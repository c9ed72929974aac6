"""The port's ``CheckpointManager`` (the contract of
``tests/test_checkpoint_robust.py`` and the checkpoint half of
``tests/test_train_infra.py``): atomic commit with the torn-write sweep,
per-array checksums and the tree fingerprint validated on restore, the
fallback past a corrupt or torn newest step, keep-K garbage collection
that never strands the newest valid step, and the async writer's snapshot
and failure semantics.  The layout is the JAX manager's: the same files,
array paths, per-array digests, dtypes and shapes for the same tree; bf16
is stored as its uint16 view with ``bfloat16`` in the manifest.
"""
import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.manager import \
    CheckpointManager as JCheckpointManager  # noqa: E402
from repro_torch.checkpoint.manager import (  # noqa: E402
    CheckpointCorruptError, CheckpointManager)
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.train.faults import (TrainFaultInjector,  # noqa: E402
                                      TrainFaultPlan)


def _trees(step):
    rng = np.random.default_rng(step)
    t = lambda a: torch.from_numpy(np.asarray(a))             # noqa: E731
    return {"params": {"w": t(rng.normal(size=(4, 3)).astype(np.float32)),
                       "blocks": [{"b": t(np.full((2,), step, np.float32))},
                                  {"b": t(np.full((2,), -step, np.float32))}],
                       "h": t(rng.normal(size=(3,))).to(torch.bfloat16)},
            "opt_state": {"step": torch.tensor(step, dtype=torch.int32),
                          "m": {"w": torch.zeros(4, 3)}}}


def _mgr(path, **kw):
    return CheckpointManager(str(path), registry=MetricsRegistry(), **kw)


def _save_steps(mgr, steps, **kw):
    for s in steps:
        mgr.save(s, _trees(s), meta={"tag": f"s{s}"}, block=True, **kw)


def _assert_roundtrip(trees, restored):
    a, b = tree_leaves(trees), tree_leaves(restored)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and y.device.type == "cpu"
        assert torch.equal(x, y)


def test_roundtrip_with_manifest(tmp_path):
    mgr = _mgr(tmp_path, keep=3)
    _save_steps(mgr, [7])
    restored, meta = mgr.restore()
    _assert_roundtrip(_trees(7), restored)
    assert isinstance(restored["params"]["blocks"], list)
    assert meta["tag"] == "s7" and meta["step"] == 7
    assert sorted(os.listdir(tmp_path)) == ["step_000000007"]
    manifest = json.load(open(tmp_path / "step_000000007" / "manifest.json"))
    assert manifest["step"] == 7
    assert "params/blocks/__0/b" in manifest["arrays"]
    assert manifest["arrays"]["params/h"]["dtype"] == "bfloat16"
    with np.load(tmp_path / "step_000000007" / "arrays.npz") as data:
        assert data["params/h"].dtype == np.uint16
    assert len(manifest["tree_fingerprint"]) == 64


def test_layout_matches_the_jax_manager(tmp_path):
    """One f32/int32 tree through both managers: the same files, array
    paths, digests, dtypes and shapes, and the same meta."""
    tree = {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
            "s": np.asarray(3, np.int32)}
    JCheckpointManager(str(tmp_path / "j"), async_save=False).save(
        5, {"params": tree}, meta={"data": {"step": 5, "seed": 1}})
    _mgr(tmp_path / "t", async_save=False).save(
        5, {"params": {k: torch.from_numpy(v) for k, v in tree.items()}},
        meta={"data": {"step": 5, "seed": 1}})
    jd, td = tmp_path / "j" / "step_000000005", tmp_path / "t" / \
        "step_000000005"
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
    jm, tm = (json.load(open(d / "manifest.json")) for d in (jd, td))
    assert jm["arrays"] == tm["arrays"]
    assert json.load(open(jd / "meta.json")) == \
        json.load(open(td / "meta.json"))
    restored, _ = _mgr(tmp_path / "t").restore()
    np.testing.assert_array_equal(restored["params"]["w"].numpy(), tree["w"])


def test_restore_explicit_step(tmp_path):
    mgr = _mgr(tmp_path, keep=5)
    _save_steps(mgr, [1, 2, 3])
    restored, meta = mgr.restore(step=2)
    _assert_roundtrip(_trees(2), restored)
    assert meta["step"] == 2
    with pytest.raises(FileNotFoundError):
        mgr.restore(step=99)


def test_keep_k_gc_and_no_tmp_left(tmp_path):
    mgr = _mgr(tmp_path, keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"params": {"x": torch.ones(2)}}, meta={})
    assert mgr.steps() == [3, 4]
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_stale_tmp_litter_swept_on_init(tmp_path):
    mgr = _mgr(tmp_path, keep=3)
    _save_steps(mgr, [1])
    litter = tmp_path / "step_000000002.12345.67890.tmp"
    litter.mkdir()
    (litter / "arrays.npz").write_bytes(b"partial")
    mgr2 = _mgr(tmp_path, keep=3)
    assert not litter.exists()
    assert mgr2.steps() == [1]
    _assert_roundtrip(_trees(1), mgr2.restore()[0])


def test_corrupt_newest_falls_back_explicit_raises(tmp_path):
    mgr = _mgr(tmp_path, keep=5)
    _save_steps(mgr, [1, 2, 3])
    npz = tmp_path / "step_000000003" / "arrays.npz"
    with np.load(npz) as data:
        flat = {k: data[k] for k in data.files}
    flat["params/w"] = flat["params/w"] + 1.0
    with open(npz, "wb") as f:
        np.savez(f, **flat)
    with pytest.raises(CheckpointCorruptError):
        mgr.restore(step=3)
    restored, meta = mgr.restore()
    assert meta["step"] == 2
    _assert_roundtrip(_trees(2), restored)


def test_corrupt_bf16_payload_detected(tmp_path):
    mgr = _mgr(tmp_path, keep=5)
    _save_steps(mgr, [1])
    npz = tmp_path / "step_000000001" / "arrays.npz"
    with np.load(npz) as data:
        flat = {k: data[k] for k in data.files}
    flat["params/h"] = flat["params/h"] ^ np.uint16(1)      # one bit
    with open(npz, "wb") as f:
        np.savez(f, **flat)
    with pytest.raises(CheckpointCorruptError, match="sha256"):
        mgr.restore(step=1)


def test_torn_step_missing_file_falls_back(tmp_path):
    mgr = _mgr(tmp_path, keep=5)
    _save_steps(mgr, [1, 2])
    os.remove(tmp_path / "step_000000002" / "manifest.json")
    assert mgr.restore()[1]["step"] == 1
    with pytest.raises(CheckpointCorruptError):
        mgr.restore(step=2)


def test_garbage_meta_json_falls_back(tmp_path):
    mgr = _mgr(tmp_path, keep=5)
    _save_steps(mgr, [1, 2])
    (tmp_path / "step_000000002" / "meta.json").write_text("{not json")
    assert mgr.restore()[1]["step"] == 1


def test_shape_dtype_drift_detected(tmp_path):
    mgr = _mgr(tmp_path, keep=5)
    _save_steps(mgr, [1])
    d = tmp_path / "step_000000001"
    manifest = json.load(open(d / "manifest.json"))
    manifest["arrays"]["params/w"]["shape"] = [3, 4]
    (d / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(CheckpointCorruptError, match="manifest"):
        mgr.restore(step=1)
    manifest["arrays"]["params/w"]["shape"] = [4, 3]
    manifest["arrays"]["params/h"]["dtype"] = "float16"
    (d / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(CheckpointCorruptError, match="manifest"):
        mgr.restore(step=1)


def test_fingerprint_mismatch_detected(tmp_path):
    mgr = _mgr(tmp_path, keep=5)
    _save_steps(mgr, [1])
    d = tmp_path / "step_000000001"
    manifest = json.load(open(d / "manifest.json"))
    manifest["tree_fingerprint"] = "0" * 64
    (d / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(CheckpointCorruptError, match="fingerprint"):
        mgr.restore(step=1)


def test_all_corrupt_raises_corrupt_not_missing(tmp_path):
    mgr = _mgr(tmp_path, keep=5)
    _save_steps(mgr, [1])
    os.remove(tmp_path / "step_000000001" / "arrays.npz")
    with pytest.raises(CheckpointCorruptError, match="failed validation"):
        mgr.restore()
    with pytest.raises(FileNotFoundError):
        _mgr(tmp_path / "empty", keep=5).restore()


def test_gc_prunes_oldest_keeps_window(tmp_path):
    mgr = _mgr(tmp_path, keep=2)
    _save_steps(mgr, [1, 2, 3, 4, 5])
    assert mgr.steps() == [4, 5]
    _assert_roundtrip(_trees(5), mgr.restore()[0])


def test_gc_never_prunes_newest_valid_under_corrupt_dirs(tmp_path):
    mgr = _mgr(tmp_path, keep=2)
    _save_steps(mgr, [0, 1])
    (tmp_path / "step_000000008").mkdir()
    (tmp_path / "step_000000009").mkdir()
    _save_steps(mgr, [2])
    assert mgr.steps() == [2, 8, 9]
    restored, meta = mgr.restore()
    assert meta["step"] == 2
    _assert_roundtrip(_trees(2), restored)


def test_restore_before_walks_past_newest(tmp_path):
    mgr = _mgr(tmp_path, keep=5)
    _save_steps(mgr, [1, 2, 3])
    assert mgr.restore(before=3)[1]["step"] == 2
    with pytest.raises(FileNotFoundError):
        mgr.restore(before=1)


def test_async_save_snapshots_tensors_and_meta_at_call_time(tmp_path):
    """The writer serializes what ``save`` was given when it was called:
    later changes to the meta list or to a tensor do not leak in."""
    mgr = _mgr(tmp_path, keep=3)
    losses = [1.0, 2.0]
    trees = _trees(2)
    mgr.save(2, trees, meta={"losses": losses})
    losses.append(3.0)
    trees["params"]["w"].add_(1.0)
    mgr.wait()
    restored, meta = mgr.restore(step=2)
    assert meta["losses"] == [1.0, 2.0]
    _assert_roundtrip(_trees(2), restored)


def test_async_save_then_blocking_save_no_interleave(tmp_path):
    mgr = _mgr(tmp_path, keep=10)
    for i in range(5):
        mgr.save(2 * i, _trees(2 * i), meta={"tag": f"a{i}"})
        mgr.save(2 * i + 1, _trees(2 * i + 1), block=True)
    mgr.wait()
    assert mgr.steps() == list(range(10))
    for s in (0, 5, 9):
        _assert_roundtrip(_trees(s), mgr.restore(step=s)[0])
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_concurrent_writers_same_step_commit_whole(tmp_path):
    mgr = _mgr(tmp_path, keep=5)
    errs = []

    def write():
        try:
            mgr._write(4, {"params": {"w": torch.ones(8, 8)}},
                       {"tag": "race"})
        except Exception as e:                 # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=write) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    restored, _ = mgr.restore(step=4)
    assert torch.equal(restored["params"]["w"], torch.ones(8, 8))
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_wait_surfaces_worker_failure_once_then_recovers(tmp_path):
    faults = TrainFaultInjector(TrainFaultPlan.of(ckpt_fail=(0,)))
    reg = MetricsRegistry()
    mgr = CheckpointManager(str(tmp_path), keep=3, faults=faults,
                            registry=reg)
    mgr.save(1, _trees(1), meta={})
    with pytest.raises(RuntimeError, match="async checkpoint failed"):
        mgr.wait()
    mgr.wait()
    assert mgr.steps() == []
    mgr.save(2, _trees(2), meta={}, block=True)
    assert mgr.restore()[1]["step"] == 2
    c = reg.snapshot()["counters"]
    assert c["ckpt_saves_total"] == 2 and c["ckpt_commits_total"] == 1
    assert c["ckpt_write_failures_total"] == 1
    assert c["ckpt_restores_total"] == 1


def test_injected_ckpt_failure_leaves_previous_state_observable(tmp_path):
    _save_steps(_mgr(tmp_path, keep=3), [1])
    faults = TrainFaultInjector(TrainFaultPlan.of(ckpt_fail=(0,)))
    mgr = _mgr(tmp_path, keep=3, faults=faults)
    with pytest.raises(Exception):
        mgr.save(2, _trees(2), meta={}, block=True)
    assert mgr.steps() == [1]
    _assert_roundtrip(_trees(1), mgr.restore()[0])
    swept = _mgr(tmp_path, keep=3)
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    assert swept.steps() == [1]
