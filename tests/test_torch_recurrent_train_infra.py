"""The recurrent train step's audit, capture, state and launcher on the CPU,
for ``recurrentgemma-2b`` and ``xlstm-350m`` ``.reduced()`` (square_pallas
on the kernels' plain versions):

- the audit of one step equals ``chip_smoke.recurrent_train_audit``, the
  analytic count the card's phase holds its audits to: each forward
  contraction once, and once at ``.bwd_x`` / ``.bwd_w`` for each gradient
  autograd computes, none for the zero initial states' cotangents and the
  dropped final mLSTM state (3 x the forward less those), with the same
  count under ``remat="block"`` (the recompute notes nothing); the routes
  taken equal ``chip_smoke.recurrent_train_launches``' forward, backward
  and recompute; xlstm at 300 tokens, two mLSTM chunks, the second padded;
- the rematerialised step's gradients equal ``remat="none"``'s bit for bit;
- the step captured (``jit_train_step``) on
  ``tests/test_torch_compiled_train.py``'s stub graph: 2 calls equal 2
  eager steps bit for bit, the ledger's audit of a replay equals the eager
  audit; ``GuardedStep(jit=True)`` on the stub clean;
- ``LM.train_params`` of a bf16 model keeps the f32 ``lam``, ``w_if`` and
  ``r`` leaves, as JAX's tree does, and ``train_state_from_jax`` of a
  scanned bf16 JAX state gives the same dtypes; that mixed tree
  round-trips through a checkpoint bit for bit;
- the launcher with ``--reduced`` (and ``--layers``) for both archs, each
  in a checkpoint directory of its own (both trainers adopt any tree that
  restores, so a shared directory would resume one arch from the other's
  run);
- ``chip_smoke.k1_ordered``, the reference K1 is held to past
  ``K1_LINEAR_MAX_K`` terms, bit for bit against a scalar loop over K1's
  documented order, within K1's stated bound of the plain version, and a
  zero output far outside its tolerance.
"""
import collections
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models.lm import build_model as jbuild  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.convert import train_state_from_jax  # noqa: E402
from repro_torch.core import counting as tcount  # noqa: E402
from repro_torch.core import graphs  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import routing  # noqa: E402
from repro_torch.models.lm import build_model  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import step as step_mod  # noqa: E402
from test_torch_compiled_train import CUDA, _bind_stub, _StubCall  # noqa
from test_torch_recurrent_train import _one_thread  # noqa: E402,F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

ARCHS = ("recurrentgemma-2b", "xlstm-350m")
# (B, S): recurrentgemma past its 32-token window, xlstm over two chunks
SHAPE = {"recurrentgemma-2b": (2, 64), "xlstm-350m": (1, 300)}
ROUTE_KERNEL = {"kernel": "K1", "batched": "K2", "fold": "K3",
                "virtual": "virtual"}
F32_LEAVES = {"recurrentgemma-2b": ("lam",), "xlstm-350m": ("w_if", "r")}


def _cfg(arch, mode="square_pallas", **kw):
    return dataclasses.replace(tget(arch).reduced(), matmul_mode=mode, **kw)


def _batch(cfg, B, S, seed=5, n=1):
    return SyntheticLM(DataConfig(global_batch=B, seq_len=S, vocab=cfg.vocab,
                                  seed=seed), device="cpu").take(n)


def _state(cfg, seed=0):
    params = build_model(cfg, device="cpu", seed=seed).train_params()
    return params, adamw.adamw_init(params)


# ---------------------------------------------------------- the audit
@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("arch", ARCHS)
def test_audit_and_routes_equal_the_analytic_count(arch, remat):
    """One square_pallas step's audit, site by site, equals
    ``chip_smoke.recurrent_train_audit`` (fraction_square and
    fraction_square_bwd 1.0, the total below 3 x the forward's by the
    gradients never computed), and the routes it took equal
    ``chip_smoke.recurrent_train_launches``' forward + backward +
    recompute."""
    cfg = _cfg(arch, remat=remat)
    B, S = SHAPE[arch]
    step = step_mod.make_train_step(build_model(cfg, device="cpu"),
                                    step_mod.TrainConfig())
    p, o = _state(cfg)
    taken = routing.select_matmul_route.taken
    taken.clear()
    (_, _, met), ctr = step_mod.audit_step(step, p, o, _batch(cfg, B, S)[0])
    assert np.isfinite(float(met["loss"]))
    got = {s: d["mults"] for s, d in ctr.by_site().items()}
    want = chip_smoke.recurrent_train_audit(cfg, B, S)
    assert got == want
    assert ctr.fraction_square == ctr.fraction_square_bwd == 1.0
    fwd = sum(m for s, m in got.items() if ".bwd_" not in s)
    missing = {"recurrentgemma-2b": 0, "xlstm-350m": 1}[arch]
    assert (ctr.total_mults < 3 * fwd) == bool(missing)
    rules = chip_smoke.recurrent_train_launches(cfg, B, S)
    total = collections.Counter()
    for part in ("forward", "backward", "recompute"):
        total.update(rules[part])
    assert {ROUTE_KERNEL[k]: n for k, n in taken.items() if n} == \
        {k: n for k, n in total.items() if n}


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_block_gradients_equal_none(arch):
    """The recompute under ``remat="block"`` (``counting.remat``) runs each
    block's forward again, the scans and the sLSTM loop included: the
    gradients equal ``remat="none"``'s bit for bit (``standard``: the
    recompute is the mode's own forward, whichever mode)."""
    B, S = SHAPE[arch]
    fps = []
    for remat in ("none", "block"):
        cfg = _cfg(arch, "standard", remat=remat)
        loss_fn = step_mod.make_loss_fn(build_model(cfg, device="cpu"),
                                        step_mod.TrainConfig())
        p, _ = _state(cfg)
        _, g = step_mod.value_and_grad(loss_fn, p, _batch(cfg, B, S)[0])
        fps.append(adamw.tree_fingerprint(g))
    assert fps[0] == fps[1]


# ------------------------------------------------- the captured step
@pytest.mark.parametrize("arch", ARCHS)
def test_captured_step_on_the_stub_equals_eager(arch, monkeypatch):
    """The recurrent step captured (``jit_train_step``) on the CPU stub
    graph under the compiled audit: 2 calls equal 2 eager steps bit for
    bit (losses, params, optimizer state), one capture, the ledger's audit
    of a replay equal to the eager step's site by site.  Then
    ``GuardedStep(jit=True)`` on the stub: clean, the eager result."""
    monkeypatch.setattr(graphs, "CapturedCall", _StubCall)
    _StubCall.made = []
    cfg = _cfg(arch, remat="block")
    raw = step_mod.make_train_step(build_model(cfg, device="cpu"),
                                   step_mod.TrainConfig())
    batches = _batch(cfg, 2, 32, n=2)
    p, o = _state(cfg)
    eager, ctr = [], None
    for i, b in enumerate(batches):
        if i == 0:
            (p, o, met), ctr = step_mod.audit_step(raw, p, o, b)
        else:
            p, o, met = raw(p, o, b)
        eager.append(float(met["loss"]))
    want = adamw.tree_fingerprint((p, o))

    jitted = step_mod.jit_train_step(raw, CUDA)
    p, o = _state(cfg)
    losses = []
    with tcount.compiled_audit():
        for b in batches:
            p, o, met = jitted(p, o, b)
            losses.append(float(met["loss"]))
    assert jitted.captures == 1 and len(_StubCall.made) == 1
    assert losses == eager
    assert adamw.tree_fingerprint((p, o)) == want
    with tcount.track_compiled_contractions() as tc_ctr:
        jitted.current.ledger.emit()
    assert {k: v["mults"] for k, v in tc_ctr.by_site().items()} == \
        {k: v["mults"] for k, v in ctr.by_site().items()}
    assert tc_ctr.fraction_square_bwd == 1.0

    gs = step_mod.GuardedStep(raw, jit=True, trip_limit=1,
                              registry=MetricsRegistry())
    gs._bind = lambda params: _bind_stub(gs)
    p, o = _state(cfg)
    gp, go, gmet = gs(p, o, batches[0])
    ep, eo, emet = raw(p, o, batches[0])
    assert gs.stats() == {"guard_trips": 0, "rejits": 0, "retries": 0}
    assert gs.captures == 1
    assert adamw.tree_fingerprint((gp, go, gmet["loss"])) == \
        adamw.tree_fingerprint((ep, eo, emet["loss"]))


# -------------------------------------------- state and checkpoints
def _leaf_dtypes(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _leaf_dtypes(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, t in enumerate(tree)
                for k, v in _leaf_dtypes(t, f"{path}/{i}").items()}
    return {path: tree.dtype}


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_state_keeps_its_f32_leaves_and_round_trips(arch, tmp_path):
    """A bf16 model's ``train_params``: the ``mix`` leaves the spec makes
    f32 (recurrentgemma's ``lam``, xlstm's ``w_if`` and ``r``) stay f32,
    the rest bf16, plain tensors with no grad; ``train_state_from_jax`` of
    the scanned bf16 JAX state (``m`` and ``v`` not zero) has the same
    leaves and dtypes, its values JAX's; and that mixed tree round-trips
    through the port's checkpoint bit for bit."""
    tc = _cfg(arch, "standard", dtype="bfloat16")
    p = build_model(tc, device="cpu").train_params()
    dtypes = _leaf_dtypes(p)
    f32 = {k for k, v in dtypes.items() if v == torch.float32}
    kinds = {k for k in f32 if k.split("/")[-2] in F32_LEAVES[arch]}
    assert kinds and kinds == {k for k in dtypes
                               if k.split("/")[-2] in F32_LEAVES[arch]}
    assert f32 - kinds == {k for k in f32 if "norm" in k or "ln" in k}
    assert all(v == torch.bfloat16 for k, v in dtypes.items()
               if k not in f32)
    assert not any(t.requires_grad for t in tree_leaves(p))

    jc = dataclasses.replace(jget(arch).reduced(), dtype="bfloat16")
    assert jc.scan_layers
    jp = jbuild(jc).init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(3)
    jo = dict(jadamw.adamw_init(jp), step=np.asarray(7, np.int32))
    for k in ("m", "v"):
        jo[k] = jax.tree.map(lambda a: np.abs(rng.normal(size=a.shape))
                             .astype(np.float32), jo[k])
    tp, to = train_state_from_jax(jax.tree.map(np.asarray, jp),
                                  jax.tree.map(np.asarray, jo))
    assert _leaf_dtypes(tp) == dtypes
    assert int(to["step"]) == 7
    assert all(t.dtype == torch.float32
               for t in tree_leaves((to["m"], to["v"])))
    for name, layer in enumerate(tp["layers"]):
        for leaf in F32_LEAVES[arch]:
            if leaf in layer.get("mix", {}):
                assert layer["mix"][leaf]["w"].dtype == torch.float32, name

    state = {"params": tp, "opt_state": to}
    mgr = CheckpointManager(str(tmp_path / "ck"), registry=MetricsRegistry(),
                            async_save=False)
    mgr.save(1, state, meta={"arch": arch})
    trees, meta = CheckpointManager(str(tmp_path / "ck"),
                                    registry=MetricsRegistry()).restore()
    assert meta["arch"] == arch
    assert adamw.tree_fingerprint(trees) == adamw.tree_fingerprint(state)
    for a, b in zip(tree_leaves(trees), tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ------------------------------------------------------ the launcher
@pytest.mark.parametrize("arch,layers", [("recurrentgemma-2b", 0),
                                         ("recurrentgemma-2b", 3),
                                         ("xlstm-350m", 0),
                                         ("xlstm-350m", 4)])
def test_launcher_trains_recurrent_on_the_cpu(arch, layers, tmp_path):
    """``python -m repro_torch.launch.train --arch <recurrent> --reduced``
    on the CPU (eager), in a checkpoint directory of its own: finite
    losses, a checkpoint, and the trainer's first-step audit covering the
    recurrent sites forward and backward, all square, equal to the
    analytic count; ``--layers N`` trains the first N layers only (the
    card's smoke runs recurrentgemma's launcher at its first period)."""
    from repro_torch.launch import train as launch
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
            "--global-batch", "2", "--seq", "32", "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path / "ck"), "--matmul-mode",
            "square_pallas"]
    out = launch.main(argv + (["--layers", str(layers)] if layers else []))
    assert out["final_step"] == 2
    assert np.isfinite(out["loss_trajectory"]).all()
    audit = out["contraction_audit"]
    assert audit["fraction_square"] == audit["fraction_square_bwd"] == 1.0
    cfg = _cfg(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    assert {s: d["mults"] for s, d in audit["by_site"].items()} == \
        chip_smoke.recurrent_train_audit(cfg, 2, 32)
    assert (tmp_path / "ck" / "step_000000002").is_dir()


# ------------------------------------------------ K1's own order
def _k1_scalar(a, b, sa, sb):
    """K1's order as ``csrc/sq_matmul.cu`` states it, one output at a time:
    8 partials, partial p over k = p, p + 8, ..., each term fmaf(s, s,
    acc) of s = a + b (the fma's one rounding: s^2 and the sum in float64,
    then f32), partial 0 from Sa_i + Sb_j, summed 0..7 and halved."""
    m, k = a.shape
    out = np.zeros((m, b.shape[1]), np.float32)
    for i in range(m):
        for j in range(b.shape[1]):
            parts = []
            for p in range(8):
                acc = np.float32(sa[i] + sb[j]) if p == 0 else np.float32(0)
                for kc in range(p, k, 8):
                    s = np.float32(a[i, kc] + b[kc, j])
                    acc = np.float32(np.float64(acc)
                                     + np.float64(s) * np.float64(s))
                parts.append(acc)
            v = parts[0]
            for q in parts[1:]:
                v = np.float32(v + q)
            out[i, j] = v * np.float32(0.5)
    return out


@pytest.mark.parametrize("nb,k", [(0, 45), (0, 64), (2, 37)])
def test_k1_ordered_is_k1s_order(nb, k, monkeypatch):
    """``chip_smoke.k1_ordered`` equals the scalar loop bit for bit (2-D,
    and batched per element), agrees with ``sq_matmul_plain`` within K1's
    stated f32 bound k * 2^-23 * (max|a| + max|b|)^2, and past
    ``K1_LINEAR_MAX_K`` (lowered here to 16) holds a launch to itself at a
    share of 0 and a zero output at a share far above 1."""
    from repro_torch.kernels.sq_matmul import sq_matmul_plain
    rng = np.random.default_rng(k)
    shape = (nb,) if nb else ()
    a = torch.from_numpy(rng.standard_normal(shape + (3, k),
                                             dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal(shape + (k, 5), dtype=np.float32)
                         / np.float32(np.sqrt(k)))
    sa, sb = -(a * a).sum(-1), -(b * b).sum(-2)
    got = chip_smoke.k1_ordered(a, b, sa, sb)
    for e in range(max(nb, 1)):
        pick = (lambda t: t[e]) if nb else (lambda t: t)
        want = _k1_scalar(*(pick(t).numpy() for t in (a, b, sa, sb)))
        assert np.array_equal(pick(got).numpy(), want)
        plain = sq_matmul_plain(pick(a), pick(b), pick(sa), pick(sb))
        bound = k * 2.0 ** -23 * (a.abs().max() + b.abs().max()).item() ** 2
        assert (plain - pick(got)).abs().max().item() <= bound
    monkeypatch.setattr(chip_smoke, "K1_LINEAR_MAX_K", 16)
    ref = chip_smoke.k1_reference(a, b, sa, sb, None)
    assert chip_smoke.k1_share(got, ref, a, b, sa, sb).item() == 0.0
    assert chip_smoke.k1_share(torch.zeros_like(got), ref, a, b, sa,
                               sb).item() > 100.0
