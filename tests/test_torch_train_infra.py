"""The port's training infrastructure against the JAX package (the
contracts of ``tests/test_train_infra.py``, ``tests/test_train_chaos.py``
and ``tests/test_optim.py``'s AdamW half).

- AdamW, the cosine schedule, the global norm and int8 compression with
  error feedback against ``repro.optim.adamw`` on the same numpy trees
  (f32 within 1e-6; bf16 params within one bf16 ulp of the update).
- ``SyntheticLM``: batches bit-identical to JAX's, checkpointable state.
- ``TrainFaultPlan.random``: the JAX plan for the same seed.
- The trainer: resume bit-identical to the interrupted state, the
  straggler watchdog, the first step's audit in the result, and the chaos
  suite: retries, NaN rollback, a poisoned checkpoint's escalation, write
  faults, a failed anchor, kill and resume, SIGTERM and resume, seeded
  schedules, each ending bit-identical (by ``tree_fingerprint``) to the
  unfaulted run, whose losses are JAX's trainer's at 2e-3.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models.lm import build_model as jbuild  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import faults as jfaults  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import train_state_from_jax  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models.lm import build_model  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import step as step_mod  # noqa: E402
from repro_torch.train.faults import (SimulatedKill,  # noqa: E402
                                      TrainFaultInjector, TrainFaultPlan)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from test_torch_moe import _one_thread  # noqa: E402,F401

TOTAL = 6
CHAOS = dict(name="tiny-chaos", family="dense", n_layers=2, d_model=32,
             n_heads=2, n_kv_heads=2, d_ff=64, vocab=128, head_dim=16,
             dtype="float32", scan_layers=False, remat="none",
             attn_chunk_q=16, attn_chunk_kv=16, loss_chunk=16, max_seq=64,
             matmul_mode="square_virtual")


# ------------------------------------------------------------------ AdamW
def _trees(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    shapes = {"a": (4, 3), "b": {"c": (5,), "d": (2, 2, 2)}}

    def mk(shape):
        return rng.normal(size=shape).astype(np.float32)
    p = jax.tree.map(mk, shapes, is_leaf=lambda t: isinstance(t, tuple))
    g = jax.tree.map(lambda x: mk(x.shape) * 3.0, p)
    return p, g


def _t(tree, dtype=torch.float32):
    return tree_map(lambda a: torch.from_numpy(np.asarray(a, np.float32))
                    .to(dtype), tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype):
    p, g = _trees(0)
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jcfg = jadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jp = jax.tree.map(lambda a: jnp.asarray(a, dtype), p)
    jg = jax.tree.map(lambda a: jnp.asarray(a, dtype), g)
    tdt = getattr(torch, dtype)
    tp, tg = _t(p, tdt), _t(g, tdt)
    jo, to = jadamw.adamw_init(jp), adamw.adamw_init(tp)
    for _ in range(4):
        jp, jo, jmet = jadamw.adamw_update(jcfg, jp, jg, jo)
        tp, to, met = adamw.adamw_update(cfg, tp, tg, to)
    assert int(to["step"]) == 4 and to["step"].dtype == torch.int32
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(float(met["lr"]), float(jmet["lr"]),
                               rtol=1e-6)
    atol = 1e-6 if dtype == "float32" else 2 ** -7 * 4
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert a.dtype == tdt
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), rtol=0,
                                   atol=atol)
    for k in ("m", "v"):
        for a, b in zip(tree_leaves(to[k]), jax.tree.leaves(jo[k])):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-7)


def test_schedule_norm_and_int8_match_jax():
    jcfg = jadamw.AdamWConfig(warmup_steps=10, total_steps=100)
    cfg = adamw.AdamWConfig(warmup_steps=10, total_steps=100)
    for s in (0, 1, 5, 10, 50, 100, 150):
        np.testing.assert_allclose(
            float(adamw.cosine_schedule(cfg, torch.tensor(s))),
            float(jadamw.cosine_schedule(jcfg, jnp.asarray(s))), rtol=1e-6)
    p, _ = _trees(3)
    np.testing.assert_allclose(float(adamw.global_norm(_t(p))),
                               float(jadamw.global_norm(p)), rtol=1e-6)
    g = np.random.default_rng(4).normal(size=(64,)).astype(np.float32)
    q, s = adamw.compress_int8(torch.from_numpy(g))
    jq, js = jadamw.compress_int8(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(s), float(js), rtol=1e-7)


def test_grad_compression_error_feedback():
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(
        size=(64,)).astype(np.float32) * 1e-3)}
    ef = {"w": torch.zeros(64)}
    total_true = np.zeros(64)
    total_deq = np.zeros(64)
    for _ in range(50):
        deq, ef = adamw.compressed_grad_tree(g, ef)
        total_true += g["w"].numpy()
        total_deq += deq["w"].numpy()
    np.testing.assert_allclose(total_deq, total_true, atol=2e-4)


def test_tree_fingerprint_is_bit_exact():
    a = {"w": torch.ones(3), "l": [torch.zeros(2, dtype=torch.bfloat16)]}
    fp = adamw.tree_fingerprint(a)
    assert fp == adamw.tree_fingerprint(tree_map(torch.clone, a))
    b = tree_map(torch.clone, a)
    b["l"][0][1] = torch.finfo(torch.bfloat16).tiny
    assert adamw.tree_fingerprint(b) != fp
    assert adamw.tree_fingerprint({"w": torch.ones(3, dtype=torch.float64),
                                   "l": a["l"]}) != fp
    assert adamw.tree_fingerprint({"w": torch.ones(1, 3),
                                   "l": a["l"]}) != fp


# ------------------------------------------------------------------- data
@pytest.mark.parametrize("structure", [True, False])
@pytest.mark.parametrize("seed", [0, 1234])
def test_batches_bit_identical_to_jax(seed, structure):
    j = JSyntheticLM(JDataConfig(global_batch=3, seq_len=20, vocab=300,
                                 seed=seed, structure=structure))
    t = SyntheticLM(DataConfig(global_batch=3, seq_len=20, vocab=300,
                               seed=seed, structure=structure),
                    device="cpu")
    for a, b in zip(j.take(4), t.take(4)):
        assert b["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(a["tokens"]),
                                      b["tokens"].numpy())
    assert t.state_dict() == j.state_dict()


def test_data_pipeline_checkpointable():
    cfg = DataConfig(global_batch=2, seq_len=8, vocab=100)
    it = SyntheticLM(cfg, device="cpu")
    it.next_batch()
    st = it.state_dict()
    b1 = it.next_batch()
    it2 = SyntheticLM(cfg, device="cpu")
    it2.load_state_dict(st)
    assert torch.equal(b1["tokens"], it2.next_batch()["tokens"])
    with pytest.raises(ValueError, match="seed"):
        SyntheticLM(DataConfig(2, 8, 100, seed=9), device="cpu") \
            .load_state_dict(st)


def test_fault_plans_are_jax_plans():
    for seed in range(6):
        a, b = TrainFaultPlan.random(seed), jfaults.TrainFaultPlan.random(
            seed)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


# ---------------------------------------------------------------- trainer
_MODEL = build_model(ModelConfig(**CHAOS), device="cpu")
_STEP = step_mod.make_train_step(_MODEL, step_mod.TrainConfig())
_J = {}


def _jax_init():
    """JAX's initial state of the chaos config (cached): both packages'
    trainers start from it."""
    if not _J:
        jm = jbuild(JModelConfig(**CHAOS))
        params = jm.init(jax.random.PRNGKey(0))
        _J.update(model=jm, params=params, opt=jadamw.adamw_init(params))
    return _J


def _trainer(ckpt_dir, faults=None, ckpt_every=2, total=TOTAL, step=None):
    j = _jax_init()
    params, opt = train_state_from_jax(jax.tree.map(np.asarray, j["params"]),
                                       jax.tree.map(np.asarray, j["opt"]))
    data = SyntheticLM(DataConfig(global_batch=2, seq_len=16,
                                  vocab=CHAOS["vocab"], seed=7),
                       device="cpu")
    cfg = TrainerConfig(total_steps=total, ckpt_every=ckpt_every,
                        ckpt_dir=str(ckpt_dir), keep=3, log_every=3,
                        audit_contractions=False)
    return Trainer(cfg, step or _STEP, params, opt, data, faults=faults)


def _params_fp(tr):
    return adamw.tree_fingerprint(tr.params)


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    tr = _trainer(tmp_path_factory.mktemp("base"))
    res = tr.run()
    assert res["final_step"] == TOTAL
    assert all(np.isfinite(res["loss_trajectory"]))
    assert res["rollbacks"] == 0 and res["step_failures"] == 0
    # the JAX trainer on the same state and stream
    j = _jax_init()
    jtr = JTrainer(JTrainerConfig(total_steps=TOTAL, ckpt_every=2,
                                  ckpt_dir=str(tmp_path_factory.mktemp("j")),
                                  keep=3, log_every=3,
                                  audit_contractions=False),
                   jax.jit(jstep.make_train_step(j["model"],
                                                 jstep.TrainConfig())),
                   j["params"], j["opt"],
                   JSyntheticLM(JDataConfig(global_batch=2, seq_len=16,
                                            vocab=CHAOS["vocab"], seed=7)))
    jres = jtr.run()
    np.testing.assert_allclose(res["loss_trajectory"],
                               jres["loss_trajectory"], rtol=2e-3, atol=2e-3)
    return {"losses": res["loss_trajectory"], "params_fp": _params_fp(tr)}


def _check_identical(tr, res, baseline):
    assert res["final_step"] == TOTAL
    assert res["loss_trajectory"] == baseline["losses"]
    assert _params_fp(tr) == baseline["params_fp"]


def test_trainer_resume_is_deterministic(tmp_path, baseline):
    t_a = _trainer(tmp_path, total=4, ckpt_every=4)
    t_a.run()
    fp_a = _params_fp(t_a)
    t_b = _trainer(tmp_path, ckpt_every=4)
    assert t_b.maybe_resume()
    assert t_b.step == 4 and t_b.data.step == 4
    assert _params_fp(t_b) == fp_a
    res = t_b.run()
    _check_identical(t_b, res, baseline)


def test_straggler_watchdog_logic(tmp_path, monkeypatch):
    """The trainer's clock is driven by the test: each step takes 1 s of
    it and step 3 takes 10 s, 10x the EWMA that step 2 seeded (a straggler
    past ``watchdog_factor`` 3x), whatever the host's own load."""
    import types
    from repro_torch.train import trainer as trainer_mod
    clock = {"now": 0.0}
    monkeypatch.setattr(trainer_mod, "time", types.SimpleNamespace(
        monotonic=lambda: clock["now"]))
    t = _trainer(tmp_path, total=3, ckpt_every=100)
    slow = {"n": 0}
    orig = t.train_step

    def sometimes_slow(p, o, b):
        slow["n"] += 1
        out = orig(p, o, b)
        clock["now"] += 10.0 if slow["n"] == 3 else 1.0   # a straggler
        return out

    t.train_step = sometimes_slow
    out = t.run()
    assert len(out["stragglers"]) >= 1
    assert t.registry.snapshot()["counters"]["train_stragglers_total"] >= 1


def test_trainer_surfaces_backward_audit(tmp_path):
    tr = _trainer(tmp_path, total=2, ckpt_every=100)
    tr.cfg.audit_contractions = True
    res = tr.run()
    audit = res["contraction_audit"]
    assert audit["fraction_square"] == 1.0
    assert audit["fraction_square_bwd"] == 1.0
    assert audit["bwd_mults"] == 2 * (audit["total_mults"] // 3)
    snap = tr.obs_snapshot()
    assert snap["contraction_audit"] == audit
    assert snap["gauges"]["train_final_step"] == 2


def test_guarded_step_in_the_trainer(tmp_path, baseline):
    tr = _trainer(tmp_path, step=step_mod.GuardedStep(_STEP))
    res = tr.run()
    _check_identical(tr, res, baseline)
    assert res["guard"] == {"guard_trips": 0, "rejits": 0, "retries": 0}
    assert tr.registry.snapshot()["gauges"]["train_guard_retries"] == 0


# ------------------------------------------------------------------ chaos
def _run_with_restarts(ckpt_dir, plan, max_restarts=4):
    faults = TrainFaultInjector(plan)
    deaths = 0
    while True:
        tr = _trainer(ckpt_dir, faults=faults)
        tr.maybe_resume()
        try:
            return tr, tr.run(), deaths
        except SimulatedKill:
            deaths += 1
            assert deaths <= max_restarts, "kill loop did not converge"
            plan = dataclasses.replace(plan, kill_after=None,
                                       sigterm_after=None)
            faults = TrainFaultInjector(plan)


def test_step_faults_retry_bit_identical(tmp_path, baseline):
    faults = TrainFaultInjector(TrainFaultPlan.of(step_fail=(1, 3)))
    tr = _trainer(tmp_path, faults=faults)
    res = tr.run()
    _check_identical(tr, res, baseline)
    assert res["step_failures"] == 2 == faults.injected["step"]
    assert res["rollbacks"] == 0


def test_nan_grad_commits_then_rolls_back_bit_identical(tmp_path, baseline):
    faults = TrainFaultInjector(TrainFaultPlan.of(nan_grad=(2,)))
    tr = _trainer(tmp_path, faults=faults)
    res = tr.run()
    _check_identical(tr, res, baseline)
    assert faults.injected["nan"] == 1
    assert res["rollbacks"] >= 1 and res["step_failures"] == 0


def test_poisoned_checkpoint_escalates_to_older_snapshot(tmp_path, baseline):
    tr = _trainer(tmp_path, faults=TrainFaultInjector(
        TrainFaultPlan.of(nan_grad=(1,))))
    tr.ckpt.async_save = False
    res = tr.run()
    _check_identical(tr, res, baseline)
    assert res["rollbacks"] >= 2


def test_ckpt_write_fault_absorbed_never_torn(tmp_path, baseline):
    faults = TrainFaultInjector(TrainFaultPlan.of(ckpt_fail=(1,)))
    tr = _trainer(tmp_path, faults=faults)
    res = tr.run()
    _check_identical(tr, res, baseline)
    assert res["ckpt_failures"] >= 1 and faults.injected["ckpt"] == 1
    _, meta = tr.ckpt.restore()
    assert int(meta["step"]) in range(TOTAL + 1)


def test_failed_anchor_write_falls_back_to_init_state(tmp_path, baseline):
    plan = TrainFaultPlan.of(ckpt_fail=(0, 1), nan_grad=(1,))
    tr = _trainer(tmp_path, faults=TrainFaultInjector(plan))
    res = tr.run()
    _check_identical(tr, res, baseline)
    assert res["rollbacks"] >= 1 and res["ckpt_failures"] >= 2


def test_kill_and_resume_bit_identical(tmp_path, baseline):
    faults = TrainFaultInjector(TrainFaultPlan.of(kill_after=3))
    tr = _trainer(tmp_path, faults=faults)
    with pytest.raises(SimulatedKill):
        tr.run()
    assert faults.injected["kill"] == 1
    assert tr.ckpt.latest_step() == 2
    tr2 = _trainer(tmp_path)
    assert tr2.maybe_resume() and tr2.step == 2
    _check_identical(tr2, tr2.run(), baseline)


def test_sigterm_resumes_bit_identically_with_balanced_spans(tmp_path,
                                                             baseline):
    """SIGTERM between steps: the handler commits a final blocking
    checkpoint (the only one, with the cadence off), every span closes
    through the unwind, and the restarted run ends bit-identical with its
    own registry counting only its stretch."""
    faults = TrainFaultInjector(TrainFaultPlan.of(sigterm_after=2))
    tr = _trainer(tmp_path, faults=faults, ckpt_every=100)
    with obs_trace.capture() as trc:
        with pytest.raises(SimulatedKill):
            tr.run()
    assert faults.injected["sigterm"] == 1 and tr._preempted
    assert tr.ckpt.latest_step() == 2
    assert trc.open_spans == 0
    names = [r.name for r in trc.records()]
    assert "train.sigterm" in names and "ckpt.commit" in names
    c = tr.registry.snapshot()["counters"]
    assert c["train_steps_total"] == 2 and c["ckpt_commits_total"] >= 1
    tr2 = _trainer(tmp_path, ckpt_every=100)
    assert tr2.maybe_resume() and tr2.step == 2
    res = tr2.run()
    _check_identical(tr2, res, baseline)
    c2 = tr2.registry.snapshot()["counters"]
    assert c2["train_steps_total"] == TOTAL - 2
    assert c2["ckpt_restores_total"] == 1


def test_registry_counts_faulted_run_ledger(tmp_path, baseline):
    plan = TrainFaultPlan.of(step_fail=(1, 3), nan_grad=(2,),
                             ckpt_fail=(1,))
    tr = _trainer(tmp_path, faults=TrainFaultInjector(plan))
    res = tr.run()
    _check_identical(tr, res, baseline)
    c = tr.registry.snapshot()["counters"]
    assert c["train_step_failures_total"] == res["step_failures"] == 2
    assert c["train_rollbacks_total"] == res["rollbacks"] >= 1
    assert c["ckpt_write_failures_total"] >= 1
    assert c["train_steps_total"] >= TOTAL
    assert tr.registry.snapshot()["gauges"]["train_final_step"] == TOTAL


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_chaos_schedule_converges_bit_identical(tmp_path, baseline,
                                                       seed):
    plan = TrainFaultPlan.random(seed)
    tr, res, deaths = _run_with_restarts(tmp_path, plan)
    _check_identical(tr, res, baseline)
    if plan.kill_after is not None and plan.kill_after < TOTAL:
        assert deaths >= 1
