"""The port's serving resilience against the JAX engine's, under the same
seeded fault schedules (``serve/faults.py``), with the same weights.

For every schedule both engines give each request the same terminal status
and the same tokens, and the port keeps the contract of
``tests/test_faults.py`` and ``tests/test_paged_chaos.py``: every request
terminal, no leaked block, every request no fault touches token-identical
to the fault-free run, the registry's terminal counters partitioning the
submissions.  Also held to the JAX engine: the bounded queue's shed
policies, deadlines, the run's wall budget, ``cancel``, the preemption
budget, the watchdog, windowed eviction on a sliding-window config, and
the request lifecycle events of the trace.  Then the port-only parts: a
kernel error propagates out of ``Engine.run`` (it never becomes a FAILED
request), and the launcher runs on the CPU with every flag.

The JAX engine jits its model calls (no contraction trips in these runs,
so its compiled guard and the port's eager one act alike) and waits on
each call: on the CPU backend its asynchronous calls race with its own
in-place block-table edits.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget  # noqa: E402
from repro.models.lm import build_model as jbuild  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.serve import faults as jfaults  # noqa: E402
from repro.serve.server import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs.base import SQUARE_GEMMS_POLICY  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import routing as trouting  # noqa: E402
from repro_torch.kernels import build as tbuild  # noqa: E402
from repro_torch.kernels import sq_matmul as tk1  # noqa: E402
from repro_torch.kernels import sq_paged_attn as tk4  # noqa: E402
from repro_torch.kernels.build import KernelError  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.serve import make_requests  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.obs import check as tcheck  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import faults as tfaults  # noqa: E402
from repro_torch.serve.server import Request as TRequest  # noqa: E402
from test_torch_moe import _one_thread  # noqa: E402,F401

ENGINE_KW = dict(max_slots=4, block_size=8, num_blocks=48, blocks_per_seq=6,
                 prefill_chunk=8, max_new_tokens=5)
TERMINALS = ("completed", "rejected", "shed", "timeouts", "failures",
             "cancelled")


@pytest.fixture(autouse=True)
def _fresh_state():
    for f in (trouting.reset_route_health, ttrace.disable, jtrace.disable):
        f()
    yield
    for f in (trouting.reset_route_health, ttrace.disable, jtrace.disable):
        f()


def _pair(arch, **cfg_kw):
    jc = dataclasses.replace(jget(arch).reduced(), **cfg_kw)
    tc = dataclasses.replace(tget(arch).reduced(), **cfg_kw)
    jm = jbuild(jc)
    params = jm.init(jax.random.PRNGKey(0))
    tm = LM(tc, device=torch.device("cpu"))
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


@pytest.fixture(scope="module")
def world():
    jm, params, tm = _pair("deepseek-7b")
    reqs = make_requests(tm.cfg, 6, seed=0, lo=4, hi=20)
    base = teng.Engine(tm, teng.EngineConfig(**ENGINE_KW), device="cpu").run(
        [TRequest(r.rid, r.tokens) for r in reqs])
    assert all(r.ok for r in base.values())
    return jm, params, tm, reqs, {rid: r.tokens for rid, r in base.items()}


def _synchronous(engine):
    for name in ("_chunk", "_decode", "_logits_at"):
        fn = getattr(engine, name)
        setattr(engine, name,
                lambda *a, _f=fn: jax.block_until_ready(_f(*a)))
    return engine


def _jax_plan(plan):
    return jfaults.FaultPlan(alloc_fail=plan.alloc_fail,
                             step_fail=dict(plan.step_fail),
                             nan_logits=dict(plan.nan_logits),
                             clock_skew=dict(plan.clock_skew))


def _run_both(world, plan=None, requests=None, **cfg_kw):
    """Both engines over the same requests, each with its own injector
    for ``plan``.  Returns (port engine, port results, JAX engine, JAX
    results)."""
    jm, params, tm, reqs, _ = world
    reqs = reqs if requests is None else requests
    kw = {**ENGINE_KW, **cfg_kw}
    je = _synchronous(jeng.Engine(
        jm, params, jeng.EngineConfig(**kw),
        faults=None if plan is None else jfaults.FaultInjector(
            _jax_plan(plan))))
    te = teng.Engine(tm, teng.EngineConfig(**kw), device="cpu",
                     faults=None if plan is None
                     else tfaults.FaultInjector(plan))
    jreqs = [JRequest(r.rid, r.tokens, deadline_s=r.deadline_s) for r in reqs]
    treqs = [TRequest(r.rid, r.tokens, deadline_s=r.deadline_s) for r in reqs]
    return te, te.run(treqs), je, je.run(jreqs)


def _check_contract(eng, results, n_submitted):
    assert len(results) == n_submitted
    assert eng.allocator.used_blocks == 0            # zero leaked blocks
    m = eng.metrics
    assert (m.completed + m.rejected + m.timeouts + m.failures
            + m.cancelled) == n_submitted
    assert m.tokens_out == sum(len(r.tokens) for r in results.values())
    c = eng.registry.snapshot()["counters"]
    assert c["engine_requests_submitted_total"] == n_submitted
    assert sum(c[f"engine_requests_{k}_total"] for k in TERMINALS) \
        == n_submitted
    assert all(v >= 0 for v in c.values())
    assert c["engine_tokens_generated_total"] >= m.tokens_out


METRICS = ("completed", "rejected", "shed", "timeouts", "failures",
           "cancelled", "step_failures", "watchdog_trips", "guard_trips",
           "preemptions", "tokens_out", "decode_steps", "prefill_chunks",
           "peak_queue_depth", "peak_blocks_used")


def _same_outcome(tres, jres, te, je):
    assert sorted(tres) == sorted(jres)
    for rid in tres:
        assert str(tres[rid].status) == str(jres[rid].status), rid
        assert tres[rid].tokens == jres[rid].tokens, rid
    for k in METRICS:
        assert getattr(te.metrics, k) == getattr(je.metrics, k), k


PLANS = {
    "transient": (tfaults.FaultPlan.of(alloc_fail=(1, 3, 5, 8),
                                       decode_fail=(0, 4, 9),
                                       prefill_fail=(2, 6)), {}),
    "persistent_decode": (tfaults.FaultPlan.of(decode_fail=range(10_000)),
                          dict(max_step_retries=3, watchdog_steps=50)),
    "persistent_alloc": (tfaults.FaultPlan.of(alloc_fail=range(10_000)),
                         dict(watchdog_steps=10)),
    "nan_logits_guarded": (tfaults.FaultPlan.of(nan_logits={2: 1}),
                           dict(guard=True)),
    "nan_logits_unguarded": (tfaults.FaultPlan.of(nan_logits={2: 1}), {}),
    "clock_skew": (tfaults.FaultPlan.of(clock_skew={3: 3600.0}),
                   dict(deadline_s=60.0)),
    "mixed": (tfaults.FaultPlan.of(alloc_fail=(1, 3), decode_fail=(0, 4),
                                   prefill_fail=(2,), nan_logits={2: 1},
                                   clock_skew={6: 3600.0}),
              dict(guard=True, deadline_s=60.0)),
    **{f"random{seed}": (tfaults.FaultPlan.random(seed), {})
       for seed in (0, 1, 2, 3)},
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_fault_plan_gives_the_same_outcome_as_jax(world, name):
    plan, kw = PLANS[name]
    *_, reqs, base = world
    te, tres, je, jres = _run_both(world, plan, **kw)
    _check_contract(te, tres, len(reqs))
    _same_outcome(tres, jres, te, je)
    for rid, r in tres.items():
        if r.ok and name != "nan_logits_unguarded":
            assert r.tokens == base[rid], rid
    if name.startswith("random") or name == "transient":
        assert all(r.ok for r in tres.values())
    if name == "transient":
        assert te.metrics.step_failures == 5
    if name == "persistent_decode":
        assert all(r.status is teng.RequestStatus.FAILED
                   and "consecutive" in r.error for r in tres.values())
    if name == "persistent_alloc":
        assert te.metrics.watchdog_trips == 1
        assert all("watchdog" in r.error for r in tres.values())
    if name == "nan_logits_guarded":
        bad = [r for r in tres.values() if not r.ok]
        assert len(bad) == 1 and "numerics guard" in bad[0].error
        assert te.metrics.guard_trips == 1
        assert te.registry.snapshot()["counters"][
            "engine_guard_trips_total"] == 1
    if name == "nan_logits_unguarded":
        assert all(r.ok for r in tres.values())
        assert any(r.tokens != base[rid] for rid, r in tres.items())
    if name == "clock_skew":
        assert te.metrics.timeouts >= 1
    assert te._faults.injected == je._faults.injected


def test_fault_plan_random_is_numpys_schedule():
    for seed in (0, 7, 123):
        t, j = tfaults.FaultPlan.random(seed), jfaults.FaultPlan.random(seed)
        assert (t.alloc_fail, dict(t.step_fail)) == \
            (j.alloc_fail, dict(j.step_fail))
    assert tfaults.FaultPlan.random(7) == tfaults.FaultPlan.random(7)
    assert tfaults.FaultPlan.random(7) != tfaults.FaultPlan.random(8)


def test_faulty_allocator_and_injector():
    from repro_torch.serve.paged import BlockAllocator
    inj = tfaults.FaultInjector(tfaults.FaultPlan.of(alloc_fail=(0,),
                                                     decode_fail=(0,)))
    alloc = tfaults.FaultyAllocator(BlockAllocator(8, 4), inj)
    assert alloc.alloc(1) is None                 # injected exhaustion
    got = alloc.alloc(2)
    assert got is not None and alloc.used_blocks == 2
    assert alloc.occupancy() == {"num_blocks": 7, "used_blocks": 2,
                                 "free_blocks": 5, "utilization": 2 / 7}
    alloc.free(got)
    assert alloc.used_blocks == 0
    with pytest.raises(tfaults.InjectedFault):
        inj.before_step("decode")
    inj.before_step("decode")
    assert issubclass(tfaults.InjectedFault, RuntimeError)
    logits = torch.zeros(3, 5)
    p = tfaults.FaultInjector(tfaults.FaultPlan.of(nan_logits={0: 1}))
    out = p.poison_logits(logits, 0)
    assert torch.isnan(out[1]).all() and not torch.isnan(out[0]).any()
    assert not torch.isnan(logits).any()          # the input is untouched
    assert p.poison_logits(logits, 1) is logits


# ------------------------------------------------ admission and budgets
def _ragged(tm, n, seed):
    return make_requests(tm.cfg, n, seed=seed, lo=4, hi=8)


SMALL = dict(max_slots=2, block_size=8, num_blocks=32, blocks_per_seq=4,
             prefill_chunk=8, max_new_tokens=3)


@pytest.mark.parametrize("policy,shed", [("reject-new", {3, 4, 5}),
                                         ("evict-oldest", {0, 1, 2})])
def test_bounded_queue_sheds_like_jax(world, policy, shed):
    tm = world[2]
    te, tres, je, jres = _run_both(world, requests=_ragged(tm, 6, 13),
                                   queue_limit=3, shed_policy=policy,
                                   **SMALL)
    _same_outcome(tres, jres, te, je)
    _check_contract(te, tres, 6)
    assert {rid for rid, r in tres.items()
            if r.status is teng.RequestStatus.REJECTED} == shed
    assert te.metrics.shed == 3 and te.metrics.peak_queue_depth == 3
    c = te.registry.snapshot()["counters"]
    assert c["engine_requests_shed_total"] == 3
    assert c["engine_requests_rejected_total"] == 0
    assert set(te.metrics.ttft_s) == {0, 1, 2, 3, 4, 5} - shed


def test_queue_limit_zero_sheds_everything():
    tm = LM(tget("fairsquare-demo").reduced(), device=torch.device("cpu"))
    for policy in teng.SHED_POLICIES:
        eng = teng.Engine(tm, teng.EngineConfig(
            queue_limit=0, shed_policy=policy, **SMALL), device="cpu")
        res = eng.run(_ragged(tm, 2, 18))
        assert all(r.status is teng.RequestStatus.REJECTED
                   for r in res.values())
        assert eng.metrics.summary()["mean_ttft_s"] == 0.0


def test_deadline_and_per_request_override_like_jax(world):
    tm = world[2]
    reqs = _ragged(tm, 3, 14)
    reqs[1].deadline_s = 3600.0
    te, tres, je, jres = _run_both(world, requests=reqs, deadline_s=0.0,
                                   **SMALL)
    _same_outcome(tres, jres, te, je)
    _check_contract(te, tres, 3)
    assert [str(tres[i].status) for i in range(3)] == \
        ["timed_out", "completed", "timed_out"]


def test_max_wall_budget_zero_like_jax(world):
    tm = world[2]
    te, tres, je, jres = _run_both(world, requests=_ragged(tm, 3, 15),
                                   max_wall_s=0.0, **SMALL)
    _same_outcome(tres, jres, te, je)
    assert all(r.status is teng.RequestStatus.TIMED_OUT
               for r in tres.values())
    assert te.allocator.used_blocks == 0


def test_cancel_queued_and_inflight_like_jax(world):
    tm = world[2]
    reqs = make_requests(tm.cfg, 4, seed=16, lo=4, hi=8)
    outcomes = []
    for make, eng_mod, Req in (
            (lambda: _synchronous(jeng.Engine(
                world[0], world[1], jeng.EngineConfig(
                    **dict(SMALL, max_new_tokens=6)))), jeng,
             JRequest),
            (lambda: teng.Engine(tm, teng.EngineConfig(
                **dict(SMALL, max_new_tokens=6)), device="cpu"), teng,
             TRequest)):
        eng = make()
        eng.submit([Req(r.rid, r.tokens) for r in reqs])
        assert eng.cancel(3)                     # still queued (2 slots)
        while eng.step():
            if 0 in {s.req.rid for s in eng.slots if s is not None} \
                    and eng.results.get(0) is None and eng.cancel(0):
                break
        while eng.step():
            pass
        assert not eng.cancel(99)
        assert eng.allocator.used_blocks == 0
        outcomes.append({rid: (str(r.status), r.tokens)
                         for rid, r in eng.results.items()})
    assert outcomes[0] == outcomes[1]
    assert outcomes[1][3] == ("cancelled", [])
    assert outcomes[1][0][0] == "cancelled"


def test_preemption_budget_and_drain_like_jax(world):
    tm = world[2]
    reqs = make_requests(tm.cfg, 4, seed=7, lo=10, hi=14)
    te, tres, je, jres = _run_both(
        world, requests=reqs, max_slots=4, block_size=4, num_blocks=13,
        blocks_per_seq=8, prefill_chunk=16, max_new_tokens=8,
        max_preemptions=0)
    _same_outcome(tres, jres, te, je)
    _check_contract(te, tres, 4)
    failed = [r for r in tres.values()
              if r.status is teng.RequestStatus.FAILED]
    assert failed and all("preemption budget" in r.error for r in failed)
    assert sorted(r.rid for r in te.drain_finished()) == [0, 1, 2, 3]
    assert te.drain_finished() == []


def test_lifecycle_events_match_jax(world):
    """The request lifecycle events of a faulted run (submit, admit, first
    token, preempt, terminal, step failure) are the JAX engine's, in
    order, with the same arguments (times aside), and every span closes."""
    plan = tfaults.FaultPlan.of(alloc_fail=(1, 3), decode_fail=(0, 4),
                                prefill_fail=(2,))
    with ttrace.capture() as ttr, jtrace.capture() as jtr:
        te, tres, je, jres = _run_both(world, plan, guard=True)
    assert ttr.open_spans == jtr.open_spans == 0
    names = ("request.submit", "request.admit", "request.first_token",
             "request.terminal", "engine.preempt", "engine.step_failure")

    def lifecycle(tr):
        return [(r.name, {k: v for k, v in r.args.items() if k != "ttft_s"})
                for r in tr.records() if r.name in names]
    assert lifecycle(ttr) == lifecycle(jtr)
    spans = [r.name for r in ttr.records() if r.dur is not None]
    assert {"engine.tick", "engine.admit", "engine.prefill_chunk",
            "engine.decode_step"} <= set(spans)
    errored = [r for r in ttr.records()
               if r.name in ("engine.prefill_chunk", "engine.decode_step")
               and "error" in r.args]
    assert len(errored) == te._faults.injected["decode"] \
        + te._faults.injected["prefill"] == 3


def test_window_eviction_caps_footprint_like_jax():
    """A sliding window of 8 over 4-token blocks: eviction on gives the
    tokens of eviction off (aged blocks are masked anyway) and of the JAX
    engine, frees every block, and caps the footprint."""
    window = 8
    jm, params, tm = _pair("starcoder2-3b", window=window)
    assert teng.eviction_window(tm.cfg) == window == \
        jeng.eviction_window(jm.cfg)
    assert teng.eviction_window(tget("deepseek-7b").reduced()) is None
    reqs = make_requests(tm.cfg, 4, seed=4, lo=10, hi=24)
    kw = dict(max_slots=4, block_size=4, num_blocks=48, blocks_per_seq=10,
              prefill_chunk=8, max_new_tokens=8)
    world = (jm, params, tm, reqs, None)
    off = teng.Engine(tm, teng.EngineConfig(window_eviction=False, **kw),
                      device="cpu")
    res_off = off.run([TRequest(r.rid, r.tokens) for r in reqs])
    te, tres, je, jres = _run_both(world, **kw)
    _same_outcome(tres, jres, te, je)
    assert {k: r.tokens for k, r in tres.items()} == \
        {k: r.tokens for k, r in res_off.items()}
    assert all(r.ok for r in tres.values())
    assert te.allocator.used_blocks == 0
    assert te.metrics.peak_blocks_used <= 4 * (-(-window // 4) + 1)
    assert te.metrics.peak_blocks_used < off.metrics.peak_blocks_used


def test_engine_config_validates_shed_policy():
    with pytest.raises(ValueError, match="shed_policy"):
        teng.EngineConfig(shed_policy="drop-everything")


def test_summary_never_divides_by_zero():
    tm = LM(tget("fairsquare-demo").reduced(), device=torch.device("cpu"))
    s = teng.Engine(tm, teng.EngineConfig(**SMALL), device="cpu") \
        .metrics.summary()
    assert s["tokens_per_s"] == 0.0 and s["mean_ttft_s"] == 0.0
    assert s["batch_occupancy"] == 0.0 and s["decode_step_p99_s"] == 0.0


# ------------------------------------------------ kernel errors propagate
@pytest.mark.parametrize("exc", [
    KernelError("sq_matmul_k1: CUDA error 700 (an illegal memory access)"),
    torch.AcceleratorError("CUDA error: an illegal memory access was "
                           "encountered")])
def test_kernel_error_propagates_out_of_run(monkeypatch, exc):
    """A kernel fault is never absorbed into request statuses: K1's entry
    raising stops ``Engine.run`` with the error, and no request ends
    FAILED."""
    cfg = dataclasses.replace(tget("fairsquare-demo").reduced(),
                              matmul_mode="square_pallas")
    tm = LM(cfg, device=torch.device("cpu"))
    calls = []

    def broken(*a, **k):
        calls.append(1)
        raise exc
    monkeypatch.setattr(tops, "sq_matmul_k1", broken)
    eng = teng.Engine(tm, teng.EngineConfig(**ENGINE_KW), device="cpu")
    with pytest.raises(type(exc), match="CUDA error"):
        eng.run(make_requests(cfg, 3, seed=1, lo=4, hi=8))
    assert len(calls) == 1                        # no retry either
    assert not any(r.status is teng.RequestStatus.FAILED
                   for r in eng.results.values())
    assert eng.metrics.step_failures == 0


@pytest.mark.parametrize("kernel", ["k1", "k4"])
def test_kernel_refusal_propagates_out_of_run(monkeypatch, kernel):
    """A launch that a real wrapper refuses stops ``Engine.run`` with a
    KernelError and leaves no request FAILED.  The refusal a CPU host can
    reach is the wrappers' device check: K1's or K4's own wrapper gets the
    model's operands on the ``meta`` device, neither the CPU nor CUDA."""
    monkeypatch.delenv("REPRO_ROUTE", raising=False)
    cfg = dataclasses.replace(tget("fairsquare-demo").reduced(),
                              matmul_mode="square_pallas",
                              contraction_policy=SQUARE_GEMMS_POLICY)
    tm = LM(cfg, device=torch.device("cpu"))
    mod, name = ((tk1, "sq_matmul_k1") if kernel == "k1"
                 else (tk4, "sq_paged_attn_k4"))
    real, calls = getattr(mod, name), []

    def on_meta(*a, **k):
        calls.append(1)
        return real(*(t.to("meta") for t in a), **k)
    monkeypatch.setattr(tops if kernel == "k1" else tk4, name, on_meta)
    # 128-token tables: long enough for the paged step to route to K4
    geo = dict(max_slots=4, block_size=16, num_blocks=40, blocks_per_seq=8,
               prefill_chunk=16, max_new_tokens=4)
    eng = teng.Engine(tm, teng.EngineConfig(**geo), device="cpu")
    with pytest.raises(KernelError, match="runs on CUDA"):
        eng.run(make_requests(cfg, 3, seed=1, lo=4, hi=8))
    assert len(calls) == 1                        # no retry either
    assert not any(r.status is teng.RequestStatus.FAILED
                   for r in eng.results.values())
    assert eng.metrics.step_failures == 0


@pytest.mark.parametrize("failure", ["nvcc_fails", "nvcc_hangs",
                                     "library_missing"])
def test_build_and_load_failures_are_kernel_errors(monkeypatch, tmp_path,
                                                   failure):
    """Every way a kernel can fail to build or load raises KernelError, the
    one error class the engine re-raises: a compiler that exits non-zero,
    one past ``NVCC_TIMEOUT_S`` (killed, no process left) and a library
    that does not load."""
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path / "build")
    if failure == "library_missing":
        with pytest.raises(KernelError, match="does not load"):
            tbuild.bind(tmp_path / "libmissing.so", "sq_conv")
        return
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho refused\nexit 3\n"
                    if failure == "nvcc_fails"
                    else "#!/bin/sh\nexec sleep 30\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(tbuild, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(tbuild, "NVCC_TIMEOUT_S", 0.5)
    match = "exit 3" if failure == "nvcc_fails" else "ran past"
    with pytest.raises(KernelError, match=match):
        tbuild.build(["sq_conv"])
    assert not list((tmp_path / "build").glob("*.so*"))


def test_other_model_errors_are_retried_then_failed(monkeypatch):
    """Any other exception keeps the JAX semantics: retried, then FAILED
    after ``max_step_retries`` consecutive failures."""
    cfg = tget("fairsquare-demo").reduced()
    tm = LM(cfg, device=torch.device("cpu"))

    def broken(*a, **k):
        raise ValueError("not a kernel fault")
    monkeypatch.setattr(tm, "decode_paged", broken)
    eng = teng.Engine(tm, teng.EngineConfig(max_step_retries=2,
                                            **ENGINE_KW), device="cpu")
    res = eng.run(make_requests(cfg, 2, seed=1, lo=4, hi=8))
    assert all(r.status is teng.RequestStatus.FAILED
               and "consecutive" in r.error for r in res.values())
    assert eng.allocator.used_blocks == 0


# ---------------------------------------------------------- the launcher
@pytest.mark.parametrize("extra,statuses", [
    ([], {"completed": 4}),
    (["--queue-limit", "2", "--shed-policy", "reject-new", "--slots", "1"],
     None),
    (["--deadline-ms", "0"], {"timed_out": 4})])
def test_launcher_every_flag_on_cpu(tmp_path, capsys, extra, statuses):
    m, t = tmp_path / "m.json", tmp_path / "t.json"
    argv = ["--reduced", "--device", "cpu", "--matmul-mode", "square_pallas",
            "--policy", "square_gemms", "--prepared", "--guard",
            "--requests", "4", "--max-new", "3", "--deadline-ms", "600000",
            "--queue-limit", "16", "--shed-policy", "evict-oldest",
            "--metrics-file", str(m), "--trace-out", str(t), *extra]
    res = tserve.main(argv)
    out = capsys.readouterr().out
    assert len(res) == 4
    got = {}
    for r in res.values():
        got[str(r.status)] = got.get(str(r.status), 0) + 1
    if statuses is not None:
        assert got == statuses
    else:
        assert got["rejected"] > 0 and got["completed"] > 0
    assert "route health: 0 tracked site(s), 0 demoted" in out
    assert tcheck.main([str(m), str(t)]) == 0
    snap = json.loads(m.read_text())
    c = snap["counters"]
    assert c["engine_requests_submitted_total"] == 4
    assert sum(c[f"engine_requests_{k}_total"] for k in TERMINALS) == 4
    assert c["engine_guard_recomputes_total"] == 0
    assert snap["engine"]["guard_trips"] == 0
    assert snap["route_health"] == []
    tr = json.loads(t.read_text())
    assert tr["otherData"]["dropped_records"] == 0
    names = {e["name"] for e in tr["traceEvents"]}
    assert {"engine.tick", "request.submit", "request.terminal"} <= names
    assert not ttrace.enabled()                    # main restored tracing


def test_launcher_legacy_ignores_metrics_file(tmp_path, capsys):
    res = tserve.main(["--reduced", "--device", "cpu", "--legacy",
                       "--requests", "2", "--max-new", "2",
                       "--metrics-file", str(tmp_path / "m.json")])
    assert len(res) == 2
    assert "ignored under --legacy" in capsys.readouterr().out
    assert not (tmp_path / "m.json").exists()
    assert os.environ.get("REPRO_ROUTE") is None
