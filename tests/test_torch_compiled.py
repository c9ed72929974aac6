"""The port's compiled serving step on the CPU, against the JAX package's
compiled audit and compiled guard.

The port captures its model calls into CUDA graphs
(``core/graphs.py``), which this host cannot run.  What it can run is the
capture ledger, which is plain Python: a call made inside
``graphs.recording(ledger)`` fills the ledger as a capture does (runtime
contraction notes, finite probes, kernel launch deltas; no in-line finite
check, no eager note), and ``ledger.emit()`` is what each replay adds on
the host.  So:

- the compiled audit (``counting.compiled_audit`` /
  ``track_compiled_contractions``): N emits tally N times the volume, a
  call recorded outside the audit tallies nothing, and an eager audit
  around emits alone warns ``EmptyAuditWarning``; the recorded ledger of
  a ``fairsquare-demo.reduced()`` paged decode step equals JAX's compiled
  audit of a cached jitted step on every site JAX reports (``by_site``
  and ``total_mults``), and its K4 sites (which JAX's compiled audit
  omits) equal the port's eager audit;
- the compiled guard: a recorded saturating ``fs_einsum`` probes instead
  of recomputing in line, and its drained trips equal a jitted JAX call's;
  ``drain_pending_trips`` against JAX's on one sequence of probe results
  (returned dicts, trips, demoted keys, route-epoch moves);
- the engine's ``_guarded_call`` loop with a stub in place of
  ``CapturedCall`` (replay once when clean, retry on a trip, re-capture
  once on an epoch move, stop at ``max_step_retries + 1``), and a retried
  call leaving the paged pools bit-equal to a clean call's;
- ``EngineConfig.jit`` / ``ServeConfig.jit``: ``None`` on the CPU is
  eager with today's tokens, ``True`` on the CPU is refused.
"""
import collections
import contextlib
import dataclasses
import json
import os
import tempfile
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import jax.experimental.pallas.tpu as pltpu  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs.base import SQUARE_GEMMS_POLICY as J_SQG  # noqa: E402
from repro.core import counting as jcount  # noqa: E402
from repro.core import guards as jguards  # noqa: E402
from repro.core.einsum import fs_einsum as jeinsum  # noqa: E402
from repro.kernels import routing as jrouting  # noqa: E402
from repro.models.lm import build_model as jbuild  # noqa: E402
from repro.serve import paged as jpaged  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs.base import SQUARE_GEMMS_POLICY as T_SQG  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import counting as tcount  # noqa: E402
from repro_torch.core import graphs  # noqa: E402
from repro_torch.core import guards as tguards  # noqa: E402
from repro_torch.core.einsum import fs_einsum as teinsum  # noqa: E402
from repro_torch.kernels import routing as trouting  # noqa: E402
from repro_torch.kernels import sq_paged_attn as tk4  # noqa: E402
from repro_torch.kernels.build import KernelError  # noqa: E402
from repro_torch.launch.serve import make_requests  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.obs import check as obs_check  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import paged as tpaged  # noqa: E402
from repro_torch.serve.server import Request, ServeConfig, Server  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_state():
    """Route health, the guard-policy stacks and the pending ledgers are
    process globals in both packages."""
    def reset():
        trouting.reset_route_health()
        jrouting.reset_route_health()
        trouting.route_health().recomputes = 0
        tguards.clear_pending_trips()
        jguards.clear_pending_trips()
        del tguards._POLICY_STACK[:]
        del jguards._POLICY_STACK[:]
    reset()
    yield
    reset()


@contextlib.contextmanager
def _route(value):
    """REPRO_ROUTE for one side's calls only (both packages read it)."""
    old = os.environ.pop("REPRO_ROUTE", None)
    if value is not None:
        os.environ["REPRO_ROUTE"] = value
    try:
        yield
    finally:
        os.environ.pop("REPRO_ROUTE", None)
        if old is not None:
            os.environ["REPRO_ROUTE"] = old


def _cancelling(m=4, k=8, n=4, mag=1e19):
    x = np.full((m, k), mag, np.float32)
    x[:, 1::2] *= -1.0                     # alternating signs down K
    y = np.full((k, n), mag, np.float32)
    return x, y


def _ffn(a, b):
    return teinsum("mk,kn->mn", a, b, mode="square_virtual", site="ffn")


# ---------------------------------------------------------- the ledger
def test_recording_fills_the_ledger_and_emits_per_replay():
    """Inside the recording region an fs_einsum notes nothing eagerly and
    fills the ledger with one runtime note (under the audit) and one
    probe (under a compiled guard); each emit lands both once."""
    x, w = torch.ones(4, 8), torch.ones(8, 2)
    ledger = graphs.CaptureLedger()
    with warnings.catch_warnings(), tguards.guarded(), \
            tcount.compiled_audit():
        warnings.simplefilter("ignore", tcount.EmptyAuditWarning)
        with tcount.track_contractions() as eager, graphs.recording(ledger):
            out = teinsum("mk,kn->mn", x, w, mode="square_exact",
                          site="ffn")
    assert torch.equal(out, torch.full((4, 2), 8.0))
    assert eager.records == []               # a capture executes nothing
    assert ledger.notes == [("ffn", "mk,kn->mn", "square_exact", 64, False)]
    assert [k for k, _ in ledger.probes] == ["ffn|1x4x8x2|float32"]
    assert ledger.flags[0] == ("ffn|1x4x8x2|float32",)
    assert not graphs.capturing() and graphs.current_ledger() is None
    with tcount.track_compiled_contractions() as ctr:
        for _ in range(3):
            ledger.emit()
    assert ctr.total_mults == 3 * 64 and ctr.fraction_square == 1.0
    assert tguards.pending_trip_counts() == {}
    assert tguards.drain_pending_trips() == {}


def test_recording_does_not_nest():
    with graphs.recording(graphs.CaptureLedger()):
        with pytest.raises(graphs.CaptureError, match="nest"):
            with graphs.recording(graphs.CaptureLedger()):
                pass


def test_recording_moves_kernel_launch_counts_into_the_ledger(monkeypatch):
    """A launch counted inside the region is taken back (nothing ran) and
    handed to the ledger; each emit adds it again."""
    from repro_torch.kernels import sq_matmul as k1mod
    k1 = k1mod.sq_matmul_k1
    monkeypatch.setattr(k1, "launches", 5)
    monkeypatch.setattr(k1, "shapes", collections.Counter({(8, 64, 64): 5}))
    ledger = graphs.CaptureLedger()
    with graphs.recording(ledger):
        k1.launches += 2                     # two launches while capturing
        k1.shapes[(8, 64, 64)] += 1
        k1.shapes[(8, 64, 128)] += 1
    assert k1.launches == 5 and k1.shapes == {(8, 64, 64): 5}
    assert [(k.__name__, n, dict(s)) for k, n, s in ledger.launches] == [
        ("sq_matmul_k1", 2, {(8, 64, 64): 1, (8, 64, 128): 1})]
    ledger.emit()
    ledger.emit()
    assert k1.launches == 9
    assert k1.shapes == {(8, 64, 64): 7, (8, 64, 128): 2}


# ------------------------------------------------------ compiled audit
def test_compiled_audit_tallies_every_emit_like_jax():
    """tests/test_compiled_guard.py's per-execution test: N replays tally N
    times the volume, and a capture outside compiled_audit tallies 0 --
    the port's ledger and JAX's cached jit give the same counts."""
    x, w = np.ones((4, 8), np.float32), np.ones((8, 2), np.float32)
    with jcount.compiled_audit():
        f = jax.jit(lambda a, b: jeinsum("mk,kn->mn", a, b,
                                         mode="square_virtual", site="ffn"))
        f(x, w)
    with jcount.track_compiled_contractions() as jc:
        for _ in range(3):
            jax.block_until_ready(f(x, w))
    ledger = graphs.CaptureLedger()
    with tcount.compiled_audit(), graphs.recording(ledger):
        _ffn(torch.from_numpy(x), torch.from_numpy(w))
    with tcount.track_compiled_contractions() as tc:
        for _ in range(3):
            ledger.emit()
    assert tc.summary() == jc.summary()
    assert tc.total_mults == 3 * 4 * 8 * 2

    unaudited = graphs.CaptureLedger()
    with graphs.recording(unaudited):
        _ffn(torch.from_numpy(x), torch.from_numpy(w))
    g = jax.jit(lambda a, b: jeinsum("mk,kn->mn", a, b,
                                     mode="square_virtual", site="ffn"))
    g(x, w)                                   # traced without the audit
    with tcount.track_compiled_contractions() as tc2, \
            jcount.track_compiled_contractions() as jc2:
        unaudited.emit()
        jax.block_until_ready(g(x, w))
    assert tc2.total_mults == jc2.total_mults == 0


def test_eager_audit_around_emits_alone_warns():
    ledger = graphs.CaptureLedger()
    with tcount.compiled_audit(), graphs.recording(ledger):
        _ffn(torch.ones(4, 8), torch.ones(8, 2))
    with pytest.warns(tcount.EmptyAuditWarning):
        with tcount.track_contractions() as ctr:
            ledger.emit()
    assert ctr.total_mults == 0


def test_compiled_audit_env_and_eager_runtime_notes(monkeypatch):
    """``$REPRO_COMPILED_AUDIT`` enables the audit as JAX's does; an
    innermost region wins; a runtime note outside any capture tallies at
    once (JAX's eager callback fires at once)."""
    monkeypatch.setenv("REPRO_COMPILED_AUDIT", "1")
    assert tcount.compiled_audit_enabled() == jcount.compiled_audit_enabled()
    assert tcount.compiled_audit_enabled()
    with tcount.compiled_audit(False):
        assert not tcount.compiled_audit_enabled()
    monkeypatch.delenv("REPRO_COMPILED_AUDIT")
    assert not tcount.compiled_audit_enabled()
    with tcount.track_compiled_contractions() as ctr:
        tcount.emit_runtime_note(site="s", spec="x", mode="standard",
                                 mults=7)
    assert ctr.total_mults == 7 and ctr.fraction_square == 0.0


def _lm_pair(policy, arch="fairsquare-demo"):
    jc = dataclasses.replace(jget(arch).reduced(), matmul_mode="square_pallas")
    tc = dataclasses.replace(tget(arch).reduced(), matmul_mode="square_pallas")
    if policy:
        jc = dataclasses.replace(jc, contraction_policy=J_SQG)
        tc = dataclasses.replace(tc, contraction_policy=T_SQG)
    jm = jbuild(jc)
    params = jm.init(jax.random.PRNGKey(0))
    tm = LM(tc, device=torch.device("cpu"))
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


@pytest.mark.parametrize("route", ["gather", "kernel"])
@pytest.mark.parametrize("policy", [False, True])
def test_decode_step_ledger_matches_jax_compiled_audit(route, policy,
                                                       monkeypatch):
    """One paged decode step of 3 sequences over 128-token tables: the
    port's recorded ledger, emitted once, against JAX's compiled audit of
    the cached jitted step.  Every site JAX reports agrees; on the
    ``kernel`` route JAX's compiled audit has no ``attn_scores`` /
    ``attn_pv`` (its K4 notes are trace-time only) and the port's K4
    runtime notes equal its eager audit."""
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                        raising=False)
    jm, jparams, tm = _lm_pair(policy)
    B, nb, bs = 3, 8, 16
    num_blocks = 1 + B * nb
    tables = (1 + np.arange(B * nb, dtype=np.int32)).reshape(B, nb)
    toks = np.random.default_rng(9).integers(0, tm.cfg.vocab, (B, 1)) \
        .astype(np.int32)
    poss = np.full((B, 1), 8, np.int32)

    def jstep(params, cache, pos_pool, tab, tk, ps):
        hidden, cache, pos_pool = jm.decode_paged(params, cache, tk, ps, tab,
                                                  pos_pool, block_size=bs)
        return jm.logits(params, hidden)[:, -1], cache, pos_pool

    jargs = (jparams, jm.init_paged_cache(num_blocks * bs),
             jnp.asarray(jpaged.empty_pos_pool(num_blocks, bs)),
             jnp.asarray(tables), jnp.asarray(toks), jnp.asarray(poss))
    with _route(f"matmul=virtual,paged_attn={route}"):
        with jcount.compiled_audit():
            f = jax.jit(jstep)
            jax.block_until_ready(f(*jargs))          # traces + runs
        with jcount.track_compiled_contractions() as jc:
            jax.block_until_ready(f(*jargs))          # cached run

    params = tm.tree()
    cache = tm.init_paged_cache(num_blocks * bs)
    pool = torch.from_numpy(tpaged.empty_pos_pool(num_blocks, bs))

    def tstep():
        hidden = tm.decode_paged(params, cache, torch.from_numpy(toks),
                                 torch.from_numpy(poss),
                                 torch.from_numpy(tables), pool,
                                 block_size=bs)
        return tm.logits(params, hidden)[:, -1]

    ledger = graphs.CaptureLedger()
    with _route(f"paged_attn={route}"), torch.no_grad():
        with tcount.track_contractions() as eager:
            tstep()
        with tcount.compiled_audit(), graphs.recording(ledger):
            tstep()
    with tcount.track_compiled_contractions() as tc:
        ledger.emit()

    jsites, tsites = jc.by_site(), tc.by_site()
    assert jsites and all(tsites[s] == d for s, d in jsites.items())
    k4 = {"attn_scores", "attn_pv"}
    if route == "kernel":
        assert not k4 & set(jsites)
        assert {s: tsites[s] for s in k4} == \
            {s: eager.by_site()[s] for s in k4}
        assert tc.total_mults == jc.total_mults + sum(
            tsites[s]["mults"] for s in k4)
    else:
        assert tc.total_mults == jc.total_mults
    assert tsites == eager.by_site()


# ------------------------------------------------------- compiled guard
def test_recorded_saturating_einsum_probes_like_a_jitted_one():
    """Operands past the square form's range inside a capture: no in-line
    trip (nothing can be read there), one probe; its drain trips the same
    key as a jitted JAX call's drain, and ``compiled=False`` probes
    nothing, as in JAX."""
    x, y = _cancelling(32, 64, 32)
    with jguards.guarded(trip_limit=3):
        f = jax.jit(lambda a, b: jeinsum("mk,kn->mn", a, b,
                                         mode="square_exact", site="sat"))
        jax.block_until_ready(f(x, y))
        jtrips = jguards.drain_pending_trips()
    ledger = graphs.CaptureLedger()
    with tguards.guarded(trip_limit=3):
        with graphs.recording(ledger):
            out = teinsum("mk,kn->mn", torch.from_numpy(x),
                          torch.from_numpy(y), mode="square_pallas",
                          site="sat")
        assert not torch.isfinite(out).all()   # served as computed
        assert trouting.route_health().summary()["trips"] == {}
        ledger.emit()
        ttrips = tguards.drain_pending_trips()
    assert ttrips == jtrips == {"sat|1x32x64x32|float32": 1}
    assert trouting.route_health().summary() == \
        jrouting.route_health().summary()

    quiet = graphs.CaptureLedger()
    with tguards.guarded(compiled=False), graphs.recording(quiet):
        teinsum("mk,kn->mn", torch.from_numpy(x), torch.from_numpy(y),
                mode="square_pallas", site="sat")
    assert quiet.probes == [] and quiet.flags is None


def test_guard_policy_compiled_field_and_env(monkeypatch):
    monkeypatch.setenv("REPRO_GUARD", "1")
    monkeypatch.setenv("REPRO_GUARD_COMPILED", "0")
    for g in (tguards, jguards):
        assert g.guard_policy().enabled and not g.guard_policy().compiled
    monkeypatch.delenv("REPRO_GUARD_COMPILED")
    assert tguards.guard_policy() == tguards.GuardPolicy(enabled=True)
    with tguards.guarded(trip_limit=5, compiled=False):
        assert tguards.guard_policy() == tguards.GuardPolicy(
            enabled=True, trip_limit=5, compiled=False)
    tguards.set_guard_policy(True, trip_limit=2, compiled=False)
    assert not tguards.guard_policy().compiled


# step -> [(key, finite?)]: keys a and b, trip limit 2; b never demotes
PROBE_STEPS = [
    [("a|1x4x8x4|float32", True), ("b|2x3x4x5|float32", True)],
    [("a|1x4x8x4|float32", False), ("b|2x3x4x5|float32", True)],
    [("a|1x4x8x4|float32", False), ("a|1x4x8x4|float32", False),
     ("b|2x3x4x5|float32", False)],
    [],
    [("b|2x3x4x5|float32", True), ("a|1x4x8x4|float32", False)],
]


def test_drain_pending_trips_matches_jax():
    """One sequence of probe results through both packages: the same
    pending counts, drained dicts, trips, demoted keys and route-epoch
    moves.  Integer outputs probe nothing."""
    th, jh = trouting.route_health(), jrouting.route_health()
    t0, j0 = trouting.route_epoch(), jrouting.route_epoch()
    for step in PROBE_STEPS:
        for key, ok in step:
            val = np.float32(1.0 if ok else np.nan) * np.ones((2, 2),
                                                              np.float32)
            tguards.emit_trace_probe(key, torch.from_numpy(val))
            jguards.emit_trace_probe(key, jnp.asarray(val))
        tguards.emit_trace_probe("int|1x1x1x1|int32",
                                 torch.zeros(3, dtype=torch.int32))
        jguards.emit_trace_probe("int|1x1x1x1|int32",
                                 jnp.zeros(3, jnp.int32))
        jax.effects_barrier()
        assert tguards.pending_trip_counts() == jguards.pending_trip_counts()
        assert tguards.drain_pending_trips(trip_limit=2) == \
            jguards.drain_pending_trips(trip_limit=2)
        assert th.trips == jh.trips
        assert set(th.demotions) == set(jh.demotions)
        assert trouting.route_epoch() - t0 == jrouting.route_epoch() - j0
    assert th.trips == {"a|1x4x8x4|float32": 4, "b|2x3x4x5|float32": 1}
    assert set(th.demotions) == {"a|1x4x8x4|float32"}
    assert trouting.route_epoch() - t0 == 1
    assert tguards.drain_pending_trips() == {}


# ------------------------------------------------- the engine's loop
GEO = dict(max_slots=4, block_size=16, num_blocks=40, blocks_per_seq=8,
           prefill_chunk=16, max_new_tokens=4)


def _model():
    cfg = dataclasses.replace(tget("fairsquare-demo").reduced(),
                              matmul_mode="square_pallas",
                              contraction_policy=T_SQG)
    return LM(cfg, device=torch.device("cpu"))


class _StubCall:
    """Stands in for ``graphs.CapturedCall`` on the CPU: each call runs the
    model function eagerly and lands the next scheduled probe result (a
    tripped key, or None for a clean call)."""
    schedule, calls, made = [], [], []

    def __init__(self, fn, args, *, device, pool=None, name="call",
                 state=()):
        self.fn, self.name, self.args = fn, name, args
        _StubCall.made.append(name)

    def replay(self):
        return self(*self.args)

    def __call__(self, *args):
        self.args = args
        _StubCall.calls.append(self.name)
        key = _StubCall.schedule.pop(0) if _StubCall.schedule else None
        if key is not None:
            tguards.emit_trace_probe(key, torch.tensor([float("nan")]))
        return self.fn(*(a if isinstance(a, torch.Tensor)
                         else torch.as_tensor(np.asarray(a)) for a in args))

    def release(self):
        pass


@pytest.fixture
def stub_engine(monkeypatch):
    """A CPU engine whose compiled path runs on :class:`_StubCall`."""
    monkeypatch.setattr(graphs, "CapturedCall", _StubCall)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    _StubCall.schedule, _StubCall.calls, _StubCall.made = [], [], []

    def make(**kw):
        eng = teng.Engine(_model(), teng.EngineConfig(**{**GEO, **kw}),
                          device="cpu")
        eng._jit = True
        eng._jit_model_fns()
        return eng
    return make


def _decode_args(eng):
    toks = np.zeros((GEO["max_slots"], 1), np.int32)
    poss = np.full((GEO["max_slots"], 1), -1, np.int32)
    toks[0, 0], poss[0, 0] = 7, 3
    table = eng.tables.table.copy()
    table[0, 0] = 1
    return toks, poss, table


KEY = "ffn|1x4x64x128|float32"


@pytest.mark.parametrize("schedule,limit,retries,calls,trips,rejits", [
    ([], 3, 8, 1, 0, 0),                   # clean: one replay
    ([KEY], 3, 8, 2, 1, 0),                # a trip retries, same graph
    ([KEY], 1, 8, 2, 1, 1),                # a demotion re-captures once
    ([KEY] * 20, 100, 2, 3, 3, 0),         # retries stop at 2 + 1 calls
])
def test_guarded_call_loop(stub_engine, schedule, limit, retries, calls,
                           trips, rejits):
    eng = stub_engine(guard=True, max_step_retries=retries)
    _StubCall.schedule = list(schedule)
    with torch.no_grad(), tguards.guarded(trip_limit=limit):
        logits = eng._guarded_call("_decode", *_decode_args(eng))
    assert logits.shape == (GEO["max_slots"], eng.model.cfg.padded_vocab)
    assert _StubCall.calls == ["_decode"] * calls
    assert eng.metrics.guard_trips == trips
    assert eng.metrics.guard_rejits == rejits
    assert eng._c_work["guard_rejits"].value == rejits
    assert _StubCall.made == ["_decode"] * (1 + rejits)
    assert eng.captures == 1 + rejits
    assert (trouting.route_epoch() == eng._route_epoch) or not rejits


def test_unguarded_compiled_call_is_not_drained(stub_engine):
    eng = stub_engine(guard=False)
    _StubCall.schedule = [KEY]
    with torch.no_grad():
        eng._guarded_call("_decode", *_decode_args(eng))
    assert _StubCall.calls == ["_decode"]
    assert tguards.pending_trip_counts() == {KEY: 1}   # left undrained


def test_retried_call_leaves_the_pools_bit_equal(stub_engine):
    """A prefill chunk retried after a probe trip rewrites the same pool
    positions: K/V pools and pos_pool bit-equal to a clean call's."""
    clean = stub_engine(guard=True)
    retried = stub_engine(guard=True)
    toks = np.zeros((1, GEO["prefill_chunk"]), np.int32)
    poss = np.full((1, GEO["prefill_chunk"]), -1, np.int32)
    toks[0, :5] = [3, 1, 4, 1, 5]
    poss[0, :5] = np.arange(5)
    for eng, sched in ((clean, []), (retried, [KEY])):
        eng.tables.ensure(0, 5)
        _StubCall.schedule = list(sched)
        with torch.no_grad(), tguards.guarded():
            eng._guarded_call("_chunk", toks, poss, eng.tables.table[0:1])
    assert retried.metrics.guard_trips == 1
    assert torch.equal(clean.pos_pool, retried.pos_pool)
    for a, b in zip(clean.cache, retried.cache):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])


def test_guarded_compiled_engine_run_matches_eager(stub_engine):
    """A whole guarded run through the stub's compiled path: the eager
    engine's tokens, 3 captures, 0 trips; the snapshot carries
    ``engine_guard_rejits_total`` and passes ``obs.check``."""
    reqs = make_requests(_model().cfg, 3, seed=2, lo=4, hi=12)
    eager = teng.Engine(_model(), teng.EngineConfig(guard=True, **GEO),
                        device="cpu")
    want = eager.run([Request(r.rid, r.tokens) for r in reqs])
    eng = stub_engine(guard=True)
    got = eng.run([Request(r.rid, r.tokens) for r in reqs])
    assert {k: r.tokens for k, r in got.items()} == \
        {k: r.tokens for k, r in want.items()}
    assert sorted(_StubCall.made) == ["_chunk", "_decode", "_logits_at"]
    assert eng.metrics.guard_trips == eng.metrics.guard_rejits == 0
    snap = eng.obs_snapshot()
    assert snap["counters"]["engine_guard_rejits_total"] == 0
    assert snap["engine"]["guard_rejits"] == 0
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "m.json")
        with open(path, "w") as f:
            json.dump(snap, f)
        assert obs_check.check_snapshot(path) == []


def test_k4_under_capture_is_not_checked_in_line(monkeypatch):
    """A non-finite K4 result inside a capture: no trip and no gather
    recompute (JAX's recompute is eager-only), and the K4 sites still
    get their runtime notes under the compiled audit."""
    calls = []

    def bad(q, *a, **k):
        calls.append(q.shape)
        return torch.full(q.shape, float("nan"))
    bad.launches = 0                         # the wrapper's counter
    monkeypatch.setattr(tk4, "sq_paged_attn_k4", bad)
    monkeypatch.delenv("REPRO_ROUTE", raising=False)
    tm = _model()
    B, nb, bs = 2, 8, 16
    tables = torch.arange(1, 1 + B * nb, dtype=torch.int32).reshape(B, nb)
    cache = tm.init_paged_cache((1 + B * nb) * bs)
    pool = torch.from_numpy(tpaged.empty_pos_pool(1 + B * nb, bs))
    ledger = graphs.CaptureLedger()
    with torch.no_grad(), tguards.guarded(trip_limit=1), \
            tcount.compiled_audit(), graphs.recording(ledger):
        out = tm.decode_paged(tm.tree(), cache,
                              torch.zeros((B, 1), dtype=torch.int32),
                              torch.full((B, 1), 5, dtype=torch.int32),
                              tables, pool, block_size=bs)
    assert len(calls) == tm.cfg.n_layers
    assert not torch.isfinite(out).all()
    assert trouting.route_health().summary()["trips"] == {}
    assert trouting.route_health().recomputes == 0
    sites = [n[0] for n in ledger.notes]
    assert sites.count("attn_scores") == sites.count("attn_pv") \
        == tm.cfg.n_layers


# ------------------------------------------------------- configuration
def test_jit_default_is_eager_on_cpu_with_todays_tokens():
    tm = _model()
    reqs = make_requests(tm.cfg, 3, seed=2, lo=4, hi=12)
    runs = {}
    for jit in (None, False):
        eng = teng.Engine(tm, teng.EngineConfig(jit=jit, **GEO), device="cpu")
        assert not eng._jit and eng.captures == 0
        runs[jit] = {k: r.tokens for k, r in eng.run(
            [Request(r.rid, r.tokens) for r in reqs]).items()}
        assert not eng._graph_set.calls
    assert runs[None] == runs[False]
    server = Server(tm, tm.tree(), ServeConfig(max_batch=2, cache_len=64,
                                               max_new_tokens=3),
                    device="cpu")
    assert not server.jit and server.graph is None
    first = server.run([Request(r.rid, r.tokens) for r in reqs])
    again = server.run([Request(r.rid, r.tokens) for r in reqs])
    assert first == again and server.graph is None   # the cache is reset


def test_jit_true_on_cpu_is_refused():
    tm = _model()
    with pytest.raises(ValueError, match="jit=True"):
        teng.Engine(tm, teng.EngineConfig(jit=True, **GEO), device="cpu")
    with pytest.raises(ValueError, match="jit=True"):
        Server(tm, tm.tree(), ServeConfig(jit=True), device="cpu")


def test_captured_call_refuses_the_cpu_and_propagates_as_a_kernel_fault():
    with pytest.raises(graphs.CaptureError, match="CUDA device"):
        graphs.CapturedCall(lambda a: a, (np.zeros(2),), device="cpu")
    assert issubclass(graphs.CaptureError, KernelError)
    assert issubclass(graphs.CaptureError, teng._KERNEL_FAULTS)


def test_engine_and_server_are_freed_without_the_collector():
    """Their bound model calls hold no reference back to them, so an engine
    or a server (and the graphs, caches and pools it owns) is freed when
    its last reference goes, not at a later collection -- which could run
    during another object's capture."""
    import gc
    import weakref
    tm = _model()
    collecting = gc.isenabled()
    gc.disable()
    try:
        for jit in (False, True):
            eng = teng.Engine(tm, teng.EngineConfig(**GEO), device="cpu")
            eng._jit = jit
            eng._jit_model_fns()
            ref = weakref.ref(eng)
            del eng
            assert ref() is None
        server = Server(tm, tm.tree(), ServeConfig(), device="cpu")
        ref = weakref.ref(server)
        del server
        assert ref() is None
    finally:
        if collecting:
            gc.enable()
