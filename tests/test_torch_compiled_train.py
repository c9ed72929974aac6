"""The port's captured train step on the CPU, against the JAX package's
jitted one (``tests/test_compiled_guard.py``'s train half).

The port captures a whole train step (forward, the square-routed backward,
AdamW) into one CUDA graph (``core/graphs.py``'s ``CapturedFunction``,
``train/step.py``'s ``jit_train_step`` and ``GuardedStep(jit=True)``),
which this host cannot run.  What it can run is the capture ledger: a call
made inside ``graphs.recording(ledger)`` fills the ledger as a capture
does (runtime contraction notes, finite probes, kernel launch deltas; no
in-line finite check, no eager note), and ``ledger.emit()`` is what each
replay adds on the host.  A stub (:class:`_StubCall`) stands in for the
CUDA graph with its contract: static inputs written by each call, a
warm-up and a capture recorded, routes fixed at capture, and static
outputs that every replay overwrites in place.  So:

- the recorded train step's ledger against JAX's compiled audit of a
  cached jitted step, every site and its ``.bwd_x`` / ``.bwd_w``; N emits
  tally N times; an eager counter around emits alone warns;
- the recorded saturating step (cotangent ~1e22): it probes instead of
  recomputing in line, its drained trips equal a jitted JAX step's, and
  only ``chaos.bwd_*`` keys demote;
- ``GuardedStep(jit=True)``'s loop on the stub: for each schedule its
  ``stats()`` equal JAX's jitted ``GuardedStep``'s, the clean path is
  bit-equal to the bare step, an epoch move re-captures once, a
  persistent trip raises ``still tripping``; and the aliasing trap: with
  the caller's params the previous replay's outputs, which the tripped
  replay overwrote, the retry and the re-capture still compute from the
  original inputs, bit-equal to the eager guarded step;
- the ``Trainer`` over the stub-captured step: the eager trainer's losses
  and params; a retry after a call that raised past its replay, and a
  rollback or resume, start from the committed or restored state written
  into the static inputs; the initial snapshot holds the caller's tensors;
- defaults (``jit=None`` eager on the CPU, ``jit=True`` refused) and key
  changes (``--grad-compression``'s second signature captures anew).
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.core import counting as jcount  # noqa: E402
from repro.core import guards as jguards  # noqa: E402
from repro.core.einsum import fs_einsum as jeinsum  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.kernels import routing as jrouting  # noqa: E402
from repro.models.lm import build_model as jbuild  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import loss as jloss  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import train_state_from_jax  # noqa: E402
from repro_torch.core import counting as tcount  # noqa: E402
from repro_torch.core import graphs  # noqa: E402
from repro_torch.core import guards as tguards  # noqa: E402
from repro_torch.core.einsum import fs_einsum as teinsum  # noqa: E402
from repro_torch.core.tree import (tree_flatten, tree_leaves,  # noqa: E402
                                   tree_map, tree_unflatten)
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import routing as trouting  # noqa: E402
from repro_torch.models.lm import build_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import step as step_mod  # noqa: E402
from repro_torch.train.faults import (TrainFaultInjector,  # noqa: E402
                                      TrainFaultPlan)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from test_torch_moe import _one_thread  # noqa: E402,F401

# tests/test_compiled_guard.py::_tiny_train_world's config
TINY = dict(name="tiny-compiled-audit", family="dense", n_layers=2,
            d_model=32, n_heads=2, n_kv_heads=2, d_ff=64, vocab=128,
            head_dim=16, dtype="float32", scan_layers=False, remat="none",
            attn_chunk_q=16, attn_chunk_kv=16, loss_chunk=16, max_seq=64,
            matmul_mode="square_virtual")
# sites whose JAX notes come from a traced scan body: held to JAX's audit
# of the forward alone, as tests/test_torch_train.py holds them
CHUNKED_SITES = ("attn_scores", "attn_pv", "loss")
CUDA = torch.device("cuda")     # the stub ignores it; no CUDA call is made


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


# ------------------------------------------------------------ the stub
class _StubCall:
    """Stands in for ``graphs.CapturedCall`` on the CPU, with its contract:
    the first call's inputs copied into static inputs (``inputs``), a
    warm-up recorded into a ledger that is thrown away (its launches
    counted), a capture recorded into ``ledger`` with the routes of that
    moment fixed for every replay, and static outputs that each replay
    overwrites in place.  A replay runs the function again on the static
    inputs under a recording (so it checks nothing in line and notes
    nothing eagerly) and emits the capture's notes and launches and its
    own probe flags, as a graph writes its flag vector anew."""
    made = []

    def __init__(self, fn, args, *, device, pool=None, name="call",
                 state=()):
        self.fn, self.name = fn, name
        leaves, self._treedef = tree_flatten(tuple(args))
        self._static = [a.clone() if isinstance(a, torch.Tensor)
                        else torch.as_tensor(np.array(a)) for a in leaves]
        self.inputs = tree_unflatten(self._treedef, self._static)
        with graphs.recording(graphs.CaptureLedger()) as warm:
            fn(*self.inputs)
        warm.count_launches()
        self._routes = dict(trouting.route_health().demotions)
        self.ledger = graphs.CaptureLedger()
        with graphs.recording(self.ledger):
            self.outputs = fn(*self.inputs)
        self.replays = 0
        self.released = False
        _StubCall.made.append(self)

    def _write(self, args):
        leaves, treedef = tree_flatten(tuple(args))
        assert treedef == ("tuple", self._treedef[1][:len(args)])
        for arg, static in zip(leaves, self._static):
            if not isinstance(arg, torch.Tensor):
                arg = torch.as_tensor(np.asarray(arg))
            if arg.data_ptr() != static.data_ptr():
                static.copy_(arg)

    def replay(self):
        assert not self.released
        health = trouting.route_health()
        now, health.demotions = health.demotions, dict(self._routes)
        run = graphs.CaptureLedger()
        try:
            with graphs.recording(run):
                out = self.fn(*self.inputs)
        finally:
            health.demotions = now
        for o, n in zip(tree_leaves(self.outputs), tree_leaves(out)):
            o.copy_(n)
        for note in self.ledger.notes:
            tcount.land_runtime_note(*note)
        if run.flags is not None:
            tguards.land_probes(*run.flags)
        self.ledger.count_launches()
        self.replays += 1
        return self.outputs

    def __call__(self, *args):
        self._write(args)
        return self.replay()

    def release(self):
        self.released = True
        self.outputs = None


@pytest.fixture
def stub(monkeypatch):
    monkeypatch.setattr(graphs, "CapturedCall", _StubCall)
    _StubCall.made = []
    return _StubCall


# --------------------------------------------------- the tiny world
@pytest.fixture(scope="module")
def world():
    """_tiny_train_world's JAX model, initial state and 3 batches."""
    jm = jbuild(JModelConfig(**TINY))
    params = jm.init(jax.random.PRNGKey(0))
    opt = jadamw.adamw_init(params)
    batches = JSyntheticLM(JDataConfig(global_batch=2, seq_len=32,
                                       vocab=128, seed=5)).take(3)
    return jm, params, opt, batches


def _port_state(world):
    _, params, opt, _ = world
    return train_state_from_jax(jax.tree.map(np.asarray, params),
                                jax.tree.map(np.asarray, opt))


def _port_batches(n=3, seed=5):
    return SyntheticLM(DataConfig(global_batch=2, seq_len=32, vocab=128,
                                  seed=seed), device="cpu").take(n)


def _port_step(mode="square_pallas", **tkw):
    model = build_model(ModelConfig(**dict(TINY, matmul_mode=mode)),
                        device="cpu")
    return step_mod.make_train_step(model, step_mod.TrainConfig(**tkw))


# ------------------------------------------- the recorded step's ledger
def test_recorded_train_step_ledger_equals_jax_compiled_audit(world):
    """The ledger of a train step recorded under ``compiled_audit`` tallies,
    at each emit, JAX's compiled audit of a cached jitted step on every
    site it notes per execution, both gradients included; the chunked
    sites (a JAX scan body) equal JAX's audit of the forward alone, each
    gradient site its forward.  N emits tally N times; the recording
    itself notes nothing eagerly, and an eager counter around emits alone
    warns as JAX's does around a cached call."""
    jm, params, opt, batches = world
    with jcount.compiled_audit():
        jfn = jax.jit(jstep.make_train_step(jm, jstep.TrainConfig()))
        jp, jo, _ = jfn(params, opt, batches[0])
        jax.block_until_ready(jp)
    with jcount.track_compiled_contractions() as jc:
        jax.block_until_ready(jfn(jp, jo, batches[1])[2]["loss"])
    want = {k: v["mults"] for k, v in jc.by_site().items()}

    step = _port_step("square_virtual")
    p, o = _port_state(world)
    ledger = graphs.CaptureLedger()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with tcount.compiled_audit(), \
                tcount.track_contractions() as eager, \
                graphs.recording(ledger):
            step(p, o, _port_batches()[0])
    assert eager.records == []
    assert any(issubclass(c.category, tcount.EmptyAuditWarning)
               for c in caught)
    with tcount.track_compiled_contractions() as tc:
        ledger.emit()
    got = {k: v["mults"] for k, v in tc.by_site().items()}
    assert set(got) == set(want)
    assert tc.fraction_square == jc.fraction_square == 1.0
    assert tc.fraction_square_bwd == jc.fraction_square_bwd == 1.0
    fwd = {s: m for s, m in got.items() if ".bwd_" not in s}
    for s, m in want.items():
        if s.split(".")[0] not in CHUNKED_SITES:
            assert got[s] == m, s
    for s, m in fwd.items():
        assert got[f"{s}.bwd_x"] == got[f"{s}.bwd_w"] == m, s
    with jcount.track_contractions() as jfwd:
        tok = batches[0]["tokens"]
        hidden, _, _ = jm.forward(params, {"tokens": tok[:, :-1]})
        jloss.chunked_xent(hidden, tok[:, 1:], params["embed"]["table"],
                           chunk=TINY["loss_chunk"], mode="square_virtual")
    for s, m in jfwd.by_site().items():
        assert fwd[s] == m["mults"], s

    with tcount.track_compiled_contractions() as tc3:
        for _ in range(3):
            ledger.emit()
    assert tc3.total_mults == 3 * tc.total_mults
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with tcount.track_contractions() as tctr:
            ledger.emit()
    assert tctr.total_mults == 0
    assert any(issubclass(c.category, tcount.EmptyAuditWarning)
               for c in caught)


# ------------------------------------------------ the saturating step
RNG_SEED = 23


def _sat_operands(m=8, k=16, n=4):
    rng = np.random.default_rng(RNG_SEED)
    return (rng.normal(size=(m, k)).astype(np.float32),
            rng.normal(size=(k, n)).astype(np.float32))


def _jax_sat_step(mode):
    """tests/test_compiled_guard.py::_make_sat_step."""
    def train_step(params, opt_state, batch):
        def loss_fn(p):
            out = jeinsum("mk,kn->mn", batch["x"], p["w"], mode=mode,
                          site="chaos")
            return jnp.sum(out) * 1e22
        loss, grads = jax.value_and_grad(loss_fn)(params)
        return params, opt_state, {"loss": loss, "grads": grads}
    return train_step


def _sat_step(mode="square_exact"):
    """The port's twin: the loss scale puts the VJP cotangent at ~1e22, so
    the square form's ``(g + w)^2`` and ``(g + x)^2`` in the backward
    contractions are inf in f32 while the standard route's products stay
    finite.  JAX's ``custom_vjp`` computes (and probes) dL/dx of the batch
    operand too, though nothing differentiates it; the port's VJP computes
    only the gradients autograd asks for, so here ``x`` asks for one."""
    def loss_fn(p, batch):
        x = batch["x"].detach().requires_grad_(True)
        out = teinsum("mk,kn->mn", x, p["w"], mode=mode, site="chaos")
        return torch.sum(out) * 1e22, {}

    def train_step(params, opt_state, batch):
        (loss, _), grads = step_mod.value_and_grad(loss_fn, params, batch)
        return params, opt_state, {"loss": loss, "grads": grads}
    return train_step


def _bwd_only(keys):
    return keys and all(k.split("|")[0].startswith("chaos.bwd_")
                        for k in keys)


def test_recorded_saturating_step_probes_like_a_jitted_one():
    x, w = _sat_operands()
    with jguards.guarded(trip_limit=1):
        _, _, jm = jax.jit(_jax_sat_step("square_exact"))(
            {"w": jnp.asarray(w)}, {}, {"x": jnp.asarray(x)})
        jax.block_until_ready(jm)
        jtrips = jguards.drain_pending_trips()
    ledger = graphs.CaptureLedger()
    with tguards.guarded(trip_limit=1), graphs.recording(ledger):
        _sat_step()({"w": torch.from_numpy(w)}, {}, {"x": torch.from_numpy(x)})
    health = trouting.route_health()
    # no in-line check ran: nothing tripped, nothing was recomputed
    assert health.trips == {} and health.recomputes == 0
    assert sorted(k for k, _ in ledger.probes) == [
        "chaos.bwd_w|1x4x8x16|float32", "chaos.bwd_x|1x8x4x16|float32",
        "chaos|1x8x16x4|float32"]
    ledger.emit()
    with tguards.guarded(trip_limit=1):
        trips = tguards.drain_pending_trips()
    assert trips == jtrips == {"chaos.bwd_w|1x4x8x16|float32": 1,
                               "chaos.bwd_x|1x8x4x16|float32": 1}
    assert _bwd_only(health.demotions) and \
        set(health.demotions) == set(jrouting.route_health().demotions)


# ------------------------------------------------- GuardedStep's loop
@pytest.mark.parametrize("trip_limit,max_retries,want", [
    (1, 4, {"guard_trips": 2, "rejits": 1, "retries": 1}),   # epoch move
    (2, 4, {"guard_trips": 4, "rejits": 1, "retries": 2}),   # trip, retry
    (100, 2, None),                                          # persistent
])
def test_guarded_step_loop_matches_jax(stub, trip_limit, max_retries, want):
    """The stub-captured ``GuardedStep(jit=True)`` against JAX's jitted one
    on the saturating step: equal ``stats()`` and route health; a
    demotion re-captures exactly once and the retry's gradients are the
    standard route's; a trip that never demotes within the retries raises
    ``still tripping``."""
    x, w = _sat_operands()
    jgs = jstep.GuardedStep(_jax_sat_step("square_exact"), jit=True,
                            trip_limit=trip_limit, max_retries=max_retries)
    gs = step_mod.GuardedStep(_sat_step(), jit=True, trip_limit=trip_limit,
                              max_retries=max_retries)
    gs._bind = lambda params: _bind_stub(gs)
    if want is None:
        with pytest.raises(RuntimeError, match="still tripping"):
            jgs({"w": jnp.asarray(w)}, {}, {"x": jnp.asarray(x)})
        with pytest.raises(RuntimeError, match="still tripping"):
            gs({"w": torch.from_numpy(w)}, {}, {"x": torch.from_numpy(x)})
        assert gs.stats() == jgs.stats()
        assert gs.captures == 1 and len(stub.made) == 1
        return
    _, _, jm = jgs({"w": jnp.asarray(w)}, {}, {"x": jnp.asarray(x)})
    _, _, m = gs({"w": torch.from_numpy(w)}, {}, {"x": torch.from_numpy(x)})
    assert jgs.stats() == gs.stats() == want
    assert gs.captures == 2 and len(stub.made) == 2 and stub.made[0].released
    h, jh = trouting.route_health(), jrouting.route_health()
    assert h.trips == jh.trips and set(h.demotions) == set(jh.demotions)
    assert _bwd_only(h.demotions)
    std = jax.grad(lambda v: jnp.sum(jnp.einsum("mk,kn->mn", x, v))
                   * 1e22)(jnp.asarray(w))
    for ref in (std, jm["grads"]["w"]):
        np.testing.assert_allclose(m["grads"]["w"].numpy(),
                                   np.asarray(ref), rtol=1e-5)
    # steady state: the re-captured graph is clean
    gs({"w": torch.from_numpy(w)}, {}, {"x": torch.from_numpy(x)})
    assert gs.stats() == want and gs.captures == 2


def _bind_stub(gs):
    """``GuardedStep._bind`` on CPU params, as on CUDA ones: the stub
    graph stands in for the card's."""
    gs._jit = True
    gs._fn = graphs.CapturedFunction(gs._raw, device=CUDA,
                                     name="guarded_train_step",
                                     epoch_keyed=True)


def test_guarded_step_clean_path_is_transparent(stub):
    """No saturation: one capture, no trip, retry or re-capture, and the
    outputs bit-equal to the bare step's (tests/test_compiled_guard.py's
    clean-path test)."""
    x, w = _sat_operands()

    def step(params, opt_state, batch):
        out = teinsum("mk,kn->mn", batch["x"], params["w"],
                      mode="square_exact", site="clean")
        return params, opt_state, {"loss": torch.sum(out), "out": out}

    gs = step_mod.GuardedStep(step, jit=True, trip_limit=1)
    gs._bind = lambda params: _bind_stub(gs)
    args = ({"w": torch.from_numpy(w)}, {}, {"x": torch.from_numpy(x)})
    _, _, guarded = gs(*args)
    _, _, raw = step(*args)
    assert gs.stats() == {"guard_trips": 0, "rejits": 0, "retries": 0}
    assert gs.captures == 1 and stub.made[0].replays == 1
    assert adamw.tree_fingerprint(guarded["out"]) == \
        adamw.tree_fingerprint(raw["out"])


def _update_step():
    """The saturating construction inside a step that updates its state:
    the scale is a batch leaf, so one graph serves a clean and a
    saturating batch, and the new params depend on the gradients."""
    def loss_fn(p, batch):
        out = teinsum("mk,kn->mn", batch["x"], p["w"], mode="square_exact",
                      site="chaos")
        return torch.sum(out) * batch["scale"], {}

    def train_step(params, opt_state, batch):
        (loss, _), grads = step_mod.value_and_grad(loss_fn, params, batch)
        new = tree_map(lambda p, g: p - 1e-24 * g, params, grads)
        return new, {"n": opt_state["n"] + 1}, {"loss": loss}
    return train_step


@pytest.mark.parametrize("trip_limit", [1, 2])
def test_retry_and_recapture_start_from_the_original_inputs(stub,
                                                            trip_limit):
    """The aliasing trap.  Step 2 is called with step 1's outputs, the
    graph's static outputs (the clean step 1 wrote its new state back into
    the static inputs and returned those, but a caller may hold the
    outputs, which carry the same state); its tripped replay overwrites
    them.  The retry (``trip_limit`` 2: first a plain retry, then a
    re-capture) and the re-capture (``trip_limit`` 1) still start from
    step 1's state, as it was when step 2 was called: the result is
    bit-equal to the eager guarded step's from a copy of that state."""
    x, w = _sat_operands()
    step = _update_step()
    gs = step_mod.GuardedStep(step, jit=True, trip_limit=trip_limit)
    gs._bind = lambda params: _bind_stub(gs)
    clean = {"x": torch.from_numpy(x), "scale": torch.tensor(1.0)}
    sat = {"x": torch.from_numpy(x), "scale": torch.tensor(1e22)}
    p1, o1, _ = gs({"w": torch.from_numpy(w)}, {"n": torch.tensor(0)}, clean)
    assert gs.stats()["guard_trips"] == 0
    # the clean step's state was written back into the static inputs
    assert p1["w"] is stub.made[0].inputs[0]["w"]
    p1, o1, _ = stub.made[0].outputs             # the same state
    held = tree_map(torch.clone, (p1, o1))       # step 1's state, copied
    p2, o2, m2 = gs(p1, o1, sat)
    assert gs.stats()["rejits"] == 1
    assert gs.stats()["retries"] == gs.stats()["guard_trips"] == trip_limit
    # the caller's tensors were the first graph's outputs: overwritten by
    # the tripped replay
    assert not torch.equal(p1["w"], held[0]["w"])
    trouting.reset_route_health()
    recomputes = trouting.route_health().recomputes
    with tguards.guarded(trip_limit=trip_limit):
        for _ in range(trip_limit):
            ep, eo, em = step(*held, sat)
    assert trouting.route_health().recomputes - recomputes == trip_limit
    assert adamw.tree_fingerprint((p2, o2, m2)) == \
        adamw.tree_fingerprint((ep, eo, em))
    assert bool(torch.isfinite(p2["w"]).all())


# ---------------------------------------------------------- the Trainer
def _trainer(tmp_path, step, faults=None, total=4, **kw):
    params, opt = _port_state(_world_cache())
    data = SyntheticLM(DataConfig(global_batch=2, seq_len=32, vocab=128,
                                  seed=7), device="cpu")
    cfg = TrainerConfig(total_steps=total, ckpt_every=2,
                        ckpt_dir=str(tmp_path), keep=3, log_every=2, **kw)
    return Trainer(cfg, step, params, opt, data, faults=faults)


_WORLD = {}


def _world_cache():
    if not _WORLD:
        jm = jbuild(JModelConfig(**TINY))
        params = jm.init(jax.random.PRNGKey(0))
        _WORLD["w"] = (jm, params, jadamw.adamw_init(params), None)
    return _WORLD["w"]


def _aliases(tree, static) -> bool:
    return all(a.data_ptr() == b.data_ptr()
               for a, b in zip(tree_leaves(tree), tree_leaves(static)))


def test_trainer_over_a_captured_step_matches_eager(tmp_path, stub,
                                                    monkeypatch):
    """The trainer over the stub-captured step, under a fault schedule
    whose calls 1 and 3 raise: the eager trainer's losses and params bit
    for bit, its first step's audit from the compiled counter equal to
    the eager one's, one capture.  The committed state lives in the
    graph's static inputs (each call donates it back there), from which
    the retries start; the initial snapshot is the caller's own tensors,
    untouched and never a graph buffer."""
    plan = TrainFaultPlan.of(step_fail=(1, 3))
    eager = _trainer(tmp_path / "eager", _port_step(),
                     faults=TrainFaultInjector(plan))
    base = eager.run()
    assert base["captures"] == 0 and base["contraction_audit"] is not None

    jitted = step_mod.jit_train_step(_port_step(), CUDA)
    seen = []
    replay = _StubCall.replay

    def spy(call):
        seen.append(_aliases((tr.params, tr.opt_state), call.inputs[:2]))
        return replay(call)
    monkeypatch.setattr(stub, "replay", spy)
    tr = _trainer(tmp_path / "jit", jitted, faults=TrainFaultInjector(plan))
    init = adamw.tree_fingerprint(tr._init_snapshot[0])
    res = tr.run()
    assert res["captures"] == 1 and res["step_failures"] == 2
    assert res["loss_trajectory"] == base["loss_trajectory"]
    assert adamw.tree_fingerprint(tr.params) == \
        adamw.tree_fingerprint(eager.params)
    assert res["contraction_audit"]["by_site"] == \
        base["contraction_audit"]["by_site"]
    assert res["contraction_audit"]["fraction_square_bwd"] == 1.0
    # the first replay's inputs were copied from the caller's tensors; every
    # later one ran on the state the trainer committed, in place
    assert seen == [False] + [True] * (len(seen) - 1) and len(seen) == 4
    assert _aliases((tr.params, tr.opt_state), jitted.current.inputs[:2])
    assert adamw.tree_fingerprint(tr._init_snapshot[0]) == init
    static = tree_leaves(stub.made[0].inputs[:2])
    assert not any(t.data_ptr() == s.data_ptr() for t in tree_leaves(
        tr._init_snapshot[0]) for s in static)


def test_trainer_rollback_and_resume_write_the_static_inputs(tmp_path,
                                                             stub):
    """A poisoned update rolls back: the restored trees are written into
    the captured step's static inputs and the trainer holds them there;
    the run ends bit-equal to the eager faulted run.  A resume adopts the
    checkpoint the same way."""
    plan = TrainFaultPlan.of(nan_grad=(2,))
    eager = _trainer(tmp_path / "eager", _port_step(),
                     faults=TrainFaultInjector(plan))
    base = eager.run()
    assert base["rollbacks"] >= 1

    step = step_mod.jit_train_step(_port_step(), CUDA)
    tr = _trainer(tmp_path / "jit", step, faults=TrainFaultInjector(plan))
    restored = []
    orig = tr._rollback

    def spy():
        orig()
        restored.append(_aliases((tr.params, tr.opt_state),
                                 step.current.inputs[:2]))
    tr._rollback = spy
    res = tr.run()
    assert res["rollbacks"] == base["rollbacks"] and all(restored)
    assert res["loss_trajectory"] == base["loss_trajectory"]
    assert adamw.tree_fingerprint(tr.params) == \
        adamw.tree_fingerprint(eager.params)

    again = _trainer(tmp_path / "jit", step, total=4)
    assert again.maybe_resume() and again.step == 4
    assert _aliases(again.params, step.current.inputs[0])
    assert adamw.tree_fingerprint(again.params) == \
        adamw.tree_fingerprint(eager.params)


def test_capture_error_propagates_out_of_the_trainer(tmp_path):
    """A capture that fails is a ``CaptureError`` (a ``KernelError``) that
    propagates out of the run at once: not absorbed as a step failure and
    retried, never run eagerly instead."""
    def failing(params, opt_state, batch):
        raise graphs.CaptureError("capturing train_step failed")

    tr = _trainer(tmp_path, failing)
    with pytest.raises(graphs.CaptureError, match="capturing train_step"):
        tr.run()
    assert tr.step_failures == 0 and tr.step == 0


def test_grad_compression_key_change_captures_anew(stub, world):
    """``grad_compression`` adds ``opt_state["error_feedback"]`` after the
    first step: that step's new state cannot be written back into its
    graph (another signature) and is returned as the graph's outputs; the
    second step's tree structure is a new key, captured and counted, as
    JAX re-traces; the third replays it on its donated state.  The
    results equal the eager step's."""
    step = _port_step(grad_compression=True)
    jitted = step_mod.jit_train_step(step, CUDA)
    p, o = _port_state(world)
    ep, eo = p, o
    for i, b in enumerate(_port_batches()):
        p, o, m = jitted(p, o, b)
        ep, eo, em = step(ep, eo, b)
        assert jitted.captures == min(i + 1, 2)
        assert adamw.tree_fingerprint((p, o, m["loss"])) == \
            adamw.tree_fingerprint((ep, eo, em["loss"]))
    assert len(jitted.calls) == 2 and stub.made[1].replays == 2
    assert _aliases((p, o), stub.made[1].inputs[:2])


def test_signature_keys_structure_shape_and_dtype():
    """What a capture is keyed on: the tree structure and each leaf's
    shape and dtype, a host array and a device tensor of one shape and
    dtype alike."""
    a = {"w": torch.zeros(2, 3), "n": [np.int32(1)]}
    assert graphs.signature((a,)) == graphs.signature(
        ({"w": np.ones((2, 3), np.float32), "n": [np.int32(7)]},))
    assert graphs.signature((a,)) != graphs.signature(
        ({"w": torch.zeros(2, 3), "n": [np.int32(1)], "e": 0},))
    assert graphs.signature((a,)) != graphs.signature(
        ({"w": torch.zeros(2, 4), "n": [np.int32(1)]},))
    assert graphs.signature((a,)) != graphs.signature(
        ({"w": torch.zeros(2, 3, dtype=torch.bfloat16),
          "n": [np.int32(1)]},))


# ------------------------------------------------------------ defaults
def test_jit_default_is_eager_on_cpu_with_todays_results(world):
    step = _port_step()
    gs = step_mod.GuardedStep(step)
    p, o = _port_state(world)
    b = _port_batches()[0]
    out = gs(p, o, b)
    assert gs.captures == 0 and gs._fn is step
    assert adamw.tree_fingerprint(out) == adamw.tree_fingerprint(
        step(p, o, b))


def test_jit_true_and_captures_refused_on_cpu(world):
    p, o = _port_state(world)
    b = _port_batches()[0]
    with pytest.raises(ValueError, match="jit=True"):
        step_mod.GuardedStep(_port_step(), jit=True)(p, o, b)
    with pytest.raises(graphs.CaptureError, match="CUDA device"):
        step_mod.jit_train_step(_port_step(), "cpu")


def test_launcher_on_the_cpu_runs_eagerly(tmp_path, capsys):
    from repro_torch.launch import train as launch
    out = launch.main(["--device", "cpu", "--reduced", "--steps", "2",
                       "--global-batch", "2", "--seq", "16",
                       "--ckpt-dir", str(tmp_path / "ck"),
                       "--matmul-mode", "square_pallas"])
    assert out["captures"] == 0 and out["final_step"] == 2
    assert "done at step 2 (captures: 0," in capsys.readouterr().out
