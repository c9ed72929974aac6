"""The port's square-routed MoE training against the JAX package (the MoE
half of ``tests/test_train_square.py``'s contract and
``tests/test_blocks_units.py``'s MoE tests under autograd).

Both packages start from one state (``train_state_from_jax``) and train on
batches that are bit-identical by construction.  Two MoE configs:

- ``moonshot-v1-16b-a3b.reduced()`` (2 layers, d 64, 4 experts top-2,
  capacity factor 8.0: no token is dropped), f32;
- ``tiny-moe-train`` (2 layers, d 32, 8 experts top-3, capacity factor
  0.5): every layer drops assignments, so the sink row's gradient, and
  routes past top-2, are held too.

What is held, at ``tests/test_torch_train.py``'s tolerances for the dense
model:

- one step's gradient tree, leaf by leaf, against ``jax.value_and_grad`` of
  JAX's loss in every mode under ``remat`` none and block (the multiplier
  modes at 1e-5; the square modes at 4e-5 with the loss scaled by its
  token count, 2e-3 unscaled), and the aux loss with its gradient on its
  own.  The square modes are held to JAX's ``square_virtual``, as the
  dense test holds them, and ``square_pallas`` with its loss scaled also
  to JAX's ``square_pallas`` scaled alike, whose Pallas kernels run in
  interpret mode here (the ``pltpu.TPUCompilerParams`` alias below);
- 3 AdamW steps' losses (rtol 2e-3, atol 2e-3) and parameters (within a
  tenth of their movement);
- the audit of one step against JAX's (``scan_layers=False``: JAX's audit
  double-counts scanned bodies), every ``moe_*`` site once at the forward,
  ``.bwd_x`` and ``.bwd_w``;
- the microbatched step (its capacity from the microbatch's tokens);
- ``train_state_from_jax`` of a scanned MoE state and a checkpoint round
  trip;
- the launcher with ``--reduced`` for both MoE archs;
- the captured MoE step on ``tests/test_torch_compiled_train.py``'s stub
  graph, equal to the eager step, and ``GuardedStep(jit=True)`` clean;
- the recompute under ``remat="block"`` routes as the forward did.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.core import counting as jcount  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.lm import build_model as jbuild  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import loss as jloss  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import (params_from_jax,  # noqa: E402
                                 train_state_from_jax,
                                 tree_from_state_dict)
from repro_torch.core import counting as tcount  # noqa: E402
from repro_torch.core import graphs  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.lm import build_model  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import step as step_mod  # noqa: E402
from test_torch_compiled_train import (CUDA, _bind_stub,  # noqa: E402
                                       _StubCall)
from test_torch_moe import _one_thread  # noqa: E402,F401

# The JAX package's Pallas wrappers pass ``pltpu.TPUCompilerParams``, which
# JAX 0.9.0 renamed ``CompilerParams``; set here too, so that this file's
# JAX square_pallas runs its kernels in interpret mode whether or not
# another file that sets the alias is collected.
if not hasattr(pltpu, "TPUCompilerParams"):
    pltpu.TPUCompilerParams = pltpu.CompilerParams

N_STEPS = 3
RTOL = ATOL = 2e-3            # tests/test_train_square.py's tolerance
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10)   # as test_torch_train
BATCH = dict(global_batch=2, seq_len=32, seed=5)
TINY_MOE = dict(name="tiny-moe-train", family="moe", n_layers=2, d_model=32,
                n_heads=2, n_kv_heads=2, d_ff=64, vocab=128, head_dim=16,
                n_experts=8, topk=3, capacity_factor=0.5,
                block_pattern=("moe",), dtype="float32", scan_layers=False,
                remat="none", attn_chunk_q=16, attn_chunk_kv=16,
                loss_chunk=16, max_seq=64)
CFGS = ("moonshot-v1-16b-a3b", "tiny-moe-train")
MODES = [("standard", "standard"), ("square_virtual", "square_virtual"),
         ("square_exact", "square_virtual"),
         ("square_scan", "square_virtual"),
         ("square_pallas", "square_virtual")]
CHUNKED_SITES = ("attn_scores", "attn_pv", "loss")


def _cfgs(name, mode="standard", **kw):
    """(JAX config, port config) of one of ``CFGS``."""
    if name == "tiny-moe-train":
        base = dict(TINY_MOE, matmul_mode=mode, **kw)
        return JModelConfig(**base), ModelConfig(**base)
    kw = dict(dict(matmul_mode=mode, scan_layers=False), **kw)
    return (dataclasses.replace(jget(name).reduced(), **kw),
            dataclasses.replace(tget(name).reduced(), **kw))


def _jbatches(vocab, n=N_STEPS):
    return JSyntheticLM(JDataConfig(vocab=vocab, **BATCH)).take(n)


def _batches(vocab, n=N_STEPS):
    return SyntheticLM(DataConfig(vocab=vocab, **BATCH),
                       device="cpu").take(n)


_STATES = {}


def _jax_state(name):
    """The JAX model's initial params and AdamW state of config ``name``."""
    if name not in _STATES:
        jc, _ = _cfgs(name)
        params = jbuild(jc).init(jax.random.PRNGKey(0))
        _STATES[name] = (params, jadamw.adamw_init(params))
    return _STATES[name]


def _port_state(name):
    params, opt = _jax_state(name)
    return train_state_from_jax(jax.tree.map(np.asarray, params),
                                jax.tree.map(np.asarray, opt))


def _port_params(jparams):
    return tree_from_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jparams)))


def _rel(a, b):
    return ((a.double() - b.double()).norm()
            / b.double().norm().clamp_min(1e-300)).item()


def _routings(monkeypatch):
    """Record every ``moe_dispatch`` call's expert indices and
    destinations."""
    seen = []
    real = tmoe.moe_dispatch

    def spy(expert_idx, gate_vals, n_experts, capacity):
        d = real(expert_idx, gate_vals, n_experts, capacity)
        seen.append((expert_idx.clone(), d["dest"].clone(),
                     int(capacity)))
        return d
    monkeypatch.setattr(tmoe, "moe_dispatch", spy)
    return seen


@pytest.fixture(autouse=True)
def _no_tuning_cache(monkeypatch):
    # the JAX tile planner warns on every cache miss unless autotune is off
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


# ------------------------------------------------------ the tiny config
def test_tiny_config_drops_and_routes_as_jax(monkeypatch):
    """The tiny config routes top-3 over 8 experts and drops assignments
    in every layer; each layer's routing (expert indices, destinations,
    the sink row ``E * C`` for a drop) equals JAX's lines of
    ``repro/models/moe.py`` on the same block input and weights."""
    from test_torch_moe import _jax_routing
    jc, tc = _cfgs("tiny-moe-train")
    seen, inputs = _routings(monkeypatch), []
    real = tmoe.moe_apply_local
    monkeypatch.setattr(tmoe, "moe_apply_local", lambda p, x, **kw: (
        inputs.append(x.numpy().copy()) or real(p, x, **kw)))
    model = build_model(tc, device="cpu")
    p, _ = _port_state("tiny-moe-train")
    with torch.no_grad():
        step_mod.make_loss_fn(model, step_mod.TrainConfig())(
            p, _batches(tc.vocab, 1)[0])
    assert len(seen) == len(inputs) == tc.n_layers
    E, C = tc.n_experts, seen[0][2]
    assert C == jmoe.moe_capacity(64, jc) == 16
    jparams, _ = _jax_state("tiny-moe-train")
    for i, ((idx, dest, _), x) in enumerate(zip(seen, inputs)):
        assert int((dest == E * C).sum()) > 0, i       # drops in this layer
        jidx, _, jdest, _ = _jax_routing(jparams["tail"][f"layer{i}"]["ffn"],
                                         x, jc, "standard")
        np.testing.assert_array_equal(idx.numpy(), jidx)
        np.testing.assert_array_equal(dest.numpy(), jdest)


# ------------------------------------------------ one step's gradients
_JGRADS = {}


def _jax_grads(name, jmode, aux_only=False, scale=1.0):
    """JAX's loss and gradient tree (as port leaves, divided by ``scale``)
    of one step on the first batch: of the step's loss, or of the aux loss
    alone, times ``scale``."""
    key = (name, jmode, aux_only, scale)
    if key not in _JGRADS:
        jc, _ = _cfgs(name, jmode)
        jm = jbuild(jc)
        params, _ = _jax_state(name)
        batch = _jbatches(jc.vocab, 1)[0]
        if aux_only:
            def fn(p, b):
                _, aux, _ = jm.forward(p, {"tokens": b["tokens"][:, :-1]})
                return aux * scale, {}
        else:
            def fn(p, b):
                loss, met = jstep.make_loss_fn(jm, jstep.TrainConfig())(p, b)
                return loss * scale, met
        (loss, met), g = jax.jit(jax.value_and_grad(fn, has_aux=True))(
            params, batch)
        aux = None if aux_only else float(met["aux"])
        _JGRADS[key] = (float(loss) / scale, aux,
                        [t / scale for t in tree_leaves(_port_params(g))])
    return _JGRADS[key]


@pytest.mark.parametrize("name", CFGS)
@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("mode,jmode", MODES)
def test_step_gradients_match_jax(name, mode, jmode, remat):
    """One step's gradients, leaf by leaf (the router, the three expert
    stacks and every dense leaf), against ``jax.value_and_grad`` of JAX's
    loss from the same state.  The tolerances and the loss scaling are
    ``tests/test_torch_train.py::test_step_gradients_match_jax``'s: the
    multiplier modes reassociate only (1e-5); a square mode's f32 error
    grows with the imbalance of a contraction's operands, which the mean
    loss sets at ~1/T, so it is held at 4e-5 with the loss scaled by T (a
    power of two) and at 2e-3 unscaled."""
    _, tc = _cfgs(name, mode, remat=remat)
    model = build_model(tc, device="cpu")
    loss_fn = step_mod.make_loss_fn(model, step_mod.TrainConfig())
    p, _ = _port_state(name)
    batch = _batches(tc.vocab, 1)[0]
    T = batch["tokens"][:, 1:].numel()
    scales = (1.0,) if mode in ("standard", "square_virtual") \
        else (1.0, float(T))
    for scale in scales:
        # scaled, square_pallas is held to JAX's square_pallas (its Pallas
        # kernels in interpret mode) with the loss scaled alike
        pallas = mode == "square_pallas" and scale > 1
        jl, jaux, ref = _jax_grads(name, "square_pallas" if pallas else jmode,
                                   scale=scale if pallas else 1.0)

        def scaled(params, b):
            loss, met = loss_fn(params, b)
            return loss * scale, met

        (loss, met), g = step_mod.value_and_grad(scaled, p, batch)
        assert float(loss) / scale == pytest.approx(jl, rel=1e-6)
        assert float(met["aux"]) == pytest.approx(jaux, rel=1e-5)
        leaves = tree_leaves(g)
        assert len(leaves) == len(ref)
        tol = 1e-5 if len(scales) == 1 else (4e-5 if scale > 1 else 2e-3)
        for i, (a, b) in enumerate(zip(leaves, ref)):
            assert a.shape == b.shape and bool(torch.isfinite(a).all())
            assert _rel(a / scale, b) <= tol, (i, scale, _rel(a / scale, b))


@pytest.mark.parametrize("name", CFGS)
@pytest.mark.parametrize("mode,jmode", [MODES[0], MODES[-1]])
def test_aux_loss_and_its_gradient_match_jax(name, mode, jmode):
    """The Switch aux loss on its own: its value, and its gradient, which
    reaches the router through ``pmean`` (none through the integer
    ``counts``) and every earlier leaf through the router's input.  The
    router leaves carry it all in the last layer; held at the step test's
    tolerances (the loss scaled by 2^10 in the square mode)."""
    scale = 1.0 if mode == "standard" else 1024.0
    jaux, _, ref = _jax_grads(name, jmode, aux_only=True)
    _, tc = _cfgs(name, mode)
    model = build_model(tc, device="cpu")
    p, _ = _port_state(name)
    batch = _batches(tc.vocab, 1)[0]

    def aux_fn(params, b):
        _, aux, _ = model.forward(params, {"tokens": b["tokens"][:, :-1]})
        return aux * scale, {}

    (aux, _), g = step_mod.value_and_grad(aux_fn, p, batch)
    assert float(aux) / scale == pytest.approx(jaux, rel=1e-5)
    leaves = tree_leaves(g)
    tol = 1e-5 if mode == "standard" else 4e-5
    routers = [layer["ffn"]["router"]["w"] for layer in g["layers"]]
    assert all(float(r.norm()) > 0 for r in routers)
    for i, (a, b) in enumerate(zip(leaves, ref)):
        if float(b.norm()) == 0.0:          # the embed and final norm
            assert float(a.norm()) == 0.0, i
            continue
        assert _rel(a / scale, b) <= tol, (i, _rel(a / scale, b))


# ------------------------------------------------------ trajectories
_JRUNS = {}


def _jax_run(name, jmode):
    """JAX's 3-step loss trajectory and final params (lr 1e-2)."""
    key = (name, jmode)
    if key not in _JRUNS:
        jc, _ = _cfgs(name, jmode)
        step = jax.jit(jstep.make_train_step(jbuild(jc), jstep.TrainConfig(
            opt=jadamw.AdamWConfig(**OPT))))
        p, o = _jax_state(name)
        losses = []
        for b in _jbatches(jc.vocab):
            p, o, met = step(p, o, b)
            losses.append(float(np.asarray(met["loss"])))
        _JRUNS[key] = (losses, jax.tree.map(np.asarray, p))
    return _JRUNS[key]


def _run(name, mode, steps=N_STEPS, **cfg_kw):
    _, tc = _cfgs(name, mode, **cfg_kw)
    model = build_model(tc, device="cpu")
    step = step_mod.make_train_step(model, step_mod.TrainConfig(
        opt=adamw.AdamWConfig(**OPT)))
    p, o = _port_state(name)
    losses = []
    for b in _batches(tc.vocab, steps):
        p, o, met = step(p, o, b)
        losses.append(float(met["loss"]))
    return losses, p, o


@pytest.mark.parametrize("name", CFGS)
@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("mode,jmode", MODES)
def test_loss_trajectory_matches_jax(name, mode, jmode, remat):
    """3 steps of the port from JAX's state against 3 JAX steps, losses at
    rtol = atol = 2e-3 and every parameter leaf within a tenth of its
    movement in norm (``tests/test_torch_train.py``'s holds)."""
    losses, params, _ = _run(name, mode, remat=remat)
    jlosses, jparams = _jax_run(name, jmode)
    assert np.isfinite(losses).all()
    assert abs(jlosses[-1] - jlosses[0]) > 50 * ATOL      # the loss moved
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL, atol=ATOL)
    start = tree_leaves(_port_params(_jax_state(name)[0]))
    mine = _port_params(jparams)
    for i, (a, b, p0) in enumerate(zip(tree_leaves(params),
                                       tree_leaves(mine), start)):
        moved = (b.double() - p0.double()).norm()
        assert moved > 0, i
        assert (a.double() - b.double()).norm() <= 0.1 * moved, i


# ---------------------------------------------------------- the audit
@pytest.mark.parametrize("name", CFGS)
def test_audit_step_equals_jax(name):
    """The audit of one square_pallas step: every site, the ``moe_*`` ones
    included, once at the forward and once at each of ``.bwd_x`` and
    ``.bwd_w``, fraction_square and fraction_square_bwd 1.0, the same
    under ``remat="block"`` (the recompute notes nothing), and JAX's
    train-step audit site by site where JAX notes executions, its
    forward-only audit for the chunked sites."""
    def audit(remat):
        _, tc = _cfgs(name, "square_pallas", remat=remat)
        model = build_model(tc, device="cpu")
        step = step_mod.make_train_step(model, step_mod.TrainConfig())
        p, o = _port_state(name)
        (_, _, met), ctr = step_mod.audit_step(step, p, o,
                                               _batches(tc.vocab, 1)[0])
        assert np.isfinite(float(met["loss"]))
        return ctr

    ctr = audit("none")
    mults = {k: v["mults"] for k, v in ctr.by_site().items()}
    assert ctr.fraction_square == 1.0 and ctr.fraction_square_bwd == 1.0
    fwd = {s: m for s, m in mults.items() if ".bwd_" not in s}
    assert {"moe_router", "moe_expert"} <= set(fwd)
    for s, m in fwd.items():
        assert mults[f"{s}.bwd_x"] == m and mults[f"{s}.bwd_w"] == m, s
    assert ctr.total_mults == 3 * sum(fwd.values())
    _, tc = _cfgs(name, "square_pallas")
    L, T, d, E = tc.n_layers, 64, tc.d_model, tc.n_experts
    C = tmoe.moe_capacity(T, tc)
    assert fwd["moe_router"] == L * T * d * E
    assert fwd["moe_expert"] == L * 3 * E * C * d * tc.d_ff
    assert {k: v["mults"] for k, v in audit("block").by_site().items()} \
        == mults
    # JAX's, scan_layers=False (it double-counts scanned bodies), in
    # square_virtual: the multiplies do not depend on the mode
    params, opt = _jax_state(name)
    jc, _ = _cfgs(name, "square_virtual")
    jm = jbuild(jc)
    batch = _jbatches(jc.vocab, 1)[0]
    # JAX's notes fire at trace time: tracing the step is its audit
    with jcount.track_contractions() as jctr:
        jax.make_jaxpr(jstep.make_train_step(jm, jstep.TrainConfig()))(
            params, opt, batch)
    jsites = {k: v["mults"] for k, v in jctr.by_site().items()}
    assert set(jsites) == set(mults)
    for s, m in jsites.items():
        if s.split(".")[0] not in CHUNKED_SITES:
            assert mults[s] == m, s
    def jforward(params, tok):
        hidden, _, _ = jm.forward(params, {"tokens": tok[:, :-1]})
        return jloss.chunked_xent(hidden, tok[:, 1:],
                                  params["embed"]["table"],
                                  chunk=jc.loss_chunk, mode="square_virtual")

    with jcount.track_contractions() as jfwd:
        jax.make_jaxpr(jforward)(params, batch["tokens"])
    assert {k: v["mults"] for k, v in jfwd.by_site().items()} == fwd


# ------------------------------------------------------- microbatches
@pytest.mark.parametrize("name", CFGS)
def test_microbatched_step_matches_jax(name, monkeypatch):
    """2 microbatches of 2 sequences, each routed with the capacity of its
    own 32 tokens (as JAX's scanned microbatch is; the aux loss is each
    microbatch's own, so the step is not the whole batch's): the loss,
    and the last microbatch's xent and aux, equal JAX's microbatched
    step's at 2e-3, its params within 2 lr (one AdamW step from zero
    moments moves a parameter by lr * sign(g))."""
    jc, tc = _cfgs(name, "square_pallas")
    jc = dataclasses.replace(jc, matmul_mode="square_virtual")
    model = build_model(tc, device="cpu")
    dcfg = dict(global_batch=4, seq_len=16, seed=9)
    batch = SyntheticLM(DataConfig(vocab=tc.vocab, **dcfg),
                        device="cpu").next_batch()
    jbatch = JSyntheticLM(JDataConfig(vocab=jc.vocab, **dcfg)).next_batch()
    opt_cfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    caps = []
    real = tmoe.moe_capacity
    monkeypatch.setattr(tmoe, "moe_capacity",
                        lambda n, cfg: caps.append(n) or real(n, cfg))
    p, o = _port_state(name)
    step = step_mod.make_train_step(model, step_mod.TrainConfig(
        opt=adamw.AdamWConfig(**opt_cfg), microbatch=2))
    p2, _, met = step(p, o, batch)
    assert caps == [32] * 2 * tc.n_layers
    params, opt = _jax_state(name)
    jfn = jax.jit(jstep.make_train_step(jbuild(jc), jstep.TrainConfig(
        opt=jadamw.AdamWConfig(**opt_cfg), microbatch=2)))
    jp, _, jmet = jfn(params, opt, jbatch)
    for k in ("loss", "xent", "aux"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                   rtol=RTOL, atol=ATOL)
    for a, b in zip(tree_leaves(p2), tree_leaves(_port_params(jp))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=2 * 1e-3)


# -------------------------------------------- state and checkpoints
def test_train_state_from_jax_and_checkpoint_round_trip(tmp_path):
    """A scanned JAX MoE train state, bf16, with ``m`` and ``v`` not zero:
    each port leaf is its JAX array (layer i of the scan stack, the ``(E,
    d, f)`` expert stacks whole), the port's loss from it is JAX's, and
    the state round-trips through the port's checkpoint bit for bit."""
    jc = dataclasses.replace(jget("moonshot-v1-16b-a3b").reduced(),
                             dtype="bfloat16", matmul_mode="standard")
    assert jc.scan_layers
    jm = jbuild(jc)
    jp = jm.init(jax.random.PRNGKey(1))
    batch = _jbatches(jc.vocab, 1)[0]
    rng = np.random.default_rng(3)
    jo = dict(jadamw.adamw_init(jp), step=np.asarray(7, np.int32))
    for k in ("m", "v"):
        jo[k] = jax.tree.map(lambda a: np.abs(rng.normal(size=a.shape)).astype(
            np.float32), jo[k])
    npp, npo = jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, jo)
    p, o = train_state_from_jax(npp, npo)
    assert int(o["step"]) == 7
    for tree, jtree in ((p, npp), (o["m"], npo["m"]), (o["v"], npo["v"])):
        for i, layer in enumerate(tree["layers"]):
            for k in ("router", "w_gate", "w_up", "w_down"):
                want = jtree["scan"]["pos0"]["ffn"][k]["w"][i]
                got = layer["ffn"][k]["w"]
                assert tuple(got.shape) == want.shape
                np.testing.assert_array_equal(got.float().numpy(),
                                              want.astype(np.float32))
    assert p["layers"][0]["ffn"]["w_gate"]["w"].dtype == torch.bfloat16
    assert o["m"]["layers"][0]["ffn"]["w_gate"]["w"].dtype == torch.float32
    tc = dataclasses.replace(tget("moonshot-v1-16b-a3b").reduced(),
                             dtype="bfloat16", matmul_mode="standard")
    loss_fn = step_mod.make_loss_fn(build_model(tc, device="cpu"),
                                    step_mod.TrainConfig())
    jl, _ = jax.jit(jstep.make_loss_fn(jm, jstep.TrainConfig()))(jp, batch)
    with torch.no_grad():
        tl, _ = loss_fn(p, _batches(tc.vocab, 1)[0])
    assert float(tl) == pytest.approx(float(jl), rel=2e-3)

    mgr = CheckpointManager(str(tmp_path / "t"), registry=MetricsRegistry(),
                            async_save=False)
    mgr.save(1, {"params": p, "opt_state": o}, meta={"losses": [float(tl)]})
    trees, meta = CheckpointManager(str(tmp_path / "t"),
                                    registry=MetricsRegistry()).restore()
    assert meta["losses"] == [float(tl)]
    assert adamw.tree_fingerprint(trees) == adamw.tree_fingerprint(
        {"params": p, "opt_state": o})
    for a, b in zip(tree_leaves(trees), tree_leaves(
            {"params": p, "opt_state": o})):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_train_params_carry_the_expert_stacks():
    """``LM.train_params`` of a MoE model: per layer the router (d, E) and
    the three ``(E, d, f)`` / ``(E, f, d)`` expert stacks, plain tensors
    (no grad) of the spec's dtypes, the layout ``train_state_from_jax``
    gives."""
    _, tc = _cfgs("tiny-moe-train")
    p = build_model(tc, device="cpu").train_params()
    E, d, f = tc.n_experts, tc.d_model, tc.d_ff
    want, _ = _port_state("tiny-moe-train")
    for layer in p["layers"]:
        ffn = {k: v["w"] for k, v in layer["ffn"].items()}
        assert {k: tuple(v.shape) for k, v in ffn.items()} == {
            "router": (d, E), "w_gate": (E, d, f), "w_up": (E, d, f),
            "w_down": (E, f, d)}
        assert ffn["router"].dtype == torch.float32
        assert not any(v.requires_grad for v in ffn.values())
    assert [tuple(t.shape) for t in tree_leaves(p)] == \
        [tuple(t.shape) for t in tree_leaves(want)]


def test_prepared_expert_stack_dx_falls_back_to_its_source():
    """A batched prepared ``(E, d, f)`` stack under autograd: dL/dx comes
    from its source (JAX's ``_einsum_grads`` falls back alike, having no
    opposite-layout prep of a batched stack), so the port's dx with the
    prepared stack is its dx with the raw stack bit for bit, at the site
    ``moe_expert.bwd_x`` on K2's route, and JAX's square_pallas dx with
    its own prepared stack (interpret mode) at the f32 sweep tolerance."""
    from repro.core.einsum import fs_einsum as jfs_einsum
    from repro.core.prepared import prepare_operand as jprep
    from repro_torch.core.einsum import fs_einsum
    from repro_torch.core.prepared import prepare_operand
    from repro_torch.kernels import routing
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 16, 32)).astype(np.float32)
    w = rng.normal(size=(4, 32, 64)).astype(np.float32) / 8
    ct = rng.normal(size=(4, 16, 64)).astype(np.float32)
    dxs = []
    routing.select_matmul_route.taken.clear()
    for y in (torch.from_numpy(w), prepare_operand(torch.from_numpy(w),
                                                   site="moe_expert")):
        xt = torch.from_numpy(x).requires_grad_(True)
        with tcount.track_contractions() as ctr:
            out = fs_einsum("ecd,edf->ecf", xt, y, mode="square_pallas",
                            site="moe_expert")
            (out * torch.from_numpy(ct)).sum().backward()
        assert set(ctr.by_site()) == {"moe_expert", "moe_expert.bwd_x"}
        dxs.append(xt.grad)
    assert torch.equal(dxs[0], dxs[1])
    assert routing.select_matmul_route.taken["batched"] == 4

    def jloss(xx):
        out = jfs_einsum("ecd,edf->ecf", xx, jprep(jax.numpy.asarray(w)),
                         mode="square_pallas", site="moe_expert")
        return (out * ct).sum()
    jdx = np.asarray(jax.grad(jloss)(jax.numpy.asarray(x)))
    np.testing.assert_allclose(dxs[1].numpy(), jdx, rtol=5e-3,
                               atol=5e-3 * 64)


# ------------------------------------------------------ the launcher
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "mixtral-8x7b"])
def test_launcher_trains_moe_on_the_cpu(arch, tmp_path):
    """``python -m repro_torch.launch.train --arch <moe> --reduced`` on the
    CPU: finite losses, a checkpoint, and the trainer's first-step audit
    covering the ``moe_*`` sites forward and backward, all square."""
    from repro_torch.launch import train as launch
    out = launch.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--steps", "2", "--global-batch", "2", "--seq", "32",
                       "--ckpt-every", "2", "--ckpt-dir",
                       str(tmp_path / "ck"), "--matmul-mode",
                       "square_pallas"])
    assert out["final_step"] == 2
    assert np.isfinite(out["loss_trajectory"]).all()
    audit = out["contraction_audit"]
    assert audit["fraction_square"] == audit["fraction_square_bwd"] == 1.0
    by = audit["by_site"]
    for site in ("moe_router", "moe_expert"):
        assert by[site]["mults"] > 0
        assert by[f"{site}.bwd_x"]["mults"] == by[site]["mults"]
        assert by[f"{site}.bwd_w"]["mults"] == by[site]["mults"]
    assert (tmp_path / "ck" / "step_000000002").is_dir()


# ------------------------------------------------ the captured step
def test_captured_moe_step_on_the_stub_equals_eager(monkeypatch):
    """The MoE step captured (``jit_train_step``) on the CPU stub graph,
    recorded under the compiled audit: 2 calls equal 2 eager steps bit for
    bit (losses, params, optimizer state), one capture, and the ledger's
    audit of a replay equals the eager step's audit site by site.  Then
    ``GuardedStep(jit=True)`` on the stub runs the step clean: no trip,
    retry or re-capture, and the eager step's result."""
    monkeypatch.setattr(graphs, "CapturedCall", _StubCall)
    _StubCall.made = []
    _, tc = _cfgs("tiny-moe-train", "square_pallas", remat="block")
    model = build_model(tc, device="cpu")
    raw = step_mod.make_train_step(model, step_mod.TrainConfig(
        opt=adamw.AdamWConfig(**OPT)))
    batches = _batches(tc.vocab, 2)
    p, o = _port_state("tiny-moe-train")
    eager, ctr = [], None
    for i, b in enumerate(batches):
        if i == 0:
            (p, o, met), ctr = step_mod.audit_step(raw, p, o, b)
        else:
            p, o, met = raw(p, o, b)
        eager.append(float(met["loss"]))
    want = adamw.tree_fingerprint((p, o))

    jitted = step_mod.jit_train_step(raw, CUDA)
    p, o = _port_state("tiny-moe-train")
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
    p, o = _port_state("tiny-moe-train")
    gp, go, gmet = gs(p, o, batches[0])
    ep, eo, emet = raw(p, o, batches[0])
    assert gs.stats() == {"guard_trips": 0, "rejits": 0, "retries": 0}
    assert gs.captures == 1
    assert adamw.tree_fingerprint((gp, go, gmet["loss"])) == \
        adamw.tree_fingerprint((ep, eo, emet["loss"]))


# --------------------------------------------------- the recompute
@pytest.mark.parametrize("name", CFGS)
def test_remat_recompute_routes_as_the_forward(name, monkeypatch):
    """Under ``remat="block"`` each layer's block runs twice (the forward
    and the recompute in the backward); both route every token to the
    same experts and slots, and the gradients equal ``remat="none"``'s
    bit for bit."""
    grads = {}
    for remat in ("none", "block"):
        seen = _routings(monkeypatch)
        _, tc = _cfgs(name, "square_pallas", remat=remat)
        model = build_model(tc, device="cpu")
        p, _ = _port_state(name)
        _, g = step_mod.value_and_grad(
            step_mod.make_loss_fn(model, step_mod.TrainConfig()), p,
            _batches(tc.vocab, 1)[0])
        grads[remat] = g
        L = tc.n_layers
        if remat == "none":
            assert len(seen) == L
            continue
        assert len(seen) == 2 * L             # forward, then recompute
        fwd, rec = seen[:L], seen[L:][::-1]   # the backward runs last first
        for (i1, d1, c1), (i2, d2, c2) in zip(fwd, rec):
            assert c1 == c2
            assert torch.equal(i1, i2) and torch.equal(d1, d2)
    assert adamw.tree_fingerprint(grads["none"]) == \
        adamw.tree_fingerprint(grads["block"])
