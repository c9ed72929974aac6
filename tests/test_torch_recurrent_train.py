"""The port's recurrent blocks under autograd against ``jax.grad`` of the
JAX package's, with the same weights and inputs, in all five modes:
``models/rglru.py``'s ``rglru_forward`` from a carried state (the conv's
state, the logaddexp softplus and sigmoid gates, the ``jnp.maximum`` floor
under the square root, the log-depth scan's strided slices and
interleaving writes), ``models/xlstm.py``'s ``mlstm_chunk_scan`` over three
16-token chunks, the last padded (``cumsum``, ``cummax``, the ``-1e30``
padding, the ``torch.where`` mask, the carry across chunks), from a
carried state and from the fresh one training starts at, and
``slstm_forward``'s step loop from the fresh state.  The LMs' gradients
are in ``tests/test_torch_recurrent_train_lm.py`` and
``tests/test_torch_recurrent_train_xlstm.py``, the audit, capture,
checkpoints and launcher in ``tests/test_torch_recurrent_train_infra.py``.

Each test differentiates one scalar, the sum of every output (the final
state included where it is carried) times a fixed random cotangent, and
holds each gradient, per tensor, in relative error in norm:

- ``standard`` and ``square_virtual`` at 1e-5: the two packages run the
  same operations in the same order (measured at most 4.1e-6, the mLSTM's
  ``cumsum`` and ``exp`` rounding in another order);
- ``square_exact``, ``square_scan`` and ``square_pallas`` (the kernels'
  plain versions here; JAX's Pallas kernels in interpret mode through the
  ``pltpu.TPUCompilerParams`` alias) at 2e-4 against the JAX package in
  the same mode: each side's square-form sums round at ~2^-24 * (|a| +
  |b|)^2 a term, in another order (measured at most 6.9e-5).

The inputs are random and well conditioned (no gate saturates), so these
tolerances hold the backward, not the reference's conditioning (see
``tests/test_torch_recurrent_train_xlstm.py`` for the LM's).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.layers.param import init_tree  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro.models import xlstm as jxl  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import counting as tcount  # noqa: E402
from repro_torch.core.matmul import MODES  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402
from repro_torch.models import xlstm as txl  # noqa: E402

# JAX 0.9.0 renamed ``pltpu.TPUCompilerParams``; with the alias the JAX
# square_pallas runs its Pallas kernels in interpret mode.
if not hasattr(pltpu, "TPUCompilerParams"):
    pltpu.TPUCompilerParams = pltpu.CompilerParams

# the tolerance of a mode (the module docstring)
TOL = {"standard": 1e-5, "square_virtual": 1e-5, "square_exact": 2e-4,
       "square_scan": 2e-4, "square_pallas": 2e-4}


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    """Small tensors: one torch thread computes them as fast and leaves the
    cores to the suite's other workers."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _cfgs(arch, mode):
    return (dataclasses.replace(jget(arch).reduced(), matmul_mode=mode),
            dataclasses.replace(tget(arch).reduced(), matmul_mode=mode))


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref)
                 / max(np.linalg.norm(ref), 1e-300))


def _grads_match(jfn, tfn, args, grad_keys, tol):
    """``jax.grad`` of ``jfn`` and torch's gradients of ``tfn`` at ``args``
    (a dict of numpy trees) with respect to the entries ``grad_keys``, leaf
    by leaf within ``tol`` in norm; returns the port's gradients."""
    jargs = jax.tree.map(jnp.asarray, args)
    jg = jax.jit(jax.grad(lambda g, rest: jfn({**rest, **g})))(
        {k: jargs[k] for k in grad_keys},
        {k: v for k, v in jargs.items() if k not in grad_keys})
    targs = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), args)
    for k in grad_keys:
        targs[k] = jax.tree.map(lambda t: t.requires_grad_(True), targs[k])
    leaves = jax.tree.leaves({k: targs[k] for k in grad_keys})
    tg = torch.autograd.grad(tfn(targs), leaves)
    ref = jax.tree.leaves({k: jg[k] for k in grad_keys})
    assert len(tg) == len(ref)
    for i, (a, b) in enumerate(zip(tg, ref)):
        assert tuple(a.shape) == b.shape and bool(torch.isfinite(a).all())
        assert _rel(a.numpy(), b) <= tol, (i, _rel(a.numpy(), b))
    return tg


# -------------------------------------------------------------- RG-LRU
@pytest.mark.parametrize("mode", MODES)
def test_rglru_forward_gradients_match_jax(mode):
    """33 steps (an odd length: the scan's recursion takes both its
    branches) from a carried ``h`` and conv state: the gradients of every
    weight (``lam`` through the logaddexp softplus), of the input and of
    both carried states, through the output and the final state."""
    rng = np.random.default_rng(21)
    jc, tc = _cfgs("recurrentgemma-2b", mode)
    B, S, D, R = 2, 33, jc.d_model, jc.rnn_width
    p = jax.tree.map(np.asarray, init_tree(jrg.rglru_spec(jc),
                                           jax.random.PRNGKey(3)))
    args = {"p": p, "x": _normal(rng, B, S, D), "h": _normal(rng, B, R),
            "conv": _normal(rng, B, jc.conv_width - 1, R)}
    cy, ch, cc = (_normal(rng, B, S, D), _normal(rng, B, R),
                  _normal(rng, B, jc.conv_width - 1, R))

    def objective(fwd, a, cfg, t):
        y, st = fwd(a["p"], a["x"], cfg=cfg, mode=mode,
                    state={"h": a["h"], "conv": a["conv"]})
        return ((y * t(cy)).sum() + (st["h"] * t(ch)).sum()
                + (st["conv"] * t(cc)).sum())

    _grads_match(lambda a: objective(jrg.rglru_forward, a, jc, jnp.asarray),
                 lambda a: objective(trg.rglru_forward, a, tc,
                                     torch.from_numpy),
                 args, ("p", "x", "h", "conv"), TOL[mode])


# --------------------------------------------------------------- mLSTM
def _mlstm_args(rng, B=2, H=2, S=40, hd=16, fresh=False):
    args = {"q": _normal(rng, B, H, S, hd), "k": _normal(rng, B, H, S, hd),
            "v": _normal(rng, B, H, S, hd), "it": _normal(rng, B, H, S),
            "ft": _normal(rng, B, H, S) - 1.0}
    if fresh:                    # mlstm_init_state: what training starts at
        args.update(C=np.zeros((B, H, hd, hd), np.float32),
                    n=np.zeros((B, H, hd), np.float32),
                    m=np.full((B, H), -1e30, np.float32))
    else:
        args.update(C=_normal(rng, B, H, hd, hd), n=_normal(rng, B, H, hd),
                    m=_normal(rng, B, H))
    return args


def _mlstm_objective(scan, a, t, cts, mode, chunk=16):
    h, (C, n, _) = scan(a["q"], a["k"], a["v"], a["it"], a["ft"],
                        (a["C"], a["n"], a["m"]), chunk, mode=mode)
    out = (h * t(cts[0])).sum()
    if len(cts) > 1:                             # the carried final state
        out = out + (C * t(cts[1])).sum() + (n * t(cts[2])).sum()
    return out


@pytest.mark.parametrize("mode", MODES)
def test_mlstm_chunk_scan_gradients_match_jax(mode):
    """S = 40 in chunks of 16 (three chunks, the last padded by 8 steps of
    ``it = -1e30``) from a carried state: the gradients of q, k, v, both
    log-gates and the carried ``C``, ``n`` and stabilizer ``m``, through
    the output and the final ``C`` and ``n``."""
    rng = np.random.default_rng(22)
    args = _mlstm_args(rng)
    cts = (_normal(rng, *args["q"].shape), _normal(rng, *args["C"].shape),
           _normal(rng, *args["n"].shape))
    _grads_match(
        lambda a: _mlstm_objective(jxl.mlstm_chunk_scan, a, jnp.asarray,
                                   cts, mode),
        lambda a: _mlstm_objective(txl.mlstm_chunk_scan, a, torch.from_numpy,
                                   cts, mode),
        args, tuple(args), TOL[mode])


@pytest.mark.parametrize("mode", ["standard", "square_pallas"])
def test_mlstm_fresh_state_gradients_match_jax_and_audit(mode):
    """Training's case: the zero ``C``, ``n`` and the ``-1e30`` stabilizer
    ask for no gradient and the final state is dropped.  The gradients of
    q, k, v and the gates match JAX's, and the audit of the backward has
    what ``chip_smoke.recurrent_train_contractions`` says autograd computes:
    no dL/dW of the first chunk's two contractions with the zero state,
    none of the last chunk's carry."""
    rng = np.random.default_rng(23)
    args = _mlstm_args(rng, fresh=True)
    cts = (_normal(rng, *args["q"].shape),)
    keys = ("q", "k", "v", "it", "ft")
    with tcount.track_contractions() as ctr:
        _grads_match(
            lambda a: _mlstm_objective(jxl.mlstm_chunk_scan, a, jnp.asarray,
                                       cts, mode),
            lambda a: _mlstm_objective(txl.mlstm_chunk_scan, a,
                                       torch.from_numpy, cts, mode),
            args, keys, TOL[mode])
    B, H, S, hd = args["q"].shape
    nb, c, nc = B * H, 16, 3
    chunk = [c * hd * hd, c * hd, c * hd * c, c * c * hd, hd * c * hd,
             hd * c]
    fwd = nb * nc * sum(chunk)
    got = {s: d["mults"] for s, d in ctr.by_site().items()}
    assert got == {
        "recurrent_mix": fwd,
        "recurrent_mix.bwd_x": fwd - nb * sum(chunk[4:]),
        "recurrent_mix.bwd_w": fwd - nb * (sum(chunk[:2]) + sum(chunk[4:]))}


# --------------------------------------------------------------- sLSTM
@pytest.mark.parametrize("mode", MODES)
def test_slstm_forward_gradients_match_jax(mode):
    """14 steps of the sLSTM loop from the fresh state (zero ``c``, ``n``,
    ``h``; the stabilizer at -1e30): the gradients of ``w_x``, the
    recurrent ``r``, the norm, ``w_out`` and the input.  Step 0 contracts
    the zero ``h``, so it has no dL/dx (its dL/dW counts)."""
    rng = np.random.default_rng(24)
    jc, tc = _cfgs("xlstm-350m", mode)
    p = jax.tree.map(np.asarray, init_tree(jxl.slstm_spec(jc),
                                           jax.random.PRNGKey(4)))
    B, S, D = 2, 14, jc.d_model
    args = {"p": p, "x": _normal(rng, B, S, D)}
    cy = _normal(rng, B, S, D)

    def objective(fwd, a, cfg, t):
        y, _ = fwd(a["p"], a["x"], cfg=cfg, mode=mode)
        return (y * t(cy)).sum()

    with tcount.track_contractions() as ctr:
        _grads_match(lambda a: objective(jxl.slstm_forward, a, jc,
                                         jnp.asarray),
                     lambda a: objective(txl.slstm_forward, a, tc,
                                         torch.from_numpy),
                     args, ("p", "x"), TOL[mode])
    H = tc.n_heads
    hd = D // H
    step = H * B * hd * 4 * hd
    mix = {s: d["mults"] for s, d in ctr.by_site().items()
           if s.startswith("recurrent_mix")}
    assert mix == {"recurrent_mix": S * step,
                   "recurrent_mix.bwd_x": (S - 1) * step,
                   "recurrent_mix.bwd_w": S * step}


@pytest.mark.parametrize("n", [2, 7, 33])
def test_stabilizer_cummax_differentiates_as_jax(n):
    """The mLSTM stabilizer's running max ``max_{j<=t} (i_j - b_j)``, with
    ties (entries drawn from three values): ``jax.lax.cummax``
    differentiates as its associative scan of ``max``, splitting each tie
    evenly; the port's ``_cummax`` runs the same recursion, so its values
    and gradient are JAX's exactly.  (``torch.cummax`` sends a tie's
    gradient to one index, through a scatter whose atomic adds make the
    backward vary from run to run on CUDA.)"""
    rng = np.random.default_rng(26)
    x = rng.choice(np.array([-1.0, 0.0, 0.5], np.float32), size=(3, 2, n))
    ct = _normal(rng, 3, 2, n)
    jval, jgrad = jax.value_and_grad(
        lambda a: (jax.lax.cummax(a, axis=2) * ct).sum())(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    out = txl._cummax(tx)
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_array_equal(
        out.detach().numpy(), np.asarray(jax.lax.cummax(jnp.asarray(x),
                                                        axis=2)))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad),
                               rtol=0, atol=1e-6)
