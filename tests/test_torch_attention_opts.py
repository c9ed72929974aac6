"""The port's ``chunked_attention`` schedules -- ``block_skip``, ``fold_q``
and ``p_bf16`` -- against the JAX package's (the contract of
``tests/test_attention_opts.py``) and against the port's own base schedule.

- Each option against JAX's same option, at JAX's contract shapes (B 2,
  S 70, KV 2, G 2, hd 8; chunks 16 / 8; causal, non-causal, and causal
  under a window of 9) in ``standard`` and the three torch-level square
  modes.  ``block_skip`` and ``fold_q`` at atol = rtol = 1e-5 (measured
  <= 2.1e-6: two f32 pipelines' orders and the square form's rounding).
  ``p_bf16`` rounds ``p`` to bf16, so a one-ulp difference in a score
  (the two packages' orders) may round a ``p`` the other way: one flip
  moves the output by at most 2^-8 p |v| / l, and all of them together by
  at most 2^-8 max|v| (p sums to l); that is its tolerance (measured <=
  1.3e-3 in the square modes, 3e-7 in ``standard``).
- ``block_skip`` and ``fold_q`` against the port's base schedule.  Where
  they hold bit for bit: ``standard`` and ``square_virtual`` at every
  shape; every mode at the contract shapes (a kv chunk of 8 is one
  16-wide slab, so a skipped chunk's square-form PV, ``1/2 (sum (0 + v)^2
  - sum v^2)``, sums both halves in one order and is exactly 0).  Where
  they do not: at chunks of 64 / 32 (S 300), ``square_exact`` and
  ``square_scan`` (and ``square_pallas``'s K2 plain version for
  ``block_skip``) leave each skipped chunk's residue, and torch sums the
  folded cube in another blocking; there the pair is held to the square
  form's f32 bound of the output (every PV term rounds relative to
  (|p| + |v|)^2 <= (1 + max|v|)^2, T terms a row, and every score term
  relative to (max|q| hd^-1/2 + max|k|)^2, hd terms, moving p by that
  much relative), measured <= 1e-5 against a bound of ~1e-3.
- The audit of each schedule equals JAX's ``count_scale`` accounting site
  by site (JAX's notes come from its scan bodies at trace time).
- A reduced deepseek-7b (2 layers, chunks 16 / 8, 64 tokens: 4 q blocks
  over 8 kv chunks) with ``attn_block_skip`` on: its forward against
  JAX's LM with the same option, and one step's gradients leaf by leaf
  against ``jax.value_and_grad`` (``test_torch_train``'s tolerances).
"""
import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core import counting as jcount  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.lm import build_model as jbuild  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import counting as tcount  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.train import step as step_mod  # noqa: E402
from test_torch_moe import _one_thread  # noqa: E402,F401
from test_torch_train import _port_params, _rel  # noqa: E402

OPTS = ("block_skip", "fold_q", "p_bf16")
MODES = ("standard", "square_virtual", "square_exact", "square_scan")
MASKS = {"causal": (True, None), "full": (False, None), "window": (True, 9)}
ATOL = RTOL = 1e-5
CONTRACT = dict(B=2, S=70, KV=2, G=2, hd=8, chunk_q=16, chunk_kv=8)
LARGE = dict(B=1, S=300, KV=2, G=2, hd=16, chunk_q=64, chunk_kv=32)


@pytest.fixture(autouse=True)
def _no_route_pin(monkeypatch):
    monkeypatch.delenv("REPRO_ROUTE", raising=False)


@functools.lru_cache(maxsize=None)
def _qkv(B, S, KV, G, hd, chunk_q, chunk_kv):
    rng = np.random.default_rng(11)
    return (rng.normal(size=(B, S, KV, G, hd)).astype(np.float32),
            rng.normal(size=(B, S, KV, hd)).astype(np.float32),
            rng.normal(size=(B, S, KV, hd)).astype(np.float32))


def _port(shape, mode, mask, **opt):
    q, k, v = (torch.from_numpy(t) for t in _qkv(**shape))
    pos = torch.arange(shape["S"])
    causal, window = MASKS[mask]
    return tattn.chunked_attention(
        q, k, v, pos, pos, causal=causal, window=window,
        chunk_q=shape["chunk_q"], chunk_kv=shape["chunk_kv"], mode=mode,
        **opt)


@functools.lru_cache(maxsize=None)
def _jax(mode, mask, opt):
    """JAX's option output at the contract shapes, once per (mode, mask,
    option) for the file."""
    q, k, v = (jnp.asarray(t) for t in _qkv(**CONTRACT))
    pos = jnp.arange(CONTRACT["S"])
    causal, window = MASKS[mask]
    return np.asarray(jattn.chunked_attention(
        q, k, v, pos, pos, causal=causal, window=window,
        chunk_q=CONTRACT["chunk_q"], chunk_kv=CONTRACT["chunk_kv"],
        mode=mode, **{opt: True}))


@pytest.mark.parametrize("opt", OPTS)
@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("mode", MODES)
def test_option_matches_jax(mode, mask, opt):
    got = _port(CONTRACT, mode, mask, **{opt: True}).numpy()
    want = _jax(mode, mask, opt)
    if opt == "p_bf16":
        vmax = float(np.abs(_qkv(**CONTRACT)[2]).max())
        np.testing.assert_allclose(got, want, atol=2.0 ** -8 * vmax, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def _square_bound(shape) -> float:
    """The square form's f32 bound of one output element (module
    docstring): the PV's T terms and the scores' rounding through p."""
    q, k, v = _qkv(**shape)
    vmax = float(np.abs(v).max())
    top = float(np.abs(q).max()) * shape["hd"] ** -0.5 \
        + float(np.abs(k).max())
    pv = shape["S"] * 2.0 ** -23 * (1.0 + vmax) ** 2
    scores = shape["hd"] * 2.0 ** -23 * top * top
    return pv + 2.0 * scores * vmax


# where the pair is not bit for bit (the module docstring's finding)
NOT_EXACT = {("large", "square_exact", "block_skip"),
             ("large", "square_exact", "fold_q"),
             ("large", "square_scan", "block_skip"),
             ("large", "square_scan", "fold_q"),
             ("large", "square_pallas", "block_skip")}


@pytest.mark.parametrize("opt", ["block_skip", "fold_q"])
@pytest.mark.parametrize("mode", MODES + ("square_pallas",))
@pytest.mark.parametrize("size", ["contract", "large"])
def test_schedule_equals_base(size, mode, opt):
    shape = CONTRACT if size == "contract" else LARGE
    masks = list(MASKS) if size == "contract" else ["causal"]
    for mask in masks:
        base = _port(shape, mode, mask)
        got = _port(shape, mode, mask, **{opt: True})
        if (size, mode, opt) in NOT_EXACT:
            err = float((got - base).abs().max())
            assert 0 < err <= _square_bound(shape), (mask, err)
        else:
            assert torch.equal(got, base), (mask, mode, opt)


@pytest.mark.parametrize("opt", (None,) + OPTS)
@pytest.mark.parametrize("mask", list(MASKS))
def test_audit_matches_jax(mask, opt):
    """Each schedule's contraction audit, site by site, equals JAX's (its
    ``count_scale`` accounting): nq x nk chunk pairs, or block_skip's
    triangular number when causal without a window."""
    kw = {opt: True} if opt else {}
    with tcount.track_contractions() as tctr:
        _port(CONTRACT, "square_virtual", mask, **kw)
    q, k, v = (jnp.asarray(t) for t in _qkv(**CONTRACT))
    pos = jnp.arange(CONTRACT["S"])
    causal, window = MASKS[mask]
    with jcount.track_contractions() as jctr:
        jattn.chunked_attention(
            q, k, v, pos, pos, causal=causal, window=window,
            chunk_q=CONTRACT["chunk_q"], chunk_kv=CONTRACT["chunk_kv"],
            mode="square_virtual", **kw)
    assert tctr.by_site() == jctr.by_site()
    B, S, KV, G, hd = (CONTRACT[n] for n in ("B", "S", "KV", "G", "hd"))
    cq, ck = CONTRACT["chunk_q"], CONTRACT["chunk_kv"]
    nq, nk = -(-S // cq), -(-S // ck)
    pairs = nq * nk
    if opt == "block_skip" and mask == "causal":
        pairs = sum(min(nk, -(-(i + 1) * cq // ck)) for i in range(nq))
        assert pairs < nq * nk
    per_pair = B * KV * G * cq * ck * hd
    assert tctr.by_site()["attn_scores"]["mults"] == pairs * per_pair
    assert tctr.by_site()["attn_pv"]["mults"] == pairs * per_pair


def test_fold_q_routes_at_one_chunk():
    """Under ``square_pallas`` fold_q routes each folded contraction at one
    q chunk's shape (batch B * KV, as JAX's vmap keeps it), not at the
    folded batch: the same route counts as the base schedule's."""
    from repro_torch.kernels import routing
    shape = dict(LARGE, B=2)
    taken = {}
    for opt in ({}, {"fold_q": True}):
        routing.select_matmul_route.taken.clear()
        _port(shape, "square_pallas", "causal", **opt)
        taken[bool(opt)] = dict(routing.select_matmul_route.taken)
    nq = -(-shape["S"] // shape["chunk_q"])
    assert {r: n * nq for r, n in taken[True].items()} == taken[False]
    assert set(taken[False]) == {"batched"}


# ---------------------------------------------------------------- the LM
SEQ = 64


def _lm_cfgs(mode):
    kw = dict(matmul_mode=mode, attn_chunk_q=16, attn_chunk_kv=8,
              attn_block_skip=True, loss_chunk=32)
    return (dataclasses.replace(jget("deepseek-7b").reduced(), **kw),
            dataclasses.replace(tget("deepseek-7b").reduced(), **kw))


@functools.lru_cache(maxsize=None)
def _jax_lm():
    jc, _ = _lm_cfgs("standard")
    params = jbuild(jc).init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(7).integers(0, jc.vocab, (2, SEQ + 1))
    return params, toks.astype(np.int32)


def _port_lm(mode):
    _, tc = _lm_cfgs(mode)
    params, _ = _jax_lm()
    tm = LM(tc, device=torch.device("cpu"))
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return tm


@pytest.mark.parametrize("mode", ["standard", "square_virtual",
                                  "square_pallas"])
def test_block_skip_lm_forward_matches_jax(mode):
    """The reduced deepseek-7b's hidden states and logits with
    ``attn_block_skip``, against JAX's LM with the same option (the JAX
    side's square_pallas runs square_virtual: its Pallas wrappers cannot
    run here), at ``test_torch_forward``'s 1e-4."""
    params, toks = _jax_lm()
    jc, _ = _lm_cfgs("square_virtual" if mode == "square_pallas" else mode)
    jm = jbuild(jc)
    jh, _, _ = jax.jit(jm.forward)(params,
                                   {"tokens": jnp.asarray(toks[:, :SEQ])})
    jl = jm.logits(params, jh)
    tm = _port_lm(mode)
    with tcount.track_contractions() as ctr, torch.no_grad():
        th, _, _ = tm.forward(tm.tree(),
                              {"tokens": torch.from_numpy(toks[:, :SEQ])})
        tl = tm.logits(tm.tree(), th)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    # 4 q blocks of 16 over 8 kv chunks of 8: 2 + 4 + 6 + 8 chunk pairs
    cfg = tm.cfg
    per_pair = 2 * cfg.n_heads * 16 * 8 * cfg.resolved_head_dim
    assert ctr.by_site()["attn_scores"]["mults"] == \
        cfg.n_layers * 20 * per_pair


@functools.lru_cache(maxsize=None)
def _jax_grads(jmode):
    params, toks = _jax_lm()
    jc, _ = _lm_cfgs(jmode)
    (loss, _), g = jax.value_and_grad(
        jstep.make_loss_fn(jbuild(jc), jstep.TrainConfig()), has_aux=True)(
            params, {"tokens": jnp.asarray(toks)})
    return float(loss), tree_leaves(_port_params(g))


@pytest.mark.parametrize("mode,jmode", [
    ("standard", "standard"), ("square_virtual", "square_virtual"),
    ("square_pallas", "square_virtual")])
def test_block_skip_step_gradients_match_jax(mode, jmode):
    """One step's gradients with ``attn_block_skip``, leaf by leaf against
    ``jax.value_and_grad`` of JAX's loss with the option:
    ``test_torch_train``'s 1e-5 (multiplier modes) and, with the loss
    scaled by its token count, 4e-5 (square_pallas)."""
    jloss, ref = _jax_grads(jmode)
    tm = _port_lm(mode)
    loss_fn = step_mod.make_loss_fn(tm, step_mod.TrainConfig())
    _, toks = _jax_lm()
    batch = {"tokens": torch.from_numpy(toks)}
    scale = 1.0 if mode != "square_pallas" else float(2 * SEQ)

    def scaled(params, b):
        loss, met = loss_fn(params, b)
        return loss * scale, met

    (loss, _), g = step_mod.value_and_grad(scaled, tm.tree(), batch)
    assert float(loss) / scale == pytest.approx(jloss, rel=1e-6)
    leaves = tree_leaves(g)
    assert len(leaves) == len(ref)
    tol = 1e-5 if scale == 1.0 else 4e-5
    for i, (a, b) in enumerate(zip(leaves, ref)):
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        assert _rel(a / scale, b) <= tol, (i, _rel(a / scale, b))


def test_port_reads_the_options_from_the_config():
    """``attn_forward`` passes the config's three switches, as JAX's
    ``attn_forward`` does: with ``attn_fold_q`` the audit shows nk
    contractions a site in place of nq x nk."""
    tm = _port_lm("square_virtual")
    toks = torch.from_numpy(_jax_lm()[1][:, :SEQ])
    counts = {}
    for fold in (False, True):
        cfg = dataclasses.replace(tm.cfg, attn_fold_q=fold,
                                  attn_block_skip=False)
        view = LM(cfg, device=torch.device("cpu"))
        view.load_state_dict(tm.state_dict())
        with tcount.track_contractions() as ctr, torch.no_grad():
            view.forward(view.tree(), {"tokens": toks})
        counts[fold] = sum(r.site == "attn_scores" for r in ctr.records)
    assert counts == {False: 2 * 4 * 8, True: 2 * 8}
    assert os.environ.get("REPRO_ROUTE") is None
