"""The port's MoE path against the JAX package with the same weights
(carried by ``params_from_jax``): ``models/moe.py``, the ``moe`` block,
the LM (forward, prefill and decode, paged and dense) and batched prepared
expert weights, on ``mixtral-8x7b.reduced()`` and
``moonshot-v1-16b-a3b.reduced()`` (f32), drop-free at their capacity
factor 8.0 and with forced drops at 0.01 (the contract of
``tests/test_blocks_units.py``'s MoE tests).

Tolerances: routing (expert indices, keep mask, destinations) exact;
outputs and the aux loss at rtol = atol = 1e-5 where both sides run the
multiplier (``standard``, ``square_virtual``), at 1e-4 for the emulated
square forms (``square_exact``, ``square_scan``: the same squares summed
in another order), and for ``square_pallas`` -- the port's K1 and K2/K3
plain versions on these CPU tensors against the JAX side, whose Pallas
wrappers cannot run in this venv, on ``REPRO_ROUTE=matmul=virtual,
paged_attn=gather`` -- at the f32 sweep tolerance rtol 5e-3, atol 5e-3 * k;
bf16 at rtol 5e-2, atol 0.5.  The serving stack over these archs is in
``tests/test_torch_moe_serving.py``.
"""
import contextlib
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs.base import SQUARE_GEMMS_POLICY as J_SQG  # noqa: E402
from repro.core.einsum import fs_einsum as jfs_einsum  # noqa: E402
from repro.layers.param import init_tree  # noqa: E402
from repro.models import blocks as jblk  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.lm import build_model as jbuild  # noqa: E402
from repro.serve import paged as jpaged  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs.base import SQUARE_GEMMS_POLICY as T_SQG  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.einsum import fs_einsum  # noqa: E402
from repro_torch.core.matmul import MODES  # noqa: E402
from repro_torch.core.prepared import prepare_operand  # noqa: E402
from repro_torch.kernels import ops, routing  # noqa: E402
from repro_torch.models import blocks as tblk  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.serve import paged as tpaged  # noqa: E402

ARCHS = ("mixtral-8x7b", "moonshot-v1-16b-a3b")
JAX_PALLAS_ROUTE = "matmul=virtual,paged_attn=gather"
CPU = torch.device("cpu")


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


def _jax_route(mode):
    return JAX_PALLAS_ROUTE if mode == "square_pallas" else None


def _synchronous(engine):
    """Make the JAX engine wait for each model call (its CPU table race,
    see ``tests/test_torch_engine.py``)."""
    for name in ("_chunk", "_decode", "_logits_at"):
        fn = getattr(engine, name)
        setattr(engine, name,
                lambda *a, _f=fn: jax.block_until_ready(_f(*a)))
    return engine


def _cfgs(arch, mode="standard", policy=False, **kw):
    jc = dataclasses.replace(jget(arch).reduced(), matmul_mode=mode, **kw)
    tc = dataclasses.replace(tget(arch).reduced(), matmul_mode=mode, **kw)
    if policy:
        jc = dataclasses.replace(jc, contraction_policy=J_SQG)
        tc = dataclasses.replace(tc, contraction_policy=T_SQG)
    return jc, tc


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are small: one torch thread computes them as fast, and
    leaves the cores to the other test processes (a suite run's workers
    each start a thread per core).  The port's other test files import
    this fixture."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_PARAMS = {}


def _jax_params(jc):
    """JAX's seed-0 params of ``jc`` and the port's state dict of them,
    built once a config for the whole process: they depend on neither the
    mode nor the policy, so every test of one arch shares them."""
    key = dataclasses.replace(jc, matmul_mode="standard",
                              contraction_policy=None)
    if key not in _PARAMS:
        params = jbuild(key).init(jax.random.PRNGKey(0))
        _PARAMS[key] = (params,
                        params_from_jax(jax.tree.map(np.asarray, params)))
    return _PARAMS[key]


def _models(arch, mode="standard", policy=False, **kw):
    jc, tc = _cfgs(arch, mode, policy, **kw)
    params, state = _jax_params(jc)
    tm = LM(tc, device=CPU)
    tm.load_state_dict(state)
    return jbuild(jc), params, tm


def _to_torch(tree):
    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return jax.tree.map(conv, tree)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _tol(mode, k):
    if mode in ("standard", "square_virtual"):
        return dict(rtol=1e-5, atol=1e-5)
    if mode in ("square_exact", "square_scan"):
        return dict(rtol=1e-4, atol=1e-4)
    return dict(rtol=5e-3, atol=5e-3 * k)


# ------------------------------------------------------------ capacity
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_moe_capacity_matches_jax(arch, reduced):
    jc, tc = jget(arch), tget(arch)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    for cf in (tc.capacity_factor, 0.01):
        j = dataclasses.replace(jc, capacity_factor=cf)
        t = dataclasses.replace(tc, capacity_factor=cf)
        assert [tmoe.moe_capacity(n, t) for n in range(1, 301)] == \
            [jmoe.moe_capacity(n, j) for n in range(1, 301)]


# ----------------------------------------------------- moe_apply_local
def _jax_routing(p, x, cfg, mode):
    """``repro/models/moe.py``'s routing lines (expert indices, keep mask,
    destinations), which its ``moe_apply_local`` does not return."""
    T = x.shape[0]
    E, K = cfg.n_experts, cfg.topk
    C = jmoe.moe_capacity(T, cfg)
    logits = jfs_einsum("td,de->te", x.astype(jnp.float32), p["router"]["w"],
                        mode=mode, site="moe_router")
    probs = jax.nn.softmax(logits, axis=-1)
    _, expert_idx = jax.lax.top_k(probs, K)
    flat = expert_idx.reshape(-1)
    se = flat[jnp.argsort(flat, stable=True)]
    counts = jnp.bincount(se, length=E)
    rank = jnp.arange(T * K) - (jnp.cumsum(counts) - counts)[se]
    keep = rank < C
    dest = jnp.where(keep, se * C + rank, E * C)
    return (np.asarray(expert_idx), np.asarray(keep), np.asarray(dest),
            np.asarray(counts))


def _moe_pair(arch, cf, dtype="float32", T=40, seed=0):
    jc, tc = _cfgs(arch, capacity_factor=cf, dtype=dtype)
    jp = init_tree(jmoe.moe_spec(jc), jax.random.PRNGKey(seed))
    x = np.random.default_rng(seed).normal(size=(T, jc.d_model)) \
        .astype(np.float32)
    return jc, tc, jp, _to_torch(jp), x


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [8.0, 0.01])
@pytest.mark.parametrize("mode", MODES)
def test_moe_apply_local_matches_jax(arch, cf, mode):
    jc, tc, jp, tp, x = _moe_pair(arch, cf)
    with _route(_jax_route(mode)):
        jidx, jkeep, jdest, jcounts = _jax_routing(jp, jnp.asarray(x), jc,
                                                   mode)
        jout, jaux = jmoe.moe_apply_local(jp, jnp.asarray(x), cfg=jc,
                                          mode=mode)
    routing.select_matmul_route.taken.clear()
    with _route(None):
        xt = torch.from_numpy(x)
        _, gates, idx = tmoe.moe_route(tp, xt, cfg=tc, mode=mode)
        d = tmoe.moe_dispatch(idx, gates, tc.n_experts,
                              tmoe.moe_capacity(x.shape[0], tc))
        out, aux = tmoe.moe_apply_local(tp, xt, cfg=tc, mode=mode)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(d["keep"].numpy(), jkeep)
    np.testing.assert_array_equal(d["dest"].numpy(), jdest)
    np.testing.assert_array_equal(d["counts"].numpy(), jcounts)
    assert (cf < 1) == bool((~d["keep"]).any())      # drops only when forced
    assert out.dtype == torch.float32 and out.shape == x.shape
    tol = _tol(mode, tc.d_ff)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **tol)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-5)
    if mode == "square_pallas":
        # the port's own route: K2 (plain version) for the expert GEMMs
        assert routing.select_matmul_route.taken["batched"] == 3


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["standard", "square_pallas"])
def test_moe_apply_local_bf16_matches_jax(arch, mode):
    jc, tc, jp, tp, x = _moe_pair(arch, 8.0, dtype="bfloat16")
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    with _route(_jax_route(mode)):
        jout, jaux = jmoe.moe_apply_local(jp, xb, cfg=jc, mode=mode)
    with _route(None):
        out, aux = tmoe.moe_apply_local(
            tp, torch.from_numpy(x).to(torch.bfloat16), cfg=tc, mode=mode)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(jout), rtol=5e-2, atol=0.5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=5e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_router_ties_pick_the_lowest_experts_like_top_k(arch):
    """A zero router makes every probability equal: every row picks experts
    0..K-1, as ``jax.lax.top_k`` does, with equal gates."""
    jc, tc, jp, tp, x = _moe_pair(arch, 8.0, T=9)
    jp["router"]["w"] = jnp.zeros_like(jp["router"]["w"])
    tp["router"]["w"] = torch.zeros_like(tp["router"]["w"])
    jidx, *_ = _jax_routing(jp, jnp.asarray(x), jc, "standard")
    _, gates, idx = tmoe.moe_route(tp, torch.from_numpy(x), cfg=tc)
    K = tc.topk
    assert idx.tolist() == [list(range(K))] * 9
    np.testing.assert_array_equal(idx.numpy(), jidx)
    assert torch.equal(gates, torch.full((9, K), 1.0 / K))


def test_moe_dispatch_drops_beyond_capacity_to_the_sink():
    """Every expert keeps its first C assignments in token order; the rest
    go to the sink row E*C."""
    idx = torch.tensor([[0, 1], [0, 1], [0, 2], [0, 1], [0, 3]])
    d = tmoe.moe_dispatch(idx, torch.full((5, 2), 0.5), 4, 2)
    assert d["counts"].tolist() == [5, 3, 1, 1]
    assert d["st"].tolist() == [0, 1, 2, 3, 4, 0, 1, 3, 2, 4]
    assert d["dest"].tolist() == [0, 1, 8, 8, 8, 2, 3, 8, 4, 6]


# ------------------------------------------------------------ the block
def _block_pair(arch, mode, seed=3):
    jc, tc = _cfgs(arch, mode)
    jp = init_tree(jblk.block_spec("moe", jc), jax.random.PRNGKey(seed))
    return jc, tc, jp, _to_torch(jp)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["standard", "square_pallas"])
def test_moe_block_forward_and_dense_decode_match_jax(arch, mode):
    jc, tc, jp, tp = _block_pair(arch, mode)
    B, S = 2, 12
    x = np.random.default_rng(4).normal(size=(B, S, jc.d_model)) \
        .astype(np.float32)
    jctx = {"cfg": jc, "mode": mode, "positions": jnp.arange(S),
            "causal": True}
    tctx = {"cfg": tc, "mode": mode, "positions": torch.arange(S),
            "causal": True}
    with _route(_jax_route(mode)):
        jy, jseed, jaux = jblk.block_forward("moe", jp, jnp.asarray(x), jctx)
    with _route(None):
        ty, tseed, taux = tblk.block_forward("moe", tp, torch.from_numpy(x),
                                             tctx)
    tol = _tol(mode, tc.d_ff)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **tol)
    np.testing.assert_allclose(tseed["k"].numpy(), np.asarray(jseed["k"]),
                               **tol)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5,
                               atol=1e-5)
    assert float(taux) > 0

    jcache = jblk.block_init_cache("moe", jc, B, 16)
    tcache = tblk.block_init_cache("moe", tc, B, 16, CPU)
    for t in range(3):
        xt = x[:, t:t + 1]
        pos = np.full((B,), t, np.int32)
        with _route(_jax_route(mode)):
            jo, jcache = jblk.block_decode(
                "moe", jp, jnp.asarray(xt), jcache,
                {"cfg": jc, "mode": mode, "pos": jnp.asarray(pos)})
        with _route(None):
            to = tblk.block_decode("moe", tp, torch.from_numpy(xt), tcache,
                                   {"cfg": tc, "mode": mode,
                                    "pos": torch.from_numpy(pos)})
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **tol,
                                   err_msg=f"decode step {t}")
        # the decode of a prefix equals the full pass at that position
        np.testing.assert_allclose(to.numpy()[:, 0], ty.numpy()[:, t],
                                   rtol=1e-4, atol=1e-4)


def test_moe_block_is_pageable_and_unported_kinds_name_step_6():
    assert tblk.PAGEABLE_KINDS == jblk.PAGEABLE_KINDS == ("attn", "moe",
                                                          "lattn")
    tc = tget("moonshot-v1-16b-a3b").reduced()
    pool = tblk.block_init_paged_cache("moe", tc, 64, CPU)
    assert tuple(pool["k"].shape) == (64, tc.n_kv_heads,
                                      tc.resolved_head_dim)
    # the recurrent kinds are ported but have no paged cache, as in JAX
    for kind in ("rglru", "mlstm", "slstm"):
        with pytest.raises(ValueError, match="no paged decode cache"):
            tblk.block_init_paged_cache(kind, tc, 64, CPU)
    # xdec (whisper) is ported and not pageable either; paligemma's
    # prefix tokens build, and its LM refuses the paged cache, as JAX's
    assert {"lnx", "xattn"} <= set(tblk.block_spec("xdec", tc))
    with pytest.raises(ValueError, match="no paged decode cache"):
        tblk.block_init_paged_cache("xdec", tc, 64, CPU)
    vlm = LM(tget("paligemma-3b").reduced(), device=CPU)
    assert vlm.kinds == ("attn",) * vlm.cfg.n_layers
    with pytest.raises(ValueError, match="prefix-token archs"):
        vlm.init_paged_cache(64)


# -------------------------------------------------------------- the LM
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("scan", [True, False])
def test_params_from_jax_carries_the_moe_stacks(arch, scan):
    jc, tc = _cfgs(arch, scan_layers=scan)
    tree = jax.tree.map(np.asarray, jbuild(jc).init(jax.random.PRNGKey(2)))
    sd = params_from_jax(tree)
    tm = LM(tc, device=CPU)
    tm.load_state_dict(sd)                              # strict
    E, d, f = tc.n_experts, tc.d_model, tc.d_ff
    for i in range(tc.n_layers):
        src = tree["scan"]["pos0"]["ffn"] if scan \
            else tree["tail"][f"layer{i}"]["ffn"]
        for name, shape in (("router", (d, E)), ("w_gate", (E, d, f)),
                            ("w_up", (E, d, f)), ("w_down", (E, f, d))):
            got = sd[f"layers.{i}.ffn.{name}.w"]
            want = src[name]["w"][i] if scan else src[name]["w"]
            assert tuple(got.shape) == shape
            np.testing.assert_array_equal(got.numpy(), want)
        assert sd[f"layers.{i}.ffn.router.w"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["standard", "square_virtual",
                                  "square_pallas"])
def test_lm_forward_matches_jax(arch, mode):
    jm, jparams, tm = _models(arch, mode)
    toks = np.random.default_rng(5).integers(0, tm.cfg.vocab, (2, 20)) \
        .astype(np.int32)
    with _route(_jax_route(mode)):
        jh, jaux, _ = jm.forward(jparams, {"tokens": jnp.asarray(toks)})
        jl = jm.logits(jparams, jh)
    with _route(None), torch.no_grad():
        th, taux, _ = tm.forward(tm.tree(), {"tokens": torch.from_numpy(toks)})
        tl = tm.logits(tm.tree(), th)
    tol = _tol(mode, tm.cfg.d_ff) if mode == "square_pallas" \
        else dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **tol)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert float(taux) > 0                  # the blocks' aux losses, summed


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_step_match_the_full_forward(arch):
    """``tests/test_models_smoke.py::test_decode_matches_forward`` on the
    port: drop-free, the last decode step's logits equal the full pass's."""
    _, tc = _cfgs(arch)
    tm = LM(tc, device=CPU, seed=1)
    B, S = 2, 24
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, tc.vocab, (B, S + 1)).astype(np.int32))
    params = tm.tree()
    with torch.no_grad():
        h_full, _, _ = tm.forward(params, {"tokens": toks})
        ref = tm.logits(params, h_full)[:, -1].numpy()
        _, cache = tm.prefill(params, {"tokens": toks[:, :S]}, cache_len=64)
        out, _ = tm.decode_step(params, cache, toks[:, S:S + 1],
                                torch.full((B,), S, dtype=torch.int32))
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-3,
                               atol=2e-3 * np.abs(ref).max())


def _paged_steps(jm, jparams, tm, tparams, mode):
    """A ragged 2-sequence prefill chunk, then 3 decode steps fed the JAX
    argmax tokens, through both LMs' ``decode_paged``."""
    BS, NB, NUM, CH = 8, 4, 12, 8
    tables = np.zeros((2, NB), np.int32)
    tables[0] = 1 + np.arange(NB)
    tables[1, :2] = [5, 6]
    toks = np.random.default_rng(6).integers(0, tm.cfg.vocab, (2, CH)) \
        .astype(np.int32)
    poss = np.tile(np.arange(CH, dtype=np.int32), (2, 1))
    poss[1, 5:], toks[1, 5:] = -1, 0
    jcache, tcache = jm.init_paged_cache(NUM * BS), tm.init_paged_cache(
        NUM * BS)
    jpool = jnp.asarray(jpaged.empty_pos_pool(NUM, BS))
    tpool = torch.from_numpy(tpaged.empty_pos_pool(NUM, BS))
    last = np.array([CH - 1, 4])
    tol = _tol(mode, tm.cfg.d_ff)
    for step in range(4):
        with _route(_jax_route(mode)):
            jh, jcache, jpool = jm.decode_paged(
                jparams, jcache, jnp.asarray(toks), jnp.asarray(poss),
                jnp.asarray(tables), jpool, block_size=BS)
            jl = np.asarray(jm.logits(jparams, jh))
        with _route(None), torch.no_grad():
            th = tm.decode_paged(tparams, tcache, torch.from_numpy(toks),
                                 torch.from_numpy(poss),
                                 torch.from_numpy(tables), tpool,
                                 block_size=BS)
            tl = tm.logits(tparams, th).numpy()
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **tol,
                                   err_msg=f"hidden, step {step}")
        np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
        np.testing.assert_allclose(tl, jl, **tol, err_msg=f"step {step}")
        nxt = jl[np.arange(2), last].argmax(-1).astype(np.int32)
        poss = np.array([[poss[0].max() + 1], [poss[1].max() + 1]],
                        np.int32)
        toks, last = nxt[:, None], np.array([0, 0])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["standard", "square_pallas"])
def test_decode_paged_matches_jax(arch, mode):
    """The moe block's paged decode (a prefill chunk with padded rows, then
    decode steps) through both LMs, prepared weights on both sides."""
    jm, jparams, tm = _models(arch, mode)
    routing.select_matmul_route.taken.clear()
    _paged_steps(jm, jm.prepare_params(jparams), tm, tm.prepare_params(),
                 mode)
    if mode == "square_pallas":
        assert routing.select_matmul_route.taken["batched"] > 0


def _decode_dense(tm, params, prompt, n_new, cache_len):
    hidden, cache = tm.prefill(params, {"tokens": torch.from_numpy(
        prompt[None])}, cache_len=cache_len)
    logits = [tm.logits(params, hidden[:, -1:])[0, 0].numpy()]
    toks, pos = [int(np.argmax(logits[-1]))], len(prompt)
    for _ in range(n_new - 1):
        lg, cache = tm.decode_step(params, cache, torch.tensor([[toks[-1]]]),
                                   torch.tensor([pos]))
        logits.append(lg[0].numpy())
        toks.append(int(np.argmax(logits[-1])))
        pos += 1
    return toks, logits


def _decode_paged(tm, params, prompt, n_new, *, block_size, num_blocks,
                  blocks_per_seq, chunk):
    alloc = tpaged.BlockAllocator(num_blocks, block_size)
    tables = tpaged.BlockTables(alloc, 1, blocks_per_seq)
    assert tables.ensure(0, len(prompt) + n_new)
    cache = tm.init_paged_cache(num_blocks * block_size)
    pool = torch.from_numpy(tpaged.empty_pos_pool(num_blocks, block_size))
    tb = torch.from_numpy(tables.table)
    for lo in range(0, len(prompt), chunk):
        part = prompt[lo:lo + chunk]
        t = np.zeros((1, chunk), np.int32)
        p = np.full((1, chunk), -1, np.int32)
        t[0, :len(part)] = part
        p[0, :len(part)] = np.arange(lo, lo + len(part))
        h = tm.decode_paged(params, cache, torch.from_numpy(t),
                            torch.from_numpy(p), tb, pool,
                            block_size=block_size)
        last = len(part) - 1
    logits = [tm.logits(params, h[:, last:last + 1])[0, 0].numpy()]
    toks, pos = [int(np.argmax(logits[-1]))], len(prompt)
    for _ in range(n_new - 1):
        h = tm.decode_paged(params, cache,
                            torch.tensor([[toks[-1]]], dtype=torch.int32),
                            torch.tensor([[pos]], dtype=torch.int32), tb,
                            pool, block_size=block_size)
        logits.append(tm.logits(params, h)[0, 0].numpy())
        toks.append(int(np.argmax(logits[-1])))
        pos += 1
    return toks, logits


def test_paged_matches_dense_decode_moonshot():
    """``tests/test_paged_cache.py::test_paged_matches_dense_decode`` for
    the MoE arch on the port: chunked paged prefill + paged decode equal
    the dense prefill + decode."""
    _, tc = _cfgs("moonshot-v1-16b-a3b")
    tm = LM(tc, device=CPU, seed=1)
    prompt = np.random.default_rng(3).integers(0, tc.vocab, 11,
                                               dtype=np.int32)
    with torch.no_grad():
        toks_d, logits_d = _decode_dense(tm, tm.tree(), prompt, 5, 32)
        toks_p, logits_p = _decode_paged(tm, tm.tree(), prompt, 5,
                                         block_size=8, num_blocks=8,
                                         blocks_per_seq=4, chunk=4)
    assert toks_p == toks_d
    for a, b in zip(logits_d, logits_p):
        np.testing.assert_allclose(a, b, atol=1e-4)


# ----------------------------------------------- prepared batched weights
BATCHED_SHAPES = {"batched": (4, 12, 64, 48),      # K2
                  "fold": (16, 2, 64, 32)}         # K3


@pytest.mark.parametrize("route", sorted(BATCHED_SHAPES))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prepared_batched_equals_raw_bit_for_bit(route, mode, dtype):
    """``tests/test_prepared_routing.py::test_prepared_batched_expert_gemm``
    on the port, on K2's and K3's routes: the prepared expert stack and its
    raw source give the same bits in every mode."""
    B, m, k, n = BATCHED_SHAPES[route]
    g = torch.Generator().manual_seed(7)
    x = torch.randn(B, m, k, generator=g).to(dtype)
    w = torch.randn(B, k, n, generator=g).to(dtype)
    prep = prepare_operand(w, site="moe_expert")
    assert prep.kind == "matmul_batched" and prep.kn_shape == (k, n)
    routing.select_matmul_route.taken.clear()
    r1 = fs_einsum("ecd,edf->ecf", x, w, mode=mode)
    r2 = fs_einsum("ecd,edf->ecf", x, prep, mode=mode)
    assert torch.equal(r1, r2)
    if mode == "square_pallas":
        assert routing.select_matmul_route.taken[route] == 2
        a = x.to(torch.float32) if dtype == torch.bfloat16 else x
        assert torch.equal(ops.sq_matmul_local(a, prep, fold=route == "fold"),
                           ops.sq_matmul_local(a, w, fold=route == "fold"))


def test_prepared_batched_falls_back_where_its_layout_is_not_the_specs():
    """A spec contracting the stack's last axis uses the raw source (still
    correct, prepared per call)."""
    x = torch.randn(3, 5, 6)
    w = torch.randn(3, 4, 6)
    prep = prepare_operand(w)
    ref = torch.einsum("ecd,efd->ecf", x, w)
    out = fs_einsum("ecd,efd->ecf", x, prep, mode="square_pallas")
    torch.testing.assert_close(out, ref, rtol=5e-3, atol=5e-3 * 6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", MODES)
def test_lm_prepare_params_moe_bit_identical(arch, mode):
    """``tests/test_prepared_routing.py::test_lm_prepare_params_moe`` on
    the port: the prepared router and expert stacks change no bit of the
    hidden states."""
    _, tc = _cfgs(arch, mode)
    tm = LM(tc, device=CPU, seed=1)
    pp = tm.prepare_params()
    ffn = pp["layers"][0]["ffn"]
    assert ffn["router"]["w"].site == "moe_router"
    assert ffn["router"]["w"].canon.dtype == torch.float32
    for name in ("w_gate", "w_up", "w_down"):
        assert ffn[name]["w"].kind == "matmul_batched"
        assert ffn[name]["w"].site == "moe_expert"
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tc.vocab, (2, 16)).astype(np.int32))
    with torch.no_grad():
        h1, a1, _ = tm.forward(tm.tree(), {"tokens": toks})
        h2, a2, _ = tm.forward(pp, {"tokens": toks})
    assert torch.equal(h1, h2) and torch.equal(a1, a2)
