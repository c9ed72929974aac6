"""The port's LM against the JAX LM with the same weights: ``params_from_jax``
round trip, and ``decode_paged`` hidden states and logits over a prefill
chunk plus decode steps on ``fairsquare-demo.reduced()`` (f32) in the
``standard``, ``square_virtual`` and ``square_pallas`` modes.

In ``square_pallas`` the port runs K1's and K4's plain versions (CPU
tensors) while the JAX side, whose Pallas wrappers cannot run in this
venv, runs the same mode with ``REPRO_ROUTE=matmul=virtual,
paged_attn=gather``.  Tolerance: atol = rtol = 1e-4 on f32 values of
order 1, room for the different summation orders of two f32 pipelines
(square-form sums carry ~k * 2^-23 * (|a| + |b|)^2 of rounding).
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
from repro.models.lm import build_model as jbuild  # noqa: E402
from repro.serve.paged import empty_pos_pool  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs.base import SQUARE_GEMMS_POLICY as T_SQG  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from test_torch_moe import _one_thread  # noqa: E402,F401

ATOL = RTOL = 1e-4
BS, NB, NUM_BLOCKS, CHUNK = 8, 8, 24, 8


def _cfgs(mode, scan=True, arch="fairsquare-demo"):
    jc = dataclasses.replace(jget(arch).reduced(), matmul_mode=mode,
                             scan_layers=scan)
    tc = dataclasses.replace(tget(arch).reduced(), matmul_mode=mode,
                             scan_layers=scan)
    if mode == "square_pallas":
        jc = dataclasses.replace(jc, contraction_policy=J_SQG)
        tc = dataclasses.replace(tc, contraction_policy=T_SQG)
    return jc, tc


def _models(mode, scan=True, arch="fairsquare-demo"):
    jc, tc = _cfgs(mode, scan, arch)
    jm = jbuild(jc)
    params = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    tm = LM(tc, device=torch.device("cpu"), seed=0)
    tm.load_state_dict(params_from_jax(tree))
    return jm, params, tree, tm


@pytest.mark.parametrize("scan", [True, False])
def test_params_from_jax_round_trip(scan):
    jm, params, tree, tm = _models("standard", scan=scan)   # strict load
    sd = tm.state_dict()
    np.testing.assert_array_equal(sd["embed.table"].numpy(),
                                  tree["embed"]["table"])
    for i in range(tm.cfg.n_layers):
        src = tree["scan"]["pos0"] if scan else tree["tail"][f"layer{i}"]
        for name in ("wq", "wk", "wv", "wo"):
            want = src["attn"][name]["w"]
            want = want[i] if scan else want
            got = sd[f"layers.{i}.attn.{name}.w"].numpy()
            assert got.shape == want.shape       # JAX layouts kept
            np.testing.assert_array_equal(got, want)
        for name in ("w_up", "w_gate", "w_down"):
            want = src["ffn"][name]["w"]
            np.testing.assert_array_equal(
                sd[f"layers.{i}.ffn.{name}.w"].numpy(),
                want[i] if scan else want)


def test_params_from_jax_bf16_leaves():
    jc, tc = _cfgs("standard")
    jc = dataclasses.replace(jc, dtype="bfloat16")
    tc = dataclasses.replace(tc, dtype="bfloat16")
    params = jbuild(jc).init(jax.random.PRNGKey(1))
    tree = jax.tree.map(np.asarray, params)
    tm = LM(tc, device=torch.device("cpu"))
    tm.load_state_dict(params_from_jax(tree))
    np.testing.assert_array_equal(
        tm.state_dict()["layers.1.attn.wq.w"].float().numpy(),
        np.asarray(tree["scan"]["pos0"]["attn"]["wq"]["w"][1], np.float32))


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


def _steps(jm, jparams, tm, tparams, jax_route=None):
    """A ragged 2-sequence prefill chunk, then 3 decode steps fed the JAX
    argmax tokens; compares hidden states and logits at every step."""
    cfg = tm.cfg
    P = NUM_BLOCKS * BS
    tables = np.zeros((2, NB), np.int32)
    tables[0, :NB] = 1 + np.arange(NB)
    tables[1, :3] = [9, 10, 11]
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, CHUNK)).astype(np.int32)
    poss = np.tile(np.arange(CHUNK, dtype=np.int32), (2, 1))
    poss[1, 5:] = -1                                  # ragged: 5 tokens
    toks[1, 5:] = 0
    jcache = jm.init_paged_cache(P)
    jpool = jnp.asarray(empty_pos_pool(NUM_BLOCKS, BS))
    tcache = tm.init_paged_cache(P)
    tpool = torch.from_numpy(empty_pos_pool(NUM_BLOCKS, BS))
    last = np.array([CHUNK - 1, 4])
    for step in range(4):
        with _route(jax_route):
            jh, jcache, jpool = jm.decode_paged(
                jparams, jcache, jnp.asarray(toks), jnp.asarray(poss),
                jnp.asarray(tables), jpool, block_size=BS)
            jl = np.asarray(jm.logits(jparams, jh))
        with _route(None):
            th = tm.decode_paged(tparams, tcache, torch.from_numpy(toks),
                                 torch.from_numpy(poss),
                                 torch.from_numpy(tables), tpool,
                                 block_size=BS)
            tl = tm.logits(tparams, th).numpy()
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL,
                                   rtol=RTOL, err_msg=f"hidden, step {step}")
        np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))
        np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=RTOL,
                                   err_msg=f"logits, step {step}")
        nxt = jl[np.arange(2), last].argmax(-1).astype(np.int32)
        poss = np.array([[poss[0].max() + 1], [poss[1].max() + 1]],
                        np.int32)
        toks = nxt[:, None]
        last = np.array([0, 0])


@pytest.mark.parametrize("mode", ["standard", "square_virtual",
                                  "square_pallas"])
@pytest.mark.parametrize("prepared", [False, True])
def test_decode_paged_matches_jax(mode, prepared):
    from repro_torch.kernels import routing
    jm, jparams, _, tm = _models(mode)
    tparams = tm.prepare_params() if prepared else tm.tree()
    if prepared:
        jparams = jm.prepare_params(jparams)
    routing.select_matmul_route.taken.clear()
    routing.select_paged_attn_route.taken.clear()
    jax_route = ("matmul=virtual,paged_attn=gather"
                 if mode == "square_pallas" else None)
    _steps(jm, jparams, tm, tparams, jax_route=jax_route)
    if mode == "square_pallas":
        # the port ran its own routes: K1 and K4 (their plain versions)
        assert routing.select_matmul_route.taken["kernel"] > 0
        assert routing.select_paged_attn_route.taken["kernel"] == \
            4 * tm.cfg.n_layers          # the S=8 chunk and 3 decodes
