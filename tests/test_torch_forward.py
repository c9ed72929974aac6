"""The port's full-sequence forward, prefill and dense decode against the JAX
LM with the same weights (``params_from_jax``), on ``.reduced()`` (f32)
configurations:

- ``fairsquare-demo``, ``deepseek-7b`` and ``command-r-35b`` (G = 2 after
  reduction), and ``h2o-danube-3-4b`` and ``starcoder2-3b`` (layernorm,
  gelu, attention and ffn biases) for a sliding window of 64: their prefill
  of a 70-token prompt rolls the last 64 entries into the ring cache, and
  their decode writes at ``pos % 64``;
- modes ``standard``, ``square_virtual`` and ``square_pallas`` with no
  contraction policy, where the port's attention einsums run K2/K3's plain
  version (CPU tensors) while the JAX side, whose Pallas wrappers cannot
  run in this venv, runs the same mode with ``REPRO_ROUTE=matmul=virtual``;
- a batch of a 70-token and (for ``LM.forward``) a 21-token prompt: 70 is
  over the reduced ``attn_chunk_q``/``attn_chunk_kv`` of 32, so the online
  softmax carries across three kv chunks and pads the last q and kv chunks.

Tolerance: atol = rtol = 1e-4 on f32 values of order 1 (``test_torch_lm``'s),
room for two f32 pipelines' summation orders and the square form's
~k * 2^-23 * (|a| + |b|)^2 rounding.
"""
import contextlib
import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models.lm import build_model as jbuild  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import routing  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from test_torch_moe import _one_thread  # noqa: E402,F401

ATOL = RTOL = 1e-4
CACHE_LEN = 128
ARCHS = ("fairsquare-demo", "deepseek-7b", "h2o-danube-3-4b", "starcoder2-3b",
         "command-r-35b")
MODES = ("standard", "square_virtual", "square_pallas")


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
    return "matmul=virtual,paged_attn=gather" \
        if mode == "square_pallas" else None


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    """JAX's seed-0 params of ``arch``'s ``.reduced()`` and the port's
    state dict of them, once an arch for the file: they do not depend on
    the mode."""
    params = jbuild(jget(arch).reduced()).init(jax.random.PRNGKey(0))
    return params, params_from_jax(jax.tree.map(np.asarray, params))


def _models(arch, mode):
    jc = dataclasses.replace(jget(arch).reduced(), matmul_mode=mode)
    tc = dataclasses.replace(tget(arch).reduced(), matmul_mode=mode)
    params, state = _jax_params(arch)
    tm = LM(tc, device=torch.device("cpu"))
    tm.load_state_dict(state)
    return jbuild(jc), params, tm


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL, err_msg=what)


def _jax_layers(cache, n_layers):
    """The JAX cache's per-layer dicts in layer order (scan stack of one
    attn period, then tail)."""
    out = []
    if "scan" in cache:
        c = cache["scan"]["pos0"]
        out += [{k: np.asarray(v[i]) for k, v in c.items()}
                for i in range(c["k"].shape[0])]
    for i in range(len(cache.get("tail", {}))):
        out.append({k: np.asarray(v)
                    for k, v in cache["tail"][f"layer{i}"].items()})
    assert len(out) == n_layers
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, mode):
    jm, jparams, tm = _models(arch, mode)
    routing.select_matmul_route.taken.clear()
    for S in (70, 21):
        toks = _tokens(tm.cfg.vocab, (2, S), seed=S)
        with _route(_jax_route(mode)):
            jh, _, _ = jax.jit(jm.forward)(jparams,
                                           {"tokens": jnp.asarray(toks)})
            jl = jm.logits(jparams, jh)
        with _route(None), torch.no_grad():
            th, aux, seeds = tm.forward(tm.tree(),
                                        {"tokens": torch.from_numpy(toks)})
            tl = tm.logits(tm.tree(), th)
        assert seeds == [] and float(aux) == 0.0
        _close(th, jh, f"{arch} {mode} S={S}: hidden")
        _close(tl, jl, f"{arch} {mode} S={S}: logits")
    if mode == "square_pallas":
        # the 70-token prompt's chunks are large enough for K2 (batched)
        assert routing.select_matmul_route.taken["batched"] > 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_step_match_jax(arch, mode):
    """Prefill a batch of 4 prompts of 70 tokens, then 3 decode steps at
    per-row positions, fed the JAX argmax tokens."""
    jm, jparams, tm = _models(arch, mode)
    tparams = tm.tree()
    B, S = 4, 70
    toks = _tokens(tm.cfg.vocab, (B, S), seed=5)
    routing.select_matmul_route.taken.clear()
    with _route(_jax_route(mode)):
        jh, jcache = jax.jit(jm.prefill, static_argnums=2)(
            jparams, {"tokens": jnp.asarray(toks)}, CACHE_LEN)
        nxt = np.asarray(jm.logits(jparams, jh[:, -1:])[:, 0]).argmax(-1)
    with _route(None), torch.no_grad():
        th, tcache = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                                CACHE_LEN)
    _close(th, jh, "prefill hidden")
    T = CACHE_LEN if tm.cfg.window is None else min(CACHE_LEN, tm.cfg.window)
    for i, (tc, jc) in enumerate(zip(tcache,
                                     _jax_layers(jcache, tm.cfg.n_layers))):
        assert tc["k"].shape == (B, T, tm.cfg.n_kv_heads, 16)
        np.testing.assert_array_equal(tc["pos"].numpy(), jc["pos"])
        _close(tc["k"], jc["k"], f"layer {i} k")
        _close(tc["v"], jc["v"], f"layer {i} v")
    if tm.cfg.window is not None:          # ring roll-in: S >= T
        assert sorted(tcache[0]["pos"][0].tolist()) == list(range(S - T, S))
    else:
        assert (tcache[0]["pos"][:, S:] == tattn.EMPTY_POS).all()

    jdec = jax.jit(jm.decode_step)
    pos = np.full(B, S, np.int32)
    for step in range(3):
        tok = nxt.astype(np.int32)[:, None]
        with _route(_jax_route(mode)):
            jl, jcache = jdec(jparams, jcache, jnp.asarray(tok),
                              jnp.asarray(pos))
        with _route(None), torch.no_grad():
            tl, tcache = tm.decode_step(tparams, tcache,
                                        torch.from_numpy(tok),
                                        torch.from_numpy(pos))
        _close(tl, jl, f"{arch} {mode} decode step {step}: logits")
        for tc, jc in zip(tcache, _jax_layers(jcache, tm.cfg.n_layers)):
            np.testing.assert_array_equal(tc["pos"].numpy(), jc["pos"])
        nxt = np.asarray(jl).argmax(-1)
        pos = pos + 1
    if mode == "square_pallas":
        taken = routing.select_matmul_route.taken
        assert taken["batched"] > 0 and taken["kernel"] > 0
        if tm.cfg.window is None:
            # B * KV = 8 elements of 2 x 128 at decode: the fold route (K3)
            assert taken["fold"] > 0


def test_decode_clamps_without_a_window():
    """Past the cache's end a non-window arch writes the last slot, as the
    JAX ``min(pos, T - 1)`` clamp does."""
    cfg = tget("fairsquare-demo").reduced()
    tm = LM(cfg, device=torch.device("cpu"))
    cache = tm.init_cache(2, 8)
    with torch.no_grad():
        tm.decode_step(tm.tree(), cache, torch.zeros(2, 1, dtype=torch.int32),
                       torch.tensor([3, 11], dtype=torch.int32))
    assert cache[0]["pos"][0].tolist() == [tattn.EMPTY_POS] * 3 + [3] + \
        [tattn.EMPTY_POS] * 4
    assert cache[0]["pos"][1].tolist() == [tattn.EMPTY_POS] * 7 + [11]


def test_fully_masked_rows_are_finite():
    """A q row that sees nothing (position -1) and kv padding (EMPTY_POS)
    give finite outputs."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(1, 5, 2, 2, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 7, 2, 16)).astype(np.float32))
    out = tattn.chunked_attention(
        q, k, k, torch.tensor([-1, 0, 1, 2, 3]),
        torch.tensor([0, 1, 2, 3, tattn.EMPTY_POS, tattn.EMPTY_POS, 6]),
        causal=True, window=None, chunk_q=2, chunk_kv=3)
    assert torch.isfinite(out).all()
