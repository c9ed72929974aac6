"""The port's prefix-token LM (``paligemma-3b`` ``.reduced()``: 2 layers, d
64, 4 query heads over 1 KV head of 16, GeGLU, 4 prefix patches, f32)
against the JAX package with the same weights (carried by
``params_from_jax``): the forward's hidden states over the P + S positions,
its logits and its eager audit in all five modes; prefill with patches +
one decode step at position P + S against the forward (JAX's
``test_decode_matches_forward`` contract) and against JAX's; the dense
``Server``'s greedy tokens against JAX's ``Server``, with prompts that fit
the cache and prompts whose P + S overflow it (the ring roll-in and the
decode's clamp at the last slot); the launcher's fallback and tokens
against the JAX launcher's; the Server's audit and routes against
``chip_smoke.py``'s analytic count.

Tolerances as in ``tests/test_torch_recurrent.py``'s docstring (``REL``):
1e-4 * max|ref| for ``standard`` and ``square_virtual``, 1e-3 for the
square-form modes; JAX's square_pallas runs its Pallas kernels in
interpret mode for the forward and on ``REPRO_ROUTE=matmul=virtual`` in
the Server, whose jitted steps cannot run them here.
"""
import collections
import functools
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import counting as jcount  # noqa: E402
from repro.launch import serve as jlaunch  # noqa: E402
from repro.models.lm import build_model as jbuild  # noqa: E402
from repro.serve import server as jsrv  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import counting as tcount  # noqa: E402
from repro_torch.core.matmul import MODES  # noqa: E402
from repro_torch.kernels import routing  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.serve import server as tsrv  # noqa: E402
from test_torch_moe import CPU, JAX_PALLAS_ROUTE, _route  # noqa: E402
from test_torch_recurrent import REL, _cfgs, _close  # noqa: E402
from test_torch_recurrent import _one_thread  # noqa: E402,F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

ARCH = "paligemma-3b"
# 2 slots for 5 requests of 4-23 tokens after 4 patches: P + S from 9 to
# 26, so a 20-entry cache holds some prompts whole and rolls the last 20
# entries of the others into its ring, whose decode steps then write at
# the clamped last slot, as JAX's do
SCFG = dict(max_batch=2, cache_len=20, max_new_tokens=4)
N_REQ = 5


@functools.lru_cache(maxsize=None)
def _jax_params():
    jc, _ = _cfgs(ARCH)
    return jbuild(jc).init(jax.random.PRNGKey(0))


def _models(mode="standard"):
    """The JAX LM, its params (one init for every mode) and the port's LM
    holding the same weights."""
    jc, tc = _cfgs(ARCH, mode)
    params = _jax_params()
    tm = LM(tc, device=CPU)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jbuild(jc), params, tm


def _batch(cfg, B, S, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "patches": rng.normal(size=(B, cfg.prefix_tokens, cfg.d_model))
            .astype(np.float32)}


def _reqs(cfg, make=tserve.make_requests):
    return make(cfg, N_REQ, seed=4)


def test_params_from_jax_carries_the_tied_padded_table_and_mqa():
    """``params_from_jax`` gives the port's state dict whole: the tied
    table padded to ``padded_vocab`` rows, the MQA ``wk``/``wv`` of one KV
    head beside ``wq``'s four, GeGLU's three FFN weights; the leaves equal
    JAX's."""
    _, params, tm = _models()
    cfg = tm.cfg
    sd = tm.state_dict()
    flat = params_from_jax(jax.tree.map(np.asarray, params))
    assert sorted(flat) == sorted(sd)
    assert tuple(sd["embed.table"].shape) == (cfg.padded_vocab, cfg.d_model)
    hd = cfg.resolved_head_dim
    for i in range(cfg.n_layers):
        assert tuple(sd[f"layers.{i}.attn.wq.w"].shape) == (
            cfg.d_model, cfg.n_heads, hd)
        for nm in ("wk", "wv"):
            assert tuple(sd[f"layers.{i}.attn.{nm}.w"].shape) == (
                cfg.d_model, 1, hd)
        assert {k.split(".")[3] for k in sd if k.startswith(
            f"layers.{i}.ffn.")} == {"w_gate", "w_up", "w_down"}
    for name, t in flat.items():
        assert torch.equal(sd[name], t), name


@pytest.mark.parametrize("mode", MODES)
def test_lm_forward_and_audit_match_jax(mode):
    """Hidden states over 4 patches + 12 tokens and their logits in every
    mode (JAX's square_pallas in interpret mode), and the eager audit of
    that forward site by site, against the JAX package's: every
    contraction over the P + S positions."""
    jm, jparams, tm = _models(mode)
    b = _batch(tm.cfg, 2, 12)
    with _route(None):
        with jcount.track_contractions() as jc:
            jh, _, _ = jm.forward(jparams, {k: jnp.asarray(v)
                                            for k, v in b.items()})
            jl = jm.logits(jparams, jh)
        with tcount.track_contractions() as tc, torch.no_grad():
            th, aux, _ = tm.forward(tm.tree(), {k: torch.from_numpy(v)
                                                for k, v in b.items()})
            tl = tm.logits(tm.tree(), th)
    assert th.shape == (2, tm.cfg.prefix_tokens + 12, tm.cfg.d_model)
    rel = REL.get(mode, 1e-4)
    _close(th, jh, rel, "hidden")
    _close(tl, jl, rel, "logits")
    assert float(aux) == 0.0
    want = {s: d["mults"] for s, d in jc.by_site().items()}
    assert {s: d["mults"] for s, d in tc.by_site().items()} == want
    S, d = tm.cfg.prefix_tokens + 12, tm.cfg.d_model
    assert want["logits"] == 2 * S * d * tm.cfg.padded_vocab
    assert tc.fraction_square == jc.fraction_square


@pytest.mark.parametrize("mode", ["standard", "square_pallas"])
def test_decode_matches_forward(mode):
    """``tests/test_models_smoke.py::test_decode_matches_forward`` on the
    port with patches: a prefill of P + 24 positions, one decode step at
    position P + 24 against the forward over P + 25 (rtol 2e-3, atol 2e-3 *
    max), and the prefill + decode logits and the cache after both
    against JAX's."""
    jm, jparams, tm = _models(mode)
    B, S, P = 2, 24, tm.cfg.prefix_tokens
    b = _batch(tm.cfg, B, S + 1, seed=2)
    full = {k: torch.from_numpy(v) for k, v in b.items()}
    pre = dict(full, tokens=full["tokens"][:, :S])
    with torch.no_grad():
        h, _, _ = tm.forward(tm.tree(), full)
        ref = tm.logits(tm.tree(), h)[:, -1]
        hp, cache = tm.prefill(tm.tree(), pre, cache_len=64)
        out, _ = tm.decode_step(tm.tree(), cache, full["tokens"][:, S:],
                                torch.full((B,), P + S))
    assert hp.shape[1] == P + S
    assert cache[0]["pos"][0, :P + S + 1].tolist() == list(range(P + S + 1))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-3,
                               atol=2e-3 * ref.abs().max().item())
    jpre = {k: jnp.asarray(v.numpy()) for k, v in pre.items()}
    with _route(None):
        _, jcache = jm.prefill(jparams, jpre, cache_len=64)
        jout, jcache = jm.decode_step(jparams, jcache,
                                      jnp.asarray(b["tokens"][:, S:]),
                                      jnp.full((B,), P + S, jnp.int32))
    rel = REL.get(mode, 1e-4)
    _close(out, jout, rel, "prefill + decode logits")
    for i, layer in enumerate(cache):
        for key in ("k", "v"):
            _close(layer[key], np.asarray(jcache["scan"]["pos0"][key])[i],
                   rel, f"layer {i} {key}")
        np.testing.assert_array_equal(
            layer["pos"].numpy(), np.asarray(jcache["scan"]["pos0"]["pos"])[i])


def test_launcher_draws_the_jax_launchers_requests():
    """``make_requests`` draws each prompt's length, then its patches, then
    its tokens, in the JAX launcher's order: the same requests."""
    _, tc = _cfgs(ARCH)
    for got, want in zip(_reqs(tc), _reqs(tc, jlaunch.make_requests)):
        np.testing.assert_array_equal(got.tokens, want.tokens)
        assert sorted(got.extras) == sorted(want.extras) == ["patches"]
        np.testing.assert_array_equal(got.extras["patches"],
                                      want.extras["patches"])
        assert got.extras["patches"].shape == (tc.prefix_tokens, tc.d_model)


@pytest.mark.parametrize("mode", ["standard", "square_pallas"])
def test_server_greedy_tokens_match_jax(mode):
    """The dense Server's greedy tokens (prepared, 2 slots for 5
    requests, a 20-entry cache) equal the JAX Server's, twice from one
    server; the requests include prompts whose P + S fit the cache and
    prompts whose P + S overflow it."""
    jm, jparams, tm = _models(mode)
    reqs = _reqs(tm.cfg)
    fills = {len(r.tokens) + tm.cfg.prefix_tokens > SCFG["cache_len"]
             for r in reqs}
    assert fills == {False, True}
    with _route(JAX_PALLAS_ROUTE if mode == "square_pallas" else None):
        jres = jsrv.Server(jm, jm.prepare_params(jparams),
                           jsrv.ServeConfig(**SCFG)).run(
                               _reqs(jm.cfg, jlaunch.make_requests))
    with _route(None):
        server = tsrv.Server(tm, tm.prepare_params(),
                             tsrv.ServeConfig(**SCFG, jit=False),
                             device="cpu")
        first = server.run(reqs)
        second = server.run(_reqs(tm.cfg))
    assert sorted(first) == sorted(jres) == list(range(N_REQ))
    for rid in range(N_REQ):
        assert first[rid] == [int(t) for t in jres[rid]], rid
    assert second == first


def test_server_audit_and_routes_match_the_analytic_count():
    """The eager audit of a square_pallas Server run equals
    ``chip_smoke.recurrent_audit`` site by site (fraction 1.0; each
    prefill's contractions over its P + S positions), and the routes the
    run took equal the routing rules' at
    ``chip_smoke.recurrent_contractions``' shapes -- the counts the card's
    paligemma phase holds its runs to."""
    _, tc = _cfgs(ARCH, "square_pallas")
    tm = LM(tc, device=CPU)
    server = tsrv.Server(tm, tm.prepare_params(),
                         tsrv.ServeConfig(**SCFG, jit=False), device="cpu")
    steps = []
    inner = server._decode
    server._decode = lambda *a: steps.append(1) or inner(*a)
    reqs = _reqs(tc)
    routing.select_matmul_route.taken.clear()
    with tcount.track_contractions() as audit:
        server.run(reqs)
    taken = dict(routing.select_matmul_route.taken)
    lens = [len(r.tokens) for r in reqs]
    B, T = SCFG["max_batch"], SCFG["cache_len"]
    want = chip_smoke.recurrent_audit(tc, lens, len(steps), B, T)
    assert {s: d["mults"] for s, d in audit.by_site().items()} == want
    assert audit.fraction_square == 1.0
    calls = [c for s in lens for c in chip_smoke.recurrent_contractions(
        tc, 1, s)]
    calls += chip_smoke.recurrent_contractions(tc, B, 1, T) * len(steps)
    assert calls[0][3] == lens[0] + tc.prefix_tokens    # the rows: P + S
    with chip_smoke._uncounted_routes():
        routes = collections.Counter(routing.select_matmul_route(
            m, n, k, batch=nb).name for _, _, nb, m, k, n in calls)
    assert taken == dict(routes)


def test_launcher_falls_back_and_serves_jax_launchers_tokens(capsys,
                                                               monkeypatch):
    """Without ``--legacy`` both launchers serve paligemma through the
    dense Server (cache_len 128, 4 slots) with the same note; the port's,
    given JAX's seed-0 weights, serves the JAX launcher's tokens.  With
    its own seed-0 draw it serves that Server's tokens."""
    argv = ["--arch", ARCH, "--reduced", "--requests", "3", "--max-new",
            "3", "--matmul-mode", "square_pallas", "--prepared"]
    note = (f"note: arch {ARCH!r} has non-KV decode state; falling back to "
            f"the dense reference Server")
    with _route(JAX_PALLAS_ROUTE):
        jres = jlaunch.main(argv)
    assert note in capsys.readouterr().out
    _, _, tm = _models("square_pallas")
    monkeypatch.setattr(tserve, "build_model",
                        lambda cfg, device, seed: tm)
    with _route(None):
        res = tserve.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert note in out and "[legacy] served 3 requests" in out
    assert res == {rid: [int(t) for t in v] for rid, v in jres.items()}
    monkeypatch.undo()
    res = tserve.main(argv + ["--device", "cpu"])
    _, tc = _cfgs(ARCH, "square_pallas")
    model = LM(tc, device=CPU, seed=0)
    want = tsrv.Server(model, model.prepare_params(), tsrv.ServeConfig(
        max_batch=4, cache_len=128, max_new_tokens=3), device="cpu").run(
            tserve.make_requests(tc, 3, seed=0))
    assert res == want and all(len(t) == 3 for t in res.values())
