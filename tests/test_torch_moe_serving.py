"""The port's MoE serving stack against the JAX package with the same
weights: the paged engine and the dense ``Server`` (greedy tokens), the
engine's compiled path on a CPU stub, engines sharing one prepared tree,
the contraction audit and the serve launcher, on ``mixtral-8x7b`` and
``moonshot-v1-16b-a3b`` ``.reduced()`` (f32).  The JAX side serves
``square_pallas`` on ``REPRO_ROUTE=matmul=virtual,paged_attn=gather`` and
waits on each engine model call (its CPU table race); see
``tests/test_torch_moe.py`` for the helpers and tolerances.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import counting as jcount  # noqa: E402
from repro.launch.serve import make_requests as jrequests  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.serve import server as jsrv  # noqa: E402
from repro_torch.core import counting as tcount  # noqa: E402
from repro_torch.core import graphs  # noqa: E402
from repro_torch.kernels import routing  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import server as tsrv  # noqa: E402
from test_torch_compiled import _StubCall  # noqa: E402
from test_torch_moe import (ARCHS, CPU, JAX_PALLAS_ROUTE,  # noqa: E402,F401
                            _cfgs, _jax_route, _models, _one_thread,
                            _route, _synchronous)


# -------------------------------------------------- engine and Server
ENGINE_GEO = dict(max_slots=4, block_size=8, num_blocks=32, blocks_per_seq=6,
                  prefill_chunk=8, max_new_tokens=4)


@pytest.mark.parametrize("arch,mode", [
    ("moonshot-v1-16b-a3b", "standard"),
    ("moonshot-v1-16b-a3b", "square_pallas"),
    ("mixtral-8x7b", "square_pallas")])
def test_engine_greedy_tokens_match_jax(arch, mode):
    """``tests/test_engine.py::test_engine_moe_arch``'s geometry: 6 ragged
    requests through both paged engines, prepared, the same greedy
    tokens."""
    jm, jparams, tm = _models(arch, mode, policy=mode == "square_pallas")
    jreqs = jrequests(jm.cfg, 6, seed=9, lo=3, hi=20)
    treqs = tserve.make_requests(tm.cfg, 6, seed=9, lo=3, hi=20)
    with _route(_jax_route(mode)):
        je = _synchronous(jeng.Engine(jm, jparams, jeng.EngineConfig(
            prepared=True, **ENGINE_GEO)))
        jres = je.run(jreqs)
    routing.select_matmul_route.taken.clear()
    with _route(None):
        te = teng.Engine(tm, teng.EngineConfig(prepared=True, **ENGINE_GEO),
                         device="cpu")
        tres = te.run(treqs)
    assert sorted(tres) == sorted(jres) == list(range(6))
    for rid in range(6):
        assert tres[rid].ok and jres[rid].ok
        assert tres[rid].tokens == jres[rid].tokens, rid
    assert te.metrics.decode_steps == je.metrics.decode_steps
    if mode == "square_pallas":
        assert routing.select_matmul_route.taken["batched"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_server_greedy_tokens_match_jax(arch):
    jm, jparams, tm = _models(arch, "square_pallas")
    scfg = dict(max_batch=4, cache_len=64, max_new_tokens=6)
    jreqs = jrequests(jm.cfg, 5, seed=4)
    treqs = tserve.make_requests(tm.cfg, 5, seed=4)
    with _route(JAX_PALLAS_ROUTE):
        jres = jsrv.Server(jm, jm.prepare_params(jparams),
                           jsrv.ServeConfig(**scfg)).run(jreqs)
    with _route(None):
        tres = tsrv.Server(tm, tm.prepare_params(), tsrv.ServeConfig(**scfg),
                           device="cpu").run(treqs)
    assert sorted(tres) == sorted(jres) == list(range(5))
    for rid in range(5):
        assert tres[rid] == [int(t) for t in jres[rid]], rid


def test_engines_share_one_prepared_tree():
    """``Engine(..., params=tree)`` serves the given tree (on the card the
    MoE phase shares one prepared tree between engines, where a tree each
    would not fit): the tokens of an engine that prepares its own."""
    _, tc = _cfgs("moonshot-v1-16b-a3b", "square_pallas", policy=True)
    tm = LM(tc, device=CPU)
    reqs = tserve.make_requests(tc, 3, seed=5, lo=4, hi=12)
    own = teng.Engine(tm, teng.EngineConfig(prepared=True, **ENGINE_GEO),
                      device="cpu")
    tree = tm.prepare_params()
    shared = teng.Engine(tm, teng.EngineConfig(**ENGINE_GEO), device="cpu",
                         params=tree)
    assert shared.params is tree
    want = own.run([tsrv.Request(r.rid, r.tokens) for r in reqs])
    got = shared.run([tsrv.Request(r.rid, r.tokens) for r in reqs])
    assert {k: r.tokens for k, r in got.items()} == \
        {k: r.tokens for k, r in want.items()}


def test_stub_captured_engine_equals_eager(monkeypatch):
    """The engine's compiled path (three captured model calls) over the
    MoE dispatch, on ``tests/test_torch_compiled.py``'s CPU stub: the
    eager engine's tokens."""
    monkeypatch.setattr(graphs, "CapturedCall", _StubCall)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    _StubCall.schedule, _StubCall.calls, _StubCall.made = [], [], []
    _, tc = _cfgs("moonshot-v1-16b-a3b", "square_pallas", policy=True)
    tm = LM(tc, device=CPU)
    reqs = tserve.make_requests(tc, 3, seed=2, lo=4, hi=12)
    eager = teng.Engine(tm, teng.EngineConfig(prepared=True, **ENGINE_GEO),
                        device="cpu")
    want = eager.run([tsrv.Request(r.rid, r.tokens) for r in reqs])
    eng = teng.Engine(tm, teng.EngineConfig(prepared=True, **ENGINE_GEO),
                      device="cpu")
    eng._jit = True
    eng._jit_model_fns()
    got = eng.run([tsrv.Request(r.rid, r.tokens) for r in reqs])
    assert {k: r.tokens for k, r in got.items()} == \
        {k: r.tokens for k, r in want.items()}
    assert sorted(_StubCall.made) == ["_chunk", "_decode", "_logits_at"]


# ------------------------------------------------------------ the audit
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode,policy", [("square_pallas", True),
                                         ("standard", False)])
def test_forward_audit_matches_jax(arch, mode, policy):
    """The eager audit's ``moe_router`` / ``moe_expert`` mults (B*M*K*N a
    call) and every other site equal the JAX package's."""
    jm, jparams, tm = _models(arch, mode, policy)
    toks = np.random.default_rng(1).integers(0, tm.cfg.vocab, (2, 24)) \
        .astype(np.int32)
    with _route(_jax_route(mode)), jcount.track_contractions() as jc:
        jh, _, _ = jm.forward(jparams, {"tokens": jnp.asarray(toks)})
        jm.logits(jparams, jh)
    with _route(None), torch.no_grad(), tcount.track_contractions() as tc:
        th, _, _ = tm.forward(tm.tree(), {"tokens": torch.from_numpy(toks)})
        tm.logits(tm.tree(), th)
    assert tc.by_site() == jc.by_site()
    assert tc.fraction_square == jc.fraction_square
    cfg, T = tm.cfg, 2 * 24
    C = tmoe.moe_capacity(T, cfg)
    sites = tc.by_site()
    assert sites["moe_router"]["mults"] == \
        cfg.n_layers * T * cfg.d_model * cfg.n_experts
    assert sites["moe_expert"]["mults"] == \
        cfg.n_layers * 3 * cfg.n_experts * C * cfg.d_model * cfg.d_ff
    assert "ffn" not in sites


# --------------------------------------------------------- the launcher
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("legacy", [False, True])
def test_serve_launcher_serves_moe(arch, legacy, capsys):
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--matmul-mode",
            "square_pallas", "--prepared", "--requests", "3", "--max-new",
            "3"] + (["--legacy", "--max-batch", "2"] if legacy else [])
    routing.select_matmul_route.taken.clear()
    res = tserve.main(argv)
    toks = res if legacy else {r: v.tokens for r, v in res.items()}
    assert len(toks) == 3 and all(len(t) == 3 for t in toks.values())
    assert not legacy or "[legacy]" in capsys.readouterr().out
    assert routing.select_matmul_route.taken["batched"] > 0
