"""The port's dense serving of the recurrent archs against the JAX package,
on ``recurrentgemma-2b`` and ``xlstm-350m`` ``.reduced()`` (f32): the
dense ``Server``'s greedy tokens against JAX's ``Server`` (more requests
than slots, prompts that fill the local-attention ring, two runs in one
process), ``write_slot`` over every state tensor, the decode step captured
on a CPU stand-in for ``CapturedCall`` (its warm-up call included), the
eager audit of a run against ``chip_smoke.py``'s analytic count and
routes, the paged cache's refusal and the launcher's fallback.  The JAX
side serves square_pallas on ``REPRO_ROUTE=matmul=virtual`` (its Pallas
kernels do not run under ``jit`` here), the port on its kernels' plain
versions.
"""
import collections
import functools
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch.serve import make_requests as jrequests  # noqa: E402
from repro.serve import server as jsrv  # noqa: E402
from repro_torch.core import counting as tcount  # noqa: E402
from repro_torch.core import graphs  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.kernels import routing  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.lm import LM, build_model  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import server as tsrv  # noqa: E402
from test_torch_moe import CPU, JAX_PALLAS_ROUTE, _route  # noqa: E402
from test_torch_recurrent import (ARCHS, _cfgs, _models,  # noqa: E402,F401
                                  _one_thread)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

# 2 slots for 5 requests; a 40-token cache, so recurrentgemma's local
# attention (window 32) keeps a 32-slot ring that prompts of up to 35
# tokens fill and decode wraps
SCFG = dict(max_batch=2, cache_len=40, max_new_tokens=5)
N_REQ, LO, HI = 5, 4, 36


def _reqs(cfg, make=tserve.make_requests):
    return make(cfg, N_REQ, seed=4, lo=LO, hi=HI)


def _server(tm, jit=False, **kw):
    return tsrv.Server(tm, tm.prepare_params(),
                       tsrv.ServeConfig(**dict(SCFG, jit=jit, **kw)),
                       device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_server_greedy_tokens_match_jax(arch):
    jm, jparams, tm = _models(arch, "square_pallas")
    with _route(JAX_PALLAS_ROUTE):
        jres = jsrv.Server(jm, jm.prepare_params(jparams),
                           jsrv.ServeConfig(**SCFG)).run(
                               _reqs(jm.cfg, jrequests))
    with _route(None):
        server = _server(tm)
        ptrs = [t.data_ptr() for t in tree_leaves(server.cache)]
        first = server.run(_reqs(tm.cfg))
        second = server.run(_reqs(tm.cfg))
    assert max(len(r.tokens) for r in _reqs(tm.cfg)) > 32   # fills the ring
    assert sorted(first) == sorted(jres) == list(range(N_REQ))
    for rid in range(N_REQ):
        assert first[rid] == [int(t) for t in jres[rid]], rid
    assert second == first
    assert [t.data_ptr() for t in tree_leaves(server.cache)] == ptrs


@pytest.mark.parametrize("arch", ARCHS)
def test_write_slot_covers_every_state_tensor(arch):
    """A prefill cache written into one slot: every tensor of every layer
    (K/V, positions, the recurrent states) in that row, the other rows
    untouched."""
    _, tc = _cfgs(arch)
    tm = LM(tc, device=CPU)
    toks = torch.from_numpy(np.arange(7, dtype=np.int32)[None] % tc.vocab)
    with torch.no_grad():
        _, one = tm.prefill(tm.tree(), {"tokens": toks}, 40)
    cache = tm.init_cache(3, 40)
    before = [t.clone() for t in tree_leaves(cache)]
    tsrv.write_slot(cache, 1, one)
    for layer, src in zip(cache, one):
        assert sorted(layer) == sorted(src)
    for got, was, src in zip(tree_leaves(cache), before, tree_leaves(one)):
        torch.testing.assert_close(got[1], src[0].to(got.dtype), rtol=0,
                                   atol=0)
        torch.testing.assert_close(got[0::2], was[0::2], rtol=0, atol=0)
    assert any(not torch.equal(a[1], b[1])
               for a, b in zip(tree_leaves(cache), before))


class _WarmupStub:
    """Stands in for ``graphs.CapturedCall`` on the CPU: construction runs
    the call once (the warm-up) and writes ``state`` back, as the real one
    does before its capture; each call after runs the function on the
    latest inputs (the replay)."""
    made = []

    def __init__(self, fn, args, *, device, pool=None, name="call",
                 state=()):
        self.fn, self.args, self.replays = fn, args, 0
        saved = [t.clone() for t in state]
        self._run(args)
        for t, t0 in zip(state, saved):
            t.copy_(t0)
        _WarmupStub.made.append(name)

    def _run(self, args):
        return self.fn(*(torch.as_tensor(np.asarray(a)) for a in args))

    def replay(self):
        self.replays += 1
        return self._run(self.args)

    def __call__(self, *args):
        self.args = args
        return self.replay()


@pytest.mark.parametrize("arch", ARCHS)
def test_stub_captured_decode_step_equals_eager(arch, monkeypatch):
    """The Server's compiled path on the stand-in: the eager tokens, twice,
    one capture, the eager run's final cache.  Without the state written
    back after the warm-up, the first decode step would advance the
    recurrent states twice: a run of one wave of requests (as many as the
    slots) then ends with another cache."""
    monkeypatch.setattr(graphs, "CapturedCall", _WarmupStub)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    _WarmupStub.made = []
    _, tc = _cfgs(arch, "square_pallas")
    tm = LM(tc, device=CPU)
    eager_server = _server(tm)
    eager = eager_server.run(_reqs(tc))

    def compiled(state=True):
        s = _server(tm)
        if not state:
            s._graph_set.state = ()
        s._decode = functools.partial(s._graph_set, "decode_step")
        return s

    server = compiled()
    assert server.run(_reqs(tc)) == eager
    assert server.run(_reqs(tc)) == eager
    assert _WarmupStub.made == ["decode_step"]
    assert server.graph.replays > 0
    for a, b in zip(tree_leaves(server.cache),
                    tree_leaves(eager_server.cache)):
        assert torch.equal(a, b)
    wave = _reqs(tc)[:SCFG["max_batch"]]
    for s in (eager_server, server, compiled(state=False)):
        s.run(wave)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(server.cache), tree_leaves(eager_server.cache)))
    assert any(not torch.equal(a, b) for a, b in zip(
        tree_leaves(s.cache), tree_leaves(eager_server.cache)))


@pytest.mark.parametrize("arch", ARCHS)
def test_server_audit_and_routes_match_the_analytic_count(arch):
    """The eager audit of a square_pallas Server run equals
    ``chip_smoke.recurrent_audit`` site by site (fraction 1.0), and the
    routes the run took equal the routing rules' at
    ``chip_smoke.recurrent_contractions``' shapes -- the counts the card's
    recurrent phase holds its runs to."""
    _, tc = _cfgs(arch, "square_pallas")
    tm = LM(tc, device=CPU)
    server = _server(tm)
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
    with chip_smoke._uncounted_routes():
        routes = collections.Counter(routing.select_matmul_route(
            m, n, k, batch=nb).name for _, _, nb, m, k, n in calls)
    assert taken == dict(routes)
    assert routes["virtual"] and (routes["kernel"] or routes["batched"])


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_serving_refuses_recurrent_archs(arch):
    """``tests/test_paged_cache.py::test_init_paged_cache_rejects_non_kv_
    archs``: no paged cache for a recurrent layer, in both packages; the
    paged engine refuses the model."""
    jm, _, tm = _models(arch)
    with pytest.raises(ValueError):
        jm.init_paged_cache(64)
    with pytest.raises(ValueError, match="no paged decode cache"):
        tm.init_paged_cache(64)
    with pytest.raises(ValueError, match="no paged decode cache"):
        teng.Engine(tm, teng.EngineConfig(), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_falls_back_to_the_dense_server(arch, capsys):
    """Without ``--legacy`` the launcher serves a recurrent arch through the
    dense Server with the JAX launcher's note: the tokens of that Server
    (cache_len 128, max_batch 4) on the seed-0 model."""
    res = tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--matmul-mode", "square_pallas", "--prepared",
                       "--requests", "3", "--max-new", "3"])
    out = capsys.readouterr().out
    assert (f"note: arch {arch!r} has non-KV decode state; falling back "
            f"to the dense reference Server") in out
    assert "[legacy] served 3 requests" in out
    _, tc = _cfgs(arch, "square_pallas")
    model = build_model(tc, device="cpu", seed=0)
    want = tsrv.Server(model, model.prepare_params(), tsrv.ServeConfig(
        max_batch=4, cache_len=128, max_new_tokens=3), device="cpu").run(
            tserve.make_requests(tc, 3, seed=0))
    assert res == want and all(len(t) == 3 for t in res.values())
