"""The port's dense serving of ``whisper-large-v3`` ``.reduced()`` (2
encoder + 2 decoder layers, 16 frames, f32) against the JAX package: the
launcher's request draws; the dense ``Server``'s greedy tokens against
JAX's ``Server``; the decode step captured on a CPU stand-in for
``CapturedCall`` across inserts that replace a slot's encoder K/V; the
eager audit of a Server run against ``chip_smoke.py``'s analytic count and
routes; the launcher's fallback.  The JAX side serves square_pallas on
``REPRO_ROUTE=matmul=virtual`` (its Pallas kernels do not run under
``jit`` here), the port on its kernels' plain versions.
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
from repro_torch.models.lm import build_model  # noqa: E402
from repro_torch.serve import server as tsrv  # noqa: E402
from test_torch_encdec import ARCH, _models  # noqa: E402
from test_torch_moe import JAX_PALLAS_ROUTE, _route  # noqa: E402
from test_torch_recurrent import _cfgs  # noqa: E402
from test_torch_recurrent import _one_thread  # noqa: E402,F401
from test_torch_recurrent_serving import _WarmupStub  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

# 2 slots for 5 requests: every slot is refilled, so each insert replaces
# the encoder K/V of a slot the captured step has read before
SCFG = dict(max_batch=2, cache_len=40, max_new_tokens=4)
N_REQ = 5


def _reqs(cfg, make=tserve.make_requests):
    return make(cfg, N_REQ, seed=4)


def _server(tm, jit=False):
    return tsrv.Server(tm, tm.prepare_params(),
                       tsrv.ServeConfig(**dict(SCFG, jit=jit)), device="cpu")


def test_launcher_draws_the_jax_launchers_requests():
    """``make_requests`` draws each prompt's length, then its frames, then
    its tokens, in the JAX launcher's order: the same requests."""
    _, tc = _cfgs(ARCH)
    for got, want in zip(_reqs(tc), _reqs(tc, jrequests)):
        assert got.rid == want.rid
        np.testing.assert_array_equal(got.tokens, want.tokens)
        assert sorted(got.extras) == sorted(want.extras) == ["frames"]
        np.testing.assert_array_equal(got.extras["frames"],
                                      want.extras["frames"])
        assert got.extras["frames"].shape == (tc.encoder_seq, tc.d_model)


def test_server_greedy_tokens_match_jax():
    """The dense Server's greedy tokens (square_pallas, prepared, 2 slots
    for 5 requests) equal the JAX Server's, twice from one server, the
    cache's tensors staying where they were."""
    jm, jparams, tm = _models("square_pallas")
    with _route(JAX_PALLAS_ROUTE):
        jres = jsrv.Server(jm, jm.prepare_params(jparams),
                           jsrv.ServeConfig(**SCFG)).run(
                               _reqs(jm.cfg, jrequests))
    with _route(None):
        server = _server(tm)
        ptrs = [t.data_ptr() for t in tree_leaves(server.cache)]
        first = server.run(_reqs(tm.cfg))
        second = server.run(_reqs(tm.cfg))
    assert sorted(first) == sorted(jres) == list(range(N_REQ))
    for rid in range(N_REQ):
        assert first[rid] == [int(t) for t in jres[rid]], rid
    assert second == first
    assert [t.data_ptr() for t in tree_leaves(server.cache)] == ptrs


def test_stub_captured_decode_step_reads_each_inserted_slot(monkeypatch):
    """The Server's compiled path on the stand-in (``_WarmupStub``, as in
    ``tests/test_torch_recurrent_serving.py``): the eager tokens and the
    eager run's final cache, from one capture, while every insert after
    the capture replaces a slot's encoder K/V in the cache the captured
    step reads."""
    monkeypatch.setattr(graphs, "CapturedCall", _WarmupStub)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    _WarmupStub.made = []
    _, tm = _models("square_pallas")[1:]
    eager_server = _server(tm)
    eager = eager_server.run(_reqs(tm.cfg))
    server = _server(tm)
    server._decode = functools.partial(server._graph_set, "decode_step")
    seen = []
    write = tsrv.write_slot

    def spy(cache, slot, one):
        seen.append(cache[0]["xk"][slot].clone())
        write(cache, slot, one)
    monkeypatch.setattr(tsrv, "write_slot", spy)
    assert server.run(_reqs(tm.cfg)) == eager
    assert _WarmupStub.made == ["decode_step"] and server.graph.replays > 0
    assert len(seen) == N_REQ and any(bool(t.abs().sum()) for t in seen)
    for a, b in zip(tree_leaves(server.cache),
                    tree_leaves(eager_server.cache)):
        assert torch.equal(a, b)


def test_server_audit_and_routes_match_the_analytic_count():
    """The eager audit of a square_pallas Server run equals
    ``chip_smoke.encdec_audit`` site by site (fraction 1.0), and the
    routes the run took equal the routing rules' at
    ``chip_smoke.recurrent_contractions``' shapes (the encoder and the
    cross-attention included) -- the counts the card's encoder-decoder
    phase holds its runs to."""
    _, tc = _cfgs(ARCH, "square_pallas")
    tm = build_model(tc, device="cpu")
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
    want = chip_smoke.encdec_audit(tc, lens, len(steps), B, T)
    assert {s: d["mults"] for s, d in audit.by_site().items()} == want
    assert audit.fraction_square == 1.0
    calls = [c for s in lens for c in chip_smoke.recurrent_contractions(
        tc, 1, s)]
    calls += chip_smoke.recurrent_contractions(tc, B, 1, T) * len(steps)
    with chip_smoke._uncounted_routes():
        routes = collections.Counter(routing.select_matmul_route(
            m, n, k, batch=nb).name for _, _, nb, m, k, n in calls)
    assert taken == dict(routes)


def test_launcher_falls_back_to_the_dense_server(capsys):
    """Without ``--legacy`` the launcher serves whisper through the dense
    Server with the JAX launcher's note: the tokens of that Server
    (cache_len 128, max_batch 4) on the seed-0 model and the launcher's
    requests, frames included."""
    res = tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--matmul-mode", "square_pallas", "--prepared",
                       "--requests", "3", "--max-new", "3"])
    out = capsys.readouterr().out
    assert (f"note: arch {ARCH!r} has non-KV decode state; falling back "
            f"to the dense reference Server") in out
    assert "[legacy] served 3 requests" in out
    _, tc = _cfgs(ARCH, "square_pallas")
    model = build_model(tc, device="cpu", seed=0)
    want = tsrv.Server(model, model.prepare_params(), tsrv.ServeConfig(
        max_batch=4, cache_len=128, max_new_tokens=3), device="cpu").run(
            tserve.make_requests(tc, 3, seed=0))
    assert res == want and all(len(t) == 3 for t in res.values())

