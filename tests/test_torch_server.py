"""The port's dense reference ``Server`` against the JAX ``Server`` with the
same weights: greedy tokens must be identical for the serve launcher's 8
requests (seed 0, 16 new tokens each, 4 slots, ``cache_len`` 128), on
``fairsquare-demo.reduced()`` (f32).

In ``square_pallas`` with no contraction policy the port runs K1's and
K2/K3's plain versions on these CPU tensors, while the JAX Server, whose
Pallas wrappers cannot run in this venv, serves the same mode with
``REPRO_ROUTE=matmul=virtual``.  The JAX Server waits for every sampled
token before it moves a slot's position, so it has none of the JAX
engine's table race and its tokens can be compared directly.
"""
import contextlib
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.launch.serve import make_requests as jrequests  # noqa: E402
from repro.models.lm import build_model as jbuild  # noqa: E402
from repro.serve import server as jsrv  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import routing  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.serve import server as tsrv  # noqa: E402
from test_torch_moe import _one_thread  # noqa: E402,F401


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


def _models(mode):
    jc = dataclasses.replace(jget("fairsquare-demo").reduced(),
                             matmul_mode=mode)
    tc = dataclasses.replace(tget("fairsquare-demo").reduced(),
                             matmul_mode=mode)
    jm = jbuild(jc)
    params = jm.init(jax.random.PRNGKey(0))
    tm = LM(tc, device=torch.device("cpu"))
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


@pytest.mark.parametrize("mode,prepared", [("standard", False),
                                           ("square_pallas", True)])
def test_server_greedy_tokens_match_jax(mode, prepared):
    jm, jparams, tm = _models(mode)
    scfg = dict(max_batch=4, cache_len=128, max_new_tokens=16)
    jreqs = jrequests(jm.cfg, 8)
    treqs = tserve.make_requests(tm.cfg, 8)
    for a, b in zip(jreqs, treqs):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    if prepared:
        jparams = jm.prepare_params(jparams)
    with _route("matmul=virtual,paged_attn=gather"
                if mode == "square_pallas" else None):
        jres = jsrv.Server(jm, jparams, jsrv.ServeConfig(**scfg)).run(jreqs)
    routing.select_matmul_route.taken.clear()
    with _route(None):
        tparams = tm.prepare_params() if prepared else tm.tree()
        tres = tsrv.Server(tm, tparams, tsrv.ServeConfig(**scfg),
                           device="cpu").run(treqs)
    assert sorted(tres) == sorted(jres) == list(range(8))
    for rid in range(8):
        assert len(tres[rid]) == 16
        assert tres[rid] == [int(t) for t in jres[rid]], rid
    if mode == "square_pallas":
        taken = routing.select_matmul_route.taken
        # decode: 4 slots x 2 kv heads of 2 x 128 scores -> fold (K3)
        assert taken["kernel"] > 0 and taken["fold"] > 0


def test_server_eos_duplicates_and_seeded_sampling():
    tm = LM(tget("fairsquare-demo").reduced(), device=torch.device("cpu"))
    reqs = tserve.make_requests(tm.cfg, 5, seed=2)
    base = tsrv.Server(tm, tm.tree(), tsrv.ServeConfig(
        max_batch=2, cache_len=64, max_new_tokens=6), device="cpu").run(reqs)
    assert all(len(v) == 6 for v in base.values())
    # EOS = the first token of request 0: it ends at one token, the slot
    # is never taken, and the others run as before until they emit it
    eos = base[0][0]
    out = tsrv.Server(tm, tm.tree(), tsrv.ServeConfig(
        max_batch=2, cache_len=64, max_new_tokens=6, eos_id=eos),
        device="cpu").run(tserve.make_requests(tm.cfg, 5, seed=2))
    assert out[0] == [eos]
    for rid, toks in base.items():
        cut = toks.index(eos) + 1 if eos in toks else len(toks)
        assert out[rid] == toks[:cut]
    with pytest.raises(ValueError, match="duplicate"):
        tsrv.Server(tm, tm.tree(), tsrv.ServeConfig(), device="cpu").run(
            [tsrv.Request(1, np.arange(3, dtype=np.int32)),
             tsrv.Request(1, np.arange(4, dtype=np.int32))])
    hot = tsrv.ServeConfig(max_batch=2, cache_len=64, max_new_tokens=5,
                           temperature=1.0)
    runs = [tsrv.Server(tm, tm.tree(), hot, seed=7, device="cpu").run(
        tserve.make_requests(tm.cfg, 3, seed=1)) for _ in range(2)]
    assert runs[0] == runs[1]


def test_write_slot_replaces_the_whole_slot():
    tm = LM(tget("fairsquare-demo").reduced(), device=torch.device("cpu"))
    cache = tm.init_cache(3, 16)
    for layer in cache:
        layer["pos"].fill_(5)
        layer["k"].fill_(1.0)
    with torch.no_grad():
        _, one = tm.prefill(tm.tree(), {"tokens": torch.zeros(
            1, 4, dtype=torch.int32)}, 16)
    tsrv.write_slot(cache, 1, one)
    for dst, src in zip(cache, one):
        assert torch.equal(dst["pos"][1], src["pos"][0])
        assert torch.equal(dst["k"][1], src["k"][0])
        assert (dst["pos"][0] == 5).all() and (dst["pos"][2] == 5).all()


@pytest.mark.parametrize("legacy", [False, True])
def test_serve_launcher_policy_none_on_cpu(capsys, legacy):
    """Both entry points with every contraction square (the default
    ``--policy none``), on an explicit CPU device."""
    argv = ["--reduced", "--device", "cpu", "--matmul-mode",
            "square_pallas", "--prepared", "--requests", "3", "--max-new",
            "3"] + (["--legacy", "--max-batch", "2"] if legacy else [])
    routing.select_matmul_route.taken.clear()
    res = tserve.main(argv)
    assert len(res) == 3
    toks = res if legacy else {r: v.tokens for r, v in res.items()}
    assert all(len(t) == 3 for t in toks.values())
    assert ("[legacy]" in capsys.readouterr().out) == legacy
    assert routing.select_matmul_route.taken["kernel"] > 0


def test_serve_launcher_refuses_to_page_an_unpageable_arch(capsys):
    """An arch with non-KV decode state is not paged: the launcher falls
    back to the dense Server with the JAX launcher's note (whisper's
    encoder-decoder too), and paligemma's prefix tokens, which build
    since they were ported, fall back alike."""
    res = tserve.main(["--arch", "xlstm-350m", "--reduced", "--device",
                       "cpu", "--requests", "2", "--max-new", "2"])
    assert "falling back to the dense reference Server" in \
        capsys.readouterr().out
    assert sorted(res) == [0, 1] and all(
        isinstance(t, list) and len(t) == 2 for t in res.values())
    res = tserve.main(["--arch", "whisper-large-v3", "--reduced",
                       "--device", "cpu", "--requests", "2", "--max-new",
                       "2"])
    assert "falling back to the dense reference Server" in \
        capsys.readouterr().out
    assert sorted(res) == [0, 1] and all(len(t) == 2 for t in res.values())
    res = tserve.main(["--arch", "paligemma-3b", "--reduced", "--device",
                       "cpu", "--requests", "2", "--max-new", "2"])
    assert "falling back to the dense reference Server" in \
        capsys.readouterr().out
    assert sorted(res) == [0, 1] and all(len(t) == 2 for t in res.values())
