"""The port's route planner agrees with ``repro.kernels.routing`` on a grid
of shapes and honours ``REPRO_ROUTE`` the same way."""
import itertools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import routing as jrt  # noqa: E402
from repro_torch.kernels import routing as trt  # noqa: E402


@pytest.fixture(autouse=True)
def _no_autotune_cache(monkeypatch):
    # each planner consults its own tuning cache (route overrides) only
    # when autotune is on: compare the rules themselves
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    monkeypatch.delenv("REPRO_ROUTE", raising=False)


DIMS = (1, 8, 32, 64, 768, 3072)
BATCHES = (1, 2, 4, 96)


def test_matmul_routes_match_jax():
    for m, n, k, b in itertools.product(DIMS, DIMS, DIMS, BATCHES):
        want = jrt.select_matmul_route(m, n, k, batch=b, dtype=jnp.float32)
        got = trt.select_matmul_route(m, n, k, batch=b, dtype=torch.float32)
        assert got.name == want.name, (m, n, k, b, got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_paged_attn_routes_match_jax(dtype):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
           torch.int8: jnp.int8}[dtype]
    for s, t, b in itertools.product((1, 4, 8, 9, 32), (16, 63, 64, 128, 512),
                                     (1, 8)):
        want = jrt.select_paged_attn_route(s, t, batch=b, kv_heads=12,
                                           hd=64, dtype=jdt)
        got = trt.select_paged_attn_route(s, t, batch=b, kv_heads=12,
                                          hd=64, dtype=dtype)
        assert got.name == want.name, (s, t, b, got, want)


@pytest.mark.parametrize("env", ["kernel", "virtual", "gather", "fused",
                                 "matmul=fold", "matmul=batched,paged_attn="
                                 "gather", "paged_attn=kernel", "auto",
                                 "matmul=auto,paged_attn=kernel"])
def test_repro_route_env_matches_jax(monkeypatch, env):
    monkeypatch.setenv("REPRO_ROUTE", env)
    for m, n, k, b in ((8, 768, 768, 1), (1, 4, 4, 1), (4, 4, 4, 96)):
        assert trt.select_matmul_route(m, n, k, batch=b).name == \
            jrt.select_matmul_route(m, n, k, batch=b).name
    for s, t in ((1, 128), (32, 128), (1, 16)):
        assert trt.select_paged_attn_route(s, t).name == \
            jrt.select_paged_attn_route(s, t).name


@pytest.mark.parametrize("env", ["nonsense", "matmul=gather"])
def test_repro_route_env_rejects_unknown(monkeypatch, env):
    monkeypatch.setenv("REPRO_ROUTE", env)
    with pytest.raises(ValueError):
        jrt.select_matmul_route(8, 8, 8)
    with pytest.raises(ValueError):
        trt.select_matmul_route(8, 8, 8)


def test_route_decisions_are_counted():
    trt.select_matmul_route.taken.clear()
    trt.select_matmul_route(8, 768, 768)
    trt.select_matmul_route(1, 4, 4)
    assert trt.select_matmul_route.taken == {"kernel": 1, "virtual": 1}


def test_serving_route_table_of_fairsquare_demo():
    """The routes of full-width fairsquare-demo's attention contractions
    (12 heads of 64, G = 1) under ``--policy none``: paged prefill chunks
    and dense prefills of 13+ tokens take K2 (``batched``), dense prefills
    of 7-12 tokens and every dense decode step of 4 slots take K3
    (``fold``), and prompts of 6 tokens or fewer stay ``virtual``."""
    route = trt.select_matmul_route
    # paged Engine, one prefill chunk of 32 against a 128-slot table
    assert route(32, 128, 64, batch=12).name == "batched"       # scores
    assert route(32, 64, 128, batch=12).name == "batched"       # PV
    # dense Server prefill of S tokens: scores (S, 64) @ (64, S), PV
    # (S, S) @ (S, 64); the launcher's seed-0 prompts are 12-23 tokens
    for s in range(1, 40):
        want = "virtual" if s <= 6 else "fold" if s <= 12 else "batched"
        assert route(s, s, 64, batch=12).name == want, s
        assert route(s, 64, s, batch=12).name == want, s
        assert want == jrt.select_matmul_route(s, s, 64, batch=12,
                                               dtype=jnp.float32).name
    # dense Server decode step, 4 slots x 12 heads against cache_len 128
    assert route(1, 128, 64, batch=48).name == "fold"
    assert route(1, 64, 128, batch=48).name == "fold"
