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
    # the JAX planner consults its tuning cache only when autotune is on;
    # the port has no cache, so compare the rules themselves
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
