"""Parity of the port's batched square GEMMs (K2/K3's plain version, the
batched half of ``ops`` and ``fs_einsum`` in ``square_pallas`` on rank-3
operands) with the JAX package, on the CPU.

The reference is ``jax.vmap(repro.core.matmul.pm_matmul_exact)`` (the JAX
Pallas wrappers cannot run in this venv) and the plain product ``x @ y``.
Tolerances are ``tests/test_kernels.py::test_sq_matmul_sweep``'s: f32 at
rtol 5e-3, atol 5e-3 * k; int8 bit-exact.  Shapes are ragged in B, m, n
and k (nothing is a tile multiple).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import matmul as jmm  # noqa: E402
from repro_torch.core import squares as tsq  # noqa: E402
from repro_torch.core.einsum import fs_einsum  # noqa: E402
from repro_torch.kernels import ops, routing  # noqa: E402
from repro_torch.kernels.ref import sq_matmul_ref  # noqa: E402
from repro_torch.kernels.sq_matmul import (  # noqa: E402
    sq_matmul_batched_plain, sq_matmul_k2, sq_matmul_k3, sq_matmul_plain)

SHAPES = [(1, 1, 1, 1), (3, 7, 13, 9), (5, 1, 64, 33), (12, 12, 16, 12),
          (2, 33, 70, 17)]                     # (B, m, k, n)


def _operands(shape, dtype, seed=0):
    B, m, k, n = shape
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        a = rng.integers(-128, 128, (B, m, k)).astype(np.int8)
        b = rng.integers(-128, 128, (B, k, n)).astype(np.int8)
    else:
        a = rng.normal(size=(B, m, k)).astype(np.float32)
        b = rng.normal(size=(B, k, n)).astype(np.float32)
    return a, b


def _assert_close(out, ref, dtype, k):
    out, ref = np.asarray(out), np.asarray(ref)
    if dtype == "int8":
        assert out.dtype == np.int32
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=5e-3, atol=5e-3 * k)


def _jax_ref(a, b):
    return np.asarray(jax.vmap(jmm.pm_matmul_exact)(jnp.asarray(a),
                                                    jnp.asarray(b)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_batched_plain_matches_jax(shape, dtype):
    a, b = _operands(shape, dtype)
    acc = torch.int32 if dtype == "int8" else torch.float32
    aw, bw = torch.from_numpy(a).to(acc), torch.from_numpy(b).to(acc)
    out = sq_matmul_batched_plain(aw, bw, tsq.row_correction(aw),
                                  tsq.col_correction(bw, dim=-2))
    _assert_close(out.numpy(), _jax_ref(a, b), dtype, shape[2])
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), a @ b, rtol=5e-3,
                                   atol=5e-3 * shape[2])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("fold", [False, True])
def test_ops_batched_matches_jax(shape, dtype, fold):
    a, b = _operands(shape, dtype, seed=1)
    out = ops.sq_matmul(torch.from_numpy(a), torch.from_numpy(b), fold=fold,
                        device="cpu")
    assert out.shape == shape[:2] + shape[3:]
    _assert_close(out.numpy(), _jax_ref(a, b), dtype, shape[2])
    _assert_close(sq_matmul_ref(torch.from_numpy(a),
                                torch.from_numpy(b)).numpy(),
                  _jax_ref(a, b), dtype, shape[2])


def test_batched_plain_is_k1_plain_per_element():
    a, b = _operands((4, 9, 40, 21), "float32", seed=2)
    aw, bw = torch.from_numpy(a), torch.from_numpy(b)
    sa, sb = tsq.row_correction(aw), tsq.col_correction(bw, dim=-2)
    out = sq_matmul_batched_plain(aw, bw, sa, sb)
    for e in range(4):
        np.testing.assert_allclose(
            out[e].numpy(), sq_matmul_plain(aw[e], bw[e], sa[e], sb[e]).numpy(),
            rtol=1e-6, atol=1e-5)


def test_k2_k3_on_cpu_run_the_plain_version_and_count_nothing():
    a, b = _operands((6, 1, 64, 40), "int8", seed=3)
    aw, bw = torch.from_numpy(a).int(), torch.from_numpy(b).int()
    sa, sb = tsq.row_correction(aw), tsq.col_correction(bw, dim=-2)
    before = (sq_matmul_k2.launches, sq_matmul_k3.launches)
    want = sq_matmul_batched_plain(aw, bw, sa, sb)
    assert torch.equal(sq_matmul_k2(aw, bw, sa, sb), want)
    assert torch.equal(sq_matmul_k3(aw, bw, sa, sb), want)
    assert (sq_matmul_k2.launches, sq_matmul_k3.launches) == before
    with pytest.raises(ValueError, match="corrections"):
        sq_matmul_k2(aw, bw, sa[:, :0], sb)
    with pytest.raises(TypeError):
        sq_matmul_k3(aw.double(), bw.double(), sa.double(), sb.double())
    with pytest.raises(ValueError, match="batched contraction mismatch"):
        ops.sq_matmul(torch.ones(2, 3, 4), torch.ones(3, 4, 5), device="cpu")


@pytest.mark.parametrize("spec,xs,ys", [
    ("bqkgh,btkh->bkgqt", (2, 32, 3, 2, 16), (2, 40, 3, 16)),   # scores
    ("bkgqt,btkh->bqkgh", (2, 3, 2, 32, 40), (2, 40, 3, 16)),   # PV
    ("bqkgh,btkh->bkgqt", (4, 1, 12, 1, 64), (4, 128, 12, 64)),  # decode
    ("bmk,bkn->bnm", (7, 5, 300), (7, 300, 6)),
])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_fs_einsum_square_pallas_batched(monkeypatch, spec, xs, ys, dtype):
    monkeypatch.delenv("REPRO_ROUTE", raising=False)
    rng = np.random.default_rng(4)
    if dtype == "int8":
        x = rng.integers(-128, 128, xs).astype(np.int8)
        y = rng.integers(-128, 128, ys).astype(np.int8)
    else:
        x = rng.normal(size=xs).astype(np.float32)
        y = rng.normal(size=ys).astype(np.float32)
    routing.select_matmul_route.taken.clear()
    out = fs_einsum(spec, torch.from_numpy(x), torch.from_numpy(y),
                    mode="square_pallas")
    assert routing.select_matmul_route.taken["virtual"] == 0
    want = jnp.einsum(spec, jnp.asarray(x, jnp.int32 if dtype == "int8"
                                        else jnp.float32),
                      jnp.asarray(y, jnp.int32 if dtype == "int8"
                                  else jnp.float32))
    k = int(np.prod([d for c, d in zip(spec.split(",")[0], xs)
                     if c in spec.split(",")[1].split("->")[0]
                     and c not in spec.split("->")[1]]))
    _assert_close(out.numpy(), np.asarray(want), dtype, k)
