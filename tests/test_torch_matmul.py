"""Parity of the port's square algebra, matmul modes, prepared operands and
K1 wrapper (plain version on the CPU) with the JAX package.

Tolerances are those ``tests/test_kernels.py`` holds the Pallas kernels
to: f32 at rtol 5e-3, atol 5e-3*k; bf16 at rtol 5e-2, atol 0.5; int8
exact.  The JAX Pallas wrappers cannot run in this venv, so the references
are ``repro.core.matmul`` (non-Pallas modes) and ``repro.kernels.ref``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import matmul as jmm  # noqa: E402
from repro.core import squares as jsq  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import matmul as tmm  # noqa: E402
from repro_torch.core import squares as tsq  # noqa: E402
from repro_torch.core.prepared import prepare_operand  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.sq_matmul import sq_matmul_k1, sq_matmul_plain  # noqa: E402

MM_SHAPES = [(1, 1, 1), (7, 13, 9), (64, 128, 32), (33, 200, 129)]
JAX_MODES = ("standard", "square_virtual", "square_exact", "square_scan")


def _operands(shape, dtype, seed=0):
    m, k, n = shape
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        a = rng.integers(-128, 128, (m, k)).astype(np.int8)
        b = rng.integers(-128, 128, (k, n)).astype(np.int8)
        return a, b, torch.from_numpy(a), torch.from_numpy(b)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    if dtype == "bfloat16":
        ta = torch.from_numpy(a).to(torch.bfloat16)
        tb = torch.from_numpy(b).to(torch.bfloat16)
        return (jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
                ta, tb)
    return a, b, torch.from_numpy(a), torch.from_numpy(b)


def _assert_close(out, ref, dtype, k):
    out = np.asarray(out)
    ref = np.asarray(ref)
    if dtype == "int8":
        assert out.dtype == np.int32
        np.testing.assert_array_equal(out, ref)
    elif dtype == "bfloat16":
        np.testing.assert_allclose(out, ref, rtol=5e-2, atol=0.5)
    else:
        np.testing.assert_allclose(out, ref, rtol=5e-3, atol=5e-3 * k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_squares_algebra_matches_jax(dtype):
    ja, jb, ta, tb = _operands((7, 13, 9), dtype)
    assert str(tsq.accum_dtype(ta.dtype)).split(".")[-1] == \
        jsq.accum_dtype(jnp.asarray(ja).dtype).name
    for t_fn, j_fn, dim in ((tsq.row_correction, jsq.row_correction, -1),
                            (tsq.col_correction, jsq.col_correction, 0)):
        x, jx = (ta, ja) if dim == -1 else (tb, jb)
        _assert_close(t_fn(x, dim).float().numpy()
                      if dtype != "int8" else t_fn(x, dim).numpy(),
                      np.asarray(j_fn(jnp.asarray(jx), dim)), dtype, 13)
    acc = torch.tensor([-7, 6, 9], dtype=torch.int32)
    np.testing.assert_array_equal(
        tsq.halve(acc).numpy(), np.asarray(jsq.halve(jnp.asarray(acc.numpy()))))


@pytest.mark.parametrize("shape", MM_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("mode", JAX_MODES + ("square_pallas",))
def test_matmul_modes_match_jax(mode, dtype, shape):
    ja, jb, ta, tb = _operands(shape, dtype)
    out = tmm.matmul(ta, tb, mode=mode)
    if mode == "square_pallas":
        # the JAX kernel mode's oracle: the exact square-form matmul
        ref = jref.sq_matmul_ref(jnp.asarray(ja), jnp.asarray(jb))
    else:
        ref = jmm.matmul(jnp.asarray(ja), jnp.asarray(jb), mode=mode)
    if dtype == "bfloat16" and mode == "standard":
        out = out.float()
    _assert_close(out.numpy(), np.asarray(ref, np.float32 if dtype != "int8"
                                          else np.int32), dtype, shape[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("mode", ["square_pallas", "square_virtual",
                                  "standard"])
def test_prepared_bit_identical_to_raw(mode, dtype):
    _, _, ta, tb = _operands((33, 200, 129), dtype, seed=1)
    prep = prepare_operand(tb)
    assert torch.equal(tmm.matmul(ta, prep, mode=mode),
                       tmm.matmul(ta, tb, mode=mode))
    prep_t = prepare_operand(tb.T.contiguous(), transpose=True)
    assert torch.equal(tmm.matmul(ta, prep_t, mode=mode),
                       tmm.matmul(ta, tb, mode=mode))


def test_sq_matmul_entry_point_cpu():
    _, _, ta, tb = _operands((5, 9, 4), "int8")
    out = ops.sq_matmul(ta, tb, device="cpu")
    np.testing.assert_array_equal(
        out.numpy(), ta.numpy().astype(np.int32) @ tb.numpy().astype(np.int32))
    a3 = torch.randn(3, 4, 32)
    b = torch.randn(32, 8)
    out3 = ops.sq_matmul(a3, b, device="cpu")
    assert out3.shape == (3, 4, 8)
    np.testing.assert_allclose(out3.numpy(), (a3 @ b).numpy(), rtol=2e-3,
                               atol=1e-2)
    b3 = torch.randn(3, 32, 8)                    # batched: K2/K3
    for fold in (False, True):
        out_b = ops.sq_matmul(a3, b3, fold=fold, device="cpu")
        assert out_b.shape == (3, 4, 8)
        np.testing.assert_allclose(out_b.numpy(), (a3 @ b3).numpy(),
                                   rtol=2e-3, atol=1e-2)
    with pytest.raises(ValueError, match="batched contraction mismatch"):
        ops.sq_matmul(a3, torch.randn(2, 32, 8), device="cpu")


def test_k1_plain_on_cpu_counts_no_launch():
    before = sq_matmul_k1.launches
    aw = torch.randn(8, 40)
    bw = torch.randn(40, 70)
    sa, sb = tsq.row_correction(aw), tsq.col_correction(bw)
    out = sq_matmul_k1(aw, bw, sa, sb)
    assert sq_matmul_k1.launches == before
    assert torch.equal(out, sq_matmul_plain(aw, bw, sa, sb))
    np.testing.assert_allclose(out.numpy(), (aw @ bw).numpy(), rtol=5e-3,
                               atol=5e-3 * 40)
    with pytest.raises(TypeError):
        sq_matmul_k1(aw.double(), bw.double(), sa.double(), sb.double())


INT_EINSUM_SPECS = {"mk,kn->mn": ((9, 300), (300, 70)),
                    "bmk,bkn->bmn": ((3, 9, 300), (3, 300, 70))}


@pytest.mark.parametrize("spec", sorted(INT_EINSUM_SPECS))
@pytest.mark.parametrize("dtype", ["int8", "int16"])
@pytest.mark.parametrize("preferred", [None, "int32"])
def test_standard_einsum_int_matches_jax(spec, dtype, preferred):
    """``fs_einsum(mode="standard")`` on integer operands returns what
    ``jnp.einsum`` returns: the operands' dtype (wrapping) or ``preferred``,
    bit for bit."""
    from repro.core.einsum import fs_einsum as jeinsum
    from repro_torch.core.einsum import fs_einsum as teinsum
    info = np.iinfo(dtype)
    rng = np.random.default_rng(11)
    xs, ys = INT_EINSUM_SPECS[spec]
    x = rng.integers(info.min, info.max, xs, endpoint=True).astype(dtype)
    y = rng.integers(info.min, info.max, ys, endpoint=True).astype(dtype)
    want = np.asarray(jeinsum(spec, jnp.asarray(x), jnp.asarray(y),
                              mode="standard",
                              preferred=preferred and jnp.dtype(preferred)))
    got = teinsum(spec, torch.from_numpy(x), torch.from_numpy(y),
                  mode="standard",
                  preferred=preferred and getattr(torch, preferred))
    assert str(got.dtype) == f"torch.{want.dtype}"
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,n,grid", [
    (8, 768, (96, 1)), (8, 3072, (384, 1)), (4, 32000, (4000, 1)),
    (1, 1, (8, 1)), (9, 769, (56, 1)), (32, 768, (48, 1)),
    (33, 33, (8, 2))])
def test_k1_launch_shape(m, n, grid):
    """K1's grid: a cluster of 8 blocks (one partial each) per 8 x 64 tile
    at m <= 8, per 32 x 128 tile above."""
    from repro_torch.kernels.sq_matmul import k1_launch_shape
    shape = k1_launch_shape(m, n)
    assert shape["grid"] == grid and shape["cluster"] == (8, 1, 1)
    assert (shape["rows"], shape["cols"], shape["warps"]) == (
        (8, 64, 4) if m <= 8 else (32, 128, 16))


@pytest.mark.parametrize("nb,m,n,grid", [
    (12, 32, 128, (12, 2, 8)), (12, 32, 64, (12, 1, 8)),      # paged prefill
    (12, 13, 13, (12, 1, 4)), (12, 23, 64, (12, 2, 6)),       # dense prefill
    (12, 128, 128, (12, 2, 16)), (1, 1, 1, (1, 1, 1)),
    (3, 40, 3, (3, 1, 5)), (1, 9, 65, (1, 3, 3))])
def test_k2_launch_shape(nb, m, n, grid):
    """K2's grid (elements, column tiles, row tiles): one 8-warp block per
    tile of 1 row at m = 1, 4 rows up to m = 32, else 8, and 64 columns
    where n > 32 and the grid keeps 96 blocks, else 32."""
    from repro_torch.kernels.sq_matmul import k2_launch_shape
    shape = k2_launch_shape(nb, m, n)
    assert shape["grid"] == grid and shape["warps"] == 8
    assert shape["rows"] == (1 if m == 1 else 4 if m <= 32 else 8)
    assert shape["cols"] * grid[1] >= n > shape["cols"] * (grid[1] - 1)


@pytest.mark.parametrize("nb,m,n,grid", [
    (48, 1, 128, (48, 2, 1)), (48, 1, 64, (48, 2, 1)),        # dense decode
    (12, 12, 12, (12, 1, 3)), (12, 12, 64, (12, 2, 3)),       # dense prefill
    (96, 1, 33, (96, 1, 1)), (5, 7, 33, (5, 2, 2)),
    (4096, 1, 16, (4096, 1, 1)), (2, 1, 1, (2, 1, 1))])
def test_k3_launch_shape(nb, m, n, grid):
    """K3's grid follows K2's rule: at the dense-decode shapes 96 blocks of
    64 columns for n = 128 and 96 blocks of 32 columns for n = 64."""
    from repro_torch.kernels.sq_matmul import k2_launch_shape, k3_launch_shape
    shape = k3_launch_shape(nb, m, n)
    assert shape["grid"] == grid and shape == k2_launch_shape(nb, m, n)
    assert shape["grid"][0] * shape["grid"][1] * shape["grid"][2] == \
        nb * -(-n // shape["cols"]) * -(-m // shape["rows"])


def test_sq_matmul_launch_constants_match_source():
    """The Python launch-shape mirrors and the planner's variants read what
    the CUDA source launches with: K1's two cluster instances (tile codes 0
    and 1), and K2's and K3's shared 8-warp tile (its instantiated rows and
    column widths).  The source applies no rule of its own: each launch's
    variant is the caller's plan (kernels/tuning.py)."""
    import re
    from pathlib import Path

    import repro_torch
    from repro_torch.kernels import sq_matmul as mod
    from repro_torch.kernels import tuning
    src = (Path(repro_torch.__file__).parent / "csrc" /
           "sq_matmul.cu").read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert consts["KS"] == mod._KS == 8 and consts["BN"] == 32
    assert "TILE_MIN_BLOCKS" not in consts and "TILE_TALL_M" not in consts
    assert "constexpr int THREADS = BN * KS;" in src
    # K1: launch_cluster<T, BM, RW, CT, STAGES> for tile 0, then tile 1
    k1 = re.findall(r"if \(tile == (\d)\) return launch_cluster<T, (\d+), "
                    r"(\d+), (\d+), (\d+)>", src)
    assert [int(t[0]) for t in k1] == [0, 1]
    plans = tuning.candidates_matmul("sq_matmul", 9, 1, 1)
    assert [p.code for p in plans] == [0, 1]
    for (_, bm, rw, ct, _), plan, m in zip(k1, plans, (8, 9)):
        shape = mod.k1_launch_shape(m, 1)
        assert (shape["rows"], shape["cols"], shape["warps"]) == (
            int(bm), 32 * int(ct), int(rw) * int(ct))
        assert (plan.rows, plan.cols) == (int(bm), 32 * int(ct))
    # K2/K3: the instantiated rows and column widths are the candidates'
    rows = sorted(int(r) for r in re.findall(
        r"case (\d+): return launch_rows<T, (?:\d+), FOLDED>", src))
    assert rows == sorted(int(r) for r in re.findall(
        r"launch_rows<T, (\d+), FOLDED>", src)) == [1, 4, 8]
    vecs = sorted(int(v) for v in re.findall(
        r"launch_tile<T, R, (\d+), FOLDED>", src))
    assert vecs == [1, 2]
    cands = tuning.candidates_matmul("sq_matmul_batched", 33, 65, 1, 4)
    assert sorted({p.rows for p in cands}) == rows
    assert sorted({p.cols for p in cands}) == [32 * v for v in vecs]
    assert [mod.k2_launch_shape(1, m, 1)["rows"]
            for m in (1, 2, mod._TILE_TALL_M + 1)] == [1, 4, 8]
    widths = {mod.k3_launch_shape(nb, 1, n)["cols"]
              for nb in (1, 95, 96) for n in (32, 33, 64)}
    assert widths == {32 * v for v in vecs}
