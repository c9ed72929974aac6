"""The port's complex half against the JAX package's, on the CPU.

The same numpy inputs (from seeds) go through ``repro`` and
``repro_torch``: the complex helpers of ``core/squares.py``,
``core/complexmm.py``, ``core/transforms.py``, ``complex_correlate1d`` and
``iir_filter`` of ``core/conv.py``, and ``kernels.ops.cpm3_matmul`` /
``cpm4_matmul`` -- on the CPU the plain versions of K5 and K6 -- against
the JAX Pallas wrappers in interpret mode (``TPUCompilerParams``, renamed
``CompilerParams`` in JAX 0.9.0, aliased below), against
``kernels/ref.py::cpm3_matmul_ref`` and against ``x @ y``.

Tolerances are the JAX tests': ``tests/test_kernels.py`` (the Pallas
complex matmuls: rtol 1e-3, atol 1e-3 * k), ``tests/test_complex_and_
transforms.py`` (``core/complexmm``: rtol 1e-4, atol 1e-3 * k; transforms
rtol 1e-5 to 1e-4; the unit-modulus ``S_k == -N`` at rtol 1e-4) and
``tests/test_iir_cpm4.py`` (rtol 1e-3, atol 1e-3).  Integer planes are
exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from repro.core import complexmm as jcm  # noqa: E402
from repro.core import conv as jconv  # noqa: E402
from repro.core import squares as jsq  # noqa: E402
from repro.core import transforms as jtr  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import complexmm as tcm  # noqa: E402
from repro_torch.core import conv as tconv  # noqa: E402
from repro_torch.core import squares as tsq  # noqa: E402
from repro_torch.core import transforms as ttr  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.cpm3_matmul import (  # noqa: E402
    cpm3_matmul_k5, cpm3_matmul_plain)
from repro_torch.kernels.cpm4_matmul import (  # noqa: E402
    cpm4_matmul_k6, cpm4_matmul_plain)

CPU = "cpu"

# The JAX package's Pallas wrappers pass ``pltpu.TPUCompilerParams``, which
# JAX 0.9.0 renamed ``CompilerParams``.  The alias is made once, when this
# file is collected, and so holds for the whole test process: a jitted
# wrapper traced under a per-test alias would otherwise be served from the
# jit cache to later tests at the same shape and fail at every other.
if not hasattr(pltpu, "TPUCompilerParams"):
    pltpu.TPUCompilerParams = pltpu.CompilerParams


@pytest.fixture(autouse=True)
def _no_tuning_cache(monkeypatch):
    # the JAX tile planner warns on every cache miss unless autotune is off
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                      else t)


def _cplx(rng, *shape, scale=(1.0, 1.0)):
    return (scale[0] * rng.normal(size=shape)
            + 1j * scale[1] * rng.normal(size=shape)).astype(np.complex64)


def _close(got, want, k, rtol=1e-4):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=1e-3 * k)


# ---------------------------------------------------------------------------
# core/squares.py: the complex helpers
# ---------------------------------------------------------------------------

HELPERS = ["pm_neg", "cpm4_real", "cpm4_imag", "cpm3_shared", "cpm3_real",
           "cpm3_imag"]
ARITY = {"pm_neg": 2, "cpm3_shared": 3}


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("name", HELPERS)
def test_complex_helpers_match_jax(name, dtype):
    rng = np.random.default_rng(HELPERS.index(name))
    if dtype == "int8":
        ops_ = [rng.integers(-128, 128, size=(5, 6)).astype(np.int8)
                for _ in range(ARITY.get(name, 4))]
    else:
        ops_ = [rng.normal(size=(5, 6)).astype(np.float32) * (i + 1)
                for i in range(ARITY.get(name, 4))]
    got = getattr(tsq, name)(*(torch.as_tensor(o) for o in ops_))
    want = np.asarray(getattr(jsq, name)(*(jnp.asarray(o) for o in ops_)))
    if dtype == "int8":
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(_np(got), want)
    else:
        np.testing.assert_allclose(_np(got), want, rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------------------
# core/complexmm.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["standard", "cpm4", "cpm3"])
@pytest.mark.parametrize("shape", [(1, 1, 1), (4, 7, 5), (16, 32, 8),
                                   (3, 4, 7, 5)])
def test_complex_matmul_matches_jax(mode, shape):
    rng = np.random.default_rng(sum(shape))
    *lead, m, k, n = shape
    x, y = _cplx(rng, *lead, m, k), _cplx(rng, k, n)
    got = tcm.complex_matmul(x, y, mode=mode, device=CPU)
    want = np.asarray(jcm.complex_matmul(jnp.asarray(x), jnp.asarray(y),
                                         mode=mode))
    assert tuple(got.shape) == tuple(lead) + (m, n)
    _close(got, want, k)
    _close(got, x @ y, k)


@pytest.mark.parametrize("mode", ["cpm4", "cpm3"])
def test_complex_matmul_plane_pairs_and_real_inputs(mode):
    rng = np.random.default_rng(5)
    x, y = _cplx(rng, 4, 6), _cplx(rng, 6, 3)
    f = getattr(tcm, f"{mode}_matmul")
    _close(f((x.real, x.imag), (y.real, y.imag), device=CPU), x @ y, 6)
    re, im = f(torch.as_tensor(x.real), torch.as_tensor(y.real),
               torch.as_tensor(x.imag), torch.as_tensor(y.imag),
               planes_out=True)
    _close(re, (x @ y).real, 6)
    _close(im, (x @ y).imag, 6)
    xr = x.real.copy()                       # real operand: zero imag plane
    got = f(xr, y, device=CPU)
    want = getattr(jcm, f"{mode}_matmul")(jnp.asarray(xr), jnp.asarray(y))
    _close(got, np.asarray(want), 6)
    _close(got, xr @ y, 6)


@pytest.mark.parametrize("mode", ["cpm4", "cpm3"])
@pytest.mark.parametrize("batch", [(), (2,)])
def test_complex_matmul_int_planes_exact(mode, batch):
    rng = np.random.default_rng(11)
    a, b = (rng.integers(-128, 128, size=(*batch, 5, 9)).astype(np.int8)
            for _ in range(2))
    c, s = (rng.integers(-128, 128, size=(9, 4)).astype(np.int8)
            for _ in range(2))
    re, im = getattr(tcm, f"{mode}_matmul")((a, b), (c, s), planes_out=True,
                                            device=CPU)
    jre, jim = getattr(jcm, f"{mode}_matmul")(
        (jnp.asarray(a), jnp.asarray(b)), (jnp.asarray(c), jnp.asarray(s)),
        planes_out=True)
    assert re.dtype == im.dtype == torch.int32
    a64, b64, c64, s64 = (t.astype(np.int64) for t in (a, b, c, s))
    np.testing.assert_array_equal(_np(re), a64 @ c64 - b64 @ s64)
    np.testing.assert_array_equal(_np(im), a64 @ s64 + b64 @ c64)
    np.testing.assert_array_equal(_np(re), np.asarray(jre))
    np.testing.assert_array_equal(_np(im), np.asarray(jim))


def test_split_planes_accepts_pairs_and_rejects_malformed():
    rng = np.random.default_rng(3)
    x = _cplx(rng, 3, 4)
    re, im = tcm.split_planes((x.real, x.imag), device=CPU)
    np.testing.assert_array_equal(_np(re), x.real)
    np.testing.assert_array_equal(_np(im), x.imag)
    r = rng.normal(size=(2, 5)).astype(np.float32)
    re, im = tcm.split_planes(r, device=CPU)
    np.testing.assert_array_equal(_np(re), r)
    assert not _np(im).any()
    for bad, match in (((np.zeros((2, 2)),), "plane pair"),
                       ((np.zeros((2, 2)), np.zeros((2, 3))), "differ"),
                       ((x, x), "real arrays")):
        with pytest.raises(ValueError, match=match):
            tcm.split_planes(bad, device=CPU)
        with pytest.raises(ValueError):
            jcm.split_planes(tuple(jnp.asarray(t) for t in bad))


# ---------------------------------------------------------------------------
# kernels/ops.py complex half (K5, K6 plain versions) against the JAX
# Pallas wrappers in interpret mode
# ---------------------------------------------------------------------------

@pytest.fixture
def jax_pallas():
    from repro.kernels import ops as jops
    return jops


# every plane non-zero and at its own scale, so a swapped plane or sign in
# a correction cannot hide
SCALES = ((1.0, 0.5), (2.0, 0.25))


@pytest.mark.parametrize("kernel", ["cpm3_matmul", "cpm4_matmul"])
@pytest.mark.parametrize("shape", [(4, 6, 5), (40, 80, 24), (128, 128, 128),
                                   (37, 101, 53)])
def test_ops_complex_matmul_matches_jax_pallas(jax_pallas, kernel, shape):
    m, k, n = shape
    rng = np.random.default_rng(m + k + n)
    x, y = _cplx(rng, m, k, scale=SCALES[0]), _cplx(rng, k, n, scale=SCALES[1])
    re, im = getattr(ops, kernel)(x, y, device=CPU)
    assert re.dtype == im.dtype == torch.float32
    assert tuple(re.shape) == tuple(im.shape) == (m, n)
    jre, jim = getattr(jax_pallas, kernel)(jnp.asarray(x), jnp.asarray(y),
                                           interpret=True)
    z = x @ y
    for got, pallas, exact in ((re, jre, z.real), (im, jim, z.imag)):
        _close(got, np.asarray(pallas), k, rtol=1e-3)
        _close(got, exact, k, rtol=1e-3)
    rre, rim = tref.cpm3_matmul_ref(torch.as_tensor(x), torch.as_tensor(y))
    jrre, jrim = jref.cpm3_matmul_ref(jnp.asarray(x), jnp.asarray(y))
    for got, want in ((re, rre), (im, rim), (rre, np.asarray(jrre)),
                      (rim, np.asarray(jrim))):
        _close(got, want, k, rtol=1e-3)


@pytest.mark.parametrize("kernel", ["cpm3_matmul", "cpm4_matmul"])
def test_ops_complex_matmul_accepts_real_and_tensor_operands(kernel):
    rng = np.random.default_rng(21)
    x, y = _cplx(rng, 6, 9), rng.normal(size=(9, 4)).astype(np.float32)
    re, im = getattr(ops, kernel)(torch.as_tensor(x), y, device=CPU)
    _close(re, (x @ y).real, 9, rtol=1e-3)
    _close(im, (x @ y).imag, 9, rtol=1e-3)
    xt = torch.as_tensor(x.astype(np.complex128))   # comes down to complex64
    re, _ = getattr(ops, kernel)(xt, y)
    assert re.device.type == "cpu" and re.dtype == torch.float32
    with pytest.raises(ValueError, match="contraction mismatch"):
        getattr(ops, kernel)(x, y.T, device=CPU)


@pytest.mark.parametrize("kernel", ["cpm3_matmul", "cpm4_matmul"])
def test_ops_complex_matmul_refuses_int_planes(kernel):
    """Integer complex matmul is core.complexmm's exact path: the kernel
    takes f32 planes only, as the Pallas kernel (whose acc * 0.5 store
    fails on int32) does."""
    xi = np.ones((3, 4), np.int8)
    with pytest.raises(TypeError, match="f32"):
        getattr(ops, kernel)(xi, xi.T.copy(), device=CPU)
    planes = [torch.ones(3, 4, dtype=torch.int32)] * 2 \
        + [torch.ones(4, 2, dtype=torch.int32)] * 2
    with pytest.raises(TypeError, match="f32"):
        if kernel == "cpm3_matmul":
            cpm3_matmul_k5(*planes, *[torch.zeros(3, dtype=torch.int32)] * 2,
                           *[torch.zeros(2, dtype=torch.int32)] * 2)
        else:
            cpm4_matmul_k6(*planes, torch.zeros(3, dtype=torch.int32),
                           torch.zeros(2, dtype=torch.int32))


def _planes(rng, m, k, n):
    a, b = (torch.as_tensor(rng.normal(size=(m, k)).astype(np.float32)) * sc
            for sc in (1.0, 0.5))
    c, s = (torch.as_tensor(rng.normal(size=(k, n)).astype(np.float32)) * sc
            for sc in (2.0, 0.25))
    return a, b, c, s


def _plain(kernel, a, b, c, s, k_chunk=None):
    if kernel == "K5":
        corr = ((-(a + b) ** 2 + b ** 2).sum(1),
                (-(a + b) ** 2 - a ** 2).sum(1),
                (-c ** 2 + (c + s) ** 2).sum(0),
                (-c ** 2 - (s - c) ** 2).sum(0))
        return cpm3_matmul_plain(a, b, c, s, *corr, k_chunk=k_chunk), corr
    corr = -(a ** 2 + b ** 2).sum(1), -(c ** 2 + s ** 2).sum(0)
    return cpm4_matmul_plain(a, b, c, s, *corr, k_chunk=k_chunk), corr


@pytest.mark.parametrize("kernel", ["K5", "K6"])
def test_plain_zero_k_padding_adds_exactly_zero(kernel):
    """k past the edge loads zeros into all four planes (the kernels' mask):
    such terms add exactly 0 to both planes."""
    rng = np.random.default_rng(8)
    a, b, c, s = _planes(rng, 5, 8, 3)
    (re, im), corr = _plain(kernel, a, b, c, s, k_chunk=4)
    pad_r, pad_c = torch.zeros(5, 4), torch.zeros(4, 3)
    args = (torch.cat([a, pad_r], 1), torch.cat([b, pad_r], 1),
            torch.cat([c, pad_c]), torch.cat([s, pad_c]), *corr)
    f = cpm3_matmul_plain if kernel == "K5" else cpm4_matmul_plain
    pre, pim = f(*args, k_chunk=4)
    assert torch.equal(pre, re) and torch.equal(pim, im)


@pytest.mark.parametrize("kernel", ["K5", "K6"])
def test_plain_slabs_and_wrapper_counts(kernel):
    """The plain version's k slab only reorders the sum; a CPU call runs it
    and counts no launch."""
    rng = np.random.default_rng(9)
    a, b, c, s = _planes(rng, 6, 37, 5)
    (re, im), corr = _plain(kernel, a, b, c, s)
    (re3, im3), _ = _plain(kernel, a, b, c, s, k_chunk=3)
    tol = 2 * 37 * 2.0 ** -23 * (1 + 0.5 + 2 + 0.25) ** 2 * 16
    assert (re - re3).abs().max() <= tol and (im - im3).abs().max() <= tol
    wrapper = cpm3_matmul_k5 if kernel == "K5" else cpm4_matmul_k6
    before, shapes = wrapper.launches, dict(wrapper.shapes)
    got = wrapper(a, b, c, s, *corr)
    assert torch.equal(got[0], re) and torch.equal(got[1], im)
    assert wrapper.launches == before and dict(wrapper.shapes) == shapes
    z = (a + 1j * b).to(torch.complex64) @ (c + 1j * s).to(torch.complex64)
    _close(re, z.real, 37, rtol=1e-3)
    _close(im, z.imag, 37, rtol=1e-3)


def test_batched_dft_through_ops_matches_fft():
    """The slice's path at test scale: signals as rows of Z, each row's DFT
    is a row of Z @ W (W symmetric)."""
    rng = np.random.default_rng(0)
    z = _cplx(rng, 8, 32)
    w = ttr.dft_matrix(32, device=CPU)
    want = np.fft.fft(z, axis=-1)
    for kernel in ("cpm3_matmul", "cpm4_matmul"):
        re, im = getattr(ops, kernel)(z, w, device=CPU)
        _close(re, want.real, 32)
        _close(im, want.imag, 32)


# ---------------------------------------------------------------------------
# core/transforms.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 8, 16, 64])
def test_dft_matrix_equals_jax(n):
    got = _np(ttr.dft_matrix(n, device=CPU))
    assert got.dtype == np.complex64
    np.testing.assert_array_equal(got, np.asarray(jtr.dft_matrix(n)))


@pytest.mark.parametrize("mode", ["standard", "square"])
def test_real_transform_matches_jax(mode):
    rng = np.random.default_rng(4)
    w = rng.normal(size=(8, 8)).astype(np.float32)
    x = rng.normal(size=(8,)).astype(np.float32)
    got = ttr.real_transform(w, x, mode=mode, device=CPU)
    want = np.asarray(jtr.real_transform(jnp.asarray(w), jnp.asarray(x),
                                         mode=mode))
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(got), w @ x, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="unknown transform mode"):
        ttr.real_transform(w, x, mode="cpm3", device=CPU)


@pytest.mark.parametrize("coeff", ["real", "complex"])
def test_square_transform_matches_jax(coeff):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(16,)).astype(np.float32)
    w = (rng.normal(size=(16, 16)).astype(np.float32) if coeff == "real"
         else np.array(jtr.dft_matrix(16)))
    eng = ttr.SquareTransform(w, device=CPU)
    jeng = jtr.SquareTransform(jnp.asarray(w))
    got = _np(eng(x))
    np.testing.assert_allclose(got, np.asarray(jeng(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    want = w @ x if coeff == "real" else np.fft.fft(x)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    if coeff == "real":
        np.testing.assert_allclose(_np(eng.swk), np.asarray(jeng.swk),
                                   rtol=1e-6)
    else:
        np.testing.assert_allclose(_np(eng.swk_r), np.asarray(jeng.swk_r),
                                   rtol=1e-6)
        np.testing.assert_allclose(_np(eng.swk_i), np.asarray(jeng.swk_i),
                                   rtol=1e-6)


@pytest.mark.parametrize("mode", ["cpm4", "cpm3"])
def test_complex_transform_is_dft_and_matches_jax(mode):
    rng = np.random.default_rng(7)
    n = 16
    z = _cplx(rng, n)
    w = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    w = w.astype(np.complex64)                  # not unit modulus
    eng = ttr.ComplexSquareTransform(w, mode=mode, device=CPU)
    jeng = jtr.ComplexSquareTransform(jnp.asarray(w), mode=mode)
    names = ("sk",) if mode == "cpm4" else ("sxk", "syk")
    for name in names:                          # the same precomputed terms
        np.testing.assert_allclose(_np(getattr(eng, name)),
                                   np.asarray(getattr(jeng, name)),
                                   rtol=1e-6, atol=1e-5)
    _close(eng(z), np.asarray(jeng(jnp.asarray(z))), n)
    _close(eng(z), w @ z, n)
    dft = ttr.ComplexSquareTransform(ttr.dft_matrix(n, device=CPU), mode=mode)
    np.testing.assert_allclose(_np(dft(z)), np.fft.fft(z), rtol=1e-4,
                               atol=1e-3)
    with pytest.raises(ValueError, match="lies on"):
        dft(torch.as_tensor(z, device="meta"))


def test_unit_modulus_simplification():
    """Paper §6/§7: for unit-modulus coefficient rows, S_k == -N."""
    n = 32
    eng = ttr.ComplexSquareTransform(ttr.dft_matrix(n, device=CPU),
                                     mode="cpm4")
    np.testing.assert_allclose(_np(eng.sk), -n * np.ones(n), rtol=1e-4)
    with pytest.raises(ValueError, match="cpm4|cpm3"):
        ttr.ComplexSquareTransform(ttr.dft_matrix(n, device=CPU),
                                   mode="standard")


# ---------------------------------------------------------------------------
# core/conv.py complex half
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["standard", "cpm4", "cpm3"])
def test_complex_correlate1d_matches_jax(mode):
    rng = np.random.default_rng(12)
    x, w = _cplx(rng, 60), _cplx(rng, 7)
    got = tconv.complex_correlate1d(x, w, mode=mode, device=CPU)
    want = np.asarray(jconv.complex_correlate1d(jnp.asarray(x),
                                                jnp.asarray(w), mode=mode))
    np.testing.assert_allclose(_np(got), want, rtol=1e-4, atol=1e-3)
    ref = np.array([np.sum(w * x[i:i + 7]) for i in range(54)])
    np.testing.assert_allclose(_np(got), ref, rtol=1e-4, atol=1e-3)


def _iir_ref(x, b, a):
    nb, na = len(b), len(a)
    y = np.zeros(len(x))
    xp = np.pad(x, (nb - 1, 0))
    for t in range(len(x)):
        y[t] = np.dot(b[::-1], xp[t:t + nb])
        for j in range(na):
            if t - j - 1 >= 0:
                y[t] += a[j] * y[t - j - 1]
    return y


@pytest.mark.parametrize("mode", ["standard", "square"])
@pytest.mark.parametrize("nb,na", [(3, 1), (4, 2), (8, 3)])
def test_iir_filter_matches_jax_and_recurrence(nb, na, mode):
    rng = np.random.default_rng(13 + nb)
    x = rng.normal(size=(50,)).astype(np.float32)
    b = (rng.normal(size=(nb,)) * 0.5).astype(np.float32)
    a = (rng.normal(size=(na,)) * 0.3).astype(np.float32)
    got = _np(tconv.iir_filter(x, b, a, mode=mode, device=CPU))
    want = np.asarray(jconv.iir_filter(jnp.asarray(x), jnp.asarray(b),
                                       jnp.asarray(a), mode=mode))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got, _iir_ref(x, b, a), rtol=1e-3, atol=1e-3)
