"""The port's square convolutions against the JAX package's, on the CPU.

The same numpy inputs (from seeds) go through ``repro`` and
``repro_torch``.  The JAX Pallas conv kernels cannot run under JAX 0.9.0,
which lacks ``pl.load`` (ROADMAP Q3), so the port is held against the JAX
package's non-Pallas references: ``core/conv.py`` ``conv2d`` in
``standard`` and ``square_virtual``, ``correlate1d``/``convolve1d``/
``correlate2d``/``sliding_sum_squares``, ``kernels/ref.py::sq_conv_ref``
and ``routing.select_conv2d_route``; and, with ``TPUCompilerParams``
(renamed ``CompilerParams`` in JAX 0.9.0) aliased for one test, the JAX
im2col route.

Tolerances are the JAX tests': ``tests/test_conv2d.py`` (f32 rtol 2e-3,
atol 2e-3 * K volume; bf16 inputs rtol 5e-2, atol 1.0; int8 exact) and
``tests/test_kernels.py::test_sq_conv_sweep`` (rtol 1e-4, atol 1e-3).  On
the CPU every kernel wrapper runs its plain version: the K7 and K8 cases
here hold those plain versions and everything around them.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import conv as jconv  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import routing as jrt  # noqa: E402
from repro_torch.core import conv as tconv  # noqa: E402
from repro_torch.core.prepared import prepare_operand  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import routing as trt  # noqa: E402
from test_torch_moe import _one_thread  # noqa: E402,F401

CPU = "cpu"


@pytest.fixture(autouse=True)
def _no_route_pins(monkeypatch):
    # the JAX planner consults its tuning cache only when autotune is on;
    # the port has no cache, so compare the rules themselves
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    monkeypatch.delenv("REPRO_ROUTE", raising=False)


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                      else t)


def _f32(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _port_modes(x, w, **kw):
    return {m: _np(tconv.conv2d(x, w, mode=m, device=CPU, **kw))
            for m in tconv.CONV2D_MODES}


def _check_f32(x, w, kvol, **kw):
    """Every port mode against the JAX standard conv, and the port's
    standard and square_virtual against the JAX ones."""
    jstd = np.asarray(jconv.conv2d(jnp.asarray(x), jnp.asarray(w),
                                   mode="standard", **kw))
    jvirt = np.asarray(jconv.conv2d(jnp.asarray(x), jnp.asarray(w),
                                    mode="square_virtual", **kw))
    got = _port_modes(x, w, **kw)
    for mode, out in got.items():
        assert out.shape == jstd.shape, mode
        np.testing.assert_allclose(out, jstd, rtol=2e-3, atol=2e-3 * kvol,
                                   err_msg=mode)
    np.testing.assert_allclose(got["square_virtual"], jvirt, rtol=2e-3,
                               atol=2e-3 * kvol)
    return got


# ---------------------------------------------------------------------------
# conv2d: modes x strides x paddings x shapes (the JAX edge-case grid)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw,khw", [((17, 13), (3, 3)), ((9, 23), (5, 3)),
                                    ((8, 8), (8, 8)), ((6, 31), (1, 7))])
def test_conv2d_odd_spatial_sizes(hw, khw):
    rng = np.random.default_rng(23)
    x, w = _f32(rng, (1, 3) + hw), _f32(rng, (5, 3) + khw)
    _check_f32(x, w, 3 * khw[0] * khw[1])


@pytest.mark.parametrize("stride", [2, (2, 1), (1, 3), 3])
@pytest.mark.parametrize("padding", ["VALID", "SAME"])
def test_conv2d_strides_and_padding(stride, padding):
    rng = np.random.default_rng(24)
    x, w = _f32(rng, (2, 4, 15, 18)), _f32(rng, (6, 4, 3, 3))
    _check_f32(x, w, 36, stride=stride, padding=padding)


@pytest.mark.parametrize("padding", [1, 2, ((2, 0), (0, 3)),
                                     ((0, 1), (3, 2))])
def test_conv2d_explicit_padding(padding):
    rng = np.random.default_rng(25)
    x, w = _f32(rng, (1, 2, 10, 11)), _f32(rng, (3, 2, 3, 5))
    _check_f32(x, w, 30, padding=padding, stride=(1, 2))


@pytest.mark.parametrize("cin,cout", [(5, 3), (1, 7), (13, 1), (65, 9),
                                      (3, 5), (7, 7)])
def test_conv2d_ragged_channels(cin, cout):
    rng = np.random.default_rng(26)
    x, w = _f32(rng, (2, cin, 12, 11)), _f32(rng, (cout, cin, 3, 3))
    _check_f32(x, w, 9 * cin, stride=2, padding="SAME")


@pytest.mark.parametrize("xs,ws,shape", [
    ((16, 16), (3, 3), (14, 14)),               # (H, W) x (kh, kw)
    ((16, 16), (4, 3, 3), (4, 14, 14)),         # (H, W) x (cout, kh, kw)
    ((3, 9, 9), (2, 3, 3, 3), (2, 7, 7)),       # (cin, H, W) x OIHW
    ((4, 1, 8, 8), (3, 3), (4, 1, 6, 6)),       # batch kept under shorthand
])
def test_conv2d_rank_shorthands(xs, ws, shape):
    rng = np.random.default_rng(27)
    x, w = _f32(rng, xs), _f32(rng, ws)
    got = _check_f32(x, w, int(np.prod(ws[-2:])) * (xs[-3] if len(xs) > 2
                                                     else 1))
    assert all(out.shape == shape for out in got.values())


def test_conv2d_channel_mismatch_and_oversized_kernel_raise():
    with pytest.raises(ValueError, match="channel mismatch"):
        tconv.conv2d(np.zeros((2, 8, 8), np.float32),
                     np.zeros((4, 3, 3, 3), np.float32), device=CPU)
    with pytest.raises(ValueError, match="larger than padded input"):
        tconv.conv2d(np.zeros((4, 4), np.float32),
                     np.zeros((5, 5), np.float32), mode="square_pallas",
                     device=CPU)
    with pytest.raises(ValueError, match="unknown conv2d mode"):
        tconv.conv2d(np.zeros((4, 4), np.float32),
                     np.zeros((3, 3), np.float32), mode="square_scan",
                     device=CPU)


def test_conv2d_bf16_widening():
    """bf16 operands accumulate in f32 in the square modes."""
    rng = np.random.default_rng(28)
    xj = jnp.asarray(rng.normal(size=(1, 8, 14, 14)), jnp.bfloat16)
    wj = jnp.asarray(rng.normal(size=(4, 8, 3, 3)), jnp.bfloat16)
    x = torch.as_tensor(np.array(xj.astype(jnp.float32))).bfloat16()
    w = torch.as_tensor(np.array(wj.astype(jnp.float32))).bfloat16()
    ref = np.asarray(jconv.conv2d(xj.astype(jnp.float32),
                                  wj.astype(jnp.float32)))
    jvirt = np.asarray(jconv.conv2d(xj, wj, mode="square_virtual"))
    for mode in ("square_virtual", "square_exact", "square_pallas"):
        out = tconv.conv2d(x, w, mode=mode)
        assert out.dtype == torch.float32, mode
        np.testing.assert_allclose(_np(out), ref, rtol=5e-2, atol=1.0,
                                   err_msg=mode)
    np.testing.assert_allclose(_np(tconv.conv2d(x, w, mode="square_virtual")),
                               jvirt, rtol=5e-2, atol=1.0)
    std = tconv.conv2d(x, w)
    assert std.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(std.float()), ref, rtol=5e-2, atol=1.0)


@pytest.mark.parametrize("stride,padding", [(1, "VALID"), (2, "SAME"),
                                            ((1, 2), ((2, 0), (1, 3)))])
def test_conv2d_int8_exact(stride, padding):
    """int8 square modes accumulate in int32 and agree bit for bit with the
    JAX square_virtual conv; standard mode keeps the JAX int8 result."""
    rng = np.random.default_rng(29)
    x = rng.integers(-30, 30, (2, 3, 11, 9)).astype(np.int8)
    w = rng.integers(-30, 30, (4, 3, 3, 3)).astype(np.int8)
    kw = dict(stride=stride, padding=padding)
    jvirt = np.asarray(jconv.conv2d(jnp.asarray(x), jnp.asarray(w),
                                    mode="square_virtual", **kw))
    jstd = np.asarray(jconv.conv2d(jnp.asarray(x), jnp.asarray(w), **kw))
    got = _port_modes(x, w, **kw)
    for mode in ("square_virtual", "square_exact", "square_pallas"):
        assert got[mode].dtype == np.int32, mode
        np.testing.assert_array_equal(got[mode], jvirt, err_msg=mode)
    assert got["standard"].dtype == jstd.dtype
    np.testing.assert_array_equal(got["standard"], jstd)
    fused = _np(ops.sq_conv2d(x, w, device=CPU, **kw))
    np.testing.assert_array_equal(fused, jvirt)


# ---------------------------------------------------------------------------
# The two routes against each other; prepared against raw
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("xs,ws,stride,padding", [
    ((2, 5, 13, 13), (7, 5, 3, 3), 1, "SAME"),
    ((1, 3, 20, 17), (16, 3, 7, 7), 2, 3),
    ((3, 6, 9, 9), (8, 6, 1, 1), 1, 0),
    ((1, 2, 10, 11), (3, 2, 3, 5), (2, 1), ((2, 0), (0, 3))),
])
def test_fused_plain_matches_im2col_route(xs, ws, stride, padding):
    rng = np.random.default_rng(30)
    kvol = int(np.prod(ws[1:]))
    x, w = _f32(rng, xs), _f32(rng, ws)
    fused = _np(ops.sq_conv2d(x, w, stride=stride, padding=padding,
                              device=CPU))
    im2col = _np(ops.sq_conv2d_im2col(x, w, stride=stride, padding=padding,
                                      device=CPU))
    np.testing.assert_allclose(fused, im2col, rtol=2e-3, atol=2e-3 * kvol)
    xi = rng.integers(-128, 128, xs).astype(np.int8)
    wi = rng.integers(-128, 128, ws).astype(np.int8)
    np.testing.assert_array_equal(
        _np(ops.sq_conv2d(xi, wi, stride=stride, padding=padding,
                          device=CPU)),
        _np(ops.sq_conv2d_im2col(xi, wi, stride=stride, padding=padding,
                                 device=CPU)))


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
@pytest.mark.parametrize("ws", [(6, 4, 3, 3), (3, 3), (5, 3, 3)])
def test_prepared_bit_identical_to_raw(dtype, ws):
    rng = np.random.default_rng(31)
    xs = (2, 4, 12, 10) if len(ws) == 4 else (12, 10)
    if dtype == np.int8:
        x = torch.as_tensor(rng.integers(-128, 128, xs).astype(np.int8))
        w = torch.as_tensor(rng.integers(-128, 128, ws).astype(np.int8))
    else:
        x, w = torch.as_tensor(_f32(rng, xs)), torch.as_tensor(_f32(rng, ws))
    prep = prepare_operand(w, for_="conv2d")
    assert prep.kind == "conv2d" and prepare_operand(prep) is prep
    kw = dict(stride=2, padding="SAME")
    for f in (ops.sq_conv2d, ops.sq_conv2d_im2col, ops.sq_conv2d_routed):
        assert torch.equal(f(x, prep, **kw), f(x, w, **kw)), f.__name__
    for mode in tconv.CONV2D_MODES:
        assert torch.equal(tconv.conv2d(x, prep, mode=mode, **kw),
                           tconv.conv2d(x, w, mode=mode, **kw)), mode


def test_prepared_operands_keep_their_kind():
    w = torch.ones(3, 2, 3, 3)
    with pytest.raises(ValueError, match="'matmul' PreparedOperand"):
        ops.sq_conv2d(torch.ones(1, 2, 5, 5), prepare_operand(w[0, 0]))
    from repro_torch.core import matmul as tmm
    with pytest.raises(ValueError, match="'conv2d' PreparedOperand"):
        tmm.matmul(torch.ones(2, 18), prepare_operand(w, for_="conv2d"),
                   mode="square_pallas")


def test_k7_splits_the_k_walk_of_the_deep_layers():
    """On a 132-SM card K7 splits the K walk of the ResNet-50 layers whose
    64 x 64 tiles leave the busiest SM short of 3 blocks (conv3_1, conv4_x,
    conv5_x: 2, 5 and 7 ways) and no other; a split is a whole number of
    16-deep K tiles, and the splits cover the walk."""
    from repro_torch.kernels.sq_conv2d import k7_launch_shape
    layers = [((8, 3, 224, 224), 64, (7, 7), 2, 3),
              ((8, 256, 56, 56), 64, (1, 1), 1, 0),
              ((8, 64, 56, 56), 64, (3, 3), 1, 1),
              ((8, 128, 56, 56), 128, (3, 3), 2, 1),
              ((8, 256, 14, 14), 256, (3, 3), 1, 1),
              ((8, 512, 7, 7), 512, (3, 3), 1, 1)]
    shapes = [k7_launch_shape(xs, n, khw, (s, s), ((p, p), (p, p)), 132)
              for xs, n, khw, s, p in layers]
    assert [sh["grid"][2] for sh in shapes] == [1, 1, 1, 2, 5, 7]
    for sh in shapes:
        z, per = sh["grid"][2], sh["per_split"]
        assert per * z >= sh["k_tiles"] > per * (z - 1)
    # a card of 8 SMs is filled without a split at conv2_x
    assert k7_launch_shape((8, 64, 56, 56), 64, (3, 3), (1, 1),
                           ((1, 1), (1, 1)), 8)["grid"][2] == 1


# ---------------------------------------------------------------------------
# The route planner
# ---------------------------------------------------------------------------

def test_conv2d_routes_match_jax():
    for oh, ow, khw, cin, cout, b in itertools.product(
            (1, 7, 32, 56, 112), (1, 13, 32), ((1, 1), (3, 3), (7, 7)),
            (1, 3, 14, 64, 256), (1, 16, 512), (1, 8)):
        kh, kw = khw
        want = jrt.select_conv2d_route(oh, ow, kh, kw, cin, cout, batch=b,
                                       dtype=jnp.float32)
        got = trt.select_conv2d_route(oh, ow, kh, kw, cin, cout, batch=b,
                                      dtype=torch.float32)
        assert got.name == want.name, (oh, ow, khw, cin, cout, b, got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_conv2d_routes_key_on_the_accumulator_dtype(dtype):
    jdt = {torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8}[dtype]
    for oh, cin, b in itertools.product((16, 30, 32, 33, 64), (1, 3, 14),
                                        (1, 8)):
        assert trt.select_conv2d_route(oh, oh, 3, 3, cin, 16, batch=b,
                                       dtype=dtype).name == \
            jrt.select_conv2d_route(oh, oh, 3, 3, cin, 16, batch=b,
                                    dtype=jdt).name


@pytest.mark.parametrize("env", ["fused", "im2col", "conv2d=fused",
                                 "conv2d=im2col", "matmul=kernel", "auto",
                                 "conv2d=auto,matmul=virtual", "kernel"])
def test_conv2d_repro_route_env_matches_jax(monkeypatch, env):
    monkeypatch.setenv("REPRO_ROUTE", env)
    for args in ((32, 32, 3, 3, 3, 16, 8), (56, 56, 3, 3, 64, 64, 8),
                 (4, 4, 1, 1, 2, 2, 1)):
        *shape, b = args
        assert trt.select_conv2d_route(*shape, batch=b).name == \
            jrt.select_conv2d_route(*shape, batch=b).name, (env, args)


def test_routed_conv_counts_its_routes(monkeypatch):
    trt.select_conv2d_route.taken.clear()
    x = np.ones((2, 3, 8, 8), np.float32)
    tconv.conv2d(x, np.ones((4, 3, 3, 3), np.float32), mode="square_pallas",
                 device=CPU)                                 # tiny: im2col
    tconv.conv2d(np.ones((1, 16, 9, 9), np.float32),
                 np.ones((4, 16, 3, 3), np.float32), mode="square_pallas",
                 device=CPU)                                 # kvol 144: fused
    monkeypatch.setenv("REPRO_ROUTE", "conv2d=fused")
    tconv.conv2d(x, np.ones((4, 3, 3, 3), np.float32), mode="square_pallas",
                 device=CPU)
    assert dict(trt.select_conv2d_route.taken) == {"im2col": 1, "fused": 2}


def test_conv2d_patch_bytes_matches_the_cost_model():
    from repro.core import cost_model as cm
    for args in itertools.product((1, 28), (3, 7), (3, 64), (1, 8)):
        oh, k, cin, b = args
        assert trt.conv2d_patch_bytes(oh, oh, k, k, cin, batch=b) == \
            cm.conv2d_patch_bytes(oh, oh, k, k, cin, batch=b)
    assert trt.IM2COL_PATCH_BYTES_MAX == jrt.IM2COL_PATCH_BYTES_MAX
    assert trt.IM2COL_K_MAX == jrt.IM2COL_K_MAX


# ---------------------------------------------------------------------------
# 1D and single-plane 2D correlations; K8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["standard", "square", "square_virtual"])
@pytest.mark.parametrize("L,n", [(64, 3), (257, 7), (100, 100)])
def test_correlate1d_and_convolve1d_match_jax(mode, L, n):
    rng = np.random.default_rng(32)
    x, w = _f32(rng, L), _f32(rng, n)
    for tf, jf in ((tconv.correlate1d, jconv.correlate1d),
                   (tconv.convolve1d, jconv.convolve1d)):
        np.testing.assert_allclose(
            _np(tf(x, w, mode=mode, device=CPU)),
            np.asarray(jf(jnp.asarray(x), jnp.asarray(w), mode=mode)),
            rtol=1e-4, atol=1e-3, err_msg=tf.__name__)
    xi = rng.integers(-128, 128, L).astype(np.int8)
    wi = rng.integers(-128, 128, n).astype(np.int8)
    got = _np(tconv.correlate1d(xi, wi, mode=mode, device=CPU))
    want = np.asarray(jconv.correlate1d(jnp.asarray(xi), jnp.asarray(wi),
                                        mode=mode))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["standard", "square", "square_virtual"])
@pytest.mark.parametrize("hw,khw", [((9, 8), (3, 2)), ((12, 12), (5, 5)),
                                    ((4, 17), (4, 1))])
def test_correlate2d_matches_jax(mode, hw, khw):
    rng = np.random.default_rng(33)
    x, w = _f32(rng, hw), _f32(rng, khw)
    np.testing.assert_allclose(
        _np(tconv.correlate2d(x, w, mode=mode, device=CPU)),
        np.asarray(jconv.correlate2d(jnp.asarray(x), jnp.asarray(w),
                                     mode=mode)),
        rtol=1e-4, atol=1e-3)
    xi = rng.integers(-128, 128, hw).astype(np.int8)
    wi = rng.integers(-128, 128, khw).astype(np.int8)
    np.testing.assert_array_equal(
        _np(tconv.correlate2d(xi, wi, mode=mode, device=CPU)),
        np.asarray(jconv.correlate2d(jnp.asarray(xi), jnp.asarray(wi),
                                     mode=mode)))


@pytest.mark.parametrize("n", [1, 5, 40])
def test_sliding_sum_squares_matches_jax(n):
    rng = np.random.default_rng(34)
    x = _f32(rng, (3, 40))
    np.testing.assert_allclose(
        _np(tconv.sliding_sum_squares(x, n, device=CPU)),
        np.asarray(jconv.sliding_sum_squares(jnp.asarray(x), n)),
        rtol=1e-5, atol=1e-4)
    xi = rng.integers(-128, 128, 40).astype(np.int8)
    np.testing.assert_array_equal(
        _np(tconv.sliding_sum_squares(xi, n, device=CPU)),
        np.asarray(jconv.sliding_sum_squares(jnp.asarray(xi), n)))


@pytest.mark.parametrize("L,n", [(64, 3), (300, 11), (1000, 64), (257, 7),
                                 (2049, 1), (4000, 255), (700, 300),
                                 (129, 129)])
def test_sq_conv_matches_jax_ref(L, n):
    """K8's plain version through ops.sq_conv: taps and outputs ragged
    against every tile size, no padding."""
    rng = np.random.default_rng(35)
    x, w = _f32(rng, L), _f32(rng, n)
    out = _np(ops.sq_conv(x, w, device=CPU))
    oracle = np.asarray(jref.sq_conv_ref(jnp.asarray(x), jnp.asarray(w)))
    assert out.shape == (L - n + 1,)
    np.testing.assert_allclose(out, oracle, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(_np(tref.sq_conv_ref(torch.as_tensor(x),
                                                    torch.as_tensor(w))),
                               oracle, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(out, np.correlate(x, w, mode="valid"),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("L,n", [(300, 11), (1000, 255)])
def test_sq_conv_int8_exact(L, n):
    """The int path halves with an arithmetic shift (squares.halve): exact
    against the integer correlation and the JAX square-mode one."""
    rng = np.random.default_rng(36)
    x = rng.integers(-128, 128, L).astype(np.int8)
    w = rng.integers(-128, 128, n).astype(np.int8)
    out = _np(ops.sq_conv(x, w, device=CPU))
    assert out.dtype == np.int32
    np.testing.assert_array_equal(
        out, np.correlate(x.astype(np.int64), w.astype(np.int64), "valid"))
    np.testing.assert_array_equal(
        out, np.asarray(jconv.correlate1d(jnp.asarray(x), jnp.asarray(w),
                                          mode="square")))


def test_sq_conv_rejects_bad_shapes():
    with pytest.raises(ValueError, match="1 <= n <= L"):
        ops.sq_conv(np.ones(4, np.float32), np.ones(5, np.float32),
                    device=CPU)
    with pytest.raises(ValueError, match="1D"):
        ops.sq_conv(np.ones((2, 4), np.float32), np.ones(3, np.float32),
                    device=CPU)


def test_tensors_stay_on_their_device_and_arrays_follow_device():
    x = torch.ones(2, 3, 6, 6)
    out = tconv.conv2d(x, torch.ones(4, 3, 3, 3), mode="square_pallas")
    assert out.device == x.device
    out = ops.sq_conv(np.ones(20, np.float32), np.ones(3, np.float32),
                      device=CPU)
    assert out.device.type == "cpu"


# ---------------------------------------------------------------------------
# The JAX im2col route itself, with the renamed compiler params
# aliased for this test only
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("xs,ws,stride,padding", [
    ((2, 5, 12, 11), (7, 5, 3, 3), 2, "SAME"),
    ((1, 3, 8, 9), (4, 3, 3, 3), 1, ((1, 0), (2, 1))),
])
def test_im2col_route_matches_the_jax_im2col_route(monkeypatch, xs, ws,
                                                   stride, padding):
    from jax.experimental.pallas import tpu as pltpu
    from repro.kernels import ops as jops
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams",
                            pltpu.CompilerParams, raising=False)
    rng = np.random.default_rng(37)
    x, w = _f32(rng, xs), _f32(rng, ws)
    want = np.asarray(jops.sq_conv2d_im2col(jnp.asarray(x), jnp.asarray(w),
                                            stride=stride, padding=padding,
                                            interpret=True))
    got = _np(ops.sq_conv2d_im2col(x, w, stride=stride, padding=padding,
                                   device=CPU))
    np.testing.assert_allclose(got, want, rtol=2e-3,
                               atol=2e-3 * int(np.prod(ws[1:])))
