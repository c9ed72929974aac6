"""K7's and K8's launch rules on the CPU: the Python mirrors
(``k7_launch_shape``, ``k8_launch_shape``) at the shapes ``chip_smoke.py``
runs, against the constants of ``src/repro_torch/csrc/sq_conv2d.cu`` and
``sq_conv.cu``, and each kernel's square term read from its source.  The
kernels themselves run only on the card (``tests/test_torch_cuda.py``)."""
import re
from pathlib import Path

import pytest

pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.core import conv as cc  # noqa: E402
from repro_torch.kernels import sq_conv as k8mod  # noqa: E402
from repro_torch.kernels import sq_conv2d as k7mod  # noqa: E402
from repro_torch.kernels.sq_conv import k8_launch_shape  # noqa: E402
from repro_torch.kernels.sq_conv2d import (  # noqa: E402
    conv2d_out_hw, k7_launch_shape)

CSRC = Path(repro_torch.__file__).parent / "csrc"
SMS = 132                     # an H100 SXM

# chip_smoke.py's timed ResNet-50 layers at batch 8: (x shape, w shape,
# stride, padding), and the launch the rule gives each: grid, band, channel
# slice, window (rows, staged columns)
RESNET50 = {
    "conv1": ((8, 3, 224, 224), (64, 3, 7, 7), 2, 3,
              (1568, 1, 1), 8, 3, (21, 24)),
    "conv2_x 1x1": ((8, 256, 56, 56), (64, 256, 1, 1), 1, 0,
                    (392, 1, 1), 8, 16, (8, 8)),
    "conv2_x 3x3": ((8, 64, 56, 56), (64, 64, 3, 3), 1, 1,
                    (392, 1, 1), 8, 16, (10, 16)),
    "conv3_1 3x3/2": ((8, 128, 56, 56), (128, 128, 3, 3), 2, 1,
                      (98, 2, 2), 14, 16, (14, 32)),
    "conv4_x 3x3": ((8, 256, 14, 14), (256, 256, 3, 3), 1, 1,
                    (25, 4, 5), 14, 16, (10, 16)),
    "conv5_x 3x3": ((8, 512, 7, 7), (512, 512, 3, 3), 1, 1,
                    (7, 8, 7), 7, 16, (17, 9)),
}
# chip_smoke.py's K7_RAGGED, and shapes that take the rule's other
# branches: a band that does not divide ow, the pixels-a-tile guard
K7_RAGGED = [
    ((2, 3, 17, 13), (5, 3, 3, 3), 1, "SAME"),
    ((1, 5, 15, 18), (7, 5, 3, 3), 2, "SAME"),
    ((2, 7, 10, 11), (3, 7, 3, 5), 1, ((2, 0), (0, 3))),
    ((1, 3, 9, 23), (5, 3, 5, 3), (2, 1), "VALID"),
    ((2, 5, 31, 29), (65, 5, 7, 7), 2, ((3, 2), (1, 3))),
    ((3, 1, 8, 8), (1, 1, 8, 8), 1, "VALID"),
    ((1, 3, 23, 23), (4, 3, 3, 3), 1, "SAME"),
    ((1, 2, 24, 24), (3, 2, 24, 24), 1, "VALID"),
]


def _geometry(xs, ws, stride, padding):
    strides = cc.resolve_stride(stride)
    pads = cc.resolve_padding(padding, xs[2:], ws[2:], strides)
    return strides, pads


def _shape(xs, ws, stride, padding):
    strides, pads = _geometry(xs, ws, stride, padding)
    return k7_launch_shape(xs, ws[0], ws[2:], strides, pads, SMS)


@pytest.mark.parametrize("name", list(RESNET50))
def test_k7_launch_at_resnet50_layers(name):
    """Each timed layer's launch: 64 x 64 tiles, the band that divides its
    width, 16-channel windows (conv1 all 3), and a K walk split only on the
    three deep layers, whose tiles leave the busiest of 132 SMs short of 3
    blocks."""
    xs, ws, st, pd, grid, band, cs, window = RESNET50[name]
    shape = _shape(xs, ws, st, pd)
    assert shape["grid"] == grid
    assert (shape["band"], shape["slice"], shape["window"]) == \
        (band, cs, window)
    assert shape["tile"] == (64, 64) and shape["pixels"] == 64
    gx, gy, gz = grid
    assert (-(-gx * gy // SMS) >= 3) == (gz == 1)


def test_k7_tiers_each_taken_by_a_timed_layer():
    """Every band branch of the rule (a divisor of ow in [8, 16]: 8 and 14;
    else ow itself below 8: 7) and both split branches (none, split) is
    taken by a layer chip_smoke.py times."""
    shapes = [_shape(*v[:4]) for v in RESNET50.values()]
    assert {s["band"] for s in shapes} == {8, 14, 7}
    assert {s["grid"][2] > 1 for s in shapes} == {True, False}


def _windows_cover(xs, ws, stride, padding):
    """Every pixel in exactly one tile, and every tile's reads inside its
    window, walked with the kernel's own index math."""
    (B, C, H, W), (kh, kw) = xs, ws[2:]
    (sh, sv), pads = _geometry(xs, ws, stride, padding)
    shape = k7_launch_shape(xs, ws[0], (kh, kw), (sh, sv), pads, SMS)
    oh, ow = conv2d_out_hw((H, W), (kh, kw), (sh, sv), pads)
    tc, pt = shape["band"], shape["pixels"]
    wr, wc = shape["window"]
    hp = (oh - 1) * sh + kh
    bands = -(-ow // tc)
    seen = set()
    for bx in range(shape["grid"][0]):
        band, q0 = bx % bands, bx // bands * pt
        g0 = q0 // tc
        vr0 = g0 // oh * hp + g0 % oh * sh
        ix_band = band * tc * sv - pads[1][0]
        xoff = ix_band & 3 if W % 4 == 0 else 0
        for p in range(pt):
            g, col = divmod(q0 + p, tc)
            if g >= B * oh or band * tc + col >= ow:
                continue
            seen.add((g, band * tc + col))
            vr = g // oh * hp + g % oh * sh
            assert vr - vr0 + kh <= wr
            assert xoff + col * sv + kw <= wc
    assert len(seen) == B * oh * ow


@pytest.mark.parametrize("case", list(RESNET50.values())[1:] + K7_RAGGED,
                         ids=lambda c: "x".join(map(str, c[0] + c[1][2:])))
def test_k7_launch_covers_the_output(case):
    _windows_cover(*case[:4])
    shape = _shape(*case[:4])
    gz, per, k_tiles = shape["grid"][2], shape["per_split"], \
        shape["k_tiles"]
    assert 1 <= gz <= k7mod._MAX_SPLITS
    assert per * gz >= k_tiles > per * (gz - 1)
    assert shape["smem"] <= 227 * 1024


def test_k7_pixels_guard_only_for_windows_that_would_not_fit():
    """A 1 x 1 output under a 24 x 24 filter: one pixel's window is the
    whole filter, so a tile takes 8 pixels, not 64; every other shape here
    keeps 64."""
    assert _shape((1, 2, 24, 24), (3, 2, 24, 24), 1, "VALID")["pixels"] == 8
    assert all(_shape(*c[:4])["pixels"] == 64 for c in K7_RAGGED[:-1])


def test_k7_16_byte_windows_only_where_w_is_a_multiple_of_4():
    """W % 4 == 0 stages whole 4-column chunks from an aligned column, so
    the window grows to a multiple of 4 columns; an unaligned input stages
    single columns."""
    xs, ws, st, pd = RESNET50["conv2_x 3x3"][:4]
    strides, pads = _geometry(xs, ws, st, pd)
    aligned = k7_launch_shape(xs, 64, (3, 3), strides, pads, SMS)
    loose = k7_launch_shape(xs, 64, (3, 3), strides, pads, SMS,
                            x_aligned=False)
    assert aligned["window"] == (10, 16) and loose["window"] == (10, 10)
    assert _shape((1, 3, 9, 23), (5, 3, 5, 3), (2, 1), "VALID")["window"][1] \
        == (8 - 1) * 1 + 3


def _consts(name):
    src = (CSRC / name).read_text()
    return src, {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+)(?: \* 1024)?;", src)}


def test_k7_launch_constants_match_source():
    """The mirror reads the launch the CUDA source derives from a plan (the
    band and split rule itself is the planner's model mode, in Python: the
    source takes both from its caller and checks their range)."""
    src, c = _consts("sq_conv2d.cu")
    assert c["THREADS"] == 128 and (c["TM"], c["TN"]) == (8, 4)
    assert "constexpr int BM = 8 * TM;" in src
    assert "constexpr int BN = 16 * TN;" in src
    assert (8 * c["TM"], 16 * c["TN"], c["BK"]) == \
        (k7mod._BM, k7mod._BN, k7mod._BK)
    assert (c["CS_MAX"], c["MAX_SPLITS"]) == (k7mod._CS_MAX,
                                              k7mod._MAX_SPLITS)
    assert not {"TC_LO", "TC_HI", "SAT_BLOCKS"} & set(c)
    assert "if (tc < 1 || tc > ow || splits < 1 || splits > MAX_SPLITS)" \
        in src
    assert "constexpr int WINDOW_BYTES = 64 * 1024;" in src
    assert k7mod._WINDOW_BYTES == 64 * 1024
    assert max(int(i) for i in re.findall(r"shape\[(\d+)\] = ", src)) + 1 \
        == k7mod._SHAPE_INTS


def test_k8_launch_constants_match_source():
    src, c = _consts("sq_conv.cu")
    assert (c["THREADS"], c["R"], c["TC"]) == \
        (k8mod._THREADS, k8mod._R, k8mod._TC)
    assert max(int(i) for i in re.findall(r"shape\[(\d+)\] = ", src)) + 1 \
        == k8mod._SHAPE_INTS


@pytest.mark.parametrize("L,n", [(1 << 20, 16), (1 << 20, 127),
                                 (1 << 20, 255), (5000, 127), (4097, 255),
                                 (300, 1), (1000, 300), (2049, 3)])
def test_k8_launch_shape(L, n):
    """One block a run of 2048 outputs, 8 a thread, taps staged 256 at a
    time: the FIR streams and chip_smoke.py's K8_RAGGED."""
    shape = k8_launch_shape(L, n)
    assert shape == {"grid": -(-(L - n + 1) // 2048), "block": 2048,
                     "thread": 8, "tap_chunk": 256}


def _body(src: str, signature: str) -> str:
    start = src.index(signature)
    return src[start:src.index("\n}\n", start)]


@pytest.mark.parametrize("name", ["sq_conv2d.cu", "sq_conv.cu"])
def test_kernel_term_square_count(name):
    """K7's and K8's f32 term is one add and one square, 2 FP32 slots:
    s = a + b, fma(s, s, acc).  K8 no longer subtracts x^2 a term (its
    parent's third slot): the sum of squares is formed once a sample."""
    src = (CSRC / name).read_text()
    term = _body(src, "__device__ __forceinline__ float pm_accum(")
    code = term.split("{", 1)[1]
    assert code.count("fmaf(") == 1 and "fmaf(s, s, acc)" in code
    assert code.count("+") == 1 and "-" not in code and "*" not in code
    assert "fmaf(-" not in src
