"""K7: the fused 2D square convolution and its plain PyTorch version.

:func:`sq_conv2d_k7` replaces ``src/repro/kernels/sq_conv2d.py::
sq_conv2d_kernel`` (behind ``sq_conv2d_pallas``): an implicit-GEMM
correlation that never builds the im2col patch tensor.  The kernel lives
in ``src/repro_torch/csrc/sq_conv2d.cu``, whose header states what bounds
it on an H100 and how its design meets that: a block of 128 threads per
64-pixel x 64-filter tile, each thread an 8 x 4 register tile, one input
window per tile and channel slice staged in shared memory, the band and
the K walk's splits a plan of :mod:`repro_torch.kernels.tuning` (model
rule: :func:`k7_launch_shape`), the rest of the launch derived from them.

It takes pre-widened operands, as the Pallas kernel does, in f32 or int32:
the input ``xw`` (B, cin, H, W) NCHW and unpadded (the kernel masks the
padding itself, so no padded copy is made), the filters as the
``(kh*kw*cin, cout)`` tap matrix ``wt`` with K ordered (kh, kw, cin) -- the
Pallas kernel's ``(kh, kw, Cp, Np)`` tap block -- and the per-filter
correction ``sw`` (cout,) ``= -sum w^2``.  It returns

    out[b, f, oy, ox] = 1/2 (Sw_f + sum_{i,j,c} (x_pad + w)^2 - sum x_pad^2)

(B, cout, oh, ow) in the same dtype.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import squares as sq
from repro_torch.core import cost_model as cm
from repro_torch.kernels import build, meta, tuning

__all__ = ["sq_conv2d_k7", "sq_conv2d_plain", "conv2d_out_hw",
           "k7_launch_shape"]

_DTYPE_CODES = {torch.float32: 0, torch.int32: 1}
_INT_MAX = 2 ** 31 - 1
_MAX_GRID_Y = 65535
# The tile rule of csrc/sq_conv2d.cu (launch_shape): a block's tile of
# pixels x filters and its K tile; the band widths tried (divisors of ow),
# the channels a slice, the bytes of the window ring, the blocks an SM that
# keep its FP32 pipes busy and the most splits of a K walk.
_BM, _BN, _BK = 64, 64, 16
_TC_LO, _TC_HI = 8, 16
_CS_MAX = 16
_WINDOW_BYTES = 64 * 1024
_SAT_BLOCKS = 3
_MAX_SPLITS = 8
_SHAPE_INTS = 11              # the C entry's launch report
_PLAIN_CHUNK_ELEMS = 1 << 24  # bound on the plain version's live term tensor

Pads = Tuple[Tuple[int, int], Tuple[int, int]]


def conv2d_out_hw(hw, khw, stride, pads: Pads) -> Tuple[int, int]:
    """Output extents of a correlation of an (H, W) input with (kh, kw)
    taps under ``stride`` and explicit ``pads``."""
    (H, W), (kh, kw), (sh, sv) = hw, khw, stride
    return ((H + pads[0][0] + pads[0][1] - kh) // sh + 1,
            (W + pads[1][0] + pads[1][1] - kw) // sv + 1)


def sq_conv2d_plain(xw: torch.Tensor, wt: torch.Tensor, sw: torch.Tensor,
                    khw: Tuple[int, int], stride: Tuple[int, int],
                    pads: Pads) -> torch.Tensor:
    """K7's arithmetic in plain PyTorch: the accumulator starts at ``Sw_f``,
    the squares ``(x + w)^2`` are added tap by tap in channel chunks small
    enough to fit in memory at CNN-layer sizes, the input's ``sum x^2`` over
    each window is subtracted and the sum is halved.  Used for CPU tensors
    and as K7's reference on the card."""
    B, C, H, W = xw.shape
    kh, kw = khw
    sh, sv = stride
    N = wt.shape[1]
    oh, ow = conv2d_out_hw((H, W), khw, stride, pads)
    P = oh * ow
    (ph0, ph1), (pw0, pw1) = pads
    xp = F.pad(xw, (pw0, pw1, ph0, ph1))
    w4 = wt.reshape(kh, kw, C, N)
    acc = sw.reshape(1, 1, N).expand(B, P, N).clone()
    sx = torch.zeros((B, P), dtype=xw.dtype, device=xw.device)
    cc = max(1, _PLAIN_CHUNK_ELEMS // max(1, B * P * N))
    for i in range(kh):
        for j in range(kw):
            view = xp[:, :, i:i + (oh - 1) * sh + 1:sh,
                      j:j + (ow - 1) * sv + 1:sv].reshape(B, C, P)
            for c0 in range(0, C, cc):
                xs = view[:, c0:c0 + cc]                       # (B, cc, P)
                s = xs[..., None] + w4[i, j, c0:c0 + cc][None, :, None, :]
                acc = acc + torch.sum(s * s, dim=1, dtype=acc.dtype)
                sx = sx + torch.sum(xs * xs, dim=1, dtype=sx.dtype)
    out = sq.halve(acc - sx[..., None])                       # (B, P, N)
    return out.permute(0, 2, 1).reshape(B, N, oh, ow)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _window(pt: int, tc: int, oh: int, khw, stride, pw: int,
            vec: bool) -> Tuple[int, int]:
    """Window rows and columns of a run of ``pt`` pixels in a band of ``tc``
    output columns: the band rows it can span, each image it crosses
    adding kh - sh virtual rows (none when whole runs tile every image's
    rows); with 16-byte copies (``vec``) from the aligned column at or left
    of the band's first, in whole 4-column chunks."""
    (kh, kw), (sh, sv) = khw, stride
    whole = pt % tc == 0
    rows = pt // tc if whole else (pt - 1) // tc + 2
    cross = 0 if whole and oh % rows == 0 else _cdiv(rows - 1, oh)
    wc = (tc - 1) * sv + kw
    if vec:
        wc = _cdiv((-pw & 3 if tc * sv % 4 == 0 else 3) + wc, 4) * 4
    return (rows - 1) * sh + kh + cross * max(0, kh - sh), wc


def k7_launch_shape(xshape, N: int, khw, stride, pads: Pads, sms: int,
                    elem: int = 4, x_aligned: bool = True, band: int = None,
                    splits: int = None) -> dict:
    """K7's launch for a (B, C, H, W) input, N filters of ``khw`` taps under
    ``stride`` and ``pads``, on a card of ``sms`` SMs, as
    ``csrc/sq_conv2d.cu`` (``launch_shape``) makes it from a plan's
    ``band`` and ``splits``; ``x_aligned``: the input starts on a 16-byte
    boundary.

    ``band`` is the output columns a tile row and ``splits`` the most
    blocks a tile's K walk is split over (the launch takes the fewest that
    keep that many K tiles a split).  The rule (``None``, the planner's
    model mode): the band is the smallest divisor of ow in [8, 16], else
    min(ow, 8); the split count the one that least loads the busiest SM,
    counting fewer than 3 blocks an SM as 3, the smallest on a tie.
    ``pixels`` is the pixels a tile (64 unless one channel's window would
    not fit), ``slice`` the channels a window, ``window`` its rows and
    staged columns (4-column chunks where W % 4 == 0).  ``grid`` is (pixel
    tiles, filter tiles, splits); ``tile`` the block's (pixels,
    filters)."""
    B, C, H, W = xshape
    kh, kw = khw
    oh, ow = conv2d_out_hw((H, W), khw, stride, pads)
    vec = W % 4 == 0 and x_aligned
    tc = band if band is not None else next(
        (d for d in range(_TC_LO, _TC_HI + 1) if ow % d == 0),
        min(ow, _TC_LO))
    pt = _BM
    while True:
        wr, wc = _window(pt, tc, oh, khw, stride, pads[1][0], vec)
        if pt == 1 or 2 * elem * wr * wc <= _WINDOW_BYTES:
            break
        pt //= 2
    cs = min(_CS_MAX, C, max(1, _WINDOW_BYTES // (2 * elem * wr * wc)))
    tps = _cdiv(kh * kw * cs, _BK)
    k_tiles = _cdiv(C, cs) * tps
    grid_xy = (_cdiv(ow, tc) * _cdiv(B * oh * tc, pt), _cdiv(N, _BN))
    if splits is None:
        tiles = grid_xy[0] * grid_xy[1]
        cost = {z: max(_cdiv(tiles * z, sms), _SAT_BLOCKS) * _cdiv(k_tiles, z)
                for z in range(1, min(_MAX_SPLITS, k_tiles) + 1)}
        splits = min(cost, key=lambda z: (cost[z], z))
    per_split = _cdiv(k_tiles, min(splits, k_tiles))
    smem = (elem * (2 * _BK * _BM + 2 * _BK * _BN + 2 * _BM) + 4 * 6 * _BK
            + 4 * _cdiv(cs * wr, 4) * 4 + elem * 2 * cs * wr * wc)
    return {"grid": (*grid_xy, _cdiv(k_tiles, per_split)),
            "tile": (_BM, _BN), "band": tc, "pixels": pt, "slice": cs,
            "per_split": per_split, "k_tiles": k_tiles, "window": (wr, wc),
            "smem": smem}


def _reported(shape) -> dict:
    """The C entry's launch report in :func:`k7_launch_shape`'s form."""
    gx, gy, gz, tc, cs, per_split, wr, wc, smem, k_tiles, pt = shape
    return {"grid": (gx, gy, gz), "tile": (_BM, _BN), "band": tc,
            "pixels": pt, "slice": cs, "per_split": per_split,
            "k_tiles": k_tiles, "window": (wr, wc), "smem": smem}


def _check(xw, wt, sw, khw) -> None:
    if xw.dtype not in _DTYPE_CODES:
        raise TypeError(f"K7 takes f32 or int32 (pre-widened) operands, got "
                        f"{xw.dtype}")
    for name, t in (("wt", wt), ("sw", sw)):
        if t.dtype != xw.dtype:
            raise TypeError(f"K7 operand {name} is {t.dtype}, xw is "
                            f"{xw.dtype}")
        if t.device != xw.device:
            raise ValueError(f"K7 operand {name} is on {t.device}, xw on "
                             f"{xw.device}")
    if xw.ndim != 4 or wt.ndim != 2:
        raise ValueError(f"K7 needs xw (B, cin, H, W) and wt (kh*kw*cin, "
                         f"cout), got {tuple(xw.shape)} and "
                         f"{tuple(wt.shape)}")
    kh, kw = khw
    if wt.shape[0] != kh * kw * xw.shape[1] or tuple(sw.shape) != \
            (wt.shape[1],):
        raise ValueError(f"K7 taps {tuple(wt.shape)} and correction "
                         f"{tuple(sw.shape)} do not fit {kh}x{kw} taps over "
                         f"{xw.shape[1]} channels")


def sq_conv2d_k7(xw: torch.Tensor, wt: torch.Tensor, sw: torch.Tensor, *,
                 khw: Tuple[int, int], stride: Tuple[int, int],
                 pads: Pads, plan: tuning.Conv2DPlan = None) -> torch.Tensor:
    """Launch K7 on CUDA tensors (the plain version on CPU tensors), with
    ``plan``'s band and splits (default the planner's,
    :func:`repro_torch.kernels.tuning.plan_conv2d`).

    ``sq_conv2d_k7.launches`` counts the kernel launches made by this
    process, and ``sq_conv2d_k7.shapes`` counts them by ``(B, cin, H, W,
    cout, kh, kw, stride, pads)``; a CPU call does not count.
    ``sq_conv2d_k7.last_shape`` is the last launch as the kernel reports it
    (:func:`k7_launch_shape`'s form) and ``sq_conv2d_k7.last_plan`` its
    plan, None before one.
    """
    _check(xw, wt, sw, khw)
    B, C, H, W = xw.shape
    N = wt.shape[1]
    kh, kw = khw
    oh, ow = conv2d_out_hw((H, W), khw, stride, pads)
    if oh <= 0 or ow <= 0:
        raise ValueError(f"kernel {khw} larger than the padded input of "
                         f"{(H, W)} under pads {pads}")
    if xw.device.type == "cpu":
        return sq_conv2d_plain(xw, wt, sw, khw, stride, pads)
    if xw.device.type == "meta" and meta.active():
        plan = tuning.plan_conv2d(tuple(xw.shape), N, khw, stride, pads,
                                  xw.dtype, sms=cm.H100_SMS, plan=plan)
        shape = k7_launch_shape(xw.shape, N, khw, stride, pads, cm.H100_SMS,
                                band=plan.band, splits=plan.splits)
        terms = B * oh * ow * N * kh * kw * C
        meta.record("K7", (B, C, H, W, N, kh, kw, tuple(stride),
                           tuple(map(tuple, pads))), terms, 2 * terms,
                    cm.conv2d_cost(shape, B, C, N, oh, ow, kh, kw, H, W,
                                   xw.element_size()), xw.dtype)
        return torch.empty((B, N, oh, ow), dtype=xw.dtype, device="meta")
    if xw.device.type != "cuda":
        raise build.KernelError("K7 runs on CUDA (or its plain version on "
                                f"CPU), got a tensor on {xw.device}")
    M = B * oh * ow
    xw, wt, sw = xw.contiguous(), wt.contiguous(), sw.contiguous()
    sms = torch.cuda.get_device_properties(xw.device).multi_processor_count
    aligned = xw.data_ptr() % 16 == 0
    plan = tuning.plan_conv2d(tuple(xw.shape), N, khw, stride, pads,
                              xw.dtype, sms=sms, x_aligned=aligned, plan=plan)
    shape = k7_launch_shape(xw.shape, N, khw, stride, pads, sms,
                            x_aligned=aligned, band=plan.band,
                            splits=plan.splits)
    gx, gy, gz = shape["grid"]
    if max(xw.numel(), wt.numel(), M * N) > _INT_MAX or gy > _MAX_GRID_Y:
        raise build.KernelError(f"K7 shape {tuple(xw.shape)} x "
                                f"{tuple(wt.shape)} exceeds the kernel's "
                                "32-bit indexing or grid limits")
    out = torch.empty((B, N, oh, ow), dtype=xw.dtype, device=xw.device)
    if out.numel() == 0:
        return out
    # the split partials and one zeroed ticket a tile (none with 1 split)
    split = gz > 1
    partial = torch.empty(gx * gy * gz * _BM * _BN if split else 0,
                          dtype=xw.dtype, device=xw.device)
    tickets = torch.zeros(gx * gy if split else 0, dtype=torch.int32,
                          device=xw.device)
    lib = build.load("sq_conv2d")
    report = (ctypes.c_int * _SHAPE_INTS)()
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream(xw.device).cuda_stream
        rc = lib.fs_sq_conv2d(_DTYPE_CODES[xw.dtype], xw.data_ptr(),
                              wt.data_ptr(), sw.data_ptr(), out.data_ptr(),
                              B, C, H, W, N, kh, kw, stride[0], stride[1],
                              pads[0][0], pads[1][0], oh, ow, plan.band,
                              plan.splits, partial.data_ptr(), partial.numel(),
                              tickets.data_ptr(), tickets.numel(), stream,
                              ctypes.addressof(report))
    build.check(lib, rc, "K7 sq_conv2d launch")
    sq_conv2d_k7.launches += 1
    sq_conv2d_k7.shapes[(B, C, H, W, N, kh, kw, tuple(stride),
                         tuple(map(tuple, pads)))] += 1
    sq_conv2d_k7.last_shape = _reported(tuple(report))
    sq_conv2d_k7.last_plan = plan
    return out


sq_conv2d_k7.launches = 0
sq_conv2d_k7.shapes = collections.Counter()
sq_conv2d_k7.last_shape = None
sq_conv2d_k7.last_plan = None
