"""K7: the fused 2D square convolution and its plain PyTorch version.

:func:`sq_conv2d_k7` replaces ``src/repro/kernels/sq_conv2d.py::
sq_conv2d_kernel`` (behind ``sq_conv2d_pallas``): an implicit-GEMM
correlation that never builds the im2col patch tensor.  The kernel lives
in ``src/repro_torch/csrc/sq_conv2d.cu``, whose header states what bounds
it on an H100 and how its design meets that.

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
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import squares as sq
from repro_torch.kernels import build

__all__ = ["sq_conv2d_k7", "sq_conv2d_plain", "conv2d_out_hw", "k_splits"]

_DTYPE_CODES = {torch.float32: 0, torch.int32: 1}
_INT_MAX = 2 ** 31 - 1
_MAX_GRID_Y = 65535
_BM, _BN, _BK = 128, 64, 16   # pixels x filters a block, K chunk: the source's
# The K walk of a tile is split over several blocks when the card has more
# SMs than there are tiles, for _BLOCKS_PER_SM blocks per SM, each split at
# least _MIN_SPLIT_CHUNKS chunks deep.  (With a tile or more per SM a split
# bought nothing on an H100: PERF.md, K7 findings.)
_BLOCKS_PER_SM = 2
_MIN_SPLIT_CHUNKS = 8
_MAX_SPLITS = 16
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


def k_splits(M: int, N: int, K: int, sms: int) -> int:
    """How many blocks K7 splits each output tile's K walk over on a card
    with ``sms`` SMs: none while there are as many tiles as SMs, else enough
    for ``_BLOCKS_PER_SM`` blocks per SM, each split at least
    ``_MIN_SPLIT_CHUNKS`` chunks deep, at most ``_MAX_SPLITS``."""
    tiles = -(-M // _BM) * -(-N // _BN)
    if tiles >= sms:
        return 1
    want = -(-_BLOCKS_PER_SM * sms // tiles)
    deep = -(-K // _BK) // _MIN_SPLIT_CHUNKS
    return max(1, min(want, deep, _MAX_SPLITS))


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
                 pads: Pads) -> torch.Tensor:
    """Launch K7 on CUDA tensors (the plain version on CPU tensors).

    ``sq_conv2d_k7.launches`` counts the kernel launches made by this
    process, and ``sq_conv2d_k7.shapes`` counts them by ``(B, cin, H, W,
    cout, kh, kw, stride, pads)``; a CPU call does not count.
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
    if xw.device.type != "cuda":
        raise ValueError(f"K7 runs on CUDA (or its plain version on CPU), "
                         f"got a tensor on {xw.device}")
    M = B * oh * ow
    if max(xw.numel(), wt.numel(), M * N, M + _BM) > _INT_MAX \
            or -(-N // _BN) > _MAX_GRID_Y:
        raise ValueError(f"K7 shape {tuple(xw.shape)} x {tuple(wt.shape)} "
                         f"exceeds the kernel's 32-bit indexing or grid "
                         f"limits")
    out = torch.empty((B, N, oh, ow), dtype=xw.dtype, device=xw.device)
    if out.numel() == 0:
        return out
    xw, wt, sw = xw.contiguous(), wt.contiguous(), sw.contiguous()
    splits = k_splits(M, N, wt.shape[0], torch.cuda.get_device_properties(
        xw.device).multi_processor_count)
    # the split partials and one zeroed ticket a tile (unused with 1 split)
    partial = torch.empty(splits * M * N if splits > 1 else 0,
                          dtype=xw.dtype, device=xw.device)
    tickets = torch.zeros(-(-M // _BM) * -(-N // _BN) if splits > 1 else 0,
                          dtype=torch.int32, device=xw.device)
    lib = build.load("sq_conv2d")
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream(xw.device).cuda_stream
        rc = lib.fs_sq_conv2d(_DTYPE_CODES[xw.dtype], xw.data_ptr(),
                              wt.data_ptr(), sw.data_ptr(), out.data_ptr(),
                              B, C, H, W, N, kh, kw, stride[0], stride[1],
                              pads[0][0], pads[1][0], oh, ow, splits,
                              partial.data_ptr(), tickets.data_ptr(), stream)
    build.check(lib, rc, "K7 sq_conv2d launch")
    sq_conv2d_k7.launches += 1
    sq_conv2d_k7.shapes[(B, C, H, W, N, kh, kw, tuple(stride),
                         tuple(map(tuple, pads)))] += 1
    return out


sq_conv2d_k7.launches = 0
sq_conv2d_k7.shapes = collections.Counter()
