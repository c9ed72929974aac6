"""K8: the square-based 1D correlation (the paper's Fig. 8 FIR engine) and
its plain PyTorch version.

:func:`sq_conv_k8` replaces ``src/repro/kernels/sq_conv.py::
sq_conv_kernel`` (behind ``sq_conv_pallas``).  The kernel lives in
``src/repro_torch/csrc/sq_conv.cu``, whose header states what bounds it on
an H100 and how its design meets that: 2048 outputs a block, 8 a thread,
the taps walked in staged chunks of 256, each output's sum of squares
formed from squares taken once a sample (:func:`k8_launch_shape`).

It takes pre-widened operands in f32 or int32 -- samples ``xw`` (L,), taps
``ww`` (n,) with 1 <= n <= L, and the tap correction ``sw`` (1,)
``= -sum w^2`` -- and returns the valid correlation

    y_k = 1/2 (Sw + sum_t ((x_{k+t} + w_t)^2 - x_{k+t}^2)),  k < L - n + 1

in the same dtype.  Neither the taps nor the outputs need padding: the
kernel masks both ragged ends.  The integer result is halved with an
arithmetic shift, as ``squares.halve`` does.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.core import squares as sq
from repro_torch.core import cost_model as cm
from repro_torch.kernels import build, meta

__all__ = ["sq_conv_k8", "sq_conv_plain", "k8_launch_shape"]

_DTYPE_CODES = {torch.float32: 0, torch.int32: 1}
_INT_MAX = 2 ** 31 - 1
# csrc/sq_conv.cu: outputs a thread, threads a block, taps a staged chunk
_R, _THREADS, _TC = 8, 256, 256
_SHAPE_INTS = 4               # the C entry's launch report
_PLAIN_CHUNK_ELEMS = 1 << 24  # bound on the plain version's live term tensor


def sq_conv_plain(xw: torch.Tensor, ww: torch.Tensor,
                  sw: torch.Tensor) -> torch.Tensor:
    """K8's arithmetic in plain PyTorch: the accumulator starts at ``Sw``,
    each tap adds ``(x + w)^2 - x^2`` over every output (in chunks of taps
    that fit in memory), the sum is halved.  Used for CPU tensors and as
    K8's reference on the card."""
    n = ww.shape[0]
    k_out = xw.shape[0] - n + 1
    win = xw.unfold(0, k_out, 1)                  # (n, k_out): row t = x[t:]
    acc = sw.expand(k_out).clone()
    tc = max(1, _PLAIN_CHUNK_ELEMS // max(1, k_out))
    for t0 in range(0, n, tc):
        xs = win[t0:t0 + tc]
        s = xs + ww[t0:t0 + tc, None]
        acc = acc + torch.sum(s * s - xs * xs, dim=0, dtype=acc.dtype)
    return sq.halve(acc)


def k8_launch_shape(L: int, n: int) -> dict:
    """K8's launch for L samples and n taps, as ``csrc/sq_conv.cu`` makes
    it: one block a run of ``block`` outputs, ``thread`` outputs a thread,
    the taps staged ``tap_chunk`` at a time."""
    bo = _R * _THREADS
    return {"grid": -(-(L - n + 1) // bo), "block": bo, "thread": _R,
            "tap_chunk": _TC}


def _check(xw, ww, sw) -> None:
    if xw.dtype not in _DTYPE_CODES:
        raise TypeError(f"K8 takes f32 or int32 (pre-widened) operands, got "
                        f"{xw.dtype}")
    for name, t in (("ww", ww), ("sw", sw)):
        if t.dtype != xw.dtype:
            raise TypeError(f"K8 operand {name} is {t.dtype}, xw is "
                            f"{xw.dtype}")
        if t.device != xw.device:
            raise ValueError(f"K8 operand {name} is on {t.device}, xw on "
                             f"{xw.device}")
    if xw.ndim != 1 or ww.ndim != 1 or tuple(sw.shape) != (1,):
        raise ValueError(f"K8 needs xw (L,), ww (n,) and sw (1,), got "
                         f"{tuple(xw.shape)}, {tuple(ww.shape)} and "
                         f"{tuple(sw.shape)}")
    if not 1 <= ww.shape[0] <= xw.shape[0]:
        raise ValueError(f"K8 needs 1 <= n <= L taps, got n={ww.shape[0]} "
                         f"for L={xw.shape[0]}")


def sq_conv_k8(xw: torch.Tensor, ww: torch.Tensor,
               sw: torch.Tensor) -> torch.Tensor:
    """Launch K8 on CUDA tensors (the plain version on CPU tensors).

    ``sq_conv_k8.launches`` counts the kernel launches made by this
    process, and ``sq_conv_k8.shapes`` counts them by ``(L, n)``; a CPU
    call does not count.  ``sq_conv_k8.last_shape`` is the last launch as
    the kernel reports it (:func:`k8_launch_shape`'s form), None before
    one.
    """
    _check(xw, ww, sw)
    if xw.device.type == "cpu":
        return sq_conv_plain(xw, ww, sw)
    if xw.device.type == "meta" and meta.active():
        L, n = xw.shape[0], ww.shape[0]
        terms = (L - n + 1) * n
        launch = k8_launch_shape(L, n)
        size = xw.element_size()
        # a square a sample a tap and its accumulate: 2 slots a term
        meta.record("K8", (L, n), terms, 2 * terms, cm.LaunchCost(
            launch["grid"], _THREADS, size * (launch["block"] + _TC),
            2.0 * terms, size * (L + n + (L - n + 1) + 1)), xw.dtype)
        return torch.empty((L - n + 1,), dtype=xw.dtype, device="meta")
    if xw.device.type != "cuda":
        raise build.KernelError("K8 runs on CUDA (or its plain version on "
                                f"CPU), got a tensor on {xw.device}")
    L, n = xw.shape[0], ww.shape[0]
    if L + 4096 > _INT_MAX:
        raise build.KernelError(f"K8 stream of {L} samples exceeds the "
                                "kernel's 32-bit indexing")
    out = torch.empty((L - n + 1,), dtype=xw.dtype, device=xw.device)
    xw, ww, sw = xw.contiguous(), ww.contiguous(), sw.contiguous()
    lib = build.load("sq_conv")
    report = (ctypes.c_int * _SHAPE_INTS)()
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream(xw.device).cuda_stream
        rc = lib.fs_sq_conv(_DTYPE_CODES[xw.dtype], xw.data_ptr(),
                            ww.data_ptr(), sw.data_ptr(), out.data_ptr(), L,
                            n, stream, ctypes.addressof(report))
    build.check(lib, rc, "K8 sq_conv launch")
    sq_conv_k8.launches += 1
    sq_conv_k8.shapes[(L, n)] += 1
    grid, bo, r, tc = report
    sq_conv_k8.last_shape = {"grid": grid, "block": bo, "thread": r,
                             "tap_chunk": tc}
    return out


sq_conv_k8.launches = 0
sq_conv_k8.shapes = collections.Counter()
sq_conv_k8.last_shape = None
