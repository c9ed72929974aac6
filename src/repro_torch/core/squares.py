"""Fair-and-Square primitive algebra (paper §2, §6.1): the PyTorch port of
``repro/core/squares.py``, real half.

Accumulating PM terms ``(a+b)^2`` plus the row/column corrections yields
``2 * (true result)``; callers apply :func:`halve` at the end (the paper's
"simple right shift").  Integer operands follow the paper's bit-growth rule:
int8/int16 accumulate in int32, so the integer path is exact.
"""
from __future__ import annotations

import torch

__all__ = ["accum_dtype", "widen_for_sum", "square", "pm", "row_correction",
           "col_correction", "halve"]

_INT_NARROW = (torch.int8, torch.uint8, torch.int16)


def accum_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulator dtype for square-form arithmetic.

    bf16/f16 -> f32; int8/int16 -> int32; int32 and int64 -> int32 (the
    JAX package's rule with x64 off); f32/f64 unchanged.
    """
    if dtype in _INT_NARROW or dtype in (torch.int32, torch.int64):
        return torch.int32
    if dtype in (torch.bfloat16, torch.float16):
        return torch.float32
    return dtype


def widen_for_sum(x: torch.Tensor) -> torch.Tensor:
    """Widen so that ``a + b`` cannot overflow before squaring."""
    return x.to(accum_dtype(x.dtype))


def square(x: torch.Tensor) -> torch.Tensor:
    """The squaring primitive, in the accumulator dtype."""
    w = widen_for_sum(x)
    return w * w


def pm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Real partial multiplication (paper Fig.1b): ``(a+b)^2``, in the
    accumulator dtype."""
    return square(widen_for_sum(a) + widen_for_sum(b))


def _sum(t: torch.Tensor, dim: int) -> torch.Tensor:
    # torch.sum promotes integers to int64; the square datapath stays in
    # its int32 accumulator (as the JAX package does with x64 off)
    if t.dtype.is_floating_point:
        return torch.sum(t, dim=dim)
    return torch.sum(t, dim=dim, dtype=t.dtype)


def row_correction(a: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``Sa_i = -sum_k a_ik^2`` along the contraction axis (paper eq 5)."""
    return -_sum(square(a), dim)


def col_correction(b: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``Sb_j = -sum_k b_kj^2`` along the contraction axis (paper eq 5)."""
    return -_sum(square(b), dim)


def halve(x: torch.Tensor) -> torch.Tensor:
    """Recover ``c`` from ``2c``: x0.5 for floats, an arithmetic ``>> 1`` for
    integers (exact: every accumulated ``2ab`` is even)."""
    if x.dtype.is_floating_point:
        return x * 0.5
    return torch.bitwise_right_shift(x, 1)
