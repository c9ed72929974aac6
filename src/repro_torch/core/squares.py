"""Fair-and-Square primitive algebra (paper §2, §6.1): the PyTorch port of
``repro/core/squares.py``.

Accumulating PM terms ``(a+b)^2`` plus the row/column corrections yields
``2 * (true result)``; callers apply :func:`halve` at the end (the paper's
"simple right shift").  Integer operands follow the paper's bit-growth rule:
int8/int16 accumulate in int32, so the integer path is exact.
"""
from __future__ import annotations

import torch

__all__ = ["accum_dtype", "widen_for_sum", "square", "acc_sum", "pm",
           "pm_neg", "cpm4_real", "cpm4_imag", "cpm3_shared", "cpm3_real",
           "cpm3_imag", "row_correction", "col_correction", "square_approx",
           "halve"]

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


def pm_neg(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Negative-product partial multiplication (paper eq 2): ``(a-b)^2``;
    ``sum_k pm_neg(a_k, b_k) + Sa + Sb == -2 * sum_k a_k b_k``."""
    return square(widen_for_sum(a) - widen_for_sum(b))


# Complex partial multiplications.  Operands are passed as separate real and
# imaginary planes (a + jb) and (c + js): the four wires entering the
# paper's CPM blocks.

def cpm4_real(a, b, c, s) -> torch.Tensor:
    """CPM (4 squares) real part, paper eq (21): ``(a+c)^2 + (b-s)^2``."""
    return pm(a, c) + pm_neg(b, s)


def cpm4_imag(a, b, c, s) -> torch.Tensor:
    """CPM (4 squares) imag part, paper eq (22): ``(b+c)^2 + (a+s)^2``."""
    return pm(b, c) + pm(a, s)


def cpm3_shared(a, b, c) -> torch.Tensor:
    """The square shared by CPM3 real and imaginary parts: ``(c+a+b)^2``."""
    return square(widen_for_sum(a) + widen_for_sum(b) + widen_for_sum(c))


def cpm3_real(a, b, c, s, shared=None) -> torch.Tensor:
    """CPM3 real part, paper eq (37): ``(c+a+b)^2 - (b+c+s)^2``."""
    if shared is None:
        shared = cpm3_shared(a, b, c)
    return shared - square(widen_for_sum(b) + widen_for_sum(c)
                           + widen_for_sum(s))


def cpm3_imag(a, b, c, s, shared=None) -> torch.Tensor:
    """CPM3 imag part, paper eq (38): ``(c+a+b)^2 + (a+s-c)^2``."""
    if shared is None:
        shared = cpm3_shared(a, b, c)
    return shared + square(widen_for_sum(a) + widen_for_sum(s)
                           - widen_for_sum(c))


def acc_sum(t: torch.Tensor, dim) -> torch.Tensor:
    """``t`` summed over ``dim`` in its own dtype: torch.sum promotes
    integers to int64, the square datapath stays in its int32 accumulator
    (as the JAX package does with x64 off)."""
    return torch.sum(t, dim=dim, dtype=t.dtype)


def row_correction(a: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``Sa_i = -sum_k a_ik^2`` along the contraction axis (paper eq 5)."""
    return -acc_sum(square(a), dim)


def col_correction(b: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``Sb_j = -sum_k b_kj^2`` along the contraction axis (paper eq 5)."""
    return -acc_sum(square(b), dim)


def square_approx(x: torch.Tensor, *, drop_bits: int = 4) -> torch.Tensor:
    """Approximate squaring (paper conclusion: "Approximate squaring is also
    a possibility").

    Integer path: a truncated squarer -- the low ``drop_bits`` bits of the
    widened operand are zeroed before squaring (relative error at most
    ``2^(drop_bits+1) / |x|``).  Float path: the square is computed in
    bfloat16 (an 8-bit mantissa, a truncated multiplier array) and widened
    to the accumulator dtype.
    """
    if not x.dtype.is_floating_point:
        w = widen_for_sum(x)
        t = torch.bitwise_left_shift(torch.bitwise_right_shift(w, drop_bits),
                                     drop_bits)
        return t * t
    xb = x.to(torch.bfloat16)
    return (xb * xb).to(accum_dtype(x.dtype))


def halve(x: torch.Tensor) -> torch.Tensor:
    """Recover ``c`` from ``2c``: x0.5 for floats, an arithmetic ``>> 1`` for
    integers (exact: every accumulated ``2ab`` is even)."""
    if x.dtype.is_floating_point:
        return x * 0.5
    return torch.bitwise_right_shift(x, 1)
