"""Square-based complex matrix multiplication (paper §6 and §9): the PyTorch
port of ``repro/core/complexmm.py``.

Two decompositions of ``Z = X @ Y`` with ``X = A + jB`` (M,N) and
``Y = C + jS`` (N,P):

CPM4 (paper §6, eqs 17-19): 4 squares per complex multiply
    Re(2z_hk) = sum_i [(a+c)^2 + (b-s)^2] + Sx_h + Sy_k
    Im(2z_hk) = sum_i [(b+c)^2 + (a+s)^2] + Sx_h + Sy_k
    Sx_h = -sum_i (a^2 + b^2)       Sy_k = -sum_i (c^2 + s^2)

CPM3 (paper §9, eqs 31-36): 3 squares per complex multiply; the square
``(c+a+b)^2`` is shared between real and imaginary parts:
    Re(2z_hk) = sum_i [(c+a+b)^2 - (b+c+s)^2] + Sab_h + Scs_k
    Im(2z_hk) = sum_i [(c+a+b)^2 + (a+s-c)^2] + Sba_h + Ssc_k
    Sab_h = sum_i (-(a+b)^2 + b^2)   Scs_k = sum_i (-c^2 + (c+s)^2)
    Sba_h = sum_i (-(a+b)^2 - a^2)   Ssc_k = sum_i (-c^2 - (s-c)^2)

Unit-modulus simplification (paper §6): if every element of Y has |y| = 1
(e.g. the DFT matrix), then Sy_k == -N.

Inputs may be complex tensors or arrays, ``(re, im)`` plane pairs (how the
paper's four-wire CPM hardware sees them) or real operands (imaginary
plane zero).  These functions materialise every term, so they are test
scale: they are the CPU oracles of the kernels K5 and K6, which
``kernels/ops.py`` runs.  Integer planes (int8/int16) accumulate in int32
and halve with a shift, so that path is exact.  Tensors stay on their own
device unless ``device`` names one; arrays go to CUDA unless the caller
names another device.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import squares as sq
from repro_torch.device import Device, operand_device

__all__ = ["cpm4_matmul", "cpm3_matmul", "complex_matmul", "split_planes",
           "join_planes"]


def split_planes(x, *, device: Device = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split an operand into its (re, im) planes.

    Accepts a complex tensor or array, an explicit ``(re, im)`` pair (the
    module docstring's four-wire hardware view), or a real operand
    (imaginary plane identically zero).
    """
    if isinstance(x, (tuple, list)):
        if len(x) != 2:
            raise ValueError(
                f"expected a (re, im) plane pair, got {len(x)} items")
        dev = operand_device(x[0], device)
        re = torch.as_tensor(x[0]).to(dev)
        im = torch.as_tensor(x[1]).to(dev)
        if re.is_complex() or im.is_complex():
            raise ValueError("(re, im) planes must be real arrays")
        if re.shape != im.shape:
            raise ValueError(f"plane shapes differ: {tuple(re.shape)} vs "
                             f"{tuple(im.shape)}")
        return re, im
    x = torch.as_tensor(x).to(operand_device(x, device))
    if x.is_complex():
        return x.real, x.imag
    return x, torch.zeros_like(x)


def _as_planes(x, x_im, device: Device):
    if x_im is None:
        return split_planes(x, device=device)
    return split_planes((x, x_im), device=device)


def _widened(x, y, x_im, y_im, device: Device):
    a, b = _as_planes(x, x_im, device)
    c, s = _as_planes(y, y_im, a.device)
    acc = sq.accum_dtype(a.dtype)
    return tuple(t.to(acc) for t in (a, b, c, s))


def join_planes(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """``re + j im`` as a complex tensor; int32 planes give complex64, as
    ``re + 1j * im`` does in JAX."""
    ft = re.dtype if re.dtype.is_floating_point else torch.float32
    return torch.complex(re.to(ft), im.to(ft))


def _out(re: torch.Tensor, im: torch.Tensor, planes_out: bool):
    return (re, im) if planes_out else join_planes(re, im)


def cpm4_matmul(x, y, x_im=None, y_im=None, *, planes_out: bool = False,
                device: Device = None):
    """Complex matmul with 4 squares per multiply (paper §6).  ``x`` may
    carry leading batch axes: (..., M, N) @ (N, P)."""
    a, b, c, s = _widened(x, y, x_im, y_im, device)
    a3, b3 = a[..., :, :, None], b[..., :, :, None]
    c3, s3 = c[None, :, :], s[None, :, :]
    re2 = sq.acc_sum(sq.pm(a3, c3) + sq.pm_neg(b3, s3), -2)
    im2 = sq.acc_sum(sq.pm(b3, c3) + sq.pm(a3, s3), -2)

    sx = -sq.acc_sum(sq.square(a) + sq.square(b), -1)         # (.., M)
    sy = -sq.acc_sum(sq.square(c) + sq.square(s), 0)          # (P,)

    re = sq.halve(re2 + sx[..., None] + sy)
    im = sq.halve(im2 + sx[..., None] + sy)
    return _out(re, im, planes_out)


def cpm3_matmul(x, y, x_im=None, y_im=None, *, planes_out: bool = False,
                device: Device = None):
    """Complex matmul with 3 squares per multiply (paper §9).  ``x`` may
    carry leading batch axes: (..., M, N) @ (N, P)."""
    a, b, c, s = _widened(x, y, x_im, y_im, device)
    ab, bb = a[..., :, :, None], b[..., :, :, None]       # (.., M, N, 1)
    cb, sb = c[None, :, :], s[None, :, :]                 # (1, N, P)

    shared = sq.cpm3_shared(ab, bb, cb)                   # (c+a+b)^2, shared
    re2 = sq.acc_sum(sq.cpm3_real(ab, bb, cb, sb, shared=shared), -2)
    im2 = sq.acc_sum(sq.cpm3_imag(ab, bb, cb, sb, shared=shared), -2)

    sab = sq.acc_sum(-sq.square(a + b) + sq.square(b), -1)    # (.., M) eq 33
    scs = sq.acc_sum(-sq.square(c) + sq.square(c + s), 0)     # (P,)    eq 33
    sba = sq.acc_sum(-sq.square(a + b) - sq.square(a), -1)    # (.., M) eq 35
    ssc = sq.acc_sum(-sq.square(c) - sq.square(s - c), 0)     # (P,)    eq 35

    re = sq.halve(re2 + sab[..., None] + scs)
    im = sq.halve(im2 + sba[..., None] + ssc)
    return _out(re, im, planes_out)


def complex_matmul(x, y, *, mode: str = "standard", device: Device = None):
    """Complex matmul dispatch: standard | cpm4 | cpm3."""
    if mode == "standard":
        dev = operand_device(x, device)
        return torch.matmul(torch.as_tensor(x).to(dev),
                            torch.as_tensor(y).to(dev))
    if mode == "cpm4":
        return cpm4_matmul(x, y, device=device)
    if mode == "cpm3":
        return cpm3_matmul(x, y, device=device)
    raise ValueError(f"unknown complex matmul mode {mode!r}")
