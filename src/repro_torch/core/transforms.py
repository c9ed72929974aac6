"""Square-based linear transforms (paper §4, §7, §10): the PyTorch port of
``repro/core/transforms.py``.

Real-coefficient transform of a real vector (paper eq 7/8):
    X_k = sum_i w_ki x_i
        = 1/2 ( sum_i (w_ki + x_i)^2  - sum_i x_i^2  + Sw_k )
    Sw_k = -sum_i w_ki^2  (precomputed: "the coefficients are constants", §4)

The ``sum_i x_i^2`` term is common to all k and computed once.

Complex-coefficient transforms of complex vectors:
  - CPM4 form (paper §7, eqs 23-26) with data term Sxy = -sum(x^2+y^2) and
    per-row S_k = -sum(c^2+s^2); unit-modulus rows (DFT) give S_k = -N.
  - CPM3 form (paper §10, eqs 39-43).

The transform engines precompute the coefficient-side corrections at
construction, amortising them over many applications.  They compute in
broadcast form and launch no kernel, as in the JAX package; a batch of
signals goes through ``kernels.ops.cpm3_matmul`` / ``cpm4_matmul`` (K5/K6)
as one complex matmul against :func:`dft_matrix` instead.  Every entry
point takes ``device``: tensors stay on their own device unless one is
named, arrays go to CUDA unless the caller names another device, and an
engine's input must lie on the engine's device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import squares as sq
from repro_torch.core.complexmm import join_planes, split_planes
from repro_torch.device import Device, operand_device, resolve_device

__all__ = ["SquareTransform", "ComplexSquareTransform", "dft_matrix",
           "real_transform"]


def dft_matrix(n: int, dtype: torch.dtype = torch.complex64, *,
               device: Device = None) -> torch.Tensor:
    """The n-point DFT matrix ``exp(-2 pi j k i / n)``, computed in complex128
    by numpy and rounded to ``dtype`` (the JAX package's construction, so
    both give the same bits)."""
    k = np.arange(n)
    w = np.exp(-2j * np.pi * np.outer(k, k) / n)
    return torch.as_tensor(w).to(dtype).to(resolve_device(device))


def real_transform(w, x, *, mode: str = "standard",
                   device: Device = None) -> torch.Tensor:
    """One-shot real transform X_k = sum_i w_ki x_i (paper eq 7/8)."""
    dev = operand_device(x, device)
    w, x = torch.as_tensor(w).to(dev), torch.as_tensor(x).to(dev)
    if mode == "standard":
        return w @ x
    acc = sq.accum_dtype(x.dtype)
    ww, xw = w.to(acc), x.to(acc)
    if mode == "square":
        sab = _rowsum(sq.pm(ww, xw[None, :]))        # sum (w_ki + x_i)^2
        sx = _rowsum(sq.square(xw))                  # common x^2 term
        swk = -_rowsum(sq.square(ww))                # Sw_k (eq 9)
        return sq.halve(sab - sx + swk)
    raise ValueError(f"unknown transform mode {mode!r}")


def _rowsum(t: torch.Tensor) -> torch.Tensor:
    return sq.acc_sum(t, -1)


class _Engine:
    """Coefficients on one device; inputs placed there."""

    device: torch.device

    def _input(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor) and x.device != self.device:
            raise ValueError(f"input lies on {x.device}, the transform's "
                             f"coefficients on {self.device}")
        return torch.as_tensor(x).to(self.device)


class SquareTransform(_Engine):
    """Real-coefficient square-based transform engine (paper Fig.6b).

    Registers are initialised with the precomputed ``Sw_k``; each input
    sample is added to the k-th coefficient column, squared, the shared
    ``x_i^2`` subtracted, and accumulated.  Complex *coefficients* over
    real inputs (paper §4 end) are two instances, one per coefficient
    plane: a complex ``w``.
    """

    def __init__(self, w, *, device: Device = None):
        self.device = operand_device(w, device)
        w = torch.as_tensor(w).to(self.device)
        self.complex_coeff = w.is_complex()
        if self.complex_coeff:
            self.wr, self.wi = w.real, w.imag
            self.swk_r = -_rowsum(sq.square(self.wr))
            self.swk_i = -_rowsum(sq.square(self.wi))
        else:
            self.w = w
            self.swk = -_rowsum(sq.square(w))        # eq 9, precomputed

    def __call__(self, x) -> torch.Tensor:
        x = self._input(x)
        acc = sq.accum_dtype(x.dtype)
        xw = x.to(acc)
        sx = _rowsum(sq.square(xw))
        if self.complex_coeff:
            re = sq.halve(_rowsum(sq.pm(self.wr.to(acc), xw[None, :])) - sx
                          + self.swk_r)
            im = sq.halve(_rowsum(sq.pm(self.wi.to(acc), xw[None, :])) - sx
                          + self.swk_i)
            return join_planes(re, im)
        sab = _rowsum(sq.pm(self.w.to(acc), xw[None, :]))
        return sq.halve(sab - sx + self.swk)


class ComplexSquareTransform(_Engine):
    """Complex-coefficient transform of complex inputs (paper §7 CPM4,
    §10 CPM3)."""

    def __init__(self, w, *, mode: str = "cpm3", device: Device = None):
        if mode not in ("cpm4", "cpm3"):
            raise ValueError(f"mode must be cpm4|cpm3, got {mode!r}")
        self.mode = mode
        self.device = operand_device(w, device)
        self.c, self.s = split_planes(w, device=self.device)
        c, s = self.c, self.s
        if mode == "cpm4":
            # S_k = -sum_i (c^2 + s^2)  (eq 25); == -N for unit-modulus rows
            self.sk = -_rowsum(sq.square(c) + sq.square(s))
        else:
            # Sx_k / Sy_k (eqs 41 / 43)
            self.sxk = _rowsum(-sq.square(c) + sq.square(c + s))
            self.syk = _rowsum(-sq.square(c) - sq.square(s - c))

    def __call__(self, z) -> torch.Tensor:
        x, y = split_planes(self._input(z))
        acc = sq.accum_dtype(x.dtype)
        x, y = x.to(acc), y.to(acc)
        c, s = self.c.to(acc), self.s.to(acc)
        xb, yb = x[None, :], y[None, :]
        if self.mode == "cpm4":
            # eqs 24 / 26
            re2 = _rowsum(sq.pm(c, xb) + sq.pm_neg(s, yb))
            im2 = _rowsum(sq.pm(c, yb) + sq.pm(s, xb))
            sxy = -_rowsum(sq.square(x) + sq.square(y))      # eq 25, common
            re = sq.halve(re2 + sxy + self.sk)
            im = sq.halve(im2 + sxy + self.sk)
            return join_planes(re, im)
        # CPM3: eqs 40 / 42 with shared (c + x + y)^2
        shared = sq.cpm3_shared(xb, yb, c)
        re2 = _rowsum(sq.cpm3_real(xb, yb, c, s, shared=shared))
        im2 = _rowsum(sq.cpm3_imag(xb, yb, c, s, shared=shared))
        sxy = _rowsum(-sq.square(x + y) + sq.square(y))      # eq 41, common
        syx = _rowsum(-sq.square(x + y) - sq.square(x))      # eq 43, common
        re = sq.halve(re2 + sxy + self.sxk)
        im = sq.halve(im2 + syx + self.syk)
        return join_planes(re, im)
