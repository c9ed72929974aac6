"""Square-based real matrix multiplication (paper §3): the PyTorch port of
``repro/core/matmul.py``.

    c_ij = 1/2 ( Sab_ij + Sa_i + Sb_j ),   Sab_ij = sum_k (a_ik + b_kj)^2

Modes (the JAX package's names and meanings):

``standard``        the multiplier baseline (``torch.matmul``);
``square_virtual``  the square-form contract through the multiplier
                    (``Sab = -Sa - Sb + 2 A@B``: x2 carry, then halving);
``square_exact``    every (i, k, j) square materialised -- the oracle;
``square_scan``     the same arithmetic streamed over K blocks;
``square_pallas``   the hand-written kernel mode: K1 (``csrc/sq_matmul.cu``;
                    K2/K3 for the batched contractions of ``fs_einsum``)
                    on CUDA tensors, the plain version on CPU tensors, or
                    the ``virtual`` form below the kernel-overhead floor
                    (:func:`repro_torch.kernels.routing.select_matmul_route`).

Integer operands (int8/int16) widen to int32 and every mode is exact.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import squares as sq
from repro_torch.core.prepared import PreparedOperand

__all__ = ["matmul", "pm_matmul_exact", "pm_matmul_scan", "pm_matmul_virtual",
           "pm_matmul_approx", "MODES", "set_default_mode",
           "get_default_mode"]

MODES = ("standard", "square_virtual", "square_exact", "square_scan",
         "square_pallas")

_DEFAULT_MODE = "standard"


def set_default_mode(mode: str) -> None:
    """Set the process default mode: the one a contraction runs in when
    neither its policy nor its caller names one."""
    global _DEFAULT_MODE
    if mode not in MODES:
        raise ValueError(f"unknown matmul mode {mode!r}; expected one of "
                         f"{MODES}")
    _DEFAULT_MODE = mode


def get_default_mode() -> str:
    return _DEFAULT_MODE


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32 matmul.  CUDA has no int32 ``torch.matmul``; there the product
    runs in float64, which is exact while every partial sum stays below
    2**53, then wraps to int32 like the CPU's integer matmul."""
    if a.device.type == "cuda":
        out = torch.matmul(a.double(), b.double())
        return out.to(torch.int64).to(torch.int32)
    return torch.matmul(a, b)


def _standard(a: torch.Tensor, b: torch.Tensor,
              preferred: Optional[torch.dtype]) -> torch.Tensor:
    dt = preferred or sq.accum_dtype(a.dtype)
    a, b = a.to(dt), b.to(dt)
    if dt.is_floating_point:
        return torch.matmul(a, b)
    return _int_matmul(a, b)


def pm_matmul_virtual(a: torch.Tensor, b: torch.Tensor,
                      preferred: Optional[torch.dtype] = None) -> torch.Tensor:
    """Square-form result through the multiplier: the corrections cancel,
    so only the x2 carry and the final halving are kept (bit-exact on the
    integer path)."""
    acc2 = _standard(a, b, preferred)
    acc2 = acc2 + acc2
    return sq.halve(acc2)


def pm_matmul_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Faithful emulation: materialises the (..., M, K, N) PM cube."""
    acc_dt = sq.accum_dtype(a.dtype)
    aw, bw = a.to(acc_dt), b.to(acc_dt)
    s = aw[..., :, :, None] + bw[..., None, :, :]
    sab = torch.sum(s * s, dim=-2, dtype=acc_dt)
    acc2 = sab + sq.row_correction(aw, dim=-1)[..., None] \
        + sq.col_correction(bw, dim=-2)[..., None, :]
    return sq.halve(acc2)


def pm_matmul_scan(a: torch.Tensor, b: torch.Tensor,
                   block: int = 16) -> torch.Tensor:
    """Streamed emulation: the accumulator starts at ``Sa_i + Sb_j`` (the
    paper's register preload) and ``block``-wide K slabs of squares stream
    in, keeping O(M*N*block) live memory."""
    acc_dt = sq.accum_dtype(a.dtype)
    aw, bw = a.to(acc_dt), b.to(acc_dt)
    k = aw.shape[-1]
    acc = sq.row_correction(aw, dim=-1)[..., None] \
        + sq.col_correction(bw, dim=-2)[..., None, :]
    for k0 in range(0, k, max(1, block)):
        s = aw[..., :, k0:k0 + block, None] + bw[..., None, k0:k0 + block, :]
        acc = acc + torch.sum(s * s, dim=-2, dtype=acc_dt)
    return sq.halve(acc)


def pm_matmul_approx(a: torch.Tensor, b: torch.Tensor, *, drop_bits: int = 4,
                     block: int = 128) -> torch.Tensor:
    """Square-based matmul with approximate squarers (paper conclusion).

    The streaming structure of :func:`pm_matmul_scan`, with every square --
    PM terms and corrections alike -- through
    :func:`~repro_torch.core.squares.square_approx`: a datapath built from
    truncated squarer circuits."""
    acc_dt = sq.accum_dtype(a.dtype)
    aw, bw = a.to(acc_dt), b.to(acc_dt)

    def sqx(t):
        return sq.square_approx(t, drop_bits=drop_bits)

    acc = (-sq.acc_sum(sqx(aw), -1))[..., None] + (-sq.acc_sum(sqx(bw), 0))
    for k0 in range(0, aw.shape[-1], max(1, block)):
        s = aw[..., :, k0:k0 + block, None] + bw[None, k0:k0 + block, :]
        acc = acc + sq.acc_sum(sqx(s), -2).to(acc_dt)
    return sq.halve(acc)


def matmul(a: torch.Tensor, b, *, mode: Optional[str] = None,
           preferred: Optional[torch.dtype] = None) -> torch.Tensor:
    """Dense contraction ``a[..., K] @ b[K, N]`` under a fair-square mode.

    ``b`` may be a :class:`~repro_torch.core.prepared.PreparedOperand`: the
    non-kernel modes use its raw source (bit-identical to raw dispatch) and
    ``square_pallas`` reuses its widened weight and ``Sb``.
    """
    prep = b if isinstance(b, PreparedOperand) else None
    if prep is not None and prep.kind != "matmul":
        raise ValueError(f"matmul got a {prep.kind!r} PreparedOperand")
    b_shape = prep.kn_shape if prep is not None else tuple(b.shape)
    if len(b_shape) != 2:
        raise ValueError(f"rhs must be 2D (K, N), got {tuple(b_shape)}")
    if a.shape[-1] != b_shape[0]:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b_shape)}")
    b_arr = (lambda: prep.kn_source()) if prep is not None else (lambda: b)
    mode = mode or _DEFAULT_MODE
    if mode == "standard":
        return _standard(a, b_arr(), preferred)
    if mode == "square_virtual":
        return pm_matmul_virtual(a, b_arr(), preferred)
    if mode == "square_exact":
        return pm_matmul_exact(a, b_arr())
    if mode == "square_scan":
        return pm_matmul_scan(a, b_arr())
    if mode == "square_pallas":
        from repro_torch.kernels import ops as kops      # lazy: import cycle
        from repro_torch.kernels import routing
        m_rows = a.numel() // max(1, a.shape[-1])
        route = routing.select_matmul_route(m_rows, b_shape[1], b_shape[0],
                                            dtype=a.dtype)
        if route.name == "virtual":
            return pm_matmul_virtual(a, b_arr(), preferred)
        return kops.sq_matmul_local(a, b)
    raise ValueError(f"unknown matmul mode {mode!r}; expected one of {MODES}")
