"""Public wrappers around the square kernels: the PyTorch port of
``repro/kernels/ops.py``, matmul half.

The matmul prep is split into the paper's weight-stationary halves:
:func:`prepare_matmul_rhs` widens the column operand and computes ``Sb``
(the work a :class:`~repro_torch.core.prepared.PreparedOperand` keeps), and
:func:`_sq_matmul_exec` widens the activation, computes ``Sa`` and launches
K1.  Raw and prepared calls share both functions, so they are
bit-identical.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.core import squares as sq
from repro_torch.core.prepared import PreparedOperand
from repro_torch.device import resolve_device
from repro_torch.kernels.sq_matmul import sq_matmul_k1

__all__ = ["sq_matmul", "sq_matmul_local", "prepare_matmul_rhs"]


def prepare_matmul_rhs(b: torch.Tensor, acc: Optional[torch.dtype] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The column-operand half: ``b`` (k, n) widened to the accumulator
    dtype ``acc`` (default: ``b``'s own), contiguous, and its correction
    ``Sb`` (n,)."""
    bw = b.to(acc or sq.accum_dtype(b.dtype)).contiguous()
    return bw, sq.col_correction(bw, dim=0)


def _sq_matmul_exec(a: torch.Tensor, bw: torch.Tensor,
                    sb: torch.Tensor) -> torch.Tensor:
    """The execute half: stream the (m, k) activation against a prepared
    column operand through K1."""
    aw = a.to(bw.dtype).contiguous()
    return sq_matmul_k1(aw, bw, sq.row_correction(aw, dim=-1), sb)


def sq_matmul_local(a: torch.Tensor,
                    b: Union[torch.Tensor, PreparedOperand]) -> torch.Tensor:
    """``a[..., K] @ b[K, N]`` through K1 on the device ``a`` lies on.

    Leading dims of ``a`` collapse to rows (the dense-layer convention);
    returns the accumulator dtype (f32 for floats, int32 for small ints).
    """
    if isinstance(b, PreparedOperand):
        k, n = b.kn_shape
    else:
        if b.ndim == 3:
            raise NotImplementedError(
                "batched (B, K, N) square GEMMs run on K2/K3 "
                "(sq_matmul_batched_kernel / sq_matmul_folded_kernel), "
                "which this port does not have yet (ROADMAP Q2, next slice)")
        if b.ndim != 2:
            raise ValueError(f"rhs must be 2D (K, N), got {tuple(b.shape)}")
        k, n = b.shape
    if a.shape[-1] != k:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ "
                         f"({k}, {n})")
    lead = a.shape[:-1]
    a2 = a.reshape(-1, k)
    acc = sq.accum_dtype(a.dtype)
    if isinstance(b, PreparedOperand) and b.canon.dtype == acc:
        out = _sq_matmul_exec(a2, b.canon, b.corr)
    else:
        src = b.kn_source() if isinstance(b, PreparedOperand) else b
        out = _sq_matmul_exec(a2, *prepare_matmul_rhs(src, acc))
    return out.reshape(*lead, n)


def sq_matmul(a, b, *, device: Optional[Union[str, torch.device]] = None
              ) -> torch.Tensor:
    """Square-based matmul through K1 (public entry point).

    Runs on ``device`` (default: CUDA, which must be present); a CPU device
    runs K1's plain version.  ``b`` may be a PreparedOperand, which must
    already lie on that device.

    >>> a = torch.arange(6.0).reshape(2, 3)
    >>> b = torch.ones(3, 4)
    >>> torch.allclose(sq_matmul(a, b, device="cpu"), a @ b)
    True
    >>> ai = torch.tensor([[3, -7]], dtype=torch.int8)
    >>> bi = torch.tensor([[5], [2]], dtype=torch.int8)
    >>> int(sq_matmul(ai, bi, device="cpu")[0, 0])      # int8: bit-exact
    1
    """
    dev = resolve_device(device)
    a = torch.as_tensor(a).to(dev)
    if isinstance(b, PreparedOperand):
        if b.device != a.device:
            raise ValueError(f"prepared operand lies on {b.device}, the "
                             f"call runs on {a.device}")
    else:
        b = torch.as_tensor(b).to(dev)
    return sq_matmul_local(a, b)
