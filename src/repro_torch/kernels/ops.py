"""Public wrappers around the square kernels: the PyTorch port of
``repro/kernels/ops.py``, matmul half.

The matmul prep is split into the paper's weight-stationary halves:
:func:`prepare_matmul_rhs` widens the column operand and computes ``Sb``
(the work a :class:`~repro_torch.core.prepared.PreparedOperand` keeps), and
:func:`_sq_matmul_exec` / :func:`_sq_matmul_batched_exec` widen the
activation, compute ``Sa`` and launch K1 / K2 or K3.  Raw and prepared
calls share these functions, so they are bit-identical.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.core import squares as sq
from repro_torch.core.prepared import PreparedOperand
from repro_torch.device import resolve_device
from repro_torch.kernels.sq_matmul import (sq_matmul_k1, sq_matmul_k2,
                                           sq_matmul_k3)

__all__ = ["sq_matmul", "sq_matmul_local", "prepare_matmul_rhs"]


def prepare_matmul_rhs(b: torch.Tensor, acc: Optional[torch.dtype] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The column-operand half: ``b`` (k, n) or (B, k, n) widened to the
    accumulator dtype ``acc`` (default: ``b``'s own), contiguous, and its
    correction ``Sb`` (n,) or (B, n)."""
    bw = b.to(acc or sq.accum_dtype(b.dtype)).contiguous()
    return bw, sq.col_correction(bw, dim=-2)


def _sq_matmul_exec(a: torch.Tensor, bw: torch.Tensor,
                    sb: torch.Tensor) -> torch.Tensor:
    """The execute half: stream the (m, k) activation against a prepared
    column operand through K1."""
    aw = a.to(bw.dtype).contiguous()
    return sq_matmul_k1(aw, bw, sq.row_correction(aw, dim=-1), sb)


def _sq_matmul_batched_exec(a: torch.Tensor, bw: torch.Tensor,
                            sb: torch.Tensor, fold: bool) -> torch.Tensor:
    """The execute half of a batched GEMM: widen the (B, m, k) activation,
    compute ``Sa`` (B, m) and run K3 (``fold``) or K2 against the prepared
    ``(bw, sb)``.

    The JAX package's fold width (``_pick_fb``, ``FOLD_ROW_TARGET``) and its
    zero batch padding are Pallas tiling.  Here the number of elements a
    block folds is K3's own launch geometry, and a ragged batch, m, n and k
    are masked inside both kernels, so nothing is padded on the host."""
    aw = a.to(bw.dtype).contiguous()
    kernel = sq_matmul_k3 if fold else sq_matmul_k2
    return kernel(aw, bw, sq.row_correction(aw, dim=-1), sb)


def sq_matmul_local(a: torch.Tensor,
                    b: Union[torch.Tensor, PreparedOperand], *,
                    fold: bool = False) -> torch.Tensor:
    """``a[..., K] @ b[K, N]`` through K1, or ``a[B, M, K] @ b[B, K, N]``
    through K2 (K3 with ``fold``), on the device ``a`` lies on.

    Against a 2D ``b``, leading dims of ``a`` collapse to rows (the
    dense-layer convention).  Returns the accumulator dtype (f32 for
    floats, int32 for small ints).
    """
    if isinstance(b, PreparedOperand):
        k, n = b.kn_shape
    elif b.ndim == 3:
        if a.ndim != 3 or a.shape[0] != b.shape[0] \
                or a.shape[2] != b.shape[1]:
            raise ValueError(f"batched contraction mismatch: "
                             f"{tuple(a.shape)} @ {tuple(b.shape)}")
        return _sq_matmul_batched_exec(
            a, *prepare_matmul_rhs(b, sq.accum_dtype(a.dtype)), fold)
    else:
        if b.ndim != 2:
            raise ValueError(f"rhs must be 2D (K, N) or batched 3D "
                             f"(B, K, N), got {tuple(b.shape)}")
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


def sq_matmul(a, b, *, fold: bool = False,
              device: Optional[Union[str, torch.device]] = None
              ) -> torch.Tensor:
    """Square-based matmul through K1, or K2/K3 (public entry point).

    ``a`` (m, k) @ ``b`` (k, n) runs K1; ``a`` (B, m, k) @ ``b`` (B, k, n)
    runs K2, or K3 with ``fold=True`` (the small-(m, n), large-B route of
    :mod:`repro_torch.kernels.routing`).  Runs on ``device`` (default:
    CUDA, which must be present); a CPU device runs the kernels' plain
    version.  ``b`` may be a 2D PreparedOperand, which must already lie on
    that device.

    >>> a = torch.arange(6.0).reshape(2, 3)
    >>> b = torch.ones(3, 4)
    >>> torch.allclose(sq_matmul(a, b, device="cpu"), a @ b)
    True
    >>> ai = torch.tensor([[3, -7]], dtype=torch.int8)
    >>> bi = torch.tensor([[5], [2]], dtype=torch.int8)
    >>> int(sq_matmul(ai, bi, device="cpu")[0, 0])      # int8: bit-exact
    1
    >>> a3, b3 = torch.ones(4, 2, 3), torch.ones(4, 3, 5)
    >>> tuple(sq_matmul(a3, b3, fold=True, device="cpu").shape)
    (4, 2, 5)
    """
    dev = resolve_device(device)
    a = torch.as_tensor(a).to(dev)
    if isinstance(b, PreparedOperand):
        if b.device != a.device:
            raise ValueError(f"prepared operand lies on {b.device}, the "
                             f"call runs on {a.device}")
    else:
        b = torch.as_tensor(b).to(dev)
    return sq_matmul_local(a, b, fold=fold)
