"""Weight-stationary prepared operands (paper §4-§5): the PyTorch port of
``repro/core/prepared.py``, matmul half.

A weight used by many calls has its constant half of the kernel prep done
once: the widened weight in the canonical ``(K, N)`` layout and its column
correction ``Sb_j = -sum_k b_kj^2``.  Raw-array dispatch runs the same prep
function per call (:func:`repro_torch.kernels.ops.prepare_matmul_rhs`), so
prepared and raw results are bit-identical by construction.

There is no tile padding: K1 masks ragged edges itself.  ``transposed``
records that the call site contracts the weight's last axis (the tied
vocab GEMM ``bsd,vd->bsv``); the transpose is materialised once, here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["PreparedOperand", "prepare_operand", "unwrap"]


@dataclasses.dataclass
class PreparedOperand:
    """A constant matmul operand with its kernel prep precomputed."""
    source: torch.Tensor            # original weight, caller layout
    canon: torch.Tensor             # widened (K, N), contiguous
    corr: torch.Tensor              # Sb, (N,)
    transposed: bool                # canon built from source.T
    site: Optional[str] = None

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.source.shape)

    @property
    def device(self) -> torch.device:
        return self.source.device

    @property
    def kn_shape(self) -> Tuple[int, int]:
        """The ``(K, N)`` shape the contraction sees."""
        return tuple(self.canon.shape)

    def kn_source(self) -> torch.Tensor:
        """The raw source in ``(K, N)`` orientation (non-kernel modes)."""
        return self.source.T if self.transposed else self.source


def unwrap(x):
    """The raw source of a PreparedOperand (identity otherwise)."""
    return x.source if isinstance(x, PreparedOperand) else x


def prepare_operand(w, *, transpose: bool = False,
                    site: Optional[str] = None) -> PreparedOperand:
    """Precompute the constant-operand half of the K1 prep.

    ``w``: a 2D ``(K, N)`` weight (``(N, K)`` with ``transpose=True``).
    Idempotent on an already-prepared operand.  Batched ``(B, K, N)``
    weights (the MoE experts) are not prepared yet: attention's batched
    operands are activations, prepared per call inside ``ops``.
    """
    if isinstance(w, PreparedOperand):
        return w
    if w.ndim != 2:
        raise NotImplementedError(
            f"prepare_operand takes a 2D (K, N) weight, got {tuple(w.shape)}; "
            f"the batched (B, K, N) prep of the MoE expert weights comes "
            f"with the MoE slice (ROADMAP Q1, slice 5)")
    from repro_torch.kernels import ops as kops          # lazy: import cycle
    mat = w.T if transpose else w
    canon, corr = kops.prepare_matmul_rhs(mat)
    return PreparedOperand(w, canon, corr, transpose, site)
