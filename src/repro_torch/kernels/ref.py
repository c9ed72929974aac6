"""Plain oracles of the port's kernels: the PyTorch port of
``repro/kernels/ref.py``, matmul half.

:func:`sq_matmul_ref` is the ground truth of ``ops.sq_matmul`` (K1, K2 and
K3): the faithful square-form matmul of ``core/matmul.py``, which
materialises every PM term and batches over any leading axes.
"""
from __future__ import annotations

import torch

from repro_torch.core.matmul import pm_matmul_exact

__all__ = ["sq_matmul_ref"]


def sq_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Oracle of ``kernels.ops.sq_matmul``: ``a`` (m, k) @ ``b`` (k, n), or
    (B, m, k) @ (B, k, n), as the exact square-based matmul."""
    return pm_matmul_exact(a, b)
