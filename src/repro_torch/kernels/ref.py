"""Plain oracles of the port's kernels: the PyTorch port of
``repro/kernels/ref.py``.

:func:`sq_matmul_ref` is the ground truth of ``ops.sq_matmul`` (K1, K2 and
K3): the faithful square-form matmul of ``core/matmul.py``, which
materialises every PM term and batches over any leading axes.
:func:`sq_conv_ref` is that of ``ops.sq_conv`` (K8): the square-mode
correlation of ``core/conv.py``.  :func:`cpm3_matmul_ref` is that of
``ops.cpm3_matmul`` (K5): the CPM3 matmul of ``core/complexmm.py``, planes
out.
"""
from __future__ import annotations

import torch

from repro_torch.core.complexmm import cpm3_matmul
from repro_torch.core.conv import correlate1d
from repro_torch.core.matmul import pm_matmul_exact

__all__ = ["sq_matmul_ref", "cpm3_matmul_ref", "sq_conv_ref"]


def sq_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Oracle of ``kernels.ops.sq_matmul``: ``a`` (m, k) @ ``b`` (k, n), or
    (B, m, k) @ (B, k, n), as the exact square-based matmul."""
    return pm_matmul_exact(a, b)


def cpm3_matmul_ref(x, y):
    """Oracle of ``kernels.ops.cpm3_matmul``: the (re, im) planes of the
    CPM3 matmul, every term materialised."""
    return cpm3_matmul(x, y, planes_out=True)


def sq_conv_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Oracle of ``kernels.ops.sq_conv``: the valid square-based
    correlation."""
    return correlate1d(x, w, mode="square")
