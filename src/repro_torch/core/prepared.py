"""Weight-stationary prepared operands (paper §4-§5): the PyTorch port of
``repro/core/prepared.py``.

A weight used by many calls has its constant half of the kernel prep done
once: the widened weight in the canonical ``(K, N)`` layout and its column
correction ``Sb_j = -sum_k b_kj^2``.  A batched ``(B, K, N)`` weight (the
MoE expert stack, ``kind="matmul_batched"``) keeps ``canon`` ``(B, K, N)``
and ``corr`` ``(B, N)``, which K2/K3 stream.  Raw-array dispatch runs the
same prep function per call
(:func:`repro_torch.kernels.ops.prepare_matmul_rhs`), so prepared and raw
results are bit-identical by construction.

There is no tile padding: K1 masks ragged edges itself, and the launch
plan is resolved at each launch (:func:`clear_plan_cache` drops its memo).  ``transposed``
records that the call site contracts the weight's last axis (the tied
vocab GEMM ``bsd,vd->bsv``); the transpose is materialised once, here.
``prepare_grads=True`` also prepares the same source in the opposite
layout, on the ``grad`` field, which the ``fs_einsum`` VJP contracts for
dL/dx.

A conv2d prepare (``for_="conv2d"``) holds what both conv routes stream
(:func:`repro_torch.kernels.ops.prepare_conv2d_weights`): in ``canon`` the
widened filters as K7's ``(kh*kw*cin, cout)`` tap matrix, K ordered
(kh, kw, cin); in ``im2col`` the same filters as the im2col route's
``(cin*kh*kw, cout)`` K1 operand; and in ``corr`` the per-filter correction
``Sw_f = -sum_{c,i,j} w^2``, which is also that matrix's column correction.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["PreparedOperand", "prepare_operand", "unwrap", "is_prepared",
           "clear_plan_cache"]


@dataclasses.dataclass
class PreparedOperand:
    """A constant matmul or conv2d operand with its kernel prep
    precomputed."""
    source: torch.Tensor            # original weight, caller layout
    canon: torch.Tensor             # widened (K, N) or (B, K, N), contiguous
    corr: torch.Tensor              # Sb or Sw: (N,), batched (B, N)
    transposed: bool                # canon built from source.T
    site: Optional[str] = None
    kind: str = "matmul"            # "matmul" | "matmul_batched" | "conv2d"
    im2col: Optional[torch.Tensor] = None   # conv2d: (cin*kh*kw, cout)
    grad: Optional["PreparedOperand"] = None    # dL/dx layout (VJP)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.source.shape)

    @property
    def device(self) -> torch.device:
        return self.source.device

    @property
    def kn_shape(self) -> Tuple[int, int]:
        """The ``(K, N)`` shape the contraction sees (of each batch element
        of a batched operand)."""
        return tuple(self.canon.shape[-2:])

    def kn_source(self) -> torch.Tensor:
        """The raw source in ``(K, N)`` (or ``(B, K, N)``) orientation
        (non-kernel modes)."""
        return self.source.transpose(-1, -2) if self.transposed \
            else self.source


def unwrap(x):
    """The raw source of a PreparedOperand (identity otherwise)."""
    return x.source if isinstance(x, PreparedOperand) else x


def is_prepared(x) -> bool:
    return isinstance(x, PreparedOperand)


def clear_plan_cache() -> None:
    """Drop the planner's memo of launch plans and cached routes
    (:mod:`repro_torch.kernels.tuning`): each is resolved again, from the
    tuning cache or the model, at its next launch.  A prepared operand
    holds no plan of its own (no tile padding), so nothing else is kept."""
    from repro_torch.kernels import tuning   # lazy: kernels import this
    tuning.clear_memo()


def prepare_operand(w, *, for_: str = "matmul", transpose: bool = False,
                    site: Optional[str] = None,
                    prepare_grads: bool = False) -> PreparedOperand:
    """Precompute the constant-operand half of the K1 or conv prep.

    ``for_="matmul"``: ``w`` is a 2D ``(K, N)`` weight (``(N, K)`` with
    ``transpose=True``), or a batched ``(B, K, N)`` one (the MoE expert
    stack, ``kind="matmul_batched"``), each batch element prepared as a 2D
    weight is.  ``for_="conv2d"``: ``w`` is a
    ``(cout, cin, kh, kw)`` filter bank, or a rank shorthand of
    :func:`repro_torch.core.conv.normalize_conv2d`.  Idempotent on an
    already-prepared operand.

    ``prepare_grads`` (2D matmul only): also prepare the opposite-layout
    form of the same source under ``<site>.bwd_x`` on the ``grad`` field,
    which the ``fs_einsum`` VJP contracts for dL/dx.

    >>> gp = prepare_operand(torch.ones(5, 7), site="dense",
    ...                      prepare_grads=True)
    >>> gp.grad.transposed, gp.grad.site, gp.grad.kn_shape
    (True, 'dense.bwd_x', (7, 5))
    >>> ep = prepare_operand(torch.ones(3, 5, 7, dtype=torch.bfloat16))
    >>> ep.kind, tuple(ep.canon.shape), ep.canon.dtype, tuple(ep.corr.shape)
    ('matmul_batched', (3, 5, 7), torch.float32, (3, 7))
    """
    if isinstance(w, PreparedOperand):
        return w
    if for_ == "conv2d":
        from repro_torch.core.conv import filters4
        from repro_torch.kernels import ops as kops      # lazy: import cycle
        w4 = filters4(w)
        canon, corr, im2col = kops.prepare_conv2d_weights(w4)
        return PreparedOperand(w, canon, corr, False, site, kind="conv2d",
                               im2col=im2col)
    if for_ != "matmul":
        raise ValueError(f"unknown prepare target {for_!r}; expected "
                         f"'matmul' or 'conv2d'")
    if w.ndim not in (2, 3):
        raise ValueError(f"prepare_operand takes a 2D (K, N) or batched "
                         f"(B, K, N) weight, got {tuple(w.shape)}")
    from repro_torch.kernels import ops as kops          # lazy: import cycle
    batched = w.ndim == 3
    mat = w.transpose(-1, -2) if transpose else w
    canon, corr = kops.prepare_matmul_rhs(mat)
    # dL/dx of a batched prep contracts its raw source, as in the JAX
    # package: the batched kernel route takes (B, K, N)-layout preps only
    gradp = None
    if prepare_grads and not batched:
        gradp = prepare_operand(w, transpose=not transpose,
                                site=f"{site}.bwd_x" if site else None)
    return PreparedOperand(w, canon, corr, transpose, site,
                           kind="matmul_batched" if batched else "matmul",
                           grad=gradp)
