"""The collectives the port writes by hand, as autograd functions over a
mesh axis: the counterpart of the ``psum`` / ``pmean`` calls inside the
JAX package's ``shard_map`` bodies.

Under a mesh every parameter is whole on every rank and each activation is
whole over ``model`` (``distributed/context.py``), so a tensor-parallel
contraction takes this rank's slice of its replicated operands and sums
the partial results over ``model``.  The transposes are Megatron's
conjugate pair:

- :func:`reduce_from` sums over the axis; its output is replicated, so its
  cotangent is already whole and passes through unchanged (a plain
  ``all_reduce``'s backward would sum it again, multiplying it by the axis
  size);
- :func:`slice_from` takes this rank's slice of a replicated tensor; its
  cotangent is gathered over the axis, so the gradient of the whole tensor
  is whole on every rank;
- :func:`copy_to` passes a replicated tensor that every rank reads whole
  into rank-local work; its cotangents are summed over the axis;
- :func:`mean_from` averages over the axis (the data-parallel ``pmean``);
  its cotangent is divided by the axis size, without a collective: the
  data-parallel gradient sum that follows adds the ranks' shares.

On an :class:`~repro_torch.distributed.sharding.AbstractMesh` (the dry
run) nothing is sent: the call is shape-only and may only see ``meta``
tensors.  Every call notes its kind and the bytes it moves with
:func:`note`, which the op-level analyzer
(:mod:`repro_torch.roofline.op_analysis`) reads.
"""
from __future__ import annotations

from typing import Callable, List

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import AbstractMesh, mesh_shape

__all__ = ["axis_size", "axis_index", "reduce_from", "slice_from",
           "copy_to", "mean_from", "all_reduce_", "note", "listen"]

_LISTENERS: List[Callable[[str, int], None]] = []


def listen(fn: Callable[[str, int], None]):
    """Add ``fn(kind, nbytes)`` to the listeners of every collective (and
    return a function that removes it)."""
    _LISTENERS.append(fn)
    return lambda: _LISTENERS.remove(fn)


def note(kind: str, t: torch.Tensor) -> None:
    """Tell the listeners that a collective of ``kind`` moved the bytes
    of ``t`` (the output operand, as JAX's collective byte count does)."""
    nbytes = t.numel() * t.element_size()
    for fn in list(_LISTENERS):
        fn(kind, nbytes)


def axis_size(mesh, axis: str) -> int:
    return mesh_shape(mesh).get(axis, 1)


def axis_index(mesh, axis: str) -> int:
    """This rank's index along ``axis`` (0 on an abstract mesh)."""
    if isinstance(mesh, AbstractMesh) or axis_size(mesh, axis) == 1:
        return 0
    return mesh.get_local_rank(axis)


def _abstract(mesh, t: torch.Tensor) -> bool:
    if not isinstance(mesh, AbstractMesh):
        return False
    if t.device.type != "meta":
        raise ValueError("an AbstractMesh runs no collective: only meta "
                         "tensors (the dry run) may pass through it")
    return True


def all_reduce_(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum ``t`` over ``axis`` in place (no autograd)."""
    note("all-reduce", t)
    if not _abstract(mesh, t) and axis_size(mesh, axis) > 1:
        dist.all_reduce(t, group=mesh.get_group(axis))
    return t


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce_(x.clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.mesh, ctx.axis), None, None


class _Mean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.n = axis_size(mesh, axis)
        return all_reduce_(x.clone(), mesh, axis) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


class _Slice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        n = axis_size(mesh, axis)
        ctx.mesh, ctx.axis, ctx.dim, ctx.n = mesh, axis, dim, n
        return x.chunk(n, dim)[axis_index(mesh, axis)].contiguous()

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.cat([g] * ctx.n, ctx.dim)
        note("all-gather", out)
        if not _abstract(ctx.mesh, g):
            parts = [torch.empty_like(g) for _ in range(ctx.n)]
            dist.all_gather(parts, g, group=ctx.mesh.get_group(ctx.axis))
            out = torch.cat(parts, ctx.dim)
        return out, None, None, None


def reduce_from(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``axis``; the cotangent passes unchanged."""
    if axis_size(mesh, axis) == 1:
        return x
    return _Reduce.apply(x, mesh, axis)


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x`` as it is; its cotangent is summed over ``axis``."""
    if axis_size(mesh, axis) == 1:
        return x
    return _Copy.apply(x, mesh, axis)


def mean_from(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The mean of ``x`` over ``axis``; the cotangent is divided by the
    axis size."""
    if axis_size(mesh, axis) == 1:
        return x
    return _Mean.apply(x, mesh, axis)


def slice_from(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's equal slice of ``x`` along ``dim`` (``x.shape[dim]``
    must divide by the axis size); the cotangent is gathered over
    ``axis``."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"over {axis} ({n})")
    return _Slice.apply(x, mesh, axis, dim)
