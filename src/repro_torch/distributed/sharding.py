"""Logical-axis sharding rules (MaxText-style) with automatic rule
dropping: the PyTorch port of ``repro/distributed/sharding.py``.

Each parameter carries logical axis names (``layers/param.py``); the rules
below map them to mesh axes.  A rule is dropped for a tensor dim when the
dim's size is not divisible by the mesh axis's size -- so kv_heads = 1
(paligemma, recurrentgemma) or 8-head attention on a 16-way model axis fall
back to replication while vocab and mlp stay sharded.

A spec is JAX's ``PartitionSpec`` as a tuple: one entry a tensor dim, a
mesh-axis name, a tuple of names, or ``None`` (replicated).  A
:class:`Sharding` pairs it with its mesh and gives the per-device shape and
the ``torch.distributed.tensor`` placements (``Shard(d)`` /
``Replicate()``, one a mesh dim).  A mesh is a ``DeviceMesh`` with named
dims or an :class:`AbstractMesh` (names and sizes, no devices, JAX's
``AbstractMesh``), which is how the 16 x 16 and 2 x 16 x 16 production
meshes exist on one card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.layers.param import ParamSpec, spec_map

__all__ = ["LOGICAL_RULES", "AbstractMesh", "Sharding", "mesh_shape",
           "logical_to_spec", "param_shardings", "zero1_shardings",
           "input_shardings", "act_spec", "constrain", "shard_shape",
           "param_bytes_per_device", "data_axes", "shard_batch"]

# logical axis -> mesh axis (the first rule whose mesh axis divides the dim
# wins); JAX's table, entry for entry
LOGICAL_RULES: Tuple[Tuple[str, Optional[object]], ...] = (
    ("vocab", "model"),
    ("mlp", "model"),
    ("q_heads", "model"),       # flattened heads*head_dim projections
    ("kv_proj", "model"),
    # the expert axis is not sharded: MoE experts run tensor-parallel on
    # their hidden (mlp) axis (models/blocks.py::_apply_moe)
    ("expert", None),
    ("rnn", "model"),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("head_dim", None),         # never split a head across devices
    ("batch", ("pod", "data")),
    ("q_chunks", "model"),      # folded attention q-chunk axis
    ("embed", None),
    ("layers", None),
    ("seq", None),
    ("conv", None),
)

_RULES = dict(LOGICAL_RULES)


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh of named axes and sizes with no devices.

    >>> m = AbstractMesh((16, 16), ("data", "model"))
    >>> m.shape["model"], m.size
    (16, 256)
    """
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of an :class:`AbstractMesh` or a named
    ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    names = mesh.mesh_dim_names
    if not names:
        raise ValueError("a DeviceMesh needs mesh_dim_names for the "
                         "sharding rules")
    return dict(zip(names, tuple(mesh.mesh.shape)))


def _axis_size(shape: Dict[str, int], axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(shape[a] for a in axis if a in shape)
    return shape.get(axis, 1)


def _entry(axes: Tuple[str, ...]):
    """A spec entry of mesh axes: None, one name, or a tuple of two or
    more (JAX's ``PartitionSpec`` stores a 1-tuple as its name)."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def _mesh_axis(shape: Dict[str, int], logical):
    """The mesh axis (or tuple of axes) of a logical axis on this mesh, or
    None."""
    mesh_ax = _RULES.get(logical) if logical is not None else None
    if isinstance(mesh_ax, tuple):
        return _entry(tuple(a for a in mesh_ax if a in shape))
    return mesh_ax if mesh_ax in shape else None


def data_axes(mesh) -> Tuple[str, ...]:
    """The mesh's data axes, ``pod`` then ``data``, those it has."""
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def logical_to_spec(mesh, shape, axes) -> tuple:
    """The spec of one tensor, dropping indivisible rules and any mesh
    axis an earlier dim already took."""
    mshape = mesh_shape(mesh)
    used = set()
    entries = []
    for dim, ax in zip(shape, axes):
        mesh_ax = _mesh_axis(mshape, ax)
        if mesh_ax is None:
            entries.append(None)
            continue
        flat = mesh_ax if isinstance(mesh_ax, tuple) else (mesh_ax,)
        if dim % _axis_size(mshape, mesh_ax) != 0 \
                or any(a in used for a in flat):
            entries.append(None)          # drop the rule: replicate
            continue
        used.update(flat)
        entries.append(mesh_ax)
    return tuple(entries)


def shard_shape(mesh, shape, spec) -> Tuple[int, ...]:
    """The per-device shape of a tensor of ``shape`` under ``spec``
    (JAX's ``NamedSharding.shard_shape``)."""
    mshape = mesh_shape(mesh)
    out = []
    for i, dim in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        n = _axis_size(mshape, ax)
        if dim % n:
            raise ValueError(f"dim {i} of {tuple(shape)} ({dim}) does not "
                             f"divide over {ax} ({n})")
        out.append(dim // n)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a mesh (JAX's ``NamedSharding``)."""
    mesh: object
    spec: tuple

    def shard_shape(self, shape) -> Tuple[int, ...]:
        return shard_shape(self.mesh, shape, self.spec)

    @property
    def placements(self) -> list:
        """One ``torch.distributed.tensor`` placement a mesh dim:
        ``Shard(d)`` where the spec puts that mesh axis on tensor dim
        ``d``, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for name in mesh_shape(self.mesh):
            dims = [d for d, e in enumerate(self.spec)
                    if e == name or (isinstance(e, tuple) and name in e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return out


def param_shardings(mesh, spec_tree):
    """The :class:`Sharding` of each tensor of a ParamSpec tree."""
    return spec_map(lambda s: Sharding(
        mesh, logical_to_spec(mesh, s.shape, s.axes)), spec_tree)


def act_spec(mesh, *axes) -> tuple:
    """The spec of an activation given a logical axis a dim."""
    mshape = mesh_shape(mesh)
    entries = []
    used = set()
    for ax in axes:
        mesh_ax = _mesh_axis(mshape, ax)
        flat = (mesh_ax,) if isinstance(mesh_ax, str) else (mesh_ax or ())
        if mesh_ax is not None and not any(a in used for a in flat):
            used.update(flat)
            entries.append(mesh_ax)
        else:
            entries.append(None)
    return tuple(entries)


def zero1_shardings(mesh, spec_tree):
    """ZeRO-1 optimizer-state sharding: each m / v tensor keeps its
    param's model-axis sharding and also shards its largest
    still-replicated dim divisible by the data size over the data axes."""
    daxes = data_axes(mesh)
    dsize = _axis_size(mesh_shape(mesh), daxes) if daxes else 1

    def one(s: ParamSpec):
        spec = list(logical_to_spec(mesh, s.shape, s.axes))
        if dsize > 1:
            cands = [(d, i) for i, d in enumerate(s.shape)
                     if spec[i] is None and d % dsize == 0 and d >= dsize]
            if cands:
                _, i = max(cands)
                spec[i] = _entry(daxes)
        return Sharding(mesh, tuple(spec))

    return spec_map(one, spec_tree)


def input_shardings(mesh, batch_tree):
    """Batch inputs: the leading batch dim over the data axes when it
    divides, everything else replicated."""
    daxes = data_axes(mesh)
    size = _axis_size(mesh_shape(mesh), daxes) if daxes else 1

    def one(x):
        shape = tuple(x.shape)
        if shape and size > 1 and shape[0] % size == 0:
            return Sharding(mesh,
                            (_entry(daxes),) + (None,) * (len(shape) - 1))
        return Sharding(mesh, (None,) * len(shape))
    return tree_map(one, batch_tree)


def param_bytes_per_device(mesh, spec_tree) -> int:
    """Bytes of one device's shard of every parameter."""
    total = 0
    for s, sh in zip(tree_leaves(spec_tree),
                     tree_leaves(param_shardings(mesh, spec_tree))):
        total += math.prod(sh.shard_shape(s.shape)) * s.dtype.itemsize
    return total


def _data_index(mesh) -> int:
    """This rank's index over the data axes (``pod`` major) of a
    ``DeviceMesh``."""
    idx = 0
    for a in data_axes(mesh):
        idx = idx * mesh_shape(mesh)[a] + mesh.get_local_rank(a)
    return idx


def shard_batch(mesh, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """This rank's shard of each batch input under
    :func:`input_shardings` (the whole input where its batch does not
    divide); an :class:`AbstractMesh` keeps the first shard's shape."""
    shards = input_shardings(mesh, batch)
    if isinstance(mesh, AbstractMesh):
        idx = 0
    else:
        idx = _data_index(mesh)
    out = {}
    for k, x in batch.items():
        n = x.shape[0] // shards[k].shard_shape(x.shape)[0] if x.ndim else 1
        if n == 1:
            out[k] = x
        else:
            b = x.shape[0] // n
            out[k] = x[idx * b:(idx + 1) * b]
    return out


def constrain(x: torch.Tensor, mesh, *axes) -> torch.Tensor:
    """JAX's ``with_sharding_constraint`` on logical activation axes.  The
    port has no SPMD partitioner that could act on it: under a mesh each
    rank holds its own batch shard and the rest whole
    (``distributed/context.py``), which every constraint of the model
    admits.  So this checks that the constraint names a known logical axis
    (or None) for at most each dim of ``x`` (trailing dims left out are
    replicated, as in a short ``PartitionSpec``) and returns ``x``
    unchanged."""
    if mesh is None:
        return x
    if len(axes) > x.ndim:
        raise ValueError(f"constraint {axes} has {len(axes)} axes, the "
                         f"tensor {tuple(x.shape)} {x.ndim}")
    unknown = [a for a in axes if a is not None and a not in _RULES]
    if unknown:
        raise ValueError(f"unknown logical axes {unknown}")
    return x
