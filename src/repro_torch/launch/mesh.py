"""Mesh builders: the PyTorch port of ``repro/launch/mesh.py``.

Functions, not module-level constants, so importing this module touches no
process group.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch.distributed as dist

from repro_torch.distributed.sharding import AbstractMesh

__all__ = ["make_production_mesh", "make_local_mesh", "make_mesh"]


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16 x 16 = 256 chips a pod; ``multi_pod`` stacks 2 pods = 512 chips,
    as an :class:`AbstractMesh` (names and sizes, no devices).

    Axes: ``pod`` (cross-pod data parallelism), ``data`` (in-pod data
    parallelism), ``model`` (tensor parallelism)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def _device_type(device_type: Optional[str]) -> str:
    if device_type is not None:
        return device_type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: Sequence[int], names: Sequence[str], *,
              device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` with dims ``names`` over the
    initialised process group's ranks.  ``device_type`` defaults to
    ``cuda`` under NCCL and ``cpu`` under gloo (whose tensors may still
    live on a GPU)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(device_type), tuple(shape),
                            mesh_dim_names=tuple(names))


def make_local_mesh(*, device_type: Optional[str] = None):
    """A 1D ``data`` ``DeviceMesh`` over every rank of the initialised
    process group; ``None`` in a single process (no group, or one
    rank)."""
    if not dist.is_available() or not dist.is_initialized() \
            or dist.get_world_size() == 1:
        return None
    return make_mesh((dist.get_world_size(),), ("data",),
                     device_type=device_type)
