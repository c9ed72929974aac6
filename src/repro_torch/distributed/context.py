"""Process-global mesh context: the PyTorch port of
``repro/distributed/context.py``.

The model code is mesh-agnostic; the blocks that write collectives by hand
(the TP reduce of ``layers/basic.py::dense_tp_reduce``, the MoE's
model-axis combine, the train step's data-parallel reduce) discover the
active mesh here.  ``use_mesh`` is entered by the launcher, the dry run or
a test around a step.

Under a mesh with a data axis larger than 1, every activation is the
rank's own batch shard (the caller splits the batch with
``sharding.shard_batch``) and every parameter is whole on every rank: the
port has no SPMD partitioner, so what the JAX package leaves to GSPMD runs
replicated over ``model``.
"""
from __future__ import annotations

import contextlib

__all__ = ["current_mesh", "use_mesh"]

_MESH = None


def current_mesh():
    return _MESH


@contextlib.contextmanager
def use_mesh(mesh):
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield mesh
    finally:
        _MESH = prev
