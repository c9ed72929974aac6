"""Shape-only launches of the square kernels on the ``meta`` device.

Each kernel wrapper (K1-K8) has a ``meta`` branch: given ``meta`` tensors
it returns an empty output of the kernel's shape and dtype, launches
nothing, and records the launch here -- the kernel, its shape, the square
terms it computes, the work it replaces in FLOPs and its
:class:`~repro_torch.core.cost_model.LaunchCost` (FP32 or INT32 issue
slots and bytes) at the plan the planner gives that shape.  The op-level
analyzer (:mod:`repro_torch.roofline.op_analysis`) reads the records.
The branch is taken only inside an open :func:`recording` (the
analyzer opens one): the caller asks for it.  Outside one, a wrapper
given ``meta`` tensors refuses them as it refuses any device other than
the CPU or CUDA; it never falls back to this branch.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, List, Tuple

import torch

from repro_torch.core.cost_model import LaunchCost

__all__ = ["MetaLaunch", "active", "record", "recording"]


@dataclasses.dataclass(frozen=True)
class MetaLaunch:
    kernel: str              # "K1" .. "K8"
    shape: Tuple[int, ...]   # the kernel's shape key, as its ``.shapes``
    terms: float             # square terms computed
    flops: float             # FLOPs of the contraction it replaces
    cost: LaunchCost         # slots (padded tiles) and bytes
    int_path: bool           # int32 operands: the slots are INT32


_RECORDS: List[List[MetaLaunch]] = []


def active() -> bool:
    """True inside a :func:`recording`: the wrappers' ``meta`` branches
    are open."""
    return bool(_RECORDS)


def record(kernel: str, shape, terms: float, flops: float,
           cost: LaunchCost, dtype: torch.dtype) -> None:
    """Note one shape-only launch into every open :func:`recording`."""
    launch = MetaLaunch(kernel, tuple(shape), float(terms), float(flops),
                        cost, not dtype.is_floating_point)
    for rec in _RECORDS:
        rec.append(launch)


@contextlib.contextmanager
def recording() -> Iterator[List[MetaLaunch]]:
    """The list of the launches the ``meta`` branches record inside."""
    rec: List[MetaLaunch] = []
    _RECORDS.append(rec)
    try:
        yield rec
    finally:
        _RECORDS.remove(rec)
