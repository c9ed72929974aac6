"""Parameter specification: the PyTorch port of ``repro/layers/param.py``.

Models are described as trees of :class:`ParamSpec` (shape, dtype,
initializer).  :func:`init_module` materialises a spec tree as nested
``nn.ModuleDict``/``nn.ParameterDict`` modules from a ``torch.Generator``.
The distributions are the JAX package's (scaled normal ``1/sqrt(fan_in)``,
zeros, ones); the bits differ, since the generators differ.  Parameters are
drawn on the CPU and then moved, so a seed gives the same weights on every
device.  Logical sharding axes are not carried: the port runs on one card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

__all__ = ["ParamSpec", "init_module", "torch_dtype"]


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config dtype name (``"bfloat16"``, ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"                     # normal | zeros | ones | embed
    fan_in: Optional[int] = None             # for scaled-normal init


def _materialize(spec: ParamSpec, gen: torch.Generator) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype)
    fan = spec.fan_in or (spec.shape[0] if spec.shape else 1)
    scale = 1.0 / math.sqrt(max(1, fan))
    return (torch.randn(spec.shape, generator=gen, dtype=torch.float32)
            * scale).to(spec.dtype)


def init_module(spec_tree: dict, gen: torch.Generator,
                device: torch.device) -> nn.Module:
    """Materialise a spec tree: a dict of specs becomes an
    ``nn.ParameterDict``, a dict of dicts an ``nn.ModuleDict``.  Parameters
    are inference weights (``requires_grad=False``)."""
    if all(isinstance(v, ParamSpec) for v in spec_tree.values()):
        return nn.ParameterDict({
            k: nn.Parameter(_materialize(s, gen).to(device),
                            requires_grad=False)
            for k, s in spec_tree.items()})
    if all(isinstance(v, dict) for v in spec_tree.values()):
        return nn.ModuleDict({k: init_module(v, gen, device)
                              for k, v in spec_tree.items()})
    raise ValueError(f"spec tree levels must hold only specs or only "
                     f"subtrees, got keys {sorted(spec_tree)}")
