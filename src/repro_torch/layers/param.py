"""Parameter specification: the PyTorch port of ``repro/layers/param.py``.

Models are described as trees of :class:`ParamSpec` (shape, logical axes,
dtype, initializer): nested dicts, and lists of per-layer subtrees where
the JAX package stacks layers.  From one spec tree:

- :func:`init_module` materialises it as nested ``nn.ModuleDict`` /
  ``nn.ParameterDict`` modules from a ``torch.Generator``.  The
  distributions are the JAX package's (scaled normal ``1/sqrt(fan_in)``,
  zeros, ones); the bits differ, since the generators differ.  Parameters
  are drawn on the CPU and then moved, so a seed gives the same weights on
  every device; on the ``meta`` device nothing is drawn.
- :func:`abstract_tree` gives ``device="meta"`` tensors of each spec's
  shape and dtype (the dry run never allocates a parameter).
- :func:`axes_tree` gives the logical axis names of each tensor, which
  :mod:`repro_torch.distributed.sharding` maps to mesh axes.
- :func:`count_params` counts the parameters (MODEL_FLOPS = 6 * N * D).

Logical axis vocabulary (``distributed/sharding.py`` holds the rules):
``batch, seq, embed, mlp, heads, kv_heads, head_dim, q_heads, kv_proj,
vocab, expert, layers, conv, rnn, q_chunks``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.core.tree import tree_leaves

__all__ = ["ParamSpec", "init_module", "abstract_tree", "axes_tree",
           "count_params", "spec_map", "is_spec", "torch_dtype"]


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config dtype name (``"bfloat16"``, ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]          # logical axis per dim
    dtype: torch.dtype = torch.float32
    init: str = "normal"                     # normal | zeros | ones | embed
    fan_in: Optional[int] = None             # for scaled-normal init

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"ParamSpec shape {self.shape} and axes "
                             f"{self.axes} differ in rank")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def spec_map(fn, spec_tree):
    """``fn`` applied to every :class:`ParamSpec` of a spec tree (dicts
    and lists), keeping the tree's structure and key order."""
    if isinstance(spec_tree, dict):
        return {k: spec_map(fn, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return [spec_map(fn, v) for v in spec_tree]
    if not is_spec(spec_tree):
        raise TypeError(f"spec trees hold ParamSpecs, got "
                        f"{type(spec_tree).__name__}")
    return fn(spec_tree)


def _materialize(spec: ParamSpec, gen: torch.Generator) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype)
    fan = spec.fan_in or (spec.shape[0] if spec.shape else 1)
    scale = 1.0 / math.sqrt(max(1, fan))
    return (torch.randn(spec.shape, generator=gen, dtype=torch.float32)
            * scale).to(spec.dtype)


def _abstract(spec: ParamSpec) -> torch.Tensor:
    return torch.empty(spec.shape, dtype=spec.dtype, device="meta")


def init_module(spec_tree: dict, gen: torch.Generator,
                device: torch.device) -> nn.Module:
    """Materialise a spec tree: a dict of specs becomes an
    ``nn.ParameterDict``, a dict of dicts an ``nn.ModuleDict``.  Parameters
    are inference weights (``requires_grad=False``).  On the ``meta``
    device the tensors are :func:`abstract_tree`'s: nothing is drawn and
    ``gen`` is not advanced."""
    meta = torch.device(device).type == "meta"
    if all(isinstance(v, ParamSpec) for v in spec_tree.values()):
        return nn.ParameterDict({
            k: nn.Parameter(_abstract(s) if meta
                            else _materialize(s, gen).to(device),
                            requires_grad=False)
            for k, s in spec_tree.items()})
    if all(isinstance(v, dict) for v in spec_tree.values()):
        return nn.ModuleDict({k: init_module(v, gen, device)
                              for k, v in spec_tree.items()})
    raise ValueError(f"spec tree levels must hold only specs or only "
                     f"subtrees, got keys {sorted(spec_tree)}")


def abstract_tree(spec_tree):
    """``meta`` tensors of each spec's shape and dtype: JAX's
    ``ShapeDtypeStruct`` tree, allocating nothing."""
    return spec_map(_abstract, spec_tree)


def axes_tree(spec_tree):
    """The logical axes of each spec."""
    return spec_map(lambda s: s.axes, spec_tree)


def count_params(spec_tree) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(spec_tree))
