"""Weights from the JAX package's layout into the port's ``LM``.

:func:`params_from_jax` takes a JAX ``LM`` params tree whose leaves are
numpy arrays (``jax.tree.map(np.asarray, params)``) and returns a state
dict for :class:`repro_torch.models.lm.LM`.  Layer ``i`` comes from the
scan stack (``params["scan"]["pos{j}"]``, leading period axis) or the
unrolled tail (``params["tail"]["layer{t}"]``) exactly as the JAX model
orders them.  An encoder-decoder tree's encoder (``encoder.blocks.pos0``,
stacked with a leading ``encoder_layers`` axis, and ``encoder.norm``)
becomes ``encoder.layers.{i}`` and ``encoder.norm``.  Tensor layouts are
kept: wq/wk/wv (d, heads, hd), wo (heads, hd, d), dense weights (d_in,
d_out).

:func:`train_state_from_jax` takes a JAX params tree and AdamW state and
returns the port's functional params tree and optimizer state (the
layout of :meth:`repro_torch.models.lm.LM.train_params`), so both packages
can train from one state.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["params_from_jax", "tree_from_state_dict",
           "train_state_from_jax"]


def _flatten(tree: Mapping, prefix: str, out: Dict[str, np.ndarray]) -> None:
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            _flatten(v, name + ".", out)
        else:
            out[name] = np.asarray(v)


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """State dict of the port's LM from a numpy JAX params tree.

    The layer order is the JAX model's: every period of the scan stack
    (``pos0 .. pos{p-1}`` for each index of the leading axis), then the
    tail layers."""
    layers = []
    scan = tree.get("scan", {})
    if scan:
        stacked = {}
        for j in range(len(scan)):
            one: Dict[str, np.ndarray] = {}
            _flatten(scan[f"pos{j}"], "", one)
            stacked[j] = one
        n_periods = {v.shape[0] for one in stacked.values()
                     for v in one.values()}
        if len(n_periods) != 1:
            raise ValueError(f"scan leaves disagree on the period count: "
                             f"{sorted(n_periods)}")
        for period in range(n_periods.pop()):
            for j in range(len(scan)):
                layers.append({k: v[period] for k, v in stacked[j].items()})
    tail = tree.get("tail", {})
    for t in range(len(tail)):
        one = {}
        _flatten(tail[f"layer{t}"], "", one)
        layers.append(one)
    flat: Dict[str, np.ndarray] = {}
    _flatten({"embed": tree["embed"], "final_norm": tree["final_norm"]}, "",
             flat)
    for i, layer in enumerate(layers):
        for k, v in layer.items():
            flat[f"layers.{i}.{k}"] = v
    if "encoder" in tree:
        enc = tree["encoder"]
        stacked: Dict[str, np.ndarray] = {}
        _flatten(enc["blocks"]["pos0"], "", stacked)
        for k, v in stacked.items():
            for i in range(v.shape[0]):
                flat[f"encoder.layers.{i}.{k}"] = v[i]
        _flatten(enc["norm"], "encoder.norm.", flat)
    return {k: _to_torch(v) for k, v in flat.items()}


def tree_from_state_dict(flat: Mapping[str, torch.Tensor]) -> Dict:
    """The LM's params tree (``{"embed", "final_norm", "layers": [...]}``,
    and ``"encoder": {"layers": [...], "norm"}`` where present) from a
    state dict of dotted names."""
    root: Dict = {}
    for name, t in flat.items():
        node = root
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t
    for node in (root, root.get("encoder", {})):
        layers = node.get("layers", {})
        node["layers"] = [layers[str(i)] for i in range(len(layers))]
    return root


def train_state_from_jax(params: Mapping, opt_state: Mapping):
    """``(params, opt_state)`` of the port from a numpy JAX params tree and
    ``repro.optim.adamw`` state: the params and AdamW's ``m`` and ``v`` go
    through :func:`params_from_jax`'s layer mapping, ``step`` alongside."""
    p = tree_from_state_dict(params_from_jax(params))
    opt = {k: tree_from_state_dict(params_from_jax(opt_state[k]))
           for k in ("m", "v")}
    opt["step"] = torch.tensor(int(np.asarray(opt_state["step"])),
                               dtype=torch.int32)
    return p, opt


def _to_torch(a: np.ndarray) -> torch.Tensor:
    # numpy has no bfloat16: JAX bf16 leaves arrive as ml_dtypes arrays
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))     # a writable, owned copy
