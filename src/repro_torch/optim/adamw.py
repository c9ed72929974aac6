"""AdamW with global-norm clipping, a cosine schedule, and int8 gradient
compression with error feedback: the PyTorch port of
``repro/optim/adamw.py``.

Functional, as the JAX version is: the state mirrors the params tree
(:mod:`repro_torch.core.tree`), ``m`` and ``v`` are f32, and
:func:`adamw_update` returns new tensors and never writes its inputs, so a
retried step (``GuardedStep``, ``Trainer._attempt_step``) and the trainer's
rollback to its initial snapshot can reuse a step's inputs as JAX's
immutable arrays allow.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math

import numpy as np
import torch

from repro_torch.core.tree import tree_leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "compress_int8", "decompress_int8",
           "compressed_grad_tree", "tree_fingerprint"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio * lr`` (f32)."""
    step = step.float()
    warm = torch.clamp(step / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def adamw_init(params):
    """``{"step": 0, "m": zeros, "v": zeros}``, m and v f32 beside each
    parameter."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    leaf = tree_leaves(params)[0]
    return {"step": torch.zeros((), dtype=torch.int32, device=leaf.device),
            "m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def adamw_update(cfg: AdamWConfig, params, grads, state):
    """One AdamW step.  Returns ``(new_params, new_state, metrics)``; every
    parameter is updated in f32 and cast back to its own dtype."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    lr = cosine_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * p.float()
        return _Out(((p.float() - lr * delta).to(p.dtype), m, v))

    out = tree_map(upd, params, grads, state["m"], state["v"])
    new_state = {"step": step, "m": _pick(out, 1), "v": _pick(out, 2)}
    return _pick(out, 0), new_state, {"grad_norm": gnorm, "lr": lr}


class _Out(tuple):
    """Several results of one leaf, told apart from a tree's tuples."""


def _pick(tree, i):
    """Result ``i`` of every leaf's :class:`_Out`, as a tree."""
    if isinstance(tree, _Out):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return type(tree)(_pick(t, i) for t in tree)


def _leaf_bytes(leaf):
    """(dtype name, shape, raw bytes) of a tensor, numpy array or scalar;
    a bf16 tensor's bytes are its uint16 view (numpy has no bfloat16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return name, tuple(t.shape), t.numpy().tobytes()
    a = np.asarray(leaf)
    return str(a.dtype), tuple(a.shape), a.tobytes()


def tree_fingerprint(tree) -> str:
    """Bit-exact SHA-256 of a tree of tensors, arrays or scalars: its
    structure, then each leaf's dtype, shape and raw bytes, so two runs
    have the same digest iff they are bit-identical (the fixed-seed
    determinism probe of the train loop).  Reads device values back.

    >>> a = {"w": torch.ones(2), "l": [torch.zeros(1, dtype=torch.bfloat16)]}
    >>> tree_fingerprint(a) == tree_fingerprint(
    ...     {"l": [torch.zeros(1, dtype=torch.bfloat16)], "w": torch.ones(2)})
    True
    >>> tree_fingerprint(a) == tree_fingerprint({"w": torch.ones(2)})
    False
    """
    h = hashlib.sha256()
    h.update(repr(_structure(tree)).encode())
    for leaf in tree_leaves(tree):
        name, shape, raw = _leaf_bytes(leaf)
        h.update(name.encode())
        h.update(repr(shape).encode())
        h.update(raw)
    return h.hexdigest()


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_structure(t) for t in tree]
    return "*"


# ---------------------------------------------------------- grad compression

def compress_int8(g: torch.Tensor):
    """Symmetric per-tensor int8 quantization: ``(q, scale)``."""
    gf = g.float()
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_grad_tree(grads, error_feedback):
    """Quantize grads with error feedback: ``g_eff = g + e``, ``e' = g_eff -
    deq``.  Returns ``(dequantized grads, new error feedback)``."""
    def one(g, e):
        g_eff = g.float() + e
        deq = decompress_int8(*compress_int8(g_eff))
        return _Out((deq.to(g.dtype), g_eff - deq))

    out = tree_map(one, grads, error_feedback)
    return _pick(out, 0), _pick(out, 1)
