"""Decoder blocks: the PyTorch port of ``repro/models/blocks.py``, the
``attn`` kind (pre-norm attention + FFN) and the ``moe`` kind (pre-norm
attention + a mixture of experts, :mod:`repro_torch.models.moe`): the
full-sequence pass, dense and paged decode, and the empty caches.  The
recurrent and cross-attention kinds come with ROADMAP Q1 step 6."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.layers import basic
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import moe as moe_mod

__all__ = ["block_spec", "block_forward", "block_decode", "block_init_cache",
           "block_init_paged_cache", "PAGEABLE_KINDS"]

# Block kinds whose decode cache is a paged KV pool.  The JAX package also
# pages ``lattn``, which this port builds with the recurrent archs.
PAGEABLE_KINDS = ("attn", "moe")


def _norm_spec(cfg):
    if cfg.norm == "layernorm":
        return basic.layernorm_spec(cfg.d_model)
    return basic.rmsnorm_spec(cfg.d_model)


def _norm_apply(cfg, p, x):
    if cfg.norm == "layernorm":
        return basic.layernorm_apply(p, x)
    return basic.rmsnorm_apply(p, x)


def _check_kind(kind: str) -> None:
    if kind not in ("attn", "moe"):
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet; this port builds "
            f"attention and MoE blocks (the recurrent and cross-attention "
            f"kinds come with ROADMAP Q1 step 6)")


def block_spec(kind: str, cfg) -> Dict[str, Any]:
    _check_kind(kind)
    s: Dict[str, Any] = {"ln1": _norm_spec(cfg), "attn": attn.attn_spec(cfg)}
    if cfg.d_ff:
        s["ln2"] = _norm_spec(cfg)
        s["ffn"] = (moe_mod.moe_spec(cfg) if kind == "moe"
                    else ffn_mod.ffn_spec(cfg))
    return s


def _ffn_residual(kind, cfg, p, x, mode, policy):
    """``x`` plus the block's FFN (or MoE) of its normed input; returns
    ``(x, aux_loss)``, the aux loss zero outside a MoE block."""
    aux = torch.zeros((), device=x.device)
    if cfg.d_ff:
        h2 = _norm_apply(cfg, p["ln2"], x)
        if kind == "moe":
            B, S, D = h2.shape
            out, aux = moe_mod.moe_apply_local(
                p["ffn"], h2.reshape(B * S, D), cfg=cfg, mode=mode,
                policy=policy)
            out = out.reshape(B, S, D)
        else:
            out = ffn_mod.ffn_apply(p["ffn"], h2, cfg=cfg, mode=mode,
                                    policy=policy)
        x = x + out
    return x, aux


def block_forward(kind: str, p, x, ctx):
    """Full-sequence block pass.  ``ctx``: dict(cfg, mode, policy,
    positions (S,), causal).  Returns ``(x_out, cache_seed, aux_loss)``;
    the seed is this layer's roped ``{"k", "v"}`` (B, S, KV, hd)."""
    _check_kind(kind)
    cfg, mode, policy = ctx["cfg"], ctx["mode"], ctx.get("policy")
    h = _norm_apply(cfg, p["ln1"], x)
    out, (k, v) = attn.attn_forward(p["attn"], h, cfg=cfg,
                                    positions=ctx["positions"],
                                    causal=ctx.get("causal", True),
                                    window=cfg.window, mode=mode,
                                    policy=policy)
    x, aux = _ffn_residual(kind, cfg, p, x + out, mode, policy)
    return x, {"k": k, "v": v}, aux


def block_decode(kind: str, p, x, cache, ctx):
    """One decode step of a block: x (B, S, D) -> (B, S, D); ``cache`` is
    this layer's cache, updated in place.

    With ``ctx["paged"]`` (the engine) the cache is the layer's pool dict,
    S may be a prefill chunk and ``ctx["pos"]`` is (B, S); otherwise it is
    the dense ``{"k", "v", "pos"}`` cache, S = 1 and ``ctx["pos"]`` is
    (B,)."""
    _check_kind(kind)
    cfg, mode, policy = ctx["cfg"], ctx["mode"], ctx.get("policy")
    h = _norm_apply(cfg, p["ln1"], x)
    if ctx.get("paged") is not None:
        out = attn._attn_paged_step(p["attn"], h, cache, ctx["pos"],
                                    cfg=cfg, window=cfg.window, mode=mode,
                                    policy=policy, paged=ctx["paged"])
    else:
        out, _ = attn.attn_decode(p["attn"], h, cache, ctx["pos"], cfg=cfg,
                                  window=cfg.window, mode=mode,
                                  policy=policy)
    return _ffn_residual(kind, cfg, p, x + out, mode, policy)[0]


def block_init_cache(kind: str, cfg, batch: int, cache_len: int, device):
    """Empty dense KV cache for one layer (a ring under ``cfg.window``)."""
    _check_kind(kind)
    return attn.init_kv_cache(cfg, batch, cache_len, device, cfg.window)


def block_init_paged_cache(kind: str, cfg, pool_slots: int, device):
    """Empty paged KV pool for one layer."""
    _check_kind(kind)
    return attn.init_paged_kv_cache(cfg, pool_slots, device)
