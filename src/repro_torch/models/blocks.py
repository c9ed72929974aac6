"""Decoder blocks: the PyTorch port of ``repro/models/blocks.py``, ``attn``
kind only (pre-norm attention + FFN, paged decode)."""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.layers import basic
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod

__all__ = ["block_spec", "block_decode", "block_init_paged_cache",
           "PAGEABLE_KINDS"]

# Block kinds whose decode cache is a paged KV pool.  The JAX package also
# pages ``moe`` and ``lattn``; this port builds ``attn`` only so far.
PAGEABLE_KINDS = ("attn",)


def _norm_spec(cfg):
    if cfg.norm == "layernorm":
        return basic.layernorm_spec(cfg.d_model)
    return basic.rmsnorm_spec(cfg.d_model)


def _norm_apply(cfg, p, x):
    if cfg.norm == "layernorm":
        return basic.layernorm_apply(p, x)
    return basic.rmsnorm_apply(p, x)


def _check_kind(kind: str) -> None:
    if kind != "attn":
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet; this port builds plain "
            f"dense attention blocks (ROADMAP Q1, slice 5 brings the rest)")


def block_spec(kind: str, cfg) -> Dict[str, Any]:
    _check_kind(kind)
    s: Dict[str, Any] = {"ln1": _norm_spec(cfg), "attn": attn.attn_spec(cfg)}
    if cfg.d_ff:
        s["ln2"] = _norm_spec(cfg)
        s["ffn"] = ffn_mod.ffn_spec(cfg)
    return s


def block_decode(kind: str, p, x, cache, ctx):
    """One paged step of a block: x (B, S, D) -> (B, S, D); ``cache`` is
    this layer's pool dict, updated in place."""
    _check_kind(kind)
    cfg, mode, policy = ctx["cfg"], ctx["mode"], ctx.get("policy")
    h = _norm_apply(cfg, p["ln1"], x)
    x = x + attn._attn_paged_step(p["attn"], h, cache, ctx["pos"], cfg=cfg,
                                  window=cfg.window, mode=mode,
                                  policy=policy, paged=ctx["paged"])
    if cfg.d_ff:
        h2 = _norm_apply(cfg, p["ln2"], x)
        x = x + ffn_mod.ffn_apply(p["ffn"], h2, cfg=cfg, mode=mode,
                                  policy=policy)
    return x


def block_init_paged_cache(kind: str, cfg, pool_slots: int, device):
    """Empty paged KV pool for one layer."""
    _check_kind(kind)
    return attn.init_paged_kv_cache(cfg, pool_slots, device)
