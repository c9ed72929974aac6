"""Decoder blocks: the PyTorch port of ``repro/models/blocks.py``.

Every layer is a ``kind``: ``attn`` (pre-norm attention + FFN), ``moe``
(attention + a mixture of experts, :mod:`repro_torch.models.moe`),
``lattn`` (``attn`` at ``cfg.local_window``), ``rglru`` (the RG-LRU mix,
:mod:`repro_torch.models.rglru`, + an optional FFN), ``mlstm`` and
``slstm`` (the xLSTM mixes, :mod:`repro_torch.models.xlstm`) and ``xdec``
(the whisper-style decoder block: self-attention, cross-attention over the
encoder stream, FFN): the full-sequence pass, dense and paged decode, and
the empty caches.  An ``xdec`` cache holds the encoder's K/V (``xk``,
``xv``) beside its self-attention ring; decode reads them and never
writes them.

A recurrent kind's cache is its state (a dict of ``(B, ...)`` tensors);
decode writes the new state into those tensors in place, as attention
writes its K/V ring, so a captured decode step carries it from replay to
replay.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed import context as dctx
from repro_torch.distributed import sharding as shd
from repro_torch.layers import basic
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import xlstm as xlstm_mod

__all__ = ["block_spec", "block_forward", "block_decode", "block_init_cache",
           "block_init_paged_cache", "PAGEABLE_KINDS", "KINDS"]

#: Block kinds this port builds.
KINDS = ("attn", "moe", "lattn", "rglru", "mlstm", "slstm", "xdec")
#: Kinds whose layer runs attention (their cache is a K/V ring).
ATTN_KINDS = ("attn", "moe", "lattn", "xdec")
#: Block kinds whose decode cache is a KV dict -- the kinds the paged
#: serving engine supports (recurrent state and the encoder's K/V are per
#: slot, not positional, so paging does not apply to them).
PAGEABLE_KINDS = ("attn", "moe", "lattn")

_RECURRENT = {
    "rglru": (rglru_mod.rglru_forward, rglru_mod.rglru_decode,
              rglru_mod.rglru_init_state),
    "mlstm": (xlstm_mod.mlstm_forward, xlstm_mod.mlstm_decode,
              xlstm_mod.mlstm_init_state),
    "slstm": (xlstm_mod.slstm_forward, xlstm_mod.slstm_decode,
              xlstm_mod.slstm_init_state),
}


def _norm_spec(cfg):
    if cfg.norm == "layernorm":
        return basic.layernorm_spec(cfg.d_model)
    return basic.rmsnorm_spec(cfg.d_model)


def _norm_apply(cfg, p, x):
    if cfg.norm == "layernorm":
        return basic.layernorm_apply(p, x)
    return basic.rmsnorm_apply(p, x)


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown block kind {kind!r}")


def _window_for(kind: str, cfg):
    return cfg.local_window if kind == "lattn" else cfg.window


def block_spec(kind: str, cfg) -> Dict[str, Any]:
    _check_kind(kind)
    s: Dict[str, Any] = {"ln1": _norm_spec(cfg)}
    if kind in ATTN_KINDS:
        s["attn"] = attn.attn_spec(cfg)
        if kind == "xdec":
            s["lnx"] = _norm_spec(cfg)
            s["xattn"] = attn.attn_spec(cfg)
    elif kind == "rglru":
        s["mix"] = rglru_mod.rglru_spec(cfg)
    elif kind == "mlstm":
        s["mix"] = xlstm_mod.mlstm_spec(cfg)
    else:
        s["mix"] = xlstm_mod.slstm_spec(cfg)
    if cfg.d_ff and kind in ATTN_KINDS + ("rglru",):
        s["ln2"] = _norm_spec(cfg)
        s["ffn"] = (moe_mod.moe_spec(cfg) if kind == "moe"
                    else ffn_mod.ffn_spec(cfg))
    return s


def _apply_moe(p, x, cfg, mode, policy=None):
    """The MoE block over ``x`` (B, S, D), alone or under the mesh (JAX's
    ``shard_map`` dispatch): the tokens are this rank's batch shard, the
    expert hidden axis is tensor-parallel over ``model`` where it divides,
    and the aux loss is averaged over the data axes."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    mesh = dctx.current_mesh()
    if mesh is None:
        out, aux = moe_mod.moe_apply_local(p, xt, cfg=cfg, mode=mode,
                                           policy=policy)
        return out.reshape(B, S, D), aux
    tp = coll.axis_size(mesh, "model") > 1 \
        and cfg.d_ff % coll.axis_size(mesh, "model") == 0
    out, aux = moe_mod.moe_apply_local(
        p, xt, cfg=cfg, mode=mode, policy=policy,
        psum_axes=("model",) if tp else None)
    for a in shd.data_axes(mesh):
        aux = coll.mean_from(aux, mesh, a)
    return out.reshape(B, S, D), aux


def _ffn_residual(kind, cfg, p, x, mode, policy):
    """``x`` plus the block's FFN (or MoE) of its normed input; returns
    ``(x, aux_loss)``, the aux loss zero outside a MoE block."""
    aux = torch.zeros((), device=x.device)
    if "ffn" in p:
        h2 = _norm_apply(cfg, p["ln2"], x)
        if kind == "moe":
            out, aux = _apply_moe(p["ffn"], h2, cfg, mode, policy)
        else:
            out = ffn_mod.ffn_apply(p["ffn"], h2, cfg=cfg, mode=mode,
                                    policy=policy)
        x = x + out
    return x, aux


def block_forward(kind: str, p, x, ctx):
    """Full-sequence block pass.  ``ctx``: dict(cfg, mode, policy,
    positions (S,), causal; for ``xdec`` cross_x (B, T, D), the encoder's
    output, and cross_positions (T,)).  Returns ``(x_out, cache_seed,
    aux_loss)``; the seed is an attention layer's roped ``{"k", "v"}`` (B,
    S, KV, hd) -- an ``xdec`` layer's also its cross K/V ``"xk"``, ``"xv"``
    (B, T, KV, hd) --, a recurrent layer's final state."""
    _check_kind(kind)
    cfg, mode, policy = ctx["cfg"], ctx["mode"], ctx.get("policy")
    h = _norm_apply(cfg, p["ln1"], x)
    if kind in ATTN_KINDS:
        out, (k, v) = attn.attn_forward(p["attn"], h, cfg=cfg,
                                        positions=ctx["positions"],
                                        causal=ctx.get("causal", True),
                                        window=_window_for(kind, cfg),
                                        mode=mode, policy=policy)
        seed = {"k": k, "v": v}
        if kind == "xdec":
            x = x + out
            out, (seed["xk"], seed["xv"]) = attn.attn_forward(
                p["xattn"], _norm_apply(cfg, p["lnx"], x), cfg=cfg,
                positions=ctx["positions"], cross_x=ctx["cross_x"],
                cross_positions=ctx["cross_positions"], mode=mode,
                policy=policy)
    else:
        out, seed = _RECURRENT[kind][0](p["mix"], h, cfg=cfg, mode=mode,
                                        policy=policy)
    x, aux = _ffn_residual(kind, cfg, p, x + out, mode, policy)
    return x, seed, aux


def block_decode(kind: str, p, x, cache, ctx):
    """One decode step of a block: x (B, S, D) -> (B, S, D); ``cache`` is
    this layer's cache, updated in place.

    With ``ctx["paged"]`` (the engine) the cache is the layer's pool dict,
    S may be a prefill chunk and ``ctx["pos"]`` is (B, S); otherwise it is
    the dense ``{"k", "v", "pos"}`` cache or a recurrent layer's state, S =
    1 and ``ctx["pos"]`` is (B,).  A recurrent layer's new state is copied
    into the cache's own tensors.  An ``xdec`` layer attends to its
    cache's ``xk``/``xv`` after its self-attention (dense decode only)."""
    _check_kind(kind)
    cfg, mode, policy = ctx["cfg"], ctx["mode"], ctx.get("policy")
    h = _norm_apply(cfg, p["ln1"], x)
    if kind not in ATTN_KINDS:
        out, state = _RECURRENT[kind][1](p["mix"], h, cache, cfg=cfg,
                                         mode=mode, policy=policy)
        for key, t in state.items():
            cache[key].copy_(t)
    elif ctx.get("paged") is not None:
        out = attn._attn_paged_step(p["attn"], h, cache, ctx["pos"],
                                    cfg=cfg, window=_window_for(kind, cfg),
                                    mode=mode, policy=policy,
                                    paged=ctx["paged"])
    else:
        out, _ = attn.attn_decode(p["attn"], h, cache, ctx["pos"], cfg=cfg,
                                  window=_window_for(kind, cfg), mode=mode,
                                  policy=policy)
        if kind == "xdec":
            x = x + out
            out, _ = attn.attn_decode(
                p["xattn"], _norm_apply(cfg, p["lnx"], x), None, ctx["pos"],
                cfg=cfg, cross_cache={"k": cache["xk"], "v": cache["xv"]},
                mode=mode, policy=policy)
    return _ffn_residual(kind, cfg, p, x + out, mode, policy)[0]


def block_init_cache(kind: str, cfg, batch: int, cache_len: int, device,
                     enc_len: int = 0):
    """Empty dense decode cache for one layer: a K/V ring (``cache_len``
    long, the window under a sliding window; an ``xdec`` layer's also
    zero ``xk``/``xv`` of ``(batch, enc_len, KV, hd)`` in the config's
    dtype) or a recurrent kind's initial state."""
    _check_kind(kind)
    if kind in ATTN_KINDS:
        c = attn.init_kv_cache(cfg, batch, cache_len, device,
                               _window_for(kind, cfg))
        if kind == "xdec":
            for key in ("xk", "xv"):
                c[key] = torch.zeros(
                    (batch, enc_len, cfg.n_kv_heads, cfg.resolved_head_dim),
                    dtype=c["k"].dtype, device=device)
        return c
    return _RECURRENT[kind][2](cfg, batch, device)


def block_init_paged_cache(kind: str, cfg, pool_slots: int, device):
    """Empty paged KV pool for one layer; raises for a kind with non-KV
    decode state, as the JAX package does."""
    _check_kind(kind)
    if kind not in PAGEABLE_KINDS:
        raise ValueError(
            f"block kind {kind!r} has no paged decode cache; the paged "
            f"serving engine supports {PAGEABLE_KINDS} (use the dense "
            f"reference Server for recurrent / encoder-decoder archs)")
    return attn.init_paged_kv_cache(cfg, pool_slots, device)
