"""Attention over the paged KV cache: the PyTorch port of the paged half of
``repro/models/attention.py``.

Layouts: activations (B, S, D); q (B, S, KV, G, hd) with G = H // KV;
pools (P, KV, hd) with P = num_blocks * block_size physical token slots.
Projections route through ``fs_einsum`` at sites ``attn_qkv``/``attn_out``;
the softmax read takes one of two routes (:mod:`repro_torch.kernels.routing`):
K4 (``kernel``) or a gathered window plus the ``attn_scores``/``attn_pv``
einsums (``gather``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.einsum import fs_einsum, resolve_mode
from repro_torch.core.prepared import PreparedOperand
from repro_torch.layers import basic
from repro_torch.layers.param import ParamSpec, torch_dtype

__all__ = ["attn_spec", "init_paged_kv_cache", "paged_slots",
           "paged_gather_indices", "EMPTY_POS",
           "ATTEND_POS_LIMIT", "NEG_INF"]

# Sentinel position of an unwritten / freed / padded physical cache slot;
# every mask tests ``pos < ATTEND_POS_LIMIT`` and every sentinel write uses
# EMPTY_POS, which sits above it.
EMPTY_POS = 2 ** 30
ATTEND_POS_LIMIT = 2 ** 29

NEG_INF = -1e30


def attn_spec(cfg):
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    dt = torch_dtype(cfg.dtype)

    def proj(shape):
        return {"w": ParamSpec(shape, dtype=dt, fan_in=d)}

    spec = {"wq": proj((d, h, hd)), "wk": proj((d, kv, hd)),
            "wv": proj((d, kv, hd)), "wo": proj((h, hd, d))}
    if cfg.attn_bias:
        for nm, shape in (("wq", (h, hd)), ("wk", (kv, hd)),
                          ("wv", (kv, hd)), ("wo", (d,))):
            spec[nm]["b"] = ParamSpec(shape, dtype=dt, init="zeros")
    return spec


def _proj_in(p, x, n, hd, mode, policy=None):
    """x[..., d] @ w[d, n, hd] -> (..., n, hd).  ``p["w"]`` may be a
    PreparedOperand of the reshaped (d, n*hd) weight."""
    w = p["w"]
    if not isinstance(w, PreparedOperand):
        w = w.reshape(w.shape[-3], n * hd)
    out = basic.dense_apply({"w": w}, x, mode=mode, policy=policy,
                            site="attn_qkv")
    out = out.reshape(*x.shape[:-1], n, hd)
    if "b" in p:
        out = out + p["b"].to(out.dtype)
    return out


def _proj_out(p, x, mode, out_dtype, policy=None):
    """x[..., h, hd] @ w[h, hd, d] -> (..., d)."""
    w = p["w"]
    if not isinstance(w, PreparedOperand):
        h, hd, d = w.shape[-3:]
        w = w.reshape(h * hd, d)
    xf = x.reshape(*x.shape[:-2], w.shape[0])
    out = basic.dense_apply({"w": w}, xf, mode=mode, policy=policy,
                            site="attn_out")
    if "b" in p:
        out = out + p["b"].to(out.dtype)
    return out.to(out_dtype)


def _softcap(scores, cap: float):
    if cap and cap > 0.0:
        return torch.tanh(scores / cap) * cap
    return scores


def paged_slots(tables: torch.Tensor, positions: torch.Tensor,
                block_size: int) -> torch.Tensor:
    """Physical pool slot of each (sequence, position); padded (-1)
    positions map to slot 0, inside the null block."""
    pos_r = torch.clamp(positions, min=0).long()
    blk = torch.gather(tables.long(), 1, pos_r // block_size)
    phys = blk * block_size + pos_r % block_size
    return torch.where(positions >= 0, phys, 0)


def paged_gather_indices(tables: torch.Tensor,
                         block_size: int) -> torch.Tensor:
    """(B, nb * block_size) pool indices of each sequence's logical window,
    in position order."""
    offs = torch.arange(block_size, device=tables.device)
    return (tables.long()[:, :, None] * block_size + offs).reshape(
        tables.shape[0], -1)


def _attn_paged_step(p, x, cache, pos, *, cfg, window: Optional[int], mode,
                    policy, paged):
    """Multi-token attention step against the paged KV pool (the port of
    ``repro.models.attention._attn_paged_step``).

    New K/V are written to their physical slots IN PLACE (the pools are
    the engine's, updated step by step; the JAX version returns new
    pools), then every query attends over its own block table's window
    with the absolute-position causal mask.  ``kernel`` runs K4;
    ``gather`` materialises the window.  There is no guard and no
    recompute: a kernel fault surfaces as an error.

    ``paged``: dict(tables (B, nb) int32, pos_pool (P,) int32 already
    holding this step's positions, phys (B, S) slots, block_size).
    """
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    G = H // KV
    dt = torch_dtype(cfg.dtype)
    pos_r = torch.clamp(pos, min=0)

    q = _proj_in(p["wq"], x, H, hd, mode, policy).to(dt)
    k1 = _proj_in(p["wk"], x, KV, hd, mode, policy).to(dt)
    v1 = _proj_in(p["wv"], x, KV, hd, mode, policy).to(dt)
    qr = basic.rope(q, pos_r, cfg.rope_theta)
    k1 = basic.rope(k1, pos_r, cfg.rope_theta)

    phys = paged["phys"].reshape(B * S)
    k_pool, v_pool = cache["k"], cache["v"]
    k_pool[phys] = k1.reshape(B * S, KV, hd).to(k_pool.dtype)
    v_pool[phys] = v1.reshape(B * S, KV, hd).to(v_pool.dtype)

    tables, pos_pool = paged["tables"], paged["pos_pool"]
    bs = paged["block_size"]
    T = tables.shape[1] * bs
    qf = qr.reshape(B, S, KV, G, hd).float() * hd ** -0.5

    use_kernel = False
    if resolve_mode(mode, policy, "attn_paged") == "square_pallas" \
            and dt.is_floating_point:
        from repro_torch.kernels import routing
        route = routing.select_paged_attn_route(
            S, T, batch=B, kv_heads=KV, group=G, hd=hd, dtype=dt)
        use_kernel = route.name == "kernel"

    if use_kernel:
        from repro_torch.kernels.sq_paged_attn import sq_paged_attn_k4
        out = sq_paged_attn_k4(qf, k_pool, v_pool, tables, pos_pool, pos,
                               block_size=bs, window=window,
                               softcap=cfg.attn_logit_softcap,
                               attend_limit=ATTEND_POS_LIMIT)
    else:
        idx = paged_gather_indices(tables, bs)
        k = k_pool[idx].float()                            # (B, T, KV, hd)
        v = v_pool[idx].float()
        kv_pos = pos_pool[idx]                             # (B, T)
        valid = (kv_pos[:, None, :] <= pos[:, :, None]) \
            & (kv_pos[:, None, :] < ATTEND_POS_LIMIT)      # (B, S, T)
        if window is not None:
            valid &= (pos[:, :, None] - kv_pos[:, None, :]) < window
        s = fs_einsum("bqkgh,btkh->bkgqt", qf, k, mode=mode, policy=policy,
                      site="attn_scores")
        s = _softcap(s, cfg.attn_logit_softcap)
        s = s.masked_fill(~valid[:, None, None], NEG_INF)
        w = torch.softmax(s, dim=-1)
        out = fs_einsum("bkgqt,btkh->bqkgh", w, v, mode=mode, policy=policy,
                        site="attn_pv")

    out = out.reshape(B, S, H, hd).to(dt)
    return _proj_out(p["wo"], out, mode, x.dtype, policy=policy)


def init_paged_kv_cache(cfg, pool_slots: int, device) -> dict:
    """Empty paged KV pool of one layer: ``pool_slots`` physical token
    slots shared by every sequence."""
    hd = cfg.resolved_head_dim
    dt = torch_dtype(cfg.dtype)
    shape = (pool_slots, cfg.n_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}
