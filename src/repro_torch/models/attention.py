"""Attention: the PyTorch port of ``repro/models/attention.py`` (self
attention; cross-attention comes with the encoder-decoder slice).

- Full sequence (train / prefill): :func:`attn_forward` over
  :func:`chunked_attention`, an online softmax over q chunks x kv chunks.
- Dense decode: :func:`attn_decode` against a ``(B, T, KV, hd)`` cache
  (a ring under a sliding window) with per-row ``(B,)`` positions.
- Paged decode and chunked prefill (the engine): :func:`_attn_paged_step`
  over ``(P, KV, hd)`` pools with P = num_blocks * block_size physical
  token slots; its softmax read takes one of two routes
  (:mod:`repro_torch.kernels.routing`): K4 (``kernel``) or a gathered
  window plus two einsums (``gather``).

Layouts: activations (B, S, D); q (B, S, KV, G, hd) with G = H // KV;
k/v (B, T, KV, hd).  Every contraction routes through ``fs_einsum``: the
projections at sites ``attn_qkv``/``attn_out``, the softmax path at
``attn_scores``/``attn_pv`` (under ``square_pallas`` with no policy, K2 or
K3 run those).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import counting, graphs, guards
from repro_torch.core.einsum import fs_einsum, resolve_mode
from repro_torch.core.prepared import PreparedOperand
from repro_torch.layers import basic
from repro_torch.layers.param import ParamSpec, torch_dtype

__all__ = ["attn_spec", "attn_forward", "attn_decode", "chunked_attention",
           "init_kv_cache", "init_paged_kv_cache", "paged_slots",
           "paged_gather_indices", "EMPTY_POS", "ATTEND_POS_LIMIT",
           "NEG_INF"]

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


def _pad_seq(t: torch.Tensor, pad: int, value=0) -> torch.Tensor:
    """Pad dim 1 (the sequence axis) of ``t`` at the end by ``pad``."""
    if not pad:
        return t
    return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad), value=value)


def chunked_attention(q, k, v, q_pos, kv_pos, *, causal: bool,
                      window: Optional[int], chunk_q: int, chunk_kv: int,
                      softcap: float = 0.0, mode: Optional[str] = None,
                      policy=None) -> torch.Tensor:
    """Online-softmax attention with O(chunk_q * chunk_kv) live scores.

    q: (B, S, KV, G, hd); k, v: (B, T, KV, hd); ``q_pos`` (S,) and
    ``kv_pos`` (T,) absolute positions.  Returns (B, S, KV, G, hd) in
    q.dtype.  Padded q rows get position -1 and padded kv entries
    :data:`EMPTY_POS`, so they never attend; a fully masked row ends as a
    finite average (the normaliser is clamped at 1e-30).  Python loops
    stand in for the JAX version's ``lax.map``/``lax.scan``; its
    ``block_skip``, ``fold_q`` and ``p_bf16`` options are not ported.
    """
    B, S, KV, G, hd = q.shape
    T = k.shape[1]
    cq, ck = min(chunk_q, S), min(chunk_kv, T)
    pad_q, pad_k = (-S) % cq, (-T) % ck
    qp = _pad_seq(q, pad_q)
    qpos = F.pad(q_pos, (0, pad_q), value=-1)
    kp, vp = _pad_seq(k, pad_k), _pad_seq(v, pad_k)
    kpos = F.pad(kv_pos, (0, pad_k), value=EMPTY_POS)
    nq, nk = qp.shape[1] // cq, kp.shape[1] // ck
    scale = hd ** -0.5
    dev = q.device

    outs = []
    for qi in range(nq):
        qf = qp[:, qi * cq:(qi + 1) * cq].float() * scale
        qpc = qpos[qi * cq:(qi + 1) * cq]
        m = torch.full((B, KV, G, cq), NEG_INF, device=dev)
        l = torch.zeros((B, KV, G, cq), device=dev)
        acc = torch.zeros((B, KV, G, cq, hd), device=dev)
        for ki in range(nk):
            sl = slice(ki * ck, (ki + 1) * ck)
            kc, vc, kpc = kp[:, sl].float(), vp[:, sl].float(), kpos[sl]
            s = fs_einsum("bqkgh,bckh->bkgqc", qf, kc, mode=mode,
                          policy=policy, site="attn_scores")
            s = _softcap(s, softcap)
            mask = kpc[None, :] < ATTEND_POS_LIMIT   # padded kv never attend
            if causal:
                mask = mask & (kpc[None, :] <= qpc[:, None])
            if window is not None:
                mask = mask & ((qpc[:, None] - kpc[None, :]) < window)
            s = s.masked_fill(~mask, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = fs_einsum("bkgqc,bckh->bkgqh", p, vc, mode=mode,
                           policy=policy, site="attn_pv")
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))              # (B,cq,KV,G,hd)
    return torch.cat(outs, dim=1)[:, :S].to(q.dtype)


def attn_forward(p, x, *, cfg, positions, causal: bool = True,
                 window: Optional[int] = None, mode: Optional[str] = None,
                 policy=None):
    """Full-sequence self attention (train / prefill).  ``positions``:
    (S,) absolute.  Returns ``(out, (k, v))``, the roped k and v in the
    config's dtype, so callers can seed KV caches."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    dt = torch_dtype(cfg.dtype)
    q = _proj_in(p["wq"], x, H, hd, mode, policy)
    k = _proj_in(p["wk"], x, KV, hd, mode, policy).to(dt)
    v = _proj_in(p["wv"], x, KV, hd, mode, policy).to(dt)
    q = q.to(dt)
    q = basic.rope(q, positions, cfg.rope_theta)
    k = basic.rope(k, positions, cfg.rope_theta)
    out = chunked_attention(q.reshape(B, S, KV, H // KV, hd), k, v,
                            positions, positions, causal=causal,
                            window=window, chunk_q=cfg.attn_chunk_q,
                            chunk_kv=cfg.attn_chunk_kv,
                            softcap=cfg.attn_logit_softcap, mode=mode,
                            policy=policy)
    out = out.reshape(B, S, H, hd)
    return _proj_out(p["wo"], out, mode, x.dtype, policy=policy), (k, v)


def attn_decode(p, x, cache, pos, *, cfg, window: Optional[int] = None,
                mode: Optional[str] = None, policy=None):
    """Single-token decode against a dense cache ``{"k", "v": (B, T, KV,
    hd), "pos": (B, T) int32}`` (a ring buffer under ``window``).

    ``pos`` (B,): each row's absolute position.  The new K/V and position
    are written IN PLACE (the JAX version returns a new cache) at slot
    ``pos % T`` under a window, else ``min(pos, T - 1)``; a row attends to
    every cache entry whose position is at most its own (and inside the
    window).  Returns ``(out (B, 1, D), cache)``.
    """
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    G = H // KV
    dt = torch_dtype(cfg.dtype)
    pos = pos.long()

    q = _proj_in(p["wq"], x, H, hd, mode, policy).to(dt)
    k1 = _proj_in(p["wk"], x, KV, hd, mode, policy).to(dt)
    v1 = _proj_in(p["wv"], x, KV, hd, mode, policy).to(dt)
    qr = basic.rope(q, pos[:, None], cfg.rope_theta)
    k1 = basic.rope(k1, pos[:, None], cfg.rope_theta)

    T = cache["k"].shape[1]
    slot = pos % T if window is not None else torch.clamp(pos, max=T - 1)
    bidx = torch.arange(B, device=x.device)
    cache["k"][bidx, slot] = k1[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, slot] = v1[:, 0].to(cache["v"].dtype)
    cache["pos"][bidx, slot] = pos.to(cache["pos"].dtype)
    kv_abs = cache["pos"]
    valid = kv_abs <= pos[:, None]
    if window is not None:
        valid &= (pos[:, None] - kv_abs) < window

    qf = qr.reshape(B, 1, KV, G, hd).float() * hd ** -0.5
    s = fs_einsum("bqkgh,btkh->bkgqt", qf, cache["k"].float(), mode=mode,
                  policy=policy, site="attn_scores")
    s = _softcap(s, cfg.attn_logit_softcap)
    s = s.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = fs_einsum("bkgqt,btkh->bqkgh", w, cache["v"].float(), mode=mode,
                    policy=policy, site="attn_pv")
    out = out.reshape(B, 1, H, hd).to(dt)
    return _proj_out(p["wo"], out, mode, x.dtype, policy=policy), cache


def init_kv_cache(cfg, batch: int, max_len: int, device,
                  window: Optional[int] = None) -> dict:
    """Empty dense KV cache; a sliding-window arch allocates only its
    window (a ring buffer).  Every ``pos`` entry starts at EMPTY_POS."""
    T = min(max_len, window) if window is not None else max_len
    hd = cfg.resolved_head_dim
    dt = torch_dtype(cfg.dtype)
    shape = (batch, T, cfg.n_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "pos": torch.full((batch, T), EMPTY_POS, dtype=torch.int32,
                              device=device)}


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
    with the absolute-position causal mask.  ``kernel`` runs K4 (not for
    an ``attn_paged`` health key that was demoted); ``gather``
    materialises the window.  K4's result is noted into the contraction
    audit at ``attn_scores`` and ``attn_pv`` (and, captured under the
    compiled audit, into the graph's runtime notes).  Under an enabled
    guard an eager non-finite K4 result is a counted trip, recomputed on
    the gather route; a captured one is not checked in line; a kernel
    fault surfaces as an error.

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

    def gather_attend():
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
        return fs_einsum("bkgqt,btkh->bqkgh", w, v, mode=mode, policy=policy,
                         site="attn_pv")

    use_kernel = False
    if resolve_mode(mode, policy, "attn_paged") == "square_pallas" \
            and dt.is_floating_point:
        from repro_torch.kernels import routing
        route = routing.select_paged_attn_route(
            S, T, batch=B, kv_heads=KV, group=G, hd=hd, dtype=dt)
        hkey = routing.health_key("attn_paged", (B, S, KV, G, hd, T), dt)
        use_kernel = (route.name == "kernel"
                      and not routing.route_health().is_demoted(hkey))

    if use_kernel:
        from repro_torch.kernels.sq_paged_attn import sq_paged_attn_k4
        out = sq_paged_attn_k4(qf, k_pool, v_pool, tables, pos_pool, pos,
                               block_size=bs, window=window,
                               softcap=cfg.attn_logit_softcap,
                               attend_limit=ATTEND_POS_LIMIT)
        # None under a CUDA graph capture: no in-line check and no
        # recompute there (JAX's recompute is eager-only too); the
        # engine's per-slot logits guard catches a non-finite K4 result
        ok = guards.check_finite(out) if guards.guard_policy().enabled \
            else True
        if ok is False:
            # a counted recompute, never a quiet one: the trip lands in
            # RouteHealth (a guard.trip event; demotion at the limit) and
            # in its recompute count, and the gather route's fs_einsums
            # note themselves
            routing.route_health().record_trip(
                hkey, limit=guards.guard_policy().trip_limit)
            out = gather_attend()
        else:
            # K4 computes both softmax-path contractions: note them at the
            # sites the audit knows, with the gather route's volumes.  A
            # capture under the compiled audit emits their runtime notes
            # too (the JAX package's compiled audit omits these sites), so
            # a replayed step's audit equals an eager step's.
            runtime = counting.compiled_audit_enabled() \
                and graphs.capturing()
            for site in ("attn_scores", "attn_pv"):
                note = dict(site=site, spec="paged_attn_kernel",
                            mode="square_pallas",
                            mults=B * KV * G * S * T * hd)
                counting.note_contraction(**note)
                if runtime:
                    counting.emit_runtime_note(**note)
    else:
        out = gather_attend()

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
