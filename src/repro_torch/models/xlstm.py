"""xLSTM blocks (arXiv:2405.04517), mLSTM (matrix memory, chunkwise
parallel) and sLSTM (scalar memory, strictly sequential): the PyTorch port
of ``repro/models/xlstm.py``.

mLSTM recurrence (stabilized, per head):
    C_t = f_t C_{t-1} + i_t v_t k_t^T      n_t = f_t n_{t-1} + i_t k_t
    h_t = (C_t q_t) / max(|n_t . q_t|, 1)
with exponential gating i_t = exp(i~_t), f_t = exp(f~_t) and running
stabilizer m_t.  Prefill uses the chunkwise-parallel form (an intra-chunk
attention-like matrix plus the inter-chunk state carry), decode the
sequential step.  sLSTM has recurrent (h_{t-1}) connections and so no
parallel form: a loop over time, one ``fs_einsum`` a step.

Python loops stand in for JAX's ``lax.scan``; each contraction is noted
once a call, where JAX scales its scan body's notes by
``count_scale(steps)``, so the audits agree.  Every contraction goes
through ``fs_einsum`` at the JAX sites (``recurrent_proj``,
``recurrent_gates``, ``recurrent_mix``).

States: mLSTM ``{"C": (B, H, hd, hd), "n": (B, H, hd), "m": (B, H)}`` and
sLSTM ``{"c", "n", "h", "m": (B, D)}``, all f32, the stabilizers starting
at -1e30.  The scans take and return the ``(C, n, m)`` tuple, as JAX's do.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.einsum import fs_einsum
from repro_torch.layers import basic
from repro_torch.layers.param import ParamSpec, torch_dtype

__all__ = ["mlstm_spec", "mlstm_forward", "mlstm_decode", "mlstm_init_state",
           "mlstm_chunk_scan", "mlstm_seq_scan", "slstm_spec",
           "slstm_forward", "slstm_decode", "slstm_init_state"]

_NEG = -1e30


# =============================================================== mLSTM block

def mlstm_spec(cfg):
    d = cfg.d_model
    di = int(cfg.inner_factor * d)
    dt = torch_dtype(cfg.dtype)

    def dn(i, o, ax):
        return basic.dense_spec(i, o, ax, dt, False)

    return {
        "w_in": dn(d, 2 * di, ("embed", "mlp")),     # up-proj: x branch + gate
        "wq": dn(di, di, ("mlp", None)),
        "wk": dn(di, di, ("mlp", None)),
        "wv": dn(di, di, ("mlp", None)),
        "w_if": {"w": ParamSpec((di, 2), ("mlp", None), dtype=torch.float32,
                                fan_in=di)},
        "norm": basic.rmsnorm_spec(di),
        "w_out": dn(di, d, ("mlp", "embed")),
    }


def _mlstm_gates(p, xi: torch.Tensor, mode=None, policy=None):
    g = fs_einsum("...d,dg->...g", xi.float(), p["w_if"]["w"], mode=mode,
                  policy=policy, site="recurrent_gates")
    it = g[..., 0]                                   # log input gate
    ft = F.logsigmoid(g[..., 1])                     # log forget gate
    return it, ft


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], h, x.shape[-1] // h)


def _cummax(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running max along the last axis, as ``jax.lax.cummax``
    differentiates it: the recursion of ``jax.lax.associative_scan`` with
    ``max`` (pair adjacent entries, scan the pairs, fill in the even
    entries), so a tie splits its gradient evenly, as ``lax.max``'s does.
    ``torch.cummax`` sends it all to one index, with a scatter whose
    atomic adds make the backward vary from run to run on CUDA."""
    n = x.shape[-1]
    if n < 2:
        return x
    odd = _cummax(torch.maximum(x[..., 0:-1:2], x[..., 1::2]))
    even = torch.maximum(odd[..., :n // 2 - (n + 1) % 2], x[..., 2::2])
    even = torch.cat([x[..., :1], even], dim=-1)
    out = x.new_empty(x.shape)
    out[..., 0::2] = even
    out[..., 1::2] = odd
    return out


def mlstm_chunk_scan(q, k, v, it, ft, state, chunk: int, *, mode=None,
                     policy=None):
    """Chunkwise-parallel stabilized mLSTM.

    q, k, v: (B, H, S, hd) f32; it, ft: (B, H, S) log-gates; state: the
    tuple ``(C (B, H, hd, hd), n (B, H, hd), m (B, H))``.  Returns
    ``(h_out (B, H, S, hd), final state)``.  S pads up to a multiple of
    the chunk with ``it = -1e30`` (a padded step writes nothing)."""
    B, H, S, hd = q.shape
    c = min(chunk, S)
    pad = (-S) % c
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        it = F.pad(it, (0, pad), value=_NEG)
        ft = F.pad(ft, (0, pad))
    nc = q.shape[2] // c
    scale = hd ** -0.5
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))

    def mix(spec, a, b):
        return fs_einsum(spec, a, b, mode=mode, policy=policy,
                         site="recurrent_mix")

    C, n, m = state
    hs = []
    for j in range(nc):
        sl = slice(j * c, (j + 1) * c)
        qc, kc, vc, ic, fc = q[:, :, sl], k[:, :, sl], v[:, :, sl], \
            it[:, :, sl], ft[:, :, sl]
        b = torch.cumsum(fc, dim=-1)                         # (B,H,c)
        g = b[..., -1]                                       # total decay
        # stabilizers
        cmax = _cummax(ic - b)                         # max_j<=t (i_j - b_j)
        m_loc = b + cmax
        m_new = torch.maximum(m[..., None] + b, m_loc)       # (B,H,c)
        # inter-chunk
        q_eff = qc * (scale * torch.exp(m[..., None] + b - m_new))[..., None]
        h_inter = mix("bhcx,bhxd->bhcd", q_eff, C)
        n_inter = mix("bhcx,bhx->bhc", q_eff, n)
        # intra-chunk
        dmat = (b[..., :, None] - b[..., None, :] + ic[..., None, :]
                - m_new[..., :, None])                       # (B,H,c,c)
        dmat = torch.where(tri, dmat, torch.full_like(dmat, _NEG))
        s = mix("bhcx,bhdx->bhcd", qc * scale, kc) * torch.exp(dmat)
        h_intra = mix("bhcd,bhdx->bhcx", s, vc)
        n_intra = torch.sum(s, dim=-1)
        denom = torch.maximum(torch.abs(n_inter + n_intra),
                              torch.exp(-m_new))
        hs.append((h_inter + h_intra) / denom[..., None])
        # carry to the next chunk
        m_end = torch.maximum(m + g, g + cmax[..., -1])
        w_old = torch.exp(m + g - m_end)
        w_new = torch.exp(g[..., None] - b + ic - m_end[..., None])  # (B,H,c)
        # three-operand outer product: fold the gate into k first so the
        # contraction stays a two-operand fair-square dispatch
        C = C * w_old[..., None, None] + mix(
            "bhck,bhcv->bhkv", kc * w_new[..., None], vc)
        n = n * w_old[..., None] + mix("bhck,bhc->bhk", kc, w_new)
        m = m_end
    h = torch.cat(hs, dim=2)
    return h[:, :, :S], (C, n, m)


def mlstm_seq_scan(q, k, v, it, ft, state, *, mode=None, policy=None):
    """Sequential mLSTM (the decode step, and the oracle of the chunked
    form): operands and state as :func:`mlstm_chunk_scan`."""
    scale = q.shape[-1] ** -0.5
    C, n, m = state
    hs = []
    for t in range(q.shape[2]):
        qt, kt, vt = q[:, :, t], k[:, :, t], v[:, :, t]
        i_t, f_t = it[:, :, t], ft[:, :, t]
        m_new = torch.maximum(f_t + m, i_t)
        fw = torch.exp(f_t + m - m_new)
        iw = torch.exp(i_t - m_new)
        C = C * fw[..., None, None] + iw[..., None, None] * (
            kt[..., :, None] * vt[..., None, :])
        n = n * fw[..., None] + iw[..., None] * kt
        qs = qt * scale
        num = fs_einsum("bhk,bhkv->bhv", qs, C, mode=mode, policy=policy,
                        site="recurrent_mix")
        den = torch.maximum(
            torch.abs(fs_einsum("bhk,bhk->bh", qs, n, mode=mode,
                                policy=policy, site="recurrent_mix")),
            torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=2), (C, n, m)


def mlstm_init_state(cfg, batch: int, device) -> dict:
    h = cfg.n_heads
    hd = int(cfg.inner_factor * cfg.d_model) // h
    f32 = torch.float32
    return {"C": torch.zeros((batch, h, hd, hd), dtype=f32, device=device),
            "n": torch.zeros((batch, h, hd), dtype=f32, device=device),
            "m": torch.full((batch, h), _NEG, dtype=f32, device=device)}


def mlstm_forward(p, x: torch.Tensor, *, cfg, state=None,
                  mode: Optional[str] = None, chunk: int = 256,
                  sequential: bool = False, policy=None):
    """mLSTM block over a sequence (chunked, or ``sequential``).  Returns
    ``(y, final_state)``, the state a new dict."""
    B, S, D = x.shape
    di = int(cfg.inner_factor * D)
    H = cfg.n_heads

    def dense(name, t):
        return basic.dense_apply(p[name], t, mode=mode, policy=policy,
                                 site="recurrent_proj")

    up = dense("w_in", x)
    xi, gate = up[..., :di], up[..., di:]
    q, k, v = (_heads(dense(nm, xi), H).transpose(1, 2).float()
               for nm in ("wq", "wk", "wv"))
    itg, ftg = _mlstm_gates(p, xi, mode, policy)           # (B, S)
    it = itg[:, None, :].expand(B, H, S)
    ft = ftg[:, None, :].expand(B, H, S)
    if state is None:
        state = mlstm_init_state(cfg, B, x.device)
    st = (state["C"], state["n"], state["m"])
    if sequential:
        h, st = mlstm_seq_scan(q, k, v, it, ft, st, mode=mode,
                               policy=policy)
    else:
        h, st = mlstm_chunk_scan(q, k, v, it, ft, st, chunk, mode=mode,
                                 policy=policy)
    h = h.transpose(1, 2).reshape(B, S, di).to(x.dtype)
    h = basic.rmsnorm_apply(p["norm"], h)
    h = h * F.silu(gate.float()).to(h.dtype)
    y = basic.dense_apply(p["w_out"], h, mode=mode, out_dtype=x.dtype,
                          policy=policy, site="recurrent_proj")
    return y, dict(zip(("C", "n", "m"), st))


def mlstm_decode(p, x: torch.Tensor, state, *, cfg,
                 mode: Optional[str] = None, policy=None):
    return mlstm_forward(p, x, cfg=cfg, state=state, mode=mode,
                         sequential=True, policy=policy)


# =============================================================== sLSTM block

def slstm_spec(cfg):
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    dt = torch_dtype(cfg.dtype)
    return {
        "w_x": basic.dense_spec(d, 4 * d, ("embed", "mlp"), dt, True),
        "r": {"w": ParamSpec((h, hd, 4 * hd), ("q_heads", None, None),
                             dtype=torch.float32, fan_in=hd)},
        "norm": basic.rmsnorm_spec(d),
        "w_out": basic.dense_spec(d, d, ("mlp", "embed"), dt, False),
    }


def slstm_init_state(cfg, batch: int, device) -> dict:
    d = cfg.d_model
    f32 = torch.float32
    z = {k: torch.zeros((batch, d), dtype=f32, device=device)
         for k in ("c", "n", "h")}
    return dict(z, m=torch.full((batch, d), _NEG, dtype=f32, device=device))


def slstm_forward(p, x: torch.Tensor, *, cfg, state=None,
                  mode: Optional[str] = None, policy=None):
    """Sequential sLSTM over (B, S, D).  Returns ``(y, final_state)``, the
    state a new dict."""
    B, S, D = x.shape
    H = cfg.n_heads
    hd = D // H
    if state is None:
        state = slstm_init_state(cfg, B, x.device)
    wx = basic.dense_apply(p["w_x"], x, mode=mode, policy=policy,
                           site="recurrent_proj").float()       # (B,S,4D)
    rmat = p["r"]["w"]                                          # (H,hd,4hd)
    c, n, h, m = (state[k] for k in ("c", "n", "h", "m"))
    hs = []
    for t in range(S):
        hh = h.reshape(B, H, hd)
        rec = fs_einsum("bhx,hxy->bhy", hh, rmat, mode=mode, policy=policy,
                        site="recurrent_mix").reshape(B, 4 * D)
        pre = wx[:, t] + rec
        zt = torch.tanh(pre[:, 0 * D:1 * D])
        i_t = pre[:, 1 * D:2 * D]                   # log-space input gate
        f_t = F.logsigmoid(pre[:, 2 * D:3 * D])
        ot = torch.sigmoid(pre[:, 3 * D:4 * D])
        m_new = torch.maximum(f_t + m, i_t)
        fw = torch.exp(f_t + m - m_new)
        iw = torch.exp(i_t - m_new)
        c = fw * c + iw * zt
        n = fw * n + iw
        h = ot * c / torch.maximum(n, torch.exp(-m_new))
        m = m_new
        hs.append(h)
    hs = torch.stack(hs, dim=1).to(x.dtype)
    hs = basic.rmsnorm_apply(p["norm"], hs)
    y = basic.dense_apply(p["w_out"], hs, mode=mode, out_dtype=x.dtype,
                          policy=policy, site="recurrent_proj")
    return y, {"c": c, "n": n, "h": h, "m": m}


def slstm_decode(p, x: torch.Tensor, state, *, cfg,
                 mode: Optional[str] = None, policy=None):
    return slstm_forward(p, x, cfg=cfg, state=state, mode=mode,
                         policy=policy)
