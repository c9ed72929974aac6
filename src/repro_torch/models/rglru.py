"""RecurrentGemma / Griffin recurrent block (arXiv:2402.19427): the PyTorch
port of ``repro/models/rglru.py``.

Block: x -> [branch1: linear -> causal depthwise conv1d(w=4) -> RG-LRU]
            [branch2: linear -> GeLU]
       merge = branch1 * branch2 -> linear down.

RG-LRU (real-gated linear recurrent unit), diagonal recurrence:
    r_t = sigmoid(W_r x_t)         i_t = sigmoid(W_i x_t)
    a_t = exp(-c * softplus(L) * r_t)            (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The full-sequence pass runs the diagonal recurrence as a log-depth
parallel scan (:func:`_assoc_scan`, the recursion of
``jax.lax.associative_scan`` with the same combine, so the partial
products meet in JAX's order); decode is the sequential step.  The conv
keeps a (width-1)-sample state for decode.  Every GEMM goes through the
fair-square dispatch; the conv is a plain multiply-add, as in JAX.

A layer's state is ``{"h": (B, R) f32, "conv": (B, W-1, R)}``; the decode
step returns a new one and the block writes it into the cache in place.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.layers import basic
from repro_torch.layers.param import ParamSpec, torch_dtype

__all__ = ["rglru_spec", "rglru_forward", "rglru_decode", "rglru_init_state"]

_C = 8.0


def rglru_spec(cfg):
    d = cfg.d_model
    r = cfg.rnn_width or d
    w = cfg.conv_width
    dt = torch_dtype(cfg.dtype)

    def dn(i, o, ax):
        return basic.dense_spec(i, o, ax, dt, False)

    return {
        "w_x": dn(d, r, ("embed", "rnn")),             # branch 1
        "w_gate": dn(d, r, ("embed", "rnn")),          # branch 2
        "conv": {"w": ParamSpec((w, r), (None, "rnn"), dtype=dt,
                                fan_in=w)},
        "w_r": dn(r, r, ("rnn", "mlp")),               # recurrence gate
        "w_i": dn(r, r, ("rnn", "mlp")),               # input gate
        "lam": {"w": ParamSpec((r,), ("rnn",), dtype=torch.float32,
                               init="ones")},
        "w_out": dn(r, d, ("rnn", "embed")),
    }


def _conv1d_causal(x: torch.Tensor, w: torch.Tensor,
                   state: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x: (B, S, R); w: (W, R); state: (B, W-1, R).
    Returns ``(out (B, S, R), new_state (B, W-1, R))``."""
    W = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], W - 1, x.shape[-1]), dtype=x.dtype,
                            device=x.device)
    xx = torch.cat([state, x], dim=1)
    out = sum(xx[:, i:i + x.shape[1]] * w[i] for i in range(W))
    new_state = xx[:, -(W - 1):] if W > 1 else state
    return out, new_state


def _gates(p, xb: torch.Tensor, mode=None, policy=None):
    r = torch.sigmoid(basic.dense_apply(
        p["w_r"], xb, mode=mode, policy=policy,
        site="recurrent_gates").float())
    i = torch.sigmoid(basic.dense_apply(
        p["w_i"], xb, mode=mode, policy=policy,
        site="recurrent_gates").float())
    lam = p["lam"]["w"]
    # jax.nn.softplus is logaddexp(x, 0) (torch's softplus thresholds)
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))
    log_a = -_C * softplus * r                               # (B, S, R), <= 0
    a = torch.exp(log_a)
    # jnp.maximum's gradient (half to each side at a tie), not clamp's
    gated_x = torch.sqrt(torch.maximum(1.0 - a * a, a.new_full((), 1e-12))) \
        * (i * xb.float())
    return a, gated_x


def rglru_init_state(cfg, batch: int, device) -> dict:
    r = cfg.rnn_width or cfg.d_model
    return {"h": torch.zeros((batch, r), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, r),
                                dtype=torch_dtype(cfg.dtype), device=device)}


def _combine(left, right):
    al, bl = left
    ar, br = right
    return al * ar, br + ar * bl


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Interleave along dim 1: even[0], odd[0], even[1], ...  (``even`` has
    as many entries as ``odd`` or one more)."""
    n = even.shape[1] + odd.shape[1]
    out = even.new_empty((even.shape[0], n) + tuple(even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _assoc_scan(elems):
    """Inclusive scan of ``(a, b)`` pairs along dim 1 under
    :func:`_combine`: the recursion of ``jax.lax.associative_scan`` (pair
    adjacent entries, scan the pairs, fill in the even entries), so every
    entry is combined from the same partial products in the same order.
    O(log S) levels of whole-tensor ops, not S steps."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine([e[:, 0:-1:2] for e in elems],
                       [e[:, 1::2] for e in elems])
    odd = _assoc_scan(reduced)
    if n % 2 == 0:
        even = _combine([e[:, :-1] for e in odd],
                        [e[:, 2::2] for e in elems])
    else:
        even = _combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def rglru_forward(p, x: torch.Tensor, *, cfg, state=None,
                  mode: Optional[str] = None, policy=None):
    """Full-sequence forward.  Returns ``(y, final_state)``."""
    B = x.shape[0]
    if state is None:
        state = rglru_init_state(cfg, B, x.device)
    xb = basic.dense_apply(p["w_x"], x, mode=mode, out_dtype=x.dtype,
                           policy=policy, site="recurrent_proj")
    gate = basic.dense_apply(p["w_gate"], x, mode=mode, policy=policy,
                             site="recurrent_proj")
    xb, conv_state = _conv1d_causal(xb, p["conv"]["w"], state["conv"])
    a, gx = _gates(p, xb, mode, policy)
    # h_t = a_t h_{t-1} + gx_t: fold the carried-in state as a seed step
    a0 = torch.ones((B, 1, a.shape[-1]), dtype=a.dtype, device=a.device)
    aa = torch.cat([a0, a], dim=1)
    bb = torch.cat([state["h"][:, None, :], gx], dim=1)
    _, hs = _assoc_scan([aa, bb])
    h = hs[:, 1:]                                            # drop seed step
    new_state = {"h": h[:, -1], "conv": conv_state}
    merged = h.to(x.dtype) * F.gelu(gate.float(),
                                    approximate="tanh").to(x.dtype)
    y = basic.dense_apply(p["w_out"], merged, mode=mode, out_dtype=x.dtype,
                          policy=policy, site="recurrent_proj")
    return y, new_state


def rglru_decode(p, x: torch.Tensor, state, *, cfg,
                 mode: Optional[str] = None, policy=None):
    """Single-token decode (the sequential step); x (B, 1, D).  Returns
    ``(y, new_state)``, the state in new tensors."""
    xb = basic.dense_apply(p["w_x"], x, mode=mode, out_dtype=x.dtype,
                           policy=policy, site="recurrent_proj")
    gate = basic.dense_apply(p["w_gate"], x, mode=mode, policy=policy,
                             site="recurrent_proj")
    xb, conv_state = _conv1d_causal(xb, p["conv"]["w"], state["conv"])
    a, gx = _gates(p, xb, mode, policy)
    h = a[:, 0] * state["h"] + gx[:, 0]
    merged = h[:, None].to(x.dtype) * F.gelu(
        gate.float(), approximate="tanh").to(x.dtype)
    y = basic.dense_apply(p["w_out"], merged, mode=mode, out_dtype=x.dtype,
                          policy=policy, site="recurrent_proj")
    return y, {"h": h, "conv": conv_state}
