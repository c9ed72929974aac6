"""Feed-forward blocks (gated and plain), fair-square routed: the PyTorch
port of ``repro/models/ffn.py``."""
from __future__ import annotations

from typing import Optional

from repro_torch.layers import basic
from repro_torch.layers.param import torch_dtype

__all__ = ["ffn_spec", "ffn_apply"]


def ffn_spec(cfg):
    d, f = cfg.d_model, cfg.d_ff
    dt = torch_dtype(cfg.dtype)
    bias = cfg.ffn_bias
    spec = {"w_up": basic.dense_spec(d, f, ("embed", "mlp"), dt, bias),
            "w_down": basic.dense_spec(f, d, ("mlp", "embed"), dt, bias)}
    if cfg.activation in ("swiglu", "geglu"):
        spec["w_gate"] = basic.dense_spec(d, f, ("embed", "mlp"), dt, bias)
    return spec


def ffn_apply(p, x, *, cfg, mode: Optional[str] = None, policy=None):
    up = basic.dense_apply(p["w_up"], x, mode=mode, policy=policy, site="ffn")
    if "w_gate" in p:
        gate = basic.dense_apply(p["w_gate"], x, mode=mode, policy=policy,
                                 site="ffn")
        h = basic.activation(cfg.activation, up, gate)
    else:
        h = basic.activation(cfg.activation, up)
    h = h.to(x.dtype)
    if cfg.tp_bf16_reduce:
        return basic.dense_tp_reduce(p["w_down"], h, mode=mode,
                                     out_dtype=x.dtype, policy=policy,
                                     site="ffn")
    return basic.dense_apply(p["w_down"], h, mode=mode, out_dtype=x.dtype,
                             policy=policy, site="ffn")
