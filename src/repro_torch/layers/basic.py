"""Basic layers, all GEMMs routed through the fair-square einsum dispatch:
the PyTorch port of ``repro/layers/basic.py``.

Parameters arrive as mappings (an ``nn.ParameterDict`` or, after
``LM.prepare_params``, a plain dict whose ``"w"`` may be a
:class:`~repro_torch.core.prepared.PreparedOperand`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import einsum as fse
from repro_torch.core import squares as sq
from repro_torch.layers.param import ParamSpec

__all__ = ["dense_spec", "dense_apply", "dense_tp_reduce", "embed_spec",
           "embed_apply",
           "rmsnorm_spec", "rmsnorm_apply", "layernorm_spec",
           "layernorm_apply", "rope", "activation"]


def dense_spec(d_in: int, d_out: int, axes: Tuple[Optional[str],
               Optional[str]], dtype=torch.bfloat16, bias: bool = False):
    spec = {"w": ParamSpec((d_in, d_out), axes, dtype=dtype, fan_in=d_in)}
    if bias:
        spec["b"] = ParamSpec((d_out,), (axes[1],), dtype=dtype,
                              init="zeros")
    return spec


def dense_apply(p, x: torch.Tensor, *, mode: Optional[str] = None,
                out_dtype: Optional[torch.dtype] = None, policy=None,
                site: str = "dense") -> torch.Tensor:
    """``x[..., d_in] @ w[d_in, d_out]`` through the fair-square dispatch,
    accumulated in ``accum_dtype(x.dtype)``."""
    w = p["w"]
    lead = x.shape[:-1]
    out = fse.fs_einsum("tk,kn->tn", x.reshape(-1, x.shape[-1]), w,
                        mode=mode, policy=policy, site=site,
                        preferred=sq.accum_dtype(x.dtype))
    out = out.reshape(*lead, w.shape[-1])
    if "b" in p:
        out = out + p["b"].to(out.dtype)
    if out_dtype is not None:
        out = out.to(out_dtype)
    return out


def dense_tp_reduce(p, x: torch.Tensor, *, mode: Optional[str] = None,
                    out_dtype: Optional[torch.dtype] = None,
                    axis: str = "model",
                    reduce_dtype: torch.dtype = torch.bfloat16, policy=None,
                    site: str = "dense") -> torch.Tensor:
    """Row-parallel dense (the contraction dim split over ``axis``) with an
    explicit reduced-precision sum, JAX's ``dense_tp_reduce``.

    Each rank contracts its K-shard of ``x`` and ``w`` through the
    fair-square dispatch, so the paper's corrections are computed on the
    local shard (a prepared weight is unwrapped: its global-K corrections
    do not apply to a shard), casts the partial to ``reduce_dtype`` and
    sums it over ``axis`` (:func:`~repro_torch.distributed.collectives.
    reduce_from`, whose cotangent is not summed again; the shards'
    cotangents are gathered).  Falls back to :func:`dense_apply` with no
    mesh, no such axis, or a contraction dim that does not divide."""
    from repro_torch.core.prepared import PreparedOperand
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import context as dctx
    mesh = dctx.current_mesh()
    w = p["w"]
    K = w.kn_shape[0] if isinstance(w, PreparedOperand) else w.shape[-2]
    n = coll.axis_size(mesh, axis) if mesh is not None else 1
    if n == 1 or K % n != 0:
        return dense_apply(p, x, mode=mode, out_dtype=out_dtype,
                           policy=policy, site=site)
    if isinstance(w, PreparedOperand):
        w = w.kn_source()
    wl = coll.slice_from(w, mesh, axis, 0)
    xl = coll.slice_from(x, mesh, axis, x.ndim - 1)
    part = fse.fs_einsum("tk,kn->tn", xl.reshape(-1, xl.shape[-1]), wl,
                         mode=mode, policy=policy, site=site,
                         preferred=sq.accum_dtype(xl.dtype))
    out = coll.reduce_from(part.to(reduce_dtype), mesh, axis)
    out = out.reshape(*x.shape[:-1], w.shape[-1])
    if "b" in p:
        out = out + p["b"].to(out.dtype)
    if out_dtype is not None:
        out = out.to(out_dtype)
    return out


def embed_spec(vocab: int, d: int, dtype=torch.bfloat16):
    return {"table": ParamSpec((vocab, d), ("vocab", "embed"), dtype=dtype,
                               init="embed", fan_in=d)}


def embed_apply(p, ids: torch.Tensor) -> torch.Tensor:
    return p["table"][ids]


def rmsnorm_spec(d: int):
    return {"scale": ParamSpec((d,), ("embed",), dtype=torch.float32,
                               init="zeros")}


def rmsnorm_apply(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + p["scale"])
    return y.to(x.dtype)


def layernorm_spec(d: int):
    return {"scale": ParamSpec((d,), ("embed",), dtype=torch.float32,
                               init="ones"),
            "bias": ParamSpec((d,), ("embed",), dtype=torch.float32,
                              init="zeros")}


def layernorm_apply(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding.  x: (..., seq, heads, head_dim); positions:
    (..., seq)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.arange(half, dtype=torch.float32, device=x.device) / half
    inv = torch.pow(theta, -freqs)                           # (half,)
    ang = positions[..., :, None].float() * inv
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def activation(name: str, x: torch.Tensor,
               gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "silu":
        return F.silu(x)
    if name in ("geglu", "swiglu"):
        if gate is None:
            raise ValueError(f"{name} needs a gate")
        act = F.gelu(gate, approximate="tanh") if name == "geglu" \
            else F.silu(gate)
        return act * x
    raise ValueError(f"unknown activation {name!r}")
