"""Mixture-of-Experts block: the PyTorch port of ``repro/models/moe.py`` for
one card -- top-k routing, capacity-bounded sort-based dispatch and the
batched expert GEMMs (GShard/Switch style, dropless up to the capacity
factor).

The JAX package runs the block inside ``shard_map`` under a mesh (tokens
over the data axes, the expert hidden axis over ``model``, one psum after
the down-projection).  So does the port under a mesh
(``models/blocks.py::_apply_moe``): each rank routes its own batch shard's
tokens, contracts the experts' hidden slice of this model rank
(``psum_axes``) and sums the down-projection over ``model``; the aux loss
is averaged over the data axes.  The router step (logits, softmax, top-k, renormalised gates) is
:func:`moe_route` and the sort-based dispatch :func:`moe_dispatch`, so a
caller can hold either on its own.

Every shape is a function of the token count T alone and nothing reads a
tensor's value back to the host, so the block can be captured into a CUDA
graph: the per-expert counts are a scatter-add of ones (``torch.bincount``
reads its maximum back), top-k is the first K of a stable descending sort
(``jax.lax.top_k`` puts the lower index first among equal values, which
``torch.topk`` does not promise), and the combine adds each token's
contributions left to right in ascending expert order, the order in which
the JAX package's scatter-add visits them, without atomics (a float
``index_add_`` on CUDA adds in a varying order).

The router weight and the batched ``(E, d, f)`` expert weights may arrive
as :class:`repro_torch.core.prepared.PreparedOperand` leaves
(:meth:`repro_torch.models.lm.LM.prepare_params`): ``fs_einsum`` then
streams the prepared column slabs, on K1 for the router and K2/K3 for the
experts under ``square_pallas``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.einsum import fs_einsum
from repro_torch.core.prepared import PreparedOperand
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import context as dctx
from repro_torch.layers.param import ParamSpec, torch_dtype

__all__ = ["moe_spec", "moe_capacity", "moe_route", "moe_dispatch",
           "moe_apply_local"]


def moe_spec(cfg):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = torch_dtype(cfg.dtype)
    return {
        "router": {"w": ParamSpec((d, e), ("embed", None), torch.float32,
                                  fan_in=d)},
        "w_gate": {"w": ParamSpec((e, d, f), ("expert", "embed", "mlp"),
                                  dt, fan_in=d)},
        "w_up": {"w": ParamSpec((e, d, f), ("expert", "embed", "mlp"), dt,
                                fan_in=d)},
        "w_down": {"w": ParamSpec((e, f, d), ("expert", "mlp", "embed"),
                                  dt, fan_in=f)},
    }


def moe_capacity(n_tokens: int, cfg) -> int:
    """Slots per expert for ``n_tokens`` routed rows: every row the caller
    passes counts, padding included, as in the JAX package.

    >>> from repro_torch.configs import get_config
    >>> cfg = get_config("moonshot-v1-16b-a3b")
    >>> moe_capacity(8, cfg), moe_capacity(32, cfg), moe_capacity(184, cfg)
    (4, 4, 24)
    """
    cap = int(n_tokens * cfg.topk * cfg.capacity_factor / cfg.n_experts) + 1
    return max(4, cap + (-cap) % 4)


def moe_route(p, x: torch.Tensor, *, cfg, mode: Optional[str] = None,
              policy=None):
    """The router step over ``x`` (T, D): f32 logits at site
    ``moe_router``, their softmax ``probs`` (T, E), and the top-k experts
    ``expert_idx`` (T, K) with their gates renormalised to sum to one.
    Returns ``(probs, gate_vals, expert_idx)``.

    Among equal probabilities the lower expert index comes first, as
    ``jax.lax.top_k`` orders them:

    >>> from repro_torch.configs import get_config
    >>> cfg = get_config("mixtral-8x7b").reduced()
    >>> p = {"router": {"w": torch.zeros(cfg.d_model, cfg.n_experts)}}
    >>> _, g, idx = moe_route(p, torch.ones(3, cfg.d_model), cfg=cfg)
    >>> idx.tolist(), g[0].tolist()
    ([[0, 1], [0, 1], [0, 1]], [0.5, 0.5])
    """
    K = cfg.topk
    logits = fs_einsum("td,de->te", x.float(), p["router"]["w"], mode=mode,
                       policy=policy, site="moe_router")
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = vals[:, :K], idx[:, :K]
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)
    return probs, gate_vals, expert_idx


def moe_dispatch(expert_idx: torch.Tensor, gate_vals: torch.Tensor,
                 n_experts: int, capacity: int):
    """Sort the (T*K) assignments by expert (stable, so within an expert
    by token, then top-k slot) and give each its rank among its expert's
    assignments.  Returns a dict of the sorted assignments' token ``st``,
    gate ``sg``, ``keep`` (rank < capacity) and ``dest`` (``expert * C +
    rank``, or the sink row ``E * C`` for a dropped one), the per-expert
    ``counts`` (E,) and ``order`` (sorted position -> flat assignment
    index)."""
    T, K = expert_idx.shape
    E, C = n_experts, capacity
    dev = expert_idx.device
    flat_expert = expert_idx.reshape(-1)
    flat_token = torch.arange(T, device=dev)[:, None].expand(T, K).reshape(-1)
    se, order = torch.sort(flat_expert, stable=True)
    st, sg = flat_token[order], gate_vals.reshape(-1)[order]
    counts = torch.zeros(E, dtype=torch.int64, device=dev).scatter_add_(
        0, flat_expert, torch.ones_like(flat_expert))
    offsets = torch.cumsum(counts, 0) - counts              # exclusive
    rank = torch.arange(T * K, device=dev) - offsets[se]
    keep = rank < C
    dest = torch.where(keep, se * C + rank, torch.full_like(rank, E * C))
    return {"st": st, "sg": sg, "keep": keep, "dest": dest,
            "counts": counts, "order": order}


def _tp_experts(p, mesh, axis: str):
    """The expert weights' hidden (mlp) slice of this rank on ``axis``
    (a prepared stack is unwrapped: its corrections are of the whole
    hidden axis, as JAX's ``shard_map`` in_specs slice the raw tensor)."""
    def raw(w):
        return w.kn_source() if isinstance(w, PreparedOperand) else w
    return dict(p, **{
        "w_gate": {"w": coll.slice_from(raw(p["w_gate"]["w"]), mesh, axis,
                                        2)},
        "w_up": {"w": coll.slice_from(raw(p["w_up"]["w"]), mesh, axis, 2)},
        "w_down": {"w": coll.slice_from(raw(p["w_down"]["w"]), mesh, axis,
                                        1)}})


def moe_apply_local(p, x: torch.Tensor, *, cfg, mode: Optional[str] = None,
                    psum_axes=None, policy=None):
    """MoE over a local token block: ``x`` (T, D) (callers flatten B*S).

    ``psum_axes``: the mesh axis (a one-name tuple) the expert hidden axis
    is tensor-parallel over, under :func:`~repro_torch.distributed.context.
    current_mesh`; this rank contracts its hidden slice and the
    down-projection is summed over the axis.  None outside a mesh.
    Returns ``(out (T, D) in x's dtype, aux_loss f32 scalar)``."""
    mesh = dctx.current_mesh() if psum_axes else None
    if mesh is not None:
        (axis,) = psum_axes
        p = _tp_experts(p, mesh, axis)
    T, D = x.shape
    E, K = cfg.n_experts, cfg.topk
    C = moe_capacity(T, cfg)
    probs, gate_vals, expert_idx = moe_route(p, x, cfg=cfg, mode=mode,
                                             policy=policy)
    d = moe_dispatch(expert_idx, gate_vals, E, C)

    # ---- dispatch: (E*C + 1 sink, D) buffer; only the sink row is
    # written more than once, and it is discarded ----
    xt = x.to(torch_dtype(cfg.dtype))
    buf = torch.zeros((E * C + 1, D), dtype=xt.dtype, device=x.device)
    buf[d["dest"]] = xt[d["st"]]
    eb = buf[:E * C].reshape(E, C, D)
    if mesh is not None:
        eb = coll.copy_to(eb, mesh, axis)     # every hidden slice reads it

    # ---- batched expert GEMMs (fair-square dispatch over the expert axis)
    gate_h = fs_einsum("ecd,edf->ecf", eb, p["w_gate"]["w"], mode=mode,
                       policy=policy, site="moe_expert")
    up_h = fs_einsum("ecd,edf->ecf", eb, p["w_up"]["w"], mode=mode,
                     policy=policy, site="moe_expert")
    h = (F.silu(gate_h.float()) * up_h.float()).to(xt.dtype)
    y = fs_einsum("ecf,efd->ecd", h, p["w_down"]["w"], mode=mode,
                  policy=policy, site="moe_expert").float()
    if mesh is not None:
        y = coll.reduce_from(y, mesh, axis)   # the TP combine

    # ---- combine: each token's kept contributions, weighted by their
    # gates, added from zero in ascending expert order ----
    y_flat = torch.cat([y.reshape(E * C, D), y.new_zeros(1, D)])
    contrib = y_flat[d["dest"]] * (d["sg"] * d["keep"])[:, None]
    inv = torch.empty_like(d["order"]).scatter_(
        0, d["order"], torch.arange(T * K, device=x.device))
    pos = torch.sort(inv.reshape(T, K), dim=1).values
    per_token = contrib[pos]                                # (T, K, D)
    out = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    for j in range(K):
        out = out + per_token[:, j]

    # ---- Switch aux loss: E * sum_e fraction_e * router_prob_e ----
    frac = d["counts"].float() / max(1, T * K)
    pmean = torch.mean(probs, dim=0)
    aux = E * torch.sum(frac * pmean)
    return out.to(x.dtype), aux
