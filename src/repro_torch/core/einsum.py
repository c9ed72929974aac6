"""Square-aware einsum dispatch: the PyTorch port of ``repro/core/einsum.py``
(with its contraction audit, numerics guard and square-routed VJP).

``fs_einsum(spec, x, y)`` parses a two-operand spec, classifies each index
as batch / M / K / N, canonicalises the operands to ``(B, M, K) @ (B, K, N)``
and runs the contraction under a fair-square mode
(:mod:`repro_torch.core.matmul`).  ``standard`` calls ``torch.einsum``
verbatim, except for integer operands on CUDA, which has no integer
einsum: there :func:`_standard` runs it in float64 and wraps to the dtype
``jnp.einsum`` returns.  Mode resolution: ``policy.lookup(site)`` >
``mode`` > the process default.

After every contraction, whatever its mode, ``_dispatch`` notes its
``B*M*K*N`` scalar multiplies and served mode into each open
:func:`repro_torch.core.counting.track_contractions` counter.  Under an
enabled guard policy (:mod:`repro_torch.core.guards`) a square-routed
output that is not finite records a trip in
:class:`repro_torch.kernels.routing.RouteHealth` and is recomputed on
``standard``; a demoted key runs ``standard`` from the start.  Both are
noted ``demoted=True``.  Under a CUDA graph capture
(:mod:`repro_torch.core.graphs`) there is no in-line check: a compiled
guard policy emits a finite probe into the graph instead, and under
:func:`repro_torch.core.counting.compiled_audit` a runtime note joins the
contraction note, so that every replay is audited.

Under autograd (grad mode on, float operands, one of them requiring grad)
the call goes through :class:`_FsEinsumVJP`, a ``torch.autograd.Function``
whose backward re-enters ``fs_einsum`` for both gradients, at the sites
``<site>.bwd_x`` (dL/dx) and ``<site>.bwd_w`` (dL/dW), under the forward's
mode and policy: the paper's one-square-a-multiply applied to the whole
training dataflow, each gradient audited, guarded and overridable by
policy as a site of its own.  The backward is itself differentiable, so
second-order gradients go through the same dispatch.  ``$REPRO_EINSUM_VJP=0``
turns the VJP off: the torch-level modes are then differentiated
mechanically, and ``square_pallas``, whose kernels autograd cannot see
through, raises when a gradient is requested.

Supported specs: two operands, explicit ``->``, an optional ellipsis, no
repeated index within one operand.  Indices in one operand only and not in
the output are summed out first (einsum semantics).
"""
from __future__ import annotations

import dataclasses
import math
import os
import string
from typing import Optional, Tuple

import torch

from repro_torch.core import counting, graphs, guards
from repro_torch.core import matmul as fsmm
from repro_torch.core import squares as sq
from repro_torch.core.prepared import PreparedOperand, unwrap

__all__ = ["fs_einsum", "ContractionPlan", "plan_contraction",
           "resolve_mode", "vjp_enabled"]

# Escape hatch: REPRO_EINSUM_VJP=0 turns the square-routed VJP off.
_VJP_ENV = "REPRO_EINSUM_VJP"


def vjp_enabled() -> bool:
    return os.environ.get(_VJP_ENV, "1") != "0"


@dataclasses.dataclass(frozen=True)
class ContractionPlan:
    """Index classification of a two-operand contraction spec (see
    ``repro.core.einsum.ContractionPlan``)."""
    x_dims: str
    y_dims: str
    out_dims: str
    batch: str
    m: str
    k: str
    n: str
    x_sum: str
    y_sum: str


def _expand_ellipsis(spec: str, x_ndim: int, y_ndim: int) -> str:
    lhs, out = spec.split("->")
    xs, ys = lhs.split(",")
    n_x = x_ndim - len(xs.replace("...", ""))
    n_y = y_ndim - len(ys.replace("...", ""))
    widths = [w for t, w in ((xs, n_x), (ys, n_y)) if "..." in t]
    if not widths:
        return spec
    if min(widths) != max(widths):
        raise ValueError(f"fs_einsum does not support broadcasting ellipses "
                         f"of different rank in {spec!r}")
    used = set(spec)
    ell = "".join(c for c in string.ascii_letters if c not in used)[:widths[0]]
    return spec.replace("...", ell)


def plan_contraction(spec: str, x_shape: Tuple[int, ...],
                     y_shape: Tuple[int, ...]) -> ContractionPlan:
    """Parse and classify a two-operand einsum spec."""
    spec = spec.replace(" ", "")
    if "->" not in spec or spec.count(",") != 1:
        raise ValueError(f"fs_einsum needs a two-operand spec with explicit "
                         f"'->', got {spec!r}")
    spec = _expand_ellipsis(spec, len(x_shape), len(y_shape))
    lhs, out = spec.split("->")
    xs, ys = lhs.split(",")
    if len(xs) != len(x_shape) or len(ys) != len(y_shape):
        raise ValueError(f"spec {spec!r} does not match operand ranks "
                         f"{len(x_shape)} and {len(y_shape)}")
    if len(set(xs)) != len(xs) or len(set(ys)) != len(ys) \
            or len(set(out)) != len(out):
        raise ValueError(f"repeated index within one term of {spec!r} "
                         f"(diagonals) is not supported")
    for d in out:
        if d not in xs and d not in ys:
            raise ValueError(f"output index {d!r} of {spec!r} appears in "
                             f"no operand")
    batch = "".join(d for d in xs if d in ys and d in out)
    k = "".join(d for d in xs if d in ys and d not in out)
    m = "".join(d for d in xs if d not in ys and d in out)
    n = "".join(d for d in ys if d not in xs and d in out)
    x_sum = "".join(d for d in xs if d not in ys and d not in out)
    y_sum = "".join(d for d in ys if d not in xs and d not in out)
    return ContractionPlan(xs, ys, out, batch, m, k, n, x_sum, y_sum)


def resolve_mode(mode: Optional[str], policy, site: Optional[str]) -> str:
    """policy[site] > explicit mode > the process default
    (:func:`repro_torch.core.matmul.set_default_mode`)."""
    if policy is not None:
        pmode = policy.lookup(site)
        if pmode is not None:
            return pmode
    return mode if mode is not None else fsmm.get_default_mode()


def _sizes(plan: ContractionPlan, x_shape, y_shape) -> dict:
    sizes = dict(zip(plan.x_dims, x_shape))
    for d, s in zip(plan.y_dims, y_shape):
        if d in sizes and sizes[d] != s:
            raise ValueError(
                f"size mismatch for index {d!r}: {sizes[d]} vs {s}")
        sizes[d] = s
    return sizes


def _sum_out(t: torch.Tensor, dims: str, drop: str):
    if not drop:
        return t, dims
    axes = tuple(dims.index(d) for d in drop)
    t = torch.sum(t, dim=axes) if t.dtype.is_floating_point \
        else torch.sum(t, dim=axes, dtype=sq.accum_dtype(t.dtype))
    return t, "".join(d for d in dims if d not in drop)


def _to_canonical(t: torch.Tensor, dims: str, target: str,
                  shape3) -> torch.Tensor:
    perm = tuple(dims.index(d) for d in target)
    if perm != tuple(range(len(perm))):
        t = t.permute(perm)
    return t.reshape(shape3)


def _batched_matmul(a: torch.Tensor, b, mode: str,
                    preferred: Optional[torch.dtype],
                    fold: int = 1) -> torch.Tensor:
    """Canonical (B, M, K) @ (B, K, N) under a fair-square mode.  ``b``
    may be a batched PreparedOperand: the non-kernel modes use its raw
    source, the kernels its prepared ``canon``/``corr``.

    ``square_pallas`` resolves its route with
    :func:`repro_torch.kernels.routing.select_matmul_route` at one copy's
    shape (batch B / ``fold``): K2 (``batched``, and ``kernel``, whose K1
    equals K2 bit for bit on every element), K3 (``fold``) or the
    ``virtual`` form below the kernel-overhead floor."""
    if mode == "square_virtual":
        return fsmm.pm_matmul_virtual(a, unwrap(b), preferred)
    if mode == "square_exact":
        return fsmm.pm_matmul_exact(a, unwrap(b))
    if mode == "square_scan":
        return fsmm.pm_matmul_scan(a, unwrap(b))
    if mode == "square_pallas":
        from repro_torch.kernels import ops as kops   # lazy: import cycle
        from repro_torch.kernels import routing
        B, M, K = a.shape
        N = unwrap(b).shape[-1]
        route = routing.select_matmul_route(M, N, K, batch=B // fold,
                                            dtype=a.dtype)
        if route.name == "virtual":
            return fsmm.pm_matmul_virtual(a, unwrap(b), preferred)
        return kops.sq_matmul_local(a, b, fold=(route.name == "fold"))
    raise ValueError(f"unknown matmul mode {mode!r}; expected one of "
                     f"{fsmm.MODES}")


def _standard(spec: str, x: torch.Tensor, y: torch.Tensor,
              preferred: Optional[torch.dtype]) -> torch.Tensor:
    """``jnp.einsum(spec, x, y, preferred_element_type=preferred)``: the
    operands' promoted dtype, or ``preferred``.  CUDA has no integer
    einsum, so integer operands there take ``core/matmul.py``'s exact path:
    a float64 product (exact while every partial sum stays below 2**53),
    then a wrap to the result dtype, as the CPU's integer einsum wraps."""
    if preferred is not None:
        x, y = x.to(preferred), y.to(preferred)
    dt = torch.promote_types(x.dtype, y.dtype)
    if dt.is_floating_point or dt.is_complex:
        # jnp.einsum promotes mixed operands; torch.einsum refuses them
        return torch.einsum(spec, x.to(dt), y.to(dt))
    if x.device.type != "cuda":
        return torch.einsum(spec, x, y)
    out = torch.einsum(spec, x.double(), y.double())
    return out.to(torch.int64).to(dt)


def _dispatch(spec: str, x: torch.Tensor, y, mode: str,
              site: Optional[str], preferred: Optional[torch.dtype],
              fold: int = 1):
    """Execute one contraction under a resolved mode: canonicalisation,
    route-health demotion, the finite guard and the counting note all
    live here."""
    plan = plan_contraction(spec, tuple(x.shape), tuple(y.shape))
    sizes = _sizes(plan, x.shape, y.shape)
    prod = lambda dims: math.prod(sizes[d] for d in dims)   # noqa: E731
    B, M, K, N = (prod(plan.batch), prod(plan.m), prod(plan.k),
                  prod(plan.n))
    if fold < 1 or B % fold:
        raise ValueError(f"fold {fold} does not divide the batch {B} of "
                         f"{spec!r}")

    # A call site whose square-routed output tripped the finite check
    # ``trip_limit`` times is demoted: served standard, noted demoted.
    gp = guards.guard_policy()
    hkey = health = None
    demoted = False
    if gp.enabled and mode in counting.SQUARE_MODES:
        from repro_torch.kernels import routing   # lazy: import cycle
        health = routing.route_health()
        hkey = routing.health_key(site or "einsum", (B, M, K, N), x.dtype)
        if health.is_demoted(hkey):
            mode, demoted = "standard", True

    out = _execute(spec, plan, sizes, (B, M, K, N), x, y, mode, preferred,
                   fold)
    if hkey is not None and not demoted:
        # check_finite is None under a CUDA graph capture, where nothing
        # can be read back: no in-line recompute there.  Under a compiled
        # guard policy the capture gets a finite probe instead, and the
        # step owner drains, demotes and retries after each replay.
        ok = guards.check_finite(out)
        if ok is False:
            health.record_trip(hkey, limit=gp.trip_limit)
            out = _execute(spec, plan, sizes, (B, M, K, N), x, y,
                           "standard", preferred)
            mode, demoted = "standard", True
        elif ok is None and gp.compiled:
            guards.emit_trace_probe(hkey, out)

    note = dict(site=site or "einsum", spec=spec, mode=mode,
                mults=B * M * K * N, demoted=demoted)
    counting.note_contraction(**note)
    if counting.compiled_audit_enabled() and graphs.capturing():
        # the replay twin of the note: tallied at every replay
        counting.emit_runtime_note(**note)
    return out


def _execute(spec: str, plan: ContractionPlan, sizes: dict, bmkn, x, y,
             mode: str, preferred: Optional[torch.dtype], fold: int = 1):
    """The contraction itself, under ``mode``."""
    if mode == "standard":
        return _standard(spec, x, unwrap(y), preferred)
    B, M, K, N = bmkn

    # A prepared y is used as prepared only when its layout IS the spec's:
    # nothing summed out, single k and n indices, and either no batch and
    # the (K, N) transpose matching how it was prepared, or one batch
    # index over an untransposed batched prep laid out (B, K, N) (the MoE
    # expert stack).  Otherwise its raw source is contracted (still
    # correct, prepared per call).
    p, yy = (y, None) if isinstance(y, PreparedOperand) else (None, y)
    if p is not None:
        usable = not plan.y_sum and len(plan.k) == 1 and len(plan.n) == 1
        if plan.batch:
            usable = (usable and p.kind == "matmul_batched"
                      and not p.transposed and len(plan.batch) == 1
                      and plan.y_dims == plan.batch + plan.k + plan.n)
        else:
            usable = (usable and p.kind == "matmul"
                      and plan.y_dims == ((plan.n + plan.k) if p.transposed
                                          else (plan.k + plan.n)))
        if not usable:
            yy, p = p.source, None

    xx, x_dims = _sum_out(x, plan.x_dims, plan.x_sum)
    if plan.batch:
        a = _to_canonical(xx, x_dims, plan.batch + plan.m + plan.k, (B, M, K))
        if p is None:
            yy, y_dims = _sum_out(yy, plan.y_dims, plan.y_sum)
            b = _to_canonical(yy, y_dims, plan.batch + plan.k + plan.n,
                              (B, K, N))
        else:
            b = p
        out = _batched_matmul(a, b, mode, preferred, fold)
    else:
        a = _to_canonical(xx, x_dims, plan.m + plan.k, (M, K))
        if p is None:
            yy, y_dims = _sum_out(yy, plan.y_dims, plan.y_sum)
            b = _to_canonical(yy, y_dims, plan.k + plan.n, (K, N))
        else:
            b = p
        out = fsmm.matmul(a, b, mode=mode, preferred=preferred)

    canon = plan.batch + plan.m + plan.n
    out = out.reshape(tuple(sizes[d] for d in canon))
    perm = tuple(canon.index(d) for d in plan.out_dims)
    if perm != tuple(range(len(perm))):
        out = out.permute(perm)
    return out


# --------------------------------------------------------------------------
# The VJP: both gradients of ``out = einsum(spec, x, y)`` are einsums of the
# cotangent with one operand,
#
#     dL/dx = einsum("out,y->x", g, y)        site  <site>.bwd_x
#     dL/dW = einsum("out,x->y", g, x)        site  <site>.bwd_w
#
# so the backward re-enters fs_einsum for each, rather than differentiating
# the dispatched primitives (which the kernels' ctypes launches would not
# let autograd do at all).
# --------------------------------------------------------------------------

def _unreduce(t: torch.Tensor, dims: str, full_dims: str,
              full_shape) -> torch.Tensor:
    """Broadcast a gradient back over axes that were summed out before the
    contraction (d(sum_s x)/dx broadcasts over s)."""
    if dims == full_dims:
        return t
    for ax, d in enumerate(full_dims):
        if d not in dims:
            t = t.unsqueeze(ax)
    return t.expand(full_shape)


def _einsum_grads(spec: str, x: torch.Tensor, ysrc: torch.Tensor, prep, g,
                  mode: str, policy, site: Optional[str], preferred,
                  need_x: bool, need_w: bool, fold: int = 1):
    """``(dx, dW)`` of ``fs_einsum(spec, x, y)`` for the cotangent ``g``, each
    through ``fs_einsum`` at its backward site (``None`` where not
    needed).  A prepared ``y`` gives dx its opposite-layout ``grad`` prep
    when it has one; otherwise dispatch falls back to its source.  Both
    keep the forward's batch axes, so they keep its ``fold``."""
    plan = plan_contraction(spec, tuple(x.shape), tuple(ysrc.shape))
    base = site or "einsum"
    x_red = "".join(d for d in plan.x_dims if d not in plan.x_sum)
    y_red = "".join(d for d in plan.y_dims if d not in plan.y_sum)
    dx = dw = None
    if need_x:
        y_dx = ysrc if prep is None else (
            prep.grad if prep.grad is not None else prep)
        if plan.y_sum:
            y_dx, _ = _sum_out(unwrap(y_dx), plan.y_dims, plan.y_sum)
        dx = fs_einsum(f"{plan.out_dims},{y_red}->{x_red}", g, y_dx,
                       mode=mode, policy=policy, site=f"{base}.bwd_x",
                       preferred=preferred, fold=fold)
        dx = _unreduce(dx, x_red, plan.x_dims, x.shape).to(x.dtype)
    if need_w:
        xr, _ = _sum_out(x, plan.x_dims, plan.x_sum)
        dw = fs_einsum(f"{plan.out_dims},{x_red}->{y_red}", g, xr,
                       mode=mode, policy=policy, site=f"{base}.bwd_w",
                       preferred=preferred, fold=fold)
        dw = _unreduce(dw, y_red, plan.y_dims, ysrc.shape).to(ysrc.dtype)
    return dx, dw


class _FsEinsumVJP(torch.autograd.Function):
    """``fs_einsum`` under autograd: the forward is :func:`_dispatch`, the
    backward :func:`_einsum_grads`.  The tensor inputs are ``x`` and ``y``'s
    source (a :class:`PreparedOperand` is not a tensor, so its ``source``
    stands in for it and receives dL/dW); ``prep`` rides along as a plain
    argument.  The backward is differentiable (no ``once_differentiable``):
    under ``create_graph`` its ``fs_einsum`` calls come back through this
    Function."""

    @staticmethod
    def forward(ctx, x, ysrc, prep, spec, mode, policy, site, preferred,
                fold):
        ctx.save_for_backward(x, ysrc)
        ctx.prep = prep
        ctx.args = (spec, mode, policy, site, preferred, fold)
        return _dispatch(spec, x, ysrc if prep is None else prep, mode, site,
                         preferred, fold)

    @staticmethod
    def backward(ctx, g):
        x, ysrc = ctx.saved_tensors
        spec, mode, policy, site, preferred, fold = ctx.args
        dx, dw = _einsum_grads(spec, x, ysrc, ctx.prep, g, mode, policy,
                               site, preferred, ctx.needs_input_grad[0],
                               ctx.needs_input_grad[1], fold)
        return dx, dw, None, None, None, None, None, None, None


def _wants_grad(x: torch.Tensor, ysrc: torch.Tensor) -> bool:
    """Whether autograd will ask this call for a gradient: grad mode on,
    float operands, and one of them requiring grad (JAX's ``_wants_vjp``,
    which tests for tracers).  Serving (no grad) and integer operands take
    the plain dispatch."""
    return (torch.is_grad_enabled() and x.dtype.is_floating_point
            and ysrc.dtype.is_floating_point
            and (x.requires_grad or ysrc.requires_grad))


def fs_einsum(spec: str, x: torch.Tensor, y, *, mode: Optional[str] = None,
              policy=None, site: Optional[str] = None,
              preferred: Optional[torch.dtype] = None,
              fold: int = 1) -> torch.Tensor:
    """Two-operand einsum through the fair-square contraction dispatch.

    ``mode``: fair-square mode (default: policy / caller / ``standard``);
    ``policy``: a ContractionPolicy consulted with ``site``;
    ``preferred``: accumulation dtype of the multiplier paths (square paths
    widen by ``accum_dtype``); ``fold``: the call stands for ``fold``
    copies of one contraction stacked on its leading batch axis (what
    ``jax.vmap`` of the JAX call computes): ``square_pallas`` routes at one
    copy's shape (batch / ``fold``), as the vmapped JAX call does, and both
    gradients keep it.

    >>> x = torch.arange(24.0).reshape(2, 3, 4)
    >>> y = torch.ones(2, 4, 5)
    >>> out = fs_einsum("bmk,bkn->bnm", x, y, mode="square_virtual")
    >>> tuple(out.shape)
    (2, 5, 3)
    >>> torch.allclose(out, torch.einsum("bmk,bkn->bnm", x, y))
    True

    Under autograd both gradients are square-routed sites of their own:

    >>> from repro_torch.core import counting
    >>> x = torch.ones(3, 4, requires_grad=True)
    >>> w = torch.full((4, 2), 0.5, requires_grad=True)
    >>> with counting.track_contractions() as ctr:
    ...     fs_einsum("mk,kn->mn", x, w, mode="square_virtual",
    ...               site="ffn").sum().backward()
    >>> sorted(ctr.by_site())
    ['ffn', 'ffn.bwd_w', 'ffn.bwd_x']
    >>> ctr.fraction_square, torch.equal(x.grad, torch.ones(3, 4))
    (1.0, True)
    """
    mode = resolve_mode(mode, policy, site)
    if mode not in fsmm.MODES:
        raise ValueError(f"unknown matmul mode {mode!r}; expected one of "
                         f"{fsmm.MODES}")
    ysrc = unwrap(y)
    if _wants_grad(x, ysrc):
        if vjp_enabled():
            prep = y if isinstance(y, PreparedOperand) else None
            return _FsEinsumVJP.apply(x, ysrc, prep, spec, mode, policy,
                                      site, preferred, fold)
        if mode == "square_pallas":
            raise RuntimeError(
                f"fs_einsum({spec!r}, site={site!r}): square_pallas cannot "
                f"be differentiated with {_VJP_ENV}=0 (autograd does not see "
                f"through the kernels' launches); unset {_VJP_ENV} to route "
                f"the gradients through the square-form VJP")
    return _dispatch(spec, x, y, mode, site, preferred, fold)
