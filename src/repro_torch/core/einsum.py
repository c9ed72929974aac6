"""Square-aware einsum dispatch: the PyTorch port of ``repro/core/einsum.py``
(forward only, with its contraction audit and numerics guard).

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
noted ``demoted=True``.

Supported specs: two operands, explicit ``->``, an optional ellipsis, no
repeated index within one operand.  Indices in one operand only and not in
the output are summed out first (einsum semantics).
"""
from __future__ import annotations

import dataclasses
import math
import string
from typing import Optional, Tuple

import torch

from repro_torch.core import counting, guards
from repro_torch.core import matmul as fsmm
from repro_torch.core import squares as sq
from repro_torch.core.prepared import PreparedOperand, unwrap

__all__ = ["fs_einsum", "ContractionPlan", "plan_contraction",
           "resolve_mode"]


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
                    preferred: Optional[torch.dtype]) -> torch.Tensor:
    """Canonical (B, M, K) @ (B, K, N) under a fair-square mode.

    ``square_pallas`` resolves its route with
    :func:`repro_torch.kernels.routing.select_matmul_route`: K2
    (``batched``), K3 (``fold``) or the ``virtual`` form below the
    kernel-overhead floor."""
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
        route = routing.select_matmul_route(M, N, K, batch=B, dtype=a.dtype)
        if route.name == "virtual":
            return fsmm.pm_matmul_virtual(a, unwrap(b), preferred)
        return kops.sq_matmul_local(a, unwrap(b),
                                    fold=(route.name == "fold"))
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
    if x.device.type != "cuda" or dt.is_floating_point or dt.is_complex:
        return torch.einsum(spec, x, y)
    out = torch.einsum(spec, x.double(), y.double())
    return out.to(torch.int64).to(dt)


def _dispatch(spec: str, x: torch.Tensor, y, mode: str,
              site: Optional[str], preferred: Optional[torch.dtype]):
    """Execute one contraction under a resolved mode: canonicalisation,
    route-health demotion, the finite guard and the counting note all
    live here."""
    plan = plan_contraction(spec, tuple(x.shape), tuple(y.shape))
    sizes = _sizes(plan, x.shape, y.shape)
    prod = lambda dims: math.prod(sizes[d] for d in dims)   # noqa: E731
    B, M, K, N = (prod(plan.batch), prod(plan.m), prod(plan.k),
                  prod(plan.n))

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

    out = _execute(spec, plan, sizes, (B, M, K, N), x, y, mode, preferred)
    if hkey is not None and not demoted and not guards.check_finite(out):
        health.record_trip(hkey, limit=gp.trip_limit)
        out = _execute(spec, plan, sizes, (B, M, K, N), x, y, "standard",
                       preferred)
        mode, demoted = "standard", True

    counting.note_contraction(site=site or "einsum", spec=spec, mode=mode,
                              mults=B * M * K * N, demoted=demoted)
    return out


def _execute(spec: str, plan: ContractionPlan, sizes: dict, bmkn, x, y,
             mode: str, preferred: Optional[torch.dtype]):
    """The contraction itself, under ``mode``."""
    if mode == "standard":
        return _standard(spec, x, unwrap(y), preferred)
    B, M, K, N = bmkn

    # A prepared y is used as prepared only when its (K, N) layout IS the
    # spec's: nothing summed out, single k and n indices, no batch, and
    # the transpose matching how it was prepared.  Otherwise its raw
    # source is contracted (still correct, prepared per call).
    p, yy = (y, None) if isinstance(y, PreparedOperand) else (None, y)
    if p is not None:
        usable = (not plan.y_sum and not plan.batch and len(plan.k) == 1
                  and len(plan.n) == 1
                  and plan.y_dims == ((plan.n + plan.k) if p.transposed
                                      else (plan.k + plan.n)))
        if not usable:
            yy, p = p.source, None

    xx, x_dims = _sum_out(x, plan.x_dims, plan.x_sum)
    if plan.batch:
        yy, y_dims = _sum_out(yy, plan.y_dims, plan.y_sum)
        a = _to_canonical(xx, x_dims, plan.batch + plan.m + plan.k, (B, M, K))
        b = _to_canonical(yy, y_dims, plan.batch + plan.k + plan.n, (B, K, N))
        out = _batched_matmul(a, b, mode, preferred)
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


def fs_einsum(spec: str, x: torch.Tensor, y, *, mode: Optional[str] = None,
              policy=None, site: Optional[str] = None,
              preferred: Optional[torch.dtype] = None) -> torch.Tensor:
    """Two-operand einsum through the fair-square contraction dispatch.

    ``mode``: fair-square mode (default: policy / caller / ``standard``);
    ``policy``: a ContractionPolicy consulted with ``site``;
    ``preferred``: accumulation dtype of the multiplier paths (square paths
    widen by ``accum_dtype``).

    >>> x = torch.arange(24.0).reshape(2, 3, 4)
    >>> y = torch.ones(2, 4, 5)
    >>> out = fs_einsum("bmk,bkn->bnm", x, y, mode="square_virtual")
    >>> tuple(out.shape)
    (2, 5, 3)
    >>> torch.allclose(out, torch.einsum("bmk,bkn->bnm", x, y))
    True
    """
    mode = resolve_mode(mode, policy, site)
    if mode not in fsmm.MODES:
        raise ValueError(f"unknown matmul mode {mode!r}; expected one of "
                         f"{fsmm.MODES}")
    return _dispatch(spec, x, y, mode, site, preferred)
