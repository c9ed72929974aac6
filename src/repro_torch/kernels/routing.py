"""Route planner for the ``square_pallas`` mode and the route-health
circuit breaker: the PyTorch port of ``repro/kernels/routing.py`` (route
rules, ``REPRO_ROUTE`` and :class:`RouteHealth`).

``matmul`` routes: ``kernel`` (K1), ``batched`` (K2), ``fold`` (K3) and
``virtual`` (the square-form contract through the
multiplier, below the kernel-overhead floor).  ``conv2d`` routes: ``fused``
(K7, the implicit-GEMM conv kernel: no patch tensor) and ``im2col``
(materialised patches through K1).  ``paged_attn`` routes:
``kernel`` (K4, the block-table-streaming kernel) and ``gather`` (a dense
gathered window plus two einsums).

The thresholds are the JAX package's, which were set on its CPU interpret
host; they are carried over as the same rules and are still to be measured
again on the H100.

``REPRO_ROUTE`` keeps its meaning: a bare route name applies to every kind
it is valid for (``kernel`` pins matmul and paged_attn), ``kind=route``
lists scope it, ``auto`` defers to the rules.  Each selector counts its
decisions in its ``taken`` counter, so a run can show which routes it used.

:class:`RouteHealth` is the per-(site, shape, dtype) breaker the numerics
guard (:mod:`repro_torch.core.guards`) records its trips in; its keys
(:func:`health_key`) are the JAX package's, letter for letter.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import os
from typing import Dict, List, Optional

import torch

from repro_torch.core import squares as sq
from repro_torch.obs import trace as obs_trace

__all__ = ["Route", "select_matmul_route", "select_conv2d_route",
           "select_paged_attn_route", "conv2d_patch_bytes", "MATMUL_ROUTES",
           "CONV2D_ROUTES", "PAGED_ATTN_ROUTES", "VIRTUAL_FLOOR_MULTS",
           "FOLD_STEP_LANE_OPS", "FOLD_MIN_BATCH", "IM2COL_PATCH_BYTES_MAX",
           "IM2COL_K_MAX", "PAGED_KERNEL_MAX_S", "PAGED_KERNEL_MIN_T",
           "health_key", "RouteHealth", "route_health", "reset_route_health",
           "route_epoch"]

logger = logging.getLogger(__name__)

MATMUL_ROUTES = ("kernel", "batched", "fold", "virtual")
CONV2D_ROUTES = ("fused", "im2col")
PAGED_ATTN_ROUTES = ("kernel", "gather")
_ALL_ROUTES = frozenset(MATMUL_ROUTES + CONV2D_ROUTES + PAGED_ATTN_ROUTES)

# Interpret-host values of the JAX package, to be re-measured on the H100.
VIRTUAL_FLOOR_MULTS = 32768          # B*M*K*N below which -> virtual
FOLD_STEP_LANE_OPS = 8 * 4096        # per-element PM lane-ops -> fold
FOLD_MIN_BATCH = 4
_KC_MNK_MAX = 32                     # repro.kernels.tuning.KC_MNK_MAX
IM2COL_PATCH_BYTES_MAX = 2 * 1024 * 1024   # tuning.CACHE_BUDGET
IM2COL_K_MAX = 128                   # tuning.LANE: K volume -> im2col
PAGED_KERNEL_MAX_S = 8               # query rows above which -> gather
PAGED_KERNEL_MIN_T = 64              # pool length below which -> gather


@dataclasses.dataclass(frozen=True)
class Route:
    """A resolved route choice plus why it was chosen."""
    name: str
    reason: str

    def __str__(self):
        return self.name


def _env_route(kind: str, valid) -> Optional[str]:
    """Parse ``REPRO_ROUTE`` for ``kind`` (the JAX package's grammar)."""
    v = os.environ.get("REPRO_ROUTE", "").strip()
    if not v or v == "auto":
        return None
    if "=" in v:
        for part in v.split(","):
            key, _, val = part.partition("=")
            if key.strip() == kind:
                val = val.strip()
                if val in ("", "auto"):
                    return None
                if val not in valid:
                    raise ValueError(
                        f"REPRO_ROUTE: unknown {kind} route {val!r}; "
                        f"expected one of {tuple(valid)} or 'auto'")
                return val
        return None
    if v in valid:
        return v
    if v in _ALL_ROUTES:
        return None                 # valid for another kind only
    raise ValueError(f"REPRO_ROUTE: unknown route {v!r}; expected one of "
                     f"{tuple(sorted(_ALL_ROUTES))} or 'auto'")


def _pm_tile_vpu_ops(m: int, n: int, k: int, kc: int) -> float:
    """repro.core.cost_model.pm_tile_vpu_ops with 3 ops per PM term."""
    return float(m) * n * k * (3 + 1.0 / max(1, kc))


def conv2d_patch_bytes(oh: int, ow: int, kh: int, kw: int, cin: int,
                       batch: int = 1, itemsize: int = 4) -> int:
    """Bytes of the materialised im2col patch matrix ``(B*oh*ow,
    cin*kh*kw)`` (``repro.core.cost_model.conv2d_patch_bytes``): the
    planner keys the fused-vs-im2col choice on whether it stays
    cache-resident."""
    return batch * oh * ow * cin * kh * kw * itemsize


def _decide(fn, route: Route) -> Route:
    fn.taken[route.name] += 1
    return route


def select_matmul_route(m: int, n: int, k: int, *, batch: int = 1,
                        dtype: torch.dtype = torch.float32) -> Route:
    """Resolve the ``square_pallas`` route of a (possibly batched) GEMM."""
    fn = select_matmul_route
    env = _env_route("matmul", MATMUL_ROUTES)
    if env is not None:
        return _decide(fn, Route(env, "REPRO_ROUTE override"))
    mults = batch * m * n * k
    if mults < VIRTUAL_FLOOR_MULTS:
        return _decide(fn, Route("virtual", f"volume {mults} below "
                                            f"kernel-overhead floor "
                                            f"{VIRTUAL_FLOOR_MULTS}"))
    if batch == 1:
        return _decide(fn, Route("kernel", "unbatched GEMM"))
    step_ops = _pm_tile_vpu_ops(m, n, k, kc=_KC_MNK_MAX)
    if batch >= FOLD_MIN_BATCH and step_ops < FOLD_STEP_LANE_OPS:
        return _decide(fn, Route("fold", f"per-element PM work "
                                         f"{step_ops:.0f} lane-ops below "
                                         f"the grid-step floor "
                                         f"{FOLD_STEP_LANE_OPS}"))
    return _decide(fn, Route("batched",
                             "per-element work amortizes its grid step"))


def select_conv2d_route(oh: int, ow: int, kh: int, kw: int, cin: int,
                        cout: int, *, batch: int = 1,
                        dtype: torch.dtype = torch.float32) -> Route:
    """Resolve the ``square_pallas`` route of a 2D convolution: ``im2col``
    when the patch matrix is at most :data:`IM2COL_PATCH_BYTES_MAX` and the
    K volume at most :data:`IM2COL_K_MAX`, else ``fused``."""
    fn = select_conv2d_route
    env = _env_route("conv2d", CONV2D_ROUTES)
    if env is not None:
        return _decide(fn, Route(env, "REPRO_ROUTE override"))
    kvol = cin * kh * kw
    patch = conv2d_patch_bytes(oh, ow, kh, kw, cin, batch=batch,
                               itemsize=sq.accum_dtype(dtype).itemsize)
    if patch <= IM2COL_PATCH_BYTES_MAX and kvol <= IM2COL_K_MAX:
        return _decide(fn, Route("im2col", f"patch matrix {patch}B "
                                           f"cache-resident and K volume "
                                           f"{kvol} below one lane group"))
    return _decide(fn, Route("fused", f"patch matrix {patch}B / K volume "
                                      f"{kvol} in the window-streaming "
                                      f"regime"))


def select_paged_attn_route(s: int, t: int, *, batch: int = 1,
                            kv_heads: int = 1, group: int = 1, hd: int = 64,
                            dtype: torch.dtype = torch.float32) -> Route:
    """Resolve the paged-KV attention read route of a decode/chunk step.

    ``s`` is the query-tile length, ``t`` the pool length the block table
    spans.  Integer dtypes always gather (K4's softmax is float-only)."""
    fn = select_paged_attn_route
    if not dtype.is_floating_point:
        return _decide(fn, Route("gather", f"{dtype} operands: the fused "
                                           f"softmax kernel is float-only"))
    env = _env_route("paged_attn", PAGED_ATTN_ROUTES)
    if env is not None:
        return _decide(fn, Route(env, "REPRO_ROUTE override"))
    gbytes = 2 * 2 * batch * t * kv_heads * hd * 4
    if s > PAGED_KERNEL_MAX_S:
        return _decide(fn, Route("gather", f"query tile {s} > "
                                           f"{PAGED_KERNEL_MAX_S}: "
                                           f"per-block rematerialization "
                                           f"outweighs the {gbytes}B "
                                           f"gather"))
    if t < PAGED_KERNEL_MIN_T:
        return _decide(fn, Route("gather", f"pool length {t} < "
                                           f"{PAGED_KERNEL_MIN_T}: gathered "
                                           f"window ({gbytes}B) too small "
                                           f"to amortize the block walk"))
    return _decide(fn, Route("kernel", f"long table walk (T={t}, S={s}) "
                                       f"streams past the {gbytes}B dense "
                                       f"gather"))


select_matmul_route.taken = collections.Counter()
select_conv2d_route.taken = collections.Counter()
select_paged_attn_route.taken = collections.Counter()


# --------------------------------------------------------------------------
# Route health: the per-(site, shape, dtype) circuit breaker.
#
# The numerics guard (repro_torch.core.guards) checks square-routed outputs
# for non-finite values; every trip is recorded here and its call is
# recomputed on the standard route.  After ``trip_limit`` trips of one key
# the key is DEMOTED: its call site is served on the standard route from
# then on.  A demotion is logged once per key and shows in the contraction
# audit (``mode="standard"``, ``demoted=True``).  State is per process and
# resettable (:func:`reset_route_health`), as a deployment re-arms its
# breakers on a model reload.
# --------------------------------------------------------------------------

def health_key(site: str, sizes, dtype: torch.dtype) -> str:
    """Circuit-breaker key of one contraction call site:
    ``site|BxMxKxN|float32``.

    ``sizes`` is any shape-describing tuple (the dispatcher passes the
    canonical ``(B, M, K, N)``); ``dtype`` is the *operand* dtype, named
    as numpy names it (``float32``, ``bfloat16``), so the keys are the JAX
    package's.
    """
    sig = "x".join(str(int(s)) for s in sizes)
    return f"{site}|{sig}|{str(dtype).removeprefix('torch.')}"


@dataclasses.dataclass
class RouteHealth:
    """Trip counts and demotions, keyed by :func:`health_key`.

    ``epoch`` increments on every routing-state change (a demotion, or a
    reset that re-arms demoted keys), so a caller that caches routing
    decisions can tell when they went stale (:func:`route_epoch`).
    ``recomputes`` counts the guarded calls recomputed on the standard
    route after a trip; every caller of :meth:`record_trip` recomputes its
    call, so the trip counts it.  The serving engine reports it as
    ``engine_guard_recomputes_total``.
    """
    trips: Dict[str, int] = dataclasses.field(default_factory=dict)
    demotions: Dict[str, str] = dataclasses.field(default_factory=dict)
    epoch: int = 0
    # every record_trip() gets a process-wide sequence number; first/last
    # per key date a breaker's history without storing timestamps
    trip_seq: int = 0
    first_trip: Dict[str, int] = dataclasses.field(default_factory=dict)
    last_trip: Dict[str, int] = dataclasses.field(default_factory=dict)
    recomputes: int = 0

    def record_trip(self, key: str, limit: int,
                    reason: str = "non-finite square-route output") -> bool:
        """Record one guard trip and the recompute that follows it; returns
        True when this trip demotes."""
        self.trips[key] = self.trips.get(key, 0) + 1
        self.trip_seq += 1
        self.recomputes += 1
        self.first_trip.setdefault(key, self.trip_seq)
        self.last_trip[key] = self.trip_seq
        obs_trace.event("guard.trip", cat="guard", key=key,
                        trips=self.trips[key], reason=reason)
        if key not in self.demotions and self.trips[key] >= max(1, limit):
            self.demotions[key] = f"{reason} ({self.trips[key]} trips)"
            self.epoch += 1
            obs_trace.event("guard.demote", cat="guard", key=key,
                            trips=self.trips[key])
            logger.warning(
                "route-health: demoting %s to the standard route after "
                "%d guard trips (%s)", key, self.trips[key], reason)
            return True
        return False

    def is_demoted(self, key: str) -> bool:
        return key in self.demotions

    def summary(self) -> Dict[str, object]:
        return {"trips": dict(self.trips),
                "demotions": dict(self.demotions)}

    def snapshot(self) -> List[Dict[str, object]]:
        """One entry per key that ever tripped: trip count, demoted flag and
        reason, first/last trip ordinals.  The engine's observability
        snapshot carries it, and
        :func:`repro_torch.obs.metrics.publish_route_health` publishes it
        as labeled gauges."""
        return [{"key": key,
                 "trips": n,
                 "demoted": key in self.demotions,
                 "reason": self.demotions.get(key),
                 "first_trip": self.first_trip.get(key, 0),
                 "last_trip": self.last_trip.get(key, 0)}
                for key, n in sorted(self.trips.items())]


_HEALTH = RouteHealth()


def route_health() -> RouteHealth:
    """The process-wide route-health registry."""
    return _HEALTH


def reset_route_health() -> None:
    """Re-arm every breaker (tests / model reload).  Moves the route epoch
    if any key was demoted."""
    if _HEALTH.demotions:
        _HEALTH.epoch += 1
    _HEALTH.trips.clear()
    _HEALTH.demotions.clear()
    _HEALTH.first_trip.clear()
    _HEALTH.last_trip.clear()


def route_epoch() -> int:
    """Monotonic counter of routing-state changes (demotions, resets)."""
    return _HEALTH.epoch
