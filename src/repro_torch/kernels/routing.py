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

Each selector resolves, in order: ``REPRO_ROUTE`` (a bare route name
applies to every kind it is valid for -- ``kernel`` pins matmul and
paged_attn -- ``kind=route`` lists scope it, ``auto`` defers), then a route
override in the port's tuning cache (:func:`set_route_override`, keyed by
:func:`route_key` as the JAX package keys it; off under
``REPRO_AUTOTUNE=0``; memoised per key), then the rules.  Each counts its
decisions in its ``taken`` counter, so a run can show which routes it used.

The rules' thresholds are the JAX package's, set on its CPU interpret
host.  The port keeps them unchanged; their crossovers on an H100 are
measured by ``chip_smoke.py``'s crossover phase (PERF.md), and moving them
waits for a measured benchmark.

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

from repro_torch.core import cost_model as cm
from repro_torch.core import squares as sq
from repro_torch.kernels import tuning
from repro_torch.obs import trace as obs_trace

__all__ = ["Route", "select_route", "select_matmul_route",
           "select_conv2d_route", "select_paged_attn_route",
           "set_route_override", "route_key", "clear_route_memo",
           "conv2d_patch_bytes", "MATMUL_ROUTES",
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
_KIND_ROUTES = {"matmul": MATMUL_ROUTES, "conv2d": CONV2D_ROUTES,
                "paged_attn": PAGED_ATTN_ROUTES}

# Interpret-host values of the JAX package (their H100 crossovers: PERF.md).
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


conv2d_patch_bytes = cm.conv2d_patch_bytes


def route_key(kind: str, sizes: dict, dtype) -> str:
    """Cache key of a route override: ``route:<kind>:<sizes, in their keys'
    sorted order, joined by x>:<dtype name>``, the JAX package's letter
    for letter."""
    sig = "x".join(str(sizes[f]) for f in sorted(sizes))
    return f"route:{kind}:{sig}:{str(dtype).removeprefix('torch.')}"


_ROUTE_MEMO: Dict[tuple, Optional[Route]] = {}


def clear_route_memo() -> None:
    """Drop the memoised cache lookups of the selectors."""
    _ROUTE_MEMO.clear()


def _cached_route(kind: str, sizes: dict, dtype, valid) -> Optional[Route]:
    """The tuning cache's route override for this key, if autotune is on
    and the cache has one; memoised per (key, cache file)."""
    if not tuning.autotune_enabled():
        return None
    key = route_key(kind, sizes, dtype)
    memo = (key, tuning.cache_path())
    if memo not in _ROUTE_MEMO:
        entry = tuning.load_cache().get(key)
        _ROUTE_MEMO[memo] = (Route(entry["route"], "autotune-cache override")
                             if entry and entry.get("route") in valid
                             else None)
    return _ROUTE_MEMO[memo]


def set_route_override(kind: str, sizes: dict, route: str,
                       path: Optional[str] = None) -> str:
    """Pin a route for an exact shape in the tuning cache at ``path``
    (default the port's, :func:`repro_torch.kernels.tuning.cache_path`);
    the selectors consult it after ``REPRO_ROUTE`` and before their rules
    while autotune is on.  ``sizes`` may carry ``"dtype"`` (a name or a
    torch dtype, default float32): the entry keys on its ACCUMULATOR dtype,
    which is what the selectors look up, so a bf16 or int8 pin lands on
    the key a bf16 or int8 call reads.  Returns the key."""
    valid = _KIND_ROUTES.get(kind)
    if valid is None:
        raise ValueError(f"unknown route kind {kind!r}; expected one of "
                         f"{tuple(_KIND_ROUTES)}")
    if route not in valid:
        raise ValueError(f"unknown {kind} route {route!r}; expected one of "
                         f"{valid}")
    sizes = dict(sizes)
    dt = sizes.pop("dtype", torch.float32)
    if isinstance(dt, str):
        dt = getattr(torch, dt)
    key = route_key(kind, sizes, sq.accum_dtype(dt))
    cache = dict(tuning.load_cache(path))
    cache[key] = {"route": route}
    tuning.save_cache(cache, path)
    return key


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
    cached = _cached_route("matmul", {"b": batch, "m": m, "n": n, "k": k},
                           sq.accum_dtype(dtype), MATMUL_ROUTES)
    if cached is not None:
        return _decide(fn, cached)
    mults = batch * m * n * k
    if mults < VIRTUAL_FLOOR_MULTS:
        return _decide(fn, Route("virtual", f"volume {mults} below "
                                            f"kernel-overhead floor "
                                            f"{VIRTUAL_FLOOR_MULTS}"))
    if batch == 1:
        return _decide(fn, Route("kernel", "unbatched GEMM"))
    step_ops = cm.pm_tile_vpu_ops(m, n, k, kc=_KC_MNK_MAX)
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
    acc = sq.accum_dtype(dtype)
    cached = _cached_route("conv2d", {"b": batch, "oh": oh, "ow": ow,
                                      "kh": kh, "kw": kw, "ci": cin,
                                      "co": cout}, acc, CONV2D_ROUTES)
    if cached is not None:
        return _decide(fn, cached)
    kvol = cin * kh * kw
    patch = cm.conv2d_patch_bytes(oh, ow, kh, kw, cin, batch=batch,
                                  itemsize=acc.itemsize)
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
    cached = _cached_route("paged_attn", {"b": batch, "s": s, "t": t,
                                          "kv": kv_heads, "g": group,
                                          "hd": hd}, sq.accum_dtype(dtype),
                           PAGED_ATTN_ROUTES)
    if cached is not None:
        return _decide(fn, cached)
    gbytes = cm.paged_attn_gather_bytes(t, kv_heads, hd, batch=batch)
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


def select_route(kind: str, sizes: dict, *,
                 dtype: torch.dtype = torch.float32) -> Route:
    """Generic entry point: ``kind`` is ``"matmul"``, ``"conv2d"`` or
    ``"paged_attn"``, ``sizes`` its geometry as :func:`route_key` names it
    (matmul ``b m n k``; conv2d ``b oh ow kh kw ci co``; paged_attn ``b s t
    kv g hd``)."""
    if kind == "matmul":
        return select_matmul_route(sizes["m"], sizes["n"], sizes["k"],
                                   batch=sizes.get("b", 1), dtype=dtype)
    if kind == "conv2d":
        return select_conv2d_route(sizes["oh"], sizes["ow"], sizes["kh"],
                                   sizes["kw"], sizes["ci"], sizes["co"],
                                   batch=sizes.get("b", 1), dtype=dtype)
    if kind == "paged_attn":
        return select_paged_attn_route(
            sizes["s"], sizes["t"], batch=sizes.get("b", 1),
            kv_heads=sizes.get("kv", 1), group=sizes.get("g", 1),
            hd=sizes.get("hd", 64), dtype=dtype)
    raise ValueError(f"unknown route kind {kind!r}; expected one of "
                     f"{tuple(_KIND_ROUTES)}")


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
