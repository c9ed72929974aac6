"""Numerical guard-rails for the square datapath: the PyTorch port of
``repro/core/guards.py``.

The widen-before-square rule (:func:`repro_torch.core.squares.widen_for_sum`)
keeps ``a + b`` from overflowing in the accumulator dtype, but nothing
keeps ``(a + b)^2`` finite there.  f32 and bf16 operands square in f32,
so any ``|a + b| > sqrt(f32_max) ~ 1.84e19`` saturates the PM term to
``inf`` while the multiplier route at the same magnitudes may still be
finite (``1e19 * 1e19 = 1e38 < f32_max``).  f16 widens to f32, where one
square cannot saturate; int8 is exact by construction.

Behind a policy flag, the dispatcher (:func:`repro_torch.core.einsum.
fs_einsum`) checks every square-routed output with :func:`check_finite`.
A non-finite output is a trip: it is recorded in the per-(site, shape,
dtype) circuit breaker (:class:`repro_torch.kernels.routing.RouteHealth`)
and that call is recomputed on the standard route; after ``trip_limit``
trips the key is demoted and served standard from then on, each such
call noted ``demoted=True`` in the contraction audit.  Every trip emits a
``guard.trip`` trace event and counts as a recompute
(``RouteHealth.recomputes``), which the serving engine reports as
``engine_guard_recomputes_total``: degradation is observable, never
silent.

Eager and captured guard
------------------------
Eagerly, every check is one sum-reduce and a device-to-host read of its
scalar: one launch and one synchronisation per guarded contraction.

Under a CUDA graph capture (:mod:`repro_torch.core.graphs`) nothing can
be read back, and :func:`check_finite` returns ``None`` (JAX's "unknowable
under a trace").  With ``GuardPolicy.compiled`` (the default) the
dispatcher then emits a probe (:func:`emit_trace_probe`): the same sum,
kept on the device; the capture ends with one ``isfinite`` over every
probe's sum, a flag vector the graph writes at every replay.  Every
replay hands the graph's flags to a pending-trip ledger; the step owner
(the compiled serving engine's ``_guarded_call``), after each call:

1. :func:`drain_pending_trips` -- reads every pending flag in one copy and
   records each false one as a ``RouteHealth`` trip (demotion at
   ``trip_limit``);
2. on any trip, discards the result and retries the call on the same
   inputs.  A demotion is a capture-time branch, so the owner re-captures
   when :func:`repro_torch.kernels.routing.route_epoch` moved, and the
   retry serves the standard route.

``guarded(compiled=False)`` keeps the old stance: a captured call is not
probed.

Enable the guard globally with ``REPRO_GUARD=1`` (and its probes with
``REPRO_GUARD_COMPILED``, default on), for the process with
:func:`set_guard_policy`, or for a region with :func:`guarded` (the
serving engine wraps each tick in it when ``EngineConfig(guard=True)``).
"""
from __future__ import annotations

import cmath
import collections
import contextlib
import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.obs import trace as obs_trace

__all__ = ["GuardPolicy", "guard_policy", "set_guard_policy", "guarded",
           "check_finite", "emit_trace_probe", "land_probes",
           "pending_trip_counts", "clear_pending_trips",
           "drain_pending_trips", "DEFAULT_TRIP_LIMIT"]

# Guard trips of one (site, shape, dtype) key before the route-health
# registry demotes it to the standard route (the circuit breaker's K).
DEFAULT_TRIP_LIMIT = 3


@dataclasses.dataclass(frozen=True)
class GuardPolicy:
    """Runtime numerics-guard policy.

    ``enabled``    -- check square-routed contraction outputs for
                      non-finite values;
    ``trip_limit`` -- trips of one (site, shape, dtype) key before the
                      route-health breaker demotes it to the standard
                      route for the rest of the process;
    ``compiled``   -- under a CUDA graph capture, emit finite probes into
                      the graph (see the module docstring) instead of
                      leaving the captured call unchecked.
    """
    enabled: bool = False
    trip_limit: int = DEFAULT_TRIP_LIMIT
    compiled: bool = True


def _env_default() -> GuardPolicy:
    return GuardPolicy(
        enabled=os.environ.get("REPRO_GUARD", "") == "1",
        compiled=os.environ.get("REPRO_GUARD_COMPILED", "1") != "0")


_POLICY_STACK: List[GuardPolicy] = []


def guard_policy() -> GuardPolicy:
    """The active guard policy (innermost :func:`guarded` region >
    :func:`set_guard_policy` > ``$REPRO_GUARD``/``$REPRO_GUARD_COMPILED``)."""
    if _POLICY_STACK:
        return _POLICY_STACK[-1]
    return _env_default()


def set_guard_policy(enabled: bool,
                     trip_limit: int = DEFAULT_TRIP_LIMIT,
                     compiled: bool = True) -> None:
    """Set the process-level guard policy (clears any scoped regions)."""
    del _POLICY_STACK[:]
    _POLICY_STACK.append(GuardPolicy(enabled=enabled, trip_limit=trip_limit,
                                     compiled=compiled))


@contextlib.contextmanager
def guarded(enabled: bool = True, trip_limit: int = DEFAULT_TRIP_LIMIT,
            compiled: bool = True):
    """Scope a guard policy to a region; the previous one is restored on
    exit, so interleaved guarded and unguarded runs do not leak into each
    other.  Probe emission is a capture-time decision: the scope must
    cover the call that captures, not only the replays."""
    _POLICY_STACK.append(GuardPolicy(enabled=enabled, trip_limit=trip_limit,
                                     compiled=compiled))
    try:
        yield
    finally:
        _POLICY_STACK.pop()


def check_finite(x: torch.Tensor) -> Optional[bool]:
    """Whether ``x`` is entirely finite, or ``None`` under a CUDA graph
    capture, where no value can be read (callers then emit a probe,
    :func:`emit_trace_probe`, under a compiled policy).

    Integer tensors are finite by construction and return ``True`` with
    no device work.  The float probe is one sum-reduce, not an elementwise
    ``isfinite`` pass: any ``inf``/``nan`` entry makes the sum non-finite
    (``inf - inf = nan``), so there are no false passes.  A false trip
    needs finite entries whose sum overflows -- magnitudes at the dtype's
    boundary, the regime the guard demotes anyway -- and a trip only
    reroutes to the standard path.  The sum is read back and tested on
    the host: one kernel and one read a check, where ``torch.isfinite`` on
    the device would launch its elementwise ops besides.
    """
    if not (x.dtype.is_floating_point or x.dtype.is_complex):
        return True
    from repro_torch.core import graphs           # lazy: import cycle
    if graphs.capturing():
        return None
    return cmath.isfinite(torch.sum(x).item())


# --------------------------------------------------------------------------
# Compiled-regime guard: probes captured into graphs + the pending ledger
# --------------------------------------------------------------------------

# Probe flags not yet read: (health keys, (n,) bool device flags).  Filled
# by every replay of a probed graph (and by eager probes), emptied by
# drain_pending_trips.  Bounded by the probes of the calls since the last
# drain.
_PENDING: List[Tuple[Tuple[str, ...], torch.Tensor]] = []

_COMPILED_TRIP_REASON = "non-finite compiled square-route output (graph probe)"


def land_probes(keys: Tuple[str, ...], flags: torch.Tensor) -> None:
    """Hand one call's probe flags (``flags[i]`` for ``keys[i]``) to the
    pending ledger (a graph's ledger calls this at each replay)."""
    _PENDING.append((tuple(keys), flags))


def emit_trace_probe(key: str, x: torch.Tensor) -> None:
    """Emit a finite probe of ``x`` for health key ``key``.

    The probe is :func:`check_finite`'s single sum, kept on the device and
    not read in line.  Under a capture the sum goes into the capture's
    ledger, whose seal tests every probe's sum with one ``isfinite``;
    every replay of the graph lands the flags in the pending ledger.
    Outside a capture the flag lands at once.  Integer outputs are finite
    by construction and emit nothing.  A capture that no ledger records
    (not made by :class:`~repro_torch.core.graphs.CapturedCall`) raises:
    its flags could never be read."""
    if not (x.dtype.is_floating_point or x.dtype.is_complex):
        return
    from repro_torch.core import graphs           # lazy: import cycle
    total = torch.sum(x).reshape(1)
    ledger = graphs.current_ledger()
    if ledger is not None:
        ledger.probes.append((key, total))
    elif graphs.capturing():
        raise graphs.CaptureError(
            "a finite probe under a CUDA graph capture that no ledger "
            "records: capture through repro_torch.core.graphs.CapturedCall")
    else:
        land_probes((key,), torch.isfinite(total))


def _read(pending) -> Dict[str, int]:
    """``{key: non-finite flags}`` of ``pending``, read in one copy."""
    trips: Dict[str, int] = collections.Counter()
    if not pending:
        return {}
    flags = pending[0][1] if len(pending) == 1 else torch.cat(
        [f.to(pending[0][1].device) for _, f in pending])
    keys = [k for ks, _ in pending for k in ks]
    for key, ok in zip(keys, flags.cpu().tolist()):
        if not ok:
            trips[key] += 1
    return dict(trips)


def pending_trip_counts() -> Dict[str, int]:
    """The pending trips by key, without draining them (reads the flags)."""
    return _read(_PENDING)


def clear_pending_trips() -> None:
    """Drop every pending flag without recording it (tests)."""
    del _PENDING[:]


def drain_pending_trips(trip_limit: Optional[int] = None) -> Dict[str, int]:
    """Read every pending probe flag in one device-to-host copy, clear the
    ledger, and record each non-finite flag as a trip of its key in the
    route-health breaker (demotion after ``trip_limit`` trips of a key;
    default: the active policy's limit).  Returns ``{health_key: trips}``
    -- empty means the call was clean.  The caller owns the recovery: on
    any trip the call's output is suspect and is recomputed, re-captured
    first if :func:`repro_torch.kernels.routing.route_epoch` moved."""
    with obs_trace.span("guard.drain", cat="guard"):
        pending = list(_PENDING)
        del _PENDING[:]
        drained = _read(pending)
    if not drained:
        return drained
    if trip_limit is None:
        trip_limit = guard_policy().trip_limit
    from repro_torch.kernels import routing       # lazy: import cycle
    health = routing.route_health()
    for key, n in drained.items():
        for _ in range(n):
            health.record_trip(key, limit=trip_limit,
                               reason=_COMPILED_TRIP_REASON)
    return drained
