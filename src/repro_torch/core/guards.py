"""Numerical guard-rails for the square datapath: the PyTorch port of
``repro/core/guards.py`` (its eager guard; the compiled probes come with a
compiled serving step).

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

The port runs eagerly, so every check is one sum-reduce and a
device-to-host read of its scalar: the guard costs one launch and one
synchronisation per guarded contraction.

Enable it globally with ``REPRO_GUARD=1``, for the process with
:func:`set_guard_policy`, or for a region with :func:`guarded` (the
serving engine wraps each tick in it when ``EngineConfig(guard=True)``).
"""
from __future__ import annotations

import cmath
import contextlib
import dataclasses
import os
from typing import List

import torch

__all__ = ["GuardPolicy", "guard_policy", "set_guard_policy", "guarded",
           "check_finite", "DEFAULT_TRIP_LIMIT"]

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
                      route for the rest of the process.
    """
    enabled: bool = False
    trip_limit: int = DEFAULT_TRIP_LIMIT


def _env_default() -> GuardPolicy:
    return GuardPolicy(enabled=os.environ.get("REPRO_GUARD", "") == "1")


_POLICY_STACK: List[GuardPolicy] = []


def guard_policy() -> GuardPolicy:
    """The active guard policy (innermost :func:`guarded` region >
    :func:`set_guard_policy` > ``$REPRO_GUARD``)."""
    if _POLICY_STACK:
        return _POLICY_STACK[-1]
    return _env_default()


def set_guard_policy(enabled: bool,
                     trip_limit: int = DEFAULT_TRIP_LIMIT) -> None:
    """Set the process-level guard policy (clears any scoped regions)."""
    del _POLICY_STACK[:]
    _POLICY_STACK.append(GuardPolicy(enabled=enabled, trip_limit=trip_limit))


@contextlib.contextmanager
def guarded(enabled: bool = True, trip_limit: int = DEFAULT_TRIP_LIMIT):
    """Scope a guard policy to a region; the previous one is restored on
    exit, so interleaved guarded and unguarded runs do not leak into each
    other."""
    _POLICY_STACK.append(GuardPolicy(enabled=enabled, trip_limit=trip_limit))
    try:
        yield
    finally:
        _POLICY_STACK.pop()


def check_finite(x: torch.Tensor) -> bool:
    """Whether ``x`` is entirely finite.

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
    return cmath.isfinite(torch.sum(x).item())
