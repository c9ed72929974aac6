"""Deterministic fault injection for the serving engine: the PyTorch port of
``repro/serve/faults.py``.

The injector puts the failures the engine must absorb at seeded,
reproducible points, so a test can hold the engine to its contract under
every schedule: every submitted request ends in a terminal status, every
request no fault poisons finishes token-identically to the fault-free run,
and no block leaks.

Injection points
----------------
``alloc_fail``   the ``n``-th :meth:`BlockAllocator.alloc` call reports
                 exhaustion (returns ``None``): admission stalls and
                 mid-decode preemption;
``step_fail``    the ``n``-th decode / prefill model call raises
                 :class:`InjectedFault`: the bounded step retries and the
                 watchdog;
``nan_logits``   the ``n``-th successful decode step's logits get one
                 slot's row set to NaN: the engine's numerics guard (that
                 slot fails, the batch survives);
``clock_skew``   at engine tick ``n`` the engine clock jumps forward by
                 ``s`` seconds: deadline expiry without sleeping.

The injector goes to :class:`repro_torch.serve.engine.Engine` as its
``faults=`` argument; ``None`` (the default) injects nothing.  A schedule
is written out (:meth:`FaultPlan.of`) or drawn from a seed
(:meth:`FaultPlan.random`, numpy's ``default_rng``: the JAX package's
schedules for the same seed).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Mapping, Optional

import numpy as np
import torch

__all__ = ["InjectedFault", "FaultPlan", "FaultInjector", "FaultyAllocator"]


class InjectedFault(RuntimeError):
    """The exception a scheduled step failure raises (told apart from
    organic failures in logs, handled like them by the engine)."""


def _fset(v) -> FrozenSet[int]:
    return frozenset(int(x) for x in (() if v is None else v))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One deterministic injection schedule (all ordinals 0-based).

    ``alloc_fail`` -- ordinals of allocator ``alloc()`` calls that report
                      exhaustion;
    ``step_fail``  -- per call kind (``"decode"`` / ``"prefill"``),
                      ordinals of model calls that raise;
    ``nan_logits`` -- decode-step ordinal -> slot whose logits row is
                      poisoned with NaN;
    ``clock_skew`` -- engine tick -> seconds the clock jumps forward.
    """
    alloc_fail: FrozenSet[int] = frozenset()
    step_fail: Mapping[str, FrozenSet[int]] = \
        dataclasses.field(default_factory=dict)
    nan_logits: Mapping[int, int] = dataclasses.field(default_factory=dict)
    clock_skew: Mapping[int, float] = dataclasses.field(default_factory=dict)

    @classmethod
    def of(cls, *, alloc_fail=(), decode_fail=(), prefill_fail=(),
           nan_logits: Optional[Dict[int, int]] = None,
           clock_skew: Optional[Dict[int, float]] = None) -> "FaultPlan":
        """A plan from flat per-kind arguments."""
        step = {}
        df, pf = _fset(decode_fail), _fset(prefill_fail)
        if df:
            step["decode"] = df
        if pf:
            step["prefill"] = pf
        return cls(alloc_fail=_fset(alloc_fail), step_fail=step,
                   nan_logits=dict(nan_logits or {}),
                   clock_skew=dict(clock_skew or {}))

    @classmethod
    def random(cls, seed: int, *, calls: int = 48, p_alloc: float = 0.15,
               p_decode: float = 0.08, p_prefill: float = 0.05) -> "FaultPlan":
        """A seeded random schedule over the first ``calls`` ordinals of
        each injection point (same seed, same plan)."""
        rng = np.random.default_rng(seed)
        return cls.of(
            alloc_fail=np.nonzero(rng.random(calls) < p_alloc)[0],
            decode_fail=np.nonzero(rng.random(calls) < p_decode)[0],
            prefill_fail=np.nonzero(rng.random(calls) < p_prefill)[0])


class FaultInjector:
    """Stateful executor of one :class:`FaultPlan` (per-run counters; use
    a fresh injector per engine run)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.calls: Dict[str, int] = {"alloc": 0, "decode": 0, "prefill": 0}
        self.injected: Dict[str, int] = {"alloc": 0, "decode": 0,
                                         "prefill": 0, "nan": 0, "skew": 0}

    def alloc_exhausted(self) -> bool:
        n = self.calls["alloc"]
        self.calls["alloc"] += 1
        if n in self.plan.alloc_fail:
            self.injected["alloc"] += 1
            return True
        return False

    def before_step(self, kind: str) -> None:
        n = self.calls[kind]
        self.calls[kind] += 1
        if n in self.plan.step_fail.get(kind, ()):
            self.injected[kind] += 1
            raise InjectedFault(f"injected {kind} failure (call {n})")

    def poison_logits(self, logits: torch.Tensor,
                      decode_ordinal: int) -> torch.Tensor:
        """Poison one slot's logits row at the scheduled decode step
        (``decode_ordinal`` = successful decode steps so far, the same in
        a faulted and a fault-free run).  Returns a new tensor; the
        caller's is left as it was."""
        slot = self.plan.nan_logits.get(int(decode_ordinal))
        if slot is None:
            return logits
        self.injected["nan"] += 1
        out = logits.clone()
        out[int(slot)] = float("nan")
        return out

    def clock_skew(self, tick: int) -> float:
        s = float(self.plan.clock_skew.get(int(tick), 0.0))
        if s:
            self.injected["skew"] += 1
        return s


class FaultyAllocator:
    """Transparent :class:`~repro_torch.serve.paged.BlockAllocator` wrapper
    whose ``alloc`` reports exhaustion at scheduled calls.  Everything else
    delegates to the real allocator, so leak accounting reads the true
    pool."""

    def __init__(self, inner, injector: FaultInjector):
        self.inner = inner
        self.injector = injector

    def alloc(self, n: int):
        if self.injector.alloc_exhausted():
            return None
        return self.inner.alloc(n)

    def __getattr__(self, name):
        return getattr(self.inner, name)
