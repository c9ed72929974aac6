"""Structured tracing: spans + instant events into a bounded ring buffer
(the port's own copy of ``repro/obs/trace.py``; it imports nothing of the
JAX package).

The tracer is the first pillar of the observability layer.  Design
constraints, in order:

- **Near-zero cost when disabled.**  Tracing is off by default; every
  instrumentation site goes through the module-level :func:`span` /
  :func:`event` helpers, whose disabled path is one global read and one
  ``None`` check (no allocation -- :func:`span` hands back one shared
  ``nullcontext``).
- **Bounded memory.**  Completed records land in a ``deque(maxlen=...)``
  ring: a long-lived engine can trace forever; old records fall off the
  back and are counted in :attr:`Tracer.dropped` instead of growing the
  heap.
- **Clock-injectable.**  ``Tracer(clock=...)`` takes any ``() -> float``
  seconds callable.  The serving engine runs deadlines on a *skewable*
  clock and the chaos suites demand deterministic runs, so tests inject a
  counting clock rather than reading wall time.
- **Thread-safe.**  Records carry the emitting thread id (exported as the
  Chrome-trace ``tid``, so work on another thread renders on its own
  track) and the open-span balance is kept per thread.

Span balance is part of the chaos contract: every span opened during a
run must be closed *even when the instrumented region raises* (including
``BaseException``).  ``_Span.__exit__`` records unconditionally, and
:meth:`Tracer.open_spans` exposes the live count so the fault suites can
assert it returns to zero.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

__all__ = ["SpanRecord", "Tracer", "get_tracer", "enabled", "enable",
           "disable", "capture", "span", "event"]


@dataclasses.dataclass
class SpanRecord:
    """One completed span (``dur is not None``) or instant event.

    ``ts``/``dur`` are in the tracer clock's seconds; the Chrome-trace
    exporter converts to microseconds.  ``args`` is a small flat dict of
    JSON-serializable annotations (rid, tick, route kind, ...).
    """
    name: str
    cat: str
    ts: float
    dur: Optional[float]          # None: instant event
    tid: int
    args: Dict[str, object]


class _Span:
    """Re-entrant-free single-use context manager for one span.

    A plain class (not ``@contextmanager``) so ``__exit__`` is guaranteed
    to run -- and record the span -- on ANY unwind path, including
    ``BaseException``.
    """
    __slots__ = ("_tracer", "name", "cat", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Dict[str, object]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self) -> "_Span":
        self._t0 = self._tracer._clock()
        self._tracer._open_enter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t = self._tracer
        t._open_exit()
        if exc_type is not None:
            self.args = dict(self.args, error=exc_type.__name__)
        t._record(SpanRecord(self.name, self.cat, self._t0,
                             t._clock() - self._t0,
                             threading.get_ident(), self.args))
        return False                      # never swallow the exception


class Tracer:
    """Bounded-ring span/event collector.  See the module docstring."""

    def __init__(self, capacity: int = 16384,
                 clock: Optional[Callable[[], float]] = None):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self._clock = clock if clock is not None else time.perf_counter
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._open: Dict[int, int] = {}   # thread id -> open span depth
        self.capacity = capacity
        self.emitted = 0                  # total records ever emitted

    # ------------------------------------------------------------ internals
    def _open_enter(self) -> None:
        tid = threading.get_ident()
        with self._lock:
            self._open[tid] = self._open.get(tid, 0) + 1

    def _open_exit(self) -> None:
        tid = threading.get_ident()
        with self._lock:
            n = self._open.get(tid, 0) - 1
            if n <= 0:
                self._open.pop(tid, None)
            else:
                self._open[tid] = n

    def _record(self, rec: SpanRecord) -> None:
        with self._lock:
            self._ring.append(rec)        # maxlen: oldest falls off
            self.emitted += 1

    # ------------------------------------------------------------------ API
    def span(self, name: str, cat: str = "repro", **args) -> _Span:
        """A context manager timing the enclosed region as one span."""
        return _Span(self, name, cat, args)

    def event(self, name: str, cat: str = "repro", **args) -> None:
        """Record an instant event at the current clock reading."""
        self._record(SpanRecord(name, cat, self._clock(), None,
                                threading.get_ident(), args))

    def records(self) -> List[SpanRecord]:
        """A stable copy of the ring's current contents (oldest first)."""
        with self._lock:
            return list(self._ring)

    @property
    def open_spans(self) -> int:
        """Spans currently entered but not yet exited, over all threads.
        Zero after any completed (or fully unwound) run -- the balance
        invariant the chaos suites pin."""
        with self._lock:
            return sum(self._open.values())

    @property
    def dropped(self) -> int:
        """Records evicted by the ring bound (emitted - retained)."""
        with self._lock:
            return self.emitted - len(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.emitted = 0


# ---------------------------------------------------------------- module API
# The global tracer IS the enable flag: ``None`` means disabled, and the
# disabled fast path below is one read + one ``is None`` check.
_TRACER: Optional[Tracer] = None
_NULL = contextlib.nullcontext()          # stateless: safe to share


def get_tracer() -> Optional[Tracer]:
    """The process-global tracer, or None when tracing is disabled."""
    return _TRACER


def enabled() -> bool:
    return _TRACER is not None


def enable(capacity: int = 16384,
           clock: Optional[Callable[[], float]] = None) -> Tracer:
    """Install (and return) a fresh process-global tracer."""
    global _TRACER
    _TRACER = Tracer(capacity=capacity, clock=clock)
    return _TRACER


def disable() -> None:
    """Tear the global tracer down; instrumentation reverts to no-ops."""
    global _TRACER
    _TRACER = None


@contextlib.contextmanager
def capture(capacity: int = 16384,
            clock: Optional[Callable[[], float]] = None):
    """Scoped tracing for tests: install a fresh tracer, yield it,
    restore whatever was installed before (including "disabled")."""
    global _TRACER
    prev = _TRACER
    _TRACER = Tracer(capacity=capacity, clock=clock)
    try:
        yield _TRACER
    finally:
        _TRACER = prev


def span(name: str, cat: str = "repro", **args):
    """Span through the global tracer; a shared no-op context when
    tracing is disabled (the hot-path form every instrumentation site
    uses)."""
    t = _TRACER
    if t is None:
        return _NULL
    return t.span(name, cat, **args)


def event(name: str, cat: str = "repro", **args) -> None:
    """Instant event through the global tracer; no-op when disabled."""
    t = _TRACER
    if t is not None:
        t.event(name, cat, **args)
