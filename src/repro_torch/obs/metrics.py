"""Metrics registry: counters / gauges / fixed-bucket histograms with
JSON-snapshot and Prometheus-text exporters (the port's own copy of
``repro/obs/metrics.py``).

Second pillar of the observability layer.  The design is deliberately
small and dependency-free:

- **Counter** -- monotonically non-decreasing; ``inc`` rejects negative
  deltas so monotonicity is a *type* property the chaos suites can rely
  on, not a convention.  (Quantities that legitimately roll back -- the
  engine's delivered-token count under preemption -- stay in
  ``EngineMetrics`` or become gauges.)
- **Gauge** -- a settable level (queue depth, block utilization,
  square-routed fraction).
- **Histogram** -- fixed upper-bound buckets (+Inf implicit), count and
  sum, with p50/p95/p99 estimated by linear interpolation inside the
  landing bucket.  Fixed buckets keep ``observe`` O(#buckets) and the
  memory O(1) however long the engine runs -- the same bounded-state
  rule as ``EngineMetrics``' running sums.
- **Labels** -- an optional flat ``{str: str}`` dict frozen into the
  metric identity (one time series per label combination), used for
  per-site route-health dumps (``route_health_trips{key="..."}``).

A single :meth:`MetricsRegistry.snapshot` answers the whole-stack health
question: the serving engine, route health and the counting audit all
publish into one registry (``launch/serve.py --metrics-file``; checked by
``python -m repro_torch.obs.check``).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry", "DEFAULT_LATENCY_BUCKETS",
           "publish_contraction_audit", "publish_route_health"]

# The JAX package's buckets, 100 us to 60 s, so both packages' snapshots
# line up; latencies outside land in the open +Inf bucket.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class Counter:
    """Monotonic counter.  ``inc(n)`` with ``n < 0`` raises."""
    __slots__ = ("name", "labels", "help", "_value", "_lock")
    kind = "counter"

    def __init__(self, name: str, labels=None, help: str = ""):
        self.name = name
        self.labels = labels or {}
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError(
                f"counter {self.name!r} is monotonic; inc({n}) rejected "
                f"(use a Gauge for quantities that go down)")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """A settable level."""
    __slots__ = ("name", "labels", "help", "_value", "_lock")
    kind = "gauge"

    def __init__(self, name: str, labels=None, help: str = ""):
        self.name = name
        self.labels = labels or {}
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram with interpolated percentile estimates.

    ``buckets`` are sorted inclusive upper bounds; an implicit +Inf
    bucket catches the tail.  ``quantile`` walks the cumulative counts
    and interpolates linearly inside the landing bucket (the +Inf bucket
    reports its lower edge -- a floor, not a fabricated tail value).
    """
    __slots__ = ("name", "labels", "help", "buckets", "counts",
                 "_sum", "_count", "_lock")
    kind = "histogram"

    def __init__(self, name: str, buckets: Optional[Sequence[float]] = None,
                 labels=None, help: str = ""):
        self.name = name
        self.labels = labels or {}
        self.help = help
        bs = tuple(float(b) for b in
                   (buckets if buckets is not None
                    else DEFAULT_LATENCY_BUCKETS))
        if not bs or list(bs) != sorted(bs):
            raise ValueError(f"histogram {name!r} needs sorted non-empty "
                             f"buckets, got {bs}")
        self.buckets = bs
        self.counts = [0] * (len(bs) + 1)          # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        for i, b in enumerate(self.buckets):       # noqa: B007
            if v <= b:
                break
        else:
            i = len(self.buckets)
        with self._lock:
            self.counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0 <= q <= 1); 0.0 when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        with self._lock:
            total = self._count
            if total == 0:
                return 0.0
            rank = q * total
            cum = 0
            for i, c in enumerate(self.counts):
                prev_cum = cum
                cum += c
                if cum >= rank and c > 0:
                    lo = self.buckets[i - 1] if i > 0 else 0.0
                    if i == len(self.buckets):     # +Inf bucket: floor
                        return lo
                    hi = self.buckets[i]
                    frac = (rank - prev_cum) / c
                    return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            return self.buckets[-1]

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "sum": self.sum, "mean": self.mean,
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}


def _full_name(name: str, labels: Dict[str, str]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Get-or-create home for metrics; one snapshot for the whole stack."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, labels, **kw):
        labels = dict(labels or {})
        full = _full_name(name, labels)
        with self._lock:
            m = self._metrics.get(full)
            if m is None:
                m = cls(name, labels=labels, **kw)
                self._metrics[full] = m
            elif not isinstance(m, cls):
                raise ValueError(f"metric {full!r} already registered as "
                                 f"{m.kind}, requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get(Counter, name, labels, help=help)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get(Gauge, name, labels, help=help)

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None,
                  help: str = "",
                  labels: Optional[Dict[str, str]] = None) -> Histogram:
        return self._get(Histogram, name, labels, buckets=buckets,
                         help=help)

    def metrics(self) -> List[object]:
        with self._lock:
            return list(self._metrics.values())

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()

    # ------------------------------------------------------------ exporters
    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """JSON-serializable state of every registered metric."""
        out: Dict[str, Dict[str, object]] = {
            "counters": {}, "gauges": {}, "histograms": {}}
        for m in self.metrics():
            full = _full_name(m.name, m.labels)
            if isinstance(m, Counter):
                out["counters"][full] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][full] = m.value
            else:
                out["histograms"][full] = m.summary()
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (one HELP/TYPE pair per family)."""
        lines: List[str] = []
        seen_family = set()
        by_name: Dict[str, List[object]] = {}
        for m in self.metrics():
            by_name.setdefault(m.name, []).append(m)
        for name in sorted(by_name):
            for m in by_name[name]:
                if name not in seen_family:
                    seen_family.add(name)
                    if m.help:
                        lines.append(f"# HELP {name} {m.help}")
                    lines.append(f"# TYPE {name} {m.kind}")
                if isinstance(m, Histogram):
                    cum = 0
                    for b, c in zip(m.buckets, m.counts):
                        cum += c
                        lbl = dict(m.labels, le=repr(float(b)))
                        lines.append(
                            f"{_full_name(name + '_bucket', lbl)} {cum}")
                    lbl = dict(m.labels, le="+Inf")
                    lines.append(
                        f"{_full_name(name + '_bucket', lbl)} {m.count}")
                    lines.append(
                        f"{_full_name(name + '_sum', m.labels)} {m.sum}")
                    lines.append(
                        f"{_full_name(name + '_count', m.labels)} "
                        f"{m.count}")
                else:
                    lines.append(f"{_full_name(name, m.labels)} {m.value}")
        return "\n".join(lines) + "\n"


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-default registry (module-level instrumentation lands
    here; engines carry their own registries so per-run invariants stay
    per-run)."""
    return _DEFAULT


# ------------------------------------------------------------- publishers
def publish_contraction_audit(summary: Dict[str, object],
                              registry: MetricsRegistry,
                              prefix: str = "counting") -> None:
    """Publish a :meth:`ContractionCounter.summary` dict as gauges, so
    the registry snapshot carries the square-routed fraction (fwd AND
    bwd) next to the serving/training counters from the same run."""
    for key in ("total_mults", "multiplies_replaced_by_squares",
                "fraction_square", "bwd_mults", "fraction_square_bwd",
                "fraction_demoted"):
        if key in summary:
            registry.gauge(f"{prefix}_{key}").set(float(summary[key]))
    demoted = summary.get("demoted_sites") or []
    registry.gauge(f"{prefix}_demoted_sites").set(len(demoted))


def publish_route_health(snapshot: List[Dict[str, object]],
                         registry: MetricsRegistry) -> None:
    """Publish a :meth:`RouteHealth.snapshot` dump as per-key labeled
    gauges (trip count, demoted flag, first/last trip ordinals)."""
    registry.gauge("route_health_sites").set(len(snapshot))
    registry.gauge("route_health_demoted_sites").set(
        sum(1 for e in snapshot if e["demoted"]))
    for e in snapshot:
        lbl = {"key": str(e["key"])}
        registry.gauge("route_health_trips", labels=lbl).set(e["trips"])
        registry.gauge("route_health_demoted", labels=lbl).set(
            1.0 if e["demoted"] else 0.0)
        registry.gauge("route_health_first_trip", labels=lbl).set(
            e["first_trip"])
        registry.gauge("route_health_last_trip", labels=lbl).set(
            e["last_trip"])
