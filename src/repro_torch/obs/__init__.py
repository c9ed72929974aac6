"""Unified observability layer: tracing, metrics, exporters (the port's
own copy of ``repro/obs``; it imports nothing of the JAX package).

Dependency-free (stdlib only, no torch import) so every layer of the
stack -- kernels, core dispatch, serving -- can instrument itself without
import cycles.  Three pillars:

- :mod:`repro_torch.obs.trace` -- span/event tracer (ring buffer,
  thread-safe, clock-injectable, near-zero cost when disabled);
- :mod:`repro_torch.obs.metrics` -- counters/gauges/histograms in a
  :class:`MetricsRegistry` with JSON-snapshot + Prometheus-text export;
- :mod:`repro_torch.obs.export` -- Chrome ``trace_event`` JSON (Perfetto)
  and span-derived per-request latency breakdowns.

``python -m repro_torch.obs.check SNAPSHOT [TRACE]`` validates the two
files the serving launcher writes (:mod:`repro_torch.obs.check`).
"""
from repro_torch.obs import trace
from repro_torch.obs.export import (request_breakdown, to_chrome_trace,
                                    write_chrome_trace)
from repro_torch.obs.metrics import (DEFAULT_LATENCY_BUCKETS, Counter, Gauge,
                                     Histogram, MetricsRegistry,
                                     default_registry,
                                     publish_contraction_audit,
                                     publish_route_health)

__all__ = [
    "trace",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "default_registry", "DEFAULT_LATENCY_BUCKETS",
    "publish_contraction_audit", "publish_route_health",
    "to_chrome_trace", "write_chrome_trace", "request_breakdown",
]
