"""Exporters: Chrome ``trace_event`` JSON and per-request latency
breakdowns derived from spans (the port's own copy of
``repro/obs/export.py``).

``to_chrome_trace`` emits the Trace Event Format that Perfetto and
``chrome://tracing`` load directly: spans become complete ("X") events,
instants become "i" events, and the emitting thread id becomes ``tid``
so work on another thread renders on its own track.
Timestamps are converted from the tracer clock's seconds to the format's
microseconds, rebased to the earliest record so traces start at t=0
regardless of the injected clock.

``request_breakdown`` reconstructs where each request's latency went --
queue wait, prefill compute, time-to-first-token, decode tail -- from
the engine's request lifecycle events (``request.submit`` /
``request.admit`` / ``request.first_token`` / ``request.terminal``) and
its per-chunk ``engine.prefill_chunk`` spans.  This is the span-derived
twin of ``EngineMetrics.ttft_s``: the dict gives the mean, the spans
give the shape.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from repro_torch.obs.trace import SpanRecord, Tracer

__all__ = ["to_chrome_trace", "write_chrome_trace", "request_breakdown"]

_US = 1e6


def _tid_map(records: List[SpanRecord]) -> Dict[int, int]:
    """Stable small integers for thread ids (tid 0 = first seen, which
    is the engine's thread in practice)."""
    out: Dict[int, int] = {}
    for r in records:
        if r.tid not in out:
            out[r.tid] = len(out)
    return out


def to_chrome_trace(tracer: Tracer, process_name: str = "repro") -> dict:
    """Render the tracer's ring as a Chrome ``trace_event`` JSON object."""
    records = tracer.records()
    t0 = min((r.ts for r in records), default=0.0)
    tids = _tid_map(records)
    events: List[dict] = [{
        "name": "process_name", "ph": "M", "pid": 1, "tid": 0, "ts": 0,
        "args": {"name": process_name},
    }]
    for r in records:
        ev = {
            "name": r.name,
            "cat": r.cat,
            "pid": 1,
            "tid": tids[r.tid],
            "ts": (r.ts - t0) * _US,
            "args": dict(r.args),
        }
        if r.dur is None:
            ev["ph"] = "i"
            ev["s"] = "t"               # thread-scoped instant
        else:
            ev["ph"] = "X"
            ev["dur"] = r.dur * _US
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"dropped_records": tracer.dropped}}


def write_chrome_trace(tracer: Tracer, path: str,
                       process_name: str = "repro") -> str:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(tracer, process_name), f)
    return path


def request_breakdown(
        tracer: Tracer) -> Dict[int, Dict[str, Optional[float]]]:
    """Per-request latency decomposition from engine lifecycle records.

    Returns ``{rid: {"queue_s", "prefill_s", "ttft_s", "decode_s",
    "total_s", "status"}}``.  Stages a request never reached (a shed
    request has no admit, a rejected one no first token) are ``None``;
    ``prefill_s`` sums the request's ``engine.prefill_chunk`` span
    durations -- compute time, disjoint from queue wait.
    """
    submit: Dict[int, float] = {}
    admit: Dict[int, float] = {}
    first: Dict[int, float] = {}
    prefill: Dict[int, float] = {}
    terminal: Dict[int, float] = {}
    status: Dict[int, str] = {}
    for r in tracer.records():
        rid = r.args.get("rid")
        if rid is None:
            continue
        rid = int(rid)
        if r.name == "request.submit":
            submit[rid] = r.ts
        elif r.name == "request.admit":
            admit[rid] = r.ts
        elif r.name == "request.first_token":
            first[rid] = r.ts
        elif r.name == "request.terminal":
            terminal[rid] = r.ts
            status[rid] = str(r.args.get("status", ""))
        elif r.name == "engine.prefill_chunk" and r.dur is not None:
            prefill[rid] = prefill.get(rid, 0.0) + r.dur
    out: Dict[int, Dict[str, Optional[float]]] = {}
    for rid in sorted(submit.keys() | terminal.keys()):
        sub, adm = submit.get(rid), admit.get(rid)
        ft, end = first.get(rid), terminal.get(rid)
        out[rid] = {
            "queue_s": (adm - sub) if sub is not None and adm is not None
            else None,
            "prefill_s": prefill.get(rid),
            "ttft_s": (ft - sub) if sub is not None and ft is not None
            else None,
            "decode_s": (end - ft) if ft is not None and end is not None
            else None,
            "total_s": (end - sub) if sub is not None and end is not None
            else None,
            "status": status.get(rid),
        }
    return out
