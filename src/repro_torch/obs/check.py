"""Check the two observability files the serving launcher writes (the
port's counterpart of the JAX package's ``scripts/check_obs.py``, with the
same checks; stdlib only).

1. **Registry snapshot JSON** (``--metrics-file``): ``counters`` /
   ``gauges`` / ``histograms`` maps with numeric values; counters are
   non-negative; each histogram summary has count/sum/mean/p50/p95/p99
   with ordered percentiles; where the request-lifecycle counters are
   present, the terminal counters PARTITION the submissions (completed +
   rejected + shed + timeouts + failures + cancelled == submitted); where
   both the audit gauges and a ``contraction_audit`` section are present,
   their square fractions agree.
2. **Chrome trace JSON** (``--trace-out``): ``traceEvents`` is a list of
   objects with the keys a trace viewer requires -- ``ph`` in {X, i, M},
   complete events with a numeric ``ts`` and ``dur >= 0``, instants with a
   scope ``s`` -- so the file loads in Perfetto / chrome://tracing.

    python -m repro_torch.obs.check SNAPSHOT [TRACE]

exits 1 on any violation, printing each.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

__all__ = ["check_snapshot", "check_trace", "main", "TERMINAL_KEYS"]

TERMINAL_KEYS = ("completed", "rejected", "shed", "timeouts", "failures",
                 "cancelled")


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _load(path: str, what: str, failures: List[str]):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        failures.append(f"{what} {path}: unreadable ({e})")
        return None


def check_snapshot(path: str) -> List[str]:
    """The violations of one registry snapshot file (empty: it passes)."""
    failures: List[str] = []
    snap = _load(path, "snapshot", failures)
    if snap is None:
        return failures
    if not isinstance(snap, dict):
        return [f"snapshot {path}: top level must be an object"]
    for sec in ("counters", "gauges", "histograms"):
        if not isinstance(snap.get(sec), dict):
            return [f"snapshot: missing/invalid '{sec}' map"]
    for name, v in snap["counters"].items():
        if not _is_num(v):
            failures.append(f"snapshot: counter {name} is not numeric: "
                            f"{v!r}")
        elif v < 0:
            failures.append(f"snapshot: counter {name} is negative ({v}) -- "
                            f"counters are monotonic")
    for name, v in snap["gauges"].items():
        if not _is_num(v):
            failures.append(f"snapshot: gauge {name} is not numeric: {v!r}")
    for name, s in snap["histograms"].items():
        if not isinstance(s, dict):
            failures.append(f"snapshot: histogram {name} is not a summary "
                            f"object")
            continue
        missing = [k for k in ("count", "sum", "mean", "p50", "p95", "p99")
                   if not _is_num(s.get(k))]
        if missing:
            failures.append(f"snapshot: histogram {name} missing numeric "
                            f"{missing}")
            continue
        if s["count"] and not (s["p50"] <= s["p95"] <= s["p99"]):
            failures.append(f"snapshot: histogram {name} percentiles not "
                            f"ordered: p50={s['p50']} p95={s['p95']} "
                            f"p99={s['p99']}")

    c = snap["counters"]
    if "engine_requests_submitted_total" in c:
        submitted = c["engine_requests_submitted_total"]
        parts = {k: c.get(f"engine_requests_{k}_total", 0.0)
                 for k in TERMINAL_KEYS}
        if sum(parts.values()) != submitted:
            failures.append(f"snapshot: terminal counters do not partition "
                            f"submissions: {parts} vs submitted={submitted}")
    if c.get("ckpt_commits_total", 0) > c.get("ckpt_saves_total", 0):
        failures.append("snapshot: more checkpoint commits than save "
                        "attempts")
    g = snap["gauges"]
    audit = snap.get("contraction_audit")
    if audit and "counting_fraction_square" in g:
        if abs(g["counting_fraction_square"]
               - audit["fraction_square"]) > 1e-9:
            failures.append(f"snapshot: counting_fraction_square gauge "
                            f"({g['counting_fraction_square']}) != audit "
                            f"({audit['fraction_square']})")
    if not failures:
        print(f"ok: snapshot {path} ({len(c)} counters, {len(g)} gauges, "
              f"{len(snap['histograms'])} histograms)")
    return failures


def check_trace(path: str) -> List[str]:
    """The violations of one Chrome trace file (empty: it passes)."""
    failures: List[str] = []
    tr = _load(path, "trace", failures)
    if tr is None:
        return failures
    events = tr.get("traceEvents") if isinstance(tr, dict) else None
    if not isinstance(events, list):
        return [f"trace {path}: missing 'traceEvents' list"]
    n_x = n_i = 0
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            failures.append(f"trace: event #{i} is not an object")
            return failures
        ph = e.get("ph")
        if ph not in ("X", "i", "M"):
            failures.append(f"trace: event #{i} has unsupported ph={ph!r}")
            continue
        if ph == "M":
            continue
        if not _is_num(e.get("ts")) or e["ts"] < 0:
            failures.append(f"trace: event #{i} ({e.get('name')}) bad "
                            f"ts={e.get('ts')!r}")
        if not isinstance(e.get("name"), str) or "pid" not in e \
                or "tid" not in e:
            failures.append(f"trace: event #{i} missing name/pid/tid")
        if ph == "X":
            n_x += 1
            if not _is_num(e.get("dur")) or e["dur"] < 0:
                failures.append(f"trace: complete event #{i} "
                                f"({e.get('name')}) bad dur={e.get('dur')!r}")
        else:
            n_i += 1
            if e.get("s") not in ("t", "p", "g"):
                failures.append(f"trace: instant event #{i} "
                                f"({e.get('name')}) bad scope "
                                f"s={e.get('s')!r}")
    if not failures:
        print(f"ok: trace {path} ({n_x} spans, {n_i} instants)")
    return failures


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.check",
        description="check a registry snapshot and, optionally, a Chrome "
                    "trace written by the serving launcher")
    ap.add_argument("snapshot", help="registry snapshot JSON "
                                     "(--metrics-file)")
    ap.add_argument("trace", nargs="?", default=None,
                    help="Chrome trace JSON (--trace-out)")
    args = ap.parse_args(argv)
    failures = check_snapshot(args.snapshot)
    if args.trace is not None:
        failures += check_trace(args.trace)
    for msg in failures:
        print(f"FAIL: {msg}")
    if failures:
        print(f"\nobs check: {len(failures)} violation(s)")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
