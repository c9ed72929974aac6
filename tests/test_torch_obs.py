"""The port's observability layer (``repro_torch.obs``) against the JAX
package's ``repro.obs``: the same calls give the same registry snapshot,
the same Prometheus text, the same Chrome trace (a counting clock is
injected into both tracers, so even the timestamps agree) and the same
per-request breakdown; and ``python -m repro_torch.obs.check`` gives the
verdicts and messages of ``scripts/check_obs.py`` on the same files.
"""
import copy
import itertools
import json
import subprocess
import sys
from pathlib import Path

import pytest

from repro import obs as jobs
from repro_torch import obs as tobs
from repro_torch.obs import check as tcheck

ROOT = Path(__file__).resolve().parents[1]


def _clock():
    c = itertools.count()
    return lambda: next(c) * 0.001


def _drive(obs, capacity):
    """One scripted run through an obs package: spans (one raising),
    request lifecycle events, counters, gauges, labeled metrics,
    histograms, and both publishers.  Returns what can be compared."""
    reg = obs.MetricsRegistry()
    with obs.trace.capture(capacity=capacity, clock=_clock()) as tr:
        for rid in range(3):
            obs.trace.event("request.submit", cat="engine", rid=rid,
                            prompt_tokens=4 + rid)
        with obs.trace.span("engine.tick", cat="engine", tick=1):
            with obs.trace.span("engine.admit", cat="engine"):
                for rid in range(2):
                    obs.trace.event("request.admit", cat="engine", rid=rid,
                                    slot=rid)
            with obs.trace.span("engine.prefill_chunk", cat="engine", rid=0,
                                lo=0, n=4):
                pass
            obs.trace.event("request.first_token", cat="engine", rid=0,
                            ttft_s=0.01)
        with pytest.raises(RuntimeError):
            with obs.trace.span("engine.decode_step", cat="engine", n_live=1):
                raise RuntimeError("injected")
        for rid, status in ((0, "completed"), (1, "failed"), (2, "rejected")):
            obs.trace.event("request.terminal", cat="engine", rid=rid,
                            status=status)
        assert tr.open_spans == 0
        chrome = obs.to_chrome_trace(tr)
        breakdown = obs.request_breakdown(tr)
        dropped = tr.dropped
    reg.counter("engine_requests_submitted_total", help="submitted").inc(3)
    reg.counter("engine_requests_completed_total").inc()
    reg.gauge("engine_queue_depth").set(2)
    reg.gauge("engine_live_slots").inc(3)
    h = reg.histogram("engine_ttft_seconds")
    for v in (0.0002, 0.003, 0.003, 0.07, 0.4, 99.0):
        h.observe(v)
    reg.histogram("custom", buckets=(1.0, 2.0), labels={"site": "ffn"}) \
        .observe(1.5)
    obs.publish_contraction_audit(
        {"total_mults": 100, "multiplies_replaced_by_squares": 80,
         "fraction_square": 0.8, "bwd_mults": 0, "fraction_square_bwd": 0.0,
         "fraction_demoted": 0.1, "demoted_sites": ["logits"]}, reg)
    obs.publish_route_health(
        [{"key": "ffn|1x4x8x4|float32", "trips": 3, "demoted": True,
          "reason": "r", "first_trip": 1, "last_trip": 3},
         {"key": "attn_paged|1x1x2x1x16x128|bfloat16", "trips": 1,
          "demoted": False, "reason": None, "first_trip": 4,
          "last_trip": 4}], reg)
    return {"snapshot": reg.snapshot(), "prometheus": reg.to_prometheus(),
            "chrome": chrome, "breakdown": breakdown, "dropped": dropped}


@pytest.mark.parametrize("capacity", [16384, 8, 3])
def test_same_calls_give_the_same_artifacts(capacity):
    got, want = _drive(tobs, capacity), _drive(jobs, capacity)
    assert got == want
    if capacity == 3:
        assert got["dropped"] > 0          # the ring bound held and counted


def test_chrome_trace_carries_error_tags_and_dropped_count():
    out = _drive(tobs, 16384)["chrome"]
    assert out["otherData"]["dropped_records"] == 0
    errored = [e for e in out["traceEvents"]
               if e.get("args", {}).get("error") == "RuntimeError"]
    assert [e["name"] for e in errored] == ["engine.decode_step"]
    assert out["traceEvents"][0]["ph"] == "M"


@pytest.mark.parametrize("values", [[], [0.5], [1e-5, 2e-4, 7.0, 100.0],
                                    [0.003] * 50 + [0.2] * 3])
def test_histogram_quantiles_match_jax(values):
    th, jh = tobs.Histogram("h"), jobs.Histogram("h")
    for v in values:
        th.observe(v)
        jh.observe(v)
    assert th.summary() == jh.summary()
    for q in (0.0, 0.25, 0.5, 0.95, 0.99, 1.0):
        assert th.quantile(q) == jh.quantile(q)


def test_counter_monotonic_and_type_conflicts_raise_like_jax():
    for obs in (tobs, jobs):
        reg = obs.MetricsRegistry()
        with pytest.raises(ValueError, match="monotonic"):
            reg.counter("c").inc(-1)
        reg.gauge("g")
        with pytest.raises(ValueError, match="already registered"):
            reg.counter("g")
        with pytest.raises(ValueError, match="quantile"):
            obs.Histogram("h").quantile(1.5)
        with pytest.raises(ValueError, match="sorted"):
            obs.Histogram("h", buckets=(2.0, 1.0))
        with pytest.raises(ValueError, match="capacity"):
            obs.trace.Tracer(capacity=0)


def test_disabled_tracer_is_a_shared_noop():
    tobs.trace.disable()
    assert not tobs.trace.enabled()
    assert tobs.trace.span("a") is tobs.trace.span("b")
    tobs.trace.event("x")                      # no tracer: nothing recorded
    with tobs.trace.capture() as tr:
        assert tobs.trace.get_tracer() is tr
    assert tobs.trace.get_tracer() is None


def test_write_chrome_trace_round_trips(tmp_path):
    with tobs.trace.capture(clock=_clock()) as tr:
        with tobs.trace.span("engine.tick", cat="engine", tick=1):
            tobs.trace.event("request.submit", cat="engine", rid=0)
        path = tobs.write_chrome_trace(tr, str(tmp_path / "t.json"))
    assert json.loads(Path(path).read_text()) == tobs.to_chrome_trace(tr)
    assert tcheck.check_trace(path) == []


# ------------------------------------------- the artifact checks, both ways
def _good_snapshot():
    return {
        "counters": {"engine_requests_submitted_total": 4,
                     "engine_requests_completed_total": 2,
                     "engine_requests_shed_total": 1,
                     "engine_requests_timeouts_total": 1},
        "gauges": {"counting_fraction_square": 0.75, "engine_queue_depth": 0},
        "histograms": {"engine_ttft_seconds": {
            "count": 2, "sum": 0.5, "mean": 0.25, "p50": 0.2, "p95": 0.3,
            "p99": 0.3}},
        "contraction_audit": {"fraction_square": 0.75}}


def _good_trace():
    return {"traceEvents": [
        {"name": "process_name", "ph": "M", "pid": 1, "tid": 0, "ts": 0},
        {"name": "engine.tick", "cat": "engine", "ph": "X", "pid": 1,
         "tid": 0, "ts": 1.0, "dur": 5.0, "args": {}},
        {"name": "request.submit", "cat": "engine", "ph": "i", "s": "t",
         "pid": 1, "tid": 0, "ts": 2.0, "args": {"rid": 0}}]}


def _mutate(obj, path, value):
    obj = copy.deepcopy(obj)
    node = obj
    for k in path[:-1]:
        node = node[k]
    if value is KeyError:
        del node[path[-1]]
    else:
        node[path[-1]] = value
    return obj


SNAPSHOTS = {
    "good": _good_snapshot(),
    "negative_counter": _mutate(_good_snapshot(),
                                ("counters", "engine_requests_shed_total"),
                                -1),
    "no_partition": _mutate(_good_snapshot(),
                            ("counters", "engine_requests_submitted_total"),
                            5),
    "string_gauge": _mutate(_good_snapshot(),
                            ("gauges", "engine_queue_depth"), "x"),
    "unordered_hist": _mutate(_good_snapshot(),
                              ("histograms", "engine_ttft_seconds", "p95"),
                              0.1),
    "hist_missing_key": _mutate(_good_snapshot(),
                                ("histograms", "engine_ttft_seconds", "p99"),
                                KeyError),
    "audit_disagrees": _mutate(_good_snapshot(),
                               ("contraction_audit", "fraction_square"), 0.5),
    "no_gauges": _mutate(_good_snapshot(), ("gauges",), KeyError),
    "ckpt_ledger": _mutate(_good_snapshot(), ("counters",
                                              "ckpt_commits_total"), 2),
}
TRACES = {
    "good": _good_trace(),
    "bad_ph": _mutate(_good_trace(), ("traceEvents", 1, "ph"), "B"),
    "negative_dur": _mutate(_good_trace(), ("traceEvents", 1, "dur"), -1.0),
    "bad_scope": _mutate(_good_trace(), ("traceEvents", 2, "s"), "x"),
    "no_tid": _mutate(_good_trace(), ("traceEvents", 2, "tid"), KeyError),
    "no_events": {"events": []},
}


def _fails(stdout):
    return sorted(line for line in stdout.splitlines()
                  if line.startswith("FAIL: "))


def _check_obs(args):
    """``scripts/check_obs.py`` (stdlib only) in a process of its own: its
    violation list is a module global."""
    out = subprocess.run([sys.executable, "scripts/check_obs.py", *args],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    return out.returncode, _fails(out.stdout)


def _port_check(args, capsys):
    capsys.readouterr()
    rc = tcheck.main(args)
    return rc, _fails(capsys.readouterr().out)


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_snapshot_check_matches_check_obs(name, tmp_path, capsys):
    p = tmp_path / "m.json"
    p.write_text(json.dumps(SNAPSHOTS[name]))
    want = _check_obs(["--snapshot", str(p)])
    got = _port_check([str(p)], capsys)
    assert got == want
    assert (got[0] == 0) == (name == "good")


@pytest.mark.parametrize("name", sorted(TRACES))
def test_trace_check_matches_check_obs(name, tmp_path, capsys):
    snap, tr = tmp_path / "m.json", tmp_path / "t.json"
    snap.write_text(json.dumps(_good_snapshot()))
    tr.write_text(json.dumps(TRACES[name]))
    want = _check_obs(["--snapshot", str(snap), "--trace", str(tr)])
    got = _port_check([str(snap), str(tr)], capsys)
    assert got == want
    assert (got[0] == 0) == (name == "good")


def test_check_reports_unreadable_files(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert tcheck.main([str(bad)]) == 1
    assert tcheck.main([str(tmp_path / "missing.json")]) == 1


def test_check_runs_as_a_module(tmp_path):
    p = tmp_path / "m.json"
    p.write_text(json.dumps(_good_snapshot()))
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs.check",
                          str(p)], capture_output=True, text=True,
                         timeout=120, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("ok: snapshot")
