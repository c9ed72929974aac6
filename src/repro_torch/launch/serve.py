"""Serving launcher: the paged continuous-batching engine (default) or the
dense reference Server (``--legacy``), on the GPU.  An arch with non-KV
decode state (the recurrent ``recurrentgemma-2b`` and ``xlstm-350m``, the
encoder-decoder ``whisper-large-v3``, the prefix-token ``paligemma-3b``)
falls back to the dense Server with the JAX launcher's note.

    python -m repro_torch.launch.serve --arch fairsquare-demo \\
        --matmul-mode square_pallas --prepared [--legacy --max-batch 4]

serves the paper's model at full width (random weights from ``--seed``;
``--layers N`` and ``--encoder-layers N`` cut the depth) with every
contraction square-form (``--policy none``, the default): K1
runs every projection, FFN and logits GEMM, K4 the engine's decode
attention, and K2/K3 the attention einsums of prefill (and, under
``--legacy``, of every decode step).  ``--policy square_gemms`` keeps the
attention softmax path on the multiplier.  ``--reduced`` serves the small
smoke configuration; ``--device cpu`` runs the kernels' plain versions;
``--route`` pins the square_pallas route (``REPRO_ROUTE`` syntax).

The paged engine's resilience and observability flags are the JAX
launcher's: ``--deadline-ms``, ``--queue-limit``, ``--shed-policy``,
``--guard`` (fail non-finite-logits slots, guard every square-routed
contraction), ``--metrics-file`` (the engine's registry snapshot as JSON)
and ``--trace-out`` (a Chrome trace of the run).  Check the two files with
``python -m repro_torch.obs.check METRICS TRACE``.  :func:`main` returns
``{rid: RequestResult}`` (the engine) or ``{rid: tokens}`` (``--legacy``).

On the GPU both paths serve from CUDA graphs, as the JAX launcher serves
from jitted steps: the engine captures its three model calls
(``EngineConfig.jit``, whose default captures on CUDA), the dense Server
its decode step; ``--guard`` then runs the compiled guard (probes in the
graphs, drained after each call; a demotion re-captures, counted in
``engine_guard_rejits_total``).  On the CPU both run eagerly.  To audit a
compiled run, enclose :func:`main` in
``repro_torch.core.counting.compiled_audit()`` (it must cover the
captures) and ``track_compiled_contractions()``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import SQUARE_GEMMS_POLICY
from repro_torch.models.blocks import PAGEABLE_KINDS
from repro_torch.models.lm import build_model
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.export import write_chrome_trace
from repro_torch.serve.engine import SHED_POLICIES, Engine, EngineConfig
from repro_torch.serve.server import Request, ServeConfig, Server

__all__ = ["make_requests", "main"]


def make_requests(cfg, n: int, seed: int = 0, lo: int = 4,
                  hi: int = 24) -> List[Request]:
    """``n`` ragged prompts from a numpy seed, each with its extras (a
    prefix arch's ``patches``, an encoder-decoder arch's ``frames``, both
    N(0, 1) f32): the JAX launcher's draws in its order, so both packages
    serve the same requests."""
    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(n):
        plen = int(rng.integers(lo, hi))
        extras = {}
        if cfg.prefix_tokens:
            extras["patches"] = rng.normal(
                size=(cfg.prefix_tokens, cfg.d_model)).astype(np.float32)
        if cfg.encoder_layers:
            extras["frames"] = rng.normal(
                size=(cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        reqs.append(Request(rid, rng.integers(0, cfg.vocab, plen,
                                              dtype=np.int32),
                            extras or None))
    return reqs


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="fairsquare-demo")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="serve only the first N layers of --arch, at its "
                         "width (a depth cut)")
    ap.add_argument("--encoder-layers", type=int, default=0,
                    help="an encoder-decoder arch: only the first N "
                         "encoder layers")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--matmul-mode", default=None)
    ap.add_argument("--policy", choices=["none", "square_gemms"],
                    default="none",
                    help="per-site contraction policy (square_gemms = "
                         "square everywhere but the attention softmax path)")
    ap.add_argument("--route", default=None,
                    help="pin the square_pallas route (REPRO_ROUTE syntax)")
    ap.add_argument("--prepared", action="store_true",
                    help="prepare every GEMM weight once at engine start")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--blocks", type=int, default=64)
    ap.add_argument("--blocks-per-seq", type=int, default=8)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--legacy", action="store_true",
                    help="serve through the dense reference Server")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="decode slots of the dense Server (--legacy)")
    # resilience (engine only)
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline from submit, in ms (an "
                         "expired request ends TIMED_OUT with its partial "
                         "tokens)")
    ap.add_argument("--queue-limit", type=int, default=None,
                    help="bounded admission queue depth; overflow is shed "
                         "per --shed-policy")
    ap.add_argument("--shed-policy", choices=SHED_POLICIES,
                    default="reject-new",
                    help="full-queue policy: refuse the newcomer, or evict "
                         "the oldest queued request")
    ap.add_argument("--guard", action="store_true",
                    help="numerics guard: fail non-finite-logits slots and "
                         "let the route-health breaker demote saturating "
                         "square-route sites")
    # observability
    ap.add_argument("--metrics-file", default=None,
                    help="write the engine's registry snapshot (counters, "
                         "gauges, histogram percentiles, route health) as "
                         "JSON")
    ap.add_argument("--trace-out", default=None,
                    help="trace the run and write a Chrome trace_event JSON "
                         "(Perfetto / chrome://tracing)")
    args = ap.parse_args(argv)
    tracing = (obs_trace.capture() if args.trace_out
               else contextlib.nullcontext())
    with tracing as tracer:
        results = _serve(args)
        if tracer is not None:
            write_chrome_trace(tracer, args.trace_out)
            print(f"  trace -> {args.trace_out} ({len(tracer.records())} "
                  f"records, {tracer.dropped} dropped)")
    return results


def _serve(args):
    """Build the model and serve the requests as ``args`` say."""
    if args.route:
        os.environ["REPRO_ROUTE"] = args.route
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if args.encoder_layers:
        if not cfg.encoder_layers:
            raise ValueError(f"--encoder-layers: arch {cfg.name!r} has no "
                             f"encoder")
        cfg = dataclasses.replace(cfg, encoder_layers=args.encoder_layers)
    if args.matmul_mode:
        cfg = dataclasses.replace(cfg, matmul_mode=args.matmul_mode)
    if args.policy == "square_gemms":
        cfg = dataclasses.replace(cfg, contraction_policy=SQUARE_GEMMS_POLICY)
    if not args.legacy and (cfg.encoder_layers or cfg.prefix_tokens
                            or any(k not in PAGEABLE_KINDS
                                   for k in cfg.layer_kinds)):
        print(f"note: arch {cfg.name!r} has non-KV decode state; "
              f"falling back to the dense reference Server")
        args.legacy = True
    model = build_model(cfg, device=args.device, seed=args.seed)
    reqs = make_requests(cfg, args.requests, seed=args.seed)
    if args.legacy:
        if args.metrics_file:
            print("note: --metrics-file needs the paged engine's registry; "
                  "ignored under --legacy")
        return _serve_legacy(model, reqs, args)
    ecfg = EngineConfig(max_slots=args.slots, block_size=args.block_size,
                        num_blocks=args.blocks,
                        blocks_per_seq=args.blocks_per_seq,
                        prefill_chunk=args.prefill_chunk,
                        max_new_tokens=args.max_new, prepared=args.prepared,
                        deadline_s=(args.deadline_ms / 1e3
                                    if args.deadline_ms is not None
                                    else None),
                        queue_limit=args.queue_limit,
                        shed_policy=args.shed_policy, guard=args.guard)
    engine = Engine(model, ecfg, seed=args.seed, device=model.device)
    results = engine.run(reqs)
    m = engine.metrics
    print(f"[engine] served {len(results)} requests, {m.tokens_out} tokens "
          f"in {m.wall_s:.2f}s ({m.tokens_per_s:.1f} tok/s, "
          f"mode={cfg.matmul_mode}, prepared={args.prepared}, "
          f"device={model.device})")
    print(f"  ttft mean {m.mean_ttft_s * 1e3:.0f}ms | block util "
          f"{m.mean_utilization:.0%} (peak {m.peak_blocks_used} blk) | "
          f"occupancy {m.batch_occupancy:.2f} slots/step | "
          f"{m.prefill_chunks} prefill chunks, {m.decode_steps} decode "
          f"steps, {m.preemptions} preemptions")
    by_status = {}
    for r in results.values():
        by_status[str(r.status)] = by_status.get(str(r.status), 0) + 1
    print(f"  terminals: {by_status} | shed {m.shed} | timeouts "
          f"{m.timeouts} | guard trips {m.guard_trips} | guard recomputes "
          f"{m.guard_recomputes} | guard rejits {m.guard_rejits} | step "
          f"failures {m.step_failures}")
    summ = m.summary()
    print(f"  ttft p50/p95/p99 {summ['ttft_p50_s'] * 1e3:.0f}/"
          f"{summ['ttft_p95_s'] * 1e3:.0f}/{summ['ttft_p99_s'] * 1e3:.0f}ms"
          f" | decode step p50/p95/p99 "
          f"{summ['decode_step_p50_s'] * 1e3:.1f}/"
          f"{summ['decode_step_p95_s'] * 1e3:.1f}/"
          f"{summ['decode_step_p99_s'] * 1e3:.1f}ms")
    snap = engine.obs_snapshot()
    demoted = [h["key"] for h in snap["route_health"] if h["demoted"]]
    line = (f"  route health: {len(snap['route_health'])} tracked site(s), "
            f"{len(demoted)} demoted")
    if demoted:
        line += " -> " + ", ".join(demoted)
    print(line)
    if args.metrics_file:
        with open(args.metrics_file, "w") as f:
            json.dump(snap, f, indent=1, sort_keys=True)
        print(f"  metrics snapshot -> {args.metrics_file}")
    for rid in sorted(results)[:4]:
        print(f"  req {rid}: {results[rid].tokens[:8]}...")
    if len(results) != args.requests:
        raise RuntimeError(f"{len(results)} results for {args.requests} "
                           f"requests")
    return results


def _serve_legacy(model, reqs: List[Request], args):
    """The dense reference Server with the JAX launcher's geometry
    (``cache_len`` 128)."""
    with torch.no_grad():
        params = model.prepare_params() if args.prepared else model.tree()
    server = Server(model, params,
                    ServeConfig(max_batch=args.max_batch, cache_len=128,
                                max_new_tokens=args.max_new),
                    seed=args.seed, device=model.device)
    t0 = time.perf_counter()
    results = server.run(reqs)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in results.values())
    print(f"[legacy] served {len(results)} requests, {total} tokens in "
          f"{dt:.2f}s ({total / dt:.1f} tok/s, mode={model.cfg.matmul_mode}, "
          f"prepared={args.prepared}, device={model.device})")
    for rid in sorted(results)[:4]:
        print(f"  req {rid}: {results[rid][:8]}...")
    if len(results) != len(reqs):
        raise RuntimeError(f"{len(results)} results for {len(reqs)} "
                           f"requests")
    return results


if __name__ == "__main__":
    main()
