"""Serving launcher: the paged continuous-batching engine on the GPU.

    python -m repro_torch.launch.serve --arch fairsquare-demo \\
        --matmul-mode square_pallas --policy square_gemms --prepared

runs the paper's model at full width (random weights from ``--seed``)
through K1 (every projection, FFN and logits GEMM) and K4 (decode
attention).  ``--reduced`` serves the small smoke configuration;
``--device cpu`` runs the kernels' plain versions; ``--route`` pins the
square_pallas route (``REPRO_ROUTE`` syntax).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, Optional

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import SQUARE_GEMMS_POLICY
from repro_torch.models.lm import build_model
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.server import Request

__all__ = ["make_requests", "main"]


def make_requests(cfg, n: int, seed: int = 0, lo: int = 4,
                  hi: int = 24) -> List[Request]:
    """``n`` ragged prompts from a numpy seed (the JAX launcher's draws, so
    both packages serve the same prompts)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(n):
        plen = int(rng.integers(lo, hi))
        reqs.append(Request(rid, rng.integers(0, cfg.vocab, plen,
                                              dtype=np.int32)))
    return reqs


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="fairsquare-demo")
    ap.add_argument("--reduced", action="store_true")
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
    args = ap.parse_args(argv)

    if args.route:
        os.environ["REPRO_ROUTE"] = args.route
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.matmul_mode:
        cfg = dataclasses.replace(cfg, matmul_mode=args.matmul_mode)
    if args.policy == "square_gemms":
        cfg = dataclasses.replace(cfg, contraction_policy=SQUARE_GEMMS_POLICY)
    model = build_model(cfg, device=args.device, seed=args.seed)
    ecfg = EngineConfig(max_slots=args.slots, block_size=args.block_size,
                        num_blocks=args.blocks,
                        blocks_per_seq=args.blocks_per_seq,
                        prefill_chunk=args.prefill_chunk,
                        max_new_tokens=args.max_new, prepared=args.prepared)
    engine = Engine(model, ecfg, seed=args.seed, device=model.device)
    results = engine.run(make_requests(cfg, args.requests, seed=args.seed))
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
    print(f"  terminals: {by_status}")
    for rid in sorted(results)[:4]:
        print(f"  req {rid}: {results[rid].tokens[:8]}...")
    if len(results) != args.requests:
        raise RuntimeError(f"{len(results)} results for {args.requests} "
                           f"requests")
    return results


if __name__ == "__main__":
    main()
