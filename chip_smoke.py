"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the hand-written
CUDA kernels from the sources in this checkout, holds each against its
plain PyTorch version at every shape the serving paths below launch it
at, then serves the full-width fairsquare-demo model (square_pallas,
prepared weights, bf16) three ways and checks after each that it went
through the kernels, at shapes held to their plain versions:

- the paged engine with the square_gemms policy (attention softmax path on
  the multiplier): K1 on every GEMM, K4 on decode attention; a few decode
  ticks are traced with torch.profiler for the device-busy share;
- the paged engine with no policy (every contraction square): K2 on the
  attention einsums of each prefill chunk as well;
- the dense reference Server (``--legacy``) with no policy: K2/K3 on
  prefill attention, K3 on every decode step's attention, K1 elsewhere; a
  few of its decode steps are traced too;
- the launcher (``repro_torch.launch.serve.main``) as the first path, with
  ``--guard``, ``--deadline-ms``, ``--queue-limit``, ``--metrics-file`` and
  ``--trace-out``, compiled (CUDA graphs, its default on the GPU) inside
  the compiled contraction audit: the first path's tokens, a snapshot and
  a trace that pass ``repro_torch.obs.check``, no guard trip, recompute,
  re-capture or step failure, the same K1/K4 launches per step (and one
  call more for each capture's warm-up), and the audit's per-site mults
  and square fraction equal to the analytic count (the no-policy path's
  eager audit too, at a square fraction of 1); then the eager guard alone
  on the first path's model, timed per decode tick and traced;
- the first path again with its three model calls replayed from CUDA
  graphs: the eager path's tokens, 3 captures, K1 +85 and K4 +12 a decode
  tick by the capture ledger and in a profiled replay, eager and compiled
  engines timed in turns and traced, and a guarded compiled engine; and
  the dense Server with its decode step replayed (the eager Server's
  tokens, K1 85 and K3 24 a step by the ledger and the profiler).

The first three paths run eagerly (``jit=False``), as the JAX engine's
benchmark regime does; the launcher and the graph phases run what the
launcher serves on the GPU.

After the conv and complex phases below, the engine runs a fault schedule
at full width and 2 layers (allocator, prefill and decode failures, a
poisoned logits row, a clock skew past a deadline, a queue shedding the
oldest, a cancel): every request terminal, no block leaked, the poisoned
row FAILED and counted, every completed request token-identical to a
clean run, eagerly and compiled.  Then the numerics guard on K1's route:
f32 operands past the square form's range trip it, each call returns the
standard result, and the second trip demotes the key so K1 is launched no
more.  Last, the compiled guard: the same contraction captured in a CUDA
graph trips through its probes, demotes on the second replay and is
re-captured on the standard route; and an engine whose seeded demotion
re-captures its graphs keeps its tokens and its memory.

K1 is also held bit for bit to K2 at nb = 1 and to K3 at every shape, and
timed beside K2 at nb = 1; K3 is timed beside K2 on its own operands, and
K2's and K3's per-unit sums are printed beside torch.bmm's and the bound's;
K4 is also checked and timed at
1024-token tables (against a float64 reference there, since the plain
version's own f32 rounding reaches the tolerance at that length).  Each
phase prints the split and cluster shape its kernel launched with.

It then holds the convolution kernels to their plain versions -- K7 at the
six ResNet-50 layers it runs at batch 8 and a ragged/padded set, K8 on
2^20-sample FIR streams and a ragged set, every template instance of both
free of spills in the compiler's report and every launch's grid and tile
checked against its Python mirror, each timed row beside the bound and
the FP32 slot floor, with per-pass sums beside F.conv2d and F.conv1d --
and drives the two conv paths as a user would:
``conv2d(mode="square_pallas")`` with prepared filters over those layers
and the CIFAR ResNet stem (K7 six times, K1 once through im2col), and
``ops.sq_conv`` over the three streams (K8 three times).

Last, the complex square matmuls: K5 (CPM3) and K6 (CPM4), each template
instance free of spills in the compiler's report, are held to their plain
versions at the batched-DFT shape (4096 x 1024 x 1024) and at 64^3, each
launch's grid checked against its mirror and timed beside torch.matmul on
complex64, the FLOP bound and the FP32 slot floor (the card's clock and
power sampled alongside), and the DFT path is driven as a user would: ``ops.cpm3_matmul`` and ``ops.cpm4_matmul`` of 4096 numpy signals of
1024 samples (seed 0) by ``transforms.dft_matrix(1024)`` -- one K5 and one
K6 launch -- each result held to ``torch.fft.fft``.

    python3 chip_smoke.py

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repo.  Its last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``;
the line before it is the card's name and power limit, and the one before
that lists the kernels with their launches on each path, their times,
their plain versions' times, their bounds and a library call's time.
Times are CUDA-graph replays (no host gaps); K1's weights are cycled
through enough copies to defeat the 50 MB L2, as the decode path finds
them, while the operands of K2/K3, K7 and K8 are the activations or
samples their caller has just written and stay hot.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.configs.base import SQUARE_GEMMS_POLICY        # noqa: E402
from repro_torch.core import counting, graphs, guards           # noqa: E402
from repro_torch.core.einsum import fs_einsum                   # noqa: E402
from repro_torch.kernels import build, routing                  # noqa: E402
from repro_torch.kernels.sq_matmul import (                     # noqa: E402
    k1_launch_shape, k2_launch_shape, k3_launch_shape,
    sq_matmul_batched_plain, sq_matmul_k1, sq_matmul_k2, sq_matmul_k3,
    sq_matmul_plain)
from repro_torch.core import conv as conv_core                   # noqa: E402
from repro_torch.core import transforms                          # noqa: E402
from repro_torch.core.prepared import prepare_operand           # noqa: E402
from repro_torch.kernels import ops                             # noqa: E402
from repro_torch.kernels.cpm3_matmul import (                   # noqa: E402
    cpm3_matmul_k5, cpm3_matmul_plain, k5_launch_shape)
from repro_torch.kernels.cpm4_matmul import (                   # noqa: E402
    cpm4_matmul_k6, cpm4_matmul_plain, k6_launch_shape)
from repro_torch.kernels.sq_conv import (                       # noqa: E402
    k8_launch_shape, sq_conv_k8, sq_conv_plain)
from repro_torch.kernels.sq_conv2d import (                     # noqa: E402
    conv2d_out_hw, k7_launch_shape, sq_conv2d_k7, sq_conv2d_plain)
from repro_torch.kernels.sq_paged_attn import (                 # noqa: E402
    k4_splits, sq_paged_attn_k4, sq_paged_attn_plain)
from repro_torch.launch import serve as serve_launcher          # noqa: E402
from repro_torch.launch.serve import make_requests              # noqa: E402
from repro_torch.models.attention import EMPTY_POS              # noqa: E402
from repro_torch.models.lm import LM, build_model               # noqa: E402
from repro_torch.obs import check as obs_check                  # noqa: E402
from repro_torch.serve.faults import FaultInjector, FaultPlan   # noqa: E402
from repro_torch.serve.engine import (                          # noqa: E402
    Engine, EngineConfig, RequestStatus)
from repro_torch.serve.server import (                          # noqa: E402
    Request, ServeConfig, Server, write_slot)

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and the CUDA-core FP32 rate
# outside the tensor cores.  The squares run on the CUDA cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# An FP32 add takes an issue slot as an fma does: the slot rate is half the
# FLOP rate, and it is what bounds a square kernel's instruction mix.
FP32_SLOTS_PER_S = FP32_OPS_PER_S / 2
L2_DEFEAT_BYTES = 200 * 2 ** 20

# The serving geometry of launch/serve.py.
SLOTS, BLOCK, BLOCKS, BLOCKS_PER_SEQ, CHUNK = 8, 16, 64, 8, 32
N_REQUESTS, MAX_NEW = 8, 16
# GEMMs per layer: wq, wk, wv, wo (d x d), w_gate, w_up (d x ff), w_down
# (ff x d); plus the tied logits once per forward.
GEMMS_PER_LAYER = 7

# The dense reference Server of launch/serve.py --legacy.
DENSE_BATCH, DENSE_CACHE = 4, 128
HEADS, HEAD_DIM = 12, 64
LAYERS = 12                     # fairsquare-demo's: launches of a shape per unit

K1_SHAPES = [(768, 768), (768, 3072), (3072, 768), (768, 32000)]


def k1_cases(prompt_lens):
    """(m, k, n, timed) compared with the plain version: the engine's decode
    rows (8) and prefill chunk (32) and the dense Server's decode rows (4)
    at every (k, n), the single row of a request's first-token logits, and
    each prompt length at the layer GEMMs (the dense Server's prefill;
    checked, not timed).  The serving phases check that they launched K1
    at no other shape."""
    cases = [(m, k, n, True) for m in (8, 32, 4) for k, n in K1_SHAPES]
    cases.append((1, 768, 32000, True))
    cases += [(s, k, n, False) for s in sorted(set(prompt_lens) - {1, 4, 8, 32})
              for k, n in K1_SHAPES[:3]]
    return cases


# the batched GEMMs of one unit, each launched once a layer: K2's paged
# prefill chunk (scores, PV) and K3's dense decode step of 4 slots
UNIT_SHAPES = {
    "K2": [(HEADS, CHUNK, HEAD_DIM, BLOCKS_PER_SEQ * BLOCK),
           (HEADS, CHUNK, BLOCKS_PER_SEQ * BLOCK, HEAD_DIM)],
    "K3": [(DENSE_BATCH * HEADS, 1, HEAD_DIM, DENSE_CACHE),
           (DENSE_BATCH * HEADS, 1, DENSE_CACHE, HEAD_DIM)]}
UNIT_NAMES = {"K2": "paged prefill chunk", "K3": "dense decode step"}


def dense_prefill_kernel(s: int):
    """The kernel of a dense-Server prefill's two attention einsums at full
    width, for a prompt of s tokens: K2 from 13 tokens, K3 for 7-12, none
    (the virtual route) below."""
    return "K2" if s >= 13 else "K3" if s >= 7 else None


def batched_cases(prompt_lens):
    """{"K2": [(B, m, k, n)], "K3": [...]}: every batched GEMM the serving
    phases launch.  Paged prefill chunk: scores (12, 32, 64) @ (12, 64,
    128), PV (12, 32, 128) @ (12, 128, 64); dense prefill of s tokens:
    (12, s, 64) @ (12, 64, s) and (12, s, s) @ (12, s, 64); dense decode of
    4 slots: (48, 1, 64) @ (48, 64, 128) and (48, 1, 128) @ (48, 128, 64)."""
    cases = {name: list(shapes) for name, shapes in UNIT_SHAPES.items()}
    for s in sorted(set(prompt_lens)):
        kern = dense_prefill_kernel(s)
        if kern:
            cases[kern] += [(HEADS, s, HEAD_DIM, s), (HEADS, s, s, HEAD_DIM)]
    return cases

# multiplicity of each (k, n) in one decode step of fairsquare-demo
K1_PER_STEP = {(768, 768): 48, (768, 3072): 24, (3072, 768): 12,
               (768, 32000): 1}
TRACE_TICKS = 4


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    print(f"  [{'ok' if cond else 'FAIL'}] {what}", flush=True)
    if not cond:
        raise SmokeFailure(what)


def time_graph(fns, reps: int = 20, replays: int = 5) -> float:
    """Mean device ms of one call: at least ``reps`` calls, cycling through
    every one of ``fns``, captured in one CUDA graph and replayed
    ``replays`` times between CUDA events."""
    reps = max(reps, len(fns))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(reps):
            fns[i % len(fns)]()
    g.replay()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (reps * replays)


def copies_for(nbytes: int) -> int:
    return max(2, min(64, math.ceil(L2_DEFEAT_BYTES / max(1, nbytes))))


# ------------------------------------------------------------------ K1
def k1_phase(dev, gen, cases):
    """K1 against its plain version at the main-path shapes, and bit for
    bit against K2 at nb = 1 and K3 on the same operands; each timed row
    also times K2 at nb = 1."""
    print("K1 sq_matmul vs plain (f32 from bf16 inputs: |err| <= "
          "k * 2^-23 * (max|a| + max|b|)^2; int8: exact; K1 = K2 at nb=1 "
          "= K3, bit for bit)", flush=True)
    rows = []
    for m, k, n, timed in cases:
        a = torch.randn(m, k, generator=gen).to(torch.bfloat16).to(dev)
        b = (torch.randn(k, n, generator=gen) / math.sqrt(k)).to(
            torch.bfloat16).to(dev)
        aw, bw = a.float(), b.float()
        sa, sb = -(aw * aw).sum(1), -(bw * bw).sum(0)
        out = sq_matmul_k1(aw, bw, sa, sb)
        ref = sq_matmul_plain(aw, bw, sa, sb)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = k * 2.0 ** -23 * (aw.abs().max().item()
                                + bw.abs().max().item()) ** 2
        check(bool(torch.isfinite(out).all()) and err <= tol,
              f"f32 m={m} k={k} n={n}: max|err| {err:.3e} <= {tol:.3e}")

        ai = torch.randint(-128, 128, (m, k), generator=gen,
                           dtype=torch.int32).to(dev)
        bi = torch.randint(-128, 128, (k, n), generator=gen,
                           dtype=torch.int32).to(dev)
        sai, sbi = -(ai * ai).sum(1, dtype=torch.int32), \
            -(bi * bi).sum(0, dtype=torch.int32)
        oi = sq_matmul_k1(ai, bi, sai, sbi)
        exact = torch.matmul(ai.double(), bi.double()).to(torch.int32)
        check(torch.equal(oi, sq_matmul_plain(ai, bi, sai, sbi))
              and torch.equal(oi, exact),
              f"int8 m={m} k={k} n={n}: bit-exact")
        same = all(
            torch.equal(o, kern(x[None], y[None], sx[None], sy[None])[0])
            for o, x, y, sx, sy in ((out, aw, bw, sa, sb),
                                    (oi, ai, bi, sai, sbi))
            for kern in (sq_matmul_k2, sq_matmul_k3))
        check(same, f"m={m} k={k} n={n}: K1 = K2 at nb=1 = K3, f32 and "
                    f"int32, bit for bit")
        if not timed:
            rows.append(dict(m=m, k=k, n=n, max_abs_err=err))
            continue

        nc = copies_for(k * n * 4)
        bws = [bw.clone() for _ in range(nc)]
        sbs = [sb.clone() for _ in range(nc)]
        ms = time_graph([lambda i=i: sq_matmul_k1(aw, bws[i], sa, sbs[i])
                         for i in range(nc)])
        k2_ms = time_graph([lambda i=i: sq_matmul_k2(
            aw[None], bws[i][None], sa[None], sbs[i][None])
            for i in range(nc)])
        plain_ms = time_graph(
            [lambda i=i: sq_matmul_plain(aw, bws[i], sa, sbs[i])
             for i in range(nc)], reps=4, replays=2)
        lib_ms = time_graph([lambda i=i: torch.matmul(aw, bws[i])
                             for i in range(nc)])
        nbytes = 4 * (m * k + k * n + m + n + m * n)
        ops = 2 * m * n * k
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, \
            ops / FP32_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        row = dict(m=m, k=k, n=n, ms=ms, k2_ms=k2_ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound, t_bytes=t_bytes,
                   t_ops=t_ops,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   max_abs_err=err)
        rows.append(row)
        shape = k1_launch_shape(m, n)
        print(f"    m={m:2d} k={k:4d} n={n:5d}  K1 {ms:.4f} ms | K2 at nb=1 "
              f"{k2_ms:.4f} ms ({k2_ms / ms:.1f}x) | plain "
              f"{plain_ms:.4f} ms | torch.matmul {lib_ms:.4f} ms | bound "
              f"{bound:.4f} ms ({row['bound_by']}) | "
              f"{bound / ms:.1%} of bound | grid {shape['grid']} in "
              f"clusters of {shape['cluster']}, {shape['rows']}x"
              f"{shape['cols']} tiles, {shape['warps']} warps a block",
              flush=True)
        del bws, sbs
    for m in (8, DENSE_BATCH):
        step = {key: sum(K1_PER_STEP[(r["k"], r["n"])] * r[key]
                         for r in rows if r["m"] == m and "ms" in r)
                for key in ("ms", "k2_ms", "library_ms")}
        print(f"  per decode step at m={m} (85 GEMMs, graph replay): K1 "
              f"{step['ms']:.4f} ms | K2 at nb=1 "
              f"{step['k2_ms']:.4f} ms ({step['k2_ms'] / step['ms']:.1f}x)"
              f" | torch.matmul {step['library_ms']:.4f} ms", flush=True)
    return rows


# -------------------------------------------------------------- K2, K3
BATCHED = {"K2": (sq_matmul_k2, k2_launch_shape),
           "K3": (sq_matmul_k3, k3_launch_shape)}


def batched_phase(dev, gen, name, cases):
    """K2 or K3 against the batched plain version at every shape of the
    serving phases (f32 from bf16 inputs and int8), bit for bit against K1
    per element (K2) or against K2 (K3), and timed beside the plain version
    and torch.bmm (K3 also beside K2), each row with its grid; then the
    per-unit sums: K2 per paged prefill chunk, K3 per dense decode step.
    The operands are activations the caller has just written, so they are
    not cycled past the L2."""
    kern, launch_shape = BATCHED[name]
    other = "K1 per element" if name == "K2" else "K2"
    print(f"{name} {kern.__name__} vs plain (f32 |err| <= k * 2^-23 * "
          f"(max|a| + max|b|)^2; int8 exact; {name} = {other} bit for bit)",
          flush=True)
    rows = []
    for nb, m, k, n in cases:
        a = torch.randn(nb, m, k, generator=gen).to(torch.bfloat16).to(dev)
        b = torch.randn(nb, k, n, generator=gen).to(torch.bfloat16).to(dev)
        aw, bw = a.float(), b.float()
        sa, sb = -(aw * aw).sum(2), -(bw * bw).sum(1)
        ai = torch.randint(-128, 128, (nb, m, k), generator=gen,
                           dtype=torch.int32).to(dev)
        bi = torch.randint(-128, 128, (nb, k, n), generator=gen,
                           dtype=torch.int32).to(dev)
        sai = -(ai * ai).sum(2, dtype=torch.int32)
        sbi = -(bi * bi).sum(1, dtype=torch.int32)
        out = kern(aw, bw, sa, sb)
        ref = sq_matmul_batched_plain(aw, bw, sa, sb)
        oi = kern(ai, bi, sai, sbi)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = k * 2.0 ** -23 * (aw.abs().max().item()
                                + bw.abs().max().item()) ** 2
        check(bool(torch.isfinite(out).all()) and err <= tol,
              f"f32 B={nb} m={m} k={k} n={n}: max|err| {err:.3e} <= "
              f"{tol:.3e}")
        exact = torch.matmul(ai.double(), bi.double()).to(torch.int32)
        check(torch.equal(oi, sq_matmul_batched_plain(ai, bi, sai, sbi))
              and torch.equal(oi, exact),
              f"int8 B={nb} m={m} k={k} n={n}: bit-exact")
        same = True
        for x, y, sx, sy, o in ((aw, bw, sa, sb, out), (ai, bi, sai, sbi, oi)):
            if name == "K2":
                same &= all(torch.equal(o[e], sq_matmul_k1(x[e], y[e], sx[e],
                                                           sy[e]))
                            for e in range(nb))
            else:
                same &= torch.equal(o, sq_matmul_k2(x, y, sx, sy))
        check(same, f"B={nb} m={m} k={k} n={n}: {name} = {other}, f32 and "
                    f"int32, bit for bit")

        ms = time_graph([lambda: kern(aw, bw, sa, sb)])
        plain_ms = time_graph([lambda: sq_matmul_batched_plain(aw, bw, sa,
                                                               sb)],
                              reps=4, replays=2)
        lib_ms = time_graph([lambda: torch.bmm(aw, bw)])
        # K3's schedule against K2's on the same operands (the route choice)
        k2_ms = time_graph([lambda: sq_matmul_k2(aw, bw, sa, sb)]) \
            if name == "K3" else None
        nbytes = 4 * nb * (m * k + k * n + m + n + m * n)
        ops = 2 * nb * m * n * k
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, \
            ops / FP32_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        shape = launch_shape(nb, m, n)
        row = dict(shape=(nb, m, k, n), ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound, t_bytes=t_bytes,
                   t_ops=t_ops, k2_ms=k2_ms, grid=shape["grid"],
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   max_abs_err=err)
        rows.append(row)
        vs_k2 = f" | K2 {k2_ms:.5f} ms" if k2_ms is not None else ""
        print(f"    B={nb:2d} m={m:2d} k={k:3d} n={n:3d}  {name} {ms:.5f} ms "
              f"| plain {plain_ms:.4f} ms | torch.bmm {lib_ms:.5f} ms"
              f"{vs_k2} | bound {bound:.5f} ms ({row['bound_by']}) | "
              f"{bound / ms:.1%} of bound | grid {shape['grid']} of "
              f"{shape['rows']}x{shape['cols']} tiles, {shape['warps']} "
              f"warps a block", flush=True)
    unit = [r for r in rows if r["shape"] in UNIT_SHAPES[name]]
    sums = {key: sum(LAYERS * r[key] for r in unit)
            for key in ("ms", "library_ms", "bound_ms")}
    vs_k2 = (f" | K2 on the same operands "
             f"{sum(LAYERS * r['k2_ms'] for r in unit):.4f} ms"
             if name == "K3" else "")
    print(f"  per {UNIT_NAMES[name]} ({LAYERS * len(unit)} launches, graph "
          f"replay): {name} {sums['ms']:.4f} ms | torch.bmm "
          f"{sums['library_ms']:.4f} ms ({sums['ms'] / sums['library_ms']:.2f}"
          f"x){vs_k2} | bound {sums['bound_ms']:.4f} ms "
          f"({sums['bound_ms'] / sums['ms']:.1%} of bound)", flush=True)
    return rows


# ------------------------------------------------------------------ K4
def k4_inputs(dev, gen, *, B=8, S=1, KV=12, G=1, hd=64, nb=BLOCKS_PER_SEQ,
              live=None, pad_row=None, pools=1):
    """Pools of the serving geometry; sequence i holds live[i] tokens in
    fresh blocks, the rest of its table is the null block.  The pool has
    room for every table to be full."""
    P = (1 + B * nb) * BLOCK
    live = live or [nb * BLOCK] * B
    tables = np.zeros((B, nb), np.int32)
    pos_pool = np.full(P, EMPTY_POS, np.int32)
    nxt = 1
    for i, n in enumerate(live):
        for c in range(-(-n // BLOCK)):
            tables[i, c] = nxt
            for j in range(BLOCK):
                if c * BLOCK + j < n:
                    pos_pool[nxt * BLOCK + j] = c * BLOCK + j
            nxt += 1
    q_pos = np.array([[n - 1] for n in live], np.int32)
    if pad_row is not None:
        q_pos[pad_row, :] = -1
    k_pools = [torch.randn(P, KV, hd, generator=gen).to(torch.bfloat16).to(dev)
               for _ in range(pools)]
    v_pools = [torch.randn(P, KV, hd, generator=gen).to(torch.bfloat16).to(dev)
               for _ in range(pools)]
    q = (torch.randn(B, S, KV, G, hd, generator=gen) * hd ** -0.5).to(dev)
    return (q, k_pools, v_pools, torch.as_tensor(tables).to(dev),
            torch.as_tensor(pos_pool).to(dev), torch.as_tensor(q_pos).to(dev))


def attn_f64(q, kp, vp, tables, pos_pool, q_pos, *, window=None,
             softcap=0.0):
    """K4's function in float64 with the multiplier: the reference for
    long tables, where the plain version's own f32 sums of (p + v)^2 over
    the whole window reach the tolerance."""
    idx = (tables.long()[:, :, None] * BLOCK
           + torch.arange(BLOCK, device=tables.device)).reshape(
               tables.shape[0], -1)
    k = kp[idx].double().permute(0, 2, 1, 3)[:, :, None]   # (B,KV,1,T,hd)
    v = vp[idx].double().permute(0, 2, 1, 3)[:, :, None]
    s = q.double().permute(0, 2, 3, 1, 4) @ k.transpose(-1, -2)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    kv_pos, qp = pos_pool[idx][:, None, :], q_pos[:, :, None]
    valid = (kv_pos <= qp) & (kv_pos < 2 ** 29)
    if window is not None:
        valid &= (qp - kv_pos) < window
    s = s.masked_fill(~valid[:, None, None], -1e30)
    return (torch.softmax(s, dim=-1) @ v).permute(0, 3, 1, 2, 4)


def k4_time(dev, gen, nb: int, pools: int):
    """K4 over full tables of ``nb`` blocks at the decode shape (B 8, KV 12,
    S 1, G 1, hd 64, bf16 pools), ``pools`` pool copies cycled past the L2
    (one per layer at the serving table), timed beside the plain version
    and SDPA on the gathered window."""
    B, KV, G, hd, S = 8, 12, 1, 64, 1
    q, kps, vps, tables, pos_pool, q_pos = k4_inputs(dev, gen, nb=nb,
                                                     pools=pools)
    n = len(kps)
    ms = time_graph([lambda i=i: sq_paged_attn_k4(
        q, kps[i], vps[i], tables, pos_pool, q_pos, block_size=BLOCK)
        for i in range(n)])
    plain_ms = time_graph([lambda i=i: sq_paged_attn_plain(
        q, kps[i], vps[i], tables, pos_pool, q_pos, block_size=BLOCK)
        for i in range(n)], reps=4, replays=2)
    idx = (tables.long()[:, :, None] * BLOCK
           + torch.arange(BLOCK, device=dev)).reshape(B, -1)
    T = idx.shape[1]
    kg = [kp[idx].permute(0, 2, 1, 3).contiguous() for kp in kps]
    vg = [vp[idx].permute(0, 2, 1, 3).contiguous() for vp in vps]
    qs = q.reshape(B, S, KV * G, hd).permute(0, 2, 1, 3).to(torch.bfloat16)
    mask = (pos_pool[idx][:, None, None, :] <= q_pos[:, None, :, None])
    lib_ms = time_graph([lambda i=i: torch.nn.functional.
                         scaled_dot_product_attention(
                             qs, kg[i], vg[i], attn_mask=mask, scale=1.0)
                         for i in range(n)])
    t_live = int((tables != 0).sum().item()) * BLOCK
    nbytes = (2 * t_live * KV * hd * 2 + t_live * 4 + 2 * B * S * KV * G * hd * 4
              + tables.numel() * 4 + q_pos.numel() * 4)
    ops = 2 * 2 * t_live * S * KV * G * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, \
        ops / FP32_OPS_PER_S * 1e3
    splits = k4_splits(B, KV, nb, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               T=T, splits=splits)
    print(f"    decode B={B} KV={KV} T={T}: K4 {ms:.4f} ms | plain "
          f"{plain_ms:.4f} ms | SDPA on the gathered window {lib_ms:.4f} ms "
          f"| bound {row['bound_ms']:.5f} ms ({row['bound_by']}) | "
          f"{row['bound_ms'] / ms:.1%} of bound | {splits} splits of "
          f"{nb // splits} table blocks: grid ({KV}, {B}, {splits}) = "
          f"{KV * B * splits} blocks of {32 * min(4, S * G)} threads in "
          f"clusters of (1, 1, {splits})", flush=True)
    return row


def k4_phase(dev, gen):
    print("K4 sq_paged_attn vs plain (B=8 S=1 KV=12 G=1 hd=64 bs=16 nb=8, "
          "bf16 pools; |err| <= 1e-4; at nb=64, T=1024, |err| <= 1e-4 "
          "against a float64 reference)", flush=True)
    live = [128, 128, 100, 64, 37, 16, 5, 1]      # partial tables, null blocks
    worst = 0.0
    for window, softcap, pad_row in ((None, 0.0, 6), (40, 0.0, None),
                                     (None, 30.0, None), (24, 50.0, 7)):
        q, kps, vps, tables, pos_pool, q_pos = k4_inputs(
            dev, gen, live=live, pad_row=pad_row)
        out = sq_paged_attn_k4(q, kps[0], vps[0], tables, pos_pool, q_pos,
                               block_size=BLOCK, window=window,
                               softcap=softcap)
        ref = sq_paged_attn_plain(q, kps[0], vps[0], tables, pos_pool, q_pos,
                                  block_size=BLOCK, window=window,
                                  softcap=softcap)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        worst = max(worst, err)
        check(bool(torch.isfinite(out).all()) and err <= 1e-4,
              f"window={window} softcap={softcap} padded_row={pad_row}: "
              f"max|err| {err:.3e}")

    # 1024-token tables (8 table blocks a split): partial tables, a padded
    # row, a window that masks whole splits, a softcap
    live_long = [1024, 1000, 700, 513, 129, 64, 16, 1]
    worst_long = 0.0
    for window, softcap, pad_row in ((None, 0.0, 6), (40, 0.0, None),
                                     (None, 30.0, 7)):
        q, kps, vps, tables, pos_pool, q_pos = k4_inputs(
            dev, gen, nb=64, live=live_long, pad_row=pad_row)
        kw = dict(window=window, softcap=softcap)
        out = sq_paged_attn_k4(q, kps[0], vps[0], tables, pos_pool, q_pos,
                               block_size=BLOCK, **kw)
        ref = sq_paged_attn_plain(q, kps[0], vps[0], tables, pos_pool, q_pos,
                                  block_size=BLOCK, **kw)
        exact = attn_f64(q, kps[0], vps[0], tables, pos_pool, q_pos, **kw)
        torch.cuda.synchronize()
        err = (out.double() - exact).abs().max().item()
        worst_long = max(worst_long, err)
        check(bool(torch.isfinite(out).all()) and err <= 1e-4,
              f"T=1024 window={window} softcap={softcap} padded_row="
              f"{pad_row}: max|K4 - float64| {err:.3e} (K4 vs plain "
              f"{(out - ref).abs().max().item():.3e}, plain vs float64 "
              f"{(ref.double() - exact).abs().max().item():.3e})")

    row = k4_time(dev, gen, BLOCKS_PER_SEQ, pools=12)
    print(f"    per paged decode step (12 launches): K4 {12 * row['ms']:.4f}"
          f" ms | SDPA on the gathered window {12 * row['library_ms']:.4f} ms"
          f" | bring-up schedule 0.536 ms as recorded in PERF.md's bring_up "
          f"table (NVIDIA H100 80GB HBM3, 700 W)", flush=True)
    row["long"] = k4_time(dev, gen, 64, pools=4)
    row["long"]["max_abs_err_vs_float64"] = worst_long
    row["max_abs_err"] = worst
    return row


# -------------------------------------------------------------- engine
def serve_cfg(policy=SQUARE_GEMMS_POLICY):
    cfg = get_config("fairsquare-demo")
    return dataclasses.replace(cfg, matmul_mode="square_pallas",
                               contraction_policy=policy)


def engine_cfg(max_new=MAX_NEW, jit=False, guard=False):
    """The launcher's engine geometry; eager unless ``jit`` (the launcher's
    own default captures on CUDA)."""
    return EngineConfig(max_slots=SLOTS, block_size=BLOCK, num_blocks=BLOCKS,
                        blocks_per_seq=BLOCKS_PER_SEQ, prefill_chunk=CHUNK,
                        max_new_tokens=max_new, prepared=True, jit=jit,
                        guard=guard)


def reset_counts():
    for kern in (sq_matmul_k1, sq_matmul_k2, sq_matmul_k3, sq_conv2d_k7,
                 sq_conv_k8, cpm3_matmul_k5, cpm4_matmul_k6):
        kern.launches = 0
        kern.shapes.clear()
    sq_paged_attn_k4.launches = 0
    routing.select_matmul_route.taken.clear()
    routing.select_paged_attn_route.taken.clear()
    routing.select_conv2d_route.taken.clear()


def counts():
    return (sq_matmul_k1.launches, sq_matmul_k2.launches,
            sq_matmul_k3.launches, sq_paged_attn_k4.launches)


def run_ticks(eng) -> list:
    """Step ``eng`` to its end.  Per tick: (K1 launches, K4 launches,
    decode steps, prefill chunks, first tokens, host wall in s, model
    calls captured)."""
    ticks, pending = [], True
    while pending:
        m = eng.metrics
        before = (sq_matmul_k1.launches, sq_paged_attn_k4.launches,
                  m.decode_steps, m.prefill_chunks, m.first_tokens)
        graphs0 = set(eng._graph_set.calls)
        t_tick = time.perf_counter()
        pending = eng.step()            # ends on the sampled tokens' copy
        t_tick = time.perf_counter() - t_tick
        ticks.append(tuple(a - b for a, b in zip(
            (sq_matmul_k1.launches, sq_paged_attn_k4.launches,
             m.decode_steps, m.prefill_chunks, m.first_tokens), before))
            + (t_tick, frozenset(set(eng._graph_set.calls) - graphs0)))
    return ticks


def warmup_launches(captured, L: int):
    """(K1, K4) launches of the warm-up calls of the model calls captured
    (each capture runs its call once eagerly first)."""
    per_call = {"_chunk": (L * GEMMS_PER_LAYER, 0),
                "_decode": (L * GEMMS_PER_LAYER + 1, L),
                "_logits_at": (1, 0)}
    return tuple(sum(per_call[c][i] for c in captured) for i in (0, 1))


def tick_walls(ticks, L: int) -> list:
    """Check every tick's K1/K4 launches against its steps (and, for a
    compiled engine, the warm-ups of its captures); returns the sorted
    walls (s) of the decode-only ticks without a capture."""
    per_step = (L * GEMMS_PER_LAYER + 1, L)
    bad = [t for t in ticks
           if t[0] != per_step[0] * t[2] + L * GEMMS_PER_LAYER * t[3] + t[4]
           + warmup_launches(t[6], L)[0]
           or t[1] != per_step[1] * t[2] + warmup_launches(t[6], L)[1]]
    decode_only = [t for t in ticks if t[2] and not t[3] and not t[6]]
    check(not bad and decode_only,
          f"every tick: K1 +{per_step[0]} and K4 +{per_step[1]} per decode "
          f"step (K1 +{L * GEMMS_PER_LAYER} per prefill chunk, +1 per first "
          f"token; one call more for each capture's warm-up); "
          f"{len(decode_only)} decode-only ticks")
    return sorted(t[5] for t in decode_only)


def engine_phase(dev, compared):
    cfg = serve_cfg()
    print(f"engine: {cfg.name} full width (L={cfg.n_layers} d={cfg.d_model} "
          f"H={cfg.n_heads} ff={cfg.d_ff} V={cfg.vocab} {cfg.dtype}), "
          f"square_pallas + square_gemms, prepared", flush=True)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    print(f"  model built in {time.perf_counter() - t0:.1f} s", flush=True)
    L = cfg.n_layers

    # warm-up engine: first-touch costs stay out of the measured run
    Engine(model, engine_cfg(max_new=2), device=dev).run(
        make_requests(cfg, 1, seed=1))
    torch.cuda.synchronize()

    eng = Engine(model, engine_cfg(), device=dev)
    eng.submit(make_requests(cfg, N_REQUESTS, seed=0))
    reset_counts()                      # counts of the main path's run only
    t0 = time.perf_counter()
    ticks = run_ticks(eng)
    torch.cuda.synchronize()
    eng.metrics.wall_s = time.perf_counter() - t0
    k1_total, k4_total = sq_matmul_k1.launches, sq_paged_attn_k4.launches
    shapes = dict(sq_matmul_k1.shapes)
    taken = dict(routing.select_matmul_route.taken)
    attn_taken = dict(routing.select_paged_attn_route.taken)
    m = eng.metrics
    res = eng.results

    check(len(res) == N_REQUESTS and all(
        r.status is RequestStatus.COMPLETED and len(r.tokens) == MAX_NEW
        for r in res.values()),
        f"{N_REQUESTS} requests COMPLETED with {MAX_NEW} tokens each")
    walls = tick_walls(ticks, L)
    check(set(shapes) <= set(compared["K1"]),
          f"K1 ran only at shapes held to its plain version above: "
          f"{sorted(shapes.items())}")
    check(sq_matmul_k2.launches == sq_matmul_k3.launches == 0,
          "K2 and K3 not launched: the policy keeps attention's einsums on "
          "the multiplier")
    check(taken.get("virtual", 0) == 0,
          f"no matmul took the virtual route (routes taken: {taken}; paged "
          f"attention: {attn_taken})")
    check(k1_total == (L * GEMMS_PER_LAYER + 1) * m.decode_steps
          + L * GEMMS_PER_LAYER * m.prefill_chunks + m.first_tokens
          and k4_total == L * m.decode_steps,
          f"main path: K1 {k1_total} launches, K4 {k4_total} launches over "
          f"{m.decode_steps} decode steps, {m.prefill_chunks} prefill chunks")
    print(f"  decode-only ticks: median wall {walls[len(walls) // 2] * 1e3:.2f}"
          f" ms (min {walls[0] * 1e3:.2f}, max {walls[-1] * 1e3:.2f}) for "
          f"one ragged decode step of {SLOTS} slots", flush=True)
    print(f"  served {len(res)} requests, {m.tokens_out} tokens in "
          f"{m.wall_s:.3f} s: {m.tokens_per_s:.1f} tokens/s, mean TTFT "
          f"{m.mean_ttft_s * 1e3:.1f} ms, batch occupancy "
          f"{m.batch_occupancy:.2f}, mean block utilization "
          f"{m.mean_utilization:.3f}", flush=True)
    logits_phase(model, eng.params, dev)
    trace_phase(model, dev, walls[len(walls) // 2])
    return {"K1": k1_total, "K4": k4_total, "model": model,
            "tokens": {rid: r.tokens for rid, r in res.items()},
            "tick_s": walls[len(walls) // 2], "tokens_per_s": m.tokens_per_s}


def _prefill_decode_logits(model: LM, params, prompts, dev) -> torch.Tensor:
    """One prefill chunk and one decode step over fresh paged caches; the
    decode step's logits (B, V)."""
    B = len(prompts)
    cache = model.init_paged_cache(BLOCKS * BLOCK)
    pos_pool = torch.full((BLOCKS * BLOCK,), EMPTY_POS, dtype=torch.int32,
                          device=dev)
    # sequence i owns blocks 1 + 2i and 2 + 2i (its prompt plus one decoded
    # token fit in 2 blocks); the other 6 columns are the null block, so the
    # table still spans T = 128 >= 64 and decode attention routes to K4
    tables = torch.zeros(B, BLOCKS_PER_SEQ, dtype=torch.int32)
    for i in range(B):
        tables[i, :2] = torch.tensor([1 + 2 * i, 2 + 2 * i])
    toks = np.zeros((B, CHUNK), np.int32)
    poss = np.full((B, CHUNK), -1, np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
        poss[i, :len(p)] = np.arange(len(p))
    tables = tables.to(dev)
    with torch.no_grad():
        hidden = model.decode_paged(params, cache, torch.as_tensor(toks).to(dev),
                                    torch.as_tensor(poss).to(dev), tables,
                                    pos_pool, block_size=BLOCK)
        last = torch.as_tensor([len(p) - 1 for p in prompts], device=dev)
        first = model.logits(params, hidden[torch.arange(B, device=dev),
                                            last][:, None])[:, 0]
        nxt = torch.argmax(first, dim=-1).to(torch.int32)[:, None]
        pos = torch.as_tensor([[len(p)] for p in prompts], dtype=torch.int32,
                              device=dev)
        hidden = model.decode_paged(params, cache, nxt, pos, tables, pos_pool,
                                    block_size=BLOCK)
        return model.logits(params, hidden)[:, -1]


def logits_phase(model: LM, params, dev) -> None:
    """One decode step's logits against the same model in standard mode."""
    cfg_std = dataclasses.replace(model.cfg, matmul_mode="standard",
                                  contraction_policy=None)
    std = LM(cfg_std, device=dev, seed=1)
    std.load_state_dict(model.state_dict())
    prompts = [r.tokens[:16] for r in make_requests(model.cfg, SLOTS, seed=0)]
    sq_logits = _prefill_decode_logits(model, params, prompts, dev)
    std_logits = _prefill_decode_logits(std, std.tree(), prompts, dev)
    scale = std_logits.abs().max().item()
    err = (sq_logits - std_logits).abs().max().item()
    agree = (sq_logits.argmax(-1) == std_logits.argmax(-1)).float().mean()
    check(bool(torch.isfinite(sq_logits).all()) and err <= 2e-2 * scale,
          f"decode-step logits vs standard mode: max|diff| {err:.4e} <= "
          f"2e-2 * max|logits| ({2e-2 * scale:.4e})")
    check(agree.item() == 1.0,
          f"decode-step greedy tokens vs standard mode: argmax agreement "
          f"{agree.item():.3f} over {len(prompts)} rows")


def _union_us(spans) -> float:
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


# device kernels by name in a trace
TRACE_KERNELS = (("K1", "sq_matmul_cluster_kernel"),
                 ("K2", "sq_matmul_batched_kernel"),
                 ("K3", "sq_matmul_folded_kernel"),
                 ("K4", "sq_paged_attn_kernel"), ("K5", "Cpm3"),
                 ("K6", "Cpm4"))


def trace_steps(step, what: str, untraced_s: float) -> dict:
    """torch.profiler trace of ``TRACE_TICKS`` calls of ``step``: the
    device-busy share of their wall, and each kernel's and the other
    device work's time per call.  Profiling slows the host, so the busy
    share it reads is a lower bound for the untraced run.  Returns the
    per-call device operations, busy ms, busy share and launches of each
    kernel (an empty dict when the trace recorded no device events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_TICKS):
            with record_function("traced_step"):
                step()
        torch.cuda.synchronize()
    evs = prof.events()
    # record_function also leaves a device-side annotation of the same name
    ticks = [e.time_range for e in evs
             if e.name == "traced_step" and e.device_type == DeviceType.CPU]
    device = [e for e in evs if e.device_type == DeviceType.CUDA
              and e.name != "traced_step"]
    wall_us = sum(t.end - t.start for t in ticks)
    n = len(ticks)
    print(f"  trace of {n} {what} (torch.profiler): "
          f"{wall_us / n / 1e3:.2f} ms wall each traced, "
          f"{untraced_s * 1e3:.2f} ms untraced", flush=True)
    if not device:
        print("  trace: no device events recorded; device-busy share not "
              "measured", flush=True)
        return {}

    def kernel(name):
        for label, sym in TRACE_KERNELS:
            if sym in name:
                return label
        return None

    busy_us = _union_us((e.time_range.start, e.time_range.end)
                        for e in device)
    parts = []
    stats = {"ops": len(device) / n, "busy_ms": busy_us / n / 1e3,
             "busy_share": busy_us / wall_us, "wall_ms": wall_us / n / 1e3}
    for label in [lb for lb, _ in TRACE_KERNELS] + [None]:
        mine = [e for e in device if kernel(e.name) == label]
        ms = sum(e.time_range.end - e.time_range.start
                 for e in mine) / 1e3 / n
        if label is None:
            parts.append(f"other device work {ms:.3f} ms")
        else:
            stats[label] = len(mine) / n
            if mine:
                parts.append(f"{label} {len(mine) / n:.0f} launches "
                             f"{ms:.3f} ms")
    print(f"  trace per step: {len(device) / n:.0f} device operations, "
          f"device busy {busy_us / n / 1e3:.3f} ms = "
          f"{busy_us / wall_us:.1%} of the traced wall; "
          f"{', '.join(parts)}", flush=True)
    other = collections.Counter()
    for e in device:
        if kernel(e.name) is None:
            other[e.name[:48]] += e.time_range.end - e.time_range.start
    print("  largest other device work per step: " + "; ".join(
        f"{name} {us / n / 1e3:.3f} ms" for name, us in other.most_common(3)),
        flush=True)
    # the host side: the operators and CUDA runtime calls that hold the
    # host longest (self time, so a wait lands on the call that waits)
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU
                   and e.key != "traced_step"),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    print("  host per step, by self time: " + "; ".join(
        f"{e.key} x{e.count / n:.0f} {e.self_cpu_time_total / n / 1e3:.3f} ms"
        for e in host[:8]), flush=True)
    return stats


def trace_phase(model: LM, dev, untraced_tick_s: float,
                guard: bool = False, jit: bool = False) -> dict:
    """A trace of a few decode-only ticks of a fresh engine (same
    requests), with or without the numerics guard, eager or compiled
    (then every model call is captured before the traced ticks)."""
    eng = Engine(model, engine_cfg(jit=jit, guard=guard), device=dev)
    eng.submit(make_requests(model.cfg, N_REQUESTS, seed=0))
    while eng.metrics.first_tokens < N_REQUESTS:
        if not eng.step():
            raise SmokeFailure("trace engine ended before every request "
                               "had its first token")
    return trace_steps(eng.step, f"{'replayed ' * jit}decode-only ticks"
                                 f"{' (guard on)' * guard}", untraced_tick_s)


# ------------------------------------------------------------- launcher
def expected_audit(cfg, decode_steps: int, prefill_chunks: int,
                   first_tokens: int) -> dict:
    """{site: mults} of a paged-engine run, from the config and the step
    counts: each decode step runs (SLOTS, 1) rows and each prefill chunk
    (1, CHUNK), padding included; the softmax path spans T = BLOCKS_PER_SEQ
    * BLOCK positions; logits run every decode row and one row a first
    token."""
    L, d, ff = cfg.n_layers, cfg.d_model, cfg.d_ff
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    rows = SLOTS * decode_steps + CHUNK * prefill_chunks
    attn = L * H * hd * BLOCKS_PER_SEQ * BLOCK * rows
    return {"attn_qkv": L * d * (H + 2 * KV) * hd * rows,
            "attn_out": L * H * hd * d * rows,
            "ffn": L * 3 * d * ff * rows,
            "attn_scores": attn, "attn_pv": attn,
            "logits": d * cfg.padded_vocab * (SLOTS * decode_steps
                                              + first_tokens)}


def audit_ok(audit, cfg, decode_steps, prefill_chunks, first_tokens,
             square_gemms: bool) -> None:
    """The run's contraction audit against the analytic count.  With no
    policy every contraction is square; under square_gemms the prefill
    chunks' softmax path runs the gather route on the multiplier while K4
    serves the decode steps' in square form."""
    want = expected_audit(cfg, decode_steps, prefill_chunks, first_tokens)
    got = {site: d["mults"] for site, d in audit.by_site().items()}
    check(got == want, f"audit: per-site mults equal the analytic count "
                       f"{want}")
    total = sum(want.values())
    standard = (2 * cfg.n_layers * cfg.n_heads * cfg.resolved_head_dim
                * BLOCKS_PER_SEQ * BLOCK * CHUNK * prefill_chunks
                if square_gemms else 0)
    share = (total - standard) / total
    check(audit.fraction_square == share and audit.fraction_demoted == 0.0,
          f"audit: fraction_square {audit.fraction_square:.6f} == analytic "
          f"{share:.6f} ({'square_gemms' if square_gemms else 'no policy'};"
          f" {audit.multiplies_replaced} of {audit.total_mults} multiplies "
          f"replaced by squares)")


def _decode_tick_walls(trace: dict) -> list:
    """Durations (s) of the traced ticks that ran a decode step and no
    prefill chunk, checking on the way that every engine.* span lies
    inside one engine.tick span."""
    spans = [e for e in trace["traceEvents"]
             if e.get("ph") == "X" and e["name"].startswith("engine.")]
    ticks = [e for e in spans if e["name"] == "engine.tick"]
    inner = [e for e in spans if e["name"] != "engine.tick"]
    owner, stray = {}, []
    for e in inner:
        host = [t for t in ticks if t["ts"] <= e["ts"]
                and e["ts"] + e["dur"] <= t["ts"] + t["dur"]]
        if len(host) != 1:
            stray.append((e["name"], e["ts"]))
            continue
        owner.setdefault(id(host[0]), set()).add(e["name"])
    check(ticks and not stray,
          f"trace: each of {len(inner)} engine.* spans lies inside exactly "
          f"one of {len(ticks)} engine.tick spans (outside: {stray[:4]})")
    return sorted(t["dur"] / 1e6 for t in ticks
                  if owner.get(id(t), set()) >= {"engine.decode_step"}
                  and "engine.prefill_chunk" not in owner.get(id(t), set()))


def launcher_phase(dev, compared, plain):
    """``python -m repro_torch.launch.serve`` at full width with every
    resilience and observability flag on -- its engine compiled, as the
    launcher's default is on CUDA -- inside the compiled contraction
    audit: the engine_phase's tokens, a clean snapshot and trace, K1/K4
    launches per step unchanged (plus one call for each capture's
    warm-up), no re-capture, and the audit of the replays equal to the
    analytic count.  Then one
    engine with the guard alone (no trace) on engine_phase's model, timed
    by engine_phase's tick loop beside engine_phase's run, and a trace of
    its decode-only ticks: where the guard's finite checks spend the
    time."""
    import tempfile
    cfg = serve_cfg()
    L = cfg.n_layers
    print("launcher: python -m repro_torch.launch.serve, fairsquare-demo "
          "full width, square_pallas + square_gemms, prepared, --guard, "
          "--deadline-ms, --queue-limit, --metrics-file, --trace-out; "
          "compiled (CUDA graphs, the default), compiled audit",
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        mfile, tfile = f"{tmp}/metrics.json", f"{tmp}/trace.json"
        argv = ["--matmul-mode", "square_pallas", "--policy", "square_gemms",
                "--prepared", "--guard", "--deadline-ms", "600000",
                "--queue-limit", "64", "--shed-policy", "reject-new",
                "--requests", str(N_REQUESTS), "--max-new", str(MAX_NEW),
                "--slots", str(SLOTS), "--block-size", str(BLOCK),
                "--blocks", str(BLOCKS), "--blocks-per-seq",
                str(BLOCKS_PER_SEQ), "--prefill-chunk", str(CHUNK),
                "--seed", "0", "--device", str(dev), "--metrics-file", mfile,
                "--trace-out", tfile]
        reset_counts()                  # counts of this path's run only
        # the compiled audit must cover the captures, which happen inside
        # the run; the counter tallies every replay
        with counting.compiled_audit(), \
                counting.track_compiled_contractions() as audit:
            res = serve_launcher.main(argv)
        torch.cuda.synchronize()
        k1_total, k4_total = sq_matmul_k1.launches, sq_paged_attn_k4.launches
        check(obs_check.main([mfile, tfile]) == 0,
              "metrics snapshot and trace pass "
              "python -m repro_torch.obs.check")
        with open(mfile) as f:
            snap = json.load(f)
        with open(tfile) as f:
            trace = json.load(f)
    check(len(res) == N_REQUESTS and all(
        r.status is RequestStatus.COMPLETED and len(r.tokens) == MAX_NEW
        for r in res.values()),
        f"{N_REQUESTS} requests COMPLETED with {MAX_NEW} tokens each")
    check({rid: r.tokens for rid, r in res.items()} == plain["tokens"],
          "launcher tokens equal engine_phase's")
    c, eng = snap["counters"], snap["engine"]
    parts = {k: c[f"engine_requests_{k}_total"]
             for k in obs_check.TERMINAL_KEYS}
    check(sum(parts.values()) == c["engine_requests_submitted_total"]
          == N_REQUESTS, f"terminal counters partition the {N_REQUESTS} "
                         f"submissions: {parts}")
    check(snap["route_health"] == [], "route health: no site tripped")
    check(eng["guard_trips"] == eng["step_failures"] == eng["watchdog_trips"]
          == eng["preemptions"] == eng["guard_rejits"] == 0
          and c["engine_guard_recomputes_total"] == 0
          and c["engine_guard_rejits_total"] == 0,
          "0 guard trips, 0 guard recomputes, 0 re-captures, 0 step "
          "failures, 0 watchdog trips, 0 preemptions")
    check(trace["otherData"]["dropped_records"] == 0,
          f"trace: {len(trace['traceEvents'])} events, 0 dropped")
    walls = _decode_tick_walls(trace)
    steps, chunks = eng["decode_steps"], eng["prefill_chunks"]
    firsts = eng["completed"]           # one first token each, no preemption
    # no re-capture: each of the three calls captured once, its warm-up
    # one eager call more
    warm = warmup_launches(("_chunk", "_decode", "_logits_at"), L)
    check(k1_total == (L * GEMMS_PER_LAYER + 1) * steps
          + L * GEMMS_PER_LAYER * chunks + firsts + warm[0]
          and k4_total == L * steps + warm[1] and walls,
          f"K1 {k1_total} and K4 {k4_total} launches: +"
          f"{L * GEMMS_PER_LAYER + 1} and +{L} per decode step, as in "
          f"engine_phase, and {warm} for the three captures' warm-ups "
          f"({steps} decode steps, {chunks} prefill chunks, "
          f"{len(walls)} decode-only ticks)")
    check(sq_matmul_k2.launches == sq_matmul_k3.launches == 0,
          "K2 and K3 not launched")
    shapes_ok(compared)
    audit_ok(audit, cfg, steps, chunks, firsts, square_gemms=True)
    tick = walls[len(walls) // 2]
    print(f"  launcher (compiled, guard + trace on): "
          f"{eng['tokens_per_s']:.1f} "
          f"tokens/s, median decode-only tick wall {tick * 1e3:.2f} ms; "
          f"engine_phase (guard and trace off): "
          f"{plain['tokens_per_s']:.1f} tokens/s, "
          f"{plain['tick_s'] * 1e3:.2f} ms", flush=True)

    # the eager guard alone, without the trace: one finite check (a
    # device-to-host read) a guarded contraction
    geng = Engine(plain["model"], engine_cfg(guard=True), device=dev)
    geng.submit(make_requests(cfg, N_REQUESTS, seed=0))
    gwalls = tick_walls(run_ticks(geng), L)
    check({rid: r.tokens for rid, r in geng.results.items()}
          == plain["tokens"] and geng.metrics.guard_recomputes
          == geng.metrics.guard_trips == 0,
          "guarded engine: engine_phase's tokens, 0 guard trips and "
          "recomputes")
    n_checks = L * GEMMS_PER_LAYER + 1 + L
    gtick = gwalls[len(gwalls) // 2]
    print(f"  guard alone: median decode-only tick wall "
          f"{gtick * 1e3:.2f} ms beside engine_phase's "
          f"{plain['tick_s'] * 1e3:.2f} ms; {n_checks} finite checks a "
          f"decode step (K1's GEMMs and K4's layers), "
          f"{(gtick - plain['tick_s']) / n_checks * 1e6:.0f} us each",
          flush=True)
    trace_phase(plain["model"], dev, gtick, guard=True)
    return {"K1": k1_total, "K4": k4_total}


FAULT_LAYERS = 2


def fault_phase(dev, jit: bool = False) -> None:
    """The engine under a fault schedule at full width and 2 layers:
    allocator, prefill and decode failures, a poisoned logits row, a clock
    skew past one request's deadline, a bounded queue shedding the oldest,
    one cancel.  Every request ends terminal, no block leaks, the
    registry's terminals partition the submissions, every poisoned row
    FAILS and counts as a guard trip, and every request that completes has
    a clean run's tokens."""
    cfg = dataclasses.replace(serve_cfg(), n_layers=FAULT_LAYERS)
    print(f"faults: {cfg.name} full width at {FAULT_LAYERS} layers, "
          f"square_pallas + square_gemms, prepared, guard, "
          f"{'compiled' if jit else 'eager'}", flush=True)
    model = build_model(cfg, device=dev, seed=0)
    n = 12
    reqs = make_requests(cfg, n, seed=5)
    clean = Engine(model, engine_cfg(jit=jit), device=dev).run(
        [Request(r.rid, r.tokens) for r in reqs])
    check(all(r.ok for r in clean.values()), f"clean run: {n} COMPLETED")
    plan = FaultPlan.of(alloc_fail=(1, 4, 9), prefill_fail=(2,),
                        decode_fail=(0, 5), nan_logits={3: 1},
                        clock_skew={12: 3600.0})
    inj = FaultInjector(plan)
    eng = Engine(model, dataclasses.replace(
        engine_cfg(jit=jit, guard=True), queue_limit=6,
        shed_policy="evict-oldest"), device=dev, faults=inj)
    batch = [Request(r.rid, r.tokens) for r in reqs]
    batch[-1].deadline_s = 60.0          # the newest: still pending at tick 12
    eng.submit(batch)
    check(eng.cancel(batch[-2].rid), "cancel a queued request")
    while eng.step():
        pass
    torch.cuda.synchronize()
    res, m = eng.results, eng.metrics
    by = collections.Counter(str(r.status) for r in res.values())
    print(f"  terminals {dict(by)}; injected {inj.injected}; step failures "
          f"{m.step_failures}, guard trips {m.guard_trips}, preemptions "
          f"{m.preemptions}", flush=True)
    check(len(res) == n and not eng.queue
          and all(s is None for s in eng.slots),
          f"every one of the {n} requests is terminal")
    check(eng.allocator.used_blocks == 0, "0 used blocks at the end")
    c = eng.registry.snapshot()["counters"]
    check(sum(c[f"engine_requests_{k}_total"]
              for k in obs_check.TERMINAL_KEYS)
          == c["engine_requests_submitted_total"] == n,
          "the registry's terminal counters sum to the submissions")
    poisoned = [r for r in res.values() if "numerics guard" in (r.error or "")]
    check(inj.injected["nan"] == 1 and len(poisoned) == m.guard_trips == 1
          and all(r.status is RequestStatus.FAILED for r in poisoned),
          "the poisoned row's request FAILED and counts as a guard trip")
    check(by["rejected"] == m.shed == n - 6 and by["cancelled"] == 1
          and by["timed_out"] == 1,
          f"{n - 6} shed (evict-oldest, queue limit 6), 1 cancelled, 1 timed "
          f"out")
    check(inj.injected["alloc"] + inj.injected["prefill"]
          + inj.injected["decode"] == 6 and m.step_failures == 3,
          "3 allocator refusals and 3 step failures absorbed")
    done = {rid: r.tokens for rid, r in res.items() if r.ok}
    check(done and all(toks == clean[rid].tokens
                       for rid, toks in done.items()),
          f"{len(done)} completed requests token-identical to the clean run")


def guard_phase(dev) -> None:
    """fs_einsum on K1's route with f32 operands past the square form's
    range (|a+b| > 1.84e19; products that cancel), under guarded(trip
    limit 2): each trip returns the standard result, the second demotes
    the key, and a demoted key launches K1 no more."""
    print("guard: fs_einsum on the K1 route, f32 operands of 1e19 whose "
          "products cancel, trip limit 2", flush=True)
    x = torch.full((32, 64), 1e19, device=dev)
    x[:, 1::2] *= -1.0
    y = torch.full((64, 32), 1e19, device=dev)
    want = torch.einsum("mk,kn->mn", x, y)
    check(bool(torch.isfinite(want).all()), "the multiplier result is finite")
    key = routing.health_key("guard_phase", (1, 32, 64, 32), torch.float32)
    health = routing.route_health()
    epoch0 = routing.route_epoch()
    reset_counts()
    launches = []
    with guards.guarded(trip_limit=2), \
            counting.track_contractions() as audit:
        for _ in range(4):
            out = fs_einsum("mk,kn->mn", x, y, mode="square_pallas",
                            site="guard_phase")
            torch.cuda.synchronize()
            launches.append(sq_matmul_k1.launches)
            check(torch.equal(out, want), "the call returns the standard "
                                          "result")
    check(launches == [1, 2, 2, 2] and health.trips.get(key) == 2
          and health.is_demoted(key) and routing.route_epoch() == epoch0 + 1,
          f"two trips launch K1 and demote {key} (route epoch "
          f"{epoch0} -> {routing.route_epoch()}); K1 launches per call "
          f"{launches}")
    check([r.demoted for r in audit.records] == [True] * 4
          and audit.fraction_demoted == 1.0,
          "every call noted demoted=True, served standard")
    routing.reset_route_health()
    check(not health.is_demoted(key), "reset_route_health re-arms the key")


# ------------------------------------------------------- compiled step
CARD = ""                       # nvidia-smi's name and power limit


def _timed_run(eng, reqs, off: int, per_tick: bool = True) -> dict:
    """Serve ``reqs`` on ``eng`` with their rids shifted by ``off`` (so one
    engine serves them again): the tokens by the original rid, the wall,
    tokens/s, mean TTFT, the decode-only tick walls (checked per tick by
    :func:`tick_walls`, unless ``per_tick`` is off: a retried call
    launches its kernels twice) and whether all COMPLETED with MAX_NEW
    tokens."""
    eng.submit([Request(r.rid + off, r.tokens) for r in reqs])
    t0 = time.perf_counter()
    ticks = run_ticks(eng)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rids = [r.rid + off for r in reqs]
    toks = {rid - off: eng.results[rid].tokens for rid in rids}
    ttft = [eng.metrics.ttft_s[rid] for rid in rids]
    return {"tokens": toks, "wall": wall,
            "tokens_per_s": sum(len(t) for t in toks.values()) / wall,
            "ttft_ms": 1e3 * sum(ttft) / len(ttft),
            "walls": (tick_walls(ticks, eng.model.cfg.n_layers) if per_tick
                      else None),
            "ok": all(eng.results[rid].ok
                      and len(eng.results[rid].tokens) == MAX_NEW
                      for rid in rids)}


def _walls_str(walls) -> str:
    return (f"median {walls[len(walls) // 2] * 1e3:.2f} ms (min "
            f"{walls[0] * 1e3:.2f}, max {walls[-1] * 1e3:.2f}, "
            f"{len(walls)} ticks)")


def graph_engine_phase(dev, compared, plain):
    """The paged engine with its three model calls captured into CUDA
    graphs (``EngineConfig(jit=True)``), on engine_phase's model and
    requests: engine_phase's tokens, 3 captures and no re-capture, K1 +85
    and K4 +12 a decode tick by the ledger (each capture's warm-up one
    call more), exactly 85 K1 and 12 K4 kernels in a profiled replayed
    tick; then eager and compiled engines timed in turns (eager, graph,
    graph, eager), each traced once, and a guarded compiled engine."""
    model = plain["model"]
    cfg = model.cfg
    L = cfg.n_layers
    print(f"graph engine: {cfg.name} full width, square_pallas + "
          f"square_gemms, prepared, _chunk/_decode/_logits_at captured into "
          f"CUDA graphs (EngineConfig(jit=True)); card {CARD}", flush=True)
    reqs = make_requests(cfg, N_REQUESTS, seed=0)
    geng = Engine(model, engine_cfg(jit=True), device=dev)
    reset_counts()                      # counts of this path's run only
    first = _timed_run(geng, reqs, 0)
    k1, k4 = sq_matmul_k1.launches, sq_paged_attn_k4.launches
    m = geng.metrics
    check(first["ok"] and first["tokens"] == plain["tokens"],
          f"{N_REQUESTS} requests COMPLETED; tokens equal engine_phase's "
          f"(eager)")
    check(geng.captures == 3 and sorted(geng._graph_set.calls) == [
        "_chunk", "_decode", "_logits_at"] and m.guard_rejits == 0,
        f"3 captures ({sorted(geng._graph_set.calls)}), 0 re-captures")
    check(sq_matmul_k2.launches == sq_matmul_k3.launches == 0,
          "K2 and K3 not launched")
    shapes_ok(compared)
    warm = warmup_launches(("_chunk", "_decode", "_logits_at"), L)
    check(k1 == (L * GEMMS_PER_LAYER + 1) * m.decode_steps
          + L * GEMMS_PER_LAYER * m.prefill_chunks + m.first_tokens + warm[0]
          and k4 == L * m.decode_steps + warm[1],
          f"by the ledger: K1 {k1}, K4 {k4} over {m.decode_steps} decode "
          f"steps, {m.prefill_chunks} prefill chunks and the warm-ups {warm}")

    runs = {"eager": [], "graph": []}
    for i, kind in enumerate(("eager", "graph", "graph", "eager")):
        eng = geng if kind == "graph" else Engine(model, engine_cfg(),
                                                  device=dev)
        r = _timed_run(eng, reqs, 100 * (i + 1))
        check(r["ok"] and r["tokens"] == plain["tokens"],
              f"turn {i + 1} ({kind}): engine_phase's tokens")
        runs[kind].append(r)
        print(f"  turn {i + 1} {kind}: {r['tokens_per_s']:.1f} tokens/s, "
              f"mean TTFT {r['ttft_ms']:.2f} ms, decode-only tick "
              f"{_walls_str(r['walls'])}; card {CARD}", flush=True)
    check(geng.captures == 3, "the reused compiled engine captured no more")
    med = {k: sorted(w for r in v for w in r["walls"])[
        len(v[0]["walls"] + v[1]["walls"]) // 2] for k, v in runs.items()}
    stats = {k: trace_phase(model, dev, med[k], jit=(k == "graph"))
             for k in ("eager", "graph")}
    check(stats["graph"].get("K1") == L * GEMMS_PER_LAYER + 1
          and stats["graph"].get("K4") == L,
          f"a profiled replayed tick holds {stats['graph'].get('K1')} K1 and "
          f"{stats['graph'].get('K4')} K4 kernels (want "
          f"{L * GEMMS_PER_LAYER + 1} and {L})")
    for k in ("eager", "graph"):
        rs = runs[k]
        print(f"  {k} (2 turns): {rs[0]['tokens_per_s']:.1f} and "
              f"{rs[1]['tokens_per_s']:.1f} tokens/s, mean TTFT "
              f"{rs[0]['ttft_ms']:.2f} and {rs[1]['ttft_ms']:.2f} ms, median "
              f"decode-only tick {med[k] * 1e3:.2f} ms; traced tick: "
              f"{stats[k]['ops']:.0f} device operations, device busy "
              f"{stats[k]['busy_ms']:.3f} ms = {stats[k]['busy_share']:.1%} "
              f"of the traced wall; untraced tick wall - device busy = "
              f"{med[k] * 1e3 - stats[k]['busy_ms']:.2f} ms of host time "
              f"outside the device's work; card {CARD}", flush=True)

    # the compiled guard on a clean run: probes in the graphs, one read of
    # their flags a call, no trip
    gg = Engine(model, engine_cfg(jit=True, guard=True), device=dev)
    r = _timed_run(gg, reqs, 0)
    gm = gg.metrics
    check(r["ok"] and r["tokens"] == plain["tokens"] and gm.guard_trips
          == gm.guard_rejits == gm.guard_recomputes == 0 and gg.captures == 3,
          "guarded compiled engine: engine_phase's tokens, 0 trips, 0 "
          "re-captures, 0 recomputes, 3 captures")
    gstats = trace_phase(model, dev, r["walls"][len(r["walls"]) // 2],
                         guard=True, jit=True)
    print(f"  graph + guard: {r['tokens_per_s']:.1f} tokens/s, decode-only "
          f"tick {_walls_str(r['walls'])}, traced tick "
          f"{gstats.get('ops', 0):.0f} device operations, busy "
          f"{gstats.get('busy_share', 0):.1%}; card {CARD}", flush=True)
    return {"K1": k1, "K4": k4}


def compiled_guard_phase(dev, plain) -> None:
    """The compiled guard: ``fs_einsum`` on K1's route captured under
    ``guarded(trip_limit=2)`` with static f32 operands; operands past the
    square form's range (``|a+b| > 1.84e19``) written in and replayed trip
    it, the second replay demotes the key and moves the route epoch, and a
    re-capture launches K1 no more and returns torch.einsum's result.
    Then the engine: a seeded pending trip and demotion re-capture the
    model calls and the run recovers engine_phase's tokens, with
    ``memory_allocated`` not growing across a re-capture."""
    print("compiled guard: fs_einsum on the K1 route in a CUDA graph, f32 "
          "operands of 1e19 whose products cancel, trip limit 2", flush=True)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(32, 64, generator=gen).to(dev)
    y = torch.randn(64, 32, generator=gen).to(dev)
    xs = torch.full((32, 64), 1e19, device=dev)
    xs[:, 1::2] *= -1.0
    ys = torch.full((64, 32), 1e19, device=dev)
    want = torch.einsum("mk,kn->mn", xs, ys)
    check(bool(torch.isfinite(want).all()), "the multiplier result is finite")
    key = routing.health_key("graph_guard", (1, 32, 64, 32), torch.float32)
    routing.reset_route_health()
    guards.clear_pending_trips()
    health, epoch0 = routing.route_health(), routing.route_epoch()

    def fn(a, b):
        return fs_einsum("mk,kn->mn", a, b, mode="square_pallas",
                         site="graph_guard")

    reset_counts()
    with guards.guarded(trip_limit=2):
        call = graphs.CapturedCall(fn, (x, y), device=dev, name="graph_guard")
        check(call.ledger.flags[0] == (key,)
              and [(kern.__name__, n) for kern, n, _ in call.ledger.launches]
              == [("sq_matmul_k1", 1)],
              f"the capture holds one probe ({key}) and one K1 launch")
        clean = call.replay()
        drained = [guards.drain_pending_trips()]
        torch.cuda.synchronize()
        tol = 64 * 2.0 ** -23 * (x.abs().max() + y.abs().max()).item() ** 2
        check(drained == [{}] and (clean - x @ y).abs().max().item() <= tol,
              "clean operands: no trip, the square result")
        for _ in range(2):
            call(xs, ys)
            drained.append(guards.drain_pending_trips())
        check(drained[1:] == [{key: 1}, {key: 1}]
              and health.trips.get(key) == 2 and health.is_demoted(key)
              and routing.route_epoch() == epoch0 + 1,
              f"two replays past the range trip twice and demote the key "
              f"(route epoch {epoch0} -> {routing.route_epoch()}; drained "
              f"{drained})")
        launched = sq_matmul_k1.launches
        check(launched == 4, f"K1: 1 warm-up + 3 replays = {launched}")
        call.release()
        recap = graphs.CapturedCall(fn, (xs, ys), device=dev,
                                    name="graph_guard")
        out = recap.replay()
        torch.cuda.synchronize()
        check(not recap.ledger.launches and recap.ledger.flags is None
              and sq_matmul_k1.launches == launched
              and torch.equal(out, want)
              and guards.drain_pending_trips() == {},
              "the re-capture serves the demoted key on the standard route: "
              "no K1 launch, no probe, torch.einsum's result")
    routing.reset_route_health()

    # the engine: a seeded pending trip and demotion (a synthetic key: the
    # ledger is the injection point) make _guarded_call drain, re-capture
    # and retry; the run is token-exact
    model = plain["model"]
    reqs = make_requests(model.cfg, N_REQUESTS, seed=0)
    eng = Engine(model, engine_cfg(jit=True, guard=True), device=dev)

    def mem():
        torch.cuda.synchronize()
        return (torch.cuda.memory_allocated(dev) / 2 ** 20,
                torch.cuda.memory_reserved(dev) / 2 ** 20)

    mems = [mem()]
    for i in range(2):
        probe = routing.health_key("synthetic_probe", (1, 2, 256, 1024),
                                   torch.float32)
        guards.emit_trace_probe(probe, torch.full((1,), float("nan"),
                                                  device=dev))
        health.record_trip(probe, limit=1)
        epoch = eng._route_epoch
        r = _timed_run(eng, reqs, 1000 * i, per_tick=False)
        mems.append(mem())
        # run 1 captures _chunk, re-captures it after the drain, then
        # _logits_at and _decode; run 2 re-captures all three
        check(r["ok"] and r["tokens"] == plain["tokens"]
              and eng.metrics.guard_rejits == i + 1
              and eng._route_epoch > epoch and eng.captures == 4 + 3 * i,
              f"run {i + 1} after a seeded demotion: engine_phase's tokens, "
              f"guard_rejits {eng.metrics.guard_rejits}, route epoch "
              f"{epoch} -> {eng._route_epoch}, {eng.captures} captures")
        routing.reset_route_health()
    eng._jit_model_fns()                # frees the three graphs
    mems.append(mem())
    print(f"  memory (allocated, reserved) MiB: before the first run "
          f"{mems[0][0]:.1f}, {mems[0][1]:.1f}; after it (3 graphs live) "
          f"{mems[1][0]:.1f}, {mems[1][1]:.1f}; after the second, which "
          f"re-captured all three {mems[2][0]:.1f}, {mems[2][1]:.1f}; the "
          f"graphs freed {mems[3][0]:.1f}, {mems[3][1]:.1f}", flush=True)
    check(abs(mems[2][0] - mems[1][0]) <= 1.0
          and mems[3][0] < mems[2][0],
          "a re-capture frees the old graphs: allocated memory after it "
          "within 1 MiB of before it, and lower once the graphs are freed")


# ------------------------------------------------- every contraction square
def shapes_ok(compared) -> None:
    """K1, K2 and K3 ran only at shapes their phases held to the plain
    version."""
    for name, kern in (("K1", sq_matmul_k1), ("K2", sq_matmul_k2),
                       ("K3", sq_matmul_k3)):
        ran = dict(kern.shapes)
        check(set(ran) <= set(compared[name]),
              f"{name} ran only at shapes held to its plain version above: "
              f"{sorted(ran.items())}")


def engine_none_phase(model: LM, dev, compared):
    """The paged engine with every contraction square (no policy): each
    prefill chunk's two attention einsums per layer run on K2."""
    cfg = model.cfg
    L = cfg.n_layers
    print(f"engine, no policy: {cfg.name} full width, square_pallas with "
          f"every contraction square, prepared", flush=True)
    eng = Engine(model, engine_cfg(), device=dev)
    eng.submit(make_requests(cfg, N_REQUESTS, seed=0))
    reset_counts()                      # counts of this path's run only
    bad, t0, pending = [], time.perf_counter(), True
    with counting.track_contractions() as audit:
        while pending:
            m = eng.metrics
            before = counts() + (m.decode_steps, m.prefill_chunks,
                                 m.first_tokens)
            pending = eng.step()
            d = [a - b for a, b in zip(counts() + (
                m.decode_steps, m.prefill_chunks, m.first_tokens), before)]
            k1, k2, k3, k4, steps, chunks, firsts = d
            if (k1 != (L * GEMMS_PER_LAYER + 1) * steps
                    + L * GEMMS_PER_LAYER * chunks + firsts
                    or k4 != L * steps or k2 != 2 * L * chunks or k3):
                bad.append(d)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m, res = eng.metrics, eng.results
    total = dict(zip(("K1", "K2", "K3", "K4"), counts()))
    taken = dict(routing.select_matmul_route.taken)
    check(len(res) == N_REQUESTS and all(
        r.status is RequestStatus.COMPLETED and len(r.tokens) == MAX_NEW
        for r in res.values()),
        f"{N_REQUESTS} requests COMPLETED with {MAX_NEW} tokens each")
    check(not bad and m.prefill_chunks > 0 and m.decode_steps > 0,
          f"every tick: K2 +{2 * L} per prefill chunk, K1 +"
          f"{L * GEMMS_PER_LAYER + 1} and K4 +{L} per decode step, no K3 "
          f"({m.prefill_chunks} prefill chunks, {m.decode_steps} decode "
          f"steps; faulty ticks {bad})")
    check(taken.get("virtual", 0) == 0 and total["K2"] > 0,
          f"no matmul took the virtual route (routes taken: {taken}); "
          f"launches {total}")
    shapes_ok(compared)
    audit_ok(audit, cfg, m.decode_steps, m.prefill_chunks, m.first_tokens,
             square_gemms=False)
    print(f"  served {len(res)} requests, {m.tokens_out} tokens in "
          f"{wall:.3f} s ({m.tokens_out / wall:.1f} tokens/s)", flush=True)
    return total


def server_phase(model: LM, dev, compared):
    """The dense reference Server with every contraction square: prefill
    attention on K2 or K3 by prompt length, every decode step's attention
    on K3 (4 slots x 12 heads, m = 1), every other GEMM on K1."""
    cfg = model.cfg
    L = cfg.n_layers
    print(f"dense Server (--legacy), no policy: {cfg.name} full width, "
          f"prepared, max_batch {DENSE_BATCH}, cache_len {DENSE_CACHE}",
          flush=True)
    with torch.no_grad():
        params = model.prepare_params()
    server = Server(model, params, ServeConfig(
        max_batch=DENSE_BATCH, cache_len=DENSE_CACHE,
        max_new_tokens=MAX_NEW, jit=False), device=dev)
    calls = []

    def traced(kind, fn):
        def call(*args):
            before, shapes = counts(), collections.Counter(
                sq_matmul_k1.shapes)
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            t = time.perf_counter() - t
            delta = [a - b for a, b in zip(counts(), before)]
            ms = {s[0] for s in sq_matmul_k1.shapes - shapes}
            size = args[1]["tokens"].shape[1] if kind == "prefill" else None
            calls.append((kind, size, delta, ms, t))
            return out
        return call

    server._prefill = traced("prefill", server._prefill)
    server._decode = traced("decode", server._decode)
    reqs = make_requests(cfg, N_REQUESTS, seed=0)
    reset_counts()                      # counts of this path's run only
    t0 = time.perf_counter()
    out = server.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = dict(zip(("K1", "K2", "K3", "K4"), counts()))
    taken = dict(routing.select_matmul_route.taken)
    check(sorted(out) == list(range(N_REQUESTS))
          and all(len(t) == MAX_NEW for t in out.values()),
          f"{N_REQUESTS} requests served with {MAX_NEW} tokens each")
    decodes = [c for c in calls if c[0] == "decode"]
    prefills = [c for c in calls if c[0] == "prefill"]
    per_step = L * GEMMS_PER_LAYER + 1
    check(decodes and all(c[2] == [per_step, 0, 2 * L, 0]
                          and c[3] == {DENSE_BATCH} for c in decodes),
          f"every decode step: K1 {per_step} at m={DENSE_BATCH} and K3 "
          f"{2 * L}, no K2 or K4 ({len(decodes)} steps; seen "
          f"{sorted({(tuple(c[2]), tuple(c[3])) for c in decodes})})")
    want = {s: [L * GEMMS_PER_LAYER,
                2 * L if dense_prefill_kernel(s) == "K2" else 0,
                2 * L if dense_prefill_kernel(s) == "K3" else 0, 0]
            for s in {c[1] for c in prefills}}
    check(len(prefills) == N_REQUESTS
          and all(c[2] == want[c[1]] for c in prefills),
          f"every prefill: K1 {L * GEMMS_PER_LAYER}, and K2 {2 * L} from 13 "
          f"tokens or K3 {2 * L} for 7-12: "
          f"{[(c[1], c[2]) for c in prefills]}")
    check(total["K1"] == per_step * len(decodes)
          + (L * GEMMS_PER_LAYER + 1) * len(prefills)
          and total["K3"] > 0 and total["K2"] > 0
          and taken.get("virtual", 0) == 0,
          f"main path: launches {total} over {len(decodes)} decode steps "
          f"and {len(prefills)} prefills; routes {taken}")
    shapes_ok(compared)
    walls = sorted(c[4] for c in decodes)
    tokens = sum(len(t) for t in out.values())
    print(f"  served {len(out)} requests, {tokens} tokens in {wall:.3f} s "
          f"({tokens / wall:.1f} tokens/s); decode step of {DENSE_BATCH} "
          f"slots: median wall {walls[len(walls) // 2] * 1e3:.2f} ms (min "
          f"{walls[0] * 1e3:.2f}, max {walls[-1] * 1e3:.2f}); prefill median "
          f"{sorted(c[4] for c in prefills)[len(prefills) // 2] * 1e3:.2f} "
          f"ms", flush=True)
    dense_logits_phase(model, params, dev)
    prompts = [np.asarray(r.tokens, np.int32) for r in reqs[:DENSE_BATCH]]
    cache, pos = _dense_prefilled(model, params, prompts, dev)
    toks = torch.zeros((DENSE_BATCH, 1), dtype=torch.int32, device=dev)
    with torch.no_grad():
        trace_steps(lambda: model.decode_step(params, cache, toks, pos),
                    f"dense decode steps of {DENSE_BATCH} slots",
                    walls[len(walls) // 2])
    total["tokens"] = out
    total["step_s"] = walls[len(walls) // 2]
    return total


def dense_graph_phase(model: LM, dev, compared, dense):
    """The dense Server with its decode step captured into a CUDA graph
    (its default on CUDA, as the JAX Server jits ``decode_step``):
    server_phase's tokens, K1 85 and K3 24 a decode step by the ledger
    (the first step twice: its capture's warm-up runs it eagerly once) and
    in a profiled replay."""
    cfg = model.cfg
    L = cfg.n_layers
    print(f"dense Server, decode step captured (CUDA graph): {cfg.name} full "
          f"width, no policy, prepared, max_batch {DENSE_BATCH}; card {CARD}",
          flush=True)
    with torch.no_grad():
        params = model.prepare_params()
    server = Server(model, params, ServeConfig(
        max_batch=DENSE_BATCH, cache_len=DENSE_CACHE,
        max_new_tokens=MAX_NEW), device=dev)
    check(server.jit, "the Server captures its decode step by default on "
                      "CUDA")
    calls, inner = [], server._decode

    def decode(*args):
        before = counts()
        t = time.perf_counter()
        out = inner(*args)
        torch.cuda.synchronize()
        calls.append(([a - b for a, b in zip(counts(), before)],
                      time.perf_counter() - t))
        return out

    server._decode = decode
    reset_counts()                      # counts of this path's run only
    t0 = time.perf_counter()
    out = server.run(make_requests(cfg, N_REQUESTS, seed=0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = dict(zip(("K1", "K2", "K3", "K4"), counts()))
    check(out == dense["tokens"], "tokens equal server_phase's (eager)")
    per = [L * GEMMS_PER_LAYER + 1, 0, 2 * L, 0]
    check(calls and calls[0][0] == [2 * n for n in per]
          and all(c[0] == per for c in calls[1:])
          and server.graph.replays == len(calls),
          f"by the ledger: every replayed decode step K1 {per[0]} and K3 "
          f"{per[2]}, the first twice (warm-up + replay); {len(calls)} "
          f"steps, {server.graph.replays} replays")
    shapes_ok(compared)
    walls = sorted(c[1] for c in calls[1:])
    tokens = sum(len(t) for t in out.values())
    print(f"  served {len(out)} requests, {tokens} tokens in {wall:.3f} s "
          f"({tokens / wall:.1f} tokens/s); replayed decode step "
          f"{_walls_str(walls)} beside server_phase's eager median "
          f"{dense['step_s'] * 1e3:.2f} ms; card {CARD}", flush=True)
    stats = trace_steps(server.graph.replay, "replayed dense decode steps",
                        walls[len(walls) // 2])
    check(stats.get("K1") == per[0] and stats.get("K3") == per[2],
          f"a profiled replay holds {stats.get('K1')} K1 and "
          f"{stats.get('K3')} K3 kernels (want {per[0]} and {per[2]})")
    return total


def _dense_prefilled(model: LM, params, prompts, dev):
    """A dense cache with each prompt prefilled into its slot, and the
    slots' next positions."""
    cache = model.init_cache(len(prompts), DENSE_CACHE)
    with torch.no_grad():
        for i, p in enumerate(prompts):
            _, one = model.prefill(params, {"tokens": torch.as_tensor(
                p[None], device=dev)}, DENSE_CACHE)
            write_slot(cache, i, one)
    return cache, torch.as_tensor([len(p) for p in prompts], device=dev)


def _dense_decode_logits(model: LM, params, prompts, first, dev):
    """One decode step of all slots of a freshly prefilled dense cache, fed
    ``first``; that step's logits (B, V)."""
    cache, pos = _dense_prefilled(model, params, prompts, dev)
    with torch.no_grad():
        logits, _ = model.decode_step(params, cache,
                                      first.to(torch.int32)[:, None], pos)
    return logits


def dense_logits_phase(model: LM, params, dev) -> None:
    """One dense decode step's logits (4 slots) against the same model in
    standard mode, fed the same tokens."""
    cfg_std = dataclasses.replace(model.cfg, matmul_mode="standard",
                                  contraction_policy=None)
    std = LM(cfg_std, device=dev, seed=1)
    std.load_state_dict(model.state_dict())
    prompts = [np.asarray(r.tokens, np.int32)
               for r in make_requests(model.cfg, DENSE_BATCH, seed=0)]
    with torch.no_grad():
        first = torch.stack([torch.argmax(std.logits(std.tree(), std.forward(
            std.tree(), {"tokens": torch.as_tensor(p[None], device=dev)})[0][
                :, -1:])[0, 0]) for p in prompts])
    sq_logits = _dense_decode_logits(model, params, prompts, first, dev)
    std_logits = _dense_decode_logits(std, std.tree(), prompts, first, dev)
    scale = std_logits.abs().max().item()
    err = (sq_logits - std_logits).abs().max().item()
    agree = (sq_logits.argmax(-1) == std_logits.argmax(-1)).float().mean()
    check(bool(torch.isfinite(sq_logits).all()) and err <= 2e-2 * scale,
          f"dense decode-step logits vs standard mode: max|diff| {err:.4e} "
          f"<= 2e-2 * max|logits| ({2e-2 * scale:.4e})")
    check(agree.item() == 1.0,
          f"dense decode-step greedy tokens vs standard mode: argmax "
          f"agreement {agree.item():.3f} over {len(prompts)} rows")


# ------------------------------------------------------------ K7, K8
# ResNet-50 (He et al. 2016, Table 1; stride on the 3x3 as in torchvision's
# v1.5) at batch 8: (name, x shape, w shape, stride, padding), and the
# CIFAR ResNet stem (the same paper, section 4.2), which the planner sends
# to the im2col route.
RESNET50_LAYERS = [
    ("conv1", (8, 3, 224, 224), (64, 3, 7, 7), 2, 3),
    ("conv2_x 1x1", (8, 256, 56, 56), (64, 256, 1, 1), 1, 0),
    ("conv2_x 3x3", (8, 64, 56, 56), (64, 64, 3, 3), 1, 1),
    ("conv3_1 3x3/2", (8, 128, 56, 56), (128, 128, 3, 3), 2, 1),
    ("conv4_x 3x3", (8, 256, 14, 14), (256, 256, 3, 3), 1, 1),
    ("conv5_x 3x3", (8, 512, 7, 7), (512, 512, 3, 3), 1, 1),
]
CIFAR_STEM = ("cifar stem", (8, 3, 32, 32), (16, 3, 3, 3), 1, 1)
# ragged and padded: odd H/W, cin 3/5/7, SAME, explicit asymmetric pads,
# stride 2 (B, cin, H, W), (cout, cin, kh, kw), stride, padding
K7_RAGGED = [
    ((2, 3, 17, 13), (5, 3, 3, 3), 1, "SAME"),
    ((1, 5, 15, 18), (7, 5, 3, 3), 2, "SAME"),
    ((2, 7, 10, 11), (3, 7, 3, 5), 1, ((2, 0), (0, 3))),
    ((1, 3, 9, 23), (5, 3, 5, 3), (2, 1), "VALID"),
    ((2, 5, 31, 29), (65, 5, 7, 7), 2, ((3, 2), (1, 3))),
    ((3, 1, 8, 8), (1, 1, 8, 8), 1, "VALID"),
]
FIR_TAPS = (16, 127, 255)            # JAX benchmarks' count; below/above 128
FIR_LEN = 1 << 20
K8_RAGGED = [(5000, 127), (4097, 255), (300, 1), (1000, 300), (2049, 3)]


def conv_operands(gen, xshape, wshape, dev, relu=True):
    """f32 activations (post-ReLU unless ``relu`` is False: an image) and
    He-normal filters."""
    x = torch.randn(xshape, generator=gen)
    if relu:
        x = x.clamp_min(0)
    fan_in = wshape[1] * wshape[2] * wshape[3]
    w = torch.randn(wshape, generator=gen) * math.sqrt(2.0 / fan_in)
    return x.to(dev), w.to(dev)


def conv_geometry(xshape, wshape, stride, padding):
    strides = conv_core.resolve_stride(stride)
    pads = conv_core.resolve_padding(padding, xshape[2:], wshape[2:], strides)
    return strides, pads


def conv_tol(x, w, kvol):
    """|err| bound of two square-form f32 sums of kvol terms per output."""
    return kvol * 2.0 ** -23 * (x.abs().max().item()
                                + w.abs().max().item()) ** 2


def k7_call(x, w, stride, padding):
    """(kernel call, plain call, im2col-route call) on one conv's operands,
    the filters prepared once."""
    strides, pads = conv_geometry(x.shape, w.shape, stride, padding)
    wt, sw, _ = ops.prepare_conv2d_weights(w)
    khw = tuple(w.shape[2:])
    return (lambda: sq_conv2d_k7(x, wt, sw, khw=khw, stride=strides,
                                 pads=pads),
            lambda: sq_conv2d_plain(x, wt, sw, khw, strides, pads),
            lambda: ops.sq_conv2d_im2col(x, w, stride=stride,
                                         padding=padding))


def conv_build_report():
    """K7's and K8's compiler report: each template instance's registers
    and spill bytes, which must be 0."""
    for name, source in (("K7", "sq_conv2d"), ("K8", "sq_conv")):
        for row in build.ptxas_usage(build.report(source)):
            inst = re.search(r"kernelI([if])E", row["entry"])
            dtype = {"f": "f32", "i": "int32"}[inst[1]] if inst else \
                row["entry"]
            spill = row["spill_stores"] + row["spill_loads"]
            check(spill == 0, f"{name} {dtype}: {row['registers']} "
                              f"registers, {spill} bytes spilled")


def k7_phase(dev, gen):
    """K7 against its plain version at every ResNet-50 fused layer and a
    ragged/padded set (f32 and int8), against the im2col route on the same
    operands, each launch's grid and tile checked against
    ``k7_launch_shape``, and timed beside the plain version, F.conv2d, the
    bound and the FP32 slot floor (2 slots a term), with the per-pass sums.
    Operands are activations their caller has just written, so they stay
    hot, as for K2/K3."""
    print("K7 sq_conv2d vs plain (f32 |err| <= K * 2^-23 * (max|x| + "
          "max|w|)^2 with K = kh*kw*cin; int8 exact; fused = im2col route "
          "within the same bound, int8 bit for bit)", flush=True)
    conv_build_report()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    cases = [(name, xs, ws, st, pd, True) for name, xs, ws, st, pd
             in RESNET50_LAYERS]
    cases += [("ragged", xs, ws, st, pd, False) for xs, ws, st, pd
              in K7_RAGGED]
    for name, xshape, wshape, stride, padding, timed in cases:
        x, w = conv_operands(gen, xshape, wshape, dev,
                             relu=name not in ("conv1", "ragged"))
        kvol = wshape[1] * wshape[2] * wshape[3]
        kern, plain, im2col = k7_call(x, w, stride, padding)
        out, ref, via = kern(), plain(), im2col()
        torch.cuda.synchronize()
        shape = sq_conv2d_k7.last_shape
        strides, pads = conv_geometry(xshape, wshape, stride, padding)
        want = k7_launch_shape(xshape, wshape[0], wshape[2:], strides, pads,
                               sms)
        tol = conv_tol(x, w, kvol)
        err = (out - ref).abs().max().item()
        err_route = (out - via).abs().max().item()
        label = f"{name} x{tuple(xshape)} w{tuple(wshape)} s={stride} " \
                f"p={padding}"
        check(bool(torch.isfinite(out).all()) and out.shape == ref.shape
              and err <= tol,
              f"f32 {label}: max|err| {err:.3e} <= {tol:.3e}")
        check(err_route <= tol, f"f32 {label}: fused vs im2col route "
                                f"max|diff| {err_route:.3e} <= {tol:.3e}")
        check(shape == want, f"{label}: grid {shape['grid']} of "
                             f"{shape['tile'][0]} x {shape['tile'][1]} tiles, "
                             f"band {shape['band']}, {shape['pixels']} pixels "
                             f"a tile, {shape['slice']} channels a slice, "
                             f"window {shape['window']}, "
                             f"{shape['grid'][2]} split(s), as the mirror says")
        if not timed or name in ("conv1", "conv3_1 3x3/2", "conv5_x 3x3"):
            xi = torch.randint(-128, 128, xshape, generator=gen,
                               dtype=torch.int32).to(dev)
            wi = torch.randint(-128, 128, wshape, generator=gen,
                               dtype=torch.int32).to(dev)
            ki, pi, ii = k7_call(xi, wi, stride, padding)
            oi = ki()
            exact = conv_core.conv2d_nchw(xi, wi, strides, pads, torch.int32)
            check(torch.equal(oi, pi()) and torch.equal(oi, exact)
                  and torch.equal(oi, ii()),
                  f"int8 {label}: bit-exact, = plain = im2col route")
        if not timed:
            rows.append(dict(name=name, max_abs_err=err))
            continue
        ms = time_graph([kern])
        plain_ms = time_graph([plain], reps=2, replays=2)
        lib_ms = time_graph([lambda: torch.nn.functional.conv2d(
            x, w, stride=strides, padding=(pads[0][0], pads[1][0]))])
        B, cout = xshape[0], wshape[0]
        oh, ow = out.shape[2:]
        terms = B * oh * ow * cout * kvol
        nbytes = 4 * (x.numel() + w.numel() + cout + out.numel())
        ops_n = 3 * terms                 # one add + one FMA per square term
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, \
            ops_n / FP32_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        floor = 2 * terms / FP32_SLOTS_PER_S * 1e3
        row = dict(name=name, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=bound, t_bytes=t_bytes, t_ops=t_ops,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   max_abs_err=err, terms=terms, slot_floor_ms=floor)
        rows.append(row)
        print(f"    {name:14s} {terms / 1e6:7.1f} M terms, K walk split "
              f"{shape['grid'][2]}x  K7 {ms:.4f} ms | "
              f"plain {plain_ms:.4f} ms | F.conv2d (f32, no TF32) "
              f"{lib_ms:.4f} ms | bound {bound:.4f} ms ({row['bound_by']}) "
              f"| {bound / ms:.1%} of bound | slot floor {floor:.4f} ms (2 "
              f"slots a term) | {floor / ms:.1%} of floor", flush=True)
    timed = [r for r in rows if "ms" in r]
    ms, lib, floor = (sum(r[k] for r in timed)
                      for k in ("ms", "library_ms", "slot_floor_ms"))
    print(f"  K7 per pass over the {len(timed)} layers: {ms:.4f} ms | "
          f"F.conv2d {lib:.4f} ms ({ms / lib:.2f}x) | slot floor "
          f"{floor:.4f} ms ({floor / ms:.1%} of floor)", flush=True)
    return rows


def k8_phase(dev, gen):
    """K8 against its plain version on the FIR streams (L = 2^20 at 16, 127
    and 255 taps) and a ragged set, f32 and int8, each launch's grid
    checked against ``k8_launch_shape``, timed beside the plain version,
    F.conv1d, the bound and the FP32 slot floor (2 slots a term), with the
    per-pass sums."""
    print("K8 sq_conv vs plain (f32 |err| <= n * 2^-23 * (max|x| + "
          "max|w|)^2; int8 exact)", flush=True)
    rows = []
    cases = [(FIR_LEN, n, True) for n in FIR_TAPS]
    cases += [(L, n, False) for L, n in K8_RAGGED]
    for L, n, timed in cases:
        x = torch.randn(L, generator=gen).to(dev)
        w = (torch.randn(n, generator=gen) / math.sqrt(n)).to(dev)
        sw = -(w * w).sum().reshape(1)
        out = sq_conv_k8(x, w, sw)
        ref = sq_conv_plain(x, w, sw)
        torch.cuda.synchronize()
        shape = sq_conv_k8.last_shape
        tol = conv_tol(x, w, n)
        err = (out - ref).abs().max().item()
        check(bool(torch.isfinite(out).all()) and err <= tol,
              f"f32 L={L} n={n}: max|err| {err:.3e} <= {tol:.3e}")
        check(shape == k8_launch_shape(L, n),
              f"L={L} n={n}: {shape['grid']} blocks of {shape['block']} "
              f"outputs, {shape['thread']} a thread, taps staged "
              f"{shape['tap_chunk']} at a time, as the mirror says")
        xi = torch.randint(-128, 128, (L,), generator=gen,
                           dtype=torch.int32).to(dev)
        wi = torch.randint(-128, 128, (n,), generator=gen,
                           dtype=torch.int32).to(dev)
        swi = -(wi * wi).sum(dtype=torch.int32).reshape(1)
        oi = sq_conv_k8(xi, wi, swi)
        exact = conv_core.correlate1d(xi, wi, mode="standard")
        check(torch.equal(oi, sq_conv_plain(xi, wi, swi))
              and torch.equal(oi, exact),
              f"int8 L={L} n={n}: bit-exact")
        if not timed:
            rows.append(dict(L=L, n=n, max_abs_err=err))
            continue
        ms = time_graph([lambda: sq_conv_k8(x, w, sw)])
        plain_ms = time_graph([lambda: sq_conv_plain(x, w, sw)], reps=2,
                              replays=2)
        lib_ms = time_graph([lambda: torch.nn.functional.conv1d(
            x[None, None], w[None, None])])
        k_out = L - n + 1
        nbytes = 4 * (L + n + 1 + k_out)
        ops_n = 3 * k_out * n
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, \
            ops_n / FP32_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        floor = 2 * k_out * n / FP32_SLOTS_PER_S * 1e3
        row = dict(L=L, n=n, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=bound, t_bytes=t_bytes, t_ops=t_ops,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   max_abs_err=err, slot_floor_ms=floor)
        rows.append(row)
        print(f"    L=2^20 n={n:3d}  K8 {ms:.4f} ms | plain {plain_ms:.4f} ms "
              f"| F.conv1d (f32, no TF32) {lib_ms:.4f} ms | bound "
              f"{bound:.4f} ms ({row['bound_by']}) | {bound / ms:.1%} of "
              f"bound | slot floor {floor:.4f} ms (2 slots a term) | "
              f"{floor / ms:.1%} of floor", flush=True)
    timed = [r for r in rows if "ms" in r]
    ms, lib, bound = (sum(r[k] for r in timed)
                      for k in ("ms", "library_ms", "bound_ms"))
    print(f"  K8 per pass over the {len(timed)} streams: {ms:.4f} ms | "
          f"F.conv1d {lib:.4f} ms ({ms / lib:.2f}x) | bound {bound:.4f} ms "
          f"({bound / ms:.1%} of bound)", flush=True)
    return rows


def kernel_counts():
    return {"K1": sq_matmul_k1.launches, "K2": sq_matmul_k2.launches,
            "K3": sq_matmul_k3.launches, "K4": sq_paged_attn_k4.launches,
            "K5": cpm3_matmul_k5.launches, "K6": cpm4_matmul_k6.launches,
            "K7": sq_conv2d_k7.launches, "K8": sq_conv_k8.launches}


def conv_path_phase(dev, gen):
    """The conv path as a user drives it: conv2d(mode="square_pallas") with
    prepared filters over the six ResNet-50 layers and the CIFAR stem, the
    route the planner's.  One K7 launch per fused layer, one K1 launch for
    the stem, nothing else; each output within the bound of standard mode,
    and the prepared result equal to the raw one bit for bit."""
    layers = RESNET50_LAYERS + [CIFAR_STEM]
    print(f"conv path: conv2d square_pallas, prepared filters, "
          f"{len(layers)} layers at batch 8", flush=True)
    data = []
    for name, xshape, wshape, stride, padding in layers:
        x, w = conv_operands(gen, xshape, wshape, dev,
                             relu=name not in ("conv1", "cifar stem"))
        data.append((name, x, w, prepare_operand(w, for_="conv2d"), stride,
                     padding))
    # the stem's K1 GEMM is held to K1's plain version at its shape
    _, x, w, _, stride, padding = data[-1]
    strides, pads = conv_geometry(x.shape, w.shape, stride, padding)
    pm = ops._im2col_patches(x, tuple(w.shape[2:]), strides, pads,
                             conv2d_out_hw(x.shape[2:], w.shape[2:], strides,
                                           pads))
    _, sw, wmat = ops.prepare_conv2d_weights(w)
    sa = -(pm * pm).sum(1)
    err = (sq_matmul_k1(pm, wmat, sa, sw)
           - sq_matmul_plain(pm, wmat, sa, sw)).abs().max().item()
    tol = pm.shape[1] * 2.0 ** -23 * (pm.abs().max().item()
                                      + wmat.abs().max().item()) ** 2
    check(err <= tol, f"K1 at the stem's im2col GEMM {tuple(pm.shape)} @ "
                      f"{tuple(wmat.shape)}: max|err| {err:.3e} <= "
                      f"{tol:.3e}")
    for _, x, _, prep, stride, padding in data:          # warm-up
        conv_core.conv2d(x, prep, stride=stride, padding=padding,
                         mode="square_pallas")
    torch.cuda.synchronize()

    reset_counts()                      # counts of this path's run only
    per_layer, outs = [], []
    t0 = time.perf_counter()
    for _, x, _, prep, stride, padding in data:
        before = kernel_counts()
        outs.append(conv_core.conv2d(x, prep, stride=stride, padding=padding,
                                     mode="square_pallas"))
        after = kernel_counts()
        per_layer.append({k: after[k] - before[k] for k in after})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = kernel_counts()
    taken = dict(routing.select_conv2d_route.taken)
    k1_shapes = dict(sq_matmul_k1.shapes)

    want = [{"K7": 1} if name != "cifar stem" else {"K1": 1}
            for name, *_ in layers]
    check(all(d == {k: w.get(k, 0) for k in d}
              for d, w in zip(per_layer, want)),
          f"one K7 launch per fused layer, one K1 for the stem, no other "
          f"kernel: {per_layer}")
    check(total["K7"] == 6 and total["K1"] == 1 and taken == {"fused": 6,
                                                              "im2col": 1},
          f"main path: launches {total}, routes {taken}")
    check(set(k1_shapes) == {tuple(pm.shape) + (wmat.shape[1],)},
          f"K1 ran only at the stem's GEMM held to its plain version above: "
          f"{k1_shapes}")
    for (name, x, w, _, stride, padding), out in zip(data, outs):
        std = conv_core.conv2d(x, w, stride=stride, padding=padding,
                               mode="standard")
        raw = conv_core.conv2d(x, w, stride=stride, padding=padding,
                               mode="square_pallas")
        tol = conv_tol(x, w, w.shape[1] * w.shape[2] * w.shape[3])
        err = (out - std).abs().max().item()
        check(bool(torch.isfinite(out).all()) and out.shape == std.shape
              and err <= tol and torch.equal(out, raw),
              f"{name}: out {tuple(out.shape)} vs standard mode max|diff| "
              f"{err:.3e} <= {tol:.3e}; prepared = raw bit for bit")
    print(f"  7 layers in {wall * 1e3:.2f} ms of host wall (eager, one "
          f"pass after a warm-up)", flush=True)
    return total


def fir_path_phase(dev):
    """The FIR path as a user drives it: ops.sq_conv on numpy streams of
    2^20 samples from seed 0 (they go to the GPU by default), at 16, 127
    and 255 taps.  One K8 launch per stream, nothing else; each output
    within the bound of the standard correlation."""
    print("FIR path: ops.sq_conv on L = 2^20 numpy streams (seed 0)",
          flush=True)
    rng = np.random.default_rng(0)
    streams = [(rng.standard_normal(FIR_LEN).astype(np.float32),
                (rng.standard_normal(n) / math.sqrt(n)).astype(np.float32))
               for n in FIR_TAPS]
    reset_counts()                      # counts of this path's run only
    outs = [ops.sq_conv(x, w) for x, w in streams]
    torch.cuda.synchronize()
    total = kernel_counts()
    check(total["K8"] == len(FIR_TAPS)
          and sum(total.values()) == len(FIR_TAPS)
          and dict(sq_conv_k8.shapes) == {(FIR_LEN, n): 1 for n in FIR_TAPS},
          f"main path: one K8 launch per stream, no other kernel: {total}")
    for (x, w), out in zip(streams, outs):
        xt, wt = torch.as_tensor(x, device=dev), torch.as_tensor(w, device=dev)
        std = conv_core.correlate1d(xt, wt, mode="standard")
        tol = conv_tol(xt, wt, len(w))
        err = (out - std).abs().max().item()
        check(out.device.type == "cuda" and out.shape == std.shape
              and bool(torch.isfinite(out).all()) and err <= tol,
              f"n={len(w)}: out {tuple(out.shape)} on {out.device} vs the "
              f"standard correlation max|diff| {err:.3e} <= {tol:.3e}")
    return total


# ------------------------------------------------------------ K5, K6
# The batched DFT: 4096 complex64 signals of 1024 samples, one per row of Z,
# times the 1024-point DFT matrix W (symmetric, so each row of Z @ W is that
# signal's DFT); and 64^3, the shape of the JAX pallas_cpm3_matmul rows of
# BENCH_kernels.json.
DFT_SIGNALS, DFT_POINTS = 4096, 1024
# (kernel, plain version, FLOP a complex term, source, FP32 slots a term,
# launch-shape mirror).  The FLOP are the algorithm's work: K5's three
# squares and three adds (9, an fma counted as 2), K6's four and four (12);
# the slots count each add and each square once.
CPM = {"K5": (cpm3_matmul_k5, cpm3_matmul_plain, 9, "cpm3_matmul", 6,
              k5_launch_shape),
       "K6": (cpm4_matmul_k6, cpm4_matmul_plain, 12, "cpm4_matmul", 8,
              k6_launch_shape)}


def dft_signals() -> np.ndarray:
    """Z: the DFT path's 4096 complex64 signals (normal real and imaginary
    planes, numpy seed 0)."""
    rng = np.random.default_rng(0)
    shape = (DFT_SIGNALS, DFT_POINTS)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def cpm_operands(x, y):
    """The contiguous f32 planes (a, b, c, s) of ``x @ y`` and the
    corrections of K5 (eqs 33/35) and K6 (eq 18), as ops computes them."""
    a, b, c, s = (t.float().contiguous() for t in (x.real, x.imag, y.real,
                                                   y.imag))
    k5 = ((-(a + b) ** 2 + b ** 2).sum(1), (-(a + b) ** 2 - a ** 2).sum(1),
          (-c ** 2 + (c + s) ** 2).sum(0), (-c ** 2 - (s - c) ** 2).sum(0))
    k6 = (-(a ** 2 + b ** 2).sum(1), -(c ** 2 + s ** 2).sum(0))
    return (a, b, c, s), {"K5": k5, "K6": k6}


def cpm_tol(planes, k: int) -> float:
    """|err| bound of two square-form f32 sums of k complex terms: each
    plane accumulates two squares of sums of up to three planes."""
    return 2 * k * 2.0 ** -23 * sum(t.abs().max().item()
                                    for t in planes) ** 2


class SmiSamples:
    """``nvidia-smi`` sampling the SM clock and power draw every 20 ms while
    the block runs (an FP32-bound kernel follows the clock, which the power
    limit sets); ``str()`` gives min / median / max of each."""

    QUERY = ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
             "--format=csv,noheader,nounits", "-lms", "20"]

    def __enter__(self):
        self.proc = subprocess.Popen(self.QUERY, stdout=subprocess.PIPE,
                                     stderr=subprocess.DEVNULL, text=True)
        self.proc.stdout.readline()          # the sampler is running
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        self.rows = [[float(x) for x in line.split(",")]
                     for line in out.splitlines() if line.count(",") == 2]
        return False

    def __str__(self):
        if not self.rows:
            return "nvidia-smi gave no samples"
        clk, pwr = (sorted(r[i] for r in self.rows) for i in (0, 1))
        return (f"{len(clk)} nvidia-smi samples: SM clock {clk[0]:.0f} / "
                f"{clk[len(clk) // 2]:.0f} / {clk[-1]:.0f} MHz, power "
                f"{pwr[0]:.0f} / {pwr[len(pwr) // 2]:.0f} / {pwr[-1]:.0f} W "
                f"of {self.rows[0][2]:.0f} W (min / median / max)")


def cpm_build_report():
    """K5's and K6's compiler report: each instance's registers and spill
    bytes, which must be 0."""
    for name, (*_, source, _, _) in CPM.items():
        for row in build.ptxas_usage(build.report(source)):
            inst = re.search(r"Li(\d+)ELi(\d+)ELi(\d+)ELb([01])E",
                             row["entry"])
            tile = (f"{inst[1]} x {inst[2]} thread tile, {inst[3]}-deep K "
                    f"tile, {'16-byte' if inst[4] == '1' else 'scalar'} "
                    f"copies" if inst else row["entry"])
            spill = row["spill_stores"] + row["spill_loads"]
            check(spill == 0, f"{name} {tile}: {row['registers']} registers, "
                              f"{spill} bytes spilled")


def cpm_phase(dev, gen, z, w):
    """K5 and K6 against their plain versions at the batched-DFT shape (the
    DFT path's own operands) and at 64^3, K5 against K6, each with its grid
    and tile, timed beside the plain version, torch.matmul on complex64 (no
    TF32), the FLOP bound and the FP32 slot floor, with the card's clock
    and power sampled beside the DFT-shape timings.  The operands are the
    planes the wrapper has just written (40 MB at the DFT shape), so they
    are not cycled past the L2."""
    print("K5 cpm3_matmul and K6 cpm4_matmul vs plain (f32 |err| <= 2 * k * "
          "2^-23 * (max|a| + max|b| + max|c| + max|s|)^2; K5 vs K6 within "
          "twice that)", flush=True)
    cpm_build_report()
    small = [torch.complex(torch.randn(m, k, generator=gen),
                           torch.randn(m, k, generator=gen)).to(dev)
             for m, k in ((64, 64), (64, 64))]
    cases = [("batched DFT", torch.as_tensor(z, device=dev), w),
             ("64^3", *small)]
    rows = {"K5": [], "K6": []}
    for label, x, y in cases:
        planes, corrs = cpm_operands(x, y)
        m, k = planes[0].shape
        n = planes[2].shape[1]
        tol = cpm_tol(planes, k)
        outs = {}
        lib_ms = time_graph([lambda: torch.matmul(x, y)])
        for name, (kern, plain, flop, _, slots, launch_shape) in CPM.items():
            out = kern(*planes, *corrs[name])
            ref = plain(*planes, *corrs[name])
            torch.cuda.synchronize()
            err = max((o - r).abs().max().item() for o, r in zip(out, ref))
            check(all(bool(torch.isfinite(o).all()) for o in out)
                  and err <= tol,
                  f"{name} f32 {label} m={m} k={k} n={n}: max|err| "
                  f"{err:.3e} <= {tol:.3e}")
            shape = kern.last_shape
            check(shape == launch_shape(m, n),
                  f"{name} {label}: grid {shape['grid']} of {shape['rows']} "
                  f"x {shape['cols']} tiles, {shape['thread_tile'][0]} x "
                  f"{shape['thread_tile'][1]} a thread, as the mirror says")
            outs[name] = out
            if label == "batched DFT":
                with SmiSamples() as smi:
                    ms = time_graph([lambda: kern(*planes, *corrs[name])],
                                    replays=20)
            else:
                ms = time_graph([lambda: kern(*planes, *corrs[name])])
            plain_ms = time_graph([lambda: plain(*planes, *corrs[name])],
                                  reps=2, replays=2)
            nbytes = 4 * (2 * m * k + 2 * k * n + 2 * m * n
                          + sum(t.numel() for t in corrs[name]))
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flop * m * n * k / FP32_OPS_PER_S * 1e3
            bound = max(t_bytes, t_ops)
            floor = slots * m * n * k / FP32_SLOTS_PER_S * 1e3
            row = dict(shape=(m, k, n), ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bound, t_bytes=t_bytes,
                       t_ops=t_ops, slot_floor_ms=floor,
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       max_abs_err=err, grid=shape["grid"],
                       tile=(shape["rows"], shape["cols"]))
            rows[name].append(row)
            print(f"    {name} {label:11s} m={m:4d} k={k:4d} n={n:4d}  "
                  f"{ms:.4f} ms | plain {plain_ms:.4f} ms | torch.matmul "
                  f"complex64 (no TF32) {lib_ms:.4f} ms | bound {bound:.4f} "
                  f"ms ({row['bound_by']}, {flop} FLOP a term) | "
                  f"{bound / ms:.1%} of bound | slot floor {floor:.4f} ms "
                  f"({slots} slots a term) | {floor / ms:.1%} of floor",
                  flush=True)
            if label == "batched DFT":
                print(f"      {smi}", flush=True)
        diff = max((p - q).abs().max().item()
                   for p, q in zip(outs["K5"], outs["K6"]))
        check(diff <= 2 * tol, f"{label}: K5 vs K6 max|diff| {diff:.3e} <= "
                               f"{2 * tol:.3e}")
    return rows


def dft_path_phase(dev, z, w):
    """The batched-DFT path as a user drives it: ops.cpm3_matmul and
    ops.cpm4_matmul of the numpy signals Z by W = dft_matrix(1024) on the
    card.  One K5 and one K6 launch, nothing else; both spectra within the
    f32 bound of torch.fft.fft; ComplexSquareTransform's S_k = -N on the
    card, and one signal through it against the FFT; then a trace of a few
    calls for where the time goes."""
    print(f"DFT path: ops.cpm3_matmul / ops.cpm4_matmul of {DFT_SIGNALS} "
          f"numpy signals (seed 0) x dft_matrix({DFT_POINTS}) on "
          f"{w.device}", flush=True)
    for f in (ops.cpm3_matmul, ops.cpm4_matmul):          # warm-up
        f(z[:64], w)
    torch.cuda.synchronize()
    reset_counts()                      # counts of this path's run only
    outs, walls, steps = {}, {}, []
    for name in CPM:
        f = getattr(ops, CPM[name][3])
        t0 = time.perf_counter()
        outs[name] = f(z, w)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        steps.append(kernel_counts())
    total = kernel_counts()
    check(steps[0] == {**{k: 0 for k in total}, "K5": 1}
          and total == {**{k: 0 for k in total}, "K5": 1, "K6": 1}
          and dict(cpm3_matmul_k5.shapes) == dict(cpm4_matmul_k6.shapes)
          == {(DFT_SIGNALS, DFT_POINTS, DFT_POINTS): 1},
          f"main path: one K5 launch for ops.cpm3_matmul, one K6 for "
          f"ops.cpm4_matmul, no other kernel: {steps}")
    zt = torch.as_tensor(z, device=dev)
    ref = torch.fft.fft(zt, dim=-1)
    tol = cpm_tol((zt.real, zt.imag, w.real, w.imag), DFT_POINTS)
    for name, (re, im) in outs.items():
        err = max((re - ref.real).abs().max().item(),
                  (im - ref.imag).abs().max().item())
        check(re.device == im.device == zt.device
              and re.shape == im.shape == ref.shape
              and bool(torch.isfinite(re).all() & torch.isfinite(im).all())
              and err <= tol,
              f"{CPM[name][3]}: spectra {tuple(re.shape)} on {re.device} vs "
              f"torch.fft.fft max|diff| {err:.3e} <= {tol:.3e}; one eager "
              f"call {walls[name] * 1e3:.2f} ms of host wall")
    eng = transforms.ComplexSquareTransform(w, mode="cpm4")
    check(eng.sk.device == w.device and torch.allclose(
        eng.sk, torch.full_like(eng.sk, -DFT_POINTS), rtol=1e-4, atol=0),
        f"ComplexSquareTransform(dft_matrix({DFT_POINTS}), cpm4).sk == "
        f"-{DFT_POINTS} at rtol 1e-4 on {eng.sk.device}: max|sk + N| "
        f"{(eng.sk + DFT_POINTS).abs().max().item():.3e}")
    tol1 = cpm_tol((zt[0].real, zt[0].imag, w.real, w.imag), DFT_POINTS)
    for mode in ("cpm4", "cpm3"):
        eng = transforms.ComplexSquareTransform(w, mode=mode)
        out = eng(zt[0])
        err = (out - ref[0]).abs().max().item()
        check(out.device == w.device and err <= tol1,
              f"one signal through ComplexSquareTransform({mode}) on "
              f"{out.device}: vs torch.fft.fft max|diff| {err:.3e} <= "
              f"{tol1:.3e}")
    trace_steps(lambda: ops.cpm3_matmul(z, w),
                "batched-DFT calls (ops.cpm3_matmul, numpy Z)", walls["K5"])
    return total


# ---------------------------------------------------------------- main
def kernel_line(k1_rows, k2_rows, k3_rows, k4_row, k7_rows, k8_rows,
                cpm_rows, launches):
    """The kernels line.  ``launches``: {kernel: {path: count}} read after
    each path's run.  K1's and K4's times are per decode step of the paged
    engine, K2's per paged prefill chunk, K3's per dense decode step, K7's
    per pass over the six fused ResNet-50 layers, K8's per pass over the
    three FIR streams, and K5's and K6's per batched DFT; each sums its
    kernel's launches of that unit from the shape tables above."""
    decode = [r for r in k1_rows if r["m"] == 8 and "ms" in r]

    def per_step(rows, mult, key):
        return sum(mult(r) * r[key] for r in rows)

    def entry(key, name, line, rows, mult, per,
              source="src/repro_torch/csrc/sq_matmul.cu"):
        t_bytes = per_step(rows, mult, "t_bytes")
        t_ops = per_step(rows, mult, "t_ops")
        return {"name": name, "route": "cuda", "source": source,
                "replaces": f"src/repro/kernels/{line}",
                "launches": sum(launches[key].values()),
                "launches_by_path": launches[key],
                # over every shape compared, not only the timed ones
                "max_abs_err": max(r["max_abs_err"] for r in all_rows[key]),
                "ms": per_step(rows, mult, "ms"),
                "plain_ms": per_step(rows, mult, "plain_ms"),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": per_step(rows, mult, "library_ms"), "per": per}

    all_rows = {"K1": k1_rows, "K2": k2_rows, "K3": k3_rows,
                "K7": k7_rows, "K8": k8_rows, **cpm_rows}
    k1 = entry("K1", "sq_matmul (K1)", "sq_matmul.py:92", decode,
               lambda r: K1_PER_STEP[(r["k"], r["n"])],
               "one paged decode step: 85 GEMMs at m=8")
    k1["k2_nb1_ms"] = per_step(decode, lambda r: K1_PER_STEP[
        (r["k"], r["n"])], "k2_ms")
    k2 = entry("K2", "sq_matmul_batched (K2)", "sq_matmul.py:117",
               [r for r in k2_rows if r["shape"] in UNIT_SHAPES["K2"]],
               lambda r: LAYERS,
               "one paged prefill chunk: 24 launches at B=12 m=32")
    k3_unit = [r for r in k3_rows if r["shape"] in UNIT_SHAPES["K3"]]
    k3 = entry("K3", "sq_matmul_folded (K3)", "sq_matmul.py:179", k3_unit,
               lambda r: LAYERS,
               "one dense decode step: 24 launches at B=48 m=1")
    k3["k2_ms"] = per_step(k3_unit, lambda r: LAYERS, "k2_ms")
    for kern, rows in ((k2, k2_rows), (k3, k3_rows)):
        kern["grids"] = {str(r["shape"]): r["grid"] for r in rows}
    k4 = {"name": "sq_paged_attn (K4)", "route": "cuda",
          "source": "src/repro_torch/csrc/sq_paged_attn.cu",
          "replaces": "src/repro/kernels/sq_paged_attn.py:62",
          "launches": sum(launches["K4"].values()),
          "launches_by_path": launches["K4"],
          "max_abs_err": k4_row["max_abs_err"],
          "ms": 12 * k4_row["ms"], "plain_ms": 12 * k4_row["plain_ms"],
          "bound_ms": 12 * k4_row["bound_ms"], "bound_by": k4_row["bound_by"],
          "library_ms": 12 * k4_row["library_ms"],
          "per": "one paged decode step: 12 launches at B=8 T=128",
          "splits": k4_row["splits"], "long_table": k4_row["long"]}
    k7 = entry("K7", "sq_conv2d (K7)", "sq_conv2d.py:68",
               [r for r in k7_rows if "ms" in r], lambda r: 1,
               "one pass over the six fused ResNet-50 layers at batch 8",
               source="src/repro_torch/csrc/sq_conv2d.cu")
    k8 = entry("K8", "sq_conv (K8)", "sq_conv.py:50",
               [r for r in k8_rows if "ms" in r], lambda r: 1,
               "one pass over the three FIR streams: L=2^20 at 16, 127 "
               "and 255 taps", source="src/repro_torch/csrc/sq_conv.cu")
    dft = (DFT_SIGNALS, DFT_POINTS, DFT_POINTS)
    k5, k6 = (entry(key, f"{CPM[key][3]} ({key})", f"{CPM[key][3]}.py:{line}",
                    [r for r in cpm_rows[key] if r["shape"] == dft],
                    lambda r: 1, f"one batched DFT: {DFT_SIGNALS} signals "
                    f"of {DFT_POINTS} points, one launch",
                    source=f"src/repro_torch/csrc/{CPM[key][3]}.cu")
              for key, line in (("K5", 66), ("K6", 55)))
    for kern, key in ((k5, "K5"), (k6, "K6")):
        row = next(r for r in cpm_rows[key] if r["shape"] == dft)
        kern.update(grid=row["grid"], tile=row["tile"])
    return json.dumps({"kernels": [k1, k2, k3, k4, k5, k6, k7, k8]})


def run(dev) -> str:
    """Every phase after the build; returns the kernels line."""
    gen = torch.Generator().manual_seed(0)
    prompt_lens = [len(r.tokens) for r in make_requests(
        serve_cfg(), N_REQUESTS, seed=0)]
    print(f"launcher prompts (seed 0): {prompt_lens} tokens", flush=True)
    cases = batched_cases(prompt_lens)
    k1_rows = k1_phase(dev, gen, k1_cases(prompt_lens))
    k2_rows = batched_phase(dev, gen, "K2", cases["K2"])
    k3_rows = batched_phase(dev, gen, "K3", cases["K3"])
    k4_row = k4_phase(dev, gen)
    k7_rows = k7_phase(dev, gen)
    k8_rows = k8_phase(dev, gen)
    z, w = dft_signals(), transforms.dft_matrix(DFT_POINTS, device=dev)
    cpm_rows = cpm_phase(dev, gen, z, w)
    compared = {"K1": [(r["m"], r["k"], r["n"]) for r in k1_rows],
                "K2": cases["K2"], "K3": cases["K3"]}
    plain = engine_phase(dev, compared)
    k1_total, k4_total = plain["K1"], plain["K4"]
    launcher = launcher_phase(dev, compared, plain)
    graph = graph_engine_phase(dev, compared, plain)
    model = build_model(serve_cfg(policy=None), device=dev, seed=0)
    none = engine_none_phase(model, dev, compared)
    dense = server_phase(model, dev, compared)
    dense_graph = dense_graph_phase(model, dev, compared, dense)
    conv = conv_path_phase(dev, gen)
    fir = fir_path_phase(dev)
    dft = dft_path_phase(dev, z, w)
    fault_phase(dev)
    fault_phase(dev, jit=True)
    guard_phase(dev)
    compiled_guard_phase(dev, plain)
    launches = {"K1": {"engine_square_gemms": k1_total,
                       "launcher": launcher["K1"],
                       "engine_graph": graph["K1"],
                       "engine_no_policy": none["K1"],
                       "server_no_policy": dense["K1"],
                       "server_graph": dense_graph["K1"],
                       "conv_path": conv["K1"]},
                "K2": {"engine_no_policy": none["K2"],
                       "server_no_policy": dense["K2"],
                       "server_graph": dense_graph["K2"]},
                "K3": {"server_no_policy": dense["K3"],
                       "server_graph": dense_graph["K3"]},
                "K4": {"engine_square_gemms": k4_total,
                       "launcher": launcher["K4"],
                       "engine_graph": graph["K4"],
                       "engine_no_policy": none["K4"]},
                "K7": {"conv_path": conv["K7"]},
                "K5": {"dft_path": dft["K5"]},
                "K6": {"dft_path": dft["K6"]},
                "K8": {"fir_path": fir["K8"]}}
    dense_k1 = sum(K1_PER_STEP[(r["k"], r["n"])] * r["ms"] for r in k1_rows
                   if r["m"] == DENSE_BATCH and "ms" in r)
    dense_k3 = sum(LAYERS * r["ms"] for r in k3_rows if r["shape"][1] == 1)
    print(f"dense decode step in graph replay: K1 85 launches at "
          f"m={DENSE_BATCH} {dense_k1:.3f} ms, K3 24 launches "
          f"{dense_k3:.3f} ms", flush=True)
    return kernel_line(k1_rows, k2_rows, k3_rows, k4_row, k7_rows, k8_rows,
                       cpm_rows, launches)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    global CARD
    CARD = smi
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    reports = build.build()
    print(f"built {sorted(reports) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s (one nvcc per source, "
          f"concurrently)", flush=True)
    for name, out in reports.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")

    print(run(dev), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
