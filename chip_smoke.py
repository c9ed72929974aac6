"""Smoke run of the PyTorch port on one NVIDIA GPU: builds the hand-written
CUDA kernels from the sources in this checkout, holds each against its
plain PyTorch version at the serving shapes, then serves the full-width
fairsquare-demo model (square_pallas, square_gemms policy, prepared
weights, bf16) through the paged engine, checks that its GEMMs ran on K1
(at shapes held to the plain version) and its decode attention on K4, and
traces a few decode ticks with torch.profiler for the device-busy share.

    python3 chip_smoke.py

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repo.  Its last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``;
the line before it lists the kernels with their launches on the main path,
their times, their plain versions' times, their bounds and a library
call's time.  Times are CUDA-graph replays (no host gaps) with the
weights cycled through enough copies to defeat the 50 MB L2, as the decode
path finds them.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.configs.base import SQUARE_GEMMS_POLICY        # noqa: E402
from repro_torch.kernels import build, routing                  # noqa: E402
from repro_torch.kernels.sq_matmul import (                     # noqa: E402
    sq_matmul_k1, sq_matmul_plain)
from repro_torch.kernels.sq_paged_attn import (                 # noqa: E402
    sq_paged_attn_k4, sq_paged_attn_plain)
from repro_torch.launch.serve import make_requests              # noqa: E402
from repro_torch.models.attention import EMPTY_POS              # noqa: E402
from repro_torch.models.lm import LM, build_model               # noqa: E402
from repro_torch.serve.engine import (                          # noqa: E402
    Engine, EngineConfig, RequestStatus)

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and the CUDA-core FP32 rate
# outside the tensor cores.  The squares run on the CUDA cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
L2_DEFEAT_BYTES = 200 * 2 ** 20

# The serving geometry of launch/serve.py.
SLOTS, BLOCK, BLOCKS, BLOCKS_PER_SEQ, CHUNK = 8, 16, 64, 8, 32
N_REQUESTS, MAX_NEW = 8, 16
# GEMMs per layer: wq, wk, wv, wo (d x d), w_gate, w_up (d x ff), w_down
# (ff x d); plus the tied logits once per forward.
GEMMS_PER_LAYER = 7

K1_SHAPES = [(768, 768), (768, 3072), (3072, 768), (768, 32000)]
# (m, k, n) compared with the plain version: decode's 8 rows and a prefill
# chunk's 32 at every (k, n), and the single row of a request's first-token
# logits (ragged against the kernel's 8-row tile).  The engine phase checks
# that it launched K1 at no other shape.
K1_CASES = ([(8, k, n) for k, n in K1_SHAPES]
            + [(32, k, n) for k, n in K1_SHAPES] + [(1, 768, 32000)])
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
def k1_phase(dev, gen):
    """K1 against its plain version at the main-path shapes."""
    print("K1 sq_matmul vs plain (f32 from bf16 inputs: |err| <= "
          "k * 2^-23 * (max|a| + max|b|)^2; int8: exact)", flush=True)
    rows = []
    for m, k, n in K1_CASES:
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

        nc = copies_for(k * n * 4)
        bws = [bw.clone() for _ in range(nc)]
        sbs = [sb.clone() for _ in range(nc)]
        ms = time_graph([lambda i=i: sq_matmul_k1(aw, bws[i], sa, sbs[i])
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
        row = dict(m=m, k=k, n=n, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound, t_bytes=t_bytes,
                   t_ops=t_ops,
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   max_abs_err=err)
        rows.append(row)
        print(f"    m={m:2d} k={k:4d} n={n:5d}  K1 {ms:.4f} ms | plain "
              f"{plain_ms:.4f} ms | torch.matmul {lib_ms:.4f} ms | bound "
              f"{bound:.4f} ms ({row['bound_by']}) | "
              f"{bound / ms:.1%} of bound", flush=True)
        del bws, sbs
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


def k4_phase(dev, gen):
    print("K4 sq_paged_attn vs plain (B=8 S=1 KV=12 G=1 hd=64 bs=16 nb=8, "
          "bf16 pools; |err| <= 1e-4)", flush=True)
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

    # timing at the decode shape: full tables, 12 pool copies (one per layer)
    B, KV, G, hd, S = 8, 12, 1, 64, 1
    q, kps, vps, tables, pos_pool, q_pos = k4_inputs(dev, gen, pools=12)
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
    live_blocks = int((tables != 0).sum().item())
    t_live = live_blocks * BLOCK
    nbytes = (2 * t_live * KV * hd * 2 + t_live * 4 + 2 * B * S * KV * G * hd * 4
              + tables.numel() * 4 + q_pos.numel() * 4)
    ops = 2 * 2 * t_live * S * KV * G * hd
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, \
        ops / FP32_OPS_PER_S * 1e3
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               max_abs_err=worst, T=T)
    print(f"    decode B=8 T={T}: K4 {ms:.4f} ms | plain {plain_ms:.4f} ms | "
          f"SDPA on the gathered window {lib_ms:.4f} ms | bound "
          f"{row['bound_ms']:.5f} ms ({row['bound_by']})", flush=True)
    return row


# -------------------------------------------------------------- engine
def serve_cfg():
    cfg = get_config("fairsquare-demo")
    return dataclasses.replace(cfg, matmul_mode="square_pallas",
                               contraction_policy=SQUARE_GEMMS_POLICY)


def engine_cfg(max_new=MAX_NEW):
    return EngineConfig(max_slots=SLOTS, block_size=BLOCK, num_blocks=BLOCKS,
                        blocks_per_seq=BLOCKS_PER_SEQ, prefill_chunk=CHUNK,
                        max_new_tokens=max_new, prepared=True)


def reset_counts():
    sq_matmul_k1.launches = 0
    sq_matmul_k1.shapes.clear()
    sq_paged_attn_k4.launches = 0
    routing.select_matmul_route.taken.clear()
    routing.select_paged_attn_route.taken.clear()


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
    ticks = []
    t0 = time.perf_counter()
    pending = True
    while pending:
        m = eng.metrics
        before = (sq_matmul_k1.launches, sq_paged_attn_k4.launches,
                  m.decode_steps, m.prefill_chunks, m.first_tokens)
        t_tick = time.perf_counter()
        pending = eng.step()            # ends on the sampled tokens' copy
        t_tick = time.perf_counter() - t_tick
        ticks.append(tuple(a - b for a, b in zip(
            (sq_matmul_k1.launches, sq_paged_attn_k4.launches,
             m.decode_steps, m.prefill_chunks, m.first_tokens), before))
            + (t_tick,))
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
    per_step = (L * GEMMS_PER_LAYER + 1, L)
    bad = [t for t in ticks
           if t[0] != per_step[0] * t[2] + L * GEMMS_PER_LAYER * t[3] + t[4]
           or t[1] != per_step[1] * t[2]]
    decode_only = [t for t in ticks if t[2] and not t[3]]
    check(not bad and decode_only,
          f"every tick: K1 +{per_step[0]} and K4 +{per_step[1]} per decode "
          f"step (K1 +{L * GEMMS_PER_LAYER} per prefill chunk, +1 per first "
          f"token); {len(decode_only)} decode-only ticks")
    check(set(shapes) <= set(compared),
          f"K1 ran only at shapes held to its plain version above: "
          f"{sorted(shapes.items())}")
    check(taken.get("virtual", 0) == 0,
          f"no matmul took the virtual route (routes taken: {taken}; paged "
          f"attention: {attn_taken})")
    check(k1_total == per_step[0] * m.decode_steps
          + L * GEMMS_PER_LAYER * m.prefill_chunks + m.first_tokens
          and k4_total == L * m.decode_steps,
          f"main path: K1 {k1_total} launches, K4 {k4_total} launches over "
          f"{m.decode_steps} decode steps, {m.prefill_chunks} prefill chunks")
    walls = sorted(t[5] for t in decode_only)
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
    return k1_total, k4_total, m


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


def trace_phase(model: LM, dev, untraced_tick_s: float) -> None:
    """torch.profiler trace of a few decode-only ticks of a fresh engine
    (same requests): the device-busy share of the ticks' wall, and K1's,
    K4's and the other device work's time inside the engine.  Profiling
    slows the host, so the busy share it reads is a lower bound for the
    untraced run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    eng = Engine(model, engine_cfg(), device=dev)
    eng.submit(make_requests(model.cfg, N_REQUESTS, seed=0))
    while eng.metrics.first_tokens < N_REQUESTS:
        if not eng.step():
            raise SmokeFailure("trace engine ended before every request "
                               "had its first token")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_TICKS):
            with record_function("decode_tick"):
                eng.step()
        torch.cuda.synchronize()
    evs = prof.events()
    # record_function also leaves a device-side annotation of the same name
    ticks = [e.time_range for e in evs
             if e.name == "decode_tick" and e.device_type == DeviceType.CPU]
    device = [e for e in evs if e.device_type == DeviceType.CUDA
              and e.name != "decode_tick"]
    wall_us = sum(t.end - t.start for t in ticks)
    print(f"  trace of {len(ticks)} decode-only ticks (torch.profiler): "
          f"{wall_us / len(ticks) / 1e3:.2f} ms wall per tick traced, "
          f"{untraced_tick_s * 1e3:.2f} ms untraced", flush=True)
    if not device:
        print("  trace: no device events recorded; device-busy share not "
              "measured", flush=True)
        return

    def dev_ms(pick):
        return sum(e.time_range.end - e.time_range.start
                   for e in device if pick(e.name)) / 1e3 / len(ticks)

    def is_k1(name):
        return "sq_matmul_kernel" in name

    def is_k4(name):
        return "sq_paged_attn_kernel" in name

    busy_us = _union_us((e.time_range.start, e.time_range.end)
                        for e in device)
    n_k1 = sum(is_k1(e.name) for e in device) / len(ticks)
    n_k4 = sum(is_k4(e.name) for e in device) / len(ticks)
    print(f"  trace per tick: {len(device) / len(ticks):.0f} device "
          f"operations, device busy {busy_us / len(ticks) / 1e3:.3f} ms = "
          f"{busy_us / wall_us:.1%} of the traced wall; K1 {n_k1:.0f} "
          f"launches {dev_ms(is_k1):.3f} ms, K4 {n_k4:.0f} launches "
          f"{dev_ms(is_k4):.3f} ms, other device work "
          f"{dev_ms(lambda n: not (is_k1(n) or is_k4(n))):.3f} ms",
          flush=True)


# ---------------------------------------------------------------- main
def kernel_line(k1_rows, k4_row, k1_total, k4_total):
    decode = [r for r in k1_rows if r["m"] == 8]

    def per_step(key):
        return sum(K1_PER_STEP[(r["k"], r["n"])] * r[key] for r in decode)

    t_bytes, t_ops = per_step("t_bytes"), per_step("t_ops")
    k1 = {"name": "sq_matmul (K1)", "route": "cuda",
          "source": "src/repro_torch/csrc/sq_matmul.cu",
          "replaces": "src/repro/kernels/sq_matmul.py:92",
          "launches": k1_total,
          "max_abs_err": max(r["max_abs_err"] for r in k1_rows),
          "ms": per_step("ms"), "plain_ms": per_step("plain_ms"),
          "bound_ms": max(t_bytes, t_ops),
          "bound_by": "bytes" if t_bytes >= t_ops else "operations",
          "library_ms": per_step("library_ms"),
          "per": "one decode step: 85 GEMMs at m=8"}
    k4 = {"name": "sq_paged_attn (K4)", "route": "cuda",
          "source": "src/repro_torch/csrc/sq_paged_attn.cu",
          "replaces": "src/repro/kernels/sq_paged_attn.py:62",
          "launches": k4_total, "max_abs_err": k4_row["max_abs_err"],
          "ms": 12 * k4_row["ms"], "plain_ms": 12 * k4_row["plain_ms"],
          "bound_ms": 12 * k4_row["bound_ms"], "bound_by": k4_row["bound_by"],
          "library_ms": 12 * k4_row["library_ms"],
          "per": "one decode step: 12 launches at B=8 T=128"}
    return json.dumps({"kernels": [k1, k4]})


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

    gen = torch.Generator().manual_seed(0)
    k1_rows = k1_phase(dev, gen)
    k4_row = k4_phase(dev, gen)
    k1_total, k4_total, _ = engine_phase(
        dev, [(r["m"], r["k"], r["n"]) for r in k1_rows])
    print(kernel_line(k1_rows, k4_row, k1_total, k4_total), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
