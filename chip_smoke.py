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

Last of all, training: K1 and K2 are held to their plain versions at
every shape of a full-width train step (forward, dL/dx and dL/dW; the
plain K1 in blocks of output rows) and timed beside torch.matmul /
torch.bmm and the FP32 slot floor; then ``repro_torch.launch.train``
trains fairsquare-demo at full width (square_pallas, bf16, remat
"block", 8 x 256 tokens, 4 steps, checkpoints every 2, metrics and
trace files), its step captured into one CUDA graph and replayed (the
launcher's default on CUDA): finite losses, every checkpoint restorable,
one capture, the first step's compiled audit equal to the analytic count
(fraction 1.0 forward and backward), K1/K2 only at held shapes and
(steps + captures) x 340 / 96 launches.  f32 losses over 3 steps against
standard, every K1/K2 launch of a step against the exact product of its
operands, a captured and an eager fixed-seed run's fingerprints,
launches by forward / backward / recompute, the eager and the captured
step timed in turns (eager, graph, graph, eager) and each traced, the
capture's time, the state's copy into the graph's static inputs, the
compiled audit of a replayed step, and the compiled train guard (JAX's
saturating step under ``GuardedStep(jit=True)``: a probe trips, the
``.bwd_*`` keys demote, a re-capture, the standard route's gradients,
memory across a re-capture) follow.

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

Last, MoE serving: moonshot-v1-16b-a3b at its published width (d 2048,
16 heads of 128, 64 experts top-6, d_ff 1408, vocab 163840), 4 of its 48
layers (48 prepared layers do not fit the card; 4 keep the smoke inside
its time limit), bf16, prepared, weights
from seed 0 drawn on the device, in the paged engine under the
square_gemms policy. K1 is held
to its plain version at the router's, the attention projections' and the
logits' shapes, K2 at the two expert shapes (64, 4, 2048) @ (64, 2048,
1408) and (64, 4, 1408) @ (64, 1408, 2048) with the prepared expert stack
equal to its raw source bit for bit, each timed with its weights cycled
past the L2. The engine serves the launcher's 8 requests eagerly and with
its three model calls captured: every request COMPLETED, the same tokens,
per tick the K1/K2/K4 launches the routing rules give (by counter, by the
capture ledger and in a profiled replay), the eager and the compiled audit
equal to the analytic count site by site, ``moe_apply_local`` free of host
syncs, eager and compiled runs timed in turns, and each layer's MoE held to
``standard`` teacher-forced (an expert swap only inside the router's
rounding bound).

Last, MoE training: the same model at its published width, 2 of its 48
layers (a captured step holds ~32 B a parameter: the caller's state, the
graph's static inputs, its new state and the gradients; 2 keep the smoke
inside its time limit), bf16, remat
"block", 8 x 256 tokens, square_pallas with no policy. K1 is held to its
plain version at the router's three GEMMs of a step and K2 at the expert
GEMMs' four shapes (forward and dL/dx, and dL/dW over the C = 244 slots),
each timed beside torch.matmul / torch.bmm, the bound and the FP32 slot
floor. In f32 at 2 layers: one step's gradients of the loss x 2^14 against
standard run on square_pallas's routing (every site square within 1e-1,
the loss's vocab GEMM on standard within 1e-2; each layer's swapped
experts reported with their margins) with every K1/K2 launch held to its
exact product, and 3 steps' losses against standard's. In bf16 at 3
layers: launches by forward, backward and recompute equal to the routing
rules' (by counter, capture ledger and a profiled replay), an eager step
under ``set_sync_debug_mode("error")`` whose audit is the analytic count,
one layer's MoE backward eager twice and captured bit for bit, a captured
and an eager fixed-seed 2-step run's fingerprints, eager and captured
steps timed in turns and traced (K1, K2, the dispatch's ops, AdamW apart),
the compiled audit of a replay, ``GuardedStep(jit=True)`` clean and the
``Trainer`` over the captured step with its first-step audit (no
checkpoint on the card). The training phases before it also run the
captured launcher configuration 32 steps in square_pallas and in
standard and print the loss gap at every step.

Last of all, in a process of its own (a fresh CUDA context and profiler),
recurrent serving: recurrentgemma-2b
(RG-LRU + local attention) and xlstm-350m (mLSTM + sLSTM) at their
published width, recurrentgemma at 3 of its 26 layers and xlstm at 8 of
its 24 (each its first period; cut for the smoke's time limit), bf16,
prepared, square_pallas with every contraction square. K1 and K2/K3 are
held to their plain versions at a dense decode step's shapes and timed;
the launcher without ``--legacy`` falls back to the dense Server with the
JAX launcher's note and serves
the 8 requests compiled, and the phase serves the model it built (its
weights drawn from seed 0 on the host, the launcher's ``--layers`` cut)
after it; a warm-up Server run
holds the first launch at each shape of the path to the plain version on
its own operands and gives the launcher's tokens; then the Server eager
and with its decode step captured, twice:
the same tokens, one capture, K1/K2/K3 a decode step and a prefill as the
routing rules give them (by counter, capture ledger and a profiled
replay), the eager and compiled audits equal to ``recurrent_audit``
(fraction 1.0); eager and replayed runs in turns, traced, with the device
time by operator and the raw ``mix`` weights' per-call preparation timed;
decode-step logits against standard (bf16), and in f32 teacher-forced layer
by layer with every launch against its exact product; a 1024-token prompt
(bf16 prefill wall; f32 prefill + decode against the forward, standard at
the JAX contract and square_pallas against standard; xlstm's mLSTM chunked
= sequential).

Last, in a process of its own too, recurrent training: recurrentgemma-2b
at its published width and 3 of its 26 layers (its first period; the
whole step does not fit the card) and xlstm-350m at its first
(mlstm x 7, slstm) period, 8 of its 24 layers, bf16,
remat "block", square_pallas with no policy, 2048 tokens a step, weights
from seed 0 drawn on the device.  K1/K2 at every training shape against
their plain versions (past k = 32768 K1 against its own order of
summation, with both against the exact product), timed beside
torch.matmul / torch.bmm; f32 against standard (3 steps' losses, every
launch of a step against its exact product, recurrentgemma's gradients at
one period with the loss's vocab GEMM on standard, xlstm's blocks alone
teacher-forced, each tensor past its gate held to it in a witness run
with the site that sets its gap on standard, beside the bf16 control);
launches by
forward and by step against ``recurrent_train_launches``, an eager step
free of host syncs whose audit is ``recurrent_train_audit`` and whose
first launch at each shape is held to its plain version; a captured and
an eager fixed-seed 2-step run bit for bit; the capture's time, nodes and
pool; eager and replayed steps timed and traced; the compiled audit; the
``Trainer`` over the captured step; ``GuardedStep(jit=True)``; the
launcher for each arch at its first period, compiled,
with its final checkpoint in a fresh directory.

Last, in a process of its own too, encoder-decoder serving:
whisper-large-v3 at its published width, 4 of its 32 encoder layers over
1500 frames and 4 of its 32 ``xdec`` layers (d 1280, 20 heads of 64,
d_ff 5120 gelu, vocab 51866), bf16, prepared, square_pallas with every
contraction square, as the recurrent phase serves its archs: K1 and K2/K3
at a decode step's shapes (the cross-attention's (80, 1, 64) @ (80, 64,
1500) and back) and at the prefill's encoder and cross K/V shapes (K1 at
m = 1500, K2 on (20, 1500, 64) @ (20, 64, 1024) and back) held to their
plain versions and timed; the launcher's fallback, its 8 requests with
their frames, its model served after it; a warm-up Server run probing
every first launch; the Server eager and captured, twice (4 inserts
after the capture replace a slot's encoder K/V in the cache the graph
reads), by counter, ledger and a profiled replay, the audits equal to
``encdec_audit``; turns and traces, TTFT and the cross K/V's f32
widening; decode-step logits against standard (bf16); in f32
teacher-forced, every encoder and decoder layer against standard with
every launch against its exact product, and the encoder's output and the
decode-step logits end to end.

Last, each in a process of its own too, the prefix-token and the
encoder-decoder inputs.  paligemma-3b served at its published
width (6 of its 18 layers, SERVE_LAYERS; d 2048, 8 query heads of 256 over
1 KV head, GeGLU d_ff 16384, vocab 257216, 256 prefix patches), its weights
drawn on the device from seed 0, bf16, prepared, no policy: K1 and K2 at
a decode step's and a prefill's shapes against their plain versions and
timed; the launcher's fallback (cache_len 128, its prefills rolled into
the ring) held to the eager Server at that length; the Server at a
cache_len that holds the whole sequence (320), eager (every first launch
held to K1's own order) and captured, twice, by counter, ledger and a
profiled replay, the audits equal to ``recurrent_audit`` over P + S
positions; turns, traces, TTFT; in f32 teacher-forced every layer
against standard (with a witness site, LAYER_WITNESS_NOTE) and the
decode-step logits end to end; the bf16 decode-step logits against
standard.  Then paligemma-3b trained at 2 of its 18 layers over 2 x (256
patches + 256 tokens), and whisper-large-v3 at 2 + 2 layers over 2 x 128
tokens and 2 x 1500 frames, as the recurrent training phase trains its
archs (the loss's vocab GEMM over the text positions only; the launches
held to K1's own order; the f32 parity at 1 (1 + 1) layer with its witness, its
catch and, for whisper, the cross-attention's key bias held beside its
weight, GRAD_ZERO_NOTE, and its 3 steps with the elements whose AdamW
first moment differs in sign held to standard's,
TRAJECTORY_WITNESS_NOTE), each with its launcher.

Last, each in a process of its own, the launch planner
(``kernels/tuning.py``: model mode equal to every kernel's launch rule,
K1 = K2 = K3 bit for bit under every tile, every plan variant of K1-K7 at
the kernel phases' shapes held to its plain version and timed into a
scratch cache, the cache served, a route override that moves a launch,
``REPRO_AUTOTUNE=0``) and the attention options: deepseek-7b at its
published width and 2 of its 30 layers, an 8192-token prefill under the
base schedule, ``block_skip``, ``fold_q`` and ``p_bf16`` and a 4096-token
train step under base and ``block_skip``, their K2 launches by counter and
profiler and their audits equal to each schedule's analytic count.

Last, the devices and the roofline.  The replayed dense decode tick, the
captured train step and deepseek-7b's base prefill are dry-run on
``meta`` (``launch/dryrun.py``) under the op-level analyzer, in a process
of its own beside the next phase (it runs nothing on the card): their
K1-K4 launches equal the counters of the measured runs, their square
terms the audit's multiplies, their dot FLOPs twice those, and every
measured wall is at or above its floor against the H100's datasheet
peaks (each share printed).  Then two gloo ranks share the one card
(NCCL takes a GPU a rank), each a process of its own: ``dense_tp_reduce``
at the FFN's down-projection runs K1 on each rank's K-shard within K1's
f32 bound, a 2-rank data-parallel bf16 train step equals the 1-rank step
on the whole batch within 2e-3, and the captured step under the mesh is
refused.

    python3 chip_smoke.py
    python3 chip_smoke.py --autotune FILE      # a tuning cache, the card's
    python3 chip_smoke.py --crossovers FILE    # the route rules' sweeps

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
import contextlib
import copy
import dataclasses
import gc
import io
import itertools
import json
import math
import os
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
from repro_torch.core import cost_model                         # noqa: E402
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
from repro_torch.core.tree import tree_leaves, tree_map         # noqa: E402
from repro_torch.kernels import ops                             # noqa: E402
from repro_torch.kernels import tuning                          # noqa: E402
from repro_torch.kernels import cpm3_matmul, cpm4_matmul        # noqa: E402
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
from repro_torch.layers import basic                            # noqa: E402
from repro_torch.launch.serve import make_requests              # noqa: E402
from repro_torch.models import attention as attn_mod            # noqa: E402
from repro_torch.models import blocks as blk                    # noqa: E402
from repro_torch.models.attention import EMPTY_POS              # noqa: E402
from repro_torch.models.lm import (                             # noqa: E402
    LM, build_model, decoder_kinds)
from repro_torch.models.moe import (                            # noqa: E402
    moe_apply_local, moe_capacity, moe_dispatch, moe_route)
from repro_torch.obs import check as obs_check                  # noqa: E402
from repro_torch.obs import trace as obs_trace                  # noqa: E402
from repro_torch.serve.faults import FaultInjector, FaultPlan   # noqa: E402
from repro_torch.serve.engine import (                          # noqa: E402
    Engine, EngineConfig, RequestStatus)
from repro_torch.serve.server import (                          # noqa: E402
    Request, ServeConfig, Server, request_batch, write_slot)

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
# idle host time inside each profiler window, before the traced work and
# after its last synchronisation (see padded_profile)
TRACE_PAD_S = 0.2


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    print(f"  [{'ok' if cond else 'FAIL'}] {what}", flush=True)
    if not cond:
        raise SmokeFailure(what)


# mean device ms of one call over CUDA-graph replays (kernels/tuning.py)
time_graph = tuning.time_graph


def k1_planned(m: int, n: int, k: int) -> dict:
    """K1's launch of an f32 (m, k) @ (k, n) under the planner's plan (the
    cache's, or the model rule's)."""
    return k1_launch_shape(m, n, tuning.plan_matmul(m, n, k).rows)


def batched_planned(name: str, nb: int, m: int, n: int, k: int) -> dict:
    """K2's or K3's launch under the planner's plan."""
    plan = tuning.plan_matmul(m, n, k, batch=nb, kind=PLAN_KIND[name])
    return k2_launch_shape(nb, m, n, plan.rows, plan.cols)


def cpm_planned(name: str, m: int, n: int, k: int) -> dict:
    """K5's or K6's launch under the planner's thread tile."""
    plan = tuning.plan_cpm(PLAN_KIND[name], m, n, k)
    own = cpm3_matmul.K5_TILE if name == "K5" else cpm4_matmul.K6_TILE
    return cpm3_matmul.cpm_launch_shape(m, n, own, plan.thread_tile)


PLAN_KIND = {"K1": "sq_matmul", "K2": "sq_matmul_batched",
             "K3": "sq_matmul_folded", "K4": "sq_paged_attn",
             "K5": "cpm3_matmul", "K6": "cpm4_matmul", "K7": "sq_conv2d"}


def copies_for(nbytes: int) -> int:
    return max(2, min(64, math.ceil(L2_DEFEAT_BYTES / max(1, nbytes))))


# ------------------------------------------------------------------ K1
def k1_phase(dev, gen, cases, per_step=None, step_rows=(8, DENSE_BATCH),
             unit="decode step"):
    """K1 against its plain version at the main-path shapes, and bit for
    bit against K2 at nb = 1 and K3 on the same operands; each timed row
    also times K2 at nb = 1.  ``per_step``: the launches of each (k, n) in
    one ``unit`` (default: fairsquare-demo's decode step), summed for each
    m of ``step_rows``."""
    per_step = per_step or K1_PER_STEP
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
        shape = k1_planned(m, n, k)
        print(f"    m={m:2d} k={k:4d} n={n:5d}  K1 {ms:.4f} ms | K2 at nb=1 "
              f"{k2_ms:.4f} ms ({k2_ms / ms:.1f}x) | plain "
              f"{plain_ms:.4f} ms | torch.matmul {lib_ms:.4f} ms | bound "
              f"{bound:.4f} ms ({row['bound_by']}) | "
              f"{bound / ms:.1%} of bound | grid {shape['grid']} in "
              f"clusters of {shape['cluster']}, {shape['rows']}x"
              f"{shape['cols']} tiles, {shape['warps']} warps a block",
              flush=True)
        del bws, sbs
    for m in step_rows:
        step = {key: sum(per_step.get((r["k"], r["n"]), 0) * r[key]
                         for r in rows if r["m"] == m and "ms" in r)
                for key in ("ms", "k2_ms", "library_ms")}
        print(f"  per {unit} at m={m} ({sum(per_step.values())} GEMMs, "
              f"graph replay): K1 "
              f"{step['ms']:.4f} ms | K2 at nb=1 "
              f"{step['k2_ms']:.4f} ms ({step['k2_ms'] / step['ms']:.1f}x)"
              f" | torch.matmul {step['library_ms']:.4f} ms", flush=True)
    return rows


# -------------------------------------------------------------- K2, K3
BATCHED = {"K2": (sq_matmul_k2, k2_launch_shape),
           "K3": (sq_matmul_k3, k3_launch_shape)}


def batched_phase(dev, gen, name, cases, unit=None):
    """K2 or K3 against the batched plain version at every shape of the
    serving phases (f32 from bf16 inputs and int8), bit for bit against K1
    per element (K2) or against K2 (K3), and timed beside the plain version
    and torch.bmm (K3 also beside K2), each row with its grid; then the
    per-unit sums: K2 per paged prefill chunk, K3 per dense decode step
    (``unit``: (what, {(B, m, k, n): launches a unit}) for another unit).
    The operands are activations the caller has just written, so they are
    not cycled past the L2."""
    unit_name, per_unit = unit or (
        UNIT_NAMES[name], {shape: LAYERS for shape in UNIT_SHAPES[name]})
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
        shape = batched_planned(name, nb, m, n, k)
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
    unit = [r for r in rows if r["shape"] in per_unit]
    if not unit:
        return rows
    sums = {key: sum(per_unit[r["shape"]] * r[key] for r in unit)
            for key in ("ms", "library_ms", "bound_ms")}
    vs_k2 = (f" | K2 on the same operands "
             f"{sum(per_unit[r['shape']] * r['k2_ms'] for r in unit):.4f} ms"
             if name == "K3" else "")
    print(f"  per {unit_name} ({sum(per_unit[r['shape']] for r in unit)} "
          f"launches, graph replay): {name} {sums['ms']:.4f} ms | torch.bmm "
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
    return tuning.paged_attn_f64(q, kp, vp, tables, pos_pool, q_pos, BLOCK,
                                 window=window, softcap=softcap)


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
    splits = tuning.plan_paged_attn(
        B, S, KV, G, hd, nb, BLOCK, kps[0].dtype,
        sms=torch.cuda.get_device_properties(dev).multi_processor_count
    ).splits
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
    calls captured, K2 launches, K3 launches)."""
    ticks, pending = [], True

    def now():
        m = eng.metrics
        return (sq_matmul_k1.launches, sq_paged_attn_k4.launches,
                m.decode_steps, m.prefill_chunks, m.first_tokens,
                sq_matmul_k2.launches, sq_matmul_k3.launches)

    while pending:
        before = now()
        graphs0 = set(eng._graph_set.calls)
        t_tick = time.perf_counter()
        pending = eng.step()            # ends on the sampled tokens' copy
        t_tick = time.perf_counter() - t_tick
        d = tuple(a - b for a, b in zip(now(), before))
        ticks.append(d[:5] + (t_tick, frozenset(
            set(eng._graph_set.calls) - graphs0)) + d[5:])
    return ticks


def call_launches(L: int) -> dict:
    """{call: Counter(kernel: launches)} of the engine's model calls on
    fairsquare-demo's L layers under square_gemms: a decode step (K1 on
    every GEMM and the logits, K4 a layer), a prefill chunk (K1 on every
    GEMM) and one row's logits (K1)."""
    return {"_decode": collections.Counter(K1=L * GEMMS_PER_LAYER + 1, K4=L),
            "_chunk": collections.Counter(K1=L * GEMMS_PER_LAYER),
            "_logits_at": collections.Counter(K1=1)}


def warmup_launches(captured, L: int):
    """(K1, K4) launches of the warm-up calls of the model calls captured
    (each capture runs its call once eagerly first)."""
    per_call = call_launches(L)
    return tuple(sum(per_call[c][k] for c in captured) for k in ("K1", "K4"))


def tick_walls(ticks, L: int, per_call=None, what: str = "every tick"
               ) -> list:
    """Check every tick's K1/K2/K3/K4 launches against its decode steps,
    prefill chunks and first tokens (and, for a compiled engine, the
    warm-up call of each capture), by ``per_call`` (default:
    :func:`call_launches`); returns the sorted walls (s) of the
    decode-only ticks without a capture."""
    per_call = per_call or call_launches(L)
    index = {"K1": 0, "K4": 1, "K2": 7, "K3": 8}
    bad = []
    for t in ticks:
        for key, i in index.items():
            want = (per_call["_decode"][key] * t[2]
                    + per_call["_chunk"][key] * t[3]
                    + per_call["_logits_at"][key] * t[4]
                    + sum(per_call[c][key] for c in t[6]))
            if t[i] != want:
                bad.append((key, t[i], want, t[2:5], sorted(t[6])))
    decode_only = [t for t in ticks if t[2] and not t[3] and not t[6]]
    check(not bad and decode_only,
          f"{what}: each of {len(ticks)} ticks launches "
          f"{dict(per_call['_decode'])} a decode step, "
          f"{dict(per_call['_chunk'])} a prefill chunk, "
          f"{dict(per_call['_logits_at'])} a first token (each capture's "
          f"warm-up one call more); {len(decode_only)} decode-only ticks"
          + (f"; off: {bad[:3]}" if bad else ""))
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


@contextlib.contextmanager
def padded_profile(cpu: bool = True):
    """A torch.profiler window with TRACE_PAD_S of idle host time before
    the work it traces and after that work's last synchronisation.  The
    traces that lost CUPTI records on one H100 lost K1 kernels, which
    open a step, and never a K2, which come later: a recurrentgemma
    decode replay 198 of its 201 K1 in every try, with its 16 K2 all
    there; MoE train traces 1-3 of a step's 64 K1 (or 2 of 44), with
    every K2 there.  The profiler keeps only the device records that fall
    inside its window, so work at the window's edge falls outside it
    where the device's and the host's clocks disagree (``trace_steps``
    prints how far they do).  The pad keeps the work away from both
    edges."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        time.sleep(TRACE_PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)


# device kernels by name in a trace
TRACE_KERNELS = (("K1", "sq_matmul_cluster_kernel"),
                 ("K2", "sq_matmul_batched_kernel"),
                 ("K3", "sq_matmul_folded_kernel"),
                 ("K4", "sq_paged_attn_kernel"), ("K5", "Cpm3"),
                 ("K6", "Cpm4"))


def trace_steps(step, what: str, untraced_s: float,
                calls: int = TRACE_TICKS, host: bool = True) -> dict:
    """torch.profiler trace of ``calls`` calls of ``step``: the
    device-busy share of their wall, and each kernel's and the other
    device work's time per call.  Profiling slows the host, so the busy
    share it reads is a lower bound for the untraced run.  Returns the
    per-call device operations, busy ms, busy share and launches of each
    kernel (an empty dict when the trace recorded no device events).
    ``host=False`` leaves out the host's operators by self time (reading
    them takes seconds in a trace of 10^5 operators)."""
    from torch.autograd import DeviceType
    from torch.profiler import record_function

    with padded_profile() as prof:
        for _ in range(calls):
            with record_function("traced_step"):
                step()
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
    # the device's clock against the host's: a device record cannot start
    # before the traced work began nor before the runtime call that
    # launched it, so a negative lead is the clocks' disagreement
    launch = {e.id: e.time_range.start for e in evs
              if e.device_type == DeviceType.CPU and e.name.startswith("cuda")}
    first = min(e.time_range.start for e in device)
    lead_us = min((e.time_range.start - launch[e.id] for e in device
                   if e.id in launch), default=math.nan)
    print(f"  trace clocks: the first device record starts "
          f"{first - min(t.start for t in ticks):.1f} us after the first "
          f"traced call begins, and a device record at least {lead_us:.1f} "
          f"us after its launch call (the pad is {TRACE_PAD_S * 1e6:.0f} "
          f"us)", flush=True)

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
            stats[f"{label}_ms"] = ms
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
    stats["other"] = {name: us / n / 1e3 for name, us in other.items()}
    if not host:
        return stats
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
                guard: bool = False, jit: bool = False,
                params=None) -> dict:
    """A trace of a few decode-only ticks of a fresh engine (same
    requests), with or without the numerics guard, eager or compiled
    (then every model call is captured before the traced ticks), serving
    ``params`` (default: the model's own, prepared)."""
    eng = Engine(model, engine_cfg(jit=jit, guard=guard), device=dev,
                 params=params)
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
    sites = {"attn_qkv": L * d * (H + 2 * KV) * hd * rows,
             "attn_out": L * H * hd * d * rows,
             "attn_scores": attn, "attn_pv": attn,
             "logits": d * cfg.padded_vocab * (SLOTS * decode_steps
                                               + first_tokens)}
    if cfg.n_experts:
        # a MoE layer routes every row of a call, padding included, and
        # runs 3 expert GEMMs of (E, C, d, ff), C = moe_capacity(rows)
        E = cfg.n_experts
        slots = (moe_capacity(SLOTS, cfg) * decode_steps
                 + moe_capacity(CHUNK, cfg) * prefill_chunks)
        sites["moe_router"] = L * d * E * rows
        sites["moe_expert"] = L * 3 * E * d * ff * slots
    else:
        sites["ffn"] = L * 3 * d * ff * rows
    return sites


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


def _timed_run(eng, reqs, off: int, per_tick: bool = True,
               walls_of=None) -> dict:
    """Serve ``reqs`` on ``eng`` with their rids shifted by ``off`` (so one
    engine serves them again): the tokens by the original rid, the wall,
    tokens/s, mean TTFT, the decode-only tick walls (checked per tick by
    ``walls_of``, :func:`tick_walls` by default, unless ``per_tick`` is
    off: a retried call launches its kernels twice) and whether all
    COMPLETED with MAX_NEW tokens."""
    walls_of = walls_of or (lambda t: tick_walls(t, eng.model.cfg.n_layers))
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
            "walls": walls_of(ticks) if per_tick else None,
            "ok": all(eng.results[rid].ok
                      and len(eng.results[rid].tokens) == MAX_NEW
                      for rid in rids)}


def lapper():
    """A function that prints the seconds since its previous call (or since
    this one) beside ``what`` was done."""
    laps = [time.perf_counter()]

    def lap(what):
        laps.append(time.perf_counter())
        print(f"  ({what}: {laps[-1] - laps[-2]:.1f} s)", flush=True)
    return lap


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
    return dict(total, step_s=walls[len(walls) // 2],
                per_step=dict(zip(("K1", "K2", "K3", "K4"), per)))


def _one_batch(prompt, dev) -> dict:
    """The batch of one prompt, a token array or a Request with its extras
    (an encoder-decoder arch's frames), as the Server's prefill takes
    it."""
    return request_batch(prompt if isinstance(prompt, Request)
                         else Request(-1, prompt), dev)


def _dense_prefilled(model: LM, params, prompts, dev):
    """A dense cache with each prompt (token array or Request) prefilled
    into its slot, and the slots' next positions (after a prefix arch's
    patches)."""
    cache = model.init_cache(len(prompts), DENSE_CACHE)
    with torch.no_grad():
        for i, p in enumerate(prompts):
            _, one = model.prefill(params, _one_batch(p, dev), DENSE_CACHE)
            write_slot(cache, i, one)
    return cache, torch.as_tensor(
        [len(p.tokens if isinstance(p, Request) else p)
         + model.cfg.prefix_tokens for p in prompts], device=dev)


def _dense_decode_logits(model: LM, params, prompts, first, dev):
    """One decode step of all slots of a freshly prefilled dense cache, fed
    ``first``; that step's logits (B, V)."""
    cache, pos = _dense_prefilled(model, params, prompts, dev)
    with torch.no_grad():
        logits, _ = model.decode_step(params, cache,
                                      first.to(torch.int32)[:, None], pos)
    return logits


def dense_logits_phase(model: LM, params, dev, tol: float = 2e-2) -> dict:
    """One dense decode step's logits (4 slots) against the same weights in
    standard mode, fed the same tokens: max|diff| <= ``tol`` *
    max|logits| and the same argmax on every row; square_virtual's gap
    (the multiplier under the square form's contract) printed beside
    it."""
    std = _view(model, matmul_mode="standard")     # the same weights
    virt = _view(model, matmul_mode="square_virtual")
    prompts = make_requests(model.cfg, DENSE_BATCH, seed=0)
    with torch.no_grad():
        first = torch.stack([torch.argmax(std.logits(std.tree(), std.forward(
            std.tree(), _one_batch(p, dev))[0][:, -1:])[0, 0])
            for p in prompts])
        sq_logits = _dense_decode_logits(model, params, prompts, first, dev)
        std_logits = _dense_decode_logits(std, std.tree(), prompts, first,
                                          dev)
        virt_logits = _dense_decode_logits(virt, virt.tree(), prompts, first,
                                           dev)
    del std, virt
    scale = std_logits.abs().max().item()
    err = (sq_logits - std_logits).abs().max().item()
    agree = (sq_logits.argmax(-1) == std_logits.argmax(-1)).float().mean()
    virt_err = _rel_max(virt_logits, std_logits)
    print(f"  decode-step logits vs standard (bf16): max|diff| {err:.4e}, "
          f"max|logits| {scale:.4e} (ratio {err / scale:.3e}), argmax "
          f"agreement {agree.item():.3f} over {len(prompts)} rows; "
          f"square_virtual (the multiplier) {virt_err:.3e}", flush=True)
    check(bool(torch.isfinite(sq_logits).all()) and err <= tol * scale,
          f"decode-step logits vs standard mode: max|diff| {err:.4e} <= "
          f"{tol:g} * max|logits| ({tol * scale:.4e})")
    check(agree.item() == 1.0,
          f"decode-step greedy tokens vs standard mode: argmax agreement "
          f"{agree.item():.3f} over {len(prompts)} rows")
    return {"err": err, "scale": scale, "virtual": virt_err, "tol": tol}


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
        plan = sq_conv2d_k7.last_plan     # the planner's: a cached or model plan
        want = k7_launch_shape(xshape, wshape[0], wshape[2:], strides, pads,
                               sms, band=plan.band, splits=plan.splits)
        check(plan == tuning.plan_conv2d(
            tuple(xshape), wshape[0], wshape[2:], strides, pads, sms=sms),
            f"{name}: K7 launched the planner's {plan}")
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
            check(shape == cpm_planned(name, m, n, k),
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
# ------------------------------------------------------------- training
# The training launcher's defaults (the JAX launcher's): 8 sequences of 256
# tokens a step, fairsquare-demo at full width, bf16, remat="block".
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 256, 4
TRAIN_T = TRAIN_B * TRAIN_S


def train_cfg(mode="square_pallas", **kw):
    return dataclasses.replace(get_config("fairsquare-demo"),
                               matmul_mode=mode, **kw)


def train_k1_shapes(cfg):
    """{(m, k, n): launches a step} of K1 in one train step, from the
    config: each 2D GEMM (T, k) @ (k, n) of the forward, its dL/dx (T, n)
    @ (n, k) and its dL/dW (n, T) @ (T, k); the forward's counts once more
    for the rematerialised recompute, whose K1 launches are read on the
    card (``train_timing_phase``), not assumed here."""
    L, d, ff, V, T = (cfg.n_layers, cfg.d_model, cfg.d_ff,
                      cfg.padded_vocab, TRAIN_T)
    hd, H, KV = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    fwd = collections.Counter()
    for k, n, times in ((d, H * hd, L), (d, KV * hd, 2 * L),
                        (H * hd, d, L), (d, ff, 2 * L), (ff, d, L),
                        (d, V, 1)):
        fwd[(k, n)] += times
    shapes = collections.Counter()
    for (k, n), times in fwd.items():
        shapes[(T, k, n)] += times          # forward
        shapes[(T, n, k)] += times          # dL/dx
        shapes[(n, T, k)] += times          # dL/dW
    return dict(shapes)


def train_k2_shapes(cfg):
    """The batched attention GEMMs of a train step at one q and one kv
    chunk (S <= both chunk sizes): scores (B*KV, G*S, hd) @ (hd, S), PV
    (B*KV, G*S, S) @ (S, hd), and their gradients; (B, m, k, n) -> the
    contractions a step that map to it (forward and backward)."""
    S, hd = TRAIN_S, cfg.resolved_head_dim
    nb, gs = TRAIN_B * cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads * S
    L = cfg.n_layers
    return {(nb, gs, hd, S): 2 * L,    # scores; PV's dL/dx
            (nb, gs, S, hd): 3 * L,    # PV; scores' dL/dx and dL/dW
            (nb, hd, gs, S): L}        # PV's dL/dW


def _plain_rows(aw, bw, sa, sb, budget=2 ** 28):
    """K1's plain version in blocks of output rows, each block's
    k_chunk-wide slab of squares within ``budget`` bytes."""
    rows = max(1, budget // (16 * bw.shape[1] * 4))
    return torch.cat([sq_matmul_plain(aw[i:i + rows], bw, sa[i:i + rows], sb)
                      for i in range(0, aw.shape[0], rows)])


def train_kernel_phase(dev, gen, cfg):
    """K1 and K2 against their plain versions at every training shape (f32
    from bf16-rounded operands; the plain K1 in blocks of output rows),
    each timed by graph replay beside torch.matmul / torch.bmm (no TF32),
    the FP32 slot floor (2 slots a term) and the bound.  Measured, not a
    queue: no kernel is redesigned here."""
    k1 = train_k1_shapes(cfg)
    k2 = train_k2_shapes(cfg)
    print(f"training shapes (T = {TRAIN_B} x {TRAIN_S} = {TRAIN_T} tokens "
          f"a step): K1 at {len(k1)} shapes, K2 at {len(k2)}, held to their "
          f"plain versions (f32 |err| <= k * 2^-23 * (max|a| + max|b|)^2) "
          f"and timed (graph replay; slot floor = 2 FP32 slots a term at "
          f"{FP32_SLOTS_PER_S:.3g}/s)", flush=True)
    rows = []
    for (m, k, n), per_step in sorted(k1.items()):
        a = torch.randn(m, k, generator=gen).to(torch.bfloat16).to(dev)
        b = (torch.randn(k, n, generator=gen) / math.sqrt(k)).to(
            torch.bfloat16).to(dev)
        aw, bw = a.float(), b.float()
        sa, sb = -(aw * aw).sum(1), -(bw * bw).sum(0)
        out = sq_matmul_k1(aw, bw, sa, sb)
        err = (out - _plain_rows(aw, bw, sa, sb)).abs().max().item()
        tol = k * 2.0 ** -23 * (aw.abs().max().item()
                                + bw.abs().max().item()) ** 2
        check(bool(torch.isfinite(out).all()) and err <= tol,
              f"K1 f32 m={m} k={k} n={n}: max|err| {err:.3e} <= {tol:.3e}")
        del out
        ms = time_graph([lambda: sq_matmul_k1(aw, bw, sa, sb)], reps=3,
                        replays=2)
        lib_ms = time_graph([lambda: torch.matmul(aw, bw)], reps=3,
                            replays=2)
        terms = m * n * k
        floor = 2 * terms / FP32_SLOTS_PER_S * 1e3
        t_bytes = 4 * (m * k + k * n + m + n + m * n) / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * terms / FP32_OPS_PER_S * 1e3
        rows.append(dict(kernel="K1", shape=(m, k, n), per_step=per_step,
                         ms=ms, library_ms=lib_ms, floor_ms=floor,
                         bound_ms=max(t_bytes, t_ops), max_abs_err=err))
        print(f"    K1 m={m:5d} k={k:5d} n={n:5d} x{per_step:2d} a step: "
              f"{ms:.4f} ms | torch.matmul {lib_ms:.4f} ms "
              f"({ms / lib_ms:.2f}x) | slot floor {floor:.4f} ms "
              f"({floor / ms:.1%} of it) | grid "
              f"{k1_planned(m, n, k)['grid']}", flush=True)
        del aw, bw, a, b
    for (nb, m, k, n), per_step in sorted(k2.items()):
        aw = torch.randn(nb, m, k, generator=gen).to(torch.bfloat16).to(
            dev).float()
        bw = torch.randn(nb, k, n, generator=gen).to(torch.bfloat16).to(
            dev).float()
        sa, sb = -(aw * aw).sum(2), -(bw * bw).sum(1)
        out = sq_matmul_k2(aw, bw, sa, sb)
        err = (out - sq_matmul_batched_plain(aw, bw, sa, sb)).abs().max(
        ).item()
        tol = k * 2.0 ** -23 * (aw.abs().max().item()
                                + bw.abs().max().item()) ** 2
        check(bool(torch.isfinite(out).all()) and err <= tol,
              f"K2 f32 B={nb} m={m} k={k} n={n}: max|err| {err:.3e} <= "
              f"{tol:.3e}")
        ms = time_graph([lambda: sq_matmul_k2(aw, bw, sa, sb)], reps=5,
                        replays=2)
        lib_ms = time_graph([lambda: torch.bmm(aw, bw)], reps=5, replays=2)
        terms = nb * m * n * k
        floor = 2 * terms / FP32_SLOTS_PER_S * 1e3
        t_bytes = 4 * nb * (m * k + k * n + m + n + m * n) \
            / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * terms / FP32_OPS_PER_S * 1e3
        rows.append(dict(kernel="K2", shape=(nb, m, k, n), per_step=per_step,
                         ms=ms, library_ms=lib_ms, floor_ms=floor,
                         bound_ms=max(t_bytes, t_ops), max_abs_err=err))
        print(f"    K2 B={nb} m={m:3d} k={k:3d} n={n:3d} x{per_step:2d} a "
              f"step: {ms:.4f} ms | torch.bmm {lib_ms:.4f} ms "
              f"({ms / lib_ms:.2f}x) | slot floor {floor:.4f} ms "
              f"({floor / ms:.1%} of it) | grid "
              f"{batched_planned('K2', nb, m, n, k)['grid']}", flush=True)
    for name, lib in (("K1", "torch.matmul"), ("K2", "torch.bmm")):
        mine = [r for r in rows if r["kernel"] == name]
        tot = {key: sum(r["per_step"] * r[key] for r in mine)
               for key in ("ms", "library_ms", "floor_ms")}
        print(f"  per train step without the recompute "
              f"({sum(r['per_step'] for r in mine)} launches): {name} "
              f"{tot['ms']:.3f} ms | {lib} {tot['library_ms']:.3f} ms | "
              f"slot floor {tot['floor_ms']:.3f} ms", flush=True)
    return rows


def expected_train_audit(cfg) -> dict:
    """{site: mults} of one train step: each forward contraction's
    B*M*K*N, and the same again at <site>.bwd_x and <site>.bwd_w (the
    recompute notes nothing).  Attention spans the whole S x S block of one
    q chunk and one kv chunk; a MoE layer's router is T*d*E and its three
    expert GEMMs 3*E*C*d*f, C = moe_capacity(T), in place of the FFN."""
    L, d, ff, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.padded_vocab
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    T, S = TRAIN_T, TRAIN_S
    attn = L * TRAIN_B * H * S * S * hd
    fwd = {"attn_qkv": L * T * d * (H + 2 * KV) * hd,
           "attn_out": L * T * H * hd * d,
           "attn_scores": attn, "attn_pv": attn, "loss": T * d * V}
    if cfg.n_experts:
        E = cfg.n_experts
        fwd["moe_router"] = L * T * d * E
        fwd["moe_expert"] = L * 3 * E * moe_capacity(T, cfg) * d * ff
    else:
        fwd["ffn"] = L * T * 3 * d * ff
    out = dict(fwd)
    for site, m in fwd.items():
        out[f"{site}.bwd_x"] = out[f"{site}.bwd_w"] = m
    return out


def train_launcher_phase(dev, compared) -> dict:
    """``python -m repro_torch.launch.train`` on full-width fairsquare-demo,
    square_pallas, bf16, remat="block", 8 x 256 tokens, 4 steps,
    --ckpt-every 2, --metrics-file, --trace-out, its step captured into a
    CUDA graph (the launcher's default on CUDA): finite losses, every
    checkpoint committed and restorable, one capture, the first step's
    compiled audit equal to the analytic count with every contraction
    (forward and backward) on K1/K2."""
    import tempfile
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import train as train_launcher
    from repro_torch.obs.metrics import MetricsRegistry
    cfg = train_cfg()
    print(f"train launcher: python -m repro_torch.launch.train, "
          f"fairsquare-demo full width, square_pallas, {cfg.dtype}, "
          f"remat={cfg.remat}, {TRAIN_B} x {TRAIN_S} tokens, "
          f"{TRAIN_STEPS} steps, --ckpt-every 2, --metrics-file, "
          f"--trace-out, the step replayed from a CUDA graph", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        mfile, tfile = f"{tmp}/metrics.json", f"{tmp}/trace.json"
        argv = ["--arch", "fairsquare-demo", "--matmul-mode", "square_pallas",
                "--steps", str(TRAIN_STEPS), "--global-batch", str(TRAIN_B),
                "--seq", str(TRAIN_S), "--ckpt-every", "2", "--ckpt-dir",
                f"{tmp}/ckpt", "--device", str(dev), "--metrics-file", mfile,
                "--trace-out", tfile]
        reset_counts()                  # counts of this path's run only
        t0 = time.perf_counter()
        res = train_launcher.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(obs_check.main([mfile, tfile]) == 0,
              "metrics snapshot and trace pass "
              "python -m repro_torch.obs.check")
        launched = {"K1": sq_matmul_k1.launches, "K2": sq_matmul_k2.launches,
                    "K3": sq_matmul_k3.launches}
        shapes_ok(compared)
        with open(mfile) as f:
            snap = json.load(f)
        with open(tfile) as f:
            trace = json.load(f)
        mgr = CheckpointManager(f"{tmp}/ckpt", registry=MetricsRegistry())
        steps = mgr.steps()
        restored = {}
        for s in steps:
            trees, meta = mgr.restore(step=s)   # digests and fingerprint
            restored[s] = meta["losses"]
    losses = res["loss_trajectory"]
    print(f"  losses {losses}; run wall {wall:.1f} s (builds, the capture, "
          f"{TRAIN_STEPS} steps, 3 checkpoint writes)", flush=True)
    check(res["captures"] == 1,
          f"the step captured once ({res['captures']} captures)")
    check(res["final_step"] == TRAIN_STEPS and len(losses) == TRAIN_STEPS
          and all(math.isfinite(x) for x in losses),
          f"{TRAIN_STEPS} steps with finite losses")
    check(steps == [2, 4] and all(restored[s] == losses[:s] for s in steps),
          f"checkpoints {steps} committed; each restores, validated (per-"
          f"array sha256 and tree fingerprint), with the run's losses")
    c = snap["counters"]
    check(c["train_steps_total"] == TRAIN_STEPS
          and c["ckpt_commits_total"] == 3
          and c["ckpt_write_failures_total"] == 0
          and res["step_failures"] == res["rollbacks"] == 0,
          f"metrics snapshot: {c['train_steps_total']} steps, "
          f"{c['ckpt_commits_total']} commits (steps 2, 4 and the final "
          f"save), 0 write failures, 0 step failures, 0 rollbacks")
    spans = collections.Counter(e["name"] for e in trace["traceEvents"]
                                if e.get("ph") == "X")
    check(spans["train.step"] == TRAIN_STEPS and spans["ckpt.commit"] == 3
          and trace["otherData"]["dropped_records"] == 0,
          f"trace: {dict(spans)}, 0 dropped")
    audit = res["contraction_audit"]
    want = expected_train_audit(cfg)
    got = {site: v["mults"] for site, v in audit["by_site"].items()}
    check(got == want and audit["total_mults"] == sum(want.values()),
          f"audit of the first step: per-site mults equal the analytic "
          f"count, {audit['total_mults']:,} = 3 x "
          f"{sum(want.values()) // 3:,} forward multiplies")
    check(audit["fraction_square"] == 1.0
          and audit["fraction_square_bwd"] == 1.0
          and audit["fraction_demoted"] == 0.0,
          "compiled audit of the first step's replay: fraction_square 1.0 "
          "and fraction_square_bwd 1.0")
    # each capture's warm-up is one eager step more
    calls = TRAIN_STEPS + res["captures"]
    per_step = {k: v / calls for k, v in launched.items()}
    check(launched["K1"] > 0 and launched["K2"] > 0
          and launched["K3"] == 0
          and all(v == int(v) for v in per_step.values()),
          f"launches over {TRAIN_STEPS} replayed steps and "
          f"{res['captures']} warm-up: {launched} ({per_step} a step)")
    return dict(launched, calls=calls)


def _train_losses(cfg, dev, steps, tcfg=None, jit=False):
    """``steps`` steps of ``cfg`` from seed 0 on the launcher's first
    batches, eager or captured: (losses, final params, final optimizer
    state)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod
    model = build_model(cfg, device=dev, seed=0)
    params = model.train_params()
    opt = adamw.adamw_init(params)
    step = step_mod.make_train_step(model, tcfg or step_mod.TrainConfig())
    if jit:
        step = step_mod.jit_train_step(step, dev)
    data = SyntheticLM(DataConfig(TRAIN_B, TRAIN_S, cfg.vocab), cfg,
                       device=dev)
    losses = []
    for batch in data.take(steps):
        params, opt, met = step(params, opt, batch)
        losses.append(float(met["loss"]))
    return losses, params, opt


def _probed_kernels():
    """Wrap K1, K2 and K3 as ``kernels.ops`` calls them, so that every
    launch is also held to the exact (float64) product of its operands:
    returns the list each launch's (kernel, shape, max|err|, tolerance,
    max|exact|) joins when the wrap is undone, and the function that
    unwraps them.  The step itself reads nothing back (xlstm's launches K2
    ~5000 times)."""
    from repro_torch.kernels import ops as kops
    seen, pending = [], []
    orig = {"K1": kops.sq_matmul_k1, "K2": kops.sq_matmul_k2,
            "K3": kops.sq_matmul_k3}

    def probe(name, kern):
        def run(aw, bw, sa, sb):
            out = kern(aw, bw, sa, sb)
            exact = torch.matmul(aw.double(), bw.double())
            tol = aw.shape[-1] * 2.0 ** -23 * (
                aw.abs().max() + bw.abs().max()).double() ** 2
            pending.append((name, tuple(aw.shape) + (bw.shape[-1],),
                            torch.stack([(out.double() - exact).abs().max(),
                                         tol, exact.abs().max()])))
            return out
        return run

    for name, kern in orig.items():
        setattr(kops, f"sq_matmul_{name.lower()}", probe(name, kern))

    def restore():
        for name, kern in orig.items():
            setattr(kops, f"sq_matmul_{name.lower()}", kern)
        if pending:
            values = torch.stack([v for _, _, v in pending]).cpu().tolist()
            seen.extend((name, shape, *v)
                        for (name, shape, _), v in zip(pending, values))
            pending.clear()
    return seen, restore


# One step's gradients are compared with the loss scaled by 2^14.  The
# mean loss makes every cotangent ~1/T of the activations it meets (T =
# 2^11 target tokens a step), and the square form's f32 error, ~2^-24 *
# (|a| + |b|)^2 a term, is then not small against the product |ab|: the
# unscaled square-routed gradients are mostly rounding (PERF.md section 6).
# Scaling the loss by a power of two balances the operands, and the
# scaling and the division after it are exact.  Of the scales 1, 2^11,
# 2^14 and 2^17, 2^14 left the smallest gap, and the tolerances sit above
# what it left (f32 worst 3.7e-3; bf16 worst 3.2e-2 against
# tests/test_vjp_square.py's 5e-2), all measured by
# scripts/train_grad_gap.py on an H100.  A zero, missing or misrouted
# gradient is off by ~1.
GRAD_SCALE = 2.0 ** 14
GRAD_RTOL = {"float32": 1e-2, "bfloat16": 5e-2}


def _leaf_names(tree, path=""):
    """Leaf paths of ``tree`` in ``tree_leaves``'s order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, t in enumerate(tree)
                for n in _leaf_names(t, f"{path}/{i}")]
    return [path]


def _grads(cfg, dev, scale=1.0):
    """One step's gradients of ``cfg`` from seed 0 on the first batch, of
    the loss times ``scale`` and divided by it: ``{leaf path: tensor}`` in
    tree order."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train import step as step_mod
    model = build_model(cfg, device=dev, seed=0)
    batch = SyntheticLM(DataConfig(TRAIN_B, TRAIN_S, cfg.vocab), cfg,
                        device=dev).next_batch()
    loss_fn = step_mod.make_loss_fn(model, step_mod.TrainConfig())

    def scaled(params, b):
        loss, met = loss_fn(params, b)
        return loss * scale, met

    _, g = step_mod.value_and_grad(scaled, model.train_params(), batch)
    return dict(zip(_leaf_names(g), (t / scale for t in tree_leaves(g))))


def _norm_rel(got, ref):
    """Per tensor ||got - ref|| / ||ref||: (median, worst, its path)."""
    rel = _rel_tensors(got, ref)
    worst = max(rel, key=rel.get)
    return sorted(rel.values())[len(rel) // 2], rel[worst], worst


def train_parity_phase(dev) -> None:
    """Full width in f32 (remat="none"): 3 steps of square_pallas against
    3 of standard (TF32 off) on the same batches, at
    tests/test_train_square.py's rtol 2e-3 and atol 2e-3.  Then one step's
    gradients, with the loss scaled by ``GRAD_SCALE``, tensor by tensor
    against standard's: f32 within ``GRAD_RTOL["float32"]`` in norm, with
    every K1 and K2 launch, forward and backward, held to the exact product
    of the operands it was given within the square form's f32 bound k *
    2^-23 * (max|a| + max|b|)^2; and bf16 (the launcher's dtype) within
    tests/test_vjp_square.py's 5e-2."""
    print("train parity: fairsquare-demo full width, f32, remat none, 3 "
          "steps square_pallas vs standard (no TF32); one step's gradients "
          f"of the loss x {GRAD_SCALE:g} against standard's, f32 with every "
          "launch against its exact product, and bf16", flush=True)
    got = {}
    for mode in ("square_pallas", "standard"):
        losses, _, _ = _train_losses(
            train_cfg(mode, dtype="float32", remat="none"), dev, 3)
        got[mode] = losses
    diffs = [abs(a - b) for a, b in zip(got["square_pallas"],
                                        got["standard"])]
    check(all(d <= 2e-3 + 2e-3 * abs(b)
              for d, b in zip(diffs, got["standard"])),
          f"f32 losses: square_pallas {got['square_pallas']} vs standard "
          f"{got['standard']} (|diff| {[f'{d:.2e}' for d in diffs]}; rtol "
          f"2e-3, atol 2e-3)")
    for dtype in ("float32", "bfloat16"):
        probed = dtype == "float32"
        seen, restore = _probed_kernels() if probed else ([], None)
        try:
            sq = _grads(train_cfg("square_pallas", dtype=dtype,
                                  remat="none"), dev, GRAD_SCALE)
        finally:
            if probed:
                restore()
        if probed:
            bad = [r for r in seen if not r[2] <= r[3]]
            worst = max(seen, key=lambda r: r[2] / r[3])
            check(len(seen) == 3 * (85 + 24) + 1 and not bad,
                  f"one f32 step: all {len(seen)} K1/K2 launches within k * "
                  f"2^-23 * (max|a| + max|b|)^2 of their exact products "
                  f"(worst {worst[0]} {worst[1]}: {worst[2]:.3e} <= "
                  f"{worst[3]:.3e}, {worst[2] / worst[4]:.2%} of its largest "
                  f"exact entry)")
        std = _grads(train_cfg("standard", dtype=dtype, remat="none"), dev,
                     GRAD_SCALE)
        check(list(sq) == list(std) and all(
            bool(torch.isfinite(t).all()) for t in sq.values()),
            f"{dtype} gradients: {len(sq)} finite tensors")
        med, worst, name = _norm_rel(sq, std)
        check(worst <= GRAD_RTOL[dtype],
              f"{dtype} gradients of the loss x {GRAD_SCALE:g}, square_pallas "
              f"vs standard: ||diff|| / ||standard|| median {med:.3e}, worst "
              f"{worst:.3e} ({name}) <= {GRAD_RTOL[dtype]:g}")
        del sq, std


def train_compiled_equals_eager_phase(dev) -> None:
    """Two fixed-seed runs of the launcher's configuration (bf16, remat
    block, square_pallas), 2 steps each, one eager and one captured into a
    CUDA graph: equal tree_fingerprints of the losses, params and
    optimizer state.  (It replaces two eager runs' comparison: K1/K2 fix
    their summation order, and a replay runs the eager step's kernels.)"""
    from repro_torch.optim import adamw
    fps = {}
    for jit in (False, True):
        losses, params, opt = _train_losses(train_cfg(), dev, 2, jit=jit)
        fps[jit] = adamw.tree_fingerprint(
            {"losses": torch.tensor(losses), "params": params, "opt": opt})
        print(f"  {'captured' if jit else 'eager'} 2 steps: losses "
              f"{losses}", flush=True)
    check(fps[False] == fps[True],
          f"captured and eager fixed-seed runs bit-identical: fingerprint "
          f"{fps[False][:16]}... twice")


def sat_train_step(mode):
    """tests/test_compiled_guard.py::_make_sat_step on the port: the loss
    scale puts the cotangent at ~1e22, so the square form's backward
    ``(g + w)^2`` and ``(g + x)^2`` are inf in f32 while the standard
    route's products stay finite.  ``x`` asks for its gradient, since
    JAX's custom_vjp computes dL/dx of the batch operand too."""
    from repro_torch.train import step as step_mod

    def loss_fn(p, batch):
        x = batch["x"].detach().requires_grad_(True)
        out = fs_einsum("mk,kn->mn", x, p["w"], mode=mode, site="chaos")
        return torch.sum(out) * 1e22, {}

    def train_step(params, opt_state, batch):
        (loss, _), grads = step_mod.value_and_grad(loss_fn, params, batch)
        return params, opt_state, {"loss": loss, "grads": grads}
    return train_step


def train_guard_phase(dev) -> None:
    """The compiled train guard: JAX's saturating step captured by
    ``GuardedStep(jit=True)`` under ``square_exact`` at JAX's size
    (8 x 16 x 4) and under ``square_pallas`` at 64 x 64 x 32, K1's route
    for the forward and both gradients.  A probe trips, exactly the
    ``chaos.bwd_*`` keys demote, the re-capture launches K1 no more there,
    the gradients are finite and within 1e-5 of the standard route's, and
    a second call has no trip.  Then allocated memory across a re-capture
    (the old outputs dropped) within 1 MiB."""
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.train import step as step_mod
    print("compiled train guard: GuardedStep(jit=True) on JAX's saturating "
          "train step (cotangent ~1e22), trip limit 1", flush=True)
    gen = torch.Generator().manual_seed(23)
    for mode, (m, k, n) in (("square_exact", (8, 16, 4)),
                            ("square_pallas", (64, 64, 32))):
        x = torch.randn(m, k, generator=gen).to(dev)
        w = torch.randn(k, n, generator=gen).to(dev)
        routing.reset_route_health()
        guards.clear_pending_trips()
        gs = step_mod.GuardedStep(sat_train_step(mode), jit=True,
                                  trip_limit=1, max_retries=4,
                                  registry=MetricsRegistry())
        reset_counts()
        _, _, met = gs({"w": w}, {}, {"x": x})
        torch.cuda.synchronize()
        k1_first = sq_matmul_k1.launches
        health = routing.route_health()
        demoted = sorted(health.demotions)
        # the standard route's gradients, eagerly, as the demoted graph's
        ref = sat_train_step("standard")({"w": w}, {}, {"x": x})[2][
            "grads"]["w"]
        g = met["grads"]["w"]
        rel = ((g - ref).abs() / ref.abs()).max().item()
        call = gs._fn.current
        check(gs.guard_trips == 2 and gs.rejits == 1 and gs.retries == 1
              and gs.captures == 2 and len(demoted) == 2
              and all(d.split("|")[0] in ("chaos.bwd_x", "chaos.bwd_w")
                      for d in demoted),
              f"{mode}: probes trip {gs.guard_trips} times, {gs.stats()}, "
              f"demoted exactly {demoted}, {gs.captures} captures")
        check(bool(torch.isfinite(g).all()) and rel <= 1e-5,
              f"{mode}: gradients finite, max relative difference from the "
              f"standard route's {rel:.2e} <= 1e-5")
        if mode == "square_pallas":
            # warm-up, tripped replay, re-capture's warm-up and replay
            k1_graph = sum(n for kern, n, _ in call.ledger.launches
                           if kern is sq_matmul_k1)
            check(k1_first == 3 + 3 + 1 + 1 and k1_graph == 1,
                  f"K1 launched {k1_first} times (3 a call, then 1: the "
                  f"re-captured graph launches it for the forward alone, "
                  f"its ledger {k1_graph})")
        _, _, met2 = gs({"w": w}, {}, {"x": x})
        torch.cuda.synchronize()
        check(gs.stats() == {"guard_trips": 2, "rejits": 1, "retries": 1}
              and gs.captures == 2 and torch.equal(met2["grads"]["w"], g),
              f"{mode}: a second call replays clean, no trip or capture")
        del met, met2, g, gs, call

    # memory across a re-capture (after the guarded steps above, so cuBLAS
    # already holds its workspace for the capture stream in autograd's
    # thread, which the demoted route's first capture allocates once)
    def mem():
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated(dev) / 2 ** 20

    routing.reset_route_health()
    with guards.guarded(trip_limit=1):
        cf = graphs.CapturedFunction(sat_train_step("square_pallas"),
                                     device=dev, epoch_keyed=True,
                                     name="sat_step")
        out = cf({"w": w}, {}, {"x": x})
        trips = guards.drain_pending_trips()
        del out
        before = mem()
        cf.recapture()
        out = cf.replay()
        clean = guards.drain_pending_trips()
        del out
        after = mem()
        cf.release()
    freed = mem()
    routing.reset_route_health()
    print(f"  memory allocated across a re-capture: {before:.3f} MiB with "
          f"the first graph, {after:.3f} MiB with the re-captured one, "
          f"{freed:.3f} MiB with both freed", flush=True)
    check(len(trips) == 2 and clean == {} and abs(after - before) <= 1.0
          and freed < after,
          "a re-capture frees the old graph: allocated memory after it "
          "within 1 MiB of before it, lower once the graphs are freed")


def train_timing_phase(dev) -> dict:
    """The launcher's configuration: K1/K2 launches of one forward, one
    step at remat none and one at remat block (so forward, backward and
    recompute apart); then the eager step and the step captured into a
    CUDA graph timed in turns (eager, graph, graph, eager; the median wall
    of 5 warm steps each, tokens/s), the capture's time, its ledger's
    launches against the eager step's, a profiled trace of 2 steps of each
    (device-busy share, device operations, K1/K2 kernels a step), the
    device time of the state's copy into the graph's static inputs, and
    the compiled audit of one replayed step against the analytic count."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod
    split = {}
    for remat in ("none", "block"):
        cfg = train_cfg(remat=remat)
        model = build_model(cfg, device=dev, seed=0)
        params = model.train_params()
        opt = adamw.adamw_init(params)
        batch = SyntheticLM(DataConfig(TRAIN_B, TRAIN_S, cfg.vocab), cfg,
                            device=dev).next_batch()
        step = step_mod.make_train_step(model, step_mod.TrainConfig())
        if remat == "none":
            reset_counts()
            with torch.no_grad():
                step_mod.make_loss_fn(model, step_mod.TrainConfig())(
                    params, batch)
            split["forward"] = (sq_matmul_k1.launches,
                                sq_matmul_k2.launches)
        reset_counts()
        step(params, opt, batch)
        torch.cuda.synchronize()
        split[remat] = (sq_matmul_k1.launches, sq_matmul_k2.launches)
        step_counts = dict(zip(("K1", "K2", "K3", "K4"), counts()))
    # the loss rematerialises its chunks at either setting (as JAX's
    # jax.checkpoint of the chunk body does): one K1 launch a chunk
    chunks = -(-TRAIN_S // min(cfg.loss_chunk, TRAIN_S))
    fwd = split["forward"]
    bwd = (2 * fwd[0], 2 * fwd[1])
    rec = tuple(a - b - c for a, b, c in zip(split["block"], fwd, bwd))
    print(f"train step launches (K1, K2): forward {fwd}, backward {bwd}, "
          f"recompute {rec} (the loss's {chunks} chunk(s) at remat none "
          f"too); a remat=none step {split['none']}, a remat=block step "
          f"{split['block']}", flush=True)
    check(split["none"] == (3 * fwd[0] + chunks, 3 * fwd[1])
          and rec == (fwd[0], fwd[1]),
          "backward: two launches (dL/dx, dL/dW) per forward launch; "
          "remat block recomputes the whole forward")

    # the captured step (remat block): its capture timed, under the
    # compiled audit so that a replay can be audited below
    graph = step_mod.jit_train_step(step, dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with counting.compiled_audit():
        out = graph(params, opt, batch)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    ledger = {kern.__name__: n for kern, n, _ in graph.current.ledger.launches}
    got = (ledger.get("sq_matmul_k1", 0), ledger.get("sq_matmul_k2", 0))
    check(graph.captures == 1 and got == split["block"]
          and (sq_matmul_k1.launches, sq_matmul_k2.launches)
          == (2 * got[0], 2 * got[1]),
          f"captured step: by its ledger K1 {got[0]} and K2 {got[1]} a "
          f"replay (the eager step's), counted twice by the first call "
          f"(the warm-up and the replay); the first call (warm-up, capture, "
          f"replay) {capture_s * 1e3:.1f} ms; card {CARD}")

    state = {"eager": (params, opt), "graph": out[:2]}
    fns = {"eager": step, "graph": graph}

    def one(kind):
        p, o, met = fns[kind](*state[kind], batch)
        state[kind] = (p, o)
        return met

    walls = {"eager": [], "graph": []}
    for i, kind in enumerate(("eager", "graph", "graph", "eager")):
        turn = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one(kind)
            torch.cuda.synchronize()
            turn.append(time.perf_counter() - t0)
        turn = sorted(turn[1:])
        walls[kind] += turn
        print(f"  turn {i + 1} {kind}: median {turn[2] * 1e3:.2f} ms (min "
              f"{turn[0] * 1e3:.2f}, max {turn[-1] * 1e3:.2f}), "
              f"{TRAIN_T / turn[2]:.0f} tokens/s; card {CARD}", flush=True)
    check(graph.captures == 1, "the reused captured step captured no more")
    med = {k: sorted(v)[len(v) // 2] for k, v in walls.items()}
    # each traced step reads its loss, as the trainer does: a replay
    # returns before the device has run it
    stats = {k: trace_steps(lambda k=k: float(one(k)["loss"]),
                            f"{'replayed ' * (k == 'graph')}train steps",
                            med[k], calls=2)
             for k in ("eager", "graph")}
    check(stats["graph"].get("K1") == got[0]
          and stats["graph"].get("K2") == got[1],
          f"a profiled replayed step holds {stats['graph'].get('K1')} K1 and "
          f"{stats['graph'].get('K2')} K2 kernels (the ledger's {got})")
    for k in ("eager", "graph"):
        print(f"  {k}: median wall {med[k] * 1e3:.2f} ms over 10 warm steps "
              f"in 2 turns, {TRAIN_T / med[k]:.0f} tokens/s; traced step "
              f"{stats[k]['ops']:.0f} device operations, device busy "
              f"{stats[k]['busy_ms']:.3f} ms = {stats[k]['busy_share']:.1%} "
              f"of the traced wall, {stats[k]['busy_ms'] / (med[k] * 1e3):.1%}"
              f" of the untraced median; card {CARD}", flush=True)

    # the donation's copy of the new state (params, m, v) into the static
    # inputs: its device time from a profile of the copy of a distinct tree
    # of the same signature (the eager state), and its host time
    from torch.autograd import DeviceType
    nbytes = sum(t.numel() * t.element_size()
                 for t in tree_leaves(state["eager"]))
    with padded_profile(cpu=False) as prof:
        t0 = time.perf_counter()
        graph.stage(*state["eager"])
        host_ms = (time.perf_counter() - t0) * 1e3
    spans = [e.time_range for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    copy_ms = sum(t.end - t.start for t in spans) / 1e3
    print(f"  the state's copy into the graph's static inputs (the "
          f"donation's write-back): {nbytes / 1e9:.3f} GB in {len(spans)} "
          f"device copies, {copy_ms:.3f} ms of device time ("
          f"{2 * nbytes / copy_ms / 1e6:.0f} GB/s read + written, "
          f"{copy_ms / (med['graph'] * 1e3):.2%} of the replayed step), "
          f"issued in {host_ms:.3f} ms of host time; card {CARD}",
          flush=True)

    # the compiled audit of a replayed step: the analytic count, forward
    # and backward, the recompute's notes absent
    want = expected_train_audit(cfg)
    with counting.track_compiled_contractions() as ctr:
        graph.replay()
    torch.cuda.synchronize()
    audited = {site: v["mults"] for site, v in ctr.by_site().items()}
    check(audited == want and ctr.total_mults == sum(want.values())
          and ctr.fraction_square == 1.0 and ctr.fraction_square_bwd == 1.0,
          f"compiled audit of a replayed step: {ctr.total_mults:,} "
          f"multiplies, per site the analytic count (no recompute note), "
          f"fraction_square {ctr.fraction_square} and fraction_square_bwd "
          f"{ctr.fraction_square_bwd}")
    return {"forward": fwd, "backward": bwd, "recompute": rec,
            "step": split["block"], "step_counts": step_counts,
            "audit": ctr.total_mults, "median_ms": med["eager"] * 1e3,
            "graph_median_ms": med["graph"] * 1e3, "capture_ms":
            capture_s * 1e3, "copy_ms": copy_ms, "trace": stats["eager"],
            "graph_trace": stats["graph"]}


TRAIN_LONG_STEPS = 16


def train_long_phase(dev) -> dict:
    """The launcher's configuration (fairsquare-demo full width, bf16,
    remat block, 8 x 256 tokens, AdamW as the launcher sets it for this
    many steps: lr 3e-4, 10 warm-up steps), its step captured, trained
    TRAIN_LONG_STEPS steps in square_pallas and in standard on the same
    batches: finite losses at every step and the first 3 within
    tests/test_train_square.py's 2e-3; the gap at every step is printed,
    not gated."""
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod
    n = TRAIN_LONG_STEPS
    tcfg = step_mod.TrainConfig(opt=adamw.AdamWConfig(
        lr=3e-4, warmup_steps=max(10, n // 20), total_steps=n))
    print(f"long training: the captured launcher configuration, {n} steps "
          f"in square_pallas and in standard", flush=True)
    losses = {}
    for mode in ("square_pallas", "standard"):
        t0 = time.perf_counter()
        losses[mode], _, _ = _train_losses(train_cfg(mode), dev, n,
                                           tcfg=tcfg, jit=True)
        print(f"  {mode}: {n} captured steps in "
              f"{time.perf_counter() - t0:.1f} s (the capture included); "
              f"losses {[round(x, 5) for x in losses[mode]]}", flush=True)
    sq, std = losses["square_pallas"], losses["standard"]
    gap = [a - b for a, b in zip(sq, std)]
    print(f"  loss gap square_pallas - standard by step: "
          f"{[f'{g:.2e}' for g in gap]}; mean |gap| steps 1-8 "
          f"{sum(abs(g) for g in gap[:8]) / 8:.2e}, steps {n - 7}-{n} "
          f"{sum(abs(g) for g in gap[-8:]) / 8:.2e}, largest "
          f"{max(abs(g) for g in gap):.2e} at step "
          f"{max(range(n), key=lambda i: abs(gap[i])) + 1}; card {CARD}",
          flush=True)
    check(all(math.isfinite(x) for x in sq + std)
          and all(abs(a - b) <= 2e-3 + 2e-3 * abs(b)
                  for a, b in zip(sq[:3], std[:3])),
          f"{n} steps finite in both modes; the first 3 within rtol 2e-3, "
          f"atol 2e-3 of standard's (the rest reported, not gated)")
    return {"gap": gap}


def train_phases(dev, gen, compared) -> dict:
    """The training path: its kernels at its shapes, the launcher
    (captured), parity, compiled against eager, timing in turns and the
    compiled train guard.  Returns the launcher's K1/K2 launches."""
    cfg = train_cfg()
    rows = train_kernel_phase(dev, gen, cfg)
    compared["K1"] = list(compared["K1"]) + list(train_k1_shapes(cfg))
    compared["K2"] = list(compared["K2"]) + list(train_k2_shapes(cfg))
    launched = train_launcher_phase(dev, compared)
    train_parity_phase(dev)
    train_compiled_equals_eager_phase(dev)
    timing = train_timing_phase(dev)
    train_guard_phase(dev)
    train_long_phase(dev)
    calls = launched.pop("calls")
    check(tuple(launched[k] for k in ("K1", "K2"))
          == tuple(calls * n for n in timing["step"]),
          f"the launcher's launches {launched} = (steps + captures) "
          f"{calls} x a timed step's {timing['step']}")
    return {"launches": launched, "rows": rows, "timing": timing}


# ----------------------------------------------------- recurrent serving
# recurrentgemma-2b (RG-LRU + local attention) and xlstm-350m (mLSTM +
# sLSTM) at their published width and full depth, bf16, prepared,
# square_pallas with no policy, served by the dense Server (the launcher's
# fallback: their decode state is not a KV cache).
RECURRENT_ARCHS = ("recurrentgemma-2b", "xlstm-350m")
MLSTM_CHUNK = 256            # mlstm_forward's chunk
LONG_PROMPT = 1024           # the long prompt: 4 mLSTM chunks, a 1024-step scan
# decode-step logits against standard mode (bf16): |diff| / max|logits|,
# with the same argmax on every row.  recurrentgemma holds the dense LM's
# 2e-2 (PERF.md section 2).  xlstm's 24-layer recurrence leaves 8.07e-2
# (measured on one H100): the bound its f32 measurement below sets
# (recurrent_layer_check: every K1/K2 launch of the step within its own
# bound of the exact product, each layer within RECURRENT_LAYER_TOL of
# standard's, the f32 logits within 8.1e-3), amplified by bf16's re-rounding
# of every layer's activations; square_virtual, the same contract on the
# multiplier, is printed beside it.
RECURRENT_STD_TOL = {"recurrentgemma-2b": 2e-2, "xlstm-350m": 1e-1}
# f32, square_pallas against standard, teacher-forced: each layer's
# increment (|diff| / max; measured at most 2.5e-3 on one H100)
RECURRENT_LAYER_TOL = 5e-3
# f32, square_pallas: decode-step logits and the long prompt's logits
# against standard's, and the long prompt's prefill + decode against its
# own forward (|diff| / max|logits|; measured 2.2e-3 to 8.1e-3): the
# dense LM's serving bound
RECURRENT_F32_TOL = 2e-2
# prefill + one decode step against the forward's last logits (f32):
# tests/test_models_smoke.py::test_decode_matches_forward's rtol and atol
RECURRENT_LONG_TOL = 2e-3


# The serving phases' depth cuts, for the smoke's time limit (the
# prefix-token and the two training phases after them took 251.5 s of a
# whole smoke on one H100): recurrentgemma at its first (rglru, rglru,
# lattn) period of 26 layers, xlstm at its first (mlstm x 7, slstm) period
# of 24, whisper at 4 of its 32 encoder and 4 of its 32 decoder layers,
# paligemma at 6 of its 18 (whole until the planner and attention-options
# phases were added); every kind, shape and kernel of each path still
# runs.  The launcher serves the same cut (--layers, --encoder-layers).
SERVE_LAYERS = {"recurrentgemma-2b": 3, "xlstm-350m": 8,
                "whisper-large-v3": 4, "paligemma-3b": 6}


def serve_cut(arch) -> list:
    """The serve launcher's flags for ``arch``'s SERVE_LAYERS cut."""
    n = SERVE_LAYERS.get(arch)
    if not n:
        return []
    return ["--layers", str(n)] + (["--encoder-layers", str(n)]
                                   if get_config(arch).encoder_layers else [])


def served_depth(arch) -> str:
    """The serving phases' depth of ``arch``, in words."""
    cfg, full = recurrent_cfg(arch), get_config(arch)
    if cfg.n_layers == full.n_layers:
        return f"full depth ({full.n_layers} layers)"
    enc = (f" and {cfg.encoder_layers} of {full.encoder_layers} encoder "
           f"layers" if cfg.encoder_layers else "")
    return f"{cfg.n_layers} of {full.n_layers} layers{enc}"


def recurrent_cfg(arch, mode="square_pallas", dtype=None):
    """``arch`` at its published width, served at its SERVE_LAYERS depth
    (the encoder cut alike), square_pallas with no policy."""
    cfg = dataclasses.replace(get_config(arch), matmul_mode=mode,
                              contraction_policy=None)
    n = SERVE_LAYERS.get(arch)
    if n:
        cfg = dataclasses.replace(cfg, n_layers=n)
        if cfg.encoder_layers:
            cfg = dataclasses.replace(cfg, encoder_layers=n)
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def recurrent_contractions(cfg, B: int, S: int, cache_len: int = 0,
                           logit_rows: int = 1) -> list:
    """(site, batched, nb, m, k, n) of every ``fs_einsum`` call of one model
    call of a dense-Server arch (recurrent or encoder-decoder), in the
    canonical (nb, m, k, n) the dispatch plans: a forward of B sequences of
    S tokens (``cache_len`` 0: the prefill, an encoder-decoder arch's
    encoder over ``cfg.encoder_seq`` frames first, a prefix arch's decoder
    over its ``cfg.prefix_tokens`` patches and the S tokens; then the
    logits of ``logit_rows`` rows, none at 0) or a decode step of B rows
    against the dense cache (``cache_len`` > 0: S = 1, each attention ring
    min(cache_len, window) long, the logits of every row).  ``batched``:
    the spec has a batch index, so its kernel routes go to K2/K3, at nb = 1
    too."""
    out = []
    if cfg.encoder_layers and not cache_len:
        out += layer_contractions(cfg, "attn", B, cfg.encoder_seq) \
            * cfg.encoder_layers
    if not cache_len:
        S += cfg.prefix_tokens
    out += [c for kind in decoder_kinds(cfg)
            for c in layer_contractions(cfg, kind, B, S, cache_len)]
    rows = B if cache_len > 0 else logit_rows
    if rows:
        out.append(("logits", False, 1, rows, cfg.d_model, cfg.padded_vocab))
    return out


def layer_contractions(cfg, kind: str, B: int, S: int,
                       cache_len: int = 0) -> list:
    """:func:`recurrent_contractions`' calls of one layer of ``kind``, in
    the order the layer makes them."""
    d = cfg.d_model
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    G = H // KV
    decode = cache_len > 0
    T = B * S
    out = []

    def dense(site, k, n, rows=T):
        out.append((site, False, 1, rows, k, n))

    def attend(n_kv, window=None):
        """The scores and PV of S queries a row over ``n_kv`` keys: one
        decode step's against the ring (or the encoder's K/V), a forward's
        q chunks x kv chunks."""
        if decode:
            ring = min(n_kv, window) if window else n_kv
            out.append(("attn_scores", True, B * KV, G, hd, ring))
            out.append(("attn_pv", True, B * KV, G, ring, hd))
        else:
            cq, ck = min(cfg.attn_chunk_q, S), min(cfg.attn_chunk_kv, n_kv)
            for _ in range(-(-S // cq) * -(-n_kv // ck)):
                out.append(("attn_scores", True, B * KV, cq * G, hd, ck))
                out.append(("attn_pv", True, B * KV, G * cq, ck, hd))

    def ffn():
        if cfg.d_ff:
            gated = cfg.activation in ("swiglu", "geglu")
            for _ in range(2 if gated else 1):
                dense("ffn", d, cfg.d_ff)
            dense("ffn", cfg.d_ff, d)

    if kind in ("attn", "lattn", "xdec"):
        for n in (H * hd, KV * hd, KV * hd):
            dense("attn_qkv", d, n)
        attend(cache_len if decode else S,
               cfg.local_window if kind == "lattn" else cfg.window)
        dense("attn_out", H * hd, d)
        if kind == "xdec":                  # cross-attention
            Te = cfg.encoder_seq
            dense("attn_qkv", d, H * hd)
            if not decode:                  # K/V of the encoder's output
                dense("attn_qkv", d, KV * hd, rows=B * Te)
                dense("attn_qkv", d, KV * hd, rows=B * Te)
            attend(Te)
            dense("attn_out", H * hd, d)
        ffn()
    elif kind == "rglru":
        R = cfg.rnn_width or d
        dense("recurrent_proj", d, R)               # w_x
        dense("recurrent_proj", d, R)               # w_gate
        dense("recurrent_gates", R, R)              # w_r
        dense("recurrent_gates", R, R)              # w_i
        dense("recurrent_proj", R, d)               # w_out
        ffn()
    elif kind == "mlstm":
        di = int(cfg.inner_factor * d)
        hm = di // H
        dense("recurrent_proj", d, 2 * di)          # w_in
        for _ in range(3):                          # wq, wk, wv
            dense("recurrent_proj", di, di)
        dense("recurrent_gates", di, 2)             # w_if
        if decode:                                  # mlstm_seq_scan
            out.append(("recurrent_mix", True, B * H, 1, hm, hm))
            out.append(("recurrent_mix", True, B * H, 1, hm, 1))
        else:                                       # mlstm_chunk_scan
            c = min(MLSTM_CHUNK, S)
            for _ in range(-(-S // c)):
                for m, k, n in ((c, hm, hm), (c, hm, 1), (c, hm, c),
                                (c, c, hm), (hm, c, hm), (hm, c, 1)):
                    out.append(("recurrent_mix", True, B * H, m, k, n))
        dense("recurrent_proj", di, d)              # w_out
    elif kind == "slstm":
        hs = d // H
        dense("recurrent_proj", d, 4 * d)           # w_x
        for _ in range(S):                          # the recurrence
            out.append(("recurrent_mix", True, H, B, hs, 4 * hs))
        dense("recurrent_proj", d, d)               # w_out
    else:
        raise ValueError(f"no recurrent-serving count for kind {kind!r}")
    return out


@contextlib.contextmanager
def _uncounted_routes():
    """Ask ``select_matmul_route`` without leaving its decisions in its
    ``taken`` counter."""
    taken = routing.select_matmul_route.taken
    saved = collections.Counter(taken)
    try:
        yield
    finally:
        taken.clear()
        taken.update(saved)


def contraction_kernel(batched: bool, nb: int, m: int, k: int, n: int):
    """The kernel one contraction launches under square_pallas by the
    routing rules: "K1", "K2", "K3", or None on the virtual route."""
    route = routing.select_matmul_route(m, n, k, batch=nb).name
    if route == "virtual":
        return None
    if not batched:
        return "K1"
    return "K3" if route == "fold" else "K2"


def recurrent_launches(calls) -> dict:
    """{kernel: launches} and {kernel: {shape: launches}} of the
    contractions ``calls`` (:func:`recurrent_contractions`), by the routing
    rules; the shapes are the wrappers' keys, (m, k, n) for K1 and (B, m,
    k, n) for K2/K3.  ``virtual`` counts the calls on the virtual route."""
    n = collections.Counter({"K1": 0, "K2": 0, "K3": 0, "virtual": 0})
    shapes = {"K1": collections.Counter(), "K2": collections.Counter(),
              "K3": collections.Counter()}
    with _uncounted_routes():
        for _, batched, nb, m, k, nn in calls:
            kern = contraction_kernel(batched, nb, m, k, nn)
            if kern is None:
                n["virtual"] += 1
            else:
                n[kern] += 1
                shapes[kern][(m, k, nn) if kern == "K1"
                             else (nb, m, k, nn)] += 1
    return dict(n), shapes


def recurrent_audit(cfg, prompt_lens, decode_steps: int, batch: int,
                    cache_len: int) -> dict:
    """{site: mults} of a dense-Server run, from the config and the step
    counts: each prompt's prefill (a forward of one sequence) and its first
    token's logits (one row), and ``decode_steps`` decode steps of
    ``batch`` rows (every slot steps, live or not)."""
    sites = collections.Counter()
    calls = [c for s in prompt_lens for c in recurrent_contractions(cfg, 1, s)]
    calls += recurrent_contractions(cfg, batch, 1, cache_len) * decode_steps
    for site, _, nb, m, k, n in calls:
        sites[site] += nb * m * k * n
    return dict(sites)


def encdec_audit(cfg, prompt_lens, decode_steps: int, batch: int,
                 cache_len: int) -> dict:
    """{site: mults} of an encoder-decoder dense-Server run: each prompt's
    prefill (the encoder over ``cfg.encoder_seq`` frames, the cross K/V
    projected from its output, the decoder over the prompt) and its first
    token's logits, and ``decode_steps`` decode steps of ``batch`` rows,
    each attending to the ``cfg.encoder_seq`` cross entries of its slot:
    :func:`recurrent_audit`'s count, whose contractions
    (:func:`recurrent_contractions`) carry the encoder and the
    cross-attention."""
    return recurrent_audit(cfg, prompt_lens, decode_steps, batch, cache_len)


def _probe_rows(out, aw, bw, sa, sb, rows: int = 0):
    """``out`` and its operands cut to ``rows`` (default PROBE_ROWS) output
    rows (the first and the last half) of each batch element, where there
    are more."""
    rows = rows or PROBE_ROWS
    m, h = aw.shape[-2], rows // 2
    if m <= rows:
        return out, (aw, bw, sa, sb)
    rows = torch.cat([torch.arange(h, device=aw.device),
                      torch.arange(m - h, m, device=aw.device)])
    return out[..., rows, :], (aw[..., rows, :], bw, sa[..., rows], sb)


def _plain_probe(seen: dict, ordered: dict = None):
    """Wrap K1/K2/K3 as ``kernels.ops`` calls them, so that the first launch
    at each shape is also held to its plain version on the very operands
    the path gave it (:func:`k1_share`; the plain version in blocks of rows
    or batch elements, past K1_LINEAR_MAX_K :func:`k1_ordered`, on
    PROBE_ROWS of K1's output rows where the whole product has more than
    PROBE_TERMS terms).  ``seen`` gets (kernel,
    shape) -> the share of its tolerance, a device scalar: nothing is read
    back, so a probed step also runs under ``set_sync_debug_mode("error")``.
    With ``ordered`` (a dict) every first launch is held to
    :func:`k1_ordered`, K1's own order, within 2^-20 * (|Sa| + |Sb| +
    |ref|), on PROBE_ROWS rows of each batch element (:func:`_probe_rows`),
    and ``ordered`` gets, per (kernel, shape), on those rows: the share of
    the linear bound the plain version leaves against the launch, the
    launch's and the plain version's largest distance from the exact
    (float64) product, and max|exact|.
    Returns the function that unwraps them.  Plain calls launch no kernel,
    so the counts stay the path's."""
    from repro_torch.kernels import ops as kops
    orig = {"K1": kops.sq_matmul_k1, "K2": kops.sq_matmul_k2,
            "K3": kops.sq_matmul_k3}

    def probe(name, kern):
        def run(aw, bw, sa, sb):
            out = kern(aw, bw, sa, sb)
            shape = tuple(aw.shape) + (bw.shape[-1],)
            if (name, shape) not in seen and ordered is not None:
                got, cut = _probe_rows(out, aw, bw, sa, sb)
                seen[(name, shape)] = k1_share(got, k1_ordered(*cut), *cut,
                                               ordered=True)
                plain = (_plain_rows if name == "K1" else _plain_batched)(
                    *cut)
                exact = torch.matmul(cut[0].double(), cut[1].double())
                ordered[(name, shape)] = torch.stack([
                    k1_share(got, plain, *cut, ordered=False),
                    (got.double() - exact).abs().max(),
                    (plain.double() - exact).abs().max(),
                    exact.abs().max()])
            elif (name, shape) not in seen:
                got = out
                if name == "K1" and math.prod(shape) > PROBE_TERMS:
                    got, (aw, bw, sa, sb) = _probe_rows(out, aw, bw, sa, sb)
                ref = k1_reference(aw, bw, sa, sb, _plain_rows
                                   if name == "K1" else _plain_batched)
                seen[(name, shape)] = k1_share(got, ref, aw, bw, sa, sb)
            return out
        return run

    for name, kern in orig.items():
        setattr(kops, f"sq_matmul_{name.lower()}", probe(name, kern))

    def restore():
        for name, kern in orig.items():
            setattr(kops, f"sq_matmul_{name.lower()}", kern)
    return restore


def probe_ok(seen: dict, what: str, ordered: bool = False) -> dict:
    """Check the probed launches of :func:`_plain_probe` (``ordered``: each
    held to K1's own order); returns the shapes held to the plain version,
    by kernel."""
    shares = {k: v.item() for k, v in seen.items()}
    bad = {k: v for k, v in shares.items() if not v <= 1.0}
    worst = max(shares, key=shares.get)
    rule = ("K1's own order, k1_ordered, on up to 64 rows of each batch "
            "element, within 2^-20 * (|Sa| + |Sb| + |ref|)" if ordered else
            f"f32 |err| <= k * 2^-23 * (max|a| + max|b|)^2; past k = "
            f"{K1_LINEAR_MAX_K} K1's own order, k1_ordered, within 2^-20 * "
            f"(|Sa| + |Sb| + |ref|)")
    check(shares and not bad,
          f"{what}: the first launch at each of {len(shares)} shapes held to "
          f"its plain version on the path's own operands ({rule}); "
          f"worst {worst} at {shares[worst]:.1%} of its "
          f"bound" + (f"; off: {bad}" if bad else ""))
    shapes = {"K1": set(), "K2": set(), "K3": set()}
    for name, shape in shares:
        shapes[name].add(shape)
    return shapes


def _server_calls(server, calls: list) -> None:
    """Wrap the Server's prefill and decode calls: each appends (kind,
    prompt length or None, K1/K2/K3/K4 launch deltas, wall s) to
    ``calls``."""
    def wrap(kind, fn):
        def call(*args):
            before = counts()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            t = time.perf_counter() - t
            size = args[1]["tokens"].shape[1] if kind == "prefill" else None
            calls.append((kind, size, [a - b for a, b in zip(counts(),
                                                               before)], t))
            return out
        return call
    server._prefill = wrap("prefill", server._prefill)
    server._decode = wrap("decode", server._decode)


def _launch_vec(n: dict) -> list:
    return [n.get("K1", 0), n.get("K2", 0), n.get("K3", 0), 0]


def recurrent_calls_ok(calls, cfg, what: str, compiled: bool = False):
    """Every prefill and decode call of a Server run launched what the
    routing rules give at its shapes (a compiled run's first decode step
    twice: its capture's warm-up runs it eagerly once); returns the number
    of decode steps."""
    dec = _launch_vec(recurrent_launches(recurrent_contractions(
        cfg, DENSE_BATCH, 1, DENSE_CACHE))[0])
    decodes = [c for c in calls if c[0] == "decode"]
    prefills = [c for c in calls if c[0] == "prefill"]
    want_pre = {s: _launch_vec(recurrent_launches(recurrent_contractions(
        cfg, 1, s, logit_rows=0))[0]) for s in {c[1] for c in prefills}}
    first = [2 * x for x in dec] if compiled else dec
    check(decodes and decodes[0][2] == first
          and all(c[2] == dec for c in decodes[1:]),
          f"{what}: every decode step launches K1/K2/K3/K4 {dec} as the "
          f"routing rules give{' (the first twice)' * compiled}; "
          f"{len(decodes)} steps, seen "
          f"{sorted({tuple(c[2]) for c in decodes})}")
    check(prefills and all(c[2] == want_pre[c[1]] for c in prefills),
          f"{what}: every prefill launches what the rules give at its "
          f"length: {sorted({(c[1], tuple(c[2])) for c in prefills})}")
    return len(decodes)


def recurrent_audit_ok(audit, want: dict, what: str) -> None:
    got = {site: d["mults"] for site, d in audit.by_site().items()}
    check(got == want, f"{what}: per-site mults equal the analytic count "
                       f"{want}")
    check(audit.fraction_square == 1.0 and audit.fraction_demoted == 0.0,
          f"{what}: fraction_square {audit.fraction_square} (no policy: "
          f"every contraction square; {audit.multiplies_replaced} multiplies "
          f"replaced by squares)")


def recurrent_kernel_phase(dev, gen, cfg) -> dict:
    """K1 (m = 4 rows) and K2/K3 at the shapes of one dense decode step of
    ``cfg``, against their plain versions, timed beside torch.matmul /
    torch.bmm and the bound (K1's weights cycled past the L2); the rows for
    the kernels line."""
    _, shapes = recurrent_launches(recurrent_contractions(
        cfg, DENSE_BATCH, 1, DENSE_CACHE))
    per_step = {(k, n): c for (m, k, n), c in shapes["K1"].items()}
    k1 = k1_phase(dev, gen, [(m, k, n, True) for m, k, n in shapes["K1"]],
                  per_step=per_step, step_rows=(DENSE_BATCH,),
                  unit=f"{cfg.name} decode step")
    rows = {"K1": k1}
    for name in ("K2", "K3"):
        if shapes[name]:
            rows[name] = batched_phase(
                dev, gen, name, sorted(shapes[name]),
                unit=(f"{cfg.name} decode step", dict(shapes[name])))
    return {"rows": rows, "shapes": shapes}


def _view(model: LM, **kw) -> LM:
    """``model`` under ``cfg`` fields ``kw`` (another mode or dtype), sharing
    its modules; the weights come in as a params tree."""
    view = copy.copy(model)
    view.cfg = dataclasses.replace(model.cfg, **kw)
    return view


def _rel_max(got, ref) -> float:
    return ((got.double() - ref.double()).abs().max()
            / ref.double().abs().max().clamp_min(1e-300)).item()


def recurrent_layer_check(model: LM, dev) -> dict:
    """f32 (the model's weights, cast), teacher-forced, layer by layer: one
    decode step of 4 prefilled slots (prefilled in standard mode), each
    layer run in square_pallas and in standard mode on standard's input
    and state, with every K1/K2 launch held to the exact (float64) product
    of the operands it was given; then the logits GEMM on standard's final
    hidden state, and the decode-step logits of square_pallas against
    standard end to end (not teacher-forced).  Returns the per-layer gaps
    (|diff| / max of the block's increment, of its new state) and the
    end-to-end gap."""
    cfg = model.cfg
    p32 = tree_map(lambda t: t.float(), model.tree())
    std = _view(model, matmul_mode="standard", dtype="float32")
    sq_m = _view(model, matmul_mode="square_pallas", dtype="float32")
    prompts = [np.asarray(r.tokens, np.int32)
               for r in make_requests(cfg, DENSE_BATCH, seed=0)]
    with torch.no_grad():
        first = torch.stack([torch.argmax(std.logits(p32, std.forward(
            p32, {"tokens": torch.as_tensor(q[None], device=dev)})[0][
                :, -1:])[0, 0]) for q in prompts])
        cache, pos = _dense_prefilled(std, p32, prompts, dev)
        x = std._embed_tokens(p32, first.to(torch.int32)[:, None])
        ctx = {m: {"cfg": v.cfg, "mode": m, "policy": None, "pos": pos}
               for m, v in (("standard", std), ("square_pallas", sq_m))}
        seen, restore = _probed_kernels()
        rows = []
        k3 = sq_matmul_k3.launches
        try:
            for kind, p, c in zip(cfg.layer_kinds, p32["layers"], cache):
                c_sq = {k: t.clone() for k, t in c.items()}
                y_sq = blk.block_decode(kind, p, x, c_sq, ctx["square_pallas"])
                y = blk.block_decode(kind, p, x, c, ctx["standard"])
                state = max((_rel_max(c_sq[k], c[k]) for k in c
                             if k not in ("k", "v", "pos")), default=0.0)
                rows.append((kind, _rel_max(y_sq - x, y - x), state))
                x = y
            h = std._final_norm(p32, x)
            l_std = std.logits(p32, h)[:, 0]
            l_sq = sq_m.logits(p32, h)[:, 0]
        finally:
            restore()
        k3 = sq_matmul_k3.launches - k3
        e2e_sq = _dense_decode_logits(sq_m, p32, prompts, first, dev)
        e2e_std = _dense_decode_logits(std, p32, prompts, first, dev)
    check(k3 == 0, "no K3 on the decode path")
    bad = [r for r in seen if not r[2] <= r[3]]
    worst = max(seen, key=lambda r: r[2] / r[3])
    check(seen and not bad,
          f"f32 teacher-forced decode step: each of {len(seen)} K1/K2 "
          f"launches within its bound k * 2^-23 * (max|a| + max|b|)^2 of "
          f"the exact product of its operands; worst {worst[0]} "
          f"{worst[1]} |err| {worst[2]:.3e} of {worst[3]:.3e}")
    by_kind = collections.defaultdict(list)
    for kind, inc, st in rows:
        by_kind[kind].append((inc, st))
    for kind, vals in by_kind.items():
        inc = sorted(v[0] for v in vals)
        st = sorted(v[1] for v in vals)
        print(f"  f32 teacher-forced {kind} x{len(vals)}: block increment "
              f"|diff| / max: median {inc[len(inc) // 2]:.3e}, worst "
              f"{inc[-1]:.3e}; new state: median {st[len(st) // 2]:.3e}, "
              f"worst {st[-1]:.3e}", flush=True)
    tf = _rel_max(l_sq, l_std)
    e2e = _rel_max(e2e_sq, e2e_std)
    agree = (e2e_sq.argmax(-1) == e2e_std.argmax(-1)).float().mean().item()
    print(f"  f32 logits GEMM teacher-forced: |diff| / max {tf:.3e}; f32 "
          f"decode-step logits end to end, square_pallas vs standard: "
          f"|diff| / max {e2e:.3e}, argmax agreement {agree:.3f}; per layer "
          f"{[f'{r[1]:.1e}' for r in rows]}", flush=True)
    worst_layer = max(max(r[1], r[2]) for r in rows)
    check(worst_layer <= RECURRENT_LAYER_TOL and tf <= RECURRENT_LAYER_TOL,
          f"f32 teacher-forced: every layer's increment and new state, and "
          f"the logits GEMM, within {RECURRENT_LAYER_TOL:g} of standard's "
          f"(worst {max(worst_layer, tf):.3e})")
    check(e2e <= RECURRENT_F32_TOL and agree == 1.0,
          f"f32 decode-step logits vs standard end to end: {e2e:.3e} <= "
          f"{RECURRENT_F32_TOL:g}, the same argmax on every row")
    del p32, cache
    return {"rows": rows, "logits_tf": tf, "e2e": e2e, "agree": agree,
            "launches": len(seen),
            "worst_launch": worst[2] / worst[3]}


def recurrent_long_phase(model: LM, dev, gen) -> dict:
    """One LONG_PROMPT-token prompt in f32 (the model's weights, cast):
    prefill + one decode step against the forward over LONG_PROMPT + 1
    tokens, in standard mode at the JAX contract and in square_pallas (the
    first launch at each shape held to its plain version), each
    square_pallas result also against standard's; for xlstm, layer 0's
    mLSTM chunked against sequential."""
    cfg = model.cfg
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda t: t.float(), model.tree())
    toks = torch.randint(0, cfg.vocab, (1, LONG_PROMPT + 1), generator=gen) \
        .to(dev)
    out = {}
    seen = {}
    for mode in ("standard", "square_pallas"):
        m = _view(model, matmul_mode=mode, dtype="float32")
        restore = _plain_probe(seen) if mode == "square_pallas" else None
        try:
            with torch.no_grad():
                h, _, _ = m.forward(p32, {"tokens": toks})
                ref = m.logits(p32, h[:, -1:])[:, 0]
                del h
                _, cache = m.prefill(p32, {"tokens": toks[:, :LONG_PROMPT]},
                                     2 * LONG_PROMPT)
                got, _ = m.decode_step(p32, cache, toks[:, LONG_PROMPT:],
                                       torch.full((1,), LONG_PROMPT,
                                                  device=dev))
                del cache
        finally:
            if restore:
                restore()
        out[mode] = (ref, got)
    torch.cuda.synchronize()
    ref, got = out["standard"]
    err = (got - ref).abs()
    check(bool(torch.isfinite(got).all()) and bool(
        (err <= RECURRENT_LONG_TOL * (ref.abs() + ref.abs().max())).all()),
        f"f32 standard: prefill of {LONG_PROMPT} tokens + one decode step vs "
        f"the forward over {LONG_PROMPT + 1}: max|diff| "
        f"{err.max().item():.3e} (rtol {RECURRENT_LONG_TOL:g}, atol "
        f"{RECURRENT_LONG_TOL:g} * max|logits| = "
        f"{RECURRENT_LONG_TOL * ref.abs().max().item():.3e})")
    (sq_ref, sq_got), (st_ref, st_got) = out["square_pallas"], out["standard"]
    gaps = {"pd_vs_fwd": _rel_max(sq_got, sq_ref),
            "fwd_vs_std": _rel_max(sq_ref, st_ref),
            "pd_vs_std": _rel_max(sq_got, st_got)}
    print(f"  f32 square_pallas over {LONG_PROMPT} tokens, |diff| / "
          f"max|logits|: prefill + decode vs its forward "
          f"{gaps['pd_vs_fwd']:.3e}; forward vs standard's "
          f"{gaps['fwd_vs_std']:.3e}; prefill + decode vs standard's "
          f"{gaps['pd_vs_std']:.3e}", flush=True)
    check(bool(torch.isfinite(sq_got).all())
          and bool(torch.isfinite(sq_ref).all())
          and max(gaps.values()) <= RECURRENT_F32_TOL,
          f"f32 square_pallas long prompt: each gap <= {RECURRENT_F32_TOL:g}"
          f" * max|logits|")
    shapes = probe_ok(seen, f"long prompt ({LONG_PROMPT} tokens, f32, "
                            f"square_pallas)")
    res = {"err": err.max().item(), "gaps": gaps, "shapes": shapes}
    if "mlstm" in cfg.layer_kinds:
        from repro_torch.models import xlstm
        i = cfg.layer_kinds.index("mlstm")
        p = p32["layers"][i]
        std = _view(model, matmul_mode="standard", dtype="float32")
        with torch.no_grad():
            x = basic.rmsnorm_apply(p["ln1"], std._embed_tokens(
                p32, toks[:, :LONG_PROMPT]))
            yc, sc = xlstm.mlstm_forward(p["mix"], x, cfg=cfg32,
                                         mode="standard")
            ys, ss = xlstm.mlstm_forward(p["mix"], x, cfg=cfg32,
                                         mode="standard", sequential=True)
        ok = all(torch.allclose(a, b, rtol=2e-3, atol=2e-3)
                 for a, b in ((yc, ys), (sc["C"], ss["C"])))
        check(ok, f"layer {i}'s mLSTM over {LONG_PROMPT} tokens (f32, "
                  f"standard): chunked ({LONG_PROMPT // MLSTM_CHUNK} chunks "
                  f"of {MLSTM_CHUNK}) = sequential at rtol = atol = 2e-3 "
                  f"(tests/test_blocks_units.py): max|diff| y "
                  f"{(yc - ys).abs().max().item():.3e}, C "
                  f"{(sc['C'] - ss['C']).abs().max().item():.3e}")
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    return res


def recurrent_op_times(model: LM, params, dev) -> dict:
    """Where an eager decode step's device time goes, by operator (self
    device time of a profiled step), and the per-call preparation of the
    raw ``mix`` weights (widening and corrections, ``prepare_matmul_rhs``)
    alone, timed by graph replay."""
    from torch.autograd import DeviceType
    prompts = [np.asarray(r.tokens, np.int32)
               for r in make_requests(model.cfg, DENSE_BATCH, seed=0)]
    cache, pos = _dense_prefilled(model, params, prompts, dev)
    toks = torch.zeros((DENSE_BATCH, 1), dtype=torch.int32, device=dev)
    with torch.no_grad():
        model.decode_step(params, cache, toks, pos)
        with padded_profile() as prof:
            for _ in range(2):
                model.decode_step(params, cache, toks, pos)
    ops_ms = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CPU or not e.key.startswith("aten::"):
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us:
            ops_ms[e.key] = us / 2 / 1e3
    top = sorted(ops_ms.items(), key=lambda kv: -kv[1])[:8]
    mix = [sub["w"] for layer in params["layers"] if "mix" in layer
           for name, sub in layer["mix"].items()
           if name.startswith("w") and sub["w"].ndim == 2
           and sub["w"].dtype == torch.bfloat16]
    prep_ms = time_graph([lambda w=w: ops.prepare_matmul_rhs(w, torch.float32)
                          for w in mix], reps=len(mix), replays=3) * len(mix)
    n = sum(w.numel() for w in mix)
    print(f"  eager decode step, device time by operator (self, per step): "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in top), flush=True)
    print(f"  the raw mix weights' per-call preparation (widen to f32 and "
          f"Sb, {len(mix)} weights, {n / 1e6:.1f} M parameters) alone: "
          f"{prep_ms:.3f} ms a step by graph replay; card {CARD}",
          flush=True)
    del cache
    return {"ops_ms": dict(top), "mix_prep_ms": prep_ms, "mix_params": n}


def _replay_kernel_counts(replay, want: dict, tries: int = 4) -> list:
    """K1-K4 kernels of single profiled replays, one replay a trace, until
    one holds ``want`` or ``tries`` run out; the counts of each.  A whole
    smoke's later traces have lost a few CUPTI records (2642 device
    operations a traced xlstm step where the phase alone traces 2647, one
    K1 of 448 among them, measured on one H100), while a graph replays
    the same kernels every time: a fault in the graph misses in every
    try."""
    from torch.autograd import DeviceType
    seen = []
    for _ in range(tries):
        with padded_profile() as prof:
            replay()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        seen.append({label: sum(sym in n for n in names)
                     for label, sym in TRACE_KERNELS if label in want})
        if seen[-1] == want:
            break
    return seen


def recurrent_arch_phase(dev, gen, arch) -> dict:
    """One recurrent arch at full width (see the module docstring)."""
    cfg = recurrent_cfg(arch)
    L = cfg.n_layers
    lap = lapper()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    print(f"recurrent serving: {arch} ({cfg.source}) at its published width, "
          f"{L} of its {get_config(arch).n_layers} layers "
          f"({dict(collections.Counter(cfg.layer_kinds))}, "
          f"d={cfg.d_model} H={cfg.n_heads} V={cfg.vocab}), {cfg.dtype}, "
          f"prepared, square_pallas with every contraction square, dense "
          f"Server max_batch {DENSE_BATCH} cache_len {DENSE_CACHE}; card "
          f"{CARD}", flush=True)
    reqs = make_requests(cfg, N_REQUESTS, seed=0)
    lens = [len(r.tokens) for r in reqs]
    dec_calls = recurrent_contractions(cfg, DENSE_BATCH, 1, DENSE_CACHE)
    dec, dec_shapes = recurrent_launches(dec_calls)
    virtual = sorted({(c[0],) + c[2:] for c in dec_calls
                      if contraction_kernel(*c[1:]) is None}) \
        if dec["virtual"] else []
    print(f"  launches by the routing rules: a decode step of "
          f"{DENSE_BATCH} rows {dec} (virtual route: {virtual}); a prefill "
          f"of {sorted(set(lens))} tokens "
          f"{[recurrent_launches(recurrent_contractions(cfg, 1, s))[0] for s in sorted(set(lens))]}",
          flush=True)
    kern = recurrent_kernel_phase(dev, gen, cfg)
    lap("the kernels at a decode step's shapes")
    launched, l_run, model = launcher_serve(arch, serve_cut(arch))
    with torch.no_grad():
        params = model.prepare_params()

    # a warm-up run that also holds the first launch at each shape of the
    # path to its plain version on the path's own operands
    seen = {}
    restore = _plain_probe(seen)
    try:
        warm = Server(model, params, ServeConfig(
            max_batch=DENSE_BATCH, cache_len=DENSE_CACHE,
            max_new_tokens=MAX_NEW, jit=False), device=dev).run(reqs)
    finally:
        restore()
    compared = probe_ok(seen, f"{arch} Server, eager")
    for key, held in kern["shapes"].items():    # held by the kernel phase
        compared[key] |= set(held)
    check(launched == warm, "launcher tokens = the eager Server's (the "
                            "launcher's own seed-0 weights and prompts)")
    shapes_ok(compared)
    l_counts, l_audit, l_eager, l_wall = l_run

    lap("the launcher and the probed warm-up run")

    # the Server eager, counted and audited
    server = Server(model, params, ServeConfig(
        max_batch=DENSE_BATCH, cache_len=DENSE_CACHE,
        max_new_tokens=MAX_NEW, jit=False), device=dev)
    calls = []
    _server_calls(server, calls)
    reset_counts()
    with counting.track_contractions() as audit:
        eager = server.run(reqs)
    torch.cuda.synchronize()
    launches = {"eager": dict(zip(("K1", "K2", "K3", "K4"), counts()))}
    check(eager == warm, "eager Server tokens = the warm-up run's")
    steps = recurrent_calls_ok(calls, cfg, "eager Server")
    shapes_ok(compared)
    want = recurrent_audit(cfg, lens, steps, DENSE_BATCH, DENSE_CACHE)
    recurrent_audit_ok(audit, want, "eager Server audit")
    check(launches["eager"]["K4"] == 0, "no K4 on the dense Server's path")
    lw = sum(l_audit.by_site()[s]["mults"] for s in l_audit.by_site()) + \
        sum(l_eager.by_site()[s]["mults"] for s in l_eager.by_site())
    l_pre = recurrent_audit(cfg, lens, 0, DENSE_BATCH, DENSE_CACHE)
    check({s: d["mults"] for s, d in l_eager.by_site().items()} == l_pre
          and lw == sum(want.values()),
          f"launcher audit: eager prefills {sum(l_pre.values())} + compiled "
          f"replays = the analytic {sum(want.values())} multiplies")
    recurrent_audit_ok(l_audit, recurrent_audit(cfg, [], steps, DENSE_BATCH,
                                                DENSE_CACHE),
                       "launcher compiled audit (its replays)")
    # prefills with their first tokens' logits, then the decode steps and
    # the capture's warm-up (one eager decode step)
    l_want = collections.Counter()
    for s_len in lens:
        l_want.update(recurrent_launches(recurrent_contractions(
            cfg, 1, s_len))[0])
    for key in ("K1", "K2", "K3"):
        l_want[key] += dec[key] * (steps + 1)
    check(all(l_counts[k] == l_want[k] for k in ("K1", "K2", "K3"))
          and l_counts["K4"] == 0,
          f"launcher launches {l_counts}: the prefills' and first tokens' by "
          f"the rules, {steps} replayed decode steps and the capture's "
          f"warm-up at {dec}: {dict(l_want)}")

    # the Server with its decode step captured: twice, the same tokens
    gserver = Server(model, params, ServeConfig(
        max_batch=DENSE_BATCH, cache_len=DENSE_CACHE,
        max_new_tokens=MAX_NEW), device=dev)
    check(gserver.jit, "the Server captures its decode step by default on "
                       "CUDA")
    gcalls = []
    _server_calls(gserver, gcalls)
    ptrs = [t.data_ptr() for t in tree_leaves(gserver.cache)]
    reset_counts()
    with counting.compiled_audit(), \
            counting.track_compiled_contractions() as g_audit:
        graph = gserver.run(reqs)
    torch.cuda.synchronize()
    launches["graph"] = dict(zip(("K1", "K2", "K3", "K4"), counts()))
    check(graph == eager, "replayed tokens = eager tokens")
    gsteps = recurrent_calls_ok(gcalls, cfg, "captured Server (by the "
                                             "ledger)", compiled=True)
    recurrent_audit_ok(g_audit, recurrent_audit(cfg, [], gsteps, DENSE_BATCH,
                                                DENSE_CACHE),
                       "captured Server compiled audit (its replays)")
    shapes_ok(compared)
    again = gserver.run(reqs)
    check(again == eager and gserver._graph_set.captures == 1
          and gserver.graph.replays == 2 * gsteps
          and [t.data_ptr() for t in tree_leaves(gserver.cache)] == ptrs,
          f"a second run of the captured Server: the same tokens, 1 capture "
          f"(no re-capture), {gserver.graph.replays} replays, its cache "
          f"tensors where they were")

    lap("the Server eager and captured, twice")

    # eager and replayed in turns
    runs = {"eager": [], "graph": []}
    for i, kind in enumerate(("eager", "graph", "graph", "eager")):
        s = gserver if kind == "graph" else Server(
            model, params, ServeConfig(max_batch=DENSE_BATCH,
                                       cache_len=DENSE_CACHE,
                                       max_new_tokens=MAX_NEW, jit=False),
            device=dev)
        tcalls = []
        _server_calls(s, tcalls)
        t0 = time.perf_counter()
        got = s.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(got == eager, f"turn {i + 1} ({kind}): the eager tokens")
        walls = sorted(c[3] for c in tcalls if c[0] == "decode")
        pre = sorted(c[3] for c in tcalls if c[0] == "prefill")
        runs[kind].append({"wall": wall, "walls": walls,
                           "tokens_per_s": N_REQUESTS * MAX_NEW / wall,
                           "prefill_s": pre[len(pre) // 2]})
        print(f"  turn {i + 1} {kind}: {N_REQUESTS * MAX_NEW / wall:.1f} "
              f"tokens/s, decode step {_walls_str(walls)}, prefill median "
              f"{pre[len(pre) // 2] * 1e3:.2f} ms; card {CARD}", flush=True)
    med = {k: sorted(w for r in v for w in r["walls"])[
        len(v[0]["walls"] + v[1]["walls"]) // 2] for k, v in runs.items()}
    stats = {"graph": trace_steps(gserver.graph.replay,
                                  f"replayed {arch} decode steps",
                                  med["graph"])}
    want_dec = {k: dec[k] for k in ("K1", "K2", "K3")}
    want_dec["K4"] = 0
    seen_counts = _replay_kernel_counts(gserver.graph.replay, want_dec)
    check(seen_counts[-1] == want_dec,
          f"a profiled replay holds {seen_counts[-1]} kernels, the rules' "
          f"{want_dec} (replays profiled one at a time, up to 4, until one "
          f"holds them: {seen_counts})")
    prompts = [np.asarray(r.tokens, np.int32) for r in reqs[:DENSE_BATCH]]
    cache, pos = _dense_prefilled(model, params, prompts, dev)
    toks = torch.zeros((DENSE_BATCH, 1), dtype=torch.int32, device=dev)
    with torch.no_grad():
        stats["eager"] = trace_steps(
            lambda: model.decode_step(params, cache, toks, pos),
            f"eager {arch} decode steps", med["eager"], calls=2)
    del cache
    lap("turns and traces")
    std = dense_logits_phase(model, params, dev,
                             tol=RECURRENT_STD_TOL[arch])
    lap("bf16 logits against standard")
    layers = recurrent_layer_check(model, dev)
    lap("the f32 layer check")
    op_times = recurrent_op_times(model, params, dev)
    # the long prompt's bf16 prefill wall, then its f32 checks
    ltoks = torch.randint(0, cfg.vocab, (1, LONG_PROMPT), generator=gen) \
        .to(dev)
    pw = []
    with torch.no_grad():
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.prefill(params, {"tokens": ltoks}, 2 * LONG_PROMPT)
            torch.cuda.synchronize()
            pw.append(time.perf_counter() - t0)
    print(f"  bf16 prefill of {LONG_PROMPT} tokens (prepared, square_pallas):"
          f" {', '.join(f'{w * 1e3:.1f}' for w in pw)} ms; card {CARD}",
          flush=True)
    lap("operator times and the bf16 long prefill")
    long = recurrent_long_phase(model, dev, gen)
    lap("the f32 long prompt")
    peak = torch.cuda.max_memory_allocated()
    del model, params, server, gserver
    gc.collect()
    torch.cuda.empty_cache()
    for k in ("eager", "graph"):
        st = stats[k]
        if not st:
            continue
        print(f"  {arch} {k}: {runs[k][0]['tokens_per_s']:.1f} and "
              f"{runs[k][1]['tokens_per_s']:.1f} tokens/s, median decode "
              f"step {med[k] * 1e3:.2f} ms (untraced, synchronized); traced "
              f"step: {st['ops']:.0f} device operations, busy "
              f"{st['busy_ms']:.3f} ms = {st['busy_ms'] / (med[k] * 1e3):.1%}"
              f" of the untraced step, K1 {st['K1_ms']:.3f} ms, K2 "
              f"{st['K2_ms']:.3f} ms, K3 {st['K3_ms']:.3f} ms, other "
              f"{st['busy_ms'] - st['K1_ms'] - st['K2_ms'] - st['K3_ms']:.3f}"
              f" ms; card {CARD}", flush=True)
    print(f"  memory: allocated before {_gib(mem0)}, peak {_gib(peak)}, "
          f"after {_gib(torch.cuda.memory_allocated())}; launcher run "
          f"{l_wall:.1f} s; card {CARD}", flush=True)
    return {"cfg": cfg, "dec": dec, "kern": kern, "steps": steps,
            "launches": dict(launches, launcher=l_counts),
            "step_ms": {k: v * 1e3 for k, v in med.items()},
            "tokens_per_s": {k: [r["tokens_per_s"] for r in v]
                             for k, v in runs.items()},
            "prefill_long_ms": [w * 1e3 for w in pw], "std": std,
            "layers": layers, "op_times": op_times, "long": long,
            "trace": stats}


@contextlib.contextmanager
def _kept_model(built: list, draw=None):
    """Keep the model ``repro_torch.launch.serve`` builds (appended to
    ``built``), so that the phase serves the launcher's own weights after
    it and draws none of its own.  With ``draw`` (:func:`device_model`)
    the launcher's weights are drawn on the device from its seed instead
    of on the host."""
    make = serve_launcher.build_model

    def keep(cfg, device=None, seed=0):
        built.append(draw(cfg, torch.device(device or "cuda"), seed)
                     if draw else make(cfg, device=device, seed=seed))
        return built[-1]
    serve_launcher.build_model = keep
    try:
        yield
    finally:
        serve_launcher.build_model = make


def launcher_serve(arch, extra=(), draw=None) -> tuple:
    """``python -m repro_torch.launch.serve --arch <arch> --matmul-mode
    square_pallas --prepared`` (and ``extra``, a depth cut) on the card,
    compiled (its default on CUDA), under the compiled and the eager
    audit: the JAX launcher's fallback note, every request's MAX_NEW
    tokens.  Returns its tokens, (its K1-K4 launches, the compiled audit,
    the eager audit, its wall s) and the model it built (weights drawn
    from seed 0 on the host, or by ``draw``, :func:`_kept_model`), which
    the phase serves after it."""
    built = []
    reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with counting.compiled_audit(), \
            counting.track_compiled_contractions() as l_audit, \
            counting.track_contractions() as l_eager, \
            contextlib.redirect_stdout(buf), _kept_model(built, draw):
        launched = serve_launcher.main(["--arch", arch, "--matmul-mode",
                                        "square_pallas", "--prepared",
                                        *extra])
    torch.cuda.synchronize()
    l_wall = time.perf_counter() - t0
    print("\n".join("  | " + s for s in buf.getvalue().splitlines()),
          flush=True)
    l_counts = dict(zip(("K1", "K2", "K3", "K4"), counts()))
    check(f"note: arch {arch!r} has non-KV decode state; falling back to "
          f"the dense reference Server" in buf.getvalue(),
          "the launcher without --legacy falls back to the dense Server "
          "with the JAX launcher's note")
    check(sorted(launched) == list(range(N_REQUESTS))
          and all(len(t) == MAX_NEW for t in launched.values()),
          f"launcher: {N_REQUESTS} requests with {MAX_NEW} tokens each")
    check(len(built) == 1, "the launcher built one model")
    print(f"  the launcher {' '.join(extra)} (its weights drawn from seed 0 "
          f"on the {'device' if draw else 'host'}, prepared, served) took "
          f"{l_wall:.1f} s; the phase serves its "
          f"model after it; allocated {_gib(torch.cuda.memory_allocated())}"
          f"; card {CARD}", flush=True)
    return launched, (l_counts, l_audit, l_eager, l_wall), built[0]


def recurrent_phase(dev, gen) -> dict:
    """Both archs, then what the kernels line takes from them: the K1-K3
    entries (:func:`recurrent_entries`) and each kernel's launches by
    path."""
    rec = {arch: recurrent_arch_phase(dev, gen, arch)
           for arch in RECURRENT_ARCHS}
    k1, k2, k3 = ({"max_abs_err": 0.0} for _ in range(3))
    recurrent_entries(k1, k2, k3, rec)
    launches = {kern: {f"{path}_{arch}": r["launches"][key][kern]
                       for arch, r in rec.items()
                       for path, key in (("recurrent_launcher", "launcher"),
                                         ("recurrent_server", "eager"),
                                         ("recurrent_server_graph", "graph"))}
                for kern in ("K1", "K2", "K3")}
    return {"entries": {"K1": k1, "K2": k2, "K3": k3}, "launches": launches}


RECURRENT_FLAG = "--recurrent-phase"


def phase_isolated(flag: str, what: str, *args: str) -> dict:
    """A phase run in a process of its own (``chip_smoke.py FLAG FILE``),
    which writes its results to a JSON file under ``build/``: a fresh CUDA
    context and profiler.  In one long process the later traces lose a
    few CUPTI records (on one H100, a replay traced 198 of its 201 K1
    kernels, every try, after the MoE phases, and a MoE train replay 63
    of its 64 in four single-replay traces after the MoE serving phase),
    while tokens and ledgers stay exact."""
    return phase_join(phase_start(flag, *args), what)


def phase_start(flag: str, *args: str, name: str = None) -> tuple:
    """Start :func:`phase_isolated`'s process; returns it and its file
    (``build/<name>.json``, the flag's name by default)."""
    out = Path(__file__).resolve().parent / "build" / \
        f"{name or flag.strip('-')}.json"
    out.parent.mkdir(exist_ok=True)
    out.unlink(missing_ok=True)
    gc.collect()
    torch.cuda.empty_cache()
    sys.stdout.flush()
    return subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             flag, str(out), *args]), out


def phase_join(started, what: str, timeout: float = 900):
    """Wait for a :func:`phase_start`'s process, or for a list of them
    (every one killed past ``timeout``), and read its results (a list of
    them for a list)."""
    group = started if isinstance(started, list) else [started]
    deadline = time.monotonic() + timeout
    rcs = []
    try:
        for proc, _ in group:
            try:
                rcs.append(proc.wait(
                    timeout=max(0.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                rcs.append(None)
    finally:
        for proc, _ in group:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    check(rcs == [0] * len(group) and all(out.exists() for _, out in group),
          f"{what}, in a process of its own, ran to its end (exit "
          f"{rcs if isinstance(started, list) else rcs[0]})")
    res = [json.loads(out.read_text()) for _, out in group]
    return res if isinstance(started, list) else res[0]


def recurrent_entries(k1, k2, k3, rec) -> None:
    """Add recurrent serving to the K1, K2 and K3 entries of the kernels
    line: per dense decode step of each arch, the launches by the routing
    rules (checked by counter, ledger and profiler) and the time at its
    shapes."""
    for kern, key in ((k1, "K1"), (k2, "K2"), (k3, "K3")):
        kern["recurrent"] = {}
        for arch, r in rec.items():
            rows = r["kern"]["rows"].get(key, [])
            shapes = r["kern"]["shapes"][key]
            mult = ((lambda row: sum(c for (m, k, n), c in shapes.items()
                                     if (k, n) == (row["k"], row["n"])))
                    if key == "K1" else (lambda row: shapes[row["shape"]]))
            entry = {"per": f"one dense decode step of {arch} at its "
                            f"published width, {served_depth(arch)}, "
                            f"{DENSE_BATCH} rows",
                     "launches_per_decode_step": r["dec"][key]}
            if rows:
                entry.update({k: sum(mult(row) * row[k] for row in rows)
                              for k in ("ms", "plain_ms", "library_ms",
                                        "bound_ms")},
                             max_abs_err=max(row["max_abs_err"]
                                             for row in rows))
                kern["max_abs_err"] = max(kern["max_abs_err"],
                                          entry["max_abs_err"])
            kern["recurrent"][arch] = entry


# ------------------------------------------------------ encoder-decoder
ENCDEC_ARCH = "whisper-large-v3"
ENCDEC_FLAG = "--encdec-phase"
# the archs whose training launches are held to K1's own order
# (ENCDEC_PROBE_NOTE): whisper's cross-attention and encoder PV, and
# paligemma's PV over its 512 positions, where Sb = -sum v^2 dwarfs the
# result and K1's partial 0 drifts
ORDERED_ARCHS = ("whisper-large-v3", "paligemma-3b")
# decode-step logits against standard mode (bf16): the dense LM's bound
ENCDEC_STD_TOL = 2e-2
# ENCDEC_PROBE_NOTE: the first launch at each shape of the Server run is
# held to K1's own order (k1_ordered), not to the plain version's linear
# bound.  On the path's own operands the plain version left up to 1.65 x
# k * 2^-23 * (max|a| + max|b|)^2 against K2 at the cross-attention's PV
# (softmax weights x the encoder's V, k = 1024 and 1500; measured on one
# H100): there Sb = -sum v^2 dwarfs the result sum p v, and K1's partial 0,
# seeded with Sa + Sb, drifts as it does past K1_LINEAR_MAX_K.  The kernel
# rows on random operands still hold the linear bound at every shape.


def probe_linear_report(linear: dict) -> dict:
    """Print what the plain version (slabs of 16 added to one accumulator)
    leaves against each probed launch, as a share of the linear bound k *
    2^-23 * (max|a| + max|b|)^2, and both outputs' distance from the exact
    product, for the shapes past that bound (:func:`_plain_probe`'s
    ``ordered``); returns them by shape."""
    vals = {k: v.tolist() for k, v in linear.items()}
    over = {k: v for k, v in vals.items() if v[0] > 1.0}
    worst = max(vals, key=lambda k: vals[k][0])
    print(f"  (reported) the plain version against the same launches: worst "
          f"{worst} at {vals[worst][0]:.1%} of the linear bound; "
          f"{len(over)} of {len(vals)} shapes past it" + "".join(
              f"; {k}: {v[0]:.1%}, from the exact product the launch "
              f"{v[1]:.3e} and the plain version {v[2]:.3e} (max|exact| "
              f"{v[3]:.3e})" for k, v in sorted(over.items())), flush=True)
    return {str(k): v for k, v in vals.items()}


def _ordered_kernels():
    """Wrap K1, K2 and K3 as ``kernels.ops`` calls them, so that every
    launch is held to :func:`k1_ordered` (K1's own order) on PROBE_ROWS // 8
    output rows of each batch element (:func:`_probe_rows`), within 2^-20 *
    (|Sa| + |Sb| + |ref|), and its distance from the exact (float64)
    product on those rows is measured beside the linear bound k * 2^-23 *
    (max|a| + max|b|)^2: returns the list each launch's (kernel, shape,
    share of the ordered tolerance, |err| from the exact product, the
    linear bound, max|exact|) joins when the wrap is undone, and the
    function that unwraps them.  Nothing is read back before then."""
    from repro_torch.kernels import ops as kops
    seen, pending = [], []
    orig = {"K1": kops.sq_matmul_k1, "K2": kops.sq_matmul_k2,
            "K3": kops.sq_matmul_k3}

    def probe(name, kern):
        def run(aw, bw, sa, sb):
            out = kern(aw, bw, sa, sb)
            got, cut = _probe_rows(out, aw, bw, sa, sb, PROBE_ROWS // 8)
            exact = torch.matmul(cut[0].double(), cut[1].double())
            pending.append((name, tuple(aw.shape) + (bw.shape[-1],),
                            torch.stack([
                                k1_share(got, k1_ordered(*cut), *cut,
                                         ordered=True).double(),
                                (got.double() - exact).abs().max(),
                                torch.as_tensor(k1_tol(exact, *cut,
                                                       ordered=False)
                                                ).double(),
                                exact.abs().max()])))
            return out
        return run

    for name, kern in orig.items():
        setattr(kops, f"sq_matmul_{name.lower()}", probe(name, kern))

    def restore():
        for name, kern in orig.items():
            setattr(kops, f"sq_matmul_{name.lower()}", kern)
        if pending:
            values = torch.stack([v for _, _, v in pending]).cpu().tolist()
            seen.extend((name, shape, *v)
                        for (name, shape, _), v in zip(pending, values))
            pending.clear()
    return seen, restore


def encdec_prefill_shapes(cfg) -> dict:
    """{kernel: Counter(shape: launches a prefill)} of the prefill's
    contractions that do not depend on the prompt: the encoder's layers
    over ``cfg.encoder_seq`` frames and the cross K/V projected from its
    output, by the routing rules (the decoder's, at the prompt's length,
    are held at their first launch on the path's own operands)."""
    Te, d = cfg.encoder_seq, cfg.d_model
    kv = cfg.n_kv_heads * cfg.resolved_head_dim
    calls = layer_contractions(cfg, "attn", 1, Te) * cfg.encoder_layers
    calls += [("attn_qkv", False, 1, Te, d, kv)] * (2 * cfg.n_layers)
    return recurrent_launches(calls)[1]


# LAYER_WITNESS_NOTE: paligemma's f32 teacher-forced decode layers sat
# 4.5e-3 to 7.5e-3 from standard's (every layer; whisper's and the
# recurrent LMs' at most 2.5e-3) and its decode-step logits 2.74e-2 end to
# end, with every launch equal to K1's own order and within the linear
# bound of the exact product (measured on one H100).  There the gap is the
# square form's f32 rounding at one site, not a kernel's fault: for the
# archs of LAYER_WITNESS_ARCHS alone, the worst layer is run again with
# one site at a time on standard, and the gates become LAYER_CATCH a layer
# and F32_CATCH end to end with every site square, and the usual
# RECURRENT_LAYER_TOL and RECURRENT_F32_TOL with the witnessed site on
# standard.  Every other arch (whisper) keeps those two gates with every
# site square.  A wrong or missing contraction is off by ~1 and fails
# either way.
LAYER_WITNESS_ARCHS = ("paligemma-3b",)
LAYER_SITES = ("attn_qkv", "attn_scores", "attn_pv", "attn_out", "ffn")
LAYER_CATCH = 1e-2
F32_CATCH = 5e-2


def encdec_layer_check(model: LM, dev) -> dict:
    """f32 (the model's weights, cast), teacher-forced, against standard
    mode (an arch with no encoder -- paligemma -- starts at the decode
    step): the encoder over DENSE_BATCH requests' frames layer by layer,
    each layer run in square_pallas and standard on standard's input (its
    increment's |diff| / max), and the encoder's output end to end; then
    one decode step of DENSE_BATCH slots prefilled in standard mode (fed
    standard's first tokens), each decoder layer likewise on standard's
    input and cache, and the logits GEMM on standard's final hidden
    state.  Every K1/K2/K3 launch of the
    teacher-forced runs is held to the exact (float64) product of its
    operands.  Last, the decode-step logits of square_pallas against
    standard end to end (not teacher-forced)."""
    cfg = model.cfg
    p32 = tree_map(lambda t: t.float(), model.tree())
    std = _view(model, matmul_mode="standard", dtype="float32")
    sq_m = _view(model, matmul_mode="square_pallas", dtype="float32")
    reqs = make_requests(cfg, DENSE_BATCH, seed=0)
    enc_rows, dec_rows = [], []
    with torch.no_grad():
        if cfg.encoder_layers:
            frames = torch.as_tensor(np.stack([r.extras["frames"]
                                               for r in reqs]), device=dev)
            T = frames.shape[1]
            ectx = {m: {"cfg": v.cfg, "mode": m, "policy": None,
                        "causal": False,
                        "positions": torch.arange(T, device=dev)}
                    for m, v in (("standard", std), ("square_pallas", sq_m))}
            enc_sq, enc_std = sq_m.encode(p32, frames), std.encode(p32,
                                                                   frames)
        cache, first = std.init_cache(DENSE_BATCH, DENSE_CACHE), []
        for i, r in enumerate(reqs):           # standard's prefills
            hidden, one = std.prefill(p32, _one_batch(r, dev), DENSE_CACHE)
            first.append(std.logits(p32, hidden[:, -1:])[0, 0].argmax())
            write_slot(cache, i, one)
        first = torch.stack(first)
        pos = torch.as_tensor([len(r.tokens) + cfg.prefix_tokens
                               for r in reqs], device=dev)
        dctx = {m: {"cfg": v.cfg, "mode": m, "policy": None, "pos": pos}
                for m, v in (("standard", std), ("square_pallas", sq_m))}
        seen, restore = _ordered_kernels()
        try:
            if cfg.encoder_layers:
                x = frames
                for p in p32["encoder"]["layers"]:
                    y_sq = blk.block_forward("attn", p, x,
                                             ectx["square_pallas"])[0]
                    y = blk.block_forward("attn", p, x, ectx["standard"])[0]
                    enc_rows.append(_rel_max(y_sq - x, y - x))
                    x = y
            x = std._embed_tokens(p32, first.to(torch.int32)[:, None])
            pre = []              # each layer's input, cache and output
            for kind, p, c in zip(std.kinds, p32["layers"], cache):
                c_sq = {k: t.clone() for k, t in c.items()}
                pre.append((x, {k: t.clone() for k, t in c.items()}))
                y_sq = blk.block_decode(kind, p, x, c_sq,
                                        dctx["square_pallas"])
                y = blk.block_decode(kind, p, x, c, dctx["standard"])
                dec_rows.append(_rel_max(y_sq - x, y - x))
                pre[-1] += (y,)
                x = y
            h = std._final_norm(p32, x)
            l_std = std.logits(p32, h)[:, 0]
            l_sq = sq_m.logits(p32, h)[:, 0]
        finally:
            restore()
        e2e_sq = _dense_decode_logits(sq_m, p32, reqs, first, dev)
        # LAYER_WITNESS_NOTE: past the layer gate (LAYER_WITNESS_ARCHS),
        # the worst decoder layer again with one site at a time on
        # standard, and the decode-step logits end to end with the site
        # that closes the gap most
        witness, e2e_w = {}, None
        i = max(range(len(dec_rows)), key=dec_rows.__getitem__)
        if (cfg.name in LAYER_WITNESS_ARCHS
                and dec_rows[i] > RECURRENT_LAYER_TOL):
            x0, c0, y0 = pre[i]
            for site in LAYER_SITES:
                c_w = {k: t.clone() for k, t in c0.items()}
                y_w = blk.block_decode(std.kinds[i], p32["layers"][i], x0,
                                       c_w, dict(dctx["square_pallas"],
                                                 policy=_policy((site,))))
                witness[site] = _rel_max(y_w - x0, y0 - x0)
            best = min(witness, key=witness.get)
            sq_w = _view(model, matmul_mode="square_pallas", dtype="float32",
                         contraction_policy=_policy((best,)))
            e2e_w = (best, _rel_max(_dense_decode_logits(
                sq_w, p32, reqs, first, dev), l_std))
        del pre
    e2e_std = l_std        # standard's step end to end: its own inputs
    bad = [r for r in seen if not r[2] <= 1.0]
    worst = max(seen, key=lambda r: r[2])
    far = max(seen, key=lambda r: r[3] / r[4])
    check(seen and not bad,
          f"f32 teacher-forced encoder and decode step: each of {len(seen)} "
          f"K1/K2/K3 launches held to K1's own order (k1_ordered) on 8 rows "
          f"of each batch element, within 2^-20 * (|Sa| + |Sb| + |ref|); "
          f"worst {worst[0]} {worst[1]} at {worst[2]:.1%}")
    print(f"  (reported) their distance from the exact product: "
          f"{sum(r[3] > r[4] for r in seen)} of {len(seen)} launches past the "
          f"linear bound k * 2^-23 * (max|a| + max|b|)^2, the farthest "
          f"{far[0]} {far[1]} |err| {far[3]:.3e} = {far[3] / far[4]:.1%} of "
          f"it (max|exact| {far[5]:.3e})", flush=True)
    enc_e2e = _rel_max(enc_sq, enc_std) if cfg.encoder_layers else 0.0
    tf = _rel_max(l_sq, l_std)
    e2e = _rel_max(e2e_sq, e2e_std)
    agree = (e2e_sq.argmax(-1) == e2e_std.argmax(-1)).float().mean().item()
    for what, rows in (("encoder attn", enc_rows),
                       (f"decoder {model.kinds[0]}", dec_rows)):
        if not rows:
            continue
        srt = sorted(rows)
        print(f"  f32 teacher-forced {what} x{len(rows)}: block increment "
              f"|diff| / max: median {srt[len(srt) // 2]:.3e}, worst "
              f"{srt[-1]:.3e}; per layer {[f'{r:.1e}' for r in rows]}",
              flush=True)
    enc_s = (f"encoder output end to end (4 x {cfg.encoder_seq} frames), "
             f"square_pallas vs standard: |diff| / max {enc_e2e:.3e}; "
             if cfg.encoder_layers else "")
    print(f"  f32 {enc_s}logits GEMM "
          f"teacher-forced {tf:.3e}; decode-step logits end to end "
          f"{e2e:.3e}, argmax agreement {agree:.3f}; card {CARD}",
          flush=True)
    worst_layer = max(enc_rows + dec_rows + [tf])
    if witness:
        best, e2e_best = e2e_w
        print(f"  the worst decoder layer ({i}, {dec_rows[i]:.3e}) with one "
              f"site on standard: "
              + ", ".join(f"{k} {v:.3e}" for k, v in witness.items())
              + f"; the decode-step logits end to end with {best} on "
              f"standard {e2e_best:.3e}", flush=True)
        check(worst_layer <= LAYER_CATCH and witness[best] <=
              RECURRENT_LAYER_TOL and e2e <= F32_CATCH
              and e2e_best <= RECURRENT_F32_TOL and agree == 1.0
              and enc_e2e <= RECURRENT_F32_TOL,
              f"f32 teacher-forced: every layer's increment and the logits "
              f"GEMM within {LAYER_CATCH:g} of standard's (worst "
              f"{worst_layer:.3e}), the worst within {RECURRENT_LAYER_TOL:g} "
              f"with {best} on standard ({witness[best]:.3e}); the "
              f"decode-step logits end to end {e2e:.3e} <= {F32_CATCH:g}, "
              f"{e2e_best:.3e} <= {RECURRENT_F32_TOL:g} with {best} on "
              f"standard, the same argmax on every row (LAYER_WITNESS_NOTE)")
    else:
        check(worst_layer <= RECURRENT_LAYER_TOL,
              f"f32 teacher-forced: every encoder and decoder layer's "
              f"increment and the logits GEMM within {RECURRENT_LAYER_TOL:g} "
              f"of standard's (worst {worst_layer:.3e})")
        check(enc_e2e <= RECURRENT_F32_TOL and e2e <= RECURRENT_F32_TOL
              and agree == 1.0,
              f"f32 end to end: the encoder's output {enc_e2e:.3e} and the "
              f"decode-step logits {e2e:.3e} <= {RECURRENT_F32_TOL:g} * max, "
              f"the same argmax on every row")
    del p32, cache
    gc.collect()
    torch.cuda.empty_cache()
    return {"encoder": enc_rows, "decoder": dec_rows, "logits_tf": tf,
            "encoder_e2e": enc_e2e, "e2e": e2e, "agree": agree,
            "witness": witness, "e2e_witness": e2e_w,
            "launches": len(seen), "worst_launch": worst[2],
            "farthest_linear": far[3] / far[4]}


def ttft_walls(model: LM, params, dev) -> tuple:
    """The first launcher request and the TTFT of it on an idle Server (its
    prefill with its extras, its first token's logits and the sample,
    synchronized), 3 times, in s."""
    req = make_requests(model.cfg, 1, seed=0)[0]
    walls = []
    with torch.no_grad():
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hidden, _ = model.prefill(params, _one_batch(req, dev),
                                      DENSE_CACHE)
            int(model.logits(params, hidden[:, -1:])[0, 0].argmax())
            walls.append(time.perf_counter() - t0)
    return req, walls


def encdec_times(model: LM, params, server, dev) -> dict:
    """TTFT of one request on an idle Server (:func:`ttft_walls`, median
    of 3) and the cross-attention's f32 widening of the encoder's K/V in a
    decode step alone (``attention.attn_decode``'s ``k.float()``,
    ``v.float()`` over every layer's cross cache), by graph replay."""
    req, walls = ttft_walls(model, params, dev)
    cross = [t for layer in server.cache for key, t in layer.items()
             if key in ("xk", "xv")]
    widen_ms = time_graph([lambda: [t.float() for t in cross]], reps=2,
                          replays=3)
    n = sum(t.numel() for t in cross)
    print(f"  TTFT of one request on an idle Server ({len(req.tokens)} "
          f"tokens, {model.cfg.encoder_seq} frames): "
          f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms; the cross "
          f"K/V's f32 widening a decode step ({len(cross)} tensors, "
          f"{n / 1e6:.1f} M bf16 entries, {6 * n / 2 ** 30:.2f} GiB moved) "
          f"alone {widen_ms:.3f} ms by graph replay; card {CARD}",
          flush=True)
    return {"ttft_ms": sorted(walls)[1] * 1e3, "widen_ms": widen_ms,
            "widen_entries": n}


def encdec_phase(dev, gen) -> dict:
    """whisper-large-v3 at its published width and full depth, served by
    the dense Server eager and with its decode step replayed (see the
    module docstring); returns what the kernels line takes from it."""
    arch = ENCDEC_ARCH
    cfg = recurrent_cfg(arch)
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    full = get_config(arch)
    print(f"encoder-decoder serving: {arch} ({cfg.source}) at its published "
          f"width ({cfg.encoder_layers} of its {full.encoder_layers} encoder "
          f"layers over {cfg.encoder_seq} frames, {cfg.n_layers} of its "
          f"{full.n_layers} xdec layers, d="
          f"{cfg.d_model} H={cfg.n_heads}x{cfg.resolved_head_dim} ff="
          f"{cfg.d_ff} {cfg.activation} {cfg.norm} V={cfg.vocab}), "
          f"{cfg.dtype}, prepared, square_pallas with every contraction "
          f"square, dense Server max_batch {DENSE_BATCH} cache_len "
          f"{DENSE_CACHE}; card {CARD}", flush=True)
    reqs = make_requests(cfg, N_REQUESTS, seed=0)
    lens = [len(r.tokens) for r in reqs]
    dec_calls = recurrent_contractions(cfg, DENSE_BATCH, 1, DENSE_CACHE)
    dec = recurrent_launches(dec_calls)[0]
    pre = {s: recurrent_launches(recurrent_contractions(
        cfg, 1, s, logit_rows=0))[0] for s in sorted(set(lens))}
    print(f"  launches by the routing rules: a decode step of {DENSE_BATCH} "
          f"rows {dec}; a prefill of {sorted(pre)} tokens (the first "
          f"token's logits apart) {list(pre.values())}", flush=True)
    L = cfg.n_layers
    check(dec["virtual"] == 0 and dec["K1"] == L * 8 + 1
          and dec["K2"] + dec["K3"] == L * 4,
          f"a decode step: K1 {dec['K1']} = {L} x (4 self + 2 cross + 2 "
          f"FFN) + the logits, {dec['K2'] + dec['K3']} batched launches = "
          f"{L} x (self scores, self PV, cross scores, cross PV), none "
          f"virtual")
    kern = recurrent_kernel_phase(dev, gen, cfg)
    pre_shapes = encdec_prefill_shapes(cfg)
    pre_rows = recurrent_train_kernel_rows(
        dev, torch.Generator(device=dev).manual_seed(1), cfg,
        {"shapes": pre_shapes}, unit="prefill")
    lap_kern = time.perf_counter() - t_phase

    launched, l_run, model = launcher_serve(arch, serve_cut(arch))
    lap_launcher = time.perf_counter() - t_phase - lap_kern
    with torch.no_grad():
        params = model.prepare_params()
    scfg = dict(max_batch=DENSE_BATCH, cache_len=DENSE_CACHE,
                max_new_tokens=MAX_NEW)
    # the Server eager: counted, audited, and the first launch at each
    # shape held to K1's own order (ENCDEC_PROBE_NOTE; the probes launch
    # no kernel and note no contraction)
    server = Server(model, params, ServeConfig(**scfg, jit=False),
                    device=dev)
    calls = []
    _server_calls(server, calls)
    seen, linear = {}, {}
    reset_counts()
    restore = _plain_probe(seen, linear)
    try:
        with counting.track_contractions() as audit:
            eager = server.run(reqs)
    finally:
        restore()
    torch.cuda.synchronize()
    launches = {"eager": dict(zip(("K1", "K2", "K3", "K4"), counts()))}
    compared = probe_ok(seen, f"{arch} Server, eager", ordered=True)
    probe_linear_report(linear)
    for held in (kern["shapes"], pre_shapes):   # held by the kernel rows
        for key, shapes in held.items():
            compared[key] |= set(shapes)
    check(launched == eager, "launcher tokens = the eager Server's (the "
                             "launcher's own seed-0 weights and requests)")
    l_counts, l_audit, l_eager, l_wall = l_run
    steps = recurrent_calls_ok(calls, cfg, "eager Server")
    shapes_ok(compared)
    want = encdec_audit(cfg, lens, steps, DENSE_BATCH, DENSE_CACHE)
    recurrent_audit_ok(audit, want, "eager Server audit (encdec_audit)")
    check(launches["eager"]["K4"] == 0, "no K4 on the dense Server's path")
    lw = sum(d["mults"] for d in l_audit.by_site().values()) + \
        sum(d["mults"] for d in l_eager.by_site().values())
    l_pre = encdec_audit(cfg, lens, 0, DENSE_BATCH, DENSE_CACHE)
    check({s: d["mults"] for s, d in l_eager.by_site().items()} == l_pre
          and lw == sum(want.values()),
          f"launcher audit: eager prefills {sum(l_pre.values())} + compiled "
          f"replays = the analytic {sum(want.values())} multiplies")
    recurrent_audit_ok(l_audit, encdec_audit(cfg, [], steps, DENSE_BATCH,
                                             DENSE_CACHE),
                       "launcher compiled audit (its replays)")
    l_want = collections.Counter()
    for s_len in lens:
        l_want.update(recurrent_launches(recurrent_contractions(
            cfg, 1, s_len))[0])
    for key in ("K1", "K2", "K3"):
        l_want[key] += dec[key] * (steps + 1)
    check(all(l_counts[k] == l_want[k] for k in ("K1", "K2", "K3"))
          and l_counts["K4"] == 0,
          f"launcher launches {l_counts}: the prefills' and first tokens' by "
          f"the rules, {steps} replayed decode steps and the capture's "
          f"warm-up at {dec}")

    # the Server with its decode step captured: 8 requests over 4 slots,
    # so 4 inserts after the capture replace a slot's encoder K/V in the
    # cache the graph reads; twice, the same tokens
    gserver = Server(model, params, ServeConfig(**scfg), device=dev)
    check(gserver.jit, "the Server captures its decode step by default on "
                       "CUDA")
    gcalls = []
    _server_calls(gserver, gcalls)
    ptrs = [t.data_ptr() for t in tree_leaves(gserver.cache)]
    reset_counts()
    with counting.compiled_audit(), \
            counting.track_compiled_contractions() as g_audit:
        graph = gserver.run(reqs)
    torch.cuda.synchronize()
    launches["graph"] = dict(zip(("K1", "K2", "K3", "K4"), counts()))
    inserts = sum(c[0] == "prefill" for c in gcalls)
    check(graph == eager,
          f"replayed tokens = eager tokens ({inserts} inserts over "
          f"{DENSE_BATCH} slots, {inserts - DENSE_BATCH} of them after the "
          f"capture, each writing its slot's encoder K/V into the cache the "
          f"graph reads)")
    gsteps = recurrent_calls_ok(gcalls, cfg, "captured Server (by the "
                                             "ledger)", compiled=True)
    recurrent_audit_ok(g_audit, encdec_audit(cfg, [], gsteps, DENSE_BATCH,
                                             DENSE_CACHE),
                       "captured Server compiled audit (its replays)")
    shapes_ok(compared)

    # eager and replayed in turns, the replayed turn the captured Server's
    # second run: the runs above (the eager one probed and audited, the
    # replayed one capturing) are not timed
    runs = {}
    for i, kind in enumerate(("eager", "graph")):
        s = gserver if kind == "graph" else Server(
            model, params, ServeConfig(**scfg, jit=False), device=dev)
        tcalls = []
        _server_calls(s, tcalls)
        t0 = time.perf_counter()
        got = s.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(got == eager, f"turn {i + 1} ({kind}): the eager tokens")
        walls = sorted(c[3] for c in tcalls if c[0] == "decode")
        pw = sorted(c[3] for c in tcalls if c[0] == "prefill")
        runs[kind] = {"wall": wall, "walls": walls,
                      "tokens_per_s": N_REQUESTS * MAX_NEW / wall,
                      "prefill_s": pw[len(pw) // 2]}
        print(f"  turn {i + 1} {kind}: {N_REQUESTS * MAX_NEW / wall:.1f} "
              f"tokens/s, decode step {_walls_str(walls)}, prefill median "
              f"{pw[len(pw) // 2] * 1e3:.2f} ms; card {CARD}", flush=True)
    check(gserver._graph_set.captures == 1
          and gserver.graph.replays == 2 * gsteps
          and [t.data_ptr() for t in tree_leaves(gserver.cache)] == ptrs,
          f"the captured Server's second run (turn 2): the same tokens, 1 "
          f"capture (no re-capture), {gserver.graph.replays} replays, its "
          f"cache tensors where they were")
    med = {k: r["walls"][len(r["walls"]) // 2] for k, r in runs.items()}
    stats = {"graph": trace_steps(gserver.graph.replay,
                                  f"replayed {arch} decode steps",
                                  med["graph"])}
    want_dec = {k: dec[k] for k in ("K1", "K2", "K3")}
    want_dec["K4"] = 0
    seen_counts = _replay_kernel_counts(gserver.graph.replay, want_dec)
    check(seen_counts[-1] == want_dec,
          f"a profiled replay holds {seen_counts[-1]} kernels, the rules' "
          f"{want_dec} (replays profiled one at a time, up to 4, until one "
          f"holds them: {seen_counts})")
    cache, pos = _dense_prefilled(model, params, reqs[:DENSE_BATCH], dev)
    toks = torch.zeros((DENSE_BATCH, 1), dtype=torch.int32, device=dev)
    with torch.no_grad():
        stats["eager"] = trace_steps(
            lambda: model.decode_step(params, cache, toks, pos),
            f"eager {arch} decode steps", med["eager"], calls=2)
    del cache
    times = encdec_times(model, params, gserver, dev)
    lap_serve = time.perf_counter() - t_phase - lap_kern - lap_launcher

    std = dense_logits_phase(model, params, dev, tol=ENCDEC_STD_TOL)
    del server, gserver
    gc.collect()
    torch.cuda.empty_cache()
    layers = encdec_layer_check(model, dev)
    peak = torch.cuda.max_memory_allocated()
    for k in ("eager", "graph"):
        st = stats[k]
        if not st:
            continue
        kk = st["K1_ms"] + st["K2_ms"] + st["K3_ms"]
        print(f"  {arch} {k}: {runs[k]['tokens_per_s']:.1f} tokens/s, "
              f"median decode step {med[k] * 1e3:.2f} ms (untraced, "
              f"synchronized); traced step: {st['ops']:.0f} device "
              f"operations, busy {st['busy_ms']:.3f} ms = "
              f"{st['busy_ms'] / (med[k] * 1e3):.1%} of the untraced step, "
              f"K1 {st['K1_ms']:.3f} ms, K2 {st['K2_ms']:.3f} ms, K3 "
              f"{st['K3_ms']:.3f} ms ({kk:.3f} ms = "
              f"{kk / st['busy_ms']:.1%} of busy), the cross K/V's widening "
              f"alone {times['widen_ms']:.3f} ms, other "
              f"{st['busy_ms'] - kk:.3f} ms; card {CARD}", flush=True)
    print(f"  phase {time.perf_counter() - t_phase:.1f} s: kernels "
          f"{lap_kern:.1f} s, the launcher {lap_launcher:.1f} s ({l_wall:.1f}"
          f" s its run), the Server runs, turns and traces {lap_serve:.1f} "
          f"s, the numerics the rest; peak allocation {_gib(peak)}; card "
          f"{CARD}", flush=True)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    res = {"dec": dec, "pre": {str(k): v for k, v in pre.items()},
           "kern": kern, "pre_rows": pre_rows,
           "pre_shapes": {k: {str(s): n for s, n in v.items()}
                          for k, v in pre_shapes.items()},
           "steps": steps, "launches": dict(launches, launcher=l_counts),
           "step_ms": {k: v * 1e3 for k, v in med.items()},
           "tokens_per_s": {k: r["tokens_per_s"] for k, r in runs.items()},
           "prefill_ms": {k: r["prefill_s"] * 1e3 for k, r in runs.items()},
           "times": times, "std": std, "layers": layers,
           "trace": {k: {n: v for n, v in st.items() if n != "other"}
                     for k, st in stats.items()},
           "phase_s": time.perf_counter() - t_phase,
           "encoder_seq": cfg.encoder_seq}
    k1, k2, k3 = ({"max_abs_err": 0.0} for _ in range(3))
    encdec_entries(k1, k2, k3, res)
    return {"entries": {"K1": k1, "K2": k2, "K3": k3},
            "launches": {kern_: {f"encdec_{path}": res["launches"][key][kern_]
                                 for path, key in (
                                     ("launcher", "launcher"),
                                     ("server", "eager"),
                                     ("server_graph", "graph"))}
                         for kern_ in ("K1", "K2", "K3")},
           "summary": {k: res[k] for k in ("dec", "pre", "steps", "step_ms",
                                           "tokens_per_s", "prefill_ms",
                                           "times", "std", "layers",
                                           "trace", "phase_s")}}


def encdec_entries(k1, k2, k3, res) -> None:
    """Add encoder-decoder serving to the K1, K2 and K3 entries of the
    kernels line (:func:`serve_entries`): per dense decode step of
    whisper-large-v3 (4 rows) and per prefill's prompt-independent part
    (the encoder and the cross K/V)."""
    serve_entries(k1, k2, k3, res, ENCDEC_ARCH, "encdec",
                  f"one prefill's encoder over {res['encoder_seq']} frames "
                  f"and its cross K/V (the prompt's own contractions apart)")


def serve_entries(k1, k2, k3, res, arch, name, prefill_per) -> None:
    """Add a dense-Server path to the K1, K2 and K3 entries of the kernels
    line under ``name``: per dense decode step of ``arch`` (4 rows) and
    per ``prefill_per`` (``res["pre_rows"]``), the launches by the routing
    rules (checked by counter, ledger and profiler) and the time at their
    shapes."""
    for kern, key in ((k1, "K1"), (k2, "K2"), (k3, "K3")):
        rows = res["kern"]["rows"].get(key, [])
        shapes = res["kern"]["shapes"][key]
        mult = ((lambda row: sum(c for (m, k, n), c in shapes.items()
                                 if m == DENSE_BATCH
                                 and (k, n) == (row["k"], row["n"])))
                if key == "K1" else (lambda row: shapes[row["shape"]]))
        entry = {"per": f"one dense decode step of {arch} at its "
                        f"published width, {served_depth(arch)}, "
                        f"{DENSE_BATCH} rows",
                 "launches_per_decode_step": res["dec"][key]}
        if rows:
            entry.update({k: sum(mult(row) * row[k] for row in rows)
                          for k in ("ms", "plain_ms", "library_ms",
                                    "bound_ms")},
                         max_abs_err=max(row["max_abs_err"] for row in rows))
        mine = [r for r in res["pre_rows"] if r["kernel"] == key]
        if mine:
            t_bytes = sum(x["per_step"] * x["t_bytes"] for x in mine)
            t_ops = sum(x["per_step"] * x["t_ops"] for x in mine)
            entry["prefill"] = {
                "per": prefill_per,
                "launches": sum(x["per_step"] for x in mine),
                **{k: sum(x["per_step"] * (x[k] or 0) for x in mine)
                   for k in ("ms", "plain_ms", "library_ms")},
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "max_abs_err": max(x["max_abs_err"] for x in mine)}
        errs = [entry.get("max_abs_err", 0.0),
                entry.get("prefill", {}).get("max_abs_err", 0.0)]
        kern["max_abs_err"] = max([kern["max_abs_err"]] + errs)
        kern[name] = entry


# ------------------------------------------------- prefix-token serving
VLM_ARCH = "paligemma-3b"
VLM_FLAG = "--vlm-phase"
# The phase's Server holds a whole sequence: the 256 patches, the longest
# of the launcher's prompts (23 tokens) and MAX_NEW.  The launcher's own
# cache_len 128 rolls the last 128 positions of each prefill into its ring
# and clamps each decode step's write at the last slot, as the JAX
# reference's does; its run is held to the eager Server at that length.
VLM_CACHE = 320
LAUNCHER_CACHE = 128
# decode-step logits against standard mode (bf16), with the same argmax
# on every row.  paligemma's bf16 square_pallas left 2.72e-2 of max|logits|
# in its runs on one H100 (2e-2, the dense LM's bound, failed), and in f32
# its square form alone left 2.74e-2 (LAYER_WITNESS_NOTE): the gap is the
# square form's f32 rounding at the GeGLU, not bf16's.  The gate is that
# reading with a margin of about half of it; a wrong or missing
# contraction moves the logits by ~1 of max and fails it.
VLM_STD_TOL = 4e-2


def vlm_ttft(model: LM, params, dev) -> list:
    """TTFT of one request on an idle Server (:func:`ttft_walls`), its
    prefill over the patches and the prompt."""
    req, walls = ttft_walls(model, params, dev)
    print(f"  TTFT of one request on an idle Server ({model.cfg.prefix_tokens}"
          f" patches + {len(req.tokens)} tokens): "
          f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms; card {CARD}",
          flush=True)
    return walls


def vlm_phase(dev, gen) -> dict:
    """paligemma-3b at its published width and SERVE_LAYERS' depth (its
    weights drawn on the device from seed 0), its launcher's 8 requests with their
    256 patches served by the dense Server, eager and with its decode step
    replayed; the launcher at its own cache_len; bf16 logits and the f32
    layers against standard.  Runs in a process of its own
    (:func:`phase_isolated`), whose DENSE_CACHE it sets to VLM_CACHE."""
    global DENSE_CACHE
    DENSE_CACHE = VLM_CACHE
    arch = VLM_ARCH
    cfg = recurrent_cfg(arch)
    P, L = cfg.prefix_tokens, cfg.n_layers
    t_phase = time.perf_counter()
    lap = lapper()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"prefix-token serving: {arch} ({cfg.source}) at its published "
          f"width, {served_depth(arch)} (L={L}, d={cfg.d_model} H={cfg.n_heads}x"
          f"{cfg.resolved_head_dim} over {cfg.n_kv_heads} KV head, ff="
          f"{cfg.d_ff} {cfg.activation}, V={cfg.vocab} padded to "
          f"{cfg.padded_vocab}, {P} prefix patches), {cfg.dtype}, prepared, "
          f"square_pallas with every contraction square, dense Server "
          f"max_batch {DENSE_BATCH} cache_len {DENSE_CACHE}; card {CARD}",
          flush=True)
    reqs = make_requests(cfg, N_REQUESTS, seed=0)
    lens = [len(r.tokens) for r in reqs]
    dec = recurrent_launches(recurrent_contractions(
        cfg, DENSE_BATCH, 1, DENSE_CACHE))[0]
    pre = {s: recurrent_launches(recurrent_contractions(
        cfg, 1, s, logit_rows=0))[0] for s in sorted(set(lens))}
    print(f"  launches by the routing rules: a decode step of {DENSE_BATCH} "
          f"rows {dec}; a prefill of {P} + {sorted(pre)} positions (the "
          f"first token's logits apart) {list(pre.values())}", flush=True)
    check(dec["virtual"] == 0 and dec["K1"] == L * 7 + 1
          and dec["K2"] + dec["K3"] == L * 2,
          f"a decode step: K1 {dec['K1']} = {L} x (4 attention + 3 GeGLU) "
          f"+ the logits, {dec['K2'] + dec['K3']} batched launches = {L} x "
          f"(scores, PV), none virtual")
    kern = recurrent_kernel_phase(dev, gen, cfg)
    s_med = sorted(lens)[len(lens) // 2]
    pre_shapes = recurrent_launches(recurrent_contractions(
        cfg, 1, s_med, logit_rows=0))[1]
    pre_rows = recurrent_train_kernel_rows(
        dev, torch.Generator(device=dev).manual_seed(1), cfg,
        {"shapes": pre_shapes}, unit=f"prefill of {P} + {s_med}")
    lap("the kernels at a decode step's and a prefill's shapes")

    # the launcher, its weights drawn on the device (2.5 G parameters: a
    # host draw takes tens of seconds) and served after it
    launched, l_run, model = launcher_serve(arch, serve_cut(arch),
                                            draw=device_model)
    l_counts, l_audit, l_eager, l_wall = l_run
    with torch.no_grad():
        params = model.prepare_params()
    lap("the launcher")
    scfg = dict(max_batch=DENSE_BATCH, cache_len=DENSE_CACHE,
                max_new_tokens=MAX_NEW)
    server = Server(model, params, ServeConfig(**scfg, jit=False),
                    device=dev)
    calls = []
    _server_calls(server, calls)
    seen, linear = {}, {}
    reset_counts()
    restore = _plain_probe(seen, linear)
    try:
        with counting.track_contractions() as audit:
            eager = server.run(reqs)
    finally:
        restore()
    torch.cuda.synchronize()
    launches = {"eager": dict(zip(("K1", "K2", "K3", "K4"), counts()))}
    compared = probe_ok(seen, f"{arch} Server, eager", ordered=True)
    probe_linear_report(linear)
    for held in (kern["shapes"], pre_shapes):   # held by the kernel rows
        for key, shapes in held.items():
            compared[key] |= set(shapes)
    check(sorted(eager) == list(range(N_REQUESTS))
          and all(len(t) == MAX_NEW for t in eager.values()),
          f"{N_REQUESTS} requests with {MAX_NEW} tokens each")
    steps = recurrent_calls_ok(calls, cfg, "eager Server")
    shapes_ok(compared)
    want = recurrent_audit(cfg, lens, steps, DENSE_BATCH, DENSE_CACHE)
    recurrent_audit_ok(audit, want, "eager Server audit (recurrent_audit: "
                                    "each prefill over P + S positions)")
    check(launches["eager"]["K4"] == 0, "no K4 on the dense Server's path")

    # the launcher's geometry: its tokens are the eager Server's at its
    # own cache_len, whose ring the prefill overflows
    short = Server(model, params, ServeConfig(
        max_batch=DENSE_BATCH, cache_len=LAUNCHER_CACHE,
        max_new_tokens=MAX_NEW, jit=False), device=dev).run(reqs)
    differ = sum(short[r] != eager[r] for r in eager)
    check(launched == short,
          f"launcher tokens = the eager Server's at its cache_len "
          f"{LAUNCHER_CACHE} (P + S = {P + min(lens)}-{P + max(lens)} "
          f"positions roll into the ring; {differ} of {N_REQUESTS} "
          f"requests' tokens differ from the whole cache's)")
    l_want_audit = recurrent_audit(cfg, lens, steps, DENSE_BATCH,
                                   LAUNCHER_CACHE)
    lw = sum(d["mults"] for d in l_audit.by_site().values()) + \
        sum(d["mults"] for d in l_eager.by_site().values())
    l_pre = recurrent_audit(cfg, lens, 0, DENSE_BATCH, LAUNCHER_CACHE)
    check({s: d["mults"] for s, d in l_eager.by_site().items()} == l_pre
          and lw == sum(l_want_audit.values()),
          f"launcher audit: eager prefills {sum(l_pre.values())} + compiled "
          f"replays = the analytic {sum(l_want_audit.values())} multiplies")
    recurrent_audit_ok(l_audit, recurrent_audit(
        cfg, [], steps, DENSE_BATCH, LAUNCHER_CACHE),
        "launcher compiled audit (its replays)")
    l_dec = recurrent_launches(recurrent_contractions(
        cfg, DENSE_BATCH, 1, LAUNCHER_CACHE))[0]
    l_want = collections.Counter()
    for s_len in lens:
        l_want.update(recurrent_launches(recurrent_contractions(
            cfg, 1, s_len))[0])
    for key in ("K1", "K2", "K3"):
        l_want[key] += l_dec[key] * (steps + 1)
    check(all(l_counts[k] == l_want[k] for k in ("K1", "K2", "K3"))
          and l_counts["K4"] == 0,
          f"launcher launches {l_counts}: the prefills' and first tokens' by "
          f"the rules, {steps} replayed decode steps and the capture's "
          f"warm-up at {l_dec}")
    lap("the Server eager, probed and audited, and at the launcher's cache")

    # the Server with its decode step captured: 8 requests over 4 slots,
    # 4 inserts after the capture; twice, the same tokens
    gserver = Server(model, params, ServeConfig(**scfg), device=dev)
    check(gserver.jit, "the Server captures its decode step by default on "
                       "CUDA")
    gcalls = []
    _server_calls(gserver, gcalls)
    ptrs = [t.data_ptr() for t in tree_leaves(gserver.cache)]
    reset_counts()
    with counting.compiled_audit(), \
            counting.track_compiled_contractions() as g_audit:
        graph = gserver.run(reqs)
    torch.cuda.synchronize()
    launches["graph"] = dict(zip(("K1", "K2", "K3", "K4"), counts()))
    check(graph == eager, "replayed tokens = eager tokens")
    gsteps = recurrent_calls_ok(gcalls, cfg, "captured Server (by the "
                                             "ledger)", compiled=True)
    recurrent_audit_ok(g_audit, recurrent_audit(cfg, [], gsteps, DENSE_BATCH,
                                                DENSE_CACHE),
                       "captured Server compiled audit (its replays)")
    shapes_ok(compared)
    runs = {}
    for i, kind in enumerate(("eager", "graph")):
        srv = gserver if kind == "graph" else Server(
            model, params, ServeConfig(**scfg, jit=False), device=dev)
        tcalls = []
        _server_calls(srv, tcalls)
        t0 = time.perf_counter()
        got = srv.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(got == eager, f"turn {i + 1} ({kind}): the eager tokens")
        walls = sorted(c[3] for c in tcalls if c[0] == "decode")
        pw = sorted(c[3] for c in tcalls if c[0] == "prefill")
        runs[kind] = {"wall": wall, "walls": walls,
                      "tokens_per_s": N_REQUESTS * MAX_NEW / wall,
                      "prefill_s": pw[len(pw) // 2]}
        print(f"  turn {i + 1} {kind}: {N_REQUESTS * MAX_NEW / wall:.1f} "
              f"tokens/s, decode step {_walls_str(walls)}, prefill median "
              f"{pw[len(pw) // 2] * 1e3:.2f} ms; card {CARD}", flush=True)
    check(gserver._graph_set.captures == 1
          and gserver.graph.replays == 2 * gsteps
          and [t.data_ptr() for t in tree_leaves(gserver.cache)] == ptrs,
          f"the captured Server's second run (turn 2): the same tokens, 1 "
          f"capture (no re-capture), {gserver.graph.replays} replays, its "
          f"cache tensors where they were")
    med = {k: r["walls"][len(r["walls"]) // 2] for k, r in runs.items()}
    stats = {"graph": trace_steps(gserver.graph.replay,
                                  f"replayed {arch} decode steps",
                                  med["graph"])}
    want_dec = {k: dec[k] for k in ("K1", "K2", "K3")}
    want_dec["K4"] = 0
    seen_counts = _replay_kernel_counts(gserver.graph.replay, want_dec)
    check(seen_counts[-1] == want_dec,
          f"a profiled replay holds {seen_counts[-1]} kernels, the rules' "
          f"{want_dec} (replays profiled one at a time, up to 4, until one "
          f"holds them: {seen_counts})")
    cache, pos = _dense_prefilled(model, params, reqs[:DENSE_BATCH], dev)
    toks = torch.zeros((DENSE_BATCH, 1), dtype=torch.int32, device=dev)
    with torch.no_grad():
        stats["eager"] = trace_steps(
            lambda: model.decode_step(params, cache, toks, pos),
            f"eager {arch} decode steps", med["eager"], calls=2)
    del cache
    ttft = vlm_ttft(model, params, dev)
    lap("the captured Server, turns, traces and TTFT")

    del server, gserver
    gc.collect()
    torch.cuda.empty_cache()
    layers = encdec_layer_check(model, dev)
    std = dense_logits_phase(model, params, dev, tol=VLM_STD_TOL)
    lap("the f32 layers and bf16 logits against standard")
    peak = torch.cuda.max_memory_allocated()
    for k in ("eager", "graph"):
        st = stats[k]
        if not st:
            continue
        kk = st["K1_ms"] + st["K2_ms"] + st["K3_ms"]
        print(f"  {arch} {k}: {runs[k]['tokens_per_s']:.1f} tokens/s, "
              f"median decode step {med[k] * 1e3:.2f} ms (untraced, "
              f"synchronized); traced step: {st['ops']:.0f} device "
              f"operations, busy {st['busy_ms']:.3f} ms = "
              f"{st['busy_ms'] / (med[k] * 1e3):.1%} of the untraced step, "
              f"K1 {st['K1_ms']:.3f} ms, K2 {st['K2_ms']:.3f} ms, K3 "
              f"{st['K3_ms']:.3f} ms ({kk:.3f} ms = "
              f"{kk / st['busy_ms']:.1%} of busy), other "
              f"{st['busy_ms'] - kk:.3f} ms; card {CARD}", flush=True)
    print(f"  phase {time.perf_counter() - t_phase:.1f} s, the launcher "
          f"{l_wall:.1f} s of it; peak allocation {_gib(peak)}; card {CARD}",
          flush=True)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    res = {"dec": dec, "pre": {str(k): v for k, v in pre.items()},
           "kern": kern, "pre_rows": pre_rows, "steps": steps,
           "launches": dict(launches, launcher=l_counts),
           "step_ms": {k: v * 1e3 for k, v in med.items()},
           "tokens_per_s": {k: r["tokens_per_s"] for k, r in runs.items()},
           "prefill_ms": {k: r["prefill_s"] * 1e3 for k, r in runs.items()},
           "ttft_ms": sorted(ttft)[1] * 1e3, "std": std, "layers": layers,
           "trace": {k: {n: v for n, v in st.items() if n != "other"}
                     for k, st in stats.items()},
           "phase_s": time.perf_counter() - t_phase}
    k1, k2, k3 = ({"max_abs_err": 0.0} for _ in range(3))
    serve_entries(k1, k2, k3, res, arch, "vlm",
                  f"one prefill of {P} patches + {s_med} tokens (the first "
                  f"token's logits apart)")
    return {"entries": {"K1": k1, "K2": k2, "K3": k3},
            "launches": {kern_: {f"vlm_{path}": res["launches"][key][kern_]
                                 for path, key in (
                                     ("launcher", "launcher"),
                                     ("server", "eager"),
                                     ("server_graph", "graph"))}
                         for kern_ in ("K1", "K2", "K3")},
            "summary": {k: res[k] for k in ("dec", "pre", "steps", "step_ms",
                                            "tokens_per_s", "prefill_ms",
                                            "ttft_ms", "std", "layers",
                                            "trace", "phase_s")}}


# ---------------------------------------------------- recurrent training
# (B, S) of a train step: 2048 tokens, as the dense and MoE phases take.
# recurrentgemma's 1024 tokens stay within its 2048-token local window;
# xlstm's 512 span two 256-token mLSTM chunks and 512 sLSTM steps.
RECURRENT_TRAIN_BS = {"recurrentgemma-2b": (2, 1024), "xlstm-350m": (4, 512),
                      # paligemma: 2 x (256 patches + 256 tokens); whisper:
                      # 2 x 128 tokens over 2 x 1500 frames
                      "paligemma-3b": (2, 256), "whisper-large-v3": (2, 128)}
GRADS = ("x", "w")


def recurrent_train_contractions(cfg, B: int, S: int) -> list:
    """(site, batched, nb, m, k, n, grads) of each forward contraction of
    one train step of B sequences of S tokens (the layers', then the
    chunked loss's vocab GEMMs), in the canonical (nb, m, k, n) the
    dispatch plans.  ``grads``: the gradients autograd computes of it,
    ``"x"`` (dL/dx, canonical (nb, m, n, k)) and ``"w"`` (dL/dW, (nb, n, m,
    k)); each has the forward's multiplies.  Three kinds of contraction
    have fewer than two:

    - the first mLSTM chunk contracts ``q`` with the zero initial state
      ``C`` and ``n``, which ask for no gradient: its ``h_inter`` and
      ``n_inter`` have dL/dx only;
    - the last mLSTM chunk carries ``C`` and ``n`` into the final state,
      which training drops: those two reach no loss, and autograd runs
      neither of their gradients;
    - the sLSTM's step 0 contracts the zero initial ``h``: dL/dW only.

    An encoder-decoder arch's encoder layers come first, over
    ``cfg.encoder_seq`` frames, and its decoder layers are ``xdec`` (the
    cross K/V projected from the encoder's output); a prefix arch's
    layers run over its ``cfg.prefix_tokens`` patches and the S tokens,
    while the loss's vocab GEMMs cover the S text positions only."""
    out = []
    for _ in range(cfg.encoder_layers):
        out += [c + (GRADS,) for c in layer_contractions(
            cfg, "attn", B, cfg.encoder_seq)]
    for kind in decoder_kinds(cfg):
        calls = layer_contractions(cfg, kind, B, S + cfg.prefix_tokens)
        grads = [GRADS] * len(calls)
        if kind == "mlstm":
            nc = -(-S // min(MLSTM_CHUNK, S))
            first = 5                        # w_in, wq, wk, wv, w_if
            for i in (0, 1):
                grads[first + i] = ("x",)
            for i in (4, 5):
                grads[first + 6 * (nc - 1) + i] = ()
        elif kind == "slstm":
            grads[1] = ("w",)
        out += [c + (g,) for c, g in zip(calls, grads)]
    c = min(cfg.loss_chunk, S)
    for _ in range(-(-S // c)):
        out.append(("loss", False, 1, B * c, cfg.d_model, cfg.padded_vocab,
                    GRADS))
    return out


def grad_shape(grad: str, nb: int, m: int, k: int, n: int) -> tuple:
    """The canonical (nb, m, k, n) of a forward contraction's dL/dx
    (``"x"``) or dL/dW (``"w"``): ``einsum(out, y -> x)`` and ``einsum(out,
    x -> y)`` in the VJP."""
    return (nb, m, n, k) if grad == "x" else (nb, n, m, k)


def recurrent_train_audit(cfg, B: int, S: int) -> dict:
    """{site: mults} of one train step, the analytic count: each forward
    contraction's nb*m*k*n at its site, and again at ``<site>.bwd_x`` /
    ``<site>.bwd_w`` for each gradient autograd computes of it
    (:func:`recurrent_train_contractions`); a rematerialised recompute
    notes nothing.  So it is 3 x the forward's multiplies less the
    gradients never computed."""
    sites = collections.Counter()
    for site, _, nb, m, k, n, grads in recurrent_train_contractions(cfg, B,
                                                                    S):
        sites[site] += nb * m * k * n
        for g in grads:
            sites[f"{site}.bwd_{g}"] += nb * m * k * n
    return dict(sites)


def recurrent_train_launches(cfg, B: int, S: int) -> dict:
    """{part: Counter(kernel: launches)} of one square_pallas train step by
    the routing rules, ``virtual`` counting the calls on the virtual route:
    the forward; the backward (each gradient autograd computes); the
    recompute (under remat "block" every layer contraction again but the
    encoder's first layer's, whose input, the frames, asks for no
    gradient, so ``counting.remat`` runs it without a checkpoint; the
    loss's chunks at either setting, as its chunk body is rematerialised).
    Also ``shapes``: {kernel: Counter(shape: launches a step)}, the shape a
    wrapper's key ((m, k, n) for K1, (nb, m, k, n) for K2/K3)."""
    out = {p: collections.Counter() for p in
           ("forward", "backward", "recompute")}
    shapes = {k: collections.Counter() for k in ("K1", "K2", "K3")}

    def add(part, batched, nb, m, k, n):
        kern = contraction_kernel(batched, nb, m, k, n)
        out[part][kern or "virtual"] += 1
        if kern:
            shapes[kern][(m, k, n) if kern == "K1" else (nb, m, k, n)] += 1

    first = len(layer_contractions(cfg, "attn", B, cfg.encoder_seq)) \
        if cfg.encoder_layers else 0
    with _uncounted_routes():
        for i, (site, batched, nb, m, k, n, grads) in enumerate(
                recurrent_train_contractions(cfg, B, S)):
            add("forward", batched, nb, m, k, n)
            for g in grads:
                add("backward", batched, *grad_shape(g, nb, m, k, n))
            if site == "loss" or (cfg.remat == "block" and i >= first):
                add("recompute", batched, nb, m, k, n)
    out["shapes"] = shapes
    return out


# Depth of the bf16 main path: recurrentgemma's whole captured step (~32 B
# a parameter, 2.89 G parameters) does not fit the card (at 7 of its 8
# (rglru, rglru, lattn) periods the eager steps beside the captured one
# ran out of the card's memory, measured on one H100); it trains its first
# period (3 layers), where every kind, shape
# and kernel of the step runs, in the smoke's time limit.  xlstm
# trains its first (mlstm x 7, slstm) period of three: every kind, shape
# and kernel of its step at a third of the host-bound work (its eager
# step, its 2.8e5-node capture and trace, its f32 parity took ~260 s of
# the smoke at 24 layers).
# paligemma's whole step (2.51 G parameters, ~30 GB of weights,
# gradients and AdamW state before the eager step beside the captured
# one) would not fit as recurrentgemma's did not; at 2 of its 18 layers
# every shape and kernel of its step runs.  whisper trains 2 encoder and
# 2 decoder layers (an encoder-decoder arch is cut as deep on both
# sides, :func:`recurrent_train_cfg`).
RECURRENT_TRAIN_LAYERS = {"recurrentgemma-2b": 3, "xlstm-350m": 8,
                          "paligemma-3b": 2, "whisper-large-v3": 2}
# the f32 parity against standard: each at one period (1 layer, 1 + 1)
RECURRENT_F32_LAYERS = {"recurrentgemma-2b": 3, "xlstm-350m": 8,
                        "paligemma-3b": 1, "whisper-large-v3": 1}
# the archs whose eager step is traced: xlstm's holds 2.7e5 device
# operations beside as many host ones, and reading its trace took ~2 min
# of the smoke (measured on one H100: busy 1397.8 ms, 9.3 % of the traced
# step's wall)
EAGER_TRACED = ("recurrentgemma-2b",)
RECURRENT_TRAINER_STEPS = 2
# the launcher on the card: recurrentgemma at its first period (rglru,
# rglru, lattn) (the host draw and the final checkpoint of its 655
# M-parameter tied table set its time at any depth), xlstm at one mLSTM
# layer (its period of 8, whose eager warm-up step is host-bound, until
# the planner and attention-options phases were added; the phase above
# trains the whole period)
RECURRENT_LAUNCHER_LAYERS = {"recurrentgemma-2b": 3, "xlstm-350m": 1,
                             "paligemma-3b": 1, "whisper-large-v3": 1}
RECURRENT_LAUNCHER_STEPS = 2
# xlstm's gradient control: every f32 parameter times (1 + 2^-20)
GRAD_BUMP = 2.0 ** -20
# a probed launch at more terms than this is held to the plain version
# on PROBE_ROWS of its output rows (the first and the last half)
PROBE_TERMS = 2 ** 33
# a kernel row times the plain version up to this many terms (the plain
# version of one of recurrentgemma's 1.34e12-term vocab GEMMs takes ~9 s)
PLAIN_TIMED_TERMS = 2 ** 38
# recurrentgemma's f32 gradients of the loss x 2^14 against standard's,
# the loss's vocab GEMM on standard in both runs (PR 27's rule for
# moonshot: K1's dL/dx of the loss sums V terms in 8 sequential partials),
# each tensor within RECURRENT_GRAD_RTOL.  A tensor past it is held to
# RECURRENT_GRAD_RTOL in a witness run that moves one more site to
# standard in both runs (:func:`site_witness`): the site whose square form
# sets that gap.  Every tensor with the loss alone on standard stays
# within RECURRENT_GRAD_CATCH, so a wrong, zero or missing gradient
# through the witnessed site (off by ~1) fails all the same.
RECURRENT_GRAD_RTOL = 1e-2
RECURRENT_GRAD_CATCH = 5e-2
# paligemma's catch: with the loss alone on standard its f32 gradients sit
# 2.6e-2 (median) from standard's, worst 5.6e-2 (layer 1's wo), and every
# tensor past 1e-2 falls to <= 1.2e-3 with ffn on standard too (its GeGLU's
# dL/dx sums 16384 terms; measured on one H100): the catch only has to
# tell that from a wrong, zero or missing gradient, off by ~1, as MoE's
# 1e-1 with every site square does.
GRAD_CATCH = {"paligemma-3b": 1e-1}
# whisper's 3 f32 steps run with the loss's vocab GEMM on standard, as its
# gradient gate does; with every site square they are reported.  That
# GEMM's dL/dx sums the 51968 padded vocab entries on K1, whose partial 0
# drifts at that k (5.1 % of max|exact| at whisper's shape, measured on
# one H100), and the final layernorm's bias gradient, the sum of that
# dL/dx over every row, then sits 13x its own norm from standard's: one
# AdamW step on it moved the next loss by 8.5e-2 (measured on one
# H100).  recurrentgemma's and paligemma's final norms (rmsnorm) carry
# no bias.
LOSS_STANDARD_TRAJECTORY = ("whisper-large-v3",)
# TRAJECTORY_WITNESS_NOTE: with the loss on standard whisper's 3 steps
# still sat 4.08e-2 and 1.16e-1 from standard's at steps 2 and 3, 19 % and
# 20 % of what standard's own steps moved each loss, while its one-step
# gradients were within 2.3e-3 of standard's, every tensor.  AdamW's
# first steps move each element by about lr * sign(g) whatever |g|, and
# the next loss is another batch's (its own frames), so an element whose
# gradient sign is set by rounding moves that loss by lr * its gradient
# there.  The witness (:func:`trajectory_witness`, measured on one H100):
# the square run with each element whose first moment differs in sign
# from standard's held to standard's after each step (12.2 %, 9.5 % and
# 8.3 % of the elements) sat 1.32e-4, 1.58e-4 and 1.50e-2 from standard's,
# within rtol = atol = 2e-3, and that is gated; standard's own
# trajectory at the params x (1 + 2^-20) moved 1.1e-5 at most; of the
# 4.10e-2 the square run's first step moves the next loss by, the
# encoder's first FFN down projection alone carries 3.07e-2.  The square
# run itself is held to 2e-3, or to TRAJECTORY_SHARE of what standard's
# own steps moved each loss (the same batch's loss at the initial params
# against standard's): the measured 19-20 % and a margin; an update that
# is missing or reversed moves a loss by 1-2 x that movement.
TRAJECTORY_SHARE = 0.25
# GRAD_ZERO_NOTE: whisper's cross-attention key bias has a zero gradient
# in exact arithmetic (no rope on the encoder's keys, so q . b_k adds one
# constant to a row's scores, which the softmax cancels); each side leaves
# rounding there (~7e2 x standard's own norm apart, measured on one H100),
# so it is held, on both sides, to RECURRENT_GRAD_RTOL times the norm of
# its layer's key weight gradient instead of relatively.
# xlstm's blocks alone, teacher-forced (f32, a unit cotangent): each
# gradient of square_pallas within max(XLSTM_BLOCK_RTOL, 4 x its control,
# standard's at the block's params x (1 + 2^-20)) of standard's, or past
# that within it in a witness run with one site (or two) on standard, and
# within XLSTM_BLOCK_CATCH with every site square.
XLSTM_BLOCK_RTOL = 1e-2
XLSTM_BLOCK_CATCH = 1e-1
PROBE_ROWS = 64
RECURRENT_TRAIN_FLAG = "--recurrent-train-phase"
# K1 against its plain version: past this k the two orders of summation,
# not the kernel, set the gap, and the stated f32 bound k * 2^-23 *
# (max|a| + max|b|)^2 no longer holds (measured on one H100: 4.3 against
# its 1.02 at the 256000-term dL/dx of recurrentgemma's loss on
# N(0, 1) x N(0, 1/k) operands).  K1's partial 0 starts at Sa_i + Sb_j
# (~ -k there) and adds k/8 single squares to it; at that magnitude a
# square below half a unit in the last place is lost, and chi-square
# terms lose more often than they gain, so the partial drifts with k
# where the plain version's slabs of 16 do not.  There each launch is held to
# :func:`k1_ordered`, K1's own order in plain PyTorch, within
# 2^-20 * (|Sa_i| + |Sb_j| + |ref_ij|) (8 units in the last place of the
# largest partial), so a zero or wrong output fails, and its distance from
# the exact product is reported beside the plain version's.
K1_LINEAR_MAX_K = 32768
K1_ORDER_STEPS = 16                     # k1_ordered's steps a chunk


def k1_ordered(aw, bw, sa, sb) -> torch.Tensor:
    """K1's arithmetic in K1's own order (``csrc/sq_matmul.cu``), for
    (m, k) @ (k, n) or (B, m, k) @ (B, k, n): per output 8 partials,
    partial p over k = p, p + 8, ... in increasing k, each term an f32 add
    s = a + b and fmaf(s, s, acc) (here s^2 and the sum in float64,
    rounded to f32 once, as the fma rounds), partial 0 from Sa_i + Sb_j
    and the others from 0, summed 0..7 and halved."""
    one = aw.dim() == 2
    if one:
        aw, bw, sa, sb = aw[None], bw[None], sa[None], sb[None]
    nb, m, k = aw.shape
    n = bw.shape[-1]
    pad = -k % 8
    a8 = torch.nn.functional.pad(aw, (0, pad)).view(nb, m, -1, 8)
    b8 = torch.nn.functional.pad(bw, (0, 0, 0, pad)).view(nb, -1, 8, n)
    acc = torch.zeros(nb, m, 8, n, dtype=torch.float32, device=aw.device)
    acc[:, :, 0] = sa[:, :, None] + sb[:, None, :]
    for j0 in range(0, a8.shape[2], K1_ORDER_STEPS):
        s = (a8[:, :, j0:j0 + K1_ORDER_STEPS, :, None]
             + b8[:, None, j0:j0 + K1_ORDER_STEPS])       # f32 a + b
        sq = s.double().square_()
        for j in range(sq.shape[2]):
            torch.add(acc, sq[:, :, j], out=acc)          # one f32 rounding
    v = acc[:, :, 0]
    for q in range(1, 8):
        v = v + acc[:, :, q]
    v = v * 0.5
    return v[0] if one else v


def k1_tol(ref, aw, bw, sa, sb, ordered=None):
    """The tolerance of a K1/K2/K3 output against ``ref``: k * 2^-23 *
    (max|a| + max|b|)^2 against the plain version, or past
    K1_LINEAR_MAX_K (or where ``ordered``) 2^-20 * (|Sa_i| + |Sb_j| +
    |ref_ij|) against :func:`k1_ordered`."""
    if ordered is None:
        ordered = aw.shape[-1] > K1_LINEAR_MAX_K
    if not ordered:
        return aw.shape[-1] * 2.0 ** -23 * (
            aw.abs().max() + bw.abs().max()) ** 2
    return 2.0 ** -20 * (sa.abs().unsqueeze(-1) + sb.abs().unsqueeze(-2)
                         + ref.abs())


def k1_reference(aw, bw, sa, sb, plain):
    """What a launch on these operands is held to: ``plain(aw, bw, sa,
    sb)``, or past K1_LINEAR_MAX_K :func:`k1_ordered`."""
    return (k1_ordered if aw.shape[-1] > K1_LINEAR_MAX_K else plain)(
        aw, bw, sa, sb)


def k1_share(out, ref, aw, bw, sa, sb, ordered=None) -> torch.Tensor:
    """The largest share of its tolerance (:func:`k1_tol`) that K1 (or
    K2/K3) ``out`` leaves against ``ref`` (:func:`k1_reference`), on the
    device (inf where ``out`` is not finite; nothing read back)."""
    err = (out - ref).abs()
    tol = torch.as_tensor(k1_tol(ref, aw, bw, sa, sb, ordered))
    # a zero bound (zeros contracted with zeros) leaves a share of 0
    share = (err / tol.clamp_min(1e-30)).max()
    return torch.where(torch.isfinite(out).all(), share,
                       torch.full_like(share, math.inf))


def k1_error(out, ref, aw, bw, sa, sb) -> tuple:
    """(max|out - ref|, the largest tolerance, the worst share of it): see
    :func:`k1_share`."""
    share = k1_share(out, ref, aw, bw, sa, sb).item()
    tol = torch.as_tensor(k1_tol(ref, aw, bw, sa, sb)).max().item()
    return (out - ref).abs().max().item(), tol, share


def recurrent_train_cfg(arch, layers: int = 0, mode="square_pallas", **kw):
    """``arch`` at its published width, ``layers`` (default
    RECURRENT_TRAIN_LAYERS) deep; an encoder-decoder arch's encoder cut
    to as many layers."""
    cfg = dataclasses.replace(
        get_config(arch), n_layers=layers or RECURRENT_TRAIN_LAYERS[arch],
        matmul_mode=mode, contraction_policy=None, **kw)
    if cfg.encoder_layers:
        cfg = dataclasses.replace(cfg, encoder_layers=cfg.n_layers)
    return cfg


def device_tree(cfg, dev, seed: int = 0):
    """``cfg``'s params tree in f32, drawn on the device by a CUDA
    generator seeded with ``seed``: ``layers/param.py``'s distributions
    (scaled normal 1 / sqrt(fan_in), ones, zeros) in spec order.  A host
    draw of recurrentgemma's 2.2 G parameters takes tens of seconds, as
    ``build_model`` draws them; these weights are random all the same."""
    from repro_torch.layers.param import ParamSpec
    g = torch.Generator(device=dev).manual_seed(seed)

    def draw(node):
        if isinstance(node, ParamSpec):
            if node.init in ("zeros", "ones"):
                return (torch.zeros if node.init == "zeros"
                        else torch.ones)(node.shape, device=dev)
            fan = node.fan_in or (node.shape[0] if node.shape else 1)
            return torch.randn(node.shape, generator=g, device=dev) \
                / math.sqrt(max(1, fan))
        if isinstance(node, dict):
            return {k: draw(v) for k, v in node.items()}
        return [draw(n) for n in node]
    return draw(train_spec(cfg))


def recurrent_train_kernel_rows(dev, gen, cfg, rules,
                                unit: str = "train step") -> list:
    """K1/K2/K3 at every distinct shape of a train step of ``cfg`` (the
    forward's, both gradients' and the recompute's, as
    :func:`recurrent_train_launches` gives them) on random bf16-rounded
    operands: against the plain version (past K1_LINEAR_MAX_K against
    :func:`k1_ordered` on PROBE_ROWS rows, with the distance of each from
    the exact product), timed in graph replay with the operands hot beside
    torch.matmul / torch.bmm (no TF32), the bound and the FP32 slot floor,
    the plain version once between CUDA events.  ``unit``: what
    ``rules``' launch counts are counted over."""
    print(f"{cfg.name} {unit} shapes: K1/K2/K3 held to their plain "
          f"versions (f32 |err| <= k * 2^-23 * (max|a| + max|b|)^2; past "
          f"k = {K1_LINEAR_MAX_K} to K1's own order) and timed (graph "
          f"replay, operands hot); card {CARD}", flush=True)
    rows = []
    for name in ("K1", "K2", "K3"):
        for shape, per_step in sorted(rules["shapes"][name].items()):
            B, m, k, n = (1,) + shape if name == "K1" else shape
            # drawn on the device: the vocab GEMMs' operands hold up to
            # 655 M entries
            a = torch.randn(B, m, k, generator=gen, device=dev).to(
                torch.bfloat16)
            b = (torch.randn(B, k, n, generator=gen, device=dev)
                 / math.sqrt(k)).to(torch.bfloat16)
            aw, bw = a.float(), b.float()
            del a, b
            sa, sb = -(aw * aw).sum(2), -(bw * bw).sum(1)
            if name == "K1":
                args = (aw[0], bw[0], sa[0], sb[0])
                kern, lib = sq_matmul_k1, (lambda: torch.matmul(aw[0], bw[0]))
                plain = lambda: _plain_rows(*args, budget=2 ** 30)  # noqa
                grid = k1_planned(m, n, k)["grid"]
            else:
                args = (aw, bw, sa, sb)
                kern, lib = BATCHED[name][0], (lambda: torch.bmm(aw, bw))
                plain = lambda: _plain_batched(*args)               # noqa
                grid = BATCHED[name][1](B, m, n)["grid"]
            out = kern(*args)
            terms = B * m * k * n
            ref, cut, plain_ms, vs_exact = None, args, None, {}
            if terms <= PLAIN_TIMED_TERMS or name != "K1":
                held = []
                plain_ms = _event_ms(lambda: held.append(plain()))
                ref = held[0]
            if name == "K1" and (ref is None or k > K1_LINEAR_MAX_K):
                # held on PROBE_ROWS output rows (the plain version not
                # timed past PLAIN_TIMED_TERMS)
                h = PROBE_ROWS // 2
                idx = torch.cat([torch.arange(h, device=dev),
                                 torch.arange(m - h, m, device=dev)])
                cut = (args[0][idx], args[1], args[2][idx], args[3])
                out = out[idx]
                ref = _plain_rows(*cut) if ref is None else ref[idx]
            if k > K1_LINEAR_MAX_K:
                exact = torch.matmul(cut[0].double(), cut[1].double())
                vs_exact = {"err_exact": (out.double() - exact).abs().max(),
                            "plain_err_exact": (ref.double()
                                                - exact).abs().max(),
                            "max_exact": exact.abs().max()}
                vs_exact = {key: v.item() for key, v in vs_exact.items()}
                del exact
                ref = k1_ordered(*cut)
                zero = k1_share(torch.zeros_like(out), ref, *cut).item()
            err, tol, share = k1_error(out, ref, *cut)
            check(bool(torch.isfinite(out).all()) and share <= 1.0
                  and (k <= K1_LINEAR_MAX_K or zero > 1.0),
                  f"{name} f32 B={B} m={m} k={k} n={n}: max|err| {err:.3e}, "
                  f"{share:.1%} of its bound"
                  + (f" against K1's own order (k1_ordered; at most "
                     f"{tol:.3e}, a zero output at {zero:.0%} of it); "
                     f"against the exact product {vs_exact['err_exact']:.3e}"
                     f" = {vs_exact['err_exact'] / vs_exact['max_exact']:.1%}"
                     f" of max|exact| {vs_exact['max_exact']:.3e}, the plain "
                     f"version's {vs_exact['plain_err_exact']:.3e}"
                     if k > K1_LINEAR_MAX_K else f" {tol:.3e}"))
            del out, ref
            reps = 5 if terms < 2 ** 36 else 1        # a vocab GEMM: ~0.2 s
            ms = time_graph([lambda: kern(*args)], reps=reps, replays=2)
            lib_ms = time_graph([lib], reps=reps, replays=2)
            t_bytes = 4 * B * (m * k + k * n + m + n + m * n) \
                / HBM_BYTES_PER_S * 1e3
            t_ops = 2 * terms / FP32_OPS_PER_S * 1e3
            row = dict(kernel=name, shape=(B, m, k, n), per_step=per_step,
                       ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       floor_ms=2 * terms / FP32_SLOTS_PER_S * 1e3,
                       bound_ms=max(t_bytes, t_ops), t_bytes=t_bytes,
                       t_ops=t_ops, max_abs_err=err, grid=grid, **vs_exact)
            rows.append(row)
            plain_s = ("not timed" if plain_ms is None
                       else f"{plain_ms:.2f} ms")
            print(f"    {name} B={B:2d} m={m:6d} k={k:6d} n={n:6d} "
                  f"x{per_step:4d} a {unit}: {ms:.4f} ms | plain {plain_s} | "
                  f"{'torch.matmul' if name == 'K1' else 'torch.bmm'} "
                  f"{lib_ms:.4f} ms ({ms / lib_ms:.2f}x) | bound "
                  f"{row['bound_ms']:.4f} ms | slot floor "
                  f"{row['floor_ms']:.4f} ms | grid {grid}", flush=True)
            del aw, bw, sa, sb, args
    for name in ("K1", "K2", "K3"):
        mine = [r for r in rows if r["kernel"] == name]
        if mine:
            tot = {key: sum(r["per_step"] * (r[key] or 0) for r in mine)
                   for key in ("ms", "plain_ms", "library_ms", "floor_ms",
                               "bound_ms")}
            untimed = sum(r["per_step"] for r in mine
                          if r["plain_ms"] is None)
            print(f"  per {unit} ({cfg.n_layers} layers, "
                  f"{sum(r['per_step'] for r in mine)} launches): {name} "
                  f"{tot['ms']:.3f} ms | plain {tot['plain_ms']:.1f} ms"
                  f"{f' (not timed at {untimed} launches)' * bool(untimed)}"
                  f" | "
                  f"library {tot['library_ms']:.3f} ms | slot floor "
                  f"{tot['floor_ms']:.3f} ms | bound {tot['bound_ms']:.3f} "
                  f"ms; card {CARD}", flush=True)
    return rows


def state_digest(tree) -> str:
    """A bit-level digest of a tree of tensors, computed where they lie:
    per leaf, the 64-bit wrapping sums of its raw words and of each word
    times its position (mod 2^31 - 1, plus 1), read back once and hashed.
    Two trees with one bit apart differ in it; ``tree_fingerprint`` of a
    22 GB train state reads it all back and hashes it on the host, ~40 s
    on the card's host."""
    import hashlib
    words = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    sums, chunk = [], 1 << 26
    for leaf in tree_leaves(tree):
        w = leaf.detach().contiguous().reshape(-1)
        w = w.view(words[w.element_size()])
        total = torch.zeros(2, dtype=torch.int64, device=w.device)
        for i in range(0, w.numel(), chunk):
            c = w[i:i + chunk].long()
            pos = torch.arange(i, i + c.numel(), device=c.device) \
                % 2147483647 + 1
            total += torch.stack([c.sum(), (c * pos).sum()])
        sums.append(total.cpu())
    return hashlib.sha256(torch.stack(sums).numpy().tobytes()).hexdigest()


def train_grads(model: LM, params, batch, cfg, scale: float) -> dict:
    """One step's gradients of ``cfg``'s loss times ``scale`` (divided by
    it after) at ``params``: {leaf path: tensor}."""
    from repro_torch.train import step as step_mod
    loss_fn = step_mod.make_loss_fn(moe_train_view(model, cfg),
                                    step_mod.TrainConfig())

    def scaled(p, b):
        loss, met = loss_fn(p, b)
        return loss * scale, met

    _, g = step_mod.value_and_grad(scaled, params, batch)
    return {k: t / scale for k, t in _tree_leaves_named(g).items()}


def _rel_tensors(got: dict, ref: dict) -> dict:
    return {k: ((got[k].double() - r.double()).norm()
                / r.double().norm().clamp_min(1e-300)).item()
            for k, r in ref.items()}


def site_witness(rel_with, excess: dict, sites) -> dict:
    """For each tensor of ``excess`` ({name: its gate}), past its gate with
    every site square: the first of ``sites`` (then of their pairs) whose
    move to standard in both runs brings it within its gate, {name: (the
    sites moved, its gap there)}.  ``rel_with(sites)`` runs the square side
    with ``sites`` on standard and gives every tensor's gap."""
    found = {}
    groups = [(x,) for x in sites] + list(itertools.combinations(sites, 2))
    for group in groups:
        left = [t for t in excess if t not in found]
        if not left:
            break
        rel = rel_with(group)
        for t in left:
            if rel[t] <= excess[t]:
                found[t] = (group, rel[t])
    return found


def _policy(sites, **more):
    from repro_torch.configs.base import ContractionPolicy
    return ContractionPolicy.of(**{x: "standard" for x in sites}, **more)


def block_parity(model: LM, params, batch, cfgs) -> dict:
    """Each layer alone, teacher-forced: its input from standard's f32
    forward of ``batch``, a random unit cotangent on its output, and the
    gradients of the block's params and input in square_pallas against
    standard's.  Each tensor within max(XLSTM_BLOCK_RTOL, 4 x its control,
    standard's at the block's params x (1 + 2^-20)); a tensor past that is
    held to it in a witness run with one site (or two) on standard
    (:func:`site_witness`), and beside it stands the bf16 control,
    standard computed in bf16; every tensor within XLSTM_BLOCK_CATCH with
    every site square.  A block's backward alone is as well conditioned as
    its operands, where the whole LM's compounds 24 of them."""
    from repro_torch.train import step as step_mod
    cfg = cfgs["standard"]
    cfg_bf = dataclasses.replace(cfg, dtype="bfloat16")
    params_bf = moe_train_tree(params, cfg_bf)
    inputs, real = [], blk.block_forward

    def spy(kind, p, x, ctx):
        inputs.append(x.detach())
        return real(kind, p, x, ctx)

    blk.block_forward = spy
    try:
        with torch.no_grad():
            moe_train_view(model, cfg).forward(
                params, {"tokens": batch["tokens"][:, :-1]})
    finally:
        blk.block_forward = real
    B, S = inputs[0].shape[:2]
    sites = sorted(x for x in recurrent_train_audit(cfg, B, S)
                   if "." not in x and x != "loss")
    g = torch.Generator(device=inputs[0].device).manual_seed(3)
    worst, worst_ctl, n_tensors, past = 0.0, 0.0, 0, []
    for i, (kind, x) in enumerate(zip(cfg.layer_kinds, inputs)):
        ct = torch.randn(x.shape, generator=g, device=x.device)

        def grads(mode, p, xin=x, c=cfg, policy=None):
            ctx = {"cfg": c, "mode": mode, "policy": policy,
                   "positions": torch.arange(S, device=x.device),
                   "causal": True}

            def fn(q, b):
                y = real(kind, q["p"], q["x"], ctx)[0]
                return (y.float() * b["ct"]).sum(), {}
            _, gr = step_mod.value_and_grad(fn, {"p": p, "x": xin},
                                            {"ct": ct})
            return _tree_leaves_named(gr)

        p = params["layers"][i]
        std = grads("standard", p)
        rel = _rel_tensors(grads("square_pallas", p), std)
        ctl = _rel_tensors(grads("standard", tree_map(
            lambda t: t * (1 + GRAD_BUMP), p)), std)
        gate = {n: max(XLSTM_BLOCK_RTOL, 4 * ctl[n]) for n in rel}
        excess = {n: gate[n] for n in rel if rel[n] > gate[n]}
        if excess:
            found = site_witness(lambda group: _rel_tensors(grads(
                "square_pallas", p, policy=_policy(group)), std),
                excess, sites)
            bf = _rel_tensors(grads("standard", params_bf["layers"][i],
                                    x.to(torch.bfloat16), cfg_bf), std)
            past += [(rel[n], f"layer {i} {kind} {n}", gate[n],
                      found.get(n), bf[n]) for n in excess]
        n_tensors += len(rel)
        worst = max(worst, max(rel.values()))
        worst_ctl = max(worst_ctl, max(ctl.values()))
    past.sort(key=lambda r: r[0], reverse=True)
    by_site = collections.Counter("+".join(r[3][0]) if r[3] else "none"
                                  for r in past)
    print(f"  xlstm blocks: {len(past)} of {n_tensors} tensors past "
          f"max({XLSTM_BLOCK_RTOL:g}, 4 x the control) with every site "
          f"square; the site whose move to standard brings each within it: "
          f"{dict(by_site)}", flush=True)
    for gap, name, gt, fnd, bf in past[:12]:
        print(f"    {name}: {gap:.3e} (gate {gt:.3e}); "
              + (f"{fnd[1]:.3e} with {'+'.join(fnd[0])} on standard"
                 if fnd else "no site's move brings it within its gate")
              + f"; the bf16 control {bf:.3e}", flush=True)
    check(worst <= XLSTM_BLOCK_CATCH and all(r[3] for r in past),
          f"each of the {len(inputs)} blocks alone (teacher-forced on "
          f"standard's f32 layer inputs, a unit cotangent): the gradients of "
          f"its params and input in square_pallas within max("
          f"{XLSTM_BLOCK_RTOL:g}, 4 x the control) of standard's, "
          f"{len(past)} of {n_tensors} only with the witnessed site on "
          f"standard too; with every site square each within "
          f"{XLSTM_BLOCK_CATCH:g} (worst {worst:.3e}, control worst "
          f"{worst_ctl:.3e})")
    return {"block_worst": worst, "block_control_worst": worst_ctl,
            "block_past": [(r[1], r[0], r[3] and "+".join(r[3][0]),
                            r[3] and r[3][1], r[4]) for r in past],
            "block_tensors": n_tensors}


def trajectory_witness(model: LM, params, batches, runs) -> dict:
    """Where a square-form trajectory's losses leave standard's: the
    square run (``runs["square_pallas"]``) and standard's in lockstep, and
    after each step every element whose AdamW first moment differs in sign
    from standard's held to standard's (its parameter, m and v): the held
    run's losses, and the share of elements held.  Beside it, standard's
    own trajectory at the params x (1 + GRAD_BUMP) (its conditioning), and
    after one step each tensor of the square run's params put alone into
    standard's: the next batch's loss in standard mode, less standard's,
    and the share of its elements held after that step
    (TRAJECTORY_WITNESS_NOTE)."""
    from repro_torch.core.tree import tree_flatten, tree_unflatten
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod
    tc = step_mod.TrainConfig()
    step = {m: step_mod.make_train_step(moe_train_view(model, runs[m]), tc)
            for m in ("square_pallas", "standard")}
    names = _leaf_names(params)
    flat = lambda t: tree_flatten(t)[0]                          # noqa: E731
    p_sq = p_st = params
    o_sq, o_st = adamw.adamw_init(params), adamw.adamw_init(params)
    held, total = [], sum(x.numel() for x in flat(params))
    after_one, held_by_tensor = None, {}
    losses = {"held": [], "standard": []}
    for t, b in enumerate(batches):
        p_sq, o_sq, met_sq = step["square_pallas"](p_sq, o_sq, b)
        p_st, o_st, met_st = step["standard"](p_st, o_st, b)
        losses["held"].append(float(met_sq["loss"]))
        losses["standard"].append(float(met_st["loss"]))
        if t == 0:
            after_one = p_sq
        ps, tdef = tree_flatten(p_sq)
        ms, vs = flat(o_sq["m"]), flat(o_sq["v"])
        n, new = 0, ([], [], [])
        for a, m, v, a_st, m_st, v_st in zip(ps, ms, vs, flat(p_st),
                                             flat(o_st["m"]),
                                             flat(o_st["v"])):
            flip = torch.sign(m) != torch.sign(m_st)
            n += int(flip.sum())
            if t == 0:
                held_by_tensor[names[len(new[0])]] = (
                    flip.float().mean().item())
            for out, x, y in zip(new, (a, m, v), (a_st, m_st, v_st)):
                out.append(torch.where(flip, y, x))
        held.append(n / total)
        p_sq = tree_unflatten(tdef, new[0])
        o_sq = dict(o_sq, m=tree_unflatten(tdef, new[1]),
                    v=tree_unflatten(tdef, new[2]))
    del p_sq, o_sq, p_st, o_st
    p = tree_map(lambda x: x * (1 + GRAD_BUMP), params)
    o, losses["control"] = adamw.adamw_init(p), []
    for b in batches:
        p, o, met = step["standard"](p, o, b)
        losses["control"].append(float(met["loss"]))
    del p, o
    # each tensor of the square run's first step alone in standard's
    p_one, _, _ = step["standard"](params, adamw.adamw_init(params),
                                   batches[0])
    loss_fn = step_mod.make_loss_fn(moe_train_view(model, runs["standard"]),
                                    tc)
    base_leaves, tdef = tree_flatten(p_one)
    sq_leaves = flat(after_one)
    with torch.no_grad():
        base = float(loss_fn(p_one, batches[1])[0])
        alone = float(loss_fn(after_one, batches[1])[0]) - base
        by_tensor = {}
        for i, name in enumerate(names):
            mix = list(base_leaves)
            mix[i] = sq_leaves[i]
            by_tensor[name] = float(loss_fn(tree_unflatten(tdef, mix),
                                            batches[1])[0]) - base
    del p_one, after_one
    gc.collect()
    return {"losses": losses, "held_share": held,
            "held_by_tensor": held_by_tensor,
            "square_params_alone": alone, "by_tensor": by_tensor}


def recurrent_train_parity(dev, arch, model: LM, tree) -> dict:
    """f32, remat none, RECURRENT_F32_LAYERS[arch] layers of the drawn
    weights, square_pallas against standard (TF32 off), at the main path's
    tokens.  One square step's gradients of the loss x GRAD_SCALE with
    every K1/K2/K3 launch held to the exact (float64) product of its
    operands and its launches counted (the forward, both gradients and the
    loss's recompute, by the routing rules), then 3 steps' losses against
    standard's at rtol = atol = 2e-3.

    recurrentgemma (and paligemma, whisper): each tensor within
    RECURRENT_GRAD_RTOL with the loss's
    vocab GEMM on standard in both runs, or past it within it in a witness
    run with one more site on standard (:func:`site_witness`), and every
    tensor within RECURRENT_GRAD_CATCH; every site square and the bf16 control
    are reported.
    xlstm: the whole LM's gap is reported: at its published width
    standard's own gradients move by 2.0e-2 (median; 1.96e-1 worst) when
    every f32 parameter is multiplied by (1 + 2^-20), within one mLSTM
    chunk too (1.6e-2; measured on one H100), so no gate on the whole LM
    can tell a fault from the reference's conditioning
    (tests/test_torch_recurrent_train_xlstm.py); each block alone is gated
    instead (:func:`block_parity`)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod
    L = RECURRENT_F32_LAYERS[arch]
    B, S = RECURRENT_TRAIN_BS[arch]
    cfgs = {m: recurrent_train_cfg(arch, L, m, dtype="float32", remat="none")
            for m in ("square_pallas", "standard")}
    L = f"{L} + {L}" if cfgs["standard"].encoder_layers else L
    params = moe_train_tree(tree, cfgs["standard"])

    def data(b, s, n=1):
        return SyntheticLM(DataConfig(b, s, cfgs["standard"].vocab),
                           cfgs["standard"], device=dev).take(n)

    batches = data(B, S, 3)
    print(f"{arch} train parity: published width, {L} layers, f32, remat "
          f"none, {B} x {S} tokens, square_pallas vs standard (no TF32); one "
          f"step's gradients of the loss x {GRAD_SCALE:g}, then 3 steps' "
          f"losses; card {CARD}", flush=True)

    def grads(cfg, p=params, batch=batches[0]):
        return train_grads(model, p, batch, cfg, GRAD_SCALE)

    def launches_ok(batch, what):
        """One square step's gradients, every launch probed and counted."""
        b, s = batch["tokens"].shape[0], batch["tokens"].shape[1] - 1
        rules = recurrent_train_launches(cfgs["square_pallas"], b, s)
        want = tuple(sum(rules[p][k] for p in ("forward", "backward",
                                               "recompute"))
                     for k in ("K1", "K2", "K3"))
        ordered = arch in ORDERED_ARCHS
        seen, restore = (_ordered_kernels if ordered else _probed_kernels)()
        reset_counts()
        try:
            sq = grads(cfgs["square_pallas"], batch=batch)
        finally:
            restore()
        launched = counts()[:3]
        # the first mLSTM chunk contracts zeros with zeros: a bound of 0
        shares = [r[2] if ordered else r[2] / r[3] if r[3]
                  else (0.0 if r[2] == 0 else math.inf) for r in seen]
        worst = max(range(len(seen)), key=shares.__getitem__)
        rule = ("held to K1's own order (k1_ordered) on 8 rows of each "
                "batch element, within 2^-20 * (|Sa| + |Sb| + |ref|)"
                if ordered else
                "within k * 2^-23 * (max|a| + max|b|)^2 of its exact product")
        check(launched == want and len(seen) == sum(launched)
              and shares[worst] <= 1.0
              and all(bool(torch.isfinite(t).all()) for t in sq.values()),
              f"{what}: one f32 step launches K1/K2/K3 {launched} (the "
              f"rules' forward, backward and the loss's recompute: {want}),"
              f" each {rule} (worst {seen[worst][0]} {seen[worst][1]} at "
              f"{shares[worst]:.1%} of it); {len(sq)} finite gradients")
        if ordered:
            far = max(seen, key=lambda r: r[3] / r[4])
            print(f"  (reported) their distance from the exact product: "
                  f"{sum(r[3] > r[4] for r in seen)} of {len(seen)} launches "
                  f"past the linear bound k * 2^-23 * (max|a| + max|b|)^2, "
                  f"the farthest {far[0]} {far[1]} |err| {far[3]:.3e} = "
                  f"{far[3] / far[4]:.1%} of it (max|exact| {far[5]:.3e})",
                  flush=True)
        return sq, {(r[0], r[1]) for r in seen}

    def median(rel):
        return sorted(rel.values())[len(rel) // 2]

    out = {}
    if arch != "xlstm-350m":
        sq, launched = launches_ok(batches[0], f"{arch} {B} x {S}")
        std = grads(cfgs["standard"])
        # GRAD_ZERO_NOTE: leaves whose gradient is zero in exact
        # arithmetic, each held beside its sibling weight's gradient
        zero = {t: t[:-1] + "w" for t in std if t.endswith("/xattn/wk/b")}
        for t, wt in zero.items():
            bound = RECURRENT_GRAD_RTOL * std[wt].double().norm().item()
            got = (sq[t].double().norm().item(),
                   std[t].double().norm().item())
            check(max(got) <= bound,
                  f"{t}: zero in exact arithmetic (the softmax cancels q . "
                  f"b_k); ||square_pallas|| {got[0]:.3e} and ||standard|| "
                  f"{got[1]:.3e} <= {RECURRENT_GRAD_RTOL:g} x ||{wt}|| "
                  f"({bound:.3e})")
        for t in zero:
            del sq[t], std[t]
        rel = _rel_tensors(sq, std)
        del sq
        w = max(rel, key=rel.get)
        print(f"  every site square (reported): ||diff|| / ||standard|| "
              f"median {median(rel):.3e}, worst {rel[w]:.3e} ({w})",
              flush=True)

        def rel_with(sites=()):
            return _rel_tensors(grads(dataclasses.replace(
                cfgs["square_pallas"],
                contraction_policy=_policy(sites, loss="standard"))), std)

        rel2 = rel_with()
        w2 = max(rel2, key=rel2.get)
        catch = GRAD_CATCH.get(arch, RECURRENT_GRAD_CATCH)
        excess = {t: RECURRENT_GRAD_RTOL for t, r in rel2.items()
                  if r > RECURRENT_GRAD_RTOL}
        sites = sorted(x for x in recurrent_train_audit(cfgs["standard"], B, S)
                       if "." not in x and x != "loss")
        found = site_witness(rel_with, excess, sites)
        cfg_bf = dataclasses.replace(cfgs["standard"], dtype="bfloat16")
        bf = _rel_tensors(grads(cfg_bf, moe_train_tree(tree, cfg_bf)), std)
        print(f"  the bf16 control (standard computed in bf16): "
              f"||diff|| / ||standard|| median {median(bf):.3e}, worst "
              f"{max(bf.values()):.3e}", flush=True)
        for t in sorted(excess, key=rel2.get, reverse=True):
            print(f"    {t}: {rel2[t]:.3e} with the loss alone on standard; "
                  + (f"{found[t][1]:.3e} with {'+'.join(found[t][0])} on "
                     f"standard too" if t in found else
                     "no site's move brings it within the gate")
                  + f"; the bf16 control {bf[t]:.3e}", flush=True)
        check(rel2[w2] <= catch and len(found) == len(excess),
              f"f32 gradients of the loss x {GRAD_SCALE:g}, the loss's vocab "
              f"GEMM on standard in both runs: {len(rel2)} tensors, "
              f"||diff|| / ||standard|| median {median(rel2):.3e}, worst "
              f"{rel2[w2]:.3e} ({w2}) <= {catch:g}; "
              f"{len(rel2) - len(excess)} within {RECURRENT_GRAD_RTOL:g}, the "
              f"other {len(excess)} within it with the witnessed site on "
              f"standard too")
        out.update(all_square=rel[w], loss_standard=rel2[w2],
                   zero=sorted(zero),
                   past={t: (rel2[t], found.get(t), bf[t]) for t in excess},
                   bf16_median=median(bf), bf16_worst=max(bf.values()))
        del std
    else:
        sq, launched = launches_ok(batches[0], f"{arch} {B} x {S}")
        std = grads(cfgs["standard"])
        rel = _rel_tensors(sq, std)
        print(f"  the whole LM's gradients (reported): square_pallas's gap "
              f"median {median(rel):.3e}, worst {max(rel.values()):.3e}",
              flush=True)
        del sq, std
        out.update(gap_median=median(rel), gap_worst=max(rel.values()))
        out.update(block_parity(model, params, batches[0], cfgs))
    out["launched"] = sorted(launched)
    losses = {}
    runs = dict(cfgs)
    if arch in LOSS_STANDARD_TRAJECTORY:
        runs["all_square"] = runs["square_pallas"]
        runs["square_pallas"] = dataclasses.replace(
            cfgs["square_pallas"], contraction_policy=_policy(
                (), loss="standard"))
    for mode, cfg in runs.items():
        step = step_mod.make_train_step(moe_train_view(model, cfg),
                                        step_mod.TrainConfig())
        p, o = params, adamw.adamw_init(params)
        losses[mode] = []
        for b in batches:
            p, o, met = step(p, o, b)
            losses[mode].append(float(met["loss"]))
        del p, o, step
        gc.collect()
    diffs = [abs(a - b) for a, b in zip(losses["square_pallas"],
                                        losses["standard"])]
    gates = [2e-3 + 2e-3 * abs(b) for b in losses["standard"]]
    if arch in LOSS_STANDARD_TRAJECTORY:
        # each batch's loss at the initial params: what standard's own
        # steps moved it by (LOSS_STANDARD_TRAJECTORY)
        loss_fn = step_mod.make_loss_fn(moe_train_view(
            model, cfgs["standard"]), step_mod.TrainConfig())
        with torch.no_grad():
            losses["unmoved"] = [float(loss_fn(params, b)[0])
                                 for b in batches]
        moved = [abs(a - b) for a, b in zip(losses["standard"],
                                            losses["unmoved"])]
        gates = [max(g, TRAJECTORY_SHARE * m) for g, m in zip(gates, moved)]
        gap = [abs(a - b) for a, b in zip(losses["all_square"],
                                          losses["standard"])]
        print(f"  (reported) standard's steps moved the losses by "
              f"{[f'{m:.2e}' for m in moved]}; with every site square, the "
              f"loss's vocab GEMM too: {losses['all_square']}, |diff| "
              f"{[f'{g:.2e}' for g in gap]}", flush=True)
        wit = trajectory_witness(model, params, batches, runs)
        out["witness"] = wit
        ref = wit["losses"]["standard"]

        def gaps(key):
            return [f"{abs(a - b):.2e}" for a, b in zip(wit["losses"][key],
                                                        ref)]
        top = sorted(wit["by_tensor"].items(), key=lambda kv: -abs(kv[1]))
        print(f"  (reported) standard at the params x (1 + 2^-20): |diff| "
              f"{gaps('control')}; after one step the square run's params "
              f"in standard mode move the next loss by "
              f"{wit['square_params_alone']:.3e}, each tensor alone (sum "
              f"{sum(wit['by_tensor'].values()):.3e}; the share of its "
              f"elements whose first moment's sign differs): "
              + ", ".join(f"{k} {v:.2e} ({wit['held_by_tensor'][k]:.1%})"
                          for k, v in top[:6]), flush=True)
        held_gates = [2e-3 + 2e-3 * abs(b) for b in ref]
        check(all(abs(a - b) <= g for a, b, g in zip(
                  wit["losses"]["held"], ref, held_gates)),
              f"f32 losses at {L} layers, the square run (the loss on "
              f"standard) with each element whose AdamW first moment differs "
              f"in sign from standard's held to standard's after each step "
              f"(shares {[f'{h:.2e}' for h in wit['held_share']]}): |diff| "
              f"{gaps('held')}; rtol 2e-3, atol 2e-3 "
              f"(TRAJECTORY_WITNESS_NOTE)")
    check(all(math.isfinite(x) for x in losses["square_pallas"])
          and all(d <= g for d, g in zip(diffs, gates)),
          f"f32 losses at {L} layers: square_pallas "
          f"{'(the loss on standard) ' * ('all_square' in losses)}"
          f"{losses['square_pallas']} vs standard {losses['standard']} "
          f"(|diff| {[f'{d:.2e}' for d in diffs]}; rtol 2e-3, atol 2e-3"
          + (f", or a quarter of what standard's steps moved each loss: "
             f"gates {[f'{g:.2e}' for g in gates]})"
             if arch in LOSS_STANDARD_TRAJECTORY else ")"))
    out["losses"] = losses
    return out


def slstm_block_ms(model: LM, params, cfg, dev, gen, B: int, S: int
                   ) -> float:
    """Device ms of one sLSTM block at the step's shapes under autograd as
    the step runs it (its forward, the rematerialised recompute and the
    backward: the S-step loop thrice), captured alone and replayed between
    CUDA events."""
    from repro_torch.train import step as step_mod
    i = cfg.layer_kinds.index("slstm")
    ctx = {"cfg": cfg, "mode": cfg.matmul_mode, "policy": None,
           "positions": torch.arange(S, device=dev), "causal": True}
    x = torch.randn(B, S, cfg.d_model, generator=gen).to(
        torch.bfloat16).to(dev)
    ct = torch.randn(B, S, cfg.d_model, generator=gen).to(
        torch.bfloat16).to(dev)

    def fn(q, b):
        y = counting.remat(lambda h: blk.block_forward(
            "slstm", q["p"], h, ctx)[0])(q["x"])
        return (y.float() * b["ct"].float()).sum(), {}

    def grads_of(p, x, ct):
        return step_mod.value_and_grad(fn, {"p": p, "x": x}, {"ct": ct})[1]

    graph = graphs.CapturedFunction(grads_of, device=dev, name="slstm_block")
    graph(params["layers"][i], x, ct)
    ms = _event_ms(lambda: [graph.replay() for _ in range(3)]) / 3
    graph.release()
    return ms


def recurrent_train_arch_phase(dev, gen, arch) -> dict:
    """``arch`` trained at its published width, bf16, remat "block",
    square_pallas with no policy, RECURRENT_TRAIN_BS[arch] tokens a step,
    RECURRENT_TRAIN_LAYERS[arch] layers (weights drawn on the device,
    :func:`device_tree`): the kernels at every training shape
    (:func:`recurrent_train_kernel_rows`), the f32 parity
    (:func:`recurrent_train_parity`), launches by forward and by step
    against the routing rules (the parity step's split the backward off),
    an eager step under ``set_sync_debug_mode("error")`` whose audit is
    :func:`recurrent_train_audit` and whose first launch at each shape is
    held to its plain version on its own operands, a captured and an
    eager fixed-seed 2-step run (:func:`state_digest`), the capture's
    time, nodes and memory, the eager and the replayed step in turns
    (eager, graph, graph) and traced, a profiled replay's kernels against
    the ledger, the compiled audit of a replay, xlstm's sLSTM blocks'
    share, the ``Trainer`` over the captured step and the launcher
    (:func:`recurrent_launcher_run`).  The captured step is
    ``GuardedStep(jit=True)``'s, the ``Trainer``'s default on CUDA."""
    import tempfile
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod
    from repro_torch.train.trainer import Trainer, TrainerConfig
    t_phase = time.perf_counter()
    lap = lapper()
    cfg = recurrent_train_cfg(arch)
    full = get_config(arch)
    B, S = RECURRENT_TRAIN_BS[arch]
    T, L = B * S, cfg.n_layers
    kk = ("K1", "K2", "K3")
    gc.collect()
    torch.cuda.empty_cache()
    enc = (f" and {cfg.encoder_layers} of its {full.encoder_layers} encoder "
           f"layers over {cfg.encoder_seq} frames" if cfg.encoder_layers
           else f" after its {cfg.prefix_tokens} patches"
           if cfg.prefix_tokens else "")
    print(f"training: {arch} ({full.source}) at its published "
          f"width (d={cfg.d_model} H={cfg.n_heads} V={cfg.vocab}), {L} of "
          f"its {full.n_layers} layers "
          f"{dict(collections.Counter(decoder_kinds(cfg)))}{enc}, "
          f"{cfg.dtype}, "
          f"remat {cfg.remat}, {B} x {S} tokens, square_pallas, no policy; "
          f"card {CARD}", flush=True)
    rules = recurrent_train_launches(cfg, B, S)
    want = {p: tuple(rules[p][k] for k in kk) for p in
            ("forward", "backward", "recompute")}
    step_want = tuple(sum(w[i] for w in want.values()) for i in range(3))
    print(f"  launches a step by the routing rules (K1, K2, K3): forward "
          f"{want['forward']}, backward {want['backward']}, recompute "
          f"{want['recompute']}", flush=True)
    check(all(rules[p]["virtual"] == 0 for p in want),
          "no contraction of the step, forward or backward, routes to the "
          "virtual form")
    rows = recurrent_train_kernel_rows(
        dev, torch.Generator(device=dev).manual_seed(1), cfg, rules)
    lap("the kernels at the training shapes")

    t0 = time.perf_counter()
    view = moe_train_view(build_model(cfg.reduced(), device=dev), cfg)
    tree = device_tree(dataclasses.replace(cfg, dtype="float32"), dev)
    torch.cuda.synchronize()
    print(f"  f32 weights of {L} layers drawn on the device (seed 0) in "
          f"{time.perf_counter() - t0:.2f} s; allocated "
          f"{_gib(torch.cuda.memory_allocated())}", flush=True)
    parity = recurrent_train_parity(dev, arch, view, tree)
    lap("the f32 parity")
    params = moe_train_tree(tree, cfg)
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    n_params = sum(t.numel() for t in tree_leaves(params))
    f32 = sum(t.numel() for t in tree_leaves(params)
              if t.dtype == torch.float32)
    print(f"  bf16 params: {n_params:,} ({n_params / 1e9:.3f} G; {f32:,} "
          f"kept f32 as the spec has them), allocated "
          f"{_gib(torch.cuda.memory_allocated())}", flush=True)
    batches = SyntheticLM(DataConfig(B, S, cfg.vocab), cfg,
                          device=dev).take(3)
    tcfg = step_mod.TrainConfig()
    step = step_mod.make_train_step(view, tcfg)
    loss_fn = step_mod.make_loss_fn(view, tcfg)

    reset_counts()
    with torch.no_grad():
        loss_fn(params, batches[0])
    torch.cuda.synchronize()
    fwd = counts()[:3]
    # an eager step under set_sync_debug_mode("error"), audited, the first
    # launch at each shape held to its plain version on its own operands
    seen, linear = {}, ({} if arch in ORDERED_ARCHS else None)
    restore = _plain_probe(seen, linear)
    opt = adamw.adamw_init(params)
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, eager_audit = step_mod.audit_step(step, params, opt, batches[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
        restore()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    eager_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    block = counts()[:3]
    del out, opt
    check(fwd == want["forward"] and block == step_want,
          f"launches (K1, K2, K3): a forward {fwd}, a remat block step "
          f"{block} = the rules' forward + backward + recompute "
          f"{step_want}")
    print(f"  [ok] one eager step ({first_s:.1f} s, its probes included) "
          f"ran under set_sync_debug_mode('error'): no host sync in the "
          f"forward, the scans, the sLSTM loop, the backward or AdamW; its "
          f"peak allocation {eager_peak:.2f} GiB; card {CARD}", flush=True)
    probed = probe_ok(seen, f"that {arch} step", ordered=linear is not None)
    if linear is not None:
        probe_linear_report(linear)
    check(all(probed[k] == set(rules["shapes"][k]) for k in kk),
          f"the probed shapes are the rules' "
          f"{[len(rules['shapes'][k]) for k in kk]} K1/K2/K3 shapes")
    expected = recurrent_train_audit(cfg, B, S)
    got = {s: v["mults"] for s, v in eager_audit.by_site().items()}
    fwd_mults = sum(m for s, m in expected.items() if ".bwd_" not in s)
    check(got == expected and eager_audit.fraction_square == 1.0
          and eager_audit.fraction_square_bwd == 1.0,
          f"eager audit of a step: per site the analytic count "
          f"({eager_audit.total_mults:,} multiplies, "
          f"{eager_audit.total_mults / fwd_mults:.6f} x the forward's "
          f"{fwd_mults:,}), fraction_square and fraction_square_bwd 1.0")
    for site in sorted(s for s in expected if ".bwd_" not in s):
        print(f"    {site}: forward {expected[site]:,}, .bwd_x "
              f"{expected.get(site + '.bwd_x', 0):,}, .bwd_w "
              f"{expected.get(site + '.bwd_w', 0):,}", flush=True)
    lap("launches, the eager audit and the probes")

    # a fixed-seed eager 2-step run (its second step the first eager
    # turn); then the same captured
    walls = {"eager": [], "graph": []}
    p, o, e_losses = params, adamw.adamw_init(params), []
    for i, b in enumerate(batches[:2]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, met = step(p, o, b)
        e_losses.append(float(met["loss"]))
        if i:
            walls["eager"].append(time.perf_counter() - t0)
    print(f"  turn 1 eager: {walls['eager'][0] * 1e3:.1f} ms, "
          f"{T / walls['eager'][0]:.0f} tokens/s; card {CARD}", flush=True)
    fp_eager = state_digest(
        {"losses": torch.tensor(e_losses), "params": p, "opt": o})
    lap("the eager 2-step run")

    def turn(kind, i):
        """One step timed (the path is warm: the eager one has run, the
        graph replayed)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, _ = fns[kind](*state[kind], b_fixed)
        torch.cuda.synchronize()
        walls[kind].append(time.perf_counter() - t0)
        state[kind] = (p, o)
        print(f"  turn {i} {kind}: {walls[kind][-1] * 1e3:.1f} ms, "
              f"{T / walls[kind][-1]:.0f} tokens/s; card {CARD}", flush=True)

    def one(kind):
        p, o, met = fns[kind](*state[kind], b_fixed)
        state[kind] = (p, o)
        return met

    state = {"eager": (p, o)}
    b_fixed = batches[-1]
    # the captured step under the compiled guard (the Trainer's default on
    # CUDA): its probes ride in the graph, and each call drains them
    graph = step_mod.GuardedStep(step, jit=True, registry=MetricsRegistry())
    fns = {"eager": step, "graph": graph}
    stats = {"eager": trace_steps(lambda: float(one("eager")["loss"]),
                                  f"eager {arch} train steps",
                                  min(walls["eager"]), calls=1, host=False)
             if arch in EAGER_TRACED else {}}
    del state["eager"], p, o
    gc.collect()
    torch.cuda.empty_cache()

    g_losses = []
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with counting.compiled_audit():
        p, o = params, adamw.adamw_init(params)
        for b in batches[:2]:
            p, o, met = graph(p, o, b)
            g_losses.append(float(met["loss"]))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    graph_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    call = graph._fn.current
    fp_graph = state_digest(
        {"losses": torch.tensor(g_losses), "params": p, "opt": o})
    ledger = {kern.__name__: n for kern, n, _ in call.ledger.launches}
    led = tuple(ledger.get(f"sq_matmul_{k.lower()}", 0) for k in kk)
    capture = {"capture_s": call.capture_s, "nodes": call.nodes,
               "pool_gib": call.pool_bytes / 2 ** 30, "first_s": first_s,
               "peak_gib": graph_peak}
    print(f"  eager 2 steps {e_losses}, captured {g_losses}; the capture "
          f"took {call.capture_s:.2f} s (recorded and instantiated), the "
          f"graph holds {call.nodes} nodes and its pool "
          f"{capture['pool_gib']:.2f} GiB; warm-up, capture and 2 replays "
          f"{first_s:.1f} s, peak allocation {graph_peak:.2f} GiB of the "
          f"card's {_gib(torch.cuda.get_device_properties(dev).total_memory)}"
          f"; card {CARD}", flush=True)
    check(fp_eager == fp_graph,
          f"captured and eager fixed-seed 2-step runs bit-identical: "
          f"state_digest {fp_eager[:16]}... twice (losses, params, AdamW "
          f"state)")
    check(graph.captures == 1 and led == block
          and graph.stats() == {"guard_trips": 0, "rejits": 0,
                                "retries": 0}
          and counts()[:3] == tuple(3 * n for n in led),
          f"GuardedStep(jit=True): one capture, no re-capture, the guard "
          f"clean {graph.stats()}; by its ledger K1 {led[0]}, K2 {led[1]}, "
          f"K3 {led[2]} a replay (the eager step's), counted 3 times over "
          f"the warm-up and 2 replays")
    state["graph"] = (p, o)
    del p, o
    turn("graph", 2)
    turn("graph", 3)
    stats["graph"] = trace_steps(lambda: float(one("graph")["loss"]),
                                 f"replayed {arch} train steps",
                                 min(walls["graph"]), calls=1, host=False)
    traced = {k: stats["graph"].get(k) for k in kk}
    check(traced == dict(zip(kk, led)),
          f"a profiled replay holds K1/K2/K3 {traced} (the ledger's {led})")
    with counting.track_compiled_contractions() as ctr:
        graph._fn.replay()
    torch.cuda.synchronize()
    audited = {s: v["mults"] for s, v in ctr.by_site().items()}
    check(audited == expected and ctr.fraction_square_bwd == 1.0,
          f"compiled audit of a replayed step: per site the analytic count, "
          f"{ctr.total_mults:,} multiplies, fraction_square "
          f"{ctr.fraction_square} and fraction_square_bwd "
          f"{ctr.fraction_square_bwd}")
    lap("capture, turns, traces and the compiled audit")

    # the Trainer over the captured step; its final state is not written
    # here (recurrentgemma's ~22 GB): the launcher's Trainer below writes
    # its own in a fresh directory
    del state["graph"]
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(TrainerConfig(total_steps=RECURRENT_TRAINER_STEPS,
                                        ckpt_every=10 ** 9, ckpt_dir=tmp,
                                        log_every=1),
                          graph, params, adamw.adamw_init(params),
                          SyntheticLM(DataConfig(B, S, cfg.vocab), cfg,
                                      device=dev))
        trainer._save = lambda block=False: None
        reset_counts()
        t0 = time.perf_counter()
        res = trainer.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launched = counts()[:3]
        wrote = sorted(os.listdir(tmp))
    losses = res["loss_trajectory"]
    audit = res["contraction_audit"]
    check(res["final_step"] == RECURRENT_TRAINER_STEPS
          and res["captures"] == 1 and res["step_failures"] == 0
          and res["guard"] == {"guard_trips": 0, "rejits": 0, "retries": 0}
          and all(math.isfinite(x) for x in losses) and not wrote,
          f"Trainer over the captured step: {RECURRENT_TRAINER_STEPS} "
          f"replays in {run_s:.1f} s, losses {losses}, no new capture, the "
          f"guard clean")
    check({s: v["mults"] for s, v in audit["by_site"].items()} == expected
          and audit["fraction_square"] == 1.0
          and audit["fraction_square_bwd"] == 1.0,
          "the Trainer's first-step audit (the compiled audit of its first "
          "replay): the analytic count, fraction_square and "
          "fraction_square_bwd 1.0")
    check(launched == tuple(RECURRENT_TRAINER_STEPS * n for n in block),
          f"the Trainer's launches {launched} = its "
          f"{RECURRENT_TRAINER_STEPS} replays x a step's {block}")
    graph._fn.release()
    del trainer, graph, fns["graph"], call
    gc.collect()
    torch.cuda.empty_cache()
    lap("the Trainer")
    best = {k: min(v) for k, v in walls.items()}
    slstm_ms = None
    if "slstm" in cfg.layer_kinds:
        slstm_ms = slstm_block_ms(view, params, cfg, dev, gen, B, S)
    for k in ("eager", "graph"):
        st = stats[k]
        share = ""
        if slstm_ms is not None and st:
            n_s = cfg.layer_kinds.count("slstm")
            share = (f", the {n_s} sLSTM blocks {n_s * slstm_ms:.1f} ms "
                     f"({n_s * slstm_ms / st['busy_ms']:.1%} of the busy "
                     f"time; one block's forward, recompute and backward "
                     f"captured alone: {slstm_ms:.2f} ms)")
        busy = (f"traced step {st['ops']:.0f} device operations, busy "
                f"{st['busy_ms']:.1f} ms = "
                f"{st['busy_ms'] / (best[k] * 1e3):.1%} of the untraced "
                f"step: K1 {st['K1_ms']:.1f} ms ({st['K1']:.0f}), K2 "
                f"{st['K2_ms']:.1f} ms ({st['K2']:.0f}), the rest "
                f"{st['busy_ms'] - st['K1_ms'] - st['K2_ms']:.1f} ms{share}"
                if st else "not traced")
        print(f"  {k}: fastest step {best[k] * 1e3:.1f} ms, "
              f"{T / best[k]:.0f} tokens/s; {busy}; card {CARD}",
              flush=True)
    del view, step, loss_fn, params
    gc.collect()
    torch.cuda.empty_cache()
    launcher = recurrent_launcher_run(dev, arch)
    lap("the launcher")

    print(f"  {arch} training phase {time.perf_counter() - t_phase:.1f} s; "
          f"allocated after {_gib(torch.cuda.memory_allocated())}; card "
          f"{CARD}", flush=True)
    return {"rows": rows, "rules": {p: dict(rules[p]) for p in want},
            "step": block, "trainer": dict(zip(kk, launched)),
            "parity": parity,
            "capture": capture, "eager_peak_gib": eager_peak,
            "best_ms": {k: v * 1e3 for k, v in best.items()},
            "trace": {k: {n: v for n, v in st.items() if n != "other"}
                      for k, st in stats.items()},
            "slstm_ms": slstm_ms, "launcher": launcher}


def recurrent_launcher_run(dev, arch) -> dict:
    """``python -m repro_torch.launch.train --arch <arch>`` on the card:
    square_pallas, the config's bf16 and remat "block", the launcher's
    own 8 x 256 tokens a step, RECURRENT_LAUNCHER_STEPS steps replayed
    from one CUDA graph, ``--layers`` RECURRENT_LAUNCHER_LAYERS
    (each arch's first period), a fresh
    ``--ckpt-dir``: finite losses, one
    capture, the final checkpoint committed, the first step's compiled
    audit equal to :func:`recurrent_train_audit` and the launches (the
    capture's warm-up and the replays) a step's by the routing rules."""
    import tempfile
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import train as train_launcher
    from repro_torch.obs.metrics import MetricsRegistry
    B, S = 8, 256                       # the launcher's defaults
    layers = RECURRENT_LAUNCHER_LAYERS[arch]
    steps = RECURRENT_LAUNCHER_STEPS
    cfg = recurrent_train_cfg(arch, layers or get_config(arch).n_layers)
    cut = ["--layers", str(layers)] if layers else []
    if layers and cfg.encoder_layers:
        cut += ["--encoder-layers", str(layers)]
    print(f"  train launcher: python -m repro_torch.launch.train --arch "
          f"{arch} {' '.join(cut)} ({cfg.n_layers} layers), square_pallas, "
          f"{cfg.dtype}, remat {cfg.remat}, {B} x {S} tokens, {steps} "
          f"steps, a fresh --ckpt-dir", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--arch", arch, *cut, "--matmul-mode", "square_pallas",
                "--steps", str(steps), "--ckpt-dir", f"{tmp}/ckpt",
                "--device", str(dev)]
        reset_counts()
        t0 = time.perf_counter()
        res = train_launcher.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()[:3]
        committed = CheckpointManager(f"{tmp}/ckpt",
                                      registry=MetricsRegistry()).steps()
    losses = res["loss_trajectory"]
    rules = recurrent_train_launches(cfg, B, S)
    per_step = tuple(sum(rules[p][k] for p in ("forward", "backward",
                                               "recompute"))
                     for k in ("K1", "K2", "K3"))
    calls = steps + res["captures"]
    check(res["captures"] == 1 and res["final_step"] == steps
          and len(losses) == steps and res["step_failures"] == 0
          and all(math.isfinite(x) for x in losses) and committed == [steps],
          f"the {arch} launcher: {steps} steps in {wall:.1f} s (the host "
          f"draw, the capture, the steps and the final checkpoint), losses "
          f"{losses}, {res['captures']} capture, checkpoint {committed} "
          f"committed in its fresh directory; card {CARD}")
    audit = res["contraction_audit"]
    check({s: v["mults"] for s, v in audit["by_site"].items()}
          == recurrent_train_audit(cfg, B, S)
          and audit["fraction_square"] == 1.0
          and audit["fraction_square_bwd"] == 1.0,
          f"the {arch} launcher's first-step audit (the compiled audit of "
          f"its replay): the analytic count, {audit['total_mults']:,} "
          f"multiplies, fraction_square and fraction_square_bwd 1.0")
    check(launched == tuple(calls * n for n in per_step),
          f"the {arch} launcher's launches (K1, K2, K3) {launched} = "
          f"{calls} steps (the capture's warm-up and {steps} replays) x the "
          f"rules' {per_step}")
    return dict(zip(("K1", "K2", "K3"), launched), wall_s=wall,
                layers=cfg.n_layers, losses=losses)


def recurrent_train_phase(dev, gen, archs=RECURRENT_ARCHS) -> dict:
    """Both archs (or ``archs``) trained, then what the kernels line takes
    from them: the K1-K3 entries (:func:`recurrent_train_entries`) and each
    kernel's launches by path."""
    rt = {arch: recurrent_train_arch_phase(dev, gen, arch)
          for arch in archs}
    k1, k2, k3 = ({"max_abs_err": 0.0} for _ in range(3))
    recurrent_train_entries(k1, k2, k3, rt)
    launches = {kern: {**{f"recurrent_train_{arch}": r["trainer"][kern]
                          for arch, r in rt.items()},
                       **{f"recurrent_train_launcher_{arch}":
                          r["launcher"][kern] for arch, r in rt.items()}}
                for kern in ("K1", "K2", "K3")}
    return {"entries": {"K1": k1, "K2": k2, "K3": k3}, "launches": launches}


def arch_train_phase(dev, gen, arch, name) -> dict:
    """One arch trained (:func:`recurrent_train_arch_phase`), then what the
    kernels line takes from it under ``name``: the K1-K3 entries and each
    kernel's launches by the Trainer and by the launcher."""
    r = recurrent_train_arch_phase(dev, gen, arch)
    k1, k2, k3 = ({"max_abs_err": 0.0} for _ in range(3))
    recurrent_train_entries(k1, k2, k3, {arch: r}, name)
    launches = {kern: {name: r["trainer"][kern],
                       f"{name}_launcher": r["launcher"][kern]}
                for kern in ("K1", "K2", "K3")}
    return {"entries": {"K1": k1, "K2": k2, "K3": k3}, "launches": launches,
            "summary": {k: r[k] for k in ("step", "rules", "best_ms",
                                          "capture", "eager_peak_gib",
                                          "parity", "trace", "launcher")}}


VLM_TRAIN_FLAG = "--vlm-train-phase"
ENCDEC_TRAIN_FLAG = "--encdec-train-phase"


def vlm_train_phase(dev, gen) -> dict:
    """paligemma-3b trained at its published width: 2 of its 18 layers
    over its 256 patches and 256 tokens a sequence."""
    return arch_train_phase(dev, gen, VLM_ARCH, "vlm_train")


def encdec_train_phase(dev, gen) -> dict:
    """whisper-large-v3 trained at its published width: 2 encoder layers
    over the 1500 frames and 2 decoder layers."""
    return arch_train_phase(dev, gen, ENCDEC_ARCH, "encdec_train")


def recurrent_train_entries(k1, k2, k3, rt, name="recurrent_train") -> None:
    """Add training to the K1, K2 and K3 entries of the kernels line under
    ``name``: per train step of each arch at the phase's depth, the
    launches by the routing rules (checked by counter, ledger and
    profiler) and the times at their shapes."""
    for kern, key in ((k1, "K1"), (k2, "K2"), (k3, "K3")):
        kern[name] = {}
        for arch, r in rt.items():
            mine = [row for row in r["rows"] if row["kernel"] == key]
            B, S = RECURRENT_TRAIN_BS[arch]
            enc = (f" (and as many encoder layers)"
                   if get_config(arch).encoder_layers else "")
            entry = {"per": f"one train step of {arch} at its published "
                            f"width, {RECURRENT_TRAIN_LAYERS[arch]} layers"
                            f"{enc}, {B} x {S} tokens: forward, both "
                            f"gradients and the recompute",
                     "launches_per_step": sum(r["rules"][p].get(key, 0)
                                              for p in r["rules"])}
            if mine:
                t_bytes = sum(x["per_step"] * x["t_bytes"] for x in mine)
                t_ops = sum(x["per_step"] * x["t_ops"] for x in mine)
                entry.update(
                    {k: sum(x["per_step"] * (x[k] or 0) for x in mine)
                     for k in ("ms", "plain_ms", "library_ms", "floor_ms")},
                    plain_untimed_launches=sum(
                        x["per_step"] for x in mine if x["plain_ms"] is None),
                    bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    max_abs_err=max(x["max_abs_err"] for x in mine))
                kern["max_abs_err"] = max(kern["max_abs_err"],
                                          entry["max_abs_err"])
            kern[name][arch] = entry


# ---------------------------------------------------------- MoE serving
MOE_ARCH = "moonshot-v1-16b-a3b"
# 4 of its 48 layers: prepared, a layer holds 1.14 GB of bf16 weights and
# 2.28 GB of their f32 canon (3.42 GB); 48 layers (~166 GB with the
# embedding and the prepared vocab table) do not fit one 80 GB card, 16
# (~56.7 GB) leave room for the pools, graphs and transients; 4 keep the
# whole smoke inside its time limit beside the recurrent training phase
# and its launchers (the host draws a layer's 0.55 G weights in ~5 s).
MOE_LAYERS = 4
ROUTE_KERNEL = {"kernel": "K1", "batched": "K2", "fold": "K3",
                "virtual": "virtual"}
# the engine's model calls: a decode tick (SLOTS rows), a prefill chunk
# (CHUNK rows), one row's logits a first token
MOE_CALLS = ("_decode", "_chunk", "_logits_at")
MOE_OUT_TOL = 2e-2          # rows of one expert set: |diff| / max|out|


def moe_cfg(mode="square_pallas", policy=SQUARE_GEMMS_POLICY):
    return dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS,
                               matmul_mode=mode, contraction_policy=policy)


def moe_layer_gemms(cfg, T: int) -> list:
    """(B, m, k, n, dtype) of each GEMM one layer runs over T rows:
    wq, wk, wv, wo on bf16 activations, the router in f32, and the three
    expert GEMMs of C = moe_capacity(T) slots an expert."""
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    C = moe_capacity(T, cfg)
    bf = torch.bfloat16
    return [(1, T, d, H * hd, bf), (1, T, d, KV * hd, bf),
            (1, T, d, KV * hd, bf), (1, T, H * hd, d, bf),
            (1, T, d, E, torch.float32),
            (E, C, d, f, bf), (E, C, d, f, bf), (E, C, f, d, bf)]


def moe_call_launches(cfg) -> dict:
    """{call: Counter(kernel: launches)} of each engine model call, from
    the routing rules (``select_matmul_route``, ``select_paged_attn_route``)
    at the call's shapes.  Under SQUARE_GEMMS_POLICY the gathered softmax
    path of a prefill chunk runs on the multiplier, so only K4 can carry
    attention.  Call before a counted run: the selectors count their
    decisions."""
    L, d, V = cfg.n_layers, cfg.d_model, cfg.padded_vocab
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    out = {}
    for call, T, S in (("_decode", SLOTS, 1), ("_chunk", CHUNK, CHUNK)):
        n = collections.Counter()
        for B, m, k, nn, dt in moe_layer_gemms(cfg, T):
            route = routing.select_matmul_route(m, nn, k, batch=B, dtype=dt)
            n[ROUTE_KERNEL[route.name]] += L
        attn = routing.select_paged_attn_route(
            S, BLOCKS_PER_SEQ * BLOCK, batch=T // S, kv_heads=KV,
            group=cfg.n_heads // KV, hd=hd, dtype=torch.bfloat16)
        if attn.name == "kernel":
            n["K4"] += L
        out[call] = n
    for call, rows in (("_decode", SLOTS), ("_logits_at", 1)):
        route = routing.select_matmul_route(rows, V, d, dtype=torch.float32)
        out.setdefault(call, collections.Counter())[
            ROUTE_KERNEL[route.name]] += 1
    return out


def moe_k1_cases(cfg) -> tuple:
    """(cases, per_tick): K1's (m, k, n) on the MoE path -- the router
    (d x E) and the attention projections (d x d) at a decode tick's 8
    rows and a prefill chunk's 32, the logits at 8 rows and at one -- and
    the launches of each (k, n) in one decode tick."""
    d, E, V, L = cfg.d_model, cfg.n_experts, cfg.padded_vocab, cfg.n_layers
    cases = [(m, d, n, True) for m in (SLOTS, CHUNK) for n in (E, d)]
    cases += [(SLOTS, d, V, True), (1, d, V, True)]
    per_tick = {(d, d): 4 * L, (d, E): L, (d, V): 1}
    return cases, per_tick


def moe_expert_phase(dev, gen, cfg) -> list:
    """K2 (or K3, wherever the routing rule takes them) at the expert
    GEMMs' shapes, (E, C, d) @ (E, d, f) and (E, C, f) @ (E, f, d) with C
    = moe_capacity of a decode tick and of a prefill chunk: against the
    batched plain version (f32 from bf16 inputs), the prepared expert stack
    against its raw bf16 source bit for bit, and timed with the weights
    cycled past the L2 (as the path streams them) beside torch.bmm and
    the byte bound."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    caps = sorted({moe_capacity(SLOTS, cfg), moe_capacity(CHUNK, cfg)})
    print(f"MoE expert GEMMs: K2/K3 vs plain at E={E}, C in {caps} "
          f"(f32 |err| <= k * 2^-23 * (max|a| + max|b|)^2; prepared = raw "
          f"bit for bit); weights cycled past the L2", flush=True)
    rows = []
    for C in caps:
        for k, n in ((d, f), (f, d)):
            route = routing.select_matmul_route(C, n, k, batch=E,
                                                dtype=torch.bfloat16).name
            name = ROUTE_KERNEL[route]
            check(name in BATCHED, f"(E={E}, C={C}, k={k}, n={n}) routes "
                                   f"to K2 or K3: {route}")
            kern, launch_shape = BATCHED[name]
            a = torch.randn(E, C, k, generator=gen).to(torch.bfloat16).to(dev)
            w = (torch.randn(E, k, n, generator=gen) / math.sqrt(k)).to(
                torch.bfloat16).to(dev)
            prep = prepare_operand(w, site="moe_expert")
            aw, bw, sb = a.float(), prep.canon, prep.corr
            sa = -(aw * aw).sum(2)
            out = kern(aw, bw, sa, sb)
            ref = sq_matmul_batched_plain(aw, bw, sa, sb)
            fold = name == "K3"
            same = torch.equal(ops.sq_matmul_local(a, prep, fold=fold),
                               ops.sq_matmul_local(a, w, fold=fold)) \
                and torch.equal(ops.sq_matmul_local(a, prep, fold=fold), out)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            tol = k * 2.0 ** -23 * (aw.abs().max().item()
                                    + bw.abs().max().item()) ** 2
            check(bool(torch.isfinite(out).all()) and err <= tol,
                  f"{name} f32 E={E} C={C} k={k} n={n}: max|err| {err:.3e} "
                  f"<= {tol:.3e}")
            check(same, f"{name} E={E} C={C} k={k} n={n}: the prepared "
                        f"expert stack = its raw bf16 source = the direct "
                        f"launch, bit for bit")
            nc = copies_for(E * k * n * 4)
            bws = [bw.clone() for _ in range(nc)]
            sbs = [sb.clone() for _ in range(nc)]
            ms = time_graph([lambda i=i: kern(aw, bws[i], sa, sbs[i])
                             for i in range(nc)])
            plain_ms = time_graph(
                [lambda i=i: sq_matmul_batched_plain(aw, bws[i], sa, sbs[i])
                 for i in range(nc)], reps=2, replays=1)
            lib_ms = time_graph([lambda i=i: torch.bmm(aw, bws[i])
                                 for i in range(nc)])
            nbytes = 4 * E * (C * k + k * n + C + n + C * n)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = 2 * E * C * n * k / FP32_OPS_PER_S * 1e3
            shape = batched_planned(name, E, C, n, k)
            row = dict(kernel=name, shape=(E, C, k, n), ms=ms,
                       plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=max(t_bytes, t_ops), t_bytes=t_bytes,
                       t_ops=t_ops, grid=shape["grid"], max_abs_err=err,
                       bound_by="bytes" if t_bytes >= t_ops else "operations")
            rows.append(row)
            print(f"    {name} E={E} C={C} k={k:4d} n={n:4d}  {ms:.4f} ms | "
                  f"plain {plain_ms:.3f} ms | torch.bmm {lib_ms:.4f} ms | "
                  f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}) | "
                  f"{row['bound_ms'] / ms:.1%} of bound | grid "
                  f"{shape['grid']} of {shape['rows']}x{shape['cols']} "
                  f"tiles; card {CARD}", flush=True)
            del bws, sbs, prep, w
    L = cfg.n_layers
    for C in caps:
        mine = [r for r in rows if r["shape"][1] == C]
        mult = {(d, f): 2 * L, (f, d): L}
        tot = {key: sum(mult[r["shape"][2:]] * r[key] for r in mine)
               for key in ("ms", "library_ms", "bound_ms")}
        print(f"  per model call at C={C} ({3 * L} expert GEMMs over {L} "
              f"layers, graph replay): {tot['ms']:.3f} ms | torch.bmm "
              f"{tot['library_ms']:.3f} ms | bound {tot['bound_ms']:.3f} ms "
              f"({tot['bound_ms'] / tot['ms']:.1%} of bound); card {CARD}",
              flush=True)
    return rows


def moe_sync_free(params, cfg, dev, gen) -> None:
    """``moe_apply_local`` of layer 0 at a decode tick's and a prefill
    chunk's rows under ``torch.cuda.set_sync_debug_mode("error")``: the
    dispatch reads nothing back to the host, so it can be captured."""
    p = params["layers"][0]["ffn"]
    x = torch.randn(CHUNK, cfg.d_model, generator=gen).to(
        torch.bfloat16).to(dev)
    outs = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            for T in (SLOTS, CHUNK):
                outs.append(moe_apply_local(p, x[:T], cfg=cfg,
                                            mode=cfg.matmul_mode,
                                            policy=cfg.contraction_policy))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(all(bool(torch.isfinite(o).all()) and o.shape == (T, cfg.d_model)
              for (o, _), T in zip(outs, (SLOTS, CHUNK))),
          f"moe_apply_local at T={SLOTS} and T={CHUNK} ran under "
          f"set_sync_debug_mode('error'): no host sync in the dispatch")


def _kept_sets(idx, d):
    """Each row's set of experts, and its set of kept ones."""
    T, K = idx.shape
    keep = torch.zeros(T * K, dtype=torch.bool, device=idx.device)
    keep[d["order"]] = d["keep"]
    keep = keep.reshape(T, K).cpu().numpy()
    idx = idx.cpu().numpy()
    return ([frozenset(r) for r in idx],
            [frozenset(r[kp]) for r, kp in zip(idx, keep)])


def moe_layer_check(model: LM, params, cfg, dev, prompts) -> None:
    """Layer by layer against ``standard``, teacher-forced: each layer's
    MoE input comes from a standard forward of the prompts (right-padded
    with token 0; every row is routed, as in the forward), and that layer's
    ``moe_apply_local`` runs in square_pallas (prepared) and in standard.
    Rows with the same expert set and the same kept experts agree within
    MOE_OUT_TOL * max|out|.  A row whose set differs must be explained by
    rounding: for every expert e the square path took and f it did not,
    standard's logits satisfy l_f - l_e <= 2 * delta, delta the router's
    rounding bound a logit (K1's f32 bound k 2^-23 (max|x| + max|w|)^2,
    plus standard's own k 2^-24 max|x| max|w|); in probabilities the
    6th-7th margin p6 - p7 <= p7 (exp(2 delta) - 1).  A row whose kept
    experts differ must share an expert with such a swap (the swap moved
    the slots of that expert)."""
    std = dataclasses.replace(cfg, matmul_mode="standard",
                              contraction_policy=None)
    raw = model.tree()
    B, S = len(prompts), max(len(p) for p in prompts)
    toks = np.zeros((B, S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    toks = torch.as_tensor(toks, device=dev)
    T, D, E, K = B * S, cfg.d_model, cfg.n_experts, cfg.topk
    C = moe_capacity(T, cfg)
    positions = torch.arange(S, device=dev)
    print(f"  layer-wise vs standard, teacher-forced: {B} prompts padded to "
          f"{S} tokens = {T} routed rows, C={C}", flush=True)
    lines = []
    with torch.no_grad():
        x = model._embed_tokens(raw, toks)
        for i, p in enumerate(raw["layers"]):
            h = blk._norm_apply(std, p["ln1"], x)
            out, _ = attn_mod.attn_forward(p["attn"], h, cfg=std,
                                           positions=positions, causal=True,
                                           window=std.window, mode="standard")
            x = x + out
            hf = blk._norm_apply(std, p["ln2"], x).reshape(T, D)
            pq = params["layers"][i]["ffn"]
            _, gq, iq = moe_route(pq, hf, cfg=cfg, mode=cfg.matmul_mode,
                                  policy=cfg.contraction_policy)
            ps, gs, is_ = moe_route(p["ffn"], hf, cfg=std, mode="standard")
            setq, keptq = _kept_sets(iq, moe_dispatch(iq, gq, E, C))
            sets, kepts = _kept_sets(is_, moe_dispatch(is_, gs, E, C))
            yq, _ = moe_apply_local(pq, hf, cfg=cfg, mode=cfg.matmul_mode,
                                    policy=cfg.contraction_policy)
            ys, _ = moe_apply_local(p["ffn"], hf, cfg=std, mode="standard")
            x = x + ys.reshape(B, S, D)          # teacher-forced: standard

            xmax = hf.float().abs().amax(1)                       # (T,)
            wmax = p["ffn"]["router"]["w"].abs().max()
            delta = (D * 2.0 ** -23 * (xmax + wmax) ** 2
                     + D * 2.0 ** -24 * xmax * wmax).cpu().numpy()
            logits = torch.log(ps.double()).cpu().numpy()   # up to a shift
            pr = torch.sort(ps, dim=1, descending=True).values.cpu().numpy()
            swapped = [t for t in range(T) if setq[t] != sets[t]]
            bad = []
            for t in swapped:
                gap = max(logits[t, f] - logits[t, e]
                          for e in setq[t] - sets[t]
                          for f in sets[t] - setq[t])
                if gap > 2 * delta[t]:
                    bad.append((t, gap, 2 * delta[t]))
            moved = set().union(*[(setq[t] ^ sets[t]) for t in swapped]) \
                if swapped else set()
            keep_diff = [t for t in range(T) if setq[t] == sets[t]
                         and keptq[t] != kepts[t]]
            unexplained = [t for t in keep_diff if not (sets[t] & moved)]
            same = [t for t in range(T) if setq[t] == sets[t]
                    and keptq[t] == kepts[t]]
            scale = ys.float().abs().max().item()
            err = (yq.float()[same] - ys.float()[same]).abs().max().item() \
                if same else 0.0
            margins = [pr[t, K - 1] - pr[t, K] for t in swapped]
            bounds = [pr[t, K] * math.expm1(2 * delta[t]) for t in swapped]
            lines.append((i, len(swapped), len(keep_diff), err / scale))
            check(not bad and not unexplained and err <= MOE_OUT_TOL * scale,
                  f"layer {i:2d}: {len(swapped)} rows swapped an expert "
                  f"(6th-7th margins {[f'{m:.2e}' for m in margins[:4]]} <= "
                  f"bounds {[f'{b:.2e}' for b in bounds[:4]]}), "
                  f"{len(keep_diff)} rows' kept experts moved by them, "
                  f"{len(same)} rows max|diff| {err:.3e} <= "
                  f"{MOE_OUT_TOL} * max|out| ({MOE_OUT_TOL * scale:.3e})"
                  + (f"; unexplained {bad[:3]} {unexplained[:3]}"
                     if bad or unexplained else ""))
    print(f"  swaps per layer: {[n for _, n, _, _ in lines]}; kept sets "
          f"moved per layer: {[n for _, _, n, _ in lines]}", flush=True)

    # end to end, teacher-forced (printed, not gated)
    valid = torch.as_tensor([[j < len(p) for j in range(S)]
                             for p in prompts], device=dev)
    with torch.no_grad():
        hq, _, _ = model.forward(params, {"tokens": toks})
        lq = model.logits(params, hq)[valid]
        model.cfg = std
        try:
            hs, _, _ = model.forward(raw, {"tokens": toks})
            ls = model.logits(raw, hs)[valid]
        finally:
            model.cfg = cfg
    rel = ((lq - ls).abs().max() / ls.abs().max()).item()
    agree = (lq.argmax(-1) == ls.argmax(-1)).float().mean().item()
    print(f"  teacher-forced logits vs standard over {int(valid.sum())} "
          f"prompt positions ({cfg.n_layers} layers, not gated): "
          f"max|diff| / max|logits| {rel:.3e}, argmax agreement "
          f"{agree:.3f}", flush=True)


def _gib(nbytes: int) -> str:
    return f"{nbytes / 2 ** 30:.2f} GiB"


def moe_phase(dev, gen) -> dict:
    """moonshot-v1-16b-a3b at its published width, MOE_LAYERS of its
    layers, served by the paged engine eager and with its three model
    calls captured (see the module docstring)."""
    cfg = moe_cfg()
    full = get_config(MOE_ARCH)
    L = cfg.n_layers
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    print(f"MoE serving: {cfg.name} at its published width (d={cfg.d_model}"
          f" H={cfg.n_heads}x{cfg.resolved_head_dim} E={cfg.n_experts} "
          f"top-{cfg.topk} ff={cfg.d_ff} V={cfg.vocab} cf "
          f"{cfg.capacity_factor}) {cfg.dtype}, {L} of its {full.n_layers} "
          f"layers (depth cut: {full.n_layers} prepared layers do not fit "
          f"the card), square_pallas + square_gemms, prepared; allocated "
          f"before {_gib(mem0)}; card {CARD}", flush=True)
    per_call = moe_call_launches(cfg)
    print(f"  launches by the routing rules: decode tick (T={SLOTS}, C="
          f"{moe_capacity(SLOTS, cfg)}) {dict(per_call['_decode'])}, "
          f"prefill chunk (T={CHUNK}, C={moe_capacity(CHUNK, cfg)}) "
          f"{dict(per_call['_chunk'])}, first token "
          f"{dict(per_call['_logits_at'])}", flush=True)
    check(all(c["virtual"] == 0 for c in per_call.values()),
          "no GEMM of the path routes to the virtual form")
    k1_cases, per_tick = moe_k1_cases(cfg)
    k1_rows = k1_phase(dev, gen, k1_cases, per_step=per_tick,
                       step_rows=(SLOTS,), unit="MoE decode tick")
    k2_rows = moe_expert_phase(dev, gen, cfg)
    compared = {"K1": [(r["m"], r["k"], r["n"]) for r in k1_rows],
                "K2": [r["shape"] for r in k2_rows if r["kernel"] == "K2"],
                "K3": [r["shape"] for r in k2_rows if r["kernel"] == "K3"]}

    t0 = time.perf_counter()
    model = device_model(cfg, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.no_grad():
        params = model.prepare_params()
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    print(f"  model drawn on the device (seed 0) in {init_s:.2f} s, "
          f"prepared in {prep_s:.2f} s; allocated "
          f"{_gib(torch.cuda.memory_allocated())}", flush=True)
    reqs = make_requests(cfg, N_REQUESTS, seed=0)

    def walls_of(what):
        return lambda ticks: tick_walls(ticks, L, per_call, what)

    # warm-up engine: first-touch costs stay out of the measured run
    Engine(model, engine_cfg(max_new=2), device=dev, params=params).run(
        make_requests(cfg, 1, seed=1))
    torch.cuda.synchronize()

    eng = Engine(model, engine_cfg(), device=dev, params=params)
    reset_counts()                      # counts of the main path's run only
    with counting.track_contractions() as eager_audit:
        eager = _timed_run(eng, reqs, 0, walls_of=walls_of("eager"))
    m = eng.metrics
    launched = {"eager": dict(zip(("K1", "K2", "K3", "K4"), counts()))}
    taken = dict(routing.select_matmul_route.taken)
    check(eager["ok"] and all(r.status is RequestStatus.COMPLETED
                              for r in eng.results.values()),
          f"{N_REQUESTS} requests COMPLETED with {MAX_NEW} tokens each")
    check(taken.get("virtual", 0) == 0 and launched["eager"]["K2"] > 0,
          f"no GEMM took the virtual route (routes taken: {taken})")
    shapes_ok(compared)
    audit_ok(eager_audit, cfg, m.decode_steps, m.prefill_chunks,
             m.first_tokens, square_gemms=True)
    eager_steps = (m.decode_steps, m.prefill_chunks, m.first_tokens)
    del eng

    geng = Engine(model, engine_cfg(jit=True), device=dev, params=params)
    reset_counts()
    with counting.compiled_audit(), \
            counting.track_compiled_contractions() as audit:
        first = _timed_run(geng, reqs, 0, walls_of=walls_of("compiled"))
    gm = geng.metrics
    launched["graph"] = dict(zip(("K1", "K2", "K3", "K4"), counts()))
    check(first["ok"] and first["tokens"] == eager["tokens"],
          f"compiled: {N_REQUESTS} requests COMPLETED, tokens equal the "
          f"eager engine's")
    check(geng.captures == 3 and sorted(geng._graph_set.calls) == sorted(
        MOE_CALLS) and gm.guard_rejits == 0,
        f"3 captures ({sorted(geng._graph_set.calls)}), 0 re-captures")
    check((gm.decode_steps, gm.prefill_chunks, gm.first_tokens)
          == eager_steps, f"compiled: the eager run's {eager_steps} decode "
                          f"steps, prefill chunks and first tokens")
    shapes_ok(compared)
    audit_ok(audit, cfg, gm.decode_steps, gm.prefill_chunks,
             gm.first_tokens, square_gemms=True)
    moe_sync_free(params, cfg, dev, gen)

    runs = {"eager": [], "graph": []}
    for i, kind in enumerate(("eager", "graph", "graph", "eager")):
        e = geng if kind == "graph" else Engine(model, engine_cfg(),
                                                device=dev, params=params)
        r = _timed_run(e, reqs, 100 * (i + 1), walls_of=walls_of(kind))
        check(r["ok"] and r["tokens"] == eager["tokens"],
              f"turn {i + 1} ({kind}): the eager run's tokens")
        runs[kind].append(r)
        print(f"  turn {i + 1} {kind}: {r['tokens_per_s']:.1f} tokens/s, "
              f"mean TTFT {r['ttft_ms']:.2f} ms, decode-only tick "
              f"{_walls_str(r['walls'])}; card {CARD}", flush=True)
        del e
    check(geng.captures == 3, "the reused compiled engine captured no more")
    del geng
    med = {k: sorted(w for r in v for w in r["walls"])[
        len(v[0]["walls"] + v[1]["walls"]) // 2] for k, v in runs.items()}
    stats = {k: trace_phase(model, dev, med[k], jit=(k == "graph"),
                            params=params) for k in ("eager", "graph")}
    want = per_call["_decode"]
    got = {key: stats["graph"].get(key) for key in ("K1", "K2", "K3", "K4")}
    check(all(got[key] == want[key] for key in got),
          f"a profiled replayed tick holds {got} kernels (the rules give "
          f"{dict(want)})")
    for k in ("eager", "graph"):
        st = stats[k]
        print(f"  {k}: {runs[k][0]['tokens_per_s']:.1f} and "
              f"{runs[k][1]['tokens_per_s']:.1f} tokens/s, mean TTFT "
              f"{runs[k][0]['ttft_ms']:.2f} and {runs[k][1]['ttft_ms']:.2f} "
              f"ms, median decode-only tick {med[k] * 1e3:.2f} ms; traced "
              f"tick: {st['ops']:.0f} device operations, busy "
              f"{st['busy_ms']:.3f} ms = {st['busy_share']:.1%} of the "
              f"traced wall, K2 {st['K2_ms']:.3f} ms = "
              f"{st['K2_ms'] / st['busy_ms']:.1%} of the busy time, K1 "
              f"{st['K1_ms']:.3f} ms, K4 {st['K4_ms']:.3f} ms; card {CARD}",
              flush=True)

    moe_layer_check(model, params, cfg, dev,
                    [r.tokens for r in reqs])
    peak = torch.cuda.max_memory_allocated()
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  memory: allocated before {_gib(mem0)}, peak {_gib(peak)}, "
          f"after {_gib(torch.cuda.memory_allocated())}; init {init_s:.1f} "
          f"s, prepare {prep_s:.2f} s; card {CARD}", flush=True)
    return {"per_call": per_call, "k1_rows": k1_rows, "k2_rows": k2_rows,
            "per_tick": per_tick, "launches": launched,
            "tick_ms": {k: v * 1e3 for k, v in med.items()},
            "tokens_per_s": {k: [r["tokens_per_s"] for r in v]
                             for k, v in runs.items()}}


# ---------------------------------------------------------- MoE training
# moonshot-v1-16b-a3b at its published width, trained in the launcher's
# configuration (bf16, remat block, 8 x 256 tokens, no policy).  A layer
# holds 570.6 M parameters and the tied vocab table 335.5 M.  At its
# capture a captured step holds the caller's state, the graph's static
# inputs and its new state (10 B a parameter each: bf16 weights, f32 m and
# v) and the gradients: ~32 B a parameter, 66 GB at 3 layers, 84 GB at 4.
# 2 (3 until the recurrent training phase gained its launchers) keep the
# whole smoke inside its time limit.
MOE_TRAIN_LAYERS = 2
MOE_TRAIN_FLAG = "--moe-train-phase"
# the f32 phases against standard: an eager f32 AdamW step holds ~28 B a
# parameter, 41 GB at 2 layers
MOE_TRAIN_F32_LAYERS = 2
MOE_TRAINER_STEPS = 4
# a timed turn: 1 warm step and 3 timed
MOE_TURN_STEPS = 4
MOE_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")
# device work of the dispatch and combine, by kernel name
DISPATCH_OPS = ("sort", "scatter", "gather", "index", "cumsum", "Radix",
                "radix", "cub")


def moe_train_cfg(layers: int = MOE_TRAIN_LAYERS, mode="square_pallas",
                  **kw):
    return dataclasses.replace(get_config(MOE_ARCH), n_layers=layers,
                               matmul_mode=mode, **kw)


def moe_train_view(model: LM, cfg) -> LM:
    """``model``'s forward under ``cfg``, holding none of its weights: a
    train step reads the config and the forward from the model and takes
    the weights as a params tree, so one draw of the weights serves every
    depth, dtype and mode below."""
    view = copy.copy(model)
    view.cfg = cfg
    object.__setattr__(view, "_modules", {})     # none of its weights
    return view


def train_spec(cfg) -> dict:
    """The spec tree of ``cfg``'s params, in ``LM.tree``'s layout."""
    from repro_torch.layers import basic
    from repro_torch.layers.param import torch_dtype
    norm = (basic.layernorm_spec if cfg.norm == "layernorm"
            else basic.rmsnorm_spec)
    spec = {"embed": basic.embed_spec(cfg.padded_vocab, cfg.d_model,
                                      torch_dtype(cfg.dtype)),
            "final_norm": norm(cfg.d_model),
            "layers": [blk.block_spec(k, cfg) for k in decoder_kinds(cfg)]}
    if cfg.encoder_layers:
        spec["encoder"] = {"layers": [blk.block_spec("attn", cfg)] *
                           cfg.encoder_layers, "norm": norm(cfg.d_model)}
    return spec


def moe_train_tree(tree, cfg):
    """The first ``cfg.n_layers`` layers of a params ``tree`` drawn in f32,
    each leaf cast to the dtype of ``cfg``'s spec: the weights
    ``build_model(cfg, seed=0)`` draws (it draws in f32, casts, and draws
    the layers in order), f32 leaves shared with ``tree``."""
    spec = train_spec(cfg)

    def cast(node, s):
        if isinstance(node, dict):
            return {k: cast(v, s[k]) for k, v in node.items()}
        if isinstance(node, list):
            return [cast(n, t) for n, t in zip(node, s)]
        return node if node.dtype == s.dtype else node.to(s.dtype)
    return cast(dict(tree, layers=tree["layers"][:cfg.n_layers]), spec)


def _module(node) -> torch.nn.Module:
    """A params tree as the LM's modules: a dict of tensors becomes an
    ``nn.ParameterDict`` of serving weights, a list an ``nn.ModuleList``,
    a dict of subtrees an ``nn.ModuleDict``."""
    if isinstance(node, list):
        return torch.nn.ModuleList(_module(n) for n in node)
    if all(isinstance(v, torch.Tensor) for v in node.values()):
        return torch.nn.ParameterDict({
            k: torch.nn.Parameter(v, requires_grad=False)
            for k, v in node.items()})
    return torch.nn.ModuleDict({k: _module(v) for k, v in node.items()})


def device_model(cfg, dev, seed: int = 0) -> LM:
    """An LM of ``cfg`` whose weights are drawn on the device
    (:func:`device_tree`, each leaf cast to its spec's dtype as
    ``build_model`` casts): the distributions ``build_model(cfg,
    seed=seed)`` draws from, other bits, in well under a second where a
    host draw of a few G parameters took tens of seconds."""
    tree = moe_train_tree(device_tree(dataclasses.replace(
        cfg, dtype="float32"), dev, seed), cfg)
    model = moe_train_view(build_model(cfg.reduced(), device=dev), cfg)
    for name, sub in tree.items():
        setattr(model, name, _module(sub))
    return model


def moe_train_gemms(cfg) -> list:
    """(B, m, k, n) of each forward GEMM of one train step, canonical (B,
    m, k) @ (B, k, n): a layer's q, k, v, attention scores and PV (one q
    and one kv chunk), o, the router and the three expert GEMMs of C =
    moe_capacity(T) slots an expert; then the loss's vocab GEMM."""
    d, f, E, V = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.padded_vocab
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    T, S = TRAIN_T, TRAIN_S
    C = moe_capacity(T, cfg)
    nb, gs = TRAIN_B * KV, H // KV * S
    layer = [(1, T, d, H * hd), (1, T, d, KV * hd), (1, T, d, KV * hd),
             (nb, gs, hd, S), (nb, gs, S, hd), (1, T, H * hd, d),
             (1, T, d, E), (E, C, d, f), (E, C, d, f), (E, C, f, d)]
    return layer * cfg.n_layers + [(1, T, d, V)]


def grad_gemms(B, m, k, n) -> tuple:
    """The canonical (dL/dx, dL/dW) GEMMs of a (B, m, k) @ (B, k, n) one:
    (B, m, n) @ (B, n, k) and (B, n, m) @ (B, m, k)."""
    return (B, m, n, k), (B, n, m, k)


def gemm_kernel(B, m, k, n) -> str:
    """The kernel ``select_matmul_route`` sends a GEMM to."""
    return ROUTE_KERNEL[routing.select_matmul_route(m, n, k, batch=B).name]


def moe_train_launches(cfg) -> dict:
    """{part: Counter(kernel: launches)} of one train step by the routing
    rules: the forward, the backward (dL/dx and dL/dW of each forward
    GEMM) and the recompute (remat block: every layer GEMM again; the
    loss's one chunk at either setting, as its chunk body is
    rematerialised)."""
    fwd = moe_train_gemms(cfg)
    out = {p: collections.Counter()
           for p in ("forward", "backward", "recompute")}
    for g in fwd:
        out["forward"][gemm_kernel(*g)] += 1
        for h in grad_gemms(*g):
            out["backward"][gemm_kernel(*h)] += 1
    for g in fwd:
        out["recompute"][gemm_kernel(*g)] += 1
    return out


def _event_ms(fn) -> float:
    """Device ms of one eager call between CUDA events (a plain version
    too large to capture)."""
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


def _plain_batched(aw, bw, sa, sb, budget=2 ** 31):
    """K2's plain version in blocks of batch elements, each block's
    k_chunk-wide slab of squares within ``budget`` bytes."""
    per = 16 * aw.shape[1] * bw.shape[2] * 4
    nb = max(1, budget // per)
    return torch.cat([sq_matmul_batched_plain(aw[i:i + nb], bw[i:i + nb],
                                              sa[i:i + nb], sb[i:i + nb])
                      for i in range(0, aw.shape[0], nb)])


def moe_train_kernel_phase(dev, gen, cfg) -> list:
    """K1 at the router's GEMMs of a train step (forward (T, d) @ (d, E),
    dL/dx (T, E) @ (E, d), dL/dW (E, T) @ (T, d)) and K2 (or K3, where the
    rule sends them) at the expert GEMMs' (forward and dL/dx (E, C, d) @
    (E, d, f) and (E, C, f) @ (E, f, d); dL/dW (E, f, C) @ (E, C, d) and
    (E, d, C) @ (E, C, f)), C = moe_capacity(T): against the plain version
    (f32 from bf16-rounded operands), timed in graph replay with the
    operands hot beside torch.matmul / torch.bmm (no TF32), the bound and
    the FP32 slot floor (2 slots a term), the plain version once between
    CUDA events."""
    d, f, E, L = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.n_layers
    C = moe_capacity(TRAIN_T, cfg)
    router, up, down = (1, TRAIN_T, d, E), (E, C, d, f), (E, C, f, d)
    # launches a step: forward, backward and the recompute
    cases = collections.Counter({router: 2 * L, up: 2 * 2 * L,
                                 down: 2 * L})
    for g, times in ((router, L), (up, 2 * L), (down, L)):
        for h in grad_gemms(*g):
            cases[h] += times
    print(f"MoE training shapes (T = {TRAIN_T}, C = {C}): K1 at the "
          f"router's, K2/K3 at the experts', held to their plain versions "
          f"(f32 |err| <= k * 2^-23 * (max|a| + max|b|)^2) and timed (graph "
          f"replay, operands hot); card {CARD}", flush=True)
    rows = []
    for (B, m, k, n), per_step in sorted(cases.items()):
        name = gemm_kernel(B, m, k, n)
        check(name in ("K1", "K2", "K3"),
              f"(B={B}, m={m}, k={k}, n={n}) routes to a kernel: {name}")
        a = torch.randn(B, m, k, generator=gen).to(torch.bfloat16).to(dev)
        b = (torch.randn(B, k, n, generator=gen) / math.sqrt(k)).to(
            torch.bfloat16).to(dev)
        aw, bw = a.float(), b.float()
        sa, sb = -(aw * aw).sum(2), -(bw * bw).sum(1)
        if name == "K1":
            args = (aw[0], bw[0], sa[0], sb[0])
            kern, lib = sq_matmul_k1, (lambda: torch.matmul(aw[0], bw[0]))
            plain = lambda: _plain_rows(*args)                 # noqa: E731
            grid = k1_planned(m, n, k)["grid"]
        else:
            args = (aw, bw, sa, sb)
            kern, lib = BATCHED[name][0], (lambda: torch.bmm(aw, bw))
            plain = lambda: _plain_batched(*args)              # noqa: E731
            grid = BATCHED[name][1](B, m, n)["grid"]
        out = kern(*args)
        ref = plain()
        err = (out - ref).abs().max().item()
        tol = k * 2.0 ** -23 * (aw.abs().max().item()
                                + bw.abs().max().item()) ** 2
        check(bool(torch.isfinite(out).all()) and err <= tol,
              f"{name} f32 B={B} m={m} k={k} n={n}: max|err| {err:.3e} <= "
              f"{tol:.3e}")
        del out, ref
        ms = time_graph([lambda: kern(*args)], reps=5, replays=2)
        lib_ms = time_graph([lib], reps=5, replays=2)
        plain_ms = _event_ms(plain)
        terms = B * m * k * n
        t_bytes = 4 * B * (m * k + k * n + m + n + m * n) \
            / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * terms / FP32_OPS_PER_S * 1e3
        row = dict(kernel=name, shape=(B, m, k, n), per_step=per_step,
                   ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   floor_ms=2 * terms / FP32_SLOTS_PER_S * 1e3,
                   bound_ms=max(t_bytes, t_ops), t_bytes=t_bytes,
                   t_ops=t_ops, max_abs_err=err, grid=grid)
        rows.append(row)
        print(f"    {name} B={B:2d} m={m:4d} k={k:4d} n={n:4d} x{per_step:2d}"
              f" a step: {ms:.4f} ms | plain {plain_ms:.2f} ms | "
              f"{'torch.matmul' if name == 'K1' else 'torch.bmm'} "
              f"{lib_ms:.4f} ms ({ms / lib_ms:.2f}x) | bound "
              f"{row['bound_ms']:.4f} ms | slot floor {row['floor_ms']:.4f} "
              f"ms ({row['floor_ms'] / ms:.1%} of it) | grid {grid}; card "
              f"{CARD}", flush=True)
        del a, b, aw, bw, sa, sb, args
    for name in ("K1", "K2", "K3"):
        mine = [r for r in rows if r["kernel"] == name]
        if mine:
            tot = {key: sum(r["per_step"] * r[key] for r in mine)
                   for key in ("ms", "library_ms", "floor_ms", "bound_ms")}
            print(f"  per train step ({L} layers, "
                  f"{sum(r['per_step'] for r in mine)} launches at these "
                  f"shapes): {name} {tot['ms']:.3f} ms | library "
                  f"{tot['library_ms']:.3f} ms | slot floor "
                  f"{tot['floor_ms']:.3f} ms | bound {tot['bound_ms']:.3f} "
                  f"ms; card {CARD}", flush=True)
    return rows


def _routing_spy():
    """Wrap ``moe_route`` and ``moe_dispatch`` as ``moe_apply_local`` calls
    them: each call appends its router probabilities, experts, dispatch
    and the largest |x| and |w| of the router GEMM.  Returns the list and
    the function that unwraps them."""
    from repro_torch.models import moe as moe_mod
    seen, real = [], (moe_mod.moe_route, moe_mod.moe_dispatch)

    def route(p, x, **kw):
        probs, gates, idx = real[0](p, x, **kw)
        w = p["router"]["w"]
        seen.append({"probs": probs.detach(), "idx": idx,
                     "amax": (x.abs().max().item(),
                              w.abs().max().item())})
        return probs, gates, idx

    def dispatch(idx, gates, n_experts, capacity):
        d = real[1](idx, gates, n_experts, capacity)
        seen[-1].update(C=capacity, **{k: d[k] for k in ("st", "keep",
                                                          "order")})
        return d

    moe_mod.moe_route, moe_mod.moe_dispatch = route, dispatch

    def restore():
        moe_mod.moe_route, moe_mod.moe_dispatch = real
    return seen, restore


def moe_routing_diff(sq, std, cfg) -> list:
    """Per layer: the experts whose kept token set differs between the two
    modes, and for each token whose expert set differs, the margin by
    which standard preferred each expert the square path dropped (l_f -
    l_e from standard's probabilities) against twice the router's
    rounding bound a logit, delta = K1's f32 bound k 2^-23 (max|x| +
    max|w|)^2 plus standard's own k 2^-24 max|x| max|w| (the MoE serving
    phase's rule).  Upstream layers also differ by rounding, so a margin
    above 2 delta is reported, not a fault."""
    k = cfg.d_model
    out = []
    for a, b in zip(sq, std):
        sets_a, kept_a = _kept_sets(a["idx"], a)
        sets_b, kept_b = _kept_sets(b["idx"], b)
        moved = set().union(*(x ^ y for x, y in zip(kept_a, kept_b)))
        rows = [t for t, (x, y) in enumerate(zip(sets_a, sets_b)) if x != y]
        lp = torch.log(b["probs"].double()).cpu()
        margins = [(lp[t, f] - lp[t, e]).item() for t in rows
                   for e in sets_a[t] - sets_b[t]
                   for f in sets_b[t] - sets_a[t]]
        xm, wm = b["amax"]
        delta = k * 2.0 ** -23 * (xm + wm) ** 2 + k * 2.0 ** -24 * xm * wm
        out.append({"same": [e for e in range(cfg.n_experts)
                             if e not in moved],
                    "rows": len(rows), "margins": margins,
                    "bound": 2 * delta})
    return out


def _tree_leaves_named(tree) -> dict:
    return dict(zip(_leaf_names(tree), tree_leaves(tree)))


def _pinned_routes(routes):
    """Make ``moe_route`` take each call's experts from ``routes`` (another
    run's, in call order), with its own probabilities gathered there and
    renormalised as the gates: the same function of the weights as that
    run's, so the two differ by rounding alone.  Returns the function that
    unwraps it."""
    from repro_torch.models import moe as moe_mod
    real, it = moe_mod.moe_route, iter(routes)

    def route(p, x, **kw):
        probs, _, _ = real(p, x, **kw)
        idx = next(it)["idx"]
        gates = torch.gather(probs, 1, idx)
        return probs, gates / torch.clamp(
            torch.sum(gates, dim=-1, keepdim=True), min=1e-9), idx

    moe_mod.moe_route = route

    def restore():
        moe_mod.moe_route = real
    return restore


def _rel_slices(got, ref, experts=None) -> dict:
    """{tensor: ||got - ref|| / ||ref||}, the expert stacks by expert
    (``path[e]``), of every expert or of those in ``experts[layer]``."""
    rel = {}

    def one(a, b):
        if b.norm() == 0 and a.norm() == 0:
            return 0.0
        return ((a.double() - b.double()).norm()
                / b.double().norm().clamp_min(1e-300)).item()

    for path, r in ref.items():
        parts = path.split("/")
        if len(parts) > 4 and parts[1] == "layers" \
                and parts[4] in MOE_EXPERT_LEAVES:
            keep = range(r.shape[0]) if experts is None else \
                experts[int(parts[2])]
            for e in keep:
                rel[f"{path}[{e}]"] = one(got[path][e], r[e])
        else:
            rel[path] = one(got[path], r)
    return rel


def _rel_str(rel: dict) -> str:
    worst = max(rel, key=rel.get)
    return (f"{len(rel)} tensors and expert slices, ||diff|| / ||standard|| "
            f"median {sorted(rel.values())[len(rel) // 2]:.3e}, worst "
            f"{rel[worst]:.3e} ({worst})")


def moe_grads(model: LM, params, batch, cfg, scale: float, pin=None):
    """One step's gradients of ``cfg``'s loss times ``scale`` (divided by it
    after) at ``params``, ``{leaf path: tensor}``, and each MoE layer's
    routing (``_routing_spy``); with ``pin``, on those routes
    (``_pinned_routes``)."""
    from repro_torch.train import step as step_mod
    loss_fn = step_mod.make_loss_fn(moe_train_view(model, cfg),
                                    step_mod.TrainConfig())

    def scaled(p, b):
        loss, met = loss_fn(p, b)
        return loss * scale, met

    spy, unspy = _routing_spy()
    unpin = _pinned_routes(pin) if pin is not None else None
    try:
        _, g = step_mod.value_and_grad(scaled, params, batch)
    finally:
        if unpin is not None:
            unpin()
        unspy()
    return {k: t / scale for k, t in _tree_leaves_named(g).items()}, spy


# The gradient gates of MoE training (f32, the loss x GRAD_SCALE, per
# tensor in norm, each run on square_pallas's routing).  With every site
# square, K1's dL/dx of the loss sums k = vocab = 163840 terms, in 8
# partials of 20480 squares each added in sequence: the cotangent that
# enters the network is then off standard's by ~1e-2 and every gradient
# inherits it (scripts/train_grad_gap.py on an H100: worst 5.2e-2 at 2^14,
# square_scan's chunked sums of the same squares 4.7e-3), though each
# launch is within its f32 bound.  So the step with every site square is
# held at MOE_GRAD_RTOL_ALL, above that and below a wrong, zero or missing
# launch's ~1, and the step with the loss's GEMM on standard in both runs
# at the dense gate, GRAD_RTOL["float32"] (worst 8.7e-4 there).
MOE_GRAD_RTOL_ALL = 1e-1


def moe_train_parity_phase(dev, model: LM) -> dict:
    """f32 at MOE_TRAIN_F32_LAYERS layers, remat none, the model's own f32
    weights: one step's gradients of the loss x GRAD_SCALE in
    square_pallas against standard's (TF32 off), with every K1/K2 launch
    of the square step held to the exact (float64) product of its
    operands.  Each layer's routing is compared first: the experts whose
    kept token set differs, and each swapped assignment's margin.  A swap
    in one layer moves its token's cotangent, and through attention its
    sequence's, in every layer below by more than rounding, so the gates
    hold square_pallas to standard run on square_pallas's routing
    (``_pinned_routes``), every tensor and every expert's slice of the
    three expert stacks: within MOE_GRAD_RTOL_ALL with every site square,
    within GRAD_RTOL["float32"] with the loss's vocab GEMM on standard in
    both runs (see MOE_GRAD_RTOL_ALL).  Against standard's own routing the
    non-expert tensors and the same-set experts' slices are reported.  Then
    3 steps' losses against standard's at rtol = atol = 2e-3."""
    from repro_torch.configs.base import ContractionPolicy
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod
    L = MOE_TRAIN_F32_LAYERS
    cfgs = {m: moe_train_cfg(L, m, dtype="float32", remat="none")
            for m in ("square_pallas", "standard")}
    params = moe_train_tree(model.tree(), cfgs["standard"])
    batches = SyntheticLM(DataConfig(TRAIN_B, TRAIN_S, model.cfg.vocab),
                          cfgs["standard"], device=dev).take(3)
    print(f"MoE train parity: {MOE_ARCH} full width, {L} layers, f32, "
          f"remat none, square_pallas vs standard (no TF32); one step's "
          f"gradients of the loss x {GRAD_SCALE:g}, then 3 steps' losses",
          flush=True)
    want = moe_train_launches(cfgs["square_pallas"])

    def grads(cfg, pin=None):
        return moe_grads(model, params, batches[0], cfg, GRAD_SCALE, pin=pin)

    seen, restore = _probed_kernels()
    try:
        sq, sq_routes = grads(cfgs["square_pallas"])
    finally:
        restore()
    n_want = (sum(want["forward"].values())
              + sum(want["backward"].values()) + 1)
    bad = [r for r in seen if not r[2] <= r[3]]
    worst = max(seen, key=lambda r: r[2] / r[3])
    check(len(seen) == n_want and not bad
          and want["forward"]["K3"] == want["backward"]["K3"] == 0,
          f"one f32 step: all {len(seen)} K1/K2 launches (the rules give "
          f"{n_want}, none on K3) within k * 2^-23 * (max|a| + max|b|)^2 of "
          f"their exact products (worst {worst[0]} {worst[1]}: "
          f"{worst[2]:.3e} <= {worst[3]:.3e})")
    launched = {(r[0], r[1]) for r in seen}
    std, std_routes = grads(cfgs["standard"])
    pinned, _ = grads(cfgs["standard"], pin=sq_routes)
    check(list(sq) == list(std) == list(pinned) and all(
        bool(torch.isfinite(t).all()) for t in sq.values()),
        f"f32 gradients: {len(sq)} finite tensors in each run")
    diff = moe_routing_diff(sq_routes, std_routes, cfgs["standard"])
    check(len(diff) == L, f"routing recorded in each of the {L} layers")
    swapped = []
    for li, dl in enumerate(diff):
        n_diff = model.cfg.n_experts - len(dl["same"])
        swapped.append(n_diff)
        m = dl["margins"]
        print(f"  layer {li}: {dl['rows']} of {TRAIN_T} tokens routed to "
              f"another expert set, {n_diff} of {model.cfg.n_experts} "
              f"experts with another kept token set; swap margins "
              f"(standard's l_f - l_e) {'max %.3e' % max(m) if m else 'none'}"
              f", {sum(x > dl['bound'] for x in m)} of {len(m)} above 2 delta "
              f"= {dl['bound']:.3e} (reported: the layers' inputs differ "
              f"too)", flush=True)
    print(f"  against standard's own routing (reported): "
          f"{_rel_str(_rel_slices(sq, std, [dl['same'] for dl in diff]))}",
          flush=True)
    rel = _rel_slices(sq, pinned)
    check(max(rel.values()) <= MOE_GRAD_RTOL_ALL,
          f"f32 gradients of the loss x {GRAD_SCALE:g}, every site square, "
          f"vs standard on square_pallas's routing: {_rel_str(rel)} <= "
          f"{MOE_GRAD_RTOL_ALL:g}")
    grad_worst = {"all": max(rel.values())}
    del sq, std, pinned, sq_routes, std_routes
    pol = ContractionPolicy.of(loss="standard")
    sq, sq_routes = grads(dataclasses.replace(cfgs["square_pallas"],
                                              contraction_policy=pol))
    pinned, _ = grads(dataclasses.replace(cfgs["standard"],
                                          contraction_policy=pol),
                      pin=sq_routes)
    rel = _rel_slices(sq, pinned)
    check(max(rel.values()) <= GRAD_RTOL["float32"],
          f"f32 gradients of the loss x {GRAD_SCALE:g}, the loss's vocab GEMM "
          f"on standard in both runs, vs standard on square_pallas's "
          f"routing: {_rel_str(rel)} <= {GRAD_RTOL['float32']:g}")
    grad_worst["loss_standard"] = max(rel.values())
    del sq, pinned, sq_routes

    losses = {}
    for mode, cfg in cfgs.items():
        step = step_mod.make_train_step(moe_train_view(model, cfg),
                                        step_mod.TrainConfig())
        p, o = params, adamw.adamw_init(params)
        losses[mode] = []
        for b in batches:
            p, o, met = step(p, o, b)
            losses[mode].append(float(met["loss"]))
        del p, o, step
        gc.collect()
    diffs = [abs(a - b) for a, b in zip(losses["square_pallas"],
                                        losses["standard"])]
    check(all(math.isfinite(x) for x in losses["square_pallas"])
          and all(d <= 2e-3 + 2e-3 * abs(b)
                  for d, b in zip(diffs, losses["standard"])),
          f"f32 losses at {L} layers: square_pallas "
          f"{losses['square_pallas']} vs standard {losses['standard']} "
          f"(|diff| {[f'{d:.2e}' for d in diffs]}; rtol 2e-3, atol 2e-3)")
    return {"launched": launched, "swapped_experts": swapped,
            "grad_worst": grad_worst}


def moe_layer_backward_phase(dev, params, cfg, gen) -> None:
    """One layer's MoE at a step's T = 2048 rows, its backward (dL/dx, the
    router and the three expert stacks) run twice eagerly and once
    captured into a CUDA graph: the three bit for bit."""
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod
    p = params["layers"][0]["ffn"]
    x = torch.randn(TRAIN_T, cfg.d_model, generator=gen).to(
        torch.bfloat16).to(dev)
    ct = torch.randn(TRAIN_T, cfg.d_model, generator=gen).to(
        torch.bfloat16).to(dev)

    def grads_of(p, x, ct):
        def fn(q, b):
            out, aux = moe_apply_local(q["p"], q["x"], cfg=cfg,
                                       mode=cfg.matmul_mode)
            return (out.float() * b["ct"].float()).sum() + aux, {}
        _, g = step_mod.value_and_grad(fn, {"p": p, "x": x}, {"ct": ct})
        return g

    runs = [grads_of(p, x, ct) for _ in range(2)]
    graph = graphs.CapturedFunction(grads_of, device=dev, name="moe_bwd")
    runs.append(graph(p, x, ct))
    torch.cuda.synchronize()
    fps = [adamw.tree_fingerprint(r) for r in runs]
    names = sorted(_tree_leaves_named(runs[0]))
    check(fps[0] == fps[1] == fps[2],
          f"one layer's MoE backward at T = {TRAIN_T} ({', '.join(names)}): "
          f"two eager runs and a captured one bit for bit")
    graph.release()


def moe_train_phase(dev, gen) -> dict:
    """moonshot-v1-16b-a3b at its published width, trained: the kernels at
    the router's and experts' training shapes, the f32 parity phase, then
    MOE_TRAIN_LAYERS layers in the launcher's configuration (bf16, remat
    block, square_pallas, no policy): launches by forward, backward and
    recompute against the routing rules (by counter; the captured step's
    by its ledger and a profiled replay), an eager step under
    ``set_sync_debug_mode("error")`` whose audit is the analytic count,
    one layer's MoE backward eager twice and captured, a captured and an
    eager fixed-seed 2-step run's fingerprints, the eager and the captured
    step timed in turns and traced, the compiled audit of a replay,
    ``GuardedStep(jit=True)`` clean and the ``Trainer`` over the captured
    step (MOE_TRAINER_STEPS steps, its first-step audit; no checkpoint is
    written: the state is ~20 GB)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod
    from repro_torch.train.trainer import Trainer, TrainerConfig
    lap = lapper()
    cfg = moe_train_cfg()
    full = get_config(MOE_ARCH)
    L = cfg.n_layers
    gc.collect()
    torch.cuda.empty_cache()
    print(f"MoE training: {cfg.name} at its published width (d="
          f"{cfg.d_model} H={cfg.n_heads}x{cfg.resolved_head_dim} E="
          f"{cfg.n_experts} top-{cfg.topk} ff={cfg.d_ff} V={cfg.vocab} cf "
          f"{cfg.capacity_factor}), {L} of its {full.n_layers} layers (depth "
          f"cut: a captured step holds ~32 B a parameter), {cfg.dtype}, "
          f"remat {cfg.remat}, {TRAIN_B} x {TRAIN_S} tokens, square_pallas, "
          f"no policy; allocated before "
          f"{_gib(torch.cuda.memory_allocated())}; card {CARD}", flush=True)
    rules = moe_train_launches(cfg)
    print(f"  launches a step by the routing rules: forward "
          f"{dict(rules['forward'])}, backward {dict(rules['backward'])}, "
          f"recompute {dict(rules['recompute'])}", flush=True)
    check(all(c["virtual"] == 0 and c["K3"] == 0 for c in rules.values()),
          "no GEMM of the step, forward or backward, routes to the virtual "
          "form or to K3")
    rows = moe_train_kernel_phase(dev, gen, cfg)
    lap("the kernels at the training shapes")

    t0 = time.perf_counter()
    model = device_model(moe_train_cfg(dtype="float32"), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"  f32 weights of {L} layers drawn on the device (seed 0) in "
          f"{init_s:.2f} s; allocated "
          f"{_gib(torch.cuda.memory_allocated())}", flush=True)
    parity = moe_train_parity_phase(dev, model)
    lap("the weights' draw and the f32 parity")
    params = moe_train_tree(model.tree(), cfg)
    model = moe_train_view(model, cfg)     # the f32 weights go
    gc.collect()
    torch.cuda.empty_cache()
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"  bf16 params: {n_params:,} ({n_params / 1e9:.3f} G), "
          f"allocated {_gib(torch.cuda.memory_allocated())}", flush=True)
    compared = {"K1": [], "K2": [], "K3": []}
    for r in rows:
        B, m, k, n = r["shape"]
        compared[r["kernel"]].append((m, k, n) if B == 1 and r["kernel"]
                                     == "K1" else (B, m, k, n))
    for name, shape in parity["launched"]:
        compared[name].append(shape)
    data = SyntheticLM(DataConfig(TRAIN_B, TRAIN_S, cfg.vocab), cfg,
                       device=dev)
    batches = data.take(3)
    tcfg = step_mod.TrainConfig()
    step = step_mod.make_train_step(model, tcfg)
    loss_fn = step_mod.make_loss_fn(model, tcfg)
    moe_layer_backward_phase(dev, params, cfg, gen)

    # launches: forward, a remat none step, a remat block step (eager,
    # under set_sync_debug_mode("error"), audited)
    split = {}
    reset_counts()
    with torch.no_grad():
        loss_fn(params, batches[0])
    split["forward"] = counts()[:3]
    step_none = step_mod.make_train_step(
        moe_train_view(model, dataclasses.replace(cfg, remat="none")), tcfg)
    reset_counts()
    step_none(params, adamw.adamw_init(params), batches[0])
    torch.cuda.synchronize()
    split["none"] = counts()[:3]
    del step_none
    gc.collect()
    opt = adamw.adamw_init(params)
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, eager_audit = step_mod.audit_step(step, params, opt,
                                               batches[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    eager_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    split["block"] = counts()[:3]
    shapes_ok(compared)
    del out, opt
    kk = ("K1", "K2", "K3")
    want = {p: tuple(rules[p][k] for k in kk) for p in rules}
    print(f"  launches (K1, K2, K3): forward {split['forward']}, a remat "
          f"none step {split['none']}, a remat block step {split['block']};"
          f" the rules' forward {want['forward']}, backward "
          f"{want['backward']}, recompute {want['recompute']}", flush=True)
    check(split["forward"] == want["forward"]
          and split["none"] == tuple(a + b + (k == "K1") for a, b, k in zip(
              want["forward"], want["backward"], kk))
          and split["block"] == tuple(a + b + c for a, b, c in zip(
              want["forward"], want["backward"], want["recompute"])),
          "launches a step = forward + 2 x backward + the recompute, as the "
          "routing rules give them (the loss's chunk recomputed at either "
          "setting)")
    print(f"  [ok] one eager step ran under set_sync_debug_mode('error'): "
          f"no host sync in the forward, the backward or AdamW; its peak "
          f"allocation {eager_peak:.2f} GiB; card {CARD}", flush=True)
    expected = expected_train_audit(cfg)
    got = {s: v["mults"] for s, v in eager_audit.by_site().items()}
    check(got == expected and eager_audit.fraction_square == 1.0
          and eager_audit.fraction_square_bwd == 1.0,
          f"eager audit of a step: per site the analytic count "
          f"(moe_router {expected['moe_router']:,}, moe_expert "
          f"{expected['moe_expert']:,}, each again at .bwd_x and .bwd_w), "
          f"{eager_audit.total_mults:,} multiplies, fraction_square 1.0 and "
          f"fraction_square_bwd 1.0")

    lap("the layer backward, launches and the eager audit")
    # a captured and an eager fixed-seed 2-step run, bit for bit; the
    # eager state goes on as the first eager turn
    p, o, e_losses = params, adamw.adamw_init(params), []
    for b in batches[:2]:
        p, o, met = step(p, o, b)
        e_losses.append(float(met["loss"]))
    fp_eager = adamw.tree_fingerprint(
        {"losses": torch.tensor(e_losses), "params": p, "opt": o})
    walls = {"eager": [], "graph": []}

    def turn(kind, fn, i):
        times = []
        for _ in range(MOE_TURN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        times = sorted(times[1:])
        walls[kind] += times
        mid = times[len(times) // 2]
        print(f"  turn {i} {kind}: median {mid * 1e3:.1f} ms (min "
              f"{times[0] * 1e3:.1f}, max {times[-1] * 1e3:.1f}), "
              f"{TRAIN_T / mid:.0f} tokens/s; card {CARD}", flush=True)

    state = {"eager": (p, o)}
    b_fixed = batches[-1]

    def one(kind):
        p, o, met = fns[kind](*state[kind], b_fixed)
        state[kind] = (p, o)
        return met

    graph = step_mod.jit_train_step(step, dev)
    fns = {"eager": step, "graph": graph}
    turn("eager", lambda: one("eager"), 1)
    med_e1 = sorted(walls["eager"])[len(walls["eager"]) // 2]
    stats = {"eager": trace_steps(lambda: float(one("eager")["loss"]),
                                  "eager MoE train steps", med_e1, calls=1)}
    del state["eager"], p, o
    gc.collect()
    torch.cuda.empty_cache()

    g_losses = []
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with counting.compiled_audit():
        p, o = params, adamw.adamw_init(params)
        for b in batches[:2]:
            p, o, met = graph(p, o, b)
            g_losses.append(float(met["loss"]))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    graph_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    fp_graph = adamw.tree_fingerprint(
        {"losses": torch.tensor(g_losses), "params": p, "opt": o})
    ledger = {kern.__name__: n for kern, n, _ in
              graph.current.ledger.launches}
    led = tuple(ledger.get(f"sq_matmul_{k.lower()}", 0) for k in kk)
    print(f"  eager 2 steps {e_losses}, captured {g_losses}; the capture "
          f"and 2 steps {first_s:.1f} s, peak allocation {graph_peak:.2f} "
          f"GiB; card {CARD}", flush=True)
    check(fp_eager == fp_graph,
          f"captured and eager fixed-seed 2-step runs bit-identical: "
          f"fingerprint {fp_eager[:16]}... twice (losses, params, AdamW "
          f"state)")
    check(graph.captures == 1 and led == split["block"]
          and counts()[:3] == tuple(3 * n for n in led),
          f"one capture; by its ledger K1 {led[0]}, K2 {led[1]}, K3 {led[2]}"
          f" a replay (the eager step's), counted 3 times over the warm-up "
          f"and 2 replays")
    shapes_ok(compared)
    state["graph"] = (p, o)
    del p, o
    turn("graph", lambda: one("graph"), 2)
    turn("graph", lambda: one("graph"), 3)
    med = {"eager": med_e1, "graph": sorted(walls["graph"])[
        len(walls["graph"]) // 2]}
    stats["graph"] = trace_steps(lambda: float(one("graph")["loss"]),
                                 "replayed MoE train steps", med["graph"],
                                 calls=1)
    traced = tuple(stats["graph"].get(k) for k in kk)
    check(traced == led,
          f"a profiled replay holds {traced} K1/K2/K3 kernels (the "
          f"ledger's {led})")
    with counting.track_compiled_contractions() as ctr:
        graph.replay()
    torch.cuda.synchronize()
    audited = {s: v["mults"] for s, v in ctr.by_site().items()}
    check(audited == expected and ctr.fraction_square_bwd == 1.0,
          f"compiled audit of a replayed step: per site the analytic count, "
          f"{ctr.total_mults:,} multiplies, fraction_square "
          f"{ctr.fraction_square} and fraction_square_bwd "
          f"{ctr.fraction_square_bwd}")
    graph.release()
    del state["graph"], graph, fns["graph"]
    gc.collect()
    torch.cuda.empty_cache()
    state["eager"] = (params, adamw.adamw_init(params))
    turn("eager", lambda: one("eager"), 4)
    med["eager"] = sorted(walls["eager"])[len(walls["eager"]) // 2]

    # AdamW's device time over this state, apart (the params stand in for
    # the gradients: one shape and dtype), the second of two calls
    p, o = state.pop("eager")
    adam_ms = [_event_ms(lambda: adamw.adamw_update(tcfg.opt, p, p, o))
               for _ in range(2)][-1]
    del p, o
    gc.collect()
    torch.cuda.empty_cache()
    for k in ("eager", "graph"):
        st = stats[k]
        other = st.get("other", {})
        disp = sum(ms for name, ms in other.items()
                   if any(s in name for s in DISPATCH_OPS))
        print(f"  {k}: median step {med[k] * 1e3:.1f} ms, "
              f"{TRAIN_T / med[k]:.0f} tokens/s; traced step "
              f"{st['ops']:.0f} device operations, busy {st['busy_ms']:.1f} "
              f"ms = {st['busy_ms'] / (med[k] * 1e3):.1%} of the untraced "
              f"median: K2 {st['K2_ms']:.1f} ms ({st['K2']:.0f}), K1 "
              f"{st['K1_ms']:.1f} ms ({st['K1']:.0f}), the dispatch's sort, "
              f"scatter, gather and index ops {disp:.1f} ms, AdamW alone "
              f"{adam_ms:.1f} ms (between CUDA events), the rest "
              f"{st['busy_ms'] - st['K1_ms'] - st['K2_ms'] - disp:.1f} ms "
              f"(AdamW in it); card {CARD}", flush=True)

    lap("the captured and eager runs, turns, traces and the compiled audit")
    # GuardedStep(jit=True): clean
    gs = step_mod.GuardedStep(step, jit=True, registry=MetricsRegistry())
    p, o = params, adamw.adamw_init(params)
    for i in range(2):
        p, o, met = gs(p, o, batches[i])
    torch.cuda.synchronize()
    check(gs.stats() == {"guard_trips": 0, "rejits": 0, "retries": 0}
          and gs.captures == 1 and math.isfinite(float(met["loss"])),
          f"GuardedStep(jit=True) over the MoE step: 2 calls clean "
          f"{gs.stats()}, {gs.captures} capture")
    gs._fn.release()
    del gs, p, o, met
    gc.collect()
    torch.cuda.empty_cache()

    # the Trainer over the captured step; no checkpoint is written on the
    # card (the run's state would be ~20 GB), so its saves do nothing
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(TrainerConfig(total_steps=MOE_TRAINER_STEPS,
                                        ckpt_every=10 ** 9, ckpt_dir=tmp,
                                        log_every=1),
                          step_mod.jit_train_step(step, dev), params,
                          adamw.adamw_init(params),
                          SyntheticLM(DataConfig(TRAIN_B, TRAIN_S,
                                                 cfg.vocab), cfg,
                                      device=dev))
        trainer._save = lambda block=False: None
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        res = trainer.run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launched = counts()[:3]
        wrote = os.listdir(tmp)
        trainer.train_step.release()
    losses = res["loss_trajectory"]
    audit = res["contraction_audit"]
    got = {s: v["mults"] for s, v in audit["by_site"].items()}
    calls = MOE_TRAINER_STEPS + res["captures"]
    check(res["final_step"] == MOE_TRAINER_STEPS and res["captures"] == 1
          and all(math.isfinite(x) for x in losses) and not wrote
          and res["step_failures"] == 0,
          f"Trainer: {MOE_TRAINER_STEPS} captured steps, losses {losses}, "
          f"{res['captures']} capture, no checkpoint written, peak "
          f"allocation {peak:.2f} GiB; card {CARD}")
    check(got == expected and audit["fraction_square"] == 1.0
          and audit["fraction_square_bwd"] == 1.0,
          "the Trainer's first-step audit (the compiled audit of its first "
          "replay): the analytic count, fraction_square and "
          "fraction_square_bwd 1.0")
    check(launched == tuple(calls * n for n in split["block"]),
          f"the Trainer's launches {launched} = (steps + captures) {calls} "
          f"x a step's {split['block']}")
    del trainer, params, model, step, loss_fn
    gc.collect()
    torch.cuda.empty_cache()
    lap("GuardedStep and the Trainer")
    print(f"  memory: an eager step peaks at {eager_peak:.2f} GiB, the "
          f"captured step's first call at {graph_peak:.2f} GiB, the "
          f"Trainer at {peak:.2f} GiB; after "
          f"{_gib(torch.cuda.memory_allocated())}; card {CARD}", flush=True)
    return {"rows": rows, "rules": rules, "step": split["block"],
            "trainer": dict(zip(kk, launched)),
            "median_ms": {k: v * 1e3 for k, v in med.items()},
            "trace": stats, "adamw_ms": adam_ms,
            "peak_gib": {"eager": eager_peak, "graph": graph_peak,
                         "trainer": peak}}


def moe_entries(k1, k2, k4, moe) -> None:
    """Add the MoE path to the K1, K2 and K4 entries of the kernels line:
    launches per decode tick, prefill chunk and first token by the routing
    rules (which the MoE phase checked by counter, ledger and profiler),
    and K1's and K2's times per decode tick at its shapes."""
    pc, cfg = moe["per_call"], moe_cfg()
    k2_mult = {(cfg.d_model, cfg.d_ff): 2 * cfg.n_layers,
               (cfg.d_ff, cfg.d_model): cfg.n_layers}
    tick = {"K1": ([r for r in moe["k1_rows"] if r["m"] == SLOTS],
                   lambda r: moe["per_tick"][(r["k"], r["n"])]),
            "K2": ([r for r in moe["k2_rows"]
                    if r["shape"][1] == moe_capacity(SLOTS, cfg)],
                   lambda r: k2_mult[r["shape"][2:]]),
            "K4": ([], None)}
    for kern, key in ((k1, "K1"), (k2, "K2"), (k4, "K4")):
        rows, mult = tick[key]
        kern["moe"] = {
            "per": f"one decode tick of {MOE_ARCH} at its published width, "
                   f"{cfg.n_layers} layers, {SLOTS} rows",
            "launches_per_decode_tick": pc["_decode"][key],
            "launches_per_prefill_chunk": pc["_chunk"][key],
            "launches_per_first_token": pc["_logits_at"][key]}
        if rows:
            kern["moe"].update(
                {k: sum(mult(r) * r[k] for r in rows)
                 for k in ("ms", "plain_ms", "library_ms", "bound_ms")},
                max_abs_err=max(r["max_abs_err"] for r in rows))
            kern["max_abs_err"] = max(kern["max_abs_err"],
                                      kern["moe"]["max_abs_err"])


def moe_train_entries(k1, k2, mt) -> None:
    """Add MoE training to the K1 and K2 entries of the kernels line: per
    train step of the MoE phase's depth, the router's (K1) and the
    experts' (K2) launches at the shapes timed there, their times, and
    each kernel's launches a whole step by the routing rules (which the
    phase checked by counter, ledger and profiler)."""
    L = MOE_TRAIN_LAYERS
    for kern, key in ((k1, "K1"), (k2, "K2")):
        rows = [r for r in mt["rows"] if r["kernel"] == key]
        t_bytes = sum(r["per_step"] * r["t_bytes"] for r in rows)
        t_ops = sum(r["per_step"] * r["t_ops"] for r in rows)
        kern["moe_train"] = {
            "per": f"one train step of {MOE_ARCH} at its published width, "
                   f"{L} layers, {TRAIN_B} x {TRAIN_S} tokens: the "
                   f"{'router' if key == 'K1' else 'expert'} GEMMs, "
                   f"forward, both gradients and the recompute",
            "launches_at_these_shapes": sum(r["per_step"] for r in rows),
            "launches_per_step": sum(mt["rules"][p][key]
                                     for p in mt["rules"]),
            **{k: sum(r["per_step"] * r[k] for r in rows)
               for k in ("ms", "plain_ms", "library_ms", "floor_ms")},
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": max(r["max_abs_err"] for r in rows)}
        kern["max_abs_err"] = max(kern["max_abs_err"],
                                  kern["moe_train"]["max_abs_err"])


# ------------------------------------------------------------ the planner
TUNING_FLAG = "--tuning-phase"
AUTOTUNE_FLAG = "--autotune"
CROSSOVER_FLAG = "--crossovers"
# K4 at the paged engine's decode step and the 1024-token tables (bf16
# pools), K5/K6 at the batched DFT and 64^3 (m, n, k)
K4_TUNE_SHAPES = [(SLOTS, 1, HEADS, 1, HEAD_DIM, BLOCKS_PER_SEQ, BLOCK),
                  (SLOTS, 1, HEADS, 1, HEAD_DIM, 64, BLOCK)]
CPM_TUNE_SHAPES = [(DFT_SIGNALS, DFT_POINTS, DFT_POINTS), (64, 64, 64)]


def tuning_shapes(prompt_lens, attn: bool = False) -> dict:
    """Every shape the kernel phases hold K1-K7 at (the serving paths'
    launches): K1 at :func:`k1_cases`, K2/K3 at :func:`batched_cases`, K4
    at the decode step and the long tables, K5/K6 at the DFT shapes, K7 at
    ResNet-50's six layers; with ``attn``, also K2 at deepseek-7b's
    attention chunks (base and folded)."""
    cases = batched_cases(prompt_lens)
    shapes = {
        "sq_matmul": sorted({(m, n, k) for m, k, n, _ in
                             k1_cases(prompt_lens)}),
        "sq_matmul_batched": sorted({(nb, m, n, k)
                                     for nb, m, k, n in cases["K2"]}),
        "sq_matmul_folded": sorted({(nb, m, n, k)
                                    for nb, m, k, n in cases["K3"]}),
        "sq_paged_attn": K4_TUNE_SHAPES, "cpm": CPM_TUNE_SHAPES,
        "sq_conv2d": [(xs, ws[0], ws[2:], *conv_geometry(xs, ws, st, pd))
                      for _, xs, ws, st, pd in RESNET50_LAYERS]}
    if attn:
        shapes["sq_matmul_batched"] += attn_k2_shapes()
    return shapes


def autotune_all(shapes: dict, path: str, verbose: bool = False) -> dict:
    """Every plan variant of K1-K7 at ``shapes``, each held to its plain
    version (kernels/tuning.py's autotune), timed; the winners written to
    the cache at ``path``.  Returns the entries."""
    found = {}
    for kind in ("sq_matmul", "sq_matmul_batched", "sq_matmul_folded"):
        found.update(tuning.autotune_matmul(shapes[kind], kind=kind,
                                            path=path, verbose=verbose))
    found.update(tuning.autotune_paged_attn(
        shapes["sq_paged_attn"], torch.bfloat16, path=path,
        verbose=verbose))
    for kind in ("cpm3_matmul", "cpm4_matmul"):
        found.update(tuning.autotune_cpm(shapes["cpm"], kind=kind, path=path,
                                         verbose=verbose))
    found.update(tuning.autotune_conv2d(shapes["sq_conv2d"], path=path,
                                        verbose=verbose))
    return found


def print_entries(entries: dict, what: str) -> None:
    """One line a cache entry: the model rule's variant and time, the
    winner's, and how many variants were held to plain and timed."""
    print(f"{what} ({CARD}):", flush=True)
    for key, e in sorted(entries.items()):
        fields = {k: v for k, v in e.items() if k not in (
            "us_per_call", "rule", "rule_us", "variants", "max_abs_err")}
        print(f"    {key}: rule {e['rule']} {e['rule_us']:.2f} us | winner "
              f"{fields} {e['us_per_call']:.2f} us "
              f"({e['rule_us'] / e['us_per_call']:.3f}x) | "
              f"{e['variants']} variants, max|err| {e['max_abs_err']:.2e}",
              flush=True)


def model_plans(shapes: dict) -> dict:
    """Under ``REPRO_AUTOTUNE=0`` every plan the planner gives at
    ``shapes`` against the launch rule the C sources applied before the
    planner: {kind: (equal, total)}."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    k1 = [tuning.plan_matmul(m, n, k) == tuning.K1Plan(
        k1_launch_shape(m, n)["rows"], k1_launch_shape(m, n)["cols"])
        for m, n, k in shapes["sq_matmul"]]
    out["K1"] = (sum(k1), len(k1))
    for name, kind in (("K2", "sq_matmul_batched"),
                       ("K3", "sq_matmul_folded")):
        got = [tuning.plan_matmul(m, n, k, batch=nb, kind=kind)
               == tuning.BatchedPlan(k2_launch_shape(nb, m, n)["rows"],
                                     k2_launch_shape(nb, m, n)["cols"])
               for nb, m, n, k in shapes[kind]]
        out[name] = (sum(got), len(got))
    k4 = [tuning.plan_paged_attn(B, S, KV, G, hd, nb, bs, torch.bfloat16,
                                 sms=sms).splits == k4_splits(B, KV, nb, sms)
          for B, S, KV, G, hd, nb, bs in shapes["sq_paged_attn"]]
    out["K4"] = (sum(k4), len(k4))
    for name, own in (("K5", cpm3_matmul.K5_TILE),
                      ("K6", cpm4_matmul.K6_TILE)):
        got = [tuning.plan_cpm(PLAN_KIND[name], m, n, k).thread_tile
               == cpm3_matmul.cpm_launch_shape(m, n, own)["thread_tile"]
               for m, n, k in shapes["cpm"]]
        out[name] = (sum(got), len(got))
    k7 = []
    for xs, N, khw, st, pads in shapes["sq_conv2d"]:
        rule = k7_launch_shape(xs, N, khw, st, pads, sms)
        k7.append(tuning.plan_conv2d(xs, N, khw, st, pads, sms=sms)
                  == tuning.Conv2DPlan(rule["band"], rule["grid"][2]))
    out["K7"] = (sum(k7), len(k7))
    return out


def bitwise_variants(dev, gen, shapes: dict) -> int:
    """K1 under both tiles and K2 and K3 under all six at nb = 1, at every
    K1 shape, and K2 and K3 under all six at every batched shape beside K1
    on its first element: one result, bit for bit.  Returns the launches
    compared."""
    n = 0
    for m, n_, k in shapes["sq_matmul"]:
        aw, bw = torch.randn(m, k, generator=gen).to(dev), \
            torch.randn(k, n_, generator=gen).to(dev)
        sa, sb = -(aw * aw).sum(1), -(bw * bw).sum(0)
        outs = [sq_matmul_k1(aw, bw, sa, sb, plan=p) for p in
                tuning.candidates_matmul("sq_matmul", m, n_, k)]
        outs += [kern(aw[None], bw[None], sa[None], sb[None], plan=p)[0]
                 for kern in (sq_matmul_k2, sq_matmul_k3)
                 for p in tuning.candidates_matmul("sq_matmul_batched", m,
                                                   n_, k)]
        check(all(torch.equal(o, outs[0]) for o in outs),
              f"K1 x2 tiles, K2 x6, K3 x6 at nb=1, m={m} k={k} n={n_}: "
              f"{len(outs)} results bit for bit")
        n += len(outs)
    for kind in ("sq_matmul_batched", "sq_matmul_folded"):
        for nb, m, n_, k in shapes[kind]:
            aw = torch.randn(nb, m, k, generator=gen).to(dev)
            bw = torch.randn(nb, k, n_, generator=gen).to(dev)
            sa, sb = -(aw * aw).sum(2), -(bw * bw).sum(1)
            outs = [kern(aw, bw, sa, sb, plan=p)
                    for kern in (sq_matmul_k2, sq_matmul_k3)
                    for p in tuning.candidates_matmul(kind, m, n_, k, nb)]
            first = sq_matmul_k1(aw[0], bw[0], sa[0], sb[0])
            check(all(torch.equal(o, outs[0]) for o in outs)
                  and torch.equal(outs[0][0], first),
                  f"K2 x6, K3 x6 at B={nb} m={m} k={k} n={n_}, and K1 on "
                  f"element 0: bit for bit")
            n += len(outs) + 1
    return n


@contextlib.contextmanager
def _env(**values):
    """Environment variables for the block (None unsets), restored after,
    with the planner's memo dropped on both sides."""
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        os.environ.pop(k, None) if v is None else os.environ.update({k: v})
    tuning.clear_cache()
    try:
        yield
    finally:
        for k, v in old.items():
            os.environ.pop(k, None) if v is None else os.environ.update(
                {k: v})
        tuning.clear_cache()


def tuning_phase(dev, gen) -> dict:
    """The planner on the card (kernels/tuning.py; run in a process of its
    own, since it sets the planner's variables): model mode = the launch
    rule at every shape of the kernel phases; K1 = K2 = K3 bit for bit
    under every variant; every variant of K1-K7 at those shapes held to
    its plain version and timed, the winners in a scratch cache
    (``autotune_*``); the scratch cache served (hits counted, ``tuning.cache``
    events traced); a route override in it that moves one batched GEMM
    from K2 to K3, by counter; and ``REPRO_AUTOTUNE=0``, which ignores the
    override and the cache."""
    t0 = time.perf_counter()
    prompt_lens = [len(r.tokens) for r in make_requests(
        serve_cfg(), N_REQUESTS, seed=0)]
    shapes = tuning_shapes(prompt_lens)
    with _env(REPRO_AUTOTUNE="0"):
        rule = model_plans(shapes)
    for name, (eq, tot) in rule.items():
        check(eq == tot, f"model mode: {name}'s plan = its launch rule at "
                         f"{eq} of {tot} shapes")
    compared = bitwise_variants(dev, gen, shapes)
    scratch = Path(__file__).resolve().parent / "build" / \
        "tuning_smoke.json"
    scratch.parent.mkdir(exist_ok=True)
    scratch.unlink(missing_ok=True)
    t_tune = time.perf_counter()
    entries = autotune_all(shapes, str(scratch))
    tune_s = time.perf_counter() - t_tune
    print_entries(entries, f"autotune of every variant at the kernel phases' "
                           f"shapes, {tune_s:.1f} s")
    check(len(entries) == sum(len(v) for k, v in shapes.items()) + len(
        shapes["cpm"]), f"an entry for every shape ({len(entries)})")
    reg = tuning._HIT_COUNTER, tuning._MISS_COUNTER
    with _env(REPRO_TORCH_TUNING_CACHE=str(scratch), REPRO_AUTOTUNE=None), \
            obs_trace.capture() as tracer:
        hits0, miss0 = (c.value for c in reg)
        served = model_plans(shapes)   # every shape resolves from the cache
        hits, misses = reg[0].value - hits0, reg[1].value - miss0
        events = [r for r in tracer.records() if r.name == "tuning.cache"]
        check(hits == len(entries) and misses == 0 and len(events) == hits
              and all(r.args["hit"] for r in events),
              f"scratch cache served: {hits:.0f} hits, {misses:.0f} misses, "
              f"{len(events)} tuning.cache events")
        differ = {k: t - e for k, (e, t) in served.items()}
        a = torch.randn(HEADS, CHUNK, HEAD_DIM, generator=gen).to(dev)
        b = torch.randn(HEADS, HEAD_DIM, BLOCKS_PER_SEQ * BLOCK,
                        generator=gen).to(dev)
        sizes = {"b": HEADS, "m": CHUNK, "n": BLOCKS_PER_SEQ * BLOCK,
                 "k": HEAD_DIM}
        reset_counts()
        fs_einsum("bmk,bkn->bmn", a, b, mode="square_pallas")
        before = (sq_matmul_k2.launches, sq_matmul_k3.launches)
        key = routing.set_route_override("matmul", dict(sizes, dtype="float32"),
                                         "fold", path=str(scratch))
        reset_counts()
        moved = fs_einsum("bmk,bkn->bmn", a, b, mode="square_pallas")
        after = (sq_matmul_k2.launches, sq_matmul_k3.launches)
        route = routing.select_route("matmul", sizes).name
    check(before == (1, 0) and after == (0, 1) and route == "fold",
          f"route override {key} -> fold: K2/K3 launches {before} before, "
          f"{after} after (select_route says {route})")
    with _env(REPRO_TORCH_TUNING_CACHE=str(scratch), REPRO_AUTOTUNE="0"):
        reset_counts()
        plain = fs_einsum("bmk,bkn->bmn", a, b, mode="square_pallas")
        off = (sq_matmul_k2.launches, sq_matmul_k3.launches)
        hits0 = reg[0].value
        again = model_plans(shapes)
        check(off == (1, 0) and torch.equal(plain, moved)
              and reg[0].value == hits0
              and all(e == t for e, t in again.values()),
              f"REPRO_AUTOTUNE=0: the override ignored (K2/K3 {off}, the "
              f"same result bit for bit), no cache hit, every plan the "
              f"model's")
    wall = time.perf_counter() - t0
    print(f"tuning phase: {wall:.1f} s ({tune_s:.1f} s of it timing "
          f"{sum(e['variants'] for e in entries.values())} variants); "
          f"winners other than the rule: {differ}", flush=True)
    return {"entries": entries, "rule": rule, "bitwise": compared,
            "seconds": wall, "tune_s": tune_s}


def autotune_main(dev, path: str) -> dict:
    """``python3 chip_smoke.py --autotune FILE``: the committed cache.  One
    autotune over every shape the kernel phases hold K1-K7 at and
    deepseek-7b's attention chunks, written to FILE (a fresh file)."""
    prompt_lens = [len(r.tokens) for r in make_requests(
        serve_cfg(), N_REQUESTS, seed=0)]
    Path(path).unlink(missing_ok=True)
    t0 = time.perf_counter()
    with _env(REPRO_AUTOTUNE="0"):
        entries = autotune_all(tuning_shapes(prompt_lens, attn=True), path)
    print_entries(entries, f"autotune into {path}, "
                           f"{time.perf_counter() - t0:.1f} s")
    return entries


# Route crossovers: each rule's two routes timed as the dispatch runs them
# (REPRO_ROUTE pins one), over a sweep of the quantity its threshold reads.
CROSS_CUBES = (2, 4, 8, 16, 24, 32, 48, 64, 96, 128, 256)
CROSS_DECODE = ((8, 64), (8, 128), (8, 256), (8, 512), (8, 768),
                (8, 3072))                          # (m, k = n)
CROSS_FOLD = ((1, 64, 64), (1, 128, 64), (4, 32, 32), (8, 128, 64),
              (32, 128, 64), (32, 64, 128))          # per element (m, n, k)
CROSS_BATCH = (1, 2, 4, 8, 16, 48, 96, 384)
CROSS_CONV = ((8, 1, 32), (8, 3, 32), (8, 8, 32), (8, 14, 32),
              (8, 3, 56), (8, 16, 56), (8, 64, 28), (8, 64, 56),
              (1, 3, 224), (8, 3, 224))             # (B, cin, H = W), 3x3
CROSS_PAGED_S = (1, 2, 4, 8, 9, 16, 32)
CROSS_PAGED_NB = (1, 2, 4, 8, 16, 64)                 # T = 16 nb


def _route_ms(kind: str, route: str, fn) -> float:
    with _env(REPRO_ROUTE=f"{kind}={route}"):
        return tuning.time_graph([fn], reps=10, replays=3)


def crossovers_main(dev, path: str) -> dict:
    """``python3 chip_smoke.py --crossovers FILE``: each route rule's two
    routes timed on the card as ``fs_einsum`` / ``conv2d`` / the paged
    attention read run them, over the quantity its threshold reads; the
    smallest point from which the rule's preferred route is no slower, as
    JSON in FILE.  The thresholds stay as they are (ROADMAP Q2)."""
    gen = torch.Generator().manual_seed(0)
    out = {"card": CARD}

    def mm(m, n, k, nb=1):
        a = torch.randn(*((nb,) if nb > 1 else ()), m, k,
                        generator=gen).to(dev)
        b = torch.randn(*((nb,) if nb > 1 else ()), k, n,
                        generator=gen).to(dev)
        spec = "bmk,bkn->bmn" if nb > 1 else "mk,kn->mn"
        return lambda: fs_einsum(spec, a, b, mode="square_pallas")

    rows = []
    for m, n, k in [(c, c, c) for c in CROSS_CUBES] + \
            [(m, kn, kn) for m, kn in CROSS_DECODE]:
        f = mm(m, n, k)
        rows.append({"m": m, "n": n, "k": k, "mults": m * n * k,
                     "kernel_ms": _route_ms("matmul", "kernel", f),
                     "virtual_ms": _route_ms("matmul", "virtual", f)})
    out["virtual_floor"] = rows
    rows = []
    for (m, n, k), nb in itertools.product(CROSS_FOLD, CROSS_BATCH):
        if nb == 1:
            continue
        f = mm(m, n, k, nb)
        rows.append({"batch": nb, "m": m, "n": n, "k": k,
                     "step_ops": cost_model.pm_tile_vpu_ops(m, n, k, 32),
                     "batched_ms": _route_ms("matmul", "batched", f),
                     "fold_ms": _route_ms("matmul", "fold", f)})
    out["fold"] = rows
    rows = []
    from repro_torch.core.conv import conv2d
    for B, cin, hw in CROSS_CONV:
        x = torch.randn(B, cin, hw, hw, generator=gen).to(dev)
        w = prepare_operand(torch.randn(64, cin, 3, 3, generator=gen).to(dev),
                            for_="conv2d")
        f = lambda x=x, w=w: conv2d(x, w, padding="SAME",   # noqa: E731
                                    mode="square_pallas")
        rows.append({"batch": B, "cin": cin, "hw": hw, "k_volume": cin * 9,
                     "patch_bytes": cost_model.conv2d_patch_bytes(
                         hw, hw, 3, 3, cin, batch=B),
                     "fused_ms": _route_ms("conv2d", "fused", f),
                     "im2col_ms": _route_ms("conv2d", "im2col", f)})
    out["im2col"] = rows
    rows = []
    for S, nb in itertools.product(CROSS_PAGED_S, CROSS_PAGED_NB):
        rows.append(dict(S=S, T=nb * BLOCK, **paged_routes_ms(dev, gen, S,
                                                               nb)))
    out["paged"] = rows
    Path(path).write_text(json.dumps(out, indent=1))
    for name, rows in out.items():
        if name == "card":
            continue
        print(f"crossover sweep {name} ({CARD}):", flush=True)
        for r in rows:
            print("    " + ", ".join(f"{k} {v:.4f}" if isinstance(v, float)
                                     else f"{k} {v}" for k, v in r.items()),
                  flush=True)
    return out


def paged_routes_ms(dev, gen, S: int, nb: int) -> dict:
    """The paged attention read of a decode or chunk step (the paged
    engine's geometry: 8 sequences, 12 kv-heads of 64, bf16 pools, each
    table full) on both routes: K4 and the gathered window through the
    square-routed einsums (``_attn_paged_step``'s two)."""
    B, KV, hd = SLOTS, HEADS, HEAD_DIM
    q, kps, vps, tables, pos_pool, _ = k4_inputs(dev, gen, B=B, S=S, nb=nb)
    kp, vp = kps[0], vps[0]
    q_pos = torch.arange(nb * BLOCK - S, nb * BLOCK, dtype=torch.int32,
                         device=dev).expand(B, S).contiguous()

    def kernel():
        return sq_paged_attn_k4(q, kp, vp, tables, pos_pool, q_pos,
                                block_size=BLOCK)

    def gather():
        idx = attn_mod.paged_gather_indices(tables, BLOCK)
        k, v, kv_pos = kp[idx].float(), vp[idx].float(), pos_pool[idx]
        valid = (kv_pos[:, None, :] <= q_pos[:, :, None]) \
            & (kv_pos[:, None, :] < attn_mod.ATTEND_POS_LIMIT)
        s = fs_einsum("bqkgh,btkh->bkgqt", q, k, mode="square_pallas",
                      site="attn_scores")
        s = s.masked_fill(~valid[:, None, None], attn_mod.NEG_INF)
        return fs_einsum("bkgqt,btkh->bqkgh", torch.softmax(s, dim=-1), v,
                         mode="square_pallas", site="attn_pv")

    exact = attn_f64(q, kp, vp, tables, pos_pool, q_pos)
    err = {name: (fn().double() - exact).abs().max().item()
           for name, fn in (("K4", kernel), ("gather", gather))}
    # the gather route's square-form PV sums T terms of (p + v)^2
    vmax = vp.float().abs().max().item()
    bound = nb * BLOCK * 2.0 ** -23 * (1 + vmax) ** 2
    check(err["K4"] <= 1e-4 and err["gather"] <= bound,
          f"paged read S={S} T={nb * BLOCK} vs float64: K4 "
          f"{err['K4']:.2e} <= 1e-4, gather {err['gather']:.2e} <= "
          f"{bound:.2e}")
    return {"kernel_ms": tuning.time_graph([kernel], reps=10, replays=3),
            "gather_ms": tuning.time_graph([gather], reps=10, replays=3)}


# ------------------------------------------------------ attention options
# deepseek-7b (arXiv:2401.02954: d 4096, 32 heads of 128, MHA, no window,
# vocab 102400) at 2 of its 30 layers, bf16, weights drawn on the device:
# a dense causal decoder with no window, which block_skip needs.  At the
# default chunks (2048 q / 1024 kv) an 8192-token prefill has 4 q blocks
# over 8 kv chunks (block_skip visits 20 of the 32 pairs) and a 4096-token
# train step 2 over 4 (6 of 8).
ATTN_ARCH = "deepseek-7b"
ATTN_LAYERS = 2
ATTN_PREFILL = 8192
ATTN_TRAIN = 4096
ATTN_FLAG = "--attn-opts-phase"
ATTN_SCHEDULES = ("base", "block_skip", "fold_q", "p_bf16")


def attn_cfg(schedule: str = "base", mode: str = "square_pallas", **kw):
    return dataclasses.replace(
        get_config(ATTN_ARCH), n_layers=ATTN_LAYERS, matmul_mode=mode,
        attn_block_skip=schedule == "block_skip",
        attn_fold_q=schedule == "fold_q", attn_p_bf16=schedule == "p_bf16",
        **kw)


def attn_pairs(cfg, schedule: str, S: int) -> int:
    """The (q block, kv chunk) pairs a schedule visits at S tokens: nq x
    nk, or block_skip's triangular sum (causal, no window)."""
    cq, ck = min(cfg.attn_chunk_q, S), min(cfg.attn_chunk_kv, S)
    nq, nk = -(-S // cq), -(-S // ck)
    if schedule == "block_skip":
        return sum(min(nk, -(-(i + 1) * cq // ck)) for i in range(nq))
    return nq * nk


def attn_k2(cfg, schedule: str, S: int, train: bool = False) -> int:
    """K2 launches of a prefill (or, ``train``, a remat-block train step)
    of S tokens: the scores and the PV a pair (fold_q: a kv chunk, all q
    chunks batched) a layer; a step adds both gradients of each and the
    block's recompute, 4x the forward.  Every one of these contractions
    takes the batched route at these shapes (batch 32, m 2048)."""
    nk = -(-S // min(cfg.attn_chunk_kv, S))
    per_layer = 2 * (nk if schedule == "fold_q" else
                     attn_pairs(cfg, schedule, S))
    return cfg.n_layers * per_layer * (4 if train else 1)


def attn_mults(cfg, schedule: str, S: int) -> int:
    """The audit's multiplies at ``attn_scores`` (= ``attn_pv``) over the
    layers: each pair is B * KV * G * cq * ck * hd."""
    cq, ck = min(cfg.attn_chunk_q, S), min(cfg.attn_chunk_kv, S)
    return cfg.n_layers * attn_pairs(cfg, schedule, S) * cfg.n_heads * \
        cq * ck * cfg.resolved_head_dim


def attn_k2_shapes() -> list:
    """(nb, m, n, k) of K2's forward launches in the phase: the scores and
    the PV, base and folded (4 q chunks)."""
    cfg = attn_cfg()
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    cq, ck = cfg.attn_chunk_q, cfg.attn_chunk_kv
    nq = ATTN_PREFILL // cq
    return [(nb, cq, n, k) for nb in (H, nq * H)
            for n, k in ((ck, hd), (hd, ck))]


def attn_direct(dev, gen) -> dict:
    """The four schedules' ``chunked_attention`` on one layer's shapes at
    8192 tokens (bf16 q, k, v as a layer gives them; square_pallas, then
    ``standard`` in f32): fold_q = base bit for bit (K2 computes every
    element as K1 whatever its batch or tile), block_skip within the
    square form's f32 bound of base (a skipped pair's PV, 1/2 (sum (0 +
    v)^2 - sum v^2), is K2's rounding residue and not exactly 0), p_bf16
    within 2^-8 max|v| of base (p rounded to bf16), base within the f32
    bound of ``standard``."""
    cfg = attn_cfg()
    S, KV, hd = ATTN_PREFILL, cfg.n_kv_heads, cfg.resolved_head_dim
    G = cfg.n_heads // KV
    q = torch.randn(1, S, KV, G, hd, generator=gen).to(torch.bfloat16).to(dev)
    k = torch.randn(1, S, KV, hd, generator=gen).to(torch.bfloat16).to(dev)
    v = torch.randn(1, S, KV, hd, generator=gen).to(torch.bfloat16).to(dev)
    pos = torch.arange(S, device=dev)
    kw = dict(causal=True, window=None, chunk_q=cfg.attn_chunk_q,
              chunk_kv=cfg.attn_chunk_kv)
    outs, k2 = {}, {}
    for sched in ATTN_SCHEDULES:
        reset_counts()
        outs[sched] = attn_mod.chunked_attention(
            q, k, v, pos, pos, mode="square_pallas",
            **kw, **({sched: True} if sched != "base" else {})).float()
        torch.cuda.synchronize()
        k2[sched] = (sq_matmul_k2.launches, sq_matmul_k3.launches)
        check(k2[sched] == (attn_k2(dataclasses.replace(cfg, n_layers=1),
                                    sched, S), 0),
              f"chunked_attention {sched} at S={S}: K2/K3 launches "
              f"{k2[sched]} = the schedule's")
    std = attn_mod.chunked_attention(q.float(), k.float(), v.float(), pos,
                                     pos, mode="standard", **kw)
    vmax = v.float().abs().max().item()
    top = q.float().abs().max().item() * hd ** -0.5 \
        + k.float().abs().max().item()
    bound = 2.0 ** -23 * (S * (1 + vmax) ** 2 + 2 * hd * top * top * vmax)
    err = {s: (outs[s] - outs["base"]).abs().max().item()
           for s in ATTN_SCHEDULES}
    err["standard"] = (outs["base"] - std).abs().max().item()
    check(torch.equal(outs["fold_q"], outs["base"]),
          "fold_q = base bit for bit (square_pallas, K2)")
    check(err["block_skip"] <= bound,
          f"block_skip vs base max|diff| {err['block_skip']:.3e} <= the "
          f"f32 bound {bound:.3e} (bit for bit: "
          f"{torch.equal(outs['block_skip'], outs['base'])})")
    check(err["p_bf16"] <= 2.0 ** -8 * vmax,
          f"p_bf16 vs base max|diff| {err['p_bf16']:.3e} <= 2^-8 max|v| "
          f"{2.0 ** -8 * vmax:.3e}")
    check(err["standard"] <= bound, f"base vs standard (f32) max|diff| "
                                    f"{err['standard']:.3e} <= {bound:.3e}")
    return {"err": err, "bound": bound, "k2": k2,
            "block_skip_exact": torch.equal(outs["block_skip"],
                                            outs["base"])}


def _cfg_view(model: LM, cfg) -> LM:
    """``model`` (its weights shared, not copied) under another config of
    the same shapes: another attention schedule or mode."""
    view = copy.copy(model)
    view.cfg = cfg
    return view


def _timed(fn, what: str) -> tuple:
    """A warm call, a timed one (synchronized wall) and a traced one
    (device busy and K2/K3 kernels, :func:`trace_steps`)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = trace_steps(lambda: (fn(), torch.cuda.synchronize()), what,
                        wall, calls=1, host=False)
    return out, wall, stats


def attn_opts_phase(dev, gen) -> dict:
    """block_skip, fold_q and p_bf16 on deepseek-7b at its published width
    (2 layers, bf16, seed 0 on the device): the schedules' attention alone
    (:func:`attn_direct`); an 8192-token causal prompt through the prefill
    path under each schedule (launches by counter and by a profiled run
    equal to the schedule's, the audit's attention sites equal to its
    multiplies and every other site equal to base's, the last position's
    logits against ``standard``'s and fold_q's equal to base's bit for
    bit); one remat-block train step at 4096 tokens, base and block_skip
    (launches, audit, loss); each timed (wall and device)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod
    t_phase = time.perf_counter()
    direct = attn_direct(dev, gen)
    cfg = attn_cfg()
    model = device_model(cfg, dev, seed=0)
    tree = model.tree()
    toks = torch.randint(0, cfg.vocab, (1, ATTN_PREFILL + 1),
                         generator=gen).to(dev)
    prefill = {}
    for sched in ("standard",) + ATTN_SCHEDULES:
        c = attn_cfg("base", mode="standard") if sched == "standard" \
            else attn_cfg(sched)
        view = _cfg_view(model, c)

        def run(view=view):
            with torch.no_grad():
                hidden, _ = view.prefill(
                    tree, {"tokens": toks[:, :ATTN_PREFILL]},
                    cache_len=ATTN_PREFILL)
                return view.logits(tree, hidden[:, -1:]).float()

        reset_counts()
        with counting.track_contractions() as ctr:
            logits = run()
        torch.cuda.synchronize()
        n = (sq_matmul_k2.launches, sq_matmul_k3.launches)
        k1 = sq_matmul_k1.launches
        _, wall, stats = _timed(run, f"{ATTN_ARCH} prefill, {sched}")
        prefill[sched] = dict(logits=logits, wall_s=wall, k1=k1,
                              busy_ms=stats.get("busy_ms"),
                              k2=n, traced=(stats.get("K2"), stats.get("K3")),
                              audit=ctr.by_site(),
                              fraction=ctr.fraction_square)
        if sched == "standard":
            continue
        want = attn_k2(cfg, sched, ATTN_PREFILL)
        check(n == (want, 0) and prefill[sched]["traced"] == (want, 0),
              f"prefill {sched}: K2/K3 {n} by counter, "
              f"{prefill[sched]['traced']} traced = ({want}, 0)")
        mults = attn_mults(cfg, sched, ATTN_PREFILL)
        site = ctr.by_site()
        check(site["attn_scores"]["mults"] == site["attn_pv"]["mults"]
              == mults and ctr.fraction_square == 1.0,
              f"prefill {sched}: audit attn_scores = attn_pv = {mults} "
              f"(analytic), fraction square {ctr.fraction_square}")
        base = prefill["base"]["audit"]
        check(all(v == base[k] for k, v in site.items()
                  if not k.startswith("attn_")), f"prefill {sched}: "
              f"every other site's multiplies = base's")
    ref = prefill["standard"]["logits"]
    scale = ref.abs().max().item()
    for sched in ATTN_SCHEDULES:
        got = prefill[sched]["logits"]
        err = (got - ref).abs().max().item()
        prefill[sched]["err_vs_standard"] = err
        check(bool(torch.isfinite(got).all()) and err <= 2e-2 * scale
              and got.argmax().item() == ref.argmax().item(),
              f"prefill {sched}: last logits vs standard max|diff| "
              f"{err:.4e} <= 2e-2 * max|logits| ({2e-2 * scale:.4e}), the "
              f"same argmax")
    check(torch.equal(prefill["fold_q"]["logits"], prefill["base"]["logits"]),
          "prefill fold_q: logits = base's bit for bit")
    print(f"prefill of {ATTN_PREFILL} tokens ({CARD}): " + "; ".join(
        f"{s} {prefill[s]['wall_s'] * 1e3:.1f} ms wall, "
        f"{prefill[s]['busy_ms']:.1f} ms busy" for s in
        ("standard",) + ATTN_SCHEDULES), flush=True)
    # one train step at 4096 tokens, remat block
    batch = SyntheticLM(DataConfig(1, ATTN_TRAIN, cfg.vocab), cfg,
                        device=dev).next_batch()
    params = model.train_params()
    opt = adamw.adamw_init(params)
    train = {}
    for sched in ("base", "block_skip"):
        c = attn_cfg(sched)
        step = step_mod.make_train_step(_cfg_view(model, c),
                                        step_mod.TrainConfig())
        reset_counts()
        with counting.track_contractions() as ctr:
            _, _, met = step(params, opt, batch)
        torch.cuda.synchronize()
        n = (sq_matmul_k2.launches, sq_matmul_k3.launches)
        k1 = sq_matmul_k1.launches
        _, wall, stats = _timed(lambda: step(params, opt, batch),
                                f"{ATTN_ARCH} train step, {sched}")
        want = attn_k2(cfg, sched, ATTN_TRAIN, train=True)
        traced = (stats.get("K2"), stats.get("K3"))
        check(n == (want, 0) and traced == (want, 0),
              f"train step {sched}: K2/K3 {n} by counter, {traced} traced "
              f"= ({want}, 0)")
        site = ctr.by_site()
        mults = attn_mults(cfg, sched, ATTN_TRAIN)
        check(all(site[f"{s}{g}"]["mults"] == mults for s in
                  ("attn_scores", "attn_pv") for g in ("", ".bwd_x",
                                                        ".bwd_w"))
              and ctr.fraction_square == 1.0
              and ctr.fraction_square_bwd == 1.0,
              f"train step {sched}: audit attn_scores / attn_pv and their "
              f"gradients = {mults} each, fraction square 1.0 and 1.0")
        train[sched] = dict(loss=float(met["loss"]), wall_s=wall, k1=k1,
                            busy_ms=stats.get("busy_ms"), k2=n,
                            traced=traced, total=ctr.total_mults)
    rel = abs(train["block_skip"]["loss"] - train["base"]["loss"]) \
        / abs(train["base"]["loss"])
    check(math.isfinite(train["base"]["loss"]) and rel <= 2e-3,
          f"train step: block_skip loss {train['block_skip']['loss']:.6f} vs "
          f"base {train['base']['loss']:.6f} (rel {rel:.2e} <= 2e-3)")
    print(f"train step of {ATTN_TRAIN} tokens, remat block ({CARD}): "
          + "; ".join(f"{s} {train[s]['wall_s'] * 1e3:.1f} ms wall, "
                      f"{train[s]['busy_ms']:.1f} ms busy"
                      for s in train), flush=True)
    wall = time.perf_counter() - t_phase
    print(f"attention-options phase: {wall:.1f} s", flush=True)
    for v in prefill.values():
        v.pop("logits")
    return {"direct": direct, "prefill": prefill, "train": train,
            "seconds": wall}


# ----------------------------------------------------------- the roofline
# The op-level analyzer (roofline/op_analysis.py) prices, on ``meta``, the
# three steps whose walls the phases above measure: the replayed dense
# decode tick, the captured train step and deepseek-7b's base prefill.
# Nothing new runs on the card.  The per-step launches, the audit and the
# walls come in from the measured runs (a JSON file).
ROOFLINE_FLAG = "--roofline-phase"
ROOFLINE_KERNELS = ("K1", "K2", "K3", "K4")


def cfg_overrides(cfg) -> dict:
    """The fields of ``cfg`` that differ from its registry config: the dry
    run's ``overrides`` that rebuild it."""
    base = get_config(cfg.name)
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if getattr(cfg, f.name) != getattr(base, f.name)}


def dense_decode_mults(cfg, B: int, T: int) -> int:
    """The contraction audit's multiplies of one dense decode step of B
    rows over a T-position cache: the projections, the scores and the PV
    over the cache, the 3-GEMM FFN and the logits."""
    L, d, ff = cfg.n_layers, cfg.d_model, cfg.d_ff
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return B * (L * (d * (H + 2 * KV) * hd + H * hd * d + 2 * H * hd * T
                     + 3 * d * ff) + d * cfg.padded_vocab)


def roofline_steps() -> list:
    """(name, config, shape, prepared) of each measured step."""
    from repro_torch.configs.base import ShapeConfig
    return [("dense decode tick, replayed", serve_cfg(policy=None),
             ShapeConfig("decode_tick", DENSE_CACHE, DENSE_BATCH, "decode"),
             True),
            ("train step, captured", train_cfg(remat="block"),
             ShapeConfig("train_step", TRAIN_S, TRAIN_B, "train"), False),
            (f"{ATTN_ARCH} prefill, base", attn_cfg(),
             ShapeConfig("prefill", ATTN_PREFILL, 1, "prefill"), False)]


def roofline_measured(dense_graph, train, attn) -> dict:
    """What the measured runs give each step of :func:`roofline_steps`:
    its wall, its launches by the kernels' counters, its audit."""
    names = [s[0] for s in roofline_steps()]
    timing = train["timing"]
    base = attn["prefill"]["base"]
    return {
        names[0]: {"wall_s": dense_graph["step_s"],
                   "launches": dense_graph["per_step"],
                   "audit": dense_decode_mults(serve_cfg(), DENSE_BATCH,
                                               DENSE_CACHE)},
        names[1]: {"wall_s": timing["graph_median_ms"] / 1e3,
                   "launches": timing["step_counts"],
                   "audit": timing["audit"]},
        names[2]: {"wall_s": base["wall_s"],
                   "launches": {"K1": base["k1"], "K2": base["k2"][0],
                                "K3": base["k2"][1], "K4": 0},
                   "audit": sum(v["mults"] for v in base["audit"].values())}}


def roofline_phase(dev, gen, args) -> dict:
    """Each measured step dry-run on ``meta`` (``launch/dryrun.py``) under
    the op-level analyzer: its K1-K4 launches equal the counters' in the
    measured run; its square terms equal the dry run's contraction audit
    (a remat-block train step also recomputes the forward: 4/3 of it),
    the audit equals the measured run's, and its dot FLOPs are twice the
    terms; every measured wall is at or above its floor (a share over 1
    means a count is wrong).  Prints each roofline term and each wall's
    share of its slot floor and of the MFU peak."""
    from repro_torch.launch import dryrun
    from repro_torch.roofline import report
    t_phase = time.perf_counter()
    measured = json.loads(Path(args[0]).read_text())
    print(f"roofline: the measured steps dry-run on meta against the "
          f"{report.HW['name']}; card {CARD}", flush=True)
    out = {}
    for name, cfg, shape, prepared in roofline_steps():
        m = measured[name]
        cell = dryrun.dryrun_cell(cfg.name, shape, prepared=prepared,
                                  overrides=cfg_overrides(cfg),
                                  verbose=False)
        got = {k: cell["launches"].get(k, 0) for k in ROOFLINE_KERNELS}
        check(got == m["launches"], f"{name}: the analyzer's launches "
              f"{got} = the kernels' counters in the measured run "
              f"{m['launches']}")
        audit, terms = cell["audit_mults"], cell["square_terms"]
        recompute = shape.kind == "train" and cfg.remat == "block"
        want = audit * 4 // 3 if recompute else audit
        check(audit == m["audit"] and terms == want
              and cell["dot_flops_per_device"] == 2 * terms,
              f"{name}: square terms {terms:.6e} = the dry run's audit "
              f"{audit:,}{' x 4/3 (the recompute)' * recompute}, the audit "
              f"= the measured run's {m['audit']:,}, dot FLOPs = 2 x terms")
        row = report.roofline_row(cell)
        share = report.fraction_of_floor(row, m["wall_s"])
        print(f"  {name}: compute {row['compute_s'] * 1e3:.4f} ms, slots "
              f"{row['slot_s'] * 1e3:.4f}, elementwise "
              f"{row['elem_s'] * 1e3:.4f}, memory {row['memory_s'] * 1e3:.4f}"
              f" (eager's {row['memory_ub_s'] * 1e3:.4f}), collective "
              f"{row['collective_s'] * 1e3:.4f}; floor "
              f"{row['floor_s'] * 1e3:.4f} ms ({row['bottleneck']}); the "
              f"wall {m['wall_s'] * 1e3:.3f} ms: {share['slot_share']:.2%} "
              f"slot floor, {share['floor_share']:.2%} floor, MFU "
              f"{share['mfu']:.3%}, roofline MFU "
              f"{row['roofline_fraction_mfu']:.3%}; card {CARD}", flush=True)
        check(share["floor_share"] <= 1.0, f"{name}: the wall is at or above "
              f"its floor (share {share['floor_share']:.2%})")
        out[name] = {"row": row, "share": share, "launches": got,
                     "square_terms": terms, "audit": audit,
                     "trace_seconds": cell["trace_seconds"]}
    wall = time.perf_counter() - t_phase
    print(f"roofline phase: {wall:.1f} s", flush=True)
    return {"steps": out, "seconds": wall}


# ------------------------------------------------------- tensor parallel
# Two gloo ranks on the one card (NCCL takes one GPU a rank), each a
# process of its own: the TP reduce at the FFN's down-projection, a
# data-parallel train step against one rank's, and the gradients under
# the mesh against one process's.
TP_RANK_FLAG = "--tp-rank"
TP_WORLD = 2
TP_TIMEOUT_S = 600
TP_STEP_TOL = 2e-3          # tests/test_train_square.py's rtol and atol
TP_MOE_ARCH = "mixtral-8x7b"
# The worst leaf's relative gradient gap (L2) and the grad norm's, under
# the mesh against one process, in f32 on the standard route, which holds
# the collectives' hand-written transposes at f32's rounding (a square
# route's gradients with no loss scale are mostly its rounding, section 6
# of PERF.md, and a rank's cotangent is half the one process's): ``dp``
# data-parallel, ``tp`` with the attention-out and FFN-down partials
# reduced in bf16 over ``model`` (tp_bf16_reduce), ``moe`` the expert
# hidden axis over ``model``.  Read on one H100: 0, 9.7e-3 and 5.0e-7.  A
# gradient that misses the data all-reduce is off by ~0.7, a cotangent
# summed again over ``model`` by ~1 or more, an expert input's cotangent
# not summed by ~0.7 (planted faults, on the card and in tests/test_torch_
# distributed.py; PERF.md).
TP_GRAD_TOL = {"dp": 1e-4, "tp": 5e-2, "moe": 1e-4}


def mesh_grad_gap(model: LM, params, batch, mesh, data: int) -> dict:
    """``make_grad_fn``'s gradients under ``mesh`` against one process's:
    the mean over the ``data`` row shards of each shard's gradients (the
    whole batch's for ``data`` 1), summed in the leaves' dtype as the
    data-parallel all-reduce sums them.  The worst leaf's relative gap
    (L2) and the grad norms' gap."""
    from repro_torch.distributed import context as dctx
    from repro_torch.train import step as step_mod
    grad_fn = step_mod.make_grad_fn(model, step_mod.TrainConfig())
    with dctx.use_mesh(mesh):
        _, got = grad_fn(params, batch)
    parts = [grad_fn(params, {k: v.chunk(data)[h] for k, v in
                              batch.items()})[1] for h in range(data)]
    ref = tree_map(lambda *gs: sum(gs) / data, *parts)
    rel = _rel_tensors(_tree_leaves_named(got), _tree_leaves_named(ref))
    worst = max(rel, key=rel.get)

    def norm(tree):
        return math.sqrt(sum(t.double().square().sum().item()
                             for t in tree_leaves(tree)))
    n_got, n_ref = norm(got), norm(ref)
    return {"worst": worst, "gap": rel[worst],
            "norm_gap": abs(n_got - n_ref) / n_ref, "leaves": len(rel)}


def tp_rank(dev, gen, args) -> dict:
    """One rank of :func:`tp_phase`'s world (``chip_smoke.py --tp-rank FILE
    STORE RANK``): ``dense_tp_reduce`` of (TRAIN_T, d_ff) @ (d_ff, d) f32
    in square_pallas over a 2-way ``model`` mesh (K1 on this rank's
    K-shard), one unsharded K1 launch of the same product and the exact
    (float64) one; one bf16 train step of fairsquare-demo over a 2-way
    ``data`` mesh (this rank's 4 of the 8 rows) and the same step on the
    whole batch with no mesh; the gradients (:func:`mesh_grad_gap`, f32 on
    the standard route) of fairsquare-demo over the ``data`` mesh and
    with ``tp_bf16_reduce`` over a 2-way ``model`` mesh, and of
    mixtral-8x7b reduced with its expert hidden axis over ``model``;
    ``jit_train_step`` under the mesh."""
    import datetime
    import torch.distributed as dist
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.distributed import context as dctx
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod
    store, rank = args[0], int(args[1])
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=TP_WORLD,
                            timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    try:
        cfg = train_cfg()
        g = torch.Generator().manual_seed(0)        # the same on each rank
        x = torch.randn(TRAIN_T, cfg.d_ff, generator=g).to(dev)
        w = (torch.randn(cfg.d_ff, cfg.d_model, generator=g)
             / math.sqrt(cfg.d_ff)).to(dev)
        tp = make_mesh((TP_WORLD,), ("model",))
        reset_counts()
        with dctx.use_mesh(tp):
            got = basic.dense_tp_reduce({"w": w}, x, mode="square_pallas",
                                        reduce_dtype=torch.float32)
        torch.cuda.synchronize()
        tp_k1 = dict(sq_matmul_k1.shapes)
        reset_counts()
        ref = basic.dense_apply({"w": w}, x, mode="square_pallas")
        torch.cuda.synchronize()
        ref_k1 = dict(sq_matmul_k1.shapes)
        exact = x.double() @ w.double()
        scale = (x.abs().max() + w.abs().max()).item() ** 2
        res = {"tp_k1": {str(k): v for k, v in tp_k1.items()},
               "ref_k1": {str(k): v for k, v in ref_k1.items()},
               "tp_err": (got.double() - exact).abs().max().item(),
               "ref_err": (ref.double() - exact).abs().max().item(),
               "tp_vs_ref": (got - ref).abs().max().item(),
               "bound": cfg.d_ff * 2.0 ** -23 * scale}

        model = build_model(cfg, device=dev, seed=0)
        params = model.train_params()
        batch = SyntheticLM(DataConfig(TRAIN_B, TRAIN_S, cfg.vocab), cfg,
                            device=dev).next_batch()
        step = step_mod.make_train_step(model, step_mod.TrainConfig())
        dp = make_mesh((TP_WORLD,), ("data",))
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with dctx.use_mesh(dp):
            p2, _, m2 = step(params, adamw.adamw_init(params), batch)
        torch.cuda.synchronize()
        res["dp_s"] = time.perf_counter() - t0
        res["dp_launches"] = list(counts())
        p1, _, m1 = step(params, adamw.adamw_init(params), batch)
        worst = 0.0
        for a, b in zip(tree_leaves(p2), tree_leaves(p1)):
            a, b = a.float(), b.float()
            excess = ((a - b).abs() - TP_STEP_TOL * b.abs()).max().item()
            worst = max(worst, excess)
        res.update(loss=[float(m1["loss"]), float(m2["loss"])],
                   param_excess=worst, tokens=[float(m1["tokens"]),
                                               float(m2["tokens"])])
        del model, params, p1, p2
        t0 = time.perf_counter()
        f32 = train_cfg("standard", dtype="float32", tp_bf16_reduce=True)
        model = build_model(f32, device=dev, seed=0)
        params = model.train_params()
        grads = {"dp": mesh_grad_gap(model, params, batch, dp, TP_WORLD),
                 "tp": mesh_grad_gap(model, params, batch, tp, 1)}
        del model, params
        moe = dataclasses.replace(get_config(TP_MOE_ARCH).reduced(),
                                  matmul_mode="standard")
        model = build_model(moe, device=dev, seed=0)
        mb = SyntheticLM(DataConfig(TRAIN_B, 16, moe.vocab), moe,
                         device=dev).next_batch()
        grads["moe"] = mesh_grad_gap(model, model.train_params(), mb, tp, 1)
        res.update(grads=grads, grads_s=time.perf_counter() - t0)
        with dctx.use_mesh(dp):
            try:
                step_mod.jit_train_step(step, dev)
                res["refused"] = None
            except RuntimeError as e:
                res["refused"] = str(e)
        dist.barrier()
        return res
    finally:
        dist.destroy_process_group()


def tp_phase(dev) -> dict:
    """Two gloo ranks on the one card (NCCL refuses two ranks on one
    device), each a process of its own (:func:`tp_rank`), building or
    loading the kernels from the one build directory under its file lock:
    the TP reduce's K1 on each rank's K-shard (one launch a rank, at k =
    d_ff / 2) and the unsharded launch each within K1's f32 bound of the
    exact product; the 2-rank data-parallel train step's loss and params
    against the 1-rank step on the whole batch at rtol = atol = 2e-3; the
    gradients under each mesh against one process's at
    :data:`TP_GRAD_TOL`; the captured step under the mesh refused with its
    stated error."""
    t_phase = time.perf_counter()
    cfg = train_cfg()
    store = Path(__file__).resolve().parent / "build" / "tp_store"
    store.parent.mkdir(exist_ok=True)
    store.unlink(missing_ok=True)
    res = phase_join([phase_start(TP_RANK_FLAG, str(store), str(r),
                                  name=f"tp_rank{r}")
                      for r in range(TP_WORLD)],
                     f"tensor-parallel phase: {TP_WORLD} gloo ranks on the "
                     f"one card", timeout=TP_TIMEOUT_S)
    half = (TRAIN_T, cfg.d_ff // TP_WORLD, cfg.d_model)
    whole = (TRAIN_T, cfg.d_ff, cfg.d_model)
    for r, rr in enumerate(res):
        check(rr["tp_k1"] == {str(half): 1} and rr["ref_k1"] ==
              {str(whole): 1} and max(rr["tp_err"], rr["ref_err"],
                                      rr["tp_vs_ref"]) <= rr["bound"],
              f"rank {r}: dense_tp_reduce ran K1 once on its K-shard "
              f"{half} (its counter), the unsharded product K1 once at "
              f"{whole}; the reduced result within K1's f32 bound "
              f"{rr['bound']:.3e} of the unsharded launch "
              f"({rr['tp_vs_ref']:.3e}) and both of the exact product "
              f"({rr['tp_err']:.3e}, {rr['ref_err']:.3e})")
        l1, l2 = rr["loss"]
        check(abs(l2 - l1) <= TP_STEP_TOL + TP_STEP_TOL * abs(l1)
              and rr["param_excess"] <= TP_STEP_TOL
              and rr["tokens"][0] == rr["tokens"][1],
              f"rank {r}: the {TP_WORLD}-rank data-parallel step (bf16, "
              f"{TP_WORLD} x {TRAIN_B // TP_WORLD} x {TRAIN_S} tokens) = the "
              f"1-rank step on the whole batch: loss {l2:.6f} vs {l1:.6f}, "
              f"params within rtol = atol = {TP_STEP_TOL} (excess "
              f"{rr['param_excess']:.2e}), global tokens {rr['tokens'][1]:.0f}"
              f"; its launches (K1, K2, K3, K4) {rr['dp_launches']} in "
              f"{rr['dp_s']:.2f} s")
        print(f"  rank {r} gradient gaps: " + ", ".join(
            f"{w} {g['gap']:.3e} ({g['worst']}) norm {g['norm_gap']:.3e}"
            for w, g in rr["grads"].items()), flush=True)
        for what, gr in rr["grads"].items():
            tol = TP_GRAD_TOL[what]
            check(gr["gap"] <= tol and gr["norm_gap"] <= tol,
                  f"rank {r}: {what} gradients under the {TP_WORLD}-rank "
                  f"mesh = one process's: worst of {gr['leaves']} leaves "
                  f"{gr['worst']} {gr['gap']:.3e}, grad norm "
                  f"{gr['norm_gap']:.3e} (gate {tol:.0e}; "
                  f"{rr['grads_s']:.1f} s for the three)")
        check(bool(rr["refused"]) and "cannot be captured" in rr["refused"],
              f"rank {r}: jit_train_step under the {TP_WORLD}-rank mesh "
              f"refused: {rr['refused']}")
    wall = time.perf_counter() - t_phase
    print(f"tensor-parallel phase: {wall:.1f} s; card {CARD}", flush=True)
    return {"ranks": res, "seconds": wall}


def kernel_line(k1_rows, k2_rows, k3_rows, k4_row, k7_rows, k8_rows,
                cpm_rows, launches, train, moe, moe_train, rec, rec_train,
                enc, vlm, vlm_train, enc_train, attn=None, tune=None):
    """The kernels line.  ``launches``: {kernel: {path: count}} read after
    each path's run.  K1's and K4's times are per decode step of the paged
    engine, K2's per paged prefill chunk, K3's per dense decode step, K7's
    per pass over the six fused ResNet-50 layers, K8's per pass over the
    three FIR streams, and K5's and K6's per batched DFT; each sums its
    kernel's launches of that unit from the shape tables above.  K1 and K2
    also carry ``train``: their times per train step at the training
    shapes (forward and both gradients, no recompute), beside the library
    call's and the FP32 slot floor."""
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
    for kern, key in ((k1, "K1"), (k2, "K2")):
        mine = [r for r in train["rows"] if r["kernel"] == key]
        kern["train"] = {
            "per": f"one train step of {TRAIN_B} x {TRAIN_S} tokens, "
                   f"forward and both gradients, no recompute",
            "launches_per_step": sum(r["per_step"] for r in mine),
            **{key2: sum(r["per_step"] * r[key2] for r in mine)
               for key2 in ("ms", "library_ms", "floor_ms", "bound_ms")},
            "max_abs_err": max(r["max_abs_err"] for r in mine)}
        kern["max_abs_err"] = max(kern["max_abs_err"],
                                  kern["train"]["max_abs_err"])
    moe_entries(k1, k2, k4, moe)
    moe_train_entries(k1, k2, moe_train)
    for kern, key in ((k1, "K1"), (k2, "K2"), (k3, "K3")):
        for part, name in ((rec, "recurrent"), (rec_train, "recurrent_train"),
                           (enc, "encdec"), (vlm, "vlm"),
                           (vlm_train, "vlm_train"),
                           (enc_train, "encdec_train")):
            entry = part["entries"][key]
            kern[name] = entry[name]
            kern["max_abs_err"] = max(kern["max_abs_err"],
                                      entry["max_abs_err"])
    if attn:
        k2["attn_opts"] = {
            "per": f"{ATTN_ARCH} at {ATTN_LAYERS} layers: a prefill of "
                   f"{ATTN_PREFILL} tokens per schedule, a train step of "
                   f"{ATTN_TRAIN} (remat block)",
            "prefill": {s: {k: v for k, v in r.items() if k != "audit"}
                        for s, r in attn["prefill"].items()},
            "train": attn["train"]}
    if tune:
        for kern, names in ((k1, ("sq_matmul",)),
                            (k2, ("sq_matmul_batched",)),
                            (k3, ("sq_matmul_folded",)),
                            (k4, ("sq_paged_attn",)), (k5, ("cpm3_matmul",)),
                            (k6, ("cpm4_matmul",)), (k7, ("sq_conv2d",))):
            mine = {key: e for key, e in tune["entries"].items()
                    if key.split(":", 1)[0] in names}
            kern["plans"] = {"shapes": len(mine),
                             "variants": sum(e["variants"] for e in mine.values()),
                             "winner_not_rule": sum(
                                 e["rule"] != {f: e[f] for f in e["rule"]}
                                 for e in mine.values()),
                             "max_abs_err": max((e["max_abs_err"]
                                                 for e in mine.values()),
                                                default=0.0)}
    return json.dumps({"kernels": [k1, k2, k3, k4, k5, k6, k7, k8]})


def run(dev) -> str:
    """Every phase after the build; returns the kernels line."""
    t_run = time.perf_counter()

    def mark(what):
        print(f"({what} done at {time.perf_counter() - t_run:.1f} s of the "
              f"smoke's phases)", flush=True)

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
    mark("the kernel phases")
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
    mark("the serving, conv, FIR, DFT, fault and guard phases")
    train = train_phases(dev, gen, compared)
    mark("the dense training phases")
    moe = moe_phase(dev, gen)
    mark("MoE serving")
    moe_train = phase_isolated(MOE_TRAIN_FLAG, "the MoE training phase")
    mark("MoE training")
    rec = phase_isolated(RECURRENT_FLAG, "the recurrent phase")
    mark("recurrent serving")
    rec_train = phase_isolated(RECURRENT_TRAIN_FLAG,
                               "the recurrent training phase")
    mark("recurrent training")
    enc = phase_isolated(ENCDEC_FLAG, "the encoder-decoder phase")
    mark("encoder-decoder serving")
    vlm = phase_isolated(VLM_FLAG, "the prefix-token serving phase")
    mark("prefix-token serving")
    vlm_train = phase_isolated(VLM_TRAIN_FLAG,
                               "the prefix-token training phase")
    mark("prefix-token training")
    enc_train = phase_isolated(ENCDEC_TRAIN_FLAG,
                               "the encoder-decoder training phase")
    mark("encoder-decoder training")
    tune = phase_isolated(TUNING_FLAG, "the planner phase")
    mark("the planner")
    attn = phase_isolated(ATTN_FLAG, "the attention-options phase")
    mark("the attention options")
    measured = Path(__file__).resolve().parent / "build" / "roofline_in.json"
    measured.write_text(json.dumps(roofline_measured(dense_graph, train,
                                                     attn)))
    # the roofline runs nothing on the card: it runs beside the TP ranks
    roofline = phase_start(ROOFLINE_FLAG, str(measured))
    tp = tp_phase(dev)
    mark("the tensor-parallel phase")
    phase_join(roofline, "the roofline phase")
    mark("the roofline")
    launches = {"K1": {"engine_square_gemms": k1_total,
                       "launcher": launcher["K1"],
                       "engine_graph": graph["K1"],
                       "engine_no_policy": none["K1"],
                       "server_no_policy": dense["K1"],
                       "server_graph": dense_graph["K1"],
                       "conv_path": conv["K1"],
                       "train": train["launches"]["K1"],
                       "moe_engine": moe["launches"]["eager"]["K1"],
                       "moe_engine_graph": moe["launches"]["graph"]["K1"],
                       "moe_train": moe_train["trainer"]["K1"],
                       "attn_opts": sum(r["k1"] for part in (
                           attn["prefill"], attn["train"])
                           for r in part.values()),
                       "tp_ranks": sum(sum(r["tp_k1"].values())
                                       + r["dp_launches"][0]
                                       for r in tp["ranks"])},
                "K2": {"engine_no_policy": none["K2"],
                       "attn_opts": sum(r["k2"][0] for part in (
                           attn["prefill"], attn["train"])
                           for r in part.values()),
                       "server_no_policy": dense["K2"],
                       "server_graph": dense_graph["K2"],
                       "train": train["launches"]["K2"],
                       "moe_engine": moe["launches"]["eager"]["K2"],
                       "moe_engine_graph": moe["launches"]["graph"]["K2"],
                       "moe_train": moe_train["trainer"]["K2"],
                       "tp_ranks": sum(r["dp_launches"][1]
                                       for r in tp["ranks"])},
                "K3": {"server_no_policy": dense["K3"],
                       "server_graph": dense_graph["K3"],
                       "train": train["launches"]["K3"]},
                "K4": {"engine_square_gemms": k4_total,
                       "launcher": launcher["K4"],
                       "engine_graph": graph["K4"],
                       "engine_no_policy": none["K4"],
                       "moe_engine": moe["launches"]["eager"]["K4"],
                       "moe_engine_graph": moe["launches"]["graph"]["K4"]},
                "K7": {"conv_path": conv["K7"]},
                "K5": {"dft_path": dft["K5"]},
                "K6": {"dft_path": dft["K6"]},
                "K8": {"fir_path": fir["K8"]}}
    for part in (rec, rec_train, enc, vlm, vlm_train, enc_train):
        for kern, paths in part["launches"].items():
            launches[kern].update(paths)
    dense_k1 = sum(K1_PER_STEP[(r["k"], r["n"])] * r["ms"] for r in k1_rows
                   if r["m"] == DENSE_BATCH and "ms" in r)
    dense_k3 = sum(LAYERS * r["ms"] for r in k3_rows if r["shape"][1] == 1)
    print(f"dense decode step in graph replay: K1 85 launches at "
          f"m={DENSE_BATCH} {dense_k1:.3f} ms, K3 24 launches "
          f"{dense_k3:.3f} ms", flush=True)
    return kernel_line(k1_rows, k2_rows, k3_rows, k4_row, k7_rows, k8_rows,
                       cpm_rows, launches, train, moe, moe_train, rec,
                       rec_train, enc, vlm, vlm_train, enc_train, attn, tune)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    child = {MOE_TRAIN_FLAG: moe_train_phase, RECURRENT_FLAG: recurrent_phase,
             RECURRENT_TRAIN_FLAG: recurrent_train_phase,
             ENCDEC_FLAG: encdec_phase, VLM_FLAG: vlm_phase,
             VLM_TRAIN_FLAG: vlm_train_phase,
             ENCDEC_TRAIN_FLAG: encdec_train_phase,
             TUNING_FLAG: tuning_phase, ATTN_FLAG: attn_opts_phase,
             ROOFLINE_FLAG: roofline_phase, TP_RANK_FLAG: tp_rank}.get(
                 sys.argv[1] if len(sys.argv) > 1 else None)
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

    mode = sys.argv[1] if len(sys.argv) > 2 else None
    if mode in (AUTOTUNE_FLAG, CROSSOVER_FLAG):
        # by hand: python3 chip_smoke.py --autotune FILE (a tuning cache)
        # or --crossovers FILE (the route sweeps, JSON)
        (autotune_main if mode == AUTOTUNE_FLAG else crossovers_main)(
            dev, sys.argv[2])
        return 0
    if child:                          # a phase_isolated's process
        # by hand: python3 chip_smoke.py --recurrent-train-phase FILE [arch]
        out = child(dev, torch.Generator().manual_seed(0),
                    *([tuple(sys.argv[3:])] if sys.argv[3:] else []))
        Path(sys.argv[2]).write_text(json.dumps(out))
        return 0
    line = run(dev)
    print(f"smoke total {time.perf_counter() - t0:.1f} s, the kernels' "
          f"build included", flush=True)
    print(line, flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
