"""Paged continuous-batching serving engine: the PyTorch port of
``repro/serve/engine.py``.

- **Paged KV cache**: one pool per layer, fixed-size blocks from a
  :class:`~repro_torch.serve.paged.BlockAllocator`, per-slot block tables;
  blocks are reserved on admission, grown during decode, and freed (their
  ``pos_pool`` entries reset) the moment a request ends.  Sliding-window
  archs also free blocks as their positions age out of the window
  (``EngineConfig.window_eviction``), capping a sequence's footprint at
  ``ceil(window / block_size) + 1`` blocks.
- **FIFO admission** and **one chunked-prefill chunk per tick**, so a long
  prompt never stalls the decodes in flight.
- **Ragged batched decode**: every live slot advances one token per tick
  at its own absolute position, in one (max_slots, 1) call.
- **Youngest-first preemption**: when the pool runs dry the youngest
  request is released and requeued at the head (greedy regeneration is
  deterministic, so outputs are unchanged); past ``max_preemptions`` it
  FAILS instead, so two long requests cannot livelock.
- **Prepared decode** (``prepared=True``): ``LM.prepare_params`` once at
  start, every serving GEMM then reuses the prepared weights.

Resilience: every submitted request ends in exactly one terminal status
(:class:`RequestStatus`) -- ``COMPLETED``; ``REJECTED`` at submit (invalid,
or shed by the bounded queue's policy, ``reject-new`` or
``evict-oldest``); ``TIMED_OUT`` past its deadline (``deadline_s`` /
``Request.deadline_s``) or the run's wall budget (``max_wall_s``);
``FAILED`` for a fault absorbed on its behalf (preemption budget,
``max_step_retries`` consecutive failed model calls, non-finite logits
under ``guard``, the no-progress watchdog); ``CANCELLED`` by
:meth:`Engine.cancel`.  Every terminal path frees the request's blocks.
A fault injector (:mod:`repro_torch.serve.faults`) drives these paths in
tests and on the card.

A failed model call is retried on the next tick: the calls write the
cache only at the positions of their inputs, so a retry rewrites the same
values and is token-exact.  (The JAX engine's calls return new pools; the
port writes its K/V pools and ``pos_pool`` in place, at the same
positions on every try, so the pools after a retried call are bit-equal
to a clean call's.)  Kernel faults are never absorbed: a
:class:`~repro_torch.kernels.build.KernelError` (a kernel that did not
build, load or launch, a launch its wrapper refused included) and the
CUDA errors torch raises (``torch.AcceleratorError``,
``torch.cuda.CudaError``) propagate out of :meth:`Engine.step` and
:meth:`Engine.run`, so a broken kernel cannot end as clean ``FAILED``
terminals.

Compiled step (``EngineConfig.jit``, the JAX engine's ``jit``): on a
CUDA device the three model calls -- ``_chunk`` (one prefill chunk,
``(1, prefill_chunk)`` tokens), ``_decode`` (one ragged decode step,
``(max_slots, 1)``, with its logits) and ``_logits_at`` (one row's
logits, its index a static device scalar) -- are each captured once into
a CUDA graph (:class:`~repro_torch.core.graphs.CapturedCall`, one memory
pool for the three) at first use and replayed from then on: a decode
tick is one replay and one read of the sampled tokens.  Inputs are
written into the graphs' static buffers; fault hooks, ``poison_logits``,
sampling and the per-slot logits guard stay on the host, outside the
replay.  ``jit=None`` (the default) captures on CUDA and runs eagerly on
the CPU, which has no graphs; ``jit=True`` on the CPU is refused;
``jit=False`` runs eagerly anywhere (the benchmark regime, and the
in-line guard's).  A capture that fails raises; nothing falls back to
eager.  The route a call takes is fixed at capture, as a jit trace fixes
it: only a route-health demotion re-captures (below).

With ``guard=True`` each tick runs under :func:`repro_torch.core.guards.
guarded`, and a slot whose logits go non-finite FAILS alone.  Eagerly the
einsum dispatcher checks square-routed outputs in line and recomputes a
trip on the standard route; each recompute counts in
``engine_guard_recomputes_total``.  Compiled, the graphs carry finite
probes instead, and :meth:`Engine._guarded_call` runs the JAX engine's
compiled guard: replay, drain the probe flags into ``RouteHealth`` (one
read), and on a trip count it, re-capture if the route epoch moved (a
demotion; the span ``engine.rejit``, counted in ``guard_rejits`` and
``engine_guard_rejits_total``) and retry on the same inputs, at most
``max_step_retries + 1`` times.  The retry rewrites the same pool
positions, so it is token-exact.  The logits guard's read joins the
sampled tokens' read, so a guarded compiled tick costs one more read (the
probe flags') than an unguarded one.

Observability: a per-engine :class:`~repro_torch.obs.metrics.
MetricsRegistry` (or the caller's) holds the request, work and guard
counters, the queue/block/slot gauges and the TTFT and decode-step
histograms; the tracer (:mod:`repro_torch.obs.trace`) gets the spans
``engine.tick``, ``engine.admit``, ``engine.prefill_chunk`` and
``engine.decode_step`` and the request lifecycle events.
:meth:`Engine.obs_snapshot` is what ``launch/serve.py --metrics-file``
writes.

Sampling is greedy at ``temperature=0`` (token-identical to the JAX
engine).  At ``temperature>0`` it draws from a ``torch.Generator`` seeded
with ``seed``, whose stream differs from the JAX engine's PRNG.
"""
from __future__ import annotations

import contextlib
import dataclasses
import enum
import functools
import itertools
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core import graphs, guards
from repro_torch.device import resolve_device
from repro_torch.kernels import routing
from repro_torch.kernels.build import KernelError
from repro_torch.models import blocks as blk
from repro_torch.models.attention import EMPTY_POS
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import paged as paged_mod
from repro_torch.serve.faults import FaultInjector, FaultyAllocator
from repro_torch.serve.server import Request

__all__ = ["EngineConfig", "EngineMetrics", "Engine", "RequestStatus",
           "RequestResult", "SHED_POLICIES", "eviction_window"]

SHED_POLICIES = ("reject-new", "evict-oldest")


def eviction_window(cfg) -> Optional[int]:
    """The model's uniform block-eviction horizon, or None.

    Freed blocks are invisible to every layer only when every
    attention-bearing layer masks by a sliding window; the horizon is the
    largest such window.  A full-attention layer (window None) disables
    eviction: its queries may reach arbitrarily old positions.
    """
    windows = []
    for kind in cfg.layer_kinds:
        if kind not in blk.PAGEABLE_KINDS:
            continue
        if cfg.window is None:
            return None
        windows.append(int(cfg.window))
    return max(windows) if windows else None


# A kernel that did not build, load or launch, or a CUDA error that torch
# raises from any launch: faults the engine must not absorb into request
# statuses.
_KERNEL_FAULTS = (KernelError, torch.cuda.CudaError) + (
    (torch.AcceleratorError,) if hasattr(torch, "AcceleratorError") else ())


class RequestStatus(str, enum.Enum):
    """Terminal request statuses (the JAX engine's names)."""
    COMPLETED = "completed"
    REJECTED = "rejected"
    TIMED_OUT = "timed_out"
    FAILED = "failed"
    CANCELLED = "cancelled"

    def __str__(self):
        return self.value


@dataclasses.dataclass
class RequestResult:
    """One request's terminal outcome.  ``tokens`` holds what was generated
    before the terminal event (all of it for ``COMPLETED``, partial for
    ``TIMED_OUT``/``FAILED``/``CANCELLED``, none for ``REJECTED``)."""
    rid: int
    status: RequestStatus
    tokens: List[int]
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.status is RequestStatus.COMPLETED


@dataclasses.dataclass
class EngineConfig:
    max_slots: int = 8            # concurrent decode batch width
    block_size: int = 16          # tokens per cache block
    num_blocks: int = 64          # pool size (block 0 reserved null)
    blocks_per_seq: int = 8       # per-sequence context ceiling, in blocks
    prefill_chunk: int = 32       # prompt tokens processed per engine step
    max_new_tokens: int = 32
    eos_id: int = -1              # -1: never terminates early
    temperature: float = 0.0      # 0 = greedy
    prepared: bool = False        # LM.prepare_params at engine start
    jit: Optional[bool] = None    # capture the model calls into CUDA graphs:
                                  # None = on CUDA (eager on the CPU), True
                                  # = always (a CPU engine refuses it),
                                  # False = eager (the in-line guard's and
                                  # the benchmark regime)
    # ---- resilience (see the module docstring) ----
    deadline_s: Optional[float] = None   # per-request budget from submit
                                         # (Request.deadline_s wins)
    max_wall_s: Optional[float] = None   # whole-run() budget
    queue_limit: Optional[int] = None    # bounded admission queue depth
    shed_policy: str = "reject-new"      # full-queue policy (SHED_POLICIES)
    max_preemptions: int = 8      # per request; exceeded -> FAILED
    max_step_retries: int = 8     # consecutive failed model calls tolerated
    watchdog_steps: int = 200     # no-progress ticks before surfacing
    guard: bool = False           # fail non-finite-logits slots; scope the
                                  # einsum route guard over every tick
    window_eviction: bool = True  # SWA archs: free blocks older than
                                  # pos - window (no-op without a window)

    def __post_init__(self):
        if self.shed_policy not in SHED_POLICIES:
            raise ValueError(f"unknown shed_policy {self.shed_policy!r}; "
                             f"expected one of {SHED_POLICIES}")

    @property
    def max_len(self) -> int:
        return self.blocks_per_seq * self.block_size


@dataclasses.dataclass
class EngineMetrics:
    """Serving counters: throughput, time to first token, block use, and
    the backpressure and failure counts."""
    tokens_out: int = 0
    prefill_tokens: int = 0
    decode_steps: int = 0
    decode_slot_steps: int = 0    # sum of live slots over decode steps
    prefill_chunks: int = 0
    first_tokens: int = 0         # prefill-final logits computed
    preemptions: int = 0
    peak_blocks_used: int = 0
    # ---- backpressure / failure accounting ----
    completed: int = 0
    rejected: int = 0             # refused at submit (invalid or shed)
    shed: int = 0                 # of rejected: shed by the queue policy
    timeouts: int = 0             # deadline / wall-budget expiries
    failures: int = 0             # FAILED terminals
    cancelled: int = 0
    step_failures: int = 0        # model calls that raised (retried)
    watchdog_trips: int = 0
    guard_trips: int = 0          # non-finite logits rows
    guard_recomputes: int = 0     # contractions recomputed by the guard
    guard_rejits: int = 0         # re-captures forced by route demotions
    peak_queue_depth: int = 0
    util_sum: float = 0.0
    util_steps: int = 0
    ttft_s: Dict[int, float] = dataclasses.field(default_factory=dict)
    wall_s: float = 0.0
    # fixed-bucket latency histograms (O(1) state): TTFT observed at a
    # request's terminal event (the TTFT its caller saw), and the wall of
    # each ragged decode step (the per-token latency of its live slots)
    ttft_hist: obs_metrics.Histogram = dataclasses.field(
        default_factory=lambda: obs_metrics.Histogram("engine_ttft_seconds"))
    decode_step_hist: obs_metrics.Histogram = dataclasses.field(
        default_factory=lambda: obs_metrics.Histogram(
            "engine_decode_step_seconds"))

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_out / self.wall_s if self.wall_s else 0.0

    @property
    def mean_ttft_s(self) -> float:
        """Mean time to first token over the requests that got one."""
        return (sum(self.ttft_s.values()) / len(self.ttft_s)
                if self.ttft_s else 0.0)

    @property
    def mean_utilization(self) -> float:
        return self.util_sum / self.util_steps if self.util_steps else 0.0

    @property
    def batch_occupancy(self) -> float:
        """Mean live slots per decode step."""
        return (self.decode_slot_steps / self.decode_steps
                if self.decode_steps else 0.0)

    def summary(self) -> Dict[str, float]:
        return {
            "tokens_out": self.tokens_out,
            "tokens_per_s": self.tokens_per_s,
            "mean_ttft_s": self.mean_ttft_s,
            "mean_block_utilization": self.mean_utilization,
            "peak_blocks_used": self.peak_blocks_used,
            "batch_occupancy": self.batch_occupancy,
            "decode_steps": self.decode_steps,
            "prefill_chunks": self.prefill_chunks,
            "preemptions": self.preemptions,
            "completed": self.completed,
            "rejected": self.rejected,
            "shed": self.shed,
            "timeouts": self.timeouts,
            "failures": self.failures,
            "cancelled": self.cancelled,
            "step_failures": self.step_failures,
            "watchdog_trips": self.watchdog_trips,
            "guard_trips": self.guard_trips,
            "guard_recomputes": self.guard_recomputes,
            "guard_rejits": self.guard_rejits,
            "peak_queue_depth": self.peak_queue_depth,
            "ttft_p50_s": self.ttft_hist.quantile(0.50),
            "ttft_p95_s": self.ttft_hist.quantile(0.95),
            "ttft_p99_s": self.ttft_hist.quantile(0.99),
            "decode_step_p50_s": self.decode_step_hist.quantile(0.50),
            "decode_step_p95_s": self.decode_step_hist.quantile(0.95),
            "decode_step_p99_s": self.decode_step_hist.quantile(0.99),
        }


@dataclasses.dataclass
class _Slot:
    req: Request
    n_prefilled: int = 0
    pos: int = 0                  # next cache position to write (decode)
    last_tok: int = 0
    remaining: int = 0
    state: str = "prefill"        # "prefill" | "decode"


class Engine:
    """Serve requests through ``model`` (an :class:`~repro_torch.models.lm.LM`)
    on ``device`` (default: CUDA, which must be present; the model must
    already lie there).  ``faults``: a
    :class:`~repro_torch.serve.faults.FaultInjector`; ``registry``: the
    :class:`~repro_torch.obs.metrics.MetricsRegistry` to publish into (a
    fresh one per engine by default).  ``params``: the params tree to serve,
    as the JAX engine takes it (default: the model's own, prepared at start
    under ``cfg.prepared``); engines of one model can share one prepared
    tree this way, where a tree each would not fit the card."""

    def __init__(self, model, cfg: EngineConfig, *, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None,
                 faults: Optional[FaultInjector] = None,
                 registry: Optional[obs_metrics.MetricsRegistry] = None,
                 params=None):
        dev = resolve_device(device)
        if model.device.type != dev.type or (
                dev.index is not None and model.device != dev):
            raise ValueError(f"the model lies on {model.device}, the engine "
                             f"was asked to run on {dev}")
        if cfg.jit and model.device.type != "cuda":
            raise ValueError(f"EngineConfig(jit=True) captures CUDA graphs; "
                             f"the engine runs on {model.device} (pass "
                             f"jit=None or False)")
        self.model = model
        self.cfg = cfg
        self.device = model.device
        self._faults = faults
        if params is None:
            with torch.no_grad():
                params = (model.prepare_params() if cfg.prepared
                          else model.tree())
        self.params = params
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.allocator = paged_mod.BlockAllocator(cfg.num_blocks,
                                                  cfg.block_size)
        if faults is not None:
            # delegates its state to the real allocator, so leak accounting
            # reads the true pool
            self.allocator = FaultyAllocator(self.allocator, faults)
        self.tables = paged_mod.BlockTables(self.allocator, cfg.max_slots,
                                            cfg.blocks_per_seq)
        self.cache = model.init_paged_cache(cfg.num_blocks * cfg.block_size)
        self.pos_pool = torch.as_tensor(
            paged_mod.empty_pos_pool(cfg.num_blocks, cfg.block_size),
            device=self.device)
        self._evict_window = (eviction_window(model.cfg)
                              if cfg.window_eviction else None)
        # the model calls: raw functions of device tensors, kept so the
        # compiled guard can re-capture after a demotion
        self._jit = (model.device.type == "cuda" if cfg.jit is None
                     else bool(cfg.jit))
        self._model_fns = self._make_model_fns()
        self._graph_set = graphs.GraphSet(self._model_fns, self.device)
        self._jit_model_fns()
        self._route_epoch = routing.route_epoch()
        self.slots: List[Optional[_Slot]] = [None] * cfg.max_slots
        self.queue: List[Request] = []
        self.results: Dict[int, RequestResult] = {}
        self.metrics = EngineMetrics()

        # The registry's terminal counters PARTITION the submissions:
        # ``rejected`` there excludes shed, which has its own counter
        # (unlike EngineMetrics.shed, a subset of EngineMetrics.rejected).
        self.registry = (registry if registry is not None
                         else obs_metrics.MetricsRegistry())
        reg = self.registry
        self._c_requests = {
            k: reg.counter(f"engine_requests_{k}_total")
            for k in ("submitted", "completed", "rejected", "shed",
                      "timeouts", "failures", "cancelled")}
        self._c_work = {
            "tokens": reg.counter("engine_tokens_generated_total",
                                  help="tokens sampled (executed work: "
                                       "counts regeneration after "
                                       "preemption, unlike tokens_out)"),
            "prefill_chunks": reg.counter("engine_prefill_chunks_total"),
            "decode_steps": reg.counter("engine_decode_steps_total"),
            "preemptions": reg.counter("engine_preemptions_total"),
            "step_failures": reg.counter("engine_step_failures_total"),
            "watchdog_trips": reg.counter("engine_watchdog_trips_total"),
            "guard_trips": reg.counter("engine_guard_trips_total"),
            "guard_recomputes": reg.counter(
                "engine_guard_recomputes_total",
                help="contractions the numerics guard recomputed on the "
                     "standard route after a non-finite square output"),
            "guard_rejits": reg.counter(
                "engine_guard_rejits_total",
                help="model-call re-captures forced by route demotions "
                     "(compiled guard)"),
        }
        self._g_queue = reg.gauge("engine_queue_depth")
        self._g_blocks = reg.gauge("engine_blocks_used")
        self._g_util = reg.gauge("engine_block_utilization")
        self._g_live = reg.gauge("engine_live_slots")
        # one observe feeds both views
        self.metrics.ttft_hist = reg.histogram("engine_ttft_seconds")
        self.metrics.decode_step_hist = reg.histogram(
            "engine_decode_step_seconds")

        self._newly_finished: List[RequestResult] = []
        self._arrival: Dict[int, float] = {}      # rid -> engine time
        self._deadline: Dict[int, float] = {}     # rid -> engine time
        self._order: Dict[int, int] = {}          # rid -> submit order
        self._seq = itertools.count()
        self._preempts: Dict[int, int] = {}
        self._tick = 0
        self._skew = 0.0                          # injected clock skew
        self._idle_ticks = 0                      # watchdog state
        self._fail_streak = {"prefill": 0, "decode": 0}

    # ------------------------------------------------------- model calls
    def _make_model_fns(self) -> Dict[str, object]:
        """The three model calls as functions of device tensors (the JAX
        engine's ``_model_fns``); each writes the pools in place."""
        model, params, cache = self.model, self.params, self.cache
        pos_pool, bs = self.pos_pool, self.cfg.block_size

        def _chunk(tokens, positions, tables):
            return model.decode_paged(params, cache, tokens, positions,
                                      tables, pos_pool, block_size=bs)

        def _decode(tokens, positions, tables):
            hidden = model.decode_paged(params, cache, tokens, positions,
                                        tables, pos_pool, block_size=bs)
            return model.logits(params, hidden)[:, -1]     # (B, V)

        def _logits_at(hidden, idx):
            # idx: a static device scalar, so one graph serves every row
            return model.logits(params,
                                hidden.index_select(1, idx.reshape(1)))[:, 0]

        return {"_chunk": _chunk, "_decode": _decode,
                "_logits_at": _logits_at}

    def _eager(self, name: str):
        """``name`` run eagerly on host arrays (``_logits_at``: a device
        hidden and a Python index).  Bound to locals, not ``self``, so the
        engine stays free of reference cycles."""
        model, params, dev = self.model, self.params, self.device
        if name == "_logits_at":
            return lambda hidden, idx: model.logits(
                params, hidden[:, idx:idx + 1])[:, 0]
        fn = self._model_fns[name]
        return lambda *arrays: fn(*(torch.as_tensor(a, device=dev)
                                    for a in arrays))

    @property
    def captures(self) -> int:
        """Model calls captured into graphs so far (re-captures counted)."""
        return self._graph_set.captures

    def _jit_model_fns(self) -> None:
        """(Re-)bind ``_chunk``, ``_decode`` and ``_logits_at``: eager, or
        each captured into a graph at its first call.  A re-capture frees
        the old graphs and their pool first."""
        self._graph_set.release()
        for name in self._model_fns:
            setattr(self, name,
                    functools.partial(self._graph_set, name) if self._jit
                    else self._eager(name))

    def _guarded_call(self, name: str, *args):
        """One model call under the compiled numerics guard (the JAX
        engine's ``_guarded_call``).

        With ``guard=True`` and a compiled engine the graphs carry finite
        probes: after each replay the pending trips are drained into
        ``RouteHealth`` (one read of the probe flags); on a trip the
        result is suspect and DISCARDED, the model calls are re-captured
        if a demotion moved the route epoch (a fresh capture takes the
        demoted -- standard -- route), and the call retries on identical
        inputs, at most ``max_step_retries + 1`` times.  The calls write
        the pools in place at the positions of their inputs, so a retry
        rewrites the same values and is token-exact.  Eager engines keep
        the in-line guard and skip the drain."""
        if not (self.cfg.guard and self._jit):
            return getattr(self, name)(*args)
        for _ in range(self.cfg.max_step_retries + 1):
            out = getattr(self, name)(*args)
            trips = guards.drain_pending_trips()
            if not trips:
                return out
            n_trips = sum(trips.values())
            self.metrics.guard_trips += n_trips
            self._c_work["guard_trips"].inc(n_trips)
            if routing.route_epoch() != self._route_epoch:
                self._route_epoch = routing.route_epoch()
                with obs_trace.span("engine.rejit", cat="engine", fn=name):
                    self._jit_model_fns()
                self.metrics.guard_rejits += 1
                self._c_work["guard_rejits"].inc()
        # retries spent on a key the breaker did not demote; the per-slot
        # logits guard downstream isolates the damage
        return out

    # ------------------------------------------------------------ helpers
    def _now(self) -> float:
        """The engine clock: wall time plus any injected skew (deadlines
        run on it, so tests expire them without sleeping)."""
        return time.perf_counter() + self._skew

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        if self.cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).cpu().numpy()
        probs = torch.softmax(logits.float() / self.cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0] \
            .cpu().numpy()

    def _sample_read(self, logits: torch.Tensor):
        """The compiled engine's read of one step: the sampled tokens and,
        under ``guard``, each row's finiteness, in one device-to-host copy.
        Returns ``(tokens, finite rows or None)``."""
        finite = (torch.isfinite(logits.amax(dim=-1)) if self.cfg.guard
                  else None)
        if self.cfg.temperature <= 0.0:
            nxt = torch.argmax(logits, dim=-1)
        else:
            x = logits.float()
            if finite is not None:       # a poisoned row samples no nan
                x = torch.where(finite[:, None], x, 0.0)
            nxt = torch.multinomial(torch.softmax(x / self.cfg.temperature,
                                                  dim=-1), 1,
                                    generator=self.generator)[:, 0]
        if finite is None:
            return nxt.cpu().numpy(), None
        both = torch.stack([nxt, finite.long()]).cpu().numpy()
        return both[0], both[1].astype(bool)

    def _reset_pos(self, blocks: List[int]) -> None:
        if blocks:
            idx = torch.as_tensor(self.tables.reset_slots_index(blocks),
                                  device=self.device).long()
            self.pos_pool[idx] = EMPTY_POS

    def _release(self, slot_id: int) -> None:
        self._reset_pos(self.tables.release(slot_id))
        self.slots[slot_id] = None

    # ------------------------------------------------- terminal accounting
    def _count_terminal(self, status: RequestStatus) -> None:
        key = {RequestStatus.COMPLETED: "completed",
               RequestStatus.TIMED_OUT: "timeouts",
               RequestStatus.FAILED: "failures",
               RequestStatus.CANCELLED: "cancelled"}.get(status)
        if key is not None:           # REJECTED is counted by _reject
            setattr(self.metrics, key, getattr(self.metrics, key) + 1)
            self._c_requests[key].inc()

    def _result(self, req: Request, status: RequestStatus,
                error: Optional[str] = None) -> RequestResult:
        """Record a request's terminal status; every per-rid map is popped
        here, whatever the terminal path."""
        res = RequestResult(req.rid, status, list(req.out or []), error)
        self.results[req.rid] = res
        self._newly_finished.append(res)
        for d in (self._arrival, self._deadline, self._order,
                  self._preempts):
            d.pop(req.rid, None)
        self._count_terminal(status)
        ttft = self.metrics.ttft_s.get(req.rid)
        if ttft is not None:
            self.metrics.ttft_hist.observe(ttft)
        obs_trace.event("request.terminal", cat="engine", rid=req.rid,
                        status=str(status))
        return res

    def _terminate(self, slot_id: int, status: RequestStatus,
                   error: Optional[str] = None) -> None:
        """End a slotted request (partial tokens kept) and free its
        blocks."""
        self._result(self.slots[slot_id].req, status, error)
        self._release(slot_id)

    def _reject(self, req: Request, msg: str, shed: bool = False) -> None:
        self.metrics.rejected += 1
        if shed:
            self.metrics.shed += 1
        self._c_requests["shed" if shed else "rejected"].inc()
        self._result(req, RequestStatus.REJECTED, msg)

    # ----------------------------------------------------------- admission
    def submit(self, requests: List[Request]) -> None:
        """Enqueue requests.  An invalid or shed request ends REJECTED; a
        duplicate rid raises (it would overwrite another request's
        result)."""
        cfg = self.cfg
        for req in requests:
            if req.rid in self.results or req.rid in self._arrival:
                raise ValueError(f"duplicate request id {req.rid}: a rid "
                                 f"already queued, in flight or finished")
            self._c_requests["submitted"].inc()
            obs_trace.event("request.submit", cat="engine", rid=req.rid,
                            prompt_tokens=len(req.tokens))
            total = len(req.tokens) + cfg.max_new_tokens
            if len(req.tokens) == 0:
                self._reject(req, "empty prompt")
                continue
            if total > cfg.max_len:
                self._reject(req, f"prompt {len(req.tokens)} + max_new "
                                  f"{cfg.max_new_tokens} exceeds the "
                                  f"per-sequence ceiling {cfg.max_len}")
                continue
            if self.allocator.blocks_for(total) > cfg.num_blocks - 1:
                self._reject(req, f"needs {self.allocator.blocks_for(total)}"
                                  f" blocks, the pool has "
                                  f"{cfg.num_blocks - 1}")
                continue
            if cfg.queue_limit is not None \
                    and len(self.queue) >= cfg.queue_limit:
                # evict-oldest sheds the oldest QUEUED request (in-flight
                # work is never thrown away by admission pressure); with
                # none queued (queue_limit=0) the newcomer is shed
                if cfg.shed_policy == "reject-new" or not self.queue:
                    self._reject(req, f"admission queue full (queue_limit="
                                      f"{cfg.queue_limit}, shed_policy="
                                      f"{cfg.shed_policy})", shed=True)
                    continue
                victim = self.queue.pop(0)
                self._reject(victim, f"shed from the admission queue by a "
                                     f"newer request (queue_limit="
                                     f"{cfg.queue_limit}, shed_policy="
                                     f"evict-oldest)", shed=True)
            now = self._now()
            self._arrival[req.rid] = now
            self._order[req.rid] = next(self._seq)
            budget = (req.deadline_s if req.deadline_s is not None
                      else cfg.deadline_s)
            if budget is not None:
                self._deadline[req.rid] = now + float(budget)
            self.queue.append(req)
            self.metrics.peak_queue_depth = max(self.metrics.peak_queue_depth,
                                                len(self.queue))

    def cancel(self, rid: int) -> bool:
        """Cancel a queued or in-flight request (CANCELLED, partial tokens
        returned, blocks freed).  False if ``rid`` is not pending."""
        for req in self.queue:
            if req.rid == rid:
                self.queue.remove(req)
                self._result(req, RequestStatus.CANCELLED, "cancelled")
                return True
        for slot_id, slot in enumerate(self.slots):
            if slot is not None and slot.req.rid == rid:
                self._terminate(slot_id, RequestStatus.CANCELLED, "cancelled")
                return True
        return False

    def drain_finished(self) -> List[RequestResult]:
        """Terminal results since the last drain (streaming callers poll
        this after each :meth:`step`)."""
        out, self._newly_finished = self._newly_finished, []
        return out

    def _expire_deadlines(self) -> None:
        if not self._deadline:
            return
        now = self._now()
        expired = {rid for rid, dl in self._deadline.items() if now >= dl}
        if not expired:
            return
        for req in [q for q in self.queue if q.rid in expired]:
            self.queue.remove(req)
            self._result(req, RequestStatus.TIMED_OUT,
                         "deadline expired while queued")
        for slot_id, slot in enumerate(self.slots):
            if slot is not None and slot.req.rid in expired:
                self._terminate(slot_id, RequestStatus.TIMED_OUT,
                                "deadline expired mid-generation")

    def _admit(self) -> bool:
        admitted = False
        for slot_id in range(self.cfg.max_slots):
            if self.slots[slot_id] is not None or not self.queue:
                continue
            req = self.queue[0]
            # under windowed eviction admission reserves the first chunk
            # only; prefill grows (and evicts) chunk by chunk
            need = (len(req.tokens) if self._evict_window is None
                    else min(len(req.tokens), self.cfg.prefill_chunk))
            if not self.tables.ensure(slot_id, need):
                break                          # pool exhausted: wait
            self.queue.pop(0)
            self.slots[slot_id] = _Slot(req=req)
            obs_trace.event("request.admit", cat="engine", rid=req.rid,
                            slot=slot_id)
            admitted = True
        return admitted

    def _preempt(self) -> bool:
        """Release the youngest slotted request and requeue it at the head
        (or FAIL it past its preemption budget).  Youngest-first means the
        oldest request is chosen only when alone, where its whole need fits
        by the submit check: it always progresses."""
        victims = [i for i, s in enumerate(self.slots) if s is not None]
        if not victims:
            return False
        victim = max(victims, key=lambda i: (self._order[
            self.slots[i].req.rid], i))
        req = self.slots[victim].req
        self.metrics.preemptions += 1
        self._c_work["preemptions"].inc()
        n = self._preempts[req.rid] = self._preempts.get(req.rid, 0) + 1
        obs_trace.event("engine.preempt", cat="engine", rid=req.rid, count=n)
        if n > self.cfg.max_preemptions:
            self._terminate(victim, RequestStatus.FAILED,
                            f"preemption budget exhausted ({n} > "
                            f"max_preemptions={self.cfg.max_preemptions})")
            return True
        # roll back the delivered-token accounting; the regeneration
        # recounts it (the work counters keep the executed work)
        self.metrics.tokens_out -= len(req.out or [])
        self.metrics.ttft_s.pop(req.rid, None)
        req.out = None
        self.queue.insert(0, req)
        self._release(victim)
        return True

    def _step_failed(self, kind: str, exc: Exception,
                     involved: List[int]) -> None:
        """A model call raised and the tick goes on; ``max_step_retries``
        consecutive failures end the involved requests FAILED.  A kernel
        fault is re-raised instead (see the module docstring)."""
        if isinstance(exc, _KERNEL_FAULTS):
            raise exc
        self.metrics.step_failures += 1
        self._c_work["step_failures"].inc()
        self._fail_streak[kind] += 1
        obs_trace.event("engine.step_failure", cat="engine", kind=kind,
                        streak=self._fail_streak[kind])
        if self._fail_streak[kind] > self.cfg.max_step_retries:
            msg = (f"{kind} step failed {self._fail_streak[kind]} "
                   f"consecutive times (max_step_retries="
                   f"{self.cfg.max_step_retries}): {exc!r}")
            for slot_id in involved:
                if self.slots[slot_id] is not None:
                    self._terminate(slot_id, RequestStatus.FAILED, msg)
            self._fail_streak[kind] = 0

    def _evict(self, slot_id: int, next_pos: int) -> None:
        freed = self.tables.evict_window(slot_id, next_pos,
                                         self._evict_window)
        if freed:
            obs_trace.event("engine.evict", cat="engine",
                            rid=self.slots[slot_id].req.rid,
                            blocks=len(freed))
        self._reset_pos(freed)

    def _guard_trip(self) -> None:
        self.metrics.guard_trips += 1
        self._c_work["guard_trips"].inc()

    # ------------------------------------------------------------- steps
    def _prefill_one(self) -> bool:
        cfg = self.cfg
        cand = [i for i, s in enumerate(self.slots)
                if s is not None and s.state == "prefill"]
        if not cand:
            return False
        slot_id = min(cand, key=lambda i: (self._order[
            self.slots[i].req.rid], i))
        slot = self.slots[slot_id]
        prompt = np.asarray(slot.req.tokens, np.int32)
        lo = slot.n_prefilled
        chunk = prompt[lo:lo + cfg.prefill_chunk]
        if self._evict_window is not None:
            self._evict(slot_id, lo)
            while self.slots[slot_id] is not None and \
                    not self.tables.ensure(slot_id, lo + len(chunk)):
                if not self._preempt():
                    return False               # retry next tick
            if self.slots[slot_id] is None:    # preempted itself
                return True
        toks = np.zeros((1, cfg.prefill_chunk), np.int32)
        poss = np.full((1, cfg.prefill_chunk), -1, np.int32)
        toks[0, :len(chunk)] = chunk
        poss[0, :len(chunk)] = np.arange(lo, lo + len(chunk), dtype=np.int32)
        try:
            with obs_trace.span("engine.prefill_chunk", cat="engine",
                                rid=slot.req.rid, lo=lo, n=len(chunk)):
                if self._faults is not None:
                    self._faults.before_step("prefill")
                hidden = self._guarded_call(
                    "_chunk", toks, poss,
                    self.tables.table[slot_id:slot_id + 1])
        except Exception as e:                        # noqa: BLE001
            self._step_failed("prefill", e, [slot_id])
            return False
        self._fail_streak["prefill"] = 0
        slot.n_prefilled = lo + len(chunk)
        self.metrics.prefill_chunks += 1
        self._c_work["prefill_chunks"].inc()
        self.metrics.prefill_tokens += len(chunk)
        if slot.n_prefilled == len(prompt):      # final chunk: first token
            logits = self._guarded_call("_logits_at", hidden, len(chunk) - 1)
            self.metrics.first_tokens += 1
            if self._jit:
                nxt, finite = self._sample_read(logits)
                bad = finite is not None and not finite[0]
            else:
                # one reduce and a scalar copy (nan/+inf propagate through
                # max)
                bad = cfg.guard and not bool(torch.isfinite(logits.max()))
            if bad:
                self._guard_trip()
                self._terminate(slot_id, RequestStatus.FAILED,
                                "non-finite prefill logits (numerics guard)")
                return True
            tok = int(nxt[0] if self._jit else self._sample(logits)[0])
            rid = slot.req.rid
            self.metrics.ttft_s[rid] = self._now() - self._arrival[rid]
            obs_trace.event("request.first_token", cat="engine", rid=rid,
                            ttft_s=self.metrics.ttft_s[rid])
            slot.req.out = [tok]
            self.metrics.tokens_out += 1
            self._c_work["tokens"].inc()
            slot.last_tok = tok
            slot.pos = len(prompt)
            slot.remaining = cfg.max_new_tokens - 1
            slot.state = "decode"
            if tok == cfg.eos_id or slot.remaining <= 0:
                self._terminate(slot_id, RequestStatus.COMPLETED)
        return True

    def _decode_all(self) -> bool:
        cfg = self.cfg
        live = [i for i, s in enumerate(self.slots)
                if s is not None and s.state == "decode"]
        if not live:
            return False
        # grow every live slot's table to cover this step's write,
        # preempting youngest-first when the pool is dry; a slot that can
        # neither grow nor find a victim skips this tick (the watchdog
        # surfaces it if it never clears)
        blocked = set()
        for slot_id in live:
            if self._evict_window is not None \
                    and self.slots[slot_id] is not None:
                self._evict(slot_id, self.slots[slot_id].pos)
            while self.slots[slot_id] is not None and not self.tables.ensure(
                    slot_id, self.slots[slot_id].pos + 1):
                if not self._preempt():
                    blocked.add(slot_id)
                    break
        live = [i for i, s in enumerate(self.slots)
                if s is not None and s.state == "decode"
                and i not in blocked]
        if not live:
            return False
        B = cfg.max_slots
        toks = np.zeros((B, 1), np.int32)
        poss = np.full((B, 1), -1, np.int32)
        for i in live:
            toks[i, 0] = self.slots[i].last_tok
            poss[i, 0] = self.slots[i].pos
        t0 = time.perf_counter()
        try:
            with obs_trace.span("engine.decode_step", cat="engine",
                                n_live=len(live)):
                if self._faults is not None:
                    self._faults.before_step("decode")
                logits = self._guarded_call("_decode", toks, poss,
                                            self.tables.table)
        except Exception as e:                        # noqa: BLE001
            self._step_failed("decode", e, live)
            return False
        self._fail_streak["decode"] = 0
        if self._faults is not None:
            logits = self._faults.poison_logits(logits,
                                                self.metrics.decode_steps)
        if self._jit:
            # per-row max: nan/+inf propagate, one reduce over the vocab
            nxt, finite = self._sample_read(logits)
        else:
            nxt = self._sample(logits)           # ends on the tokens' copy
            finite = None
            if cfg.guard:
                finite = torch.isfinite(logits.amax(dim=-1)).cpu().numpy()
        # one ragged decode step = one token per live slot: its wall is
        # the per-token latency those slots paid
        self.metrics.decode_step_hist.observe(time.perf_counter() - t0)
        self.metrics.decode_steps += 1
        self._c_work["decode_steps"].inc()
        self.metrics.decode_slot_steps += len(live)
        for i in live:
            if finite is not None and not finite[i]:
                # fail THIS slot, not the batch: argmax over a poisoned row
                # would serve garbage tokens
                self._guard_trip()
                self._terminate(i, RequestStatus.FAILED,
                                "non-finite logits (numerics guard)")
                continue
            slot = self.slots[i]
            tok = int(nxt[i])
            slot.req.out.append(tok)
            self.metrics.tokens_out += 1
            self._c_work["tokens"].inc()
            slot.pos += 1
            slot.last_tok = tok
            slot.remaining -= 1
            if tok == cfg.eos_id or slot.remaining <= 0:
                self._terminate(i, RequestStatus.COMPLETED)
        return True

    def _abort_remaining(self, status: RequestStatus, msg: str) -> None:
        for req in list(self.queue):
            self.queue.remove(req)
            self._result(req, status, msg)
        for slot_id, slot in enumerate(self.slots):
            if slot is not None:
                self._terminate(slot_id, status, msg)

    def _watchdog_fire(self) -> None:
        """No scheduler progress for ``watchdog_steps`` ticks with work
        pending: every pending request ends FAILED, instead of ``run``
        looping forever."""
        self.metrics.watchdog_trips += 1
        self._c_work["watchdog_trips"].inc()
        obs_trace.event("engine.watchdog", cat="engine",
                        idle_ticks=self._idle_ticks)
        self._abort_remaining(
            RequestStatus.FAILED,
            f"watchdog: no scheduler progress for {self._idle_ticks} "
            f"consecutive steps (persistent allocator exhaustion or "
            f"failing model calls)")
        self._idle_ticks = 0

    # ----------------------------------------------------------------- API
    def step(self) -> bool:
        """One scheduler tick: expire deadlines, admit, one prefill chunk,
        one ragged decode step.  Returns False when there is nothing left
        to do.  Results that became terminal are in :meth:`drain_finished`.
        """
        self._tick += 1
        if self._faults is not None:
            self._skew += self._faults.clock_skew(self._tick)
        health = routing.route_health()
        recomputes0 = health.recomputes
        guard_ctx = (guards.guarded() if self.cfg.guard
                     else contextlib.nullcontext())
        try:
            with obs_trace.span("engine.tick", cat="engine",
                                tick=self._tick), guard_ctx, \
                    torch.no_grad():
                self._expire_deadlines()
                with obs_trace.span("engine.admit", cat="engine"):
                    did = self._admit()
                did = self._prefill_one() or did
                did = self._decode_all() or did
        finally:
            n = health.recomputes - recomputes0
            if n:
                self.metrics.guard_recomputes += n
                self._c_work["guard_recomputes"].inc(n)
        m = self.metrics
        m.util_sum += self.allocator.utilization
        m.util_steps += 1
        m.peak_blocks_used = max(m.peak_blocks_used,
                                 self.allocator.used_blocks)
        occ = self.allocator.occupancy()
        self._g_queue.set(len(self.queue))
        self._g_blocks.set(occ["used_blocks"])
        self._g_util.set(occ["utilization"])
        self._g_live.set(sum(s is not None for s in self.slots))
        pending = bool(self.queue) or any(s is not None for s in self.slots)
        if pending and not did:
            self._idle_ticks += 1
            if self._idle_ticks >= self.cfg.watchdog_steps:
                self._watchdog_fire()
                pending = False
        else:
            self._idle_ticks = 0
        return did or pending

    def run(self, requests: List[Request]) -> Dict[int, RequestResult]:
        """Serve ``requests`` until each reaches a terminal status; returns
        {rid: RequestResult}.  Faults end as request statuses; ``run``
        raises for a duplicate rid and for a kernel fault."""
        self.submit(requests)
        t0 = time.perf_counter()
        e0 = self._now()
        while self.queue or any(s is not None for s in self.slots):
            if self.cfg.max_wall_s is not None \
                    and self._now() - e0 >= self.cfg.max_wall_s:
                self._abort_remaining(
                    RequestStatus.TIMED_OUT,
                    f"run wall budget exhausted "
                    f"(max_wall_s={self.cfg.max_wall_s})")
                break
            if not self.step():
                break
        self.metrics.wall_s += time.perf_counter() - t0
        self.publish_metrics()
        return dict(self.results)

    # ------------------------------------------------------- observability
    def publish_metrics(self) -> None:
        """Mirror the :class:`EngineMetrics` summary into the registry as
        ``engine_*`` gauges (the live counters and histograms update as
        the engine runs)."""
        for k, v in self.metrics.summary().items():
            self.registry.gauge(f"engine_{k}").set(float(v))
        self.registry.gauge("engine_wall_s").set(self.metrics.wall_s)

    def obs_snapshot(self, audit=None) -> dict:
        """The whole-stack health snapshot: the engine summary gauges, the
        route-health dump and, when the caller ran one, the counting audit
        (``audit``: a ``ContractionCounter.summary()`` dict) published into
        the engine's registry; returned as the registry snapshot plus the
        structured ``engine`` summary and ``route_health`` entries.
        ``launch/serve.py --metrics-file`` writes this dict."""
        self.publish_metrics()
        health = routing.route_health().snapshot()
        obs_metrics.publish_route_health(health, self.registry)
        if audit is not None:
            obs_metrics.publish_contraction_audit(audit, self.registry)
        snap = self.registry.snapshot()
        snap["engine"] = dict(
            self.metrics.summary(), wall_s=self.metrics.wall_s,
            submitted=int(self._c_requests["submitted"].value))
        snap["route_health"] = health
        return snap
