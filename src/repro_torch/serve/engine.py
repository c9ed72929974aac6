"""Paged continuous-batching serving engine: the PyTorch port of the core
loop of ``repro/serve/engine.py``.

- **Paged KV cache**: one pool per layer, fixed-size blocks from a
  :class:`~repro_torch.serve.paged.BlockAllocator`, per-slot block tables;
  blocks are reserved on admission, grown during decode, and freed (their
  ``pos_pool`` entries reset) the moment a request ends.
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

Sampling is greedy at ``temperature=0`` (token-identical to the JAX
engine).  At ``temperature>0`` it draws from a ``torch.Generator`` seeded
with ``seed``, whose stream differs from the JAX engine's PRNG.

Not ported yet (ROADMAP Q1 step 8): deadlines, load shedding, the
bounded admission queue, cancellation, fault injection, the numerics
guard, the no-progress watchdog (a tick without progress raises here),
windowed block eviction and the metrics registry.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.attention import EMPTY_POS
from repro_torch.serve import paged as paged_mod
from repro_torch.serve.server import Request

__all__ = ["EngineConfig", "EngineMetrics", "Engine", "RequestStatus",
           "RequestResult"]


class RequestStatus(str, enum.Enum):
    """Terminal request statuses (the JAX engine's names)."""
    COMPLETED = "completed"
    REJECTED = "rejected"
    FAILED = "failed"

    def __str__(self):
        return self.value


@dataclasses.dataclass
class RequestResult:
    """One request's terminal outcome and the tokens it produced."""
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
    max_preemptions: int = 8      # per request; exceeded -> FAILED

    @property
    def max_len(self) -> int:
        return self.blocks_per_seq * self.block_size


@dataclasses.dataclass
class EngineMetrics:
    """Serving counters: throughput, time to first token, block use."""
    tokens_out: int = 0
    decode_steps: int = 0
    decode_slot_steps: int = 0    # sum of live slots over decode steps
    prefill_chunks: int = 0
    first_tokens: int = 0         # prefill-final logits computed
    preemptions: int = 0
    peak_blocks_used: int = 0
    util_sum: float = 0.0
    util_steps: int = 0
    ttft_s: Dict[int, float] = dataclasses.field(default_factory=dict)
    wall_s: float = 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_out / self.wall_s if self.wall_s else 0.0

    @property
    def mean_ttft_s(self) -> float:
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
    already lie there)."""

    def __init__(self, model, cfg: EngineConfig, *, seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None):
        dev = resolve_device(device)
        if model.device.type != dev.type or (
                dev.index is not None and model.device != dev):
            raise ValueError(f"the model lies on {model.device}, the engine "
                             f"was asked to run on {dev}")
        self.model = model
        self.cfg = cfg
        self.device = model.device
        with torch.no_grad():
            self.params = (model.prepare_params() if cfg.prepared
                           else model.tree())
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.allocator = paged_mod.BlockAllocator(cfg.num_blocks,
                                                  cfg.block_size)
        self.tables = paged_mod.BlockTables(self.allocator, cfg.max_slots,
                                            cfg.blocks_per_seq)
        self.cache = model.init_paged_cache(cfg.num_blocks * cfg.block_size)
        self.pos_pool = torch.as_tensor(
            paged_mod.empty_pos_pool(cfg.num_blocks, cfg.block_size),
            device=self.device)
        self.slots: List[Optional[_Slot]] = [None] * cfg.max_slots
        self.queue: List[Request] = []
        self.results: Dict[int, RequestResult] = {}
        self.metrics = EngineMetrics()
        self._arrival: Dict[int, float] = {}      # rid -> submit time
        self._order: Dict[int, int] = {}          # rid -> submit order
        self._seq = itertools.count()
        self._preempts: Dict[int, int] = {}

    # ------------------------------------------------------------ helpers
    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        if self.cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).cpu().numpy()
        probs = torch.softmax(logits.float() / self.cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0] \
            .cpu().numpy()

    def _release(self, slot_id: int) -> None:
        blocks = self.tables.release(slot_id)
        if blocks:
            idx = torch.as_tensor(self.tables.reset_slots_index(blocks),
                                  device=self.device).long()
            self.pos_pool[idx] = EMPTY_POS
        self.slots[slot_id] = None

    def _result(self, req: Request, status: RequestStatus,
                error: Optional[str] = None) -> None:
        self.results[req.rid] = RequestResult(req.rid, status,
                                              list(req.out or []), error)
        for d in (self._arrival, self._order, self._preempts):
            d.pop(req.rid, None)

    def _terminate(self, slot_id: int, status: RequestStatus,
                   error: Optional[str] = None) -> None:
        self._result(self.slots[slot_id].req, status, error)
        self._release(slot_id)

    # ----------------------------------------------------------- admission
    def submit(self, requests: List[Request]) -> None:
        """Enqueue requests; an invalid one ends REJECTED.  A duplicate rid
        raises (it would overwrite another request's result)."""
        cfg = self.cfg
        for req in requests:
            if req.rid in self.results or req.rid in self._arrival:
                raise ValueError(f"duplicate request id {req.rid}")
            total = len(req.tokens) + cfg.max_new_tokens
            if len(req.tokens) == 0:
                self._result(req, RequestStatus.REJECTED, "empty prompt")
            elif total > cfg.max_len:
                self._result(req, RequestStatus.REJECTED,
                             f"prompt {len(req.tokens)} + max_new "
                             f"{cfg.max_new_tokens} exceeds the per-sequence "
                             f"ceiling {cfg.max_len}")
            elif self.allocator.blocks_for(total) > cfg.num_blocks - 1:
                self._result(req, RequestStatus.REJECTED,
                             f"needs {self.allocator.blocks_for(total)} "
                             f"blocks, the pool has {cfg.num_blocks - 1}")
            else:
                self._arrival[req.rid] = time.perf_counter()
                self._order[req.rid] = next(self._seq)
                self.queue.append(req)

    def _admit(self) -> bool:
        admitted = False
        for slot_id in range(self.cfg.max_slots):
            if self.slots[slot_id] is not None or not self.queue:
                continue
            req = self.queue[0]
            if not self.tables.ensure(slot_id, len(req.tokens)):
                break                          # pool exhausted: wait
            self.queue.pop(0)
            self.slots[slot_id] = _Slot(req=req)
            admitted = True
        return admitted

    def _preempt(self) -> bool:
        """Release the youngest slotted request and requeue it at the head
        (or FAIL it past its preemption budget)."""
        victims = [i for i, s in enumerate(self.slots) if s is not None]
        if not victims:
            return False
        victim = max(victims, key=lambda i: (self._order[
            self.slots[i].req.rid], i))
        req = self.slots[victim].req
        self.metrics.preemptions += 1
        n = self._preempts[req.rid] = self._preempts.get(req.rid, 0) + 1
        if n > self.cfg.max_preemptions:
            self._terminate(victim, RequestStatus.FAILED,
                            f"preemption budget exhausted ({n} > "
                            f"max_preemptions={self.cfg.max_preemptions})")
            return True
        self.metrics.tokens_out -= len(req.out or [])
        self.metrics.ttft_s.pop(req.rid, None)
        req.out = None                         # regenerate from scratch
        self.queue.insert(0, req)
        self._release(victim)
        return True

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
        toks = np.zeros((1, cfg.prefill_chunk), np.int32)
        poss = np.full((1, cfg.prefill_chunk), -1, np.int32)
        toks[0, :len(chunk)] = chunk
        poss[0, :len(chunk)] = np.arange(lo, lo + len(chunk), dtype=np.int32)
        dev = self.device
        hidden = self.model.decode_paged(
            self.params, self.cache, torch.as_tensor(toks, device=dev),
            torch.as_tensor(poss, device=dev),
            torch.as_tensor(self.tables.table[slot_id:slot_id + 1],
                            device=dev),
            self.pos_pool, block_size=cfg.block_size)
        slot.n_prefilled = lo + len(chunk)
        self.metrics.prefill_chunks += 1
        if slot.n_prefilled == len(prompt):      # final chunk: first token
            last = len(chunk) - 1
            logits = self.model.logits(self.params,
                                       hidden[:, last:last + 1])[:, 0]
            self.metrics.first_tokens += 1
            tok = int(self._sample(logits)[0])
            rid = slot.req.rid
            self.metrics.ttft_s[rid] = time.perf_counter() - self._arrival[rid]
            slot.req.out = [tok]
            self.metrics.tokens_out += 1
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
        # preempting youngest-first when the pool is dry
        for slot_id in live:
            while self.slots[slot_id] is not None and not self.tables.ensure(
                    slot_id, self.slots[slot_id].pos + 1):
                self._preempt()
        live = [i for i, s in enumerate(self.slots)
                if s is not None and s.state == "decode"]
        if not live:
            return True
        B = cfg.max_slots
        toks = np.zeros((B, 1), np.int32)
        poss = np.full((B, 1), -1, np.int32)
        for i in live:
            toks[i, 0] = self.slots[i].last_tok
            poss[i, 0] = self.slots[i].pos
        dev = self.device
        hidden = self.model.decode_paged(
            self.params, self.cache, torch.as_tensor(toks, device=dev),
            torch.as_tensor(poss, device=dev),
            torch.as_tensor(self.tables.table, device=dev), self.pos_pool,
            block_size=cfg.block_size)
        logits = self.model.logits(self.params, hidden)[:, -1]
        nxt = self._sample(logits)
        self.metrics.decode_steps += 1
        self.metrics.decode_slot_steps += len(live)
        for i in live:
            slot = self.slots[i]
            tok = int(nxt[i])
            slot.req.out.append(tok)
            self.metrics.tokens_out += 1
            slot.pos += 1
            slot.last_tok = tok
            slot.remaining -= 1
            if tok == cfg.eos_id or slot.remaining <= 0:
                self._terminate(i, RequestStatus.COMPLETED)
        return True

    # ----------------------------------------------------------------- API
    def step(self) -> bool:
        """One scheduler tick: admit, one prefill chunk, one ragged decode
        step.  Returns False when nothing is left to do; raises if work is
        pending but the tick could not progress."""
        with torch.no_grad():
            did = self._admit()
            did = self._prefill_one() or did
            did = self._decode_all() or did
        m = self.metrics
        m.util_sum += self.allocator.utilization
        m.util_steps += 1
        m.peak_blocks_used = max(m.peak_blocks_used,
                                 self.allocator.used_blocks)
        pending = bool(self.queue) or any(s is not None for s in self.slots)
        if pending and not did:
            raise RuntimeError(
                f"engine tick made no progress with {len(self.queue)} queued "
                f"and {sum(s is not None for s in self.slots)} slotted "
                f"requests")
        return pending

    def run(self, requests: List[Request]) -> Dict[int, RequestResult]:
        """Serve ``requests`` until each reaches a terminal status; returns
        {rid: RequestResult}."""
        self.submit(requests)
        t0 = time.perf_counter()
        while self.step():
            pass
        self.metrics.wall_s += time.perf_counter() - t0
        return dict(self.results)
