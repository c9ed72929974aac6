"""The dense reference serving loop: the PyTorch port of
``repro/serve/server.py``.

- a fixed decode batch of ``max_batch`` slots over one dense KV cache per
  layer, with slot recycling (a finished sequence's slot is refilled from
  the queue);
- batch-of-one prefill (``LM.prefill``), whose cache is written into the
  slot layer by layer;
- slot-batched decode (``LM.decode_step``) at each slot's own position;
- greedy or temperature sampling (from an explicit ``torch.Generator``);
- per-request ``max_new_tokens`` / EOS termination.

On a CUDA device the decode step is captured once into a CUDA graph
(:class:`~repro_torch.core.graphs.CapturedCall`, with static token and
position buffers over the server's one dense cache) and replayed at every
step after, as the JAX ``Server`` jits ``decode_step``; prefill varies in
length and runs eagerly, as in JAX.  ``ServeConfig.jit`` has the engine's
meaning: ``None`` captures on CUDA and runs eagerly on the CPU, ``True``
on the CPU is refused, ``False`` runs eagerly anywhere.  The cache is the
server's for its lifetime (a graph holds its address) and is reset at the
start of every :meth:`Server.run`.

The paged :class:`~repro_torch.serve.engine.Engine` is the production
path; this loop is the plain reference it is compared with.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core import graphs
from repro_torch.device import resolve_device
from repro_torch.models.attention import EMPTY_POS

__all__ = ["ServeConfig", "Request", "Server", "write_slot"]


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 4
    cache_len: int = 256
    max_new_tokens: int = 32
    eos_id: int = -1              # -1: never terminates early
    temperature: float = 0.0      # 0 = greedy
    jit: Optional[bool] = None    # capture decode_step into a CUDA graph
                                  # (None: on CUDA only; see the module
                                  # docstring)


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray            # (prompt_len,) int32
    out: Optional[List[int]] = None
    deadline_s: Optional[float] = None    # per-request wall budget from
                                          # submit (engine only; overrides
                                          # EngineConfig.deadline_s)


def write_slot(cache, slot: int, one) -> None:
    """Copy a batch-of-one cache ``one`` (``LM.prefill``'s) into row
    ``slot`` of the batched cache ``cache``, every layer and every entry
    (the prefill cache's unwritten positions are EMPTY_POS, so the slot's
    previous occupant leaves nothing behind)."""
    for dst, src in zip(cache, one):
        for key in ("k", "v", "pos"):
            dst[key][slot] = src[key][0].to(dst[key].dtype)


class Server:
    """Serve requests through ``model`` (an :class:`~repro_torch.models.lm.LM`)
    with the params tree ``params`` (``model.tree()`` or
    ``model.prepare_params()``), on ``device`` (default: CUDA, which must be
    present; the model must already lie there)."""

    def __init__(self, model, params, cfg: ServeConfig, seed: int = 0, *,
                 device: Optional[Union[str, torch.device]] = None):
        dev = resolve_device(device)
        if model.device.type != dev.type or (
                dev.index is not None and model.device != dev):
            raise ValueError(f"the model lies on {model.device}, the server "
                             f"was asked to run on {dev}")
        if cfg.jit and model.device.type != "cuda":
            raise ValueError(f"ServeConfig(jit=True) captures a CUDA graph; "
                             f"the server runs on {model.device} (pass "
                             f"jit=None or False)")
        self.model = model
        self.params = params
        self.cfg = cfg
        self.device = model.device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.cache = cache = model.init_cache(cfg.max_batch, cfg.cache_len)
        self.jit = (self.device.type == "cuda" if cfg.jit is None
                    else bool(cfg.jit))
        dev = self.device

        def step(tokens: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
            return model.decode_step(params, cache, tokens, pos)[0]

        # _decode(tokens (B, 1), pos (B,)) on host arrays -> logits (B, V);
        # compiled, the logits are the graph's, overwritten by the next
        # step.  Bound to locals, not self: no reference cycle.
        self._graph_set = graphs.GraphSet({"decode_step": step}, dev)
        self._decode = (
            functools.partial(self._graph_set, "decode_step") if self.jit
            else lambda tokens, pos: step(torch.as_tensor(tokens, device=dev),
                                          torch.as_tensor(pos, device=dev)))
        self._prefill = model.prefill

    @property
    def graph(self) -> Optional[graphs.CapturedCall]:
        """The captured decode step (None until the first compiled step)."""
        return self._graph_set.calls.get("decode_step")

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        if self.cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).cpu().numpy()
        probs = torch.softmax(logits.float() / self.cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0] \
            .cpu().numpy()

    def run(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Serve all requests to completion; returns {rid: generated ids}."""
        rids = [r.rid for r in requests]
        if len(set(rids)) != len(rids):
            dupes = sorted({r for r in rids if rids.count(r) > 1})
            raise ValueError(
                f"duplicate request ids {dupes}: results are keyed by rid, "
                f"so duplicates would silently overwrite each other")
        with torch.no_grad():
            return self._run(list(requests))

    def _run(self, queue: List[Request]) -> Dict[int, List[int]]:
        cfg = self.cfg
        dev = self.device
        results: Dict[int, List[int]] = {}
        active: List[Optional[Request]] = [None] * cfg.max_batch
        pos = np.zeros(cfg.max_batch, np.int32)
        last_tok = np.zeros(cfg.max_batch, np.int32)
        remaining = np.zeros(cfg.max_batch, np.int32)
        cache = self.cache
        for layer in cache:                 # a fresh cache, in place
            layer["k"].zero_()
            layer["v"].zero_()
            layer["pos"].fill_(EMPTY_POS)

        def insert(slot: int, req: Request) -> None:
            toks = torch.as_tensor(np.asarray(req.tokens, np.int32)[None, :],
                                   device=dev)
            hidden, pcache = self._prefill(self.params, {"tokens": toks},
                                           cfg.cache_len)
            logits = self.model.logits(self.params, hidden[:, -1:])[:, 0]
            tok = int(self._sample(logits)[0])
            req.out = [tok]
            if tok == cfg.eos_id or cfg.max_new_tokens <= 1:
                # the first token already ends it: never take a decode slot
                results[req.rid] = req.out
                return
            write_slot(cache, slot, pcache)
            active[slot] = req
            pos[slot] = len(req.tokens)
            last_tok[slot] = tok
            remaining[slot] = cfg.max_new_tokens - 1

        while queue or any(a is not None for a in active):
            for slot in range(cfg.max_batch):
                if active[slot] is None and queue:
                    insert(slot, queue.pop(0))
            live = [s for s in range(cfg.max_batch) if active[s] is not None]
            if not live:
                continue              # instantly-finished inserts: re-admit
            logits = self._decode(last_tok[:, None], pos)
            nxt = self._sample(logits)
            for slot in live:
                req = active[slot]
                tok = int(nxt[slot])
                req.out.append(tok)
                pos[slot] += 1
                last_tok[slot] = tok
                remaining[slot] -= 1
                if tok == cfg.eos_id or remaining[slot] <= 0:
                    results[req.rid] = req.out
                    active[slot] = None
        return results
