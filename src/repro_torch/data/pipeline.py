"""Deterministic synthetic token pipeline with checkpointable state: the
PyTorch port of ``repro/data/pipeline.py``.

Batch ``t`` is numpy's ``default_rng((seed, t))``, exactly as the JAX
package draws it, so both packages train on bit-identical token streams,
and a restart or a rollback regenerates the same batches from the saved
``(seed, step)``.  The prefix-patch and encoder-frame stubs of the JAX
pipeline belong to archs the port does not build yet (ROADMAP Q1 step 6);
a config that needs them is refused.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from repro_torch.device import Device, resolve_device

__all__ = ["DataConfig", "SyntheticLM"]


@dataclasses.dataclass
class DataConfig:
    global_batch: int
    seq_len: int
    vocab: int
    seed: int = 1234
    # noisy arithmetic sequences, so the LM has something to learn
    structure: bool = True


class SyntheticLM:
    """Stateful iterator: ``next_batch()`` -> ``{"tokens": (B, S+1) int32}``
    on ``device`` (default: CUDA, which must be present)."""

    def __init__(self, cfg: DataConfig, model_cfg=None, start_step: int = 0,
                 *, device: Device = None):
        if model_cfg is not None and (model_cfg.prefix_tokens
                                      or model_cfg.encoder_layers):
            raise NotImplementedError(
                f"arch {model_cfg.name!r} needs prefix patches or encoder "
                f"frames, which come with the archs that use them (ROADMAP "
                f"Q1 step 6)")
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.step = start_step
        self.device = resolve_device(device)

    # ----------------------------------------------------------- state
    def state_dict(self) -> Dict[str, int]:
        return {"step": self.step, "seed": self.cfg.seed}

    def load_state_dict(self, s: Dict[str, int]) -> None:
        if s["seed"] != self.cfg.seed:
            raise ValueError(f"data seed changed across restart: "
                             f"{s['seed']} -> {self.cfg.seed}")
        self.step = int(s["step"])

    # ----------------------------------------------------------- batches
    def _tokens(self, step: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S = cfg.global_batch, cfg.seq_len + 1
        if not cfg.structure:
            return rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
        start = rng.integers(0, cfg.vocab, (B, 1))
        stride = rng.integers(1, 17, (B, 1))
        base = (start + stride * np.arange(S)[None, :]) % cfg.vocab
        noise = rng.integers(0, cfg.vocab, (B, S))
        take_noise = rng.random((B, S)) < 0.05
        return np.where(take_noise, noise, base).astype(np.int32)

    def next_batch(self) -> Dict[str, torch.Tensor]:
        batch = {"tokens": torch.from_numpy(self._tokens(self.step)).to(
            self.device)}
        self.step += 1
        return batch

    def take(self, n: int) -> List[Dict[str, torch.Tensor]]:
        """The next ``n`` batches (advances the stream): two pipelines of
        one ``DataConfig`` give bit-identical lists."""
        return [self.next_batch() for _ in range(n)]
