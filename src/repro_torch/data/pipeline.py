"""Deterministic synthetic token pipeline with checkpointable state: the
PyTorch port of ``repro/data/pipeline.py``.

Batch ``t`` is numpy's ``default_rng((seed, t))``, exactly as the JAX
package draws it, so both packages train on bit-identical token streams,
and a restart or a rollback regenerates the same batches from the saved
``(seed, step)``.  The JAX pipeline's two frontend stubs come with them:
a prefix arch's ``patches`` (B, P, D), drawn from ``default_rng((seed,
step, 7))``, and an encoder-decoder arch's ``frames`` (B, encoder_seq, D),
from ``default_rng((seed, step, 11))``, each N(0, 1) f32 times 0.02, drawn
on the host in JAX's order and then moved to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from repro_torch.device import Device, resolve_device

__all__ = ["DataConfig", "SyntheticLM", "make_batch_specs"]


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
    (with ``model_cfg``'s ``patches`` or ``frames``, f32) on ``device``
    (default: CUDA, which must be present)."""

    def __init__(self, cfg: DataConfig, model_cfg=None, start_step: int = 0,
                 *, device: Device = None):
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

    def _stub(self, step: int, stream: int, length: int) -> np.ndarray:
        """A frontend stub's (B, length, D) embeddings: stream 7 the
        patches, 11 the frames, as the JAX pipeline draws them."""
        rng = np.random.default_rng((self.cfg.seed, step, stream))
        return rng.normal(size=(self.cfg.global_batch, length,
                                self.model_cfg.d_model)).astype(
            np.float32) * 0.02

    def next_batch(self) -> Dict[str, torch.Tensor]:
        arrays = {"tokens": self._tokens(self.step)}
        mc = self.model_cfg
        if mc is not None and mc.prefix_tokens:
            arrays["patches"] = self._stub(self.step, 7, mc.prefix_tokens)
        if mc is not None and mc.encoder_layers:
            arrays["frames"] = self._stub(self.step, 11, mc.encoder_seq)
        self.step += 1
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in arrays.items()}

    def take(self, n: int) -> List[Dict[str, torch.Tensor]]:
        """The next ``n`` batches (advances the stream): two pipelines of
        one ``DataConfig`` give bit-identical lists."""
        return [self.next_batch() for _ in range(n)]


def make_batch_specs(model_cfg, shape_cfg, *, for_train: bool = True
                     ) -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins for every model input of a cell (JAX's
    ``ShapeDtypeStruct`` batch): ``tokens`` int32, (B, S+1) to train,
    (B, S) to prefill, (B, 1) to decode, and at train and prefill a prefix
    arch's ``patches`` and an encoder-decoder arch's ``frames``, f32."""
    B = shape_cfg.global_batch
    S = shape_cfg.seq_len
    meta = dict(device="meta")
    n = {"train": S + 1, "prefill": S}.get(shape_cfg.kind, 1)
    specs = {"tokens": torch.empty((B, n), dtype=torch.int32, **meta)}
    if shape_cfg.kind in ("train", "prefill"):
        if model_cfg.prefix_tokens:
            specs["patches"] = torch.empty(
                (B, model_cfg.prefix_tokens, model_cfg.d_model),
                dtype=torch.float32, **meta)
        if model_cfg.encoder_layers:
            specs["frames"] = torch.empty(
                (B, model_cfg.encoder_seq, model_cfg.d_model),
                dtype=torch.float32, **meta)
    return specs
