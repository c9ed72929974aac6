"""Deterministic fault injection for the training loop: the PyTorch port
of ``repro/train/faults.py``.

An injector goes to :class:`repro_torch.train.trainer.Trainer` through its
``faults=`` argument, which threads it through the step wrapper
(:class:`FaultyTrainStep`), the checkpoint writer
(``CheckpointManager(faults=...)``) and the end-of-step hook.  The
recovery contract: every schedule ends with a loss trajectory and final
state bit-identical to the unfaulted run (retries run the functional step
again; rollbacks replay the batch stream, which the synthetic pipeline
regenerates from ``(seed, step)``); a kill or SIGTERM resumes from the
newest valid checkpoint; a checkpoint write fault costs that snapshot
only.

Injection points (0-based ordinals counting CALLS, so a retried step
advances the ordinal and is not poisoned again):

``step_fail``     the ``n``-th step call raises
                  :class:`~repro_torch.serve.faults.InjectedFault`;
``nan_grad``      the ``n``-th step call's returned params are NaN while
                  its loss stays finite: the damage commits and only the
                  next step's loss exposes it, forcing a rollback;
``ckpt_fail``     the ``n``-th checkpoint write raises between staging and
                  the atomic rename;
``kill_after``    once ``n`` steps have committed, raise
                  :class:`SimulatedKill` (a ``BaseException``);
``sigterm_after`` once ``n`` steps have committed, deliver a real
                  ``SIGTERM`` to this process, then :class:`SimulatedKill`.
"""
from __future__ import annotations

import dataclasses
import os
import signal
from typing import Dict, FrozenSet, Optional

import numpy as np
import torch

from repro_torch.core.tree import tree_map
from repro_torch.serve.faults import InjectedFault

__all__ = ["SimulatedKill", "TrainFaultPlan", "TrainFaultInjector",
           "FaultyTrainStep", "InjectedFault"]


class SimulatedKill(BaseException):
    """Simulated process death.  Not a ``RuntimeError``: the trainer's
    retry and rollback must never absorb it; a test "restarts" by building
    a fresh Trainer that resumes."""


def _fset(v) -> FrozenSet[int]:
    return frozenset(int(x) for x in (() if v is None else v))


@dataclasses.dataclass(frozen=True)
class TrainFaultPlan:
    """One deterministic training-fault schedule (0-based ordinals)."""
    step_fail: FrozenSet[int] = frozenset()
    nan_grad: FrozenSet[int] = frozenset()
    ckpt_fail: FrozenSet[int] = frozenset()
    kill_after: Optional[int] = None
    sigterm_after: Optional[int] = None

    @classmethod
    def of(cls, *, step_fail=(), nan_grad=(), ckpt_fail=(),
           kill_after: Optional[int] = None,
           sigterm_after: Optional[int] = None) -> "TrainFaultPlan":
        return cls(step_fail=_fset(step_fail), nan_grad=_fset(nan_grad),
                   ckpt_fail=_fset(ckpt_fail), kill_after=kill_after,
                   sigterm_after=sigterm_after)

    @classmethod
    def random(cls, seed: int, *, steps: int = 12, p_step: float = 0.15,
               p_nan: float = 0.10, p_ckpt: float = 0.25,
               p_kill: float = 0.5) -> "TrainFaultPlan":
        """A seeded schedule, drawn as the JAX package draws it (same seed,
        same plan).  ``p_*`` are per-ordinal rates over the first ``steps``
        ordinals; ``p_kill`` the chance of one kill at a random commit
        count."""
        rng = np.random.default_rng(seed)
        kill = (int(rng.integers(1, max(2, steps - 1)))
                if rng.random() < p_kill else None)
        return cls.of(
            step_fail=np.nonzero(rng.random(steps) < p_step)[0],
            nan_grad=np.nonzero(rng.random(steps) < p_nan)[0],
            ckpt_fail=np.nonzero(rng.random(steps) < p_ckpt)[0],
            kill_after=kill)


class TrainFaultInjector:
    """Stateful executor of one :class:`TrainFaultPlan` (use a fresh one per
    trainer "process", as a restarted process would)."""

    def __init__(self, plan: TrainFaultPlan):
        self.plan = plan
        self.calls: Dict[str, int] = {"step": 0, "ckpt": 0}
        self.injected: Dict[str, int] = {"step": 0, "nan": 0, "ckpt": 0,
                                         "kill": 0, "sigterm": 0}

    def next_step_ordinal(self) -> int:
        n = self.calls["step"]
        self.calls["step"] += 1
        return n

    def step_raises(self, n: int) -> bool:
        if n in self.plan.step_fail:
            self.injected["step"] += 1
            return True
        return False

    def poisons_update(self, n: int) -> bool:
        if n in self.plan.nan_grad:
            self.injected["nan"] += 1
            return True
        return False

    def before_ckpt_write(self, step: int) -> None:
        n = self.calls["ckpt"]
        self.calls["ckpt"] += 1
        if n in self.plan.ckpt_fail:
            self.injected["ckpt"] += 1
            raise InjectedFault(
                f"injected checkpoint write failure (write {n}, step {step})")

    def after_commit(self, committed_steps: int) -> None:
        if self.plan.sigterm_after is not None and \
                committed_steps == self.plan.sigterm_after:
            self.injected["sigterm"] += 1
            # the trainer's handler must leave a complete newest
            # checkpoint, because the process "dies" right after it
            os.kill(os.getpid(), signal.SIGTERM)
            raise SimulatedKill(
                f"SIGTERM then kill after step {committed_steps}")
        if self.plan.kill_after is not None and \
                committed_steps == self.plan.kill_after:
            self.injected["kill"] += 1
            raise SimulatedKill(f"killed after step {committed_steps}")


class FaultyTrainStep:
    """A train step that runs one injector's step schedule: ``step_fail``
    ordinals raise before the step runs; ``nan_grad`` ordinals let it run,
    then return every float param as NaN (the loss untouched).  It wraps
    an eager or a captured step alike: the poisoned params are fresh
    tensors, never the graph's outputs, and any other attribute (a
    captured step's ``stage`` and ``captures``) is the wrapped step's."""

    def __init__(self, step_fn, injector: TrainFaultInjector):
        self._fn = step_fn
        self.injector = injector

    def __call__(self, params, opt_state, batch):
        n = self.injector.next_step_ordinal()
        if self.injector.step_raises(n):
            raise InjectedFault(f"injected train-step failure (call {n})")
        new_params, new_opt, metrics = self._fn(params, opt_state, batch)
        if self.injector.poisons_update(n):
            new_params = tree_map(
                lambda p: torch.full_like(p, float("nan"))
                if p.is_floating_point() else p, new_params)
        return new_params, new_opt, metrics

    def __getattr__(self, name):
        return getattr(self._fn, name)
