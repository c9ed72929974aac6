"""Fault-tolerant training loop: the PyTorch port of
``repro/train/trainer.py``.

- auto-resume from the newest valid checkpoint: params, optimizer state,
  data-stream position and the committed loss trajectory;
- periodic async checkpoints (atomic, fsynced, checksummed, keep-K);
- SIGTERM drains the async writer and takes a final blocking checkpoint
  from inside the handler;
- bounded step retries: a raising step is run again on the same batch
  (the step is functional, so a retry is bit-exact);
- rollback: with recovery armed (``faults`` given or
  ``rollback_on_nonfinite``), a non-finite committed loss restores the
  newest valid checkpoint and replays; rollbacks that make no progress
  escalate to strictly older checkpoints, then to the initial snapshot,
  bounded by ``max_rollbacks``;
- a straggler watchdog: steps slower than ``watchdog_factor`` x the EWMA
  of step time are logged;
- the first step's contraction audit (forward and backward sites) lands in
  the result, and :meth:`Trainer.obs_snapshot` is what
  ``launch/train.py --metrics-file`` writes.

Restored trees come back on the device the initial params lie on.  The
step is eager or captured into a CUDA graph
(:func:`repro_torch.train.step.jit_train_step`, a
``GuardedStep(jit=True)``).  Eager, its backward runs in autograd's device
thread on CUDA, so the ``train.step`` span holds the host's forward, the
wait for the backward and the optimizer's dispatch, not the backward's own
spans or events (those land on that thread's track); captured, it holds
the launch of the replay, of the write-back below and (guarded) the
drain.

A captured step donates its params and optimizer state: it writes the new
ones back into the graph's static inputs, which no replay writes, and
returns them from there, so the state the trainer commits lives in those
inputs and a retry of a raising call starts from it, never from a graph
output that a replay overwrote.  A rollback or a resume writes the
restored trees there too (the step's ``stage``).  Checkpoints copy to the
host before ``save`` returns, so no write reads a buffer the next step's
write-back overwrites.
"""
from __future__ import annotations

import dataclasses
import math
import signal
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.checkpoint.manager import (CheckpointCorruptError,
                                            CheckpointManager)
from repro_torch.core import counting
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels.build import KernelError
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.train.faults import (FaultyTrainStep, SimulatedKill,
                                      TrainFaultInjector)

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "repro_ckpt"
    keep: int = 3
    log_every: int = 10
    watchdog_factor: float = 3.0
    # audit the first step's contractions, forward and backward sites,
    # into the run result
    audit_contractions: bool = True
    # consecutive raising step calls tolerated before the run fails
    max_step_retries: int = 3
    # non-finite-loss checkpoint rollbacks tolerated per run
    max_rollbacks: int = 8
    # probe every committed loss and roll back on non-finite even without
    # a fault injector (an injector arms recovery by itself)
    rollback_on_nonfinite: bool = False


class Trainer:
    def __init__(self, cfg: TrainerConfig, train_step: Callable,
                 params, opt_state, data: SyntheticLM,
                 faults: Optional[TrainFaultInjector] = None,
                 registry: Optional[obs_metrics.MetricsRegistry] = None):
        self.cfg = cfg
        self._faults = faults
        self.train_step = (FaultyTrainStep(train_step, faults)
                           if faults is not None else train_step)
        self.params = params
        self.opt_state = opt_state
        self.data = data
        self._device = tree_leaves(params)[0].device
        # one registry per run, shared with the checkpoint manager so one
        # snapshot covers steps and commits
        self.registry = (registry if registry is not None
                         else obs_metrics.MetricsRegistry())
        self._c_steps = self.registry.counter("train_steps_total")
        self._c_step_failures = self.registry.counter(
            "train_step_failures_total")
        self._c_rollbacks = self.registry.counter("train_rollbacks_total")
        self._c_stragglers = self.registry.counter("train_stragglers_total")
        self._h_step = self.registry.histogram("train_step_seconds")
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep,
                                      faults=faults, registry=self.registry)
        self.step = 0
        self.metrics_log = []
        self.straggler_events = []
        self.contraction_audit = None
        self.loss_trajectory: List[float] = []
        self.step_failures = 0        # raising step calls (retried)
        self.rollbacks = 0            # non-finite-loss checkpoint restores
        self.ckpt_failures = 0        # absorbed checkpoint write failures
        self._recovery = faults is not None or cfg.rollback_on_nonfinite
        self._preempted = False
        self._in_ckpt = False         # SIGTERM-handler reentrancy latch
        self._last_restored_step: Optional[int] = None
        # the step-0 fallback of a rollback when no checkpoint restores:
        # the caller's own tensors, which no step writes (a captured step
        # copies them into its static inputs at its capture), never a
        # graph buffer
        self._init_snapshot = ({"params": params, "opt_state": opt_state},
                               {"step": 0, "data": data.state_dict(),
                                "losses": []})

    def _place(self, tree):
        return tree_map(lambda t: t.to(self._device), tree)

    def _restore(self, trees) -> None:
        """Adopt restored trees as the committed state: on the device, and
        written into a captured step's static inputs (its ``stage``)."""
        params = self._place(trees["params"])
        opt_state = self._place(trees["opt_state"])
        stage = getattr(self.train_step, "stage", None)
        self.params, self.opt_state = ((params, opt_state) if stage is None
                                       else stage(params, opt_state))

    # ------------------------------------------------------------- resume
    def maybe_resume(self) -> bool:
        if self.ckpt.latest_step() is None:
            return False
        trees, meta = self.ckpt.restore()     # the newest valid step
        self._restore(trees)
        self.data.load_state_dict(meta["data"])
        self.step = int(meta["step"])
        self.loss_trajectory = [float(x) for x in meta.get("losses", [])]
        obs_trace.event("train.resume", cat="train", step=self.step)
        return True

    def _save(self, block: bool = False):
        """Checkpoint the committed state; a write failure costs this
        snapshot (counted), never the run."""
        self._in_ckpt = True
        try:
            self.ckpt.save(
                self.step,
                {"params": self.params, "opt_state": self.opt_state},
                meta={"data": self.data.state_dict(),
                      "losses": self.loss_trajectory},
                block=block)
        except Exception:
            self.ckpt_failures += 1
        finally:
            self._in_ckpt = False

    def _on_sigterm(self, *_):
        self._preempted = True
        obs_trace.event("train.sigterm", cat="train", step=self.step)
        # Python runs handlers between bytecodes of the main thread: if
        # the interrupted frame is inside _save, let that save finish and
        # the loop exit on _preempted; otherwise commit a final blocking
        # checkpoint now, since the process may never run another line
        if not self._in_ckpt:
            self._save(block=True)

    # ----------------------------------------------------------- recovery
    def _attempt_step(self, batch, audit: bool):
        """One logical step with bounded retries of raising calls, each
        from the committed state: the caller's or a restore's own tensors,
        or a captured step's static inputs, none of which a replay
        writes."""
        for attempt in range(self.cfg.max_step_retries + 1):
            try:
                if audit and attempt == 0:
                    # eager, the step notes its contractions as it runs (as
                    # JAX's first, tracing call does); captured, it notes
                    # nothing (its warm-up and capture are recorded) and
                    # the compiled audit, on at the capture, tallies its
                    # replay
                    with counting.compiled_audit(), \
                            counting.track_compiled_contractions() as cctr, \
                            counting.track_contractions(
                                allow_empty=True) as ctr:
                        out = self.train_step(self.params, self.opt_state,
                                              batch)
                    got = ctr if ctr.records else cctr
                    if got.records:
                        self.contraction_audit = got.summary()
                    return out
                return self.train_step(self.params, self.opt_state, batch)
            except (SimulatedKill, KernelError):
                # process death, or a kernel or capture fault (a capture
                # that fails raises, never falls back): no absorbing
                raise
            except Exception as e:
                self.step_failures += 1
                self._c_step_failures.inc()
                obs_trace.event("train.step_failure", cat="train",
                                step=self.step, attempt=attempt)
                if attempt >= self.cfg.max_step_retries:
                    raise RuntimeError(
                        f"train step failed {attempt + 1} consecutive "
                        f"times at step {self.step}") from e

    def _rollback(self):
        """Restore the newest valid checkpoint, or a strictly older one
        when the last restore made no progress (that snapshot may hold the
        poisoned params), or else the initial snapshot."""
        self.rollbacks += 1
        self._c_rollbacks.inc()
        if self.rollbacks > self.cfg.max_rollbacks:
            raise RuntimeError(
                f"non-finite loss persisted through "
                f"{self.cfg.max_rollbacks} checkpoint rollbacks")
        before = None
        if self._last_restored_step is not None and \
                self.step <= self._last_restored_step:
            before = self._last_restored_step
        try:
            trees, meta = self.ckpt.restore(before=before)
        except (FileNotFoundError, CheckpointCorruptError):
            trees, meta = self._init_snapshot
            meta = dict(meta, step=0)
        self._restore(trees)
        self.data.load_state_dict(meta["data"])
        self.step = int(meta["step"])
        self._last_restored_step = self.step
        obs_trace.event("train.rollback", cat="train", to_step=self.step)
        self.loss_trajectory = [float(x) for x in
                                meta.get("losses", [])][: self.step]
        self.metrics_log = [m for m in self.metrics_log
                            if m["step"] <= self.step]

    # --------------------------------------------------------------- loop
    def run(self) -> Dict[str, Any]:
        old = signal.signal(signal.SIGTERM, self._on_sigterm)
        ewma = None
        steps_run = 0
        try:
            if self._recovery and self.step == 0 and \
                    self.ckpt.latest_step() is None:
                self._save(block=True)        # the rollback anchor
            while self.step < self.cfg.total_steps and not self._preempted:
                batch = self.data.next_batch()
                t0 = time.monotonic()
                with obs_trace.span("train.step", cat="train",
                                    step=self.step):
                    new_params, new_opt, metrics = self._attempt_step(
                        batch, audit=(steps_run == 0
                                      and self.cfg.audit_contractions))
                loss = float(metrics["loss"])
                if self._recovery and not math.isfinite(loss):
                    # a poisoned update committed one step earlier:
                    # replay from the last snapshot
                    self._rollback()
                    continue
                self.params, self.opt_state = new_params, new_opt
                self.loss_trajectory.append(loss)
                dt = time.monotonic() - t0
                steps_run += 1
                if steps_run > 1:
                    # the first step carries one-time costs (kernel builds)
                    self._h_step.observe(dt)
                    if ewma is None:
                        ewma = dt
                    else:
                        if dt > self.cfg.watchdog_factor * ewma:
                            self.straggler_events.append(
                                {"step": self.step, "dt": dt, "ewma": ewma})
                            self._c_stragglers.inc()
                        ewma = 0.9 * ewma + 0.1 * dt
                self.step += 1
                self._c_steps.inc()
                if self.step % self.cfg.log_every == 0 or \
                        self.step == self.cfg.total_steps:
                    self.metrics_log.append(
                        {"step": self.step,
                         **{k: float(v) for k, v in metrics.items()}})
                if self.step % self.cfg.ckpt_every == 0:
                    self._save()
                if self._faults is not None:
                    self._faults.after_commit(self.step)   # may "die" here
            self._save(block=True)
        finally:
            try:
                self.ckpt.wait()
            except Exception:
                self.ckpt_failures += 1
            signal.signal(signal.SIGTERM, old)
        result = {"final_step": self.step,
                  "metrics": self.metrics_log,
                  "stragglers": self.straggler_events,
                  "contraction_audit": self.contraction_audit,
                  "preempted": self._preempted,
                  "loss_trajectory": list(self.loss_trajectory),
                  "step_failures": self.step_failures,
                  "rollbacks": self.rollbacks,
                  "ckpt_failures": self.ckpt_failures}
        if hasattr(self.train_step, "stats"):
            result["guard"] = self.train_step.stats()   # GuardedStep
        result["captures"] = getattr(self.train_step, "captures", 0)
        self.publish_metrics()
        return result

    # ------------------------------------------------------- observability
    def publish_metrics(self) -> None:
        """Mirror run-level results into the registry as gauges."""
        reg = self.registry
        reg.gauge("train_final_step").set(float(self.step))
        reg.gauge("train_preempted").set(float(self._preempted))
        reg.gauge("train_ckpt_failures").set(float(self.ckpt_failures))
        if self.loss_trajectory:
            reg.gauge("train_last_loss").set(self.loss_trajectory[-1])
        if self.contraction_audit is not None:
            obs_metrics.publish_contraction_audit(self.contraction_audit,
                                                  reg)
        if hasattr(self.train_step, "stats"):
            for k, v in self.train_step.stats().items():
                reg.gauge(f"train_guard_{k}").set(float(v))

    def obs_snapshot(self) -> dict:
        """The training registry's snapshot: step counters and step-time
        percentiles, checkpoint commits, the first step's contraction audit
        (square fraction forward and backward), guard counts and the
        route-health dump."""
        from repro_torch.kernels import routing
        self.publish_metrics()
        health = routing.route_health().snapshot()
        obs_metrics.publish_route_health(health, self.registry)
        snap = self.registry.snapshot()
        snap["route_health"] = health
        if self.contraction_audit is not None:
            snap["contraction_audit"] = dict(self.contraction_audit)
        return snap
