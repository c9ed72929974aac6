"""The train step and its builders: the PyTorch port of
``repro/train/step.py``.

:func:`make_train_step` returns a functional ``train_step(params,
opt_state, batch) -> (new_params, new_opt_state, metrics)``, as the JAX
builder does: the inputs are never written (AdamW returns new tensors), so
a retry or a rollback can run a step again on the same inputs.  The
gradients come from ``torch.autograd`` through the ``fs_einsum`` VJP, so
under a square mode both backward contractions of every forward one are
square-routed, at the sites ``<site>.bwd_x`` and ``<site>.bwd_w``.

The step runs eagerly, or captured whole (forward, the backward from
autograd's device thread, AdamW) into one CUDA graph and replayed, the
port's ``jax.jit``: :func:`jit_train_step` is the launcher's
``jax.jit(make_train_step(...), donate_argnums=(0, 1))``, and
:class:`GuardedStep` captures by default on CUDA, as JAX's jits.  A
captured step donates its params and optimizer state: it writes the new
ones back into the graph's static inputs (which no replay writes) and
returns them from there, so passed back they cost the next call no copy;
its metrics are the graph's outputs, which the next replay overwrites
(:class:`~repro_torch.core.graphs.CapturedFunction`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from repro_torch.core import counting, graphs, guards
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import context as dctx
from repro_torch.distributed import sharding as shd
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.device import Device, resolve_device
from repro_torch.kernels import routing
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.optim import adamw
from repro_torch.train import loss as loss_mod

__all__ = ["TrainConfig", "make_train_step", "make_grad_fn",
           "make_prefill_step", "make_decode_step", "make_loss_fn",
           "value_and_grad", "audit_step", "jit_train_step", "GuardedStep"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: adamw.AdamWConfig = adamw.AdamWConfig()
    aux_loss_weight: float = 0.01         # MoE load balance
    microbatch: int = 0                   # 0 = no gradient accumulation
    grad_compression: bool = False        # int8 + error feedback


def make_loss_fn(model, tcfg: TrainConfig):
    """``loss_fn(params, batch) -> (loss, metrics)``: next-token
    cross-entropy of ``batch["tokens"]`` (B, S+1) through the chunked loss
    at the site ``loss``, plus the weighted aux loss.  A prefix arch's
    patch positions are cut from the hidden states before the loss, so
    its vocab GEMM runs over the S text positions only."""
    cfg = model.cfg

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        inp = dict(batch)
        inp["tokens"] = tokens[:, :-1]
        labels = tokens[:, 1:]
        hidden, aux, _ = model.forward(params, inp)
        if cfg.prefix_tokens:
            hidden = hidden[:, cfg.prefix_tokens:]    # the text positions
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
        loss, metrics = loss_mod.chunked_xent(
            hidden, labels, params["embed"]["table"], mask=mask,
            chunk=cfg.loss_chunk, mode=cfg.matmul_mode,
            policy=cfg.contraction_policy)
        loss, metrics = _global_mean(loss, metrics)
        total = loss + tcfg.aux_loss_weight * aux
        return total, dict(metrics, xent=loss, aux=aux)

    return loss_fn


def _data_size(mesh) -> int:
    if mesh is None:
        return 1
    return math.prod(coll.axis_size(mesh, a) for a in shd.data_axes(mesh))


def _global_mean(loss, metrics):
    """Under a data-parallel mesh, the rank's mean loss as its share of the
    global mean: ``loss * tokens / sum(tokens)``, summed over the data
    axes with an identity transpose, so each rank's gradient is its own
    tokens' share and the gradients' sum over the data axes (the train
    step's) is the gradient of the global mean, whatever each rank's mask
    holds.  ``acc`` and ``tokens`` become the global ones."""
    mesh = dctx.current_mesh()
    if _data_size(mesh) == 1:
        return loss, metrics
    axes = shd.data_axes(mesh)
    with torch.no_grad():
        stats = torch.stack([metrics["tokens"],
                             metrics["acc"] * metrics["tokens"]])
        for a in axes:
            coll.all_reduce_(stats, mesh, a)
    share = loss * (metrics["tokens"].detach() / stats[0])
    for a in axes:
        share = coll.reduce_from(share, mesh, a)
    return share, dict(metrics, acc=stats[1] / stats[0], tokens=stats[0])


def _sum_grads(grads):
    """The gradients summed over the data axes of the current mesh (one
    all-reduce a leaf, in place)."""
    mesh = dctx.current_mesh()
    if _data_size(mesh) > 1:
        for g in tree_leaves(grads):
            for a in shd.data_axes(mesh):
                coll.all_reduce_(g, mesh, a)
    return grads


def _refuse_multi_rank(what: str) -> None:
    mesh = dctx.current_mesh()
    if mesh is not None and not isinstance(mesh, shd.AbstractMesh) \
            and math.prod(shd.mesh_shape(mesh).values()) > 1:
        raise RuntimeError(
            f"{what} captures the step into a CUDA graph, and the mesh's "
            f"collectives (gloo) cannot be captured: run the step eagerly "
            f"under a mesh of more than one rank")


def value_and_grad(loss_fn, params, batch):
    """``((loss, metrics), grads)`` of ``loss_fn`` at ``params``, the
    counterpart of ``jax.value_and_grad(has_aux=True)``.  The leaves are
    differentiated through detached aliases, so ``params`` itself gains no
    ``grad`` and no graph."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, batch)
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(p)
              for g, p in zip(grads, leaves))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_map(lambda _: next(it), live)


def make_grad_fn(model, tcfg: TrainConfig):
    """``grad_fn(params, batch) -> ((loss, metrics), grads)``: the train
    step's loss and gradients before the optimizer.  With
    ``tcfg.microbatch`` smaller than the batch the gradients are
    accumulated in f32 over ``B // microbatch`` microbatches (a loop where
    JAX scans) and ``metrics`` are the last microbatch's, as JAX's.

    Under a mesh whose data axes hold more than one rank
    (``distributed/context.py``), ``batch`` is the global batch.  Microbatch
    ``i`` is the global rows ``[i * microbatch, (i + 1) * microbatch)``, of
    which each rank takes its shard (``sharding.shard_batch``), JAX's
    microbatch constraint (the batch shard on the microbatch axis).  The
    loss is each rank's share of the global mean (``_global_mean``), and
    the gradients are summed over the data axes, so every rank returns the
    gradients of the global batch.  Parameters stay whole on every
    rank."""
    loss_fn = make_loss_fn(model, tcfg)

    def grad_fn(params, batch):
        mesh = dctx.current_mesh()
        dsize = _data_size(mesh)
        B = batch["tokens"].shape[0]

        def local(b):
            return shd.shard_batch(mesh, b) if dsize > 1 else b

        if tcfg.microbatch and tcfg.microbatch < B:
            mb = tcfg.microbatch
            n = B // mb
            g_acc, l_acc = None, 0.0
            for i in range(n):
                mbatch = local({k: v[i * mb:(i + 1) * mb]
                                for k, v in batch.items()})
                (l, metrics), g = value_and_grad(loss_fn, params, mbatch)
                g32 = tree_map(lambda t: t.float(), g)
                g_acc = g32 if g_acc is None else tree_map(
                    torch.add, g_acc, g32)
                l_acc = l_acc + l
            grads = tree_map(lambda t: t / n, g_acc)
            loss = l_acc / n
        else:
            (loss, metrics), grads = value_and_grad(loss_fn, params,
                                                    local(batch))
        with torch.no_grad():
            grads = _sum_grads(grads)
        return (loss, metrics), grads

    return grad_fn


def make_train_step(model, tcfg: TrainConfig):
    """``train_step(params, opt_state, batch)``: forward, the square-routed
    backward and AdamW, the gradients those of :func:`make_grad_fn`
    (microbatched, and summed over the data axes under a mesh, so every
    rank ends the step with the same params); ``grad_compression``
    quantizes them to int8 with error feedback kept in
    ``opt_state["error_feedback"]``."""
    grad_fn = make_grad_fn(model, tcfg)

    def train_step(params, opt_state, batch):
        (loss, metrics), grads = grad_fn(params, batch)
        with torch.no_grad():
            if tcfg.grad_compression:
                opt_state = dict(opt_state)
                ef = opt_state.get("error_feedback")
                if ef is None:
                    ef = tree_map(lambda p: torch.zeros(
                        p.shape, dtype=torch.float32, device=p.device),
                        params)
                grads, ef = adamw.compressed_grad_tree(grads, ef)
                opt_state["error_feedback"] = ef
            new_params, new_opt, opt_metrics = adamw.adamw_update(
                tcfg.opt, params, grads,
                {k: opt_state[k] for k in ("step", "m", "v")})
        if tcfg.grad_compression:
            new_opt["error_feedback"] = opt_state["error_feedback"]
        return new_params, new_opt, dict(metrics, loss=loss, **opt_metrics)

    return train_step


def audit_step(step_fn, params, opt_state, batch):
    """Run one train step under a contraction audit: ``(step outputs,
    ContractionCounter)``.  The counter covers the forward and both
    backward contractions of each (``<site>.bwd_x`` / ``<site>.bwd_w``), so
    ``ctr.fraction_square`` is the square-routed share of the step's whole
    contraction volume and ``ctr.fraction_square_bwd`` the backward's.  A
    rematerialised recompute notes nothing: each contraction counts once.
    Pass an eager step: a captured one notes nothing here (its warm-up and
    capture are recorded, its replays run no Python) and warns
    :class:`~repro_torch.core.counting.EmptyAuditWarning`; read it with
    ``counting.compiled_audit()`` around its capture and
    ``track_compiled_contractions()`` around its replays."""
    with counting.track_contractions() as ctr:
        out = step_fn(params, opt_state, batch)
    return out, ctr


def jit_train_step(step_fn, device: Device = None
                   ) -> graphs.CapturedFunction:
    """The JAX launcher's ``jax.jit(make_train_step(model, tcfg),
    donate_argnums=(0, 1))``: ``step_fn`` captured whole into one CUDA
    graph at its first call (and at the first call of each new input
    signature, as under ``--grad-compression``, whose optimizer state
    gains ``error_feedback`` after the first step) and replayed after,
    with no guard.  The :class:`~repro_torch.core.graphs.CapturedFunction`
    is called as the eager step is.  Its params and optimizer state are
    donated: each call writes the new ones back into the graph's static
    inputs and returns them from there, so a caller that passes them back
    has the next call copy nothing; the metrics are the graph's outputs,
    overwritten by the next replay.  Under a mesh of more than one rank
    it raises ``RuntimeError``: gloo collectives cannot be captured."""
    _refuse_multi_rank("jit_train_step")
    return graphs.CapturedFunction(step_fn, device=resolve_device(device),
                                   name="train_step", donate=2)


class GuardedStep:
    """A train step under the numerics guard, captured (the JAX default,
    a jitted step) or eager.

    ``jit=None`` (the default) captures on CUDA and runs eagerly on the
    CPU, which has no graphs; ``jit=True`` on the CPU is refused;
    ``jit=False`` runs eagerly anywhere.  The device is the params'.

    Captured, every call replays a CUDA graph whose square-routed
    contractions (forward and backward) carry finite probes, then drains
    the pending trips (one read):

    - a clean step writes the new params and optimizer state back into
      the graph's static inputs and returns them from there, with the
      graph's metrics (JAX's launcher donates them; here the write-back
      waits for the clean drain, so a retry still finds the inputs);
    - a tripped step's output is suspect, so it is discarded and the step
      replayed, from the graph's static inputs (the caller's params may
      be the previous replay's outputs, which the tripped replay
      overwrote).  Each drain records trips into ``RouteHealth``; once a
      key demotes, the route epoch moves, and as the route is fixed at
      capture the graph is captured anew from its static inputs (counted
      in ``rejits``, the span ``train.rejit``), so the retry serves that
      site on the standard route.  A step still tripping after
      ``max_retries`` retries raises.

    The retry is deterministic: the step is functional and replays on its
    unchanged static inputs, so the recovered result equals an eagerly
    guarded run's bit for bit.  Eagerly, a square-routed output that is
    not finite trips its key and is recomputed on the standard route in
    line, so the drain finds nothing; the counters
    (``train_guard_trips_total``, ``train_guard_rejits_total``,
    ``train_guard_retries_total``) and the loop stay JAX's.  Do not pass
    a step captured elsewhere: ``GuardedStep`` owns the capture.
    """

    def __init__(self, step_fn, *, jit: Optional[bool] = None,
                 trip_limit: int = guards.DEFAULT_TRIP_LIMIT,
                 max_retries: int = 8,
                 registry: obs_metrics.MetricsRegistry = None):
        self._raw = step_fn
        self._jit = jit
        self._fn = None               # the step or its capture, at call 1
        self.trip_limit = trip_limit
        self.max_retries = max_retries
        self.guard_trips = 0          # probe trips drained (all keys)
        self.rejits = 0               # fresh captures forced by demotions
        self.retries = 0              # discarded-and-recomputed steps
        reg = registry if registry is not None \
            else obs_metrics.default_registry()
        self.registry = reg
        self._c_trips = reg.counter("train_guard_trips_total")
        self._c_rejits = reg.counter("train_guard_rejits_total")
        self._c_retries = reg.counter("train_guard_retries_total")
        self._epoch = routing.route_epoch()

    def _bind(self, params) -> None:
        """Resolve ``jit`` on the params' device at the first call."""
        device = tree_leaves(params)[0].device
        if self._jit and device.type != "cuda":
            raise ValueError(f"GuardedStep(jit=True) captures CUDA graphs; "
                             f"its params are on {device} (use jit=None "
                             f"or False)")
        self._jit = (device.type == "cuda" if self._jit is None
                     else bool(self._jit))
        if self._jit:
            _refuse_multi_rank("GuardedStep")
        self._fn = (graphs.CapturedFunction(self._raw, device=device,
                                            name="guarded_train_step",
                                            epoch_keyed=True)
                    if self._jit else self._raw)

    @property
    def captures(self) -> int:
        """Captures so far, re-captures included (0 when eager)."""
        return self._fn.captures if self._jit and self._fn is not None \
            else 0

    def stage(self, params, opt_state):
        """Write the state into the captured step's static inputs (see
        :meth:`repro_torch.core.graphs.CapturedFunction.stage`); eager,
        the state as it is."""
        if self._jit and self._fn is not None:
            return self._fn.stage(params, opt_state)
        return params, opt_state

    def stats(self) -> Dict[str, int]:
        return {"guard_trips": self.guard_trips, "rejits": self.rejits,
                "retries": self.retries}

    def __call__(self, params, opt_state, batch):
        if self._fn is None:
            self._bind(params)
        for attempt in range(self.max_retries + 1):
            with guards.guarded(trip_limit=self.trip_limit):
                if attempt and self._jit:
                    out = self._fn.replay()       # the static inputs
                else:
                    out = self._fn(params, opt_state, batch)
                trips = guards.drain_pending_trips(self.trip_limit)
            if not trips:
                return self._fn.write_back(out, 2) if self._jit else out
            n_trips = sum(trips.values())
            self.guard_trips += n_trips
            self._c_trips.inc(n_trips)
            if routing.route_epoch() != self._epoch:
                # a key demoted: the graph still serves the square route
                # there, and only a fresh capture sees the demotion (under
                # the guard, whose probes are a capture-time decision)
                self._epoch = routing.route_epoch()
                if self._jit:
                    with guards.guarded(trip_limit=self.trip_limit), \
                            obs_trace.span("train.rejit", cat="train",
                                           attempt=attempt):
                        self._fn.recapture()
                    self.rejits += 1
                    self._c_rejits.inc()
            self.retries += 1
            self._c_retries.inc()
        raise RuntimeError(
            f"guarded train step still tripping after {self.max_retries} "
            f"retries (keys: {sorted(trips)}): the non-finite source is not "
            f"a square-routed contraction this guard can demote")


def make_prefill_step(model, cache_len: int):
    def prefill_step(params, batch):
        hidden, cache = model.prefill(params, batch, cache_len)
        logits = model.logits(params, hidden[:, -1:])[:, 0]
        return logits, cache
    return prefill_step


def make_decode_step(model):
    def decode_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos)
    return decode_step
