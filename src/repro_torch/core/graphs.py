"""Captured calls: the part ``jax.jit`` plays for the JAX package's serving
and training steps, played here by CUDA graphs.

A :class:`CapturedCall` runs a function once eagerly (the warm-up, on a
side stream, so that every kernel is built and loaded and every one-time
CUDA attribute is set before capture), captures a second call into a
``torch.cuda.CUDAGraph`` and from then on replays it.  Its inputs are
trees (nested dicts, lists and tuples, :mod:`repro_torch.core.tree`)
whose leaves live in static device buffers that each call writes in place
(host arrays go through pinned staging buffers, device tensors are copied
on the device, and a leaf that already is its static buffer is not
copied); its outputs are the tensors the captured call returned,
overwritten by every replay, so a caller consumes them before the next
one.  Graphs of one owner may share a memory pool (``pool=``, from
``torch.cuda.graph_pool_handle()``) as long as they never run at once.

A :class:`CapturedFunction` is ``jax.jit``'s cache over such graphs: one
capture per input signature (the tree structure and every leaf's shape
and dtype, and the route epoch when a guard keys on it), each counted in
``captures``.  It replays the current graph on its static inputs as they
stand (a retry), re-captures it from them (after a demotion), writes a
caller's state into them (``stage``) and, as ``jax.jit``'s
``donate_argnums``, writes a call's new state back into them
(``donate``, ``write_back``).

Python does not run again when a graph replays, so every host-side effect
of the captured call would otherwise happen once, at capture.  A
:class:`CaptureLedger` records those effects while the call is captured
(:func:`recording`) and emits them again at every replay:

- the compiled audit's contraction notes
  (:func:`repro_torch.core.counting.emit_runtime_note`), tallied into each
  open :func:`~repro_torch.core.counting.track_compiled_contractions`
  counter;
- the compiled guard's finite probes
  (:func:`repro_torch.core.guards.emit_trace_probe`): each probed
  output's sum, stacked at the end of the capture into one vector and
  tested by one ``isfinite``, so the graph writes one flag vector that
  every replay hands to the pending-trip ledger and
  :func:`~repro_torch.core.guards.drain_pending_trips` reads in one copy;
- each kernel wrapper's launch counts (``.launches`` and ``.shapes``),
  whose capture-time increments are taken back (nothing ran) and added
  again at every replay, so a counter still counts launches executed.

While a ledger records, :func:`repro_torch.core.counting.note_contraction`
tallies nothing (a capture executes no contraction), the einsum
dispatcher makes no in-line finite check (its read cannot run under a
capture) and emits probes and runtime notes instead.  The recording
state is a module global, not a thread-local: on CUDA autograd runs a
captured backward in its own device thread (on the capture stream), and
its contractions record into the same ledger.

The warm-up records too, into a ledger that is thrown away: it runs as
the capture will, with no in-line finite check (a check there would trip
and demote before the capture, so the graph would never probe what a
jitted JAX step probes), no eager contraction note and no runtime note
(each contraction counts once, at its replays); its kernel launches did
execute and stay counted.

A capture that fails raises :class:`CaptureError`; nothing here falls
back to eager execution, and a CPU device is refused.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import counting
from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.kernels.build import KernelError

__all__ = ["CaptureError", "CaptureLedger", "CapturedCall",
           "CapturedFunction", "GraphSet", "recording", "current_ledger",
           "capturing", "counted_kernels", "signature"]


class CaptureError(KernelError):
    """A model call could not be captured into a CUDA graph (or a capture
    was asked of a device that has none).  A :class:`KernelError`, so the
    serving engine lets it propagate as it does a kernel fault."""


def counted_kernels() -> List[Callable]:
    """The kernel wrappers that count their launches (``.launches``, and
    ``.shapes`` where they key them by shape)."""
    from repro_torch.kernels.cpm3_matmul import cpm3_matmul_k5
    from repro_torch.kernels.cpm4_matmul import cpm4_matmul_k6
    from repro_torch.kernels.sq_conv import sq_conv_k8
    from repro_torch.kernels.sq_conv2d import sq_conv2d_k7
    from repro_torch.kernels.sq_matmul import (sq_matmul_k1, sq_matmul_k2,
                                               sq_matmul_k3)
    from repro_torch.kernels.sq_paged_attn import sq_paged_attn_k4
    return [sq_matmul_k1, sq_matmul_k2, sq_matmul_k3, sq_paged_attn_k4,
            cpm3_matmul_k5, cpm4_matmul_k6, sq_conv2d_k7, sq_conv_k8]


@dataclasses.dataclass
class CaptureLedger:
    """The host-side effects of one captured call, emitted at every replay.

    ``notes``: ``(site, spec, mode, mults, demoted)`` runtime contraction
    notes; ``probes``: ``(health_key, sum)`` finite probes, each the (1,)
    sum of a probed output; ``flags``: after :meth:`seal`, every probe's
    key and one bool device vector, ``isfinite`` of the stacked sums;
    ``launches``: ``(wrapper, launches, shapes)`` counter deltas of the
    kernel wrappers."""
    notes: List[Tuple[str, str, str, int, bool]] = dataclasses.field(
        default_factory=list)
    probes: List[Tuple[str, torch.Tensor]] = dataclasses.field(
        default_factory=list)
    flags: Optional[Tuple[Tuple[str, ...], torch.Tensor]] = None
    launches: List[Tuple[Callable, int, collections.Counter]] = \
        dataclasses.field(default_factory=list)

    def seal(self) -> None:
        """Test every probe's sum at once: one ``cat`` and one ``isfinite``
        at the end of the recording (inside the capture, so the graph
        writes the flag vector and a drain reads it in one copy)."""
        if self.probes:
            self.flags = (tuple(k for k, _ in self.probes),
                          torch.isfinite(torch.cat([s for _, s in
                                                    self.probes])))

    def emit(self) -> None:
        """Replay the recorded effects once (after each graph replay)."""
        from repro_torch.core import guards          # lazy: import cycle
        for note in self.notes:
            counting.land_runtime_note(*note)
        if self.flags is not None:
            guards.land_probes(*self.flags)
        self.count_launches()

    def count_launches(self) -> None:
        """Add the recorded launch counts to the kernel wrappers' (calls
        that executed: a replay, or a recorded warm-up)."""
        for kern, n, shapes in self.launches:
            kern.launches += n
            if shapes:
                kern.shapes.update(shapes)


_RECORDING: List[CaptureLedger] = []

# One warm-up stream per device for the process: cuBLAS keeps a workspace
# for every stream it has run on, so a fresh stream per capture would
# leave one behind for each.
_WARMUP_STREAMS: Dict[int, torch.cuda.Stream] = {}


def _warmup_stream(device: torch.device) -> torch.cuda.Stream:
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _WARMUP_STREAMS:
        _WARMUP_STREAMS[index] = torch.cuda.Stream(index)
    return _WARMUP_STREAMS[index]


def current_ledger() -> Optional[CaptureLedger]:
    """The ledger a capture is recording into, or None."""
    return _RECORDING[-1] if _RECORDING else None


def capturing() -> bool:
    """Whether the calls made now are being captured: a ledger records, or
    the current CUDA stream captures (a capture of the caller's own)."""
    if _RECORDING:
        return True
    return torch.cuda.is_initialized() \
        and torch.cuda.is_current_stream_capturing()


@contextlib.contextmanager
def recording(ledger: CaptureLedger):
    """Record the host-side effects of the enclosed calls into ``ledger``.

    :class:`CapturedCall` opens this region around its capture.  Inside it
    the open ``track_contractions`` counters are set aside and the kernel
    wrappers' launch counts made inside are moved into the ledger (the
    counters are left as they were before the region), since a capture
    executes nothing.  The region ends by sealing the ledger
    (:meth:`CaptureLedger.seal`), so it must close inside the capture.
    Run around plain calls (as the CPU tests do, where there is no graph),
    it fills the ledger the same way."""
    if _RECORDING:
        raise CaptureError("a capture ledger is already recording: captures "
                           "do not nest")
    kernels = counted_kernels()
    before = [(k.launches, collections.Counter(getattr(k, "shapes", {})))
              for k in kernels]
    open_counters = list(counting._COUNTERS)
    del counting._COUNTERS[:]
    _RECORDING.append(ledger)
    try:
        yield ledger
        ledger.seal()
    finally:
        _RECORDING.pop()
        counting._COUNTERS[:] = open_counters
        for kern, (n, shapes) in zip(kernels, before):
            delta = kern.launches - n
            grown = collections.Counter()
            if hasattr(kern, "shapes"):
                grown = kern.shapes - shapes
                kern.shapes.clear()
                kern.shapes.update(shapes)
            kern.launches = n
            if delta or grown:
                ledger.launches.append((kern, delta, grown))


def _host_dtype(arg) -> torch.dtype:
    """The torch dtype of a host input (a numpy array or Python number)."""
    return torch.from_numpy(np.empty(0, np.asarray(arg).dtype)).dtype


def _leaf_signature(leaf) -> Tuple[Tuple[int, ...], torch.dtype]:
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), leaf.dtype
    return np.shape(leaf), _host_dtype(leaf)


def signature(args: Sequence[Any]) -> Tuple:
    """What a capture is keyed on, as a ``jax.jit`` cache keys a trace: the
    tree structure of ``args`` and each leaf's shape and dtype (a host
    array and a device tensor of one shape and dtype are one input)."""
    leaves, treedef = tree_flatten(tuple(args))
    return treedef, tuple(_leaf_signature(x) for x in leaves)


def _static_like(arg, device: torch.device) -> torch.Tensor:
    """A static device buffer for the input leaf ``arg``."""
    if isinstance(arg, torch.Tensor):
        if arg.device.type == "cpu":
            raise CaptureError("pass host inputs as numpy arrays or Python "
                               "numbers; a CPU tensor is not staged")
        return torch.empty_like(arg, device=device)
    return torch.empty(np.shape(arg), dtype=_host_dtype(arg), device=device)


class CapturedCall:
    """``fn(*args)`` captured into one CUDA graph on ``device``.

    ``args``: the first call's inputs, trees whose leaves are numpy arrays
    or Python numbers (host inputs, staged through pinned memory) or CUDA
    tensors; every later call passes inputs of the same structure, shapes
    and dtypes.  ``fn`` takes the static device buffers in the same trees
    (``inputs``) and returns a tree of tensors (the static outputs,
    returned by every call).  ``pool``: a graph memory pool handle shared
    with the owner's other graphs.

    Construction writes ``args`` into the static buffers, runs ``fn`` once
    eagerly on a side stream (the warm-up; recorded into a ledger that is
    thrown away, its result discarded) and captures a second call;
    :meth:`replay` then runs the first call, and each later call is
    ``call(*args)``.  So ``fn`` must give the same result when run again
    on the same inputs, as a functional train step does, or a model call
    that writes its caches in place at the positions of its inputs.  A
    call that updates tensors in place from their own values (a recurrent
    state) names them in ``state``: they are copied before the warm-up and
    written back after it, so the first replay applies the call once."""

    def __init__(self, fn: Callable, args: Sequence[Any], *,
                 device: torch.device, pool=None, name: str = "call",
                 state: Sequence[torch.Tensor] = ()):
        device = torch.device(device)
        if device.type != "cuda":
            raise CaptureError(f"CUDA graphs need a CUDA device; {name} was "
                               f"asked to capture on {device}")
        self.name = name
        self.device = device
        leaves, self._treedef = tree_flatten(tuple(args))
        self._static = [_static_like(a, device) for a in leaves]
        self._staging: List[Optional[torch.Tensor]] = [None] * len(leaves)
        self._staged: Optional[torch.cuda.Event] = None
        self.inputs = tree_unflatten(self._treedef, self._static)
        self._write(args)

        stream = torch.cuda.current_stream(device)
        saved = [t.clone() for t in state]
        side = _warmup_stream(device)
        side.wait_stream(stream)
        # builds, loads, sets attributes; recorded, so that it checks and
        # notes nothing in line (the module docstring).  The serving
        # engine's and the dense Server's captures warm up here too, and
        # had the same exposure while their warm-up ran unrecorded: a trip
        # there demoted before the capture (none of their tests drives a
        # warm-up that trips)
        with torch.cuda.stream(side), recording(CaptureLedger()) as warm:
            fn(*self.inputs)
        warm.count_launches()
        stream.wait_stream(side)
        for t, t0 in zip(state, saved):
            t.copy_(t0)
        del saved

        self.ledger = CaptureLedger()
        self.graph = torch.cuda.CUDAGraph()
        # A graph that the cyclic garbage collector frees while this one
        # captures resets itself, a CUDA call a capture does not permit,
        # and the capture is lost: no collection during a capture.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=pool), \
                    recording(self.ledger):
                self.outputs = fn(*self.inputs)
        except KernelError:
            raise
        except RuntimeError as e:            # torch's capture and CUDA errors
            raise CaptureError(f"capturing {name} into a CUDA graph failed: "
                               f"{e}") from e
        finally:
            if collecting:
                gc.enable()
        self.replays = 0

    def _write(self, args: Sequence[Any]) -> None:
        """Write ``args``, all the inputs or a leading run of them, into
        their static buffers."""
        leaves, treedef = tree_flatten(tuple(args))
        want = ("tuple", self._treedef[1][:len(args)])
        if treedef != want:
            raise ValueError(f"{self.name}: inputs of another tree "
                             f"structure than captured ({len(args)} "
                             f"inputs, captured with "
                             f"{len(self._treedef[1])})")
        staged, dsts, srcs = False, [], []
        for i, (arg, static) in enumerate(zip(leaves, self._static)):
            if arg is static:                 # a donated or staged input
                continue
            if isinstance(arg, torch.Tensor):
                if tuple(arg.shape) != tuple(static.shape) \
                        or arg.dtype != static.dtype:
                    raise ValueError(f"{self.name}: input {tuple(arg.shape)} "
                                     f"{arg.dtype}, captured with "
                                     f"{tuple(static.shape)} {static.dtype}")
                if arg.device.type == "cpu":
                    raise CaptureError("pass host inputs as numpy arrays or "
                                       "Python numbers; a CPU tensor is not "
                                       "staged")
                if arg.data_ptr() != static.data_ptr():
                    dsts.append(static)
                    srcs.append(arg)
                continue
            host = np.asarray(arg)
            if host.shape != tuple(static.shape):
                raise ValueError(f"{self.name}: input shape {host.shape}, "
                                 f"captured with {tuple(static.shape)}")
            if not staged and self._staged is not None:
                self._staged.synchronize()    # the last copies left staging
            staged = True
            if self._staging[i] is None:
                self._staging[i] = torch.empty(static.shape,
                                               dtype=static.dtype,
                                               pin_memory=True)
            np.copyto(self._staging[i].numpy(), host, casting="same_kind")
            static.copy_(self._staging[i], non_blocking=True)
        if dsts:
            # one multi-tensor copy: a train step's state is hundreds of
            # leaves, and a launch for each left the device waiting on the
            # host for 3 % of a full-width step on an H100
            torch._foreach_copy_(dsts, srcs)
        if staged:
            self._staged = torch.cuda.Event()
            self._staged.record(torch.cuda.current_stream(self.device))

    def replay(self):
        """Replay the graph on the current inputs and emit its ledger."""
        self.graph.replay()
        self.replays += 1
        self.ledger.emit()
        return self.outputs

    def __call__(self, *args):
        self._write(args)
        return self.replay()

    def release(self) -> None:
        """Free the graph and drop its buffers (its pool's memory returns
        once no graph of the pool is left and no caller holds one of its
        outputs)."""
        self.graph.reset()
        self.outputs = None
        self._static, self._staging, self.inputs = [], [], None
        self.ledger = CaptureLedger()


class CapturedFunction:
    """``fn`` over trees, captured per input signature and replayed: the
    counterpart of ``jax.jit(fn)`` (the JAX launcher's train step is
    ``jax.jit(make_train_step(...), donate_argnums=(0, 1))``).

    A call whose :func:`signature` (with ``epoch_keyed``, also the route
    epoch, which a guard's demotion moves) has no graph yet captures one
    (a :class:`CapturedCall` with a memory pool of its own, counted in
    ``captures``), as a jit cache miss traces; later calls of that
    signature write their inputs into its static buffers and replay it.

    The outputs are the graph's static outputs, overwritten by its next
    replay.  A call copies its inputs into the static inputs before the
    replay, unless they already are those buffers, and a replay never
    writes them (the function is functional).  So a retry replays from the
    static inputs (:meth:`replay`), never from the caller's tensors, which
    may be the previous replay's outputs that the tripped replay
    overwrote; a re-capture (:meth:`recapture`) takes its inputs from the
    old graph's static inputs before it frees the old graph; and
    :meth:`stage` writes a caller's state into the static inputs ahead of
    the call.

    ``donate``: the leading inputs the call hands over (a train step's
    params and optimizer state: 2), as ``jax.jit``'s ``donate_argnums``.
    After each call the same leading outputs, the new state, are written
    back into those static inputs and returned from there
    (:meth:`write_back`), so the caller, passing them back, has the next
    call copy nothing for them; the write-back's launches are issued
    while the device still runs the replay.  An owner that must check a
    call first (a guard's drain) keeps ``donate`` 0 and writes back
    itself."""

    def __init__(self, fn: Callable, *, device: torch.device,
                 name: str = "fn", epoch_keyed: bool = False,
                 donate: int = 0):
        device = torch.device(device)
        if device.type != "cuda":
            raise CaptureError(f"CUDA graphs need a CUDA device; {name} was "
                               f"asked to capture on {device}")
        self.fn, self.device, self.name = fn, device, name
        self.epoch_keyed = epoch_keyed
        self.donate = donate
        self.calls: Dict[Tuple, CapturedCall] = {}
        self.current: Optional[CapturedCall] = None
        self.captures = 0

    def _key(self, args: Sequence[Any]) -> Tuple:
        key = signature(args)
        if self.epoch_keyed:
            from repro_torch.kernels import routing   # lazy: import cycle
            key += (routing.route_epoch(),)
        return key

    def _capture(self, key: Tuple, args: Sequence[Any]) -> CapturedCall:
        call = CapturedCall(self.fn, args, device=self.device,
                            name=self.name)
        self.captures += 1
        self.calls[key] = self.current = call
        return call

    def __call__(self, *args):
        key = self._key(args)
        call = self.calls.get(key)
        if call is None:
            out = self._capture(key, args).replay()
        else:
            self.current = call
            out = call(*args)
        return self.write_back(out, self.donate) if self.donate else out

    def write_back(self, out, n: int):
        """``out`` with its leading ``n`` outputs written into the current
        graph's leading static inputs and replaced by them (see
        :meth:`stage`: outputs of another signature than those inputs,
        such as the optimizer state that gains ``error_feedback`` after
        ``--grad-compression``'s first step, are returned as they are)."""
        return tuple(self.stage(*out[:n])) + tuple(out[n:])

    def replay(self):
        """Replay the current graph on its static inputs as they stand: a
        retry of the last call on the inputs that call wrote."""
        if self.current is None:
            raise CaptureError(f"{self.name}: nothing captured to replay")
        return self.current.replay()

    def recapture(self) -> None:
        """Capture the current call anew from its static inputs (a
        demotion moved the routes, which a capture fixes), then free every
        graph captured before it: the next call of any other signature
        captures again, as a fresh ``jax.jit`` traces."""
        if self.current is None:
            raise CaptureError(f"{self.name}: nothing captured to re-capture")
        old = self.current.inputs
        fresh = CapturedCall(self.fn, old, device=self.device,
                             name=self.name)
        self.release()
        self.captures += 1
        self.calls[self._key(old)] = self.current = fresh

    def stage(self, *args):
        """Write ``args``, the leading inputs of the next call (a train
        step's params and optimizer state), into the current graph's
        static inputs and return them there, so the next call copies
        nothing for them and a retry starts from them.  Inputs of another
        signature than the current graph's are returned as they are: the
        next call copies them, or captures anew."""
        call = self.current
        if call is None or signature(args) != signature(
                call.inputs[:len(args)]):
            return args
        call._write(args)
        return call.inputs[:len(args)]

    def release(self) -> None:
        """Free every graph: the next call captures again."""
        for call in self.calls.values():
            call.release()
        self.calls.clear()
        self.current = None


class GraphSet:
    """An owner's model calls, each captured into a :class:`CapturedCall`
    at its first call and replayed after; the graphs share one memory
    pool.  ``fns``: name -> function of the static device buffers.
    ``set(name, *args)`` is one call; ``calls`` holds the graphs captured
    so far and ``captures`` counts every capture (re-captures included).
    ``state``: tensors the calls update in place from their own values
    (:class:`CapturedCall`'s).  It holds no reference to its owner, so an
    owner that binds its calls to it stays free of reference cycles."""

    def __init__(self, fns: Dict[str, Callable], device: torch.device,
                 state: Sequence[torch.Tensor] = ()):
        self.fns, self.device, self.state = fns, device, tuple(state)
        self.calls: Dict[str, CapturedCall] = {}
        self.captures = 0
        self._pool = None

    def __call__(self, name: str, *args):
        graph = self.calls.get(name)
        if graph is not None:
            return graph(*args)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        self.captures += 1
        graph = self.calls[name] = CapturedCall(
            self.fns[name], args, device=self.device, pool=self._pool,
            name=name, state=self.state)
        return graph.replay()

    def release(self) -> None:
        """Free every graph and the pool: the next call of each name
        captures again."""
        for graph in self.calls.values():
            graph.release()
        self.calls.clear()
        self._pool = None
