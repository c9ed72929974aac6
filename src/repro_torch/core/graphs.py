"""Captured model calls: the part ``jax.jit`` plays for the JAX package's
serving step, played here by CUDA graphs.

A :class:`CapturedCall` runs a model function once eagerly (the warm-up,
on a side stream, so that every kernel is built and loaded and every
one-time CUDA attribute is set before capture), captures a second call
into a ``torch.cuda.CUDAGraph`` and from then on replays it.  Its inputs
are static device buffers that each call writes in place (host arrays go
through pinned staging buffers, device tensors are copied on the device);
its outputs are the tensors the captured call returned, overwritten by
every replay, so a caller consumes them before the next one.  Graphs of
one owner may share a memory pool (``pool=``, from
``torch.cuda.graph_pool_handle()``) as long as they never run at once.

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
capture) and emits probes and runtime notes instead.

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
from repro_torch.kernels.build import KernelError

__all__ = ["CaptureError", "CaptureLedger", "CapturedCall", "GraphSet",
           "recording", "current_ledger", "capturing", "counted_kernels"]


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


def _static_like(arg, device: torch.device) -> Tuple[torch.Tensor,
                                                     Optional[torch.Tensor]]:
    """A static device buffer for ``arg`` and, for a host array, its pinned
    staging buffer."""
    if isinstance(arg, torch.Tensor):
        if arg.device.type == "cpu":
            raise CaptureError("pass host inputs as numpy arrays or Python "
                               "numbers; a CPU tensor is not staged")
        return torch.empty_like(arg, device=device), None
    host = torch.from_numpy(np.array(arg))
    staging = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
    return torch.empty(host.shape, dtype=host.dtype, device=device), staging


class CapturedCall:
    """``fn(*args)`` captured into one CUDA graph on ``device``.

    ``args``: the first call's inputs, numpy arrays or Python numbers (host
    inputs, staged through pinned memory) or CUDA tensors; every later
    call passes inputs of the same shapes and dtypes.  ``fn`` takes the
    static device buffers and returns a tensor or a tuple of tensors (the
    static outputs, returned by every call).  ``pool``: a graph memory
    pool handle shared with the owner's other graphs.

    Construction writes ``args`` into the static buffers, runs ``fn`` once
    eagerly on a side stream (the warm-up; its result is discarded) and
    captures a second call; :meth:`replay` then runs the first call, and
    each later call is ``call(*args)``.  So ``fn`` must give the same
    result when run again on the same inputs, as a model call that writes
    its caches in place at the positions of its inputs does."""

    def __init__(self, fn: Callable, args: Sequence[Any], *,
                 device: torch.device, pool=None, name: str = "call"):
        device = torch.device(device)
        if device.type != "cuda":
            raise CaptureError(f"CUDA graphs need a CUDA device; {name} was "
                               f"asked to capture on {device}")
        self.name = name
        self.device = device
        bufs = [_static_like(a, device) for a in args]
        self._static = [b for b, _ in bufs]
        self._staging = [s for _, s in bufs]
        self._staged: Optional[torch.cuda.Event] = None
        self._write(args)

        stream = torch.cuda.current_stream(device)
        side = _warmup_stream(device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            fn(*self._static)                 # builds, loads, sets attributes
        stream.wait_stream(side)

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
                self.outputs = fn(*self._static)
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
        if len(args) != len(self._static):
            raise ValueError(f"{self.name}: {len(args)} inputs, captured "
                             f"with {len(self._static)}")
        if self._staged is not None:
            self._staged.synchronize()        # the last copies left staging
        for arg, static, staging in zip(args, self._static, self._staging):
            if staging is None:
                if tuple(arg.shape) != tuple(static.shape) \
                        or arg.dtype != static.dtype:
                    raise ValueError(f"{self.name}: input {tuple(arg.shape)} "
                                     f"{arg.dtype}, captured with "
                                     f"{tuple(static.shape)} {static.dtype}")
                if arg.data_ptr() != static.data_ptr():
                    static.copy_(arg)
                continue
            host = np.asarray(arg)
            if host.shape != tuple(staging.shape):
                raise ValueError(f"{self.name}: input shape {host.shape}, "
                                 f"captured with {tuple(staging.shape)}")
            np.copyto(staging.numpy(), host, casting="same_kind")
            static.copy_(staging, non_blocking=True)
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
        once no graph of the pool is left)."""
        self.graph.reset()
        self.outputs = None
        self._static, self._staging = [], []
        self.ledger = CaptureLedger()


class GraphSet:
    """An owner's model calls, each captured into a :class:`CapturedCall`
    at its first call and replayed after; the graphs share one memory
    pool.  ``fns``: name -> function of the static device buffers.
    ``set(name, *args)`` is one call; ``calls`` holds the graphs captured
    so far and ``captures`` counts every capture (re-captures included).
    It holds no reference to its owner, so an owner that binds its calls
    to it stays free of reference cycles."""

    def __init__(self, fns: Dict[str, Callable], device: torch.device):
        self.fns, self.device = fns, device
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
            name=name)
        return graph.replay()

    def release(self) -> None:
        """Free every graph and the pool: the next call of each name
        captures again."""
        for graph in self.calls.values():
            graph.release()
        self.calls.clear()
        self._pool = None
