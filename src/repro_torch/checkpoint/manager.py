"""Atomic, checksummed, crash-consistent checkpoints: the PyTorch port of
``repro/checkpoint/manager.py``, with its layout and guarantees.

Layout (one directory per step):

    <dir>/step_000000042.<pid>.<tid>.tmp/...  -> written, fsynced, then
    <dir>/step_000000042/                        atomically renamed
        meta.json       (step, data-iterator state, loss trajectory)
        arrays.npz      (flat {path: array})
        manifest.json   (per-array sha256 / dtype / shape, and the whole
                         tree's fingerprint; validated on restore)

- **A torn write cannot be observed**: every file is fsynced before the
  tmp directory is renamed into place and the parent directory is fsynced
  after; ``*.tmp`` litter of a killed writer is swept when a manager is
  built.
- **Corruption is detected, not served**: :meth:`restore` hashes every
  array against the manifest and the tree against
  :func:`repro_torch.optim.adamw.tree_fingerprint`.  An explicitly
  requested corrupt step raises :class:`CheckpointCorruptError`; restoring
  the latest falls back to the newest older valid step.
- **GC never strands a run**: keep-K prunes oldest first and always keeps
  the newest structurally valid step.
- **Async**: a background thread serializes; at most one save is in
  flight, and a worker's failure surfaces once at the next
  :meth:`wait`/:meth:`save`.  One lock serializes writes and GC.

Tensors are saved from the host (``.cpu()``), so a checkpoint restores on
any device.  numpy has no bfloat16, and the card's host has no
``ml_dtypes``: a bf16 tensor is stored as its ``uint16`` view and the
manifest records ``bfloat16``, which restore views back.  Trees are nested
dicts and lists; restored trees hold CPU tensors, lists where the saved
tree had lists or tuples.
"""
from __future__ import annotations

import copy
import hashlib
import json
import logging
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tree import tree_map
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

__all__ = ["CheckpointManager", "CheckpointCorruptError"]

logger = logging.getLogger("repro_torch.checkpoint")

_STEP_RE = re.compile(r"^step_(\d{9})$")
_TMP_RE = re.compile(r"^step_\d{9}\..*\.tmp$")


class CheckpointCorruptError(RuntimeError):
    """A checkpoint step failed validation (missing file, bad JSON,
    checksum or fingerprint mismatch, array set drift)."""


def _flatten(tree, prefix="") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}__{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def fix(node):
        if isinstance(node, dict) and node and all(
                k.startswith("__") for k in node):
            return [fix(node[f"__{i}"]) for i in range(len(node))]
        if isinstance(node, dict):
            return {k: fix(v) for k, v in node.items()}
        return node

    return fix(root)


def _host(leaf) -> torch.Tensor:
    """A leaf copied to a contiguous CPU tensor (numpy arrays and scalars
    too): the snapshot owns its memory, whatever the caller does next."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return t.cpu() if t.device.type != "cpu" else t.clone(
            memory_format=torch.contiguous_format)
    return torch.from_numpy(np.array(leaf))


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """The array stored for ``t``: its ``uint16`` view for bf16."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _stored_dtype(dtype_name: str) -> str:
    return "uint16" if dtype_name == "bfloat16" else dtype_name


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _array_digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _build_manifest(step: int, flat: Dict[str, torch.Tensor],
                    arrays: Dict[str, np.ndarray]) -> Dict[str, Any]:
    from repro_torch.optim import adamw        # lazy: import cycle
    return {
        "step": int(step),
        "arrays": {k: {"sha256": _array_digest(arrays[k]),
                       "dtype": _dtype_name(t), "shape": list(t.shape)}
                   for k, t in flat.items()},
        "tree_fingerprint": adamw.tree_fingerprint(flat),
    }


def _dump(path: str, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True,
                 faults=None,
                 registry: Optional[obs_metrics.MetricsRegistry] = None):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        # a train-fault injector's before_ckpt_write fires between staging
        # and the rename: the crash point the commit must make invisible
        self._faults = faults
        reg = registry if registry is not None \
            else obs_metrics.default_registry()
        self.registry = reg
        # ckpt_commits_total counts renames that landed; a save that died
        # before its rename counts in ckpt_write_failures_total instead
        self._c = {k: reg.counter(f"ckpt_{k}_total")
                   for k in ("saves", "commits", "write_failures",
                             "restores", "gc_removed")}
        os.makedirs(directory, exist_ok=True)
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._io_lock = threading.Lock()
        self._sweep_tmp()

    # ------------------------------------------------------------- listing
    def steps(self):
        return sorted(int(m.group(1)) for m in map(_STEP_RE.match,
                                                    os.listdir(self.dir))
                      if m)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:09d}")

    def _sweep_tmp(self) -> None:
        """Remove ``*.tmp`` litter of a writer that died (never a committed
        ``step_*`` directory: the rename is the commit)."""
        for name in os.listdir(self.dir):
            if _TMP_RE.match(name):
                logger.warning("checkpoint: sweeping stale tmp dir %s "
                               "(previous writer died mid-write)", name)
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)

    # --------------------------------------------------------------- save
    def _write(self, step: int, trees: Dict[str, Any], meta: Dict[str, Any]):
        with self._io_lock:
            self._write_locked(step, trees, meta)
            self._gc_locked()

    def _write_locked(self, step, trees, meta):
        final = self._step_dir(step)
        # a unique tmp dir: writers of one step never collide
        tmp = f"{final}.{os.getpid()}.{threading.get_ident()}.tmp"
        with obs_trace.span("ckpt.stage", cat="ckpt", step=step):
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            flat = {}
            for name, tree in trees.items():
                for k, v in _flatten(tree, f"{name}/").items():
                    flat[k] = _host(v)
            arrays = {k: _to_numpy(t) for k, t in flat.items()}
            _dump(os.path.join(tmp, "arrays.npz"),
                  lambda f: np.savez(f, **arrays))
            _dump(os.path.join(tmp, "meta.json"), lambda f: f.write(
                json.dumps(dict(meta, step=step)).encode()))
            _dump(os.path.join(tmp, "manifest.json"), lambda f: f.write(
                json.dumps(_build_manifest(step, flat, arrays)).encode()))
            with obs_trace.span("ckpt.fsync", cat="ckpt", step=step):
                _fsync_dir(tmp)
        if self._faults is not None:
            # simulated crash point: files written, rename pending
            self._faults.before_ckpt_write(step)
        with obs_trace.span("ckpt.commit", cat="ckpt", step=step):
            try:
                os.replace(tmp, final)        # the atomic commit
            except OSError:
                if os.path.isdir(final):      # same step already committed
                    shutil.rmtree(tmp, ignore_errors=True)
                else:
                    raise
            _fsync_dir(self.dir)              # commit the rename itself
        self._c["commits"].inc()

    def _quick_valid(self, step: int) -> bool:
        """All three files present: GC's probe for the newest valid step
        (restore validates the content)."""
        d = self._step_dir(step)
        return all(os.path.isfile(os.path.join(d, n))
                   for n in ("arrays.npz", "meta.json", "manifest.json"))

    def _gc_locked(self):
        steps = self.steps()
        keep = set(steps[max(0, len(steps) - self.keep):])
        # with corrupt dirs stacked above it, the keep-K window alone
        # could hold only garbage: keep the newest valid step as well
        for s in reversed(steps):
            if self._quick_valid(s):
                keep.add(s)
                break
        for s in steps:
            if s not in keep:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)
                self._c["gc_removed"].inc()

    def save(self, step: int, trees: Dict[str, Any],
             meta: Optional[Dict[str, Any]] = None, block: bool = False):
        """Snapshot ``trees`` to host memory and ``meta`` by deep copy now
        (the caller goes on changing its own objects), then serialize in
        the background, or at once with ``block``.  An async save in
        flight is joined first, and its failure raised."""
        self._c["saves"].inc()
        host = {name: tree_map(_host, tree) for name, tree in trees.items()}
        meta = copy.deepcopy(meta) if meta else {}
        self.wait()                            # at most one in flight
        if not self.async_save or block:
            try:
                self._write(step, host, meta)
            except BaseException:
                self._c["write_failures"].inc()
                raise
            return

        def work():
            try:
                self._write(step, host, meta)
            except BaseException as e:         # surfaced on next wait/save
                self._c["write_failures"].inc()
                self._error = e

        self._worker = threading.Thread(target=work, daemon=True)
        self._worker.start()

    def wait(self):
        """Drain the async writer and raise its failure once (then clear
        it: one failed snapshot does not poison later saves)."""
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint failed") from err

    # ------------------------------------------------------------- restore
    def _validate(self, step: int) -> Tuple[Dict[str, torch.Tensor], Dict]:
        """Load and fully validate one step; raises CheckpointCorruptError
        (FileNotFoundError for a step that does not exist)."""
        from repro_torch.optim import adamw
        d = self._step_dir(step)
        if not os.path.isdir(d):
            raise FileNotFoundError(f"no checkpoint for step {step} in "
                                    f"{self.dir}")
        try:
            with open(os.path.join(d, "meta.json")) as f:
                meta = json.load(f)
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
            with np.load(os.path.join(d, "arrays.npz")) as data:
                arrays = {k: data[k] for k in data.files}
        except FileNotFoundError as e:
            raise CheckpointCorruptError(
                f"step {step}: missing checkpoint file ({e})") from e
        except Exception as e:
            raise CheckpointCorruptError(
                f"step {step}: unreadable checkpoint ({e!r})") from e
        want = manifest.get("arrays", {})
        if set(want) != set(arrays):
            raise CheckpointCorruptError(
                f"step {step}: array set drifted from manifest "
                f"(missing {sorted(set(want) - set(arrays))[:3]}, "
                f"extra {sorted(set(arrays) - set(want))[:3]})")
        flat = {}
        for k, spec in want.items():
            a = arrays[k]
            if str(a.dtype) != _stored_dtype(spec["dtype"]) \
                    or list(a.shape) != spec["shape"]:
                raise CheckpointCorruptError(
                    f"step {step}: {k} is {a.dtype}{a.shape}, manifest "
                    f"says {spec['dtype']}{tuple(spec['shape'])}")
            if _array_digest(a) != spec["sha256"]:
                raise CheckpointCorruptError(
                    f"step {step}: {k} failed its sha256 check "
                    f"(bit rot / torn write)")
            flat[k] = _from_numpy(a, spec["dtype"])
        fp = adamw.tree_fingerprint(flat)
        if fp != manifest.get("tree_fingerprint"):
            raise CheckpointCorruptError(
                f"step {step}: tree fingerprint mismatch ({fp[:12]}... != "
                f"{str(manifest.get('tree_fingerprint'))[:12]}...)")
        return flat, meta

    def restore(self, step: Optional[int] = None, *,
                before: Optional[int] = None
                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """``({tree_name: tree of CPU tensors}, meta)``, fully validated.

        ``step=None`` restores the newest valid step, skipping (and
        logging) corrupt or torn ones; an explicit ``step`` must validate.
        ``before`` bounds that walk to steps strictly below it (the
        trainer's escalating rollback)."""
        if step is not None:
            with obs_trace.span("ckpt.restore", cat="ckpt", step=step):
                flat, meta = self._validate(step)
        else:
            candidates = [s for s in reversed(self.steps())
                          if before is None or s < before]
            if not candidates:
                raise FileNotFoundError(
                    f"no checkpoints in {self.dir}" +
                    (f" below step {before}" if before is not None else ""))
            flat = meta = None
            last_err: Optional[Exception] = None
            for s in candidates:
                try:
                    with obs_trace.span("ckpt.restore", cat="ckpt", step=s):
                        flat, meta = self._validate(s)
                    break
                except CheckpointCorruptError as e:
                    logger.warning("checkpoint: step %d invalid (%s): "
                                   "falling back to the previous step", s, e)
                    last_err = e
            if flat is None:
                raise CheckpointCorruptError(
                    f"every checkpoint in {self.dir} failed validation"
                ) from last_err
        self._c["restores"].inc()
        roots: Dict[str, Dict[str, Any]] = {}
        for k, v in flat.items():
            name, rest = k.split("/", 1)
            roots.setdefault(name, {})[rest] = v
        return {name: _unflatten(sub) for name, sub in roots.items()}, meta
