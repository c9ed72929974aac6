"""Build and load the port's hand-written CUDA kernels.

Each source under ``src/repro_torch/csrc/`` holds one kernel, or a family
that shares its arithmetic (``sq_matmul.cu``: K1, K2 and K3), behind a
plain C interface: ``sq_paged_attn.cu`` (K4), ``cpm3_matmul.cu`` (K5),
``cpm4_matmul.cu`` (K6), ``sq_conv2d.cu`` (K7) and ``sq_conv.cu`` (K8) each
hold one; ``cpm_tile.cuh`` is the schedule K5 and K6 share.  At first use a
source is compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``build/repro_torch_kernels/`` at the repo root and loaded with
:mod:`ctypes`.  The library's name carries a hash of the source, every
header under ``csrc/`` and the flags, so an edited source or header is
rebuilt, never reused stale.  The compiler's report (``-Xptxas=-v``:
registers, spills and shared memory per kernel) is kept beside the library
(:func:`report`, parsed by :func:`ptxas_usage`).

:func:`build` starts one ``nvcc`` per source at once and waits for all of
them, so a caller that needs every kernel (``chip_smoke.py``) pays for the
slowest build, not the sum.  Nothing is compiled when a module is imported.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional

__all__ = ["KERNEL_SOURCES", "NVCC_FLAGS", "BUILD_DIR", "KernelError", "build",
           "load", "bind", "check", "report", "ptxas_usage"]

KERNEL_SOURCES = ("sq_matmul", "sq_paged_attn", "cpm3_matmul", "cpm4_matmul",
                  "sq_conv2d", "sq_conv")

# No --use_fast_math: expf/tanhf stay the accurate versions.  -fmad is left at
# nvcc's default (on); each source states how its accumulation rounds.
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_TIMEOUT_S = 600


class KernelError(RuntimeError):
    """A hand-written kernel failed to build, to load or to launch: nvcc
    missing, failing or past its timeout, a library that does not load, a
    launch the kernel refuses on CUDA tensors (device, size, shared-memory
    or alignment limits its plain version does not have), or a CUDA error
    from the launch.  The serving engine never absorbs it into a request's
    status: it propagates."""


_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "sq_matmul": {
        "fs_sq_matmul": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "fs_sq_matmul_batched": [_I, _P, _P, _P, _P, _P] + [_I] * 6 + [_P],
        "fs_sq_matmul_folded": [_I, _P, _P, _P, _P, _P] + [_I] * 6 + [_P],
    },
    "sq_paged_attn": {
        "fs_sq_paged_attn": [_I, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _I, _I,
                             ctypes.c_float, _I, _I, _I, _P],
    },
    "cpm3_matmul": {
        "fs_cpm3_matmul": [_P] * 10 + [_I] * 4 + [_P, _P],
    },
    "cpm4_matmul": {
        "fs_cpm4_matmul": [_P] * 8 + [_I] * 4 + [_P, _P],
    },
    "sq_conv2d": {
        "fs_sq_conv2d": [_I, _P, _P, _P, _P] + [_I] * 15
                        + [_P, _L, _P, _L, _P, _P],
    },
    "sq_conv": {
        "fs_sq_conv": [_I, _P, _P, _P, _P, _I, _I, _P, _P],
    },
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelError("nvcc not found on PATH or under /usr/local/cuda/bin: "
                       "the CUDA kernels are built from source on first use")


def _library_path(name: str) -> Path:
    h = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, all at once.

    Returns ``{name: nvcc output}`` for the sources compiled by this call
    (``-Xptxas=-v`` makes that output the register and shared-memory report).
    Processes sharing the build directory take turns through a file lock,
    so a library another process is building is waited for, not rebuilt.
    Raises :class:`KernelError` if any build fails or runs past
    ``NVCC_TIMEOUT_S``; no compiler process outlives the call.
    """
    names = list(names)
    for name in names:
        if name not in _SIGNATURES:
            raise ValueError(f"unknown kernel source {name!r}; expected one "
                             f"of {KERNEL_SOURCES}")
    if all(_library_path(name).exists() for name in names):
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with _LOCK, open(BUILD_DIR / "build.lock", "w") as lock:
        # processes that share the build directory (the ranks of a world)
        # build one at a time; the lock goes with its holder's process
        fcntl.flock(lock, fcntl.LOCK_EX)
        jobs = {}
        reports: Dict[str, str] = {}
        try:
            for name in names:
                lib = _library_path(name)
                if lib.exists():
                    continue
                tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                       str(_CSRC / f"{name}.cu")]
                try:
                    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)
                except OSError as exc:
                    raise KernelError(f"nvcc did not start for {name}.cu: "
                                      f"{exc}") from exc
                jobs[name] = (proc, tmp, lib)
            for name, (proc, tmp, lib) in jobs.items():
                try:
                    out, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
                except subprocess.TimeoutExpired as exc:
                    raise KernelError(f"nvcc ran past {NVCC_TIMEOUT_S} s "
                                      f"for {name}.cu") from exc
                if proc.returncode != 0:
                    raise KernelError(f"nvcc failed for {name}.cu "
                                       f"(exit {proc.returncode}):\n{out}")
                lib.with_suffix(".ptxas.txt").write_text(out)
                os.replace(tmp, lib)
                reports[name] = out
        finally:
            for proc, tmp, _ in jobs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                if tmp.exists():
                    tmp.unlink()
        return reports


def bind(path, name: str) -> ctypes.CDLL:
    """Load the library at ``path`` with the C entries of source ``name``
    (:class:`KernelError` if it does not load or lacks an entry)."""
    try:
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.fs_error_string.argtypes = [ctypes.c_int]
        lib.fs_error_string.restype = ctypes.c_char_p
    except (OSError, AttributeError) as exc:
        raise KernelError(f"kernel library {path} of {name}.cu does not "
                          f"load: {exc}") from exc
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build([name])
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = bind(_library_path(name), name)
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if code != 0:
        msg: Optional[bytes] = lib.fs_error_string(code)
        raise KernelError(f"{what}: CUDA error {code} "
                           f"({(msg or b'?').decode()})")


def report(name: str) -> str:
    """The compiler's report of one source's build (built first if needed),
    whether this process or an earlier one built it."""
    build([name])
    return _library_path(name).with_suffix(".ptxas.txt").read_text()


def ptxas_usage(text: str) -> List[dict]:
    """``[{"entry", "registers", "spill_stores", "spill_loads"}]``, one per
    kernel entry of an ``-Xptxas=-v`` report, in the report's order."""
    rows: List[dict] = []
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            rows.append({"entry": entry.group(1)})
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        regs = re.search(r"Used (\d+) registers", line)
        if rows and spill:
            rows[-1]["spill_stores"] = int(spill.group(1))
            rows[-1]["spill_loads"] = int(spill.group(2))
        if rows and regs:
            rows[-1]["registers"] = int(regs.group(1))
    return rows
