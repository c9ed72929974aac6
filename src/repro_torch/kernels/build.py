"""Build and load the port's hand-written CUDA kernels.

Each source under ``src/repro_torch/csrc/`` holds one kernel, or a family
that shares its arithmetic (``sq_matmul.cu``: K1, K2 and K3), behind a
plain C interface: ``sq_paged_attn.cu`` (K4), ``cpm3_matmul.cu`` (K5),
``cpm4_matmul.cu`` (K6), ``sq_conv2d.cu`` (K7) and ``sq_conv.cu`` (K8) each
hold one.  At first use it is compiled by ``nvcc`` for ``sm_90a``
into a shared library under ``build/repro_torch_kernels/`` at the repo root
and loaded with :mod:`ctypes`.  The library's name carries a hash of the
source and the flags, so an edited source is rebuilt, never reused stale.

:func:`build` starts one ``nvcc`` per source at once and waits for all of
them, so a caller that needs every kernel (``chip_smoke.py``) pays for the
slowest build, not the sum.  Nothing is compiled when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["KERNEL_SOURCES", "NVCC_FLAGS", "BUILD_DIR", "build", "load",
           "check"]

KERNEL_SOURCES = ("sq_matmul", "sq_paged_attn", "cpm3_matmul", "cpm4_matmul",
                  "sq_conv2d", "sq_conv")

# No --use_fast_math: expf/tanhf stay the accurate versions.  -fmad is left at
# nvcc's default (on); each source states how its accumulation rounds.
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_TIMEOUT_S = 600

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "sq_matmul": {
        "fs_sq_matmul": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _P],
        "fs_sq_matmul_batched": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "fs_sq_matmul_folded": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
    "sq_paged_attn": {
        "fs_sq_paged_attn": [_I, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _I, _I,
                             ctypes.c_float, _I, _I, _I, _P],
    },
    "cpm3_matmul": {
        "fs_cpm3_matmul": [_P] * 10 + [_I, _I, _I, _P],
    },
    "cpm4_matmul": {
        "fs_cpm4_matmul": [_P] * 8 + [_I, _I, _I, _P],
    },
    "sq_conv2d": {
        "fs_sq_conv2d": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    },
    "sq_conv": {
        "fs_sq_conv": [_I, _P, _P, _P, _P, _I, _I, _P],
    },
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda/bin: "
                       "the CUDA kernels are built from source on first use")


def _library_path(name: str) -> Path:
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, all at once.

    Returns ``{name: nvcc output}`` for the sources compiled by this call
    (``-Xptxas=-v`` makes that output the register and shared-memory report).
    Raises if any build fails; no compiler process outlives the call.
    """
    names = list(names)
    for name in names:
        if name not in _SIGNATURES:
            raise ValueError(f"unknown kernel source {name!r}; expected one "
                             f"of {KERNEL_SOURCES}")
    with _LOCK:
        jobs = {}
        reports: Dict[str, str] = {}
        try:
            for name in names:
                lib = _library_path(name)
                if lib.exists():
                    continue
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                       str(_CSRC / f"{name}.cu")]
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
                jobs[name] = (proc, tmp, lib)
            for name, (proc, tmp, lib) in jobs.items():
                out, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed for {name}.cu "
                                       f"(exit {proc.returncode}):\n{out}")
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


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build([name])
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_library_path(name)))
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.fs_error_string.argtypes = [ctypes.c_int]
            lib.fs_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if code != 0:
        msg: Optional[bytes] = lib.fs_error_string(code)
        raise RuntimeError(f"{what}: CUDA error {code} "
                           f"({(msg or b'?').decode()})")
