"""K5: the complex matmul with three squares per complex multiply (the
paper's CPM3, §9) and its plain PyTorch version.

:func:`cpm3_matmul_k5` replaces ``src/repro/kernels/cpm3_matmul.py::
cpm3_matmul_kernel`` (behind ``cpm3_matmul_pallas``).  The kernel lives in
``src/repro_torch/csrc/cpm3_matmul.cu``, whose header states what bounds it
on an H100; its schedule, shared with K6, is ``csrc/cpm_tile.cuh``: one
block of 16 x 16 threads per output tile, each thread a register tile of
every accumulator plane, the thread tile a plan of
:mod:`repro_torch.kernels.tuning` (model rule :func:`cpm_launch_shape`,
:func:`k5_launch_shape`).

It takes the four pre-widened f32 planes -- ``a``, ``b`` (m, k), the real
and imaginary planes of X, and ``c``, ``s`` (k, n), those of Y -- with the
row corrections ``sre = Sab`` and ``sim = Sba`` (m,) and the column
corrections ``scs = Scs`` and ``ssc = Ssc`` (n,) (paper eqs 33/35), and
returns the planes of ``X @ Y``:

    re = 1/2 (Sab_h + sum_i [(c+a+b)^2 - (b+c+s)^2]) + 1/2 Scs_k
    im = 1/2 (Sba_h + sum_i [(c+a+b)^2 + (a+s-c)^2]) + 1/2 Ssc_k

Nothing needs padding: the kernel masks ragged m, n and k.  Integer planes
raise a ``TypeError``: the Pallas kernel cannot compute them either (its
``acc * 0.5`` store fails on int32), and the exact integer complex matmul is
``core/complexmm.py``'s.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.core import cost_model as cm
from repro_torch.kernels import build, meta, tuning

__all__ = ["cpm3_matmul_k5", "cpm3_matmul_plain", "cpm_launch_shape",
           "k5_launch_shape"]

_INT_MAX = 2 ** 31 - 1
_MAX_GRID_Y = 65535
_PLAIN_CHUNK_ELEMS = 1 << 24  # bound on the plain version's live term tensors
# The tile rule of csrc/cpm_tile.cuh: a block is 16 x 16 threads, each a
# thread tile (rows, columns) of the outputs -- the kernel's own tile where
# its grid reaches _TILE_MIN_BLOCKS blocks, else _SMALL_TILE.
_BLOCK_THREADS = 16
_TILE_MIN_BLOCKS = 128
_SMALL_TILE = (1, 1)
K5_TILE = (8, 4)              # csrc/cpm3_matmul.cu: Cpm3::TILE_M, TILE_N


def _grid(m: int, n: int, tile) -> tuple:
    return (-(-m // (_BLOCK_THREADS * tile[0])),
            -(-n // (_BLOCK_THREADS * tile[1])))


def cpm_launch_shape(m: int, n: int, tile, thread_tile=None) -> dict:
    """The launch of K5 or K6 (own thread tile ``tile``) for an (m, k) @
    (k, n) with ``thread_tile`` (the own tile or (1, 1)).  ``rows`` x
    ``cols`` is a block's output tile and ``grid`` is (row tiles, column
    tiles).  The rule (``thread_tile=None``, the planner's model mode):
    the own tile where its grid has 128 blocks, else (1, 1)."""
    if thread_tile is None:
        tm, tn = tuple(tile)
        if _grid(m, n, (tm, tn))[0] * _grid(m, n, (tm, tn))[1] \
                < _TILE_MIN_BLOCKS:
            tm, tn = _SMALL_TILE
    else:
        tm, tn = tuple(thread_tile)
    grid = _grid(m, n, (tm, tn))
    return {"rows": _BLOCK_THREADS * tm, "cols": _BLOCK_THREADS * tn,
            "thread_tile": (tm, tn), "grid": grid}


def k5_launch_shape(m: int, n: int) -> dict:
    """K5's launch: 8 x 4 outputs a thread (128 x 64 a block) where that
    grid has 128 blocks (:func:`cpm_launch_shape`)."""
    return cpm_launch_shape(m, n, K5_TILE)


def plain_k_chunk(m: int, n: int) -> int:
    """The contraction slab of a plain version: enough of k that one
    (m, slab, n) term tensor stays within ``_PLAIN_CHUNK_ELEMS``."""
    return max(1, _PLAIN_CHUNK_ELEMS // max(1, m * n))


def cpm3_matmul_plain(a, b, c, s, sre, sim, scs, ssc, k_chunk=None):
    """K5's arithmetic in plain PyTorch: the accumulators start at ``Sab``
    and ``Sba``, the hoisted planes ``a+b``, ``c+s`` and ``s-c`` are formed
    once, each slab of k adds its three squares per term, both planes are
    halved and the column terms added.  Used for CPU tensors and as K5's
    reference on the card."""
    m, k = a.shape
    n = c.shape[1]
    kc = k_chunk or plain_k_chunk(m, n)
    ab, cs, sc = a + b, c + s, s - c
    re = sre[:, None].expand(m, n).clone()
    im = sim[:, None].expand(m, n).clone()
    for k0 in range(0, k, kc):
        sl = slice(k0, k0 + kc)
        t = ab[:, sl, None] + c[None, sl, :]          # c + a + b
        shared = t * t
        u = b[:, sl, None] + cs[None, sl, :]          # b + c + s
        v = a[:, sl, None] + sc[None, sl, :]          # a + s - c
        re = re + torch.sum(shared - u * u, dim=1)
        im = im + torch.sum(shared + v * v, dim=1)
    return re * 0.5 + 0.5 * scs, im * 0.5 + 0.5 * ssc


def check_planes(label: str, planes, row_corrs, col_corrs) -> None:
    """Raise unless ``planes`` = (a, b, c, s) are f32 (m, k), (m, k),
    (k, n), (k, n) on one device, with (m,) row and (n,) column
    corrections of the same dtype and device."""
    a = planes[0]
    if a.dtype != torch.float32:
        raise TypeError(f"{label} takes f32 (pre-widened) planes, got "
                        f"{a.dtype}; the exact integer complex matmul is "
                        f"repro_torch.core.complexmm's")
    named = list(zip("abcs", planes)) + [
        (f"row correction {i}", t) for i, t in enumerate(row_corrs)] + [
        (f"column correction {i}", t) for i, t in enumerate(col_corrs)]
    for name, t in named:
        if t.dtype != a.dtype:
            raise TypeError(f"{label} operand {name} is {t.dtype}, a is "
                            f"{a.dtype}")
        if t.device != a.device:
            raise ValueError(f"{label} operand {name} is on {t.device}, a "
                             f"on {a.device}")
    b, c, s = planes[1:]
    if a.ndim != 2 or c.ndim != 2 or a.shape != b.shape \
            or c.shape != s.shape or a.shape[1] != c.shape[0]:
        raise ValueError(f"{label} needs planes (m, k), (m, k), (k, n), "
                         f"(k, n), got {[tuple(p.shape) for p in planes]}")
    m, n = a.shape[0], c.shape[1]
    if any(tuple(t.shape) != (m,) for t in row_corrs) \
            or any(tuple(t.shape) != (n,) for t in col_corrs):
        raise ValueError(f"{label} corrections must be ({m},) and ({n},), "
                         f"got {[tuple(t.shape) for t in row_corrs]} and "
                         f"{[tuple(t.shape) for t in col_corrs]}")


def launch_planes(label: str, source: str, counter, tile, planes, corrs,
                  plan=None):
    """Launch the complex kernel of ``source`` (entry ``fs_<source>``, own
    thread tile ``tile``) on checked CUDA planes with the planner's (or the
    given) thread tile and count the launch on ``counter``, whose
    ``last_shape`` then holds the launch's tile and grid as the kernel
    reports them (in :func:`cpm_launch_shape`'s form); returns the (re,
    im) planes."""
    a, _, c, _ = planes
    if a.device.type == "meta" and meta.active():
        m, k = a.shape
        n = c.shape[1]
        plan = tuning.plan_cpm(source, m, n, k, plan=plan)
        squares, nplanes = (3, (3, 3)) if source == "cpm3_matmul" \
            else (4, (2, 2))
        meta.record(label, (m, k, n), squares * m * n * k, 8 * m * n * k,
                    cm.cpm_cost(m, n, k, plan.thread_tile, nplanes,
                                2 * squares, tile), a.dtype)
        return (torch.empty((m, n), dtype=a.dtype, device="meta"),
                torch.empty((m, n), dtype=a.dtype, device="meta"))
    if a.device.type != "cuda":
        raise build.KernelError(f"{label} runs on CUDA (or its plain version "
                                f"on CPU), got a tensor on {a.device}")
    m, k = a.shape
    n = c.shape[1]
    plan = tuning.plan_cpm(source, m, n, k, plan=plan)
    code = 0 if tuple(plan.thread_tile) == tuple(tile) else 1
    if max(m, n, k) > _INT_MAX or cpm_launch_shape(
            m, n, tile, plan.thread_tile)["grid"][1] > _MAX_GRID_Y:
        raise build.KernelError(f"{label} shape ({m}, {k}) @ ({k}, {n}) "
                                "exceeds the kernel's grid limits")
    re = torch.empty((m, n), dtype=a.dtype, device=a.device)
    im = torch.empty_like(re)
    if re.numel() == 0:
        return re, im
    args = [t.contiguous() for t in (*planes, *corrs)]
    lib = build.load(source)
    shape = (ctypes.c_int * 4)()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = getattr(lib, f"fs_{source}")(
            *(t.data_ptr() for t in args), re.data_ptr(), im.data_ptr(),
            m, n, k, code, stream, ctypes.addressof(shape))
    build.check(lib, rc, f"{label} {source} launch")
    counter.launches += 1
    counter.shapes[(m, k, n)] += 1
    gx, gy, tm, tn = shape
    counter.last_shape = {"rows": _BLOCK_THREADS * tm,
                          "cols": _BLOCK_THREADS * tn, "thread_tile": (tm, tn),
                          "grid": (gx, gy)}
    return re, im


def cpm3_matmul_k5(a, b, c, s, sre, sim, scs, ssc,
                   plan: tuning.CpmPlan = None):
    """Launch K5 on CUDA tensors (the plain version on CPU tensors); returns
    the (re, im) planes (m, n).  ``plan``: the thread tile (default the
    planner's, :func:`repro_torch.kernels.tuning.plan_cpm`).

    ``cpm3_matmul_k5.launches`` counts the kernel launches made by this
    process, and ``cpm3_matmul_k5.shapes`` counts them by ``(m, k, n)``; a
    CPU call does not count.  ``cpm3_matmul_k5.last_shape`` is the last
    launch's tile and grid (:func:`k5_launch_shape`'s form), None before one.
    """
    planes = (a, b, c, s)
    check_planes("K5", planes, (sre, sim), (scs, ssc))
    if a.device.type == "cpu":
        return cpm3_matmul_plain(a, b, c, s, sre, sim, scs, ssc)
    return launch_planes("K5", "cpm3_matmul", cpm3_matmul_k5, K5_TILE,
                         planes, (sre, sim, scs, ssc), plan)


cpm3_matmul_k5.launches = 0
cpm3_matmul_k5.shapes = collections.Counter()
cpm3_matmul_k5.last_shape = None
