"""K1, K2, K3: the square-based GEMM kernels and their plain PyTorch
versions.

- K1 (:func:`sq_matmul_k1`) replaces ``src/repro/kernels/sq_matmul.py::
  sq_matmul_kernel`` (behind ``sq_matmul_pallas``): one (m, k) @ (k, n), a
  cluster of 8 blocks per output tile, one partial sum each
  (:func:`k1_launch_shape`); the cluster launch needs Hopper (``sm_90``).
- K2 (:func:`sq_matmul_k2`) replaces ``sq_matmul_batched_kernel`` (the
  ``fb == 1`` schedule of ``sq_matmul_batched_pallas``) and K3
  (:func:`sq_matmul_k3`) ``sq_matmul_folded_kernel`` (the ``fb > 1``
  schedule): one block of 8 warps per (element, row tile, column tile),
  warp p computing partial p (:func:`k2_launch_shape`,
  :func:`k3_launch_shape`).  On an H100 one schedule serves both regimes,
  so the two kernels share their body and launch rule and differ in name
  only; each is bit-identical to K1 on every element.

All three live in ``src/repro_torch/csrc/sq_matmul.cu``, whose header
states what bounds each on an H100 and how its design meets that.  Each
launch's tile is a plan of :mod:`repro_torch.kernels.tuning` (explicit,
cached or the model rule that :func:`k1_launch_shape` and
:func:`k2_launch_shape` state); no tile changes the summation order.

The kernels take pre-widened operands, as the Pallas kernels do: ``aw``
(m, k) and ``bw`` (k, n) in f32 or int32, ``sa`` (m,) and ``sb`` (n,) the
row/column corrections -- each with a leading batch axis for K2/K3 -- and
return ``1/2 (Sa_i + Sb_j + sum_k (a_ik + b_kj)^2)`` in the same dtype.
Folding is a schedule, not arithmetic, so K2 and K3 share one plain
version, :func:`sq_matmul_batched_plain`.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.core import squares as sq
from repro_torch.core import cost_model as cm
from repro_torch.kernels import build, meta, tuning

__all__ = ["sq_matmul_k1", "sq_matmul_k2", "sq_matmul_k3",
           "sq_matmul_plain", "sq_matmul_batched_plain", "k1_launch_shape",
           "k2_launch_shape", "k3_launch_shape"]

_DTYPE_CODES = {torch.float32: 0, torch.int32: 1}
_INT_MAX = 2 ** 31 - 1
_MAX_GRID_Y = _MAX_GRID_Z = 65535
_KS = 8                       # partial sums per output: K1's cluster, K2/K3's warps
# K2's and K3's tile rule (the model mode of kernels/tuning.py)
_TILE_MIN_BLOCKS = 96
_TILE_TALL_M = 32


def k1_launch_shape(m: int, n: int, rows: int = None) -> dict:
    """K1's launch for an (m, k) @ (k, n): one cluster of 8 blocks
    (partials 0..7) per output tile of ``rows`` x 64 columns (4 warps a
    block) at 8 rows or 32 x 128 (16 warps).  The rule (``rows=None``, the
    planner's model mode) takes 8 rows for m <= 8, else 32."""
    if rows is None:
        rows = 8 if m <= 8 else 32
    cols, warps = (64, 4) if rows == 8 else (128, 16)
    return {"rows": rows, "cols": cols, "warps": warps,
            "grid": (_KS * -(-n // cols), -(-m // rows)),
            "cluster": (_KS, 1, 1)}


def k2_launch_shape(nb: int, m: int, n: int, rows: int = None,
                    cols: int = None) -> dict:
    """K2's launch for a (nb, m, k) @ (nb, k, n): one block of 8 warps
    (partials 0..7) per (element, row tile, column tile), grid (nb, column
    tiles, row tiles), a tile ``rows`` (1, 4 or 8) x ``cols`` (32 or 64: 2
    a lane).  The rule (``None``, the planner's model mode): 1 row at m =
    1, 4 up to m = 32, else 8; 64 columns where n > 32 and that grid keeps
    96 blocks, else 32."""
    if rows is None:
        rows = 1 if m == 1 else 4 if m <= _TILE_TALL_M else 8
    row_tiles = -(-m // rows)
    if cols is None:
        wide = n > 32 and nb * row_tiles * -(-n // 64) >= _TILE_MIN_BLOCKS
        cols = 64 if wide else 32
    return {"rows": rows, "cols": cols, "warps": _KS,
            "grid": (nb, -(-n // cols), row_tiles)}


def k3_launch_shape(nb: int, m: int, n: int, rows: int = None,
                    cols: int = None) -> dict:
    """K3's launch: K2's (:func:`k2_launch_shape`), which on an H100 also
    serves the fold route's small-(m, n), large-B regime."""
    return k2_launch_shape(nb, m, n, rows, cols)


def sq_matmul_plain(aw: torch.Tensor, bw: torch.Tensor, sa: torch.Tensor,
                    sb: torch.Tensor, k_chunk: int = 16) -> torch.Tensor:
    """K1's arithmetic in plain PyTorch: the accumulator starts at
    ``Sa_i + Sb_j``, ``k_chunk``-wide slabs of squares are added, the sum
    is halved.  Used for CPU tensors and as K1's reference on the card."""
    k = aw.shape[1]
    acc = sa[:, None] + sb[None, :]
    for k0 in range(0, k, k_chunk):
        s = aw[:, k0:k0 + k_chunk, None] + bw[None, k0:k0 + k_chunk, :]
        acc = acc + torch.sum(s * s, dim=1, dtype=acc.dtype)
    return sq.halve(acc)


def sq_matmul_batched_plain(aw: torch.Tensor, bw: torch.Tensor,
                            sa: torch.Tensor, sb: torch.Tensor,
                            k_chunk: int = 16) -> torch.Tensor:
    """K1's plain arithmetic on every batch element: ``aw`` (B, m, k),
    ``bw`` (B, k, n), ``sa`` (B, m), ``sb`` (B, n).  Used for CPU tensors
    and as the reference of K2 and K3 on the card."""
    k = aw.shape[-1]
    acc = sa[:, :, None] + sb[:, None, :]
    for k0 in range(0, k, k_chunk):
        s = aw[:, :, k0:k0 + k_chunk, None] + bw[:, None, k0:k0 + k_chunk, :]
        acc = acc + torch.sum(s * s, dim=2, dtype=acc.dtype)
    return sq.halve(acc)


def _check_batched(aw, bw, sa, sb, what: str) -> None:
    _check_dtypes(aw, bw, sa, sb, what)
    if aw.ndim != 3 or bw.ndim != 3 or aw.shape[0] != bw.shape[0] \
            or aw.shape[2] != bw.shape[1]:
        raise ValueError(f"{what} needs a (B, m, k) @ (B, k, n), got "
                         f"{tuple(aw.shape)} @ {tuple(bw.shape)}")
    nb, m, _ = aw.shape
    n = bw.shape[2]
    if tuple(sa.shape) != (nb, m) or tuple(sb.shape) != (nb, n):
        raise ValueError(f"{what} corrections must be ({nb}, {m}) and "
                         f"({nb}, {n}), got {tuple(sa.shape)} and "
                         f"{tuple(sb.shape)}")


def _check_dtypes(aw, bw, sa, sb, what: str) -> None:
    if aw.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} takes f32 or int32 (pre-widened) operands, "
                        f"got {aw.dtype}")
    for name, t in (("bw", bw), ("sa", sa), ("sb", sb)):
        if t.dtype != aw.dtype:
            raise TypeError(f"{what} operand {name} is {t.dtype}, aw is "
                            f"{aw.dtype}")
        if t.device != aw.device:
            raise ValueError(f"{what} operand {name} is on {t.device}, aw on "
                             f"{aw.device}")


def _check(aw, bw, sa, sb) -> None:
    _check_dtypes(aw, bw, sa, sb, "K1")
    if aw.ndim != 2 or bw.ndim != 2 or aw.shape[1] != bw.shape[0]:
        raise ValueError(f"K1 needs a (m, k) @ (k, n), got {tuple(aw.shape)} "
                         f"@ {tuple(bw.shape)}")
    m, n = aw.shape[0], bw.shape[1]
    if tuple(sa.shape) != (m,) or tuple(sb.shape) != (n,):
        raise ValueError(f"K1 corrections must be ({m},) and ({n},), got "
                         f"{tuple(sa.shape)} and {tuple(sb.shape)}")


def sq_matmul_k1(aw: torch.Tensor, bw: torch.Tensor, sa: torch.Tensor,
                 sb: torch.Tensor, plan: tuning.K1Plan = None) -> torch.Tensor:
    """Launch K1 on CUDA tensors (the plain version on CPU tensors).

    ``plan``: the launch's tile (:class:`~repro_torch.kernels.tuning.K1Plan`;
    default the planner's, :func:`repro_torch.kernels.tuning.plan_matmul`).
    ``sq_matmul_k1.launches`` counts the kernel launches made by this
    process, and ``sq_matmul_k1.shapes`` counts them by ``(m, k, n)``; a
    CPU call does not count.  On ``meta`` tensors inside a
    :func:`repro_torch.kernels.meta.recording` (the dry run) it launches
    nothing: it records the launch and returns an empty output.
    """
    _check(aw, bw, sa, sb)
    if aw.device.type == "cpu":
        return sq_matmul_plain(aw, bw, sa, sb)
    m, k = aw.shape
    n = bw.shape[1]
    if aw.device.type == "meta" and meta.active():
        plan = tuning.plan_matmul(m, n, k, aw.dtype, plan=plan)
        meta.record("K1", (m, k, n), m * k * n, 2 * m * k * n,
                    cm.k1_cost(m, n, k, plan.rows, plan.cols,
                               aw.element_size()), aw.dtype)
        return torch.empty((m, n), dtype=aw.dtype, device="meta")
    if aw.device.type != "cuda":
        raise build.KernelError("K1 runs on CUDA (or its plain version on "
                                f"CPU), got a tensor on {aw.device}")
    plan = tuning.plan_matmul(m, n, k, aw.dtype, plan=plan)
    gx, gy = k1_launch_shape(m, n, plan.rows)["grid"]
    if max(m * k, k * n, m * n) > _INT_MAX or gx > _INT_MAX \
            or gy > _MAX_GRID_Y:
        raise build.KernelError(f"K1 shape ({m}, {k}) @ ({k}, {n}) exceeds "
                                "the kernel's 32-bit indexing or grid limits")
    out = torch.empty((m, n), dtype=aw.dtype, device=aw.device)
    if out.numel() == 0:
        return out
    aw, bw = aw.contiguous(), bw.contiguous()
    sa, sb = sa.contiguous(), sb.contiguous()
    lib = build.load("sq_matmul")
    with torch.cuda.device(aw.device):
        stream = torch.cuda.current_stream(aw.device).cuda_stream
        rc = lib.fs_sq_matmul(_DTYPE_CODES[aw.dtype], aw.data_ptr(),
                              bw.data_ptr(), sa.data_ptr(), sb.data_ptr(),
                              out.data_ptr(), m, n, k, plan.code, stream)
    build.check(lib, rc, "K1 sq_matmul launch")
    sq_matmul_k1.launches += 1
    sq_matmul_k1.shapes[(m, k, n)] += 1
    return out


sq_matmul_k1.launches = 0
sq_matmul_k1.shapes = collections.Counter()


def _batched(label: str, kind: str, entry: str, counter, aw, bw, sa, sb,
             plan) -> torch.Tensor:
    """Check, then launch K2 or K3 (the C entry point ``entry``) on CUDA
    tensors with the planner's (or the given) tile and count the launch on
    ``counter``, or run the plain version on CPU tensors."""
    _check_batched(aw, bw, sa, sb, label)
    if aw.device.type == "cpu":
        return sq_matmul_batched_plain(aw, bw, sa, sb)
    nb, m, k = aw.shape
    n = bw.shape[2]
    if aw.device.type == "meta" and meta.active():
        plan = tuning.plan_matmul(m, n, k, aw.dtype, batch=nb, kind=kind,
                                  plan=plan)
        meta.record(label, (nb, m, k, n), nb * m * k * n,
                    2 * nb * m * k * n,
                    cm.batched_cost(nb, m, n, k, plan.rows, plan.cols,
                                    aw.element_size()), aw.dtype)
        return torch.empty((nb, m, n), dtype=aw.dtype, device="meta")
    if aw.device.type != "cuda":
        raise build.KernelError(f"{label} runs on CUDA (or its plain version "
                                f"on CPU), got a tensor on {aw.device}")
    plan = tuning.plan_matmul(m, n, k, aw.dtype, batch=nb, kind=kind,
                              plan=plan)
    gx, gy, gz = k2_launch_shape(nb, m, n, plan.rows, plan.cols)["grid"]
    if max(m * k, k * n, m * n) > _INT_MAX or gx > _INT_MAX \
            or gy > _MAX_GRID_Y or gz > _MAX_GRID_Z:
        raise build.KernelError(f"{label} shape ({nb}, {m}, {k}) @ ({nb}, "
                                f"{k}, {n}) exceeds the kernel's 32-bit "
                                "indexing or grid limits")
    out = torch.empty((nb, m, n), dtype=aw.dtype, device=aw.device)
    if out.numel() == 0:
        return out
    aw, bw = aw.contiguous(), bw.contiguous()
    sa, sb = sa.contiguous(), sb.contiguous()
    lib = build.load("sq_matmul")
    with torch.cuda.device(aw.device):
        stream = torch.cuda.current_stream(aw.device).cuda_stream
        rc = getattr(lib, entry)(_DTYPE_CODES[aw.dtype], aw.data_ptr(),
                                 bw.data_ptr(), sa.data_ptr(), sb.data_ptr(),
                                 out.data_ptr(), nb, m, n, k, plan.rows,
                                 plan.cols // 32, stream)
    build.check(lib, rc, f"{label} launch")
    counter.launches += 1
    counter.shapes[(nb, m, k, n)] += 1
    return out


def sq_matmul_k2(aw: torch.Tensor, bw: torch.Tensor, sa: torch.Tensor,
                 sb: torch.Tensor, plan: tuning.BatchedPlan = None
                 ) -> torch.Tensor:
    """Launch K2 (the batched route: one 8-warp block per element, row
    tile and column tile, :func:`k2_launch_shape`) on CUDA tensors (the
    plain version on CPU tensors): ``aw`` (B, m, k), ``bw`` (B, k, n),
    ``sa`` (B, m), ``sb`` (B, n); ``plan`` the tile (default the
    planner's).

    ``sq_matmul_k2.launches`` counts the launches of this process and
    ``sq_matmul_k2.shapes`` counts them by ``(B, m, k, n)``; a CPU call
    does not count.
    """
    return _batched("K2", "sq_matmul_batched", "fs_sq_matmul_batched",
                    sq_matmul_k2, aw, bw, sa, sb, plan)


def sq_matmul_k3(aw: torch.Tensor, bw: torch.Tensor, sa: torch.Tensor,
                 sb: torch.Tensor, plan: tuning.BatchedPlan = None
                 ) -> torch.Tensor:
    """Launch K3 (the fold route, :func:`k3_launch_shape`) on CUDA tensors
    (the plain version on CPU tensors); operands as :func:`sq_matmul_k2`.

    ``sq_matmul_k3.launches`` and ``sq_matmul_k3.shapes`` count as K2's
    do.
    """
    return _batched("K3", "sq_matmul_folded", "fs_sq_matmul_folded",
                    sq_matmul_k3, aw, bw, sa, sb, plan)


sq_matmul_k2.launches = 0
sq_matmul_k2.shapes = collections.Counter()
sq_matmul_k3.launches = 0
sq_matmul_k3.shapes = collections.Counter()
