"""K1: the square-based GEMM kernel and its plain PyTorch version.

Replaces ``src/repro/kernels/sq_matmul.py::sq_matmul_kernel`` (the Pallas
TPU kernel behind ``sq_matmul_pallas``).  The CUDA source is
``src/repro_torch/csrc/sq_matmul.cu``; its header states what bounds it on
an H100 (the bytes of the widened weight at decode's 8 rows) and how its
design meets that.

Both versions take pre-widened operands, as the Pallas kernel does:
``aw`` (m, k) and ``bw`` (k, n) in f32 or int32, ``sa`` (m,) and ``sb`` (n,)
the row/column corrections, and return ``1/2 (Sa_i + Sb_j + sum_k
(a_ik + b_kj)^2)`` in the same dtype.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.core import squares as sq
from repro_torch.kernels import build

__all__ = ["sq_matmul_k1", "sq_matmul_plain"]

_DTYPE_CODES = {torch.float32: 0, torch.int32: 1}
_INT_MAX = 2 ** 31 - 1
_MAX_GRID_Y = 65535
_BN = 32                      # output columns per block, as in the source


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


def _check(aw, bw, sa, sb) -> None:
    if aw.dtype not in _DTYPE_CODES:
        raise TypeError(f"K1 takes f32 or int32 (pre-widened) operands, got "
                        f"{aw.dtype}")
    for name, t in (("bw", bw), ("sa", sa), ("sb", sb)):
        if t.dtype != aw.dtype:
            raise TypeError(f"K1 operand {name} is {t.dtype}, aw is "
                            f"{aw.dtype}")
        if t.device != aw.device:
            raise ValueError(f"K1 operand {name} is on {t.device}, aw on "
                             f"{aw.device}")
    if aw.ndim != 2 or bw.ndim != 2 or aw.shape[1] != bw.shape[0]:
        raise ValueError(f"K1 needs a (m, k) @ (k, n), got {tuple(aw.shape)} "
                         f"@ {tuple(bw.shape)}")
    m, n = aw.shape[0], bw.shape[1]
    if tuple(sa.shape) != (m,) or tuple(sb.shape) != (n,):
        raise ValueError(f"K1 corrections must be ({m},) and ({n},), got "
                         f"{tuple(sa.shape)} and {tuple(sb.shape)}")


def sq_matmul_k1(aw: torch.Tensor, bw: torch.Tensor, sa: torch.Tensor,
                 sb: torch.Tensor) -> torch.Tensor:
    """Launch K1 on CUDA tensors (the plain version on CPU tensors).

    ``sq_matmul_k1.launches`` counts the kernel launches made by this
    process, and ``sq_matmul_k1.shapes`` counts them by ``(m, k, n)``; a
    CPU call does not count.
    """
    _check(aw, bw, sa, sb)
    if aw.device.type == "cpu":
        return sq_matmul_plain(aw, bw, sa, sb)
    if aw.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA (or its plain version on CPU), "
                         f"got a tensor on {aw.device}")
    m, k = aw.shape
    n = bw.shape[1]
    if max(m * k, k * n, m * n) > _INT_MAX or -(-n // _BN) > _MAX_GRID_Y:
        raise ValueError(f"K1 shape ({m}, {k}) @ ({k}, {n}) exceeds the "
                         f"kernel's 32-bit indexing or grid limits")
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
                              out.data_ptr(), m, n, k, stream)
    build.check(lib, rc, "K1 sq_matmul launch")
    sq_matmul_k1.launches += 1
    sq_matmul_k1.shapes[(m, k, n)] += 1
    return out


sq_matmul_k1.launches = 0
sq_matmul_k1.shapes = collections.Counter()
