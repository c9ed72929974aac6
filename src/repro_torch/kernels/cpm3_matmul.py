"""K5: the complex matmul with three squares per complex multiply (the
paper's CPM3, §9) and its plain PyTorch version.

:func:`cpm3_matmul_k5` replaces ``src/repro/kernels/cpm3_matmul.py::
cpm3_matmul_kernel`` (behind ``cpm3_matmul_pallas``).  The kernel lives in
``src/repro_torch/csrc/cpm3_matmul.cu``, whose header states what bounds it
on an H100 and how its design meets that.

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

import torch

from repro_torch.kernels import build

__all__ = ["cpm3_matmul_k5", "cpm3_matmul_plain"]

_INT_MAX = 2 ** 31 - 1
_MAX_GRID_Y = 65535
_BN = 32                      # output columns per block, as in the sources
_PLAIN_CHUNK_ELEMS = 1 << 24  # bound on the plain version's live term tensors


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


def launch_planes(label: str, source: str, counter, planes, corrs):
    """Launch the complex kernel of ``source`` (entry ``fs_<source>``) on
    checked CUDA planes and count the launch on ``counter``; returns the
    (re, im) planes."""
    a, _, c, _ = planes
    if a.device.type != "cuda":
        raise ValueError(f"{label} runs on CUDA (or its plain version on "
                         f"CPU), got a tensor on {a.device}")
    m, k = a.shape
    n = c.shape[1]
    if max(m, n, k) > _INT_MAX or -(-n // _BN) > _MAX_GRID_Y:
        raise ValueError(f"{label} shape ({m}, {k}) @ ({k}, {n}) exceeds "
                         f"the kernel's grid limits")
    re = torch.empty((m, n), dtype=a.dtype, device=a.device)
    im = torch.empty_like(re)
    if re.numel() == 0:
        return re, im
    args = [t.contiguous() for t in (*planes, *corrs)]
    lib = build.load(source)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = getattr(lib, f"fs_{source}")(
            *(t.data_ptr() for t in args), re.data_ptr(), im.data_ptr(),
            m, n, k, stream)
    build.check(lib, rc, f"{label} {source} launch")
    counter.launches += 1
    counter.shapes[(m, k, n)] += 1
    return re, im


def cpm3_matmul_k5(a, b, c, s, sre, sim, scs, ssc):
    """Launch K5 on CUDA tensors (the plain version on CPU tensors); returns
    the (re, im) planes (m, n).

    ``cpm3_matmul_k5.launches`` counts the kernel launches made by this
    process, and ``cpm3_matmul_k5.shapes`` counts them by ``(m, k, n)``; a
    CPU call does not count.
    """
    planes = (a, b, c, s)
    check_planes("K5", planes, (sre, sim), (scs, ssc))
    if a.device.type == "cpu":
        return cpm3_matmul_plain(a, b, c, s, sre, sim, scs, ssc)
    return launch_planes("K5", "cpm3_matmul", cpm3_matmul_k5, planes,
                         (sre, sim, scs, ssc))


cpm3_matmul_k5.launches = 0
cpm3_matmul_k5.shapes = collections.Counter()
