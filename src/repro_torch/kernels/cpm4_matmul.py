"""K6: the complex matmul with four squares per complex multiply (the
paper's CPM4, §6) and its plain PyTorch version.

:func:`cpm4_matmul_k6` replaces ``src/repro/kernels/cpm4_matmul.py::
cpm4_matmul_kernel`` (behind ``cpm4_matmul_pallas``).  The kernel lives in
``src/repro_torch/csrc/cpm4_matmul.cu``, whose header states what bounds it
on an H100; its schedule is K5's, ``csrc/cpm_tile.cuh``
(:func:`k6_launch_shape`).

It takes the four pre-widened f32 planes ``a``, ``b`` (m, k) and ``c``,
``s`` (k, n), the shared row correction ``sx = Sx`` (m,) and the shared
column correction ``sy = Sy`` (n,) (paper eq 18), and returns the planes of
``X @ Y``:

    re = 1/2 (Sx_h + sum_i [(a+c)^2 + (b-s)^2]) + 1/2 Sy_k
    im = 1/2 (Sx_h + sum_i [(b+c)^2 + (a+s)^2]) + 1/2 Sy_k

The kernel masks ragged m, n and k; integer planes raise a ``TypeError``,
as for K5 (:mod:`repro_torch.kernels.cpm3_matmul`).
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels.cpm3_matmul import (check_planes, cpm_launch_shape,
                                             launch_planes, plain_k_chunk)

__all__ = ["cpm4_matmul_k6", "cpm4_matmul_plain", "k6_launch_shape"]


K6_TILE = (4, 4)              # csrc/cpm4_matmul.cu: Cpm4::TILE_M, TILE_N


def k6_launch_shape(m: int, n: int) -> dict:
    """K6's launch: 4 x 4 outputs a thread (64 x 64 a block, two blocks an
    SM) where that grid has 128 blocks (:func:`cpm_launch_shape`)."""
    return cpm_launch_shape(m, n, K6_TILE)


def cpm4_matmul_plain(a, b, c, s, sx, sy, k_chunk=None):
    """K6's arithmetic in plain PyTorch: both accumulators start at ``Sx``,
    the negated plane ``-s`` is formed once, each slab of k adds its four
    squares per term, both planes are halved and ``Sy / 2`` added to each.
    Used for CPU tensors and as K6's reference on the card."""
    m, k = a.shape
    n = c.shape[1]
    kc = k_chunk or plain_k_chunk(m, n)
    ns = -s
    re = sx[:, None].expand(m, n).clone()
    im = re.clone()
    for k0 in range(0, k, kc):
        sl = slice(k0, k0 + kc)
        a3, b3 = a[:, sl, None], b[:, sl, None]
        c3, s3, ns3 = c[None, sl, :], s[None, sl, :], ns[None, sl, :]
        t1, t2 = a3 + c3, b3 + ns3                    # a + c, b - s
        t3, t4 = b3 + c3, a3 + s3                     # b + c, a + s
        re = re + torch.sum(t1 * t1 + t2 * t2, dim=1)
        im = im + torch.sum(t3 * t3 + t4 * t4, dim=1)
    return re * 0.5 + 0.5 * sy, im * 0.5 + 0.5 * sy


def cpm4_matmul_k6(a, b, c, s, sx, sy, plan=None):
    """Launch K6 on CUDA tensors (the plain version on CPU tensors); returns
    the (re, im) planes (m, n).  ``plan``: the thread tile (a
    :class:`~repro_torch.kernels.tuning.CpmPlan`; default the planner's).

    ``cpm4_matmul_k6.launches`` and ``cpm4_matmul_k6.shapes`` (by
    ``(m, k, n)``) count the launches of this process; a CPU call does not
    count.  ``cpm4_matmul_k6.last_shape`` is the last launch's tile and grid
    (:func:`k6_launch_shape`'s form), None before one.
    """
    planes = (a, b, c, s)
    check_planes("K6", planes, (sx,), (sy,))
    if a.device.type == "cpu":
        return cpm4_matmul_plain(a, b, c, s, sx, sy)
    return launch_planes("K6", "cpm4_matmul", cpm4_matmul_k6, K6_TILE,
                         planes, (sx, sy), plan)


cpm4_matmul_k6.launches = 0
cpm4_matmul_k6.shapes = collections.Counter()
cpm4_matmul_k6.last_shape = None
