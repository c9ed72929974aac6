"""K4: fused paged decode attention through the square PM datapath, and its
plain PyTorch version.

Replaces ``src/repro/kernels/sq_paged_attn.py::sq_paged_attn_kernel`` (the
Pallas TPU kernel behind ``sq_paged_attn``).  The CUDA source is
``src/repro_torch/csrc/sq_paged_attn.cu``; its header states what bounds it
on an H100 (the bytes of the K/V blocks and positions the table walk reads,
and at decode sizes the latency of one walk) and how its design meets that:
each table is split into up to 8 ranges walked by the blocks of one
thread-block cluster, combined in split order through distributed shared
memory (the count is a plan of :mod:`repro_torch.kernels.tuning`, whose
model rule is :func:`k4_splits`); a block is min(4, S*G) warps,
each owning query rows.  The cluster launch needs Hopper (``sm_90`` or
later).

Both versions compute, per sequence and kv-head over the block table:
scores ``1/2 (-sum q^2 - sum k^2 + sum (q + k)^2)``, an optional tanh
softcap, the absolute-position mask (``kv_pos <= q_pos``,
``kv_pos < attend_limit``, optional sliding window), softmax, and PV
``1/2 (-sum p^2 - sum v^2 + sum (p + v)^2)``.  A fully masked query row
(padding, ``q_pos = -1``) ends as a finite uniform average.
"""
from __future__ import annotations

import functools
from typing import Optional, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.core import cost_model as cm
from repro_torch.kernels import build, meta, tuning

__all__ = ["sq_paged_attn", "sq_paged_attn_k4", "sq_paged_attn_plain",
           "smem_bytes", "k4_splits"]

NEG_INF = -1e30
_POOL_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_MAX = 232448            # bytes of shared memory one H100 block may use
MAX_SPLITS = 8                # the portable cluster size, as in the source
_STAGES = 3                   # K/V copy stages, as in the source
_BLOCKS_PER_SM = 8            # blocks of min(4, rows) warps each


def _gather_index(tables: torch.Tensor, block_size: int) -> torch.Tensor:
    offs = torch.arange(block_size, device=tables.device)
    return (tables.long()[:, :, None] * block_size + offs).reshape(
        tables.shape[0], -1)


def sq_paged_attn_plain(q, k_pool, v_pool, tables, pos_pool, q_pos, *,
                        block_size: int, window: Optional[int] = None,
                        softcap: float = 0.0,
                        attend_limit: int = 2 ** 29) -> torch.Tensor:
    """K4's function in plain PyTorch over the gathered window: the same
    square-form scores and PV, with one softmax over the whole window in
    place of the kernel's online one.  Used for CPU tensors and as K4's
    reference on the card."""
    idx = _gather_index(tables, block_size)                  # (B, T)
    qf = q.float().permute(0, 2, 3, 1, 4)[..., :, None, :]   # (B,KV,G,S,1,hd)
    kk = k_pool[idx].float().permute(0, 2, 1, 3)[:, :, None, None]
    vv = v_pool[idx].float().permute(0, 2, 1, 3)[:, :, None, None]
    kv_pos = pos_pool[idx]                                   # (B, T)

    s = qf + kk                                              # (B,KV,G,S,T,hd)
    corr = -torch.sum(qf * qf, dim=-1) - torch.sum(kk * kk, dim=-1)
    sc = 0.5 * (corr + torch.sum(s * s, dim=-1))             # (B,KV,G,S,T)
    if softcap and softcap > 0.0:
        sc = torch.tanh(sc / softcap) * softcap
    qp = q_pos[:, :, None]
    valid = (kv_pos[:, None, :] <= qp) & (kv_pos[:, None, :] < attend_limit)
    if window is not None:
        valid &= (qp - kv_pos[:, None, :]) < window
    sc = sc.masked_fill(~valid[:, None, None], NEG_INF)
    p = torch.softmax(sc, dim=-1)[..., None]                 # (B,KV,G,S,T,1)

    s2 = p + vv
    corr2 = -torch.sum(p * p, dim=-2) - torch.sum(vv * vv, dim=-2)
    out = 0.5 * (corr2 + torch.sum(s2 * s2, dim=-2))         # (B,KV,G,S,hd)
    return out.permute(0, 3, 1, 2, 4).contiguous()


def smem_bytes(rows: int, block_size: int, hd: int, itemsize: int,
               cols: int) -> int:
    """Dynamic shared memory K4 needs (the layout in the CUDA source):
    ``_STAGES`` stages of a K block (rows padded by 32 bytes) and a V block
    in the pools' dtype of ``itemsize`` bytes, then f32 queries,
    accumulator, scores and per-row state, then int32 positions and the
    ``cols`` table entries of one split."""
    pools = _STAGES * block_size * (2 * hd * itemsize + 32)
    floats = 2 * rows * hd + rows * block_size + (4 + MAX_SPLITS) * rows
    return pools + 4 * (floats + rows + _STAGES * block_size + cols)


def k4_splits(batch: int, kv_heads: int, nb: int, sms: int) -> int:
    """How many ranges of table columns K4 walks each (sequence, kv-head)
    table in, one block and one cluster rank each: enough for about
    ``_BLOCKS_PER_SM`` blocks per SM, at most ``MAX_SPLITS`` and at most
    ``nb``.  Each split is a short, latency-bound walk, so more splits mean
    a shorter launch: the serving decode shape (8 sequences x 12 kv-heads,
    nb 8) on 132 SMs gets 8, one table block each."""
    want = -(-_BLOCKS_PER_SM * sms // max(1, batch * kv_heads))
    return max(1, min(MAX_SPLITS, nb, want))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(q, k_pool, v_pool, tables, pos_pool, q_pos, block_size) -> None:
    if q.ndim != 5 or q.dtype != torch.float32:
        raise ValueError(f"K4 queries must be (B, S, KV, G, hd) float32, got "
                         f"{tuple(q.shape)} {q.dtype}")
    B, S, KV, G, hd = q.shape
    if k_pool.dtype not in _POOL_CODES or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"K4 pools must share one dtype, float32 or "
                        f"bfloat16, got "
                        f"{k_pool.dtype} and {v_pool.dtype}")
    if k_pool.ndim != 3 or tuple(k_pool.shape[1:]) != (KV, hd) \
            or v_pool.shape != k_pool.shape:
        raise ValueError(f"K4 pools must be (P, {KV}, {hd}), got "
                         f"{tuple(k_pool.shape)} and {tuple(v_pool.shape)}")
    P = k_pool.shape[0]
    if P % block_size:
        raise ValueError(f"pool of {P} slots is not a whole number of "
                         f"{block_size}-token blocks")
    if tables.ndim != 2 or tables.shape[0] != B:
        raise ValueError(f"K4 tables must be ({B}, nb), got "
                         f"{tuple(tables.shape)}")
    if tuple(pos_pool.shape) != (P,) or tuple(q_pos.shape) != (B, S):
        raise ValueError(f"K4 positions must be ({P},) and ({B}, {S}), got "
                         f"{tuple(pos_pool.shape)} and {tuple(q_pos.shape)}")
    for name, t in (("tables", tables), ("pos_pool", pos_pool),
                    ("q_pos", q_pos)):
        if t.dtype != torch.int32:
            raise TypeError(f"K4 {name} must be int32, got {t.dtype}")
    for t in (k_pool, v_pool, tables, pos_pool, q_pos):
        if t.device != q.device:
            raise ValueError(f"K4 operands must share one device, got "
                             f"{t.device} and {q.device}")


def sq_paged_attn_k4(q, k_pool, v_pool, tables, pos_pool, q_pos, *,
                     block_size: int, window: Optional[int] = None,
                     softcap: float = 0.0, attend_limit: int = 2 ** 29,
                     plan: tuning.PagedAttnPlan = None) -> torch.Tensor:
    """Launch K4 on CUDA tensors (the plain version on CPU tensors).

    ``q``: (B, S, KV, G, hd) float32, pre-scaled by ``hd**-0.5``;
    ``k_pool``/``v_pool``: (P, KV, hd) in the model dtype, with this step's
    K/V already written; ``tables``: (B, nb) int32 block ids (0 = null
    block); ``pos_pool``: (P,) int32; ``q_pos``: (B, S) int32, -1 padding.
    ``plan``: the table splits (default the planner's,
    :func:`repro_torch.kernels.tuning.plan_paged_attn`).  Returns (B, S,
    KV, G, hd) float32.  ``sq_paged_attn_k4.launches`` counts the kernel
    launches.
    """
    _check(q, k_pool, v_pool, tables, pos_pool, q_pos, block_size)
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive or None, got {window}")
    if q.device.type == "cpu":
        return sq_paged_attn_plain(q, k_pool, v_pool, tables, pos_pool,
                                   q_pos, block_size=block_size,
                                   window=window, softcap=softcap,
                                   attend_limit=attend_limit)
    if q.device.type == "meta" and meta.active():
        B, S, KV, G, hd = q.shape
        nb = tables.shape[1]
        plan = tuning.plan_paged_attn(B, S, KV, G, hd, nb, block_size,
                                      k_pool.dtype, sms=cm.H100_SMS,
                                      plan=plan)
        smem = smem_bytes(S * G, block_size, hd, k_pool.element_size(),
                          -(-nb // plan.splits))
        terms = 2 * B * KV * S * G * nb * block_size * hd
        meta.record("K4", (B, S, KV, G, hd, nb, block_size), terms,
                    2 * terms, cm.paged_attn_cost(
                        B, S, KV, G, hd, nb, block_size, plan.splits, smem,
                        k_pool.element_size()), q.dtype)
        return torch.empty(q.shape, dtype=torch.float32, device="meta")
    if q.device.type != "cuda":
        raise build.KernelError("K4 runs on CUDA (or its plain version on "
                                f"CPU), got a tensor on {q.device}")
    B, S, KV, G, hd = q.shape
    nb = tables.shape[1]
    if hd % 8:
        raise build.KernelError("K4 copies K/V rows in 16-byte pieces of "
                                f"8 elements: head_dim {hd} is not a "
                                "multiple of 8")
    plan = tuning.plan_paged_attn(B, S, KV, G, hd, nb, block_size,
                                  k_pool.dtype, sms=_sm_count(q.device.index),
                                  plan=plan)
    splits = plan.splits
    smem = smem_bytes(S * G, block_size, hd, k_pool.element_size(),
                      -(-nb // splits))
    if smem > _SMEM_MAX:
        raise build.KernelError(f"K4 needs {smem} bytes of shared memory for "
                                f"S*G={S * G}, block_size={block_size}, "
                                f"hd={hd}, {nb} table columns; one block may "
                                f"use {_SMEM_MAX}")
    q, k_pool, v_pool = q.contiguous(), k_pool.contiguous(), v_pool.contiguous()
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise build.KernelError("K4 pools must start on a 16-byte boundary")
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    tables, pos_pool, q_pos = (tables.contiguous(), pos_pool.contiguous(),
                               q_pos.contiguous())
    lib = build.load("sq_paged_attn")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.fs_sq_paged_attn(
            _POOL_CODES[k_pool.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), tables.data_ptr(), pos_pool.data_ptr(),
            q_pos.data_ptr(), out.data_ptr(), B, S, KV, G, hd, nb,
            block_size, k_pool.shape[0] // block_size,
            0 if window is None else int(window), float(softcap or 0.0),
            int(attend_limit), splits, smem, stream)
    build.check(lib, rc, "K4 sq_paged_attn launch")
    sq_paged_attn_k4.launches += 1
    return out


sq_paged_attn_k4.launches = 0


def sq_paged_attn(q, k_pool, v_pool, tables, pos_pool, q_pos, *,
                  block_size: int, window: Optional[int] = None,
                  softcap: float = 0.0, attend_limit: int = 2 ** 29,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> torch.Tensor:
    """Fused paged attention (public entry point): ``softmax(q K^T) V``
    over block tables, on ``device`` (default: CUDA, which must be
    present; a CPU device runs the plain version).  Arguments as for
    :func:`sq_paged_attn_k4`."""
    dev = resolve_device(device)
    args = [torch.as_tensor(t).to(dev)
            for t in (q, k_pool, v_pool, tables, pos_pool, q_pos)]
    return sq_paged_attn_k4(*args, block_size=block_size, window=window,
                            softcap=softcap, attend_limit=attend_limit)
