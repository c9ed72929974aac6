"""Chunked vocab-fused cross-entropy: the PyTorch port of
``repro/train/loss.py``.

The (tokens, vocab) logits are never materialised whole: the loss loops
over sequence chunks, each computing ``chunk_hidden @ table.T`` (the site
``loss``) and its cross-entropy, so live memory is O(chunk * vocab).  A
Python loop stands in for the JAX ``lax.scan``, and each chunk is
rematerialised in the backward (:func:`repro_torch.core.counting.remat`,
where JAX uses ``jax.checkpoint``): one more vocab GEMM a chunk instead of
keeping every chunk's logits.  The recompute notes no contraction, so the
audit counts each chunk's GEMM once.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import counting
from repro_torch.core.einsum import fs_einsum
from repro_torch.core.prepared import PreparedOperand

__all__ = ["chunked_xent", "full_xent"]


def _f32_table(table):
    """The vocab table as f32, unless it arrives prepared (weight-
    stationary, already widened)."""
    if isinstance(table, PreparedOperand):
        return table
    return table.float()


def _chunk_xent(hidden, labels, mask, table, mode=None, policy=None):
    """hidden (T, D); labels (T,); mask (T,); table (V, D) f32 or prepared.
    Returns the chunk's summed nll and its count of correct argmaxes."""
    logits = fs_einsum("td,vd->tv", hidden.float(), table, mode=mode,
                       policy=policy, site="loss")
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels[:, None].long())[:, 0]
    nll = (lse - gold) * mask
    correct = (torch.argmax(logits, dim=-1) == labels) * mask
    return torch.sum(nll), torch.sum(correct)


def chunked_xent(hidden, labels, table, *, mask=None, chunk: int = 2048,
                 mode=None, policy=None):
    """Mean next-token cross-entropy without the full logits.

    hidden (B, S, D); labels (B, S) integer; table (V, D) (the tied LM
    head); mask (B, S) float, 0 where a position does not count.  Chunks
    run along the sequence axis, keeping the batch whole.  Returns
    ``(loss, {"acc", "tokens"})``.
    """
    B, S, D = hidden.shape
    c = min(chunk, S)
    pad = (-S) % c
    m = (torch.ones((B, S), dtype=torch.float32, device=hidden.device)
         if mask is None else mask.float())
    h, y = hidden, labels
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        y = F.pad(y, (0, pad))
        m = F.pad(m, (0, pad))
    tf = _f32_table(table)

    def body(hh, yy, mm):
        return _chunk_xent(hh.reshape(-1, D), yy.reshape(-1),
                           mm.reshape(-1), tf, mode, policy)

    body = counting.remat(body)       # recompute chunk logits in backward
    tot = torch.zeros((), device=hidden.device)
    corr = torch.zeros((), device=hidden.device)
    for i in range(h.shape[1] // c):
        sl = slice(i * c, (i + 1) * c)
        nll, ok = body(h[:, sl], y[:, sl], m[:, sl])
        tot = tot + nll
        corr = corr + ok
    denom = torch.clamp(torch.sum(m), min=1.0)
    return tot / denom, {"acc": corr / denom, "tokens": denom}


def full_xent(hidden, labels, table, *, mask=None, mode=None, policy=None):
    """Reference unchunked cross-entropy (tests)."""
    logits = fs_einsum("bsd,vd->bsv", hidden.float(), _f32_table(table),
                       mode=mode, policy=policy, site="loss")
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    m = (torch.ones(labels.shape, dtype=torch.float32,
                    device=hidden.device) if mask is None else mask.float())
    return torch.sum((lse - gold) * m) / torch.clamp(torch.sum(m), min=1.0)
