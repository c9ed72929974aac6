"""K4's plain version and the port's gather route against the JAX gather
computation (atol 1e-4, the ``tests/test_paged_attn_kernel.py``
tolerance), with null blocks, partial tables, padded query rows, sliding
windows and softcap; and the numpy block bookkeeping against the JAX
package's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro.serve import paged as jpaged  # noqa: E402
from repro_torch.kernels.sq_paged_attn import (  # noqa: E402
    sq_paged_attn, sq_paged_attn_k4)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.serve import paged as tpaged  # noqa: E402


def _setup(B=3, S=2, KV=2, G=2, hd=16, nb=4, block_size=4, n_ctx=None,
           seed=0, pool_dtype=np.float32):
    """Random pools + block tables covering ``n_ctx`` tokens per sequence
    (default: the full table), queries at the last S positions."""
    rng = np.random.default_rng(seed)
    num_blocks = 1 + B * nb
    P = num_blocks * block_size
    k_pool = rng.normal(size=(P, KV, hd)).astype(pool_dtype)
    v_pool = rng.normal(size=(P, KV, hd)).astype(pool_dtype)
    pos_pool = np.full(P, jattn.EMPTY_POS, np.int32)
    tables = np.zeros((B, nb), np.int32)
    n = n_ctx if n_ctx is not None else nb * block_size
    for b in range(B):
        blocks = 1 + b * nb + np.arange(-(-n // block_size))
        tables[b, :len(blocks)] = blocks
        for c, blk in enumerate(blocks):
            for j in range(block_size):
                if c * block_size + j < n:
                    pos_pool[blk * block_size + j] = c * block_size + j
    q = (rng.normal(size=(B, S, KV, G, hd)) * hd ** -0.5).astype(np.float32)
    q_pos = np.tile(np.arange(n - S, n), (B, 1)).astype(np.int32)
    return q, k_pool, v_pool, tables, pos_pool, q_pos


def _jax_gather(q, k_pool, v_pool, tables, pos_pool, q_pos, *, block_size,
                window=None, softcap=0.0):
    """The JAX package's gather read path (models/attention.py)."""
    idx = jattn.paged_gather_indices(jnp.asarray(tables), block_size)
    k = jnp.take(jnp.asarray(k_pool), idx, axis=0).astype(jnp.float32)
    v = jnp.take(jnp.asarray(v_pool), idx, axis=0).astype(jnp.float32)
    kv_pos = jnp.take(jnp.asarray(pos_pool), idx, axis=0)
    s = jnp.einsum("bqkgh,btkh->bkgqt", jnp.asarray(q), k)
    s = jattn._softcap(s, softcap)
    qp = jnp.asarray(q_pos)
    valid = (kv_pos[:, None, :] <= qp[:, :, None]) \
        & (kv_pos[:, None, :] < jattn.ATTEND_POS_LIMIT)
    if window is not None:
        valid &= (qp[:, :, None] - kv_pos[:, None, :]) < window
    s = jnp.where(valid[:, None, None], s, jattn.NEG_INF)
    w = jax.nn.softmax(s, axis=-1)
    return np.asarray(jnp.einsum("bkgqt,btkh->bqkgh", w, v))


CASES = {
    "full": dict(),
    "window": dict(window=5),
    "softcap": dict(softcap=2.0),
    "window+softcap": dict(window=3, softcap=1.5),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("n_ctx,pad", [(None, None), (9, None), (9, 1),
                                       (3, 2)])
def test_k4_plain_matches_jax_gather(case, n_ctx, pad):
    q, kp, vp, tb, pp, qpos = _setup(n_ctx=n_ctx)
    if pad is not None:
        qpos[pad, :] = -1                     # a fully padded sequence
    kw = CASES[case]
    out = sq_paged_attn(q, kp, vp, tb, pp, qpos, block_size=4,
                        device="cpu", **kw)
    ref = _jax_gather(q, kp, vp, tb, pp, qpos, block_size=4, **kw)
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)


def test_k4_plain_reads_bf16_pools():
    q, kp, vp, tb, pp, qpos = _setup(n_ctx=11)
    kb = torch.from_numpy(kp).to(torch.bfloat16)
    vb = torch.from_numpy(vp).to(torch.bfloat16)
    out = sq_paged_attn_k4(torch.from_numpy(q), kb, vb, torch.from_numpy(tb),
                           torch.from_numpy(pp), torch.from_numpy(qpos),
                           block_size=4)
    ref = _jax_gather(q, kb.float().numpy(), vb.float().numpy(), tb, pp, qpos,
                      block_size=4)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gather_route_matches_jax(case):
    """The port's gather route (standard einsums) is the JAX gather path."""
    q, kp, vp, tb, pp, qpos = _setup(n_ctx=10)
    kw = CASES[case]
    tq, tk, tv, tt, tpp, tqp = (torch.from_numpy(x)
                                for x in (q, kp, vp, tb, pp, qpos))
    idx = tattn.paged_gather_indices(tt, 4)
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(jattn.paged_gather_indices(jnp.asarray(tb),
                                                           4)))
    k, v, kv_pos = tk[idx].float(), tv[idx].float(), tpp[idx]
    valid = (kv_pos[:, None, :] <= tqp[:, :, None]) \
        & (kv_pos[:, None, :] < tattn.ATTEND_POS_LIMIT)
    if kw.get("window") is not None:
        valid &= (tqp[:, :, None] - kv_pos[:, None, :]) < kw["window"]
    s = tattn._softcap(torch.einsum("bqkgh,btkh->bkgqt", tq, k),
                       kw.get("softcap", 0.0))
    s = s.masked_fill(~valid[:, None, None], tattn.NEG_INF)
    out = torch.einsum("bkgqt,btkh->bqkgh", torch.softmax(s, dim=-1), v)
    np.testing.assert_allclose(out.numpy(), _jax_gather(
        q, kp, vp, tb, pp, qpos, block_size=4, **kw), atol=1e-4)


def test_paged_slots_match_jax():
    rng = np.random.default_rng(3)
    tables = rng.integers(1, 20, (3, 4)).astype(np.int32)
    positions = rng.integers(-1, 16, (3, 5)).astype(np.int32)
    got = tattn.paged_slots(torch.from_numpy(tables),
                            torch.from_numpy(positions), 4)
    want = jattn.paged_slots(jnp.asarray(tables), jnp.asarray(positions), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_block_bookkeeping_matches_jax():
    """The numpy copy of serve/paged.py behaves like the original under one
    seeded script of grow / evict / release calls."""
    rng = np.random.default_rng(0)
    ja, ta = jpaged.BlockAllocator(24, 4), tpaged.BlockAllocator(24, 4)
    jt = jpaged.BlockTables(ja, max_slots=4, blocks_per_seq=6)
    tt = tpaged.BlockTables(ta, max_slots=4, blocks_per_seq=6)
    for _ in range(200):
        slot = int(rng.integers(0, 4))
        op = rng.integers(0, 3)
        if op == 0:
            n = int(rng.integers(0, 25))
            assert jt.ensure(slot, n) == tt.ensure(slot, n)
        elif op == 1:
            pos, win = int(rng.integers(0, 24)), int(rng.integers(1, 9))
            assert jt.evict_window(slot, pos, win) == \
                tt.evict_window(slot, pos, win)
        else:
            assert jt.release(slot) == tt.release(slot)
        np.testing.assert_array_equal(jt.table, tt.table)
        assert ja.free_blocks == ta.free_blocks
    np.testing.assert_array_equal(jpaged.empty_pos_pool(5, 4),
                                  tpaged.empty_pos_pool(5, 4))


@pytest.mark.parametrize("batch,kv,nb,sms,want", [
    (8, 12, 8, 132, 8),      # the serving decode shape: one table block a split
    (8, 12, 64, 132, 8),     # 1024-token tables: 8 table blocks a split
    (4, 2, 3, 132, 3),       # fewer columns than the cluster size
    (64, 12, 8, 132, 2),     # a large batch fills the card with 2 splits
    (512, 32, 8, 132, 1),
    (8, 12, 0, 132, 1)])     # an empty table still launches one split
def test_k4_splits(batch, kv, nb, sms, want):
    from repro_torch.kernels.sq_paged_attn import k4_splits
    assert k4_splits(batch, kv, nb, sms) == want


def test_k4_smem_layout_matches_source():
    """The wrapper's shared-memory size: 3 stages of a K block (rows padded
    by 32 bytes) and a V block, f32 queries/accumulator/scores/row state,
    int32 positions and one split's table entries."""
    from repro_torch.kernels.sq_paged_attn import smem_bytes
    rows, bs, hd, cols = 1, 16, 64, 1
    pools = 3 * bs * (2 * hd * 2 + 32)
    floats = 2 * rows * hd + rows * bs + 12 * rows
    assert smem_bytes(rows, bs, hd, 2, cols) == pools + 4 * (
        floats + rows + 3 * bs + cols)
    assert smem_bytes(32, 16, 120, 4, 2) > smem_bytes(32, 16, 120, 2, 2)

