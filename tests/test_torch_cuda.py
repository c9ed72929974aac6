"""The hand-written CUDA kernels against their plain PyTorch versions on the
card.  Every test here is marked ``cuda`` and skips without a GPU; the
file imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: K1/K2/K3 f32 |err| <= k * 2^-23 * (max|a| + max|b|)^2 (the
rounding of two different orders of square-form f32 sums), int32
bit-exact; K2 equal to K1 on every element and K3 equal to K2, bit for
bit (one summation order by construction), and K1's cluster schedule
equal to K2 at nb = 1 and to K3, bit for bit;
K4 |err| <= 1e-4
(``tests/test_paged_attn_kernel.py``'s tolerance); K7 and K8 f32
|err| <= K * 2^-23 * (max|x| + max|w|)^2 over their K = kh*kw*cin or n
terms per output (the same rounding argument as K1), int32 bit-exact; K5
and K6 f32 |err| <= 2 * k * 2^-23 * (max|a| + max|b| + max|c| + max|s|)^2
(a complex term squares sums of up to three planes, and each plane
accumulates two squares), and K5 against K6 within the sum of their two
bounds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import squares as sq  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.cpm3_matmul import (  # noqa: E402
    cpm3_matmul_k5, cpm3_matmul_plain, k5_launch_shape)
from repro_torch.kernels.cpm4_matmul import (  # noqa: E402
    cpm4_matmul_k6, cpm4_matmul_plain, k6_launch_shape)
from repro_torch.kernels import sq_conv as k8mod  # noqa: E402
from repro_torch.kernels import sq_conv2d as k7mod  # noqa: E402
from repro_torch.kernels.sq_conv import sq_conv_k8, sq_conv_plain  # noqa: E402
from repro_torch.kernels.sq_conv2d import (  # noqa: E402
    sq_conv2d_k7, sq_conv2d_plain)
from repro_torch.kernels.sq_matmul import (  # noqa: E402
    sq_matmul_batched_plain, sq_matmul_k1, sq_matmul_k2, sq_matmul_k3,
    sq_matmul_plain)
from repro_torch.kernels.sq_paged_attn import (  # noqa: E402
    k4_splits, sq_paged_attn_k4, sq_paged_attn_plain)
from repro_torch.models.attention import EMPTY_POS  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card "
                    "(run this file there, or python3 chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n", [(8, 768, 768), (32, 3072, 768),
                                   (1, 768, 32000), (13, 77, 45),
                                   (40, 1, 3)])
def test_k1_matches_plain_on_card(cuda_device, m, k, n):
    gen = torch.Generator().manual_seed(0)
    aw = torch.randn(m, k, generator=gen).to(torch.bfloat16).float()
    bw = (torch.randn(k, n, generator=gen) / k ** 0.5).to(
        torch.bfloat16).float()
    aw, bw = aw.to(cuda_device), bw.to(cuda_device)
    sa, sb = sq.row_correction(aw), sq.col_correction(bw)
    before = sq_matmul_k1.launches
    before_shape = sq_matmul_k1.shapes[(m, k, n)]
    out = sq_matmul_k1(aw, bw, sa, sb)
    torch.cuda.synchronize()
    assert sq_matmul_k1.launches == before + 1
    assert sq_matmul_k1.shapes[(m, k, n)] == before_shape + 1
    ref = sq_matmul_plain(aw, bw, sa, sb)
    tol = k * 2.0 ** -23 * (aw.abs().max() + bw.abs().max()).item() ** 2
    assert (out - ref).abs().max().item() <= tol

    ai = torch.randint(-128, 128, (m, k), generator=gen,
                       dtype=torch.int32).to(cuda_device)
    bi = torch.randint(-128, 128, (k, n), generator=gen,
                       dtype=torch.int32).to(cuda_device)
    si, sj = sq.row_correction(ai), sq.col_correction(bi)
    assert torch.equal(sq_matmul_k1(ai, bi, si, sj),
                       sq_matmul_plain(ai, bi, si, sj))


def _k1_three_ways(dev, m, k, n, seed):
    """K1, K2 at nb = 1 and K3 (one 8-warp block per tile, warp p = partial
    p) on the same f32 and int8 operands; each pair of results must be
    bit-identical."""
    gen = torch.Generator().manual_seed(seed)
    aw = torch.randn(m, k, generator=gen).to(torch.bfloat16).float()
    bw = (torch.randn(k, n, generator=gen) / k ** 0.5).to(
        torch.bfloat16).float()
    ai = torch.randint(-128, 128, (m, k), generator=gen, dtype=torch.int32)
    bi = torch.randint(-128, 128, (k, n), generator=gen, dtype=torch.int32)
    for a, b in ((aw, bw), (ai, bi)):
        a, b = a.to(dev), b.to(dev)
        sa, sb = sq.row_correction(a), sq.col_correction(b)
        o1 = sq_matmul_k1(a, b, sa, sb)
        o2 = sq_matmul_k2(a[None], b[None], sa[None], sb[None])[0]
        o3 = sq_matmul_k3(a[None], b[None], sa[None], sb[None])[0]
        torch.cuda.synchronize()
        assert torch.equal(o1, o2), (m, k, n, a.dtype)
        assert torch.equal(o1, o3), (m, k, n, a.dtype)
        if a.dtype == torch.int32:
            assert torch.equal(o1.double(), torch.matmul(a.double(),
                                                         b.double()))


@pytest.mark.parametrize("m", [1, 4, 8, 32])
@pytest.mark.parametrize("k,n", [(768, 768), (768, 3072), (3072, 768),
                                 (768, 32000)])
def test_k1_cluster_equals_bring_up_at_serving_shapes(cuda_device, m, k, n):
    _k1_three_ways(cuda_device, m, k, n, seed=5)


@pytest.mark.parametrize("m", [1, 3, 9, 33])
@pytest.mark.parametrize("n", [1, 31, 33, 769])
def test_k1_cluster_equals_bring_up_ragged(cuda_device, m, n):
    for k in (1, 7, 65, 3071):
        _k1_three_ways(cuda_device, m, k, n, seed=6)


@pytest.mark.parametrize("nb,m,k,n", [
    (12, 32, 64, 128), (12, 32, 128, 64),            # paged prefill chunk
    (12, 23, 64, 23), (12, 12, 12, 64),              # dense prefill
    (48, 1, 64, 128), (48, 1, 128, 64),              # dense decode
    (5, 7, 70, 33), (3, 40, 1, 3), (1, 9, 200, 65)])  # ragged
def test_k2_k3_match_plain_and_each_other_on_card(cuda_device, nb, m, k, n):
    gen = torch.Generator().manual_seed(3)
    aw = torch.randn(nb, m, k, generator=gen).to(torch.bfloat16).float()
    bw = torch.randn(nb, k, n, generator=gen).to(torch.bfloat16).float()
    ai = torch.randint(-128, 128, (nb, m, k), generator=gen,
                       dtype=torch.int32)
    bi = torch.randint(-128, 128, (nb, k, n), generator=gen,
                       dtype=torch.int32)
    for a, b in ((aw, bw), (ai, bi)):
        a, b = a.to(cuda_device), b.to(cuda_device)
        sa, sb = sq.row_correction(a), sq.col_correction(b, dim=-2)
        before = (sq_matmul_k2.launches, sq_matmul_k3.launches,
                  sq_matmul_k2.shapes[(nb, m, k, n)])
        o2 = sq_matmul_k2(a, b, sa, sb)
        o3 = sq_matmul_k3(a, b, sa, sb)
        torch.cuda.synchronize()
        assert (sq_matmul_k2.launches, sq_matmul_k3.launches,
                sq_matmul_k2.shapes[(nb, m, k, n)]) == tuple(
                    x + 1 for x in before)
        ref = sq_matmul_batched_plain(a, b, sa, sb)
        if a.dtype == torch.int32:
            assert torch.equal(o2, ref)
            assert torch.equal(o2.double(), torch.matmul(a.double(),
                                                         b.double()))
        else:
            tol = k * 2.0 ** -23 * (a.abs().max() + b.abs().max()).item() ** 2
            assert (o2 - ref).abs().max().item() <= tol
        assert torch.equal(o3, o2)                     # K3 = K2, bit for bit
        for e in range(nb):                            # K2 = K1 per element
            assert torch.equal(o2[e], sq_matmul_k1(a[e], b[e], sa[e], sb[e]))


def _k2_k3_against_k1(dev, nb, m, k, n, seed, b_offset=0):
    """K2 and K3 on the same f32 (from bf16) and int8 operands: K2 equal to
    K1 on every element and K3 equal to K2, bit for bit; f32 within
    k * 2^-23 * (max|a| + max|b|)^2 of the plain version, int8 exact; one
    launch counted on each.  ``b_offset`` elements shift b's storage, so an
    offset of 1 refuses the 8-byte loads of b."""
    gen = torch.Generator().manual_seed(seed)
    aw = torch.randn(nb, m, k, generator=gen).to(torch.bfloat16).float()
    bw = torch.randn(nb, k, n, generator=gen).to(torch.bfloat16).float()
    ai = torch.randint(-128, 128, (nb, m, k), generator=gen,
                       dtype=torch.int32)
    bi = torch.randint(-128, 128, (nb, k, n), generator=gen,
                       dtype=torch.int32)
    for a, b in ((aw, bw), (ai, bi)):
        a = a.to(dev)
        store = torch.empty(b_offset + b.numel(), dtype=b.dtype, device=dev)
        b = store[b_offset:].view(nb, k, n).copy_(b)
        assert b.is_contiguous() and b.data_ptr() % 8 == 4 * (b_offset % 2)
        sa, sb = sq.row_correction(a), sq.col_correction(b, dim=-2)
        key = (nb, m, k, n)
        before = (sq_matmul_k2.launches, sq_matmul_k3.launches,
                  sq_matmul_k2.shapes[key], sq_matmul_k3.shapes[key])
        o2 = sq_matmul_k2(a, b, sa, sb)
        o3 = sq_matmul_k3(a, b, sa, sb)
        torch.cuda.synchronize()
        assert (sq_matmul_k2.launches, sq_matmul_k3.launches,
                sq_matmul_k2.shapes[key], sq_matmul_k3.shapes[key]) == tuple(
                    x + 1 for x in before)
        assert torch.equal(o3, o2), (key, a.dtype)       # K3 = K2
        for e in range(nb):                              # K2 = K1 per element
            assert torch.equal(o2[e], sq_matmul_k1(a[e], b[e], sa[e], sb[e])), \
                (key, e, a.dtype)
        ref = sq_matmul_batched_plain(a, b, sa, sb)
        if a.dtype == torch.int32:
            assert torch.equal(o2, ref)
            assert torch.equal(o2.double(), torch.matmul(a.double(),
                                                         b.double()))
        else:
            tol = k * 2.0 ** -23 * (a.abs().max() + b.abs().max()).item() ** 2
            assert (o2 - ref).abs().max().item() <= tol, key


@pytest.mark.parametrize("m", [1, 5, 12, 33])
@pytest.mark.parametrize("k", [1, 7, 65, 200, 3071])
def test_k2_k3_ragged_k_and_rows_on_card(cuda_device, m, k):
    """Partials with no real term (k < 8), a 64-deep K tile cut short, and
    multi-chunk walks (k > 128), at 1-row, 4-row and 8-row tiles."""
    _k2_k3_against_k1(cuda_device, 4, m, k, 33, seed=7)


@pytest.mark.parametrize("nb", [1, 4, 48])
@pytest.mark.parametrize("n", [1, 3, 33, 127, 129])
def test_k2_k3_ragged_columns_on_card(cuda_device, nb, n):
    """Odd n takes the 4-byte loads of b; n = 33 and 129 leave one column in
    the last tile; nb = 48 widens the tile to 64 columns where n > 32."""
    _k2_k3_against_k1(cuda_device, nb, 5, 65, n, seed=8)
    _k2_k3_against_k1(cuda_device, nb, 1, 65, n, seed=9)


@pytest.mark.parametrize("nb,m,k,n", [(12, 32, 64, 128), (12, 32, 128, 64),
                                      (48, 1, 64, 128), (48, 1, 128, 64)])
def test_k2_k3_unaligned_b_on_card(cuda_device, nb, m, k, n):
    """b one element past an 8-byte boundary: the serving shapes through
    the 4-byte loads of b."""
    _k2_k3_against_k1(cuda_device, nb, m, k, n, seed=10, b_offset=1)


def test_square_pallas_attention_runs_k2_k3_on_card(cuda_device):
    """fs_einsum's batched contractions reach K2 and K3 on CUDA tensors."""
    from repro_torch.core.einsum import fs_einsum
    gen = torch.Generator().manual_seed(4)
    q = torch.randn(4, 1, 12, 1, 64, generator=gen).to(cuda_device)
    kc = torch.randn(4, 128, 12, 64, generator=gen).to(cuda_device)
    qc = torch.randn(1, 32, 12, 1, 64, generator=gen).to(cuda_device)
    before = (sq_matmul_k2.launches, sq_matmul_k3.launches)
    fold = fs_einsum("bqkgh,btkh->bkgqt", q, kc, mode="square_pallas")
    batched = fs_einsum("bqkgh,btkh->bkgqt", qc, kc[:1],
                        mode="square_pallas")
    torch.cuda.synchronize()
    assert (sq_matmul_k2.launches, sq_matmul_k3.launches) == (
        before[0] + 1, before[1] + 1)
    for out, x, y in ((fold, q, kc), (batched, qc, kc[:1])):
        want = torch.einsum("bqkgh,btkh->bkgqt", x, y)
        assert (out - want).abs().max().item() <= 64 * 2.0 ** -23 * (
            x.abs().max() + y.abs().max()).item() ** 2


def _k4_inputs(dev, B=4, S=3, KV=2, G=3, hd=64, nb=8, bs=16, n_ctx=70):
    rng = np.random.default_rng(0)
    P = (1 + B * nb) * bs
    pos_pool = np.full(P, EMPTY_POS, np.int32)
    tables = np.zeros((B, nb), np.int32)
    for b in range(B):
        blocks = 1 + b * nb + np.arange(-(-n_ctx // bs))
        tables[b, :len(blocks)] = blocks
        for c, blk in enumerate(blocks):
            for j in range(bs):
                if c * bs + j < n_ctx:
                    pos_pool[blk * bs + j] = c * bs + j
    q_pos = np.tile(np.arange(n_ctx - S, n_ctx), (B, 1)).astype(np.int32)
    q_pos[1, :] = -1                                   # a padded sequence
    arrays = (rng.normal(size=(B, S, KV, G, hd)) * hd ** -0.5,
              rng.normal(size=(P, KV, hd)), rng.normal(size=(P, KV, hd)))
    q, kp, vp = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                 for a in arrays)
    return q, kp, vp, *(torch.as_tensor(a, device=dev)
                        for a in (tables, pos_pool, q_pos))


@pytest.mark.parametrize("kw", [dict(), dict(window=20),
                                dict(softcap=2.0),
                                dict(window=33, softcap=1.5)],
                         ids=["full", "window", "softcap", "both"])
@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16])
def test_k4_matches_plain_on_card(cuda_device, kw, pool_dtype):
    q, kp, vp, tables, pos_pool, q_pos = _k4_inputs(cuda_device)
    kp, vp = kp.to(pool_dtype), vp.to(pool_dtype)
    before = sq_paged_attn_k4.launches
    out = sq_paged_attn_k4(q, kp, vp, tables, pos_pool, q_pos,
                           block_size=16, **kw)
    torch.cuda.synchronize()
    assert sq_paged_attn_k4.launches == before + 1
    ref = sq_paged_attn_plain(q, kp, vp, tables, pos_pool, q_pos,
                              block_size=16, **kw)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= 1e-4


def test_k4_refusals_on_card_are_kernel_errors(cuda_device):
    """A launch K4 refuses on CUDA tensors (a head_dim that is not a whole
    number of its 16-byte copies) is a KernelError, which the serving
    engine re-raises rather than retrying; nothing launches."""
    from repro_torch.kernels.build import KernelError
    q, kp, vp, tables, pos_pool, q_pos = _k4_inputs(cuda_device, hd=12)
    before = sq_paged_attn_k4.launches
    with pytest.raises(KernelError, match="multiple of 8"):
        sq_paged_attn_k4(q, kp, vp, tables, pos_pool, q_pos, block_size=16)
    assert sq_paged_attn_k4.launches == before


# (table columns, live tokens, S, G, hd, block size, options): every split
# shape K4 takes -- more columns than splits, a ragged split of columns, fewer
# columns than 8, a window that masks whole splits, 32 query rows (S = 8,
# G = 4), head_dim 120 and 16, 4-token blocks -- each with a padded sequence
K4_SPLIT_CASES = {
    "nb64": (64, 1000, 1, 1, 64, 16, {}),
    "nb13": (13, 200, 2, 2, 64, 16, {}),
    "nb3": (3, 40, 1, 1, 128, 16, {}),
    "nb64-window": (64, 1000, 1, 1, 64, 16, dict(window=40)),
    "S8G4": (16, 250, 8, 4, 64, 16, {}),
    "S8G4-window-softcap": (16, 250, 8, 4, 120, 16,
                            dict(window=70, softcap=30.0)),
    "bs4-hd16": (11, 41, 2, 2, 16, 4, dict(softcap=5.0)),
    # ragged splits of 2 or 3 columns; 2 query rows over 5 columns a split
    "nb21": (21, 330, 1, 1, 64, 16, {}),
    "nb40-rows2": (40, 600, 1, 2, 64, 16, dict(window=100)),
}


def _attn_f64(q, kp, vp, tables, pos_pool, q_pos, *, block_size,
              window=None, softcap=0.0):
    """K4's function in float64 with the multiplier: the reference where
    the plain version's own f32 rounding reaches the tolerance."""
    idx = (tables.long()[:, :, None] * block_size
           + torch.arange(block_size, device=tables.device)).reshape(
               tables.shape[0], -1)
    k = kp[idx].double().permute(0, 2, 1, 3)[:, :, None]   # (B,KV,1,T,hd)
    v = vp[idx].double().permute(0, 2, 1, 3)[:, :, None]
    s = q.double().permute(0, 2, 3, 1, 4) @ k.transpose(-1, -2)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    kv_pos, qp = pos_pool[idx][:, None, :], q_pos[:, :, None]
    valid = (kv_pos <= qp) & (kv_pos < 2 ** 29)
    if window is not None:
        valid &= (qp - kv_pos) < window
    s = s.masked_fill(~valid[:, None, None], -1e30)
    return (torch.softmax(s, dim=-1) @ v).permute(0, 3, 1, 2, 4)


@pytest.mark.parametrize("case", sorted(K4_SPLIT_CASES))
@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16])
def test_k4_split_schedule_matches_plain_on_card(cuda_device, case,
                                                 pool_dtype):
    """Within 1e-4 of a float64 reference in every case, and of the plain
    version up to 256-token tables.  The plain version's PV sums
    (p + v)^2 over the whole window in f32, where the squares of unit
    values add up to ~T: at T = 1000 its own rounding reaches the
    tolerance on these inputs, so there the float64 reference decides."""
    nb, n_ctx, S, G, hd, bs, kw = K4_SPLIT_CASES[case]
    q, kp, vp, tables, pos_pool, q_pos = _k4_inputs(
        cuda_device, S=S, G=G, hd=hd, nb=nb, bs=bs, n_ctx=n_ctx)
    kp, vp = kp.to(pool_dtype), vp.to(pool_dtype)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert k4_splits(4, 2, nb, sms) == min(8, nb)
    before = sq_paged_attn_k4.launches
    out = sq_paged_attn_k4(q, kp, vp, tables, pos_pool, q_pos,
                           block_size=bs, **kw)
    torch.cuda.synchronize()
    assert sq_paged_attn_k4.launches == before + 1
    exact = _attn_f64(q, kp, vp, tables, pos_pool, q_pos, block_size=bs,
                      **kw)
    assert torch.isfinite(out).all()
    assert (out.double() - exact).abs().max().item() <= 1e-4
    if nb * bs <= 256:
        ref = sq_paged_attn_plain(q, kp, vp, tables, pos_pool, q_pos,
                                  block_size=bs, **kw)
        assert (out - ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("mode", ["standard", "square_virtual",
                                  "square_pallas"])
def test_int8_matmul_modes_exact_on_card(cuda_device, mode):
    from repro_torch.core import matmul as tmm
    gen = torch.Generator().manual_seed(1)
    a = torch.randint(-128, 128, (9, 300), generator=gen).to(torch.int8)
    b = torch.randint(-128, 128, (300, 70), generator=gen).to(torch.int8)
    want = a.int() @ b.int()                          # CPU int32 matmul
    got = tmm.matmul(a.to(cuda_device), b.to(cuda_device), mode=mode)
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), want)



@pytest.mark.parametrize("spec,xs,ys", [
    ("mk,kn->mn", (9, 300), (300, 70)),
    ("bmk,bkn->bmn", (3, 9, 300), (3, 300, 70))])
@pytest.mark.parametrize("preferred", [None, torch.int32])
def test_standard_einsum_int8_on_card(cuda_device, spec, xs, ys, preferred):
    """CUDA has no integer einsum: fs_einsum's standard mode must still
    return the CPU's (and jnp.einsum's) dtype and values, bit for bit."""
    from repro_torch.core.einsum import fs_einsum
    gen = torch.Generator().manual_seed(7)
    x = torch.randint(-128, 128, xs, generator=gen).to(torch.int8)
    y = torch.randint(-128, 128, ys, generator=gen).to(torch.int8)
    want = fs_einsum(spec, x, y, mode="standard", preferred=preferred)
    got = fs_einsum(spec, x.to(cuda_device), y.to(cuda_device),
                    mode="standard", preferred=preferred)
    assert got.device.type == "cuda"
    assert got.dtype == want.dtype == (preferred or torch.int8)
    assert torch.equal(got.cpu(), want)


def test_prepared_bit_identical_to_raw_on_card(cuda_device):
    from repro_torch.core import matmul as tmm
    from repro_torch.core.prepared import prepare_operand
    gen = torch.Generator().manual_seed(2)
    a = torch.randn(8, 768, generator=gen).to(torch.bfloat16).to(cuda_device)
    w = (torch.randn(32000, 768, generator=gen) / 768 ** 0.5).to(
        torch.bfloat16).to(cuda_device)
    prep = prepare_operand(w.float(), transpose=True)
    before = sq_matmul_k1.launches
    out_prep = tmm.matmul(a, prep, mode="square_pallas")
    out_raw = tmm.matmul(a, w.float().T, mode="square_pallas")
    assert sq_matmul_k1.launches == before + 2
    assert torch.equal(out_prep, out_raw)


# (B, cin, H, W, cout, kh, kw, stride, padding): odd sizes, SAME, explicit
# asymmetric pads, stride 2, ragged cin/cout, and small ResNet-like layers
K7_CASES = [
    (2, 3, 17, 13, 5, 3, 3, 1, "SAME"),
    (1, 5, 15, 18, 7, 3, 3, 2, "SAME"),
    (2, 7, 10, 11, 3, 3, 5, 1, ((2, 0), (0, 3))),
    (1, 3, 9, 23, 5, 5, 3, (2, 1), "VALID"),
    (2, 3, 29, 29, 64, 7, 7, 2, 3),
    (2, 64, 14, 14, 70, 3, 3, 1, 1),
    (1, 130, 7, 7, 129, 1, 1, 1, 0),
    (3, 1, 8, 8, 1, 8, 8, 1, "VALID"),
    (1, 256, 9, 9, 96, 3, 3, 1, 1),                  # K walk split 16 ways
    (2, 37, 11, 9, 33, 3, 3, 1, "SAME"),             # 2 splits, ragged last
]


def _conv_ref_int(x, w, stride, pads):
    from repro_torch.core.conv import conv2d_nchw
    return conv2d_nchw(x, w, stride, pads, torch.int32)


@pytest.mark.parametrize("case", K7_CASES, ids=lambda c: "x".join(
    str(v) for v in c[:7]) + f"-s{c[7]}-p{c[8]}")
def test_k7_matches_plain_on_card(cuda_device, case):
    from repro_torch.core import conv as cc
    B, C, H, W, N, kh, kw, stride, padding = case
    strides = cc.resolve_stride(stride)
    pads = cc.resolve_padding(padding, (H, W), (kh, kw), strides)
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.normal(size=(B, C, H, W)), dtype=torch.float32)
    w = torch.as_tensor(rng.normal(size=(N, C, kh, kw)) / (C * kh * kw) ** .5,
                        dtype=torch.float32)
    xi = torch.as_tensor(rng.integers(-128, 128, (B, C, H, W)),
                         dtype=torch.int32)
    wi = torch.as_tensor(rng.integers(-128, 128, (N, C, kh, kw)),
                         dtype=torch.int32)
    for xs, ws in ((x, w), (xi, wi)):
        xs, ws = xs.to(cuda_device), ws.to(cuda_device)
        wt, sw, _ = ops.prepare_conv2d_weights(ws)
        before = sq_conv2d_k7.launches
        out = sq_conv2d_k7(xs, wt, sw, khw=(kh, kw), stride=strides,
                           pads=pads)
        torch.cuda.synchronize()
        assert sq_conv2d_k7.launches == before + 1
        ref = sq_conv2d_plain(xs, wt, sw, (kh, kw), strides, pads)
        assert out.shape == ref.shape
        if xs.dtype == torch.int32:
            assert torch.equal(out, ref)
            assert torch.equal(out, _conv_ref_int(xs, ws, strides, pads))
        else:
            tol = C * kh * kw * 2.0 ** -23 * (
                xs.abs().max() + ws.abs().max()).item() ** 2
            assert torch.isfinite(out).all()
            assert (out - ref).abs().max().item() <= tol


@pytest.mark.parametrize("L,n", [(1 << 20, 16), (5000, 127), (4097, 255),
                                 (300, 1), (64, 64), (1000, 300),
                                 (2049, 3)])
def test_k8_matches_plain_on_card(cuda_device, L, n):
    rng = np.random.default_rng(8)
    x = torch.as_tensor(rng.normal(size=L), dtype=torch.float32)
    w = torch.as_tensor(rng.normal(size=n), dtype=torch.float32)
    xi = torch.as_tensor(rng.integers(-128, 128, L), dtype=torch.int32)
    wi = torch.as_tensor(rng.integers(-128, 128, n), dtype=torch.int32)
    for xs, ws in ((x, w), (xi, wi)):
        xs, ws = xs.to(cuda_device), ws.to(cuda_device)
        sw = sq.col_correction(ws, dim=0).reshape(1)
        before = sq_conv_k8.launches
        out = sq_conv_k8(xs, ws, sw)
        torch.cuda.synchronize()
        assert sq_conv_k8.launches == before + 1
        ref = sq_conv_plain(xs, ws, sw)
        assert out.shape == (L - n + 1,)
        if xs.dtype == torch.int32:
            assert torch.equal(out, ref)
            exact = np.correlate(xi.numpy().astype(np.int64),
                                 wi.numpy().astype(np.int64), "valid")
            assert np.array_equal(out.cpu().numpy(), exact)
        else:
            tol = n * 2.0 ** -23 * (xs.abs().max()
                                    + ws.abs().max()).item() ** 2
            assert (out - ref).abs().max().item() <= tol


# Each branch of K7's tile rule (kernels/sq_conv2d.py::k7_launch_shape):
# band 8, a wider divisor of ow (14, 15), ow itself below 8, a band that
# does not divide ow (23 -> 8), the pixels-a-tile guard (24 x 24 filter),
# 16-byte and single-column windows (W % 4), split and unsplit K walks,
# ragged channels, odd sizes, every stride and padding form
K7_TIER_CASES = [
    ((2, 5, 16, 16), (7, 5, 3, 3), 1, "SAME"),
    ((1, 20, 28, 28), (33, 20, 3, 3), 1, 1),
    ((2, 9, 14, 14), (65, 9, 3, 3), 2, 1),
    ((3, 17, 7, 7), (70, 17, 3, 3), 1, "SAME"),
    ((1, 3, 23, 23), (4, 3, 3, 3), 1, "SAME"),
    ((1, 2, 24, 24), (3, 2, 24, 24), 1, "VALID"),
    ((2, 6, 30, 30), (9, 6, 7, 7), 2, 3),
    ((2, 19, 13, 11), (5, 19, 1, 1), (1, 2), ((0, 1), (2, 0))),
    ((8, 16, 56, 56), (64, 16, 3, 3), 1, 1),
]


@pytest.mark.parametrize("case", K7_TIER_CASES, ids=lambda c: "x".join(
    map(str, c[0] + c[1][:1] + c[1][2:])))
def test_k7_tile_tiers_on_card(cuda_device, case):
    """f32 within the bound of the plain version; int8 bit-exact, equal to
    the plain version and to the im2col route; each launch as the mirror
    says."""
    from repro_torch.core import conv as cc
    xs, ws, stride, padding = case
    strides = cc.resolve_stride(stride)
    pads = cc.resolve_padding(padding, xs[2:], ws[2:], strides)
    sms = torch.cuda.get_device_properties(
        cuda_device).multi_processor_count
    rng = np.random.default_rng(11)
    x = torch.as_tensor(rng.normal(size=xs), dtype=torch.float32)
    w = torch.as_tensor(rng.normal(size=ws) / (ws[1] * ws[2] * ws[3]) ** .5,
                        dtype=torch.float32)
    xi = torch.as_tensor(rng.integers(-128, 128, xs), dtype=torch.int32)
    wi = torch.as_tensor(rng.integers(-128, 128, ws), dtype=torch.int32)
    for x_, w_ in ((x, w), (xi, wi)):
        x_, w_ = x_.to(cuda_device), w_.to(cuda_device)
        wt, sw, _ = ops.prepare_conv2d_weights(w_)
        out = sq_conv2d_k7(x_, wt, sw, khw=ws[2:], stride=strides, pads=pads)
        torch.cuda.synchronize()
        assert sq_conv2d_k7.last_shape == k7mod.k7_launch_shape(
            xs, ws[0], ws[2:], strides, pads, sms)
        ref = sq_conv2d_plain(x_, wt, sw, ws[2:], strides, pads)
        if x_.dtype == torch.int32:
            assert torch.equal(out, ref)
            assert torch.equal(out, _conv_ref_int(x_, w_, strides, pads))
            assert torch.equal(out, ops.sq_conv2d_im2col(
                x_, w_, stride=stride, padding=padding))
        else:
            tol = ws[1] * ws[2] * ws[3] * 2.0 ** -23 * (
                x_.abs().max() + w_.abs().max()).item() ** 2
            assert torch.isfinite(out).all()
            assert (out - ref).abs().max().item() <= tol


def test_k7_split_layer_is_deterministic_on_card(cuda_device):
    """At a layer whose K walk is split 8 ways, two launches are equal bit
    for bit (the splits are added in split order, whichever finishes
    last), and prepared filters give the raw filters' result bit for
    bit."""
    from repro_torch.core.conv import conv2d
    from repro_torch.core.prepared import prepare_operand
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(1, 256, 14, 14, generator=gen).to(cuda_device)
    w = (torch.randn(256, 256, 3, 3, generator=gen) / 48).to(cuda_device)
    wt, sw, _ = ops.prepare_conv2d_weights(w)
    runs = [sq_conv2d_k7(x, wt, sw, khw=(3, 3), stride=(1, 1),
                         pads=((1, 1), (1, 1))) for _ in range(2)]
    torch.cuda.synchronize()
    assert sq_conv2d_k7.last_shape["grid"][2] == 8
    assert torch.equal(runs[0], runs[1])
    raw = conv2d(x, w, padding=1, mode="square_pallas")
    prep = conv2d(x, prepare_operand(w, for_="conv2d"), padding=1,
                  mode="square_pallas")
    assert torch.equal(raw, prep) and torch.equal(raw, runs[0])


@pytest.mark.parametrize("n", [1, 3, 16, 127, 255, 300])
def test_k8_ragged_lengths_on_card(cuda_device, n):
    """L not a multiple of a block's 2048 outputs (nor of 4), taps below,
    at and past the 256-tap chunk: f32 within the bound, int8 exact, the
    launch as the mirror says."""
    L = 3 * 2048 + 777 + n
    rng = np.random.default_rng(n)
    x = torch.as_tensor(rng.normal(size=L), dtype=torch.float32)
    w = torch.as_tensor(rng.normal(size=n) / n ** .5, dtype=torch.float32)
    xi = torch.as_tensor(rng.integers(-128, 128, L), dtype=torch.int32)
    wi = torch.as_tensor(rng.integers(-128, 128, n), dtype=torch.int32)
    for xs, ws in ((x, w), (xi, wi)):
        xs, ws = xs.to(cuda_device), ws.to(cuda_device)
        sw = sq.col_correction(ws, dim=0).reshape(1)
        out = sq_conv_k8(xs, ws, sw)
        torch.cuda.synchronize()
        assert sq_conv_k8.last_shape == k8mod.k8_launch_shape(L, n)
        ref = sq_conv_plain(xs, ws, sw)
        if xs.dtype == torch.int32:
            assert torch.equal(out, ref)
        else:
            tol = n * 2.0 ** -23 * (xs.abs().max()
                                    + ws.abs().max()).item() ** 2
            assert (out - ref).abs().max().item() <= tol


_SANITIZED = """
import sys, torch
sys.path.insert(0, "src")
from repro_torch.kernels import ops
from repro_torch.kernels.sq_conv2d import sq_conv2d_k7
from repro_torch.kernels.sq_conv import sq_conv_k8
g = torch.Generator().manual_seed(0)
for xs, ws, st, pads in [((2, 20, 28, 28), (16, 20, 3, 3), (2, 2), ((1, 1), (1, 1))),
                         ((1, 32, 7, 7), (8, 32, 3, 3), (1, 1), ((1, 1), (1, 1))),
                         ((1, 17, 16, 16), (9, 17, 1, 1), (1, 1), ((0, 0), (0, 0)))]:
    x = torch.randn(xs, generator=g).cuda()
    wt, sw, _ = ops.prepare_conv2d_weights(torch.randn(ws, generator=g).cuda())
    sq_conv2d_k7(x, wt, sw, khw=ws[2:], stride=st, pads=pads)
for L, n in [(5000, 16), (3000, 300)]:
    x, w = torch.randn(L, generator=g).cuda(), torch.randn(n, generator=g).cuda()
    sq_conv_k8(x, w, -(w * w).sum().reshape(1))
torch.cuda.synchronize()
print("launched", sq_conv2d_k7.launches, sq_conv_k8.launches)
"""


@pytest.mark.parametrize("tool", ["racecheck", "synccheck"])
def test_conv_copy_rings_under_compute_sanitizer(cuda_device, tool):
    """K7's cp.async rings and K8's staging at small shapes under
    compute-sanitizer: no hazard.  Where the tool cannot run the program on
    this host, the test skips with the tool's own words."""
    import shutil
    import subprocess
    import sys
    from pathlib import Path
    exe = shutil.which("compute-sanitizer") or \
        "/usr/local/cuda/bin/compute-sanitizer"
    if not Path(exe).exists():
        pytest.skip("compute-sanitizer is not installed on this host")
    root = Path(__file__).resolve().parents[1]
    from repro_torch.kernels import build
    build.build(["sq_conv2d", "sq_conv"])      # outside the tool
    proc = subprocess.run([exe, "--tool", tool, sys.executable, "-c",
                           _SANITIZED], cwd=root, capture_output=True,
                          text=True, timeout=600)
    text = proc.stdout + proc.stderr
    if "launched 3 2" not in text:
        pytest.skip(f"compute-sanitizer --tool {tool} could not run the "
                    f"kernels here (exit {proc.returncode}): "
                    f"{text.strip()[-600:]}")
    import re
    assert proc.returncode == 0, text[-3000:]
    assert re.search(r"SUMMARY: 0 ", text), text[-3000:]
    assert not re.search(r"\b[1-9]\d* (hazard|error)", text), text[-3000:]


def test_conv_kernels_never_reach_plain_on_card(cuda_device, monkeypatch):
    """A CUDA tensor launches K7/K8 through every entry point: with the
    plain versions made to raise, the conv path still runs."""
    from repro_torch.core.conv import conv2d
    from repro_torch.core.prepared import prepare_operand

    def boom(*a, **k):
        raise AssertionError("plain version reached with CUDA tensors")

    monkeypatch.setattr(k7mod, "sq_conv2d_plain", boom)
    monkeypatch.setattr(k8mod, "sq_conv_plain", boom)
    x = torch.randn(2, 16, 12, 12, device=cuda_device)
    w = torch.randn(24, 16, 3, 3, device=cuda_device)
    before = (sq_conv2d_k7.launches, sq_conv_k8.launches)
    raw = conv2d(x, w, padding="SAME", mode="square_pallas")
    prep = conv2d(x, prepare_operand(w, for_="conv2d"), padding="SAME",
                  mode="square_pallas")
    ops.sq_conv(torch.randn(100, device=cuda_device),
                torch.randn(9, device=cuda_device))
    torch.cuda.synchronize()
    assert (sq_conv2d_k7.launches, sq_conv_k8.launches) == (
        before[0] + 2, before[1] + 1)
    assert torch.equal(raw, prep)


def _cpm_planes(dev, m, k, n, seed=0):
    """Four non-zero planes, each at its own scale, and both kernels'
    corrections (paper eqs 33/35 and 18)."""
    rng = np.random.default_rng(seed)
    a, b, c, s = (torch.as_tensor(rng.normal(size=shape) * sc,
                                  dtype=torch.float32).to(dev)
                  for shape, sc in (((m, k), 1.0), ((m, k), 0.5),
                                    ((k, n), 2.0), ((k, n), 0.25)))
    k5 = ((-(a + b) ** 2 + b ** 2).sum(1), (-(a + b) ** 2 - a ** 2).sum(1),
          (-c ** 2 + (c + s) ** 2).sum(0), (-c ** 2 - (s - c) ** 2).sum(0))
    k6 = (-(a ** 2 + b ** 2).sum(1), -(c ** 2 + s ** 2).sum(0))
    tol = 2 * k * 2.0 ** -23 * sum(t.abs().max().item()
                                   for t in (a, b, c, s)) ** 2
    return (a, b, c, s), k5, k6, tol


@pytest.mark.parametrize("m,k,n", [(4096, 1024, 1024), (64, 64, 64),
                                   (1, 100, 33), (37, 1, 5), (19, 130, 1),
                                   (128, 257, 96), (17, 65, 31),
                                   # across the tile edges, unaligned rows
                                   (129, 1024, 65), (128, 1023, 64),
                                   (1, 1, 1),
                                   # own and 1 x 1 thread tiles, ragged
                                   (1100, 33, 1030), (1030, 36, 1100),
                                   (500, 21, 510), (520, 36, 260)])
def test_k5_k6_match_plain_on_card(cuda_device, m, k, n):
    planes, k5, k6, tol = _cpm_planes(cuda_device, m, k, n)
    outs = {}
    for name, kern, plain, corr, launch_shape in (
            ("K5", cpm3_matmul_k5, cpm3_matmul_plain, k5, k5_launch_shape),
            ("K6", cpm4_matmul_k6, cpm4_matmul_plain, k6, k6_launch_shape)):
        before, before_shape = kern.launches, kern.shapes[(m, k, n)]
        re, im = kern(*planes, *corr)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        assert kern.shapes[(m, k, n)] == before_shape + 1
        assert kern.last_shape == launch_shape(m, n), name
        pre, pim = plain(*planes, *corr)
        assert re.shape == im.shape == (m, n)
        assert torch.isfinite(re).all() and torch.isfinite(im).all()
        assert (re - pre).abs().max().item() <= tol, name
        assert (im - pim).abs().max().item() <= tol, name
        outs[name] = (re, im)
    for p in (0, 1):
        assert (outs["K5"][p] - outs["K6"][p]).abs().max().item() <= 2 * tol


def test_k5_k6_unaligned_planes_on_card(cuda_device):
    """Planes that start 4 bytes past a 16-byte boundary (contiguous views)
    take the kernels' scalar copies at their own thread tiles and still
    match the plain versions."""
    m, k, n = 1030, 36, 1100
    planes, k5, k6, tol = _cpm_planes(cuda_device, m, k, n)
    shifted = []
    for p in planes:
        view = torch.empty(p.numel() + 1, device=cuda_device)[1:].view(
            p.shape)
        view.copy_(p)
        assert view.is_contiguous() and view.data_ptr() % 16 == 4
        shifted.append(view)
    for name, kern, plain, corr, launch_shape in (
            ("K5", cpm3_matmul_k5, cpm3_matmul_plain, k5, k5_launch_shape),
            ("K6", cpm4_matmul_k6, cpm4_matmul_plain, k6, k6_launch_shape)):
        re, im = kern(*shifted, *corr)
        torch.cuda.synchronize()
        assert kern.last_shape == launch_shape(m, n)
        assert kern.last_shape["thread_tile"] == (
            (8, 4) if name == "K5" else (4, 4))
        pre, pim = plain(*planes, *corr)
        assert (re - pre).abs().max().item() <= tol, name
        assert (im - pim).abs().max().item() <= tol, name


def test_k5_k6_wide_rows_on_card(cuda_device):
    """A row of 1.5M columns: more than 65535 column tiles of the 1 x 1
    thread tile, within the grid limit at each kernel's own tile, which the
    rule takes there."""
    m, k, n = 1, 2, 1_500_000
    planes, k5, k6, tol = _cpm_planes(cuda_device, m, k, n)
    for name, kern, plain, corr, launch_shape in (
            ("K5", cpm3_matmul_k5, cpm3_matmul_plain, k5, k5_launch_shape),
            ("K6", cpm4_matmul_k6, cpm4_matmul_plain, k6, k6_launch_shape)):
        re, im = kern(*planes, *corr)
        torch.cuda.synchronize()
        assert kern.last_shape == launch_shape(m, n)
        assert kern.last_shape["grid"][1] == -(-n // 64), name
        pre, pim = plain(*planes, *corr)
        assert (re - pre).abs().max().item() <= tol, name
        assert (im - pim).abs().max().item() <= tol, name


def test_k5_k6_refuse_int_planes_on_card(cuda_device):
    planes = [torch.ones(3, 4, dtype=torch.int32, device=cuda_device)] * 2 \
        + [torch.ones(4, 2, dtype=torch.int32, device=cuda_device)] * 2
    rows = torch.zeros(3, dtype=torch.int32, device=cuda_device)
    cols = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    before = (cpm3_matmul_k5.launches, cpm4_matmul_k6.launches)
    with pytest.raises(TypeError, match="f32"):
        cpm3_matmul_k5(*planes, rows, rows, cols, cols)
    with pytest.raises(TypeError, match="f32"):
        cpm4_matmul_k6(*planes, rows, cols)
    with pytest.raises(TypeError, match="f32"):
        ops.cpm3_matmul(np.ones((3, 4), np.int8), np.ones((4, 2), np.int8))
    assert (cpm3_matmul_k5.launches, cpm4_matmul_k6.launches) == before


def test_complex_ops_launch_k5_k6_on_card(cuda_device, monkeypatch):
    """ops.cpm3_matmul / cpm4_matmul on numpy operands run on the card
    through one K5 / K6 launch, never the plain versions, and match
    ``x @ y``."""
    from repro_torch.kernels import cpm3_matmul as k5mod
    from repro_torch.kernels import cpm4_matmul as k6mod

    def boom(*a, **k):
        raise AssertionError("plain version reached with CUDA tensors")

    monkeypatch.setattr(k5mod, "cpm3_matmul_plain", boom)
    monkeypatch.setattr(k6mod, "cpm4_matmul_plain", boom)
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(70, 300)) + 1j * rng.normal(size=(70, 300))
         ).astype(np.complex64)
    y = (rng.normal(size=(300, 45)) + 1j * rng.normal(size=(300, 45))
         ).astype(np.complex64)
    z = x.astype(np.complex128) @ y
    for f, kern in ((ops.cpm3_matmul, cpm3_matmul_k5),
                    (ops.cpm4_matmul, cpm4_matmul_k6)):
        before = kern.launches
        re, im = f(x, y)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        assert re.device.type == "cuda"
        np.testing.assert_allclose(re.cpu().numpy(), z.real, rtol=1e-3,
                                   atol=1e-3 * 300)
        np.testing.assert_allclose(im.cpu().numpy(), z.imag, rtol=1e-3,
                                   atol=1e-3 * 300)


# ---------------------------------------------------- the compiled step
# The counterparts of tests/test_compiled_guard.py's audit and engine tests
# (the JAX package jits; the port captures CUDA graphs).  The reduced
# fairsquare-demo (2 layers, d 64, f32) under square_pallas and the
# square_gemms policy: K1 on its larger GEMMs, K4 on decode attention
# (128-token tables).
COMPILED_KW = dict(max_slots=4, block_size=16, num_blocks=40,
                   blocks_per_seq=8, prefill_chunk=16, max_new_tokens=6,
                   prepared=True)


@pytest.fixture
def compiled_world(cuda_device):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SQUARE_GEMMS_POLICY
    from repro_torch.core import guards
    from repro_torch.kernels import routing
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.lm import build_model
    cfg = dataclasses.replace(get_config("fairsquare-demo").reduced(),
                              matmul_mode="square_pallas",
                              contraction_policy=SQUARE_GEMMS_POLICY)
    routing.reset_route_health()
    guards.clear_pending_trips()
    yield build_model(cfg, device=cuda_device, seed=0), \
        make_requests(cfg, 4, seed=0)
    routing.reset_route_health()
    guards.clear_pending_trips()


def _serve(model, reqs, device, **kw):
    from repro_torch.serve.engine import Engine, EngineConfig
    from repro_torch.serve.server import Request
    eng = Engine(model, EngineConfig(**COMPILED_KW, **kw), device=device)
    out = eng.run([Request(r.rid, r.tokens) for r in reqs])
    assert all(r.ok for r in out.values())
    return eng, {rid: r.tokens for rid, r in out.items()}


def test_compiled_guarded_engine_clean_run_matches_eager_on_card(
        cuda_device, compiled_world):
    """guard=True on a compiled engine (the CUDA default): probes in the
    graphs, drained after every call; a clean run has 0 trips and 0
    re-captures, 3 captures, and the eager engine's tokens."""
    model, reqs = compiled_world
    _, base = _serve(model, reqs, cuda_device, jit=False)
    eng, toks = _serve(model, reqs, cuda_device, guard=True)
    assert eng._jit and eng.captures == 3
    assert toks == base
    assert eng.metrics.guard_trips == eng.metrics.guard_rejits == 0


def test_compiled_engine_recaptures_and_recovers_on_card(cuda_device,
                                                         compiled_world):
    """A pending probe trip and a demotion seeded before the run: the
    first drain finds it, the route epoch moved, so ``_guarded_call``
    re-captures and retries, and the tokens equal a clean run's."""
    from repro_torch.core import guards
    from repro_torch.kernels import routing
    model, reqs = compiled_world
    _, base = _serve(model, reqs, cuda_device, jit=False)
    from repro_torch.serve.engine import Engine, EngineConfig
    from repro_torch.serve.server import Request
    eng = Engine(model, EngineConfig(guard=True, **COMPILED_KW),
                 device=cuda_device)
    key = routing.health_key("synthetic_probe", (1, 2, 256, 1024),
                             torch.float32)
    guards.emit_trace_probe(key, torch.full((1,), float("nan"),
                                            device=cuda_device))
    routing.route_health().record_trip(key, limit=1)
    epoch0 = eng._route_epoch
    out = eng.run([Request(r.rid, r.tokens) for r in reqs])
    assert {rid: r.tokens for rid, r in out.items()} == base
    assert eng.metrics.guard_trips >= 1 and eng.metrics.guard_rejits >= 1
    assert eng._route_epoch > epoch0


def test_ledger_launches_equal_the_profiler_on_card(cuda_device,
                                                    compiled_world):
    """The captured decode call's ledger counts exactly the K1 and K4
    kernels a profiler sees in its replays (CUPTI records kernels inside
    graphs), and each replay adds the ledger's counts to the wrappers'."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.engine import Engine, EngineConfig
    model, reqs = compiled_world
    eng = Engine(model, EngineConfig(**COMPILED_KW), device=cuda_device)
    eng.submit(reqs)
    while "_decode" not in eng._graph_set.calls:
        assert eng.step()
    graph = eng._graph_set.calls["_decode"]
    want = {k.__name__: n for k, n, _ in graph.ledger.launches}
    assert want.get("sq_matmul_k1", 0) > 0 and want.get(
        "sq_paged_attn_k4", 0) == model.cfg.n_layers
    k1, k4 = sq_matmul_k1.launches, sq_paged_attn_k4.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert sum("sq_matmul_cluster_kernel" in n for n in names) \
        == 3 * want["sq_matmul_k1"]
    assert sum("sq_paged_attn_kernel" in n for n in names) \
        == 3 * want["sq_paged_attn_k4"]
    assert sq_matmul_k1.launches == k1 + 3 * want["sq_matmul_k1"]
    assert sq_paged_attn_k4.launches == k4 + 3 * want["sq_paged_attn_k4"]


def test_compiled_audit_counts_every_replay_on_card(cuda_device):
    """N replays of a call captured under ``compiled_audit`` tally N times
    its volume; a capture outside the audit tallies nothing; an eager
    ``track_contractions`` around replays alone sees nothing and warns."""
    import warnings
    from repro_torch.core import counting, graphs
    from repro_torch.core.einsum import fs_einsum

    def fn(a, b):
        return fs_einsum("mk,kn->mn", a, b, mode="square_virtual",
                         site="ffn")

    x = torch.ones(4, 8, device=cuda_device)
    w = torch.ones(8, 2, device=cuda_device)
    with counting.compiled_audit():
        f = graphs.CapturedCall(fn, (x, w), device=cuda_device)
    with counting.track_compiled_contractions() as ctr:
        for _ in range(3):
            f.replay()
    assert ctr.total_mults == 3 * 4 * 8 * 2
    assert ctr.fraction_square == 1.0
    g = graphs.CapturedCall(fn, (x, w), device=cuda_device)
    with counting.track_compiled_contractions() as ctr2:
        g.replay()
    assert ctr2.total_mults == 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with counting.track_contractions() as tctr:
            f.replay()
    assert tctr.total_mults == 0
    assert any(issubclass(c.category, counting.EmptyAuditWarning)
               for c in caught)
    torch.cuda.synchronize()
    assert torch.equal(f.outputs, torch.full((4, 2), 8.0,
                                             device=cuda_device))


def test_compiled_engine_audit_equals_eager_on_card(cuda_device,
                                                    compiled_world):
    """The serving half of tests/test_compiled_guard.py's cached-run audit
    test: a compiled engine captured under ``compiled_audit`` reports its
    replays' real contraction mix through ``track_compiled_contractions``
    -- the eager engine's audit, site for site -- while an eager
    ``track_contractions`` around a second, replay-only run sees nothing
    and warns."""
    import warnings
    from repro_torch.core import counting
    from repro_torch.serve.engine import Engine, EngineConfig
    from repro_torch.serve.server import Request
    model, reqs = compiled_world
    with counting.track_contractions() as eager:
        _serve(model, reqs, cuda_device, jit=False)
    eng = Engine(model, EngineConfig(**COMPILED_KW), device=cuda_device)
    with counting.compiled_audit(), \
            counting.track_compiled_contractions() as compiled:
        eng.run([Request(r.rid, r.tokens) for r in reqs])
    assert eng.captures == 3
    assert compiled.by_site() == eager.by_site()
    assert 0.0 < compiled.fraction_square == eager.fraction_square < 1.0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with counting.track_contractions() as replays:
            eng.run([Request(r.rid + 100, r.tokens) for r in reqs])
    assert eng.captures == 3 and replays.total_mults == 0
    assert any(issubclass(c.category, counting.EmptyAuditWarning)
               for c in caught)


def test_capture_survives_a_collected_graph_on_card(cuda_device,
                                                    compiled_world):
    """An engine left to the cyclic garbage collector (its model calls
    close over it) holds graphs; freed during another capture, a graph
    resets itself, which a capture does not permit.  A capture keeps the
    collector off, so a second engine captures and serves the first one's
    tokens even with the collector running at nearly every allocation
    outside its captures."""
    import gc
    model, reqs = compiled_world
    first, base = _serve(model, reqs, cuda_device)
    assert first.captures == 3
    del first
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        eng, toks = _serve(model, reqs, cuda_device)
    finally:
        gc.set_threshold(*threshold)
    assert eng.captures == 3 and toks == base


# ---------------------------------------------------------------- training
@pytest.mark.parametrize("spec,xs,ys", [
    ("tk,kn->tn", (64, 96), (96, 80)),                 # K1 and both grads
    ("bqkgh,bckh->bkgqc", (2, 40, 3, 1, 64), (2, 40, 3, 64))])   # K2
def test_vjp_grads_launch_kernels_on_card(cuda_device, spec, xs, ys):
    """Under autograd on the card both gradients of a square_pallas
    contraction launch K1/K2 (from autograd's device thread) and equal the
    same VJP's grads on CPU tensors (the plain versions) within the f32
    bound k * 2^-23 * (max|a| + max|b|)^2, k taken as the larger operand's
    size (above either gradient's contraction depth)."""
    from repro_torch.core.einsum import fs_einsum
    gen = torch.Generator().manual_seed(0)
    x, y = torch.randn(xs, generator=gen), torch.randn(ys, generator=gen)
    cot = torch.randn(torch.einsum(spec, x, y).shape, generator=gen)
    grads = {}
    launches = lambda: (sq_matmul_k1.launches + sq_matmul_k2.launches  # noqa
                        + sq_matmul_k3.launches)
    before = launches()
    for dev in ("cpu", cuda_device):
        tx = x.to(dev).requires_grad_(True)
        ty = y.to(dev).requires_grad_(True)
        out = fs_einsum(spec, tx, ty, mode="square_pallas")
        grads[str(dev)] = [g.cpu() for g in torch.autograd.grad(
            torch.sum(out * cot.to(dev)), (tx, ty))]
    torch.cuda.synchronize()
    assert launches() - before == 3          # the forward and both grads
    for got, ref in zip(grads[str(cuda_device)], grads["cpu"]):
        k = max(x.numel(), y.numel())
        tol = k * 2.0 ** -23 * (cot.abs().max() + max(
            x.abs().max(), y.abs().max())).item() ** 2
        assert (got - ref).abs().max().item() <= tol


def test_train_launcher_runs_on_card(cuda_device, tmp_path):
    """The train launcher at the smoke size on the card: finite losses,
    its first step's audit square forward and backward."""
    from repro_torch.launch import train as launch
    out = launch.main(["--reduced", "--steps", "2", "--global-batch", "2",
                       "--seq", "32", "--ckpt-every", "1", "--ckpt-dir",
                       str(tmp_path / "ck"), "--matmul-mode",
                       "square_pallas"])
    assert out["final_step"] == 2
    assert np.isfinite(out["loss_trajectory"]).all()
    assert out["contraction_audit"]["fraction_square_bwd"] == 1.0


# --------------------------------------------------- the captured train step
def _tiny_train(cuda_device, remat="block"):
    """The reduced fairsquare-demo under square_pallas (its own remat
    "block", so the capture holds a rematerialised backward) with its
    first state and two batches."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.lm import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod
    cfg = dataclasses.replace(get_config("fairsquare-demo").reduced(),
                              matmul_mode="square_pallas", remat=remat)
    model = build_model(cfg, device=cuda_device, seed=0)
    params = model.train_params()
    step = step_mod.make_train_step(model, step_mod.TrainConfig())
    batches = SyntheticLM(DataConfig(2, 32, cfg.vocab), cfg,
                          device=cuda_device).take(2)
    return step, params, adamw.adamw_init(params), batches


def test_captured_train_step_bit_equal_to_eager_on_card(cuda_device):
    """Two steps replayed from one CUDA graph (forward, the rematerialised
    square-routed backward, AdamW) equal two eager steps bit for bit:
    losses, params and optimizer state; one capture."""
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod
    step, params, opt, batches = _tiny_train(cuda_device)
    jitted = step_mod.jit_train_step(step, cuda_device)
    runs = {}
    for name, fn in (("eager", step), ("graph", jitted)):
        p, o, losses = params, opt, []
        for b in batches:
            p, o, met = fn(p, o, b)
            losses.append(met["loss"].clone())
        runs[name] = adamw.tree_fingerprint({"l": losses, "p": p, "o": o})
    assert jitted.captures == 1 and jitted.current.replays == 2
    assert runs["graph"] == runs["eager"]


def test_train_ledger_launches_equal_the_profiler_on_card(cuda_device):
    """The captured train step's ledger counts exactly the K1 and K2
    kernels a profiler sees in its replays, forward, backward and
    recompute (which launch from autograd's device thread at capture), and
    each replay adds them to the wrappers' counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train import step as step_mod
    step, params, opt, batches = _tiny_train(cuda_device)
    jitted = step_mod.jit_train_step(step, cuda_device)
    jitted(params, opt, batches[0])
    want = {k.__name__: n for k, n, _ in jitted.current.ledger.launches}
    assert want.get("sq_matmul_k1", 0) > 0 and want.get("sq_matmul_k2", 0) > 0
    k1, k2 = sq_matmul_k1.launches, sq_matmul_k2.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            jitted.replay()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert sum("sq_matmul_cluster_kernel" in n for n in names) \
        == 2 * want["sq_matmul_k1"]
    assert sum("sq_matmul_batched_kernel" in n for n in names) \
        == 2 * want["sq_matmul_k2"]
    assert sq_matmul_k1.launches == k1 + 2 * want["sq_matmul_k1"]
    assert sq_matmul_k2.launches == k2 + 2 * want["sq_matmul_k2"]


def test_capture_flags_seen_in_autograd_thread_on_card(cuda_device,
                                                       monkeypatch):
    """Autograd runs a captured backward in its own device thread: there
    ``graphs.capturing()`` holds, ``current_ledger()`` is the capture's
    ledger and the current stream captures; every K1 launch of the capture
    (forward on the caller's thread, gradients on autograd's) is on a
    capturing stream; and the ledger records the backward's runtime notes,
    probes and K1 launches."""
    import threading
    from repro_torch.core import counting, graphs, guards
    from repro_torch.core.einsum import fs_einsum
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import routing
    from repro_torch.train import step as step_mod

    seen, launched = [], []

    class Spy(torch.autograd.Function):
        @staticmethod
        def forward(ctx, h):
            return h.clone()

        @staticmethod
        def backward(ctx, g):
            seen.append((threading.get_ident(), graphs.capturing(),
                         graphs.current_ledger(),
                         torch.cuda.is_current_stream_capturing()))
            return g

    k1 = kops.sq_matmul_k1

    def spied_k1(*args):
        launched.append((threading.get_ident(),
                         torch.cuda.is_current_stream_capturing()))
        return k1(*args)
    monkeypatch.setattr(kops, "sq_matmul_k1", spied_k1)

    def loss_fn(p, b):
        h = Spy.apply(fs_einsum("tk,kn->tn", b["x"], p["w1"],
                                mode="square_pallas", site="a"))
        out = fs_einsum("tn,nm->tm", h, p["w2"], mode="square_pallas",
                        site="b")
        return torch.mean(out * out), {}

    def step(params, opt_state, batch):
        (loss, _), grads = step_mod.value_and_grad(loss_fn, params, batch)
        new = {k: params[k] - 0.1 * grads[k] for k in params}
        return new, opt_state, {"loss": loss}

    gen = torch.Generator().manual_seed(0)
    params = {"w1": torch.randn(96, 80, generator=gen).to(cuda_device),
              "w2": torch.randn(80, 48, generator=gen).to(cuda_device)}
    batch = {"x": torch.randn(64, 96, generator=gen).to(cuda_device)}
    routing.reset_route_health()
    main = threading.get_ident()
    with counting.compiled_audit(), guards.guarded():
        call = graphs.CapturedCall(step, (params, {}, batch),
                                   device=cuda_device)
    # warm-up and capture: one backward each, both recorded
    assert len(seen) == 2 and seen[0][2] is not call.ledger
    tid, capturing, ledger, stream_capturing = seen[1]
    assert tid != main and capturing and ledger is call.ledger \
        and stream_capturing
    # the capture's 5 K1 launches: 2 forward (caller's thread), 3 backward
    # (b's dL/dx and dL/dW, a's dL/dW; autograd's thread), all captured
    cap = launched[5:]
    assert len(cap) == 5 and all(c for _, c in cap)
    assert [t == main for t, _ in cap] == [True, True, False, False, False]
    sites = sorted(n[0] for n in call.ledger.notes)
    assert sites == ["a", "a.bwd_w", "b", "b.bwd_w", "b.bwd_x"]
    assert sorted(k.split("|")[0] for k, _ in call.ledger.probes) == sites
    assert [(k.__name__, n) for k, n, _ in call.ledger.launches] == [
        ("sq_matmul_k1", 5)]
    call.replay()
    assert guards.drain_pending_trips() == {}
    torch.cuda.synchronize()


def test_train_recapture_memory_on_card(cuda_device):
    """A guarded captured step whose backward saturates on K1 re-captures
    after the demotion; allocated memory after the re-capture (the old
    outputs dropped) is within 1 MiB of before it.  The cycle runs twice
    and the second is measured: the demoted route's first capture makes
    cuBLAS allocate, once, its workspace for the capture stream in
    autograd's thread."""
    from repro_torch.core import graphs, guards
    from repro_torch.core.einsum import fs_einsum
    from repro_torch.kernels import routing
    from repro_torch.train import step as step_mod

    def loss_fn(p, b):
        out = fs_einsum("mk,kn->mn", b["x"], p["w"], mode="square_pallas",
                        site="chaos")
        return torch.sum(out) * 1e22, {}

    def step(params, opt_state, batch):
        (loss, _), grads = step_mod.value_and_grad(loss_fn, params, batch)
        return params, opt_state, {"loss": loss, "grads": grads}

    gen = torch.Generator().manual_seed(23)
    args = ({"w": torch.randn(64, 32, generator=gen).to(cuda_device)}, {},
            {"x": torch.randn(64, 64, generator=gen).to(cuda_device)})

    def mem():
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated(cuda_device)

    for _ in range(2):
        routing.reset_route_health()
        guards.clear_pending_trips()
        with guards.guarded(trip_limit=1):
            cf = graphs.CapturedFunction(step, device=cuda_device,
                                         epoch_keyed=True)
            out = cf(*args)
            assert list(guards.drain_pending_trips()) == [
                routing.health_key("chaos.bwd_w", (1, 32, 64, 64),
                                   torch.float32)]
            del out
            before = mem()
            cf.recapture()
            out = cf.replay()
            assert guards.drain_pending_trips() == {}
            assert bool(torch.isfinite(out[2]["grads"]["w"]).all())
            del out
            after = mem()
            cf.release()
    routing.reset_route_health()
    assert abs(after - before) <= 2 ** 20


def test_fault_schedule_over_captured_step_on_card(cuda_device, tmp_path):
    """The trainer's fault schedule over the captured step (a raising call
    retried, a poisoned update rolled back): the clean captured run's
    losses and params bit for bit, one capture each."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod
    from repro_torch.train.faults import TrainFaultInjector, TrainFaultPlan
    from repro_torch.train.trainer import Trainer, TrainerConfig
    step, params, opt, _ = _tiny_train(cuda_device)
    vocab = get_config("fairsquare-demo").reduced().vocab

    def run(name, faults=None):
        data = SyntheticLM(DataConfig(2, 32, vocab), device=cuda_device)
        tr = Trainer(TrainerConfig(total_steps=6, ckpt_every=2,
                                   ckpt_dir=str(tmp_path / name), keep=3,
                                   log_every=3, audit_contractions=False),
                     step_mod.jit_train_step(step, cuda_device), params, opt,
                     data, faults=faults)
        return tr, tr.run()

    clean, base = run("clean")
    plan = TrainFaultPlan.of(step_fail=(1, 3), nan_grad=(2,))
    tr, res = run("chaos", TrainFaultInjector(plan))
    assert base["captures"] == res["captures"] == 1
    assert res["step_failures"] == 2 and res["rollbacks"] >= 1
    assert res["loss_trajectory"] == base["loss_trajectory"]
    assert adamw.tree_fingerprint(tr.params) == \
        adamw.tree_fingerprint(clean.params)


# ------------------------------------------------------------ MoE serving
# moonshot-v1-16b-a3b's expert GEMMs (C = 4 slots an expert), on K2, and a
# small stack the fold rule sends to K3
MOE_EXPERT_SHAPES = [(64, 4, 2048, 1408), (64, 4, 1408, 2048),
                     (16, 2, 64, 32)]


@pytest.mark.parametrize("E,C,k,n", MOE_EXPERT_SHAPES)
def test_prepared_expert_stack_on_k2_k3_on_card(cuda_device, E, C, k, n):
    """K2 or K3, wherever the routing rule takes the shape, against the
    batched plain version; the prepared expert stack, its raw bf16 source
    and ``fs_einsum`` on the square route give the direct launch's
    bits."""
    from repro_torch.core.einsum import fs_einsum
    from repro_torch.core.prepared import prepare_operand
    from repro_torch.kernels import routing
    route = routing.select_matmul_route(C, n, k, batch=E,
                                        dtype=torch.bfloat16).name
    assert route in ("batched", "fold")
    kern = sq_matmul_k3 if route == "fold" else sq_matmul_k2
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(E, C, k, generator=gen).to(torch.bfloat16).to(
        cuda_device)
    w = (torch.randn(E, k, n, generator=gen) / k ** 0.5).to(
        torch.bfloat16).to(cuda_device)
    prep = prepare_operand(w, site="moe_expert")
    aw = a.float()
    sa = sq.row_correction(aw)
    before = kern.launches
    out = kern(aw, prep.canon, sa, prep.corr)
    assert kern.launches == before + 1
    ref = sq_matmul_batched_plain(aw, prep.canon, sa, prep.corr)
    tol = k * 2.0 ** -23 * (aw.abs().max() + prep.canon.abs().max()
                            ).item() ** 2
    assert (out - ref).abs().max().item() <= tol
    fold = route == "fold"
    assert torch.equal(ops.sq_matmul_local(a, prep, fold=fold), out)
    assert torch.equal(ops.sq_matmul_local(a, w, fold=fold), out)
    assert torch.equal(fs_einsum("ecd,edf->ecf", a, prep,
                                 mode="square_pallas"), out)
    assert kern.launches == before + 4


@pytest.fixture(scope="module")
def moe_layer():
    """One moonshot-v1-16b-a3b layer at its published width (bf16,
    prepared, square_pallas + square_gemms) and its LM."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SQUARE_GEMMS_POLICY
    from repro_torch.models.lm import build_model
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"), n_layers=1,
                              matmul_mode="square_pallas",
                              contraction_policy=SQUARE_GEMMS_POLICY)
    model = build_model(cfg, device="cuda", seed=0)
    with torch.no_grad():
        params = model.prepare_params()
    yield cfg, params["layers"][0]
    del model, params
    torch.cuda.empty_cache()


def test_moe_apply_local_reads_nothing_back_on_card(cuda_device, moe_layer):
    """The dispatch has no host sync (no ``.item()``, ``nonzero``, boolean
    indexing or ``bincount``): it runs under
    ``set_sync_debug_mode("error")`` at a decode tick's and a prefill
    chunk's rows, launching K1 for the router and K2 for the experts."""
    from repro_torch.models.moe import moe_apply_local
    cfg, p = moe_layer
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(32, cfg.d_model, generator=gen).to(torch.bfloat16).to(
        cuda_device)
    k1, k2 = sq_matmul_k1.launches, sq_matmul_k2.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            outs = [moe_apply_local(p["ffn"], x[:T], cfg=cfg,
                                    mode=cfg.matmul_mode,
                                    policy=cfg.contraction_policy)
                    for T in (8, 32)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert sq_matmul_k1.launches == k1 + 2
    assert sq_matmul_k2.launches == k2 + 6
    for (out, aux), T in zip(outs, (8, 32)):
        assert out.shape == (T, cfg.d_model) and out.dtype == torch.bfloat16
        assert bool(torch.isfinite(out).all()) and float(aux) > 0


def test_captured_moe_block_equals_eager_on_card(cuda_device, moe_layer):
    """A full-width moe block (attention + MoE over a prefill chunk's 32
    rows) captured into a CUDA graph: each replay gives the eager pass's
    bits, and the ledger re-emits its K1 and K2 launches."""
    from repro_torch.core import graphs
    from repro_torch.models import blocks as blk
    cfg, p = moe_layer
    ctx = {"cfg": cfg, "mode": cfg.matmul_mode,
           "policy": cfg.contraction_policy,
           "positions": torch.arange(32, device=cuda_device), "causal": True}
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(1, 32, cfg.d_model, generator=gen).to(
        torch.bfloat16).to(cuda_device)

    def fn(x):
        return blk.block_forward("moe", p, x, ctx)[0]

    with torch.no_grad():
        eager = fn(x)
        f = graphs.CapturedCall(fn, (x,), device=cuda_device)
        k1, k2 = sq_matmul_k1.launches, sq_matmul_k2.launches
        for _ in range(2):
            out = f.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, eager)
    assert sq_matmul_k1.launches == k1 + 2 * 5       # wq wk wv wo router
    assert sq_matmul_k2.launches == k2 + 2 * 3       # gate, up, down


def test_captured_moe_train_step_bit_equal_to_eager_on_card(cuda_device):
    """A MoE train step (8 experts top-3 at capacity factor 0.5, so every
    layer drops assignments; remat "block") replayed from one CUDA graph
    equals the eager step bit for bit over two steps, with the experts'
    forward and both gradients on K2."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.lm import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod
    cfg = ModelConfig(name="tiny-moe-train", family="moe", n_layers=2,
                      d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
                      vocab=256, head_dim=32, n_experts=8, topk=3,
                      capacity_factor=0.5, block_pattern=("moe",),
                      dtype="bfloat16", matmul_mode="square_pallas",
                      remat="block", loss_chunk=64, attn_chunk_q=32,
                      attn_chunk_kv=32, max_seq=64)
    model = build_model(cfg, device=cuda_device, seed=0)
    params = model.train_params()
    step = step_mod.make_train_step(model, step_mod.TrainConfig())
    batches = SyntheticLM(DataConfig(4, 32, cfg.vocab), cfg,
                          device=cuda_device).take(2)
    jitted = step_mod.jit_train_step(step, cuda_device)
    runs = {}
    for name, fn in (("eager", step), ("graph", jitted)):
        k2 = sq_matmul_k2.launches
        p, o, losses = params, adamw.adamw_init(params), []
        for b in batches:
            p, o, met = fn(p, o, b)
            losses.append(met["loss"].clone())
        torch.cuda.synchronize()
        assert sq_matmul_k2.launches > k2
        runs[name] = adamw.tree_fingerprint({"l": losses, "p": p, "o": o})
    assert jitted.captures == 1 and jitted.current.replays == 2
    assert runs["graph"] == runs["eager"]


# ------------------------------------------------------ recurrent serving
# The batched GEMMs of a dense decode step of 4 rows: xlstm-350m's mLSTM
# read-out (B*H, 1, hd, hd) and sLSTM recurrence (H, B, d/H, 4d/H),
# recurrentgemma-2b's local attention scores and PV (B*KV, G, hd, 128) and
# (B*KV, G, 128, hd)
RECURRENT_DECODE_SHAPES = [(16, 1, 512, 512), (4, 4, 256, 1024),
                           (4, 10, 256, 128), (4, 10, 128, 256)]


@pytest.mark.parametrize("nb,m,k,n", RECURRENT_DECODE_SHAPES)
def test_recurrent_decode_shapes_on_k2_k3_on_card(cuda_device, nb, m, k, n):
    """K2 or K3, wherever the routing rule takes the shape, against the
    batched plain version (f32 from bf16-rounded operands), and the
    ``fs_einsum`` call that the block makes at that shape gives the direct
    launch's bits."""
    from repro_torch.core.einsum import fs_einsum
    from repro_torch.kernels import routing
    route = routing.select_matmul_route(m, n, k, batch=nb).name
    assert route in ("batched", "fold")
    kern = sq_matmul_k3 if route == "fold" else sq_matmul_k2
    gen = torch.Generator().manual_seed(3)
    a = torch.randn(nb, m, k, generator=gen).to(torch.bfloat16).float().to(
        cuda_device)
    b = (torch.randn(nb, k, n, generator=gen) / k ** 0.5).to(
        torch.bfloat16).float().to(cuda_device)
    sa, sb = sq.row_correction(a), sq.col_correction(b, dim=-2)
    before = kern.launches
    out = kern(a, b, sa, sb)
    ref = sq_matmul_batched_plain(a, b, sa, sb)
    tol = k * 2.0 ** -23 * (a.abs().max() + b.abs().max()).item() ** 2
    assert (out - ref).abs().max().item() <= tol
    via = fs_einsum("bmk,bkn->bmn", a, b, mode="square_pallas")
    assert torch.equal(via, out)
    assert kern.launches == before + 2


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-350m"])
def test_captured_recurrent_decode_step_equals_eager_on_card(cuda_device,
                                                             arch):
    """A full-width decode step (published width and depth, bf16, prepared,
    square_pallas) of 4 prefilled slots, captured the way the Server
    captures it (``GraphSet`` over the cache, its states restored after the
    warm-up): three replays give the eager steps' logits and leave the
    eager cache, bit for bit, from one capture."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import graphs
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models.lm import build_model
    from repro_torch.serve.server import write_slot
    cfg = dataclasses.replace(get_config(arch), matmul_mode="square_pallas")
    model = build_model(cfg, device=cuda_device, seed=0)
    B, T = 4, 128
    with torch.no_grad():
        params = model.prepare_params()
        caches = []
        for _ in range(2):
            cache = model.init_cache(B, T)
            for i in range(B):
                toks = (torch.arange(5 + 3 * i, dtype=torch.int32) * 7919
                        % cfg.vocab)[None].to(cuda_device)
                write_slot(cache, i, model.prefill(params, {"tokens": toks},
                                                   T)[1])
            caches.append(cache)
        eager_cache, graph_cache = caches
        gs = graphs.GraphSet(
            {"decode_step": lambda tokens, pos: model.decode_step(
                params, graph_cache, tokens, pos)[0]}, cuda_device,
            state=tree_leaves(graph_cache))
        tok = np.arange(1, B + 1, dtype=np.int32)[:, None]
        pos = np.array([5 + 3 * i for i in range(B)], np.int32)
        for _ in range(3):
            want = model.decode_step(params, eager_cache,
                                     torch.as_tensor(tok, device=cuda_device),
                                     torch.as_tensor(pos, device=cuda_device))[0]
            got = gs("decode_step", tok, pos)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
            tok = want.argmax(-1).to(torch.int32).cpu().numpy()[:, None]
            pos = pos + 1
    assert gs.captures == 1
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(graph_cache),
                                                 tree_leaves(eager_cache)))
    del model, params, caches, eager_cache, graph_cache, gs
    torch.cuda.empty_cache()


# ----------------------------------------------------- recurrent training
# xlstm-350m's sLSTM step (H = 4 heads of hd = 256, B = 4 rows) under
# autograd: dL/dh "bhy,hxy->bhx", canonical (H, B, 4 hd, hd), and dL/dR
# "bhy,bhx->hxy", canonical (H, 4 hd, B, hd)
SLSTM_BACKWARD = [("bhy,hxy->bhx", (4, 4, 1024), (4, 256, 1024),
                   (4, 4, 1024, 256)),
                  ("bhy,bhx->hxy", (4, 4, 1024), (4, 4, 256),
                   (4, 1024, 4, 256))]


@pytest.mark.parametrize("spec,xs,ys,canon", SLSTM_BACKWARD)
def test_slstm_backward_shapes_on_k2_on_card(cuda_device, spec, xs, ys,
                                             canon):
    """K2 at the sLSTM's two backward shapes against the batched plain
    version (f32 from bf16-rounded operands), and the backward's own
    ``fs_einsum`` spec on those operands gives the direct launch's bits,
    on K2's route."""
    from repro_torch.core.einsum import fs_einsum
    from repro_torch.kernels import routing
    nb, m, k, n = canon
    assert routing.select_matmul_route(m, n, k, batch=nb).name == "batched"
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(*xs, generator=gen).to(torch.bfloat16).float().to(
        cuda_device)
    y = (torch.randn(*ys, generator=gen) / k ** 0.5).to(
        torch.bfloat16).float().to(cuda_device)
    before = sq_matmul_k2.launches
    via = fs_einsum(spec, x, y, mode="square_pallas")
    # the dispatch's canonical operands: the batch index h first
    lhs, out_dims = spec.split("->")
    xd, yd = lhs.split(",")
    m_dims = "".join(d for d in xd if d not in yd and d in out_dims)
    k_dims = "".join(d for d in xd if d in yd and d not in out_dims)
    n_dims = "".join(d for d in yd if d not in xd and d in out_dims)
    a = torch.einsum(f"{xd}->h{m_dims}{k_dims}", x).reshape(
        nb, m, k).contiguous()
    b = torch.einsum(f"{yd}->h{k_dims}{n_dims}", y).reshape(
        nb, k, n).contiguous()
    sa, sb = sq.row_correction(a), sq.col_correction(b, dim=-2)
    out = sq_matmul_k2(a, b, sa, sb)
    ref = sq_matmul_batched_plain(a, b, sa, sb)
    tol = k * 2.0 ** -23 * (a.abs().max() + b.abs().max()).item() ** 2
    assert (out - ref).abs().max().item() <= tol
    want = torch.einsum(f"h{m_dims}{n_dims}->{out_dims}",
                        out.reshape(nb, *(x.shape[xd.index(d)]
                                          for d in m_dims),
                                    *(y.shape[yd.index(d)] for d in n_dims)))
    assert torch.equal(via, want)
    assert sq_matmul_k2.launches == before + 2


@pytest.mark.parametrize("kind,S", [("rglru", 256), ("mlstm", 512),
                                    ("slstm", 64)])
def test_captured_recurrent_block_backward_equals_eager_on_card(
        cuda_device, kind, S):
    """One full-width block (recurrentgemma's rglru with its FFN; xlstm's
    mlstm over two 256-token chunks; xlstm's slstm loop), bf16,
    square_pallas, rematerialised as the train step runs it: its forward
    and backward (the gradients of every weight and of the input) twice
    eagerly and once captured into a CUDA graph, bit for bit."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import counting, graphs
    from repro_torch.layers.param import init_module
    from repro_torch.models import blocks as blk
    from repro_torch.models.lm import _as_tree
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod
    arch = "recurrentgemma-2b" if kind == "rglru" else "xlstm-350m"
    cfg = dataclasses.replace(get_config(arch), matmul_mode="square_pallas")
    gen = torch.Generator().manual_seed(7)
    p = _as_tree(init_module(blk.block_spec(kind, cfg), gen, cuda_device))
    B = 2
    x = torch.randn(B, S, cfg.d_model, generator=gen).to(
        torch.bfloat16).to(cuda_device)
    ct = torch.randn(B, S, cfg.d_model, generator=gen).to(
        torch.bfloat16).to(cuda_device)
    ctx = {"cfg": cfg, "mode": cfg.matmul_mode, "policy": None,
           "positions": torch.arange(S, device=cuda_device), "causal": True}

    def fn(q, b):
        y = counting.remat(lambda h: blk.block_forward(
            kind, q["p"], h, ctx)[0])(q["x"])
        return (y.float() * b["ct"].float()).sum(), {}

    def grads_of(p, x, ct):
        return step_mod.value_and_grad(fn, {"p": p, "x": x}, {"ct": ct})[1]

    k2 = sq_matmul_k2.launches
    runs = [grads_of(p, x, ct) for _ in range(2)]
    graph = graphs.CapturedFunction(grads_of, device=cuda_device,
                                    name=f"{kind}_block")
    runs.append(graph(p, x, ct))
    torch.cuda.synchronize()
    assert graph.captures == 1 and graph.current.nodes
    assert (sq_matmul_k2.launches > k2) == (kind != "rglru")
    fps = [adamw.tree_fingerprint(r) for r in runs]
    assert fps[0] == fps[1] == fps[2]
    graph.release()


def test_xlstm_step_gradients_repeat_bit_for_bit_on_card(cuda_device):
    """The gradients of an xlstm-350m step at its published width (8 of
    its 24 layers: 7 mLSTM and an sLSTM), 4 x 512 tokens, bf16,
    square_pallas, remat "block", computed twice eagerly: bit for bit.
    The mLSTM stabilizer's running max is a scan of ``torch.maximum``; a
    ``torch.cummax`` there scattered its gradient with atomic adds, and
    two runs' gradients differed in most leaves."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.lm import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod
    cfg = dataclasses.replace(get_config("xlstm-350m"), n_layers=8,
                              matmul_mode="square_pallas")
    model = build_model(cfg, device=cuda_device, seed=0)
    batch = SyntheticLM(DataConfig(4, 512, cfg.vocab), cfg,
                        device=cuda_device).next_batch()
    loss_fn = step_mod.make_loss_fn(model, step_mod.TrainConfig())
    fps = [adamw.tree_fingerprint(step_mod.value_and_grad(
        loss_fn, model.train_params(), batch)[1]) for _ in range(2)]
    assert fps[0] == fps[1]
