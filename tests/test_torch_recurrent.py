"""The port's recurrent blocks against the JAX package with the same
weights and inputs: ``models/rglru.py`` (the causal conv, the RG-LRU scan
with a carried state, the decode step), ``models/xlstm.py`` (the chunked
and the sequential mLSTM scans, the square form's dynamic range there,
sLSTM), each block kind's forward and decode (``lattn`` with its window),
the empty caches and the audit of a padded mLSTM chunk.  The LMs over
``recurrentgemma-2b`` and ``xlstm-350m`` ``.reduced()`` are in
``tests/test_torch_recurrent_lm.py``, the serving stack in
``tests/test_torch_recurrent_serving.py``.

Tolerances (f32): ``standard`` and ``square_virtual`` (the multiplier
with the square form's contract) within 1e-4 * max|ref| -- the two packages
run the same operations, the scans in the same order (the RG-LRU's
log-depth scan is JAX's recursion), and differ by the order of a few f32
sums (XLA's cumsum and fusions).  The square-form modes (``square_exact``,
``square_scan``, and ``square_pallas``, which runs the kernels' plain
versions here and is held to JAX's square_pallas, whose Pallas kernels run
in interpret mode through the ``pltpu.TPUCompilerParams`` alias below)
within 1e-3 * max|ref|: each side's square-form sums round at ~2^-24 *
(|a| + |b|)^2 a term, in a different order; through xlstm's 8 layers the
two packages then sit 0.5-1.1e-4 * max apart.  Prefill + decode
against the forward: JAX's own 2e-3 (``tests/test_models_smoke.py``).
bf16: logits within 2e-2 * max|logits| of JAX's, the same argmax
(``tests/test_torch_bf16.py``'s contract).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core import counting as jcount  # noqa: E402
from repro.layers.param import init_tree  # noqa: E402
from repro.models import blocks as jblk  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro.models import xlstm as jxl  # noqa: E402
from repro.models.lm import build_model as jbuild  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import counting as tcount  # noqa: E402
from repro_torch.core.matmul import MODES  # noqa: E402
from repro_torch.core.prepared import PreparedOperand  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.models import blocks as tblk  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402
from repro_torch.models import xlstm as txl  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from test_torch_moe import CPU, _route, _to_torch  # noqa: E402

# JAX 0.9.0 renamed ``pltpu.TPUCompilerParams``; with the alias the JAX
# square_pallas runs its Pallas kernels in interpret mode.
if not hasattr(pltpu, "TPUCompilerParams"):
    pltpu.TPUCompilerParams = pltpu.CompilerParams

ARCHS = ("recurrentgemma-2b", "xlstm-350m")
# the square-form modes; 1e-4 otherwise (the module docstring)
REL = {"square_exact": 1e-3, "square_scan": 1e-3, "square_pallas": 1e-3}


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    """Small tensors: one torch thread computes them as fast and leaves the
    cores to the suite's other workers."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, ref, rel, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, what
    assert np.isfinite(got).all(), what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= rel * scale, \
        f"{what}: max|diff| {err:.3e} > {rel:g} * {scale:.3e}"


def _cfgs(arch, mode="standard", **kw):
    return (dataclasses.replace(jget(arch).reduced(), matmul_mode=mode, **kw),
            dataclasses.replace(tget(arch).reduced(), matmul_mode=mode, **kw))


def _models(arch, mode="standard", **kw):
    jc, tc = _cfgs(arch, mode, **kw)
    jm = jbuild(jc)
    params = jm.init(jax.random.PRNGKey(0))
    tm = LM(tc, device=CPU)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)


def _block_params(kind, arch, seed=0):
    jc, tc = _cfgs(arch)
    jp = init_tree(jblk.block_spec(kind, jc), jax.random.PRNGKey(seed))
    return jc, tc, jp, _to_torch(jp)


RNG = np.random.default_rng(11)


def _normal(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


# -------------------------------------------------------------- RG-LRU
def test_conv1d_causal_matches_jax():
    x, w, st = _normal(2, 9, 64), _normal(4, 64), _normal(2, 3, 64)
    for state in (None, st):
        jo, js = jrg._conv1d_causal(jnp.asarray(x), jnp.asarray(w),
                                    None if state is None
                                    else jnp.asarray(state))
        to, ts = trg._conv1d_causal(torch.from_numpy(x), torch.from_numpy(w),
                                    None if state is None
                                    else torch.from_numpy(state))
        _close(to, jo, 1e-6, "conv out")
        _close(ts, js, 0.0, "conv state")


def _rglru_params(mode="standard"):
    jc, tc = _cfgs("recurrentgemma-2b", mode)
    jp = init_tree(jrg.rglru_spec(jc), jax.random.PRNGKey(3))
    return jc, tc, jp, _to_torch(jp)


@pytest.mark.parametrize("mode", ["standard", "square_virtual"])
def test_rglru_forward_with_carried_state_matches_jax(mode):
    """33 steps (an odd length, so the scan's recursion takes both its
    branches) from a carried state: output and final state."""
    jc, tc, jp, tp = _rglru_params(mode)
    R = jc.rnn_width
    x = _normal(2, 33, jc.d_model)
    h0, c0 = _normal(2, R), _normal(2, jc.conv_width - 1, R)
    jy, js = jrg.rglru_forward(jp, jnp.asarray(x), cfg=jc, mode=mode,
                               state={"h": jnp.asarray(h0),
                                      "conv": jnp.asarray(c0)})
    ty, ts = trg.rglru_forward(tp, torch.from_numpy(x), cfg=tc, mode=mode,
                               state={"h": torch.from_numpy(h0),
                                      "conv": torch.from_numpy(c0)})
    _close(ty, jy, 1e-4, "y")
    _close(ts["h"], js["h"], 1e-4, "h")
    _close(ts["conv"], js["conv"], 0.0, "conv")


@pytest.mark.parametrize("S", [1, 2, 7, 16, 40])
def test_assoc_scan_equals_the_sequential_recurrence(S):
    a = torch.from_numpy(np.abs(_normal(2, S, 8)))
    b = torch.from_numpy(_normal(2, S, 8))
    _, h = trg._assoc_scan([a, b])
    want, prev = [], torch.zeros(2, 8)
    for t in range(S):
        prev = b[:, t] if t == 0 else a[:, t] * prev + b[:, t]
        want.append(prev)
    torch.testing.assert_close(h, torch.stack(want, 1), rtol=1e-5,
                               atol=1e-5)


def test_rglru_decode_matches_jax_and_the_forward():
    jc, tc, jp, tp = _rglru_params()
    x = _normal(2, 12, jc.d_model)
    jst = jrg.rglru_init_state(jc, 2)
    tst = trg.rglru_init_state(tc, 2, CPU)
    ys = []
    for t in range(x.shape[1]):
        jy, jst = jrg.rglru_decode(jp, jnp.asarray(x[:, t:t + 1]), jst,
                                   cfg=jc)
        ty, tst = trg.rglru_decode(tp, torch.from_numpy(x[:, t:t + 1]), tst,
                                   cfg=tc)
        _close(ty, jy, 1e-4, f"step {t}")
        ys.append(ty)
    _close(tst["h"], jst["h"], 1e-4, "h")
    full, st = trg.rglru_forward(tp, torch.from_numpy(x), cfg=tc)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), full.numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tst["h"].numpy(), st["h"].numpy(), rtol=2e-3,
                               atol=2e-3)


# --------------------------------------------------------------- xLSTM
def _mlstm_inputs(B=2, H=2, S=40, hd=16, state=True):
    q, k, v = (_normal(B, H, S, hd) for _ in range(3))
    it = _normal(B, H, S)
    ft = _normal(B, H, S) - 1.0
    if state:
        st = (_normal(B, H, hd, hd), _normal(B, H, hd), _normal(B, H))
    else:
        st = (np.zeros((B, H, hd, hd), np.float32),
              np.zeros((B, H, hd), np.float32),
              np.full((B, H), -1e30, np.float32))
    return (q, k, v, it, ft), st


@pytest.mark.parametrize("mode", ["standard", "square_virtual"])
@pytest.mark.parametrize("chunk", [16, 40, 64])
def test_mlstm_chunk_scan_matches_jax(mode, chunk):
    """S = 40 in chunks of 16 (3 chunks, the last padded), 40 and 64 (one
    chunk), from a carried state."""
    ops, st = _mlstm_inputs()
    jh, js = jxl.mlstm_chunk_scan(*map(jnp.asarray, ops),
                                  tuple(map(jnp.asarray, st)), chunk,
                                  mode=mode)
    th, ts = txl.mlstm_chunk_scan(*map(torch.from_numpy, ops),
                                  tuple(map(torch.from_numpy, st)), chunk,
                                  mode=mode)
    _close(th, jh, 1e-4, "h")
    for t, j, name in zip(ts, js, "Cnm"):
        _close(t, j, 1e-4, name)


@pytest.mark.parametrize("state", [False, True])
def test_mlstm_seq_scan_matches_jax_and_the_chunked_form(state):
    ops, st = _mlstm_inputs(S=24, state=state)
    jh, js = jxl.mlstm_seq_scan(*map(jnp.asarray, ops),
                                tuple(map(jnp.asarray, st)))
    th, ts = txl.mlstm_seq_scan(*map(torch.from_numpy, ops),
                                tuple(map(torch.from_numpy, st)))
    _close(th, jh, 1e-4, "h")
    for t, j, name in zip(ts, js, "Cnm"):
        _close(t, j, 1e-4, name)
    ch, cs = txl.mlstm_chunk_scan(*map(torch.from_numpy, ops),
                                  tuple(map(torch.from_numpy, st)), 8)
    np.testing.assert_allclose(ch.numpy(), th.numpy(), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(cs[0].numpy(), ts[0].numpy(), rtol=2e-3,
                               atol=2e-3)


def _rel64(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("mode", ["square_exact", "square_pallas"])
def test_mlstm_dynamic_range_gap_matches_jax(mode):
    """The inter-chunk mix multiplies ``q * exp(m + b - m_new)``, tiny once
    a chunk's input gates jump (here by +12 from the third chunk), by
    ``C``, which holds the earlier chunks' exp-weighted outer products
    (``v`` ~ N(0, 100^2)): the square form's f32 error, ~2^-24 * (|a| +
    |b|)^2 a term, is then large against the product.  q and k are
    positive, so no denominator ``|n . q|`` cancels and ``standard`` stays
    ~2e-7 from float64.  The port's gap must be the JAX package's in the
    same mode (its Pallas kernels in interpret mode), within 2x either
    way.  (JAX's ``square_scan``, the XLA emulation, sits ~2.3x above the
    port's here, which sums its slabs in the plain kernels' order.)"""
    rng = np.random.default_rng(0)
    B, H, S, hd, c = 2, 2, 96, 32, 32
    q, k = (np.abs(rng.normal(size=(B, H, S, hd))).astype(np.float32)
            for _ in range(2))
    v = (rng.normal(size=(B, H, S, hd)) * 100.0).astype(np.float32)
    it = rng.normal(size=(B, H, S)).astype(np.float32)
    it[:, :, 64:] += 12.0
    ft = (rng.normal(size=(B, H, S)) - 1.0).astype(np.float32)
    st = (np.zeros((B, H, hd, hd), np.float32),
          np.zeros((B, H, hd), np.float32), np.full((B, H), -1e30,
                                                     np.float32))
    ops = (q, k, v, it, ft)

    def port(run_mode, dtype=torch.float32):
        h, _ = txl.mlstm_chunk_scan(
            *(torch.from_numpy(t).to(dtype) for t in ops),
            tuple(torch.from_numpy(t).to(dtype) for t in st), c,
            mode=run_mode)
        return h.numpy()

    ref = port("standard", torch.float64)
    jh, _ = jxl.mlstm_chunk_scan(*map(jnp.asarray, ops),
                                 tuple(map(jnp.asarray, st)), c, mode=mode)
    got, jax_gap, std = (_rel64(port(mode), ref), _rel64(jh, ref),
                         _rel64(port("standard"), ref))
    print(f"{mode}: ||h - exact|| / ||exact|| port {got:.3e} JAX "
          f"{jax_gap:.3e} (standard {std:.3e})")
    assert got > 10 * std                      # the gap reproduces
    assert 0.5 * jax_gap <= got <= 2.0 * jax_gap


@pytest.mark.parametrize("mode", ["standard", "square_virtual"])
def test_slstm_forward_matches_jax(mode):
    jc, tc = _cfgs("xlstm-350m", mode)
    jp = init_tree(jxl.slstm_spec(jc), jax.random.PRNGKey(4))
    tp = _to_torch(jp)
    D = jc.d_model
    x = _normal(2, 14, D)
    st = [_normal(2, D, scale=0.5) for _ in range(3)] + [_normal(2, D)]
    jy, js = jxl.slstm_forward(jp, jnp.asarray(x), cfg=jc, mode=mode,
                               state=tuple(map(jnp.asarray, st)))
    ty, ts = txl.slstm_forward(tp, torch.from_numpy(x), cfg=tc, mode=mode,
                               state=dict(zip("cnhm", map(torch.from_numpy,
                                                          st))))
    _close(ty, jy, 1e-4, "y")
    for name, j in zip("cnhm", js):
        _close(ts[name], j, 1e-4, name)


# -------------------------------------------------------------- blocks
KIND_ARCH = {"rglru": "recurrentgemma-2b", "lattn": "recurrentgemma-2b",
             "mlstm": "xlstm-350m", "slstm": "xlstm-350m"}


def _as_state(kind, jstate):
    if kind == "mlstm":
        return dict(zip(("C", "n", "m"), jstate))
    if kind == "slstm":
        return dict(zip("cnhm", jstate))
    return jstate


@pytest.mark.parametrize("kind", sorted(KIND_ARCH))
def test_block_forward_and_decode_match_jax(kind):
    """A block's forward over 36 tokens (past ``lattn``'s 32-token window)
    and its decode, token by token from an empty cache (a 32-slot ring for
    ``lattn``, whose cache_len is 48), against JAX's; the decode also
    against the forward at JAX's 2e-3."""
    jc, tc, jp, tp = _block_params(kind, KIND_ARCH[kind])
    B, S = 2, 36
    x = _normal(B, S, jc.d_model)
    pos = np.arange(S)
    jctx = {"cfg": jc, "mode": "standard", "positions": jnp.asarray(pos),
            "causal": True}
    tctx = {"cfg": tc, "mode": "standard",
            "positions": torch.from_numpy(pos), "causal": True}
    jy, jseed, _ = jblk.block_forward(kind, jp, jnp.asarray(x), jctx)
    ty, tseed, aux = tblk.block_forward(kind, tp, torch.from_numpy(x), tctx)
    _close(ty, jy, 1e-4, "forward")
    assert float(aux) == 0.0
    if kind != "lattn":
        for key, t in tseed.items():
            _close(t, _as_state(kind, jseed)[key], 1e-4, f"seed {key}")
    jcache = jblk.block_init_cache(kind, jc, B, 48)
    tcache = tblk.block_init_cache(kind, tc, B, 48, CPU)
    ids = [id(t) for t in tcache.values()]
    jdecode = jax.jit(lambda p, x, c, pos: jblk.block_decode(
        kind, p, x, c, {"cfg": jc, "mode": "standard", "pos": pos}))
    outs = []
    for t in range(S):
        jo, jcache = jdecode(jp, jnp.asarray(x[:, t:t + 1]), jcache,
                             jnp.full((B,), t, jnp.int32))
        to = tblk.block_decode(kind, tp, torch.from_numpy(x[:, t:t + 1]),
                               tcache, {"cfg": tc, "mode": "standard",
                                        "pos": torch.full((B,), t)})
        _close(to, jo, 1e-4, f"decode step {t}")
        outs.append(to)
    # the cache is updated in place: the same tensors as allocated
    assert [id(t) for t in tcache.values()] == ids
    for key, t in tcache.items():
        _close(t.float(), np.asarray(_as_state(kind, jcache)[key],
                                     np.float32), 1e-4, f"cache {key}")
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), ty.numpy(),
                               rtol=2e-3, atol=2e-3)


def test_init_caches_match_jax():
    for arch in ARCHS:
        jc, tc = _cfgs(arch)
        for kind in set(jc.layer_kinds):
            j = _as_state(kind, jblk.block_init_cache(kind, jc, 3, 40))
            t = tblk.block_init_cache(kind, tc, 3, 40, CPU)
            assert sorted(t) == sorted(j), kind
            for key in t:
                assert t[key].dtype == {
                    "float32": torch.float32, "bfloat16": torch.bfloat16,
                    "int32": torch.int32}[str(np.asarray(j[key]).dtype)]
                np.testing.assert_array_equal(t[key].float().numpy(),
                                              np.asarray(j[key], np.float32))


def test_chunk_padding_is_audited_as_jax():
    """A 300-token mLSTM forward: two chunks of 256, the second padded by
    212; the ``recurrent_mix`` notes count the padding, as JAX's
    ``count_scale(nc)`` does."""
    jc, tc, jp, tp = _block_params("mlstm", "xlstm-350m")
    x = _normal(1, 300, jc.d_model, scale=0.5)
    with jcount.track_contractions() as j:
        jxl.mlstm_forward(jp["mix"], jnp.asarray(x), cfg=jc)
    with tcount.track_contractions() as t, torch.no_grad():
        txl.mlstm_forward(tp["mix"], torch.from_numpy(x), cfg=tc)
    assert {s: d["mults"] for s, d in t.by_site().items()} == \
        {s: d["mults"] for s, d in j.by_site().items()}
    H = tc.n_heads
    hd = int(tc.inner_factor * tc.d_model) // H
    c = 256
    assert t.by_site()["recurrent_mix"]["mults"] == 2 * H * (
        2 * c * hd * hd + 2 * c * c * hd + 2 * c * hd)
