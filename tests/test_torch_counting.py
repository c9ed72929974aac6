"""The port's op counting and contraction audit against the JAX package's
``core/counting.py``, and the rest of the core algebra
(``square_approx``, ``pm_matmul_approx``, the process default mode).

- The ``*_counted`` executors and the ``*_square_count`` closed forms: the
  same squares, multiplies and results, exactly (both run numpy float64).
- ``square_approx`` / ``pm_matmul_approx``: integers exact; f32 within
  ``k * 2^-23 * (max|a| + max|b|)^2`` of the JAX function run op by op.
  Both sides square the same bf16 values, so only the order of the f32
  sums differs.
- The audit of a ``fairsquare-demo.reduced()`` forward and of a paged
  prefill chunk and decode step: ``by_site``, ``total_mults`` and
  ``fraction_square`` equal JAX's exactly, with no policy and with
  ``SQUARE_GEMMS_POLICY`` under ``square_pallas``, and under ``standard``
  (0.0).  The paged step is held on both attention routes: ``gather`` on
  both sides, and ``kernel`` (the port's K4 plain version against the JAX
  Pallas K4 in interpret mode).  JAX traces its layer scan once and scales
  the notes (``count_scale``); the port notes every layer it runs: the
  totals agree, the record counts need not.
"""
import contextlib
import dataclasses
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import jax.experimental.pallas.tpu as pltpu  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs.base import SQUARE_GEMMS_POLICY as J_SQG  # noqa: E402
from repro.core import counting as jcount  # noqa: E402
from repro.core import matmul as jmm  # noqa: E402
from repro.core import squares as jsq  # noqa: E402
from repro.core.einsum import fs_einsum as jeinsum  # noqa: E402
from repro.models.lm import build_model as jbuild  # noqa: E402
from repro.serve import paged as jpaged  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs.base import SQUARE_GEMMS_POLICY as T_SQG  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import counting as tcount  # noqa: E402
from repro_torch.core import matmul as tmm  # noqa: E402
from repro_torch.core import squares as tsq  # noqa: E402
from repro_torch.core.einsum import fs_einsum as teinsum  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from test_torch_moe import _one_thread  # noqa: E402,F401


@contextlib.contextmanager
def _route(value):
    """REPRO_ROUTE for one side's calls only (both packages read it)."""
    old = os.environ.pop("REPRO_ROUTE", None)
    if value is not None:
        os.environ["REPRO_ROUTE"] = value
    try:
        yield
    finally:
        os.environ.pop("REPRO_ROUTE", None)
        if old is not None:
            os.environ["REPRO_ROUTE"] = old


def _operands(shape_a, shape_b, seed, complex_=False):
    rng = np.random.default_rng(seed)

    def one(shape):
        x = rng.normal(size=shape)
        if complex_:
            x = x + 1j * rng.normal(size=shape)
        return x
    return one(shape_a), one(shape_b)


# -------------------------------------------------------- op counting
SHAPES = [(1, 1, 1), (3, 5, 4), (8, 16, 2), (7, 3, 11)]


@pytest.mark.parametrize("m,n,p", SHAPES)
def test_closed_forms_match_jax(m, n, p):
    for name in ("real_matmul_square_count", "cpm4_square_count",
                 "cpm3_square_count"):
        assert getattr(tcount, name)(m, n, p) == \
            getattr(jcount, name)(m, n, p), name


@pytest.mark.parametrize("m,n,p", SHAPES)
@pytest.mark.parametrize("fn,complex_,closed", [
    ("pm_matmul_counted", False, "real_matmul_square_count"),
    ("cpm4_matmul_counted", True, "cpm4_square_count"),
    ("cpm3_matmul_counted", True, "cpm3_square_count"),
    ("standard_matmul_counted", False, None)])
def test_counted_executors_match_jax(fn, complex_, closed, m, n, p):
    a, b = _operands((m, n), (n, p), seed=m * 100 + n * 10 + p,
                     complex_=complex_)
    tc, jc = tcount.OpCounter(), jcount.OpCounter()
    tout = getattr(tcount, fn)(a, b, tc)
    jout = getattr(jcount, fn)(a, b, jc)
    np.testing.assert_array_equal(tout, jout)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    if closed is None:
        assert tc.mults == m * n * p and tc.squares == 0
        np.testing.assert_allclose(tout, a @ b, rtol=1e-12, atol=1e-12)
    else:
        assert tc.squares == getattr(tcount, closed)(m, n, p)
        np.testing.assert_allclose(tout, a @ b, rtol=1e-9, atol=1e-9)


def test_op_counter_add_counts_broadcast():
    c = tcount.OpCounter()
    c.add(np.ones((3, 1)), np.ones((1, 4)))
    assert c.adds == 12 == jcount.OpCounter().add(
        np.ones((3, 1)), np.ones((1, 4))).size


def test_standard_counted_refuses_mismatched_shapes():
    with pytest.raises(ValueError, match="mismatch"):
        tcount.standard_matmul_counted(np.ones((2, 3)), np.ones((4, 2)),
                                       tcount.OpCounter())


# ----------------------------------------------------- approximate squares
@pytest.mark.parametrize("drop_bits", [0, 2, 4, 6])
def test_square_approx_int_exact(drop_bits):
    x = np.random.default_rng(drop_bits).integers(-128, 128, 257, np.int8)
    want = np.asarray(jsq.square_approx(jnp.asarray(x), drop_bits=drop_bits))
    got = tsq.square_approx(torch.from_numpy(x), drop_bits=drop_bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_square_approx_float_matches_jax(dtype):
    x = (np.random.default_rng(3).normal(size=300) * 10).astype(dtype)
    want = np.asarray(jsq.square_approx(jnp.asarray(x)))
    got = tsq.square_approx(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("drop_bits", [0, 3, 5])
@pytest.mark.parametrize("m,k,n,block", [(4, 8, 5, 128), (6, 300, 7, 128),
                                         (3, 37, 2, 16)])
def test_pm_matmul_approx_int_exact(m, k, n, block, drop_bits):
    rng = np.random.default_rng(k + drop_bits)
    a = rng.integers(-128, 128, (m, k), np.int8)
    b = rng.integers(-128, 128, (k, n), np.int8)
    want = np.asarray(jmm.pm_matmul_approx(jnp.asarray(a), jnp.asarray(b),
                                           drop_bits=drop_bits, block=block))
    got = tmm.pm_matmul_approx(torch.from_numpy(a), torch.from_numpy(b),
                               drop_bits=drop_bits, block=block)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if drop_bits == 0:
        np.testing.assert_array_equal(got.numpy(),
                                      a.astype(np.int64) @ b.astype(np.int64))


@pytest.mark.parametrize("m,k,n,block", [(4, 8, 5, 128), (6, 300, 7, 128),
                                         (3, 37, 2, 16)])
def test_pm_matmul_approx_f32_matches_jax(m, k, n, block):
    """Held to the JAX function run op by op (``jax.disable_jit``): there
    every square is the bf16 product, rounded to bf16, as
    ``square_approx`` specifies.  Inside the jitted ``lax.scan`` body XLA's
    CPU fusion multiplies the bf16-rounded operands in f32 and drops that
    rounding, so the jitted reference differs by up to ~2^-9 of a square
    per term."""
    rng = np.random.default_rng(k)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jmm.pm_matmul_approx(jnp.asarray(a),
                                               jnp.asarray(b), block=block))
    got = tmm.pm_matmul_approx(torch.from_numpy(a), torch.from_numpy(b),
                               block=block).numpy()
    tol = k * 2.0 ** -23 * (np.abs(a).max() + np.abs(b).max()) ** 2
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


# ---------------------------------------------------------- default mode
def test_set_default_mode_reaches_fs_einsum():
    assert tmm.get_default_mode() == "standard"
    x, y = torch.ones(4, 8), torch.ones(8, 2)
    try:
        tmm.set_default_mode("square_virtual")
        with tcount.track_contractions() as ctr:
            teinsum("mk,kn->mn", x, y, site="ffn")
            teinsum("mk,kn->mn", x, y, mode="standard", site="ffn")
        assert [r.mode for r in ctr.records] == ["square_virtual",
                                                 "standard"]
    finally:
        tmm.set_default_mode("standard")
    with pytest.raises(ValueError, match="unknown matmul mode"):
        tmm.set_default_mode("square_magic")
    assert tmm.get_default_mode() == "standard"


# ---------------------------------------------------------- the audit
def test_einsum_note_matches_jax_per_spec():
    """One contraction per spec class (plain, batched, summed-out index,
    ellipsis) notes the same B*M*K*N in both packages, standard included."""
    cases = [("mk,kn->mn", (4, 8), (8, 2)),
             ("bmk,bkn->bnm", (3, 4, 8), (3, 8, 5)),
             ("bqkgh,btkh->bkgqt", (2, 3, 2, 2, 4), (2, 5, 2, 4)),
             ("ij,jk->i", (3, 4), (4, 5)),
             ("...k,kn->...n", (2, 3, 4), (4, 6))]
    for mode in ("standard", "square_virtual", "square_pallas"):
        with tcount.track_contractions() as tc, \
                jcount.track_contractions() as jc:
            for spec, xs, ys in cases:
                x, y = _operands(xs, ys, seed=len(spec))
                x, y = x.astype(np.float32), y.astype(np.float32)
                teinsum(spec, torch.from_numpy(x), torch.from_numpy(y),
                        mode=mode, site=spec)
                with _route("matmul=virtual"):
                    jeinsum(spec, jnp.asarray(x), jnp.asarray(y), mode=mode,
                            site=spec)
        assert tc.by_site() == jc.by_site(), mode
        assert [(r.site, r.mode, r.mults) for r in tc.records] == \
            [(r.site, r.mode, r.mults) for r in jc.records]


def test_empty_audit_warns():
    with pytest.warns(tcount.EmptyAuditWarning):
        with tcount.track_contractions() as ctr:
            pass
    assert ctr.fraction_square == 0.0 and ctr.summary()["by_site"] == {}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with tcount.track_contractions(allow_empty=True):
            pass


def test_count_scale_and_nested_counters():
    x, y = torch.ones(2, 3), torch.ones(3, 4)
    with tcount.track_contractions() as outer:
        with tcount.count_scale(5):
            teinsum("mk,kn->mn", x, y, mode="square_exact", site="a")
        with tcount.track_contractions() as inner:
            teinsum("mk,kn->mn", x, y, site="b")
    assert outer.by_site() == {
        "a": {"mults": 120, "square_mults": 120, "demoted_mults": 0},
        "b": {"mults": 24, "square_mults": 0, "demoted_mults": 0}}
    assert inner.total_mults == 24 and inner.fraction_square == 0.0
    assert outer.fraction_square == 120 / 144


def test_summary_and_bwd_split_like_jax():
    notes = [("ffn", "square_pallas", 100, False),
             ("ffn.bwd_x", "square_virtual", 60, False),
             ("ffn.bwd_w", "standard", 40, False),
             ("logits", "standard", 30, True)]
    with tcount.track_contractions() as tc, \
            jcount.track_contractions() as jc:
        for site, mode, mults, demoted in notes:
            tcount.note_contraction(site=site, spec="s", mode=mode,
                                    mults=mults, demoted=demoted)
            jcount.note_contraction(site=site, spec="s", mode=mode,
                                    mults=mults, demoted=demoted)
    assert tc.summary() == jc.summary()
    assert tc.fraction_square_bwd == 0.6
    assert tc.demoted_sites() == ["logits"]


def _lm_pair(mode, policy, dtype="float32", arch="fairsquare-demo"):
    jc = dataclasses.replace(jget(arch).reduced(), matmul_mode=mode,
                             dtype=dtype)
    tc = dataclasses.replace(tget(arch).reduced(), matmul_mode=mode,
                             dtype=dtype)
    if policy:
        jc = dataclasses.replace(jc, contraction_policy=J_SQG)
        tc = dataclasses.replace(tc, contraction_policy=T_SQG)
    jm = jbuild(jc)
    params = jm.init(jax.random.PRNGKey(0))
    tm = LM(tc, device=torch.device("cpu"))
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


AUDITS = [("square_pallas", False), ("square_pallas", True),
          ("standard", False)]


def _same_audit(tc, jc, mode, policy, softmax_square=False):
    """Equal audits; the fraction is 0 under standard, 1 with every
    contraction square, between under the policy (the softmax path on the
    multiplier) unless K4 serves that path in square form."""
    assert tc.by_site() == jc.by_site()
    assert tc.total_mults == jc.total_mults > 0
    assert tc.fraction_square == jc.fraction_square
    if mode == "standard":
        assert tc.fraction_square == 0.0
    elif not policy or softmax_square:
        assert tc.fraction_square == 1.0
    else:
        assert 0.0 < tc.fraction_square < 1.0


@pytest.mark.parametrize("mode,policy", AUDITS)
def test_forward_audit_matches_jax(mode, policy):
    jm, jparams, tm = _lm_pair(mode, policy)
    toks = np.random.default_rng(1).integers(0, tm.cfg.vocab, (2, 40)) \
        .astype(np.int32)
    with _route("matmul=virtual"), jcount.track_contractions() as jc:
        jh, _, _ = jm.forward(jparams, {"tokens": jnp.asarray(toks)})
        jm.logits(jparams, jh)
    with _route(None), torch.no_grad(), tcount.track_contractions() as tc:
        th, _, _ = tm.forward(tm.tree(), {"tokens": torch.from_numpy(toks)})
        tm.logits(tm.tree(), th)
    _same_audit(tc, jc, mode, policy)
    if policy:
        assert tc.by_site()["attn_scores"]["square_mults"] == 0
        assert tc.by_site()["ffn"]["square_mults"] == \
            tc.by_site()["ffn"]["mults"]


def _paged_inputs(cfg, B=3, S=8, nb=8, bs=16, lo=0, seed=0):
    """Block tables giving each of B sequences nb blocks; tokens at
    positions lo..lo+S-1."""
    num_blocks = 1 + B * nb
    tables = (1 + np.arange(B * nb, dtype=np.int32)).reshape(B, nb)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)
    poss = np.tile(np.arange(lo, lo + S, dtype=np.int32), (B, 1))
    return num_blocks, bs, tables, toks, poss


def _jax_paged(jm, params, cfg, num_blocks, bs, steps):
    cache = jm.init_paged_cache(num_blocks * bs)
    pos_pool = jnp.asarray(jpaged.empty_pos_pool(num_blocks, bs))
    ctrs = []
    for tables, toks, poss in steps:
        with jcount.track_contractions() as c:
            hidden, cache, pos_pool = jm.decode_paged(
                params, cache, jnp.asarray(toks), jnp.asarray(poss),
                jnp.asarray(tables), pos_pool, block_size=bs)
            jm.logits(params, hidden)
        ctrs.append(c)
    return ctrs


def _torch_paged(tm, num_blocks, bs, steps):
    from repro_torch.serve import paged as tpaged
    cache = tm.init_paged_cache(num_blocks * bs)
    pos_pool = torch.from_numpy(tpaged.empty_pos_pool(num_blocks, bs))
    ctrs = []
    params = tm.tree()
    for tables, toks, poss in steps:
        with torch.no_grad(), tcount.track_contractions() as c:
            hidden = tm.decode_paged(params, cache, torch.from_numpy(toks),
                                     torch.from_numpy(poss),
                                     torch.from_numpy(tables), pos_pool,
                                     block_size=bs)
            tm.logits(params, hidden)
        ctrs.append(c)
    return ctrs


@pytest.mark.parametrize("route", ["gather", "kernel"])
@pytest.mark.parametrize("mode,policy", AUDITS)
def test_paged_step_audit_matches_jax(mode, policy, route, monkeypatch):
    """A paged prefill chunk of 8 tokens, then one decode step, over
    128-token tables: the K4 route at both (S <= 8, T >= 64) unless the
    gather route is pinned."""
    # the JAX Pallas K4 runs in interpret mode here only with this alias
    # (the venv's JAX renamed TPUCompilerParams)
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                        raising=False)
    jm, jparams, tm = _lm_pair(mode, policy)
    num_blocks, bs, tables, toks, poss = _paged_inputs(tm.cfg)
    dec = np.random.default_rng(9).integers(0, tm.cfg.vocab, (3, 1)) \
        .astype(np.int32)
    steps = [(tables, toks, poss),
             (tables, dec, np.full((3, 1), 8, np.int32))]
    with _route(f"matmul=virtual,paged_attn={route}"):
        jctrs = _jax_paged(jm, jparams, tm.cfg, num_blocks, bs, steps)
    with _route(f"paged_attn={route}"):
        tctrs = _torch_paged(tm, num_blocks, bs, steps)
    for tc, jc in zip(tctrs, jctrs):
        _same_audit(tc, jc, mode, policy, softmax_square=route == "kernel")
    if mode == "square_pallas" and route == "kernel":
        # the K4 notes: square even under the policy, as in JAX
        site = tctrs[1].by_site()["attn_scores"]
        assert site["square_mults"] == site["mults"] > 0
