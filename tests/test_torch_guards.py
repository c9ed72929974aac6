"""The port's numerics guard (``core/guards.py``) and route-health breaker
(``kernels/routing.py``) against the JAX package's.

The failure regime: f32 operands of magnitude 1e19 whose products cancel,
so the multiplier route is finite while the square route's ``(a + b)^2``
saturates f32 (``|a + b| > 1.84e19``).  Under the guard both packages trip
on the same (site, shape, dtype) keys, recompute each tripped call on the
standard route, demote a key at its trip limit and note the demoted calls
in the contraction audit.  The port's K4 path adds a counted recompute on
the gather route (never a quiet one): a trip in the breaker, a
``guard.trip`` event and ``engine_guard_recomputes_total``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import counting as jcount  # noqa: E402
from repro.core import guards as jguards  # noqa: E402
from repro.core.einsum import fs_einsum as jeinsum  # noqa: E402
from repro.kernels import routing as jrouting  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs.base import SQUARE_GEMMS_POLICY  # noqa: E402
from repro_torch.core import counting as tcount  # noqa: E402
from repro_torch.core import guards as tguards  # noqa: E402
from repro_torch.core.einsum import fs_einsum as teinsum  # noqa: E402
from repro_torch.kernels import routing as trouting  # noqa: E402
from repro_torch.kernels import sq_paged_attn as tk4  # noqa: E402
from repro_torch.launch.serve import make_requests  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve import paged as tpaged  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_state():
    """Route health, the guard-policy stacks and the tracers are process
    globals in both packages: reset them around every test."""
    def reset():
        trouting.reset_route_health()
        jrouting.reset_route_health()
        # the trip ordinals and the recompute count are process-wide and
        # outlive a reset: start each test from zero on both sides
        trouting.route_health().trip_seq = 0
        trouting.route_health().recomputes = 0
        jrouting.route_health().trip_seq = 0
        jguards.clear_pending_trips()
        del tguards._POLICY_STACK[:]
        del jguards._POLICY_STACK[:]
        ttrace.disable()
        jtrace.disable()
    reset()
    yield
    reset()


def _cancelling(m=4, k=8, n=4, mag=1e19):
    x = np.full((m, k), mag, np.float32)
    x[:, 1::2] *= -1.0                     # alternating signs down K
    y = np.full((k, n), mag, np.float32)
    return x, y


# ---------------------------------------------------------------- policy
def test_guard_policy_default_off_scoping_and_env(monkeypatch):
    monkeypatch.delenv("REPRO_GUARD", raising=False)
    assert not tguards.guard_policy().enabled
    with tguards.guarded(trip_limit=5):
        p = tguards.guard_policy()
        assert p.enabled and p.trip_limit == 5
        with tguards.guarded(enabled=False):
            assert not tguards.guard_policy().enabled
        assert tguards.guard_policy().enabled
    assert not tguards.guard_policy().enabled
    monkeypatch.setenv("REPRO_GUARD", "1")
    assert tguards.guard_policy().enabled == jguards.guard_policy().enabled
    assert tguards.guard_policy().trip_limit == tguards.DEFAULT_TRIP_LIMIT \
        == jguards.DEFAULT_TRIP_LIMIT
    tguards.set_guard_policy(False)
    assert not tguards.guard_policy().enabled   # set_ overrides the env
    monkeypatch.setenv("REPRO_GUARD", "0")
    del tguards._POLICY_STACK[:]
    assert not tguards.guard_policy().enabled


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_check_finite(dtype):
    assert tguards.check_finite(torch.ones(3, 3, dtype=dtype)) is True
    for bad in (float("inf"), float("-inf"), float("nan")):
        t = torch.ones(5, dtype=dtype)
        t[2] = bad
        assert tguards.check_finite(t) is False
    assert tguards.check_finite(torch.ones(4, dtype=torch.int32)) is True
    assert tguards.check_finite(torch.tensor([1 + 1j, float("nan")])) is False


@pytest.mark.parametrize("tdt,jdt", [(torch.float32, jnp.float32),
                                     (torch.bfloat16, jnp.bfloat16),
                                     (torch.float16, jnp.float16),
                                     (torch.int8, jnp.int8)])
def test_health_key_letter_for_letter(tdt, jdt):
    for sizes in ((1, 4, 8, 4), (8, 1, 2, 1, 64, 128)):
        assert trouting.health_key("attn_paged", sizes, tdt) == \
            jrouting.health_key("attn_paged", sizes, jdt)
    assert trouting.health_key("ffn", (1, 4, 8, 4), torch.float32) == \
        "ffn|1x4x8x4|float32"


def test_route_health_matches_jax():
    t, j = trouting.RouteHealth(), jrouting.RouteHealth()
    seq = ["a|1x2x3x4|float32"] * 4 + ["b|1x1x1x1|bfloat16"] * 2
    for key in seq:
        assert t.record_trip(key, limit=3) == j.record_trip(key, limit=3)
    assert t.summary() == j.summary()
    assert t.snapshot() == j.snapshot()
    assert t.epoch == j.epoch == 1
    assert t.is_demoted("a|1x2x3x4|float32")
    assert not t.is_demoted("b|1x1x1x1|bfloat16")


def test_reset_route_health_moves_the_epoch():
    h = trouting.route_health()
    h.record_trip("k", limit=1)
    e = trouting.route_epoch()
    trouting.reset_route_health()
    assert trouting.route_epoch() == e + 1
    assert h.summary() == {"trips": {}, "demotions": {}}
    trouting.reset_route_health()               # nothing demoted: no move
    assert trouting.route_epoch() == e + 1


# ------------------------------------------------- the saturating einsum
@pytest.mark.parametrize("tmode,jmode,mkn", [
    ("square_exact", "square_exact", (4, 8, 4)),
    ("square_scan", "square_scan", (4, 8, 4)),
    ("square_pallas", "square_exact", (32, 64, 32))])
@pytest.mark.parametrize("limit", [1, 3])
def test_saturating_einsum_trips_and_demotes_like_jax(tmode, jmode, mkn,
                                                      limit):
    """Five guarded calls: both packages trip on the same key, serve the
    finite standard result every time, demote at the limit, and note the
    same demoted volume.  The port's ``square_pallas`` runs K1's plain
    version here (a volume above the virtual route's floor) and is held to
    JAX's ``square_exact`` (the Pallas K1 cannot run in this venv): the key
    does not name the mode."""
    x, y = _cancelling(*mkn)
    ref = np.asarray(jnp.einsum("mk,kn->mn", x, y))
    assert np.isfinite(ref).all()
    raw = teinsum("mk,kn->mn", torch.from_numpy(x), torch.from_numpy(y),
                  mode=tmode)
    assert not torch.isfinite(raw).all()        # the square form saturates
    with ttrace.capture() as ttr, jtrace.capture() as jtr:
        with tguards.guarded(trip_limit=limit), \
                tcount.track_contractions() as tc:
            for _ in range(5):
                out = teinsum("mk,kn->mn", torch.from_numpy(x),
                              torch.from_numpy(y), mode=tmode,
                              site="trip_site")
                np.testing.assert_allclose(out.numpy(), ref)
        with jguards.guarded(trip_limit=limit, compiled=False), \
                jcount.track_contractions() as jc:
            for _ in range(5):
                jeinsum("mk,kn->mn", jnp.asarray(x), jnp.asarray(y),
                        mode=jmode, site="trip_site")
    th, jh = trouting.route_health(), jrouting.route_health()
    assert th.summary() == jh.summary()
    assert th.snapshot() == jh.snapshot()
    key = "trip_site|1x{}x{}x{}|float32".format(*mkn)
    assert th.trips[key] == limit and th.is_demoted(key)
    assert th.recomputes == limit                # each trip recomputed once
    assert tc.summary() == jc.summary()
    assert tc.fraction_demoted == 1.0 and tc.fraction_square == 0.0
    assert [r.demoted for r in tc.records] == [True] * 5
    events = [(r.name, r.args) for r in ttr.records()]
    assert events == [(r.name, r.args) for r in jtr.records()]
    assert [n for n, _ in events].count("guard.trip") == limit
    assert [n for n, _ in events].count("guard.demote") == 1


def test_guard_is_per_key_and_off_by_default():
    x, y = _cancelling()
    rng = np.random.default_rng(1)
    gx = rng.normal(size=(4, 8)).astype(np.float32)
    gy = rng.normal(size=(8, 4)).astype(np.float32)
    with tcount.track_contractions() as ctr:
        out = teinsum("mk,kn->mn", torch.from_numpy(x), torch.from_numpy(y),
                      mode="square_exact", site="unguarded")
    assert not torch.isfinite(out).all()         # unchecked without a guard
    assert trouting.route_health().summary()["trips"] == {}
    assert ctr.fraction_square == 1.0
    with tguards.guarded(trip_limit=1):
        teinsum("mk,kn->mn", torch.from_numpy(x), torch.from_numpy(y),
                mode="square_exact", site="bad")
        good = teinsum("mk,kn->mn", torch.from_numpy(gx),
                       torch.from_numpy(gy), mode="square_exact",
                       site="good")
    h = trouting.route_health()
    assert h.is_demoted("bad|1x4x8x4|float32")
    assert not h.is_demoted("good|1x4x8x4|float32")
    np.testing.assert_allclose(good.numpy(), gx @ gy, rtol=1e-4, atol=1e-5)


def test_standard_mode_is_never_guarded():
    x, y = _cancelling()
    with tguards.guarded(trip_limit=1):
        teinsum("mk,kn->mn", torch.from_numpy(x), torch.from_numpy(y),
                mode="standard", site="std")
    assert trouting.route_health().summary()["trips"] == {}


# ------------------------------------------------ K4's counted recompute
def _paged_setup(B=2, nb=8, bs=16):
    cfg = dataclasses.replace(tget("fairsquare-demo").reduced(),
                              matmul_mode="square_pallas",
                              contraction_policy=SQUARE_GEMMS_POLICY)
    tm = LM(cfg, device=torch.device("cpu"))
    num_blocks = 1 + B * nb
    tables = torch.arange(1, 1 + B * nb, dtype=torch.int32).reshape(B, nb)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, 1)).astype(np.int32))
    poss = torch.full((B, 1), 5, dtype=torch.int32)
    return tm, num_blocks, bs, tables, toks, poss


def _paged_call(tm, num_blocks, bs, tables, toks, poss):
    cache = tm.init_paged_cache(num_blocks * bs)
    pool = torch.from_numpy(tpaged.empty_pos_pool(num_blocks, bs))
    with torch.no_grad():
        return tm.decode_paged(tm.tree(), cache, toks, poss, tables, pool,
                               block_size=bs)


@pytest.fixture
def nan_k4(monkeypatch):
    """K4 returning NaN: a kernel whose result is not finite."""
    calls = []

    def bad(q, *a, **k):
        calls.append(q.shape)
        return torch.full(q.shape, float("nan"))
    monkeypatch.setattr(tk4, "sq_paged_attn_k4", bad)
    return calls


def test_k4_nonfinite_result_is_a_counted_recompute(nan_k4, monkeypatch):
    monkeypatch.delenv("REPRO_ROUTE", raising=False)
    tm, *args = _paged_setup()
    monkeypatch.setenv("REPRO_ROUTE", "paged_attn=gather")
    want = _paged_call(tm, *args)
    monkeypatch.delenv("REPRO_ROUTE")
    with ttrace.capture() as tr, tguards.guarded(trip_limit=2), \
            tcount.track_contractions() as ctr:
        got = _paged_call(tm, *args)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    h = trouting.route_health()
    key = "attn_paged|2x1x2x2x16x128|float32"
    assert len(nan_k4) == 2                      # one launch a layer
    assert h.trips == {key: 2} and h.is_demoted(key)
    assert h.recomputes == 2
    assert [r.name for r in tr.records()] == ["guard.trip", "guard.trip",
                                              "guard.demote"]
    # the recompute's contractions are the gather route's, noted as such
    specs = {r.spec for r in ctr.records if r.site == "attn_scores"}
    assert specs == {"bqkgh,btkh->bkgqt"}
    # demoted: the next call never launches K4
    _paged_call(tm, *args)
    assert len(nan_k4) == 2


def test_k4_without_guard_is_not_recomputed(nan_k4):
    tm, *args = _paged_setup()
    out = _paged_call(tm, *args)
    assert not torch.isfinite(out).all()
    assert trouting.route_health().recomputes == 0
    assert trouting.route_health().summary()["trips"] == {}


def test_engine_counts_guard_recomputes(nan_k4):
    """An engine with ``guard=True`` whose K4 returns NaN: every request
    still completes with the gather route's tokens, and the snapshot
    counts the recomputes and shows the demoted key."""
    tm, *_ = _paged_setup()
    geo = dict(max_slots=4, block_size=16, num_blocks=40, blocks_per_seq=8,
               prefill_chunk=16, max_new_tokens=4)
    reqs = make_requests(tm.cfg, 3, seed=2, lo=4, hi=12)
    clean = teng.Engine(tm, teng.EngineConfig(**geo), device="cpu")
    import os
    os.environ["REPRO_ROUTE"] = "paged_attn=gather"
    try:
        want = clean.run([teng.Request(r.rid, r.tokens) for r in reqs])
    finally:
        del os.environ["REPRO_ROUTE"]
    eng = teng.Engine(tm, teng.EngineConfig(guard=True, **geo), device="cpu")
    got = eng.run([teng.Request(r.rid, r.tokens) for r in reqs])
    assert {k: r.tokens for k, r in got.items()} == \
        {k: r.tokens for k, r in want.items()}
    snap = eng.obs_snapshot()
    n = snap["counters"]["engine_guard_recomputes_total"]
    assert n == eng.metrics.guard_recomputes == \
        trouting.route_health().recomputes > 0
    assert snap["engine"]["guard_trips"] == 0    # no logits row tripped
    assert any(h["demoted"] for h in snap["route_health"])
    assert clean.obs_snapshot()["counters"][
        "engine_guard_recomputes_total"] == 0
