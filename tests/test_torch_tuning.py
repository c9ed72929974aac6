"""The port's launch planner (``repro_torch/kernels/tuning.py``) and route
overrides (``repro_torch/kernels/routing.py``) on the CPU, against the
contracts of ``tests/test_kernel_tuning.py`` and
``tests/test_prepared_routing.py``.

- Model mode equals the launch rule each CUDA source applied before the
  planner existed, on a grid of shapes: the rules are written out here
  again, as they stood in the sources, so that a change to a mirror shows.
- Precedence: an explicit plan over the cache over the model; a cache entry
  that names no variant of the shape raises.
- The cache round-trips through its file; a miss warns once a key, with
  the model's entry ready to paste; lookups count in the default
  registry's ``tuning_cache_hits_total`` / ``tuning_cache_misses_total``
  and trace a ``tuning.cache`` event; ``REPRO_AUTOTUNE=0`` reads no file
  and warns nothing.
- The cache file is the port's own: ``REPRO_TORCH_TUNING_CACHE`` or the
  file in the port's package, never the JAX package's file or variable.
- Route overrides: keys equal to JAX's ``route_key`` letter for letter; a
  pin keyed on the accumulator dtype, so a bf16 or int8 pin reaches a bf16
  or int8 call; consulted after ``REPRO_ROUTE`` and before the rules;
  ``REPRO_AUTOTUNE=0`` ignores it; ``select_route`` as the typed selectors.
- ``prepared.clear_plan_cache`` drops the memo; ``prepared.is_prepared``.
"""
import itertools
import json
import os
import warnings
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import routing as jrt  # noqa: E402
from repro.kernels import tuning as jtuning  # noqa: E402
from repro_torch.core import prepared  # noqa: E402
from repro_torch.kernels import routing, tuning  # noqa: E402
from repro_torch.kernels.sq_conv2d import conv2d_out_hw  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from test_torch_moe import _one_thread  # noqa: E402,F401

SMS = 132                     # an H100 SXM


@pytest.fixture(autouse=True)
def _scratch_cache(tmp_path, monkeypatch):
    """Every test on a cache file of its own, autotune on, no route pin."""
    monkeypatch.setenv(tuning.CACHE_ENV, str(tmp_path / "cache.json"))
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    monkeypatch.delenv("REPRO_ROUTE", raising=False)
    tuning.clear_cache()
    yield
    tuning.clear_cache()


# -- the launch rules as the CUDA sources applied them before the planner --
def _k1_rule(m, n):
    return (8, 64) if m <= 8 else (32, 128)


def _k2_rule(nb, m, n):
    rows = 1 if m == 1 else 4 if m <= 32 else 8
    blocks = nb * -(-m // rows) * -(-n // 64)
    return rows, 64 if n > 32 and blocks >= 96 else 32


def _k4_rule(batch, kv, nb, sms):
    return max(1, min(8, nb, -(-8 * sms // max(1, batch * kv))))


def _cpm_rule(m, n, own):
    blocks = -(-m // (16 * own[0])) * -(-n // (16 * own[1]))
    return tuple(own) if blocks >= 128 else (1, 1)


def _k7_rule(xshape, n_filters, khw, stride, pads, sms):
    """The band and the split count of ``sq_conv2d.cu``'s launch_shape
    (4-byte elements, an aligned input)."""
    B, C, H, W = xshape
    kh, kw = khw
    sh, sv = stride
    oh, ow = conv2d_out_hw((H, W), khw, stride, pads)
    tc = next((d for d in range(8, 17) if ow % d == 0), min(ow, 8))
    vec = W % 4 == 0
    pt = 64
    while True:
        whole = pt % tc == 0
        rows = pt // tc if whole else (pt - 1) // tc + 2
        cross = 0 if whole and oh % rows == 0 else -(-(rows - 1) // oh)
        wr = (rows - 1) * sh + kh + cross * max(0, kh - sh)
        wc = (tc - 1) * sv + kw
        if vec:
            wc = -(-((-pads[1][0] & 3 if tc * sv % 4 == 0 else 3) + wc)
                   // 4) * 4
        if pt == 1 or 2 * 4 * wr * wc <= 64 * 1024:
            break
        pt //= 2
    cs = min(16, C, max(1, 64 * 1024 // (2 * 4 * wr * wc)))
    k_tiles = -(-C // cs) * -(-kh * kw * cs // 16)
    tiles = -(-ow // tc) * -(-B * oh * tc // pt) * -(-n_filters // 64)
    best = None
    for z in range(1, min(8, k_tiles) + 1):
        cost = max(-(-tiles * z // sms), 3) * -(-k_tiles // z)
        if best is None or cost < best[0]:
            best = (cost, z)
    per_split = -(-k_tiles // best[1])
    return tc, -(-k_tiles // per_split)


DIMS = (1, 2, 4, 8, 9, 31, 32, 33, 64, 100, 768, 3072)


@pytest.fixture
def model_mode(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    tuning.clear_cache()


def test_model_mode_is_the_launch_rule_k1_k2_k3(model_mode):
    for m, n in itertools.product(DIMS, DIMS + (32000,)):
        p = tuning.plan_matmul(m, n, 64)
        assert (p.rows, p.cols) == _k1_rule(m, n), (m, n)
        for nb in (1, 3, 12, 48, 96):
            for kind in ("sq_matmul_batched", "sq_matmul_folded"):
                p = tuning.plan_matmul(m, n, 64, batch=nb, kind=kind)
                assert (p.rows, p.cols) == _k2_rule(nb, m, n), (nb, m, n)


def test_model_mode_is_the_launch_rule_k4_k5_k6(model_mode):
    for batch, s, kv, g, nb in itertools.product(
            (1, 4, 8, 32), (1, 4), (1, 2, 12, 32), (1, 2), (1, 3, 8, 64)):
        p = tuning.plan_paged_attn(batch, s, kv, g, 64, nb, 16,
                                   torch.bfloat16, sms=SMS)
        assert p.splits == _k4_rule(batch, kv, nb, SMS)
    for m, n in itertools.product(DIMS + (4096,), DIMS + (1024,)):
        for kind, own in (("cpm3_matmul", (8, 4)), ("cpm4_matmul", (4, 4))):
            assert tuning.plan_cpm(kind, m, n, 64).thread_tile == \
                _cpm_rule(m, n, own), (kind, m, n)


K7_SHAPES = [
    ((8, 3, 224, 224), 64, (7, 7), (2, 2), ((3, 3), (3, 3))),
    ((8, 256, 56, 56), 64, (1, 1), (1, 1), ((0, 0), (0, 0))),
    ((8, 64, 56, 56), 64, (3, 3), (1, 1), ((1, 1), (1, 1))),
    ((8, 128, 56, 56), 128, (3, 3), (2, 2), ((1, 1), (1, 1))),
    ((8, 256, 14, 14), 256, (3, 3), (1, 1), ((1, 1), (1, 1))),
    ((8, 512, 7, 7), 512, (3, 3), (1, 1), ((1, 1), (1, 1))),
    ((2, 3, 17, 13), 5, (3, 3), (1, 1), ((1, 1), (1, 1))),
    ((2, 7, 10, 11), 3, (3, 5), (1, 1), ((2, 0), (0, 3))),
    ((2, 5, 31, 29), 65, (7, 7), (2, 2), ((3, 2), (1, 3))),
    ((1, 2, 24, 24), 3, (24, 24), (1, 1), ((0, 0), (0, 0))),
    ((1, 3, 23, 60), 4, (3, 3), (1, 1), ((1, 1), (1, 1))),
]


@pytest.mark.parametrize("shape", K7_SHAPES,
                         ids=lambda s: "x".join(map(str, s[0])))
def test_model_mode_is_the_launch_rule_k7(shape, model_mode):
    p = tuning.plan_conv2d(*shape, sms=SMS)
    assert (p.band, p.splits) == _k7_rule(*shape, SMS)
    assert p in tuning.candidates_conv2d(*shape)


def test_explicit_plan_wins_and_is_checked():
    key = tuning.matmul_key("sq_matmul", 8, 768, 768, torch.float32)
    tuning.save_cache({key: {"rows": 32, "cols": 128}})
    assert tuning.plan_matmul(8, 768, 768) == tuning.K1Plan(32, 128)
    assert tuning.plan_matmul(8, 768, 768, plan=tuning.K1Plan(8, 64)) == \
        tuning.K1Plan(8, 64)
    with pytest.raises(ValueError, match="variant"):
        tuning.plan_matmul(8, 768, 768, plan=tuning.K1Plan(16, 64))
    with pytest.raises(ValueError, match="variant"):
        tuning.plan_conv2d(*K7_SHAPES[0], plan=tuning.Conv2DPlan(8, 9))


def test_cache_round_trips_and_bad_entries_raise(tmp_path):
    path = Path(os.environ[tuning.CACHE_ENV])
    entries = {
        tuning.matmul_key("sq_matmul", 4, 768, 3072, torch.float32):
            {"rows": 32, "cols": 128, "us_per_call": 1.5},
        tuning.matmul_key("sq_matmul_batched", 32, 128, 64, torch.float32,
                          12): {"rows": 8, "cols": 32},
        tuning.paged_attn_key(8, 1, 12, 1, 64, 8, 16, torch.bfloat16):
            {"splits": 4},
        tuning.matmul_key("cpm3_matmul", 64, 64, 64, torch.float32):
            {"thread_tile": [8, 4]},
        tuning.conv2d_key(*K7_SHAPES[3], torch.float32):
            {"band": 16, "splits": 3}}
    tuning.save_cache(entries)
    assert json.loads(path.read_text()) == entries
    tuning.clear_cache()
    assert tuning.load_cache() == entries
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # every lookup a hit
        assert tuning.plan_matmul(4, 768, 3072) == tuning.K1Plan(32, 128)
        assert tuning.plan_matmul(32, 128, 64, batch=12,
                                  kind="sq_matmul_batched") == \
            tuning.BatchedPlan(8, 32)
        assert tuning.plan_paged_attn(8, 1, 12, 1, 64, 8, 16,
                                      torch.bfloat16) == \
            tuning.PagedAttnPlan(4)
        assert tuning.plan_cpm("cpm3_matmul", 64, 64, 64) == \
            tuning.CpmPlan((8, 4))
        assert tuning.plan_conv2d(*K7_SHAPES[3]) == tuning.Conv2DPlan(16, 3)
    tuning.save_cache({tuning.matmul_key("sq_matmul", 8, 8, 8,
                                         torch.float32): {"rows": 9,
                                                          "cols": 64}})
    with pytest.raises(ValueError, match="not a variant"):
        tuning.plan_matmul(8, 8, 8)


def test_miss_warns_once_with_its_entry_and_counts():
    reg = tuning._HIT_COUNTER, tuning._MISS_COUNTER
    hits0, miss0 = (c.value for c in reg)
    with obs_trace.capture() as tracer:
        with pytest.warns(UserWarning, match="autotune cache miss") as rec:
            plan = tuning.plan_matmul(33, 64, 16)
        msg = str(rec[0].message)
        key = "sq_matmul:33x64x16:float32"
        assert key in msg and "autotune_matmul" in msg
        assert json.dumps({key: {"cols": 128, "rows": 32}},
                          sort_keys=True) in msg
        assert plan == tuning.K1Plan(32, 128)
        tuning.clear_memo()                  # resolved again: no new warning
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert tuning.plan_matmul(33, 64, 16) == plan
        tuning.save_cache({key: {"rows": 8, "cols": 64}})
        assert tuning.plan_matmul(33, 64, 16) == tuning.K1Plan(8, 64)
    events = [r.args for r in tracer.records() if r.name == "tuning.cache"]
    assert events == [{"key": key, "hit": False}] * 2 + \
        [{"key": key, "hit": True}]
    assert (reg[0].value - hits0, reg[1].value - miss0) == (1, 2)


def test_plans_are_memoised_until_cleared():
    key = tuning.matmul_key("sq_matmul", 4, 64, 64, torch.float32)
    with pytest.warns(UserWarning):
        assert tuning.plan_matmul(4, 64, 64) == tuning.K1Plan(8, 64)
    # an edit of the file is not seen until the memo is dropped
    Path(os.environ[tuning.CACHE_ENV]).write_text(
        json.dumps({key: {"rows": 32, "cols": 128}}))
    tuning._CACHE.clear()
    assert tuning.plan_matmul(4, 64, 64) == tuning.K1Plan(8, 64)
    prepared.clear_plan_cache()
    assert tuning.plan_matmul(4, 64, 64) == tuning.K1Plan(32, 128)
    w = torch.ones(4, 4)
    assert prepared.is_prepared(prepared.prepare_operand(w))
    assert not prepared.is_prepared(w)


def test_repro_autotune_0_disables_the_cache(monkeypatch):
    key = tuning.matmul_key("sq_matmul", 8, 768, 768, torch.float32)
    tuning.save_cache({key: {"rows": 32, "cols": 128}})
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    tuning.clear_cache()
    hits = tuning._HIT_COUNTER.value
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # no miss warning either
        assert tuning.plan_matmul(8, 768, 768) == tuning.K1Plan(8, 64)
        assert tuning.plan_matmul(9, 5, 5) == tuning.K1Plan(32, 128)
    assert tuning._HIT_COUNTER.value == hits
    assert tuning._CACHE == {}              # no file read


def test_the_cache_file_is_the_ports_own(tmp_path, monkeypatch):
    """The port reads ``REPRO_TORCH_TUNING_CACHE`` or its own package's
    file; the JAX package's variable and file are never its cache, and the
    port's variable does not move the JAX package's."""
    jax_file = tmp_path / "jax_cache.json"
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(jax_file))
    assert tuning.cache_path() == os.environ[tuning.CACHE_ENV]
    assert jtuning.cache_path() == str(jax_file)
    monkeypatch.delenv(tuning.CACHE_ENV)
    default = Path(tuning.cache_path())
    assert default.parent == Path(tuning.__file__).resolve().parent
    assert default.name == "tuning_cache.json"
    assert default != Path(jtuning.cache_path())
    monkeypatch.delenv("REPRO_TUNING_CACHE")
    assert Path(jtuning.cache_path()).resolve() != default.resolve()
    # a JAX entry (Pallas tiles) under the JAX variable reaches no port plan
    jax_file.write_text(json.dumps({"sq_matmul:8x768x768:float32": {
        "bm": 8, "bn": 256, "bk": 256, "kc": 32, "pm_layout": "mkn"}}))
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(jax_file))
    monkeypatch.setenv(tuning.CACHE_ENV, str(tmp_path / "port.json"))
    tuning.clear_cache()
    with pytest.warns(UserWarning, match="cache miss"):
        assert tuning.plan_matmul(8, 768, 768) == tuning.K1Plan(8, 64)


def test_committed_cache_entries_are_variants():
    """Every entry of the port's committed cache names a variant its
    kernel has (or a route), with the model rule's variant and both times
    beside it (PERF.md records them)."""
    path = Path(tuning.__file__).resolve().parent / "tuning_cache.json"
    if not path.exists():
        pytest.skip("no committed cache")
    entries = json.loads(path.read_text())
    assert entries
    for key, e in entries.items():
        kind = key.split(":", 1)[0]
        assert kind in tuning.PLAN_KINDS, key
        plan = tuning._from_entry(kind, e)
        rule = tuning._from_entry(kind, e["rule"])
        assert isinstance(plan, tuning.PLAN_KINDS[kind]) and \
            type(rule) is type(plan)
        assert e["us_per_call"] <= e["rule_us"] and e["variants"] >= 1


def test_route_keys_equal_jax_letter_for_letter():
    for kind, sizes in (("matmul", {"b": 12, "m": 32, "n": 128, "k": 64}),
                        ("conv2d", {"b": 8, "oh": 56, "ow": 56, "kh": 3,
                                    "kw": 3, "ci": 64, "co": 64}),
                        ("paged_attn", {"b": 8, "s": 1, "t": 128, "kv": 12,
                                        "g": 1, "hd": 64})):
        for tdt, jdt in ((torch.float32, jnp.float32),
                         (torch.int32, jnp.int32),
                         (torch.bfloat16, jnp.bfloat16)):
            assert routing.route_key(kind, sizes, tdt) == \
                jrt.route_key(kind, sizes, jdt)


def test_route_override_keys_on_accumulator_dtype(tmp_path):
    """A bf16/int8 route pin must land on the key the selectors look up
    (they key post-widening, on the accumulator dtype): JAX's
    ``test_route_override_keys_on_accumulator_dtype``."""
    key = routing.set_route_override(
        "matmul", {"b": 1, "m": 8, "n": 8, "k": 8, "dtype": "bfloat16"},
        "kernel")
    assert key == "route:matmul:1x8x8x8:float32"
    assert routing.select_matmul_route(8, 8, 8,
                                       dtype=torch.bfloat16).name == "kernel"
    key = routing.set_route_override(
        "matmul", {"b": 1, "m": 8, "n": 8, "k": 8, "dtype": torch.int8},
        "kernel", path=str(tmp_path / "other.json"))
    assert key == "route:matmul:1x8x8x8:int32"
    assert routing.select_matmul_route(8, 8, 8,
                                       dtype=torch.int8).name == "virtual"


def test_route_autotune_cache_override(monkeypatch):
    """A route: entry pins the shape's route after REPRO_ROUTE and before
    the rules; REPRO_AUTOTUNE=0 disables it like any other cache consult
    (JAX's ``test_route_autotune_cache_override``)."""
    path = Path(os.environ[tuning.CACHE_ENV])
    key = routing.set_route_override(
        "matmul", {"b": 1, "m": 256, "n": 256, "k": 256}, "virtual")
    assert json.loads(path.read_text())[key] == {"route": "virtual"}
    route = routing.select_matmul_route(256, 256, 256)
    assert (route.name, route.reason) == ("virtual", "autotune-cache override")
    monkeypatch.setenv("REPRO_ROUTE", "matmul=kernel")
    assert routing.select_matmul_route(256, 256, 256).name == "kernel"
    monkeypatch.delenv("REPRO_ROUTE")
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    assert routing.select_matmul_route(256, 256, 256).name == "kernel"
    monkeypatch.delenv("REPRO_AUTOTUNE")
    with pytest.raises(ValueError, match="route"):
        routing.set_route_override("matmul", {"m": 1, "n": 1, "k": 1},
                                   "bogus")
    with pytest.raises(ValueError, match="kind"):
        routing.set_route_override("dense", {"m": 1}, "kernel")
    for kind, sizes, pin in (
            ("conv2d", {"b": 1, "oh": 30, "ow": 30, "kh": 3, "kw": 3,
                        "ci": 64, "co": 64}, "im2col"),
            ("paged_attn", {"b": 8, "s": 1, "t": 128, "kv": 12, "g": 1,
                            "hd": 64}, "gather")):
        assert routing.select_route(kind, sizes).name != pin
        routing.set_route_override(kind, dict(sizes), pin)
        assert routing.select_route(kind, sizes).name == pin


def test_override_moves_a_contraction_to_another_kernel():
    """On the CPU the kernels' plain versions run, but the route decides
    which: a fold pin takes an einsum's batched GEMM from K2 to K3 (the
    plain versions compute the same, bit for bit)."""
    from repro_torch.core.einsum import fs_einsum
    a, b = torch.randn(12, 32, 64), torch.randn(12, 64, 128)
    routing.select_matmul_route.taken.clear()
    base = fs_einsum("bmk,bkn->bmn", a, b, mode="square_pallas")
    routing.set_route_override("matmul", {"b": 12, "m": 32, "n": 128,
                                          "k": 64}, "fold")
    moved = fs_einsum("bmk,bkn->bmn", a, b, mode="square_pallas")
    assert dict(routing.select_matmul_route.taken) == {"batched": 1,
                                                       "fold": 1}
    assert torch.equal(base, moved)


def test_select_route_is_the_typed_selectors():
    for m, n, k, b in itertools.product((1, 8, 64), (8, 128), (8, 64),
                                        (1, 4, 12)):
        assert routing.select_route("matmul", {"b": b, "m": m, "n": n,
                                               "k": k}).name == \
            routing.select_matmul_route(m, n, k, batch=b).name
    with pytest.raises(ValueError, match="kind"):
        routing.select_route("dense", {})
