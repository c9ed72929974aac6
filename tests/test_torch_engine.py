"""The port's paged engine against the JAX engine with the same weights:
greedy tokens must be identical, for 8 ragged requests with prepared
weights, and under preemption.

In ``square_pallas`` (with the square_gemms policy) the port runs K1's
and K4's plain versions on these CPU tensors, while the JAX engine, whose
Pallas wrappers cannot run in this venv, serves the same mode with
``REPRO_ROUTE=matmul=virtual,paged_attn=gather``.
"""
import contextlib
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs.base import SQUARE_GEMMS_POLICY as J_SQG  # noqa: E402
from repro.launch.serve import make_requests as jrequests  # noqa: E402
from repro.models.lm import build_model as jbuild  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs.base import SQUARE_GEMMS_POLICY as T_SQG  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.serve import make_requests as trequests  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve.server import Request  # noqa: E402
from test_torch_moe import _one_thread  # noqa: E402,F401


def _synchronous(engine):
    """Make the JAX engine wait for each model call before it goes on.  On
    the CPU backend ``jnp.asarray`` may alias a numpy buffer, and the JAX
    engine hands its block-table array to an asynchronously dispatched
    prefill chunk, then edits that array in place on the next tick (grow,
    release on preemption).  Under preemption the in-flight chunk can read
    the edited table, so the reference's tokens vary from run to run.
    Waiting on every call removes that race, on the reference side only."""
    for name in ("_chunk", "_decode", "_logits_at"):
        fn = getattr(engine, name)
        setattr(engine, name,
                lambda *a, _f=fn: jax.block_until_ready(_f(*a)))
    return engine


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


GEOMETRY = {
    # the JAX engine test's geometry: 8 slots, no pool pressure
    "roomy": dict(max_slots=8, block_size=8, num_blocks=64, blocks_per_seq=8,
                  prefill_chunk=8, max_new_tokens=6),
    # a pool of 9 allocatable 4-token blocks for 4 slots: preemption
    "tight": dict(max_slots=4, block_size=4, num_blocks=10, blocks_per_seq=8,
                  prefill_chunk=8, max_new_tokens=8),
}


def _engine_greedy_tokens_match_jax(arch, mode, geometry):
    jc = dataclasses.replace(jget(arch).reduced(), matmul_mode=mode)
    tc = dataclasses.replace(tget(arch).reduced(), matmul_mode=mode)
    if mode == "square_pallas":
        jc = dataclasses.replace(jc, contraction_policy=J_SQG)
        tc = dataclasses.replace(tc, contraction_policy=T_SQG)
    jm = jbuild(jc)
    params = jm.init(jax.random.PRNGKey(0))
    tm = LM(tc, device=torch.device("cpu"))
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))

    geo = GEOMETRY[geometry]
    jreqs = jrequests(jc, 8, seed=3, lo=3, hi=20)
    treqs = trequests(tc, 8, seed=3, lo=3, hi=20)
    for a, b in zip(jreqs, treqs):
        np.testing.assert_array_equal(a.tokens, b.tokens)

    with _route("matmul=virtual,paged_attn=gather"
                if mode == "square_pallas" else None):
        je = _synchronous(jeng.Engine(jm, params,
                                      jeng.EngineConfig(prepared=True, **geo)))
        jres = je.run(jreqs)
    with _route(None):
        te = teng.Engine(tm, teng.EngineConfig(prepared=True, **geo),
                         device="cpu")
        tres = te.run(treqs)

    assert sorted(tres) == sorted(jres) == list(range(8))
    for rid in range(8):
        assert tres[rid].ok and jres[rid].ok
        assert tres[rid].tokens == jres[rid].tokens, rid
    assert te.metrics.preemptions == je.metrics.preemptions
    assert te.metrics.tokens_out == je.metrics.tokens_out == \
        8 * geo["max_new_tokens"]
    assert te.metrics.decode_steps == je.metrics.decode_steps
    assert te.allocator.used_blocks == 0
    if geometry == "tight":
        assert te.metrics.preemptions > 0


@pytest.mark.parametrize("mode,geometry", [
    ("square_virtual", "roomy"), ("square_pallas", "roomy"),
    ("standard", "tight"), ("square_pallas", "tight")])
def test_engine_greedy_tokens_match_jax(mode, geometry):
    _engine_greedy_tokens_match_jax("fairsquare-demo", mode, geometry)


@pytest.mark.parametrize("mode", ["square_virtual", "square_pallas"])
def test_engine_deepseek_greedy_tokens_match_jax(mode):
    """``deepseek-7b`` (no window; ``.reduced()``: 4 heads over 2 KV heads)
    through the paged engine: 8 ragged requests, greedy tokens identical to
    the JAX engine's."""
    _engine_greedy_tokens_match_jax("deepseek-7b", mode, "roomy")


def test_engine_rejects_like_jax():
    tc = tget("fairsquare-demo").reduced()
    tm = LM(tc, device=torch.device("cpu"))
    te = teng.Engine(tm, teng.EngineConfig(max_new_tokens=4, blocks_per_seq=2,
                                           block_size=4), device="cpu")
    reqs = [Request(0, np.zeros(0, np.int32)),
            Request(1, np.arange(5, dtype=np.int32)),
            Request(2, np.arange(3, dtype=np.int32))]
    res = te.run(reqs)
    assert [res[i].status for i in range(3)] == [
        teng.RequestStatus.REJECTED, teng.RequestStatus.REJECTED,
        teng.RequestStatus.COMPLETED]
    with pytest.raises(ValueError, match="duplicate"):
        te.submit([Request(2, np.arange(3, dtype=np.int32))])


def test_engine_temperature_sampling_is_seeded():
    tc = tget("fairsquare-demo").reduced()
    tm = LM(tc, device=torch.device("cpu"))
    cfg = teng.EngineConfig(temperature=1.0, max_new_tokens=5,
                            prefill_chunk=8)
    runs = [teng.Engine(tm, cfg, seed=7, device="cpu").run(
        trequests(tc, 3, seed=1)) for _ in range(2)]
    assert {r: v.tokens for r, v in runs[0].items()} == \
        {r: v.tokens for r, v in runs[1].items()}


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "starcoder2-3b"])
@pytest.mark.parametrize("mode", ["square_virtual", "square_pallas"])
def test_engine_sliding_window_archs_match_jax(arch, mode):
    """Greedy tokens of two sliding-window archs (``.reduced()``: a 64-token
    window) past the window: prompts of 40-70 tokens plus 30 new tokens over
    a 128-token table, so decode attention -- K4's plain version under
    ``square_pallas`` -- masks by the window on every late step."""
    jc = dataclasses.replace(jget(arch).reduced(), matmul_mode=mode)
    tc = dataclasses.replace(tget(arch).reduced(), matmul_mode=mode)
    assert jc.window == tc.window == 64
    jm = jbuild(jc)
    params = jm.init(jax.random.PRNGKey(1))
    tm = LM(tc, device=torch.device("cpu"))
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    geo = dict(max_slots=4, block_size=16, num_blocks=40, blocks_per_seq=8,
               prefill_chunk=16, max_new_tokens=30)
    jreqs = jrequests(jc, 4, seed=5, lo=40, hi=70)
    treqs = trequests(tc, 4, seed=5, lo=40, hi=70)
    with _route("matmul=virtual,paged_attn=gather"
                if mode == "square_pallas" else None):
        je = _synchronous(jeng.Engine(jm, params,
                                      jeng.EngineConfig(prepared=True, **geo)))
        jres = je.run(jreqs)
    with _route(None):
        te = teng.Engine(tm, teng.EngineConfig(prepared=True, **geo),
                         device="cpu")
        tres = te.run(treqs)
    assert max(len(r.tokens) for r in treqs) + 30 > 64
    for rid in range(4):
        assert tres[rid].ok and jres[rid].ok
        assert tres[rid].tokens == jres[rid].tokens, rid
    assert te.metrics.decode_steps == je.metrics.decode_steps
