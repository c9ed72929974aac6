"""The port in bf16, the full-width dtype, against the JAX package: the
reduced configs with ``dtype="bfloat16"`` and the same weights.

- ``LM.forward`` logits within ``2e-2 * max|logits|`` of JAX's, with the
  same argmax at every position, in ``standard``, ``square_virtual`` and
  ``square_exact``.  Both sides round the same bf16 weights and
  activations; the f32 accumulations differ in order, and a bf16 rounding
  of an activation that lands on the other side of a tie moves a logit by
  up to a bf16 ulp of the activations times the weights downstream.
- The paged engines' greedy tokens are identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget  # noqa: E402
from repro.models.lm import build_model as jbuild  # noqa: E402
from repro.serve import engine as jeng  # noqa: E402
from repro.serve.server import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.serve import make_requests  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from repro_torch.serve.server import Request as TRequest  # noqa: E402


def _pair(arch, mode):
    kw = dict(matmul_mode=mode, dtype="bfloat16")
    jc = dataclasses.replace(jget(arch).reduced(), **kw)
    tc = dataclasses.replace(tget(arch).reduced(), **kw)
    jm = jbuild(jc)
    params = jm.init(jax.random.PRNGKey(0))
    tm = LM(tc, device=torch.device("cpu"))
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    assert tm.state_dict()["embed.table"].dtype == torch.bfloat16
    return jm, params, tm


@pytest.mark.parametrize("mode", ["standard", "square_virtual",
                                  "square_exact"])
def test_bf16_forward_logits_match_jax(mode):
    jm, jparams, tm = _pair("fairsquare-demo", mode)
    toks = np.random.default_rng(0).integers(0, tm.cfg.vocab, (2, 24)) \
        .astype(np.int32)
    jh, _, _ = jax.jit(jm.forward)(jparams, {"tokens": jnp.asarray(toks)})
    jl = np.asarray(jm.logits(jparams, jh).astype(jnp.float32))
    with torch.no_grad():
        th, _, _ = tm.forward(tm.tree(), {"tokens": torch.from_numpy(toks)})
        tl = tm.logits(tm.tree(), th).float().numpy()
    assert tl.shape == jl.shape and np.isfinite(tl).all()
    scale = np.abs(jl).max()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=2e-2 * scale)
    np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))


@pytest.mark.parametrize("arch", ["fairsquare-demo", "h2o-danube-3-4b"])
def test_bf16_engine_greedy_tokens_match_jax(arch):
    jm, jparams, tm = _pair(arch, "square_virtual")
    kw = dict(max_slots=4, block_size=8, num_blocks=40, blocks_per_seq=6,
              prefill_chunk=8, max_new_tokens=6, prepared=True)
    reqs = make_requests(tm.cfg, 5, seed=3, lo=3, hi=16)
    je = jeng.Engine(jm, jparams, jeng.EngineConfig(**kw))
    for name in ("_chunk", "_decode", "_logits_at"):
        fn = getattr(je, name)
        setattr(je, name, lambda *a, _f=fn: jax.block_until_ready(_f(*a)))
    jres = je.run([JRequest(r.rid, r.tokens) for r in reqs])
    tres = teng.Engine(tm, teng.EngineConfig(**kw), device="cpu").run(
        [TRequest(r.rid, r.tokens) for r in reqs])
    assert sorted(tres) == sorted(jres) == list(range(5))
    for rid in tres:
        assert tres[rid].ok and jres[rid].ok
        assert tres[rid].tokens == jres[rid].tokens, rid
