"""The port's recurrent LMs' decode path and bf16 against the JAX package
with the same weights (carried by ``params_from_jax``), on
``recurrentgemma-2b`` and ``xlstm-350m`` ``.reduced()``: prefill + one
decode step against the forward and against JAX's decode step (its logits
and its audit), and the bf16 forward's logits.  Tolerances as in
``tests/test_torch_recurrent.py``'s docstring.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import counting as jcount  # noqa: E402
from repro_torch.core import counting as tcount  # noqa: E402
from test_torch_moe import _route  # noqa: E402
from test_torch_recurrent import (ARCHS, REL, _close,  # noqa: E402,F401
                                  _models, _one_thread, _tokens)


@pytest.mark.parametrize("mode", ["standard", "square_pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch, mode):
    """``tests/test_models_smoke.py::test_decode_matches_forward``'s
    contract: prefill 24 tokens, decode the 25th, against the forward's
    last logits at 2e-3; the decode step's logits and its audit against
    JAX's."""
    jm, jparams, tm = _models(arch, mode)
    B, S = 2, 24
    toks = _tokens(tm.cfg, B, S + 1, seed=2)
    with _route(None), torch.no_grad():
        h, _, _ = tm.forward(tm.tree(), {"tokens": torch.from_numpy(toks)})
        ref = tm.logits(tm.tree(), h)[:, -1].numpy()
        _, cache = tm.prefill(tm.tree(), {"tokens": torch.from_numpy(
            toks[:, :S])}, cache_len=64)
        with tcount.track_contractions() as td:
            out, _ = tm.decode_step(tm.tree(), cache,
                                    torch.from_numpy(toks[:, S:]),
                                    torch.full((B,), S))
        _, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(toks[:, :S])},
                               cache_len=64)
        with jcount.track_contractions() as jd:
            jout, _ = jm.decode_step(jparams, jcache, jnp.asarray(toks[:, S:]),
                                     jnp.full((B,), S, jnp.int32))
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-3,
                               atol=2e-3 * np.abs(ref).max())
    _close(out, jout, REL.get(mode, 1e-4), "decode logits vs JAX")
    assert {s: d["mults"] for s, d in td.by_site().items()} == \
        {s: d["mults"] for s, d in jd.by_site().items()}


@pytest.mark.parametrize("mode", ["standard", "square_virtual"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_match_jax(arch, mode):
    """bf16 logits against JAX's op by op (``jax.disable_jit``), whose ops
    round to bf16 one at a time as the port's do: XLA's CPU fusion drops
    some of those roundings in a jitted forward, which moves
    recurrentgemma's logits by 5e-3 * max and flips an argmax at a near
    tie."""
    jm, jparams, tm = _models(arch, mode, dtype="bfloat16")
    assert tm.state_dict()["embed.table"].dtype == torch.bfloat16
    toks = _tokens(tm.cfg, 2, 16)
    with jax.disable_jit():
        jh, _, _ = jm.forward(jparams, {"tokens": jnp.asarray(toks)})
        jl = np.asarray(jm.logits(jparams, jh).astype(jnp.float32))
    with torch.no_grad():
        th, _, _ = tm.forward(tm.tree(), {"tokens": torch.from_numpy(toks)})
        tl = tm.logits(tm.tree(), th).float().numpy()
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=0, atol=2e-2 * np.abs(jl).max())
    np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
