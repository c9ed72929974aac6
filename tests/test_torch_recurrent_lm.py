"""The port's recurrent LMs against the JAX package with the same weights
(carried by ``params_from_jax``): ``recurrentgemma-2b`` and ``xlstm-350m``
``.reduced()`` -- the forward and its eager audit (site by site) in all
five modes, the weight conversion's layer order and prepared weights
(``mix`` left raw).  Prefill + decode and bf16 are in
``tests/test_torch_recurrent_decode.py``.  Tolerances as in
``tests/test_torch_recurrent.py``'s docstring.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import counting as jcount  # noqa: E402
from repro.models.lm import build_model as jbuild  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import counting as tcount  # noqa: E402
from repro_torch.core.matmul import MODES  # noqa: E402
from repro_torch.core.prepared import PreparedOperand  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from test_torch_moe import CPU, _route  # noqa: E402
from test_torch_recurrent import (ARCHS, REL, _cfgs,  # noqa: E402,F401
                                  _close, _models, _one_thread, _tokens)


# ------------------------------------------------------------------ LM
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_and_audit_match_jax(arch, mode):
    """Hidden states and logits over 20 tokens in every mode (JAX's
    square_pallas in interpret mode), and the eager audit of that forward,
    site by site, against the JAX package's (its scan bodies scaled by
    ``count_scale``; the mLSTM's one 20-token chunk)."""
    jm, jparams, tm = _models(arch, mode)
    toks = _tokens(tm.cfg, 2, 20)
    with _route(None):
        with jcount.track_contractions() as jc:
            jh, _, _ = jm.forward(jparams, {"tokens": jnp.asarray(toks)})
            jl = jm.logits(jparams, jh)
        with tcount.track_contractions() as tc, torch.no_grad():
            th, aux, _ = tm.forward(tm.tree(),
                                    {"tokens": torch.from_numpy(toks)})
            tl = tm.logits(tm.tree(), th)
    rel = REL.get(mode, 1e-4)
    _close(th, jh, rel, "hidden")
    _close(tl, jl, rel, "logits")
    assert float(aux) == 0.0
    want = {s: d["mults"] for s, d in jc.by_site().items()}
    assert {s: d["mults"] for s, d in tc.by_site().items()} == want
    assert set(want) >= {"recurrent_proj", "recurrent_gates", "logits"}
    assert ("recurrent_mix" in want) == (arch == "xlstm-350m")
    assert tc.fraction_square == jc.fraction_square


def test_params_from_jax_orders_periods_and_tail():
    """recurrentgemma at 8 layers: 2 scanned periods of (rglru, rglru,
    lattn) and a 2-layer rglru tail, in ``cfg.layer_kinds``' order, with
    every ``mix`` leaf carried."""
    jc, tc = _cfgs("recurrentgemma-2b", n_layers=8)
    assert tc.layer_kinds == ("rglru", "rglru", "lattn") * 2 + ("rglru",) * 2
    params = jbuild(jc).init(jax.random.PRNGKey(0))
    assert sorted(params["tail"]) == ["layer0", "layer1"]
    flat = params_from_jax(jax.tree.map(np.asarray, params))
    tm = LM(tc, device=CPU)
    assert sorted(flat) == sorted(tm.state_dict())
    tm.load_state_dict(flat)
    for i, kind in enumerate(tc.layer_kinds):
        if i < 6:
            src = params["scan"][f"pos{i % 3}"]
            pick = lambda a, p=i // 3: np.asarray(a)[p]      # noqa: E731
        else:
            src, pick = params["tail"][f"layer{i - 6}"], np.asarray
        key = "attn" if kind == "lattn" else "mix"
        got = {n: t for n, t in tm.state_dict().items()
               if n.startswith(f"layers.{i}.{key}.")}
        want = jax.tree_util.tree_leaves_with_path(src[key])
        assert len(got) == len(want) and got
        for path, leaf in want:
            name = ".".join(p.key for p in path)
            np.testing.assert_array_equal(
                got[f"layers.{i}.{key}.{name}"].float().numpy(),
                pick(leaf).astype(np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_prepared_equals_raw_with_mix_raw(arch):
    """``prepare_params`` prepares the attention and FFN weights and the
    vocab table; every ``mix`` leaf stays the raw tensor.  The prepared
    forward and decode equal the raw ones."""
    _, _, tm = _models(arch, "square_pallas")
    raw, prep = tm.tree(), tm.prepare_params()
    for p, q, kind in zip(raw["layers"], prep["layers"], tm.cfg.layer_kinds):
        if "mix" in p:
            for a, b in zip(tree_leaves(p["mix"]), tree_leaves(q["mix"])):
                assert a is b
        for key in ("attn", "ffn"):
            if key in p:
                assert all(isinstance(v["w"], PreparedOperand)
                           for v in q[key].values()), (kind, key)
    assert isinstance(prep["logits_prep"], PreparedOperand)
    toks = torch.from_numpy(_tokens(tm.cfg, 2, 16))
    with torch.no_grad():
        outs = []
        for params in (raw, prep):
            h, _, _ = tm.forward(params, {"tokens": toks})
            _, cache = tm.prefill(params, {"tokens": toks}, cache_len=32)
            lg, _ = tm.decode_step(params, cache, toks[:, :1],
                                   torch.full((2,), 16))
            outs.append((tm.logits(params, h), lg))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
