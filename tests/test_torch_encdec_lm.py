"""The port's encoder-decoder LM against the JAX package with the same
weights (carried by ``params_from_jax``), on ``whisper-large-v3``
``.reduced()`` (2 encoder + 2 decoder layers, 16 frames, 4 heads over 2
KV heads, f32): the forward's hidden states, logits and eager audit site
by site in all five modes; prefill + decode against the forward (JAX's
``test_decode_matches_forward`` contract) and against JAX's, cache
included; ``params_from_jax``'s encoder leaves; prepared = raw; the
empty cache; the paged cache's refusal.  Tolerances as in
``tests/test_torch_encdec.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import counting as jcount  # noqa: E402
from repro_torch.convert import (params_from_jax,  # noqa: E402
                                 tree_from_state_dict)
from repro_torch.core import counting as tcount  # noqa: E402
from repro_torch.core.matmul import MODES  # noqa: E402
from repro_torch.core.prepared import PreparedOperand  # noqa: E402
from repro_torch.serve import engine as teng  # noqa: E402
from test_torch_encdec import _models, _normal  # noqa: E402
from test_torch_moe import _route  # noqa: E402
from test_torch_recurrent import REL, _close  # noqa: E402
from test_torch_recurrent import _one_thread  # noqa: E402,F401


def _batch(cfg, B, S, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "frames": rng.normal(size=(B, cfg.encoder_seq, cfg.d_model))
            .astype(np.float32)}


@pytest.mark.parametrize("mode", MODES)
def test_lm_forward_and_audit_match_jax(mode):
    """Hidden states and logits over 12 tokens and 16 frames in every mode
    (JAX's square_pallas in interpret mode), and the eager audit of that
    forward, site by site -- the encoder's and the cross-attention's
    contractions included -- against the JAX package's (its scans scaled
    by ``count_scale``)."""
    jm, jparams, tm = _models(mode)
    b = _batch(tm.cfg, 2, 12)
    with _route(None):
        with jcount.track_contractions() as jc:
            jh, _, _ = jm.forward(jparams, {k: jnp.asarray(v)
                                            for k, v in b.items()})
            jl = jm.logits(jparams, jh)
        with tcount.track_contractions() as tc, torch.no_grad():
            th, aux, _ = tm.forward(tm.tree(), {k: torch.from_numpy(v)
                                                for k, v in b.items()})
            tl = tm.logits(tm.tree(), th)
    rel = REL.get(mode, 1e-4)
    _close(th, jh, rel, "hidden")
    _close(tl, jl, rel, "logits")
    assert float(aux) == 0.0
    want = {s: d["mults"] for s, d in jc.by_site().items()}
    assert {s: d["mults"] for s, d in tc.by_site().items()} == want
    assert set(want) == {"attn_qkv", "attn_scores", "attn_pv", "attn_out",
                         "ffn", "logits"}
    assert tc.fraction_square == jc.fraction_square


@pytest.mark.parametrize("mode", ["standard", "square_pallas"])
def test_decode_matches_forward(mode):
    """``tests/test_models_smoke.py::test_decode_matches_forward`` on the
    port (prefill of 24 tokens, one decode step against the forward over
    25: rtol 2e-3, atol 2e-3 * max), and the prefill + decode logits and
    the cache after both against JAX's (the cross K/V copied in by the
    prefill, the self ring written by the step)."""
    jm, jparams, tm = _models(mode)
    B, S = 2, 24
    b = _batch(tm.cfg, B, S + 1, seed=2)
    full = {k: torch.from_numpy(v) for k, v in b.items()}
    pre = dict(full, tokens=full["tokens"][:, :S])
    with torch.no_grad():
        h, _, _ = tm.forward(tm.tree(), full)
        ref = tm.logits(tm.tree(), h)[:, -1]
        _, cache = tm.prefill(tm.tree(), pre, cache_len=64)
        out, _ = tm.decode_step(tm.tree(), cache, full["tokens"][:, S:],
                                torch.full((B,), S))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-3,
                               atol=2e-3 * ref.abs().max().item())
    jpre = {k: jnp.asarray(v.numpy()) for k, v in pre.items()}
    with _route(None):
        _, jcache = jm.prefill(jparams, jpre, cache_len=64)
        jout, jcache = jm.decode_step(jparams, jcache,
                                      jnp.asarray(b["tokens"][:, S:]),
                                      jnp.full((B,), S, jnp.int32))
    rel = REL.get(mode, 1e-4)
    _close(out, jout, rel, "prefill + decode logits")
    for i, layer in enumerate(cache):
        for key in ("k", "v", "xk", "xv"):
            _close(layer[key], np.asarray(jcache["scan"]["pos0"][key])[i],
                   rel, f"layer {i} {key}")


def test_params_from_jax_carries_the_encoder():
    """``params_from_jax``: the encoder's stacked ``blocks.pos0`` become
    ``encoder.layers.{i}`` (layer i = index i of the leading axis) and
    ``encoder.norm`` its norm; the decoder's scan periods carry ``lnx`` and
    ``xattn``.  The state dicts' names agree, and ``tree_from_state_dict``
    gives ``LM.tree``'s layout."""
    jm, params, tm = _models()
    sd = tm.state_dict()
    flat = params_from_jax(jax.tree.map(np.asarray, params))
    assert sorted(flat) == sorted(sd)
    tree = tree_from_state_dict(flat)
    assert len(tree["encoder"]["layers"]) == tm.cfg.encoder_layers
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(tm.tree())
    assert tm.kinds == ("xdec", "xdec")
    enc = params["encoder"]
    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(enc["blocks"]):
        name = ".".join(p.key for p in path[1:])
        for i in range(tm.cfg.encoder_layers):
            np.testing.assert_array_equal(
                sd[f"encoder.layers.{i}.{name}"].numpy(),
                np.asarray(leaf)[i])
            n += 1
    for path, leaf in jax.tree_util.tree_leaves_with_path(enc["norm"]):
        np.testing.assert_array_equal(
            sd[f"encoder.norm.{path[-1].key}"].numpy(), np.asarray(leaf))
    assert n == 2 * len(jax.tree_util.tree_leaves(enc["blocks"]))
    for i in range(tm.cfg.n_layers):
        for key in ("lnx", "xattn"):
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                    params["scan"]["pos0"][key]):
                name = ".".join(p.key for p in path)
                np.testing.assert_array_equal(
                    sd[f"layers.{i}.{key}.{name}"].numpy(),
                    np.asarray(leaf)[i])


def test_prepared_equals_raw():
    """``prepare_params`` prepares the encoder's layers and every ``xattn``
    beside the rest; the prepared forward, prefill and decode step equal the
    raw ones bit for bit."""
    _, _, tm = _models("square_pallas")
    raw, prep = tm.tree(), tm.prepare_params()
    for layers in (prep["layers"], prep["encoder"]["layers"]):
        for p in layers:
            for key in ("attn", "xattn", "ffn"):
                if key in p:
                    assert all(isinstance(v["w"], PreparedOperand)
                               for v in p[key].values()), key
    assert "xattn" in prep["layers"][0] and "xattn" not in \
        prep["encoder"]["layers"][0]
    assert all(prep["encoder"]["norm"][k] is t
               for k, t in raw["encoder"]["norm"].items())
    toks = torch.from_numpy(np.arange(12, dtype=np.int32).reshape(2, 6))
    batch = {"tokens": toks, "frames": torch.from_numpy(_normal(2, 16, 64))}
    outs = []
    with torch.no_grad():
        for params in (raw, prep):
            h, _, _ = tm.forward(params, batch)
            _, cache = tm.prefill(params, batch, cache_len=16)
            lg, _ = tm.decode_step(params, cache, toks[:, :1],
                                   torch.full((2,), 6))
            outs.append((tm.logits(params, h), lg, cache[1]["xk"]))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_paged_serving_refuses_the_encoder_decoder():
    """``tests/test_paged_cache.py::test_init_paged_cache_rejects_non_kv_
    archs``: no paged cache for whisper in either package, with JAX's
    words; the paged engine refuses the model."""
    jm, _, tm = _models()
    with pytest.raises(ValueError) as je:
        jm.init_paged_cache(64)
    with pytest.raises(ValueError, match="encoder-decoder") as te:
        tm.init_paged_cache(64)
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="encoder-decoder"):
        teng.Engine(tm, teng.EngineConfig(), device="cpu")


def test_init_cache_holds_the_encoders_length():
    """``init_cache``: each decoder layer's ``xk``/``xv`` of
    ``cfg.encoder_seq`` entries, as JAX's ``init_cache`` (stacked there)."""
    jm, _, tm = _models()
    jcache = jm.init_cache(3, 24)["scan"]["pos0"]
    for layer in tm.init_cache(3, 24):
        assert sorted(layer) == sorted(jcache)
        for key, t in layer.items():
            assert tuple(t.shape) == jcache[key].shape[1:], key
    assert tm.cfg.encoder_seq == 16

