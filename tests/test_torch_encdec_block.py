"""The port's ``xdec`` block against the JAX package with the
same weights and inputs, on ``whisper-large-v3`` ``.reduced()`` (2
encoder layers, 16 frames, 4 heads over 2 KV heads, f32), in all five
modes: the block's forward with its cache seed, its empty cache and one
decode step on the prefilled cache.  Tolerances as in
``tests/test_torch_encdec.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.layers.param import init_tree  # noqa: E402
from repro.models import blocks as jblk  # noqa: E402
from repro_torch.core.matmul import MODES  # noqa: E402
from repro_torch.models import blocks as tblk  # noqa: E402
from test_torch_encdec import ARCH, _normal  # noqa: E402
from test_torch_moe import CPU, _route, _to_torch  # noqa: E402
from test_torch_recurrent import (REL, _cfgs, _close,  # noqa: E402,F401
                                  _one_thread)


# ----------------------------------------------------------- the block
def _block(mode):
    jc, tc = _cfgs(ARCH, mode)
    jp = init_tree(jblk.block_spec("xdec", jc), jax.random.PRNGKey(7))
    return jc, tc, jp, _to_torch(jp)


@pytest.mark.parametrize("mode", MODES)
def test_xdec_block_forward_decode_and_cache_match_jax(mode):
    """The ``xdec`` block: its forward over 5 tokens with the encoder's
    16-frame stream (output and cache seed ``k``, ``v``, ``xk``, ``xv``),
    its empty cache (``xk``/``xv`` of ``(B, enc_len, KV, hd)`` in the
    config's dtype), and one decode step on the prefilled cache: the
    output, the self ring written in place, the cross K/V untouched."""
    jc, tc, jp, tp = _block(mode)
    rel = REL.get(mode, 1e-4)
    x, enc = _normal(2, 5, 64), _normal(2, 16, 64)
    jctx = {"cfg": jc, "mode": mode, "positions": jnp.arange(5),
            "cross_x": jnp.asarray(enc), "cross_positions": jnp.arange(16)}
    tctx = {"cfg": tc, "mode": mode, "positions": torch.arange(5),
            "cross_x": torch.from_numpy(enc),
            "cross_positions": torch.arange(16)}
    with _route(None):
        jo, jseed, _ = jblk.block_forward("xdec", jp, jnp.asarray(x), jctx)
        with torch.no_grad():
            to, tseed, aux = tblk.block_forward("xdec", tp,
                                                torch.from_numpy(x), tctx)
    _close(to, jo, rel, "block out")
    assert sorted(tseed) == sorted(jseed) == ["k", "v", "xk", "xv"]
    for key in tseed:
        _close(tseed[key], jseed[key], rel, f"seed {key}")
    assert float(aux) == 0.0

    jcache = jblk.block_init_cache("xdec", jc, 2, 8, 16)
    tcache = tblk.block_init_cache("xdec", tc, 2, 8, CPU, enc_len=16)
    assert sorted(tcache) == sorted(jcache)
    for key, t in tcache.items():
        assert tuple(t.shape) == jcache[key].shape, key
        assert str(t.dtype).split(".")[-1] == str(jcache[key].dtype), key
        np.testing.assert_array_equal(t.numpy(), np.asarray(jcache[key]))
    # the cache prefilled with the forward's seed, then one decode step
    for key, src in (("k", "k"), ("v", "v")):
        jcache[key] = jcache[key].at[:, :5].set(jseed[src])
        tcache[key][:, :5] = tseed[src]
    jcache["pos"] = jcache["pos"].at[:, :5].set(jnp.arange(5))
    tcache["pos"][:, :5] = torch.arange(5, dtype=torch.int32)
    for key in ("xk", "xv"):
        jcache[key] = jseed[key]
        tcache[key].copy_(tseed[key])
    cross = {k: tcache[k].clone() for k in ("xk", "xv")}
    y = _normal(2, 1, 64)
    pos = np.array([5, 5])
    with _route(None):
        jy, jnew = jblk.block_decode("xdec", jp, jnp.asarray(y), jcache,
                                     {"cfg": jc, "mode": mode,
                                      "pos": jnp.asarray(pos)})
        with torch.no_grad():
            ty = tblk.block_decode("xdec", tp, torch.from_numpy(y), tcache,
                                   {"cfg": tc, "mode": mode,
                                    "pos": torch.from_numpy(pos)})
    _close(ty, jy, rel, "block decode")
    for key in ("k", "v"):
        _close(tcache[key], jnew[key], rel, f"decode cache {key}")
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jnew["pos"]))
    for key in ("xk", "xv"):
        assert torch.equal(tcache[key], cross[key])
