"""The port's cross-attention against the JAX package with the same
weights and inputs, on ``whisper-large-v3`` ``.reduced()`` (d 64, 4 heads
over 2 KV heads of 16, f32): ``models/attention.py``'s forward with
padded KV chunks and its decode against the encoder's K/V, and the
encoder against JAX's ``_encode``, in all five modes; the ``xdec`` kind's
place among the block kinds.  The ``xdec`` block is in
``tests/test_torch_encdec_block.py``, the LM in
``tests/test_torch_encdec_lm.py``, the dense ``Server`` and the launcher
in ``tests/test_torch_encdec_serving.py``.

Tolerances as in ``tests/test_torch_recurrent.py``'s docstring (``REL``):
1e-4 * max|ref| for ``standard`` and ``square_virtual``, 1e-3 for the
square-form modes, whose f32 sums round in another order in each
package; JAX's square_pallas runs its Pallas kernels in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.layers.param import init_tree  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import blocks as jblk  # noqa: E402
from repro.models.lm import build_model as jbuild  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.matmul import MODES  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import blocks as tblk  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from test_torch_moe import CPU, _route, _to_torch  # noqa: E402
from test_torch_recurrent import (REL, _cfgs, _close,  # noqa: E402,F401
                                  _one_thread)

ARCH = "whisper-large-v3"
RNG = np.random.default_rng(30)


def _normal(*shape):
    return RNG.normal(size=shape).astype(np.float32)


def _models(mode="standard", **kw):
    """The JAX LM, its params and the port's LM holding the same weights."""
    jc, tc = _cfgs(ARCH, mode, **kw)
    jm = jbuild(jc)
    params = jm.init(jax.random.PRNGKey(0))
    tm = LM(tc, device=CPU)
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _attn_params(cfgs, seed=5):
    jc, tc = cfgs
    jp = init_tree(jattn.attn_spec(jc), jax.random.PRNGKey(seed))
    # the bias is zero at init: give it values, so that it is carried
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.1 if path[-1].key == "b" else a, jp)
    return jp, _to_torch(jp)


# ------------------------------------------------------ cross-attention
@pytest.mark.parametrize("mode", MODES)
def test_cross_attention_forward_matches_jax(mode):
    """``attn_forward(..., cross_x=, cross_positions=)``: K/V from a
    20-entry encoder stream in 8-entry chunks, so the last chunk holds 4
    padded entries that never attend; no rope, no causal mask, no window
    (a window set on the call is ignored, as in JAX).  The output and the
    unroped K/V it returns."""
    jc, tc = cfgs = _cfgs(ARCH, mode, attn_chunk_q=4, attn_chunk_kv=8,
                          window=2)
    jp, tp = _attn_params(cfgs)
    x, enc = _normal(2, 6, 64), _normal(2, 20, 64)
    pos, epos = np.arange(6), np.arange(20)
    with _route(None):
        jo, (jk, jv) = jattn.attn_forward(
            jp, jnp.asarray(x), cfg=jc, positions=jnp.asarray(pos),
            window=2, cross_x=jnp.asarray(enc),
            cross_positions=jnp.asarray(epos), mode=mode)
        with torch.no_grad():
            to, (tk, tv) = tattn.attn_forward(
                tp, torch.from_numpy(x), cfg=tc,
                positions=torch.from_numpy(pos), window=2,
                cross_x=torch.from_numpy(enc),
                cross_positions=torch.from_numpy(epos), mode=mode)
    rel = REL.get(mode, 1e-4)
    _close(to, jo, rel, "cross out")
    _close(tk, jk, rel, "cross k")
    _close(tv, jv, rel, "cross v")
    assert tuple(tk.shape) == (2, 20, tc.n_kv_heads, tc.resolved_head_dim)


@pytest.mark.parametrize("mode", MODES)
def test_cross_attention_decode_matches_jax(mode):
    """``attn_decode(..., cross_cache=)``: q unroped (each row at its own
    position, which must not matter), every one of the T entries attended,
    the encoder's K/V read and not written."""
    jc, tc = cfgs = _cfgs(ARCH, mode)
    jp, tp = _attn_params(cfgs)
    KV, hd = tc.n_kv_heads, tc.resolved_head_dim
    x = _normal(3, 1, 64)
    k, v = _normal(3, 16, KV, hd), _normal(3, 16, KV, hd)
    outs = []
    for pos in (np.array([0, 5, 9]), np.array([7, 7, 7])):
        with _route(None):
            jo, _ = jattn.attn_decode(
                jp, jnp.asarray(x), None, jnp.asarray(pos), cfg=jc,
                cross_cache={"k": jnp.asarray(k), "v": jnp.asarray(v)},
                mode=mode)
            kt, vt = torch.from_numpy(k), torch.from_numpy(v)
            with torch.no_grad():
                to, cache = tattn.attn_decode(
                    tp, torch.from_numpy(x), None, torch.from_numpy(pos),
                    cfg=tc, cross_cache={"k": kt, "v": vt}, mode=mode)
        _close(to, jo, REL.get(mode, 1e-4), "cross decode")
        assert cache is None
        assert np.array_equal(kt.numpy(), k) and np.array_equal(vt.numpy(),
                                                                v)
        outs.append(to)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


# --------------------------------------------------------- the encoder
@pytest.mark.parametrize("mode", MODES)
def test_encoder_matches_jax(mode):
    """The encoder over 16 frames (cast to the config's dtype, non-causal
    ``attn`` blocks at positions 0..15, then its layernorm) against JAX's
    ``_encode``."""
    jm, jparams, tm = _models(mode)
    frames = _normal(2, 16, 64)
    with _route(None):
        want = jm._encode(jparams, {"frames": jnp.asarray(frames)}, mode)
        with torch.no_grad():
            got = tm.encode(tm.tree(), torch.from_numpy(frames))
    _close(got, want, REL.get(mode, 1e-4), "encoder")



# --------------------------------------------------------- block kinds
def test_xdec_has_no_paged_cache():
    """``xdec`` is built but not pageable, in both packages: its paged pool
    is refused with JAX's words; ``PAGEABLE_KINDS`` is JAX's."""
    jc, tc = _cfgs(ARCH)
    assert "xdec" in tblk.KINDS
    assert tblk.PAGEABLE_KINDS == jblk.PAGEABLE_KINDS
    with pytest.raises(ValueError, match="no paged decode cache") as te:
        tblk.block_init_paged_cache("xdec", tc, 64, CPU)
    with pytest.raises(ValueError, match="no paged decode cache") as je:
        jblk.block_init_paged_cache("xdec", jc, 64)
    assert str(te.value) == str(je.value)
