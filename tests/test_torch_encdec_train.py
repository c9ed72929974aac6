"""The port's encoder-decoder LM trained, against the JAX package, on
``whisper-large-v3.reduced()`` (2 encoder layers over 16 frames, 2
``xdec`` layers, d 64, 4 heads over 2 KV heads), with
``tests/test_torch_vlm_train.py``'s helpers and tolerances: one step's
gradient tree against ``jax.value_and_grad`` in all five modes under
``remat`` none and block, leaf by leaf (the encoder's, whose output's
gradient sums every decoder layer's cross K/V cotangents, and each
``xattn``'s); 3 AdamW steps' losses; the step's audit against JAX's
forward and ``chip_smoke.py``'s analytic count (3 x the forward: the
encoder, the self- and cross-attention with its K/V projection, the FFN,
the loss); the ``Trainer``'s resume and the launcher, with
``--encoder-layers``.

Under ``remat="block"`` the encoder's first block runs without a
checkpoint: its input, the frames, asks for no gradient, and
``counting.remat`` then runs the block as it is (JAX's ``jax.checkpoint``
rematerialises every scanned block).  The gradients are the same; the
routes the audit test holds to ``chip_smoke.recurrent_train_launches``
count one recompute fewer.
"""
import dataclasses
import sys
from pathlib import Path

import pytest

from repro_torch.core.matmul import MODES
from repro_torch.core.tree import tree_leaves
from test_torch_recurrent_train import _one_thread  # noqa: F401
from test_torch_recurrent_train_lm import (  # noqa: E402
    BATCH, MULTIPLIER_TOL, SQUARE, SQUARE_TOL, T, cfgs, check_gradients,
    check_trajectory, jax_ref, step_gradients)
from test_torch_vlm_train import (  # noqa: E402
    check_audit, check_launcher, check_trainer_resumes)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

ARCH = "whisper-large-v3"


def _names(tree, path=""):
    """The leaves' paths, in ``tree_leaves``' order (sorted keys)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _names(tree[k],
                                                        f"{path}/{k}")]
    if isinstance(tree, list):
        return [n for i, t in enumerate(tree) for n in _names(t,
                                                              f"{path}/{i}")]
    return [path]


@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("mode", MODES)
def test_step_gradients_match_jax(mode, remat):
    """Every leaf of one step's gradient tree against
    ``jax.value_and_grad``: the encoder's layers and norm, each decoder
    layer's self-attention, ``lnx`` and ``xattn`` (its K/V projections
    of the encoder's output), FFN and norms, the tied table.

    The cross-attention's key bias is the one leaf whose gradient is zero
    in exact arithmetic: with no rope on the encoder's keys, q . b_k adds
    one constant to every score of a row, which the softmax cancels.  Both
    packages leave rounding there (JAX ~1e-10, the port ~1e-10 in the
    multiplier modes and ~1e-7 in the square ones), so a relative gate has
    nothing to hold; it is held instead to the leaf's tolerance times the
    norm of the same layer's key weight gradient, on both sides."""
    p, _ = jax_ref(ARCH).port_state()
    names = _names(p)
    assert len(tree_leaves(p["encoder"])) and all(
        "xattn" in layer for layer in p["layers"])
    zero = {i: names.index(n[:-1] + "w") for i, n in enumerate(names)
            if n.endswith("/xattn/wk/b")}
    assert len(zero) == len(p["layers"])
    scale = float(T) if mode in SQUARE else 1.0
    _, ref = jax_ref(ARCH).grads(scale)
    limit = SQUARE_TOL if mode in SQUARE else MULTIPLIER_TOL

    def tol(i, m):
        if i not in zero:
            return None
        return float("inf")                  # held below, not relatively

    check_gradients(ARCH, mode, remat, tol=tol)
    _, got = step_gradients(ARCH, mode, remat, scale)
    for i, w in zero.items():
        for g in (got[i], ref[i]):
            assert g.double().norm() <= limit * ref[w].double().norm(), \
                (names[i], g.norm().item(), ref[w].norm().item())


@pytest.mark.parametrize("mode", ["standard", "square_pallas"])
def test_loss_trajectory_matches_jax(mode):
    """3 steps (remat block) against JAX's 3 from the same state.  The key
    biases' gradients are zero (cross-attention) or nearly so (under rope
    only the rotation's relative term reaches them), so AdamW's step there,
    about lr * sign(g), follows each package's rounding: those leaves are
    held to AdamW's bound on each side, the losses and every other leaf as
    paligemma's."""
    p, _ = jax_ref(ARCH).port_state()
    skip = {i for i, n in enumerate(_names(p)) if n.endswith("/wk/b")}
    assert len(skip) == p_layers(p)
    check_trajectory(ARCH, mode, "block", skip=skip)


def p_layers(p):
    """Attention layers of a params tree: the encoder's, and each decoder
    layer's self and cross."""
    return len(p["encoder"]["layers"]) + 2 * len(p["layers"])


@pytest.mark.parametrize("remat", ["none", "block"])
def test_audit_and_routes_equal_the_analytic_count(remat):
    """whisper's step: the encoder over the frames, the cross K/V over the
    encoder's output, the loss over the S tokens; under remat block one
    encoder layer fewer recomputed (the module docstring)."""
    fwd, tc = check_audit(ARCH, remat)
    B, S = BATCH["global_batch"], BATCH["seq_len"]
    kv = tc.n_kv_heads * tc.resolved_head_dim
    assert fwd["loss"] == B * S * tc.d_model * tc.padded_vocab
    qkv = (tc.encoder_layers * B * tc.encoder_seq
           * tc.d_model * (tc.n_heads * tc.resolved_head_dim + 2 * kv)
           + tc.n_layers * B * S * tc.d_model
           * (2 * tc.n_heads * tc.resolved_head_dim + 2 * kv)
           + tc.n_layers * 2 * B * tc.encoder_seq * tc.d_model * kv)
    assert fwd["attn_qkv"] == qkv
    rules = chip_smoke.recurrent_train_launches(tc, B, S)
    fwd_calls = sum(rules["forward"].values())
    rec_calls = sum(rules["recompute"].values())
    loss_calls = -(-S // min(tc.loss_chunk, S))
    one_layer = len(chip_smoke.layer_contractions(tc, "attn", B,
                                                  tc.encoder_seq))
    assert rec_calls == (fwd_calls - one_layer if remat == "block"
                         else loss_calls)


def test_trainer_resumes_from_its_checkpoint(tmp_path):
    check_trainer_resumes(ARCH, tmp_path)


@pytest.mark.parametrize("enc", [0, 1])
def test_launcher_trains_on_the_cpu(enc, tmp_path):
    """The launcher, and with ``--layers 1 --encoder-layers 1`` the depth
    cut the card's smoke trains whisper at."""
    extra = ("--layers", "1", "--encoder-layers", "1") if enc else ()
    out, tc, got = check_launcher(ARCH, tmp_path, extra)
    if enc:
        tc = dataclasses.replace(tc, n_layers=1, encoder_layers=1)
    assert got == chip_smoke.recurrent_train_audit(tc, 2, 32)
    assert (tmp_path / "ck" / "step_000000002").is_dir()
