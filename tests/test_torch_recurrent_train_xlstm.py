"""``xlstm-350m.reduced()`` (7 mLSTM layers and an sLSTM, d 64, 4 heads)
trained, against the JAX package: one step's gradient tree in all five
modes under ``remat`` none and block, and 3 AdamW steps, with
``tests/test_torch_recurrent_train_lm.py``'s helpers and tolerances, but
for the multiplier modes' gradients, which are held to JAX's own
conditioning (below).

The 64-token sequences stay within one 256-token mLSTM chunk.  There the
reduced xlstm's gradients are well conditioned, but not as well as
recurrentgemma's: JAX's own gradients move by up to 5.2e-5 (up to 1.2e-4
at 256 tokens) when every f32 parameter is multiplied by (1 + 2^-20), and
the port sits 2.3e-5 from JAX's.  So each leaf of a multiplier mode is
held at max(1e-5, 4 x that control of the same leaf), measured here on
each run.

Past the first chunk the reference itself is ill conditioned, which no
tolerance here should chase: JAX's gradient moves by 1.6e-2 at 300 tokens
and 1.8e-1 at 512 under the same 2^-20 perturbation, in the leaves of
layers 0-4 (and the tied table through layer 0's input), once the
sequence crosses the first chunk boundary; its eager and jitted gradients
agree to 1.4e-6 there, and the scans alone, on random inputs, hold JAX's
gradients within 8e-6 (``tests/test_torch_recurrent_train.py``).  A
candidate cause, not established: the second chunk's denominator
``max(|n_inter + n_intra|, exp(-m_new))``, where the inter-chunk term can
cancel the intra-chunk one while the ``rmsnorm`` after it hides that in
the forward.  Gradient gates across a chunk boundary (the card's 512-token
phase) are therefore set from the same control, measured there.

AdamW amplifies that conditioning over steps: at the other tests' lr 1e-2
JAX's own 3-step trajectory under the 2^-20 perturbation ends 2.7e-2 apart
in loss and up to 29 % of a leaf's movement apart in parameters, so the
trajectories here run at lr 1e-3, where that control is 1.3e-4 and 2.1 %
(the port's standard: 1.1e-4 and 5.6 %), and the loss still moves by 0.04.
"""
import pytest

from repro_torch.core.matmul import MODES
from test_torch_recurrent_train import _one_thread  # noqa: F401
from test_torch_recurrent_train_lm import (  # noqa: E402
    MULTIPLIER_TOL, check_gradients, check_trajectory, jax_ref, rel)

ARCH = "xlstm-350m"
BUMP = 2.0 ** -20
CONTROL_MAX = 1.2e-4         # JAX's own control within one chunk, measured
TRAJECTORY_LR = 1e-3


def _control():
    """Per leaf: ||JAX's gradient at params x (1 + 2^-20) - JAX's||
    / ||JAX's||."""
    ref = jax_ref(ARCH)
    _, base = ref.grads()
    _, bumped = ref.grads(bump=BUMP)
    return [rel(a, b) for a, b in zip(bumped, base)]


def test_jax_control_within_one_chunk_is_small():
    """The regime the multiplier tolerance rests on: within one mLSTM chunk
    JAX's gradients move by at most 1.2e-4 under the 2^-20 perturbation,
    and by more than rounding alone somewhere (the control measures)."""
    control = _control()
    assert max(control) <= CONTROL_MAX
    assert max(control) > 1e-6


@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("mode", MODES)
def test_step_gradients_match_jax(mode, remat):
    """xlstm: every leaf of one step's gradient tree (each mLSTM's
    projections, ``w_if`` gates and norm, the sLSTM's ``w_x``, recurrent
    ``r``, norm and ``w_out``, the tied table) against
    ``jax.value_and_grad``: the multiplier modes at max(1e-5, 4 x the
    leaf's control), the square modes as recurrentgemma's."""
    control = _control()
    check_gradients(ARCH, mode, remat,
                    tol=lambda i, m: max(MULTIPLIER_TOL, 4 * control[i])
                    if m in ("standard", "square_virtual") else None)


@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("mode", ["standard", "square_pallas"])
def test_loss_trajectory_matches_jax(mode, remat):
    """xlstm: 3 steps against JAX's 3 from the same state, at lr 1e-3 (see
    the module docstring)."""
    check_trajectory(ARCH, mode, remat, lr=TRAJECTORY_LR)
