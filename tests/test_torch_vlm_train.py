"""The port's prefix-token LM trained, against the JAX package, on
``paligemma-3b.reduced()`` (2 layers, d 64, 4 query heads over 1 KV head,
4 prefix patches): the pipeline's ``patches`` (and whisper's ``frames``)
bit-identical to JAX's across a restart; one step's gradient tree against
``jax.value_and_grad`` in all five modes under ``remat`` none and block;
3 AdamW steps' losses; the step's audit against JAX's forward and
``chip_smoke.py``'s analytic count (the loss's vocab GEMM over the S text
positions only); the ``Trainer``'s resume and the launcher.  Whisper's
training is in ``tests/test_torch_encdec_train.py``, with these helpers.

Both packages start from one state (``train_state_from_jax``) and take
batches that are bit-identical by construction (2 sequences of 64 tokens
and their patches), with ``tests/test_torch_recurrent_train_lm.py``'s
helpers and tolerances: per tensor 1e-5 for ``standard`` and
``square_virtual``, 1e-3 for the square modes with the loss scaled by its
token count T; 3 steps' losses at rtol = atol = 2e-3, each parameter
within a tenth (``standard``) or a quarter (``square_pallas``) of its
movement.
"""
import collections
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import counting as jcount  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models.lm import build_model as jbuild  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.core.matmul import MODES  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import routing  # noqa: E402
from repro_torch.models.lm import build_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import step as step_mod  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from test_torch_recurrent_train import _one_thread  # noqa: E402,F401
from test_torch_recurrent_train_lm import (  # noqa: E402
    BATCH, batches, cfgs, check_gradients, check_trajectory, jax_ref)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

ARCH = "paligemma-3b"
ROUTE_KERNEL = {"kernel": "K1", "batched": "K2", "fold": "K3",
                "virtual": "virtual"}


# -------------------------------------------------------- the pipeline
@pytest.mark.parametrize("arch,key", [("paligemma-3b", "patches"),
                                      ("whisper-large-v3", "frames")])
def test_pipeline_stubs_match_jax_across_a_restart(arch, key):
    """``next_batch``'s tokens and its stub (paligemma's ``patches`` from
    ``(seed, step, 7)``, whisper's ``frames`` from ``(seed, step, 11)``,
    f32, times 0.02) equal the JAX pipeline's bit for bit at several seeds
    and steps, and a pipeline restored from the state after step 1 (a
    restart) draws steps 2 and 3 as the uninterrupted one did."""
    jc, tc = cfgs(arch)
    length = tc.prefix_tokens or tc.encoder_seq
    for seed in (0, 5, 1234):
        dcfg = dict(global_batch=3, seq_len=16, seed=seed)
        want = JSyntheticLM(JDataConfig(vocab=jc.vocab, **dcfg), jc).take(4)
        data = SyntheticLM(DataConfig(vocab=tc.vocab, **dcfg), tc,
                           device="cpu")
        got = data.take(2)
        again = SyntheticLM(DataConfig(vocab=tc.vocab, **dcfg), tc,
                            device="cpu")
        again.load_state_dict(data.state_dict())
        got += again.take(2)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w) == sorted(["tokens", key])
            assert g[key].dtype == torch.float32
            assert tuple(g[key].shape) == (3, length, tc.d_model)
            for k in g:
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


# ------------------------------------------------------ the gradients
@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("mode", MODES)
def test_step_gradients_match_jax(mode, remat):
    """Every leaf of one step's gradient tree (the attention's MQA
    projections, the GeGLU FFN, the norms, the tied table, whose gradient
    comes from the text positions' embeddings and the loss) against
    ``jax.value_and_grad`` of JAX's loss, which cuts the prefix positions
    before the cross-entropy, at the module docstring's tolerances."""
    check_gradients(ARCH, mode, remat)


@pytest.mark.parametrize("mode", ["standard", "square_pallas"])
def test_loss_trajectory_matches_jax(mode):
    """3 steps (remat block) against JAX's 3 from the same state."""
    check_trajectory(ARCH, mode, "block")


# ------------------------------------------------------------ the audit
def jax_forward_audit(arch):
    """JAX's forward-only audit of its loss on the first batch
    (``scan_layers=False``: its notes fire at trace time, and a scanned
    body is traced twice under differentiation)."""
    jc, _ = cfgs(arch, "square_virtual", scan_layers=False)
    jm = jbuild(jc)
    loss_fn = jstep.make_loss_fn(jm, jstep.TrainConfig())
    params = jm.init(jax.random.PRNGKey(0))
    batch = JSyntheticLM(JDataConfig(vocab=jc.vocab, **BATCH), jc).take(1)[0]
    with jcount.track_contractions() as ctr:
        jax.make_jaxpr(loss_fn)(params, batch)
    return {s: d["mults"] for s, d in ctr.by_site().items()}


def check_audit(arch, remat):
    """One square_pallas step's audit, site by site, equals
    ``chip_smoke.recurrent_train_audit`` (3 x the forward, fraction_square
    and fraction_square_bwd 1.0), its forward sites JAX's forward audit,
    and the routes it took ``chip_smoke.recurrent_train_launches``'
    forward + backward + recompute.  Returns the forward's mults by site."""
    _, tc = cfgs(arch, "square_pallas", remat=remat)
    step = step_mod.make_train_step(build_model(tc, device="cpu"),
                                    step_mod.TrainConfig())
    p, o = jax_ref(arch).port_state()
    taken = routing.select_matmul_route.taken
    taken.clear()
    (_, _, met), ctr = step_mod.audit_step(step, p, o, batches(tc, 1)[0])
    assert np.isfinite(float(met["loss"]))
    got = {s: d["mults"] for s, d in ctr.by_site().items()}
    B, S = BATCH["global_batch"], BATCH["seq_len"]
    assert got == chip_smoke.recurrent_train_audit(tc, B, S)
    assert ctr.fraction_square == ctr.fraction_square_bwd == 1.0
    fwd = {s: m for s, m in got.items() if ".bwd_" not in s}
    assert ctr.total_mults == 3 * sum(fwd.values())
    assert fwd == jax_forward_audit(arch)
    rules = chip_smoke.recurrent_train_launches(tc, B, S)
    total = collections.Counter()
    for part in ("forward", "backward", "recompute"):
        total.update(rules[part])
    assert {ROUTE_KERNEL[k]: n for k, n in taken.items() if n} == \
        {k: n for k, n in total.items() if n}
    return fwd, tc


@pytest.mark.parametrize("remat", ["none", "block"])
def test_audit_and_routes_equal_the_analytic_count(remat):
    """paligemma's step: the layers' contractions over the P + S
    positions, the loss's vocab GEMM over the S text positions only."""
    fwd, tc = check_audit(ARCH, remat)
    B, S = BATCH["global_batch"], BATCH["seq_len"]
    assert fwd["loss"] == B * S * tc.d_model * tc.padded_vocab
    assert fwd["ffn"] == tc.n_layers * 3 * B * (S + tc.prefix_tokens) \
        * tc.d_model * tc.d_ff


# ---------------------------------------------- the trainer, the launcher
def check_trainer_resumes(arch, tmp_path):
    """The ``Trainer`` over the square_pallas step (eager on the CPU): 4
    steps with a checkpoint every 2, then a trainer that resumes from the
    step-2 checkpoint of a 2-step run and runs to 4: the same losses and
    parameters bit for bit (the patches or frames regenerated from the
    restored ``(seed, step)``)."""
    _, tc = cfgs(arch, "square_pallas", remat="block")
    step = step_mod.make_train_step(build_model(tc, device="cpu"),
                                    step_mod.TrainConfig())

    def trainer(ckpt, total):
        p, o = jax_ref(arch).port_state()
        data = SyntheticLM(DataConfig(global_batch=2, seq_len=16,
                                      vocab=tc.vocab, seed=7), tc,
                           device="cpu")
        return Trainer(TrainerConfig(total_steps=total, ckpt_every=2,
                                     ckpt_dir=str(ckpt), log_every=100,
                                     audit_contractions=False),
                       step, p, o, data)

    whole = trainer(tmp_path / "a", 4)
    want = whole.run()
    assert want["final_step"] == 4
    assert np.isfinite(want["loss_trajectory"]).all()
    trainer(tmp_path / "b", 2).run()
    resumed = trainer(tmp_path / "b", 4)
    assert resumed.maybe_resume() and resumed.step == 2
    got = resumed.run()
    assert got["loss_trajectory"] == want["loss_trajectory"]
    assert adamw.tree_fingerprint(resumed.params) == \
        adamw.tree_fingerprint(whole.params)


def test_trainer_resumes_from_its_checkpoint(tmp_path):
    check_trainer_resumes(ARCH, tmp_path)


def check_launcher(arch, tmp_path, extra=()):
    """``python -m repro_torch.launch.train --arch ARCH --reduced`` on the
    CPU: finite losses, its checkpoint, and the trainer's first-step
    audit, all square, equal to ``chip_smoke.recurrent_train_audit``."""
    from repro_torch.launch import train as launch
    out = launch.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--steps", "2", "--global-batch", "2", "--seq", "32",
                       "--ckpt-every", "2", "--ckpt-dir",
                       str(tmp_path / "ck"), "--matmul-mode",
                       "square_pallas", *extra])
    assert out["final_step"] == 2
    assert np.isfinite(out["loss_trajectory"]).all()
    audit = out["contraction_audit"]
    assert audit["fraction_square"] == audit["fraction_square_bwd"] == 1.0
    _, tc = cfgs(arch, "square_pallas")
    return out, tc, {s: d["mults"] for s, d in audit["by_site"].items()}


def test_launcher_trains_on_the_cpu(tmp_path):
    _, tc, got = check_launcher(ARCH, tmp_path)
    assert got == chip_smoke.recurrent_train_audit(tc, 2, 32)
    assert (tmp_path / "ck" / "step_000000002").is_dir()
