"""The port's square-routed training step against the JAX package (the
contract of ``tests/test_train_square.py`` and the step half of
``tests/test_train_infra.py``).

Both packages start from one state (``train_state_from_jax``) of the
``tiny-train`` config of ``test_train_square.py`` and train on batches
that are bit-identical by construction (numpy ``default_rng((seed, t))``).

- One step's gradient tree, leaf by leaf, against ``jax.value_and_grad``
  of JAX's loss in every mode and under both ``remat`` settings: the
  multiplier modes at 1e-5, the square modes at 4e-5 with the loss scaled
  by its token count (a power of two, so the scaling is exact) and at
  2e-3 unscaled (see ``test_step_gradients_match_jax``).
- Losses of 3 AdamW steps (lr 1e-2 from the first step, so that they
  move by ~0.3) within JAX's own tolerance for square against standard
  (rtol 2e-3, atol 2e-3), in every mode and under both ``remat``
  settings.  Parameters after N steps within a tenth of their movement,
  leaf by leaf in norm: AdamW's ``m / sqrt(v)`` turns the sign flip of a
  near-zero gradient (reassociation noise) into a step of +-lr, so single
  entries may differ by up to about lr per step whatever the gradients'
  agreement.
- The audit of one step: >= 90 % square forward and backward, every
  backward contraction at ``<site>.bwd_x`` / ``<site>.bwd_w``, exactly 3x
  the forward volume, the same under ``remat="block"`` as under
  ``"none"`` (the recompute notes nothing), and equal to JAX's: on every
  site JAX notes once per execution (projections, FFN, forward and
  backward), and for the chunked sites (attention scores and PV, the
  loss), whose JAX notes come from a traced scan body (traced twice under
  differentiation, its backward noted outside ``count_scale``), equal to
  JAX's audit of the forward alone.
- Microbatch accumulation, int8 gradient compression, the eager
  ``GuardedStep`` (its CUDA-graph form refused on the CPU), inputs
  unchanged by a step, and the launcher on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.core import counting as jcount  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models.lm import build_model as jbuild  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import loss as jloss  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import (params_from_jax,  # noqa: E402
                                 train_state_from_jax,
                                 tree_from_state_dict)
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.models.lm import build_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import step as step_mod  # noqa: E402
from test_torch_moe import _one_thread  # noqa: E402,F401

N_STEPS = 3
RTOL = ATOL = 2e-3            # tests/test_train_square.py's tolerance
TINY = dict(name="tiny-train", family="dense", n_layers=2, d_model=32,
            n_heads=2, n_kv_heads=2, d_ff=64, vocab=128, head_dim=16,
            dtype="float32", scan_layers=False, remat="none",
            attn_chunk_q=16, attn_chunk_kv=16, loss_chunk=16, max_seq=64)
LR_MAX = step_mod.TrainConfig().opt.lr
# the trajectories' optimizer: at the default schedule (lr 3e-4 after 100
# warmup steps) 3 steps move a parameter by ~2e-5 and the loss by ~1e-4,
# so no tolerance of theirs could see a wrong gradient
OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10)


def _port_cfg(mode, **kw):
    return ModelConfig(**dict(TINY, matmul_mode=mode, **kw))


@pytest.fixture(scope="module")
def jax_state():
    """The JAX model, its initial params and AdamW state, and 3 batches."""
    jm = jbuild(JModelConfig(**dict(TINY, matmul_mode="square_virtual")))
    params = jm.init(jax.random.PRNGKey(0))
    opt = jadamw.adamw_init(params)
    batches = JSyntheticLM(JDataConfig(global_batch=2, seq_len=32,
                                       vocab=128, seed=5)).take(N_STEPS)
    return params, opt, batches


@pytest.fixture(scope="module")
def jax_runs(jax_state):
    """JAX's 3-step loss trajectory and final params, per mode."""
    params0, opt0, batches = jax_state
    out = {}
    for mode in ("standard", "square_virtual"):
        jm = jbuild(JModelConfig(**dict(TINY, matmul_mode=mode)))
        step = jax.jit(jstep.make_train_step(jm, jstep.TrainConfig(
            opt=jadamw.AdamWConfig(**OPT))))
        p, o, losses = params0, opt0, []
        for b in batches:
            p, o, met = step(p, o, b)
            losses.append(float(np.asarray(met["loss"])))
        out[mode] = (losses, jax.tree.map(np.asarray, p))
    return out


def _port_state(jax_state):
    params, opt, _ = jax_state
    return train_state_from_jax(jax.tree.map(np.asarray, params),
                                jax.tree.map(np.asarray, opt))


def _port_params(jparams):
    return tree_from_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jparams)))


def _batches():
    return SyntheticLM(DataConfig(global_batch=2, seq_len=32, vocab=128,
                                  seed=5), device="cpu").take(N_STEPS)


def _run(jax_state, mode, **cfg_kw):
    model = build_model(_port_cfg(mode, **cfg_kw), device="cpu")
    step = step_mod.make_train_step(model, step_mod.TrainConfig(
        opt=adamw.AdamWConfig(**OPT)))
    p, o = _port_state(jax_state)
    losses = []
    for b in _batches():
        p, o, met = step(p, o, b)
        losses.append(float(met["loss"]))
    return losses, p


def test_batches_bit_identical_to_jax(jax_state):
    for a, b in zip(jax_state[2], _batches()):
        assert b["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(a["tokens"]),
                                      b["tokens"].numpy())


@pytest.fixture(scope="module")
def jax_grads(jax_state):
    """JAX's loss and gradient tree of one step on the first batch, per
    mode, as port leaves."""
    params, _, batches = jax_state
    out = {}
    for mode in ("standard", "square_virtual"):
        jm = jbuild(JModelConfig(**dict(TINY, matmul_mode=mode)))
        (loss, _), g = jax.value_and_grad(
            jstep.make_loss_fn(jm, jstep.TrainConfig()), has_aux=True)(
                params, batches[0])
        out[mode] = (float(loss), tree_leaves(_port_params(g)))
    return out


def _rel(a, b):
    return ((a.double() - b.double()).norm()
            / b.double().norm().clamp_min(1e-300)).item()


@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("mode,jmode", [
    ("standard", "standard"), ("square_virtual", "square_virtual"),
    ("square_exact", "square_virtual"), ("square_scan", "square_virtual"),
    ("square_pallas", "square_virtual")])
def test_step_gradients_match_jax(jax_state, jax_grads, mode, jmode, remat):
    """One step's gradients (``value_and_grad`` of the step's loss), leaf
    by leaf, against ``jax.value_and_grad`` of JAX's loss from the same
    state; under ``remat="block"`` the recompute must use the same params
    and context.

    The multiplier modes reassociate only: 1e-5 in norm.  A square mode's
    f32 error is about 2^-24 * (|a| + |b|)^2 a term against the product
    |ab|, so it grows with the imbalance of a contraction's operands.  The
    mean loss makes every cotangent ~1/T of the activations it meets (T =
    the step's 64 target tokens); scaled by T (a power of two, so the
    scaling and the division after it are exact) the operands balance and
    the square modes hold 4e-5 (measured <= 1.3e-5); unscaled they hold
    T x that bound rounded up, 2e-3 (measured <= 6.8e-4).  A zero, missing
    or misrouted gradient is off by ~1."""
    jloss, ref = jax_grads[jmode]
    model = build_model(_port_cfg(mode, remat=remat), device="cpu")
    loss_fn = step_mod.make_loss_fn(model, step_mod.TrainConfig())
    p, _ = _port_state(jax_state)
    batch = _batches()[0]
    T = batch["tokens"][:, 1:].numel()
    scales = (1.0,) if jmode == "standard" or mode == "square_virtual" \
        else (1.0, float(T))
    for scale in scales:
        def scaled(params, b):
            loss, met = loss_fn(params, b)
            return loss * scale, met

        (loss, _), g = step_mod.value_and_grad(scaled, p, batch)
        assert float(loss) / scale == pytest.approx(jloss, rel=1e-6)
        leaves = tree_leaves(g)
        assert len(leaves) == len(ref)
        tol = 1e-5 if len(scales) == 1 else (4e-5 if scale > 1 else 2e-3)
        for i, (a, b) in enumerate(zip(leaves, ref)):
            assert a.shape == b.shape and bool(torch.isfinite(a).all())
            assert _rel(a / scale, b) <= tol, (i, scale, _rel(a / scale, b))


@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("mode,jmode", [
    ("standard", "standard"), ("square_virtual", "square_virtual"),
    ("square_exact", "square_virtual"), ("square_scan", "square_virtual"),
    ("square_pallas", "square_virtual")])
def test_loss_trajectory_matches_jax(jax_state, jax_runs, mode, jmode,
                                     remat):
    """3 steps of the port from JAX's state against 3 JAX steps (the
    ``square_*`` modes against JAX's ``square_virtual``: its Pallas kernel
    does not run on this host)."""
    losses, params = _run(jax_state, mode, remat=remat)
    jlosses, jparams = jax_runs[jmode]
    assert np.isfinite(losses).all()
    assert abs(jlosses[-1] - jlosses[0]) > 50 * ATOL      # the loss moved
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL, atol=ATOL)
    start = tree_leaves(_port_params(jax_state[0]))
    mine = _port_params(jparams)
    for a, b, p0 in zip(tree_leaves(params), tree_leaves(mine), start):
        moved = (b.double() - p0.double()).norm()
        assert moved > 0
        assert (a.double() - b.double()).norm() <= 0.1 * moved


def test_square_trajectory_tracks_standard(jax_state):
    """The JAX contract within the port: square-routed training tracks the
    multiplier baseline to reassociation tolerance."""
    std, _ = _run(jax_state, "standard")
    sq, _ = _run(jax_state, "square_pallas")
    np.testing.assert_allclose(sq, std, rtol=RTOL, atol=ATOL)


def test_fixed_seed_run_is_deterministic(jax_state):
    l1, p1 = _run(jax_state, "square_pallas", remat="block")
    l2, p2 = _run(jax_state, "square_pallas", remat="block")
    assert adamw.tree_fingerprint(np.asarray(l1, np.float32)) == \
        adamw.tree_fingerprint(np.asarray(l2, np.float32))
    assert adamw.tree_fingerprint(p1) == adamw.tree_fingerprint(p2)


def _audit(jax_state, mode, remat):
    model = build_model(_port_cfg(mode, remat=remat), device="cpu")
    step = step_mod.make_train_step(model, step_mod.TrainConfig())
    p, o = _port_state(jax_state)
    (_, _, met), ctr = step_mod.audit_step(step, p, o, _batches()[0])
    assert np.isfinite(float(met["loss"]))
    return ctr


CHUNKED_SITES = ("attn_scores", "attn_pv", "loss")


def test_audit_step_covers_backward_and_equals_jax(jax_state):
    params, opt, batches = jax_state
    ctr = _audit(jax_state, "square_pallas", "none")
    mults = {k: v["mults"] for k, v in ctr.by_site().items()}
    assert ctr.fraction_square == 1.0 and ctr.fraction_square_bwd == 1.0
    fwd = {s: m for s, m in mults.items() if ".bwd_" not in s}
    for s, m in fwd.items():          # both gradients of every contraction
        assert mults[f"{s}.bwd_x"] == m and mults[f"{s}.bwd_w"] == m
    assert ctr.total_mults == 3 * sum(fwd.values())
    assert ctr.bwd_mults == 2 * sum(fwd.values())
    # remat="block": the recompute notes nothing
    blk = _audit(jax_state, "square_pallas", "block")
    assert {k: v["mults"] for k, v in blk.by_site().items()} == mults
    # against JAX: its train-step audit where it notes executions ...
    jm = jbuild(JModelConfig(**dict(TINY, matmul_mode="square_virtual")))
    jfn = jax.jit(jstep.make_train_step(jm, jstep.TrainConfig()))
    _, jctr = jstep.audit_step(jfn, params, opt, batches[0])
    jm_sites = {k: v["mults"] for k, v in jctr.by_site().items()}
    assert set(jm_sites) == set(mults)
    for s, m in jm_sites.items():
        if s.split(".")[0] not in CHUNKED_SITES:
            assert mults[s] == m, s
    # ... and its audit of the forward alone for the chunked sites
    with jcount.track_contractions() as jfwd:
        tok = batches[0]["tokens"]
        hidden, _, _ = jm.forward(params, {"tokens": tok[:, :-1]})
        jloss.chunked_xent(hidden, tok[:, 1:], params["embed"]["table"],
                           chunk=TINY["loss_chunk"], mode="square_virtual")
    jf = {k: v["mults"] for k, v in jfwd.by_site().items()}
    assert jf == fwd


def test_audit_by_policy_keeps_attention_backward_standard(jax_state):
    """Under ``SQUARE_GEMMS_POLICY`` the attention backward sites inherit
    the forward pin (``standard``), every other site stays square."""
    from repro_torch.configs.base import SQUARE_GEMMS_POLICY
    model = build_model(_port_cfg("square_pallas",
                                  contraction_policy=SQUARE_GEMMS_POLICY),
                        device="cpu")
    step = step_mod.make_train_step(model, step_mod.TrainConfig())
    p, o = _port_state(jax_state)
    _, ctr = step_mod.audit_step(step, p, o, _batches()[0])
    modes = {r.site: r.mode for r in ctr.records}
    for s, m in modes.items():
        want = "standard" if s.split(".")[0] in ("attn_scores", "attn_pv") \
            else "square_pallas"
        assert m == want, s
    by = ctr.by_site()
    attn = sum(v["mults"] for k, v in by.items()
               if k.split(".")[0] in ("attn_scores", "attn_pv"))
    assert ctr.fraction_square == (ctr.total_mults - attn) / ctr.total_mults
    assert 0.0 < ctr.fraction_square_bwd < 1.0


def test_inputs_unchanged_by_a_step(jax_state):
    """A step writes none of its inputs: a retry and the trainer's initial
    snapshot reuse them."""
    model = build_model(_port_cfg("square_pallas", remat="block"),
                        device="cpu")
    step = step_mod.make_train_step(model, step_mod.TrainConfig(
        grad_compression=True))
    p, o = _port_state(jax_state)
    b = _batches()[0]
    before = adamw.tree_fingerprint({"p": p, "o": o, "b": b})
    out1 = step(p, o, b)
    assert adamw.tree_fingerprint({"p": p, "o": o, "b": b}) == before
    assert all(not t.requires_grad for t in tree_leaves(p))
    out2 = step(p, o, b)
    assert adamw.tree_fingerprint(out1[:2]) == adamw.tree_fingerprint(
        out2[:2])


def test_microbatch_equivalence_and_jax(jax_state):
    """Accumulating 2 microbatches of 2 equals one batch of 4 (the loss at
    the JAX test's 1e-5), and equals JAX's accumulated step."""
    cfg = _port_cfg("square_pallas")
    model = build_model(cfg, device="cpu")
    batch = SyntheticLM(DataConfig(global_batch=4, seq_len=16, vocab=128,
                                   seed=9), device="cpu").next_batch()
    jbatch = JSyntheticLM(JDataConfig(global_batch=4, seq_len=16,
                                      vocab=128, seed=9)).next_batch()
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    p, o = _port_state(jax_state)
    outs = {}
    for mb in (0, 2):
        step = step_mod.make_train_step(
            model, step_mod.TrainConfig(opt=opt_cfg, microbatch=mb))
        p2, _, met = step(p, o, batch)
        outs[mb] = (p2, float(met["loss"]))
    np.testing.assert_allclose(outs[0][1], outs[2][1], rtol=1e-5)
    # one AdamW step from zero moments moves each parameter by lr * sign(g)
    # (+ decay): a near-zero gradient whose sign the summation order flips
    # differs by 2 * lr, so parameters are held at 2 * lr
    for a, b in zip(tree_leaves(outs[0][0]), tree_leaves(outs[2][0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=2 * 1e-3)
    params, opt, _ = jax_state
    jm = jbuild(JModelConfig(**dict(TINY, matmul_mode="square_virtual")))
    jfn = jax.jit(jstep.make_train_step(jm, jstep.TrainConfig(
        opt=jadamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10),
        microbatch=2)))
    jp, _, jmet = jfn(params, opt, jbatch)
    np.testing.assert_allclose(outs[2][1], float(jmet["loss"]), rtol=RTOL,
                               atol=ATOL)
    mine = _port_params(jp)
    for a, b in zip(tree_leaves(outs[2][0]), tree_leaves(mine)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=2 * 1e-3)


def test_grad_compression_step_matches_jax(jax_state):
    params, opt, batches = jax_state
    jm = jbuild(JModelConfig(**dict(TINY, matmul_mode="square_virtual")))
    jfn = jax.jit(jstep.make_train_step(jm, jstep.TrainConfig(
        grad_compression=True)))
    jp, jo, jmet = jfn(params, opt, batches[0])
    model = build_model(_port_cfg("square_pallas"), device="cpu")
    step = step_mod.make_train_step(model, step_mod.TrainConfig(
        grad_compression=True))
    p, o = _port_state(jax_state)
    p1, o1, met = step(p, o, _batches()[0])
    assert "error_feedback" in o1
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=RTOL)
    mine = _port_params(jp)
    for a, b in zip(tree_leaves(p1), tree_leaves(mine)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=2 * LR_MAX)


def test_guarded_step_eager_and_jit_refused(jax_state):
    from repro_torch.obs.metrics import MetricsRegistry
    model = build_model(_port_cfg("square_pallas"), device="cpu")
    raw = step_mod.make_train_step(model, step_mod.TrainConfig())
    reg = MetricsRegistry()
    guarded = step_mod.GuardedStep(raw, registry=reg)
    p, o = _port_state(jax_state)
    b = _batches()[0]
    out = guarded(p, o, b)
    assert adamw.tree_fingerprint(out[:2]) == \
        adamw.tree_fingerprint(raw(p, o, b)[:2])
    assert guarded.stats() == {"guard_trips": 0, "rejits": 0, "retries": 0}
    assert {"train_guard_trips_total", "train_guard_rejits_total",
            "train_guard_retries_total"} <= set(reg.snapshot()["counters"])
    # jit=None (the default) ran eagerly on the CPU above; jit=True asks
    # for a CUDA graph, which the CPU has not
    assert guarded.captures == 0
    with pytest.raises(ValueError, match="jit=True"):
        step_mod.GuardedStep(raw, jit=True)(p, o, b)


def test_prefill_and_decode_step_builders():
    cfg = _port_cfg("square_pallas")
    model = build_model(cfg, device="cpu")
    params = model.tree()
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, 128, (2, 8)).astype(np.int32))
    logits, cache = step_mod.make_prefill_step(model, 16)(params,
                                                          {"tokens": tok})
    assert tuple(logits.shape) == (2, cfg.padded_vocab)
    nxt = torch.argmax(logits, -1)[:, None].int()
    pos = torch.full((2,), 8, dtype=torch.int32)
    logits2, _ = step_mod.make_decode_step(model)(params, cache, nxt, pos)
    assert tuple(logits2.shape) == (2, cfg.padded_vocab)
    assert bool(torch.isfinite(logits2).all())


def test_launcher_trains_on_the_cpu(tmp_path):
    from repro_torch.launch import train as launch
    out = launch.main(["--device", "cpu", "--reduced", "--steps", "4",
                       "--global-batch", "2", "--seq", "32",
                       "--ckpt-every", "2", "--ckpt-dir",
                       str(tmp_path / "ck"), "--matmul-mode",
                       "square_pallas", "--metrics-file",
                       str(tmp_path / "m.json"), "--trace-out",
                       str(tmp_path / "t.json")])
    assert out["final_step"] == 4
    assert np.isfinite(out["loss_trajectory"]).all()
    audit = out["contraction_audit"]
    assert audit["fraction_square"] == 1.0
    assert audit["fraction_square_bwd"] == 1.0
    import json
    snap = json.load(open(tmp_path / "m.json"))
    assert snap["counters"]["train_steps_total"] == 4
    assert snap["counters"]["ckpt_commits_total"] >= 2
    assert snap["contraction_audit"]["bwd_mults"] > 0
    from repro_torch.obs import check as obs_check
    assert obs_check.main([str(tmp_path / "m.json"),
                           str(tmp_path / "t.json")]) == 0
    trace = json.load(open(tmp_path / "t.json"))
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"train.step", "ckpt.commit"} <= names
    # a second launch resumes from the last checkpoint and stops at once
    again = launch.main(["--device", "cpu", "--reduced", "--steps", "4",
                         "--global-batch", "2", "--seq", "32",
                         "--ckpt-dir", str(tmp_path / "ck")])
    assert again["loss_trajectory"] == out["loss_trajectory"]
