"""The dry run (``repro_torch/launch/dryrun.py``): each cell's step priced
on ``meta``, against the JAX package's compiled step.

- One reduced cell per family -- dense (deepseek-7b), MoE (mixtral-8x7b),
  recurrent (recurrentgemma-2b, xlstm-350m), encoder-decoder (whisper)
  and prefix-token (paligemma) -- for train, prefill and decode (B 2, S
  32, ``standard``): every input is ``meta``, the parameter counts are
  JAX's, and the prefill and decode cells count exactly the dot FLOPs of
  JAX's ``analyze_compiled`` of the same step.  A train cell counts JAX's
  plus one vocab GEMM: the loss chunk is rematerialised
  (``train/loss.py``, JAX's ``jax.checkpoint``) and eager torch runs the
  recompute, which XLA elides; and xlstm's less the cotangents of its
  layers' initial states, which JAX's scans contract and autograd does
  not ask for (:func:`test_reduced_train_cells`).
- A data-parallel cell (16-way ``data``): one rank's batch shard, and
  the gradients' all-reduce counted.
- The published-width deepseek-7b ``train_4k`` cell, its 256 sequences
  in one microbatch (JAX's 64-sequence microbatches run the same layers
  four times over, four times as long to trace): its arguments alone
  would be ~78 GB (bf16 params and AdamW's f32 moments), and the
  process's RSS grows by less than 1 GiB.
- A mesh with a ``model`` axis is refused with the ROADMAP item; a
  full-attention arch's ``long_500k`` is skipped with JAX's reason.
"""
import resource
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.data.pipeline import make_batch_specs as j_specs  # noqa: E402
from repro.models.lm import build_model as jbuild  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.roofline.hlo_analysis import analyze_compiled  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed.sharding import AbstractMesh  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from test_torch_moe import _one_thread  # noqa: E402,F401

FAMILIES = ("deepseek-7b", "mixtral-8x7b", "recurrentgemma-2b",
            "xlstm-350m", "whisper-large-v3", "paligemma-3b")
B, S = 2, 32


def _jax_dot_flops(arch, kind):
    """JAX's ``analyze_compiled`` dot FLOPs of the reduced cell's step."""
    jcfg = jget(arch).reduced()
    jm = jbuild(jcfg)
    ap = jm.abstract_params()
    batch = j_specs(jcfg, JShape(f"s_{kind}", S, B, kind))
    if kind == "train":
        fn = jstep.make_train_step(jm, jstep.TrainConfig(microbatch=64))
        lowered = jax.jit(fn).lower(ap, jax.eval_shape(jadamw.adamw_init, ap),
                                    batch)
    elif kind == "prefill":
        lowered = jax.jit(jstep.make_prefill_step(jm, cache_len=S)).lower(
            ap, batch)
    else:
        cache = jax.eval_shape(lambda: jm.init_cache(B, S))
        lowered = jax.jit(jstep.make_decode_step(jm)).lower(
            ap, cache, batch["tokens"],
            jax.ShapeDtypeStruct((B,), jnp.int32))
    return analyze_compiled(lowered.compile()).dot_flops, jm.n_params()


def _cell(arch, kind, **kw):
    return dryrun.dryrun_cell(arch, ShapeConfig(f"s_{kind}", S, B, kind),
                              overrides={"_reduced": True}, verbose=False,
                              **kw)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_reduced_serve_cells_match_jax(arch, kind):
    cell = _cell(arch, kind)
    want, n_params = _jax_dot_flops(arch, kind)
    assert cell["matmul_mode"] == "standard" and cell["n_params"] == n_params
    assert cell["dot_flops_per_device"] == want > 0
    assert cell["bytes_lb_per_device"] <= cell["bytes_per_device"]
    assert cell["peak_bytes_per_device"] >= cell["argument_bytes_per_device"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_reduced_train_cells(arch):
    cell = _cell(arch, "train")
    want, n_params = _jax_dot_flops(arch, "train")
    cfg = jget(arch).reduced()
    vocab_gemm = 2 * B * S * cfg.padded_vocab * cfg.d_model
    assert cell["n_params"] == n_params
    # JAX's scans also contract the cotangent of each recurrent layer's
    # initial state, which autograd does not ask for (zeros need no
    # gradient): the mLSTM's (B, h, S, hd) @ (hd, hd) against C0 and the
    # sLSTM's first step's (B, h, hd) @ (hd, 4 hd) against h0
    h = cfg.n_heads
    hm = int(cfg.inner_factor * cfg.d_model) // h
    hs = cfg.d_model // h
    kinds = cfg.layer_kinds
    initial = (kinds.count("mlstm") * 2 * B * h * S * hm * hm
               + kinds.count("slstm") * 2 * B * h * hs * 4 * hs)
    assert cell["dot_flops_per_device"] == want + vocab_gemm - initial
    assert cell["audit_mults"] > 0 and cell["collective_bytes"] == {}


def test_data_parallel_cell_counts_the_gradient_all_reduce():
    mesh = AbstractMesh((16,), ("data",))
    sh = ShapeConfig("dp", S, 32, "train")
    one = dryrun.dryrun_cell("deepseek-7b", ShapeConfig("one", S, 2,
                                                        "train"),
                             overrides={"_reduced": True}, verbose=False)
    dp = dryrun.dryrun_cell("deepseek-7b", sh, mesh=mesh, verbose=False,
                            overrides={"_reduced": True})
    assert dp["mesh"] == "16" and dp["n_devices"] == 16
    assert dp["tokens_per_device"] == 2 * S
    # one rank does one 2-row shard's work, plus the all-reduces
    assert dp["dot_flops_per_device"] == one["dot_flops_per_device"]
    grads = 4 * dp["n_params"]            # f32 leaves of the reduced arch
    # and the loss: the token and correct counts and the loss share
    assert dp["collective_bytes"]["all-reduce"] == grads + 3 * 4


def test_published_deepseek_train_cell_allocates_nothing():
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss   # KiB
    cell = dryrun.dryrun_cell("deepseek-7b", "train_4k", verbose=False,
                              overrides={"_microbatch": 256})
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - rss
    assert cell["n_params"] == jbuild(jget("deepseek-7b")).n_params()
    params = 2 * cell["n_params"]                      # bf16
    assert cell["argument_bytes_per_device"] > params + 2 * 4 * \
        cell["n_params"]                               # + f32 m and v
    assert grown * 1024 < 2 ** 30, f"RSS grew {grown / 2 ** 20:.2f} GiB"
    assert cell["dot_flops_per_device"] > 6 * cell["n_active_params"] * \
        256 * 4096
    assert cell["trace_seconds"] > 0 and cell["tokens_per_device"] == \
        256 * 4096


def test_model_axis_refused_and_long_500k_skipped():
    with pytest.raises(NotImplementedError, match="ROADMAP Q1 step 8.1"):
        dryrun.dryrun_cell("deepseek-7b", "train_4k",
                           mesh=make_production_mesh(), verbose=False)
    cell = dryrun.dryrun_cell("deepseek-7b", "long_500k", verbose=False)
    assert cell["skipped"] and cell["reason"] == dryrun.LONG_REASON
    # JAX's reason, word for word (its module is not imported: importing
    # it sets XLA_FLAGS for the process)
    jax_src = (Path(__file__).resolve().parents[1] / "src" / "repro" /
               "launch" / "dryrun.py").read_text()
    assert '"reason": "full-attention arch: long_500k needs "' in jax_src
    assert '"sub-quadratic attention (see DESIGN.md)"' in jax_src
    assert not dryrun.dryrun_cell("recurrentgemma-2b", "long_500k",
                                  verbose=False, overrides={
                                      "_reduced": True}).get("skipped")
