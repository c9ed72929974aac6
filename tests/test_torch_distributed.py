"""The port under a mesh: the contracts of ``tests/test_distributed.py``
(JAX's tolerances) and the elastic contract of
``tests/test_approx_and_elastic.py::test_elastic_restore_across_device_counts``.

The world is ONE child process that spawns 8 ``gloo`` ranks (a ``file://``
store) and runs every check there, so the file costs one spawn; rank 0
prints one JSON line.  On a 2 x 4 (data, model) ``DeviceMesh``:

- ``tp_matmul``: the square-mode GEMM with its contraction dim split over
  ``model`` (``layers/basic.py::dense_tp_reduce``, reduced in f32, the rows
  split over ``data``) equals the unsharded product within 1e-3 in
  ``square_virtual``, ``square_scan`` and ``square_pallas``'s plain
  version;
- ``train``: one deepseek-7b reduced train step under the mesh (batch 8
  over ``data``, params whole) against the same step in one process: loss
  within 1e-3, params within 5e-3 (JAX's gates), and the gradients
  themselves (``make_grad_fn``) leaf by leaf and in their norm at
  :data:`GRAD_TOL`; the same with ``tp_bf16_reduce`` on (the attention
  output and FFN down-projections row-parallel over ``model``), and with
  two microbatches of the global rows;
- ``moe``: mixtral-8x7b reduced, its forward with each rank's batch shard
  and the expert hidden axis over ``model``, within 2e-2 of one process,
  and its gradients at :data:`GRAD_TOL`;
- ``rules``: paligemma-3b's kv = 1 tensors replicated and its vocab and
  mlp sharded on the ``DeviceMesh`` (its placements too).

Then a (2, 4) mesh of a replica axis and ``data``: each group of 4 ranks
trains deepseek-7b reduced data-parallel for 3 steps through the
``Trainer`` and rank 0 checkpoints it; this process restores it on one
process and trains on to step 6 (every loss finite).
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
WORLD = 8


def _opt():
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod
    return step_mod.TrainConfig(opt=adamw.AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=10))


def _batch(cfg):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    return SyntheticLM(DataConfig(global_batch=8, seq_len=16,
                                  vocab=cfg.vocab), cfg,
                       device="cpu").next_batch()


def _gather_rows(x, mesh):
    """The data axis's row shards of ``x`` stacked back in rank order."""
    import torch.distributed as dist
    parts = [torch.empty_like(x) for _ in range(mesh.size(0))]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group("data"))
    return torch.cat(parts)


def _tp_matmul(mesh):
    import numpy as np
    from repro_torch.distributed import context as dctx
    from repro_torch.distributed import sharding as shd
    from repro_torch.layers import basic
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(16, 64)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32))
    ref = a @ b
    errs = {}
    for mode in ("square_virtual", "square_scan", "square_pallas"):
        with dctx.use_mesh(mesh):
            local = shd.shard_batch(mesh, {"a": a})["a"]
            out = basic.dense_tp_reduce({"w": b}, local, mode=mode,
                                        reduce_dtype=torch.float32)
        errs[mode] = float((_gather_rows(out, mesh) - ref).abs().max())
    return errs


def _grad_gap(got, ref) -> float:
    """The worst leaf's relative gradient gap ``|got - ref| / |ref|`` (L2
    norms; a leaf zero in both counts 0)."""
    from repro_torch.core.tree import tree_leaves
    worst = 0.0
    for g, r in zip(tree_leaves(got), tree_leaves(ref)):
        d = float((g.double() - r.double()).norm())
        n = float(r.double().norm())
        worst = max(worst, d / n if n else (0.0 if d == 0 else float("inf")))
    return worst


def _train(mesh, arch="deepseek-7b", microbatch=0, **over):
    """One step of ``arch`` reduced under ``mesh`` (the global batch of 8;
    each rank takes its shard) and in one process: the loss, the
    gradients (``make_grad_fn``: the worst leaf's relative gap and
    AdamW's ``grad_norm``), the last microbatch's xent and the params
    after AdamW (the grad norm held to the one-process gradients').  The
    one-process gradients are the mean over the data
    shards of each shard's gradients (JAX's ``pmean`` of the MoE aux loss
    is a mean over shards; the token-mean xent equals the whole batch's,
    every row holding the same tokens), or the whole batch's when the
    step accumulates microbatches."""
    import dataclasses
    import math
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.distributed import context as dctx
    from repro_torch.models.lm import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    model = build_model(cfg, device="cpu", seed=0)
    params = model.train_params()
    batch = _batch(cfg)
    tcfg = dataclasses.replace(_opt(), microbatch=microbatch)
    grad_fn = step_mod.make_grad_fn(model, tcfg)
    if microbatch:
        (l1, m1), g1 = grad_fn(params, batch)
    else:
        d = mesh.size(0)
        parts = [grad_fn(params, {k: v.chunk(d)[h] for k, v in
                                  batch.items()}) for h in range(d)]
        l1 = sum(float(pl) for (pl, _), _ in parts) / d
        g1 = tree_map(lambda *gs: sum(gs) / d, *[g for _, g in parts])
        m1 = parts[-1][0][1]
    fn = step_mod.make_train_step(model, tcfg)
    p1, _, s1 = fn(params, adamw.adamw_init(params), batch)
    with dctx.use_mesh(mesh):
        (l2, m2), g2 = grad_fn(params, batch)
        p2, _, s2 = fn(params, adamw.adamw_init(params), batch)
    delta = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
    gn1 = math.sqrt(sum(float(g.double().square().sum())
                        for g in tree_leaves(g1)))
    gn2 = float(s2["grad_norm"])
    return {"loss1": float(l1), "loss2": float(l2),
            "xent1": float(m1["xent"]), "xent2": float(m2["xent"]),
            "grad_gap": _grad_gap(g2, g1),
            "grad_norm_gap": abs(gn2 - gn1) / gn1,
            "step_loss": [float(s1["loss"]), float(s2["loss"])],
            "param_delta": delta}


def _moe(mesh):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.distributed import context as dctx
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.lm import build_model
    cfg = get_config("mixtral-8x7b").reduced()
    model = build_model(cfg, device="cpu", seed=0)
    params = model.tree()
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32))}
    h1, _, _ = model.forward(params, batch)
    with dctx.use_mesh(mesh):
        h2, _, _ = model.forward(params, shd.shard_batch(mesh, batch))
    return {"err": float((h1 - _gather_rows(h2, mesh)).abs().max())}


def _rules(mesh):
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.lm import build_model
    spec = build_model(get_config("paligemma-3b"), device="meta").spec()
    sh = shd.param_shardings(mesh, spec)
    up = sh["layers"][0]["ffn"]["w_up"]["w"]
    return {"embed": list(map(str, sh["embed"]["table"].spec)),
            "wk": list(map(str, sh["layers"][0]["attn"]["wk"]["w"].spec)),
            "ffn_up": list(map(str, up.spec)),
            "up_placements": up.placements == [Replicate(), Shard(1)]}


def _elastic(ckpt, rank):
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.distributed import context as dctx
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod
    from repro_torch.train.trainer import Trainer, TrainerConfig
    mesh = make_mesh((2, 4), ("replica", "data"))
    cfg = get_config("deepseek-7b").reduced()
    params = build_model(cfg, device="cpu", seed=0).train_params()
    model = build_model(cfg, device="meta")
    data = SyntheticLM(DataConfig(global_batch=8, seq_len=16,
                                  vocab=cfg.vocab), cfg, device="cpu")
    # one writer: the other ranks hold the same state
    where = ckpt if rank == 0 else tempfile.mkdtemp()
    with dctx.use_mesh(mesh):
        tr = Trainer(TrainerConfig(total_steps=3, ckpt_every=3,
                                   ckpt_dir=where, log_every=100),
                     step_mod.make_train_step(model, _opt()), params,
                     adamw.adamw_init(params), data)
        out = tr.run()
    return {"step": out["final_step"]}


def _rank(rank, store, ckpt):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2, 4), ("data", "model"))
    res = {"tp_matmul": _tp_matmul(mesh), "train": _train(mesh),
           "train_tp": _train(mesh, tp_bf16_reduce=True),
           "train_micro": _train(mesh, microbatch=4),
           "moe": _moe(mesh), "moe_train": _train(mesh, "mixtral-8x7b"),
           "rules": _rules(mesh),
           "elastic": _elastic(ckpt, rank)}
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(res), flush=True)


def _world(tmp_path) -> dict:
    env = dict(os.environ, PYTHONPATH=_SRC, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), str(tmp_path / "store"),
         str(tmp_path / "ckpt")], env=env, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, f"stderr:\n{out.stderr[-4000:]}"
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world")
    return tmp, _world(tmp)


def test_tp_square_matmul_equivalence(world):
    errs = world[1]["tp_matmul"]
    for mode in ("square_virtual", "square_scan", "square_pallas"):
        assert errs[mode] < 1e-3, (mode, errs)


# The worst leaf's relative gradient gap and the grad norm's, from f32
# readings on the CPU: 0 and 1e-8 data-parallel, 1.5e-7 with
# microbatches, 5.4e-7 MoE (a margin of ~20x), and 5.5e-3 with the
# attention-out and FFN-down partials reduced in bf16 (tp_bf16_reduce).
# A gradient that misses the data all-reduce is off by ~1, a cotangent
# summed again over ``model`` by the axis size less one.
GRAD_TOL = {"train": 1e-5, "train_micro": 1e-5, "moe_train": 1e-5,
            "train_tp": 2e-2}


@pytest.mark.parametrize("which", ["train", "train_tp", "train_micro"])
def test_sharded_train_step_matches_single_device(world, which):
    res = world[1][which]
    assert abs(res["loss1"] - res["loss2"]) < 1e-3, res
    assert res["param_delta"] < 5e-3, res


@pytest.mark.parametrize("which", ["train", "train_tp", "train_micro",
                                   "moe_train"])
def test_sharded_gradients_match_single_device(world, which):
    """The gradients under the mesh (the data-parallel sum, the TP
    reduce's and the MoE expert TP's hand-written transposes) equal one
    process's, leaf by leaf and in AdamW's grad norm."""
    res = world[1][which]
    assert res["grad_gap"] < GRAD_TOL[which], res
    assert res["grad_norm_gap"] < GRAD_TOL[which], res
    assert abs(res["loss1"] - res["loss2"]) < 1e-3, res


def test_microbatches_are_global_rows_sharded(world):
    """Microbatch i is the global rows [i * mb, (i + 1) * mb), each rank
    its shard of them (JAX's microbatch constraint): the last
    microbatch's xent under the mesh is the one-process step's."""
    res = world[1]["train_micro"]
    assert abs(res["xent1"] - res["xent2"]) < 1e-5, res


def test_moe_sharded_matches_local(world):
    assert world[1]["moe"]["err"] < 2e-2


def test_logical_rules_drop_indivisible(world):
    res = world[1]["rules"]
    assert "model" in res["embed"]            # vocab sharded
    assert "model" in res["ffn_up"]           # mlp sharded
    assert "model" not in res["wk"]           # kv = 1: replicated
    assert res["up_placements"]


def test_elastic_restore_on_one_process(world):
    """The 4-rank data-parallel run's checkpoint restores on one process
    and trains on."""
    import math
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.lm import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import step as step_mod
    from repro_torch.train.trainer import Trainer, TrainerConfig
    tmp, res = world
    assert res["elastic"]["step"] == 3
    cfg = get_config("deepseek-7b").reduced()
    model = build_model(cfg, device="cpu", seed=0)
    params = model.train_params()
    data = SyntheticLM(DataConfig(global_batch=8, seq_len=16,
                                  vocab=cfg.vocab), cfg, device="cpu")
    tr = Trainer(TrainerConfig(total_steps=6, ckpt_every=100,
                               ckpt_dir=str(tmp / "ckpt"), log_every=100),
                 step_mod.make_train_step(model, _opt()), params,
                 adamw.adamw_init(params), data)
    assert tr.maybe_resume()
    assert tr.step == 3
    out = tr.run()
    assert out["final_step"] == 6
    assert all(math.isfinite(float(m["loss"])) for m in out["metrics"])


if __name__ == "__main__":
    import torch.multiprocessing as mp
    mp.spawn(_rank, args=(sys.argv[1], sys.argv[2]), nprocs=WORLD)
