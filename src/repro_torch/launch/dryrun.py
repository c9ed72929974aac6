"""Dry run: each (architecture x input shape) cell's step at published
width, priced on the ``meta`` device -- the PyTorch port of
``repro/launch/dryrun.py``.

The JAX dry run lowers and compiles each cell with ``ShapeDtypeStruct``
stand-ins on a 256- or 512-device production mesh and reads XLA's memory
and cost analyses.  Here the model's parameters, AdamW's state, the inputs
and the caches are ``meta`` tensors (nothing is allocated), and the step
(``make_train_step`` with JAX's 64-sequence microbatches,
``make_prefill_step`` or ``make_decode_step``) runs eagerly under the
op-level analyzer (:mod:`repro_torch.roofline.op_analysis`): every aten op
and every square-kernel launch is counted, not compiled.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b \\
        --shape train_4k [--matmul-mode square_pallas] [--out cells.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out cells.json

With no mesh a cell is one device's whole step.  A data-parallel mesh
(an :class:`~repro_torch.distributed.sharding.AbstractMesh` with a
``data`` or ``pod`` axis) runs one rank's batch shard and counts the
gradient all-reduce's bytes.  A ``model`` axis larger than 1 is refused:
the port runs what the JAX package leaves to GSPMD replicated over
``model`` (ROADMAP Q1 step 8.1), so a per-device count under it would
not be one.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import warnings
from typing import Any, Dict, Optional, Union

import torch

from repro_torch.configs import ARCHS, SHAPES, ShapeConfig, get_config
from repro_torch.core import counting
from repro_torch.core.tree import tree_leaves
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.distributed import context as dctx
from repro_torch.distributed import sharding as shd
from repro_torch.models.lm import build_model
from repro_torch.optim import adamw
from repro_torch.roofline.op_analysis import OpAnalyzer
from repro_torch.train import step as step_mod

__all__ = ["dryrun_cell", "input_specs", "MODEL_AXIS_ITEM", "LONG_REASON"]

#: the ROADMAP item a model-parallel dry run waits on
MODEL_AXIS_ITEM = ("ROADMAP Q1 step 8.1: the model-axis partitioning of "
                   "what the JAX package leaves to GSPMD (vocab, heads, "
                   "rnn, mlp) is not ported; the port runs it replicated "
                   "over 'model'")
#: JAX's reason for skipping long_500k on a full-attention arch
LONG_REASON = ("full-attention arch: long_500k needs sub-quadratic "
               "attention (see DESIGN.md)")


def input_specs(arch: str, shape_name: str) -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins for every model input of this cell."""
    return make_batch_specs(get_config(arch), SHAPES[shape_name])


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _mesh_name(mesh) -> str:
    if mesh is None:
        return "1"
    return "x".join(str(n) for n in shd.mesh_shape(mesh).values())


def dryrun_cell(arch: str, shape_name: Union[str, ShapeConfig], *,
                mesh=None, matmul_mode: Optional[str] = None,
                overrides: Optional[Dict[str, Any]] = None,
                prepared: bool = False, verbose: bool = True
                ) -> Dict[str, Any]:
    """Price one (arch x shape) cell's step on ``meta``; returns JAX's
    keys plus ``square_terms``, ``fp32_slots``, ``int32_slots``,
    ``launches`` (square kernels by name) and ``audit_mults`` (the
    contraction audit's multiplies), ``trace_seconds`` where JAX has
    ``lower_compile_seconds``.

    ``shape_name`` is a :data:`SHAPES` name or a :class:`ShapeConfig`.
    ``overrides``: config fields, ``_microbatch`` (default 64, JAX's) and
    ``_reduced`` (the arch's ``reduced()`` smoke config, then the fields).
    ``prepared``: serve a prefill or decode step from
    :meth:`~repro_torch.models.lm.LM.prepare_params` (prepared outside the
    count, as a server prepares once)."""
    cfg = get_config(arch)
    overrides = dict(overrides or {})
    microbatch = overrides.pop("_microbatch", 64)
    if overrides.pop("_reduced", False):
        cfg = cfg.reduced()
    if matmul_mode:
        cfg = dataclasses.replace(cfg, matmul_mode=matmul_mode)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) \
        else shape_name
    if not cfg.supports_shape(shape.name):
        return {"arch": arch, "shape": shape.name, "skipped": True,
                "reason": LONG_REASON}
    if mesh is not None and shd.mesh_shape(mesh).get("model", 1) > 1:
        raise NotImplementedError(f"dry run on a mesh with a model axis of "
                                  f"{shd.mesh_shape(mesh)['model']}: "
                                  f"{MODEL_AXIS_ITEM}")
    model = build_model(cfg, device="meta")
    params = model.abstract_params()
    batch = make_batch_specs(cfg, shape)
    local = shd.shard_batch(mesh, batch) if mesh is not None else batch
    B = local["tokens"].shape[0]                   # this device's rows
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if mesh is not None:
            stack.enter_context(dctx.use_mesh(mesh))
        # the planner warns once a shape it has no measured plan for
        stack.enter_context(warnings.catch_warnings())
        warnings.simplefilter("ignore")
        if shape.kind == "train":
            fn = step_mod.make_train_step(
                model, step_mod.TrainConfig(microbatch=microbatch))
            args = (params, adamw.adamw_init(params), batch)
        else:
            batch = local
            stack.enter_context(torch.no_grad())
            if prepared:
                params = model.prepare_params(params)
            if shape.kind == "prefill":
                fn = step_mod.make_prefill_step(model,
                                                cache_len=shape.seq_len)
                args = (params, batch)
            else:
                fn = step_mod.make_decode_step(model)
                pos = torch.empty((B,), dtype=torch.int32, device="meta")
                args = (params, model.init_cache(B, shape.seq_len),
                        batch["tokens"], pos)
        ctr = stack.enter_context(counting.track_contractions())
        with OpAnalyzer() as an:
            out = fn(*args)
    trace_s = time.perf_counter() - t0
    c = an.cost
    arg_b, out_b = _nbytes(args), _nbytes(out)
    result = {
        "arch": arch, "shape": shape.name, "kind": shape.kind,
        "mesh": _mesh_name(mesh),
        "n_devices": 1 if mesh is None else mesh.size,
        "matmul_mode": cfg.matmul_mode, "prepared": prepared,
        "dot_flops_per_device": c.dot_flops,
        "elem_flops_per_device": c.elem_flops,
        "bytes_per_device": c.bytes,
        "bytes_lb_per_device": c.bytes_lb,
        "collective_bytes": dict(c.collectives),
        "collective_bytes_total": c.collective_bytes,
        "square_terms": c.square_terms,
        "kernel_flops": c.kernel_flops,
        "fp32_slots": c.fp32_slots,
        "int32_slots": c.int32_slots,
        "launches": dict(c.launches),
        "audit_mults": ctr.total_mults,
        "argument_bytes_per_device": arg_b,
        "output_bytes_per_device": out_b,
        "temp_bytes_per_device": c.peak_bytes,
        "peak_bytes_per_device": arg_b + c.peak_bytes,
        "n_params": model.n_params(),
        "n_active_params": model.n_active_params(),
        "tokens_per_device": B * (shape.seq_len if shape.kind != "decode"
                                  else 1),
        "trace_seconds": trace_s,
    }
    if verbose:
        print(json.dumps(result), flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--matmul-mode", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch in ARCHS:
            if arch == "fairsquare-demo":
                continue
            for shape in SHAPES:
                cells.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells.append((args.arch, args.shape))

    results = []
    for arch, shape in cells:
        try:
            results.append(dryrun_cell(arch, shape,
                                       matmul_mode=args.matmul_mode))
        except Exception as e:  # noqa: BLE001 -- a failing cell is a bug; record it
            results.append({"arch": arch, "shape": shape, "error": repr(e)})
            print(f"FAIL {arch} x {shape}: {e!r}", file=sys.stderr,
                  flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    ok = sum(1 for r in results if "error" not in r)
    print(f"# dry-run: {ok}/{len(results)} cells ok", flush=True)
    return 0 if ok == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
