"""How far one train step's square-routed gradients are from standard's,
at several loss scales, on one NVIDIA GPU.

    python3 scripts/train_grad_gap.py [--device cpu --reduced] [--out FILE]
    python3 scripts/train_grad_gap.py --arch moonshot-v1-16b-a3b [--out FILE]

Takes ``chip_smoke.py``'s training configuration (fairsquare-demo at full
width, 8 x 256 tokens, remat none, weights from seed 0, the pipeline's
first batch) in f32 (TF32 off) and in bf16, computes one step's gradients
of the loss times each of ``SCALES`` (divided by it after; a power of two
makes both exact) in ``standard`` and in each of ``MODES``, and prints,
per dtype, mode and scale, ||mode - standard|| / ||standard|| over the
gradient tensors: median, worst and the worst tensor's path.
``chip_smoke.py``'s gradient gate takes its scale (``GRAD_SCALE``) and
tolerances from these runs.  ``square_scan`` is run in f32 only.

With ``--arch moonshot-v1-16b-a3b`` it takes the MoE training phase's f32
configuration instead (moonshot at its published width,
``MOE_TRAIN_F32_LAYERS`` layers, remat none) at ``MOE_SCALES``, in f32:
each mode's gradients against standard's run on that mode's routing (a
swapped expert moves the cotangents of every layer below by more than
rounding), and against standard's own routing over the non-expert
tensors; with every site square, and with the loss's vocab GEMM (k =
vocab in its dL/dx) on standard in both runs.  Exits non-zero without a CUDA device unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import itertools
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SCALES = (1.0, 2.0 ** 11, 2.0 ** 14, 2.0 ** 17)
MOE_SCALES = (2.0 ** 11, 2.0 ** 14, 2.0 ** 17)
MODES = ("square_pallas", "square_scan")


def moe_rows(smoke, dev, reduced: bool) -> list:
    """The MoE rows (see the module docstring), with every site square and
    with the loss's vocab GEMM on standard in both runs."""
    from repro_torch.configs.base import ContractionPolicy
    loss_standard = ContractionPolicy.of(loss="standard")
    torch = smoke.torch
    L = smoke.MOE_TRAIN_F32_LAYERS

    def cfg(mode, policy=None):
        c = smoke.moe_train_cfg(L, mode, dtype="float32", remat="none",
                                contraction_policy=policy)
        return c.reduced() if reduced else c

    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    model = smoke.build_model(cfg("standard"), device=dev, seed=0)
    params = model.tree()
    batch = SyntheticLM(DataConfig(smoke.TRAIN_B, smoke.TRAIN_S,
                                   model.cfg.vocab), model.cfg,
                        device=dev).next_batch()
    rows = []
    for scale, (pol, what) in itertools.product(MOE_SCALES, (
            (None, "every site square"),
            (loss_standard, "the loss on standard"))):
        std, _ = smoke.moe_grads(model, params, batch,
                                 cfg("standard", pol), scale)
        for mode in MODES:
            got, routes = smoke.moe_grads(model, params, batch,
                                          cfg(mode, pol), scale)
            pinned, _ = smoke.moe_grads(model, params, batch,
                                        cfg("standard", pol), scale,
                                        pin=routes)
            rel = smoke._rel_slices(got, pinned)
            own = {k: v for k, v in smoke._rel_slices(got, std).items()
                   if "[" not in k}
            worst = max(rel, key=rel.get)
            row = {"dtype": "float32", "mode": mode, "scale": scale,
                   "sites": what,
                   "median": sorted(rel.values())[len(rel) // 2],
                   "worst": rel[worst], "worst_tensor": worst,
                   "tensors": len(rel),
                   "own_routing_nonexpert_worst": max(own.values())}
            rows.append(row)
            print(f"moe f32 {what}: {mode:13s} loss x {scale:<8g} on its "
                  f"routing: "
                  f"median {row['median']:.4e} worst {row['worst']:.4e} "
                  f"({worst}); on standard's own, non-expert worst "
                  f"{row['own_routing_nonexpert_worst']:.4e}", flush=True)
            del got, pinned
            torch.cuda.empty_cache() if dev.type == "cuda" else None
        del std
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's smoke-test size (for the CPU)")
    ap.add_argument("--arch", default="fairsquare-demo",
                    choices=("fairsquare-demo", "moonshot-v1-16b-a3b"))
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import chip_smoke as smoke
    torch = smoke.torch
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("train_grad_gap: no CUDA device")
        smoke.build.build(["sq_matmul"])
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    rows = moe_rows(smoke, dev, args.reduced) \
        if args.arch != "fairsquare-demo" else []
    for dtype in (("float32", "bfloat16") if not rows else ()):
        modes = [m for m in MODES
                 if dtype == "float32" or m != "square_scan"]
        for scale in SCALES:
            def cfg(mode):
                c = smoke.train_cfg(mode, dtype=dtype, remat="none")
                return c.reduced() if args.reduced else c
            std = smoke._grads(cfg("standard"), dev, scale)
            for mode in modes:
                med, worst, name = smoke._norm_rel(
                    smoke._grads(cfg(mode), dev, scale), std)
                row = {"dtype": dtype, "mode": mode, "scale": scale,
                       "median": med, "worst": worst, "worst_tensor": name,
                       "tensors": len(std)}
                rows.append(row)
                print(f"{dtype:8s} {mode:13s} loss x {scale:<8g} "
                      f"||diff|| / ||standard|| median {med:.4e} worst "
                      f"{worst:.4e} ({name})", flush=True)
            del std
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    if args.device == "cuda":
        print(smoke.subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
