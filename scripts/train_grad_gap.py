"""How far one train step's square-routed gradients are from standard's,
at several loss scales, on one NVIDIA GPU.

    python3 scripts/train_grad_gap.py [--device cpu --reduced] [--out FILE]

Takes ``chip_smoke.py``'s training configuration (fairsquare-demo at full
width, 8 x 256 tokens, remat none, weights from seed 0, the pipeline's
first batch) in f32 (TF32 off) and in bf16, computes one step's gradients
of the loss times each of ``SCALES`` (divided by it after; a power of two
makes both exact) in ``standard`` and in each of ``MODES``, and prints,
per dtype, mode and scale, ||mode - standard|| / ||standard|| over the
gradient tensors: median, worst and the worst tensor's path.
``chip_smoke.py``'s gradient gate takes its scale (``GRAD_SCALE``) and
tolerances from these runs.  ``square_scan`` is run in f32 only.  Exits
non-zero without a CUDA device unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SCALES = (1.0, 2.0 ** 11, 2.0 ** 14, 2.0 ** 17)
MODES = ("square_pallas", "square_scan")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's smoke-test size (for the CPU)")
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
    rows = []
    for dtype in ("float32", "bfloat16"):
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
