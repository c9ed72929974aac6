"""Time one kernel phase of checkouts of the PyTorch port on one NVIDIA
GPU, in turns.

    python3 scripts/bench_cpm.py [PARENT_DIR] [--phase cpm|k7|k8] [--out FILE]

Runs one of ``chip_smoke.py``'s phases -- ``cpm`` (``cpm_phase``: K5 and
K6 held to their plain versions and timed at the batched-DFT shape and at
64^3 beside ``torch.matmul`` on complex64, the default), ``k7``
(``k7_phase``: K7 at the six ResNet-50 layers beside ``F.conv2d``) or
``k8`` (``k8_phase``: K8 on the three FIR streams beside ``F.conv1d``) --
of this checkout alone, or of PARENT_DIR, this checkout, this checkout
again and PARENT_DIR again, each in its own process on the same card,
with that checkout's own ``chip_smoke.py`` and kernels.  It prints the
times side by side, with each kernel's sum over its shapes (the runs as
JSON to FILE if given), and exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
KEYS = ("ms", "library_ms")


PHASES = ("cpm", "k7", "k8")


def measure(root: Path, phase: str) -> dict:
    """One checkout's phase: ``{kernel: {shape: {ms, library_ms}}}``."""
    sys.path.insert(0, str(root))
    import chip_smoke as smoke
    torch = smoke.torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_cpm: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    if phase == "k7":
        smoke.build.build(["sq_conv2d"])
        rows = {"K7": [r for r in smoke.k7_phase(dev, gen) if "ms" in r]}
        label = lambda r: r["name"]                            # noqa: E731
    elif phase == "k8":
        smoke.build.build(["sq_conv"])
        rows = {"K8": [r for r in smoke.k8_phase(dev, gen) if "ms" in r]}
        label = lambda r: f"n={r['n']}"                        # noqa: E731
    else:
        smoke.build.build(["cpm3_matmul", "cpm4_matmul"])
        z = smoke.dft_signals()
        w = smoke.transforms.dft_matrix(smoke.DFT_POINTS, device=dev)
        rows = smoke.cpm_phase(dev, gen, z, w)
        label = lambda r: "x".join(map(str, r["shape"]))       # noqa: E731
    return {name: {label(r): {k: r[k] for k in KEYS} for r in kern_rows}
            for name, kern_rows in rows.items()}


def ab(parent: Path | None, phase: str, out: str | None) -> int:
    order = ([("change", HERE)] if parent is None else
             [("parent", parent), ("change", HERE), ("change", HERE),
              ("parent", parent)])
    runs = []
    for label, root in order:
        print(f"== {label}: {root}", flush=True)
        proc = subprocess.run([sys.executable, __file__, "--root", str(root),
                               "--phase", phase],
                              capture_output=True, text=True, timeout=900)
        print(proc.stdout, proc.stderr[-2000:], flush=True)
        if proc.returncode != 0:
            return proc.returncode
        runs.append((label, json.loads(proc.stdout.strip().splitlines()[-1])))
    for name, shapes in runs[0][1].items():
        for shape in [*shapes, "sum"]:
            for key in KEYS:
                print(f"{name} {shape:15s} {key:10s} " + "  ".join(
                    f"{label} " + format(
                        sum(v[key] for v in res[name].values())
                        if shape == "sum" else res[name][shape][key], ".4f")
                    for label, res in runs), flush=True)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(runs, indent=1))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", nargs="?", type=Path)
    ap.add_argument("--phase", choices=PHASES, default="cpm")
    ap.add_argument("--out")
    ap.add_argument("--root", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.root:
        print(json.dumps(measure(args.root.resolve(), args.phase)),
              flush=True)
        return 0
    return ab(args.parent and args.parent.resolve(), args.phase, args.out)


if __name__ == "__main__":
    sys.exit(main())
