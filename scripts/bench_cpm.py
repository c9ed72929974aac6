"""Time K5 (CPM3) and K6 (CPM4) of checkouts of the PyTorch port on one
NVIDIA GPU, in turns.

    python3 scripts/bench_cpm.py [PARENT_DIR] [--out FILE]

Runs ``chip_smoke.py``'s K5/K6 phase (``cpm_phase``: each kernel held to
its plain version and timed at the batched-DFT shape and at 64^3 beside
``torch.matmul`` on complex64) of this checkout alone, or of PARENT_DIR,
this checkout, this checkout again and PARENT_DIR again, each in its own
process on the same card, with that checkout's own ``chip_smoke.py`` and
kernels.  It prints the times side by side (the runs as JSON to FILE if
given) and exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
KEYS = ("ms", "library_ms")


def measure(root: Path) -> dict:
    """One checkout's K5/K6 phase: ``{kernel: {shape: {ms, library_ms}}}``."""
    sys.path.insert(0, str(root))
    import chip_smoke as smoke
    torch = smoke.torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_cpm: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke.build.build(["cpm3_matmul", "cpm4_matmul"])
    dev = torch.device("cuda")
    z = smoke.dft_signals()
    w = smoke.transforms.dft_matrix(smoke.DFT_POINTS, device=dev)
    rows = smoke.cpm_phase(dev, torch.Generator().manual_seed(0), z, w)
    return {name: {"x".join(map(str, r["shape"])): {k: r[k] for k in KEYS}
                   for r in kern_rows} for name, kern_rows in rows.items()}


def ab(parent: Path | None, out: str | None) -> int:
    order = ([("change", HERE)] if parent is None else
             [("parent", parent), ("change", HERE), ("change", HERE),
              ("parent", parent)])
    runs = []
    for label, root in order:
        print(f"== {label}: {root}", flush=True)
        proc = subprocess.run([sys.executable, __file__, "--root", str(root)],
                              capture_output=True, text=True, timeout=900)
        print(proc.stdout, proc.stderr[-2000:], flush=True)
        if proc.returncode != 0:
            return proc.returncode
        runs.append((label, json.loads(proc.stdout.strip().splitlines()[-1])))
    for name, shapes in runs[0][1].items():
        for shape in shapes:
            for key in KEYS:
                print(f"{name} {shape:15s} {key:10s} " + "  ".join(
                    f"{label} {res[name][shape][key]:.4f}"
                    for label, res in runs), flush=True)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(runs, indent=1))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", nargs="?", type=Path)
    ap.add_argument("--out")
    ap.add_argument("--root", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.root:
        print(json.dumps(measure(args.root.resolve())), flush=True)
        return 0
    return ab(args.parent and args.parent.resolve(), args.out)


if __name__ == "__main__":
    sys.exit(main())
