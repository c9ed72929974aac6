"""The roofline of a dry-run cell against the H100's datasheet peaks: the
PyTorch port of ``repro/roofline/report.py``.

Terms (seconds, per device; a data-parallel step is bulk-synchronous, so
per device is per step):

- ``compute_s``: the dot FLOPs the tensor cores would do (every
  contraction that is not a square kernel's) at the dense BF16 peak;
- ``slot_s``: the square kernels' issue slots on the CUDA cores, FP32 at
  the FP32 slot rate and INT32 at half of it (the slots, not the FLOPs,
  set a square kernel's floor);
- ``elem_s``: elementwise and reduction FLOPs at the FP32 slot rate (the
  analyzer counts one FLOP an output element, and an op that is not an
  FMA takes one issue slot an element on the CUDA cores, which the
  square kernels' slots also use);
- ``memory_s`` (``bytes_lb``) and ``memory_ub_s`` (``bytes``: what eager
  torch moves) over the HBM rate;
- ``collective_s``: the collectives' bytes, an all-reduce weighted 2x (a
  ring's traffic a device), over NVLink's rate a direction.

``bottleneck`` is the largest of compute, slots (``slot_s + elem_s``, one
pool of issue slots), memory and collective; their maximum is the step's
floor.  MODEL_FLOPS = 6 · N_active · D to train, 2 · N_active · D to
serve (D: tokens of the step on this device); ``roofline_fraction_mfu``
is the model FLOPs at the BF16 peak over the floor (JAX's definition),
and :func:`fraction_of_floor` sets a measured wall against both.

The peaks are the H100 SXM5 80GB (700 W) datasheet's, from
``core/cost_model.py``: datasheet numbers, not measurements.

    PYTHONPATH=src python -m repro_torch.roofline.report cells.json [--by-arch]
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from repro_torch.core import cost_model as cm

__all__ = ["HW", "roofline_row", "fraction_of_floor", "build_report",
           "format_table", "format_by_arch", "model_flops_per_device"]

HW = {
    "name": "H100 SXM5 80GB, 700 W (datasheet peaks, not measured)",
    "bf16_tensor_flops": cm.BF16_TENSOR_FLOPS_PER_S,
    "fp32_flops": cm.FP32_FLOPS_PER_S,
    "fp32_slots": cm.FP32_SLOTS_PER_S,
    "int32_slots": cm.INT32_SLOTS_PER_S,
    "hbm_bw": cm.HBM_BYTES_PER_S,
    "link_bw": cm.NVLINK_BYTES_PER_S,
}

_COLL_WEIGHT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}


def model_flops_per_device(cell: Dict) -> float:
    """6 (train) or 2 (serve) x active params x this device's tokens."""
    factor = 6.0 if cell["kind"] == "train" else 2.0
    return factor * cell["n_active_params"] * cell["tokens_per_device"]


def roofline_row(cell: Dict) -> Optional[Dict]:
    if cell.get("skipped") or "error" in cell:
        return None
    tensor_flops = cell["dot_flops_per_device"] - cell["kernel_flops"]
    compute_s = tensor_flops / HW["bf16_tensor_flops"]
    slot_s = (cell["fp32_slots"] / HW["fp32_slots"]
              + cell["int32_slots"] / HW["int32_slots"])
    elem_s = cell["elem_flops_per_device"] / HW["fp32_slots"]
    memory_s = cell["bytes_lb_per_device"] / HW["hbm_bw"]
    memory_ub_s = cell["bytes_per_device"] / HW["hbm_bw"]
    coll_s = sum(_COLL_WEIGHT.get(k, 1.0) * v
                 for k, v in cell["collective_bytes"].items()) \
        / HW["link_bw"]
    terms = {"compute": compute_s, "slots": slot_s + elem_s,
             "memory": memory_s, "collective": coll_s}
    bottleneck = max(terms, key=terms.get)
    floor_s = max(terms.values())
    mf = model_flops_per_device(cell)
    return {
        "arch": cell["arch"], "shape": cell["shape"], "mesh": cell["mesh"],
        "compute_s": compute_s, "slot_s": slot_s, "elem_s": elem_s,
        "memory_s": memory_s, "memory_ub_s": memory_ub_s,
        "collective_s": coll_s, "bottleneck": bottleneck,
        "floor_s": floor_s, "model_flops_per_device": mf,
        "useful_flops_ratio": (mf / cell["dot_flops_per_device"]
                               if cell["dot_flops_per_device"] else 0.0),
        "roofline_fraction_mfu": ((mf / HW["bf16_tensor_flops"]) / floor_s
                                  if floor_s > 0 else 0.0),
        "peak_bytes_per_device": cell.get("peak_bytes_per_device", 0),
    }


def fraction_of_floor(row: Dict, measured_s: float) -> Dict[str, float]:
    """A measured wall against a row: each term's share of it (the floor's
    is ``floor_share``; above 1 the count cannot be right) and the MFU the
    wall reaches at the BF16 peak."""
    out = {f"{k[:-2]}_share": row[k] / measured_s
           for k in ("compute_s", "slot_s", "elem_s", "memory_s",
                     "collective_s", "floor_s")}
    out["mfu"] = row["model_flops_per_device"] / HW["bf16_tensor_flops"] \
        / measured_s
    return out


def build_report(path: str) -> List[Dict]:
    with open(path) as f:
        cells = json.load(f)
    rows = []
    for c in cells:
        r = roofline_row(c)
        if r is not None:
            rows.append(r)
        elif c.get("skipped"):
            rows.append({"arch": c["arch"], "shape": c["shape"],
                         "skipped": True, "reason": c.get("reason", "")})
        else:
            rows.append({"arch": c["arch"], "shape": c["shape"],
                         "skipped": True, "reason": c.get("error", "")})
    return rows


def format_table(rows: List[Dict]) -> str:
    hdr = ("| arch | shape | compute_s | slot_s | elem_s | memory_s | "
           "memory_ub_s | coll_s | bound | useful | MFU | peak GB |")
    out = [hdr, "|" + "---|" * 12]
    for r in rows:
        if r.get("skipped"):
            out.append(f"| {r['arch']} | {r['shape']} | skipped: "
                       f"{r['reason'][:60]} |" + " |" * 9)
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.4g} | "
            f"{r['slot_s']:.4g} | {r['elem_s']:.4g} | {r['memory_s']:.4g} | "
            f"{r['memory_ub_s']:.4g} | {r['collective_s']:.4g} | "
            f"{r['bottleneck']} | {r['useful_flops_ratio']:.3f} | "
            f"{r['roofline_fraction_mfu']:.3f} | "
            f"{r['peak_bytes_per_device'] / 1e9:.1f} |")
    return "\n".join(out)


def format_by_arch(rows: List[Dict]) -> str:
    """One line an arch, a cell a shape: the floor in seconds, its
    bottleneck's initial and the roofline MFU (or ``skipped``)."""
    shapes = list(dict.fromkeys(r["shape"] for r in rows))
    out = ["| arch | " + " | ".join(shapes) + " |",
           "|---|" + "---|" * len(shapes)]
    cells: Dict[str, Dict[str, str]] = {}
    for r in rows:
        cells.setdefault(r["arch"], {})[r["shape"]] = (
            "skipped" if r.get("skipped") else
            f"{r['floor_s']:.4g} s {r['bottleneck'][0]}, MFU "
            f"{r['roofline_fraction_mfu']:.2%}")
    for arch, by in cells.items():
        out.append(f"| {arch} | " + " | ".join(by.get(s, "") for s in shapes)
                   + " |")
    return "\n".join(out)


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(description="the roofline table of dry-run "
                                             "JSON files")
    ap.add_argument("json", nargs="+")
    ap.add_argument("--by-arch", action="store_true",
                    help="one line an arch: each shape's floor, its "
                         "bottleneck and the roofline MFU")
    args = ap.parse_args(argv)
    for p in args.json:
        rows = build_report(p)
        print(f"\n## {p} ({HW['name']})\n")
        print(format_by_arch(rows) if args.by_arch else format_table(rows))


if __name__ == "__main__":
    main()
