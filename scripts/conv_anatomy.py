"""Where K7's and K8's time goes on one NVIDIA GPU.

    python3 scripts/conv_anatomy.py [--out FILE]

Builds variants of ``src/repro_torch/csrc/sq_conv2d.cu`` (K7) and
``sq_conv.cu`` (K8), each the source of this checkout with one named edit,
and times them beside the kernel as built at ``chip_smoke.py``'s shapes (K7:
the six ResNet-50 layers at batch 8; K8: the three 2^20-sample FIR streams),
through the kernels' own wrappers handed the variant's library, with
``chip_smoke.time_graph``.  A variant that drops work gives wrong results by
design: only its time is read.

- K7 ``no gather``: no A operand is gathered from the window inside the K
  loop; ``no filter copies``, ``no window copies``, ``no copies``: no
  filter tile, no window, neither is copied inside it; ``squares only``:
  no gather and no copies; ``no K loop``: the prologue and epilogue alone.
- K8 ``no tap pairs``: the main loop over pairs of 8-tap groups is skipped.

It also times the FP32 issue rate of the square term's instruction mix (an
add, then an FMA of the sum with itself) on an 8 x 4 register tile with its
operands in registers, read from shared memory as K7 reads them (16-byte
fragments, a barrier every 16 steps), and on an 8 x 8 tile of 64-thread
blocks, against the 33.5e12 slots/s the card's FP32 rate gives.  It prints
the card and each time, writes them as JSON to FILE if given, and exits
non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import chip_smoke as smoke  # noqa: E402
from chip_smoke import torch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

OUT = HERE / "build" / "anatomy"
CSRC = HERE / "src" / "repro_torch" / "csrc"
K7_LOOP = ("  for (int t = t0; t < t1; ++t) {\n    const int cur",
           "  for (int t = t0; t < t0; ++t) {\n    const int cur")
K7_GATHER = [("    if (more) gather_load(slot_b, (s_b - s0) & 1);\n", ""),
             ("    if (more) gather_store(cur ^ 1);\n", "")]
K7_FILTERS = [("    if (t + 1 < t1) stage_filters(slot_b, cur ^ 1);\n", "")]
K7_WINDOWS = [("    if (t + 2 < t1 && ts_c == 0) stage_window(s_c, (s_c - s0) "
               "& 1);\n", "")]
K7_COPIES = K7_FILTERS + K7_WINDOWS
VARIANTS = {
    "sq_conv2d": {"as built": [], "no gather": K7_GATHER,
                  "no filter copies": K7_FILTERS,
                  "no window copies": K7_WINDOWS,
                  "no copies": K7_COPIES,
                  "squares only": K7_GATHER + K7_COPIES,
                  "no K loop": [K7_LOOP]},
    "sq_conv": {"as built": [],
                "no tap pairs": [("    for (; u + 2 * R <= tc; u += 2 * R) {",
                                  "    for (; u + 2 * R <= tc && n < 0; "
                                  "u += 2 * R) {")]},
}
ISSUE_RATE = r"""
#include <cuda_runtime.h>
template <int TM, int TN, int THREADS, bool SMEM>
__global__ void __launch_bounds__(THREADS) mix(float* out, int iters) {
  __shared__ __align__(16) float as[16 * 16 * TM], bs[16 * 16 * TN];
  for (int e = threadIdx.x; e < 16 * 16 * TM; e += THREADS) as[e] = e * 1e-3f;
  for (int e = threadIdx.x; e < 16 * 16 * TN; e += THREADS) bs[e] = e * 2e-3f;
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wx = THREADS == 128 ? 2 : 1;      // warps across the filters
  const int ty = (warp / wx) * 4 + lane / 8, tx = (warp % wx) * 8 + lane % 8;
  float acc[TM][TN], a[TM], b[TN];
  for (int i = 0; i < TM; ++i) a[i] = threadIdx.x * 1e-3f + i;
  for (int j = 0; j < TN; ++j) b[j] = j * 0.5f;
  for (int i = 0; i < TM; ++i) for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      if (SMEM) {
#pragma unroll
        for (int q = 0; q < TM / 4; ++q) {
          const float4 v = reinterpret_cast<const float4*>(as + kk * 16 * TM + ty * TM)[q];
          a[4 * q] = v.x; a[4 * q + 1] = v.y; a[4 * q + 2] = v.z; a[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int q = 0; q < TN / 4; ++q) {
          const float4 v = reinterpret_cast<const float4*>(bs + kk * 16 * TN + tx * TN)[q];
          b[4 * q] = v.x; b[4 * q + 1] = v.y; b[4 * q + 2] = v.z; b[4 * q + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] += 1e-7f;   // TN adds a step
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float s = a[i] + b[j];
          acc[i][j] = fmaf(s, s, acc[i][j]);
        }
    }
    if (SMEM) __syncthreads();
  }
  float t = 0.f;
  for (int i = 0; i < TM; ++i) for (int j = 0; j < TN; ++j) t += acc[i][j];
  out[blockIdx.x * THREADS + threadIdx.x] = t;
}
extern "C" int fs_mix(int which, float* out, int blocks, int iters, void* s) {
  cudaStream_t st = static_cast<cudaStream_t>(s);
  if (which == 0) mix<8, 4, 128, false><<<blocks, 128, 0, st>>>(out, iters);
  if (which == 1) mix<8, 4, 128, true><<<blocks, 128, 0, st>>>(out, iters);
  if (which == 2) mix<8, 8, 64, true><<<blocks, 64, 0, st>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""
# (name, which, threads, blocks an SM, FP32 instructions a thread a step)
MIXES = [("8 x 4, registers", 0, 128, 4, 2 * 32 + 4),
         ("8 x 4, shared memory", 1, 128, 4, 2 * 32),
         ("8 x 8, shared memory, 64 threads", 2, 64, 4, 2 * 64)]


def compile_all(jobs: dict) -> None:
    """Compile {library path: source text} with the kernels' own flags,
    one nvcc each, all at once."""
    procs = {}
    for lib, text in jobs.items():
        src = lib.with_suffix(".cu")
        src.write_text(text)
        procs[lib] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(CSRC), "-o",
             str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    for lib, proc in procs.items():
        out, _ = proc.communicate(timeout=build.NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {lib.name}:\n{out}")


def variant_sources() -> dict:
    jobs = {}
    for source, variants in VARIANTS.items():
        text = (CSRC / f"{source}.cu").read_text()
        for name, edits in variants.items():
            out = text
            for old, new in edits:
                if old not in out:
                    raise RuntimeError(f"{source} {name}: edit not found")
                out = out.replace(old, new)
            jobs[OUT / f"{source}-{name.replace(' ', '_')}.so"] = out
    return jobs


def timed_with(source: str, lib, fn) -> float:
    """chip_smoke.time_graph of ``fn`` with ``source``'s wrapper launching
    ``lib``."""
    load = build.load
    build.load = lambda name: lib if name == source else load(name)
    try:
        fn()
        torch.cuda.synchronize()
        return smoke.time_graph([fn])
    finally:
        build.load = load


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("conv_anatomy: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    jobs = variant_sources()
    jobs[OUT / "issue_rate.so"] = ISSUE_RATE
    compile_all(jobs)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    result = {"card": card, "K7": {}, "K8": {}, "issue_rate": {}}
    libs = {source: {name: build.bind(
        OUT / f"{source}-{name.replace(' ', '_')}.so", source)
        for name in variants} for source, variants in VARIANTS.items()}
    for name, xs, ws, stride, padding in smoke.RESNET50_LAYERS:
        x, w = smoke.conv_operands(gen, xs, ws, dev, relu=name != "conv1")
        kern, _, _ = smoke.k7_call(x, w, stride, padding)
        row = {v: timed_with("sq_conv2d", lib, kern)
               for v, lib in libs["sq_conv2d"].items()}
        result["K7"][name] = row
        print(f"K7 {name:14s} " + " | ".join(
            f"{v} {ms:.4f} ms" for v, ms in row.items()), flush=True)
    for n in smoke.FIR_TAPS:
        x = torch.randn(smoke.FIR_LEN, generator=gen).to(dev)
        w = (torch.randn(n, generator=gen) / math.sqrt(n)).to(dev)
        sw = -(w * w).sum().reshape(1)
        row = {v: timed_with("sq_conv", lib,
                             lambda: smoke.sq_conv_k8(x, w, sw))
               for v, lib in libs["sq_conv"].items()}
        result["K8"][f"n={n}"] = row
        print(f"K8 n={n:3d} " + " | ".join(
            f"{v} {ms:.4f} ms" for v, ms in row.items()), flush=True)
    mix = ctypes.CDLL(str(OUT / "issue_rate.so"))
    mix.fs_mix.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    buf = torch.empty(sms * 4 * 128, device=dev)
    iters = 200
    for name, which, threads, per_sm, per_step in MIXES:
        blocks = sms * per_sm

        def launch():
            rc = mix.fs_mix(which, buf.data_ptr(), blocks, iters,
                            torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"issue-rate kernel {name}: CUDA error "
                                   f"{rc}")
        ms = smoke.time_graph([launch], reps=4, replays=5)
        rate = blocks * threads * iters * 16 * per_step / (ms * 1e-3)
        result["issue_rate"][name] = rate / smoke.FP32_SLOTS_PER_S
        print(f"issue rate {name:32s} {ms:.4f} ms a launch, {rate:.4g} "
              f"slots/s = {rate / smoke.FP32_SLOTS_PER_S:.1%} of "
              f"{smoke.FP32_SLOTS_PER_S:.3g}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
