// The register-tiled schedule shared by K5 (cpm3_matmul.cu, three squares a
// complex term) and K6 (cpm4_matmul.cu, four squares): a complex square GEMM
// of X = A + jB (m, k) by Y = C + jS (k, n), given as four f32 planes, on
// Hopper's CUDA cores (sm_90a).  Each source supplies an Op -- the planes it
// stages, its accumulator planes (re and im first), its term and its thread
// tile -- and its C entry point.  The squares are scalar FP32 instructions:
// no tensor-core MMA, no library kernel.
//
// What bounds it on an H100: an FP32 add takes an issue slot as an fma
// does, so a term costs K5 6 slots and K6 8, and the batched DFT (4096 x
// 1024 x 1024) is bound by FP32 issue, ~100x above its byte bound.  The
// schedule spends as few slots as it can outside the terms:
// - Register tile.  One block of 16 x 16 threads owns a 16 TM x 16 TN output
//   tile; each thread holds a TM x TN register tile of every accumulator
//   plane for the whole k walk (no split of k, no reduction buffer).  The
//   accumulators start at the row corrections, as the Pallas init does.
//   K5 takes 8 x 4 (96 accumulators, one block an SM), K6 4 x 4 (two blocks
//   an SM): each measured faster than the other tile on its own kernel.
// - Staged operands read as broadcasts.  Each BK-deep K tile of the row
//   planes (m, k) and column planes (k, n) is staged k-major in shared
//   memory, with the hoisted planes (Op::rows, Op::cols) formed once per
//   staged element on the way in.  A warp is 4 row groups x 8 column
//   groups, so each of its 16-byte reads of a plane touches at most 128
//   distinct bytes: one shared-memory wavefront.  A K5 thread reads 9
//   float4s for its 32 terms of a k step; a K6 thread 4 for 16.
// - Overlapped copies.  Two stages: the next K tile's global loads are
//   issued into registers before the current tile's squares and stored
//   (hoisted) into the other stage after them, so one __syncthreads a K
//   tile suffices.  A thread stages a run of k of one row (a 16- or 32-byte
//   sector) and a run of columns of one k; a warp's transposed stores hit
//   32 consecutive rows of one k, so no padding is needed against bank
//   conflicts.
// - Tile plan (launch, below; chosen by kernels/tuning.py, whose model
//   rule is kernels/cpm3_matmul.py::cpm_launch_shape): a 1 x 1 thread tile
//   with a 64-deep K tile where the kernel's own would leave fewer than 128
//   blocks, so small products still spread over the SMs and a short walk is
//   one round trip.
// - Edges are masked in the kernel: rows and columns past the edge are
//   never stored, and k past the edge stages zeros in all four planes,
//   whose terms add exactly 0.  16-byte copies need k and n multiples of 4
//   and 16-byte-aligned planes; otherwise the same kernel is compiled with
//   scalar copies (VEC = false).  Nothing falls back to another kernel.
// - Epilogue: both planes are halved and 1/2 of the column corrections
//   added after the halving, as the JAX wrappers add them after their
//   pallas_call; one 16-byte store a row where VEC allows.
// Deterministic: no atomics, each output summed in one fixed order.

#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace cpm {

constexpr int THREADS = 256;          // 16 x 16 threads
constexpr int STAGES = 2;
constexpr int MAX_DEVICES = 64;       // devices whose smem attribute is cached

struct Args {
  const float *a, *b, *c, *s;  // (m, k), (m, k), (k, n), (k, n), contiguous
  const float *row_re, *row_im;  // (m,): the accumulator init of each plane
  const float *col_re, *col_im;  // (n,): added halved after the halving
  float *re, *im;                // (m, n)
  int m, n, k;
};

template <int N>
__device__ __forceinline__ void load_frag(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = x.x; v[4 * q + 1] = x.y; v[4 * q + 2] = x.z; v[4 * q + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) v[q] = p[q];
  }
}

template <int N>
__device__ __forceinline__ void store_run(float* p, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) p[q] = v[q];
  }
}

// N consecutive floats of p from index i0 of a run of length len (zeros
// past it, or everywhere if !ok); 16-byte loads when VEC and N % 4 == 0
// (then len % 4 == 0 and i0 % 4 == 0, so a float4 is all in or all out).
template <int N, bool VEC>
__device__ __forceinline__ void load_run(const float* __restrict__ p, int i0,
                                         int len, bool ok, float (&v)[N]) {
  if constexpr (VEC && N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const int i = i0 + 4 * q;
      const float4 x = ok && i < len
          ? __ldg(reinterpret_cast<const float4*>(p + i))
          : make_float4(0.f, 0.f, 0.f, 0.f);
      v[4 * q] = x.x; v[4 * q + 1] = x.y; v[4 * q + 2] = x.z; v[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q)
      v[q] = ok && i0 + q < len ? __ldg(p + i0 + q) : 0.f;
  }
}

template <class Op, int TM, int TN, int BK, bool VEC>
__global__ void __launch_bounds__(THREADS, Op::MIN_BLOCKS)
tile_kernel(const Args p) {
  constexpr int BM = 16 * TM, BN = 16 * TN;
  constexpr int RE = BM * BK / THREADS;   // staged k of one row, a thread
  constexpr int CE = BN * BK / THREADS;   // staged columns of one k, a thread
  constexpr int RPLANE = BK * BM, CPLANE = BK * BN;
  constexpr int RP = Op::ROW_PLANES, CP = Op::COL_PLANES, AP = Op::ACC_PLANES;
  constexpr int STAGE = RP * RPLANE + CP * CPLANE;
  static_assert(RE >= 1 && CE >= 1 && BM * BK % THREADS == 0 &&
                BN * BK % THREADS == 0, "tile too small for the block");
  extern __shared__ __align__(16) float smem[];

  const int m = p.m, n = p.n, k = p.k;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ty = (warp / 2) * 4 + lane / 8;   // row group: rows ty*TM + i
  const int tx = (warp % 2) * 8 + lane % 8;   // column group: tx*TN + j
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;

  // This thread's share of a staged tile: RE k of row sr from k sk, and CE
  // columns of k row ck from column sc.
  const int sr = tid % BM, sk = (tid / BM) * RE;
  const int ck = tid / (BN / CE), sc = (tid % (BN / CE)) * CE;
  const bool srow_ok = row0 + sr < m, scol_ok = col0 + sc < n;
  const size_t srow = static_cast<size_t>(srow_ok ? row0 + sr : 0) * k;
  float ra[RE], rb[RE], cc[CE], cs[CE];

  auto load = [&](int k0) {
    load_run<RE, VEC>(p.a + srow, k0 + sk, k, srow_ok, ra);
    load_run<RE, VEC>(p.b + srow, k0 + sk, k, srow_ok, rb);
    const bool kok = k0 + ck < k;
    const size_t crow = static_cast<size_t>(kok ? k0 + ck : 0) * n;
    load_run<CE, VEC>(p.c + crow, col0 + sc, n, kok && scol_ok, cc);
    load_run<CE, VEC>(p.s + crow, col0 + sc, n, kok && scol_ok, cs);
  };
  auto store = [&](float* st) {
#pragma unroll
    for (int e = 0; e < RE; ++e) {
      float v[RP];
      Op::rows(ra[e], rb[e], v);
#pragma unroll
      for (int q = 0; q < RP; ++q) st[q * RPLANE + (sk + e) * BM + sr] = v[q];
    }
    float w[CP][CE];
#pragma unroll
    for (int e = 0; e < CE; ++e) {
      float v[CP];
      Op::cols(cc[e], cs[e], v);
#pragma unroll
      for (int q = 0; q < CP; ++q) w[q][e] = v[q];
    }
#pragma unroll
    for (int q = 0; q < CP; ++q)
      store_run<CE>(st + RP * RPLANE + q * CPLANE + ck * BN + sc, w[q]);
  };

  // One load of each row correction a row: loaded once an output instead,
  // ptxas gave K5 192 registers, not 186, and it ran 12 % slower.
  float acc[AP][TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    const float vre = r < m ? p.row_re[r] : 0.f;
    const float vim = r < m ? p.row_im[r] : 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) Op::init(acc, i, j, vre, vim);
  }

  const int tiles = (k + BK - 1) / BK;
  load(0);
  store(smem);
  __syncthreads();
  for (int t = 0; t < tiles; ++t) {
    const float* st = smem + (t % STAGES) * STAGE;
    const bool more = t + 1 < tiles;
    if (more) load((t + 1) * BK);
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float rf[RP][TM], cf[CP][TN];
#pragma unroll
      for (int q = 0; q < RP; ++q)
        load_frag<TM>(st + q * RPLANE + kk * BM + ty * TM, rf[q]);
#pragma unroll
      for (int q = 0; q < CP; ++q)
        load_frag<TN>(st + RP * RPLANE + q * CPLANE + kk * BN + tx * TN, cf[q]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) Op::term(acc, i, j, rf, cf);
    }
    Op::end_tile(acc);
    if (more) store(smem + ((t + 1) % STAGES) * STAGE);
    __syncthreads();
  }

  // Epilogue: halve, then add the halved column corrections.
  const int c0 = col0 + tx * TN;
  float hre[TN], him[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    hre[j] = c0 + j < n ? 0.5f * p.col_re[c0 + j] : 0.f;
    him[j] = c0 + j < n ? 0.5f * p.col_im[c0 + j] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    if (r >= m) continue;
    float vre[TN], vim[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      vre[j] = Op::re(acc, i, j) * 0.5f + hre[j];
      vim[j] = Op::im(acc, i, j) * 0.5f + him[j];
    }
    float* ore = p.re + static_cast<size_t>(r) * n + c0;
    float* oim = p.im + static_cast<size_t>(r) * n + c0;
    if (VEC && TN % 4 == 0 && c0 < n) {   // n % 4 == 0: all TN in or out
      store_run<TN>(ore, vre);
      store_run<TN>(oim, vim);
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (c0 + j < n) { ore[j] = vre[j]; oim[j] = vim[j]; }
    }
  }
}

template <class Op, int TM, int TN, int BK, bool VEC>
int launch_tile(const Args& p, cudaStream_t stream, int* shape) {
  auto kernel = tile_kernel<Op, TM, TN, BK, VEC>;
  constexpr int BM = 16 * TM, BN = 16 * TN;
  constexpr int smem = static_cast<int>(sizeof(float)) * STAGES * BK *
                       (Op::ROW_PLANES * BM + Op::COL_PLANES * BN);
  if (smem > 48 * 1024) {
    // The attribute is per device: set at a device's first launch (and
    // again after a failure), so later launches, captured ones too, make
    // no such call.
    static std::atomic<bool> set_on[MAX_DEVICES];
    int dev = 0;
    const cudaError_t got = cudaGetDevice(&dev);
    if (got != cudaSuccess) return static_cast<int>(got);
    if (dev >= MAX_DEVICES || !set_on[dev].load()) {
      const cudaError_t set = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (set != cudaSuccess) return static_cast<int>(set);
      if (dev < MAX_DEVICES) set_on[dev].store(true);
    }
  }
  const dim3 grid((p.m + BM - 1) / BM, (p.n + BN - 1) / BN);
  shape[0] = static_cast<int>(grid.x);
  shape[1] = static_cast<int>(grid.y);
  shape[2] = TM;
  shape[3] = TN;
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <class Op, int TM, int TN, int BK>
int launch_vec(const Args& p, cudaStream_t stream, int* shape) {
  const bool vec = p.k % 4 == 0 && p.n % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(p.a) |
                     reinterpret_cast<uintptr_t>(p.b) |
                     reinterpret_cast<uintptr_t>(p.c) |
                     reinterpret_cast<uintptr_t>(p.s) |
                     reinterpret_cast<uintptr_t>(p.re) |
                     reinterpret_cast<uintptr_t>(p.im)) % 16) == 0;
  return vec ? launch_tile<Op, TM, TN, BK, true>(p, stream, shape)
             : launch_tile<Op, TM, TN, BK, false>(p, stream, shape);
}

// The two thread tiles: the kernel's own (tile 0: Op::TILE_M x Op::TILE_N,
// 16-deep K tiles) or 1 x 1 with a 64-deep K tile (tile 1), so that a short
// k walk is one round trip.  Which one a launch takes is the caller's plan
// (kernels/tuning.py); its model rule takes the own tile where that grid
// has 128 blocks.  shape receives (grid x, grid y, TM, TN) of the launch.
template <class Op>
int launch(const Args& p, int tile, cudaStream_t stream, int* shape) {
  if (tile == 0) return launch_vec<Op, Op::TILE_M, Op::TILE_N, 16>(p, stream, shape);
  if (tile == 1) return launch_vec<Op, 1, 1, 64>(p, stream, shape);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace cpm
