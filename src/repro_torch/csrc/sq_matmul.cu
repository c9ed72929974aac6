// K1, K2, K3: the square-based GEMM on Hopper's CUDA cores (sm_90a).
//
//   C_ij = 1/2 * ( Sa_i + Sb_j + sum_k (a_ik + b_kj)^2 )
//   Sa_i = -sum_k a_ik^2,  Sb_j = -sum_k b_kj^2        (paper eq. 5)
//
// Replaces the Pallas TPU kernel src/repro/kernels/sq_matmul.py::sq_matmul_kernel
// (wrapper sq_matmul_pallas, reached from ops._sq_matmul_exec).  Every
// multiply of the contraction is one operand add and one square: the squares
// are the paper's claim, so they run as scalar FP32 / INT32 instructions on the
// CUDA cores and never as a tensor-core MMA.
//
// What bounds it on an H100: each PM term is two instructions (add, then
// fma(s, s, acc) -- or an integer multiply-add), so the operation bound is
// 2*m*n*k over the CUDA-core FP32 rate.  At the serving shapes (m = 8 decode
// rows, m = 32 prefill rows) that is below the byte bound of streaming the
// widened f32 weight b once from HBM, so decode is bandwidth-bound.
//
// The summation order, fixed for all three kernels: every output keeps KS = 8
// partial sums.  Partial p takes k = p, p + 8, p + 16, ... in increasing k,
// walking zero steps (a = b = 0) up to the next multiple of BK = 64; partial 0
// starts at Sa_i + Sb_j (the paper's register preload, as the Pallas body's
// accumulator init), the others at 0.  The 8 partials are summed 0..7 and the
// sum is halved: x0.5 on f32, an arithmetic >>1 on int32, exact because the
// total is even.  So K1, K2 and K3 agree bit for bit, and prepared and raw
// calls do too.
//
// K1 (sq_matmul_cluster_kernel): one thread-block cluster of KS = 8 blocks per
// output tile (8 rows x 64 columns for m <= 8, 32 x 128 above); block rank p
// computes partial p of the tile over all of K (the tile is the caller's
// launch plan, kernels/tuning.py; no tile changes the summation order).
// Design against the byte
// bound:
// - Lane j of a warp owns one column, so a row segment of b is coalesced.  A
//   block streams only its own rows of b (k = p mod 8) through a STAGES-deep
//   cp.async ring in shared memory, RS = 32 rows a stage: tens of KB of the
//   weight in flight per block, the whole slice at once where it fits (k = 768:
//   96 rows).  8x the blocks of a one-block-per-tile schedule: 96 blocks for
//   the 768-column GEMMs at m <= 8, 4000 for the 32000-column logits.
// - Partial p needs a[rows, k = p mod 8], one value in each 32-byte sector of
//   a row of a, so its gather moves 8x the bytes it uses.  Each stage gathers
//   the a values of its k once for all of the block's columns (64 or 128), and
//   the warps of a block split its rows and columns over the same staged b and
//   a, so no partial's chain is split.  (Sharing the a tile across the cluster
//   through distributed shared memory instead was slower at every m <= 8 shape
//   on an H100: its serial prologue cost more than the traffic it saved.)
// - After cluster.sync() each rank sums its share of the tile's outputs over
//   the 8 ranks' partials in rank order, read from distributed shared memory
//   (map_shared_rank), halves and writes: no workspace, no ticket, no second
//   launch.  The cluster launch needs sm_90 or later.
// - Ragged m, n and k are masked in the kernel: rows and columns past the edge
//   are never written, and copies past the edge fill zeros, whose square adds 0.
//   b's rows go by 16-byte copies where n % 4 == 0 and b is 16-byte aligned,
//   by 4-byte copies otherwise.
//
// K2 (sq_matmul_batched_kernel) replaces sq_matmul.py:117
// sq_matmul_batched_kernel, the fb == 1 schedule of sq_matmul_batched_pallas;
// K3 (sq_matmul_folded_kernel) replaces sq_matmul.py:179
// sq_matmul_folded_kernel, its fb > 1 schedule (both behind the pallas_call
// at sq_matmul.py:234).  On an H100 one schedule serves both, so the two
// kernels share one body (partial_warps_tile) and one launch rule and differ
// only in name: the batched route launches K2, the fold route K3, and a trace
// tells them apart.  Their serving shapes are attention's batched GEMMs: the
// paged prefill chunk's (12, 32, 64) @ (12, 64, 128) and (12, 32, 128) @
// (12, 128, 64) and the dense prefill's (12, s, 64) @ (12, 64, s) and
// (12, s, s) @ (12, s, 64) on K2; dense decode's (48, 1, 64) @ (48, 64, 128)
// and (48, 1, 128) @ (48, 128, 64), and the dense prefill of 7-12 tokens, on
// K3.  What bounds them there: latency.  The operands are activations a few
// hundred KB in all, hot in L2, so the byte bound is 0.2-0.5 us a launch and
// the operation bound less; a launch is one chain of dependent latencies
// (load, square, meet the other partials, write).  The design keeps that
// chain to one round trip to L2 and two barriers:
// - One block of KS = 8 warps per (element blockIdx.x, column tile
//   blockIdx.y, row tile blockIdx.z).  Warp p is partial p, so no partial's
//   chain is split, and lane l owns V adjacent columns of an R x 32V tile.
// - A partial's rows of b for a TILE_J = 16-step chunk (128 values of k) are
//   issued at once into registers, 8 bytes a lane where V = 2, n is even and
//   b is 8-byte aligned, 4 bytes otherwise.  At the serving shapes (k <= 128)
//   that is a warp's whole share of b, loaded before the first square.
// - The chunk's R rows of a are copied once a block by cp.async into shared
//   memory, in the order of their destination (partial, row, step) so the
//   stores hit distinct banks, and read as 16-byte broadcasts.
// - The partials meet in shared memory after one __syncthreads and are summed
//   0..7: K2 = K3 = K1 per element, bit for bit.
// - The tile (R rows of 1, 4 or 8; V = 1 or 2 columns a lane) is the
//   caller's launch plan (kernels/tuning.py).  Its model rule: R = 1 row at
//   m = 1, 4 up to 32 rows, 8 above; V = 2 where n > 32 and the grid keeps
//   96 blocks, else 1.  At the serving shapes that is 96-192 blocks of 256
//   threads: one wave, at most two blocks an SM.
// Larger k walks more chunks, each one round trip and two barriers.  Ragged
// batch, m, n and k are masked in the kernel; nothing is padded on the host.
//
// Numerics: nvcc's default -fmad=true is left on.  The accumulation is written
// as an explicit fmaf(s, s, acc), one rounding per PM term whatever that flag
// says; the operand add a + b is rounded on its own, as in the Pallas body.
// The int32 path is exact for int8/int16 operands widened to int32.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int BN = 32;             // lanes of a warp: K1 columns, K2/K3 column groups
constexpr int KS = 8;              // partials per output: K1's cluster ranks, K2/K3's warps
constexpr int BK = 64;             // K walked in whole 64-deep tiles
constexpr int THREADS = BN * KS;   // K2's and K3's block

__device__ __forceinline__ float pm_accum(float acc, float a, float b) {
  const float s = a + b;
  return fmaf(s, s, acc);
}

__device__ __forceinline__ int pm_accum(int acc, int a, int b) {
  const int s = a + b;
  return acc + s * s;
}

__device__ __forceinline__ float halve(float x) { return x * 0.5f; }
__device__ __forceinline__ int halve(int x) { return x >> 1; }  // arithmetic

// ---------------------------------------------------------------- K1
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int> { using type = int4; };
template <typename T> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<int> { using type = int2; };

constexpr int RS = 32;             // k steps (rows of b) per ring stage

// Block rank p (= blockIdx.x % KS) of the cluster at (column group
// blockIdx.x / KS, row tile blockIdx.y) computes partial p of a BM x (CT * 32)
// tile: warp w takes rows (w % RW) * BM / RW onward of column tile w / RW.
// Each stage of the ring holds RS rows of b (k = p mod 8) for the block's
// CT * 32 columns and the a values a[rows, k] of the same k, gathered once for
// all of those columns.
template <typename T, int BM, int RW, int CT, int STAGES>
__global__ void __launch_bounds__(32 * RW * CT)
sq_matmul_cluster_kernel(const T* __restrict__ a, const T* __restrict__ b,
                         const T* __restrict__ sa, const T* __restrict__ sb,
                         T* __restrict__ out, int m, int n, int k, int vec_b) {
  constexpr int NT = 32 * RW * CT;
  constexpr int RPW = BM / RW;     // rows per warp, a multiple of 4
  constexpr int W = BN * CT;       // columns per block
  static_assert(RPW % 4 == 0 && BM % KS == 0, "tile shape");
  cg::cluster_group cluster = cg::this_cluster();

  const int p = blockIdx.x % KS;
  const int col0 = blockIdx.x / KS * W;
  const int row0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int wr = warp % RW, wc = warp / RW;        // row group, column tile
  const int col = col0 + wc * BN + lane;
  const bool col_ok = col < n;
  const int steps = (k + BK - 1) / BK * (BK / KS);   // k = p + KS * j, j < steps
  const int nst = (steps + RS - 1) / RS;

  extern __shared__ __align__(16) unsigned char smem[];
  T* bst = reinterpret_cast<T*>(smem);   // [STAGES][RS][W]   rows k = p mod 8 of b
  T* ast = bst + STAGES * RS * W;        // [STAGES][RS][BM]  a[rows, k = p mod 8]
  T* red = ast + STAGES * RS * BM;       // [BM][W]           this block's partial

  auto load = [&](int s) {
    T* bd = bst + (s % STAGES) * RS * W;
    const int j0 = s * RS;
    if (vec_b) {
      for (int e = tid; e < RS * (W / 4); e += NT) {
        const int jj = e / (W / 4), c = col0 + 4 * (e % (W / 4));
        const int kc = p + KS * (j0 + jj);
        const bool ok = kc < k && c < n;           // n % 4 == 0: all 4 or none
        cp_async16(bd + jj * W + (c - col0), ok ? b + (size_t)kc * n + c : b,
                   ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < RS * W; e += NT) {
        const int jj = e / W, c = col0 + e % W;
        const int kc = p + KS * (j0 + jj);
        const bool ok = kc < k && c < n;
        cp_async4(bd + e, ok ? b + (size_t)kc * n + c : b, ok ? 4 : 0);
      }
    }
    T* ad = ast + (s % STAGES) * RS * BM;
    for (int e = tid; e < RS * BM; e += NT) {
      const int jj = e / BM, r = row0 + e % BM;
      const int kc = p + KS * (j0 + jj);
      const bool ok = kc < k && r < m;
      cp_async4(ad + e, ok ? a + (size_t)r * k + kc : a, ok ? 4 : 0);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) load(s);
    cp_async_commit();
  }

  T acc[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = row0 + wr * RPW + i;
    acc[i] = (p == 0 && r < m && col_ok) ? sa[r] + sb[col] : T(0);
  }

  for (int s = 0; s < nst; ++s) {
    cp_async_wait<STAGES - 2>();    // stage s has landed
    __syncthreads();                // ... for every thread; slot s-1 is free
    if (s + STAGES - 1 < nst) load(s + STAGES - 1);
    cp_async_commit();
    const T* bs = bst + (s % STAGES) * RS * W + wc * BN + lane;
    const T* as = ast + (s % STAGES) * RS * BM + wr * RPW;
    const int jn = min(RS, steps - s * RS);
#pragma unroll 4
    for (int jj = 0; jj < jn; ++jj) {
      const T bv = bs[jj * W];
#pragma unroll
      for (int i = 0; i < RPW; i += 4) {
        const typename Vec4<T>::type av =
            *reinterpret_cast<const typename Vec4<T>::type*>(as + jj * BM + i);
        acc[i] = pm_accum(acc[i], av.x, bv);
        acc[i + 1] = pm_accum(acc[i + 1], av.y, bv);
        acc[i + 2] = pm_accum(acc[i + 2], av.z, bv);
        acc[i + 3] = pm_accum(acc[i + 3], av.w, bv);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) red[(wr * RPW + i) * W + wc * BN + lane] = acc[i];
  cluster.sync();                   // every rank's partial is in its red
  // rank p writes rows p, p + 8, ...: the 8 partials summed in rank order
  for (int e = tid; e < BM / KS * W; e += NT) {
    const int i = p + KS * (e / W), c = e % W;
    const int r = row0 + i, cc = col0 + c;
    if (r < m && cc < n) {
      T v = *cluster.map_shared_rank(red + i * W + c, 0);
#pragma unroll
      for (int q = 1; q < KS; ++q) v += *cluster.map_shared_rank(red + i * W + c, q);
      out[(size_t)r * n + cc] = halve(v);
    }
  }
  cluster.sync();                   // no rank leaves while another reads it
}

// ------------------------------------------------------------- K2, K3
// One block of KS = 8 warps per (element blockIdx.x, column tile blockIdx.y,
// row tile blockIdx.z); warp p computes partial p of an R x (32 * V) tile and
// lane l owns columns V * l .. V * l + V - 1 of it, acc[row][column] in
// registers.
constexpr int TILE_J = 16;            // k steps of a partial per chunk (128 k)

template <typename T, int R, int V>
__device__ __forceinline__ void partial_warps_tile(const T* __restrict__ a,
                                                   const T* __restrict__ b,
                                                   const T* __restrict__ sa,
                                                   const T* __restrict__ sb,
                                                   T* __restrict__ out, int m, int n,
                                                   int k, int vec_b) {
  constexpr int CW = BN * V;                    // columns per block
  static_assert(TILE_J % 4 == 0 && (V == 1 || V == 2), "tile shape");
  __shared__ __align__(16) T as[KS][R][TILE_J];  // a[row0 + i, k0 + p + KS * j]
  __shared__ __align__(16) T red[KS][R][CW];     // partial p of the tile

  // the operands of one element are contiguous, so its batch strides follow
  // from m, n and k
  const size_t e = blockIdx.x;
  a += e * m * k;
  b += e * k * n;
  sa += e * m;
  sb += e * n;
  out += e * m * n;

  const int lane = threadIdx.x % 32, p = threadIdx.x / 32;
  const int row0 = blockIdx.z * R;
  const int c0 = blockIdx.y * CW + V * lane;    // this lane's first column
  const int kpad = (k + BK - 1) / BK * BK;       // zero steps up to it, as K1

  T acc[R][V];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = row0 + i;
#pragma unroll
    for (int v = 0; v < V; ++v)
      acc[i][v] = (p == 0 && r < m && c0 + v < n) ? sa[r] + sb[c0 + v] : T(0);
  }

  for (int k0 = 0; k0 < kpad; k0 += KS * TILE_J) {
    if (k0 > 0) __syncthreads();    // every warp is done with the last chunk's a
    // The chunk's a, copied once a block into shared memory in the order of
    // its destination (partial, row, step), so the copies' stores hit distinct
    // banks and each partial's values lie contiguous for 16-byte reads.
    for (int t = threadIdx.x; t < KS * R * TILE_J; t += THREADS) {
      const int j = t % TILE_J, i = t / TILE_J % R, q = t / (TILE_J * R);
      const int r = row0 + i, kc = k0 + q + KS * j;
      const bool ok = r < m && kc < k;
      cp_async4(&as[q][i][j], ok ? a + (size_t)r * k + kc : a, ok ? 4 : 0);
    }
    cp_async_commit();
    // b: this partial's rows of the chunk for the lane's V columns, V-wide
    // where n % V == 0 and b is aligned (then all V columns are in or none)
    T bv[TILE_J][V];
#pragma unroll
    for (int j = 0; j < TILE_J; ++j) {
      const int kc = k0 + p + KS * j;
      const T* src = b + (size_t)kc * n + c0;
      if (vec_b) {
        const bool ok = kc < k && c0 < n;
        if constexpr (V == 2) {
          typename Vec2<T>::type x{};
          if (ok) x = *reinterpret_cast<const typename Vec2<T>::type*>(src);
          bv[j][0] = x.x; bv[j][1] = x.y;
        } else {
          bv[j][0] = ok ? *src : T(0);
        }
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v)
          bv[j][v] = (kc < k && c0 + v < n) ? src[v] : T(0);
      }
    }
    cp_async_wait<0>();
    __syncthreads();                // the chunk's a is in shared memory
#pragma unroll
    for (int j4 = 0; j4 < TILE_J; j4 += 4) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const typename Vec4<T>::type av =
            *reinterpret_cast<const typename Vec4<T>::type*>(&as[p][i][j4]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = j4 + jj;
          if (k0 + p + KS * j < kpad) {         // warp-uniform
            const T x = jj == 0 ? av.x : jj == 1 ? av.y : jj == 2 ? av.z : av.w;
#pragma unroll
            for (int v = 0; v < V; ++v) acc[i][v] = pm_accum(acc[i][v], x, bv[j][v]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int v = 0; v < V; ++v) red[p][i][V * lane + v] = acc[i][v];
  __syncthreads();
  // the 8 partials summed in warp order
  for (int t = threadIdx.x; t < R * CW; t += THREADS) {
    const int i = t / CW, c = t % CW;
    const int r = row0 + i, cc = blockIdx.y * CW + c;
    if (r < m && cc < n) {
      T v = red[0][i][c];
#pragma unroll
      for (int q = 1; q < KS; ++q) v += red[q][i][c];
      out[(size_t)r * n + cc] = halve(v);
    }
  }
}

template <typename T, int R, int V>
__global__ void __launch_bounds__(THREADS)
sq_matmul_batched_kernel(const T* __restrict__ a, const T* __restrict__ b,
                         const T* __restrict__ sa, const T* __restrict__ sb,
                         T* __restrict__ out, int m, int n, int k, int vec_b) {
  partial_warps_tile<T, R, V>(a, b, sa, sb, out, m, n, k, vec_b);
}

template <typename T, int R, int V>
__global__ void __launch_bounds__(THREADS)
sq_matmul_folded_kernel(const T* __restrict__ a, const T* __restrict__ b,
                        const T* __restrict__ sa, const T* __restrict__ sb,
                        T* __restrict__ out, int m, int n, int k, int vec_b) {
  partial_warps_tile<T, R, V>(a, b, sa, sb, out, m, n, k, vec_b);
}

template <typename T, int BM, int RW, int CT, int STAGES>
int launch_cluster(const T* a, const T* b, const T* sa, const T* sb, T* out, int m,
                   int n, int k, cudaStream_t stream) {
  auto kernel = sq_matmul_cluster_kernel<T, BM, RW, CT, STAGES>;
  constexpr int smem = static_cast<int>(sizeof(T)) *
                       (STAGES * RS * (BN * CT + BM) + BM * BN * CT);
  if (smem > 48 * 1024) {
    static const cudaError_t set = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  const int vec_b = n % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(KS * ((n + BN * CT - 1) / (BN * CT)), (m + BM - 1) / BM);
  cfg.blockDim = dim3(32 * RW * CT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = KS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a, b, sa, sb, out, m, n, k, vec_b);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K1's two tiles: 8-row tiles of 64 columns (tile 0: 4 warps, 2 row groups
// of 4 rows x 2 column tiles; 6 stages, 40 KB of b in flight per block) or
// 32-row tiles of 128 columns (tile 1: 16 warps, 4 row groups of 8 rows x 4
// column tiles, 4 stages), so one gathered a value serves 64 or 128 columns.
// The model rule (kernels/tuning.py) takes tile 0 for m <= 8.
template <typename T>
int launch_k1(int tile, const void* a, const void* b, const void* sa, const void* sb,
              void* out, int m, int n, int k, cudaStream_t stream) {
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  const T* psa = static_cast<const T*>(sa);
  const T* psb = static_cast<const T*>(sb);
  T* po = static_cast<T*>(out);
  if (tile == 0) return launch_cluster<T, 8, 2, 2, 6>(pa, pb, psa, psb, po, m, n, k, stream);
  if (tile == 1) return launch_cluster<T, 32, 4, 4, 4>(pa, pb, psa, psb, po, m, n, k, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int R, int V, bool FOLDED>
int launch_tile(const T* a, const T* b, const T* sa, const T* sb, T* out, int nb, int m,
                int n, int k, cudaStream_t stream) {
  const int vec_b = n % V == 0 && reinterpret_cast<uintptr_t>(b) % (V * sizeof(T)) == 0;
  const dim3 grid(nb, (n + BN * V - 1) / (BN * V), (m + R - 1) / R);
  if constexpr (FOLDED)
    sq_matmul_folded_kernel<T, R, V><<<grid, THREADS, 0, stream>>>(a, b, sa, sb, out, m,
                                                                    n, k, vec_b);
  else
    sq_matmul_batched_kernel<T, R, V><<<grid, THREADS, 0, stream>>>(a, b, sa, sb, out, m,
                                                                     n, k, vec_b);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int R, bool FOLDED>
int launch_rows(int v, const T* a, const T* b, const T* sa, const T* sb, T* out, int nb,
                int m, int n, int k, cudaStream_t stream) {
  if (v == 2) return launch_tile<T, R, 2, FOLDED>(a, b, sa, sb, out, nb, m, n, k, stream);
  return launch_tile<T, R, 1, FOLDED>(a, b, sa, sb, out, nb, m, n, k, stream);
}

template <typename T, bool FOLDED>
int launch_batched(int rows, int vec, const void* a, const void* b, const void* sa,
                   const void* sb, void* out, int nb, int m, int n, int k,
                   cudaStream_t stream) {
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  const T* psa = static_cast<const T*>(sa);
  const T* psb = static_cast<const T*>(sb);
  T* po = static_cast<T*>(out);
  if (vec != 1 && vec != 2) return static_cast<int>(cudaErrorInvalidValue);
  switch (rows) {
    case 1: return launch_rows<T, 1, FOLDED>(vec, pa, pb, psa, psb, po, nb, m, n, k, stream);
    case 4: return launch_rows<T, 4, FOLDED>(vec, pa, pb, psa, psb, po, nb, m, n, k, stream);
    case 8: return launch_rows<T, 8, FOLDED>(vec, pa, pb, psa, psb, po, nb, m, n, k, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = int32.  K1: a (m, k), b (k, n), out (m, n)
// row-major and contiguous; sa (m,), sb (n,); tile 0 (8 x 64) or 1 (32 x
// 128), the caller's plan; the grid is (8 * ceil(n / W), ceil(m / BM)) in
// clusters of 8 along x.  K2 (fs_sq_matmul_batched) and K3
// (fs_sq_matmul_folded): the same with a leading batch axis of nb elements
// on every operand, each element contiguous; rows (1, 4 or 8) and vec (1 or
// 2 columns a lane) are the caller's plan, and the grid is (nb, ceil(n /
// 32 vec), ceil(m / rows)) of 256-thread blocks.  Each returns the
// cudaError_t of its launch (cudaErrorInvalidValue for a plan it lacks).
extern "C" int fs_sq_matmul(int dtype, const void* a, const void* b,
                            const void* sa, const void* sb, void* out,
                            int m, int n, int k, int tile, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_k1<float>(tile, a, b, sa, sb, out, m, n, k, s);
  if (dtype == 1) return launch_k1<int>(tile, a, b, sa, sb, out, m, n, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int fs_sq_matmul_batched(int dtype, const void* a, const void* b,
                                    const void* sa, const void* sb, void* out,
                                    int nb, int m, int n, int k, int rows, int vec,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_batched<float, false>(rows, vec, a, b, sa, sb, out, nb, m, n, k, s);
  if (dtype == 1)
    return launch_batched<int, false>(rows, vec, a, b, sa, sb, out, nb, m, n, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int fs_sq_matmul_folded(int dtype, const void* a, const void* b,
                                   const void* sa, const void* sb, void* out,
                                   int nb, int m, int n, int k, int rows, int vec,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_batched<float, true>(rows, vec, a, b, sa, sb, out, nb, m, n, k, s);
  if (dtype == 1)
    return launch_batched<int, true>(rows, vec, a, b, sa, sb, out, nb, m, n, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* fs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
