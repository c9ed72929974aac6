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
// computes partial p of the tile over all of K.  Design against the byte
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
// K2 (sq_matmul_kernel; replaces sq_matmul.py::sq_matmul_batched_kernel, the
// fb == 1 schedule of sq_matmul_batched_pallas) is the bring-up schedule of
// K1 on a batch grid axis: one 256-thread block per BM x 32 output tile, whose
// 8 warps split each 64-deep K tile (warp p = partial p), the BM rows of the
// K tile in shared memory and read as broadcasts, the partials summed in warp
// order.  blockIdx.z picks the batch element and offsets every operand by its
// batch stride, so each element runs the order above and K2's output is
// bit-identical to K1's on a[e] @ b[e].  At nb = 1 it computes K1's function,
// which lets chip_smoke.py time the two schedules side by side.
//
// K3 (replaces sq_matmul.py::sq_matmul_folded_kernel, the fb > 1 schedule)
// is for the small-(m, n), large-B regime: attention at decode has m = 1
// row per element, where a K2 block leaves 7 of its 8 tile rows idle.  Here
// one warp owns one (element, row tile of R rows, 32-column tile) unit and
// walks all of K itself; a block holds FOLD_WARPS units, so it folds
// several batch elements.  What bounds it on an H100: its inputs are
// activations a few hundred KB in all, so its byte bound is under a
// microsecond and it is bound by latency -- one warp's K walk, with a
// broadcast load of a and a coalesced 128-byte load of b per k.  The walk
// is unrolled one BK tile at a time, so a tile's loads are in flight
// together.  Every row keeps the 8 partials of the order above in
// registers, so K3 is bit-identical to K2 on the same operands: the fold
// route never changes a bit.  A ragged batch, m, n and k are masked.
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

constexpr int BN = 32;             // output columns per block (one per lane)
constexpr int KS = 8;              // partials per output: K2's warps, K1's cluster ranks
constexpr int BK = 64;             // K walked in whole 64-deep tiles
constexpr int THREADS = BN * KS;   // K2's block

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

// K2.  The second bound (at least 4 resident blocks per SM) caps registers at
// 64.  Without it ptxas squeezed the 8-row instance into 32 registers and
// spilled to local memory, which made it markedly slower on an H100.
template <typename T, int BM>
__global__ void __launch_bounds__(THREADS, 4)
sq_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 const T* __restrict__ sa, const T* __restrict__ sb,
                 T* __restrict__ out, int m, int n, int k) {
  // A tile stored k-major; the +1 keeps the transposing store conflict-free.
  __shared__ T as[BK][BM + 1];
  __shared__ T red[KS][BM][BN];

  // blockIdx.z is the batch element; the operands of one element are
  // contiguous, so its batch strides follow from m, n and k.
  const size_t z = blockIdx.z;
  a += z * m * k;
  b += z * k * n;
  sa += z * m;
  sb += z * n;
  out += z * m * n;

  const int lane = threadIdx.x % BN;
  const int ks = threadIdx.x / BN;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int col = col0 + lane;
  const bool col_ok = col < n;

  T acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) {
    const int r = row0 + i;
    acc[i] = (ks == 0 && r < m && col_ok) ? sa[r] + sb[col] : T(0);
  }

  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int i = e / BK, kk = e % BK;
      const int r = row0 + i, kc = k0 + kk;
      as[kk][i] = (r < m && kc < k) ? a[(size_t)r * k + kc] : T(0);
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < BK / KS; ++t) {
      const int kk = t * KS + ks;
      const int kc = k0 + kk;
      const T bv = (col_ok && kc < k) ? b[(size_t)kc * n + col] : T(0);
#pragma unroll
      for (int i = 0; i < BM; ++i) acc[i] = pm_accum(acc[i], as[kk][i], bv);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < BM; ++i) red[ks][i][lane] = acc[i];
  __syncthreads();
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int i = e / BN, c = e % BN;
    const int r = row0 + i, cc = col0 + c;
    if (r < m && cc < n) {
      T v = red[0][i][c];
#pragma unroll
      for (int s = 1; s < KS; ++s) v += red[s][i][c];
      out[(size_t)r * n + cc] = halve(v);
    }
  }
}

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

// K3: one warp per (element, R-row tile, 32-column tile) unit.  Lane j owns
// column j of the tile; acc[i][p] is row i's partial p (k = p mod 8).
constexpr int FOLD_WARPS = 4;

template <typename T, int R>
__global__ void __launch_bounds__(FOLD_WARPS * BN)
sq_matmul_folded_kernel(const T* __restrict__ a, const T* __restrict__ b,
                        const T* __restrict__ sa, const T* __restrict__ sb,
                        T* __restrict__ out, int nb, int m, int n, int k) {
  const int lane = threadIdx.x % BN;
  const int row_tiles = (m + R - 1) / R;
  const int col_tiles = (n + BN - 1) / BN;
  const long long unit =
      static_cast<long long>(blockIdx.x) * FOLD_WARPS + threadIdx.x / BN;
  if (unit >= static_cast<long long>(nb) * row_tiles * col_tiles) return;
  const int ct = static_cast<int>(unit % col_tiles);
  const int rt = static_cast<int>((unit / col_tiles) % row_tiles);
  const size_t e = static_cast<size_t>(unit / col_tiles / row_tiles);
  a += e * m * k;
  b += e * k * n;
  sa += e * m;
  sb += e * n;
  out += e * m * n;

  const int row0 = rt * R;
  const int col = ct * BN + lane;
  const bool col_ok = col < n;

  T acc[R][KS];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = row0 + i;
#pragma unroll
    for (int p = 0; p < KS; ++p)
      acc[i][p] = (p == 0 && r < m && col_ok) ? sa[r] + sb[col] : T(0);
  }

  // K1 walks k up to the next multiple of BK, loading zeros past k; so
  // does this loop, so a partial that is exactly -0 ends as K1's does.
  // One BK tile per iteration, fully unrolled: its BK loads of b (and R*BK
  // of a) are independent of the accumulators, so they can all be in
  // flight at once -- a warp's serial K walk is bound by load latency.
  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int q = 0; q < BK; ++q) {
      const int p = q % KS;
      const int kc = k0 + q;
      const T bv = (col_ok && kc < k) ? b[(size_t)kc * n + col] : T(0);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = row0 + i;
        const T av = (r < m && kc < k) ? a[(size_t)r * k + kc] : T(0);
        acc[i][p] = pm_accum(acc[i][p], av, bv);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = row0 + i;
    if (r < m && col_ok) {
      T v = acc[i][0];
#pragma unroll
      for (int p = 1; p < KS; ++p) v += acc[i][p];
      out[(size_t)r * n + col] = halve(v);
    }
  }
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

// K1: 8-row tiles of 64 columns (4 warps: 2 row groups of 4 rows x 2
// column tiles; 6 stages, 40 KB of b in flight per block) for m <= 8, else
// 32-row tiles of 128 columns (16 warps: 4 row groups of 8 rows x 4 column
// tiles, 4 stages), so one gathered a value serves 64 or 128 columns.
template <typename T>
int launch_k1(const void* a, const void* b, const void* sa, const void* sb, void* out,
              int m, int n, int k, cudaStream_t stream) {
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  const T* psa = static_cast<const T*>(sa);
  const T* psb = static_cast<const T*>(sb);
  T* po = static_cast<T*>(out);
  if (m <= 8) return launch_cluster<T, 8, 2, 2, 6>(pa, pb, psa, psb, po, m, n, k, stream);
  return launch_cluster<T, 32, 4, 4, 4>(pa, pb, psa, psb, po, m, n, k, stream);
}

template <typename T>
int launch(const void* a, const void* b, const void* sa, const void* sb,
           void* out, int nb, int m, int n, int k, cudaStream_t stream) {
  const dim3 block(THREADS);
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  const T* psa = static_cast<const T*>(sa);
  const T* psb = static_cast<const T*>(sb);
  T* po = static_cast<T*>(out);
  if (m <= 8) {
    const dim3 grid((m + 7) / 8, (n + BN - 1) / BN, nb);
    sq_matmul_kernel<T, 8><<<grid, block, 0, stream>>>(pa, pb, psa, psb, po, m, n, k);
  } else {
    const dim3 grid((m + 31) / 32, (n + BN - 1) / BN, nb);
    sq_matmul_kernel<T, 32><<<grid, block, 0, stream>>>(pa, pb, psa, psb, po, m, n, k);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_folded(const void* a, const void* b, const void* sa,
                  const void* sb, void* out, int nb, int m, int n, int k,
                  cudaStream_t stream) {
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  const T* psa = static_cast<const T*>(sa);
  const T* psb = static_cast<const T*>(sb);
  T* po = static_cast<T*>(out);
  const int rows = m == 1 ? 1 : 4;
  const long long units = static_cast<long long>(nb) * ((m + rows - 1) / rows)
                          * ((n + BN - 1) / BN);
  const dim3 grid(static_cast<unsigned>((units + FOLD_WARPS - 1) / FOLD_WARPS));
  const dim3 block(FOLD_WARPS * BN);
  if (rows == 1)
    sq_matmul_folded_kernel<T, 1><<<grid, block, 0, stream>>>(pa, pb, psa, psb, po, nb, m, n, k);
  else
    sq_matmul_folded_kernel<T, 4><<<grid, block, 0, stream>>>(pa, pb, psa, psb, po, nb, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = int32.  K1: a (m, k), b (k, n), out (m, n)
// row-major and contiguous; sa (m,), sb (n,); the grid is (8 * ceil(n / W),
// ceil(m / BM)) in clusters of 8 along x (launch_k1 gives BM and W).  K2
// (fs_sq_matmul_batched) and
// K3 (fs_sq_matmul_folded): the same with a leading batch axis of nb
// elements on every operand, each element contiguous.  Each returns the
// cudaError_t of its launch.
extern "C" int fs_sq_matmul(int dtype, const void* a, const void* b,
                            const void* sa, const void* sb, void* out,
                            int m, int n, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_k1<float>(a, b, sa, sb, out, m, n, k, s);
  if (dtype == 1) return launch_k1<int>(a, b, sa, sb, out, m, n, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int fs_sq_matmul_batched(int dtype, const void* a, const void* b,
                                    const void* sa, const void* sb, void* out,
                                    int nb, int m, int n, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, sa, sb, out, nb, m, n, k, s);
  if (dtype == 1) return launch<int>(a, b, sa, sb, out, nb, m, n, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int fs_sq_matmul_folded(int dtype, const void* a, const void* b,
                                   const void* sa, const void* sb, void* out,
                                   int nb, int m, int n, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_folded<float>(a, b, sa, sb, out, nb, m, n, k, s);
  if (dtype == 1) return launch_folded<int>(a, b, sa, sb, out, nb, m, n, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* fs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
