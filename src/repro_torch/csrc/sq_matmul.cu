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
// Design against that bound:
// - One block owns a BM x 32 output tile; lane j of every warp owns column j,
//   so a warp's read of b[k, j0:j0+32] is one coalesced 128-byte line, and the
//   weight is read exactly once per row tile.
// - The BM activation rows of the current K tile sit in shared memory; every
//   lane of a warp reads the same a value (a broadcast), so a k step costs one
//   global load of b and BM shared-memory broadcasts for 2*BM instructions.
// - The 8 warps of a block split each K tile between them, which keeps 8 loads
//   of b in flight per column tile.  Warp 0's accumulators start at
//   Sa_i + Sb_j (the paper's register preload, as the Pallas body's accumulator
//   init); the other warps' start at 0.  The epilogue adds the 8 partials in
//   warp order, so results do not depend on scheduling (prepared and raw calls
//   are bit-identical), and halves the sum: x0.5 on f32, an arithmetic >>1 on
//   int32, exact because the total is even.
// - Ragged m, n and k are masked in the kernel: rows and columns past the edge
//   are never written, and k past the edge loads a = b = 0, whose square adds 0.
//
// K2 (replaces sq_matmul.py::sq_matmul_batched_kernel, the fb == 1
// schedule of sq_matmul_batched_pallas) is the same kernel on a batch grid
// axis: blockIdx.z picks the batch element and offsets every operand by its
// batch stride, so each element runs K1's exact arithmetic and K2's output
// is bit-identical to K1's on a[e] @ b[e].  The offsets are a template flag
// (BATCHED): compiled into K1 too, they cost it 2-12 % (chip_smoke.py's K1
// phase with and without them in one run, NVIDIA H100 80GB HBM3 at 700 W).
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
// together.  Every row keeps 8 partial accumulators: partial p takes
// k = p (mod 8) in increasing k, partial 0 is seeded with Sa + Sb, and the
// 8 are summed 0..7 and halved.  That is K1's order (warp p of a K1 block
// is partial p here), including the zero steps K1 takes up to the next
// multiple of BK, so K3 is bit-identical to K2 on the same operands: the
// fold route never changes a bit.  A ragged batch, m, n and k are masked.
//
// Numerics: nvcc's default -fmad=true is left on.  The accumulation is written
// as an explicit fmaf(s, s, acc), one rounding per PM term whatever that flag
// says; the operand add a + b is rounded on its own, as in the Pallas body.
// The int32 path is exact for int8/int16 operands widened to int32.

#include <cuda_runtime.h>

namespace {

constexpr int BN = 32;             // output columns per block (one per lane)
constexpr int KS = 8;              // warps per block, each a slice of every K tile
constexpr int BK = 64;             // K-tile staged in shared memory
constexpr int THREADS = BN * KS;

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

// The second bound (at least 4 resident blocks per SM) caps registers at 64.
// Without it ptxas squeezed the 8-row instance into 32 registers and spilled
// to local memory, which made it markedly slower on an H100.
template <typename T, int BM, bool BATCHED>
__global__ void __launch_bounds__(THREADS, 4)
sq_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 const T* __restrict__ sa, const T* __restrict__ sb,
                 T* __restrict__ out, int m, int n, int k) {
  // A tile stored k-major; the +1 keeps the transposing store conflict-free.
  __shared__ T as[BK][BM + 1];
  __shared__ T red[KS][BM][BN];

  if constexpr (BATCHED) {
    // K2: blockIdx.z is the batch element; the operands of one element are
    // contiguous, so its batch strides follow from m, n and k.
    const size_t z = blockIdx.z;
    a += z * m * k;
    b += z * k * n;
    sa += z * m;
    sb += z * n;
    out += z * m * n;
  }

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

template <typename T, bool BATCHED>
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
    sq_matmul_kernel<T, 8, BATCHED><<<grid, block, 0, stream>>>(pa, pb, psa, psb, po, m, n, k);
  } else {
    const dim3 grid((m + 31) / 32, (n + BN - 1) / BN, nb);
    sq_matmul_kernel<T, 32, BATCHED><<<grid, block, 0, stream>>>(pa, pb, psa, psb, po, m, n, k);
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
// row-major and contiguous; sa (m,), sb (n,).  K2 (fs_sq_matmul_batched) and
// K3 (fs_sq_matmul_folded): the same with a leading batch axis of nb
// elements on every operand, each element contiguous.  Each returns the
// cudaError_t of its launch.
extern "C" int fs_sq_matmul(int dtype, const void* a, const void* b,
                            const void* sa, const void* sb, void* out,
                            int m, int n, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, false>(a, b, sa, sb, out, 1, m, n, k, s);
  if (dtype == 1) return launch<int, false>(a, b, sa, sb, out, 1, m, n, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int fs_sq_matmul_batched(int dtype, const void* a, const void* b,
                                    const void* sa, const void* sb, void* out,
                                    int nb, int m, int n, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, true>(a, b, sa, sb, out, nb, m, n, k, s);
  if (dtype == 1) return launch<int, true>(a, b, sa, sb, out, nb, m, n, k, s);
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
