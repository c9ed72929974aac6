// K7: the fused 2D square convolution (implicit GEMM) on Hopper's CUDA
// cores (sm_90a).
//
//   out[b, f, oy, ox] = 1/2 * ( Sw_f + sum_{i,j,c} (x_pad + w)^2 + Sx )
//   Sw_f = -sum_{i,j,c} w[f, c, i, j]^2            (paper eq 14, precomputed)
//   Sx   = -sum_{i,j,c} x[b, c, oy*sh - ph + i, ox*sv - pw + j]^2
//
// Replaces the Pallas TPU kernel src/repro/kernels/sq_conv2d.py::
// sq_conv2d_kernel (wrapper sq_conv2d_pallas, reached from
// ops._sq_conv2d_fused_exec).  Every multiply of the convolution is one
// operand add and one square, on the CUDA cores: never a tensor-core MMA.
//
// The GEMM view: M = B*oh*ow output pixels, N = cout filters, K = kh*kw*cin
// taps, K ordered (i, j, c) as the Pallas kernel's (kh, kw, Cp, Np) tap
// block.  The filters come as that (K, N) matrix, row-major, and Sw as (N,).
// The input is read in place, NCHW and unpadded: no im2col patch tensor and
// no padded copy exist.
//
// What bounds it on an H100: each square term is two instructions (add,
// then fma(s, s, acc), or an integer multiply-add), so at CNN-layer sizes
// (K of hundreds to thousands, every input element reused by kh*kw*cout
// terms) it is bound by operations, not bytes.
//
// Design against that bound:
// - One block owns a 128-pixel x 64-filter output tile; each of its 256
//   threads holds 8 pixels x 4 filters of accumulators in registers, so a
//   k step costs 3 vector shared-memory loads for 64 instructions.
// - The K walk is a loop inside the block (the Pallas kernel's sequential
//   "arbitrary" channel axis).  Each 16-deep K chunk of the input window and
//   of the tap block is staged in shared memory, double-buffered: the next
//   chunk's global loads are issued before the current chunk is computed.
// - The deep layers have fewer output tiles than the card has SMs
//   (ResNet-50's conv5_x: 32 tiles for 132 SMs), so there the wrapper splits
//   the K walk over gridDim.z blocks of one tile.  Each writes its partial sum to a workspace; the last of them to
//   finish (a ticket counter) adds the partials in split order 0, 1, ...,
//   so the result does not depend on which block finished last.  With one
//   split the epilogue writes straight to the output.
// - Zero padding and ragged edges are masked at the load: a tap that falls
//   in the padding loads x = 0 and still adds (0 + w)^2 = w^2, which cancels
//   the -w^2 that Sw carries for it (sq_conv2d.py:37-41), so no term is
//   skipped.  K past the end of a split loads x = w = 0 (adds 0); pixels
//   and filters past the end are computed on zeros and never written.
// - The -x^2 correction is shared by every filter of the block: each thread
//   squares the input elements it stages (one pixel, a fixed slice of every
//   chunk), and the two partials of a pixel are added in a fixed order in
//   the epilogue: O(M*K) work, not O(M*K*N).
// - The accumulators of split 0 start at Sw_f (the paper's register
//   preload); each split subtracts its own share of Sx; the final sum is
//   halved: x0.5 on f32, an arithmetic >>1 on int32, exact because the total
//   is even.  The only atomic is the ticket, which orders nothing that is
//   summed: results do not depend on scheduling, so prepared and raw calls
//   are bit-identical.
//
// Numerics: the accumulation is an explicit fmaf(s, s, acc), one rounding
// per term; the operand add a + b is rounded on its own, as in the Pallas
// body.  The int32 path is exact for int8/int16 operands widened to int32.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;            // output pixels per block
constexpr int BN = 64;             // filters per block
constexpr int BK = 16;             // K depth of one staged chunk
constexpr int THREADS = 256;
constexpr int TM = 8;              // pixels per thread: 2 groups of 4
constexpr int TN = 4;              // filters per thread
constexpr int A_ROWS = THREADS / BM;          // 2: K rows one A pass stages
constexpr int A_LOADS = BK / A_ROWS;          // 8 input elements per thread
constexpr int B_ROWS = THREADS / BN;          // 4
constexpr int B_LOADS = BK / B_ROWS;          // 4 filter taps per thread

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int> { using type = int4; };

template <typename T>
__device__ __forceinline__ void load4(const T* p, T* r) {
  const auto v = *reinterpret_cast<const typename Vec4<T>::type*>(p);
  r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
}

__device__ __forceinline__ float pm_accum(float acc, float a, float b) {
  const float s = a + b;
  return fmaf(s, s, acc);
}

__device__ __forceinline__ int pm_accum(int acc, int a, int b) {
  const int s = a + b;
  return acc + s * s;
}

__device__ __forceinline__ float sq_accum(float acc, float a) { return fmaf(a, a, acc); }
__device__ __forceinline__ int sq_accum(int acc, int a) { return acc + a * a; }

__device__ __forceinline__ float halve(float x) { return x * 0.5f; }
__device__ __forceinline__ int halve(int x) { return x >> 1; }  // arithmetic

// Position of one K index in (tap row i, tap column j, channel c), advanced
// by a step without a division: c carries into j, j into i.
struct TapPos {
  int i, j, c;
  __device__ __forceinline__ static TapPos at(int k, int C, int kw) {
    const int tap = k / C;
    return TapPos{tap / kw, tap % kw, k - tap * C};
  }
  __device__ __forceinline__ void advance(int step, int C, int kw) {
    c += step;
    while (c >= C) {
      c -= C;
      if (++j == kw) { j = 0; ++i; }
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
sq_conv2d_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const T* __restrict__ sw, T* __restrict__ out, int C, int H,
                 int W, int N, int kw, int sh, int sv, int ph, int pw, int oh,
                 int ow, int M, int K, int k_split, T* __restrict__ partial,
                 unsigned int* __restrict__ tickets) {
  __shared__ __align__(16) T as[2][BK][BM];
  __shared__ __align__(16) T bs[2][BK][BN];
  __shared__ T sx_part[A_ROWS][BM];
  __shared__ bool last_split;

  const int t = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int ohw = oh * ow;
  // this block's share of the K walk: [k_begin, k_end), a multiple of BK
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(K, k_begin + k_split);

  // Staging roles.  A: pixel lp (fixed for the whole K walk), K rows
  // lk + A_ROWS*q of each chunk.  B: filter column bn, K rows bk + B_ROWS*q.
  const int lp = t % BM;
  const int lk = t / BM;
  const int gm = m0 + lp;
  const bool m_ok = gm < M;
  int iy0 = 0, ix0 = 0;
  const T* xb = x;
  if (m_ok) {
    const int b = gm / ohw;
    const int q = gm - b * ohw;
    const int oy = q / ow;
    iy0 = oy * sh - ph;
    ix0 = (q - oy * ow) * sv - pw;
    xb = x + static_cast<size_t>(b) * C * H * W;
  }
  const int bn = t % BN;
  const int bk = t / BN;
  const bool n_ok = n0 + bn < N;
  const T* wcol = w + n0 + bn;

  // K position of this thread's first A row; advanced BK per chunk.
  TapPos base = TapPos::at(k_begin + lk, C, kw);

  T a_reg[A_LOADS], b_reg[B_LOADS];
  T sx = 0;

  auto load = [&](int k0) {
    TapPos p = base;
#pragma unroll
    for (int q = 0; q < A_LOADS; ++q) {
      T v = 0;
      const int iy = iy0 + p.i, ix = ix0 + p.j;
      if (m_ok && k0 + lk + A_ROWS * q < k_end && iy >= 0 && iy < H && ix >= 0 &&
          ix < W)
        v = xb[(p.c * H + iy) * W + ix];
      a_reg[q] = v;
      if (q + 1 < A_LOADS) p.advance(A_ROWS, C, kw);
    }
#pragma unroll
    for (int q = 0; q < B_LOADS; ++q) {
      const int k = k0 + bk + B_ROWS * q;
      b_reg[q] = (n_ok && k < k_end) ? wcol[static_cast<size_t>(k) * N] : T(0);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < A_LOADS; ++q) {
      as[buf][lk + A_ROWS * q][lp] = a_reg[q];
      sx = sq_accum(sx, a_reg[q]);
    }
#pragma unroll
    for (int q = 0; q < B_LOADS; ++q) bs[buf][bk + B_ROWS * q][bn] = b_reg[q];
  };

  // Compute roles: pixels tx*4 + {0..3} and BM/2 + tx*4 + {0..3}, filters
  // ty*4 + {0..3}; the accumulators start at Sw_f.
  const int tx = t % 16;
  const int ty = t / 16;
  T acc[TM][TN];
#pragma unroll
  for (int jn = 0; jn < TN; ++jn) {
    const int f = n0 + ty * TN + jn;
    const T s0 = (f < N && blockIdx.z == 0) ? sw[f] : T(0);
#pragma unroll
    for (int im = 0; im < TM; ++im) acc[im][jn] = s0;
  }

  const int nk = (k_end - k_begin + BK - 1) / BK;
  load(k_begin);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      base.advance(BK, C, kw);
      load(k_begin + (kt + 1) * BK);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      T a[TM], b[TN];
      load4(&as[cur][kk][tx * 4], a);
      load4(&as[cur][kk][BM / 2 + tx * 4], a + 4);
      load4(&bs[cur][kk][ty * TN], b);
#pragma unroll
      for (int im = 0; im < TM; ++im)
#pragma unroll
        for (int jn = 0; jn < TN; ++jn)
          acc[im][jn] = pm_accum(acc[im][jn], a[im], b[jn]);
    }
    // the other buffer was last read before the previous barrier
    if (kt + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }

  sx_part[lk][lp] = sx;
  __syncthreads();

  // this split's -Sx share, per pixel, in a fixed order
#pragma unroll
  for (int im = 0; im < TM; ++im) {
    const int p = (im < 4 ? 0 : BM / 2) + tx * 4 + (im & 3);
    T sxp = sx_part[0][p];
#pragma unroll
    for (int r = 1; r < A_ROWS; ++r) sxp += sx_part[r][p];
#pragma unroll
    for (int jn = 0; jn < TN; ++jn) acc[im][jn] -= sxp;
  }

  const int splits = gridDim.z;
  if (splits > 1) {
    // publish this split's partial sums, then take a ticket; the block that
    // takes the last one adds every split's partial in split order
    const size_t plane = static_cast<size_t>(M) * N;
#pragma unroll
    for (int im = 0; im < TM; ++im) {
      const int m = m0 + (im < 4 ? 0 : BM / 2) + tx * 4 + (im & 3);
#pragma unroll
      for (int jn = 0; jn < TN; ++jn) {
        const int f = n0 + ty * TN + jn;
        if (m < M && f < N)
          partial[blockIdx.z * plane + static_cast<size_t>(f) * M + m] = acc[im][jn];
      }
    }
    __threadfence();
    __syncthreads();
    if (t == 0) {
      const unsigned int tile = blockIdx.y * gridDim.x + blockIdx.x;
      last_split = atomicAdd(&tickets[tile], 1u) == static_cast<unsigned>(splits - 1);
    }
    __syncthreads();
    if (!last_split) return;
    __threadfence();
#pragma unroll
    for (int im = 0; im < TM; ++im) {
      const int m = m0 + (im < 4 ? 0 : BM / 2) + tx * 4 + (im & 3);
#pragma unroll
      for (int jn = 0; jn < TN; ++jn) {
        const int f = n0 + ty * TN + jn;
        if (m >= M || f >= N) continue;
        const T* src = partial + static_cast<size_t>(f) * M + m;
        T total = __ldcg(src);
        for (int z = 1; z < splits; ++z) total += __ldcg(src + z * plane);
        acc[im][jn] = total;
      }
    }
  }

#pragma unroll
  for (int im = 0; im < TM; ++im) {
    const int m = m0 + (im < 4 ? 0 : BM / 2) + tx * 4 + (im & 3);
    if (m >= M) continue;
    const int b = m / ohw;
    const int q = m - b * ohw;
#pragma unroll
    for (int jn = 0; jn < TN; ++jn) {
      const int f = n0 + ty * TN + jn;
      if (f < N) out[(static_cast<size_t>(b) * N + f) * ohw + q] = halve(acc[im][jn]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* sw, void* out, int B,
           int C, int H, int W, int N, int kh, int kw, int sh, int sv, int ph,
           int pw, int oh, int ow, int splits, void* partial, void* tickets,
           cudaStream_t s) {
  const int M = B * oh * ow;
  const int K = kh * kw * C;
  const int chunks = (K + BK - 1) / BK;
  const int k_split = (chunks + splits - 1) / splits * BK;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN,
                  (K + k_split - 1) / k_split);
  sq_conv2d_kernel<T><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(sw), static_cast<T*>(out), C, H, W, N, kw, sh, sv,
      ph, pw, oh, ow, M, K, k_split, static_cast<T*>(partial),
      static_cast<unsigned int*>(tickets));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0 = float32, 1 = int32.  x (B, C, H, W) contiguous and unpadded;
// w (kh*kw*C, N) row-major, K ordered (i, j, c); sw (N,); out (B, N, oh, ow).
// (ph, pw) are the leading pads; trailing pads follow from oh and ow.  The K
// walk is split over at most `splits` blocks a tile, each a whole number of
// 16-deep chunks; with more than one, `partial` holds splits * M * N
// elements of the dtype and `tickets` one zeroed counter a tile (M/128 by
// N/64 rounded up), both left for the kernel alone while it runs.
// Returns the cudaError_t of the launch.
extern "C" int fs_sq_conv2d(int dtype, const void* x, const void* w,
                            const void* sw, void* out, int B, int C, int H,
                            int W, int N, int kh, int kw, int sh, int sv,
                            int ph, int pw, int oh, int ow, int splits,
                            void* partial, void* tickets, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(x, w, sw, out, B, C, H, W, N, kh, kw, sh, sv, ph, pw,
                         oh, ow, splits, partial, tickets, s);
  if (dtype == 1)
    return launch<int>(x, w, sw, out, B, C, H, W, N, kh, kw, sh, sv, ph, pw, oh,
                       ow, splits, partial, tickets, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* fs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
