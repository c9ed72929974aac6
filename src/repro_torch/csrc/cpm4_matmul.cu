// K6: complex matmul with four squares per complex multiply (the paper's
// CPM4, §6) on Hopper's CUDA cores (sm_90a).
//
//   Re(2z_hk) = Sx_h + Sy_k + sum_i [(a+c)^2 + (b-s)^2]      (eq 21)
//   Im(2z_hk) = Sx_h + Sy_k + sum_i [(b+c)^2 + (a+s)^2]      (eq 22)
//   Sx_h = -sum_i (a^2 + b^2),  Sy_k = -sum_i (c^2 + s^2)    (eq 18)
//
// for X = A + jB (m, k) and Y = C + jS (k, n) as four f32 planes.  Replaces
// the Pallas TPU kernel src/repro/kernels/cpm4_matmul.py::cpm4_matmul_kernel
// (body _cpm4_body; wrapper cpm4_matmul_pallas, reached from
// ops._cpm4_impl).  The squares run as scalar FP32 instructions on the CUDA
// cores, never as a tensor-core MMA.
//
// What bounds it on an H100: every complex term is 4 adds and 4 fma (12
// FLOP counting an fma as 2), with the row and column planes reused across
// a whole tile, so at the batched-DFT shape (4096 x 1024 x 1024) it is bound
// by operations on the FP32 cores, ~100x above its byte bound.
//
// Design against that bound -- K5's schedule (csrc/cpm3_matmul.cu), which is
// K1's with two accumulator planes:
// - One block owns a BM x 32 output tile; lane j owns column j (coalesced
//   128-byte reads of c and s); the 8 warps split each 64-deep K tile.
// - The row planes (a, b) are staged in shared memory k-major, read as
//   broadcast float4s (four rows a load); the column planes (c, s, -s) are
//   formed in registers at load, the negation hoisted as the Pallas kernel
//   hoists it, so every square is one add and one fmaf.  Unlike CPM3 no
//   square is shared between the planes.
// - Each thread holds re and im for its BM = 16 rows.  Warp 0's both start
//   at the one row correction Sx_h (the Pallas accumulator init: CPM4's two
//   planes share one correction pair); the other warps' at 0.
// - Epilogue: the 8 partials are summed in warp order (deterministic), both
//   planes are halved, and 1/2 Sy_k is added to both after the halving, as
//   the JAX wrapper does after its pallas_call.
// - Ragged m, n and k are masked in the kernel: k past the edge stages zeros
//   in all four planes, whose term (0+0)^2 + (0-0)^2 adds exactly 0.
//
// Numerics: each operand add rounds on its own, then re = fmaf(t2, t2,
// fmaf(t1, t1, re)) and likewise im: one rounding per square.  The halving
// is exact and the column term rounds once.  f32 only: integer planes are
// the exact path of core/complexmm.py.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 16;             // output rows per block
constexpr int BN = 32;             // output columns per block (one per lane)
constexpr int KS = 8;              // warps per block, each a slice of every K tile
constexpr int BK = 64;             // K tile staged in shared memory
constexpr int RP = BM + 4;         // padded stride of a staged row plane
constexpr int THREADS = BN * KS;

__device__ __forceinline__ void cpm4_term(float& re, float& im, float a,
                                          float b, float c, float s,
                                          float ns) {
  const float t1 = a + c;
  const float t2 = b + ns;         // b - s through the hoisted -s plane
  const float t3 = b + c;
  const float t4 = a + s;
  re = fmaf(t2, t2, fmaf(t1, t1, re));
  im = fmaf(t4, t4, fmaf(t3, t3, im));
}

__global__ void __launch_bounds__(THREADS, 2)
cpm4_matmul_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ c, const float* __restrict__ s,
                   const float* __restrict__ sx, const float* __restrict__ sy,
                   float* __restrict__ re_out, float* __restrict__ im_out,
                   int m, int n, int k) {
  __shared__ __align__(16) float rows[2][BK][RP];   // (a, b), k-major
  __shared__ float red[2][KS][BM][BN];

  const int lane = threadIdx.x % BN;
  const int ks = threadIdx.x / BN;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int col = col0 + lane;
  const bool col_ok = col < n;

  float re[BM], im[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) {
    const int r = row0 + i;
    re[i] = (ks == 0 && r < m) ? sx[r] : 0.f;
    im[i] = re[i];
  }

  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int i = e / BK, kk = e % BK;
      const int r = row0 + i, kc = k0 + kk;
      const bool ok = r < m && kc < k;
      rows[0][kk][i] = ok ? a[(size_t)r * k + kc] : 0.f;
      rows[1][kk][i] = ok ? b[(size_t)r * k + kc] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < BK / KS; ++t) {
      const int kk = t * KS + ks;
      const int kc = k0 + kk;
      const bool ok = col_ok && kc < k;
      const float cv = ok ? c[(size_t)kc * n + col] : 0.f;
      const float sv = ok ? s[(size_t)kc * n + col] : 0.f;
      const float nsv = -sv;
      const float4* pa = reinterpret_cast<const float4*>(rows[0][kk]);
      const float4* pb = reinterpret_cast<const float4*>(rows[1][kk]);
#pragma unroll
      for (int q = 0; q < BM / 4; ++q) {
        const float4 va = pa[q], vb = pb[q];
        cpm4_term(re[4 * q + 0], im[4 * q + 0], va.x, vb.x, cv, sv, nsv);
        cpm4_term(re[4 * q + 1], im[4 * q + 1], va.y, vb.y, cv, sv, nsv);
        cpm4_term(re[4 * q + 2], im[4 * q + 2], va.z, vb.z, cv, sv, nsv);
        cpm4_term(re[4 * q + 3], im[4 * q + 3], va.w, vb.w, cv, sv, nsv);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < BM; ++i) {
    red[0][ks][i][lane] = re[i];
    red[1][ks][i][lane] = im[i];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int i = e / BN, cc = e % BN;
    const int r = row0 + i, cx = col0 + cc;
    if (r < m && cx < n) {
      float vr = red[0][0][i][cc], vi = red[1][0][i][cc];
#pragma unroll
      for (int p = 1; p < KS; ++p) {
        vr += red[0][p][i][cc];
        vi += red[1][p][i][cc];
      }
      const float half_sy = 0.5f * sy[cx];
      re_out[(size_t)r * n + cx] = vr * 0.5f + half_sy;
      im_out[(size_t)r * n + cx] = vi * 0.5f + half_sy;
    }
  }
}

}  // namespace

// a, b (m, k); c, s (k, n); re, im (m, n): f32, row-major and contiguous.
// sx = Sx (m,), sy = Sy (n,).  Returns the cudaError_t of the launch.
extern "C" int fs_cpm4_matmul(const void* a, const void* b, const void* c,
                              const void* s, const void* sx, const void* sy,
                              void* re, void* im, int m, int n, int k,
                              void* stream) {
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  cpm4_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(s),
      static_cast<const float*>(sx), static_cast<const float*>(sy),
      static_cast<float*>(re), static_cast<float*>(im), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
