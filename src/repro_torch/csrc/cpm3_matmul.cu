// K5: complex matmul with three squares per complex multiply (the paper's
// CPM3, §9) on Hopper's CUDA cores (sm_90a).
//
//   Re(2z_hk) = Sab_h + Scs_k + sum_i [(c+a+b)^2 - (b+c+s)^2]      (eq 32)
//   Im(2z_hk) = Sba_h + Ssc_k + sum_i [(c+a+b)^2 + (a+s-c)^2]      (eq 34)
//
// for X = A + jB (m, k) and Y = C + jS (k, n) as four f32 planes.  Replaces
// the Pallas TPU kernel src/repro/kernels/cpm3_matmul.py::cpm3_matmul_kernel
// (body _cpm3_body; wrapper cpm3_matmul_pallas, reached from
// ops._cpm3_impl).  The squares are the paper's claim, so they run as scalar
// FP32 instructions on the CUDA cores and never as a tensor-core MMA.
//
// What bounds it on an H100: every complex term is 3 adds and 4 fma (11
// FLOP counting an fma as 2) for 8 bytes of row planes and 8 of column
// planes that are reused across a whole tile, so at the batched-DFT shape
// (4096 x 1024 x 1024) it is bound by operations on the FP32 cores, ~100x
// above its byte bound.
//
// Design against that bound -- K1's schedule (csrc/sq_matmul.cu) with two
// accumulator planes:
// - One block owns a BM x 32 output tile; lane j of every warp owns column j,
//   so a warp's read of c[k, j0:j0+32] and s[k, j0:j0+32] is one coalesced
//   128-byte line each.  The 8 warps split each 64-deep K tile.
// - The hoisted planes are formed once per staged element, as the Pallas
//   kernel forms them once per grid step: the row planes (a+b, b, a) are
//   written to shared memory k-major (a padded stride of BM + 4 floats keeps
//   16-byte alignment), so a lane reads four rows of a plane with one
//   broadcast float4 load; the column planes (c, c+s, s-c) are formed in
//   registers at load.  Each square is then one add and one fmaf.
// - Each thread holds re and im for its BM rows.  Warp 0's start at the row
//   corrections Sab_h and Sba_h (the Pallas accumulator init); the other
//   warps' at 0.  BM = 16 keeps the two planes' 32 accumulators well under
//   the 128-register cap of two resident blocks per SM (no spills), and the
//   reduction buffer (32 KB) with the staged planes (15 KB) within the 48 KB
//   of static shared memory.
// - Epilogue: the 8 partials are summed in warp order (deterministic: no
//   atomics), both planes are halved, and 1/2 Scs_k and 1/2 Ssc_k are added
//   after the halving, as the JAX wrapper adds them after its pallas_call.
// - Ragged m, n and k are masked in the kernel: rows and columns past the
//   edge are never written, and k past the edge stages zeros in all four
//   planes, whose term (0+0+0)^2 - (0+0+0)^2 adds exactly 0 to both planes.
//
// Numerics: per term t = (a+b)+c, u = b+(c+s), v = a+(s-c) are rounded on
// their own (as in the Pallas body), then re = fmaf(-u, u, fmaf(t, t, re))
// and im = fmaf(v, v, fmaf(t, t, im)): one rounding per square.  The halving
// is exact and the column term rounds once.  f32 only: integer planes are
// the exact path of core/complexmm.py (the Pallas kernel cannot take them
// either).

#include <cuda_runtime.h>

namespace {

constexpr int BM = 16;             // output rows per block
constexpr int BN = 32;             // output columns per block (one per lane)
constexpr int KS = 8;              // warps per block, each a slice of every K tile
constexpr int BK = 64;             // K tile staged in shared memory
constexpr int RP = BM + 4;         // padded stride of a staged row plane
constexpr int THREADS = BN * KS;

__device__ __forceinline__ void cpm3_term(float& re, float& im, float ab,
                                          float b, float a, float c,
                                          float cs, float sc) {
  const float t = ab + c;          // c + a + b, the square both planes share
  const float u = b + cs;          // b + c + s
  const float v = a + sc;          // a + s - c
  re = fmaf(-u, u, fmaf(t, t, re));
  im = fmaf(v, v, fmaf(t, t, im));
}

__global__ void __launch_bounds__(THREADS, 2)
cpm3_matmul_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ c, const float* __restrict__ s,
                   const float* __restrict__ sre, const float* __restrict__ sim,
                   const float* __restrict__ scs, const float* __restrict__ ssc,
                   float* __restrict__ re_out, float* __restrict__ im_out,
                   int m, int n, int k) {
  __shared__ __align__(16) float rows[3][BK][RP];   // (a+b, b, a), k-major
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
    const bool init = ks == 0 && r < m;
    re[i] = init ? sre[r] : 0.f;
    im[i] = init ? sim[r] : 0.f;
  }

  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int i = e / BK, kk = e % BK;
      const int r = row0 + i, kc = k0 + kk;
      const bool ok = r < m && kc < k;
      const float av = ok ? a[(size_t)r * k + kc] : 0.f;
      const float bv = ok ? b[(size_t)r * k + kc] : 0.f;
      rows[0][kk][i] = av + bv;
      rows[1][kk][i] = bv;
      rows[2][kk][i] = av;
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < BK / KS; ++t) {
      const int kk = t * KS + ks;
      const int kc = k0 + kk;
      const bool ok = col_ok && kc < k;
      const float cv = ok ? c[(size_t)kc * n + col] : 0.f;
      const float sv = ok ? s[(size_t)kc * n + col] : 0.f;
      const float cs = cv + sv, sc = sv - cv;
      const float4* pab = reinterpret_cast<const float4*>(rows[0][kk]);
      const float4* pb = reinterpret_cast<const float4*>(rows[1][kk]);
      const float4* pa = reinterpret_cast<const float4*>(rows[2][kk]);
#pragma unroll
      for (int q = 0; q < BM / 4; ++q) {
        const float4 vab = pab[q], vb = pb[q], va = pa[q];
        cpm3_term(re[4 * q + 0], im[4 * q + 0], vab.x, vb.x, va.x, cv, cs, sc);
        cpm3_term(re[4 * q + 1], im[4 * q + 1], vab.y, vb.y, va.y, cv, cs, sc);
        cpm3_term(re[4 * q + 2], im[4 * q + 2], vab.z, vb.z, va.z, cv, cs, sc);
        cpm3_term(re[4 * q + 3], im[4 * q + 3], vab.w, vb.w, va.w, cv, cs, sc);
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
      re_out[(size_t)r * n + cx] = vr * 0.5f + 0.5f * scs[cx];
      im_out[(size_t)r * n + cx] = vi * 0.5f + 0.5f * ssc[cx];
    }
  }
}

}  // namespace

// a, b (m, k); c, s (k, n); re, im (m, n): f32, row-major and contiguous.
// sre = Sab (m,), sim = Sba (m,), scs = Scs (n,), ssc = Ssc (n,).  Returns
// the cudaError_t of the launch.
extern "C" int fs_cpm3_matmul(const void* a, const void* b, const void* c,
                              const void* s, const void* sre, const void* sim,
                              const void* scs, const void* ssc, void* re,
                              void* im, int m, int n, int k, void* stream) {
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  cpm3_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(s),
      static_cast<const float*>(sre), static_cast<const float*>(sim),
      static_cast<const float*>(scs), static_cast<const float*>(ssc),
      static_cast<float*>(re), static_cast<float*>(im), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
