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
// What bounds it on an H100: a complex term is 3 adds and 3 squares (9
// FLOP counting an fma as 2, 6 FP32 issue slots), with the row and column
// planes reused across a whole tile, so at the batched-DFT shape (4096 x
// 1024 x 1024) it is bound by FP32 issue on the CUDA cores.
//
// Design: the register-tiled schedule of cpm_tile.cuh (shared with K6),
// with three staged row planes (a+b, b, a) and three column planes (c, c+s,
// s-c), hoisted once per staged element as the Pallas kernel hoists them
// once per grid step, so each square is one add and one fmaf.  Three
// accumulator planes a thread-tile element: P, the shared square (c+a+b)^2
// -- issued once a term, as the Pallas body's `shared = t * t` -- and re and
// im, which start at the row corrections Sab_h and Sba_h and take -(b+c+s)^2
// and +(a+s-c)^2.  An 8 x 4 thread tile: 96 accumulators, ~180 registers, so
// one block (8 warps) an SM.
//
// Numerics: per term t = (a+b)+c, u = b+(c+s), v = a+(s-c) are rounded on
// their own (as in the Pallas body), then P = fmaf(t, t, P), re = fmaf(-u,
// u, re), im = fmaf(v, v, im): one rounding per square.  At the end of each
// staged K tile re += P, im += P and P = 0, as the Pallas body folds each
// chunk's sum into its carry, so P holds at most BK terms and re and im
// round as running sums.  The halving is exact and the column term rounds
// once.  f32 only: integer planes are the exact path of core/complexmm.py
// (the Pallas kernel cannot take them either).

#include "cpm_tile.cuh"

namespace {

struct Cpm3 {
  static constexpr int ROW_PLANES = 3;   // a+b, b, a
  static constexpr int COL_PLANES = 3;   // c, c+s, s-c
  static constexpr int ACC_PLANES = 3;   // re, im, P
  static constexpr int TILE_M = 8, TILE_N = 4;  // thread tile
  static constexpr int MIN_BLOCKS = 1;   // blocks an SM

  __device__ static void rows(float a, float b, float (&v)[ROW_PLANES]) {
    v[0] = a + b;
    v[1] = b;
    v[2] = a;
  }
  __device__ static void cols(float c, float s, float (&v)[COL_PLANES]) {
    v[0] = c;
    v[1] = c + s;
    v[2] = s - c;
  }
  template <int TM, int TN>
  __device__ static void init(float (&acc)[ACC_PLANES][TM][TN], int i, int j,
                              float row_re, float row_im) {
    acc[0][i][j] = row_re;
    acc[1][i][j] = row_im;
    acc[2][i][j] = 0.f;
  }
  template <int TM, int TN>
  __device__ static void term(float (&acc)[ACC_PLANES][TM][TN], int i, int j,
                              const float (&r)[ROW_PLANES][TM],
                              const float (&c)[COL_PLANES][TN]) {
    const float t = r[0][i] + c[0][j];   // c + a + b, shared by both planes
    const float u = r[1][i] + c[1][j];   // b + c + s
    const float v = r[2][i] + c[2][j];   // a + s - c
    acc[2][i][j] = fmaf(t, t, acc[2][i][j]);
    acc[0][i][j] = fmaf(-u, u, acc[0][i][j]);
    acc[1][i][j] = fmaf(v, v, acc[1][i][j]);
  }
  template <int TM, int TN>
  __device__ static void end_tile(float (&acc)[ACC_PLANES][TM][TN]) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        acc[0][i][j] += acc[2][i][j];
        acc[1][i][j] += acc[2][i][j];
        acc[2][i][j] = 0.f;
      }
  }
  template <int TM, int TN>
  __device__ static float re(const float (&acc)[ACC_PLANES][TM][TN], int i,
                             int j) {
    return acc[0][i][j];
  }
  template <int TM, int TN>
  __device__ static float im(const float (&acc)[ACC_PLANES][TM][TN], int i,
                             int j) {
    return acc[1][i][j];
  }
};

}  // namespace

// a, b (m, k); c, s (k, n); re, im (m, n): f32, row-major and contiguous.
// sre = Sab (m,), sim = Sba (m,), scs = Scs (n,), ssc = Ssc (n,).  shape
// (4 ints, host memory) receives the launch's grid (x = row tiles, y =
// column tiles) and thread tile (TM, TN); tile 0 is the kernel's own
// thread tile, 1 the 1 x 1 (the caller's plan).  Returns the cudaError_t of the
// launch.
extern "C" int fs_cpm3_matmul(const void* a, const void* b, const void* c,
                              const void* s, const void* sre, const void* sim,
                              const void* scs, const void* ssc, void* re,
                              void* im, int m, int n, int k, int tile,
                              void* stream, int* shape) {
  const cpm::Args p{static_cast<const float*>(a), static_cast<const float*>(b),
                    static_cast<const float*>(c), static_cast<const float*>(s),
                    static_cast<const float*>(sre),
                    static_cast<const float*>(sim),
                    static_cast<const float*>(scs),
                    static_cast<const float*>(ssc), static_cast<float*>(re),
                    static_cast<float*>(im), m, n, k};
  return cpm::launch<Cpm3>(p, tile, static_cast<cudaStream_t>(stream), shape);
}

extern "C" const char* fs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
