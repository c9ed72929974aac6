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
// What bounds it on an H100: a complex term is 4 adds and 4 squares (12
// FLOP counting an fma as 2, 8 FP32 issue slots), with the row and column
// planes reused across a whole tile, so at the batched-DFT shape (4096 x
// 1024 x 1024) it is bound by FP32 issue on the CUDA cores.
//
// Design: the register-tiled schedule of cpm_tile.cuh (shared with K5),
// with the raw planes staged -- a, b by rows and c, s by columns.  b - s is
// one add with a negated operand, so no -s plane is staged (the Pallas
// kernel hoists one; on the TPU the negation is a vector op, here it is
// free).  Two accumulator planes, both starting at the one row correction
// Sx_h (CPM4's two planes share one correction pair).  A 4 x 4 thread tile:
// 32 accumulators under the 128 registers of two blocks an SM (at 8 x 4,
// 64 accumulators, ptxas spilled under that cap).
//
// Numerics: each operand add rounds on its own, then re = fmaf(t2, t2,
// fmaf(t1, t1, re)) and likewise im: one rounding per square, running sums
// over the whole k walk.  The halving is exact and the column term rounds
// once.  f32 only: integer planes are the exact path of core/complexmm.py.

#include "cpm_tile.cuh"

namespace {

struct Cpm4 {
  static constexpr int ROW_PLANES = 2;   // a, b
  static constexpr int COL_PLANES = 2;   // c, s
  static constexpr int ACC_PLANES = 2;   // re, im
  static constexpr int TILE_M = 4, TILE_N = 4;  // thread tile
  static constexpr int MIN_BLOCKS = 2;   // blocks an SM

  __device__ static void rows(float a, float b, float (&v)[ROW_PLANES]) {
    v[0] = a;
    v[1] = b;
  }
  __device__ static void cols(float c, float s, float (&v)[COL_PLANES]) {
    v[0] = c;
    v[1] = s;
  }
  template <int TM, int TN>
  __device__ static void init(float (&acc)[ACC_PLANES][TM][TN], int i, int j,
                              float row_re, float row_im) {
    acc[0][i][j] = row_re;
    acc[1][i][j] = row_im;
  }
  template <int TM, int TN>
  __device__ static void term(float (&acc)[ACC_PLANES][TM][TN], int i, int j,
                              const float (&r)[ROW_PLANES][TM],
                              const float (&c)[COL_PLANES][TN]) {
    const float a = r[0][i], b = r[1][i], cv = c[0][j], s = c[1][j];
    const float t1 = a + cv;
    const float t2 = b - s;
    const float t3 = b + cv;
    const float t4 = a + s;
    acc[0][i][j] = fmaf(t2, t2, fmaf(t1, t1, acc[0][i][j]));
    acc[1][i][j] = fmaf(t4, t4, fmaf(t3, t3, acc[1][i][j]));
  }
  template <int TM, int TN>
  __device__ static void end_tile(float (&)[ACC_PLANES][TM][TN]) {}
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
// sx = Sx (m,), sy = Sy (n,).  shape (4 ints, host memory) receives the
// launch's grid (x = row tiles, y = column tiles) and thread tile (TM, TN);
// tile 0 is the kernel's own thread tile, 1 the 1 x 1 (the caller's plan).
// Returns the cudaError_t of the launch.
extern "C" int fs_cpm4_matmul(const void* a, const void* b, const void* c,
                              const void* s, const void* sx, const void* sy,
                              void* re, void* im, int m, int n, int k,
                              int tile, void* stream, int* shape) {
  const float* x = static_cast<const float*>(sx);
  const float* y = static_cast<const float*>(sy);
  const cpm::Args p{static_cast<const float*>(a), static_cast<const float*>(b),
                    static_cast<const float*>(c), static_cast<const float*>(s),
                    x, x, y, y, static_cast<float*>(re),
                    static_cast<float*>(im), m, n, k};
  return cpm::launch<Cpm4>(p, tile, static_cast<cudaStream_t>(stream), shape);
}

extern "C" const char* fs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
