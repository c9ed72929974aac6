// K8: the square-based 1D correlation (the paper's Fig. 8 FIR engine) on
// Hopper's CUDA cores (sm_90a).
//
//   y_k = 1/2 * ( Sw + sum_t ((x_{k+t} + w_t)^2 - x_{k+t}^2) ),
//   Sw  = -sum_t w_t^2    (precomputed: the taps are constant, paper eq 11)
//
// for k < L - n + 1 (a valid correlation).  Replaces the Pallas TPU kernel
// src/repro/kernels/sq_conv.py::sq_conv_kernel (wrapper sq_conv_pallas,
// reached from ops._sq_conv_impl).  Every multiply is one operand add and
// one square; the shared x^2 is subtracted per term, as in the Pallas body.
//
// What bounds it on an H100: a stream of L samples read once and L - n + 1
// outputs written once is bound by bytes at a few taps, and by operations
// from a few tens of taps on (three instructions per term: the add, the
// square's fma and the -x^2 fma).
//
// Design against that bound:
// - One block owns a run of 2048 consecutive outputs; each of its 256
//   threads owns 8 consecutive ones, with their accumulators in registers.
// - The taps are walked in chunks of 256.  For each chunk the block stages
//   the window [start + c0, start + c0 + 2048 + 256 - 1) of the stream and
//   the chunk's taps in shared memory.  One schedule covers every tap
//   count: the Pallas kernel's unrolled (n <= 128) and looped walks are one
//   loop here.
// - Each thread slides an 8-sample register window along the staged
//   samples: one shared-memory load brings the new sample of a tap, and the
//   8 outputs reuse it, so a tap costs 2 loads for 24 arithmetic
//   instructions.  A pad word every 32 samples keeps the stride-8 loads of a
//   warp free of bank conflicts.
// - Taps past n are never walked: a zero tap would add (x + 0)^2 - x^2,
//   which is 0 in exact arithmetic but not always after the two fma
//   roundings.  Samples past L load 0 and reach only outputs past the end,
//   which are never written.
// - The accumulators start at Sw and are halved at the end: x0.5 on f32,
//   an arithmetic >>1 on int32 (exact: the total is even).  The JAX
//   kernel writes acc * 0.5 whatever the dtype; here the int path follows
//   squares.halve.
//
// Numerics: each term is fma(s, s, acc) then fma(-x, x, acc), two
// roundings; the int32 path is exact for int8/int16 widened to int32.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int R = 8;                      // outputs per thread
constexpr int BO = THREADS * R;           // outputs per block
constexpr int TC = 256;                   // taps per staged chunk
constexpr int WIN = BO + TC;              // staged samples (BO + TC - 1 used)
constexpr int U = 8;                      // taps per unrolled step

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

__device__ __forceinline__ float pm_term(float acc, float x, float w) {
  const float s = x + w;
  return fmaf(-x, x, fmaf(s, s, acc));
}

__device__ __forceinline__ int pm_term(int acc, int x, int w) {
  const int s = x + w;
  return acc + s * s - x * x;
}

__device__ __forceinline__ float halve(float x) { return x * 0.5f; }
__device__ __forceinline__ int halve(int x) { return x >> 1; }  // arithmetic

template <typename T>
__device__ __forceinline__ void tap(T (&acc)[R], T (&xr)[R], const T* xs,
                                    int at, T wt) {
  xr[R - 1] = xs[padded(at + R - 1)];
#pragma unroll
  for (int j = 0; j < R; ++j) acc[j] = pm_term(acc[j], xr[j], wt);
#pragma unroll
  for (int j = 0; j < R - 1; ++j) xr[j] = xr[j + 1];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
sq_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const T* __restrict__ sw, T* __restrict__ out, int L, int n) {
  __shared__ T xs[WIN + WIN / 32];
  __shared__ T ws[TC];

  const long long start = static_cast<long long>(blockIdx.x) * BO;
  const int k_out = L - n + 1;
  const int base = threadIdx.x * R;

  T acc[R];
  const T s0 = sw[0];
#pragma unroll
  for (int j = 0; j < R; ++j) acc[j] = s0;

  for (int c0 = 0; c0 < n; c0 += TC) {
    const int tc = min(TC, n - c0);
    for (int i = threadIdx.x; i < BO + tc - 1; i += THREADS) {
      const long long g = start + c0 + i;
      xs[padded(i)] = g < L ? x[g] : T(0);
    }
    for (int i = threadIdx.x; i < tc; i += THREADS) ws[i] = w[c0 + i];
    __syncthreads();

    T xr[R];
#pragma unroll
    for (int j = 0; j < R - 1; ++j) xr[j] = xs[padded(base + j)];
    int t = 0;
    for (; t + U <= tc; t += U) {
#pragma unroll
      for (int u = 0; u < U; ++u) tap(acc, xr, xs, base + t + u, ws[t + u]);
    }
    for (; t < tc; ++t) tap(acc, xr, xs, base + t, ws[t]);
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < R; ++j) {
    const long long k = start + base + j;
    if (k < k_out) out[k] = halve(acc[j]);
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* sw, void* out, int L,
           int n, cudaStream_t s) {
  const int k_out = L - n + 1;
  const int grid = (k_out + BO - 1) / BO;
  sq_conv_kernel<T><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(sw), static_cast<T*>(out), L, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0 = float32, 1 = int32.  x (L,), w (n,) with 1 <= n <= L, sw (1,),
// out (L - n + 1,), all contiguous.  Returns the cudaError_t of the launch.
extern "C" int fs_sq_conv(int dtype, const void* x, const void* w,
                          const void* sw, void* out, int L, int n,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, sw, out, L, n, s);
  if (dtype == 1) return launch<int>(x, w, sw, out, L, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* fs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
