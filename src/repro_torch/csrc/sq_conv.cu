// K8: the square-based 1D correlation (the paper's Fig. 8 FIR engine) on
// Hopper's CUDA cores (sm_90a).
//
//   y_k = 1/2 * ( Sw + sum_t (x_{k+t} + w_t)^2 - S_k ),
//   Sw  = -sum_t w_t^2    (precomputed: the taps are constant, paper eq 11)
//   S_k = sum_t x_{k+t}^2 (the sliding sum of squares)
//
// for k < L - n + 1 (a valid correlation).  Replaces the Pallas TPU kernel
// src/repro/kernels/sq_conv.py::sq_conv_kernel (wrapper sq_conv_pallas,
// reached from ops._sq_conv_impl).  Every multiply is one operand add and
// one square.
//
// What bounds it on an H100: a stream of L samples read once and L - n + 1
// outputs written once is bound by bytes at a few taps, and by FP32 issue
// from a few tens of taps on: a term is two issue slots, the add and
// fma(s, s, acc).
//
// Design against that bound:
// - One block owns a run of 2048 consecutive outputs; each of its 256
//   threads owns R = 8 consecutive ones, with their accumulators in
//   registers.  The taps are walked in chunks of 256: for each chunk the
//   block stages the samples [start + c0, start + c0 + 2048 + 256 - 1) in
//   shared memory with 16-byte loads, and the chunk's taps.  The outputs
//   go back through shared memory too, so that both ends of the stream
//   move as whole 512-byte runs a warp.
// - Each thread slides a register window along the staged samples, R taps
//   at a time: R new samples and two 16-byte tap reads feed 2 R^2 slots of
//   terms, and the window's two halves trade names from one group of R taps
//   to the next, so no register is moved; a chunk's last taps (fewer than
//   R) read the next R samples once and run unrolled.  A pad word every R
//   samples keeps the stride-R loads of a warp free of bank conflicts and
//   every address of a group of R taps a constant offset from the thread's
//   base.
// - -x^2 is out of the term.  Each staged sample is squared once, on its
//   way into shared memory (qs).  An output's S_k is then formed from those
//   squares with short float sums only: each aligned run of R squares is
//   summed once as it is staged, S of a thread's first output is the sum
//   of n / R such run sums (one a group of R taps, inside the tap loop)
//   and the rest of its window, and the thread's other
//   outputs slide from it, adding the square entering and subtracting the
//   one leaving -- a slide across its own R outputs, never a running
//   prefix over a block's window, which would cancel.  The slide's head
//   terms are added in the first tap chunk and its tail terms in the last,
//   so a stream of any length takes the same path.
// - Taps past n are never walked: a zero tap would add (x + 0)^2, which S
//   does not take back.  Samples past L load 0 and reach only outputs past
//   the end, which are never written.
// - The accumulators start at Sw and are halved at the end: x0.5 on f32,
//   an arithmetic >>1 on int32 (exact: the total is even).  The JAX kernel
//   writes acc * 0.5 whatever the dtype; here the int path follows
//   squares.halve.
//
// Numerics: each term is fma(s, s, acc), one rounding; S_k is formed in
// f32 as above.  The int32 path is exact for int8/int16 widened to int32.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int R = 8;                      // outputs a thread
constexpr int BO = THREADS * R;           // outputs a block
constexpr int TC = 256;                   // taps a staged chunk
constexpr int WIN = BO + TC;              // staged samples (BO + TC - 1 used)
constexpr int SPAN = WIN + WIN / R;       // with a pad word every R

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int> { using type = int4; };

// A pad word every R samples: a warp's stride-R reads hit 32 banks (R + 1
// is odd), and thread t's sample base + k sits at (R + 1) t + k + k / R.
__device__ __forceinline__ int padded(int i) { return i + i / R; }

__device__ __forceinline__ float pm_accum(float acc, float x, float w) {
  const float s = x + w;
  return fmaf(s, s, acc);
}
__device__ __forceinline__ int pm_accum(int acc, int x, int w) {
  const int s = x + w;
  return acc + s * s;
}

__device__ __forceinline__ float halve(float x) { return x * 0.5f; }
__device__ __forceinline__ int halve(int x) { return x >> 1; }  // arithmetic

// R taps from tap u0 (a multiple of R) on: window lo holds samples
// base+u0 .. +R-1 and is refilled (as the next group's lo) with
// base+u0+R .. +2R-1; xt is the thread's padded sample base.  The run
// sum of those R samples' squares (qr[u0 / R]) is added to s, the sum of
// squares of the thread's first output.
template <typename T>
__device__ __forceinline__ void taps_r(T (&acc)[R], T (&lo)[R], T (&hi)[R],
                                       T& s, const T* xt, const T* qr,
                                       const T* ws, int u0) {
  s += qr[u0 / R];
  const T* next = xt + (u0 / R + 1) * (R + 1);
#pragma unroll
  for (int j = 0; j < R; ++j) hi[j] = next[j];
  T w[R];
#pragma unroll
  for (int q = 0; q < R / 4; ++q) {
    const auto v = reinterpret_cast<const typename Vec4<T>::type*>(ws + u0)[q];
    w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z; w[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int u = 0; u < R; ++u)
#pragma unroll
    for (int j = 0; j < R; ++j)
      acc[j] = pm_accum(acc[j], j + u < R ? lo[j + u] : hi[j + u - R], w[u]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
sq_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const T* __restrict__ sw, T* __restrict__ out, int L, int n,
               int vec) {
  __shared__ __align__(16) T xs[SPAN];
  __shared__ __align__(16) T qs[SPAN];     // the staged samples' squares
  __shared__ __align__(16) T ws[TC];
  __shared__ T qrun[WIN / R];              // sums of R squares, aligned runs

  const long long start = static_cast<long long>(blockIdx.x) * BO;
  const int k_out = L - n + 1;
  const int base = threadIdx.x * R;
  const T* const xt = xs + threadIdx.x * (R + 1);    // padded(base)
  const T* const qt = qs + threadIdx.x * (R + 1);
  const T* const qr = qrun + threadIdx.x;             // runs from base

  T acc[R];
  const T s0 = sw[0];
#pragma unroll
  for (int j = 0; j < R; ++j) acc[j] = s0;
  T s_first = 0;                            // S of the thread's first output

  for (int c0 = 0; c0 < n; c0 += TC) {
    const int tc = min(TC, n - c0);
    const int span = BO + tc - 1;
    // stage the chunk's samples and their squares, a run of R at a time,
    // with the run's sum of squares
    for (int i = threadIdx.x * R; i < span; i += THREADS * R) {
      const long long g = start + c0 + i;
      T v[R];
#pragma unroll
      for (int e4 = 0; e4 < R; e4 += 4) {
        if (vec && g + e4 + 3 < L) {
          const auto f = *reinterpret_cast<const typename Vec4<T>::type*>(x + g + e4);
          v[e4] = f.x; v[e4 + 1] = f.y; v[e4 + 2] = f.z; v[e4 + 3] = f.w;
        } else {
#pragma unroll
          for (int e = e4; e < e4 + 4; ++e) v[e] = g + e < L ? x[g + e] : T(0);
        }
      }
      T q = 0;
#pragma unroll
      for (int e = 0; e < R; ++e) {
        const T sq = v[e] * v[e];
        xs[i / R * (R + 1) + e] = v[e];
        qs[i / R * (R + 1) + e] = sq;
        q += sq;
      }
      qrun[i / R] = q;
    }
    for (int i = threadIdx.x; i < tc; i += THREADS) ws[i] = w[c0 + i];
    __syncthreads();

    // the squares, R taps at a time and the last fewer than R unrolled;
    // S of the first output over this chunk's taps: the run sums of the
    // whole runs, added by taps_r, then the rest
    T s = 0;
    T lo[R], hi[R];
#pragma unroll
    for (int j = 0; j < R; ++j) lo[j] = xt[j];
    int u = 0;
    for (; u + 2 * R <= tc; u += 2 * R) {
      taps_r(acc, lo, hi, s, xt, qr, ws, u);
      taps_r(acc, hi, lo, s, xt, qr, ws, u + R);
    }
    if (u + R <= tc) {
      taps_r(acc, lo, hi, s, xt, qr, ws, u);
#pragma unroll
      for (int j = 0; j < R; ++j) lo[j] = hi[j];
      u += R;
    }
    const int rem = tc - u;             // fewer than R taps, u a multiple of R
    if (rem > 0) {
      const T* next = xt + (u / R + 1) * (R + 1);
#pragma unroll
      for (int j = 0; j < R - 1; ++j) hi[j] = j + 1 < rem ? next[j] : T(0);
#pragma unroll
      for (int e = 0; e < R - 1; ++e) {
        if (e < rem) {
          const T wt = ws[u + e];
#pragma unroll
          for (int j = 0; j < R; ++j)
            acc[j] = pm_accum(acc[j], j + e < R ? lo[j + e] : hi[j + e - R], wt);
        }
      }
    }

#pragma unroll
    for (int e = 0; e < R - 1; ++e)
      if (e < rem) s += qt[padded(u + e)];
    s_first += s;
    // the slide's head (chunk 0) and tail (last chunk): output j's S is
    // s_first + sum_{u<j} (q[k0 + u + n] - q[k0 + u])
    if (c0 == 0) {
      T h = 0;
#pragma unroll
      for (int j = 1; j < R; ++j) {
        h += qt[j - 1];
        acc[j] += h;
      }
    }
    if (c0 + tc == n) {
      T t = 0;
#pragma unroll
      for (int j = 1; j < R; ++j) {
        t += qt[padded(j - 1 + tc)];
        acc[j] -= t;
      }
    }
    __syncthreads();
  }

  // The block's outputs go through shared memory (xs, read by now), so
  // that a warp stores 512 consecutive bytes.
#pragma unroll
  for (int j = 0; j < R; ++j) xs[base + j] = halve(acc[j] - s_first);
  __syncthreads();
  for (int i = threadIdx.x * 4; i < BO; i += THREADS * 4) {
    const long long k = start + i;
    if (vec && k + 3 < k_out) {
      typename Vec4<T>::type v;
      v.x = xs[i]; v.y = xs[i + 1]; v.z = xs[i + 2]; v.w = xs[i + 3];
      *reinterpret_cast<typename Vec4<T>::type*>(out + k) = v;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k + e < k_out) out[k + e] = xs[i + e];
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* sw, void* out, int L,
           int n, cudaStream_t s, int* shape) {
  const int k_out = L - n + 1;
  const int grid = (k_out + BO - 1) / BO;
  const int vec = (reinterpret_cast<uintptr_t>(x) |
                   reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  shape[0] = grid;
  shape[1] = BO;
  shape[2] = R;
  shape[3] = TC;
  sq_conv_kernel<T><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(sw), static_cast<T*>(out), L, n, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0 = float32, 1 = int32.  x (L,), w (n,) with 1 <= n <= L, sw (1,),
// out (L - n + 1,), all contiguous.  shape receives the launch: blocks,
// outputs a block, outputs a thread, taps a staged chunk.  Returns the
// cudaError_t of the launch.
extern "C" int fs_sq_conv(int dtype, const void* x, const void* w,
                          const void* sw, void* out, int L, int n,
                          void* stream, int* shape) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, sw, out, L, n, s, shape);
  if (dtype == 1) return launch<int>(x, w, sw, out, L, n, s, shape);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* fs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
