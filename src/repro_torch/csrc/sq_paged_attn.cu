// K4: decode attention over paged block tables through the square PM datapath
// (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/sq_paged_attn.py::sq_paged_attn_kernel (wrapper
// sq_paged_attn, reached from models/attention.py::_attn_paged_step).
//
// Per (sequence i, kv-head h), over the sequence's block table:
//   scores  s = 1/2 * (-sum q^2 - sum k^2 + sum_d (q_d + k_d)^2)   = q . k
//           optional softcap tanh(s / cap) * cap
//   mask    kv_pos < attend_limit, kv_pos <= q_pos, optional q_pos - kv_pos < window
//   softmax online (running max, normaliser, rescaled accumulator)
//   PV      1/2 * (-sum p^2 - sum v^2 + sum_t (p_t + v_t)^2)         = p . v
//   out     acc / max(l, 1e-30)
//
// What bounds it on an H100: bytes.  Each block reads its sequence's K and V
// blocks for one head once (nb * block_size * head_dim elements each, in the
// model dtype) plus their positions; the square work per element is a few
// instructions, far below the CUDA-core rate at decode's 1-8 query rows.
//
// Design:
// - One block per (sequence, kv-head).  The TPU kernel's sequential grid axis
//   over table columns becomes a loop inside the block, and the block reads its
//   own tables[i, c]; nothing is prefetched as a scalar operand.
// - K and V are read straight from the model-dtype (bf16) pool and widened to
//   f32 in registers on their way to shared memory; no f32 copy of the pool is
//   ever made.  bf16 -> f32 is exact, so the values equal the Pallas path's.
// - The running max, normaliser, rescale factor and output accumulator of every
//   query row live in shared memory for the whole table walk.
// - NEG_INF is -1e30, not -inf: a fully masked row (padding, q_pos = -1) keeps
//   m = -1e30, so exp(s - m) = 1 and the row ends as a finite uniform average,
//   the Pallas kernel's convention.  Null block 0 holds EMPTY_POS positions,
//   which fail kv_pos < attend_limit and mask to nothing.
// - A table entry outside [0, num_blocks) traps: it would read outside the pool.
//
// Numerics: nvcc's default -fmad=true is left on; the PM accumulations are
// explicit fmaf(s, s, acc).  expf and tanhf are the accurate library versions
// (no --use_fast_math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename KV_T>
__global__ void __launch_bounds__(THREADS)
sq_paged_attn_kernel(const float* __restrict__ q, const KV_T* __restrict__ k_pool,
                     const KV_T* __restrict__ v_pool, const int* __restrict__ tables,
                     const int* __restrict__ pos_pool, const int* __restrict__ q_pos,
                     float* __restrict__ out, int S, int KV, int G, int hd, int nb,
                     int bs, int num_blocks, int window, float softcap,
                     int attend_limit) {
  extern __shared__ float smem[];
  const int rows = S * G;
  float* qs = smem;                 // rows * hd   queries
  float* acc = qs + rows * hd;      // rows * hd   output accumulator
  float* ks = acc + rows * hd;      // bs * hd     current K block
  float* vs = ks + bs * hd;         // bs * hd     current V block
  float* sc = vs + bs * hd;         // rows * bs   scores, then probabilities
  float* m_run = sc + rows * bs;    // rows        running max
  float* l_run = m_run + rows;      // rows        running normaliser
  float* corr = l_run + rows;       // rows        this block's rescale factor
  float* sqq = corr + rows;         // rows        -sum q^2
  float* spp = sqq + rows;          // rows        -sum p^2 over this block
  float* skk = spp + rows;          // bs          -sum k^2
  float* svv = skk + bs;            // hd          -sum v^2 over this block
  int* kpos = reinterpret_cast<int*>(svv + hd);  // bs
  int* qp = kpos + bs;                            // rows

  const int h = blockIdx.x;
  const int i = blockIdx.y;
  const int tid = threadIdx.x;

  for (int e = tid; e < rows * hd; e += THREADS) {
    const int r = e / hd, d = e % hd;
    const int s = r / G, g = r % G;
    qs[e] = q[((((size_t)i * S + s) * KV + h) * G + g) * hd + d];
    acc[e] = 0.f;
  }
  for (int r = tid; r < rows; r += THREADS) {
    m_run[r] = NEG_INF;
    l_run[r] = 0.f;
    qp[r] = q_pos[(size_t)i * S + r / G];
  }
  __syncthreads();
  for (int r = tid; r < rows; r += THREADS) {
    float x = 0.f;
    for (int d = 0; d < hd; ++d) x = fmaf(qs[r * hd + d], qs[r * hd + d], x);
    sqq[r] = -x;
  }

  for (int c = 0; c < nb; ++c) {
    const int blk = tables[(size_t)i * nb + c];
    if (blk < 0 || blk >= num_blocks) __trap();
    __syncthreads();  // the previous block's readers of ks/vs/sc are done
    for (int e = tid; e < bs * hd; e += THREADS) {
      const int t = e / hd, d = e % hd;
      const size_t src = (((size_t)blk * bs + t) * KV + h) * hd + d;
      ks[e] = widen(k_pool[src]);
      vs[e] = widen(v_pool[src]);
    }
    for (int t = tid; t < bs; t += THREADS) kpos[t] = pos_pool[(size_t)blk * bs + t];
    __syncthreads();
    for (int t = tid; t < bs; t += THREADS) {
      float x = 0.f;
      for (int d = 0; d < hd; ++d) x = fmaf(ks[t * hd + d], ks[t * hd + d], x);
      skk[t] = -x;
    }
    for (int d = tid; d < hd; d += THREADS) {
      float x = 0.f;
      for (int t = 0; t < bs; ++t) x = fmaf(vs[t * hd + d], vs[t * hd + d], x);
      svv[d] = -x;
    }
    __syncthreads();

    // scores: 2 (q . k) accumulated as squares on the correction preload
    for (int e = tid; e < rows * bs; e += THREADS) {
      const int r = e / bs, t = e % bs;
      float x = sqq[r] + skk[t];
      for (int d = 0; d < hd; ++d) {
        const float s = qs[r * hd + d] + ks[t * hd + d];
        x = fmaf(s, s, x);
      }
      float s = 0.5f * x;
      if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      const int kp = kpos[t], qq = qp[r];
      const bool ok = kp < attend_limit && kp <= qq && (window <= 0 || qq - kp < window);
      sc[e] = ok ? s : NEG_INF;
    }
    __syncthreads();

    // online softmax, one thread per query row
    for (int r = tid; r < rows; r += THREADS) {
      const float m_prev = m_run[r];
      float m_new = m_prev;
      for (int t = 0; t < bs; ++t) m_new = fmaxf(m_new, sc[r * bs + t]);
      float l = 0.f, pp = 0.f;
      for (int t = 0; t < bs; ++t) {
        const float p = expf(sc[r * bs + t] - m_new);
        sc[r * bs + t] = p;
        l += p;
        pp = fmaf(p, p, pp);
      }
      const float cr = expf(m_prev - m_new);
      l_run[r] = l_run[r] * cr + l;
      m_run[r] = m_new;
      corr[r] = cr;
      spp[r] = -pp;
    }
    __syncthreads();

    // PV: 2 (p . v) over the block's tokens, same PM form
    for (int e = tid; e < rows * hd; e += THREADS) {
      const int r = e / hd, d = e % hd;
      float x = spp[r] + svv[d];
      for (int t = 0; t < bs; ++t) {
        const float s = sc[r * bs + t] + vs[t * hd + d];
        x = fmaf(s, s, x);
      }
      acc[e] = acc[e] * corr[r] + 0.5f * x;
    }
  }
  __syncthreads();

  for (int e = tid; e < rows * hd; e += THREADS) {
    const int r = e / hd, d = e % hd;
    const int s = r / G, g = r % G;
    out[((((size_t)i * S + s) * KV + h) * G + g) * hd + d] = acc[e] / fmaxf(l_run[r], 1e-30f);
  }
}

template <typename KV_T>
int launch(const float* q, const void* k_pool, const void* v_pool, const int* tables,
           const int* pos_pool, const int* q_pos, float* out, int B, int S, int KV,
           int G, int hd, int nb, int bs, int num_blocks, int window, float softcap,
           int attend_limit, int smem_bytes, cudaStream_t stream) {
  auto kernel = sq_paged_attn_kernel<KV_T>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(KV, B);
  kernel<<<grid, THREADS, smem_bytes, stream>>>(
      q, static_cast<const KV_T*>(k_pool), static_cast<const KV_T*>(v_pool), tables,
      pos_pool, q_pos, out, S, KV, G, hd, nb, bs, num_blocks, window, softcap,
      attend_limit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kv_dtype: 0 = float32, 1 = bfloat16 (the pools' dtype).
// q and out (B, S, KV, G, hd) float32; pools (num_blocks * bs, KV, hd);
// tables (B, nb), pos_pool (num_blocks * bs,), q_pos (B, S) int32; all
// contiguous.  window <= 0 means no sliding window, softcap <= 0 no softcap.
// smem_bytes is the dynamic shared memory the wrapper sized for these shapes.
// Returns the cudaError_t of the launch.
extern "C" int fs_sq_paged_attn(int kv_dtype, const float* q, const void* k_pool,
                                const void* v_pool, const int* tables,
                                const int* pos_pool, const int* q_pos, float* out,
                                int B, int S, int KV, int G, int hd, int nb, int bs,
                                int num_blocks, int window, float softcap,
                                int attend_limit, int smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == 0)
    return launch<float>(q, k_pool, v_pool, tables, pos_pool, q_pos, out, B, S, KV, G,
                         hd, nb, bs, num_blocks, window, softcap, attend_limit,
                         smem_bytes, s);
  if (kv_dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, pos_pool, q_pos, out, B, S,
                                 KV, G, hd, nb, bs, num_blocks, window, softcap,
                                 attend_limit, smem_bytes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* fs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
