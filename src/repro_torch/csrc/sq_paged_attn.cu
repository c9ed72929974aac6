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
// What bounds it on an H100: bytes, and at decode sizes latency.  Each
// (sequence, kv-head) reads its K and V blocks once (nb * block_size * head_dim
// elements each, in the model dtype) plus their positions; the square work per
// element is a few instructions.  At the serving decode shape (8 sequences,
// 12 kv-heads, 8 table blocks of 16 tokens) that is 3 MB in all, so what a
// launch costs is the length of its dependent chain of loads and reductions.
//
// Design (a split-KV schedule over thread-block clusters):
// - The grid is (KV, B, splits).  Split s of (i, h) walks a contiguous range of
//   table columns, [s * nb / splits, (s + 1) * nb / splits), with the online
//   softmax recurrence of the TPU kernel's sequential grid axis.  The wrapper
//   picks splits (at most 8, the portable cluster size, and at most nb) so the
//   card holds several blocks per SM: at the decode shape, 8 splits of one
//   table block each, 768 one-warp blocks.
// - The splits of one (i, h) form one cluster.  Each leaves its (m, l, acc) --
//   local max, normaliser and PM-form accumulator, with its own -sum p^2 /
//   -sum v^2 corrections -- in shared memory.  After cluster.sync() every split
//   reads all of them through distributed shared memory (map_shared_rank),
//   rescales split s by exp(m_s - M), sums in split order 0, 1, ... and writes
//   its share of the output elements.  Every element is combined in that one
//   order, so the result does not depend on scheduling; no workspace, ticket,
//   memset or second launch is needed.  The remote loads of each round are
//   issued together, so a round costs one remote latency.
// - A split reads its table entries once, then copies K blocks, V blocks and
//   positions into shared memory with 16-byte cp.async (8 bf16 or 4 f32 a
//   copy), NS = 3 stages deep: two table blocks are in flight while one is
//   scored.  They stay in the pool's dtype there (K rows padded by 32 bytes
//   against bank conflicts) and are widened to f32 in registers (bf16 -> f32
//   is exact).
// - A block is min(4, rows) warps and each warp owns query rows, so a table
//   block costs one __syncthreads (its copies have landed; the previous stage
//   is free) and the rest is warp-synchronous.  Scores: a group of lanes owns
//   one token (2 lanes at 16-token blocks); each lane takes its share of
//   head_dim in 16-byte chunks, accumulates sum (q_d + k_d)^2 and sum k_d^2
//   in one pass, and the group finishes both with __shfl_xor reductions.
//   Softmax: the max, sum p and sum p^2 of the row are warp reductions.  PV:
//   lanes own dimensions and accumulate sum_t (p_t + v_td)^2 and
//   sum_t v_td^2 in one pass.
// - NEG_INF is -1e30, not -inf: a fully masked row (padding, q_pos = -1) keeps
//   m = -1e30 in every split, so every exp factor is 1 and the row ends as a
//   finite uniform average over the whole table, the null block included (the
//   Pallas kernel's convention).  A split whose tokens are all masked keeps
//   m = -1e30 and drops out of the combine wherever another split saw a real
//   score, since exp(-1e30 - M) = 0.  Null block 0 holds EMPTY_POS positions,
//   which fail kv_pos < attend_limit.
// - A table entry outside [0, num_blocks) traps: it would read outside the pool.
// - Needs head_dim % 8 == 0 and 16-byte aligned pools (the wrapper checks), and
//   a cluster launch: sm_90 or later.
//
// Numerics: nvcc's default -fmad=true is left on; the PM accumulations are
// explicit fmaf(s, s, acc).  expf and tanhf are the accurate library versions
// (no --use_fast_math).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_WARPS = 4;            // a block is min(4, rows) warps
constexpr int NS = 3;                   // K/V copy stages (table blocks in flight)
constexpr int CHUNK = 8;                // elements a lane widens at a time
constexpr int MAX_SPLITS = 8;           // the portable cluster size
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {  // all but the N newest groups
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// 8 consecutive pool elements in shared memory, widened to f32.
__device__ __forceinline__ void widen8(const float* p, float (&x)[CHUNK]) {
  const float4 lo = reinterpret_cast<const float4*>(p)[0];
  const float4 hi = reinterpret_cast<const float4*>(p)[1];
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}

__device__ __forceinline__ void widen8(const __nv_bfloat16* p, float (&x)[CHUNK]) {
  // one 16-byte load; each 32-bit word holds two bf16, element 2j in the low half
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[2 * j] = __uint_as_float(w[j] << 16);
    x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

template <typename KV_T>
__global__ void __launch_bounds__(32 * MAX_WARPS)
sq_paged_attn_kernel(const float* __restrict__ q, const KV_T* __restrict__ k_pool,
                     const KV_T* __restrict__ v_pool, const int* __restrict__ tables,
                     const int* __restrict__ pos_pool, const int* __restrict__ q_pos,
                     float* __restrict__ out, int S, int KV, int G, int hd, int nb,
                     int bs, int num_blocks, int window, float softcap,
                     int attend_limit) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = S * G;
  const int h = blockIdx.x;
  const int i = blockIdx.y;
  const int split = blockIdx.z;     // == this block's rank in its cluster
  const int splits = gridDim.z;
  const int nt = blockDim.x, warps = nt / 32;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int c_lo = split * nb / splits;
  const int c_hi = (split + 1) * nb / splits;

  // K rows are padded by 32 bytes in shared memory, so the lanes reading 16
  // bytes each of several tokens' rows hit different banks.
  const int krow = hd + 32 / static_cast<int>(sizeof(KV_T));
  const size_t blk_elems = static_cast<size_t>(bs) * (krow + hd);
  KV_T* kv_st = reinterpret_cast<KV_T*>(smem);  // NS x (K block, V block), pool dtype
  auto kst = [&](int st) { return kv_st + st * blk_elems; };
  auto vst = [&](int st) { return kst(st) + static_cast<size_t>(bs) * krow; };
  float* qs = reinterpret_cast<float*>(kv_st + NS * blk_elems);  // rows * hd  queries
  float* acc = qs + rows * hd;      // rows * hd   PM-form output accumulator
  float* sc = acc + rows * hd;      // rows * bs   scores, then probabilities
  float* m_run = sc + rows * bs;    // rows        running max
  float* l_run = m_run + rows;      // rows        running normaliser
  float* sqq = l_run + rows;        // rows        -sum q^2
  float* lnorm = sqq + rows;        // rows        the cluster's max(l, 1e-30)
  float* fac = lnorm + rows;        // MAX_SPLITS * rows  exp(m_s - M)
  int* qp = reinterpret_cast<int*>(fac + MAX_SPLITS * rows);  // rows
  int* kpos0 = qp + rows;           // NS * bs     positions, NS stages
  auto kpos = [&](int st) { return kpos0 + st * bs; };
  int* blks = kpos0 + NS * bs;      // c_hi - c_lo  this split's table entries

  // This split's table entries, read once, so a copy waits on no table load.
  for (int c = c_lo + tid; c < c_hi; c += nt) {
    const int blk = tables[static_cast<size_t>(i) * nb + c];
    if (blk < 0 || blk >= num_blocks) __trap();
    blks[c - c_lo] = blk;
  }
  __syncthreads();

  // Copy table column c's K block, V block and positions into stage st.
  const size_t tok_stride = static_cast<size_t>(KV) * hd;    // pool elements per token
  const int pieces = hd * static_cast<int>(sizeof(KV_T)) / 16;  // 16 B copies per row
  // (token, piece) of this thread's first copy, and the step between copies:
  // no division inside the copy loop
  const int t_first = tid / pieces, pc_first = tid % pieces;
  const int t_step = nt / pieces, pc_step = nt % pieces;
  auto issue = [&](int c, int st) {
    const int blk = blks[c - c_lo];
    const size_t base = (static_cast<size_t>(blk) * bs * KV + h) * hd;
    for (int t = t_first, pc = pc_first; t < bs;) {
      const size_t src = base + t * tok_stride;
      cp_async16(reinterpret_cast<char*>(kst(st) + t * krow) + pc * 16,
                 reinterpret_cast<const char*>(k_pool + src) + pc * 16);
      cp_async16(reinterpret_cast<char*>(vst(st) + t * hd) + pc * 16,
                 reinterpret_cast<const char*>(v_pool + src) + pc * 16);
      t += t_step;
      pc += pc_step;
      if (pc >= pieces) {
        pc -= pieces;
        ++t;
      }
    }
    for (int t = tid; t < bs; t += nt)
      cp_async4(kpos(st) + t, pos_pool + static_cast<size_t>(blk) * bs + t);
  };
#pragma unroll
  for (int st = 0; st < NS - 1; ++st) {
    if (c_lo + st < c_hi) issue(c_lo + st, st);
    cp_async_commit();
  }

  // Each warp owns query rows warp, warp + warps, ...: their queries,
  // -sum q^2, running state and accumulator are touched by no other warp.
  for (int r = warp; r < rows; r += warps) {
    const int s = r / G, g = r % G;
    const float* qr = q + ((((size_t)i * S + s) * KV + h) * G + g) * hd;
    float x = 0.f;
    for (int d = lane; d < hd; d += 32) {
      const float v = qr[d];
      qs[r * hd + d] = v;
      acc[r * hd + d] = 0.f;
      x = fmaf(v, v, x);
    }
    x = warp_sum(x);
    if (lane == 0) {
      sqq[r] = -x;
      m_run[r] = NEG_INF;
      l_run[r] = 0.f;
      qp[r] = q_pos[(size_t)i * S + s];
    }
  }

  // Scores: P tokens a pass, lpt lanes a token (P the power of two at or above
  // min(bs, 32)).
  int P = 1;
  while (P < bs && P < 32) P <<= 1;
  const int lpt = 32 / P;
  const int gl = lane % lpt;
  const int chunks = hd / CHUNK;
  for (int c = c_lo; c < c_hi; ++c) {
    const int st = (c - c_lo) % NS;
    cp_async_wait<NS - 2>();        // column c's copies have landed ...
    __syncthreads();                // ... for every thread; column c-1's stage is free
    if (c + NS - 1 < c_hi) issue(c + NS - 1, (c - c_lo + NS - 1) % NS);
    cp_async_commit();

    const KV_T* ks = kst(st);
    const KV_T* vs = vst(st);
    const int* kp = kpos(st);
    for (int r = warp; r < rows; r += warps) {
      const float* qr = qs + r * hd;
      float* sr = sc + r * bs;
      // scores: 2 (q . k) as squares on the -sum q^2 - sum k^2 correction
      for (int t0 = 0; t0 < bs; t0 += P) {
        const int t = t0 + lane / lpt;
        const bool live = t < bs;
        float pm = 0.f, kk = 0.f;
        if (live) {
          for (int ch = gl; ch < chunks; ch += lpt) {
            float kx[CHUNK];
            widen8(ks + t * krow + ch * CHUNK, kx);
            const float4 q0 = reinterpret_cast<const float4*>(qr + ch * CHUNK)[0];
            const float4 q1 = reinterpret_cast<const float4*>(qr + ch * CHUNK)[1];
            const float qx[CHUNK] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
            for (int j = 0; j < CHUNK; ++j) {
              const float sj = qx[j] + kx[j];
              pm = fmaf(sj, sj, pm);
              kk = fmaf(kx[j], kx[j], kk);
            }
          }
        }
        for (int o = lpt / 2; o > 0; o >>= 1) {
          pm += __shfl_xor_sync(FULL, pm, o);
          kk += __shfl_xor_sync(FULL, kk, o);
        }
        if (live && gl == 0) {
          float sv = 0.5f * ((pm - kk) + sqq[r]);
          if (softcap > 0.f) sv = tanhf(sv / softcap) * softcap;
          const int kpt = kp[t], qq = qp[r];
          const bool ok = kpt < attend_limit && kpt <= qq &&
                          (window <= 0 || qq - kpt < window);
          sr[t] = ok ? sv : NEG_INF;
        }
      }
      __syncwarp();

      // online softmax: the max, sum p and sum p^2 are warp reductions
      const float m_prev = m_run[r];
      float m_new = m_prev;
      for (int t = lane; t < bs; t += 32) m_new = fmaxf(m_new, sr[t]);
      m_new = warp_max(m_new);
      float l = 0.f, pp = 0.f;
      for (int t = lane; t < bs; t += 32) {
        const float pv = expf(sr[t] - m_new);
        sr[t] = pv;
        l += pv;
        pp = fmaf(pv, pv, pp);
      }
      l = warp_sum(l);
      pp = warp_sum(pp);
      const float cr = expf(m_prev - m_new);
      __syncwarp();
      if (lane == 0) {
        l_run[r] = l_run[r] * cr + l;
        m_run[r] = m_new;
      }

      // PV: 2 (p . v) over the block's tokens, same PM form; lanes own dims
      float* ar = acc + r * hd;
      for (int d = lane; d < hd; d += 32) {
        float x = 0.f, vv = 0.f;
        for (int t = 0; t < bs; ++t) {
          const float v = widen(vs[t * hd + d]);
          const float sv = sr[t] + v;
          x = fmaf(sv, sv, x);
          vv = fmaf(v, v, vv);
        }
        ar[d] = ar[d] * cr + 0.5f * ((x - vv) - pp);
      }
    }
  }

  // Combine the splits of (i, h) in split order through distributed shared
  // memory; split s writes output elements s*nt + tid + k*splits*nt.
  // Each round's remote loads are issued together (a fixed-size unrolled
  // loop), so a round costs one remote latency, not one per split.
  cluster.sync();
  for (int r = tid; r < rows; r += nt) {
    float ms[MAX_SPLITS], ls[MAX_SPLITS];
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) {
      ms[s] = s < splits ? *cluster.map_shared_rank(m_run + r, s) : NEG_INF;
      ls[s] = s < splits ? *cluster.map_shared_rank(l_run + r, s) : 0.f;
    }
    float m_all = ms[0];
#pragma unroll
    for (int s = 1; s < MAX_SPLITS; ++s) m_all = fmaxf(m_all, ms[s]);
    float l = 0.f;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) {
      if (s < splits) {
        const float f = expf(ms[s] - m_all);
        fac[s * rows + r] = f;
        l += ls[s] * f;
      }
    }
    lnorm[r] = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  for (int e = split * nt + tid; e < rows * hd; e += splits * nt) {
    const int r = e / hd, d = e % hd;
    float xs[MAX_SPLITS];
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s)
      xs[s] = s < splits ? *cluster.map_shared_rank(acc + e, s) : 0.f;
    float x = 0.f;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s)
      if (s < splits) x += xs[s] * fac[s * rows + r];
    const int sq = r / G, g = r % G;
    out[((((size_t)i * S + sq) * KV + h) * G + g) * hd + d] = x / lnorm[r];
  }
  cluster.sync();                   // no split leaves while another reads it
}

template <typename KV_T>
int launch(const float* q, const void* k_pool, const void* v_pool, const int* tables,
           const int* pos_pool, const int* q_pos, float* out, int B, int S, int KV,
           int G, int hd, int nb, int bs, int num_blocks, int window, float softcap,
           int attend_limit, int splits, int smem_bytes, cudaStream_t stream) {
  if (splits < 1 || splits > MAX_SPLITS || hd % CHUNK)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = sq_paged_attn_kernel<KV_T>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(KV, B, splits);
  cfg.blockDim = dim3(32 * std::min(MAX_WARPS, S * G));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, q, static_cast<const KV_T*>(k_pool), static_cast<const KV_T*>(v_pool),
      tables, pos_pool, q_pos, out, S, KV, G, hd, nb, bs, num_blocks, window, softcap,
      attend_limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kv_dtype: 0 = float32, 1 = bfloat16 (the pools' dtype).
// q and out (B, S, KV, G, hd) float32; pools (num_blocks * bs, KV, hd), 16-byte
// aligned, hd % 8 == 0; tables (B, nb), pos_pool (num_blocks * bs,), q_pos
// (B, S) int32; all contiguous.  window <= 0 means no sliding window, softcap
// <= 0 no softcap.  splits (1..8, at most nb) is the cluster size along the
// table; smem_bytes is the dynamic shared memory the wrapper sized for these
// shapes.  Returns the cudaError_t of the launch.
extern "C" int fs_sq_paged_attn(int kv_dtype, const float* q, const void* k_pool,
                                const void* v_pool, const int* tables,
                                const int* pos_pool, const int* q_pos, float* out,
                                int B, int S, int KV, int G, int hd, int nb, int bs,
                                int num_blocks, int window, float softcap,
                                int attend_limit, int splits, int smem_bytes,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == 0)
    return launch<float>(q, k_pool, v_pool, tables, pos_pool, q_pos, out, B, S, KV, G,
                         hd, nb, bs, num_blocks, window, softcap, attend_limit,
                         splits, smem_bytes, s);
  if (kv_dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, pos_pool, q_pos, out, B, S,
                                 KV, G, hd, nb, bs, num_blocks, window, softcap,
                                 attend_limit, splits, smem_bytes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* fs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
