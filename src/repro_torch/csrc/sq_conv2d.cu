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
// taps.  The filters come as the (K, N) tap matrix, row-major, K ordered
// (i, j, c) as the Pallas kernel's (kh, kw, Cp, Np) tap block, and Sw as
// (N,).  The input is read in place, NCHW and unpadded: no im2col patch
// tensor and no padded copy exist.
//
// What bounds it on an H100: a square term is two FP32 issue slots (the
// add, then fma(s, s, acc)), and every input element feeds kh*kw*cout
// terms, so at CNN-layer sizes it is bound by FP32 issue, ~100x above its
// byte bound.  Next to it, shared memory: the squares' 16-byte operand
// reads take a large share of its wavefronts at full FP32 issue, and the
// gather and the copies compete with them for the rest (timed by
// scripts/conv_anatomy.py: each costs more than its instructions).  The
// design spends as few slots and wavefronts as it can outside the terms:
//
// - Output tile.  A block of 8 x 16 threads owns 64 pixels x 64 filters;
//   each thread an 8 x 4 register tile for its whole K walk.  The 64 pixels
//   are a run of a band of `tc` output columns, row-major over the images'
//   output rows stacked (B*oh rows): where tc divides 64 (tc = 8 on 56- and
//   112-wide layers) that is an 8 x 8 block of one image, and on narrow
//   layers (tc = ow = 14 or 7) a few whole rows, crossing into the next
//   image where the rows run out.
// - One input window per tile and channel slice, as the Pallas body loads
//   one window per output tile: for `cs` channels, the input rows and
//   columns the tile's pixels read under every tap, copied once into shared
//   memory by cp.async, with its zero fill (src-size 0) for padding, ragged
//   edges and rows past the last image, so no branch sits on the data path;
//   16-byte copies from an aligned column where W % 4 == 0, else 4-byte.
//   Each (b, oy) output row reads the stacked virtual rows b*hp + oy*sh + i
//   (hp = (oh-1)*sh + kh), so a tile's window is one contiguous range of
//   virtual rows.  All kh*kw taps are then read out of that window at fixed
//   offsets: nothing is fetched from global memory once per tap.
// - k-major staged operands.  The K walk goes slice by slice, and within a
//   slice over (tap, channel) in BK = 16-deep K tiles.  Each K tile's A
//   operand (16 taps x 64 pixels) is gathered from the window into a
//   k-major tile, and its 16 filter rows are copied from the tap matrix with
//   16-byte cp.async where aligned; the squares then read both as 16-byte
//   broadcasts (a warp is 4 pixel groups x 8 filter groups), 3 reads for
//   32 terms of a k step.
// - One barrier a K tile.  Three stages run at once: K tile t is squared
//   while tile t+1's A is gathered from its window (read into registers
//   before the squares, stored after them) and tile t+1's filters and tile
//   t+2's window (at a slice's first tile) are in flight.  Rings
//   of 2 A tiles, 2 filter tiles and 2 windows, and 3 slots of the K tile's
//   tap offsets, computed two tiles ahead; every copy is waited for with
//   cp.async.wait_group 0 before the tile's barrier.
// - The -x^2 correction is shared by every filter of the block: the thread
//   that gathers an element of A squares it once, so the work is O(M*K),
//   not O(M*K*N); a pixel's two partial sums are added in a fixed order in
//   the epilogue.
// - Launch plan: the band and the number of blocks each tile's K walk is
//   split over are the caller's (kernels/tuning.py; its model rule,
//   kernels/sq_conv2d.py::k7_launch_shape, takes the band from ow's
//   divisors and the split count that least loads the busiest SM, so a
//   split is taken only where a layer's tiles leave the SMs short of 3
//   blocks: ResNet-50's conv3_1, conv4_x, conv5_x).  launch_shape, below,
//   derives the rest (the pixels a tile, the channel slice that keeps the
//   window ring within WINDOW_BYTES) and each launch reports it.  Each split writes its partial tile to a workspace and the
//   last of a tile's splits to finish (a ticket counter) adds them in
//   split order 0, 1, ..., so the result does not depend on which block
//   finished last.
// - The epilogue passes the tile through shared memory, so that a warp
//   stores 32 consecutive pixels of one filter (output and split partials
//   alike), not 32 scattered words.
//
// The accumulators of split 0 start at Sw_f (the paper's register preload),
// each split subtracts its own share of Sx, and the final sum is halved:
// x0.5 on f32, an arithmetic >>1 on int32, exact because the total is even.
// A tap that falls in the padding reads x = 0 and still adds (0 + w)^2 =
// w^2, which cancels the -w^2 that Sw carries for it, so no term is
// skipped.  The only atomic is the ticket, which orders nothing that is
// summed: results do not depend on scheduling, so prepared and raw calls
// are bit-identical.
//
// Numerics: the accumulation is an explicit fmaf(s, s, acc), one rounding
// per term; the operand add a + b is rounded on its own, as in the Pallas
// body.  The int32 path is exact for int8/int16 operands widened to int32.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int THREADS = 128;       // 8 x 16 threads
constexpr int TM = 8;              // pixels a thread
constexpr int TN = 4;              // filters a thread
constexpr int BM = 8 * TM;         // 64 pixels a block
constexpr int BN = 16 * TN;        // 64 filters a block
constexpr int BK = 16;             // K depth of one staged K tile
constexpr int GR = BK * BM / THREADS;        // A rows a thread gathers
constexpr int FV = BK * BN / 4 / THREADS;    // 16-byte filter copies a thread
constexpr int MIN_BLOCKS = 4;      // __launch_bounds__: at most 128 registers
constexpr int CS_MAX = 16;         // channels a slice
constexpr int WINDOW_BYTES = 64 * 1024;     // the two windows of the ring
constexpr int MAX_SPLITS = 8;
constexpr int MAX_DEVICES = 64;

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

// 4 or 16 bytes global -> shared, zero-filled when !ok (src-size 0: nothing
// is read, and src is then any valid address).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The tile rule, computed on the host for every launch.
struct Shape {
  int tc;          // band width: output columns a tile row
  int bands;       // ceil(ow / tc)
  int pt;          // pixels a tile: BM, unless the window would not fit
  int runs;        // tiles a band: ceil(B*oh*tc / pt)
  int cs;          // channels a slice
  int tps;         // K tiles a slice: ceil(kh*kw*cs / BK)
  int k_tiles;     // K tiles of the whole walk: slices * tps
  int per_split;   // K tiles a split
  int splits;      // grid z
  int wr, wc;      // window rows and columns
  int smem;        // dynamic shared memory, bytes
};

inline int cdiv(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

// Rows and columns of the window of a run of pt pixels in a band of tc
// columns: the band rows it can span (all of them starting at a band row
// when tc divides pt), each image it crosses adding kh - sh virtual rows
// (none when whole runs tile every image's rows).  With 16-byte copies the
// window starts at the aligned column at or left of the band's first one,
// and its rows are whole 4-column chunks.
inline void window_extent(int pt, int tc, int oh, int kh, int kw, int sh,
                          int sv, int pw, bool vec, int* wr, int* wc) {
  const bool whole = pt % tc == 0;
  const int rows = whole ? pt / tc : (pt - 1) / tc + 2;
  const int cross = whole && oh % rows == 0 ? 0 : cdiv(rows - 1, oh);
  *wr = (rows - 1) * sh + kh + cross * (kh > sh ? kh - sh : 0);
  *wc = (tc - 1) * sv + kw;
  if (vec) {
    const int shift = tc * sv % 4 == 0 ? -pw & 3 : 3;
    *wc = (shift + *wc + 3) / 4 * 4;
  }
}

inline int smem_bytes(int cs, int wr, int wc, int elem) {
  // A and filter rings, the pixels' Sx partials, 3 slots of tap offsets
  // and filter rows, the window rows' sources (padded to 16 bytes), the
  // window ring
  return elem * (2 * BK * BM + 2 * BK * BN + 2 * BM) + 4 * (2 * 3 * BK) +
         4 * ((cs * wr + 3) / 4 * 4) + elem * 2 * cs * wr * wc;
}

// The launch of a plan: band tc (1..ow) and at most `splits` (1..MAX_SPLITS)
// blocks a tile's K walk; the split count is then the fewest that keep that
// many K tiles a split.
Shape launch_shape(int B, int C, int N, int kh, int kw, int sh, int sv,
                   int pw, int oh, int ow, int tc, int splits, int elem,
                   bool vec_x) {
  Shape s{};
  s.tc = tc;
  s.bands = cdiv(ow, s.tc);
  // A capacity guard, not a tier: only an output a few pixels wide under a
  // filter of hundreds of taps (each of its pixels then reads a window of
  // its own) needs fewer than BM pixels a tile for one channel's window
  // ring to fit WINDOW_BYTES.
  s.pt = BM;
  for (;;) {
    window_extent(s.pt, s.tc, oh, kh, kw, sh, sv, pw, vec_x, &s.wr, &s.wc);
    if (s.pt == 1 || 2LL * elem * s.wr * s.wc <= WINDOW_BYTES) break;
    s.pt /= 2;
  }
  s.runs = cdiv(static_cast<long long>(B) * oh * s.tc, s.pt);
  const long long fit = WINDOW_BYTES / (2LL * elem * s.wr * s.wc);
  s.cs = static_cast<int>(fit < 1 ? 1 : fit);
  if (s.cs > CS_MAX) s.cs = CS_MAX;
  if (s.cs > C) s.cs = C;
  s.tps = cdiv(static_cast<long long>(kh) * kw * s.cs, BK);
  s.k_tiles = cdiv(C, s.cs) * s.tps;
  s.per_split = cdiv(s.k_tiles, splits < s.k_tiles ? splits : s.k_tiles);
  s.splits = cdiv(s.k_tiles, s.per_split);
  s.smem = smem_bytes(s.cs, s.wr, s.wc, elem);
  return s;
}

template <typename T>
struct Params {
  const T* __restrict__ x;
  const T* __restrict__ w;
  const T* __restrict__ sw;
  T* __restrict__ out;
  T* __restrict__ partial;
  unsigned int* __restrict__ tickets;
  int B, C, H, W, N, kh, kw, sh, sv, ph, pw, oh, ow;
  int tc, bands, pt, cs, tps, k_tiles, per_split, wr, wc, hp;
  int vec_w;       // 16-byte filter copies
  int vec_x;       // 16-byte window copies
};

template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
sq_conv2d_kernel(const Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const as = reinterpret_cast<T*>(smem_raw);           // [2][BK][BM]
  T* const bs = as + 2 * BK * BM;                         // [2][BK][BN]
  T* const sx_part = bs + 2 * BK * BN;                    // [2][BM]
  int* const tap_w = reinterpret_cast<int*>(sx_part + 2 * BM);  // [3][BK]
  int* const tap_k = tap_w + 3 * BK;                      // [3][BK]
  int* const row_src = tap_k + 3 * BK;                    // [cs * wr]
  T* const win = reinterpret_cast<T*>(row_src + (p.cs * p.wr + 3) / 4 * 4);
  __shared__ bool last_split;

  const int tid = threadIdx.x;
  const int wsz = p.wr * p.wc;
  const int wslice = p.cs * wsz;
  const int kslice = p.kh * p.kw * p.cs;
  const int band = blockIdx.x % p.bands;
  const int q0 = (blockIdx.x / p.bands) * p.pt;   // first pixel of the run
  const int n0 = blockIdx.y * BN;
  const int t0 = blockIdx.z * p.per_split;
  const int t1 = min(p.k_tiles, t0 + p.per_split);
  const int s0 = t0 / p.tps;
  const int rows = p.B * p.oh;
  const int g0 = q0 / p.tc;
  const int vr0 = (g0 / p.oh) * p.hp + (g0 % p.oh) * p.sh;
  // The window's first input column: the band's first, or with 16-byte
  // copies the aligned column at or left of it (xoff to its right).
  const int ix_band = band * p.tc * p.sv - p.pw;
  const int xoff = p.vec_x ? ix_band & 3 : 0;
  const int ix0 = ix_band - xoff;

  // The input row behind each (channel, row) of a slice's window, from
  // the slice's first channel (-1: padding or past the batch).
  for (int rr = tid; rr < p.cs * p.wr; rr += THREADS) {
    const int c = rr / p.wr, r = rr - c * p.wr;
    const int vr = vr0 + r;
    const int b = vr / p.hp;
    const int iy = vr - b * p.hp - p.ph;
    row_src[rr] = b < p.B && iy >= 0 && iy < p.H ? ((b * p.C + c) * p.H + iy) * p.W : -1;
  }

  // Gather role: pixel gp (its window offset, 0 when it is past the edge)
  // and K rows GR gq .. GR gq + GR - 1 of every K tile.
  const int gp = tid % BM, gq = tid / BM;
  int gather_off = 0;
  {
    const int q = q0 + gp;
    const int g = q / p.tc, col = q - g * p.tc;
    if (gp < p.pt && g < rows && band * p.tc + col < p.ow) {
      const int vr = (g / p.oh) * p.hp + (g % p.oh) * p.sh;
      gather_off = (vr - vr0) * p.wc + xoff + col * p.sv;
    }
  }

  // The window offset and filter row of each k of K tile u (both -1 past
  // the slice's taps or its channels), into slot (u - t0) % 3: thread e < BK
  // keeps k = kk of the next tile to enter as (tap, i, j, c) and advances
  // it by BK a tile, back to k = e at a slice's end, without a division.
  int e_tap = 0, e_i = 0, e_j = 0, e_c = 0, e_kk = 0, e_s = 0;
  if (tid < BK) {
    e_kk = (t0 % p.tps) * BK + tid;
    e_s = s0;
    e_tap = e_kk / p.cs;
    e_c = e_kk - e_tap * p.cs;
    e_i = e_tap / p.kw;
    e_j = e_tap - e_i * p.kw;
  }
  int e_slot = 0;
  auto taps = [&](int u) {
    if (tid < BK && u < t1) {
      int tw = -1, tk = -1;
      if (e_kk < kslice && e_s * p.cs + e_c < p.C) {
        tw = e_c * wsz + e_i * p.wc + e_j;
        tk = e_tap * p.C + e_s * p.cs + e_c;
      }
      tap_w[e_slot + tid] = tw;
      tap_k[e_slot + tid] = tk;
      e_kk += BK;
      if (e_kk >= p.tps * BK) {             // the next slice
        e_kk = tid;
        ++e_s;
        e_tap = tid / p.cs;
        e_c = tid - e_tap * p.cs;
        e_i = e_tap / p.kw;
        e_j = e_tap - e_i * p.kw;
      } else {
        for (e_c += BK; e_c >= p.cs; e_c -= p.cs) {
          ++e_tap;
          if (++e_j == p.kw) { e_j = 0; ++e_i; }
        }
      }
    }
    e_slot = e_slot == 2 * BK ? 0 : e_slot + BK;
  };

  // Slice s's window into ring buffer wb: each thread copies one column
  // chunk (4 columns with 16-byte copies, else 1) of every srs-th window
  // row, zero-filled where the chunk lies in the padding (with 16-byte
  // copies W % 4 == 0, so a chunk is wholly in or out).
  const int vw = p.vec_x ? 4 : 1;
  const int chunks = p.wc / vw;
  const int srs = chunks <= THREADS ? THREADS / chunks : 1;
  const int ccs = chunks <= THREADS ? chunks : THREADS;
  const int sc0 = tid % ccs;
  const int sr0 = tid / ccs < srs ? tid / ccs : p.cs * p.wr;  // idle past srs rows
  auto stage_window = [&](int s, int wb) {
    T* dst = win + wb * wslice;
    const T* xs = p.x + static_cast<size_t>(s) * p.cs * p.H * p.W;
    const int rows_valid = min(p.cs, p.C - s * p.cs) * p.wr;
    for (int rr = sr0; rr < p.cs * p.wr; rr += srs) {
      const int src = rr < rows_valid ? row_src[rr] : -1;
      for (int cc = sc0; cc < chunks; cc += ccs) {
        const int ix = ix0 + cc * vw;
        const bool ok = src >= 0 && ix >= 0 && ix < p.W;
        if (p.vec_x)
          cp_async16(dst + rr * p.wc + cc * 4, ok ? xs + src + ix : p.x, ok);
        else
          cp_async4(dst + rr * p.wc + cc, ok ? xs + src + ix : p.x, ok);
      }
    }
  };

  // K tile u's 16 filter rows into ring buffer bb (zeros past the edges).
  auto stage_filters = [&](int slot, int bb) {
    const int* tk = tap_k + slot;
    T* dst = bs + bb * BK * BN;
    if (p.vec_w) {
#pragma unroll
      for (int h = 0; h < FV; ++h) {
        const int q = tid / (BN / 4) + THREADS / (BN / 4) * h;
        const int n = tid % (BN / 4) * 4;
        const int row = tk[q];
        const bool ok = row >= 0 && n0 + n < p.N;
        cp_async16(dst + q * BN + n,
                   ok ? p.w + static_cast<size_t>(row) * p.N + n0 + n : p.w, ok);
      }
    } else {
#pragma unroll
      for (int h = 0; h < 4 * FV; ++h) {
        const int q = tid / BN + THREADS / BN * h, n = tid % BN;
        const int row = tk[q];
        const bool ok = row >= 0 && n0 + n < p.N;
        cp_async4(dst + q * BN + n,
                  ok ? p.w + static_cast<size_t>(row) * p.N + n0 + n : p.w, ok);
      }
    }
  };

  // K tile u's A operand (k-major) from window buffer wb into ring buffer
  // ab; each gathered element squared once into this thread's Sx share.
  T sx = 0;
  T gv[GR];
  auto gather_load = [&](int slot, int wb) {
    const T* src = win + wb * wslice + gather_off;
    int tw[GR];
#pragma unroll
    for (int h = 0; h < GR; h += 4) load4(tap_w + slot + gq * GR + h, tw + h);
#pragma unroll
    for (int h = 0; h < GR; ++h) gv[h] = tw[h] >= 0 ? src[tw[h]] : T(0);
  };
  auto gather_store = [&](int ab) {
    T* dst = as + ab * BK * BM + gq * GR * BM + gp;
#pragma unroll
    for (int h = 0; h < GR; ++h) {
      dst[h * BM] = gv[h];
      sx = sq_accum(sx, gv[h]);
    }
  };

  // Compute roles: pixels ty*TM + i, filters tx*TN + j; a warp is 4 pixel
  // groups x 8 filter groups.  The accumulators start at Sw_f (split 0).
  const int lane = tid % 32, warp = tid / 32;
  const int ty = (warp / 2) * 4 + lane / 8;
  const int tx = (warp % 2) * 8 + lane % 8;
  T acc[TM][TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int f = n0 + tx * TN + j;
    const T s0v = f < p.N && blockIdx.z == 0 ? p.sw[f] : T(0);
#pragma unroll
    for (int i = 0; i < TM; ++i) acc[i][j] = s0v;
  }

  auto step = [&](const T* a_s, const T* b_s) {
    T a[TM], b[TN];
    load4(a_s, a);
    load4(a_s + 4, a + 4);
    load4(b_s, b);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = pm_accum(acc[i][j], a[i], b[j]);
  };
  auto square = [&](int ab, int bb, int klen) {
    const T* a_s = as + ab * BK * BM + ty * TM;
    const T* b_s = bs + bb * BK * BN + tx * TN;
    if (klen == BK) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) step(a_s + kk * BM, b_s + kk * BN);
    } else {
#pragma unroll 4
      for (int kk = 0; kk < klen; ++kk) step(a_s + kk * BM, b_s + kk * BN);
    }
  };

  // Tiles t, t+1, t+2 of the loop below, each as (slice, tile of the
  // slice), advanced without a division.
  int s_a = s0, ts_a = t0 - s0 * p.tps;
  auto next = [&](int& s, int& ts) {
    if (++ts == p.tps) { ts = 0; ++s; }
  };
  int s_b = s_a, ts_b = ts_a;
  next(s_b, ts_b);
  int s_c = s_b, ts_c = ts_b;
  next(s_c, ts_c);

  taps(t0);
  taps(t0 + 1);
  __syncthreads();
  stage_window(s0, 0);
  if (t0 + 1 < t1 && ts_b == 0) stage_window(s0 + 1, 1);
  stage_filters(0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  gather_load(0, 0);
  gather_store(0);
  __syncthreads();
  int slot = 0;                       // tap slot of tile t
  for (int t = t0; t < t1; ++t) {
    const int cur = (t - t0) & 1;
    const int slot_b = slot == 2 * BK ? 0 : slot + BK;
    taps(t + 2);
    if (t + 1 < t1) stage_filters(slot_b, cur ^ 1);
    if (t + 2 < t1 && ts_c == 0) stage_window(s_c, (s_c - s0) & 1);
    cp_async_commit();
    // the next tile's A: read from its window before the squares, stored
    // after them, so the reads' latency hides behind the squares
    const bool more = t + 1 < t1;
    if (more) gather_load(slot_b, (s_b - s0) & 1);
    square(cur, cur, min(BK, kslice - ts_a * BK));
    if (more) gather_store(cur ^ 1);
    cp_async_wait_all();
    __syncthreads();
    slot = slot_b;
    s_a = s_b; ts_a = ts_b;
    s_b = s_c; ts_b = ts_c;
    next(s_c, ts_c);
  }

  // This split's -Sx share, per pixel, its two partials in a fixed order.
  sx_part[gq * BM + gp] = sx;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const T s = sx_part[ty * TM + i] + sx_part[BM + ty * TM + i];
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] -= s;
  }
  // The tile goes through shared memory (the A and filter rings and the
  // Sx partials, all read by now), so that a warp then stores 32
  // consecutive pixels of one filter: thread (gp, gq) takes pixel gp of
  // filters gq + 2k.
  __syncthreads();
  T* const tile_s = as;                 // [BM][BN + 1]
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      tile_s[(ty * TM + i) * (BN + 1) + tx * TN + j] = acc[i][j];
  __syncthreads();
  T v[BN / 2];
#pragma unroll
  for (int k = 0; k < BN / 2; ++k) v[k] = tile_s[gp * (BN + 1) + gq + 2 * k];

  if (gridDim.z > 1) {
    // Publish this split's partial tile, then take a ticket; the block
    // that takes the last one adds every split's partial in split order.
    const size_t tile = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
    const size_t tiles = static_cast<size_t>(gridDim.x) * gridDim.y;
    auto part = [&](int z, int k) {
      return p.partial + ((z * tiles + tile) * BN + gq + 2 * k) * BM + gp;
    };
#pragma unroll
    for (int k = 0; k < BN / 2; ++k) *part(blockIdx.z, k) = v[k];
    __threadfence();
    __syncthreads();
    if (tid == 0)
      last_split = atomicAdd(&p.tickets[tile], 1u) == gridDim.z - 1;
    __syncthreads();
    if (!last_split) return;
    __threadfence();
#pragma unroll
    for (int k = 0; k < BN / 2; ++k) v[k] = __ldcg(part(0, k));
    for (int z = 1; z < static_cast<int>(gridDim.z); ++z)
#pragma unroll
      for (int k = 0; k < BN / 2; ++k) v[k] += __ldcg(part(z, k));
  }

  const int q = q0 + gp;
  const int g = q / p.tc, ox = band * p.tc + (q - g * p.tc);
  if (gp >= p.pt || g >= rows || ox >= p.ow) return;
  const int ohw = p.oh * p.ow;
  const int b = g / p.oh, oy = g - b * p.oh;
  T* o = p.out + static_cast<size_t>(b) * p.N * ohw + oy * p.ow + ox;
#pragma unroll
  for (int k = 0; k < BN / 2; ++k) {
    const int f = n0 + gq + 2 * k;
    if (f < p.N) o[static_cast<size_t>(f) * ohw] = halve(v[k]);
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* sw, void* out, int B,
           int C, int H, int W, int N, int kh, int kw, int sh, int sv, int ph,
           int pw, int oh, int ow, int tc, int splits, void* partial,
           long long partial_cap, void* tickets, long long tickets_cap,
           cudaStream_t stream, int* shape) {
  const bool vec_x = W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (tc < 1 || tc > ow || splits < 1 || splits > MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s = launch_shape(B, C, N, kh, kw, sh, sv, pw, oh, ow, tc, splits,
                               static_cast<int>(sizeof(T)), vec_x);
  const dim3 grid(s.bands * s.runs, (N + BN - 1) / BN, s.splits);
  shape[0] = static_cast<int>(grid.x);
  shape[1] = static_cast<int>(grid.y);
  shape[2] = static_cast<int>(grid.z);
  shape[3] = s.tc;
  shape[4] = s.cs;
  shape[5] = s.per_split;
  shape[6] = s.wr;
  shape[7] = s.wc;
  shape[8] = s.smem;
  shape[9] = s.k_tiles;
  shape[10] = s.pt;
  const long long tiles = static_cast<long long>(grid.x) * grid.y;
  if (s.splits > 1 && (partial_cap < tiles * s.splits * BM * BN ||
                       tickets_cap < tiles))
    return static_cast<int>(cudaErrorInvalidValue);

  auto kernel = sq_conv2d_kernel<T>;
  // The >48 KB opt-in is per device: set at a device's first launch to
  // the card's limit (less the kernel's static shared memory), so later
  // launches, captured ones too, make no call.
  static std::atomic<bool> set_on[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES || !set_on[dev].load()) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - static_cast<int>(attr.sharedSizeBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < MAX_DEVICES) set_on[dev].store(true);
  }

  Params<T> p;
  p.x = static_cast<const T*>(x);
  p.w = static_cast<const T*>(w);
  p.sw = static_cast<const T*>(sw);
  p.out = static_cast<T*>(out);
  p.partial = static_cast<T*>(partial);
  p.tickets = static_cast<unsigned int*>(tickets);
  p.B = B; p.C = C; p.H = H; p.W = W; p.N = N; p.kh = kh; p.kw = kw;
  p.sh = sh; p.sv = sv; p.ph = ph; p.pw = pw; p.oh = oh; p.ow = ow;
  p.tc = s.tc; p.bands = s.bands; p.pt = s.pt; p.cs = s.cs; p.tps = s.tps;
  p.k_tiles = s.k_tiles; p.per_split = s.per_split; p.wr = s.wr; p.wc = s.wc;
  p.hp = (oh - 1) * sh + kh;
  p.vec_w = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  p.vec_x = vec_x;
  kernel<<<grid, THREADS, s.smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype 0 = float32, 1 = int32.  x (B, C, H, W) contiguous and unpadded;
// w (kh*kw*C, N) row-major, K ordered (i, j, c); sw (N,); out (B, N, oh, ow).
// (ph, pw) are the leading pads; trailing pads follow from oh and ow.  tc
// (the band, 1..ow) and splits (1..8) are the caller's launch plan.  Where
// the launch splits the K walk, `partial` holds at least tiles * splits * 64 * 64
// elements of the dtype and `tickets` one zeroed counter a tile,
// capacities given in elements; both are left for
// the kernel alone while it runs.  shape receives the launch: grid x, y, z
// (pixel tiles, filter tiles, splits), band width, channel slice, K tiles a
// split, window rows, window columns, shared bytes, K tiles of the walk,
// pixels a tile.
// Returns the cudaError_t of the launch.
extern "C" int fs_sq_conv2d(int dtype, const void* x, const void* w,
                            const void* sw, void* out, int B, int C, int H,
                            int W, int N, int kh, int kw, int sh, int sv,
                            int ph, int pw, int oh, int ow, int tc,
                            int splits, void* partial, long long partial_cap,
                            void* tickets, long long tickets_cap,
                            void* stream, int* shape) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, sw, out, B, C, H, W, N, kh, kw, sh, sv, ph, pw,
                         oh, ow, tc, splits, partial, partial_cap, tickets,
                         tickets_cap, s, shape);
  if (dtype == 1)
    return launch<int>(x, w, sw, out, B, C, H, W, N, kh, kw, sh, sv, ph, pw,
                       oh, ow, tc, splits, partial, partial_cap, tickets, tickets_cap,
                       s, shape);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* fs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
