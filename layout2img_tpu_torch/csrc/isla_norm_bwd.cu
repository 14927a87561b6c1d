// Fused ISLA norm backward for Hopper (sm_90a): two launches per call.
//
// The gradient of the whole pass that isla_norm.cu computes forward (the BN apply with
// given statistics, the bilinear resize of the stage mask, the mask-weighted per-object
// affine and the optional ReLU). It replaces the backward of the JAX package's Pallas
// kernel ops/pallas/isla.py::isla_modulate (_bwd, einsums under jax.custom_vjp, lines
// 103-128 in the tree of commit d0260d0^) together with the backward passes of the BN,
// the resize and the ReLU around it. For batch b, channel c and pixel p, with
// r = 1 / sqrt(var_c + eps), y = (x - mean_c) r, m_o the resized mask, d = sum_o m_o + 1e-6,
// G = sum_o m_o gamma_oc, B = sum_o m_o beta_oc and out = y (G/d + 1) + B/d, the main kernel
// takes the output gradient g (g' = g [out > 0] with the ReLU) and writes:
//
//   dx_direct = g' (G/d + 1) r                          (B, C, H, W), T
//   per (b, span, c): sum_p a and sum_p a y, a = g' (G/d + 1)
//   per (b, span, o, c): sum_p (m_o/d) g' y and sum_p (m_o/d) g'   (dgamma, dbeta)
//   per (group, b, o, p): (U_o - sum_o' (m_o'/d) U_o') / d,
//                     U_o = sum_c g' y gamma_oc + g' beta_oc      (dm of the resized mask)
//
// and the finishing kernel (below) turns those partial buffers into dmean = -r sum a,
// dvar = -r^2 sum a y / 2, dgamma, dbeta and the source mask's gradient (the group sum of
// dm through the transposed resize, as a gather). Every sum runs in a fixed order and
// nothing is atomic, so a call gives the same bits on every run.
//
// What bounds it: bytes on the main path. Per element of x it reads x and g and writes
// dx (12 bytes in f32) against 4 flops per live object for G and B, 4 per live object for
// dgamma and dbeta, and 4 per object slot (live or not: a pad object's mask gradient is
// not zero) for U. At o = 31 slots and about one live object per pixel that is some 130
// flops per 12 bytes, under the H100's f32 balance point of 20 flops per byte
// (chip_smoke.py::isla_bwd_cost counts both). What held the first version (one 128-thread
// block of 50-87 KB, 2-4 per SM) at 13% of that bound was latency: few warps in flight,
// scalar loads issued only when a chunk began, serial per-tile work. The design:
//
// * Grid: one CTA per (span of pixel tiles, channel group, batch). A tile is tp pixels of
//   the flattened h*w axis (16, 32 or 64) and a chunk is cc = 8 * threads / tp channels:
//   each thread owns 4 pixels x 2 channels. Blocks are 256 threads and hold at most 56 KB
//   of shared memory at o = 31 (ops/isla.py::backward_config picks the channel groups for
//   that), so four blocks, 32 warps, stay resident on an SM; where the map is tiny (h = 4)
//   blocks shrink to 64 threads and 32 channels so that the grid still has two per SM.
// * Loads in flight: each thread loads its 4 pixels x 2 channels of x and g with 8- or
//   16-byte loads into registers one chunk ahead (the next chunk, or the next tile's
//   first), so they land while the current chunk's contractions run. (Two shared stages
//   of x and g, as the forward streams them with cp.async, would cost 32 KB per block and
//   halve the resident blocks.) dx is stored 16 bytes (f32) or 8 bytes (bf16) at a time
//   where h*w is a multiple of 4.
// * Per tile, the (o, tp) resized mask is rebuilt in shared memory from the source mask
//   (the forward's taps and weights; each thread keeps one pixel's taps and walks objects),
//   its per-pixel sums give 1/d, and a warp vote (__reduce_or_sync over 64-bit words) gives
//   the objects that are non-zero on the tile; the live list is built by 64 threads at
//   once from the popcounts of that word. Objects that are zero on the whole tile drop out
//   of the G, B, dgamma and dbeta work. Nothing of the forward is stored: out and its sign
//   are recomputed.
// * Per chunk: gamma and beta of every object as f32 in shared memory, transposed to
//   [channel][object] so that U reads 4 objects as one 16-byte word; the elementwise pass
//   writes dx and stages g' y and g' in shared memory (rows padded by 4 words: 16-byte
//   aligned, and the 16-byte pieces a warp reads from consecutive rows at one pixel quad
//   fall on distinct banks). Then dgamma and dbeta of the live objects, 4 objects x 1
//   channel per thread from registers (the pixel quads split over up to 16 lanes where
//   the live objects are few, shuffled together in a fixed pattern, accumulated over the
//   span in shared memory), and U of every slot: each thread owns 4 objects x 4 pixels of
//   U in registers over the group's chunks, and when the 4 x 4 blocks number fewer than
//   the threads, the channels are split between ksplit threads whose partial U are summed
//   in slice order.
// * The host picks the tiling from the slot count rounded up to 8, 32 or 64, not from the
//   object count, so pad slots within that bucket change no bit of the other gradients.
// * Every sum has one owner per step and a fixed order (warp shuffles in a fixed
//   pattern, one thread per shared accumulator), and there are no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "isla_common.cuh"

namespace {

constexpr int kThreads = 256;  // most threads per block; 64 or 128 for tiny maps
constexpr int kMinBlocks = 4;  // blocks per SM the register budget is cut for (32 warps)
constexpr int kMaxWarps = kThreads / 32;
constexpr int kMaskBatch = 4;  // objects whose source taps one thread loads at once
constexpr int kGammaBatch = 4;  // gamma and beta elements one thread loads at once

struct Params {
  const void* x;       // (B, C, H, W), T
  const float* mean;   // (C,)
  const float* var;    // (C,)
  const void* mask;    // (B, O, HS, WS), T
  const void* gamma;   // (B, O, C), T
  const void* beta;    // (B, O, C), T
  const void* grad;    // (B, C, H, W), T: gradient of the output
  void* dx;            // (B, C, H, W), T: g' (G/d + 1) r
  float* part_stats;   // (B, n_spans, 2, C)
  float* part_gb;      // (B, n_spans, 2, O, C)
  float* part_dm;      // (n_groups, B, O, H, W)
  int B, C, P, W, O, O4, HS, WS;
  int row0;            // x holds image rows [row0, row0 + H) (a row shard's window)
  float scale_y, scale_x, eps;
  int relu;
  int threads, tp, tp_log2, cc;
  int n_tiles, tiles_per_span, n_spans;
  int n_groups, chunks_per_group, cg;  // cg = chunks_per_group * cc
  int units, ksplit;  // U: (O4 / 4) * (tp / 4) blocks of 4 x 4, each split over ksplit threads
};

// 4-byte words of shared memory one block uses (ops/isla.py::_bwd_smem_bytes mirrors it):
// the two gradient stages, gamma and beta transposed, the mask tile, 1/d, sum_o (m_o/d) U_o,
// the per-thread mask sums, the warps' live words, the live list, the span's per-channel
// and per-object sums.
__host__ __device__ inline int smem_words(int O, int O4, int tp, int cc, int cg, int threads) {
  return 2 * cc * (tp + 4) + 2 * cc * (O4 + 4) + O * tp + 2 * tp + threads + 16 + 64 + 2 * cg +
         2 * O * cg;
}

// Four consecutive elements of x or g, as loaded: f32 or bf16 bits, converted when used.
template <typename T>
struct Quad;
template <>
struct Quad<float> {
  float4 v;
  __device__ __forceinline__ void zero() { v = make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
  __device__ __forceinline__ void load(const float* p) { v = __ldg(reinterpret_cast<const float4*>(p)); }
  __device__ __forceinline__ void load_each(const float* p, int n) {
    v.x = n > 0 ? __ldg(p) : 0.0f;
    v.y = n > 1 ? __ldg(p + 1) : 0.0f;
    v.z = n > 2 ? __ldg(p + 2) : 0.0f;
    v.w = n > 3 ? __ldg(p + 3) : 0.0f;
  }
  __device__ __forceinline__ void get(float f[4]) const { f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w; }
};
template <>
struct Quad<__nv_bfloat16> {
  uint2 v;
  __device__ __forceinline__ void zero() { v = make_uint2(0u, 0u); }
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ void load_each(const __nv_bfloat16* p, int n) {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    unsigned e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = i < n ? __ldg(q + i) : 0u;
    v = make_uint2(e[0] | (e[1] << 16), e[2] | (e[3] << 16));
  }
  __device__ __forceinline__ void get(float f[4]) const {
    f[0] = __uint_as_float(v.x << 16); f[1] = __uint_as_float(v.x & 0xffff0000u);
    f[2] = __uint_as_float(v.y << 16); f[3] = __uint_as_float(v.y & 0xffff0000u);
  }
};

// This thread's 4 pixels [px, px + 4) x 2 channels [c, c + 2) of x and g, zeros outside, and
// the two channels' mean and variance (0 and 1 outside).
template <typename T, bool kAligned>
__device__ __forceinline__ void load_xg(const Params& p, int b, int c, int px, Quad<T> xq[2],
                                        Quad<T> gq[2], float stats[2][2]) {
  const T* x = static_cast<const T*>(p.x);
  const T* g = static_cast<const T*>(p.grad);
  const int n = min(4, p.P - px);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const size_t idx = (static_cast<size_t>(b) * p.C + c + j) * p.P + px;
    const bool c_ok = c + j < p.C;
    stats[j][0] = c_ok ? __ldg(p.mean + c + j) : 0.0f;
    stats[j][1] = c_ok ? __ldg(p.var + c + j) : 1.0f;
    if (!c_ok || n <= 0) {
      xq[j].zero();
      gq[j].zero();
    } else if (kAligned) {  // h*w % 4 == 0: a quad is all in or all out
      xq[j].load(x + idx);
      gq[j].load(g + idx);
    } else {
      xq[j].load_each(x + idx, n);
      gq[j].load_each(g + idx, n);
    }
  }
}

template <typename T, bool kAligned>
__global__ void __launch_bounds__(kThreads, kMinBlocks) isla_norm_bwd_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int tp = p.tp, cc = p.cc, O = p.O, O4 = p.O4, cg = p.cg, threads = p.threads;
  const int row = tp + 4;               // padded row of the gradient stages
  const int orow = O4 + 4;              // padded row of gamma and beta, [channel][object]
  float* gys = smem;                    // [cc][row] g' y; with gps, U's partial sums at tile end
  float* gps = gys + cc * row;          // [cc][row] g'
  float* gsm = gps + cc * row;          // [cc][orow] gamma of the chunk, f32
  float* bsm = gsm + cc * orow;         // [cc][orow] beta of the chunk, f32
  float* mt = bsm + cc * orow;          // [O][tp] resized mask, then / d
  float* inv = mt + O * tp;             // [tp] 1 / d
  float* ws = inv + tp;                 // [tp] sum_o (m_o / d) U_o
  float* d_part = ws + tp;              // [threads] per-thread sums of m
  auto* warp_seen = reinterpret_cast<unsigned long long*>(d_part + threads);  // [kMaxWarps]
  int* live_o = reinterpret_cast<int*>(warp_seen + kMaxWarps);              // [64]
  float* acc_s = reinterpret_cast<float*>(live_o + kMaxObjects);  // [2][cg] sum a, sum a y
  float* acc_gb = acc_s + 2 * cg;       // [2][O][cg] dgamma, dbeta over the span

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int span = blockIdx.x / p.n_groups;
  const int group = blockIdx.x - span * p.n_groups;
  const int chunk0 = group * p.chunks_per_group;
  const int n_chunks = min(p.chunks_per_group, (p.C + cc - 1) / cc - chunk0);
  const int tile0 = span * p.tiles_per_span;
  const int tile_end = min(tile0 + p.tiles_per_span, p.n_tiles);

  // elementwise pass: 4 pixels x 2 channels per thread
  const int quads_log2 = p.tp_log2 - 2;
  const int pl = (tid & ((1 << quads_log2) - 1)) * 4;
  const int cl = (tid >> quads_log2) * 2;
  // U: one 4-object x 4-pixel block per thread, its channels split over ksplit threads
  const int slice = tid / p.units, unit = tid - slice * p.units;
  const bool u_on = slice < p.ksplit;
  const int pq = (unit & ((1 << quads_log2) - 1)) * 4, oq = (unit >> quads_log2) * 4;

  const T* gamma = static_cast<const T*>(p.gamma);
  const T* beta = static_cast<const T*>(p.beta);
  T* dx = static_cast<T*>(p.dx);
  const size_t plane = static_cast<size_t>(p.HS) * p.WS;
  const T* m_b = static_cast<const T*>(p.mask) + static_cast<size_t>(b) * O * plane;

  for (int i = tid; i < 2 * cg + 2 * O * cg; i += threads) acc_s[i] = 0.0f;  // acc_gb follows

  // x and g of the first chunk are in flight while the first mask tile is built
  Quad<T> xq[2], gq[2];
  float stats[2][2];
  load_xg<T, kAligned>(p, b, chunk0 * cc + cl, tile0 * tp + pl, xq, gq, stats);

  for (int tile = tile0; tile < tile_end; ++tile) {
    const int p0 = tile * tp;

    // 1. The resized mask tile: a thread keeps one pixel's taps and walks objects; its
    // share of sum_o m_o, and a 64-bit word of the objects non-zero on the tile.
    {
      const int q = tid & (tp - 1), o_step = threads >> p.tp_log2;
      const bool in_map = p0 + q < p.P;
      int y0 = 0, y1 = 0, x0 = 0, x1 = 0;
      float wy = 0.0f, wx = 0.0f;
      if (in_map) {
        const int y = (p0 + q) / p.W;
        src_taps(y + p.row0, p.HS, p.scale_y, y0, y1, wy);
        src_taps(p0 + q - y * p.W, p.WS, p.scale_x, x0, x1, wx);
      }
      const int taps[4] = {y0 * p.WS + x0, y0 * p.WS + x1, y1 * p.WS + x0, y1 * p.WS + x1};
      unsigned long long seen = 0ull;
      float m_sum = 0.0f;
      for (int o_base = tid >> p.tp_log2; o_base < O; o_base += kMaskBatch * o_step) {
        float src[kMaskBatch][4];
#pragma unroll
        for (int u = 0; u < kMaskBatch; ++u) {
          const int o = o_base + u * o_step;
#pragma unroll
          for (int t = 0; t < 4; ++t)
            src[u][t] = (o < O && in_map) ? load_f32(m_b + o * plane + taps[t]) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kMaskBatch; ++u) {
          const int o = o_base + u * o_step;
          if (o < O) {
            const float v = bilerp(src[u], wy, wx);
            mt[o * tp + q] = v;
            m_sum += v;
            if (v != 0.0f) seen |= 1ull << o;
          }
        }
      }
      const unsigned lo = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(seen));
      const unsigned hi = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(seen >> 32));
      if ((tid & 31) == 0) warp_seen[tid >> 5] = lo | (static_cast<unsigned long long>(hi) << 32);
      d_part[tid] = m_sum;
    }
    __syncthreads();

    // 2. 1 / (sum over objects + 1e-6) per pixel, the live word and the live list.
    for (int q = tid; q < tp; q += threads) {
      float sum = 0.0f;
      for (int j = q; j < threads; j += tp) sum += d_part[j];
      inv[q] = 1.0f / (sum + kMaskEps);
    }
    unsigned long long live = 0ull;
    for (int w = 0; w < (threads >> 5); ++w) live |= warp_seen[w];
    const int n_live = __popcll(live);
    if (tid < kMaxObjects && ((live >> tid) & 1ull))
      live_o[__popcll(live & ((1ull << tid) - 1ull))] = tid;
    __syncthreads();

    // 3. Fold 1 / d into the live rows (published by the chunk loop's first barrier).
    for (int i = tid; i < n_live * tp; i += threads)
      mt[live_o[i >> p.tp_log2] * tp + (i & (tp - 1))] *= inv[i & (tp - 1)];

    float acc_u[4][4] = {};
    for (int k = 0; k < n_chunks; ++k) {
      const int c0 = (chunk0 + k) * cc;

      // 4. gamma and beta of every object (a pad object's mask gradient needs its own),
      // each thread's loads issued four at a time before any is stored.
      for (int i0 = tid; i0 < O4 * cc; i0 += kGammaBatch * threads) {
        float gv[kGammaBatch], bv[kGammaBatch];
#pragma unroll
        for (int u = 0; u < kGammaBatch; ++u) {
          const int i = i0 + u * threads, o = i / cc, c = c0 + i - o * cc;
          const bool ok = i < O4 * cc && o < O && c < p.C;
          const size_t off = (static_cast<size_t>(b) * O + o) * p.C + c;
          gv[u] = ok ? load_f32(gamma + off) : 0.0f;
          bv[u] = ok ? load_f32(beta + off) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kGammaBatch; ++u) {
          const int i = i0 + u * threads, o = i / cc, q = i - o * cc;
          if (i < O4 * cc) {
            gsm[q * orow + o] = gv[u];
            bsm[q * orow + o] = bv[u];
          }
        }
      }
      __syncthreads();

      // 5. Elementwise: recompute out and g', write dx, stage g' y and g'; one channel at a
      // time, so that G/d and B/d of only 4 pixels are live beside U and the prefetch.
      float sa[2], say[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = c0 + cl + j;
        const bool c_ok = c < p.C;
        float gd[4] = {}, bd[4] = {};  // G/d and B/d at the 4 pixels
        for (unsigned long long bits = live; bits; bits &= bits - 1) {
          const int o = __ffsll(static_cast<long long>(bits)) - 1;
          float m4[4];
          load4(mt + o * tp + pl, m4);
          const float gj = gsm[(cl + j) * orow + o], bj = bsm[(cl + j) * orow + o];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            gd[i] = fmaf(gj, m4[i], gd[i]);
            bd[i] = fmaf(bj, m4[i], bd[i]);
          }
        }
        const float mu = stats[j][0];
        const float rstd = c_ok ? 1.0f / sqrtf(stats[j][1] + p.eps) : 0.0f;
        float xv[4], gv[4], dxv[4], gy4[4], gp4[4];
        xq[j].get(xv);
        gq[j].get(gv);
        sa[j] = 0.0f;
        say[j] = 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float y = (xv[i] - mu) * rstd;
          const float scale = gd[i] + 1.0f;
          const float out = fmaf(y, scale, bd[i]);
          const float g = (p.relu && !(out > 0.0f)) ? 0.0f : gv[i];
          const float a = g * scale;
          dxv[i] = a * rstd;
          sa[j] += a;
          say[j] = fmaf(a, y, say[j]);
          gy4[i] = g * y;
          gp4[i] = g;
        }
        store4(gys + (cl + j) * row + pl, gy4);
        store4(gps + (cl + j) * row + pl, gp4);
        const int px = p0 + pl;
        if (c_ok && px < p.P) {
          T* dst = dx + (static_cast<size_t>(b) * p.C + c) * p.P + px;
          if (kAligned) {
            store4(dst, dxv);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (px + i < p.P) dst[i] = from_f32<T>(dxv[i]);
          }
        }
      }
      {
        // sum over the lanes that share these channels (consecutive lanes, one warp)
        for (int off = 1 << (quads_log2 - 1); off > 0; off >>= 1) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            sa[j] += __shfl_xor_sync(0xffffffffu, sa[j], off);
            say[j] += __shfl_xor_sync(0xffffffffu, say[j], off);
          }
        }
        if (pl == 0) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            acc_s[k * cc + cl + j] += sa[j];
            acc_s[cg + k * cc + cl + j] += say[j];
          }
        }
      }

      // 6. x, g and the statistics of the next chunk (or of the next tile's first) go out
      // now and land during the contractions.
      if (k + 1 < n_chunks)
        load_xg<T, kAligned>(p, b, c0 + cc + cl, p0 + pl, xq, gq, stats);
      else if (tile + 1 < tile_end)
        load_xg<T, kAligned>(p, b, chunk0 * cc + cl, p0 + tp + pl, xq, gq, stats);
      __syncthreads();

      // 7. dgamma and dbeta of the live objects: contract the stages over pixels. A unit is
      // 4 live objects x 1 channel, so each 16-byte piece of a stage row feeds 16 FMAs from
      // registers; a unit's pixel quads are split over 2^sl_log2 consecutive lanes, whose
      // sums meet in a fixed shuffle tree. Every warp runs the same number of passes.
      {
        const int units = ((n_live + 3) >> 2) * cc;
        int sl_log2 = 0;
        while (sl_log2 < quads_log2 && (units << (sl_log2 + 1)) <= threads) ++sl_log2;
        const int sl = 1 << sl_log2, part = tid & (sl - 1);
        for (int u0 = 0; u0 < units; u0 += threads >> sl_log2) {
          const int u = u0 + (tid >> sl_log2);
          const bool ok = u < units;
          const int lq = ok ? u / cc : 0, q = ok ? u - lq * cc : 0;
          int os[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) os[j] = live_o[min(4 * lq + j, n_live - 1)];
          float sg[4] = {}, sb[4] = {};
          for (int pq = part; pq < (1 << quads_log2); pq += sl) {
            float gy4[4], gp4[4];
            load4(gys + q * row + 4 * pq, gy4);
            load4(gps + q * row + 4 * pq, gp4);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float m4[4];
              load4(mt + os[j] * tp + 4 * pq, m4);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                sg[j] = fmaf(m4[i], gy4[i], sg[j]);
                sb[j] = fmaf(m4[i], gp4[i], sb[j]);
              }
            }
          }
          for (int off = sl >> 1; off > 0; off >>= 1) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              sg[j] += __shfl_xor_sync(0xffffffffu, sg[j], off);
              sb[j] += __shfl_xor_sync(0xffffffffu, sb[j], off);
            }
          }
          if (ok && part == 0) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (4 * lq + j < n_live) {
                acc_gb[os[j] * cg + k * cc + q] += sg[j];
                acc_gb[(O + os[j]) * cg + k * cc + q] += sb[j];
              }
            }
          }
        }
      }

      // 8. U of every object: contract the stages over this thread's share of the channels.
      if (u_on) {
        for (int q = slice; q < cc; q += p.ksplit) {
          float gy4[4], gp4[4], g4[4], b4[4];
          load4(gys + q * row + pq, gy4);
          load4(gps + q * row + pq, gp4);
          load4(gsm + q * orow + oq, g4);
          load4(bsm + q * orow + oq, b4);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc_u[j][i] = fmaf(g4[j], gy4[i], fmaf(b4[j], gp4[i], acc_u[j][i]));
          }
        }
      }
      __syncthreads();  // the stages and gamma/beta are refilled by the next chunk
    }

    // 9. U of the tile: the slices' partial sums in slice order, over the free stages.
    float* us = gys;  // [ksplit][O4][tp], then [O4][tp]
    const int u_size = O4 * tp;
    if (u_on) {
#pragma unroll
      for (int j = 0; j < 4; ++j) store4(us + slice * u_size + (oq + j) * tp + pq, acc_u[j]);
    }
    __syncthreads();
    if (p.ksplit > 1) {
      for (int i = tid; i < u_size; i += threads) {
        float u = us[i];
        for (int s = 1; s < p.ksplit; ++s) u += us[s * u_size + i];
        us[i] = u;
      }
      __syncthreads();
    }
    for (int q = tid; q < tp; q += threads) {
      float s = 0.0f;
      for (int l = 0; l < n_live; ++l) {
        const int o = live_o[l];
        s = fmaf(mt[o * tp + q], us[o * tp + q], s);
      }
      ws[q] = s;
    }
    __syncthreads();

    // 10. dm of this group's channels: (U_o - sum_o' (m_o'/d) U_o') / d.
    float* dm = p.part_dm + (static_cast<size_t>(group) * p.B + b) * O * p.P;
    for (int i = tid; i < O * tp; i += threads) {
      const int o = i >> p.tp_log2, q = i & (tp - 1);
      if (p0 + q < p.P) dm[static_cast<size_t>(o) * p.P + p0 + q] = (us[i] - ws[q]) * inv[q];
    }
    __syncthreads();  // mt, the live list and the stages are rebuilt by the next tile
  }

  // 11. This span's per-channel and per-object sums.
  const int cbase = chunk0 * cc;
  float* ps = p.part_stats + (static_cast<size_t>(b) * p.n_spans + span) * 2 * p.C;
  for (int i = tid; i < 2 * cg; i += threads) {
    const int s = i / cg, q = i - s * cg;
    if (cbase + q < p.C) ps[s * p.C + cbase + q] = acc_s[i];
  }
  float* pgb = p.part_gb + (static_cast<size_t>(b) * p.n_spans + span) * 2 * O * p.C;
  for (int i = tid; i < 2 * O * cg; i += threads) {
    const int so = i / cg, q = i - so * cg;
    if (cbase + q < p.C) pgb[static_cast<size_t>(so) * p.C + cbase + q] = acc_gb[i];
  }
}

template <typename T, bool kAligned>
cudaError_t launch(const Params& p, int smem_bytes, cudaStream_t stream) {
  auto kernel = isla_norm_bwd_kernel<T, kAligned>;
  // Once per instantiation (the port drives one card): ask for the most shared memory the
  // SM can give (228 KB, leaving L1 the rest), so that four blocks fit; the runtime's own
  // choice of the split may hold fewer.
  static bool carveout_set = false;
  cudaError_t err = cudaSuccess;
  if (!carveout_set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    carveout_set = err == cudaSuccess;
  }
  if (err == cudaSuccess && smem_bytes > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // the attribute call also set the last error: clear it
    return err;
  }
  kernel<<<dim3(p.n_spans * p.n_groups, p.B), p.threads, smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

// ---- The finishing kernel: the partial buffers into the five gradients. ----

constexpr int kFinishThreads = 256;

struct FinishParams {
  const float* part_stats;  // (B, n_spans, 2, C)
  const float* part_gb;     // (B, n_spans, 2, O, C)
  const float* part_dm;     // (n_groups, B, O, H, W)
  const float* var;         // (C,)
  float* dmean;             // (C,) -r sum a
  float* dvar;              // (C,) -r^2 sum a y / 2
  void* dmask;              // (B, O, HS, WS), T
  void* dgamma;             // (B, O, C), T
  void* dbeta;              // (B, O, C), T
  int B, C, O, H, W, HS, WS, n_spans, n_groups;
  int row0;                 // the destination rows are image rows [row0, row0 + H)
  float scale_y, scale_x, eps;
  int gb_slices, st_slices, dm_slices;  // threads that split one sum's rows (slices_for)
  int gb_blocks, gb_per_block;  // blocks of the dgamma/dbeta section, elements per block
  int band_rows, n_bands;    // source rows of dmask per block, blocks per (b, o) plane
  int stage_rows;            // destination rows of dm staged in shared memory at once
};

// First destination index d of [0, out) whose taps (those of image index d + off) satisfy
// i1(d) >= s (upper = false) or i0(d) > s (upper = true), or out. Both taps are
// non-decreasing in d, so the destinations that reach source index s (i0 <= s <= i1) are
// [first(false), first(true)).
__device__ int first_dst(int s, int out, int off, int in, float scale, bool upper) {
  int a = 0, b = out;
  while (a < b) {
    const int m = (a + b) >> 1;
    int i0, i1;
    float w1;
    src_taps(m + off, in, scale, i0, i1, w1);
    if (upper ? i0 > s : i1 >= s)
      b = m;
    else
      a = m + 1;
  }
  return a;
}

// The weight with which destination d reads source index s (both taps may be s at an edge).
__device__ __forceinline__ float tap_weight(int d, int s, int in, float scale) {
  int i0, i1;
  float w1;
  src_taps(d, in, scale, i0, i1, w1);
  return (i0 == s ? 1.0f - w1 : 0.0f) + (i1 == s ? w1 : 0.0f);
}

// For each element e < n, write(e, sum_r src[base(e) + r * stride]) over rows r < R. The
// block's threads form `slices` rows of kFinishThreads / slices: thread row j adds rows
// j, j + slices, ... in order, and the partial sums meet in a fixed pairwise tree.
template <typename Base, typename Write>
__device__ __forceinline__ void block_sums(const float* src, size_t stride, int R, int n, int slices,
                                           float* part, Base base, Write write) {
  if (slices == 1) {  // one thread per element: no partials to meet, loads issued 8 at a time
#pragma unroll 8
    for (int e = threadIdx.x; e < n; e += kFinishThreads) {
      const float* row = src + base(e);
      float acc = 0.0f;
      for (int r = 0; r < R; ++r) acc += row[static_cast<size_t>(r) * stride];
      write(e, acc);
    }
    __syncthreads();  // the writes are read by other threads next
    return;
  }
  const int epb = kFinishThreads / slices, j = threadIdx.x / epb, l = threadIdx.x - j * epb;
  for (int e0 = 0; e0 < n; e0 += epb) {
    const int e = e0 + l;
    float acc = 0.0f;
    if (e < n) {
      const float* row = src + base(e);
#pragma unroll 4
      for (int r = j; r < R; r += slices) acc += row[static_cast<size_t>(r) * stride];
    }
    part[threadIdx.x] = acc;
    __syncthreads();
    for (int half = slices >> 1; half > 0; half >>= 1) {
      if (j < half) part[threadIdx.x] += part[threadIdx.x + half * epb];
      __syncthreads();
    }
    if (j == 0 && e < n) write(e, part[l]);
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kFinishThreads) isla_norm_bwd_finish_kernel(const FinishParams p) {
  extern __shared__ __align__(16) float fsm[];
  const int tid = threadIdx.x;
  const int n_plane_blocks = p.B * p.O * p.n_bands;
  if (static_cast<int>(blockIdx.x) < n_plane_blocks) {
    // dmask of source rows [ys0, ys0 + R) of one (b, o) plane: part_dm summed over the
    // channel groups, then the transposed resize as a gather, rows first (W_y^T dm), then
    // columns (. W_x), each in destination order. The destination rows that reach the band
    // pass through shared memory (all at once where the host's bound holds, else in turns),
    // group-summed on the way in.
    const int plane = blockIdx.x / p.n_bands, band = blockIdx.x - plane * p.n_bands;
    const int R = p.band_rows, ys0 = band * R, nr = min(p.HS - ys0, R);
    int* lo_y = reinterpret_cast<int*>(fsm);
    int* hi_y = lo_y + R;
    int* lo_x = hi_y + R;
    int* hi_x = lo_x + p.WS;
    float* rows = reinterpret_cast<float*>(hi_x + p.WS);  // [R][W]
    float* dmp = rows + R * p.W;                           // [stage_rows][W]
    float* part = dmp + p.stage_rows * p.W;                // [kFinishThreads]
    for (int s = tid; s < nr + p.WS; s += kFinishThreads) {
      if (s < nr) {
        lo_y[s] = first_dst(ys0 + s, p.H, p.row0, p.HS, p.scale_y, false);
        hi_y[s] = first_dst(ys0 + s, p.H, p.row0, p.HS, p.scale_y, true);
      } else {
        lo_x[s - nr] = first_dst(s - nr, p.W, 0, p.WS, p.scale_x, false);
        hi_x[s - nr] = first_dst(s - nr, p.W, 0, p.WS, p.scale_x, true);
      }
    }
    for (int i = tid; i < nr * p.W; i += kFinishThreads) rows[i] = 0.0f;
    __syncthreads();
    const size_t group_stride = static_cast<size_t>(p.B) * p.O * p.H * p.W;
    const float* dm = p.part_dm + static_cast<size_t>(plane) * p.H * p.W;
    const int y_end = hi_y[nr - 1];  // a band that no row of the window reaches stays zero
    for (int yb = lo_y[0]; yb < y_end; yb += p.stage_rows) {
      const int ny = min(p.stage_rows, y_end - yb);
      block_sums(dm + static_cast<size_t>(yb) * p.W, group_stride, p.n_groups, ny * p.W,
                 p.dm_slices, part, [](int e) { return static_cast<size_t>(e); },
                 [&](int e, float v) { dmp[e] = v; });
      for (int i = tid; i < nr * p.W; i += kFinishThreads) {
        const int r = i / p.W, x = i - r * p.W;
        const int y0 = max(lo_y[r], yb), y1 = min(hi_y[r], yb + ny);
        float acc = rows[i];
        for (int y = y0; y < y1; ++y)
          acc = fmaf(tap_weight(y + p.row0, ys0 + r, p.HS, p.scale_y), dmp[(y - yb) * p.W + x],
                     acc);
        rows[i] = acc;
      }
      __syncthreads();
    }
    T* out = static_cast<T*>(p.dmask) + (static_cast<size_t>(plane) * p.HS + ys0) * p.WS;
    for (int i = tid; i < nr * p.WS; i += kFinishThreads) {
      const int r = i / p.WS, xs = i - r * p.WS;
      float acc = 0.0f;
      for (int x = lo_x[xs]; x < hi_x[xs]; ++x)
        acc = fmaf(tap_weight(x, xs, p.WS, p.scale_x), rows[r * p.W + x], acc);
      out[i] = from_f32<T>(acc);
    }
    return;
  }
  const int oc = p.O * p.C;
  float* part = fsm;
  if (static_cast<int>(blockIdx.x) < n_plane_blocks + p.gb_blocks) {
    // dgamma (k = 0) and dbeta (k = 1) of (b, o, c): the sum over spans; element
    // e = (b, k, o, c)
    const int e0 = (blockIdx.x - n_plane_blocks) * p.gb_per_block;
    const int n = min(p.gb_per_block, 2 * p.B * oc - e0);
    block_sums(p.part_gb, 2 * static_cast<size_t>(oc), p.n_spans, n, p.gb_slices, part,
               [&](int i) {
                 const int e = e0 + i, b = e / (2 * oc);
                 return static_cast<size_t>(b) * p.n_spans * 2 * oc + (e - b * 2 * oc);
               },
               [&](int i, float v) {
                 const int e = e0 + i, b = e / (2 * oc), k = (e - b * 2 * oc) / oc;
                 T* dst = static_cast<T*>(k == 0 ? p.dgamma : p.dbeta);
                 dst[e - (b + k) * oc] = from_f32<T>(v);
               });
    return;
  }
  // dmean (k = 0) and dvar (k = 1) of channel c: the sums over batches and spans;
  // element e = (k, c)
  const int e0 = (blockIdx.x - n_plane_blocks - p.gb_blocks) * (kFinishThreads / p.st_slices);
  const int n = min(kFinishThreads / p.st_slices, 2 * p.C - e0);
  block_sums(p.part_stats, 2 * static_cast<size_t>(p.C), p.B * p.n_spans, n, p.st_slices, part,
             [&](int i) { return static_cast<size_t>(e0 + i); },
             [&](int i, float v) {
               const int k = (e0 + i) / p.C, c = e0 + i - k * p.C;
               const float r = 1.0f / sqrtf(p.var[c] + p.eps);
               if (k == 0)
                 p.dmean[c] = -r * v;
               else
                 p.dvar[c] = -0.5f * r * r * v;
             });
}

// Thread rows that split a sum of `rows` terms: the least power of two that leaves each at
// most 16 terms (issued four at a time), up to the block's threads.
int slices_for(int rows) {
  int s = 1;
  while (s < kFinishThreads && 16 * s < rows) s *= 2;
  return s;
}

}  // namespace

// Launches the ISLA norm backward's main kernel on `stream`; returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue, without launching, for a tiling it cannot run,
// and the runtime's error when the block wants more shared memory than the card has). The
// caller (ops/isla.py::isla_norm_backward) checks shapes, dtypes and contiguity, picks the
// tiling (ops/isla.py::backward_config) and allocates the outputs: dx like x, part_stats
// (B, n_spans, 2, C), part_gb (B, n_spans, 2, O, C) and part_dm (n_groups, B, O, H, W), f32,
// with n_spans = ceil(ceil(H*W / tp) / tiles_per_span). U's channels are split over `ksplit`
// threads per 4 x 4 block (ksplit * (O4 / 4) * (tp / 4) <= threads). `aligned` selects 8- and
// 16-byte loads and stores of x, g and dx: it needs H*W % 4 == 0 and 16-byte-aligned x, grad
// and dx. On a row shard (rows [row0, row0 + H) of an image full_h rows high) the mask taps
// are the whole image's at those rows, and the finishing kernel's dmask is this shard's part.
extern "C" int isla_norm_backward(int bf16, int aligned, const void* x, const void* mean,
                                  const void* var, const void* mask, const void* gamma,
                                  const void* beta, const void* grad, void* dx, void* part_stats,
                                  void* part_gb, void* part_dm, int batch, int C, int H, int W,
                                  int O, int HS, int WS, int row0, int full_h, float eps, int relu,
                                  int threads, int tp,
                                  int tiles_per_span, int n_groups, int chunks_per_group,
                                  int ksplit, void* stream) {
  int tp_log2 = 0;
  while ((1 << tp_log2) < tp) ++tp_log2;
  const int O4 = (O + 3) / 4 * 4;
  const int units = (O4 / 4) * (tp / 4);
  if (O < 1 || O > kMaxObjects || tp != (1 << tp_log2) || tp < 16 || tp > 64 ||
      (threads != 64 && threads != 128 && threads != kThreads) || threads < tp ||
      ksplit < 1 || ksplit * units > threads || tiles_per_span < 1 || n_groups < 1 ||
      chunks_per_group < 1 || row0 < 0 || full_h < row0 + H)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cc = 8 * threads / tp;
  if (n_groups * chunks_per_group * cc < C || (n_groups - 1) * chunks_per_group * cc >= C)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x; p.mean = static_cast<const float*>(mean); p.var = static_cast<const float*>(var);
  p.mask = mask; p.gamma = gamma; p.beta = beta; p.grad = grad; p.dx = dx;
  p.part_stats = static_cast<float*>(part_stats);
  p.part_gb = static_cast<float*>(part_gb);
  p.part_dm = static_cast<float*>(part_dm);
  p.B = batch; p.C = C; p.P = H * W; p.W = W; p.O = O; p.O4 = O4;
  p.HS = HS; p.WS = WS; p.row0 = row0;
  p.scale_y = static_cast<float>(HS) / static_cast<float>(full_h);
  p.scale_x = static_cast<float>(WS) / static_cast<float>(W);
  p.eps = eps; p.relu = relu;
  p.threads = threads; p.tp = tp; p.tp_log2 = tp_log2; p.cc = cc;
  p.n_tiles = (p.P + tp - 1) / tp;
  p.tiles_per_span = tiles_per_span;
  p.n_spans = (p.n_tiles + tiles_per_span - 1) / tiles_per_span;
  p.n_groups = n_groups; p.chunks_per_group = chunks_per_group;
  p.cg = chunks_per_group * cc;
  p.units = units;
  p.ksplit = ksplit;
  const int smem_bytes = 4 * smem_words(O, O4, tp, cc, p.cg, threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16)
    err = aligned ? launch<__nv_bfloat16, true>(p, smem_bytes, s)
                  : launch<__nv_bfloat16, false>(p, smem_bytes, s);
  else
    err = aligned ? launch<float, true>(p, smem_bytes, s) : launch<float, false>(p, smem_bytes, s);
  return static_cast<int>(err);
}

// Launches the finishing kernel on `stream` after isla_norm_backward: reads its three partial
// buffers and writes dmean and dvar (C,) f32, dmask (B, O, HS, WS), dgamma and dbeta
// (B, O, C) in T. Blocks for bands of source rows of each (b, o) mask plane, then blocks for
// the span sums of dgamma and dbeta and for the sums over batches and spans of dmean and dvar.
// Every sum runs in a fixed order and nothing is atomic, so the result is the same bits on
// every run. Returns cudaGetLastError() after the launch (cudaErrorInvalidValue, without
// launching, for sizes it cannot run).
extern "C" int isla_norm_backward_finish(int bf16, const void* part_stats, const void* part_gb,
                                         const void* part_dm, const void* var, void* dmean,
                                         void* dvar, void* dmask, void* dgamma, void* dbeta,
                                         int batch, int C, int H, int W, int O, int HS, int WS,
                                         int row0, int full_h, float eps, int n_spans,
                                         int n_groups, void* stream) {
  if (batch < 1 || C < 1 || O < 1 || H < 1 || W < 1 || HS < 1 || WS < 1 || n_spans < 1 ||
      n_groups < 1 || row0 < 0 || full_h < row0 + H)
    return static_cast<int>(cudaErrorInvalidValue);
  FinishParams p;
  p.part_stats = static_cast<const float*>(part_stats);
  p.part_gb = static_cast<const float*>(part_gb);
  p.part_dm = static_cast<const float*>(part_dm);
  p.var = static_cast<const float*>(var);
  p.dmean = static_cast<float*>(dmean); p.dvar = static_cast<float*>(dvar);
  p.dmask = dmask; p.dgamma = dgamma; p.dbeta = dbeta;
  p.B = batch; p.C = C; p.O = O; p.H = H; p.W = W; p.HS = HS; p.WS = WS;
  p.n_spans = n_spans; p.n_groups = n_groups; p.row0 = row0;
  p.scale_y = static_cast<float>(HS) / static_cast<float>(full_h);
  p.scale_x = static_cast<float>(WS) / static_cast<float>(W);
  p.eps = eps;
  p.gb_slices = slices_for(n_spans);
  p.st_slices = slices_for(batch * n_spans);
  p.dm_slices = slices_for(n_groups);
  const long gb_elems = 2L * batch * O * C;
  if (gb_elems > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  p.gb_per_block = kFinishThreads / p.gb_slices;  // one element per thread row
  const int gb_per_block = p.gb_per_block;
  const int st_per_block = kFinishThreads / p.st_slices;
  p.gb_blocks = static_cast<int>((gb_elems + gb_per_block - 1) / gb_per_block);
  const int st_blocks = (2 * C + st_per_block - 1) / st_per_block;
  // bands of about 2048 values of W_y^T dm or of the output per block
  const int wide = W > WS ? W : WS;
  p.band_rows = 2048 / wide < 1 ? 1 : (2048 / wide > HS ? HS : 2048 / wide);
  p.n_bands = (HS + p.band_rows - 1) / p.band_rows;
  // destination rows that reach a band: (band_rows + 1) * full_h / HS from the taps'
  // spacing, and two more for the clamped edges and rounding
  p.stage_rows = static_cast<int>((p.band_rows + 1) * static_cast<long>(full_h) / HS) + 3;
  if (p.stage_rows > H) p.stage_rows = H;
  const int plane_words = 2 * (p.band_rows + WS) + (p.band_rows + p.stage_rows) * W + kFinishThreads;
  const int smem_bytes = 4 * (plane_words > kFinishThreads ? plane_words : kFinishThreads);
  const long grid = static_cast<long>(batch) * O * p.n_bands + p.gb_blocks + st_blocks;
  if (grid > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = bf16 ? isla_norm_bwd_finish_kernel<__nv_bfloat16> : isla_norm_bwd_finish_kernel<float>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();  // the attribute call also set the last error: clear it
      return static_cast<int>(err);
    }
  }
  kernel<<<static_cast<unsigned>(grid), kFinishThreads, smem_bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
