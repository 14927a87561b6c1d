// Fused ISLA norm forward for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel ops/pallas/isla.py::_isla_kernel_batched
// (isla_modulate; pallas_call at line 85 in the tree of commit d0260d0^), and takes
// in the passes around it: the eval BatchNorm apply (nn/norms.py::SyncBatchNorm with
// running statistics), the bilinear resize of the stage mask (ops/interp.py::
// resize_bilinear) and the ReLU that follows each norm in nn/blocks.py::GenResBlock.
// One launch per norm computes, for batch b, channel c and pixel p of x (b, c, h, w):
//
//   y   = (x - mean_c) / sqrt(var_c + eps)
//   m_o = mask[b, o] resized to (h, w): F.interpolate bilinear, align_corners=False
//         (on a row shard: resized to the whole image, read at the shard's rows)
//   d   = sum_o m_o(p) + 1e-6
//   out = act(y * (sum_o m_o(p) gamma[b,o,c] / d + 1) + sum_o m_o(p) beta[b,o,c] / d)
//
// What bounds it: bytes. Each output element costs x in and out back (8 bytes in
// f32) against 4 flops per object whose mask covers the pixel; at the Ours-D 128px
// shapes (o = 31 slots, 6 of them real objects, under one live object per pixel on
// average) that is far below the H100's balance point, and even with every object
// live everywhere it stays under it. The design therefore moves each byte once and
// keeps everything else on chip. (Measured by chip_smoke.py on an H100 80GB HBM3 at
// b = 8: each block's serial chain of mask loads, barriers and stream keeps a call
// at 8-49% of that bound; PERF.md has the numbers.)
//
// * Grid: one CTA per (pixel tile, channel group, batch). A pixel tile is tp pixels
//   of the flattened h*w axis (a power of two, 16..64, with 4 * tp <= 128 threads).
//   Channels are cut into chunks of cc channels (tp * cc = 16 * threads), and where
//   the map is small (h = 4, 8) several CTAs split the channels so the grid still
//   fills the 132 SMs. Small blocks keep several resident per SM, so one block's
//   mask loads overlap another's stream.
// * Mask tile: each CTA builds the (o, tp) resized mask in shared memory from the
//   source mask with inline 2-tap weights (the same taps and weights as the constant
//   resize matrices of the plain version), sums it over o once per pixel and folds
//   1 / (sum + 1e-6) into it. The resized mask never reaches device memory. A thread
//   keeps one pixel's taps and issues 16 objects' source loads before using any, and
//   before the bulk copies of x, so the tile costs one trip to memory, not one per
//   object, and that trip does not queue behind the bulk traffic.
// * Live objects: a 64-bit mask of the objects whose tile is not all zero, and the
//   contraction over objects runs over those alone. A zero mask adds exactly 0, so
//   this is exact; pad objects (all-zero masks) are never touched after the tile.
// * Channel chunks stream through two shared-memory stages with 16-byte cp.async:
//   chunks 0 and 1 (x, and gamma and beta of every object, as the live set is not
//   known yet) are requested at entry and land while the mask tile is built; later
//   chunks (x and the live objects' rows) refill a stage as soon as it is consumed,
//   so chunk k + 1 is in flight while chunk k is computed. Inputs whose rows are not
//   16-byte multiples (odd h*w or c) take plain loads into the same stages.
// * Arithmetic: each thread owns 4 pixels x 4 channels. Per live object it reads 4
//   folded mask values and 4 gammas and betas (a warp shares its channels, so these
//   are broadcasts) and does 32 FMAs. Everything is f32: exact f32 for f32 inputs,
//   bf16 inputs widened on load and rounded once on the store. The contraction is at
//   most 64 deep and the pass is byte-bound, so tensor cores (mma.sync or wgmma) would
//   buy nothing here; plain FMAs also keep f32 exact, where TF32 would not.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "isla_common.cuh"

namespace {

constexpr int kBatch = 16;  // objects whose mask taps one thread loads at once
constexpr int kMaxThreads = 128;

struct Params {
  const void* x;       // (B, C, H, W), T
  const float* mean;   // (C,) running mean
  const float* var;    // (C,) running variance
  const void* mask;    // (B, O, HS, WS), T: the source-resolution stage mask
  const void* gamma;   // (B, O, C), T
  const void* beta;    // (B, O, C), T
  void* out;           // (B, C, H, W), T
  int C, P, W, O, HS, WS;
  int row0;            // x holds image rows [row0, row0 + H) (a row shard's window)
  float scale_y, scale_x, eps;
  int relu;
  int tp, tp_log2;     // pixels per tile, a power of two
  int cc;              // channels per chunk
  int n_groups;        // channel groups per pixel tile
  int chunks_per_group;
};

// 16-byte global -> shared copy; when !valid it writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rows [c0, c0 + cc) x pixels [p0, p0 + tp) -> xs[cc][tp]; zeros outside x.
template <typename T, bool kAligned>
__device__ __forceinline__ void load_x(const Params& p, int b, int p0, int c0, T* xs) {
  const T* x = static_cast<const T*>(p.x);
  if constexpr (kAligned) {
    constexpr int kVec = 16 / sizeof(T);
    const int shift = p.tp_log2 - (kVec == 4 ? 2 : 3);  // log2(pieces per row)
    for (int i = threadIdx.x; i < (p.cc << shift); i += blockDim.x) {
      const int r = i >> shift, q = (i - (r << shift)) * kVec;
      const int c = c0 + r, pg = p0 + q;
      const bool ok = c < p.C && pg < p.P;
      cp_async16(xs + r * p.tp + q, ok ? x + (static_cast<size_t>(b) * p.C + c) * p.P + pg : x, ok);
    }
  } else {
    for (int i = threadIdx.x; i < (p.cc << p.tp_log2); i += blockDim.x) {
      const int r = i >> p.tp_log2, q = i & (p.tp - 1);
      const int c = c0 + r, pg = p0 + q;
      xs[i] = (c < p.C && pg < p.P) ? x[(static_cast<size_t>(b) * p.C + c) * p.P + pg]
                                    : from_f32<T>(0.0f);
    }
  }
}

// gamma and beta rows, channels [c0, c0 + cc), of the objects live_o[0..n) (or of
// objects 0..n - 1 when live_o is null) -> gs[o][cc], bs[o][cc].
template <typename T, bool kAligned>
__device__ __forceinline__ void load_gb(const Params& p, int b, int c0, int n, const int* live_o,
                                        T* gs, T* bs) {
  const T* gamma = static_cast<const T*>(p.gamma);
  const T* beta = static_cast<const T*>(p.beta);
  if constexpr (kAligned) {
    constexpr int kVec = 16 / sizeof(T);
    const int pieces = p.cc / kVec;
    for (int i = threadIdx.x; i < n * pieces; i += blockDim.x) {
      const int l = i / pieces, q = (i - l * pieces) * kVec;
      const int o = live_o ? live_o[l] : l, c = c0 + q;
      const bool ok = c < p.C;
      const size_t off = (static_cast<size_t>(b) * p.O + o) * p.C + c;
      cp_async16(gs + o * p.cc + q, ok ? gamma + off : gamma, ok);
      cp_async16(bs + o * p.cc + q, ok ? beta + off : beta, ok);
    }
  } else {
    for (int i = threadIdx.x; i < n * p.cc; i += blockDim.x) {
      const int l = i / p.cc, q = i - l * p.cc;
      const int o = live_o ? live_o[l] : l, c = c0 + q;
      const size_t off = (static_cast<size_t>(b) * p.O + o) * p.C + c;
      gs[o * p.cc + q] = c < p.C ? gamma[off] : from_f32<T>(0.0f);
      bs[o * p.cc + q] = c < p.C ? beta[off] : from_f32<T>(0.0f);
    }
  }
}

// BN statistics of channels c..c+3 (1 and 0 past the last channel).
__device__ __forceinline__ void load_stats(const Params& p, int c, float mu[4], float var[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    mu[j] = c + j < p.C ? __ldg(p.mean + c + j) : 0.0f;
    var[j] = c + j < p.C ? __ldg(p.var + c + j) : 1.0f;
  }
}

template <typename T, bool kAligned>
__global__ void __launch_bounds__(kMaxThreads) isla_norm_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tp = p.tp, cc = p.cc, O = p.O;
  float* mt = reinterpret_cast<float*>(smem);           // [O][tp] resized mask, then / d
  float* inv = mt + O * tp;                              // [tp] 1 / d
  float* d_part = inv + tp;                              // [blockDim.x] partial sums of m
  int* live_o = reinterpret_cast<int*>(d_part + kMaxThreads);  // [kMaxObjects] live ids
  auto* warp_seen = reinterpret_cast<unsigned long long*>(live_o + kMaxObjects);  // [warps]
  T* xs = reinterpret_cast<T*>(warp_seen + kMaxThreads / 32);  // [2][cc][tp] x chunks
  T* gs = xs + 2 * cc * tp;                              // [2][O][cc] gamma, by object
  T* bs = gs + 2 * O * cc;                               // [2][O][cc] beta, by object

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int tile = blockIdx.x / p.n_groups;
  const int chunk0 = (blockIdx.x - tile * p.n_groups) * p.chunks_per_group;
  const int p0 = tile * tp;
  const int n_chunks = min(p.chunks_per_group, (p.C + cc - 1) / cc - chunk0);

  // Each thread owns 4 pixels x 4 channels of every chunk.
  const int quads_log2 = p.tp_log2 - 2;
  const int pl = (tid & ((1 << quads_log2) - 1)) * 4;
  const int cl = (tid >> quads_log2) * 4;
  const int pg = p0 + pl;

  // 1. The resized mask tile, and which objects are non-zero anywhere in it. A
  // thread keeps one pixel (its taps and weights) and walks objects. The first
  // kBatch objects' source loads go out before the bulk copies below, which would
  // otherwise queue ahead of them.
  const int q = tid & (tp - 1), o_step = blockDim.x >> p.tp_log2;
  const bool in_map = p0 + q < p.P;
  int y0 = 0, y1 = 0, x0 = 0, x1 = 0;
  float wy = 0.0f, wx = 0.0f;
  if (in_map) {
    const int y = (p0 + q) / p.W;
    src_taps(y + p.row0, p.HS, p.scale_y, y0, y1, wy);
    src_taps(p0 + q - y * p.W, p.WS, p.scale_x, x0, x1, wx);
  }
  const int taps[4] = {y0 * p.WS + x0, y0 * p.WS + x1, y1 * p.WS + x0, y1 * p.WS + x1};
  const size_t plane = static_cast<size_t>(p.HS) * p.WS;
  const T* m_b = static_cast<const T*>(p.mask) + static_cast<size_t>(b) * O * plane;
  float src[kBatch][4];
  auto load_batch = [&](int o_base) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int o = o_base + u * o_step;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        src[u][t] = (o < O && in_map) ? load_f32(m_b + o * plane + taps[t]) : 0.0f;
    }
  };
  unsigned long long seen = 0ull;
  float m_sum = 0.0f;  // this thread's objects' share of sum_o m_o at its pixel
  auto resize_batch = [&](int o_base) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int o = o_base + u * o_step;
      if (o < O) {
        const float v = bilerp(src[u], wy, wx);
        mt[o * tp + q] = v;
        m_sum += v;
        if (v != 0.0f) seen |= 1ull << o;
      }
    }
  };
  load_batch(tid >> p.tp_log2);

  // Chunks 0 and 1 (x, and gamma and beta of every object, as the live set is not
  // known yet) and chunk 0's BN statistics are in flight during the mask work.
  for (int k = 0; k < min(n_chunks, 2); ++k) {
    load_x<T, kAligned>(p, b, p0, (chunk0 + k) * cc, xs + k * cc * tp);
    load_gb<T, kAligned>(p, b, (chunk0 + k) * cc, O, nullptr, gs + k * O * cc, bs + k * O * cc);
    cp_async_commit();
  }
  float mu[4], var[4];
  load_stats(p, chunk0 * cc + cl, mu, var);

  resize_batch(tid >> p.tp_log2);
  for (int o_base = (tid >> p.tp_log2) + kBatch * o_step; o_base < O; o_base += kBatch * o_step) {
    load_batch(o_base);
    resize_batch(o_base);
  }
  // one 64-bit word per warp; no shared atomics, so nothing to zero first
  const unsigned seen_lo = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(seen));
  const unsigned seen_hi = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(seen >> 32));
  if ((tid & 31) == 0)
    warp_seen[tid >> 5] = seen_lo | (static_cast<unsigned long long>(seen_hi) << 32);
  d_part[tid] = m_sum;
  __syncthreads();

  // 2. 1 / (sum over all objects + 1e-6) per pixel; the list of live objects.
  for (int px = tid; px < tp; px += blockDim.x) {
    float sum = 0.0f;
    for (int j = px; j < static_cast<int>(blockDim.x); j += tp) sum += d_part[j];
    inv[px] = 1.0f / (sum + kMaskEps);
  }
  unsigned long long live = 0ull;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) live |= warp_seen[w];
  const int n_live = __popcll(live);
  if (tid == 0) {
    unsigned long long bits = live;
    for (int l = 0; bits; ++l, bits &= bits - 1) live_o[l] = __ffsll(bits) - 1;
  }
  __syncthreads();

  // 3. Fold 1 / d into the live rows (published by the chunk loop's barrier).
  for (int i = tid; i < n_live * tp; i += blockDim.x)
    mt[live_o[i >> p.tp_log2] * tp + (i & (tp - 1))] *= inv[i & (tp - 1)];

  // 4. Stream the channel chunks through the two stages.
  T* out = static_cast<T*>(p.out);
  for (int k = 0; k < n_chunks; ++k) {
    const int s = k & 1;
    const int c = (chunk0 + k) * cc + cl;
    if (k + 1 < n_chunks)
      cp_async_wait<1>();  // everything but chunk k + 1 has landed
    else
      cp_async_wait<0>();
    __syncthreads();

    if (c < p.C && pg < p.P) {
      float acc_g[4][4] = {}, acc_b[4][4] = {};
      const T* g_row = gs + s * O * cc + cl;
      const T* b_row = bs + s * O * cc + cl;
      unsigned long long bits = live;
      for (; bits; bits &= bits - 1) {
        float m4[4], g4[4], b4[4];
        const int o = __ffsll(bits) - 1;
        load4(mt + o * tp + pl, m4);
        load4(g_row + o * cc, g4);
        load4(b_row + o * cc, b4);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_g[j][i] = fmaf(g4[j], m4[i], acc_g[j][i]);
            acc_b[j][i] = fmaf(b4[j], m4[i], acc_b[j][i]);
          }
        }
      }
      const T* x_row = xs + s * cc * tp + cl * tp + pl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cj = c + j;
        if (cj < p.C) {
          const float rstd = 1.0f / sqrtf(var[j] + p.eps);
          float v[4];
          load4(x_row + j * tp, v);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float y = (v[i] - mu[j]) * rstd;
            v[i] = fmaf(y, acc_g[j][i] + 1.0f, acc_b[j][i]);
            if (p.relu) v[i] = fmaxf(v[i], 0.0f);
          }
          T* dst = out + (static_cast<size_t>(b) * p.C + cj) * p.P + pg;
          if (kAligned) {
            store4(dst, v);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (pg + i < p.P) dst[i] = from_f32<T>(v[i]);
          }
        }
      }
    }
    if (k + 1 < n_chunks) load_stats(p, c + cc, mu, var);
    __syncthreads();  // stage s is free: refill it with chunk k + 2
    if (k + 2 < n_chunks) {
      const int c_next = (chunk0 + k + 2) * cc;
      load_x<T, kAligned>(p, b, p0, c_next, xs + s * cc * tp);
      load_gb<T, kAligned>(p, b, c_next, n_live, live_o, gs + s * O * cc, bs + s * O * cc);
      cp_async_commit();
    }
  }
}

template <typename T, bool kAligned>
cudaError_t launch(const Params& p, int batch, int n_tiles, int threads, int smem_bytes,
                   cudaStream_t stream) {
  auto kernel = isla_norm_kernel<T, kAligned>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();  // the attribute call also set the last error: clear it
      return err;
    }
  }
  kernel<<<dim3(n_tiles * p.n_groups, batch), threads, smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Launches the fused ISLA norm on `stream`; returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue, without launching, for a tiling it cannot run).
// The caller (ops/isla.py::isla_norm) checks shapes, dtypes and contiguity and
// picks the tiling (ops/isla.py::launch_config); `aligned` selects the cp.async
// path and needs h*w and c to be multiples of 16 bytes' worth of elements and
// 16-byte-aligned x, gamma, beta and out. x may be a row shard: rows [row0, row0 + H)
// of an image full_h rows high (the 2-D mesh's spatial mode), whose mask is resized to
// the whole image and read at those rows (full_h = H, row0 = 0 for a whole image).
extern "C" int isla_norm_forward(int bf16, int aligned, const void* x, const void* mean,
                                 const void* var, const void* mask, const void* gamma,
                                 const void* beta, void* out, int batch, int C, int H, int W,
                                 int O, int HS, int WS, int row0, int full_h, float eps,
                                 int relu, int tp,
                                 int threads, int cc, int n_groups, int chunks_per_group,
                                 int smem_bytes, void* stream) {
  int tp_log2 = 0;
  while ((1 << tp_log2) < tp) ++tp_log2;
  if (O < 1 || O > kMaxObjects || tp != (1 << tp_log2) || tp < 16 || tp > 128 ||
      threads * 16 != cc * tp || threads % 32 != 0 || threads > kMaxThreads || threads < tp ||
      n_groups < 1 || chunks_per_group < 1 || (n_groups - 1) * chunks_per_group * cc >= C ||
      row0 < 0 || full_h < row0 + H)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x; p.mean = static_cast<const float*>(mean); p.var = static_cast<const float*>(var);
  p.mask = mask; p.gamma = gamma; p.beta = beta; p.out = out;
  p.C = C; p.P = H * W; p.W = W; p.O = O; p.HS = HS; p.WS = WS; p.row0 = row0;
  p.scale_y = static_cast<float>(HS) / static_cast<float>(full_h);
  p.scale_x = static_cast<float>(WS) / static_cast<float>(W);
  p.eps = eps; p.relu = relu;
  p.tp = tp; p.tp_log2 = tp_log2; p.cc = cc;
  p.n_groups = n_groups; p.chunks_per_group = chunks_per_group;
  const int n_tiles = (p.P + tp - 1) / tp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16)
    err = aligned ? launch<__nv_bfloat16, true>(p, batch, n_tiles, threads, smem_bytes, s)
                  : launch<__nv_bfloat16, false>(p, batch, n_tiles, threads, smem_bytes, s);
  else
    err = aligned ? launch<float, true>(p, batch, n_tiles, threads, smem_bytes, s)
                  : launch<float, false>(p, batch, n_tiles, threads, smem_bytes, s);
  return static_cast<int>(err);
}
