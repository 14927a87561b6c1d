// Fused ISLA norm backward for Hopper (sm_90a).
//
// The gradient of the whole pass that isla_norm.cu computes forward (the BN apply with
// given statistics, the bilinear resize of the stage mask, the mask-weighted per-object
// affine and the optional ReLU). It replaces the backward of the JAX package's Pallas
// kernel ops/pallas/isla.py::isla_modulate (_bwd, einsums under jax.custom_vjp, lines
// 103-128 in the tree of commit d0260d0^) together with the backward passes of the BN,
// the resize and the ReLU around it. For batch b, channel c and pixel p, with
// r = 1 / sqrt(var_c + eps), y = (x - mean_c) r, m_o the resized mask, d = sum_o m_o + 1e-6,
// G = sum_o m_o gamma_oc, B = sum_o m_o beta_oc and out = y (G/d + 1) + B/d, one launch
// takes the output gradient g (g' = g [out > 0] with the ReLU) and writes:
//
//   dx_direct = g' (G/d + 1) r                          (B, C, H, W), T
//   per (b, span, c): sum_p a and sum_p a y, a = g' (G/d + 1)
//                     (dmean = -r sum a, dvar = -r^2 sum a y / 2, summed by the caller)
//   per (b, span, o, c): sum_p (m_o/d) g' y and sum_p (m_o/d) g'   (dgamma, dbeta)
//   per (group, b, o, p): (U_o - sum_o' (m_o'/d) U_o') / d,
//                     U_o = sum_c g' y gamma_oc + g' beta_oc      (dm of the resized mask)
//
// The caller (ops/isla.py::isla_norm_backward) sums the partial buffers over spans and
// channel groups in a fixed order, so the result is the same bits on every run, and
// applies the transposed resize (two small GEMMs) to dm.
//
// What bounds it: bytes on the main path. Per element of x it reads x and g and writes
// dx (12 bytes in f32) against 4 flops per live object for G and B, 4 per live object for
// dgamma and dbeta, and 4 per object slot (live or not: a pad object's mask gradient is
// not zero) for U. At o = 31 slots and about one live object per pixel that is some 130
// flops per 12 bytes, under the H100's f32 balance point of 20 flops per byte
// (chip_smoke.py::isla_bwd_cost counts both). The design keeps every intermediate on
// chip:
//
// * Grid: one CTA per (span of pixel tiles, channel group, batch). A tile is tp pixels of
//   the flattened h*w axis (16, 32 or 64) and a chunk is cc = 2048 / tp channels, so each
//   of the 128 threads owns 4 pixels x 4 channels of a chunk. A span walks a few tiles so
//   that the per-object partial sums written to device memory stay small.
// * Per tile, the (o, tp) resized mask is rebuilt in shared memory from the source mask
//   (the forward's taps and weights), summed over objects and folded with 1/d; objects
//   that are zero on the whole tile drop out of the G, B, dgamma and dbeta work. Nothing
//   of the forward is stored: out and its sign are recomputed.
// * Per chunk: gamma and beta of every object as f32 in shared memory; the elementwise
//   pass writes dx and stages g' y and g' in shared memory (rows padded by one word);
//   threads then contract those stages over pixels (dgamma, dbeta of the live objects,
//   accumulated in shared memory over the span) and over channels (U, 4 objects x 4
//   pixels per thread in registers over the group's chunks).
// * Every sum has one owner per step and a fixed order (warp shuffles in a fixed
//   pattern, one thread per shared accumulator), and there are no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "isla_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTileElems = 16 * kThreads;  // tp * cc

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
  float* part_dm;      // (n_groups, B, O, P)
  int B, C, P, W, O, O4, HS, WS;
  float scale_y, scale_x, eps;
  int relu;
  int tp, tp_log2, cc;
  int n_tiles, tiles_per_span, n_spans;
  int n_groups, chunks_per_group, cg;  // cg = chunks_per_group * cc
};

// 4-byte words of shared memory one block uses (ops/isla.py::_bwd_smem_bytes mirrors it).
__host__ __device__ inline int smem_words(int O, int O4, int tp, int cc, int cg) {
  return O * tp + tp + O4 * tp + tp + 2 * O4 * cc + 2 * cc * (tp + 1) + 2 * cg + 2 * O * cg +
         2 * O + 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) isla_norm_bwd_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int tp = p.tp, cc = p.cc, O = p.O, O4 = p.O4, cg = p.cg;
  const int row = tp + 1;              // padded row of the gradient stages
  float* mt = smem;                    // [O][tp] resized mask, then / d
  float* inv = mt + O * tp;            // [tp] 1 / d
  float* us = inv + tp;                // [O4][tp] U of this group's channels
  float* ws = us + O4 * tp;            // [tp] sum_o (m_o / d) U_o
  float* gsm = ws + tp;                // [O4][cc] gamma of the chunk, f32
  float* bsm = gsm + O4 * cc;          // [O4][cc] beta of the chunk, f32
  float* gys = bsm + O4 * cc;          // [cc][tp + 1] g' y
  float* gps = gys + cc * row;         // [cc][tp + 1] g'
  float* acc_s = gps + cc * row;       // [2][cg] sum a, sum a y over the span
  float* acc_gb = acc_s + 2 * cg;      // [2][O][cg] dgamma, dbeta over the span
  int* flag = reinterpret_cast<int*>(acc_gb + 2 * O * cg);  // [O] object non-zero in the tile
  int* live = flag + O;                // [O] ids of those objects
  int* n_live_s = live + O;            // [1]

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int span = blockIdx.x / p.n_groups;
  const int group = blockIdx.x - span * p.n_groups;
  const int chunk0 = group * p.chunks_per_group;
  const int n_chunks = min(p.chunks_per_group, (p.C + cc - 1) / cc - chunk0);
  const int tile0 = span * p.tiles_per_span;
  const int tile_end = min(tile0 + p.tiles_per_span, p.n_tiles);

  // elementwise pass: 4 pixels x 4 channels per thread
  const int quads_log2 = p.tp_log2 - 2;
  const int pl = (tid & ((1 << quads_log2) - 1)) * 4;
  const int cl = (tid >> quads_log2) * 4;
  // U contraction: 4 objects x 4 pixels per block of work, at most two per thread
  const int n_ublk = (O4 >> 2) << quads_log2;

  const T* x = static_cast<const T*>(p.x);
  const T* grad = static_cast<const T*>(p.grad);
  const T* gamma = static_cast<const T*>(p.gamma);
  const T* beta = static_cast<const T*>(p.beta);
  T* dx = static_cast<T*>(p.dx);
  const size_t plane = static_cast<size_t>(p.HS) * p.WS;
  const T* m_b = static_cast<const T*>(p.mask) + static_cast<size_t>(b) * O * plane;

  for (int i = tid; i < 2 * cg + 2 * O * cg; i += kThreads) acc_s[i] = 0.0f;  // acc_gb follows

  for (int tile = tile0; tile < tile_end; ++tile) {
    const int p0 = tile * tp;

    // 1. The resized mask tile and the objects that are non-zero on it.
    for (int o = tid; o < O; o += kThreads) flag[o] = 0;
    __syncthreads();
    for (int i = tid; i < O * tp; i += kThreads) {
      const int o = i >> p.tp_log2, q = i & (tp - 1);
      float v = 0.0f;
      if (p0 + q < p.P) {
        const int y = (p0 + q) / p.W;
        int y0, y1, x0, x1;
        float wy, wx;
        src_taps(y, p.HS, p.scale_y, y0, y1, wy);
        src_taps(p0 + q - y * p.W, p.WS, p.scale_x, x0, x1, wx);
        const T* mo = m_b + o * plane;
        const float s[4] = {load_f32(mo + y0 * p.WS + x0), load_f32(mo + y0 * p.WS + x1),
                            load_f32(mo + y1 * p.WS + x0), load_f32(mo + y1 * p.WS + x1)};
        v = bilerp(s, wy, wx);
      }
      mt[i] = v;
      if (v != 0.0f) flag[o] = 1;  // every writer stores the same value
    }
    __syncthreads();
    for (int q = tid; q < tp; q += kThreads) {
      float sum = 0.0f;
      for (int o = 0; o < O; ++o) sum += mt[o * tp + q];
      inv[q] = 1.0f / (sum + kMaskEps);
    }
    if (tid == 0) {
      int n = 0;
      for (int o = 0; o < O; ++o)
        if (flag[o]) live[n++] = o;
      *n_live_s = n;
    }
    __syncthreads();
    const int n_live = *n_live_s;
    for (int i = tid; i < n_live * tp; i += kThreads) {
      const int q = i & (tp - 1);
      mt[live[i >> p.tp_log2] * tp + q] *= inv[q];
    }
    // (published by the barrier after the first chunk's gamma and beta)

    float acc_u[2][4][4] = {};
    for (int k = 0; k < n_chunks; ++k) {
      const int c0 = (chunk0 + k) * cc;

      // 2. gamma and beta of every object (a pad object's mask gradient needs its own).
      for (int i = tid; i < O4 * cc; i += kThreads) {
        const int o = i / cc, q = i - o * cc, c = c0 + q;
        const bool ok = o < O && c < p.C;
        const size_t off = (static_cast<size_t>(b) * O + o) * p.C + c;
        gsm[i] = ok ? load_f32(gamma + off) : 0.0f;
        bsm[i] = ok ? load_f32(beta + off) : 0.0f;
      }
      __syncthreads();

      // 3. Elementwise: recompute out and g', write dx, stage g' y and g'.
      {
        float gd[4][4] = {}, bd[4][4] = {};  // [channel][pixel] G/d and B/d
        for (int l = 0; l < n_live; ++l) {
          const int o = live[l];
          float m4[4], g4[4], b4[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) m4[i] = mt[o * tp + pl + i];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            g4[j] = gsm[o * cc + cl + j];
            b4[j] = bsm[o * cc + cl + j];
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              gd[j][i] = fmaf(g4[j], m4[i], gd[j][i]);
              bd[j][i] = fmaf(b4[j], m4[i], bd[j][i]);
            }
          }
        }
        float sa[4], say[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + cl + j;
          const bool c_ok = c < p.C;
          const float mu = c_ok ? __ldg(p.mean + c) : 0.0f;
          const float rstd = c_ok ? 1.0f / sqrtf(__ldg(p.var + c) + p.eps) : 0.0f;
          sa[j] = 0.0f;
          say[j] = 0.0f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int px = p0 + pl + i;
            const bool ok = c_ok && px < p.P;
            const size_t idx = (static_cast<size_t>(b) * p.C + c) * p.P + px;
            const float xv = ok ? load_f32(x + idx) : 0.0f;
            const float gv = ok ? load_f32(grad + idx) : 0.0f;
            const float y = (xv - mu) * rstd;
            const float scale = gd[j][i] + 1.0f;
            const float out = fmaf(y, scale, bd[j][i]);
            const float gq = (p.relu && !(out > 0.0f)) ? 0.0f : gv;
            const float a = gq * scale;
            if (ok) dx[idx] = from_f32<T>(a * rstd);
            sa[j] += a;
            say[j] = fmaf(a, y, say[j]);
            gys[(cl + j) * row + pl + i] = gq * y;
            gps[(cl + j) * row + pl + i] = gq;
          }
        }
        // sum over the lanes that share these channels (consecutive lanes, one warp)
        for (int off = 1 << (quads_log2 - 1); off > 0; off >>= 1) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sa[j] += __shfl_xor_sync(0xffffffffu, sa[j], off);
            say[j] += __shfl_xor_sync(0xffffffffu, say[j], off);
          }
        }
        if (pl == 0) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc_s[k * cc + cl + j] += sa[j];
            acc_s[cg + k * cc + cl + j] += say[j];
          }
        }
      }
      __syncthreads();

      // 4. dgamma and dbeta of the live objects: contract the stages over pixels.
      for (int i = tid; i < n_live * cc; i += kThreads) {
        const int l = i / cc, q = i - l * cc, o = live[l];
        const float* mo = mt + o * tp;
        const float* gy = gys + q * row;
        const float* gp = gps + q * row;
        float sg = 0.0f, sb = 0.0f;
        for (int px = 0; px < tp; ++px) {
          sg = fmaf(mo[px], gy[px], sg);
          sb = fmaf(mo[px], gp[px], sb);
        }
        acc_gb[o * cg + k * cc + q] += sg;
        acc_gb[(O + o) * cg + k * cc + q] += sb;
      }

      // 5. U of every object: contract the stages over the chunk's channels.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int blk = tid + r * kThreads;
        if (blk < n_ublk) {
          const int pq = (blk & ((1 << quads_log2) - 1)) * 4, oq = (blk >> quads_log2) * 4;
          for (int c = 0; c < cc; ++c) {
            float gy4[4], gp4[4], g4[4], b4[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              gy4[i] = gys[c * row + pq + i];
              gp4[i] = gps[c * row + pq + i];
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              g4[j] = gsm[(oq + j) * cc + c];
              b4[j] = bsm[(oq + j) * cc + c];
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
#pragma unroll
              for (int i = 0; i < 4; ++i)
                acc_u[r][j][i] = fmaf(g4[j], gy4[i], fmaf(b4[j], gp4[i], acc_u[r][j][i]));
            }
          }
        }
      }
      __syncthreads();  // the stages and gamma/beta are refilled by the next chunk
    }

    // 6. dm of this group's channels: (U_o - sum_o' (m_o'/d) U_o') / d.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int blk = tid + r * kThreads;
      if (blk < n_ublk) {
        const int pq = (blk & ((1 << quads_log2) - 1)) * 4, oq = (blk >> quads_log2) * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) us[(oq + j) * tp + pq + i] = acc_u[r][j][i];
        }
      }
    }
    __syncthreads();
    for (int q = tid; q < tp; q += kThreads) {
      float s = 0.0f;
      for (int l = 0; l < n_live; ++l) {
        const int o = live[l];
        s = fmaf(mt[o * tp + q], us[o * tp + q], s);
      }
      ws[q] = s;
    }
    __syncthreads();
    float* dm = p.part_dm + (static_cast<size_t>(group) * p.B + b) * O * p.P;
    for (int i = tid; i < O * tp; i += kThreads) {
      const int o = i >> p.tp_log2, q = i & (tp - 1);
      if (p0 + q < p.P) dm[static_cast<size_t>(o) * p.P + p0 + q] = (us[o * tp + q] - ws[q]) * inv[q];
    }
    __syncthreads();  // mt, flags and us are rebuilt by the next tile
  }

  // 7. This span's per-channel and per-object sums.
  const int cbase = chunk0 * cc;
  float* ps = p.part_stats + (static_cast<size_t>(b) * p.n_spans + span) * 2 * p.C;
  for (int i = tid; i < 2 * cg; i += kThreads) {
    const int s = i / cg, q = i - s * cg;
    if (cbase + q < p.C) ps[s * p.C + cbase + q] = acc_s[i];
  }
  float* pgb = p.part_gb + (static_cast<size_t>(b) * p.n_spans + span) * 2 * O * p.C;
  for (int i = tid; i < 2 * O * cg; i += kThreads) {
    const int so = i / cg, q = i - so * cg;
    if (cbase + q < p.C) pgb[static_cast<size_t>(so) * p.C + cbase + q] = acc_gb[i];
  }
}

template <typename T>
cudaError_t launch(const Params& p, int smem_bytes, cudaStream_t stream) {
  auto kernel = isla_norm_bwd_kernel<T>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(p.n_spans * p.n_groups, p.B), kThreads, smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Launches the ISLA norm backward on `stream`; returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue, without launching, for a tiling it cannot run, and the
// runtime's error when the block wants more shared memory than the card has). The caller
// (ops/isla.py::isla_norm_backward) checks shapes, dtypes and contiguity, picks the tiling
// (ops/isla.py::backward_config) and allocates the outputs: dx like x, part_stats
// (B, n_spans, 2, C), part_gb (B, n_spans, 2, O, C) and part_dm (n_groups, B, O, H*W), f32,
// with n_spans = ceil(ceil(H*W / tp) / tiles_per_span).
extern "C" int isla_norm_backward(int bf16, const void* x, const void* mean, const void* var,
                                  const void* mask, const void* gamma, const void* beta,
                                  const void* grad, void* dx, void* part_stats, void* part_gb,
                                  void* part_dm, int batch, int C, int H, int W, int O, int HS,
                                  int WS, float eps, int relu, int tp, int tiles_per_span,
                                  int n_groups, int chunks_per_group, void* stream) {
  int tp_log2 = 0;
  while ((1 << tp_log2) < tp) ++tp_log2;
  if (O < 1 || O > kMaxObjects || tp != (1 << tp_log2) || tp < 16 || tp > 64 ||
      tiles_per_span < 1 || n_groups < 1 || chunks_per_group < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cc = kTileElems / tp;
  if (n_groups * chunks_per_group * cc < C || (n_groups - 1) * chunks_per_group * cc >= C)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x; p.mean = static_cast<const float*>(mean); p.var = static_cast<const float*>(var);
  p.mask = mask; p.gamma = gamma; p.beta = beta; p.grad = grad; p.dx = dx;
  p.part_stats = static_cast<float*>(part_stats);
  p.part_gb = static_cast<float*>(part_gb);
  p.part_dm = static_cast<float*>(part_dm);
  p.B = batch; p.C = C; p.P = H * W; p.W = W; p.O = O; p.O4 = (O + 3) / 4 * 4;
  p.HS = HS; p.WS = WS;
  p.scale_y = static_cast<float>(HS) / static_cast<float>(H);
  p.scale_x = static_cast<float>(WS) / static_cast<float>(W);
  p.eps = eps; p.relu = relu;
  p.tp = tp; p.tp_log2 = tp_log2; p.cc = cc;
  p.n_tiles = (p.P + tp - 1) / tp;
  p.tiles_per_span = tiles_per_span;
  p.n_spans = (p.n_tiles + tiles_per_span - 1) / tiles_per_span;
  p.n_groups = n_groups; p.chunks_per_group = chunks_per_group;
  p.cg = chunks_per_group * cc;
  const int smem_bytes = 4 * smem_words(O, p.O4, tp, cc, p.cg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16 ? launch<__nv_bfloat16>(p, smem_bytes, s) : launch<float>(p, smem_bytes, s);
  return static_cast<int>(err);
}
