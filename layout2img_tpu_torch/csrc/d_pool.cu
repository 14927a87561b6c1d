// The discriminator's 2x2 average-pool downsampling for Hopper (sm_90a), one launch
// each way.
//
// Replaces no TPU kernel: the JAX package leaves the pool (nn/blocks.py::avg_pool2x)
// and the add after it to XLA, which fuses them. In the port, PyTorch ran them as
// separate kernels, and its NCHW avg_pool2d backward (one thread per input element,
// 64-bit index divisions) was the bulk of a train step's pooling time. Forward, for
// a and b of (N, C, H, W) and r of (N, C, H/2, W/2), every input optional but a:
//
//   out = avgpool2x2(a) [+ avgpool2x2(b)] [+ r]
//
// (nn/blocks.py: DiscResBlock's output and shortcut pooled and summed in one
// launch; DiscOptimizedBlock's image shortcut alone, then its output with the
// shortcut's 1x1 conv added as r). Backward: the gradient of a and of b is the
// same tensor, the output gradient upsampled 2x and scaled by 0.25, written once;
// r's gradient is the output gradient itself (no launch).
//
// What bounds it: bytes. A forward reads 4 input elements of a (and of b) and 1 of
// r per output, a backward 1 per 4 written, with a handful of adds each: far below
// the H100's balance point. The design moves each byte once with wide accesses:
//
// * Flattened rows: an (N, C, H, W) tensor is N*C*H rows of W, and output row i
//   reads input rows 2i and 2i + 1. No index needs N, C or H.
// * Vector path (W a multiple of 8, every pointer 16-byte aligned): a thread takes
//   a 2-row x 8-column patch: one 16-byte load per row of a and of b in bf16 (two in
//   f32), 4 outputs stored at once. The backward's thread reads those 4 gradients
//   and writes the 2 x 8 patch. Other widths take one 2x2 window per thread.
// * Arithmetic in f32 in PyTorch's order: each window summed from 0 row by row,
//   times 0.25 (== PyTorch's / 4), then + pooled b, then + r, rounded once to the
//   working type. In f32 that is F.avg_pool2d(a, 2) + F.avg_pool2d(b, 2) + r bit for
//   bit; in bf16 it rounds once where that composition rounds three times. The
//   backward's 0 + g * 0.25 is avg_pool2d's backward bit for bit in either type.
//   The _rn intrinsics keep nvcc from contracting a multiply and an add.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct PoolParams {
  const void* a;    // (rows_out * 2, W), T
  const void* b;    // the same shape as a, or null
  const void* r;    // (rows_out, W / 2), T, or null
  void* out;        // (rows_out, W / 2), T
  unsigned rows_out, W;
  unsigned n_items;  // threads with work: patches (vector path) or outputs (scalar path)
};

struct PoolBwdParams {
  const void* g;  // (rows_out, W / 2), T
  void* d;        // (rows_out * 2, W), T
  unsigned rows_out, W, n_items;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Eight consecutive elements (16-byte aligned) as f32.
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  const float4 y = *reinterpret_cast<const float4*>(p + 4);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // bf16 bits are the top half of an f32
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// Four consecutive elements (16-byte aligned for f32, 8-byte for bf16).
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(x.x << 16); v[1] = __uint_as_float(x.x & 0xffff0000u);
  v[2] = __uint_as_float(x.y << 16); v[3] = __uint_as_float(x.y & 0xffff0000u);
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&t);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
}
__device__ __forceinline__ void store8(float* p, const float v[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
}

// The window mean of columns 2j, 2j + 1 of rows r0, r1: 0 + r0[2j] + r0[2j+1] +
// r1[2j] + r1[2j+1], in that order, times 0.25.
__device__ __forceinline__ float window_mean(float x00, float x01, float x10, float x11) {
  float s = __fadd_rn(0.0f, x00);
  s = __fadd_rn(s, x01);
  s = __fadd_rn(s, x10);
  s = __fadd_rn(s, x11);
  return __fmul_rn(s, 0.25f);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads) pool2x2_forward_kernel(const PoolParams p) {
  const unsigned item = blockIdx.x * kThreads + threadIdx.x;
  if (item >= p.n_items) return;
  const T* a = static_cast<const T*>(p.a);
  const T* b = static_cast<const T*>(p.b);
  const T* r = static_cast<const T*>(p.r);
  T* out = static_cast<T*>(p.out);
  const unsigned wo = p.W >> 1;
  if constexpr (kVec) {
    const unsigned per_row = p.W >> 3;  // patches per output row
    const unsigned row = item / per_row, col = item - row * per_row;
    const size_t in0 = static_cast<size_t>(2 * row) * p.W + 8 * col;
    const size_t o0 = static_cast<size_t>(row) * wo + 4 * col;
    float a0[8], a1[8], b0[8], b1[8], rv[4], v[4];
    load8(a + in0, a0);
    load8(a + in0 + p.W, a1);
    if (b) {
      load8(b + in0, b0);
      load8(b + in0 + p.W, b1);
    }
    if (r) load4(r + o0, rv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = window_mean(a0[2 * j], a0[2 * j + 1], a1[2 * j], a1[2 * j + 1]);
      if (b)
        v[j] = __fadd_rn(v[j], window_mean(b0[2 * j], b0[2 * j + 1], b1[2 * j], b1[2 * j + 1]));
      if (r) v[j] = __fadd_rn(v[j], rv[j]);
    }
    store4(out + o0, v);
  } else {
    const unsigned row = item / wo, col = item - row * wo;
    const size_t in0 = static_cast<size_t>(2 * row) * p.W + 2 * col;
    const size_t o0 = static_cast<size_t>(row) * wo + col;
    float v = window_mean(to_f32(a[in0]), to_f32(a[in0 + 1]), to_f32(a[in0 + p.W]),
                          to_f32(a[in0 + p.W + 1]));
    if (b)
      v = __fadd_rn(v, window_mean(to_f32(b[in0]), to_f32(b[in0 + 1]), to_f32(b[in0 + p.W]),
                                   to_f32(b[in0 + p.W + 1])));
    if (r) v = __fadd_rn(v, to_f32(r[o0]));
    out[o0] = from_f32<T>(v);
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads) pool2x2_backward_kernel(const PoolBwdParams p) {
  const unsigned item = blockIdx.x * kThreads + threadIdx.x;
  if (item >= p.n_items) return;
  const T* g = static_cast<const T*>(p.g);
  T* d = static_cast<T*>(p.d);
  const unsigned wo = p.W >> 1;
  if constexpr (kVec) {
    const unsigned per_row = p.W >> 3;
    const unsigned row = item / per_row, col = item - row * per_row;
    const size_t in0 = static_cast<size_t>(2 * row) * p.W + 8 * col;
    float gv[4], v[8];
    load4(g + static_cast<size_t>(row) * wo + 4 * col, gv);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[2 * j] = v[2 * j + 1] = __fadd_rn(0.0f, __fmul_rn(gv[j], 0.25f));
    store8(d + in0, v);
    store8(d + in0 + p.W, v);
  } else {
    const unsigned row = item / wo, col = item - row * wo;
    const size_t in0 = static_cast<size_t>(2 * row) * p.W + 2 * col;
    const T v = from_f32<T>(
        __fadd_rn(0.0f, __fmul_rn(to_f32(g[static_cast<size_t>(row) * wo + col]), 0.25f)));
    d[in0] = v;
    d[in0 + 1] = v;
    d[in0 + p.W] = v;
    d[in0 + p.W + 1] = v;
  }
}

template <typename K, typename P>
cudaError_t launch(K kernel, const P& p, cudaStream_t stream) {
  if (p.n_items == 0) return cudaSuccess;
  kernel<<<(p.n_items + kThreads - 1) / kThreads, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// Threads of work for (rows_out, W): patches of 2 x 8 inputs, or 2 x 2 windows.
bool items(unsigned rows_out, unsigned W, int vec, unsigned& n) {
  if (W == 0 || W % 2 != 0 || (vec && W % 8 != 0)) return false;
  const unsigned long long total =
      static_cast<unsigned long long>(rows_out) * (vec ? W / 8 : W / 2);
  if (total > 0xffffffffull - kThreads) return false;
  n = static_cast<unsigned>(total);
  return true;
}

}  // namespace

// out (rows_out, W/2) = the 2x2 means of a (2 rows_out, W) [+ those of b] [+ r], on
// `stream`; b and r may be null. `vec` selects the 2 x 8 patch path, which needs W a
// multiple of 8 and 16-byte-aligned pointers. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue, without launching, for sizes it cannot run). The
// caller (ops/pool.py::pool2x2_add) checks shapes, dtypes and contiguity.
extern "C" int pool2x2_forward(int bf16, int vec, const void* a, const void* b, const void* r,
                               void* out, unsigned rows_out, unsigned W, void* stream) {
  PoolParams p{a, b, r, out, rows_out, W, 0};
  if (!items(rows_out, W, vec, p.n_items)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16)
    err = vec ? launch(pool2x2_forward_kernel<__nv_bfloat16, true>, p, s)
              : launch(pool2x2_forward_kernel<__nv_bfloat16, false>, p, s);
  else
    err = vec ? launch(pool2x2_forward_kernel<float, true>, p, s)
              : launch(pool2x2_forward_kernel<float, false>, p, s);
  return static_cast<int>(err);
}

// d (2 rows_out, W) = g (rows_out, W/2) upsampled 2x, times 0.25: the gradient of
// every pooled input. Same `vec` rule and return value as pool2x2_forward.
extern "C" int pool2x2_backward(int bf16, int vec, const void* g, void* d, unsigned rows_out,
                                unsigned W, void* stream) {
  PoolBwdParams p{g, d, rows_out, W, 0};
  if (!items(rows_out, W, vec, p.n_items)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16)
    err = vec ? launch(pool2x2_backward_kernel<__nv_bfloat16, true>, p, s)
              : launch(pool2x2_backward_kernel<__nv_bfloat16, false>, p, s);
  else
    err = vec ? launch(pool2x2_backward_kernel<float, true>, p, s)
              : launch(pool2x2_backward_kernel<float, false>, p, s);
  return static_cast<int>(err);
}
