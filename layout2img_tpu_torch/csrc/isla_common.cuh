// Helpers shared by the ISLA norm's forward (isla_norm.cu) and backward
// (isla_norm_bwd.cu) kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxObjects = 64;  // live objects are tracked in one 64-bit word (forward)
constexpr float kMaskEps = 1e-6f;

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One element of global memory as f32 (bf16: its bits are the top half of an f32).
__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __uint_as_float(static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p)))
                         << 16);
}

// Source taps of output index `dst` for F.interpolate's bilinear rule with
// align_corners=False: half-pixel centres, negative positions clamped to 0, the
// upper tap clamped to the last row. Weight of i1 is w1, of i0 is 1 - w1.
__device__ __forceinline__ void src_taps(int dst, int in, float scale, int& i0, int& i1,
                                         float& w1) {
  const float src = fmaxf((dst + 0.5f) * scale - 0.5f, 0.0f);
  i0 = min(static_cast<int>(src), in - 1);  // src >= 0: truncation is floor
  i1 = min(i0 + 1, in - 1);
  w1 = src - static_cast<float>(i0);
}

// The bilinear value at 2x2 source taps s = {(y0,x0), (y0,x1), (y1,x0), (y1,x1)}:
// rows first, then columns, the order of the plain W_y @ m @ W_x^T.
__device__ __forceinline__ float bilerp(const float s[4], float wy, float wx) {
  const float r0 = (1.0f - wy) * s[0] + wy * s[2];
  const float r1 = (1.0f - wy) * s[1] + wy * s[3];
  return (1.0f - wx) * r0 + wx * r1;
}

// Four consecutive elements (16-byte aligned for f32, 8-byte for bf16) as f32.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]);
  const float2 b = __bfloat1622float2(q[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<const unsigned*>(&lo);
  t.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = t;
}

}  // namespace
