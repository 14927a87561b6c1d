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

}  // namespace
