// Shared pieces of the bilinear-sampling kernels (bilinear_sample.cu,
// tps_warp.cu): loads and stores in the image dtype, the pixel-index map of
// a normalized coordinate, and the border-clamped 4-tap lerp.
//
// Coordinates follow partseg_tpu_torch/partops/coords.py: (y, x) in [-1, 1]
// at pixel centres, align_corners=False, so the continuous pixel index is
// f = (c + 1)·n/2 − 0.5, and f's floor and floor + 1 are the two taps.

#pragma once

#include <cuda_bf16.h>

namespace partseg {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
// Round to nearest even, as torch's .to(torch.bfloat16).
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Continuous pixel index of a normalized coordinate, rounded after each
// operation as the plain version's separate f32 ops are (no FMA). Clamped
// to [-2, n + 1] so the int conversion cannot overflow (NaN goes to -2):
// beyond -1 and n both taps clamp to the same border pixel, so the clamp
// changes neither the output nor its derivatives.
__device__ __forceinline__ float to_pixel(float c, int n) {
  const float f = __fsub_rn(__fmul_rn(__fadd_rn(c, 1.0f), 0.5f * (float)n), 0.5f);
  return fminf(fmaxf(f, -2.0f), (float)n + 1.0f);
}

// Tap rows/columns of a pixel index f, clamped into [lo, hi], and the lerp
// weight f − floor(f).
struct Axis {
  int i0, i1;
  float t;
};

__device__ __forceinline__ Axis axis_taps(float f, int lo, int hi) {
  const float f0 = floorf(f);
  const int i = (int)f0;
  return {min(max(i, lo), hi), min(max(i + 1, lo), hi), f - f0};
}

// The four taps of one channel, read from an NHWC image row base.
template <typename T>
struct Quad {
  float v00, v01, v10, v11;
  __device__ __forceinline__ Quad(const T* img, int w, int c, Axis y, Axis x, int ch) {
    v00 = load_f32(img + ((size_t)y.i0 * w + x.i0) * c + ch);
    v01 = load_f32(img + ((size_t)y.i0 * w + x.i1) * c + ch);
    v10 = load_f32(img + ((size_t)y.i1 * w + x.i0) * c + ch);
    v11 = load_f32(img + ((size_t)y.i1 * w + x.i1) * c + ch);
  }
  // partops/warp.py's order: top row, bottom row, then y. f32 throughout.
  __device__ __forceinline__ float top(float wx) const { return v00 + (v01 - v00) * wx; }
  __device__ __forceinline__ float bot(float wx) const { return v10 + (v11 - v10) * wx; }
  __device__ __forceinline__ float lerp(float wy, float wx) const {
    const float t = top(wx);
    return t + (bot(wx) - t) * wy;
  }
};

// The four taps of one point as element offsets into an NHWC image, and
// its lerp weights: computed once per point, then shared by every channel.
struct Taps {
  size_t o00, o01, o10, o11;
  float wy, wx;
  __device__ __forceinline__ Taps(float cy, float cx, int h, int w, int c) {
    const Axis y = axis_taps(to_pixel(cy, h), 0, h - 1);
    const Axis x = axis_taps(to_pixel(cx, w), 0, w - 1);
    const size_t r0 = (size_t)y.i0 * w, r1 = (size_t)y.i1 * w;
    o00 = (r0 + x.i0) * c;
    o01 = (r0 + x.i1) * c;
    o10 = (r1 + x.i0) * c;
    o11 = (r1 + x.i1) * c;
    wy = y.t;
    wx = x.t;
  }
};

// Quad::lerp's arithmetic on tap values already loaded, and the grads
// variant's two differences: the same expressions, so the same roundings.
__device__ __forceinline__ float lerp4(float v00, float v01, float v10, float v11,
                                       float wy, float wx) {
  const float top = v00 + (v01 - v00) * wx;
  return top + ((v10 + (v11 - v10) * wx) - top) * wy;
}
__device__ __forceinline__ float diff_y(float v00, float v01, float v10, float v11, float wx) {
  return (v10 + (v11 - v10) * wx) - (v00 + (v01 - v00) * wx);
}
__device__ __forceinline__ float diff_x(float v00, float v01, float v10, float v11, float wy) {
  const float dx0 = v01 - v00;
  return dx0 + ((v11 - v10) - dx0) * wy;
}

}  // namespace partseg
