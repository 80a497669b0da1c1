// Border-clamped bilinear sampling at arbitrary coordinates (CUDA C++, sm_90a).
//
// Replaces the Pallas TPU kernel partseg_tpu/partops/pallas/bilinear_warp.py
// (`bilinear_sample_fused` -> `_run_kernel` -> `_kernel` / `_interp_body`).
// For every (b, n): (fy, fx) = pixel index of coords[b, n] (y, x in [-1, 1]),
// four border-clamped taps of the NHWC image, and
//   out[b, n, c] = lerp_y(lerp_x(v00, v01), lerp_x(v10, v11)).
// The grads variant (the autograd forward) also writes the tap differences
//   d_fy = bot − top,  d_fx = (v01 − v00) + ((v11 − v10) − (v01 − v00))·wy,
// the formulas of `_interp_body`'s with_grads branch, so the backward needs
// no gather for d_coords. At a clamped border the two taps coincide and the
// differences are 0, as on the TPU.
//
// What bounds it on the H100: device memory and, at the training shapes,
// launch latency. Each point reads 8 bytes of coords and 4·C taps and writes
// C values (3·C f32 in the grads variant); the arithmetic is a few flops per
// byte. The TPU kernel folded the gathers into [T, H] selector matmuls only
// because the TPU gathers badly; here one thread per (b, n) gathers its taps
// directly (they fall in L1/L2: neighbouring points read neighbouring
// pixels), lerps in f32 and stores once in the output dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bilinear.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, bool kGrads>
__global__ void __launch_bounds__(kThreads)
bilinear_sample_kernel(const T* __restrict__ img, const float* __restrict__ coords,
                       void* __restrict__ out, float* __restrict__ d_fy,
                       float* __restrict__ d_fx, int h, int w, int c, int n) {
  const int b = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  const size_t row = (size_t)b * n + p;
  const float2 cr = reinterpret_cast<const float2*>(coords)[row];
  const partseg::Axis ay = partseg::axis_taps(partseg::to_pixel(cr.x, h), 0, h - 1);
  const partseg::Axis ax = partseg::axis_taps(partseg::to_pixel(cr.y, w), 0, w - 1);
  const T* ib = img + (size_t)b * h * w * c;
  for (int ch = 0; ch < c; ++ch) {
    const partseg::Quad<T> q(ib, w, c, ay, ax, ch);
    const size_t o = row * c + ch;
    if (kGrads) {
      const float top = q.top(ax.t), bot = q.bot(ax.t);
      static_cast<float*>(out)[o] = top + (bot - top) * ay.t;
      d_fy[o] = bot - top;
      const float dx0 = q.v01 - q.v00;
      d_fx[o] = dx0 + ((q.v11 - q.v10) - dx0) * ay.t;
    } else {
      partseg::store_as(static_cast<T*>(out) + o, q.lerp(ay.t, ax.t));
    }
  }
}

template <typename T>
void launch(const void* img, const float* coords, void* out, float* d_fy, float* d_fx,
            int b, int h, int w, int c, int n, int with_grads, cudaStream_t s) {
  const dim3 grid((n + kThreads - 1) / kThreads, b);
  const T* im = static_cast<const T*>(img);
  if (with_grads)
    bilinear_sample_kernel<T, true><<<grid, kThreads, 0, s>>>(im, coords, out, d_fy, d_fx, h, w, c, n);
  else
    bilinear_sample_kernel<T, false><<<grid, kThreads, 0, s>>>(im, coords, out, d_fy, d_fx, h, w, c, n);
}

}  // namespace

// img: [B, H, W, C] f32 or bf16 (img_is_bf16); coords: [B, N, 2] f32 (y, x).
// with_grads = 0: out [B, N, C] in the image dtype; d_fy, d_fx unused.
// with_grads = 1: out, d_fy, d_fx [B, N, C] f32.
// The caller keeps B <= 65535. Launches on `stream`, allocates nothing, does
// not synchronise. Returns cudaGetLastError().
extern "C" int partseg_bilinear_sample(const void* img, int img_is_bf16, const float* coords,
                                       void* out, float* d_fy, float* d_fx, int b, int h,
                                       int w, int c, int n, int with_grads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (img_is_bf16)
    launch<__nv_bfloat16>(img, coords, out, d_fy, d_fx, b, h, w, c, n, with_grads, s);
  else
    launch<float>(img, coords, out, d_fy, d_fx, b, h, w, c, n, with_grads, s);
  return static_cast<int>(cudaGetLastError());
}
