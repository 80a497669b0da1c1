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
// What bounds it on the H100: device memory and latency. Each point reads 8
// bytes of coords and 4·C taps and writes C values (3·C f32 in the grads
// variant); a few flops per byte. At the training shape (32 images of
// 128²×3 bf16, 16384 points each) that is 10.5 MB, ~3 µs at 3.35 TB/s, so
// the kernel lives on how many loads it keeps in flight and how few
// instructions each point costs. The TPU kernel folded the gathers into
// [T, H] selector matmuls only because the TPU gathers badly. Here one
// thread per point computes its four tap offsets and weights once (not
// once per channel), and for the image widths C ≤ 4 (C = 3 on the main
// path) the channel count is a compile-time constant, so all 4·C tap loads
// are issued before any is used. The primal stores its C values directly:
// neighbouring threads write neighbouring bytes, and the L2 merges them
// into whole sectors (staging them through shared memory measured slower
// on the H100). The grads variant writes 3·C f32 per point into three
// arrays; there each thread takes 2 points, and the block stages its
// [points × C] results in shared memory and writes them as contiguous
// 16-byte vectors (scalars at the two ragged ends), which measured faster
// than direct stores. Wider images take a per-point kernel that loops over
// channels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "bilinear.cuh"

namespace {

constexpr int kThreads = 256;

// The block writes `count` f32 to dst from a shared stage that holds
// element i at stage[shift + i], where shift = dst's misalignment in
// elements, so the 16-byte groups of both line up.
__device__ __forceinline__ int stage_shift(const float* dst) {
  return (int)((reinterpret_cast<uintptr_t>(dst) & 15) / sizeof(float));
}

__device__ __forceinline__ void write_staged(const float* stage, float* dst, int count, int shift) {
  constexpr int kV = 4;
  const int head = min(count, (kV - shift) % kV);
  const int nvec = (count - head) / kV;
  const uint4* sv = reinterpret_cast<const uint4*>(stage + shift + head);
  uint4* dv = reinterpret_cast<uint4*>(dst + head);
  for (int i = threadIdx.x; i < head; i += kThreads) dst[i] = stage[shift + i];
  for (int i = threadIdx.x; i < nvec; i += kThreads) dv[i] = sv[i];
  for (int i = head + nvec * kV + threadIdx.x; i < count; i += kThreads)
    dst[i] = stage[shift + i];
}

// The primal for C = kC ≤ 4: one thread per point, all taps loaded first.
template <typename T, int kC>
__global__ void __launch_bounds__(kThreads)
sample_kernel(const T* __restrict__ img, const float2* __restrict__ coords, T* __restrict__ out,
              int h, int w, int n) {
  const int b = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  const size_t row = (size_t)b * n + p;
  const float2 cr = coords[row];
  const partseg::Taps tp(cr.x, cr.y, h, w, kC);
  const T* ib = img + (size_t)b * h * w * kC;
  float v[4][kC];
#pragma unroll
  for (int ch = 0; ch < kC; ++ch) {
    v[0][ch] = partseg::load_f32(ib + tp.o00 + ch);
    v[1][ch] = partseg::load_f32(ib + tp.o01 + ch);
    v[2][ch] = partseg::load_f32(ib + tp.o10 + ch);
    v[3][ch] = partseg::load_f32(ib + tp.o11 + ch);
  }
#pragma unroll
  for (int ch = 0; ch < kC; ++ch)
    partseg::store_as(out + row * kC + ch,
                      partseg::lerp4(v[0][ch], v[1][ch], v[2][ch], v[3][ch], tp.wy, tp.wx));
}

// The grads variant for C = kC ≤ 4. One block per (kThreads·kPPT points,
// image b); thread x takes points x, x + kThreads, ... (coalesced
// coordinate loads).
template <typename T, int kC, int kPPT>
__global__ void __launch_bounds__(kThreads)
sample_grads_kernel(const T* __restrict__ img, const float2* __restrict__ coords,
                    float* __restrict__ out, float* __restrict__ d_fy, float* __restrict__ d_fx,
                    int h, int w, int n) {
  constexpr int kPoints = kThreads * kPPT;
  constexpr int kStage = kPoints * kC + 4;
  __shared__ __align__(16) float s_out[kStage];
  __shared__ __align__(16) float s_dy[kStage];
  __shared__ __align__(16) float s_dx[kStage];

  const int b = blockIdx.y;
  const int p0 = blockIdx.x * kPoints;
  const int npts = min(kPoints, n - p0);
  const T* ib = img + (size_t)b * h * w * kC;
  const float2* cb = coords + (size_t)b * n + p0;

  float v[kPPT][4][kC];
  float wy[kPPT], wx[kPPT];
#pragma unroll
  for (int j = 0; j < kPPT; ++j) {
    const int t = threadIdx.x + j * kThreads;
    wy[j] = wx[j] = 0.0f;
#pragma unroll
    for (int ch = 0; ch < kC; ++ch) v[j][0][ch] = v[j][1][ch] = v[j][2][ch] = v[j][3][ch] = 0.0f;
    if (t < npts) {
      const float2 cr = cb[t];
      const partseg::Taps tp(cr.x, cr.y, h, w, kC);
      wy[j] = tp.wy;
      wx[j] = tp.wx;
#pragma unroll
      for (int ch = 0; ch < kC; ++ch) {
        v[j][0][ch] = partseg::load_f32(ib + tp.o00 + ch);
        v[j][1][ch] = partseg::load_f32(ib + tp.o01 + ch);
        v[j][2][ch] = partseg::load_f32(ib + tp.o10 + ch);
        v[j][3][ch] = partseg::load_f32(ib + tp.o11 + ch);
      }
    }
  }

  const size_t o0 = ((size_t)b * n + p0) * kC;
  const int sh = stage_shift(out + o0), sh_y = stage_shift(d_fy + o0);
  const int sh_x = stage_shift(d_fx + o0);
#pragma unroll
  for (int j = 0; j < kPPT; ++j) {
    const int t = threadIdx.x + j * kThreads;
    if (t < npts) {
#pragma unroll
      for (int ch = 0; ch < kC; ++ch) {
        const float a = v[j][0][ch], bb = v[j][1][ch], cc = v[j][2][ch], d = v[j][3][ch];
        const int e = t * kC + ch;
        s_out[sh + e] = partseg::lerp4(a, bb, cc, d, wy[j], wx[j]);
        s_dy[sh_y + e] = partseg::diff_y(a, bb, cc, d, wx[j]);
        s_dx[sh_x + e] = partseg::diff_x(a, bb, cc, d, wy[j]);
      }
    }
  }
  __syncthreads();
  write_staged(s_out, out + o0, npts * kC, sh);
  write_staged(s_dy, d_fy + o0, npts * kC, sh_y);
  write_staged(s_dx, d_fx + o0, npts * kC, sh_x);
}

// Any C: one thread per point, taps once, a loop over channels.
template <typename T, bool kGrads>
__global__ void __launch_bounds__(kThreads)
sample_any_c_kernel(const T* __restrict__ img, const float2* __restrict__ coords,
                    void* __restrict__ out, float* __restrict__ d_fy, float* __restrict__ d_fx,
                    int h, int w, int c, int n) {
  const int b = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  const size_t row = (size_t)b * n + p;
  const float2 cr = coords[row];
  const partseg::Taps tp(cr.x, cr.y, h, w, c);
  const T* ib = img + (size_t)b * h * w * c;
  for (int ch = 0; ch < c; ++ch) {
    const float a = partseg::load_f32(ib + tp.o00 + ch), bb = partseg::load_f32(ib + tp.o01 + ch);
    const float cc = partseg::load_f32(ib + tp.o10 + ch), d = partseg::load_f32(ib + tp.o11 + ch);
    const size_t o = row * c + ch;
    if constexpr (kGrads) {
      static_cast<float*>(out)[o] = partseg::lerp4(a, bb, cc, d, tp.wy, tp.wx);
      d_fy[o] = partseg::diff_y(a, bb, cc, d, tp.wx);
      d_fx[o] = partseg::diff_x(a, bb, cc, d, tp.wy);
    } else {
      partseg::store_as(static_cast<T*>(out) + o, partseg::lerp4(a, bb, cc, d, tp.wy, tp.wx));
    }
  }
}

template <typename T, int kC>
void launch_c(const T* img, const float2* coords, void* out, float* d_fy, float* d_fx, int b,
              int h, int w, int n, int with_grads, cudaStream_t s) {
  constexpr int kPPT = 2;
  if (with_grads) {
    const dim3 grid((n + kThreads * kPPT - 1) / (kThreads * kPPT), b);
    sample_grads_kernel<T, kC, kPPT><<<grid, kThreads, 0, s>>>(
        img, coords, static_cast<float*>(out), d_fy, d_fx, h, w, n);
  } else {
    const dim3 grid((n + kThreads - 1) / kThreads, b);
    sample_kernel<T, kC><<<grid, kThreads, 0, s>>>(img, coords, static_cast<T*>(out), h, w, n);
  }
}

template <typename T>
void launch(const void* img_, const float* coords_, void* out, float* d_fy, float* d_fx, int b,
            int h, int w, int c, int n, int with_grads, cudaStream_t s) {
  const T* img = static_cast<const T*>(img_);
  const float2* coords = reinterpret_cast<const float2*>(coords_);
  switch (c) {
    case 1: launch_c<T, 1>(img, coords, out, d_fy, d_fx, b, h, w, n, with_grads, s); break;
    case 2: launch_c<T, 2>(img, coords, out, d_fy, d_fx, b, h, w, n, with_grads, s); break;
    case 3: launch_c<T, 3>(img, coords, out, d_fy, d_fx, b, h, w, n, with_grads, s); break;
    case 4: launch_c<T, 4>(img, coords, out, d_fy, d_fx, b, h, w, n, with_grads, s); break;
    default: {
      const dim3 grid((n + kThreads - 1) / kThreads, b);
      if (with_grads)
        sample_any_c_kernel<T, true><<<grid, kThreads, 0, s>>>(img, coords, out, d_fy, d_fx, h,
                                                               w, c, n);
      else
        sample_any_c_kernel<T, false><<<grid, kThreads, 0, s>>>(img, coords, out, d_fy, d_fx, h,
                                                                w, c, n);
    }
  }
}

}  // namespace

// img: [B, H, W, C] f32 or bf16 (img_is_bf16); coords: [B, N, 2] f32 (y, x),
// 8-byte aligned. with_grads = 0: out [B, N, C] in the image dtype; d_fy,
// d_fx unused. with_grads = 1: out, d_fy, d_fx [B, N, C] f32. The caller
// keeps B <= 65535. Launches on `stream`, allocates nothing, does not
// synchronise. Returns cudaGetLastError().
extern "C" int partseg_bilinear_sample(const void* img, int img_is_bf16, const float* coords,
                                       void* out, float* d_fy, float* d_fx, int b, int h,
                                       int w, int c, int n, int with_grads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (img_is_bf16) launch<__nv_bfloat16>(img, coords, out, d_fy, d_fx, b, h, w, c, n, with_grads, s);
  else launch<float>(img, coords, out, d_fy, d_fx, b, h, w, c, n, with_grads, s);
  return static_cast<int>(cudaGetLastError());
}
