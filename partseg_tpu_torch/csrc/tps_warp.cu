// Fused TPS flow + border-clamped bilinear warp (CUDA C++, sm_90a).
//
// Replaces the Pallas TPU kernel partseg_tpu/partops/pallas/bilinear_warp.py
// (`tps_warp_fused` -> `_run_tps_kernel` -> `_kernel_tps`, and
// `_kernel_tps_banded` when $PARTSEG_WARP_BAND > 0). For every output pixel n
// of image b:
//   (cy, cx) = basis[n, :M] · w[b, :M, :]        the TPS flow, f32
//   out[b, n, c] = border-clamped bilinear sample of img[b] at (cy, cx).
// The dense [B, H·W, 2] flow never exists as a tensor.
//
// Band mode (kh > 0): points are grouped in raster order into tiles of
// `tile` points; per tile, start = (clip(min floor(fy), 0, H − kh) / 8)·8 and
// the row taps clamp into [start, start + kh − 1] — the TPU kernel's banded
// semantics exactly. One block handles one tile, a block-wide min reduction
// finds the start, and a second pass samples. The wrapper enables it only
// where the TPU kernel did (0 < kh < H, N == H·W, tile % W == 0).
//
// What bounds it on the H100: device memory and launch latency. At the
// training shape (32 images of 128²×3 bf16) it reads ~3 MB of image, 1.8 MB
// of basis (L2-resident across the batch) and writes ~3 MB: a few µs at
// 3.35 TB/s, so the launch shows. The TPU version's selector matmuls existed
// because the TPU gathers badly; here one thread per output pixel keeps w[b]
// (M×2 f32, M = 28 for the 5×5 grid) in shared memory, evaluates its flow as
// an f32 dot, gathers four taps per channel and lerps in f32 (the TPU kernel
// ran its flow at bf16 MXU precision and rounded the lerp weights to bf16),
// storing once in the image dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

#include "bilinear.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float2 flow(const float* __restrict__ basis_row,
                                       const float* w_s, int m) {
  float cy = 0.0f, cx = 0.0f;
  for (int j = 0; j < m; ++j) {
    const float phi = basis_row[j];
    cy = fmaf(phi, w_s[2 * j], cy);
    cx = fmaf(phi, w_s[2 * j + 1], cx);
  }
  return make_float2(cy, cx);
}

__device__ __forceinline__ int block_min(int v, int* scratch) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = scratch[threadIdx.x & (kWarps - 1)];
  for (int o = kWarps / 2; o > 0; o >>= 1) r = min(r, __shfl_xor_sync(0xffffffffu, r, o));
  return r;
}

// One block per (tile of `tile` consecutive points, image b).
template <typename T, bool kBanded>
__global__ void __launch_bounds__(kThreads)
tps_warp_kernel(const T* __restrict__ img, const float* __restrict__ weights,
                const float* __restrict__ basis, T* __restrict__ out, int h, int w, int c,
                int m, int tile, int kh) {
  extern __shared__ float w_s[];  // [m, 2]
  __shared__ int scratch[kWarps];
  const int b = blockIdx.y;
  const int hw = h * w;
  const int n0 = blockIdx.x * tile;
  const int npts = min(tile, hw - n0);
  for (int i = threadIdx.x; i < 2 * m; i += kThreads) w_s[i] = weights[(size_t)b * m * 2 + i];
  __syncthreads();

  int lo = 0, hi = h - 1;
  if (kBanded) {
    int mn = INT_MAX;
    for (int i = threadIdx.x; i < npts; i += kThreads) {
      const float2 cr = flow(basis + (size_t)(n0 + i) * m, w_s, m);
      mn = min(mn, (int)floorf(partseg::to_pixel(cr.x, h)));
    }
    mn = block_min(mn, scratch);
    lo = (min(max(mn, 0), h - kh) / 8) * 8;  // sublane-aligned start, as on the TPU
    hi = lo + kh - 1;
  }

  const T* ib = img + (size_t)b * hw * c;
  T* ob = out + ((size_t)b * hw + n0) * c;
  for (int i = threadIdx.x; i < npts; i += kThreads) {
    const float2 cr = flow(basis + (size_t)(n0 + i) * m, w_s, m);
    const partseg::Axis ay = partseg::axis_taps(partseg::to_pixel(cr.x, h), lo, hi);
    const partseg::Axis ax = partseg::axis_taps(partseg::to_pixel(cr.y, w), 0, w - 1);
    for (int ch = 0; ch < c; ++ch) {
      const partseg::Quad<T> q(ib, w, c, ay, ax, ch);
      partseg::store_as(ob + (size_t)i * c + ch, q.lerp(ay.t, ax.t));
    }
  }
}

template <typename T>
void launch(const void* img, const float* weights, const float* basis, void* out, int b,
            int h, int w, int c, int m, int tile, int kh, cudaStream_t s) {
  const int hw = h * w;
  const size_t smem = (size_t)2 * m * sizeof(float);
  const T* im = static_cast<const T*>(img);
  T* o = static_cast<T*>(out);
  if (kh > 0) {
    const dim3 grid((hw + tile - 1) / tile, b);
    tps_warp_kernel<T, true><<<grid, kThreads, smem, s>>>(im, weights, basis, o, h, w, c, m,
                                                          tile, kh);
  } else {
    const dim3 grid((hw + kThreads - 1) / kThreads, b);
    tps_warp_kernel<T, false><<<grid, kThreads, smem, s>>>(im, weights, basis, o, h, w, c, m,
                                                           kThreads, 0);
  }
}

}  // namespace

// img: [B, H, W, C] f32 or bf16 (img_is_bf16); weights: [B, M, 2] f32;
// basis: [H·W, M] f32; out: [B, H, W, C] in the image dtype. kh = 0: unbanded;
// kh > 0: band mode with `tile`-point tiles (the caller checks 0 < kh < H and
// tile % W == 0). The caller keeps B <= 65535 and 2·M·4 bytes <= 48 KB.
// Launches on `stream`, allocates nothing, does not synchronise. Returns
// cudaGetLastError().
extern "C" int partseg_tps_warp(const void* img, int img_is_bf16, const float* weights,
                                const float* basis, void* out, int b, int h, int w, int c,
                                int m, int tile, int kh, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (img_is_bf16)
    launch<__nv_bfloat16>(img, weights, basis, out, b, h, w, c, m, tile, kh, s);
  else
    launch<float>(img, weights, basis, out, b, h, w, c, m, tile, kh, s);
  return static_cast<int>(cudaGetLastError());
}
