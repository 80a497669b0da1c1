// Fused per-part spatial softmax + raw soft-argmax moments (CUDA C++, sm_90a).
//
// Replaces the Pallas TPU kernel partseg_tpu/partops/pallas/softmax_moments.py
// (`softmax_moments` -> `_forward` -> `_kernel`). For every (b, k) it computes
//   p[b, n, k] = exp(x[b, n, k] - m) / Σ_n exp(x[b, n, k] - m)     over n in H·W
//   raw[b, k]  = Σ_n p[b, n, k] · (y, x, y², yx, x²)(n)            pixel centres
// from the f32 logits. μ and Σ = E[uuᵀ] − μμᵀ are formed by the caller from
// raw (partops/moments.py:moments_from_raw), as the TPU kernel's wrapper did.
//
// What bounds it on the H100: device memory. It reads the logits and writes
// the parts (4 bytes each way per element) and does ~20 flops per element,
// far below the card's ~20 flop/byte f32 ridge. The design keeps every
// accumulation in f32 (bf16 moments make Σ indefinite, which sent training
// to NaN on the TPU) and reads the logits through a pixel stride `ld`, so the
// foreground slice logits[..., :K] of the [B, H, W, K+1] head output needs no
// copy. One block per (b, k) loops over H·W three times (max, sum, write +
// moments); the passes re-read the same 16 KB slab, which stays in L1/L2.
// Known slowness, left for a later change: with the [HW, K] layout the
// per-(b, k) loads and stores stride by K floats and are not coalesced.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float combine(float a, float b, bool is_max) {
  return is_max ? fmaxf(a, b) : a + b;
}

// Reduces each of v[0..N) across the block; every thread gets the results.
template <int N>
__device__ __forceinline__ void block_reduce(float (&v)[N], float (*scratch)[kWarps],
                                             bool is_max) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[i] = combine(v[i], __shfl_xor_sync(0xffffffffu, v[i], o), is_max);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) scratch[i][warp] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float r = scratch[i][lane % kWarps];
#pragma unroll
    for (int o = kWarps / 2; o > 0; o >>= 1) r = combine(r, __shfl_xor_sync(0xffffffffu, r, o), is_max);
    v[i] = r;
  }
  __syncthreads();  // scratch may be reused by the next reduction
}

__global__ void __launch_bounds__(kThreads)
softmax_moments_kernel(const float* __restrict__ logits, float* __restrict__ parts,
                       float* __restrict__ raw, int h, int w, int k, int ld) {
  __shared__ float scratch[5][kWarps];
  const int b = blockIdx.x / k;
  const int part = blockIdx.x - b * k;
  const int hw = h * w;
  const float* x = logits + (size_t)b * hw * ld + part;
  float* p = parts + (size_t)b * hw * k + part;

  float m[1] = {__int_as_float(0xff800000)};  // -inf
  for (int n = threadIdx.x; n < hw; n += kThreads) m[0] = fmaxf(m[0], x[(size_t)n * ld]);
  block_reduce<1>(m, scratch, true);

  float s[1] = {0.0f};
  for (int n = threadIdx.x; n < hw; n += kThreads) s[0] += expf(x[(size_t)n * ld] - m[0]);
  block_reduce<1>(s, scratch, false);

  float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int n = threadIdx.x; n < hw; n += kThreads) {
    const float pv = expf(x[(size_t)n * ld] - m[0]) / s[0];
    p[(size_t)n * k] = pv;
    const int i = n / w;
    const int j = n - i * w;
    // The same float32 expression as partops/coords.py's numpy grid.
    const float yc = -1.0f + (2.0f * ((float)i + 0.5f)) / (float)h;
    const float xc = -1.0f + (2.0f * ((float)j + 0.5f)) / (float)w;
    acc[0] += pv * yc;
    acc[1] += pv * xc;
    acc[2] += pv * (yc * yc);
    acc[3] += pv * (yc * xc);
    acc[4] += pv * (xc * xc);
  }
  block_reduce<5>(acc, scratch, false);
  if (threadIdx.x == 0) {
    float* r = raw + ((size_t)b * k + part) * 5;
#pragma unroll
    for (int i = 0; i < 5; ++i) r[i] = acc[i];
  }
}

}  // namespace

// logits: [B, H, W, ld] f32 with the K parts in the first K channels;
// parts: [B, H, W, K] f32; raw: [B, K, 5] f32. Launches on `stream`,
// allocates nothing, does not synchronise. Returns cudaGetLastError().
extern "C" int partseg_softmax_moments_f32(const float* logits, float* parts, float* raw,
                                           int b, int h, int w, int k, int ld,
                                           void* stream) {
  softmax_moments_kernel<<<b * k, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      logits, parts, raw, h, w, k, ld);
  return static_cast<int>(cudaGetLastError());
}
