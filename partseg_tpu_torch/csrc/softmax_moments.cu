// Fused per-part spatial softmax + raw soft-argmax moments (CUDA C++, sm_90a).
//
// Replaces the Pallas TPU kernel partseg_tpu/partops/pallas/softmax_moments.py
// (`softmax_moments` -> `_forward` -> `_kernel`). For every (b, k) it computes
//   p[b, n, k] = exp(x[b, n, k] - m) / Σ_n exp(x[b, n, k] - m)     over n in H·W
//   raw[b, k]  = Σ_n p[b, n, k] · (y, x, y², yx, x²)(n)            pixel centres
// from the f32 logits. μ and Σ = E[uuᵀ] − μμᵀ are formed by the caller from
// raw (partops/moments.py:moments_from_raw), as the TPU kernel's wrapper did.
// Every sum is f32: bf16 moments make Σ indefinite, which sent training to
// NaN on the TPU.
//
// What bounds it on the H100: device memory. It must read the logits once
// and write the parts once (4 bytes each way per element) and does ~20 flops
// per element, far below the card's ~20 flop/byte f32 ridge. The logits come
// as the foreground slice logits[..., :K] of the [B, H, W, ld] head output:
// pixels stride by ld floats, parts are adjacent, and one image's slab
// [H·W·ld] is contiguous.
//
// Design. The work unit is one image's slab, split over a thread block
// cluster of CS ≤ 8 CTAs (CS from the batch, so that about kTargetCtas CTAs
// fill the card): CTA `rank` owns a contiguous run of pixels.
//   1. It copies its run of the slab into shared memory once, with 16-byte
//      cp.async copies (scalar ones at a ragged head and tail), so device
//      memory is read once and coalesced. A run too large for kStageBudget
//      (maps above ~128² at small batch) is read from device memory in both
//      passes instead: the same coalesced pattern, twice.
//   2. Thread t takes part j = t % K of the pixels n ≡ t / K (mod S = ⌊256/K⌋)
//      of the run: the threads of a warp read neighbouring floats, and the
//      parts they write (p[n·K + j] = p[base + t]) are contiguous.
//   3. Per thread an online max and rescaled sum; per CTA a fixed-order
//      combine over its S stripes; then every CTA combines the cluster's
//      (max, sum) pairs, read through distributed shared memory in rank
//      order, into the same (m, s) bits.
//   4. A second pass forms p = exp(x − m)/s, stores it and accumulates the
//      five moment products; per CTA a fixed-order sum over the stripes, and
//      rank 0 sums the cluster's partials in rank order and writes raw.
// No atomics and no global scratch: one launch, and repeats give the same
// bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxParts = 64;             // the wrapper raises above
constexpr int kGroup = 8;                 // lanes that combine one part's stripes
constexpr int kMaxCluster = 8;            // the portable cluster size
constexpr int kTargetCtas = 512;          // about 4 CTAs per SM: one wave
constexpr int kMaxRun = 512;              // pixels a CTA owns at most, where it can
constexpr int kMinRun = 64;               // pixels a CTA owns at least
constexpr int kStageBudget = 96 * 1024;   // bytes of staged logits per CTA (two CTAs to an SM)
constexpr int kDefaultSmem = 48 * 1024;

struct Launch {
  int cs;      // CTAs per image (the cluster)
  int run;     // pixels per CTA, a multiple of 4
  bool staged; // the run's logits fit in shared memory
  size_t smem; // dynamic shared memory, bytes
};

// Dynamic shared memory: the pixel-centre coordinates of the H rows and W
// columns, then (staged) the run's logits with one float4 of slack, so the
// staged run starts at the same offset mod 16 bytes as its source.
__host__ Launch plan(int b, int h, int w, int ld) {
  const int hw = h * w;
  // Runs of at most kMaxRun pixels (a large image: many small CTAs, whose
  // loads, arithmetic and stores overlap across an SM), and at least
  // kTargetCtas CTAs in all (a small image: one wave that fills the card).
  int cs = 1;
  while (cs < kMaxCluster && hw / (2 * cs) >= kMinRun &&
         (hw > kMaxRun * cs || (long long)b * cs < kTargetCtas))
    cs *= 2;
  int run = (hw + cs - 1) / cs;
  run = (run + 3) & ~3;
  const size_t tables = (size_t)((h + w + 3) & ~3) * sizeof(float);
  const size_t bytes = ((size_t)run * ld + 4) * sizeof(float);
  const bool staged = bytes <= kStageBudget;
  return {cs, run, staged, tables + (staged ? bytes : 0)};
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// Starts copying n floats from src to dst (dst and src equal mod 16 bytes);
// the caller waits with cp.async.wait_all.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int n) {
  const int head = min(n, (int)((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) / 4);
  const int nv = (n - head) / 4;
  for (int i = threadIdx.x; i < nv; i += kThreads) cp_async16(dst + head + 4 * i, src + head + 4 * i);
  for (int i = threadIdx.x; i < head; i += kThreads) dst[i] = src[i];
  for (int i = head + 4 * nv + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

// A butterfly over the kGroup lanes of a group: every lane gets the same bits.
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 1; o < kGroup; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 1; o < kGroup; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
softmax_moments_kernel(const float* __restrict__ logits, float* __restrict__ parts,
                       float* __restrict__ raw, int h, int w, int k, int ld, int run) {
  extern __shared__ float4 smem4[];
  __shared__ float red[5][kThreads];        // per-thread partials
  __shared__ float cta_ms[2][kMaxParts];    // this CTA's (max, sum) per part: read by the cluster
  __shared__ float cta_mom[5][kMaxParts];   // this CTA's moment sums: read by rank 0
  __shared__ float fin[2][kMaxParts];       // the image's (max, 1 / sum)

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / cs;
  const int hw = h * w;
  const int n0 = rank * run;
  const int npix = max(0, min(run, hw - n0));
  const float* xg = logits + ((size_t)b * hw + n0) * ld;
  const float* x = xg;
  float* ytab = reinterpret_cast<float*>(smem4);
  float* xtab = ytab + h;
  if (kStaged) {
    float* xs = ytab + ((h + w + 3) & ~3) + ((reinterpret_cast<uintptr_t>(xg) & 15) >> 2);
    stage(xs, xg, npix * ld);
    x = xs;
  }
  // The same float32 expressions as partops/coords.py's numpy grid.
  for (int i = threadIdx.x; i < h; i += kThreads)
    ytab[i] = -1.0f + (2.0f * ((float)i + 0.5f)) / (float)h;
  for (int i = threadIdx.x; i < w; i += kThreads)
    xtab[i] = -1.0f + (2.0f * ((float)i + 0.5f)) / (float)w;
  if (kStaged) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int t = threadIdx.x;
  const int stripes = kThreads / k;
  const int j = t % k;
  const int s0 = t / k;
  const bool active = s0 < stripes;
  // Combining roles: thread (part jg, group lane g) takes stripes g, g + 8,
  // ... of part jg = (c0 + t) / 8, in rounds c0 = 0, 256, ... that whole
  // warps run (a lane past the last part carries the neutral value).
  const int g = t % kGroup;

  // Pass 1: the max and the sum of exp(x − max) over this thread's pixels.
  float m = __int_as_float(0xff800000);   // -inf
  float sum = 0.0f;
  const size_t step = (size_t)stripes * ld;
  if (active) {
    const float* xp = x + (size_t)s0 * ld + j;
    for (int n = s0; n < npix; n += stripes, xp += step) m = fmaxf(m, *xp);
    xp = x + (size_t)s0 * ld + j;
    for (int n = s0; n < npix; n += stripes, xp += step) sum += expf(*xp - m);
  }
  red[0][t] = m;
  red[1][t] = sum;
  __syncthreads();
  for (int c0 = 0; c0 < k * kGroup; c0 += kThreads) {   // fixed order, then a butterfly
    const int jg = (c0 + t) / kGroup;
    float cm = __int_as_float(0xff800000);
    for (int s = g; jg < k && s < stripes; s += kGroup) cm = fmaxf(cm, red[0][s * k + jg]);
    cm = group_max(cm);
    float cs_ = 0.0f;
    for (int s = g; jg < k && s < stripes; s += kGroup) {
      const float ps = red[1][s * k + jg];
      if (ps > 0.0f) cs_ += ps * expf(red[0][s * k + jg] - cm);
    }
    cs_ = group_sum(cs_);
    if (g == 0 && jg < k) {
      cta_ms[0][jg] = cm;
      cta_ms[1][jg] = cs_;
    }
  }
  cluster.sync();
  if (t < k) {   // the cluster's CTAs, in rank order: the same bits in every CTA
    float ms[2][kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      ms[0][r] = r < cs ? cluster.map_shared_rank(&cta_ms[0][0], r)[t] : 0.0f;
      ms[1][r] = r < cs ? cluster.map_shared_rank(&cta_ms[1][0], r)[t] : 0.0f;
    }
    float gm = __int_as_float(0xff800000);
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < cs) gm = fmaxf(gm, ms[0][r]);
    float gs = 0.0f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < cs && ms[1][r] > 0.0f) gs += ms[1][r] * expf(ms[0][r] - gm);
    fin[0][t] = gm;
    fin[1][t] = 1.0f / gs;
  }
  __syncthreads();

  // Pass 2: p, stored contiguously (p[(n0 + n)·K + j] = base + t), and the
  // five moment products. (yi, xi) of pixel n0 + n advance by `stripes`.
  float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (active) {
    const float gm = fin[0][j];
    const float inv = fin[1][j];
    float* pp = parts + ((size_t)b * hw + n0 + s0) * k + j;
    const float* xp = x + (size_t)s0 * ld + j;
    const int pstep = stripes * k;
    int yi = (n0 + s0) / w;
    int xi = n0 + s0 - yi * w;
    for (int n = s0; n < npix; n += stripes, xp += step, pp += pstep) {
      const float pv = expf(*xp - gm) * inv;
      *pp = pv;
      const float yc = ytab[yi];
      const float xc = xtab[xi];
      acc[0] += pv * yc;
      acc[1] += pv * xc;
      acc[2] += pv * (yc * yc);
      acc[3] += pv * (yc * xc);
      acc[4] += pv * (xc * xc);
      xi += stripes;
      while (xi >= w) {
        xi -= w;
        ++yi;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) red[i][t] = acc[i];
  __syncthreads();
  for (int c0 = 0; c0 < k * kGroup; c0 += kThreads) {
    const int jg = (c0 + t) / kGroup;
    float a[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int s = g; jg < k && s < stripes; s += kGroup) {
#pragma unroll
      for (int i = 0; i < 5; ++i) a[i] += red[i][s * k + jg];
    }
#pragma unroll
    for (int i = 0; i < 5; ++i) a[i] = group_sum(a[i]);
    if (g == 0 && jg < k) {
#pragma unroll
      for (int i = 0; i < 5; ++i) cta_mom[i][jg] = a[i];
    }
  }
  cluster.sync();
  // The cluster's moment partials in rank order; rank r writes parts
  // r, r + cs, ... so the reads spread over the cluster.
  for (int e = t; e < 5 * k; e += kThreads) {
    const int i = e / k;
    const int jj = e - i * k;
    if (jj % cs != rank) continue;
    float a = 0.0f;
    for (int r = 0; r < cs; ++r) a += cluster.map_shared_rank(&cta_mom[i][0], r)[jj];
    raw[((size_t)b * k + jj) * 5 + i] = a;
  }
  cluster.sync();   // no CTA leaves while another reads its shared memory
}

template <bool kStaged>
cudaError_t launch(const float* logits, float* parts, float* raw, int b, int h, int w, int k,
                   int ld, const Launch& p, cudaStream_t stream) {
  auto kernel = softmax_moments_kernel<kStaged>;
  // The static arrays count toward the 48 KB a block gets without the opt-in.
  if (p.smem + (5 * kThreads + 9 * kMaxParts) * sizeof(float) > kDefaultSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * p.cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, logits, parts, raw, h, w, k, ld, p.run);
}

}  // namespace

// logits: [B, H, W, ld] f32 with the K parts in the first K channels, each
// image's H·W·ld floats contiguous; parts: [B, H, W, K] f32; raw: [B, K, 5]
// f32. The caller keeps K <= 64 and B·CS < 2³¹. Launches on `stream`,
// allocates nothing, does not synchronise. Returns the first CUDA error.
extern "C" int partseg_softmax_moments_f32(const float* logits, float* parts, float* raw,
                                           int b, int h, int w, int k, int ld,
                                           void* stream) {
  const Launch p = plan(b, h, w, ld);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = p.staged ? launch<true>(logits, parts, raw, b, h, w, k, ld, p, s)
                             : launch<false>(logits, parts, raw, b, h, w, k, ld, p, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}
