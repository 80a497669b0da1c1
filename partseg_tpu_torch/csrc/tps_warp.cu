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
// semantics exactly. The wrapper enables it only where the TPU kernel did
// (0 < kh < H, N == H·W, tile % W == 0).
//
// What bounds it on the H100. The bound it is measured against is device
// memory: read the image and the [H·W, M] basis once, write the output once;
// at the training shape (32 images of 128²×3 bf16, M = 28) 3.15 + 1.84 +
// 3.15 MB, 2.43 µs at 3.35 TB/s. Its 2·M f32 FMAs per pixel (29 M at that
// shape, about 1 µs at the f32 rate) must stay plain FMAs in the plain
// dot's order, so the tensor cores cannot take the flow. What holds it
// above the bound is per-SM work done in phases that every CTA runs at
// once: the basis copy's latency, the flow's FMAs and shared-memory loads,
// then the 4-tap gathers through L1.
//
// Design. A CTA owns a run of consecutive points and a group of images, so
// the basis crosses L2 once per group of images.
//   1. Pass 1: the run's [·, M] basis rows go to shared memory in one
//      coalesced block (16-byte cp.async, rows padded to a bank-friendly
//      stride), w is read meanwhile. A thread takes one point and kImgs
//      images of the group: each 16-byte load of basis values feeds kImgs
//      pairs of FMA chains, w comes as shared-memory broadcasts. Per image
//      the chain is the plain dot's f32 FMA order over j = 0..M−1, and the
//      pixel indices (to_pixel's per-operation rounding) go to shared memory.
//   2. Band mode: the tile's minimum tap row per image meets through a block
//      reduction and, where a tile spans a thread block cluster of up to 8
//      CTAs (so that the 4096-point tiles fill the card), through distributed
//      shared memory. Integer minima: the order does not matter.
//   3. Pass 2: each thread samples its (point, image) pairs from the stored
//      indices (no second flow): taps and lerp weights once per pair, four
//      images' loads in flight together, each tap row's pixel pair read as
//      the aligned 8-byte words that hold it (C ≤ 4), and the lerp in f32
//      with the plain version's expression order; one rounding to the image
//      dtype at the store.
//
// Wide bases (tps_warp_wide_kernel). Where a run's basis rows do not fit in
// shared memory whole (M > 396 unbanded, M > 212 in band mode at
// 4096-point tiles: grid 20, M = 403, and grid 15, M = 228), the flow is
// 2·M FMAs a pixel and image, so the f32 pipes bound it (grid 20 at the
// training warp: 0.0128 ms), provided shared memory feeds them and the
// basis copies hide behind them. Measured on the H100, shared-memory load
// instructions set the pace (about one an SM every 3.7 cycles, whatever
// their width, at these access patterns), so the design counts loads:
//   - a register tile: a warp is 8 point slots × 4 image slots; a thread
//     takes 4 points (slot + 8·i) and I images (q + 4·i): 4 unbanded, 2 in
//     band mode, whose clusters want more, smaller threads;
//   - 16-byte rows: the basis rows must start on 16 bytes (M a multiple of
//     4; TPSSampler keeps its basis padded with zero columns, and the
//     wrapper pads any other basis), so a row's chunk goes over in 16-byte
//     copies and a thread reads four columns of a point in one 16-byte
//     load (the 8 point slots of a warp on 8 distinct bank quads: the row
//     stride is 4 mod 8 words), w in two: 12 loads for 128 FMAs, where
//     scalar basis loads of unaligned rows took 24;
//   - w for all M columns staged once per CTA, chunk by chunk with the
//     basis (8-byte cp.async), its rows 4 mod 8 float4s apart so that the
//     4 image slots hit distinct banks;
//   - the basis in chunks of columns through a ring of kStages buffers:
//     chunk c + kStages − 1 is in flight (cp.async groups,
//     cp.async.wait_group) while chunk c's FMAs run, one barrier a chunk;
//   - band mode keeps the cluster of CTAs per tile and walks its points in
//     runs of 256; both modes keep the pixel indices for pass 2.
// Zero columns padded onto the basis and w add fmaf(0, 0, a) = a (up to the
// sign of a zero, which to_pixel's c + 1 erases), so each flow is still the
// plain dot's chain over j = 0..M−1 in order, whatever the chunking: the
// output is the narrow path's bits. Tensor cores stay out: mma's summation
// order is not specified.
// Every output is the plain per-pixel arithmetic, so it does not depend on
// the CTA shape: the same flow chain, index rounding, taps and lerp.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

#include "bilinear.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kSmemOptIn = 232448;   // what a block may opt in to on the H100
constexpr int kSmemPerSM = 233472;   // an H100 SM's shared memory; 1 KB of it is kept per CTA

// The CTA of each mode where the basis rows fit whole: kThreads threads in
// kSplit subgroups of kRun; a chunk is kRun points, and subgroup s runs the
// flow of, and samples, images s·kImgs ... s·kImgs + kImgs − 1 of the
// group at every point of the chunk. Unbanded: 128-point runs, 8 images,
// two threads per point. Band mode: 256-point chunks (a 4096-point tile
// over a cluster of 8 CTAs of two chunks each) and 4 images, one thread
// per point.
template <bool kBanded>
struct Shape {
  static constexpr int kThreads = 256;
  static constexpr int kMinBlocks = 4;   // CTAs an SM must hold: at most 64 registers
  static constexpr int kSplit = kBanded ? 1 : 2;
  static constexpr int kGroup = kBanded ? 4 : 8;   // images per CTA, at most
  static constexpr int kRun = kThreads / kSplit;
  static constexpr int kImgs = kGroup / kSplit;
  static constexpr int kWarps = kThreads / 32;
};

// The CTA of the wide path: kWarps warps of 8 point slots × 4 image slots;
// a thread takes 4 points (slot + 8·i) and kI images (q + 4·i), so a pass
// covers kRun points and kGroup images. Unbanded: 4 × 4 a thread, 128
// threads, 128-point runs and 16 images (the 32 images × 16384 points of
// the training warp are 256 CTAs, two to an SM: 8 warps an SM; a larger
// tile a thread leaves an SM too few warps to hide its loads, and measured
// slower). Band mode: 4 × 2 a thread, 256 threads, 256-point runs and 8
// images (a 4096-point tile over 8 CTAs of two runs each), two CTAs to an
// SM so that a GPC holds the tiles' clusters at once.
template <bool kBanded>
struct Wide {
  static constexpr int kThreads = kBanded ? 256 : 128;
  static constexpr int kMinBlocks = 2;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kP = 4;                      // points per thread
  static constexpr int kI = kBanded ? 2 : 4;        // images per thread
  static constexpr int kGroup = 4 * kI;             // images per CTA, at most
  static constexpr int kRun = kWarps * 8 * kP;      // points per pass
  static constexpr int kChunk = kBanded ? 16 : 24;  // basis columns per stage, a multiple of 8
  static constexpr int kStride = kChunk + 4;        // a staged row: 4 mod 8 words
  static constexpr int kStages = 3;                 // the ring of basis chunks
};

// The launch of one call. Mirrored by partops/kernels/tps_warp.py:launch_plan.
struct Plan {
  int points;   // points a CTA owns
  int group;    // images a CTA samples (the last group may hold fewer)
  int cluster;  // CTAs per band tile (1: unbanded)
  int grid_x, grid_y;
  int smem;     // dynamic shared memory, bytes
  int chunk;    // basis columns staged at a time (M: the whole basis in one chunk)
};

// The shared-memory row stride of the basis and of w: M rounded up to a
// multiple of 4 (rows of float4) that is 4 mod 8 words, so the 8 threads of
// each phase of a 16-byte load hit distinct banks.
__host__ __device__ int row_stride(int m) {
  const int mp = (m + 3) / 4 * 4;
  return mp % 8 == 0 ? mp + 4 : mp;
}

// Dynamic shared memory, in 4-byte words: w [kGroup, MP, 2] and the run's
// basis rows [kRun, MP]; the pixel indices [group, points] as float2; the
// per-warp minima [kWarps, kImgs], the CTA's minima and the band starts
// [2, kGroup].
template <bool kBanded>
__host__ __device__ int smem_words(int mp, int points, int group) {
  using S = Shape<kBanded>;
  return 2 * S::kGroup * mp + S::kRun * mp + 2 * group * points + S::kWarps * S::kImgs +
         2 * S::kGroup;
}

// The wide path's w row: 2·MW floats, MW = M (a multiple of 4 there) + 2,
// so that rows are 4 mod 8 float4s apart.
__host__ __device__ int wide_w_stride(int m) {
  const int mw = (m + 1) / 2 * 2;
  return 2 * (mw % 4 == 0 ? mw + 2 : mw);
}

// The wide path's dynamic shared memory, in words: w [group, wide_w_stride],
// the ring [kStages, kRun, kStride], the pixel indices [group, points] as
// float2, the CTA's minima and the band starts [2, kGroup].
template <bool kBanded>
__host__ __device__ int wide_smem_words(int m, int points, int group) {
  using S = Wide<kBanded>;
  return group * wide_w_stride(m) + S::kStages * S::kRun * S::kStride + 2 * group * points +
         2 * S::kGroup;
}

template <bool kBanded>
__host__ Plan plan_of(int b, int h, int w, int m, int tile) {
  using S = Shape<kBanded>;
  Plan p;
  const int n = h * w;
  if (kBanded) {   // a tile's CTAs form a cluster; at most kMaxCluster of them
    p.cluster = std::min(kMaxCluster, (tile + S::kRun - 1) / S::kRun);
    p.points = (tile + p.cluster - 1) / p.cluster;
    p.grid_x = n / tile * p.cluster;
  } else {
    p.cluster = 1;
    p.points = S::kRun;
    p.grid_x = (n + S::kRun - 1) / S::kRun;
  }
  p.chunk = m;
  p.group = S::kGroup;   // fewer images where a long run's indices would not fit
  while (p.group > 1 && 4 * smem_words<kBanded>(row_stride(m), p.points, p.group) > kSmemOptIn)
    p.group /= 2;
  if (4 * smem_words<kBanded>(row_stride(m), p.points, p.group) > kSmemOptIn) {
    // The basis does not fit whole: the wide path, with its own CTA (the
    // same points and cluster in band mode). Images per CTA: the most that
    // fit in the share of an SM that lets kMinBlocks CTAs run on it
    // together, else within the opt-in limit, halved while they do not.
    using V = Wide<kBanded>;
    if (!kBanded) {
      p.points = V::kRun;
      p.grid_x = (n + V::kRun - 1) / V::kRun;
    }
    int budget = kSmemPerSM / V::kMinBlocks - 1024;
    if (4 * wide_smem_words<kBanded>(m, p.points, V::kGroup) > budget) budget = kSmemOptIn;
    p.group = V::kGroup;
    while (p.group > 1 && 4 * wide_smem_words<kBanded>(m, p.points, p.group) > budget)
      p.group /= 2;
    p.chunk = V::kChunk;
    p.smem = 4 * wide_smem_words<kBanded>(m, p.points, p.group);
  } else {
    p.smem = 4 * smem_words<kBanded>(row_stride(m), p.points, p.group);
  }
  p.grid_y = (b + p.group - 1) / p.group;
  return p;
}

__host__ Plan make_plan(int b, int h, int w, int m, int tile, int kh) {
  return kh > 0 ? plan_of<true>(b, h, w, m, tile) : plan_of<false>(b, h, w, m, tile);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// 16 bytes, or only the first `bytes` of them and zeros after (src is then
// not read beyond them).
__device__ __forceinline__ void cp_async16_fill(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}

// One float, or a zero where `valid` is false (src is then not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Until at most kPending of this thread's newest cp.async groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Copies the first `width` floats of `rows` basis rows (src_stride apart)
// from src into dst at row stride mp, zero beyond width, with cp.async,
// which the caller waits for (cp_async_wait). Where the rows are already
// float4 rows at that stride (width == src_stride == mp, src 16-byte
// aligned) the block goes over in 16-byte copies; elsewhere one float at a
// time.
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int rows,
                                           int width, int src_stride, int mp) {
  if (width == mp && src_stride == mp && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = threadIdx.x; i < rows * mp / 4; i += blockDim.x) cp_async16(dst + 4 * i, src + 4 * i);
  } else {
    for (int i = threadIdx.x; i < rows * mp; i += blockDim.x) {
      const int r = i / mp, j = i - r * mp;
      cp_async4(dst + i, src + (size_t)r * src_stride + min(j, width - 1), j < width);
    }
  }
}

// The values of the pixel pair (x0, x0 + 1) of one row at p, as f32: x0's
// kC channels into a, x0 + 1's into b (x0's again where `two` is false, a
// border clamp). They are read as the aligned 8-byte words that hold them,
// not one load per value, and only words that hold a needed byte.
template <typename T, int kC>
__device__ __forceinline__ void load_pair(const T* p, bool two, float (&a)[kC], float (&b)[kC]) {
  constexpr int kBytes = 2 * kC * (int)sizeof(T);
  constexpr int kWords = (kBytes + 8 - (int)sizeof(T) + 7) / 8;   // at any offset in a word
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  const uint2* q = reinterpret_cast<const uint2*>(addr & ~uintptr_t(7));
  const int o = (int)(addr & 7);
  const int end = o + (two ? kBytes : kBytes / 2);
  uint32_t wd[2 * kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const uint2 x = 8 * i < end ? __ldg(q + i) : make_uint2(0u, 0u);
    wd[2 * i] = x.x;
    wd[2 * i + 1] = x.y;
  }
  float e[2 * kC];
  if constexpr (sizeof(T) == 4) {   // element k is word k + o / 4
    const bool s = o >= 4;
#pragma unroll
    for (int k = 0; k < 2 * kC; ++k) e[k] = __uint_as_float(s ? wd[k + 1] : wd[k]);
  } else {   // bf16: element k is half k + o / 2; shift by whole words, then by a half
    const bool s = o >= 4;
    const unsigned half = (unsigned)(o & 2) * 8;
    uint32_t aw[kC + 1];
#pragma unroll
    for (int k = 0; k <= kC; ++k) aw[k] = s ? wd[k + 1] : wd[k];
#pragma unroll
    for (int k = 0; k < kC; ++k) {
      const uint32_t v = __funnelshift_r(aw[k], aw[k + 1], half);
      e[2 * k] = __uint_as_float(v << 16);
      e[2 * k + 1] = __uint_as_float(v & 0xffff0000u);
    }
  }
#pragma unroll
  for (int ch = 0; ch < kC; ++ch) {
    a[ch] = e[ch];
    b[ch] = two ? e[kC + ch] : e[ch];
  }
}

// The four tap offsets (elements, NHWC) and lerp weights of a pixel index,
// the rows clamped into [lo, hi]: partseg::Taps with a band.
struct BandTaps {
  int o00, o01, o10, o11;
  float wy, wx;
  __device__ __forceinline__ BandTaps(float2 f, int lo, int hi, int w, int c) {
    const partseg::Axis y = partseg::axis_taps(f.x, lo, hi);
    const partseg::Axis x = partseg::axis_taps(f.y, 0, w - 1);
    o00 = (y.i0 * w + x.i0) * c;
    o01 = (y.i0 * w + x.i1) * c;
    o10 = (y.i1 * w + x.i0) * c;
    o11 = (y.i1 * w + x.i1) * c;
    wy = y.t;
    wx = x.t;
  }
};

// Pass 2 of both kernels: point p (of the CTA's points, from n0) of images
// g_first ... g_first + kImgs − 1 (those below ng), their taps in flight
// together, sampled from the stored pixel indices f_s [group, points]; band
// mode clamps the tap rows into [band_lo[g], band_lo[g] + kh − 1].
template <typename T, int kC, bool kBanded, int kImgs>
__device__ __forceinline__ void sample_point(const T* __restrict__ img, T* __restrict__ out,
                                             const float2* f_s, const int* band_lo, int points,
                                             int p, int g_first, int ng, int b0, int n0, int h,
                                             int w, int c, int kh) {
  const int hw = h * w;
  if constexpr (kC > 0) {
    float v[kImgs][4][kC];
    float wy[kImgs], wx[kImgs];
#pragma unroll
    for (int i = 0; i < kImgs; ++i) {
      const int g = g_first + i;
      if (g < ng) {
        const int lo = kBanded ? band_lo[g] : 0;
        const float2 f = f_s[g * points + p];
        const partseg::Axis ay = partseg::axis_taps(f.x, lo, kBanded ? lo + kh - 1 : h - 1);
        const partseg::Axis ax = partseg::axis_taps(f.y, 0, w - 1);
        const T* ib = img + (size_t)(b0 + g) * hw * kC;
        const bool two = ax.i1 != ax.i0;
        load_pair<T, kC>(ib + (ay.i0 * w + ax.i0) * kC, two, v[i][0], v[i][1]);
        load_pair<T, kC>(ib + (ay.i1 * w + ax.i0) * kC, two, v[i][2], v[i][3]);
        wy[i] = ay.t;
        wx[i] = ax.t;
      }
    }
#pragma unroll
    for (int i = 0; i < kImgs; ++i) {
      const int g = g_first + i;
      if (g < ng) {
        T* o = out + ((size_t)(b0 + g) * hw + n0 + p) * kC;
#pragma unroll
        for (int ch = 0; ch < kC; ++ch)
          partseg::store_as(o + ch, partseg::lerp4(v[i][0][ch], v[i][1][ch], v[i][2][ch],
                                                   v[i][3][ch], wy[i], wx[i]));
      }
    }
  } else {
    for (int g = g_first; g < min(ng, g_first + kImgs); ++g) {
      const int lo = kBanded ? band_lo[g] : 0;
      const BandTaps tp(f_s[g * points + p], lo, kBanded ? lo + kh - 1 : h - 1, w, c);
      const T* ib = img + (size_t)(b0 + g) * hw * c;
      T* o = out + ((size_t)(b0 + g) * hw + n0 + p) * c;
      for (int ch = 0; ch < c; ++ch)
        partseg::store_as(o + ch, partseg::lerp4(
            partseg::load_f32(ib + tp.o00 + ch), partseg::load_f32(ib + tp.o01 + ch),
            partseg::load_f32(ib + tp.o10 + ch), partseg::load_f32(ib + tp.o11 + ch),
            tp.wy, tp.wx));
    }
  }
}

// Band mode: band_lo[g] for the CTA's images from cta_min (the CTA's
// minimum tap row per image, kGroup entries), over every CTA of the
// cluster: the sublane-aligned start of the tile's band, as on the TPU.
__device__ __forceinline__ void band_starts(int* cta_min, int* band_lo, int n_group, int h,
                                            int kh) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int t = threadIdx.x;
  if (t < n_group) {
    int v = INT_MAX;
    for (int r = 0; r < (int)cluster.num_blocks(); ++r)
      v = min(v, cluster.map_shared_rank(cta_min, r)[t]);
    band_lo[t] = (min(max(v, 0), h - kh) / 8) * 8;
  }
  __syncthreads();
}

// Grid (runs of points, groups of images). kC > 0: C = kC at compile time;
// kC = 0: any C, a loop over channels.
template <typename T, int kC, bool kBanded>
__global__ void __launch_bounds__(Shape<kBanded>::kThreads, Shape<kBanded>::kMinBlocks)
tps_warp_kernel(const T* __restrict__ img, const float* __restrict__ weights,
                const float* __restrict__ basis, T* __restrict__ out, int b, int h, int w,
                int c_rt, int m, int tile, int kh, int points, int group) {
  using S = Shape<kBanded>;
  constexpr int kImgs = S::kImgs, kRun = S::kRun;
  const int mp = row_stride(m);
  extern __shared__ float4 smem4[];
  float4* w_s = smem4;                                    // [kGroup, mp / 2]: j pairs (y, x, y, x)
  float4* b_s = w_s + S::kGroup * mp / 2;                 // [kRun, mp / 4]
  float2* f_s = reinterpret_cast<float2*>(b_s + kRun * mp / 4);    // [group, points]
  int* warp_min = reinterpret_cast<int*>(f_s + group * points);    // [kWarps, kImgs]
  int* cta_min = warp_min + S::kWarps * kImgs;            // [kGroup]: read by the cluster
  int* band_lo = cta_min + S::kGroup;                     // [kGroup]

  const int c = kC > 0 ? kC : c_rt;
  const int t = threadIdx.x;
  const int lane = t % kRun;              // the point of each chunk
  const int g_first = t / kRun * kImgs;   // the first of the images this thread takes
  const int b0 = blockIdx.y * group;
  const int ng = min(group, b - b0);
  int n0, count;
  if constexpr (kBanded) {
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    n0 = (int)(blockIdx.x / cluster.num_blocks()) * tile + rank * points;
    count = max(0, min(points, tile - rank * points));
  } else {
    n0 = blockIdx.x * points;
    count = min(points, h * w - n0);
  }

  // Pass 1: the flow of every (point, image), as pixel indices.
  int mn[kImgs];
#pragma unroll
  for (int i = 0; i < kImgs; ++i) mn[i] = INT_MAX;
  for (int c0 = 0; c0 < count; c0 += kRun) {
    const int cnt = min(kRun, count - c0);
    if (c0 > 0) __syncthreads();   // the previous chunk's rows are read
    stage_rows(reinterpret_cast<float*>(b_s), basis + (size_t)(n0 + c0) * m, cnt, m, m, mp);
    if (c0 == 0) {   // w, while the copies are in flight; zero beyond M
      for (int i = t; i < 2 * S::kGroup * mp; i += S::kThreads) {
        const int g = i / (2 * mp), j2 = i - g * 2 * mp;
        reinterpret_cast<float*>(w_s)[i] =
            g < ng && j2 < 2 * m ? weights[(size_t)(b0 + g) * 2 * m + j2] : 0.0f;
      }
    }
    cp_async_wait();
    __syncthreads();
    if (lane < cnt) {
      // Four j at a time: one 16-byte load of the point's basis values and
      // two broadcast loads of w per image. Beyond M both are zero, and
      // fmaf(0, 0, a) leaves a (up to the sign of a zero, which to_pixel's
      // c + 1 erases).
      float cy[kImgs], cx[kImgs];
#pragma unroll
      for (int i = 0; i < kImgs; ++i) cy[i] = cx[i] = 0.0f;
      const float4* row = b_s + lane * (mp / 4);
      const float4* wg = w_s + g_first * (mp / 2);
      for (int q = 0; q < mp / 4; ++q) {
        const float4 phi = row[q];
#pragma unroll
        for (int i = 0; i < kImgs; ++i) {
          const float4 w01 = wg[i * (mp / 2) + 2 * q], w23 = wg[i * (mp / 2) + 2 * q + 1];
          cy[i] = fmaf(phi.x, w01.x, cy[i]);
          cx[i] = fmaf(phi.x, w01.y, cx[i]);
          cy[i] = fmaf(phi.y, w01.z, cy[i]);
          cx[i] = fmaf(phi.y, w01.w, cx[i]);
          cy[i] = fmaf(phi.z, w23.x, cy[i]);
          cx[i] = fmaf(phi.z, w23.y, cx[i]);
          cy[i] = fmaf(phi.w, w23.z, cy[i]);
          cx[i] = fmaf(phi.w, w23.w, cx[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kImgs; ++i) {
        if (g_first + i < ng) {
          const float2 f = make_float2(partseg::to_pixel(cy[i], h), partseg::to_pixel(cx[i], w));
          f_s[(g_first + i) * points + c0 + lane] = f;
          if constexpr (kBanded) mn[i] = min(mn[i], (int)floorf(f.x));
        }
      }
    }
  }

  // Band mode: the tile's minimum row per image, over the CTA, then over
  // the cluster's CTAs.
  if constexpr (kBanded) {
#pragma unroll
    for (int i = 0; i < kImgs; ++i) {
      int v = mn[i];
      for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
      if ((t & 31) == 0) warp_min[(t >> 5) * kImgs + i] = v;
    }
    __syncthreads();
    if (t < S::kGroup) {   // image t: the warps of its subgroup
      constexpr int kSubWarps = S::kWarps / S::kSplit;
      const int sub = t / kImgs;
      int v = INT_MAX;
      for (int i = sub * kSubWarps; i < (sub + 1) * kSubWarps; ++i)
        v = min(v, warp_min[i * kImgs + t % kImgs]);
      cta_min[t] = v;
    }
    band_starts(cta_min, band_lo, S::kGroup, h, kh);
  }

  // Pass 2: each thread samples the (point, image) pairs whose indices it
  // stored, the taps of its kImgs images in flight together.
  for (int p = lane; p < count; p += kRun)
    sample_point<T, kC, kBanded, kImgs>(img, out, f_s, band_lo, points, p, g_first, ng, b0, n0,
                                         h, w, c, kh);
  if constexpr (kBanded) cg::this_cluster().sync();   // no CTA leaves while another reads its minima
}

// The wide path: Wide<kBanded>'s CTA, the basis through a ring of chunks.
// Grid (runs of points, groups of images), as tps_warp_kernel's. The
// basis rows must be 16-byte aligned: M a multiple of 4 and the basis
// 16-byte aligned (partseg_tps_warp refuses others).
template <typename T, int kC, bool kBanded>
__global__ void __launch_bounds__(Wide<kBanded>::kThreads, Wide<kBanded>::kMinBlocks)
tps_warp_wide_kernel(const T* __restrict__ img, const float* __restrict__ weights,
                     const float* __restrict__ basis, T* __restrict__ out, int b, int h, int w,
                     int c_rt, int m, int tile, int kh, int points, int group) {
  using V = Wide<kBanded>;
  constexpr int kP = V::kP, kI = V::kI, kRun = V::kRun, kStride = V::kStride;
  constexpr int kStage = kRun * kStride;           // words of one ring buffer
  constexpr int kGroups16 = V::kChunk / 4;         // 16-byte groups of a row's chunk
  const int sw = wide_w_stride(m);
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);                    // [group, sw]
  float* ring = w_s + group * sw;                                  // [kStages, kRun, kStride]
  float2* f_s = reinterpret_cast<float2*>(ring + V::kStages * kStage);   // [group, points]
  int* cta_min = reinterpret_cast<int*>(f_s + group * points);     // [kGroup]: read by the cluster
  int* band_lo = cta_min + V::kGroup;                              // [kGroup]

  const int c = kC > 0 ? kC : c_rt;
  const int t = threadIdx.x;
  const int warp = t >> 5, slot = (t & 31) >> 2, q = t & 3;
  const int b0 = blockIdx.y * group;
  const int ng = min(group, b - b0);
  const int hw = h * w;
  int n0, count;
  if constexpr (kBanded) {
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    n0 = (int)(blockIdx.x / cluster.num_blocks()) * tile + rank * points;
    count = max(0, min(points, tile - rank * points));
  } else {
    n0 = blockIdx.x * points;
    count = min(points, hw - n0);
  }
  const int chunks = (m + V::kChunk - 1) / V::kChunk;
  const long long total = (long long)hw * m;           // floats of the basis
  const bool w8 = (reinterpret_cast<uintptr_t>(weights) & 7) == 0;

  // Chunk ch into ring buffer ch % kStages: columns [j0, j0 + kChunk) of
  // the pass's rows [0, cnt) (points n_first + r) as 16-byte copies, zero
  // past the basis's end. With `with_w`, w's columns [j0, j0 + kChunk) of
  // the group's images too (8-byte copies of (y, x) pairs, 4-byte ones
  // where the weights are not 8-byte aligned), so w is staged once per CTA,
  // chunk by chunk with the basis.
  auto stage_chunk = [&](int ch, int n_first, int cnt, bool with_w) {
    float* buf = ring + (ch % V::kStages) * kStage;
    const int j0 = ch * V::kChunk;
    for (int i = t; i < cnt * kGroups16; i += V::kThreads) {
      const int r = i / kGroups16, u = i - r * kGroups16;
      const long long e = (long long)(n_first + r) * m + j0 + 4 * u;   // the group's first float
      cp_async16_fill(buf + r * kStride + 4 * u, basis + (e < total ? e : 0),
                      e < total ? 16 : 0);
    }
    const int jw = min(V::kChunk, m - j0);             // w's columns in this chunk
    for (int i = t; with_w && i < ng * jw; i += V::kThreads) {
      const int g = i / jw, j = j0 + (i - g * jw);
      float* dst = w_s + g * sw + 2 * j;
      const float* src = weights + ((size_t)(b0 + g) * m + j) * 2;
      if (w8) {
        cp_async8(dst, src);
      } else {
        cp_async4(dst, src, true);
        cp_async4(dst + 1, src + 1, true);
      }
    }
  };

  // This thread's images and their w rows, in float4s (an image past the
  // group reads the last row: its results are not stored).
  const float4* w4 = smem4;
  const float4* ring4 = reinterpret_cast<const float4*>(ring);
  int wrow[kI];
#pragma unroll
  for (int i = 0; i < kI; ++i) wrow[i] = min(q + 4 * i, group - 1) * (sw / 4);

  // Pass 1, in runs of kRun points: the flow of every (point, image), as
  // pixel indices.
  for (int c0 = 0; c0 < count; c0 += kRun) {
    const int cnt = min(kRun, count - c0);
    const int n_first = n0 + c0;
    if (c0 > 0) __syncthreads();   // the previous run's last chunk is read
#pragma unroll
    for (int st = 0; st < V::kStages - 1; ++st) {
      if (st < chunks) stage_chunk(st, n_first, cnt, c0 == 0);
      cp_async_commit();
    }
    float cy[kP][kI], cx[kP][kI];
#pragma unroll
    for (int k = 0; k < kP; ++k)
#pragma unroll
      for (int i = 0; i < kI; ++i) cy[k][i] = cx[k][i] = 0.0f;
    const int row0 = (warp * 8 * kP + slot) * (kStride / 4);   // this thread's first row, float4s
    for (int ch = 0; ch < chunks; ++ch) {
      cp_async_wait_group<V::kStages - 2>();   // chunk ch has landed (this thread's copies)
      __syncthreads();                         // everyone's; and chunk ch − 1 is read
      if (ch + V::kStages - 1 < chunks) stage_chunk(ch + V::kStages - 1, n_first, cnt, c0 == 0);
      cp_async_commit();
      const float4* buf = ring4 + (ch % V::kStages) * (kStage / 4) + row0;
      const int q0 = ch * (V::kChunk / 2);       // w's float4 of column j0
      const int steps = min(V::kChunk, m - ch * V::kChunk) / 4;
      // Four columns a step: per point one 16-byte load of its basis
      // values, per image two of w (y, x at j ... j + 3).
#pragma unroll 2
      for (int s4 = 0; s4 < steps; ++s4) {
        float4 bv[kP];
#pragma unroll
        for (int k = 0; k < kP; ++k) bv[k] = buf[k * 8 * (kStride / 4) + s4];
#pragma unroll
        for (int i = 0; i < kI; ++i) {
          const float4 w01 = w4[wrow[i] + q0 + 2 * s4], w23 = w4[wrow[i] + q0 + 2 * s4 + 1];
#pragma unroll
          for (int k = 0; k < kP; ++k) {
            cy[k][i] = fmaf(bv[k].x, w01.x, cy[k][i]);
            cx[k][i] = fmaf(bv[k].x, w01.y, cx[k][i]);
            cy[k][i] = fmaf(bv[k].y, w01.z, cy[k][i]);
            cx[k][i] = fmaf(bv[k].y, w01.w, cx[k][i]);
            cy[k][i] = fmaf(bv[k].z, w23.x, cy[k][i]);
            cx[k][i] = fmaf(bv[k].z, w23.y, cx[k][i]);
            cy[k][i] = fmaf(bv[k].w, w23.z, cy[k][i]);
            cx[k][i] = fmaf(bv[k].w, w23.w, cx[k][i]);
          }
        }
      }
    }
    cp_async_wait();
#pragma unroll
    for (int k = 0; k < kP; ++k) {
      const int r = warp * 8 * kP + slot + 8 * k;
#pragma unroll
      for (int i = 0; i < kI; ++i) {
        const int g = q + 4 * i;
        if (r < cnt && g < ng)
          f_s[g * points + c0 + r] =
              make_float2(partseg::to_pixel(cy[k][i], h), partseg::to_pixel(cx[k][i], w));
      }
    }
  }
  __syncthreads();

  // Band mode: the tile's minimum row per image, over the CTA (a warp per
  // image), then over the cluster's CTAs.
  if constexpr (kBanded) {
    for (int g = warp; g < V::kGroup; g += V::kWarps) {
      int v = INT_MAX;
      for (int p = t & 31; g < ng && p < count; p += 32)
        v = min(v, (int)floorf(f_s[g * points + p].x));
      for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
      if ((t & 31) == 0) cta_min[g] = v;
    }
    band_starts(cta_min, band_lo, V::kGroup, h, kh);
  }

  // Pass 2: a thread per point, four images' taps in flight at a time.
  for (int p = t; p < count; p += V::kThreads)
    for (int g0 = 0; g0 < ng; g0 += 4)
      sample_point<T, kC, kBanded, 4>(img, out, f_s, band_lo, points, p, g0, ng, b0, n0, h, w, c,
                                       kh);
  if constexpr (kBanded) cg::this_cluster().sync();   // no CTA leaves while another reads its minima
}

template <typename T, int kC, bool kBanded>
cudaError_t launch_mode(const T* img, const float* weights, const float* basis, T* out, int b,
                        int h, int w, int c, int m, int tile, int kh, const Plan& p,
                        cudaStream_t s) {
  // The wide path is built for C = 3 and for any C (the channel loop): its
  // time is the flow's, and fewer instances keep the build short.
  const bool wide = p.chunk < m;
  auto kernel = wide ? tps_warp_wide_kernel<T, kC == 3 ? 3 : 0, kBanded>
                     : tps_warp_kernel<T, kC, kBanded>;
  if (p.smem > kDefaultSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.grid_x, p.grid_y);
  cfg.blockDim = dim3(wide ? Wide<kBanded>::kThreads : Shape<kBanded>::kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kBanded ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, img, weights, basis, out, b, h, w, c, m, tile, kh,
                            p.points, p.group);
}

template <typename T, int kC>
cudaError_t launch(const T* img, const float* weights, const float* basis, T* out, int b,
                   int h, int w, int c, int m, int tile, int kh, const Plan& p,
                   cudaStream_t s) {
  return kh > 0 ? launch_mode<T, kC, true>(img, weights, basis, out, b, h, w, c, m, tile, kh, p, s)
                : launch_mode<T, kC, false>(img, weights, basis, out, b, h, w, c, m, tile, kh, p, s);
}

template <typename T>
cudaError_t launch_any(const void* img_, const float* weights, const float* basis, void* out_,
                       int b, int h, int w, int c, int m, int tile, int kh, const Plan& p,
                       cudaStream_t s) {
  const T* img = static_cast<const T*>(img_);
  T* out = static_cast<T*>(out_);
  switch (c) {
    case 1: return launch<T, 1>(img, weights, basis, out, b, h, w, c, m, tile, kh, p, s);
    case 2: return launch<T, 2>(img, weights, basis, out, b, h, w, c, m, tile, kh, p, s);
    case 3: return launch<T, 3>(img, weights, basis, out, b, h, w, c, m, tile, kh, p, s);
    case 4: return launch<T, 4>(img, weights, basis, out, b, h, w, c, m, tile, kh, p, s);
    default: return launch<T, 0>(img, weights, basis, out, b, h, w, c, m, tile, kh, p, s);
  }
}

}  // namespace

// img: [B, H, W, C] f32 or bf16 (img_is_bf16); weights: [B, M, 2] f32;
// basis: [H·W, M] f32; out: [B, H, W, C] in the image dtype. kh = 0: unbanded;
// kh > 0: band mode with `tile`-point tiles (the caller checks 0 < kh < H,
// tile % W == 0 and H·W % tile == 0). Where the plan takes the wide path
// (chunk < M), the basis rows must be 16-byte aligned: M a multiple of 4
// (pad the basis and w with zero columns: the flow is the same) and the
// basis 16-byte aligned; else cudaErrorInvalidValue. The caller keeps B <= 65535, H·W·C <
// 2³¹ and the plan's shared memory (partseg_tps_warp_plan) within the opt-in
// limit: neither the wide path's w of one image (M up to about 24,000) nor a
// tile's pixel indices alone always fit. Launches on `stream`, allocates
// nothing, does not synchronise. Returns the first CUDA error.
extern "C" int partseg_tps_warp(const void* img, int img_is_bf16, const float* weights,
                                const float* basis, void* out, int b, int h, int w, int c,
                                int m, int tile, int kh, void* stream) {
  const Plan p = make_plan(b, h, w, m, tile, kh);
  if (p.chunk < m && (m % 4 != 0 || (reinterpret_cast<uintptr_t>(basis) & 15) != 0))
    return static_cast<int>(cudaErrorInvalidValue);   // the wide path reads 16-byte rows
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      img_is_bf16
          ? launch_any<__nv_bfloat16>(img, weights, basis, out, b, h, w, c, m, tile, kh, p, s)
          : launch_any<float>(img, weights, basis, out, b, h, w, c, m, tile, kh, p, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

// The launch partseg_tps_warp makes for these arguments, as seven ints:
// points, group, cluster, grid_x, grid_y, smem bytes, basis chunk.
extern "C" void partseg_tps_warp_plan(int b, int h, int w, int m, int tile, int kh, int* plan) {
  const Plan p = make_plan(b, h, w, m, tile, kh);
  const int v[7] = {p.points, p.group, p.cluster, p.grid_x, p.grid_y, p.smem, p.chunk};
  for (int i = 0; i < 7; ++i) plan[i] = v[i];
}
