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
//      Where M is too wide for the rows to fit whole (M > 396 unbanded, M >
//      212 in band mode at 4096-point tiles), they are staged in chunks of
//      columns small enough for four CTAs to an SM (84 columns unbanded,
//      36 in band mode), w's with them, and each chain runs on across the
//      chunks, so the output does not depend on the chunking either.
//   2. Band mode: the tile's minimum tap row per image meets through a block
//      reduction and, where a tile spans a thread block cluster of up to 8
//      CTAs (so that the 4096-point tiles fill the card), through distributed
//      shared memory. Integer minima: the order does not matter.
//   3. Pass 2: each thread samples its (point, image) pairs from the stored
//      indices (no second flow): taps and lerp weights once per pair, the
//      kImgs images' loads in flight together, each tap row's pixel pair
//      read as the aligned 8-byte words that hold it (C ≤ 4), and the lerp
//      in f32 with the plain version's expression order; one rounding to the
//      image dtype at the store.
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

// The CTA of each mode: kThreads threads in kSplit subgroups of kRun; a
// chunk is kRun points, and subgroup s runs the flow of, and samples,
// images s·kImgs ... s·kImgs + kImgs − 1 of the group at every point of the
// chunk. Unbanded: 128-point runs, 8 images, two threads per point. Band
// mode: 256-point chunks (a 4096-point tile over a cluster of 8 CTAs of
// two chunks each) and 4 images, one thread per point.
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

// Dynamic shared memory, in 4-byte words: w [kGroup, MP, 2] and one chunk
// of basis rows [kRun, MP] (MP = row_stride(chunk), zero beyond the chunk);
// the pixel indices [group, points] as float2; the per-warp minima [kWarps,
// kImgs], the CTA's minima and the band starts [2, kGroup].
template <bool kBanded>
__host__ __device__ int smem_words(int mp, int points, int group) {
  using S = Shape<kBanded>;
  return 2 * S::kGroup * mp + S::kRun * mp + 2 * group * points + S::kWarps * S::kImgs +
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
    // The basis does not fit whole: stage it in chunks of columns, each as
    // wide as the largest stride (4 mod 8 words) that fits beside the
    // pixel indices of the most images that leave room for one, within
    // the share of an SM that lets kMinBlocks CTAs run on it together
    // where that leaves room, else within the opt-in limit.
    int budget = kSmemPerSM / S::kMinBlocks - 1024;
    p.group = S::kGroup;
    if (4 * smem_words<kBanded>(4, p.points, p.group) > budget) budget = kSmemOptIn;
    while (p.group > 1 && 4 * smem_words<kBanded>(4, p.points, p.group) > budget)
      p.group /= 2;
    const int mp = (budget / 4 - smem_words<kBanded>(0, p.points, p.group)) /
                   (2 * S::kGroup + S::kRun);
    p.chunk = mp >= 4 ? (mp - 4) / 8 * 8 + 4 : 4;
  }
  p.grid_y = (b + p.group - 1) / p.group;
  p.smem = 4 * smem_words<kBanded>(row_stride(p.chunk), p.points, p.group);
  return p;
}

__host__ Plan make_plan(int b, int h, int w, int m, int tile, int kh) {
  return kh > 0 ? plan_of<true>(b, h, w, m, tile) : plan_of<false>(b, h, w, m, tile);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// One float, or a zero where `valid` is false (src is then not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0) : "memory");
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

__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

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

// Grid (runs of points, groups of images). kC > 0: C = kC at compile time;
// kC = 0: any C, a loop over channels.
template <typename T, int kC, bool kBanded>
__global__ void __launch_bounds__(Shape<kBanded>::kThreads, Shape<kBanded>::kMinBlocks)
tps_warp_kernel(const T* __restrict__ img, const float* __restrict__ weights,
                const float* __restrict__ basis, T* __restrict__ out, int b, int h, int w,
                int c_rt, int m, int tile, int kh, int points, int group, int chunk) {
  using S = Shape<kBanded>;
  constexpr int kImgs = S::kImgs, kRun = S::kRun;
  const int mp = row_stride(chunk);
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
  const int hw = h * w;
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
    count = min(points, hw - n0);
  }

  // Pass 1: the flow of every (point, image), as pixel indices.
  int mn[kImgs];
#pragma unroll
  for (int i = 0; i < kImgs; ++i) mn[i] = INT_MAX;
  for (int c0 = 0; c0 < count; c0 += kRun) {
    const int cnt = min(kRun, count - c0);
    float cy[kImgs], cx[kImgs];
#pragma unroll
    for (int i = 0; i < kImgs; ++i) cy[i] = cx[i] = 0.0f;
    // The basis columns in chunks (one chunk unless M is too wide for
    // shared memory); the flows' FMA chains run on across chunks in j order.
    for (int j0 = 0; j0 < m; j0 += chunk) {
      const int jc = min(chunk, m - j0);
      if (c0 > 0 || j0 > 0) __syncthreads();   // the previous chunk's rows are read
      stage_rows(reinterpret_cast<float*>(b_s), basis + (size_t)(n0 + c0) * m + j0, cnt, jc, m,
                 mp);
      if (c0 == 0 || chunk < m) {   // w, while the copies are in flight; zero beyond the chunk
        for (int i = t; i < 2 * S::kGroup * mp; i += S::kThreads) {
          const int g = i / (2 * mp), j2 = i - g * 2 * mp;
          reinterpret_cast<float*>(w_s)[i] =
              g < ng && j2 < 2 * jc ? weights[(size_t)(b0 + g) * 2 * m + 2 * j0 + j2] : 0.0f;
        }
      }
      cp_async_wait();
      __syncthreads();
      if (lane >= cnt) continue;
      // Four j at a time: one 16-byte load of the point's basis values and
      // two broadcast loads of w per image. Beyond the chunk both are zero,
      // and fmaf(0, 0, a) leaves a (up to the sign of a zero, which
      // to_pixel's c + 1 erases).
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
    }
    if (lane < cnt) {
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
    cg::cluster_group cluster = cg::this_cluster();
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
    cluster.sync();
    if (t < S::kGroup) {
      int v = INT_MAX;
      for (int r = 0; r < (int)cluster.num_blocks(); ++r)
        v = min(v, cluster.map_shared_rank(cta_min, r)[t]);
      band_lo[t] = (min(max(v, 0), h - kh) / 8) * 8;   // sublane-aligned start, as on the TPU
    }
    __syncthreads();
  }

  // Pass 2: each thread samples the (point, image) pairs whose indices it
  // stored, the taps of its kImgs images in flight together.
  for (int p = lane; p < count; p += kRun) {
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
  if constexpr (kBanded) cg::this_cluster().sync();   // no CTA leaves while another reads its minima
}

template <typename T, int kC, bool kBanded>
cudaError_t launch_mode(const T* img, const float* weights, const float* basis, T* out, int b,
                        int h, int w, int c, int m, int tile, int kh, const Plan& p,
                        cudaStream_t s) {
  auto kernel = tps_warp_kernel<T, kC, kBanded>;
  if (p.smem > kDefaultSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.grid_x, p.grid_y);
  cfg.blockDim = dim3(Shape<kBanded>::kThreads);
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
                            p.points, p.group, p.chunk);
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
// tile % W == 0 and H·W % tile == 0). The caller keeps B <= 65535, H·W·C <
// 2³¹ and the plan's shared memory (partseg_tps_warp_plan) within the opt-in
// limit: any M fits, a tile's pixel indices alone may not. Launches on `stream`, allocates nothing, does not
// synchronise. Returns the first CUDA error.
extern "C" int partseg_tps_warp(const void* img, int img_is_bf16, const float* weights,
                                const float* basis, void* out, int b, int h, int w, int c,
                                int m, int tile, int kh, void* stream) {
  const Plan p = make_plan(b, h, w, m, tile, kh);
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
