// GroupNorm with a ReLU twin output, forward and backward (CUDA C++, sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves its GroupNorm (Flax
// nn.GroupNorm, models/blocks.py) to XLA, which fuses the statistics, the
// affine map and the ReLU that follows into the surrounding loops. On the
// H100 the same work through F.group_norm took an f32 copy of every bf16
// channels_last activation, a permute to NCHW (aten's NCHW-only kernels), two
// reads of that copy, an f32 output cast back, and a ReLU pass: some 36–40
// bytes moved per normalised element, where this kernel moves 6–8.
//
// What it computes, per sample b and group g of C/G channels, over H·W·C/G
// elements of x [B, H, W, C] (channels_last storage of the logical NCHW):
//   mean, var in f32 (var = E[(x − K)²] − E[x − K]², K the group's first
//   element: a shift that keeps the one-pass form exact to rounding where
//   |mean| ≫ σ), rstd = 1/√(var + eps),
//   y = ((x − mean)·rstd)·γ_c + β_c rounded once to x's dtype, r = relu(y).
// Either output may be left out. The backward takes the cotangents of y and
// r (either may be absent), applies the ReLU's mask recomputed from x, mean,
// rstd, γ and β with the forward's own arithmetic, sums the two branches in
// x's dtype (as autograd sums them at y), and forms
//   dx = rstd·(γ_c·g − (Σ γ·g)/N − x̂·(Σ γ·g·x̂)/N),
// with per-(b, c) partial sums of g and g·x̂ for dβ and dγ.
//
// What bounds it on the H100: device memory. The forward must read x once
// and write its outputs once (2 + 2 + 2 bytes an element in bf16 with both
// outputs); the backward reads x and the cotangents and writes dx. A few
// flops an element are far below the card's ridge.
//
// Design. A sample is split over a thread block cluster of CS <= 16 CTAs (CS
// from the batch and the sample's size: at least two CTAs an SM, and slices
// small enough to stage; 16 is above the portable 8, and the H100 schedules
// it within one GPC); CTA `rank` owns a contiguous run of pixels, all C
// channels: one contiguous byte range.
//   1. Threads read the slice as 16-byte vectors (V elements), neighbouring
//      threads on neighbouring vectors, several vectors in flight a thread.
//      The CTA's thread count T makes T·V a multiple of C, so thread t's lanes
//      sit on the same channels (t·V + j) mod C on every vector it reads:
//      per-lane sums, γ, β and the group's statistics live in registers.
//   2. The first `n_stage` vectors of the slice (as many as the shared-memory
//      budget holds) are kept in shared memory; the rest are read again in
//      the second pass, shortly after the first, so mostly from the L2. The
//      forward stages x with cp.async, a thread's whole share in flight at
//      once; the backward reads x and both cotangents through registers and
//      stages x and the summed cotangent g (two tensors where the raw
//      cotangents would take three: more of the slice stays on chip, which
//      measured faster than cp.async of all three).
//   3. Per-lane partials go to shared memory as a [T·V / C, C] array: each
//      channel's column sums in row order, each group's channels in order.
//   4. Each CTA's group partials are read by every CTA of the cluster through
//      distributed shared memory, in rank order: the same bits everywhere.
//   5. The second pass applies the affine map (forward) or the gradient
//      (backward) and writes 16-byte vectors.
// No atomics: repeats give the same bits. A shape whose sample size or
// pointers are not 16-byte multiples runs the same code one element at a
// time (V = 1).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxGroups = 64;        // the wrapper raises above
constexpr int kMaxCluster = 16;       // above the portable 8: opted into per kernel
constexpr int kMaxThreads = 512;      // the wrapper's plan stays at or below
constexpr int kMaxSmem = 227 * 1024;  // shared memory a CTA may opt into, static included
constexpr int kStaticSmem = 4 * kMaxGroups * sizeof(float);   // each kernel's static arrays

// Elements: f32 as itself, bf16 as its raw 16 bits.
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  __device__ static float load(float v) { return v; }
  __device__ static float store(float v) { return v; }
  __device__ static float round(float v) { return v; }
};
template <>
struct Elem<uint16_t> {
  __device__ static float load(uint16_t v) { return __uint_as_float((uint32_t)v << 16); }
  __device__ static uint16_t store(float v) { return __bfloat16_as_ushort(__float2bfloat16_rn(v)); }
  __device__ static float round(float v) { return load(store(v)); }
};

// V elements of T: one 16-byte word, or a single element (V = 1).
template <typename T, int V>
struct Vec {
  static constexpr bool kWide = V * sizeof(T) == 16;
  static_assert(kWide || V == 1, "a vector is 16 bytes or one element");
  using Raw = typename std::conditional<kWide, uint4, T>::type;

  __device__ static void unpack(const Raw& raw, float (&f)[V]) {
    if constexpr (!kWide) {
      f[0] = Elem<T>::load(raw);
    } else {
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
      if constexpr (sizeof(T) == 4) {
#pragma unroll
        for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(w[i]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          f[2 * i] = __uint_as_float(w[i] << 16);
          f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
      }
    }
  }

  __device__ static Raw pack(const float (&f)[V]) {
    if constexpr (!kWide) {
      return Elem<T>::store(f[0]);
    } else {
      uint32_t w[4];
      if constexpr (sizeof(T) == 4) {
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = __float_as_uint(f[i]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[i] = (uint32_t)Elem<T>::store(f[2 * i]) | ((uint32_t)Elem<T>::store(f[2 * i + 1]) << 16);
      }
      return make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
};

// A first read that should stay in the L2 for the second, and the second.
template <typename R>
__device__ __forceinline__ R load_keep(const R* p) { return __ldg(p); }
template <typename R>
__device__ __forceinline__ R load_last(const R* p) { return __ldcs(p); }

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// y before its rounding: the forward's expression, which the backward's
// ReLU mask repeats bit for bit.
__device__ __forceinline__ float affine(float x, float mean, float rstd, float gamma, float beta) {
  return fmaf((x - mean) * rstd, gamma, beta);
}

// Bytes of dynamic shared memory: `staged` staging areas of n_stage vectors
// (each 16-byte aligned), then two [T·V] partial arrays and two [C] sums.
__host__ __device__ inline size_t stage_bytes(int n_stage, int raw_bytes) {
  return ((size_t)n_stage * raw_bytes + 15) & ~(size_t)15;
}
__host__ __device__ inline size_t smem_bytes(int staged, int n_stage, int raw_bytes, int threads,
                                             int vec, int c) {
  return staged * stage_bytes(n_stage, raw_bytes) +
         (2 * (size_t)threads * vec + 2 * (size_t)c) * sizeof(float);
}

// Where a CTA's slice lies.
struct Slice {
  int rank, cs, b, nvec;
  size_t off;   // element offset of the slice in the tensor
};

__device__ __forceinline__ Slice slice(int hw, int c, int run, int v) {
  cg::cluster_group cluster = cg::this_cluster();
  Slice s;
  s.cs = (int)cluster.num_blocks();
  s.rank = (int)cluster.block_rank();
  s.b = blockIdx.x / s.cs;
  const int p0 = s.rank * run;
  const int npix = max(0, min(run, hw - p0));
  s.off = (size_t)s.b * hw * c + (size_t)p0 * c;
  s.nvec = npix * c / v;
  return s;
}

// Sums the per-lane partials a[T·V] (and b) by channel in row order into
// ca[C] (and cb); the caller syncs before and after.
__device__ __forceinline__ void channel_sums(const float* a, const float* b, float* ca, float* cb,
                                             int rows, int c) {
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float sa = 0.0f, sb = 0.0f;
    for (int row = 0; row < rows; ++row) {
      sa += a[row * c + ch];
      sb += b[row * c + ch];
    }
    ca[ch] = sa;
    cb[ch] = sb;
  }
}

// Starts a 16-byte copy from device to shared memory; the caller commits
// and waits (cp.async.wait_all) before reading it.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The forward's pass 1 over a CTA's slice (vectors [0, nvec) of src):
// vectors below n_st are staged in shared memory, with cp.async all at once
// where vectors are 16 bytes (a thread's whole share in flight), else
// through registers; the rest are read into registers kBatch at a time.
// `visit(v)` sees each vector, every thread its own vectors t, t + T, ...:
// the staged ones after the rest, so their copies overlap the other reads.
// n_st is nvec or a multiple of T, so a thread's vectors keep its channels
// on both sides of it.
template <typename Raw, int kBatch, bool kWide, typename Visit>
__device__ __forceinline__ void first_pass(const Raw* src, Raw* stage, int nvec, int n_st,
                                           Visit visit) {
  const int t = threadIdx.x, nt = blockDim.x;
  if constexpr (kWide) {
    for (int i = t; i < n_st; i += nt) cp_async16(stage + i, src + i);
    cp_async_commit();
  }
  for (int i0 = (kWide ? n_st : 0) + t; i0 < nvec; i0 += kBatch * nt) {
    Raw v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (i0 + u * nt < nvec) v[u] = load_keep(src + i0 + u * nt);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * nt;
      if (i < nvec) {
        if (!kWide && i < n_st) stage[i] = v[u];
        visit(v[u]);
      }
    }
  }
  if constexpr (kWide) {
    cp_async_wait_all();
    for (int i = t; i < n_st; i += nt) visit(stage[i]);
  }
}

template <typename T, int V, int kBatch>
__global__ void __launch_bounds__(kMaxThreads)
group_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, T* __restrict__ y, T* __restrict__ r,
                      float* __restrict__ mean_out, float* __restrict__ rstd_out, int hw, int c,
                      int groups, float eps, int run, int n_stage) {
  using VT = Vec<T, V>;
  using Raw = typename VT::Raw;
  extern __shared__ uint4 smem[];
  __shared__ float cta_sum[2][kMaxGroups];   // this CTA's shifted sums: read by the cluster
  __shared__ float stat[2][kMaxGroups];      // the sample's mean and rstd per group

  cg::cluster_group cluster = cg::this_cluster();
  const Slice s = slice(hw, c, run, V);
  const int t = threadIdx.x, nt = blockDim.x;
  const int cpg = c / groups;
  const int n_st = min(n_stage, s.nvec);
  const T* xb = x + (size_t)s.b * hw * c;   // the sample
  const Raw* src = reinterpret_cast<const Raw*>(x + s.off);
  Raw* stage = reinterpret_cast<Raw*>(smem);
  float* part_s = reinterpret_cast<float*>(reinterpret_cast<char*>(smem) +
                                           stage_bytes(n_stage, sizeof(Raw)));
  float* part_q = part_s + nt * V;
  float* chan_s = part_q + nt * V;
  float* chan_q = chan_s + c;

  int ch[V], gi[V];
  float shift[V], sum[V], sq[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    ch[j] = (t * V + j) % c;
    gi[j] = ch[j] / cpg;
    shift[j] = Elem<T>::load(xb[gi[j] * cpg]);
    sum[j] = 0.0f;
    sq[j] = 0.0f;
  }

  // Pass 1: shifted sums and sums of squares per lane.
  first_pass<Raw, kBatch, VT::kWide>(src, stage, s.nvec, n_st, [&](const Raw& v) {
    float f[V];
    VT::unpack(v, f);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = f[j] - shift[j];
      sum[j] += d;
      sq[j] = fmaf(d, d, sq[j]);
    }
  });
#pragma unroll
  for (int j = 0; j < V; ++j) {
    part_s[t * V + j] = sum[j];
    part_q[t * V + j] = sq[j];
  }
  __syncthreads();
  channel_sums(part_s, part_q, chan_s, chan_q, nt * V / c, c);
  __syncthreads();
  for (int g = t; g < groups; g += nt) {
    float a = 0.0f, q = 0.0f;
    for (int k = 0; k < cpg; ++k) {
      a += chan_s[g * cpg + k];
      q += chan_q[g * cpg + k];
    }
    cta_sum[0][g] = a;
    cta_sum[1][g] = q;
  }
  cluster.sync();
  for (int g = t; g < groups; g += nt) {   // the cluster's CTAs in rank order
    float a = 0.0f, q = 0.0f;
    for (int k = 0; k < s.cs; ++k) {
      a += cluster.map_shared_rank(&cta_sum[0][0], k)[g];
      q += cluster.map_shared_rank(&cta_sum[1][0], k)[g];
    }
    const float n = (float)cpg * (float)hw;
    const float m = a / n;
    const float mean = Elem<T>::load(xb[g * cpg]) + m;
    const float rstd = 1.0f / sqrtf(fmaxf(q / n - m * m, 0.0f) + eps);
    stat[0][g] = mean;
    stat[1][g] = rstd;
    if (s.rank == 0) {
      mean_out[s.b * groups + g] = mean;
      rstd_out[s.b * groups + g] = rstd;
    }
  }
  cluster_arrive();   // this CTA is done reading its peers' sums
  __syncthreads();

  // Pass 2: y = ((x − mean)·rstd)·γ + β, and relu(y).
  float mean[V], rstd[V], ga[V], be[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mean[j] = stat[0][gi[j]];
    rstd[j] = stat[1][gi[j]];
    ga[j] = gamma[ch[j]];
    be[j] = beta[ch[j]];
  }
  Raw* yo = y ? reinterpret_cast<Raw*>(y + s.off) : nullptr;
  Raw* ro = r ? reinterpret_cast<Raw*>(r + s.off) : nullptr;
  for (int i0 = t; i0 < s.nvec; i0 += kBatch * nt) {
    Raw v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * nt;
      if (i < s.nvec) v[u] = i < n_st ? stage[i] : load_last(src + i);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * nt;
      if (i < s.nvec) {
        float f[V], rv[V];
        VT::unpack(v[u], f);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          f[j] = affine(f[j], mean[j], rstd[j], ga[j], be[j]);
          rv[j] = f[j] < 0.0f ? 0.0f : f[j];   // relu of y as rounded: rounding keeps the sign
        }
        if (yo) yo[i] = VT::pack(f);
        if (ro) ro[i] = VT::pack(rv);
      }
    }
  }
  cluster_wait();   // no CTA leaves while another reads its shared memory
}

// The cotangent that reaches y: g_y (where has_y), plus g_r where relu let
// y through (where has_r), summed in x's dtype (autograd's sum at y). x̂ is
// returned in `xh`.
template <typename T, int V>
__device__ __forceinline__ void cotangent(const float (&xf)[V], bool has_y, const float (&gyf)[V],
                                          bool has_r, const float (&grf)[V],
                                          const float (&mean)[V], const float (&rstd)[V],
                                          const float (&ga)[V], const float (&be)[V],
                                          float (&xh)[V], float (&g)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    xh[j] = (xf[j] - mean[j]) * rstd[j];
    float gj = has_y ? gyf[j] : 0.0f;
    if (has_r) {
      const float yv = Elem<T>::round(affine(xf[j], mean[j], rstd[j], ga[j], be[j]));
      if (!(yv <= 0.0f)) gj += grf[j];
      if (has_y) gj = Elem<T>::round(gj);
    }
    g[j] = gj;
  }
}

template <typename T, int V, int kBatch>
__global__ void __launch_bounds__(kMaxThreads)
group_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gy, const T* __restrict__ gr,
                      const float* __restrict__ gamma, const float* __restrict__ beta,
                      const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
                      T* __restrict__ dx, float* __restrict__ part_out, int hw, int c,
                      int groups, int run, int n_stage) {
  using VT = Vec<T, V>;
  using Raw = typename VT::Raw;
  extern __shared__ uint4 smem[];
  __shared__ float cta_sum[2][kMaxGroups];   // Σ γ·g and Σ γ·g·x̂: read by the cluster
  __shared__ float coef[2][kMaxGroups];      // rstd·Σγg / N and rstd·Σγgx̂ / N

  cg::cluster_group cluster = cg::this_cluster();
  const Slice s = slice(hw, c, run, V);
  const int t = threadIdx.x, nt = blockDim.x;
  const int cpg = c / groups;
  const bool has_y = gy != nullptr, has_r = gr != nullptr;
  const Raw* const src[3] = {reinterpret_cast<const Raw*>(x + s.off),
                             has_y ? reinterpret_cast<const Raw*>(gy + s.off) : nullptr,
                             has_r ? reinterpret_cast<const Raw*>(gr + s.off) : nullptr};
  // The staged prefix keeps x and the summed cotangent g (in x's dtype,
  // exact: the sum is rounded to it anyway): two tensors, not three.
  const size_t sb = stage_bytes(n_stage, sizeof(Raw));
  Raw* stage_x = reinterpret_cast<Raw*>(smem);
  Raw* stage_g = reinterpret_cast<Raw*>(reinterpret_cast<char*>(smem) + sb);
  float* part_a = reinterpret_cast<float*>(reinterpret_cast<char*>(smem) + 2 * sb);
  float* part_b = part_a + nt * V;
  float* chan_a = part_b + nt * V;
  float* chan_b = chan_a + c;

  int ch[V], gi[V];
  float mean[V], rstd[V], ga[V], be[V], sa[V], sg[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    ch[j] = (t * V + j) % c;
    gi[j] = ch[j] / cpg;
    mean[j] = mean_in[s.b * groups + gi[j]];
    rstd[j] = rstd_in[s.b * groups + gi[j]];
    ga[j] = gamma[ch[j]];
    be[j] = beta[ch[j]];
    sa[j] = 0.0f;
    sg[j] = 0.0f;
  }
  auto grad = [&](const Raw (&v)[3], float (&xh)[V], float (&g)[V]) {
    float xf[V], gyf[V] = {}, grf[V] = {};
    VT::unpack(v[0], xf);
    if (has_y) VT::unpack(v[1], gyf);
    if (has_r) VT::unpack(v[2], grf);
    cotangent<T, V>(xf, has_y, gyf, has_r, grf, mean, rstd, ga, be, xh, g);
  };

  // Pass 1: per lane Σ g and Σ g·x̂; stage x and g for the prefix. The
  // three tensors come through registers, kBatch vectors of each in flight.
  for (int i0 = t; i0 < s.nvec; i0 += kBatch * nt) {
    Raw v[kBatch][3];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * nt;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        if (i < s.nvec && src[k]) v[u][k] = load_keep(src[k] + i);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * nt;
      if (i < s.nvec) {
        float xh[V], g[V];
        grad(v[u], xh, g);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          sa[j] += g[j];
          sg[j] = fmaf(g[j], xh[j], sg[j]);
        }
        if (i < n_stage) {
          stage_x[i] = v[u][0];
          stage_g[i] = VT::pack(g);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    part_a[t * V + j] = sa[j];
    part_b[t * V + j] = sg[j];
  }
  __syncthreads();
  channel_sums(part_a, part_b, chan_a, chan_b, nt * V / c, c);
  __syncthreads();
  float* out = part_out + ((size_t)s.b * s.cs + s.rank) * 2 * c;   // [B·CS, 2, C]: dβ, dγ shares
  for (int k = t; k < c; k += nt) {
    out[k] = chan_a[k];
    out[c + k] = chan_b[k];
  }
  for (int g = t; g < groups; g += nt) {
    float a = 0.0f, b = 0.0f;
    for (int k = g * cpg; k < (g + 1) * cpg; ++k) {
      a = fmaf(gamma[k], chan_a[k], a);
      b = fmaf(gamma[k], chan_b[k], b);
    }
    cta_sum[0][g] = a;
    cta_sum[1][g] = b;
  }
  cluster.sync();
  for (int g = t; g < groups; g += nt) {   // the cluster's CTAs in rank order
    float a = 0.0f, b = 0.0f;
    for (int k = 0; k < s.cs; ++k) {
      a += cluster.map_shared_rank(&cta_sum[0][0], k)[g];
      b += cluster.map_shared_rank(&cta_sum[1][0], k)[g];
    }
    const float rs_n = rstd_in[s.b * groups + g] / ((float)cpg * (float)hw);
    coef[0][g] = a * rs_n;
    coef[1][g] = b * rs_n;
  }
  cluster_arrive();
  __syncthreads();

  // Pass 2: dx = rstd·γ·g − (rstd·Σγg/N + x̂·rstd·Σγgx̂/N).
  float k1[V], k2[V], k3[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    k1[j] = rstd[j] * ga[j];
    k2[j] = coef[0][gi[j]];
    k3[j] = coef[1][gi[j]];
  }
  Raw* dxo = reinterpret_cast<Raw*>(dx + s.off);
  for (int i0 = t; i0 < s.nvec; i0 += kBatch * nt) {
    Raw v[kBatch][3];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * nt;
      if (i < n_stage) {
        v[u][0] = stage_x[i];
        v[u][1] = stage_g[i];
      } else {
#pragma unroll
        for (int k = 0; k < 3; ++k)
          if (i < s.nvec && src[k]) v[u][k] = load_last(src[k] + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * nt;
      if (i < s.nvec) {
        float xh[V], g[V], d[V];
        if (i < n_stage) {
          float xf[V];
          VT::unpack(v[u][0], xf);
          VT::unpack(v[u][1], g);
#pragma unroll
          for (int j = 0; j < V; ++j) xh[j] = (xf[j] - mean[j]) * rstd[j];
        } else {
          grad(v[u], xh, g);
        }
#pragma unroll
        for (int j = 0; j < V; ++j) d[j] = fmaf(k1[j], g[j], -fmaf(xh[j], k3[j], k2[j]));
        dxo[i] = VT::pack(d);
      }
    }
  }
  cluster_wait();
}

struct Plan {
  int threads, cs, run, n_stage;
};

// What every launch needs of its plan; the wrapper's plan satisfies it.
bool valid(int b, int c, int hw, int groups, int vec, const Plan& p, size_t smem) {
  return b > 0 && c > 0 && hw > 0 && groups > 0 && groups <= kMaxGroups && c % groups == 0 &&
         p.threads > 0 && p.threads <= kMaxThreads && (p.threads * vec) % c == 0 && p.cs > 0 &&
         p.cs <= kMaxCluster && p.run > 0 && ((long long)p.run * c) % vec == 0 &&
         ((long long)hw * c) % vec == 0 && (long long)(p.cs - 1) * p.run < hw &&
         (long long)p.cs * p.run >= hw && p.n_stage >= 0 &&
         (long long)p.n_stage * vec <= (long long)p.run * c &&
         (p.n_stage % p.threads == 0 || (long long)p.n_stage * vec == (long long)p.run * c) &&
         smem <= (size_t)(kMaxSmem - kStaticSmem) &&
         (long long)b * p.cs < (1LL << 31);
}

// Opts `kernel` into the largest dynamic shared memory it can take and into
// clusters of 16, once per process (the caller keeps a static per instance).
template <typename Kernel>
cudaError_t opt_in(Kernel kernel) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem - kStaticSmem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int b, const Plan& p, size_t smem, cudaStream_t stream,
                   Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * p.cs);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

constexpr int kFwdBatch = 4;   // vectors in flight a thread: 64 bytes
constexpr int kBwdBatch = 2;   // of each of three tensors: 96 bytes

template <typename T, int V>
cudaError_t forward(const void* x, const float* gamma, const float* beta, void* y, void* r,
                    float* mean, float* rstd, int b, int c, int hw, int groups, float eps,
                    const Plan& p, cudaStream_t stream) {
  using Raw = typename Vec<T, V>::Raw;
  const size_t smem = smem_bytes(1, p.n_stage, sizeof(Raw), p.threads, V, c);
  if (!valid(b, c, hw, groups, V, p, smem)) return cudaErrorInvalidValue;
  static const cudaError_t opted = opt_in(group_norm_fwd_kernel<T, V, kFwdBatch>);
  if (opted != cudaSuccess) return opted;
  return launch(group_norm_fwd_kernel<T, V, kFwdBatch>, b, p, smem, stream,
                static_cast<const T*>(x), gamma, beta, static_cast<T*>(y), static_cast<T*>(r),
                mean, rstd, hw, c, groups, eps, p.run, p.n_stage);
}

template <typename T, int V>
cudaError_t backward(const void* x, const void* gy, const void* gr, const float* gamma,
                     const float* beta, const float* mean, const float* rstd, void* dx,
                     float* part, int b, int c, int hw, int groups, const Plan& p,
                     cudaStream_t stream) {
  using Raw = typename Vec<T, V>::Raw;
  const size_t smem = smem_bytes(2, p.n_stage, sizeof(Raw), p.threads, V, c);
  if (!valid(b, c, hw, groups, V, p, smem)) return cudaErrorInvalidValue;
  static const cudaError_t opted = opt_in(group_norm_bwd_kernel<T, V, kBwdBatch>);
  if (opted != cudaSuccess) return opted;
  return launch(group_norm_bwd_kernel<T, V, kBwdBatch>, b, p, smem, stream,
                static_cast<const T*>(x), static_cast<const T*>(gy), static_cast<const T*>(gr),
                gamma, beta, mean, rstd, static_cast<T*>(dx), part, hw, c, groups, p.run,
                p.n_stage);
}

}  // namespace

// x, y, r: [B, H, W, C] (channels_last storage) in bf16 (bf16 = 1) or f32;
// gamma, beta: [C] f32; mean, rstd: [B, G] f32 out. y or r may be null (not
// written). vec: 16 / element size, or 1 (the wrapper picks it from the
// shape and the pointers' alignment); threads, cs, run, n_stage: the
// wrapper's launch plan (partops/kernels/group_norm.py:launch_plan). Launches
// on `stream`, allocates nothing, does not synchronise. Returns the first
// CUDA error (cudaErrorInvalidValue for a plan the kernel cannot take).
extern "C" int partseg_group_norm_fwd(const void* x, const float* gamma, const float* beta,
                                      void* y, void* r, float* mean, float* rstd, int bf16,
                                      int vec, int b, int c, int hw, int groups, float eps,
                                      int threads, int cs, int run, int n_stage, void* stream) {
  const Plan p = {threads, cs, run, n_stage};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (y == nullptr && r == nullptr) return static_cast<int>(err);
  if (bf16 && vec == 8)
    err = forward<uint16_t, 8>(x, gamma, beta, y, r, mean, rstd, b, c, hw, groups, eps, p, s);
  else if (bf16 && vec == 1)
    err = forward<uint16_t, 1>(x, gamma, beta, y, r, mean, rstd, b, c, hw, groups, eps, p, s);
  else if (!bf16 && vec == 4)
    err = forward<float, 4>(x, gamma, beta, y, r, mean, rstd, b, c, hw, groups, eps, p, s);
  else if (!bf16 && vec == 1)
    err = forward<float, 1>(x, gamma, beta, y, r, mean, rstd, b, c, hw, groups, eps, p, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

// x, gy, gr, dx: [B, H, W, C] (channels_last storage) in x's dtype; gy or gr
// may be null (no cotangent); gamma, beta: [C] f32; mean, rstd: [B, G] f32
// from the forward; part: [B·CS, 2, C] f32 out, each CTA's Σ g and Σ g·x̂
// per channel (the caller sums them over the first axis for dβ and dγ).
// The plan as for the forward. Returns the first CUDA error.
extern "C" int partseg_group_norm_bwd(const void* x, const void* gy, const void* gr,
                                      const float* gamma, const float* beta, const float* mean,
                                      const float* rstd, void* dx, float* part, int bf16,
                                      int vec, int b, int c, int hw, int groups, int threads,
                                      int cs, int run, int n_stage, void* stream) {
  const Plan p = {threads, cs, run, n_stage};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (gy == nullptr && gr == nullptr) return static_cast<int>(err);
  if (bf16 && vec == 8)
    err = backward<uint16_t, 8>(x, gy, gr, gamma, beta, mean, rstd, dx, part, b, c, hw, groups, p, s);
  else if (bf16 && vec == 1)
    err = backward<uint16_t, 1>(x, gy, gr, gamma, beta, mean, rstd, dx, part, b, c, hw, groups, p, s);
  else if (!bf16 && vec == 4)
    err = backward<float, 4>(x, gy, gr, gamma, beta, mean, rstd, dx, part, b, c, hw, groups, p, s);
  else if (!bf16 && vec == 1)
    err = backward<float, 1>(x, gy, gr, gamma, beta, mean, rstd, dx, part, b, c, hw, groups, p, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}
