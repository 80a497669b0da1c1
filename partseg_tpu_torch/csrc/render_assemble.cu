// Fused Gaussian part render + decoder-input assembly, and its backward
// (CUDA C++, sm_90a).
//
// Replaces the Pallas TPU kernel partseg_tpu/partops/pallas/render_assemble.py
// (`render_assemble` -> `_forward` -> `_kernel`) and its custom_vjp backward
// (`_bwd`, jnp on the TPU). For every output pixel u and channel c:
//   out[b, u, c] = Σ_k φ_k(u) · a[b, k, c],
//   d = max(Λ00·dy² + 2Λ01·dy·dx + Λ11·dx², 0),  (dy, dx) = u − μ_k,
//   φ = exp(−½ d) ("gauss") or 1 / (1 + d) ("heavy_tail").
// The [B, H, W, K] blob tensor of the unfused path is never written.
//
// Forward. What bounds it on the H100: device memory. The f32 output is the
// only large array (B·H·W·C·4 bytes); the work is ~2 flops per output
// element per part (K = 10: ~5 flop/byte, K = 16: ~8, far below the f32
// ridge), so no tensor cores. A block walks a share of one image's tiles of
// pixels: per tile it computes φ[tile, K] once into shared memory (rows
// padded with zero parts to the register tile: 12 parts for K <= 12, 16 for
// K <= 16, 32 above); each thread owns a quad of channels, holds
// a[0..K−1][c..c+3] in registers for all its tiles, and walks pixels
// reading φ rows as broadcast float4 loads — one shared load feeds 16 FMAs —
// and storing float4 outputs, coalesced across the quads of a row. Thread
// roles come from a 2-D split of threadIdx.x made once, so no integer
// division runs per output. The TPU kernel's 128-lane padding of K and C
// (and its Λ = I padding parts) existed only for the TPU's tiles.
// K <= 12 takes tiles of 256 pixels (64 for images of at most 128 pixels)
// and about kTargetBlocks blocks in all. 13 <= K <= 16 (deepfashion,
// human36m, penn_action) has a 16-part tile of its own: a 32-part tile
// there held 128 registers of a per thread and did half its FMAs, φ
// fills and φ shared memory on zero parts. Its tile and blocks per image
// come from forward_plan16, chosen on the H100 at the K = 16 decoder's
// four scales (B = 64), where the output is small and few blocks would
// leave SMs idle. Parts are summed in order from 0 in every tile: the zero
// parts only ever added fmaf(0, a, acc) = acc, so the 16-part tile gives
// the 32-part tile's bits. 17 <= K <= 32 (no preset) keeps the 32-part
// tile: splitting its parts into two groups of 16 would need a second
// register set of a or a second pass over the output.
//
// Backward, the closed form of `_bwd` exactly: φ and dφ/dd recomputed in f32
// from μ and Λ, g_φ[u,k] = Σ_c g[u,c]·a[k,c], g_d = g_φ·dφ/dd, and per part
//   d_app[k,c] = Σ_u φ·g,   d_μ = −2Λ·Σ_u g_d·diff,   d_sym = Σ_u g_d·diff·diffᵀ,
// the whole off-diagonal on d_lam[..,0,1] and 0 on [..,1,0], no mask where
// the clamp was active. What bounds it: one read of the f32 cotangent g
// (4·H·W·C bytes per image); the work is ~4 flops per element of g per part
// (K = 10: ~10 flop/byte, below the f32 ridge), so no tensor cores.
// A design that staged g and a in shared memory issued two scalar shared
// loads per FMA in both sums and summed per-tile partials in a second
// launch; shared memory and the two launches bounded it. The register-tiled
// kernel applies the forward's remedy: a lane holds
// d_app[k][its channel quad] in registers over all its pixels, reads g
// straight from device memory as float4 (a few pixels ahead), and takes φ
// rows as broadcast float4s and a from shared memory. The per-pixel g_φ is
// a sum over the quads of a pixel row: a reduce-scatter butterfly of
// shuffles leaves each lane the whole g_φ of a few parts, and that lane adds
// the five sums Σ g_d·{dy, dx, dy², dy·dx, dx²}. Any K and C: g_d = g_φ·dφ/dd
// and dφ/dd does not depend on g, so the five sums are linear in g_φ, and a
// chunk of 128 channels adds its own share of them (and owns its slice of
// d_app); a block walks the chunks one after the other and adds their
// shares in the same registers, so g is read once. Parts are independent in
// every sum: K <= 12 is one group of 12 parts, larger K groups of 16 (two
// groups, each reading g, above 16). An image of at most 8 tiles is one
// thread block cluster per part group, which sums its CTAs' partials
// through distributed shared memory in rank order: one launch. Larger
// images (the decoders' 64² and 128²) write per-block partials that a
// second launch sums in block order. No atomics anywhere: the result is
// the same bits on every run.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTargetBlocks = 1024;   // forward: blocks in all, about 8 per SM
constexpr int kTargetBlocks16 = 256;  // the 16-part forward: about 2 per SM
constexpr int kMaxParts = 32;   // the wrapper raises above this

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// μ (y, x) and Λ (00, 01, 11) of image b's parts into shared memory.
__device__ __forceinline__ void load_parts(const float* __restrict__ mu,
                                           const float* __restrict__ lam, int b, int k,
                                           float (*par)[kMaxParts]) {
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const float* m = mu + ((size_t)b * k + i) * 2;
    const float* l = lam + ((size_t)b * k + i) * 4;
    par[0][i] = m[0];
    par[1][i] = m[1];
    par[2][i] = l[0];
    par[3][i] = l[1];
    par[4][i] = l[3];
  }
}

// The pixel-centre coordinate of flat pixel n: the same float32 expression
// as partops/coords.py's numpy grid.
__device__ __forceinline__ float2 pixel_coord(int n, int h, int w) {
  const int yi = n / w;
  const int xi = n - yi * w;
  return make_float2(-1.0f + (2.0f * ((float)yi + 0.5f)) / (float)h,
                     -1.0f + (2.0f * ((float)xi + 0.5f)) / (float)w);
}

// One step of a reduce-scatter butterfly over lanes `mask` apart: a lane
// keeps the lower (or, with `upper`, the upper) kHalf of v[0, 2·kHalf) and
// adds its partner's copy of them into v[0, kHalf). kHalf is a compile-time
// constant, so every index is one and v stays in registers.
template <int kHalf, int kN>
__device__ __forceinline__ void halve(float (&v)[kN], bool upper, int mask) {
#pragma unroll
  for (int e = 0; e < kHalf; ++e) {
    const float lo = v[e];
    const float hi = v[e + kHalf];
    const float send = upper ? lo : hi;
    const float keep = upper ? hi : lo;
    v[e] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

// φ of one part at offset (dy, dx) from its mean, and dφ/dd. Clamp: a
// numerically indefinite Λ must not turn exp(−½d) into exp(+).
template <bool kGauss>
__device__ __forceinline__ float part_phi(const float (*par)[kMaxParts], int part, float dy,
                                          float dx, float* dphi) {
  const float d = fmaxf(par[2][part] * dy * dy + 2.0f * par[3][part] * dy * dx +
                            par[4][part] * dx * dx,
                        0.0f);
  const float phi = kGauss ? expf(-0.5f * d) : 1.0f / (1.0f + d);
  *dphi = kGauss ? -0.5f * phi : -(phi * phi);
  return phi;
}

// ------------------------------------------------------------------ forward

// a[p][c0..c0+3] for p < 4·kKQ, converted to f32; 0 beyond k and c.
template <typename T, int kKQ>
__device__ __forceinline__ void load_quad(const T* __restrict__ ab, int k, int c, int c0,
                                          float4 (&a4)[4 * kKQ]) {
#pragma unroll
  for (int p = 0; p < 4 * kKQ; ++p) {
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (p < k) {
      const T* ap = ab + (size_t)p * c + c0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + j < c) v[j] = to_f32(ap[j]);
    }
    a4[p] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// kKQ: parts padded to 4·kKQ (the register tile of a): K <= 12 takes
// kKQ 3, 13 <= K <= 16 kKQ 4, 17 <= K <= 32 kKQ 8. One block per
// (gridDim.x-th share of image b's kTile-pixel tiles): it walks tiles
// blockIdx.x, + gridDim.x, ..., so a thread loads its a quad once.
template <typename T, bool kGauss, int kKQ, int kTile>
__global__ void __launch_bounds__(kThreads)
render_assemble_kernel(const float* __restrict__ mu, const float* __restrict__ lam,
                       const T* __restrict__ app, float* __restrict__ out,
                       int k, int c, int h, int w) {
  constexpr int kP = 4 * kKQ;
  __shared__ float par[5][kMaxParts];
  __shared__ float4 phi_s[kTile * kKQ];   // φ[t][0..kP), zeros beyond k

  const int b = blockIdx.y;
  const int hw = h * w;
  load_parts(mu, lam, b, k, par);

  // Thread (quad q, row r): channels 4q..4q+3 at pixels r, r + rows, ...
  const int nq = (c + 3) / 4;
  const int qx = min(nq, kThreads);
  const int rows = kThreads / qx;
  const int r0 = threadIdx.x / qx;
  const int q0 = threadIdx.x - r0 * qx;
  const bool one_quad = nq <= kThreads;    // then q0 is the thread's only quad
  const bool vec = (c & 3) == 0;           // rows of out are 16-byte aligned
  const T* ab = app + (size_t)b * k * c;
  float4 a4[kP];
  if (one_quad) load_quad<T, kKQ>(ab, k, c, 4 * q0, a4);
  __syncthreads();

  float* phi_f = reinterpret_cast<float*>(phi_s);
  for (int p0 = blockIdx.x * kTile; p0 < hw; p0 += gridDim.x * kTile) {
    const int npix = min(kTile, hw - p0);
    if constexpr (kKQ == 4) {
      // A thread per (pixel, quad of parts): the pixel's coordinates once a
      // quad, one float4 store. At 16 parts and few channels (the 128²×32
      // scale) φ is a large share of the work.
      for (int i = threadIdx.x; i < kTile * kKQ; i += kThreads) {
        const int t = i / kKQ;
        const int kq = i - t * kKQ;
        if (t < npix) {
          const float2 u = pixel_coord(p0 + t, h, w);
          float f[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int part = 4 * kq + j;
            float dphi;
            f[j] = part < k ? part_phi<kGauss>(par, part, u.x - par[0][part],
                                               u.y - par[1][part], &dphi)
                            : 0.0f;
          }
          phi_s[i] = make_float4(f[0], f[1], f[2], f[3]);
        }
      }
    } else {
      // Thread (pixel tid % kTile) computes parts tid / kTile, + kThreads / kTile, ...
      for (int i = threadIdx.x; i < kTile * kP; i += kThreads) {
        const int t = i % kTile;
        const int part = i / kTile;
        if (t < npix) {
          const float2 u = pixel_coord(p0 + t, h, w);
          float dphi;
          phi_f[t * kP + part] =
              part < k ? part_phi<kGauss>(par, part, u.x - par[0][part], u.y - par[1][part], &dphi)
                       : 0.0f;
        }
      }
    }
    __syncthreads();
    if (r0 < rows) {
      float* ob = out + ((size_t)b * hw + p0) * c;
      for (int q = q0; q < nq; q += qx) {
        const int c0 = 4 * q;
        if (!one_quad) load_quad<T, kKQ>(ab, k, c, c0, a4);
        for (int t = r0; t < npix; t += rows) {
          const float4* ph = phi_s + t * kKQ;
          float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
          for (int kq = 0; kq < kKQ; ++kq) {
            const float4 f = ph[kq];
            const float fs[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {   // parts in order, as the plain sum
              const float4 a = a4[4 * kq + j];
              acc.x = fmaf(fs[j], a.x, acc.x);
              acc.y = fmaf(fs[j], a.y, acc.y);
              acc.z = fmaf(fs[j], a.z, acc.z);
              acc.w = fmaf(fs[j], a.w, acc.w);
            }
          }
          float* o = ob + (size_t)t * c + c0;
          if (vec) {
            *reinterpret_cast<float4*>(o) = acc;
          } else {
            const float r[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (c0 + j < c) o[j] = r[j];
          }
        }
      }
    }
    __syncthreads();
  }
}

// blocks_x: blocks per image (each walks ceil(tiles / blocks_x) tiles).
template <typename T, bool kGauss, int kKQ, int kTile>
void launch_forward_cfg(const float* mu, const float* lam, const void* app, float* out, int b,
                        int k, int c, int h, int w, int blocks_x, cudaStream_t stream) {
  const int tiles = (h * w + kTile - 1) / kTile;
  const dim3 grid(min(blocks_x, tiles), b);
  render_assemble_kernel<T, kGauss, kKQ, kTile><<<grid, kThreads, 0, stream>>>(
      mu, lam, static_cast<const T*>(app), out, k, c, h, w);
}

// Any tile the kernel is built for; false where (kKQ, tile) has no instance.
template <typename T, bool kGauss, int kKQ>
bool launch_forward_tile(const float* mu, const float* lam, const void* app, float* out, int b,
                         int k, int c, int h, int w, int tile, int blocks_x,
                         cudaStream_t stream) {
  if (tile == 64)
    launch_forward_cfg<T, kGauss, kKQ, 64>(mu, lam, app, out, b, k, c, h, w, blocks_x, stream);
  else if (tile == 256)
    launch_forward_cfg<T, kGauss, kKQ, 256>(mu, lam, app, out, b, k, c, h, w, blocks_x, stream);
  else if (kKQ == 4 && tile == 128)
    launch_forward_cfg<T, kGauss, kKQ, 128>(mu, lam, app, out, b, k, c, h, w, blocks_x, stream);
  else
    return false;
  return true;
}

// The 16-part tile's launch, as (tile, blocks per image). Chosen on the
// H100 at deepfashion's K = 16 decode (B = 64: 16²×256, 32²×128, 64²×64,
// 128²×32) by a sweep of tiles 64/128/256 and blocks per image.
void forward_plan16(int b, int hw, int* tile, int* blocks_x) {
  *tile = hw <= 256 ? 64 : 256;
  *blocks_x = max(1, kTargetBlocks16 / b);
}

template <typename T, bool kGauss>
void launch_forward(const float* mu, const float* lam, const void* app, float* out, int b,
                    int k, int c, int h, int w, cudaStream_t stream) {
  // K <= 12 and 17 <= K <= 32: tiles of 256 pixels, and images of at most
  // 128 pixels in one 64-pixel tile; about kTargetBlocks blocks in all.
  // Chosen on the H100 at the serving and training decoders' shapes (K =
  // 10): fewer, longer-lived blocks that each load their a quad once beat
  // one block per tile.
  const int tile = h * w <= 128 ? 64 : 256;
  const int blocks_x = max(1, kTargetBlocks / b);
  if (k <= 12) {
    launch_forward_tile<T, kGauss, 3>(mu, lam, app, out, b, k, c, h, w, tile, blocks_x, stream);
  } else if (k <= 16) {
    int t16, b16;
    forward_plan16(b, h * w, &t16, &b16);
    launch_forward_tile<T, kGauss, 4>(mu, lam, app, out, b, k, c, h, w, t16, b16, stream);
  } else {
    launch_forward_tile<T, kGauss, 8>(mu, lam, app, out, b, k, c, h, w, tile, blocks_x, stream);
  }
}

// ----------------------------------------------------------------- backward

// d_μ = −2Λ·(s0, s1) and d_Λ = [[s2, 2·s3], [0, s4]] of part p of image b
// from its five sums s = Σ g_d·{dy, dx, dy², dy·dx, dx²}.
__device__ __forceinline__ void part_grads(const float* __restrict__ lam, const float* s,
                                           float* __restrict__ d_mu, float* __restrict__ d_lam,
                                           int b, int k, int p) {
  const float* l = lam + ((size_t)b * k + p) * 4;
  float* dm = d_mu + ((size_t)b * k + p) * 2;
  dm[0] = -2.0f * (l[0] * s[0] + l[1] * s[1]);
  dm[1] = -2.0f * (l[2] * s[0] + l[3] * s[1]);
  float* dl = d_lam + ((size_t)b * k + p) * 4;
  dl[0] = s[2];
  dl[1] = s[3] + s[3];
  dl[2] = 0.0f;
  dl[3] = s[4];
}

// One block per image: sums the partials of `tiles` blocks in block order,
// then d_app (in the appearance dtype), d_μ and d_Λ.
template <typename T>
__global__ void __launch_bounds__(kThreads)
render_assemble_bwd_finish(const float* __restrict__ lam, const float* __restrict__ part,
                           T* __restrict__ d_app, float* __restrict__ d_mu,
                           float* __restrict__ d_lam, int k, int c, int tiles) {
  __shared__ float sums[kMaxParts][5];
  const int b = blockIdx.x;
  const int row = c + 5;
  const size_t per_tile = (size_t)k * row;
  const float* pb = part + (size_t)b * tiles * per_tile;
  for (int i = threadIdx.x; i < k * row; i += kThreads) {
    float acc = 0.0f;
    for (int j = 0; j < tiles; ++j) acc += pb[j * per_tile + i];
    const int p = i / row;
    const int ch = i - p * row;
    if (ch < c) store_as(d_app + ((size_t)b * k + p) * c + ch, acc);
    else sums[p][ch - c] = acc;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < k; p += kThreads) part_grads(lam, sums[p], d_mu, d_lam, b, k, p);
}

// The register-tiled backward, for every K <= 32 and every C. A block
// takes the parts of one group (4·kKQ of them: K <= 12 is one group of 12,
// larger K groups of 16, blockIdx.z) and the channels in chunks of
// 4·kBwdMaxQuads = 128 (C above 128: kChunked, kL = 5). Per chunk, a pixel
// row is 2^kL lanes of one warp (the chunk's channel quads, 2^kL >= its
// quads); kThreads >> kL rows walk a tile's pixels together. Each lane
// accumulates d_app[group's parts][its quad] (da) over all its pixels in
// registers. Per pixel it reads g[pixel][its quad] as one float4
// (kPrefetch pixels ahead), adds φ[t][k]·g to da (φ rows from shared
// memory as broadcast float4s: one load per 16 FMAs), and forms its share
// of the chunk's g_φ[t][k] = Σ_quad g·a[k][quad] (a from shared memory
// too, so that two CTAs fit an SM's registers). A reduce-scatter butterfly
// over the row's lanes (16 values: halve, exchange the other half, add)
// leaves each lane the chunk's g_φ of 16 >> min(kL, 4) parts, in a fixed
// order, for 8 + 4 + 2 + 1 shuffles instead of 16 per step. That lane
// forms g_d = g_φ·dφ/dd (dφ/dd from φ: −½φ, or −φ² for the heavy tail) and
// adds g_d·{dy, dx, dy², dy·dx, dx²} for its parts. The five sums are
// linear in g_φ, so the shares of several chunks add up in the same
// registers, and those of chunks in other CTAs where the five sums meet:
// one read of g for K <= 16, one per group above. A tile's φ and pixel
// coordinates are computed once per chunk into shared memory first.
//
// The grid: x = shares × chunk_ctas CTAs per (image, group), y = image,
// z = group. CTA x walks tiles x % shares, + shares, ... and chunks
// x / shares, + chunk_ctas, ... After each chunk it sums its rows' da
// (shuffles within a warp, then the warps in order through shared memory),
// and its five sums in the same pass after the last. With `to_part`
// (chunk_ctas 1) it
// writes them to part[b][blockIdx.x] for the finish kernel. Otherwise the
// CTAs of an (image, group) are one cluster: the `shares` CTAs of a chunk
// sum its d_app over themselves in rank order through distributed shared
// memory, CTA s writing parts s, s + shares, ...; then every CTA sums the
// five sums of parts rank, rank + cluster size, ... over all ranks in
// rank order and writes their d_μ and d_Λ: one launch.
constexpr int kBwdMaxQuads = 32;    // channel quads of a chunk
constexpr int kBwdGroupKQ = 4;      // part quads of a group for K > 12
constexpr int kBwdMaxCluster = 8;
constexpr int kBwdTile = 256;       // the most pixels of a tile
constexpr int kBwdResident = 264;   // CTAs the H100 holds at once (two to an SM)

template <typename T, bool kGauss, int kKQ, int kL, bool kChunked>
__global__ void __launch_bounds__(kThreads, 2)
render_assemble_bwd_tiled(const float* __restrict__ mu, const float* __restrict__ lam,
                          const T* __restrict__ app, const float* __restrict__ g,
                          float* __restrict__ part, T* __restrict__ d_app,
                          float* __restrict__ d_mu, float* __restrict__ d_lam, int k, int c,
                          int h, int w, int tile, int to_part, int chunk_ctas) {
  constexpr int kP = 4 * kKQ;
  constexpr int kQX = 1 << kL;
  constexpr int kRows = kThreads >> kL;
  constexpr int kV = 16;                        // g_φ values per lane, padded
  constexpr int kSteps = kL < 4 ? kL : 4;       // halving steps of the butterfly
  constexpr int kHeld = kV >> kSteps;           // parts a lane holds after them
  constexpr int kChunk = 4 * kBwdMaxQuads;      // channels of a chunk
  constexpr int kPrefetch = kKQ == 3 ? 2 : 3;   // g loads in flight per lane (3 measured faster
                                                 // for a group of 16 parts, 2 for 12)
  static_assert(kP <= kV, "a group's g_φ fills at most the butterfly's 16 values");
  static_assert(kL == 5 || !kChunked, "more than one chunk has 32 quads to a row");
  __shared__ float par[5][kMaxParts];
  __shared__ float4 phi_s[kBwdTile * kKQ];      // φ[t][0..kP), zeros beyond the group and npix
  __shared__ float2 u_s[kBwdTile];              // pixel-centre coordinates (y, x)
  __shared__ float4 a_s[kP][kBwdMaxQuads];      // a[k][quad], zeros beyond the group and chunk
  __shared__ float4 res_app[kP][kBwdMaxQuads];  // the block's Σ φ·g per (part, quad)
  __shared__ float res_s5[kV][5];               // the block's five sums per part

  const int b = blockIdx.y;
  const int p_lo = kKQ == 3 ? 0 : blockIdx.z * kP;   // the group's first part (K <= 12: one)
  const int kg = kKQ == 3 ? k : min(kP, k - p_lo);  // the group's parts
  const int hw = h * w;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q = tid & (kQX - 1);
  const int r = tid >> kL;
  const int chunks = kChunked ? (c + kChunk - 1) / kChunk : 1;
  const int ctas = kChunked ? chunk_ctas : 1;        // CTAs of an image taking chunks side by side
  const int shares = gridDim.x / ctas;               // CTAs of an image taking tiles side by side
  const int share = kChunked ? blockIdx.x % shares : blockIdx.x;
  const int first = kChunked ? blockIdx.x / shares : 0;   // this CTA's first chunk
  const bool vec = (c & 3) == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  const float* mu_y = par[0] + p_lo;                 // the group's means
  const float* mu_x = par[1] + p_lo;
  load_parts(mu, lam, b, k, par);
  float s5[kHeld][5];
#pragma unroll
  for (int i = 0; i < kHeld; ++i)
#pragma unroll
    for (int j = 0; j < 5; ++j) s5[i][j] = 0.0f;
  int off = 0;   // the first part this lane holds after the butterfly
#pragma unroll
  for (int st = 0; st < kSteps; ++st) off += ((q >> st) & 1) * (kV >> (st + 1));
  const float* app_f = reinterpret_cast<const float*>(&res_app[0][0]);
  float* phi_f = reinterpret_cast<float*>(phi_s);

  // Every CTA of a cluster runs the same trips (a chunk past the last one
  // is empty), so the cluster barriers below pair up.
  const int trips = kChunked ? (chunks + ctas - 1) / ctas : 1;
  for (int trip = 0, chunk = first; trip < trips; ++trip, chunk += ctas) {
    const bool last = trip == trips - 1;
    const int c0 = chunk * kChunk;
    const int cc = !kChunked ? c : chunk < chunks ? min(kChunk, c - c0) : 0;   // its channels
    const int nq = (cc + 3) / 4;
    for (int i = tid; i < kP * kBwdMaxQuads; i += kThreads) {
      const int p = i / kBwdMaxQuads;
      const int c4 = 4 * (i - p * kBwdMaxQuads);
      float e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (p < kg) {
        const T* ap = app + ((size_t)b * k + p_lo + p) * c + c0 + c4;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c4 + j < cc) e[j] = to_f32(ap[j]);
      }
      a_s[p][c4 / 4] = make_float4(e[0], e[1], e[2], e[3]);
    }
    float4 da[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) da[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncthreads();

    for (int p0 = share * tile; (!kChunked || cc > 0) && p0 < hw; p0 += shares * tile) {
      const int npix = min(tile, hw - p0);
      for (int t = tid; t < tile; t += kThreads) {   // a pixel per thread, all its parts
        const float2 u = pixel_coord(p0 + min(t, npix - 1), h, w);
        u_s[t] = u;
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          float phi = 0.0f, dphi;
          if (t < npix && p < kg)
            phi = part_phi<kGauss>(par, p_lo + p, u.x - mu_y[p], u.y - mu_x[p], &dphi);
          phi_f[t * kP + p] = phi;
        }
      }
      __syncthreads();
      const float* gb = g + ((size_t)b * hw + p0) * c + c0 + 4 * q;
      // g[pixel t0 + r] of this lane's quad; 0 past the tile or the chunk.
      auto load_g = [&](int t0) {
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (t0 + r < npix && q < nq) {
          const float* gp = gb + (size_t)(t0 + r) * c;
          if (vec) {
            v = __ldg(reinterpret_cast<const float4*>(gp));
          } else {
            float e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (4 * q + j < cc) e[j] = __ldg(gp + j);
            v = make_float4(e[0], e[1], e[2], e[3]);
          }
        }
        return v;
      };
      float4 gq[kPrefetch];
#pragma unroll
      for (int i = 0; i < kPrefetch; ++i) gq[i] = load_g(i * kRows);
      // Every row runs the same trip count, so the shuffles see whole warps;
      // a row past the tile's end carries g = 0.
      for (int base = 0; base < npix; base += kPrefetch * kRows) {
#pragma unroll
        for (int i = 0; i < kPrefetch; ++i) {
          const int t0 = base + i * kRows;
          if (t0 >= npix) continue;   // the same for the whole block
          const float4 g4 = gq[i];
          gq[i] = load_g(t0 + kPrefetch * kRows);
          const int t = t0 + r < npix ? t0 + r : 0;
          float v[kV];
          const float4* ph = phi_s + t * kKQ;
#pragma unroll
          for (int kq = 0; kq < kKQ; ++kq) {
            const float4 f = ph[kq];
            const float fs[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int p = 4 * kq + j;
              const float4 a = a_s[p][q];
              v[p] = fmaf(g4.x, a.x, fmaf(g4.y, a.y, fmaf(g4.z, a.z, g4.w * a.w)));
              da[p].x = fmaf(fs[j], g4.x, da[p].x);
              da[p].y = fmaf(fs[j], g4.y, da[p].y);
              da[p].z = fmaf(fs[j], g4.z, da[p].z);
              da[p].w = fmaf(fs[j], g4.w, da[p].w);
            }
          }
#pragma unroll
          for (int p = kP; p < kV; ++p) v[p] = 0.0f;
          // Reduce-scatter over the row's lanes: at step st a lane keeps the
          // half of its values chosen by bit st of q and adds its partner's.
          if constexpr (kSteps > 0) halve<8>(v, q & 1, 1);
          if constexpr (kSteps > 1) halve<4>(v, (q >> 1) & 1, 2);
          if constexpr (kSteps > 2) halve<2>(v, (q >> 2) & 1, 4);
          if constexpr (kSteps > 3) halve<1>(v, (q >> 3) & 1, 8);
          if constexpr (kL == 5) v[0] += __shfl_xor_sync(0xffffffffu, v[0], 16);   // l, l ^ 16 agree
          const float2 u = u_s[t];
#pragma unroll
          for (int e = 0; e < kHeld; ++e) {
            const int p = off + e;
            if (p < kg) {
              const float phi = phi_f[t * kP + p];
              const float gd = v[e] * (kGauss ? -0.5f * phi : -(phi * phi));
              const float dy = u.x - mu_y[p];
              const float dx = u.y - mu_x[p];
              s5[e][0] = fmaf(gd, dy, s5[e][0]);
              s5[e][1] = fmaf(gd, dx, s5[e][1]);
              s5[e][2] = fmaf(gd * dy, dy, s5[e][2]);
              s5[e][3] = fmaf(gd * dy, dx, s5[e][3]);
              s5[e][4] = fmaf(gd * dx, dx, s5[e][4]);
            }
          }
        }
      }
      __syncthreads();
    }

    // The block's rows: a butterfly over the rows within a warp, then the
    // warps in order through shared memory; da after every chunk, and the
    // five sums with the last.
#pragma unroll
    for (int m = kQX; m < 32; m <<= 1) {
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        da[p].x += __shfl_xor_sync(0xffffffffu, da[p].x, m);
        da[p].y += __shfl_xor_sync(0xffffffffu, da[p].y, m);
        da[p].z += __shfl_xor_sync(0xffffffffu, da[p].z, m);
        da[p].w += __shfl_xor_sync(0xffffffffu, da[p].w, m);
      }
      if (last) {
#pragma unroll
        for (int e = 0; e < kHeld; ++e)
#pragma unroll
          for (int j = 0; j < 5; ++j) s5[e][j] += __shfl_xor_sync(0xffffffffu, s5[e][j], m);
      }
    }
    for (int wi = 0; wi < kWarps; ++wi) {
      if (warp == wi && lane < kQX) {
#pragma unroll
        for (int p = 0; p < kP; ++p) {
          float4& dst = res_app[p][q];
          dst = wi == 0 ? da[p] : make_float4(dst.x + da[p].x, dst.y + da[p].y,
                                              dst.z + da[p].z, dst.w + da[p].w);
        }
        if (last && lane < 16) {   // with 32 lanes to a row, lanes l and l ^ 16 agree
#pragma unroll
          for (int e = 0; e < kHeld; ++e)
#pragma unroll
            for (int j = 0; j < 5; ++j)
              res_s5[off + e][j] = wi == 0 ? s5[e][j] : res_s5[off + e][j] + s5[e][j];
        }
      }
      __syncthreads();
    }
    if (to_part) {
      float* pb = part + ((size_t)b * gridDim.x + blockIdx.x) * k * (c + 5);
      for (int i = tid; i < kg * cc; i += kThreads) {
        const int p = i / cc;
        const int ch = i - p * cc;
        pb[(p_lo + p) * (c + 5) + c0 + ch] = app_f[(p * kBwdMaxQuads) * 4 + ch];
      }
      for (int i = tid; last && i < kg * 5; i += kThreads) {
        const int p = i / 5;
        pb[(p_lo + p) * (c + 5) + c + (i - p * 5)] = res_s5[p][i - p * 5];
      }
      continue;
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int mine = (kg - share + shares - 1) / shares;   // parts share, share + shares, ...
    const int rank0 = first * shares;                      // the chunk's first rank
    for (int i = tid; i < mine * cc; i += kThreads) {
      const int p = share + shares * (i / cc);
      const int ch = i % cc;
      float acc = 0.0f;
      for (int sh = 0; sh < shares; ++sh)
        acc += cluster.map_shared_rank(app_f, rank0 + sh)[(p * kBwdMaxQuads) * 4 + ch];
      store_as(d_app + ((size_t)b * k + p_lo + p) * c + c0 + ch, acc);
    }
    if (last) {   // the five sums of parts rank, rank + cluster size, ... over every rank
      const int cs = (int)cluster.num_blocks();
      const int rank = (int)cluster.block_rank();
      for (int p = rank + cs * tid; p < kg; p += cs * kThreads) {
        float sm[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        for (int rk = 0; rk < cs; ++rk) {
          const float* rs = cluster.map_shared_rank(&res_s5[p][0], rk);
#pragma unroll
          for (int j = 0; j < 5; ++j) sm[j] += rs[j];
        }
        part_grads(lam, sm, d_mu, d_lam, b, k, p_lo + p);
      }
    }
    cluster.sync();   // no CTA rewrites res_app or leaves while another reads it
  }
}

template <typename T, bool kGauss, int kKQ, int kL, bool kChunked>
cudaError_t launch_tiled(const float* mu, const float* lam, const void* app, const float* g,
                         float* part, void* d_app, float* d_mu, float* d_lam, int b, int k,
                         int c, int h, int w, int tile, cudaStream_t stream) {
  const int tiles = (h * w + tile - 1) / tile;
  const int groups = (k + 4 * kKQ - 1) / (4 * kKQ);
  auto kernel = render_assemble_bwd_tiled<T, kGauss, kKQ, kL, kChunked>;
  const T* a = static_cast<const T*>(app);
  T* da = static_cast<T*>(d_app);
  if (tiles > kBwdMaxCluster) {   // partials, then the fixed-order finish
    const int shares = min(tiles, max(1, kTargetBlocks / b));
    kernel<<<dim3(shares, b, groups), kThreads, 0, stream>>>(mu, lam, a, g, part, da, d_mu,
                                                             d_lam, k, c, h, w, tile, 1, 1);
    render_assemble_bwd_finish<T><<<b, kThreads, 0, stream>>>(lam, part, da, d_mu, d_lam, k, c,
                                                              shares);
    return cudaGetLastError();
  }
  // A cluster of CTAs per (image, group), as many as the card holds at
  // once: tiles side by side, then chunks side by side in what is left.
  const int fit = max(1, kBwdResident / (b * groups));
  const int shares = min(tiles, fit);
  const int chunks = (c + 4 * kBwdMaxQuads - 1) / (4 * kBwdMaxQuads);
  const int ctas = kChunked ? max(1, min(chunks, min(kBwdMaxCluster, fit) / shares)) : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(shares * ctas, b, groups);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = shares * ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, mu, lam, a, g, part, da, d_mu, d_lam,
                                             k, c, h, w, tile, 0, ctas);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The rule, mirrored by partops/kernels/render_assemble.py (backward_tile,
// backward_partial_rows, backward_groups, backward_chunks): K <= 12 takes
// one group of 12 parts, larger K groups of 16; rows of 2^kL lanes, 2^kL
// the least power of two >= the quads of a chunk (at most 32: 128
// channels, and above that chunks of them).
template <typename T, bool kGauss, int kKQ>
cudaError_t launch_group(const float* mu, const float* lam, const void* app, const float* g,
                         float* part, void* d_app, float* d_mu, float* d_lam, int b, int k,
                         int c, int h, int w, int tile, cudaStream_t stream) {
  const int nq = (c + 3) / 4;
#define PARTSEG_TILED(L, CHUNKED)                                                           \
  launch_tiled<T, kGauss, kKQ, L, CHUNKED>(mu, lam, app, g, part, d_app, d_mu, d_lam, b, k, \
                                           c, h, w, tile, stream)
  if (nq <= 1) return PARTSEG_TILED(0, false);
  if (nq <= 2) return PARTSEG_TILED(1, false);
  if (nq <= 4) return PARTSEG_TILED(2, false);
  if (nq <= 8) return PARTSEG_TILED(3, false);
  if (nq <= 16) return PARTSEG_TILED(4, false);
  if (nq <= kBwdMaxQuads) return PARTSEG_TILED(5, false);
  return PARTSEG_TILED(5, true);
#undef PARTSEG_TILED
}

template <typename T, bool kGauss>
cudaError_t launch_backward(const float* mu, const float* lam, const void* app, const float* g,
                            float* part, void* d_app, float* d_mu, float* d_lam, int b, int k,
                            int c, int h, int w, int tile, cudaStream_t stream) {
  if (k <= 12)
    return launch_group<T, kGauss, 3>(mu, lam, app, g, part, d_app, d_mu, d_lam, b, k, c, h, w,
                                      tile, stream);
  return launch_group<T, kGauss, kBwdGroupKQ>(mu, lam, app, g, part, d_app, d_mu, d_lam, b, k, c,
                                              h, w, tile, stream);
}

}  // namespace

// mu: [B, K, 2] f32; lam: [B, K, 2, 2] f32; app: [B, K, C] f32 or bf16
// (app_is_bf16); out: [B, H, W, C] f32, 16-byte aligned. gauss: 1 =
// "gauss", 0 = "heavy_tail". The caller keeps K <= 32 and B <= 65535.
// Launches on `stream`, allocates nothing, does not synchronise. Returns
// cudaGetLastError().
extern "C" int partseg_render_assemble(const float* mu, const float* lam, const void* app,
                                       int app_is_bf16, float* out, int b, int k, int c,
                                       int h, int w, int gauss, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (app_is_bf16) {
    if (gauss) launch_forward<__nv_bfloat16, true>(mu, lam, app, out, b, k, c, h, w, s);
    else launch_forward<__nv_bfloat16, false>(mu, lam, app, out, b, k, c, h, w, s);
  } else {
    if (gauss) launch_forward<float, true>(mu, lam, app, out, b, k, c, h, w, s);
    else launch_forward<float, false>(mu, lam, app, out, b, k, c, h, w, s);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
bool forward_tile_any(const float* mu, const float* lam, const void* app, float* out, int b,
                      int k, int c, int h, int w, int gauss, int tile, int blocks_x,
                      cudaStream_t s) {
  const int kq = k <= 12 ? 3 : k <= 16 ? 4 : 8;
#define PARTSEG_FWD(KQ)                                                                     \
  (gauss ? launch_forward_tile<T, true, KQ>(mu, lam, app, out, b, k, c, h, w, tile, blocks_x, s) \
         : launch_forward_tile<T, false, KQ>(mu, lam, app, out, b, k, c, h, w, tile, blocks_x, s))
  return kq == 3 ? PARTSEG_FWD(3) : kq == 4 ? PARTSEG_FWD(4) : PARTSEG_FWD(8);
#undef PARTSEG_FWD
}

// The forward at a given tile (64 or 256; 128 too for 13 <= K <= 16) and
// blocks per image, for the tile sweep that chose forward_plan16; the same
// arguments as partseg_render_assemble otherwise. cudaErrorInvalidValue
// where the tile has no instance.
extern "C" int partseg_render_assemble_tiled(const float* mu, const float* lam, const void* app,
                                             int app_is_bf16, float* out, int b, int k, int c,
                                             int h, int w, int gauss, int tile, int blocks_x,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = app_is_bf16 ? forward_tile_any<__nv_bfloat16>(mu, lam, app, out, b, k, c, h, w,
                                                                gauss, tile, blocks_x, s)
                              : forward_tile_any<float>(mu, lam, app, out, b, k, c, h, w, gauss,
                                                        tile, blocks_x, s);
  return static_cast<int>(ok ? cudaGetLastError() : cudaErrorInvalidValue);
}

// The backward. g: [B, H, W, C] f32; part: [B, rows, K, C + 5] f32 scratch
// (rows: none where one cluster takes an image, ceil(H·W / tile) tiles at
// most 8; else min(tiles, 1024 / B), see backward_partial_rows); d_app:
// [B, K, C] in the appearance dtype; d_mu: [B, K, 2] f32; d_lam:
// [B, K, 2, 2] f32. The caller keeps K <= 32 and B <= 65535. One launch,
// or two with partials, on `stream`; allocates nothing, does not
// synchronise. Returns the first CUDA error.
extern "C" int partseg_render_assemble_bwd(const float* mu, const float* lam, const void* app,
                                           const float* g, int app_is_bf16, float* part,
                                           void* d_app, float* d_mu, float* d_lam, int b, int k,
                                           int c, int h, int w, int gauss, int tile,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (app_is_bf16) {
    err = gauss ? launch_backward<__nv_bfloat16, true>(mu, lam, app, g, part, d_app, d_mu, d_lam,
                                                       b, k, c, h, w, tile, s)
                : launch_backward<__nv_bfloat16, false>(mu, lam, app, g, part, d_app, d_mu,
                                                        d_lam, b, k, c, h, w, tile, s);
  } else {
    err = gauss ? launch_backward<float, true>(mu, lam, app, g, part, d_app, d_mu, d_lam, b, k,
                                               c, h, w, tile, s)
                : launch_backward<float, false>(mu, lam, app, g, part, d_app, d_mu, d_lam, b,
                                                k, c, h, w, tile, s);
  }
  return static_cast<int>(err);
}
