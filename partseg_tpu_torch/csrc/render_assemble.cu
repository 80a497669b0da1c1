// Fused Gaussian part render + decoder-input assembly (CUDA C++, sm_90a).
//
// Replaces the Pallas TPU kernel partseg_tpu/partops/pallas/render_assemble.py
// (`render_assemble` -> `_forward` -> `_kernel`). For every output pixel u and
// channel c:
//   out[b, u, c] = Σ_k φ_k(u) · a[b, k, c],
//   d = max(Λ00·dy² + 2Λ01·dy·dx + Λ11·dx², 0),  (dy, dx) = u − μ_k,
//   φ = exp(−½ d) ("gauss") or 1 / (1 + d) ("heavy_tail").
// The [B, H, W, K] blob tensor of the unfused path is never written.
//
// What bounds it on the H100: device memory. The f32 output is the only
// large array (B·H·W·C·4 bytes); the inputs are a few KB per image and the
// work is ~2 flops per output element per part (K = 10: ~5 flop/byte, below
// the f32 ridge). The design stages μ, Λ and a[b] (converted to f32 on load)
// in shared memory, computes the tile's φ[T, K] once into shared memory, and
// then lets each thread sum over k for one (pixel, channel) with the channel
// fastest, so the output stores of a warp are 128 contiguous bytes. The TPU
// kernel's 128-lane padding of K and C (and its Λ = I padding parts) existed
// only for the TPU's tiles and is dropped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;       // output pixels per block
constexpr int kMaxParts = 32;   // the wrapper raises above this

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, bool kGauss>
__global__ void __launch_bounds__(kThreads)
render_assemble_kernel(const float* __restrict__ mu, const float* __restrict__ lam,
                       const T* __restrict__ app, float* __restrict__ out,
                       int k, int c, int h, int w) {
  extern __shared__ float smem[];
  float* a_s = smem;              // [k, c]
  float* phi_s = a_s + k * c;     // [kTile, k]
  __shared__ float par[5][kMaxParts];

  const int b = blockIdx.y;
  const int hw = h * w;
  const int p0 = blockIdx.x * kTile;
  const int npix = min(kTile, hw - p0);

  for (int i = threadIdx.x; i < k; i += kThreads) {
    const float* m = mu + ((size_t)b * k + i) * 2;
    const float* l = lam + ((size_t)b * k + i) * 4;
    par[0][i] = m[0];
    par[1][i] = m[1];
    par[2][i] = l[0];
    par[3][i] = l[1];
    par[4][i] = l[3];
  }
  const T* ab = app + (size_t)b * k * c;
  for (int i = threadIdx.x; i < k * c; i += kThreads) a_s[i] = to_f32(ab[i]);
  __syncthreads();

  for (int i = threadIdx.x; i < npix * k; i += kThreads) {
    const int t = i / k;
    const int part = i - t * k;
    const int n = p0 + t;
    const int yi = n / w;
    const int xi = n - yi * w;
    // The same float32 expression as partops/coords.py's numpy grid.
    const float yc = -1.0f + (2.0f * ((float)yi + 0.5f)) / (float)h;
    const float xc = -1.0f + (2.0f * ((float)xi + 0.5f)) / (float)w;
    const float dy = yc - par[0][part];
    const float dx = xc - par[1][part];
    // Clamp: a numerically indefinite Λ must not turn exp(−½d) into exp(+).
    const float d = fmaxf(par[2][part] * dy * dy + 2.0f * par[3][part] * dy * dx +
                              par[4][part] * dx * dx,
                          0.0f);
    phi_s[t * k + part] = kGauss ? expf(-0.5f * d) : 1.0f / (1.0f + d);
  }
  __syncthreads();

  float* ob = out + ((size_t)b * hw + p0) * c;
  for (int i = threadIdx.x; i < npix * c; i += kThreads) {
    const int t = i / c;
    const int ch = i - t * c;
    const float* ph = phi_s + t * k;
    float acc = 0.0f;
    for (int part = 0; part < k; ++part) acc += ph[part] * a_s[part * c + ch];
    ob[i] = acc;
  }
}

template <typename T, bool kGauss>
void launch(const float* mu, const float* lam, const void* app, float* out, int b, int k,
            int c, int h, int w, cudaStream_t stream) {
  const dim3 grid((h * w + kTile - 1) / kTile, b);
  const size_t smem = (size_t)(k * c + kTile * k) * sizeof(float);
  render_assemble_kernel<T, kGauss><<<grid, kThreads, smem, stream>>>(
      mu, lam, static_cast<const T*>(app), out, k, c, h, w);
}

}  // namespace

// mu: [B, K, 2] f32; lam: [B, K, 2, 2] f32; app: [B, K, C] f32 or bf16
// (app_is_bf16); out: [B, H, W, C] f32. gauss: 1 = "gauss", 0 = "heavy_tail".
// The caller keeps K <= 32, B <= 65535 and (K·C + 64·K)·4 bytes <= 48 KB.
// Launches on `stream`, allocates nothing, does not synchronise. Returns
// cudaGetLastError().
extern "C" int partseg_render_assemble(const float* mu, const float* lam, const void* app,
                                       int app_is_bf16, float* out, int b, int k, int c,
                                       int h, int w, int gauss, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (app_is_bf16) {
    if (gauss) launch<__nv_bfloat16, true>(mu, lam, app, out, b, k, c, h, w, s);
    else launch<__nv_bfloat16, false>(mu, lam, app, out, b, k, c, h, w, s);
  } else {
    if (gauss) launch<float, true>(mu, lam, app, out, b, k, c, h, w, s);
    else launch<float, false>(mu, lam, app, out, b, k, c, h, w, s);
  }
  return static_cast<int>(cudaGetLastError());
}
