// A convolution's epilogue: its bias, with the ReLU or the residual sum that
// follows it, forward and backward (CUDA C++, sm_90a).
//
// Replaces no TPU kernel: the JAX package's convolutions (Flax nn.Conv,
// models/blocks.py) add their bias inside XLA's fusion with whatever follows.
// On the H100 `F.conv2d(x, w, b)` runs cuDNN's product and then aten's
// broadcast add of the bias over the channels_last output, which the
// vectorised elementwise path cannot take (about 40 % of the card's
// bandwidth); the ReLU before the next convolution and the residual sum
// were passes of their own, and in training the bias gradient was a bf16
// reduction over N·H·W of its own. Here the convolution runs without its
// bias and this kernel writes, in one pass over its output z [B, H, W, C]
// (channels_last storage of the logical NCHW):
//   bias:      out = round(z + round(b))
//   relu:      out = relu(round(z + round(b)))
//   residual:  out = round(x + round(z + round(b)))
//   skip:      out = round(round(zs + round(bs)) + round(z + round(b)))
// round() is to the tensors' dtype (bf16 round-to-nearest-even, or none in
// f32); b and bs are the f32 parameters, rounded here as `.to(bf16)` would.
// These are the rounding steps of aten's chain (the product rounded to the
// output dtype, the bias added in f32 and rounded once, the residual added
// in f32 and rounded once), so the output equals that chain's bit for bit.
// The backward reads the cotangent g (and, for relu, the saved output r),
// writes g_z = g where r > 0, else 0 (relu; the other variants pass g on
// unchanged and write nothing), and sums the bias gradient per channel in
// f32 in the same pass.
//
// What bounds it on the H100: device memory. The forward reads z (and x or
// zs) once and writes out once; the backward reads g (and r) and writes g_z
// for relu. A handful of flops an element are far below the card's ridge.
//
// Design. The tensor is read as one flat run of 16-byte vectors (V elements:
// 8 bf16 or 4 f32), neighbouring threads on neighbouring vectors, each thread
// striding by the whole grid's threads and keeping kBatch vectors of each
// input in flight. The grid's thread count G is a multiple of the vectors in
// a channel period (lcm(C, V) / V), so thread t's lanes sit on the same
// channels (t·V + j) mod C on every vector it reads: its bias values, and in
// the backward its per-lane f32 partial sums, live in registers. In the
// backward each CTA writes its lanes' partials to shared memory as a
// [T·V / C, C] array, sums each channel's column in row order and writes one
// [C] row of a [CTAs, C] workspace; the last CTA to finish (an atomic count)
// sums the rows in a fixed order into the bias gradient, so the backward is
// one launch and repeats give the same bits. A tensor whose size or pointers are
// not 16-byte multiples runs the same code one element at a time (V = 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxThreads = 512;   // the wrapper's plan stays at or below
constexpr int kBatch = 4;          // vectors of each input in flight a thread

// The variants (the wrapper's BIAS, RELU, RESIDUAL, SKIP).
constexpr int kBias = 0;
constexpr int kRelu = 1;
constexpr int kResidual = 2;
constexpr int kSkip = 3;

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

// aten's ReLU (clamp_min at 0: NaN passes, as does −0) and its backward
// mask (threshold_backward: 0 where the output is <= 0).
__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }
__device__ __forceinline__ float relu_grad(float g, float r) { return r <= 0.0f ? 0.0f : g; }

// The first vector a thread reads, the grid's stride, and the channel of
// lane 0 (the same on every vector the thread reads).
struct Walk {
  long long first, stride;
  int ch0;
};

template <int V>
__device__ __forceinline__ Walk walk(int c) {
  Walk w;
  w.stride = (long long)gridDim.x * blockDim.x;
  w.first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  w.ch0 = (int)((w.first * V) % c);
  return w;
}

template <typename T, int V, int kAct>
__global__ void __launch_bounds__(kMaxThreads)
bias_act_elementwise_fwd_kernel(const T* __restrict__ z, const float* __restrict__ bias,
                                const T* __restrict__ other, const float* __restrict__ other_bias,
                                T* __restrict__ out, long long nvec, int c) {
  using VT = Vec<T, V>;
  using Raw = typename VT::Raw;
  constexpr bool kOther = kAct == kResidual || kAct == kSkip;
  const Walk w = walk<V>(c);
  float b[V], bo[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int ch = (w.ch0 + j) % c;
    b[j] = Elem<T>::round(bias[ch]);
    bo[j] = kAct == kSkip ? Elem<T>::round(other_bias[ch]) : 0.0f;
  }
  const Raw* zr = reinterpret_cast<const Raw*>(z);
  const Raw* orr = reinterpret_cast<const Raw*>(other);
  Raw* outr = reinterpret_cast<Raw*>(out);
  for (long long i0 = w.first; i0 < nvec; i0 += kBatch * w.stride) {
    Raw vz[kBatch], vo[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long i = i0 + u * w.stride;
      if (i < nvec) {
        vz[u] = __ldcs(zr + i);
        if constexpr (kOther) vo[u] = __ldcs(orr + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long i = i0 + u * w.stride;
      if (i < nvec) {
        float f[V], o[V];
        VT::unpack(vz[u], f);
        if constexpr (kOther) VT::unpack(vo[u], o);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float y = Elem<T>::round(f[j] + b[j]);
          if constexpr (kAct == kRelu) y = relu(y);
          if constexpr (kAct == kSkip) o[j] = Elem<T>::round(o[j] + bo[j]);
          if constexpr (kOther) y = o[j] + y;   // rounded by pack
          f[j] = y;
        }
        outr[i] = VT::pack(f);
      }
    }
  }
}

// g_z (relu only) and, where part is given, the bias gradient: each CTA's
// per-channel sums of g_z into its row of part [CTAs, C], then the last CTA
// to finish (counted in *done, which it resets to 0) sums the rows in order
// into d_b [C]. Dynamic shared memory: T·V floats.
template <typename T, int V, bool kRelu_>
__global__ void __launch_bounds__(kMaxThreads)
bias_act_elementwise_bwd_kernel(const T* __restrict__ g, const T* __restrict__ r,
                                T* __restrict__ gz, float* __restrict__ part,
                                float* __restrict__ d_b, unsigned int* __restrict__ done,
                                long long nvec, int c) {
  using VT = Vec<T, V>;
  using Raw = typename VT::Raw;
  extern __shared__ float rows[];
  __shared__ bool last;
  const Walk w = walk<V>(c);
  const Raw* gr = reinterpret_cast<const Raw*>(g);
  const Raw* rr = reinterpret_cast<const Raw*>(r);
  Raw* gzr = reinterpret_cast<Raw*>(gz);
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.0f;
  for (long long i0 = w.first; i0 < nvec; i0 += kBatch * w.stride) {
    Raw vg[kBatch], vr[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long i = i0 + u * w.stride;
      if (i < nvec) {
        vg[u] = __ldcs(gr + i);
        if constexpr (kRelu_) vr[u] = __ldcs(rr + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long i = i0 + u * w.stride;
      if (i < nvec) {
        float f[V];
        VT::unpack(vg[u], f);
        if constexpr (kRelu_) {
          float o[V];
          VT::unpack(vr[u], o);
#pragma unroll
          for (int j = 0; j < V; ++j) f[j] = relu_grad(f[j], o[j]);
          gzr[i] = VT::pack(f);
        }
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] += f[j];
      }
    }
  }
  if (part == nullptr) return;
  const int t = threadIdx.x, nt = blockDim.x;
#pragma unroll
  for (int j = 0; j < V; ++j) rows[t * V + j] = acc[j];
  __syncthreads();
  const int nrows = nt * V / c;   // lane t·V + j holds channel (t·V + j) mod C
  for (int ch = t; ch < c; ch += nt) {
    float s = 0.0f;
    for (int row = 0; row < nrows; ++row) s += rows[row * c + ch];
    part[(size_t)blockIdx.x * c + ch] = s;
  }
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The CTAs' rows in a fixed order: `slices` threads a channel each sum
  // every slices-th row from their own (four partial sums, four loads in
  // flight), then one sums the slices in order.
  const int slices = c <= nt ? nt / c : 1;
  const int ctas = (int)gridDim.x;
  for (int ch0 = 0; ch0 < c; ch0 += nt) {
    const int ch = ch0 + t % c, sl = t / c;
    float s = 0.0f;
    if (ch < c && sl < slices) {
      const float* col = part + ch;
      float s4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      int k = sl;
      for (; k + 3 * slices < ctas; k += 4 * slices) {
#pragma unroll
        for (int u = 0; u < 4; ++u) s4[u] += __ldcg(col + (size_t)(k + u * slices) * c);
      }
      for (; k < ctas; k += slices) s4[0] += __ldcg(col + (size_t)k * c);
      s = (s4[0] + s4[1]) + (s4[2] + s4[3]);
    }
    __syncthreads();
    rows[t] = s;
    __syncthreads();
    if (t < c && ch0 + t < c) {
      float tot = 0.0f;
      for (int k = 0; k < slices; ++k) tot += rows[k * c + t];
      d_b[ch0 + t] = tot;
    }
  }
  if (t == 0) *done = 0u;
}

// What every launch needs of its plan; the wrapper's plan satisfies it.
bool valid(long long n, int c, int vec, int threads, int ctas) {
  return n > 0 && c > 0 && n % c == 0 && n % vec == 0 && threads > 0 &&
         threads <= kMaxThreads && ((long long)threads * vec) % c == 0 && ctas > 0;
}

template <typename T, int V, int kAct>
cudaError_t forward(const void* z, const float* bias, const void* other, const float* other_bias,
                    void* out, long long n, int c, int threads, int ctas, cudaStream_t stream) {
  bias_act_elementwise_fwd_kernel<T, V, kAct><<<ctas, threads, 0, stream>>>(
      static_cast<const T*>(z), bias, static_cast<const T*>(other), other_bias,
      static_cast<T*>(out), n / V, c);
  return cudaSuccess;
}

template <typename T, int V>
cudaError_t forward_act(int act, const void* z, const float* bias, const void* other,
                        const float* other_bias, void* out, long long n, int c, int threads,
                        int ctas, cudaStream_t s) {
  switch (act) {
    case kBias: return forward<T, V, kBias>(z, bias, other, other_bias, out, n, c, threads, ctas, s);
    case kRelu: return forward<T, V, kRelu>(z, bias, other, other_bias, out, n, c, threads, ctas, s);
    case kResidual:
      return forward<T, V, kResidual>(z, bias, other, other_bias, out, n, c, threads, ctas, s);
    case kSkip: return forward<T, V, kSkip>(z, bias, other, other_bias, out, n, c, threads, ctas, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int V>
cudaError_t backward(int relu, const void* g, const void* r, void* gz, float* part, float* d_b,
                     unsigned int* done, long long n, int c, int threads, int ctas,
                     cudaStream_t stream) {
  const size_t smem = (size_t)threads * V * sizeof(float);
  if (relu)
    bias_act_elementwise_bwd_kernel<T, V, true><<<ctas, threads, smem, stream>>>(
        static_cast<const T*>(g), static_cast<const T*>(r), static_cast<T*>(gz), part, d_b, done,
        n / V, c);
  else
    bias_act_elementwise_bwd_kernel<T, V, false><<<ctas, threads, smem, stream>>>(
        static_cast<const T*>(g), nullptr, nullptr, part, d_b, done, n / V, c);
  return cudaSuccess;
}

}  // namespace

// z, other, out: [B, H, W, C] (channels_last storage) in bf16 (bf16 = 1) or
// f32, n = B·H·W·C elements; bias, other_bias: [C] f32. act: 0 bias, 1 relu,
// 2 residual (other = x), 3 skip (other = zs, other_bias = bs); other and
// other_bias are read only where the variant takes them. vec: 16 / element
// size, or 1 (the wrapper picks it from n and the pointers' alignment);
// threads, ctas: the wrapper's launch plan
// (partops/kernels/bias_act.py:launch_plan). Launches on `stream`, allocates
// nothing, does not synchronise. Returns the first CUDA error
// (cudaErrorInvalidValue for a plan or variant the kernel cannot take).
extern "C" int partseg_bias_act_fwd(const void* z, const float* bias, const void* other,
                                    const float* other_bias, void* out, int bf16, int vec,
                                    int act, long long n, int c, int threads, int ctas,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (!valid(n, c, vec, threads, ctas) || act < kBias || act > kSkip ||
      ((act == kResidual || act == kSkip) && other == nullptr) ||
      (act == kSkip && other_bias == nullptr))
    return static_cast<int>(err);
  if (bf16 && vec == 8)
    err = forward_act<uint16_t, 8>(act, z, bias, other, other_bias, out, n, c, threads, ctas, s);
  else if (bf16 && vec == 1)
    err = forward_act<uint16_t, 1>(act, z, bias, other, other_bias, out, n, c, threads, ctas, s);
  else if (!bf16 && vec == 4)
    err = forward_act<float, 4>(act, z, bias, other, other_bias, out, n, c, threads, ctas, s);
  else if (!bf16 && vec == 1)
    err = forward_act<float, 1>(act, z, bias, other, other_bias, out, n, c, threads, ctas, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

// g, r, gz: [B, H, W, C] (channels_last storage) in bf16 (bf16 = 1) or f32;
// relu: r is the forward's output and gz is written (g where r > 0, else
// 0); otherwise r and gz are not read and part must be given. part: null,
// or a [ctas, C] f32 workspace for the CTAs' per-channel sums of g_z, with
// d_b [C] f32 out (the bias gradient) and done, an unsigned counter that is
// 0 before the launch and 0 again after it (one per stream: launches that
// share it must not overlap). The plan as for the forward. Returns the
// first CUDA error.
extern "C" int partseg_bias_act_bwd(const void* g, const void* r, void* gz, float* part,
                                    float* d_b, unsigned int* done, int bf16, int vec, int relu,
                                    long long n, int c, int threads, int ctas, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (!valid(n, c, vec, threads, ctas) || (relu && (r == nullptr || gz == nullptr)) ||
      (part == nullptr && !relu) || (part != nullptr && (d_b == nullptr || done == nullptr)))
    return static_cast<int>(err);
  if (bf16 && vec == 8)
    err = backward<uint16_t, 8>(relu, g, r, gz, part, d_b, done, n, c, threads, ctas, s);
  else if (bf16 && vec == 1)
    err = backward<uint16_t, 1>(relu, g, r, gz, part, d_b, done, n, c, threads, ctas, s);
  else if (!bf16 && vec == 4)
    err = backward<float, 4>(relu, g, r, gz, part, d_b, done, n, c, threads, ctas, s);
  else if (!bf16 && vec == 1)
    err = backward<float, 1>(relu, g, r, gz, part, d_b, done, n, c, threads, ctas, s);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}
