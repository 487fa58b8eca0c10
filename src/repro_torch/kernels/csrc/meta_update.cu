// Reptile server interpolation out = w + alpha * (w_hat - w) on Hopper.
//
// Replaces the TPU kernel repro/kernels/meta_update.py::meta_update_2d
// (_meta_update_kernel). The JAX engine makes one pallas_call per
// parameter leaf over (rows, 1024) tiles; here the engine keeps phi in
// one flat buffer, so one launch updates every leaf.
//
// Bound on an H100: the pass reads w and w_hat and writes out once, 12
// bytes per element in fp32 and 6 in bf16, over 3.35 TB/s (60.1 us and
// 30.0 us at 2^24 elements); three flops per element are nothing beside
// that. There is no reuse, so no TMA or wgmma: what matters is bytes in
// flight. Where all three pointers are 16-byte aligned each thread loads
// kUnroll = 4 independent 16-byte vectors of w and of w_hat (float4, or
// eight bf16) before it uses any, with streaming cache hints (__ldcs,
// __stcs: nothing is read twice); the grid is sized to the work, one
// block per kThreads x kUnroll vectors, so no device attribute is read at
// launch. The few elements past the last whole vector go to the first
// threads of the grid. Unaligned buffers take the scalar kernel, four
// elements a thread. At the sine MLP's 1,153 elements launch latency,
// not memory, sets the pace.
//
// alpha is read from a one-float device pointer, as the TPU kernel reads
// it from SMEM: an annealed per-round alpha then needs no host->device
// copy, and a captured launch stays valid when alpha changes.
//
// The math is fp32 whatever the storage: the difference is rounded to
// fp32 (__fsub_rn), then the product and the sum are rounded once
// together, one fused multiply-add (__fmaf_rn(a, wh - w, w)). That is
// what the JAX engine's jitted interpolation compiles to (XLA contracts
// p + a * (q - p) into an FMA), and what the plain PyTorch version
// (kernels/ref.py::meta_update) computes exactly in fp64, so the two
// agree bit for bit; the intrinsics leave nvcc nothing to reassociate.
// bf16 output rounds that fp32 result to nearest even, as torch's cast
// does.
//
// A bf16 w may come with an fp32 w_hat (dtype code 2: the engine's fp32
// client mean of a bf16 dtype group), read unrounded, as the JAX
// package's plain interpolation reads it; the pass then moves 8 bytes an
// element (2 + 4 + 2), and each thread's vector is 8 bf16 of w and out
// and two float4 of w_hat.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;           // vectors (or elements) per thread

__device__ __forceinline__ float lerp_rn(float w, float wh, float a) {
  return __fmaf_rn(a, __fsub_rn(wh, w), w);
}

// w and out of type T, w_hat of type TH (T itself, or fp32 beside bf16)
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float v, float* o) { *o = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}

// n elements, all three pointers 16-byte aligned: nv = n / V whole
// vectors (one 16-byte access of w and out, H of w_hat), then the tail
// n - nv V (< V) by the first threads.
template <typename T, typename TH>
__global__ void __launch_bounds__(kThreads)
meta_update_vec(const T* __restrict__ w, const TH* __restrict__ wh,
                const float* __restrict__ alpha, T* __restrict__ out,
                long long n) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte access of w
  constexpr int H = V * sizeof(TH) / 16;  // w_hat accesses per vector
  const float a = __ldg(alpha);
  const long long nv = n / V;
  const uint4* w4 = reinterpret_cast<const uint4*>(w);
  const uint4* h4 = reinterpret_cast<const uint4*>(wh);
  uint4* o4 = reinterpret_cast<uint4*>(out);
  const long long base =
      (long long)blockIdx.x * kThreads * kUnroll + threadIdx.x;
  uint4 x[kUnroll], y[kUnroll][H];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = base + u * kThreads;
    if (i < nv) {
      x[u] = __ldcs(w4 + i);
#pragma unroll
      for (int h = 0; h < H; ++h) y[u][h] = __ldcs(h4 + i * H + h);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = base + u * kThreads;
    if (i < nv) {
      uint4 r;
      const T* xs = reinterpret_cast<const T*>(&x[u]);
      const TH* ys = reinterpret_cast<const TH*>(&y[u][0]);
      T* rs = reinterpret_cast<T*>(&r);
#pragma unroll
      for (int j = 0; j < V; ++j)
        store(lerp_rn(to_f32(xs[j]), to_f32(ys[j]), a), &rs[j]);
      __stcs(o4 + i, r);
    }
  }
  const long long tail = nv * V + (long long)blockIdx.x * kThreads +
                         threadIdx.x;
  if (tail < n) store(lerp_rn(to_f32(w[tail]), to_f32(wh[tail]), a),
                      &out[tail]);
}

// any alignment: kUnroll elements a thread, loaded before any is used
template <typename T, typename TH>
__global__ void __launch_bounds__(kThreads)
meta_update_scalar(const T* __restrict__ w, const TH* __restrict__ wh,
                   const float* __restrict__ alpha, T* __restrict__ out,
                   long long n) {
  const float a = __ldg(alpha);
  const long long base =
      (long long)blockIdx.x * kThreads * kUnroll + threadIdx.x;
  float x[kUnroll], y[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = base + u * kThreads;
    if (i < n) {
      x[u] = to_f32(__ldcs(w + i));
      y[u] = to_f32(__ldcs(wh + i));
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = base + u * kThreads;
    if (i < n) store(lerp_rn(x[u], y[u], a), &out[i]);
  }
}

template <typename T, typename TH>
cudaError_t launch(const void* w, const void* wh, const float* alpha,
                   void* out, long long n, cudaStream_t stream) {
  const bool vectorized =
      (((uintptr_t)w | (uintptr_t)wh | (uintptr_t)out) % 16) == 0;
  const long long per_block = (long long)kThreads * kUnroll;
  const long long items = vectorized ? n / (16 / sizeof(T)) : n;
  long long blocks = (items + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;                  // a tail only
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const T* wt = static_cast<const T*>(w);
  const TH* ht = static_cast<const TH*>(wh);
  T* ot = static_cast<T*>(out);
  if (vectorized)
    meta_update_vec<T, TH><<<(unsigned)blocks, kThreads, 0, stream>>>(
        wt, ht, alpha, ot, n);
  else
    meta_update_scalar<T, TH><<<(unsigned)blocks, kThreads, 0, stream>>>(
        wt, ht, alpha, ot, n);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = bfloat16 w and out with a float32
// w_hat. Returns the cudaError_t of the launch.
extern "C" int meta_update_launch(const void* w, const void* w_hat,
                                  const void* alpha, void* out, long long n,
                                  int dtype, void* stream) {
  if (n <= 0) return 0;
  const float* a = static_cast<const float*>(alpha);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float, float>(w, w_hat, a, out, n, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(w, w_hat, a, out, n, s);
  if (dtype == 2)
    return (int)launch<__nv_bfloat16, float>(w, w_hat, a, out, n, s);
  return (int)cudaErrorInvalidValue;
}
