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
// that. There is no reuse, so no TMA or wgmma: a grid-stride loop of
// 16-byte loads (float4, or eight bf16) where all three pointers are
// 16-byte aligned, and a scalar tail. At the sine MLP's 1,153 elements
// launch latency, not memory, sets the pace.
//
// alpha is read from a one-float device pointer, as the TPU kernel reads
// it from SMEM: an annealed per-round alpha then needs no host->device
// copy, and a captured launch stays valid when alpha changes.
//
// The math is fp32 whatever the storage. Each operation is rounded on
// its own (__fsub_rn, __fmul_rn, __fadd_rn), so nvcc cannot contract
// them into an FMA and the result equals the plain PyTorch version
// (kernels/ref.py::meta_update) bit for bit; bf16 output rounds to
// nearest even, as torch's cast does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float lerp_rn(float w, float wh, float a) {
  return __fadd_rn(w, __fmul_rn(a, __fsub_rn(wh, w)));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float v, float* o) { *o = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
meta_update_kernel(const T* __restrict__ w, const T* __restrict__ wh,
                   const float* __restrict__ alpha, T* __restrict__ out,
                   long long n, int vectorized) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte access
  const float a = __ldg(alpha);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long head = 0;
  if (vectorized) {
    const long long nv = n / V;
    const uint4* w4 = reinterpret_cast<const uint4*>(w);
    const uint4* h4 = reinterpret_cast<const uint4*>(wh);
    uint4* o4 = reinterpret_cast<uint4*>(out);
    for (long long i = tid; i < nv; i += stride) {
      const uint4 x = w4[i];
      const uint4 y = h4[i];
      uint4 r;
      const T* xs = reinterpret_cast<const T*>(&x);
      const T* ys = reinterpret_cast<const T*>(&y);
      T* rs = reinterpret_cast<T*>(&r);
#pragma unroll
      for (int j = 0; j < V; ++j)
        store(lerp_rn(to_f32(xs[j]), to_f32(ys[j]), a), &rs[j]);
      o4[i] = r;
    }
    head = nv * V;
  }
  for (long long i = head + tid; i < n; i += stride)
    store(lerp_rn(to_f32(w[i]), to_f32(wh[i]), a), &out[i]);
}

template <typename T>
cudaError_t launch(const void* w, const void* wh, const float* alpha,
                   void* out, long long n, cudaStream_t stream) {
  const int vectorized =
      (((uintptr_t)w | (uintptr_t)wh | (uintptr_t)out) % 16) == 0;
  const long long per_thread = vectorized ? 16 / sizeof(T) : 1;
  const long long work = (n + per_thread - 1) / per_thread;
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  // enough blocks to fill every SM several times over; the grid-stride
  // loop covers the rest
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = 8LL * sms;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  meta_update_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(w), static_cast<const T*>(wh), alpha,
      static_cast<T*>(out), n, vectorized);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int meta_update_launch(const void* w, const void* w_hat,
                                  const void* alpha, void* out, long long n,
                                  int dtype, void* stream) {
  if (n <= 0) return 0;
  const float* a = static_cast<const float*>(alpha);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(w, w_hat, a, out, n, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(w, w_hat, a, out, n, s);
  return (int)cudaErrorInvalidValue;
}
