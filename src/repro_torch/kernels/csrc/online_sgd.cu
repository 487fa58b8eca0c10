// Streaming SGD step out = p - lr * g on Hopper, and its momentum form.
//
// online_sgd_launch replaces the TPU kernel
// repro/kernels/online_sgd.py::online_sgd_2d (_sgd_kernel). The JAX server makes one pallas_call per parameter leaf;
// the port keeps every slot's (or client's) parameters in one flat buffer,
// so one launch updates all of them: one launch per streamed sample on
// the quickstart's TinyReptile client, one per step of a serving tick.
//
// Bound on an H100: the pass reads p and g and writes out once, 12 bytes
// per element in fp32 and 6 in bf16, over 3.35 TB/s (0.26 us at the
// serving shape's 64 x 1,153 fp32, 231 us at mamba2-130m's 128,981,760
// bf16); two flops per element are nothing beside that. At the sine MLP's
// sizes launch latency, on the device and on the host, sets the pace, so
// the design is about the host path as much as the device: a plain C entry
// point called through ctypes with lr passed by value (no host->device
// copy, nothing to look up per call), on PyTorch's current stream.
//
// Device side, as csrc/meta_update.cu: there is no reuse, so no TMA or
// wgmma; what matters is bytes in flight. Where all three pointers are
// 16-byte aligned each thread loads U independent 16-byte vectors of p and
// of g (float4, or eight bf16) before it uses any, with streaming cache
// hints (__ldcs, __stcs: nothing is read twice). The grid is sized to the
// work: 256-thread blocks of U = 4 vectors a thread where that fills the
// card's 132 SMs at least once, else 128-thread blocks of one vector a
// thread, so that a small update (64 x 1,153 is 18,448 vectors) is spread
// over 145 blocks rather than 19 (each SM's own bandwidth to
// L2 would set the pace there). The few elements past the last whole
// vector go to the first threads of the grid. Unaligned buffers take the
// scalar kernel, U elements a thread.
//
// out may be p (the update in place, as the LM inner loop runs it on a
// model too large for a second copy): each thread loads its elements of p
// and g before it stores them to out, and no other thread touches them, so
// these two kernels declare no pointer __restrict__.
//
// The math is fp32 whatever the storage. lr * g and the difference are
// rounded on their own (__fmul_rn, __fsub_rn), so nvcc cannot contract
// them into an FMA and the result equals the plain PyTorch version
// (kernels/ref.py::online_sgd, lr rounded to fp32 as torch does) bit for
// bit; bf16 output rounds to nearest even, as torch's cast does.
//
// online_sgd_momentum_launch replaces online_sgd_momentum_2d
// (_sgd_momentum_kernel): m' = mu * m + g, then p' = p - lr * m', with m
// and m' fp32 whatever p's type (fp32 or bf16, g in p's type). The same
// design: one pass reads p, g and m and writes p' and m', 20 bytes per
// element in fp32 and 14 with bf16 p and g (100.2 us and 70.1 us at 2^24
// elements over 3.35 TB/s, four flops per element beside that). A 16-byte
// vector of p and g (4 fp32 or 8 bf16 elements) goes with one or two
// 16-byte vectors of m; the grid and the tail are as above, the scalar
// kernel takes any unaligned operand, and lr and mu are passed by value.
// Each operation is rounded on its own (__fmul_rn and __fadd_rn for
// mu * m + g, __fmul_rn and __fsub_rn for p - lr * m'), as the plain
// version's tensor ops round them (kernels/ref.py::online_sgd with m=),
// so the two agree bit for bit.
//
// The helpers are copied from csrc/meta_update.cu rather than shared
// through a header: kernels/build.py names each library by a hash of its
// one source file, so an edited header would not rebuild it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSms = 132;            // an H100 SXM's SMs
// the two launch shapes: (threads, vectors or elements a thread)
constexpr int kBigThreads = 256, kBigUnroll = 4;
constexpr int kSmallThreads = 128, kSmallUnroll = 1;

__device__ __forceinline__ float step_rn(float p, float g, float lr) {
  return __fsub_rn(p, __fmul_rn(lr, g));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float v, float* o) { *o = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* o) {
  *o = __float2bfloat16_rn(v);
}

// n elements, all three pointers 16-byte aligned: nv = n / V whole
// vectors, then the tail n - nv V (< V) by the first threads.
template <typename T, int kThreads, int kUnroll>
__global__ void __launch_bounds__(kThreads)
online_sgd_vec(const T* p, const T* g, T* out, long long n, float lr) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte access
  const long long nv = n / V;
  const uint4* p4 = reinterpret_cast<const uint4*>(p);
  const uint4* g4 = reinterpret_cast<const uint4*>(g);
  uint4* o4 = reinterpret_cast<uint4*>(out);
  const long long base =
      (long long)blockIdx.x * kThreads * kUnroll + threadIdx.x;
  uint4 x[kUnroll], y[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = base + u * kThreads;
    if (i < nv) {
      x[u] = __ldcs(p4 + i);
      y[u] = __ldcs(g4 + i);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = base + u * kThreads;
    if (i < nv) {
      uint4 r;
      const T* xs = reinterpret_cast<const T*>(&x[u]);
      const T* ys = reinterpret_cast<const T*>(&y[u]);
      T* rs = reinterpret_cast<T*>(&r);
#pragma unroll
      for (int j = 0; j < V; ++j)
        store(step_rn(to_f32(xs[j]), to_f32(ys[j]), lr), &rs[j]);
      __stcs(o4 + i, r);
    }
  }
  const long long tail = nv * V + (long long)blockIdx.x * kThreads +
                         threadIdx.x;
  if (tail < n) store(step_rn(to_f32(p[tail]), to_f32(g[tail]), lr),
                      &out[tail]);
}

// any alignment: kUnroll elements a thread, loaded before any is used
template <typename T, int kThreads, int kUnroll>
__global__ void __launch_bounds__(kThreads)
online_sgd_scalar(const T* p, const T* g, T* out, long long n, float lr) {
  const long long base =
      (long long)blockIdx.x * kThreads * kUnroll + threadIdx.x;
  float x[kUnroll], y[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = base + u * kThreads;
    if (i < n) {
      x[u] = to_f32(__ldcs(p + i));
      y[u] = to_f32(__ldcs(g + i));
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = base + u * kThreads;
    if (i < n) store(step_rn(x[u], y[u], lr), &out[i]);
  }
}

template <typename T, int kThreads, int kUnroll>
cudaError_t launch_as(bool vectorized, long long items, const T* p,
                      const T* g, T* out, long long n, float lr,
                      cudaStream_t stream) {
  const long long per_block = (long long)kThreads * kUnroll;
  long long blocks = (items + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;                  // a tail only
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (vectorized)
    online_sgd_vec<T, kThreads, kUnroll>
        <<<(unsigned)blocks, kThreads, 0, stream>>>(p, g, out, n, lr);
  else
    online_sgd_scalar<T, kThreads, kUnroll>
        <<<(unsigned)blocks, kThreads, 0, stream>>>(p, g, out, n, lr);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* p, const void* g, void* out, long long n,
                   float lr, cudaStream_t stream) {
  const bool vectorized =
      (((uintptr_t)p | (uintptr_t)g | (uintptr_t)out) % 16) == 0;
  const long long items = vectorized ? n / (16 / sizeof(T)) : n;
  const T* pt = static_cast<const T*>(p);
  const T* gt = static_cast<const T*>(g);
  T* ot = static_cast<T*>(out);
  if (items >= (long long)kSms * kBigThreads * kBigUnroll)
    return launch_as<T, kBigThreads, kBigUnroll>(vectorized, items, pt, gt,
                                                 ot, n, lr, stream);
  return launch_as<T, kSmallThreads, kSmallUnroll>(vectorized, items, pt,
                                                   gt, ot, n, lr, stream);
}

__device__ __forceinline__ float momentum_rn(float m, float g, float mu) {
  return __fadd_rn(__fmul_rn(mu, m), g);
}

// one element of the momentum step: m' to *om, p' to *op
template <typename T>
__device__ __forceinline__ void momentum_one(float p, float g, float m,
                                             float lr, float mu, T* op,
                                             float* om) {
  const float mn = momentum_rn(m, g, mu);
  *om = mn;
  store(step_rn(p, mn, lr), op);
}

// n elements, all five pointers 16-byte aligned: a 16-byte vector of p and
// of g (V elements) with the V fp32 values of m beside it (MV vectors),
// nv = n / V of them, then the tail by the first threads.
template <typename T, int kThreads, int kUnroll>
__global__ void __launch_bounds__(kThreads)
momentum_vec(const T* __restrict__ p, const T* __restrict__ g,
             const float* __restrict__ m, T* __restrict__ op,
             float* __restrict__ om, long long n, float lr, float mu) {
  constexpr int V = 16 / sizeof(T);
  constexpr int MV = V / 4;
  const long long nv = n / V;
  const uint4* p4 = reinterpret_cast<const uint4*>(p);
  const uint4* g4 = reinterpret_cast<const uint4*>(g);
  const float4* m4 = reinterpret_cast<const float4*>(m);
  uint4* op4 = reinterpret_cast<uint4*>(op);
  float4* om4 = reinterpret_cast<float4*>(om);
  const long long base =
      (long long)blockIdx.x * kThreads * kUnroll + threadIdx.x;
  uint4 x[kUnroll], y[kUnroll];
  float4 z[kUnroll][MV];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = base + u * kThreads;
    if (i < nv) {
      x[u] = __ldcs(p4 + i);
      y[u] = __ldcs(g4 + i);
#pragma unroll
      for (int v = 0; v < MV; ++v) z[u][v] = __ldcs(m4 + i * MV + v);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = base + u * kThreads;
    if (i < nv) {
      uint4 r;
      float4 q[MV];
      const T* xs = reinterpret_cast<const T*>(&x[u]);
      const T* ys = reinterpret_cast<const T*>(&y[u]);
      const float* zs = reinterpret_cast<const float*>(z[u]);
      T* rs = reinterpret_cast<T*>(&r);
      float* qs = reinterpret_cast<float*>(q);
#pragma unroll
      for (int j = 0; j < V; ++j)
        momentum_one(to_f32(xs[j]), to_f32(ys[j]), zs[j], lr, mu, &rs[j],
                     &qs[j]);
      __stcs(op4 + i, r);
#pragma unroll
      for (int v = 0; v < MV; ++v) __stcs(om4 + i * MV + v, q[v]);
    }
  }
  const long long tail = nv * V + (long long)blockIdx.x * kThreads +
                         threadIdx.x;
  if (tail < n)
    momentum_one(to_f32(p[tail]), to_f32(g[tail]), m[tail], lr, mu,
                 &op[tail], &om[tail]);
}

// any alignment: kUnroll elements a thread, loaded before any is used
template <typename T, int kThreads, int kUnroll>
__global__ void __launch_bounds__(kThreads)
momentum_scalar(const T* __restrict__ p, const T* __restrict__ g,
                const float* __restrict__ m, T* __restrict__ op,
                float* __restrict__ om, long long n, float lr, float mu) {
  const long long base =
      (long long)blockIdx.x * kThreads * kUnroll + threadIdx.x;
  float x[kUnroll], y[kUnroll], z[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = base + u * kThreads;
    if (i < n) {
      x[u] = to_f32(__ldcs(p + i));
      y[u] = to_f32(__ldcs(g + i));
      z[u] = __ldcs(m + i);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = base + u * kThreads;
    if (i < n) momentum_one(x[u], y[u], z[u], lr, mu, &op[i], &om[i]);
  }
}

template <typename T, int kThreads, int kUnroll>
cudaError_t momentum_as(bool vectorized, long long items, const T* p,
                        const T* g, const float* m, T* op, float* om,
                        long long n, float lr, float mu,
                        cudaStream_t stream) {
  const long long per_block = (long long)kThreads * kUnroll;
  long long blocks = (items + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;                  // a tail only
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (vectorized)
    momentum_vec<T, kThreads, kUnroll><<<(unsigned)blocks, kThreads, 0,
                                         stream>>>(p, g, m, op, om, n, lr,
                                                   mu);
  else
    momentum_scalar<T, kThreads, kUnroll><<<(unsigned)blocks, kThreads, 0,
                                            stream>>>(p, g, m, op, om, n,
                                                      lr, mu);
  return cudaGetLastError();
}

template <typename T>
cudaError_t momentum(const void* p, const void* g, const void* m, void* op,
                     void* om, long long n, float lr, float mu,
                     cudaStream_t stream) {
  const bool vectorized = (((uintptr_t)p | (uintptr_t)g | (uintptr_t)m |
                            (uintptr_t)op | (uintptr_t)om) % 16) == 0;
  const long long items = vectorized ? n / (16 / sizeof(T)) : n;
  const T* pt = static_cast<const T*>(p);
  const T* gt = static_cast<const T*>(g);
  const float* mt = static_cast<const float*>(m);
  T* opt = static_cast<T*>(op);
  float* omt = static_cast<float*>(om);
  if (items >= (long long)kSms * kBigThreads * kBigUnroll)
    return momentum_as<T, kBigThreads, kBigUnroll>(
        vectorized, items, pt, gt, mt, opt, omt, n, lr, mu, stream);
  return momentum_as<T, kSmallThreads, kSmallUnroll>(
      vectorized, items, pt, gt, mt, opt, omt, n, lr, mu, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int online_sgd_launch(const void* p, const void* g, void* out,
                                 long long n, int dtype, float lr,
                                 void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, g, out, n, lr, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, g, out, n, lr, s);
  return (int)cudaErrorInvalidValue;
}

// p, g: dtype (0 = float32, 1 = bfloat16); m, out_m: float32. Returns the
// cudaError_t of the launch.
extern "C" int online_sgd_momentum_launch(const void* p, const void* g,
                                          const void* m, void* out_p,
                                          void* out_m, long long n,
                                          int dtype, float lr, float mu,
                                          void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)momentum<float>(p, g, m, out_p, out_m, n, lr, mu, s);
  if (dtype == 1)
    return (int)momentum<__nv_bfloat16>(p, g, m, out_p, out_m, n, lr, mu,
                                        s);
  return (int)cudaErrorInvalidValue;
}
