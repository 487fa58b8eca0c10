// Weighted client mean out[i] = sum_c w[c] * (w[c] > 0 ? q[c][i] : 0) on
// Hopper, in the order the JAX engine's jitted weighted_client_mean sums.
//
// No Pallas kernel computes this: the JAX engine runs
// repro/core/strategies.py::weighted_client_mean under jax.jit, and XLA
// on the CPU fixes its rounding. Up to 32 clients it fuses the multiply
// and the reduction into one loop, which LLVM contracts into a chain of
// fused multiply-adds in client order from 0:
//   acc = fma(w[c], x[c], acc)
// (__fmaf_rn, one rounding a step). Above 32 the products are rounded on
// their own (__fmul_rn) and summed by reduce-windows of 32 (the padding
// split in front and behind), each window in order from 0, level by level
// until at most 32 partial sums are left, which are summed in order from
// 0 (__fadd_rn). The host builds that plan (levels, entries, front
// padding) and passes it by value; it depends on C only, so every thread
// walks it the same way. kernels/ref.py::client_mean is the plain
// version of both orders; the two agree bit for bit.
//
// One thread per parameter; for each client the warp reads 32 consecutive
// floats, so every load is coalesced, and the weights are read through
// the read-only cache. Up to 32 clients the chain's loop is unrolled by
// eight, so their loads are issued together. Above 32 a window's 32 loads
// are issued before any value is used, so a thread waits on memory once
// a window; it sums each window in a tight loop, and only the windows'
// sums walk the levels above (their state unrolled into registers).
// Bound on an H100: (n P + C + P) x 4 bytes over 3.35 TB/s, n the clients
// whose weight is above 0 (no other client's row is read).
//
// q may also be bf16 (dtype code 1: a bf16 dtype group of the engine's
// cohort): each value is widened to fp32 in registers as it is loaded,
// which is exact, and the sums are the fp32 ones above in the same
// order, so the result equals the fp32 kernel's on q.float() bit for bit
// without that (C, P) fp32 copy. Its bound is (2 n P + 4 C + 4 P) bytes. At the
// engine's shapes (C <= 64, P = 1,153 or 20,612) the launch and the
// loads' latency, not memory bandwidth, set the pace.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWindow = 32;     // XLA's chain limit and reduce-window size
constexpr int kMaxLevels = 7;   // ceil(C / 32) levels for any C < 2^31

struct Plan {
  int levels;                 // 0: the FMA chain
  int n[kMaxLevels];          // entries at each level
  int lo[kMaxLevels];         // zeros in front of each level's windows
};

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// Up to kWindow clients' weights and values of parameter i, all loads
// issued before any is used: x[u] = w[c0 + u] > 0 ? q[c0 + u][i] : 0.
template <typename T>
__device__ __forceinline__ void load_window(const T* __restrict__ q,
                                            const float* __restrict__ w,
                                            long long P, long long i, int c0,
                                            int n, float* wv, float* x) {
#pragma unroll
  for (int u = 0; u < kWindow; ++u) wv[u] = u < n ? __ldg(w + c0 + u) : 0.f;
#pragma unroll
  for (int u = 0; u < kWindow; ++u)
    x[u] = wv[u] > 0.f ? load_f32(q + (long long)(c0 + u) * P + i) : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
client_mean_chain(const T* __restrict__ q, const float* __restrict__ w,
                  float* __restrict__ out, long long P, int C) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= P) return;
  float acc = 0.f;
#pragma unroll 8
  for (int c = 0; c < C; ++c) {
    const float wc = __ldg(w + c);
    const float x = wc > 0.f ? load_f32(q + (long long)c * P + i) : 0.f;
    acc = __fmaf_rn(wc, x, acc);
  }
  out[i] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
client_mean_windows(const T* __restrict__ q, const float* __restrict__ w,
                    float* __restrict__ out, long long P, int C, Plan plan) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= P) return;
  // levels 1 and up: the open window's sum and the next entry's index;
  // the level loop is unrolled, so both live in registers
  float part[kMaxLevels];
  int at[kMaxLevels];
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    part[l] = 0.f;
    at[l] = 0;
  }
  float total = 0.f;
  const int windows = (C + kWindow - 1) / kWindow;
  for (int j = 0; j < windows; ++j) {
    // the clients of level-0 window j (its padding adds nothing)
    const int begin = max(0, j * kWindow - plan.lo[0]);
    const int n = min(C, (j + 1) * kWindow - plan.lo[0]) - begin;
    float wv[kWindow], x[kWindow];
    load_window(q, w, P, i, begin, n, wv, x);
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < kWindow; ++u)
      if (u < n) s = __fadd_rn(s, __fmul_rn(wv[u], x[u]));
    if (plan.levels == 1) {
      total = __fadd_rn(total, s);
      continue;
    }
    // s is entry j of level 1: add it to its window; a window that
    // closes passes its sum up a level, the last level's to the total
    float up = s;
    bool carry = true;
#pragma unroll
    for (int l = 1; l < kMaxLevels; ++l) {
      if (carry && l < plan.levels) {
        part[l] = __fadd_rn(part[l], up);
        const int e = at[l]++;
        carry = (e + plan.lo[l]) % kWindow == kWindow - 1 ||
                e == plan.n[l] - 1;
        if (carry) {
          up = part[l];
          part[l] = 0.f;
          if (l == plan.levels - 1) total = __fadd_rn(total, up);
        }
      }
    }
  }
  out[i] = total;
}

template <typename T>
void launch(const void* q, const float* wf, float* of, long long P, int C,
            const Plan& plan, unsigned blocks, cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  if (plan.levels == 0)
    client_mean_chain<T><<<blocks, kThreads, 0, s>>>(qt, wf, of, P, C);
  else
    client_mean_windows<T><<<blocks, kThreads, 0, s>>>(qt, wf, of, P, C,
                                                       plan);
}

}  // namespace

// q: (C, P), row stride P, fp32 (dtype 0) or bf16 (dtype 1); w: (C,)
// fp32; out: (P,) fp32, all on the device. Returns the cudaError_t of the
// launch.
extern "C" int client_mean_launch(const void* q, const void* w, void* out,
                                  long long P, int C, int dtype,
                                  void* stream) {
  if (P <= 0) return 0;
  if (C < 1 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const long long blocks = (P + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  Plan plan{};
  for (int n = C; n > kWindow; n = (n + kWindow - 1) / kWindow) {
    if (plan.levels == kMaxLevels) return (int)cudaErrorInvalidValue;
    const int windows = (n + kWindow - 1) / kWindow;
    plan.n[plan.levels] = n;
    plan.lo[plan.levels] = (windows * kWindow - n) / 2;
    ++plan.levels;
  }
  if (dtype == 0)
    launch<float>(q, wf, of, P, C, plan, (unsigned)blocks, s);
  else
    launch<__nv_bfloat16>(q, wf, of, P, C, plan, (unsigned)blocks, s);
  return (int)cudaGetLastError();
}
