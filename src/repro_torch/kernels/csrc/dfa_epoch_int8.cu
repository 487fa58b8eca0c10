// One TIFeD integer epoch per slot: DFA forward + single-layer update.
//
// Replaces the TPU kernel repro/kernels/online_sgd_int8.py::dfa_epoch_int8
// (_dfa_epoch_kernel), which runs one slot per pallas_call. Here one
// launch covers every slot of the adaptation server: grid = B, one CTA per
// slot, 256 threads. The plain version is
// repro_torch/kernels/ref.py::dfa_int8_epoch; weights and biases must equal
// it exactly, and the loss does too while sum(err^2) < 2^53.
//
// Per slot the CTA stages its int8 weights, int32 biases, the shared int8
// feedback matrices and its int8 inputs in shared memory, loops the S
// samples inside the block, keeps the uint7 activations (int8) and the
// quantized error (int32) there, and updates only the layer this slot's
// `layer` selects; the other two layers are copied through.
//
// Arithmetic: int8 x int8 products accumulate in int32 (every sum stays
// below 2^24 inside the documented envelope, so fp32 conversions are
// exact); requantization multiplies by fp32 powers of two with the _rn
// intrinsics so nvcc cannot contract them into an FMA, rounds half to even
// with rintf (as jnp.round does) and clamps in the reference's order. The
// loss is accumulated in double per thread and reduced across the block.
//
// Bound on an H100: at the serving shape (S = 8, 1 -> 32 -> 32 -> 1) a slot
// reads about 1.2 KB of weights and inputs plus a 4 KB fp32 dither plane
// at most and writes 1.2 KB; at B = 64 that is well under a microsecond of
// HBM time (3.35 TB/s) and a few hundred thousand integer operations, so
// launch latency sets the pace: hence one launch for all slots.
//
// Plain C interface, loaded with ctypes: every entry point returns a
// cudaError_t (0 on success) and never synchronizes.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr float kInt8Max = 127.0f;
constexpr float kBiasMax = 8388608.0f;    // 2^23
constexpr float kDfaScale = 0.0078125f;   // 2^-7 (DFA_SHIFT = 7)
constexpr size_t kMaxSmem = 232448;       // 227 KB, an H100 block's limit

struct Dims {
  int S, din, h1, h2, dout;
};

struct Layout {
  size_t w0, w1, w2, fb1, fb2, x, a1, a2, b0, b1, b2, eq, d, total;
};

__host__ __device__ inline size_t align4(size_t x) { return (x + 3) & ~size_t(3); }

__host__ __device__ inline Layout make_layout(const Dims& D) {
  const size_t S = D.S, din = D.din, h1 = D.h1, h2 = D.h2, dout = D.dout;
  const size_t hmax = h1 > h2 ? h1 : h2;
  Layout L;
  size_t o = 0;
  L.w0 = o;  o += din * h1;
  L.w1 = o;  o += h1 * h2;
  L.w2 = o;  o += h2 * dout;
  L.fb1 = o; o += dout * h1;
  L.fb2 = o; o += dout * h2;
  L.x = o;   o += S * din;
  L.a1 = o;  o += S * h1;
  L.a2 = o;  o += S * h2;
  o = align4(o);
  L.b0 = o;  o += 4 * h1;
  L.b1 = o;  o += 4 * h2;
  L.b2 = o;  o += 4 * dout;
  L.eq = o;  o += 4 * S * dout;
  L.d = o;   o += 4 * S * hmax;
  L.total = o;
  return L;
}

// uint7 activation requant: clip(round(max(z, 0) * f), 0, 127)
__device__ inline int8_t requant_act(int z, float f) {
  const float r = rintf(__fmul_rn(__int2float_rn(z > 0 ? z : 0), f));
  return static_cast<int8_t>(__float2int_rn(fminf(fmaxf(r, 0.0f), kInt8Max)));
}

__device__ inline float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__global__ void __launch_bounds__(kThreads) dfa_epoch_int8_kernel(
    const int8_t* __restrict__ xq, const int32_t* __restrict__ yal,
    const int8_t* __restrict__ w0, const int8_t* __restrict__ w1,
    const int8_t* __restrict__ w2, const int32_t* __restrict__ b0,
    const int32_t* __restrict__ b1, const int32_t* __restrict__ b2,
    const int8_t* __restrict__ fb1, const int8_t* __restrict__ fb2,
    const float* __restrict__ dith0, const float* __restrict__ dith1,
    const float* __restrict__ dith2, const float* __restrict__ scales,
    const int32_t* __restrict__ layers, int8_t* __restrict__ ow0,
    int8_t* __restrict__ ow1, int8_t* __restrict__ ow2,
    int32_t* __restrict__ ob0, int32_t* __restrict__ ob1,
    int32_t* __restrict__ ob2, float* __restrict__ loss, Dims D) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(D);
  const int S = D.S, din = D.din, h1 = D.h1, h2 = D.h2, dout = D.dout;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t b = blockIdx.x;

  int8_t* w0s = reinterpret_cast<int8_t*>(smem + L.w0);
  int8_t* w1s = reinterpret_cast<int8_t*>(smem + L.w1);
  int8_t* w2s = reinterpret_cast<int8_t*>(smem + L.w2);
  int8_t* fb1s = reinterpret_cast<int8_t*>(smem + L.fb1);
  int8_t* fb2s = reinterpret_cast<int8_t*>(smem + L.fb2);
  int8_t* xs = reinterpret_cast<int8_t*>(smem + L.x);
  int8_t* a1s = reinterpret_cast<int8_t*>(smem + L.a1);
  int8_t* a2s = reinterpret_cast<int8_t*>(smem + L.a2);
  int32_t* b0s = reinterpret_cast<int32_t*>(smem + L.b0);
  int32_t* b1s = reinterpret_cast<int32_t*>(smem + L.b1);
  int32_t* b2s = reinterpret_cast<int32_t*>(smem + L.b2);
  int32_t* eqs = reinterpret_cast<int32_t*>(smem + L.eq);
  int32_t* ds = reinterpret_cast<int32_t*>(smem + L.d);

  const float f0 = scales[0], f1 = scales[1], fe = scales[2];
  const double floss = scales[3];
  const int layer = min(max(layers[b], 0), 2);   // lax.switch clamps too

  // this slot's tensors
  const int8_t* gw0 = w0 + b * din * h1;
  const int8_t* gw1 = w1 + b * h1 * h2;
  const int8_t* gw2 = w2 + b * h2 * dout;
  const int32_t* gb0 = b0 + b * h1;
  const int32_t* gb1 = b1 + b * h2;
  const int32_t* gb2 = b2 + b * dout;
  const int8_t* gx = xq + b * S * din;
  const int32_t* gy = yal + b * S * dout;

  for (int i = tid; i < din * h1; i += nt) w0s[i] = gw0[i];
  for (int i = tid; i < h1 * h2; i += nt) w1s[i] = gw1[i];
  for (int i = tid; i < h2 * dout; i += nt) w2s[i] = gw2[i];
  for (int i = tid; i < dout * h1; i += nt) fb1s[i] = fb1[i];
  for (int i = tid; i < dout * h2; i += nt) fb2s[i] = fb2[i];
  for (int i = tid; i < S * din; i += nt) xs[i] = gx[i];
  for (int i = tid; i < h1; i += nt) b0s[i] = gb0[i];
  for (int i = tid; i < h2; i += nt) b1s[i] = gb1[i];
  for (int i = tid; i < dout; i += nt) b2s[i] = gb2[i];
  __syncthreads();

  // forward, layer 0: z0 = x w0 + b0; ds holds the z0 > 0 mask if layer 0
  for (int idx = tid; idx < S * h1; idx += nt) {
    const int s = idx / h1, j = idx - s * h1;
    int z = b0s[j];
    for (int i = 0; i < din; ++i) z += int(xs[s * din + i]) * int(w0s[i * h1 + j]);
    a1s[idx] = requant_act(z, f0);
    if (layer == 0) ds[idx] = z > 0;
  }
  __syncthreads();

  // forward, layer 1
  for (int idx = tid; idx < S * h2; idx += nt) {
    const int s = idx / h2, k = idx - s * h2;
    int z = b1s[k];
    for (int j = 0; j < h1; ++j) z += int(a1s[s * h1 + j]) * int(w1s[j * h2 + k]);
    a2s[idx] = requant_act(z, f1);
    if (layer == 1) ds[idx] = z > 0;
  }
  __syncthreads();

  // output layer, error, quantized error, loss
  double lsum = 0.0;
  for (int idx = tid; idx < S * dout; idx += nt) {
    const int s = idx / dout, o = idx - s * dout;
    int z = b2s[o];
    for (int k = 0; k < h2; ++k) z += int(a2s[s * h2 + k]) * int(w2s[k * dout + o]);
    const int e = z - gy[idx];
    const float q = rintf(__fmul_rn(__int2float_rn(e), fe));
    eqs[idx] = __float2int_rn(clampf(q, -kInt8Max, kInt8Max));
    const double ed = static_cast<double>(e);
    lsum += ed * ed;
  }
  for (int off = 16; off > 0; off >>= 1) lsum += __shfl_down_sync(0xffffffffu, lsum, off);
  __shared__ double warp_sums[kThreads / 32];
  if ((tid & 31) == 0) warp_sums[tid >> 5] = lsum;
  __syncthreads();
  if (tid == 0) {
    double t = 0.0;
    for (int w = 0; w < (nt + 31) / 32; ++w) t += warp_sums[w];
    loss[b] = static_cast<float>(t * floss);
  }

  // DFA delta for a hidden layer: d = round(where(z > 0, eq fb, 0) * 2^-7)
  const int32_t* dmat = eqs;
  int dcols = dout;
  if (layer == 0 || layer == 1) {
    const int H = layer == 0 ? h1 : h2;
    const int8_t* fbm = layer == 0 ? fb1s : fb2s;
    for (int idx = tid; idx < S * H; idx += nt) {
      const int s = idx / H, j = idx - s * H;
      int d = 0;
      if (ds[idx]) {
        int p = 0;
        for (int o = 0; o < dout; ++o) p += eqs[s * dout + o] * int(fbm[o * H + j]);
        d = __float2int_rn(rintf(__fmul_rn(__int2float_rn(p), kDfaScale)));
      }
      ds[idx] = d;
    }
    __syncthreads();
    dmat = ds;
    dcols = H;
  }

  // stochastic-rounding update of the selected layer: w - floor(g ftw + u)
  const int A = layer == 0 ? din : (layer == 1 ? h1 : h2);
  const int8_t* ain = layer == 0 ? xs : (layer == 1 ? a1s : a2s);
  const int8_t* wcur = layer == 0 ? w0s : (layer == 1 ? w1s : w2s);
  const int32_t* bcur = layer == 0 ? b0s : (layer == 1 ? b1s : b2s);
  const float* dith = layer == 0 ? dith0 + b * din * h1
                    : (layer == 1 ? dith1 + b * h1 * h2 : dith2 + b * h2 * dout);
  int8_t* wout = layer == 0 ? ow0 + b * din * h1
               : (layer == 1 ? ow1 + b * h1 * h2 : ow2 + b * h2 * dout);
  int32_t* bout = layer == 0 ? ob0 + b * h1 : (layer == 1 ? ob1 + b * h2 : ob2 + b * dout);
  const float ftw = scales[4 + layer], ftb = scales[7 + layer];
  for (int idx = tid; idx < A * dcols; idx += nt) {
    const int i = idx / dcols, j = idx - i * dcols;
    int g = 0;
    for (int s = 0; s < S; ++s) g += int(ain[s * A + i]) * dmat[s * dcols + j];
    const float v = __fadd_rn(__fmul_rn(__int2float_rn(g), ftw), dith[idx]);
    const float wn = __fsub_rn(static_cast<float>(wcur[idx]), floorf(v));
    wout[idx] = static_cast<int8_t>(__float2int_rn(clampf(wn, -kInt8Max, kInt8Max)));
  }
  for (int j = tid; j < dcols; j += nt) {
    int dsum = 0;
    for (int s = 0; s < S; ++s) dsum += dmat[s * dcols + j];
    const float step = rintf(__fmul_rn(__int2float_rn(dsum), ftb));
    const float bn = __fsub_rn(__int2float_rn(bcur[j]), step);
    bout[j] = __float2int_rn(clampf(bn, -kBiasMax, kBiasMax));
  }

  // the layers not trained this epoch pass through
  if (layer != 0) {
    for (int i = tid; i < din * h1; i += nt) ow0[b * din * h1 + i] = w0s[i];
    for (int i = tid; i < h1; i += nt) ob0[b * h1 + i] = b0s[i];
  }
  if (layer != 1) {
    for (int i = tid; i < h1 * h2; i += nt) ow1[b * h1 * h2 + i] = w1s[i];
    for (int i = tid; i < h2; i += nt) ob1[b * h2 + i] = b1s[i];
  }
  if (layer != 2) {
    for (int i = tid; i < h2 * dout; i += nt) ow2[b * h2 * dout + i] = w2s[i];
    for (int i = tid; i < dout; i += nt) ob2[b * dout + i] = b2s[i];
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs for these dims (bytes).
size_t dfa_epoch_int8_smem_bytes(int S, int din, int h1, int h2, int dout) {
  return make_layout(Dims{S, din, h1, h2, dout}).total;
}

int dfa_epoch_int8_launch(
    const void* xq, const void* yal, const void* w0, const void* w1,
    const void* w2, const void* b0, const void* b1, const void* b2,
    const void* fb1, const void* fb2, const void* dith0, const void* dith1,
    const void* dith2, const void* scales, const void* layers, void* ow0,
    void* ow1, void* ow2, void* ob0, void* ob1, void* ob2, void* loss,
    int B, int S, int din, int h1, int h2, int dout, void* stream) {
  if (B < 1 || S < 1 || din < 1 || h1 < 1 || h2 < 1 || dout < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Dims D{S, din, h1, h2, dout};
  const size_t smem = make_layout(D).total;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dfa_epoch_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dfa_epoch_int8_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const int32_t*>(yal),
      static_cast<const int8_t*>(w0), static_cast<const int8_t*>(w1),
      static_cast<const int8_t*>(w2), static_cast<const int32_t*>(b0),
      static_cast<const int32_t*>(b1), static_cast<const int32_t*>(b2),
      static_cast<const int8_t*>(fb1), static_cast<const int8_t*>(fb2),
      static_cast<const float*>(dith0), static_cast<const float*>(dith1),
      static_cast<const float*>(dith2), static_cast<const float*>(scales),
      static_cast<const int32_t*>(layers), static_cast<int8_t*>(ow0),
      static_cast<int8_t*>(ow1), static_cast<int8_t*>(ow2),
      static_cast<int32_t*>(ob0), static_cast<int32_t*>(ob1),
      static_cast<int32_t*>(ob2), static_cast<float*>(loss), D);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
