// One TIFeD integer epoch per slot: DFA forward + single-layer update.
//
// Replaces the TPU kernel repro/kernels/online_sgd_int8.py::dfa_epoch_int8
// (_dfa_epoch_kernel), which runs one slot per pallas_call. Here one
// launch covers every slot of the adaptation server: one CTA of 256
// threads (8 warps) per slot. The plain version is
// repro_torch/kernels/ref.py::dfa_int8_epoch; weights and biases equal it
// exactly, and so does the loss while its float64 sum is exact.
//
// Bound on an H100: at the serving shape (S = 8, 1 -> 32 -> 32 -> 1) a slot
// reads about 1.2 KB of weights and inputs plus a 4 KB fp32 dither plane at
// most and writes 1.2 KB; at B = 64 that is 0.08 us of HBM time (3.35 TB/s)
// and under 2 M integer operations, nothing at the int8 rate. What sets the
// pace is the chain of dependent steps inside one slot, from the first load
// to the last store: global round trips of hundreds of cycles, shared loads
// and divisions of tens, and 8 warps sharing an SM's 4 schedulers, so every
// instruction on the chain counts. The kernel this one replaced staged its
// operands with one dependent load after another, ran the output layer on
// 8 threads a byte at a time, and divided to index every loop: 9.1 us a
// launch at the serving shape, against this one's 3.2 us, on an H100 80GB
// HBM3 at 700 W (kernels/time_dfa_epoch.py splits both by phase). So:
//
// * Staging is one round trip: every operand of the slot, the three dither
//   planes included (no wait for `layer` first), is started at once with
//   cp.async (16-byte copies where the address and size allow, else the
//   4-byte words that cover the bytes) and waited for once; the dither
//   planes land while the forward runs. An int8 operand whose slot does not
//   start on a word boundary comes with up to 3 bytes of its neighbours on
//   each side, which are never used. The layers this slot does not train
//   are written back from shared memory right after, off the chain.
// * Products on packed int8 with __dp4a: four int8 multiply-adds an
//   instruction, exact in int32. At staging w0, w1 and w2 are transposed
//   (lanes over columns, warps over rows: no division), so that each
//   output's reduction runs over contiguous bytes, with K padded to a
//   multiple of 4 with zeros and rows an odd number of words apart (the
//   lanes of a warp reading one word of neighbouring rows hit different
//   banks). The update's operands are transposed too: the layer input as
//   a[i][s] and the delta as d[j][s], packed over the S samples. d is int8
//   where it fits (the output error always; a hidden delta when dout = 1,
//   |d| <= 126); with dout > 1 it is int32 and the update uses IMAD. At the
//   serving shape each product is a few dp4a a lane: int8 mma.sync
//   (m16n8k32) would save some ten instructions a lane on the hidden layer
//   and is not used.
// * Three block barriers. A warp owns whole samples (P lanes a sample, P
//   the widest layer rounded up to a power of two, 4 to 32): for its
//   samples it runs layer 0, layer 1, the output layer with a reduction
//   over the P lanes, the quantized error, its share of the loss and the
//   DFA delta, with __syncwarp between the steps. Block barriers come only
//   after staging, after the transposes, and before the update, which sums
//   over every sample.
// * The sine MLP's dims (1, 32, 32, 1) are compile-time constants in their
//   own instantiations, one at the serving tick's S = 8 and one at the
//   round engine's S = 32 (TIFeD clients at the launcher's support), so
//   their layout, loop counts and index arithmetic fold away; any other
//   shape takes the same code with runtime values.
//   dfa_epoch_int8_launch_generic runs that generic instantiation at any
//   shape, so the two can be timed against each other.
// * The loss is an exact int64 sum of err^2, rounded once to double and
//   scaled by the power of two floss (the plain version sums in float64).
//
// Arithmetic: requantization multiplies by fp32 powers of two with the _rn
// intrinsics so nvcc cannot contract them into an FMA, rounds half to even
// with rintf (as torch.round and jnp.round do) and clamps in the plain
// version's order. Every integer sum stays below 2^24 inside the envelope
// the JAX package documents, so the fp32 conversions are exact.
//
// Plain C interface, loaded with ctypes: every entry point returns a
// cudaError_t (0 on success) and never synchronizes.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInt8Max = 127.0f;
constexpr float kBiasMax = 8388608.0f;    // 2^23
constexpr float kDfaScale = 0.0078125f;   // 2^-7 (DFA_SHIFT = 7)
constexpr size_t kMaxSmem = 232448;       // 227 KB, an H100 block's limit

struct Dims {
  int S, din, h1, h2, dout;
};

__host__ __device__ inline int up4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int up16(int x) { return (x + 15) & ~15; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
// bytes between the rows of a packed int8 matrix whose rows hold k bytes:
// whole words, an odd number of them
__host__ __device__ inline int odd_row(int k) { return 4 * (((k + 3) / 4) | 1); }
__host__ __device__ inline int take(int& o, int n) {
  const int at = o;
  o = up16(o + n);
  return at;
}

// Shared memory of one CTA (one slot), every region 16-byte aligned; the
// regions whose size does not depend on S come first.
struct Layout {
  // the operands as staged; the int8 ones with up to 3 bytes around
  int w0r, w1r, w2r, f1r, f2r, b0, b1, b2, d0, d1, d2;
  // packed for the products, and the warps' loss
  int w0t, w1t, w2t, lossw;
  int xr, y, xp, a1, a2, mask, eq, at, dt, total;
  int ld0, ld1, ld2;   // row strides (bytes) of w0t, w1t, w2t
  int lx, l1, l2;      // row strides (bytes) of xp, a1, a2: K up to 4
  int lt;              // row stride (bytes) of at and the int8 dt
};

__host__ __device__ inline Layout make_layout(int S, int din, int h1, int h2,
                                              int dout) {
  const int hmax = imax(h1, h2), amax = imax(din, hmax);
  const int dmax = imax(hmax, dout);
  Layout L;
  L.ld0 = odd_row(din);
  L.ld1 = odd_row(h1);
  L.ld2 = odd_row(h2);
  L.lx = up4(din);
  L.l1 = up4(h1);
  L.l2 = up4(h2);
  L.lt = odd_row(S);
  int o = 0;
  L.w0r = take(o, din * h1 + 6);
  L.w1r = take(o, h1 * h2 + 6);
  L.w2r = take(o, h2 * dout + 6);
  L.f1r = take(o, dout * h1 + 6);
  L.f2r = take(o, dout * h2 + 6);
  L.b0 = take(o, 4 * h1);
  L.b1 = take(o, 4 * h2);
  L.b2 = take(o, 4 * dout);
  L.d0 = take(o, 4 * din * h1);
  L.d1 = take(o, 4 * h1 * h2);
  L.d2 = take(o, 4 * h2 * dout);
  L.w0t = take(o, h1 * L.ld0);
  L.w1t = take(o, h2 * L.ld1);
  L.w2t = take(o, dout * L.ld2);
  L.lossw = take(o, 8 * kWarps);
  L.xr = take(o, S * din + 6);
  L.y = take(o, 4 * S * dout);
  L.xp = take(o, S * L.lx);
  L.a1 = take(o, S * L.l1);
  L.a2 = take(o, S * L.l2);
  L.mask = take(o, S * hmax);
  L.eq = take(o, 4 * S * dout);
  L.at = take(o, amax * L.lt);
  L.dt = take(o, imax(dmax * L.lt, 4 * dmax * S));
  L.total = o;
  return L;
}

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One warp starts copying the global bytes [src, src + n) to shared
// address dst (16-byte aligned): 16-byte copies where src and n are
// multiples of 16, else the 4-byte words that cover the range (see
// offset4). A word that holds a byte of the operand lies in the operand's
// own pages, so the read is safe; the bytes of the neighbours it brings
// are never used.
__device__ __forceinline__ void stage(unsigned dst, const void* src, int n,
                                      int lane) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const unsigned char* s = static_cast<const unsigned char*>(src);
  if (((a | static_cast<uintptr_t>(n)) & 15) == 0) {
    for (int k = lane; k < n / 16; k += 32) cp_async16(dst + 16 * k, s + 16 * k);
  } else {
    const int head = static_cast<int>(a & 3);
    for (int k = lane; k < (head + n + 3) >> 2; k += 32)
      cp_async4(dst + 4 * k, s - head + 4 * k);
  }
}

// where stage() puts the first byte of src: its offset in its word
__device__ __forceinline__ int offset4(const void* src) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(src) & 3);
}

// dst[c * ld + r] = src[r * C + c] for r < R, zero for R <= r < ld. With
// 32 columns or more, lanes take the columns and warps the rows; else each
// thread takes rows whole. No division either way.
__device__ __forceinline__ void transpose(int8_t* dst, const int8_t* src,
                                          int R, int C, int ld, int lane,
                                          int warp) {
  if (C >= 32) {
    for (int c = lane; c < C; c += 32)
      for (int r = warp; r < ld; r += kWarps)
        dst[c * ld + r] = r < R ? src[r * C + c] : 0;
  } else {
    for (int r = warp * 32 + lane; r < ld; r += kThreads)
      for (int c = 0; c < C; ++c) dst[c * ld + r] = r < R ? src[r * C + c] : 0;
  }
}

// One warp stores n bytes from shared memory to global memory, 16 at a
// time where both addresses and n allow.
__device__ __forceinline__ void copy_out(void* dst, const void* src, int n,
                                         int lane) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  if (((a | s | static_cast<uintptr_t>(n)) & 15) == 0) {
    for (int k = lane; k < n / 16; k += 32)
      static_cast<uint4*>(dst)[k] = static_cast<const uint4*>(src)[k];
  } else {
    for (int k = lane; k < n; k += 32)
      static_cast<unsigned char*>(dst)[k] =
          static_cast<const unsigned char*>(src)[k];
  }
}

// uint7 activation requant: clip(round(max(z, 0) * f), 0, 127)
__device__ __forceinline__ int8_t requant_act(int z, float f) {
  const float r = rintf(__fmul_rn(__int2float_rn(z > 0 ? z : 0), f));
  return static_cast<int8_t>(__float2int_rn(fminf(fmaxf(r, 0.0f), kInt8Max)));
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// Stochastic-rounding update of the A x H layer this slot trains,
// w - floor(g ftw + u) with g = a^T d, and its bias b - round(sum_s d ftb).
__device__ __forceinline__ void update_layer(
    int A, int H, int S, int lt, bool d8, const int8_t* at,
    const int8_t* dt8, const int32_t* dt32, const int8_t* w,
    const int32_t* bias, const float* dith, float ftw, float ftb,
    int8_t* wout, int32_t* bout) {
  const int sw = (S + 3) / 4, lt4 = lt / 4;
  const int* atw = reinterpret_cast<const int*>(at);
  const int* dtw = reinterpret_cast<const int*>(dt8);
  for (int idx = threadIdx.x; idx < A * H; idx += kThreads) {
    const int i = idx / H, j = idx - i * H;
    int g = 0;
    if (d8) {
      for (int q = 0; q < sw; ++q) g = __dp4a(atw[i * lt4 + q], dtw[j * lt4 + q], g);
    } else {
      for (int s = 0; s < S; ++s) g += int(at[i * lt + s]) * dt32[j * S + s];
    }
    const float v = __fadd_rn(__fmul_rn(__int2float_rn(g), ftw), dith[idx]);
    const float wn = __fsub_rn(static_cast<float>(w[idx]), floorf(v));
    wout[idx] = static_cast<int8_t>(__float2int_rn(clampf(wn, -kInt8Max, kInt8Max)));
  }
  for (int j = threadIdx.x; j < H; j += kThreads) {
    int dsum = 0;
    if (d8) {
      for (int q = 0; q < sw; ++q) dsum = __dp4a(dtw[j * lt4 + q], 0x01010101, dsum);
    } else {
      for (int s = 0; s < S; ++s) dsum += dt32[j * S + s];
    }
    const float step = rintf(__fmul_rn(__int2float_rn(dsum), ftb));
    const float bn = __fsub_rn(__int2float_rn(bias[j]), step);
    bout[j] = __float2int_rn(clampf(bn, -kBiasMax, kBiasMax));
  }
}

// kS, kDin, kH1, kH2, kDout: S and the dims as compile-time constants, or
// 0 to read them from D
template <int kS, int kDin, int kH1, int kH2, int kDout>
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
  const int S = kS ? kS : D.S;
  const int din = kDin ? kDin : D.din, h1 = kH1 ? kH1 : D.h1;
  const int h2 = kH2 ? kH2 : D.h2, dout = kDout ? kDout : D.dout;
  const Layout L = make_layout(S, din, h1, h2, dout);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t b = blockIdx.x;
  const int8_t* gw0 = w0 + b * din * h1;
  const int8_t* gw1 = w1 + b * h1 * h2;
  const int8_t* gw2 = w2 + b * h2 * dout;
  const int8_t* gx = xq + b * S * din;

  // ---- staging: one warp or two an operand, all at once, one wait ----------
  const unsigned sb = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  switch (warp) {
    case 0: stage(sb + L.w1r, gw1, h1 * h2, lane); break;
    case 2:
      stage(sb + L.w0r, gw0, din * h1, lane);
      stage(sb + L.w2r, gw2, h2 * dout, lane);
      break;
    case 3:
      stage(sb + L.xr, gx, S * din, lane);
      stage(sb + L.y, yal + b * S * dout, 4 * S * dout, lane);
      break;
    case 4:
      stage(sb + L.f1r, fb1, dout * h1, lane);
      stage(sb + L.f2r, fb2, dout * h2, lane);
      break;
    case 5:
      stage(sb + L.b0, b0 + b * h1, 4 * h1, lane);
      stage(sb + L.b1, b1 + b * h2, 4 * h2, lane);
      stage(sb + L.b2, b2 + b * dout, 4 * dout, lane);
      break;
    default: break;
  }
  cp_async_commit();
  switch (warp) {  // the dither planes, all three: no wait for `layer` first
    case 1: stage(sb + L.d1, dith1 + b * h1 * h2, 4 * h1 * h2, lane); break;
    case 6:
      stage(sb + L.d0, dith0 + b * din * h1, 4 * din * h1, lane);
      stage(sb + L.d2, dith2 + b * h2 * dout, 4 * h2 * dout, lane);
      break;
    default: break;
  }
  cp_async_commit();
  // read once the copies are under way
  const int layer = min(max(__ldg(layers + b), 0), 2);  // lax.switch clamps too
  const float f0 = __ldg(scales + 0), f1 = __ldg(scales + 1);
  const float fe = __ldg(scales + 2);
  const float ftw = __ldg(scales + 4 + layer), ftb = __ldg(scales + 7 + layer);
  // the int8 delta: always for the output error, for a hidden delta when
  // dout = 1 (|d| <= round(127 * 127 / 128) = 126)
  const bool d8 = layer == 2 || dout == 1;
  // the layer this slot trains: A x H weights
  const int A = layer == 0 ? din : (layer == 1 ? h1 : h2);
  const int H = layer == 0 ? h1 : (layer == 1 ? h2 : dout);

  const int8_t* W0 = reinterpret_cast<const int8_t*>(smem + L.w0r) + offset4(gw0);
  const int8_t* W1 = reinterpret_cast<const int8_t*>(smem + L.w1r) + offset4(gw1);
  const int8_t* W2 = reinterpret_cast<const int8_t*>(smem + L.w2r) + offset4(gw2);
  const int8_t* X = reinterpret_cast<const int8_t*>(smem + L.xr) + offset4(gx);
  const int8_t* F1 = reinterpret_cast<const int8_t*>(smem + L.f1r) + offset4(fb1);
  const int8_t* F2 = reinterpret_cast<const int8_t*>(smem + L.f2r) + offset4(fb2);
  const int32_t* B0 = reinterpret_cast<const int32_t*>(smem + L.b0);
  const int32_t* B1 = reinterpret_cast<const int32_t*>(smem + L.b1);
  const int32_t* B2 = reinterpret_cast<const int32_t*>(smem + L.b2);
  const int32_t* Y = reinterpret_cast<const int32_t*>(smem + L.y);
  int8_t* w0t = reinterpret_cast<int8_t*>(smem + L.w0t);
  int8_t* w1t = reinterpret_cast<int8_t*>(smem + L.w1t);
  int8_t* w2t = reinterpret_cast<int8_t*>(smem + L.w2t);
  int8_t* xp = reinterpret_cast<int8_t*>(smem + L.xp);
  int8_t* a1 = reinterpret_cast<int8_t*>(smem + L.a1);
  int8_t* a2 = reinterpret_cast<int8_t*>(smem + L.a2);
  int8_t* mask = reinterpret_cast<int8_t*>(smem + L.mask);
  int32_t* eq = reinterpret_cast<int32_t*>(smem + L.eq);
  int8_t* at = reinterpret_cast<int8_t*>(smem + L.at);
  int8_t* dt8 = reinterpret_cast<int8_t*>(smem + L.dt);
  int32_t* dt32 = reinterpret_cast<int32_t*>(smem + L.dt);
  long long* lossw = reinterpret_cast<long long*>(smem + L.lossw);
  const int lt = L.lt;

  cp_async_wait<1>();
  __syncthreads();

  // ---- transposes and zero padding; the layers not trained pass through -----
  transpose(w1t, W1, h1, h2, L.ld1, lane, warp);
  transpose(w0t, W0, din, h1, L.ld0, lane, warp);
  transpose(w2t, W2, h2, dout, L.ld2, lane, warp);
  // x's rows padded to whole words: a thread a row, a word at a time
  for (int s = tid; s < S; s += kThreads)
    for (int q = 0; q < L.lx / 4; ++q) {
      unsigned word = 0;
      for (int t = 0; t < 4; ++t)
        if (4 * q + t < din)
          word |= static_cast<unsigned>(static_cast<uint8_t>(X[s * din + 4 * q + t])) << (8 * t);
      reinterpret_cast<unsigned*>(xp)[s * (L.lx / 4) + q] = word;
    }
  // the update's input at[i][s]: x itself for layer 0 (transpose() again);
  // the forward fills it for layers 1 and 2. The dp4a over s reads whole
  // words, so the bytes past S in the last one must be zero.
  if (layer == 0) transpose(at, X, S, din, lt, lane, warp);
  if ((S & 3) != 0) {
    for (int r = tid; r < imax(A, H); r += kThreads)
      for (int s = S; s < up4(S); ++s) {
        if (layer != 0 && r < A) at[r * lt + s] = 0;
        if (d8 && r < H) dt8[r * lt + s] = 0;
      }
  }
  switch (warp) {
    case 4: if (layer != 1) copy_out(ow1 + b * h1 * h2, W1, h1 * h2, lane); break;
    case 5:
      if (layer != 0) {
        copy_out(ow0 + b * din * h1, W0, din * h1, lane);
        copy_out(ob0 + b * h1, B0, 4 * h1, lane);
      }
      break;
    case 6: if (layer != 1) copy_out(ob1 + b * h2, B1, 4 * h2, lane); break;
    case 7:
      if (layer != 2) {
        copy_out(ow2 + b * h2 * dout, W2, h2 * dout, lane);
        copy_out(ob2 + b * dout, B2, 4 * dout, lane);
      }
      break;
    default: break;
  }
  __syncthreads();

  // ---- forward, error, loss and delta: a warp owns whole samples ------------
  // P lanes a sample: the widest layer, up to a power of two from 4 to 32
  const int wide = imax(L.l1, L.l2);
  const int P = wide > 16 ? 32 : (wide > 8 ? 16 : (wide > 4 ? 8 : 4));
  const int per_warp = 32 / P, sub = lane / P, c = lane & (P - 1);
  const int lx4 = L.lx / 4, l14 = L.l1 / 4, l24 = L.l2 / 4;
  const int ld04 = L.ld0 / 4, ld14 = L.ld1 / 4, ld24 = L.ld2 / 4;
  const int* xpw = reinterpret_cast<const int*>(xp);
  const int* a1w = reinterpret_cast<const int*>(a1);
  const int* a2w = reinterpret_cast<const int*>(a2);
  const int* w0w = reinterpret_cast<const int*>(w0t);
  const int* w1w = reinterpret_cast<const int*>(w1t);
  const int* w2w = reinterpret_cast<const int*>(w2t);
  long long lsum = 0;
  for (int first = warp * per_warp; first < S; first += kWarps * per_warp) {
    const int s = first + sub;
    const bool live = s < S;
    // layer 0: z0 = x w0 + b0; the mask z0 > 0 if layer 0 trains
    if (live) {
      for (int j = c; j < L.l1; j += P) {
        int8_t a = 0;
        if (j < h1) {
          int z = B0[j];
          for (int q = 0; q < lx4; ++q)
            z = __dp4a(xpw[s * lx4 + q], w0w[j * ld04 + q], z);
          a = requant_act(z, f0);
          if (layer == 0) mask[s * h1 + j] = z > 0;
          if (layer == 1) at[j * lt + s] = a;
        }
        a1[s * L.l1 + j] = a;
      }
    }
    __syncwarp();
    // layer 1
    if (live) {
      for (int k = c; k < L.l2; k += P) {
        int8_t a = 0;
        if (k < h2) {
          int z = B1[k];
          for (int q = 0; q < l14; ++q)
            z = __dp4a(a1w[s * l14 + q], w1w[k * ld14 + q], z);
          a = requant_act(z, f1);
          if (layer == 1) mask[s * h2 + k] = z > 0;
          if (layer == 2) at[k * lt + s] = a;
        }
        a2[s * L.l2 + k] = a;
      }
    }
    __syncwarp();
    // output layer, error, quantized error, loss: a reduction over P lanes
    for (int o = 0; o < dout; ++o) {
      int part = 0;
      if (live)
        for (int q = c; q < l24; q += P)
          part = __dp4a(a2w[s * l24 + q], w2w[o * ld24 + q], part);
      if (P == 32) {
        part = __reduce_add_sync(kFull, part);
      } else {
        for (int off = P / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(kFull, part, off);
      }
      if (live && c == 0) {
        const int e = part + B2[o] - Y[s * dout + o];
        const float qe = rintf(__fmul_rn(__int2float_rn(e), fe));
        const int eqv = __float2int_rn(clampf(qe, -kInt8Max, kInt8Max));
        eq[s * dout + o] = eqv;
        if (layer == 2) dt8[o * lt + s] = static_cast<int8_t>(eqv);
        lsum += static_cast<long long>(e) * e;
      }
    }
    __syncwarp();
    // DFA delta of a hidden layer: d = round(where(z > 0, eq fb, 0) * 2^-7)
    if (live && layer < 2) {
      const int8_t* F = layer == 0 ? F1 : F2;
      for (int j = c; j < H; j += P) {
        int d = 0;
        if (mask[s * H + j]) {
          int p = 0;
          for (int o = 0; o < dout; ++o) p += eq[s * dout + o] * int(F[o * H + j]);
          d = __float2int_rn(rintf(__fmul_rn(__int2float_rn(p), kDfaScale)));
        }
        if (d8) dt8[j * lt + s] = static_cast<int8_t>(d);
        else dt32[j * S + s] = d;
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) lsum += __shfl_xor_sync(kFull, lsum, off);
  if (lane == 0) lossw[warp] = lsum;
  cp_async_wait<0>();
  __syncthreads();

  // ---- stochastic-rounding update of the trained layer; the loss ------------
  if (layer == 0) {
    update_layer(din, h1, S, lt, d8, at, dt8, dt32, W0, B0,
                 reinterpret_cast<const float*>(smem + L.d0), ftw, ftb,
                 ow0 + b * din * h1, ob0 + b * h1);
  } else if (layer == 1) {
    update_layer(h1, h2, S, lt, d8, at, dt8, dt32, W1, B1,
                 reinterpret_cast<const float*>(smem + L.d1), ftw, ftb,
                 ow1 + b * h1 * h2, ob1 + b * h2);
  } else {
    update_layer(h2, dout, S, lt, d8, at, dt8, dt32, W2, B2,
                 reinterpret_cast<const float*>(smem + L.d2), ftw, ftb,
                 ow2 + b * h2 * dout, ob2 + b * dout);
  }
  if (tid == 0) {
    long long t = 0;
    for (int w = 0; w < kWarps; ++w) t += lossw[w];
    loss[b] = static_cast<float>(static_cast<double>(t) *
                                 static_cast<double>(__ldg(scales + 3)));
  }
}

using Kernel = decltype(&dfa_epoch_int8_kernel<0, 0, 0, 0, 0>);

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs for these dims (bytes); SIZE_MAX for
// dims past what the kernel's int arithmetic takes.
size_t dfa_epoch_int8_smem_bytes(int S, int din, int h1, int h2, int dout) {
  if (S < 1 || din < 1 || h1 < 1 || h2 < 1 || dout < 1 ||
      static_cast<long long>(S) * imax(imax(din, h1), imax(h2, dout)) > (1 << 24) ||
      static_cast<long long>(imax(din, h2)) * imax(h1, dout) > (1 << 24)) {
    return SIZE_MAX;
  }
  return static_cast<size_t>(make_layout(S, din, h1, h2, dout).total);
}

// The operands, then the outputs w0', w1', w2', b0', b1', b2' and loss:
// the interface of the first version of this kernel, kept so that
// kernels/time_dfa_epoch.py can time an older source beside this one.
// `specialized` picks a compile-time instantiation where one matches.
static int launch(bool specialized, const void* xq, const void* yal,
                  const void* w0, const void* w1, const void* w2,
                  const void* b0, const void* b1, const void* b2,
                  const void* fb1, const void* fb2, const void* dith0,
                  const void* dith1, const void* dith2, const void* scales,
                  const void* layers, void* ow0, void* ow1, void* ow2,
                  void* ob0, void* ob1, void* ob2, void* loss, int B, int S,
                  int din, int h1, int h2, int dout, void* stream) {
  const size_t smem = dfa_epoch_int8_smem_bytes(S, din, h1, h2, dout);
  if (B < 1 || smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  // the sine MLP at the serving tick's support of 8 and the engine's 32
  const bool sine = din == 1 && h1 == 32 && h2 == 32 && dout == 1;
  Kernel kernel = dfa_epoch_int8_kernel<0, 0, 0, 0, 0>;
  if (specialized && sine && S == 8) {
    kernel = dfa_epoch_int8_kernel<8, 1, 32, 32, 1>;
  } else if (specialized && sine && S == 32) {
    kernel = dfa_epoch_int8_kernel<32, 1, 32, 32, 1>;
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
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
      static_cast<int32_t*>(ob2), static_cast<float*>(loss),
      Dims{S, din, h1, h2, dout});
  return static_cast<int>(cudaGetLastError());
}

int dfa_epoch_int8_launch(
    const void* xq, const void* yal, const void* w0, const void* w1,
    const void* w2, const void* b0, const void* b1, const void* b2,
    const void* fb1, const void* fb2, const void* dith0, const void* dith1,
    const void* dith2, const void* scales, const void* layers, void* ow0,
    void* ow1, void* ow2, void* ob0, void* ob1, void* ob2, void* loss,
    int B, int S, int din, int h1, int h2, int dout, void* stream) {
  return launch(true, xq, yal, w0, w1, w2, b0, b1, b2, fb1, fb2, dith0, dith1,
                dith2, scales, layers, ow0, ow1, ow2, ob0, ob1, ob2, loss, B,
                S, din, h1, h2, dout, stream);
}

// The same, always through the generic instantiation.
int dfa_epoch_int8_launch_generic(
    const void* xq, const void* yal, const void* w0, const void* w1,
    const void* w2, const void* b0, const void* b1, const void* b2,
    const void* fb1, const void* fb2, const void* dith0, const void* dith1,
    const void* dith2, const void* scales, const void* layers, void* ow0,
    void* ow1, void* ow2, void* ob0, void* ob1, void* ob2, void* loss,
    int B, int S, int din, int h1, int h2, int dout, void* stream) {
  return launch(false, xq, yal, w0, w1, w2, b0, b1, b2, fb1, fb2, dith0,
                dith1, dith2, scales, layers, ow0, ow1, ow2, ob0, ob1, ob2,
                loss, B, S, din, h1, h2, dout, stream);
}

}  // extern "C"
