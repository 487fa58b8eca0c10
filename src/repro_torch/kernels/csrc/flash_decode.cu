// Single-token GQA attention over a KV cache (flash-decoding) on Hopper.
//
// Replaces the TPU kernel repro/kernels/flash_decode.py::flash_decode
// (_flash_decode_kernel). For batch row b and query head h = kv R + r
// (R = H / Kv query heads share KV head kv):
//
//   out[b,h,:] = sum_p softmax_p(hd^-0.5 q[b,h,:].k[b,p,kv,:]) v[b,p,kv,:]
//
// over the positions p in [lo, hi) = [max(0, L - window), L), or [0, L)
// without a window. q is cast to fp32 and scaled in fp32, K and V are read
// in their own dtype (fp32 or bf16, the same as q's) and everything is
// accumulated in fp32; the result is stored in q's dtype. Positions outside
// [lo, hi) are never read: with L >= 1 they add exactly 0 to the TPU
// kernel's sums too (exp(-1e30 - m) underflows), so the cache's tail need
// not be zero. The wrapper rejects L = 0 (the TPU kernel's degenerate mean
// of V), as decode never passes it.
//
// Design. The TPU grid (B, Kv, S / block) walks the cache blocks in order
// with the running max, denominator and accumulator in VMEM. Here:
//  - GQA reuse: one block owns a (b, kv) pair and up to kRows = 8 of its R
//    query heads, so each K and V row is read from device memory once for
//    all of them (R > 8 takes ceil(R / 8) head groups);
//  - a split over the KV axis (flash-decoding): the grid is (n_split,
//    Kv * groups, B), and each block runs the online softmax over its own
//    stretch of positions. With one split the block writes the output;
//    otherwise it writes its partial (m, l, acc) to a workspace and a
//    second small kernel combines the splits. The wrapper picks n_split
//    so that some 528 blocks (four per SM) are in flight: at batch 8 and
//    Kv 4, (b, kv) alone would be 32 blocks on 132 SMs.
// A block of 128 threads walks its stretch in tiles of 32 positions: the
// tile's K and V rows are loaded with 16-byte vector loads into registers
// (the next tile's while the current one is computed) and stored to
// shared memory as fp32, rows padded by one float so the score loop has
// no bank conflicts; each warp owns query rows and computes one position per
// lane, then the tile's max and sum by warp shuffles; each thread then
// owns one (row, dim) output per pass and accumulates P V from shared
// memory, rescaled by exp(m_old - m_new). No tensor cores: one query
// token gives R = 8 rows, and the products stay in fp32 as the TPU
// kernel's do. The design is the simple one; it runs well above its bound
// and above PyTorch's fused attention (PERF.md), and its redesign is
// queued in ROADMAP.
//
// Bound on an H100: the K and V bytes, 2 B n Kv hd elem with n = hi - lo.
// At the decode path's (B, H, Kv, hd) = (8, 32, 4, 64) in bf16 with n =
// 2048 that is 16.8 MB, 5.0 us at 3.35 TB/s; its 4 B H n hd = 134 MFLOP
// are far below that. chip_smoke.py prints the bound of every case.
//
// Limits, checked by the Python wrapper too: hd in {64, 128}; fp32 or
// bf16, the same for q, K and V; contiguous tensors, the caches 16-byte
// aligned.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;          // positions per tile: one per lane
constexpr int kRows = 8;           // query heads per block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxCombineWarps = 4;  // the combine runs hd <= 128 threads

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// One 16-byte vector of T, unpacked to floats.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float* dst) {
    dst[0] = __uint_as_float(v.x);
    dst[1] = __uint_as_float(v.y);
    dst[2] = __uint_as_float(v.z);
    dst[3] = __uint_as_float(v.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void unpack(const uint4& v, float* dst) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
};

// q (B, H, HD), k and v (B, S, Kv, HD), out (B, H, HD); ws: the partials
// of every split, acc (n_split, B, H, HD) then m and l (n_split, B, H).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_decode_split(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out,
                   float* __restrict__ ws, int S, int H, int Kv, int R,
                   int lo, int hi, int chunk, float scale) {
  constexpr int KP = HD + 1;                   // padded shared row
  constexpr int EPV = Vec<T>::kN;              // elements per vector load
  constexpr int VPR = HD / EPV;                // vector loads per row
  constexpr int RSTEP = kThreads / HD;         // output rows per pass
  constexpr int ACC = (kRows + RSTEP - 1) / RSTEP;
  constexpr int RPW = (kRows + kWarps - 1) / kWarps;  // score rows per warp

  __shared__ float sK[kTile * KP];
  __shared__ float sV[kTile * KP];
  __shared__ float sQ[kRows * HD];
  __shared__ float sP[kRows * kTile];
  __shared__ float sCorr[kRows];
  __shared__ float sL[kRows];

  const int G = (R + kRows - 1) / kRows;       // head groups per KV head
  const int kv = blockIdx.y / G, g = blockIdx.y % G;
  const int b = blockIdx.z, B = gridDim.z;
  const int split = blockIdx.x, n_split = gridDim.x;
  const int h0 = kv * R + g * kRows;
  const int nr = min(kRows, R - g * kRows);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int d_own = t % HD, r_own = t / HD;

  const int p_begin = lo + split * chunk;
  const int p_end = min(hi, p_begin + chunk);

  for (int e = t; e < kRows * HD; e += kThreads) {
    const int r = e / HD;
    sQ[e] = r < nr ? to_f32(q[((long long)b * H + h0 + r) * HD + e % HD]) *
                         scale
                   : 0.f;
  }
  float m[RPW], l[RPW], acc[ACC];
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  const long long row = (long long)Kv * HD;    // elements between positions
  const T* kb = k + ((long long)b * S * Kv + kv) * HD;
  const T* vb = v + ((long long)b * S * Kv + kv) * HD;

  // each thread's share of one tile's K and V rows, as raw 16-byte
  // vectors (zero past the stretch): the next tile's loads are issued
  // before the current tile's arithmetic, so they are in flight during it
  constexpr int LPT = (kTile * VPR + kThreads - 1) / kThreads;
  uint4 rk[LPT], rv[LPT];
  auto fetch = [&](int p0) {
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int e = t + i * kThreads, r = e / VPR, c = e % VPR;
      rk[i] = rv[i] = make_uint4(0u, 0u, 0u, 0u);
      if (e < kTile * VPR && p0 + r < p_end) {
        rk[i] = *reinterpret_cast<const uint4*>(kb + (p0 + r) * row + c * EPV);
        rv[i] = *reinterpret_cast<const uint4*>(vb + (p0 + r) * row + c * EPV);
      }
    }
  };

  if (p_begin < p_end) fetch(p_begin);
  for (int p0 = p_begin; p0 < p_end; p0 += kTile) {
    __syncthreads();                           // the last tile is consumed
#pragma unroll
    for (int i = 0; i < LPT; ++i) {
      const int e = t + i * kThreads, r = e / VPR, c = e % VPR;
      if (e < kTile * VPR) {
        float fk[EPV], fv[EPV];
        Vec<T>::unpack(rk[i], fk);
        Vec<T>::unpack(rv[i], fv);
#pragma unroll
        for (int j = 0; j < EPV; ++j) {
          sK[r * KP + c * EPV + j] = fk[j];
          sV[r * KP + c * EPV + j] = fv[j];
        }
      }
    }
    __syncthreads();
    if (p0 + kTile < p_end) fetch(p0 + kTile);

    // scores and the online softmax: warp w owns rows w, w + 4, ...; lane
    // = position in the tile. m and l live in the owning warp's registers
    // (equal in every lane); the rescale factor goes to shared memory.
    const bool ok = p0 + lane < p_end;
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const int r = warp + j * kWarps;
      if (r < nr) {
        float s = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d)
          s = fmaf(sQ[r * HD + d], sK[lane * KP + d], s);
        float mx = ok ? s : -INFINITY;
#pragma unroll
        for (int o = 16; o; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
        const float m_new = fmaxf(m[j], mx);
        const float p = ok ? expf(s - m_new) : 0.f;
        float sum = p;
#pragma unroll
        for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
        const float corr = expf(m[j] - m_new);  // 0 on the first tile
        l[j] = l[j] * corr + sum;
        m[j] = m_new;
        sP[r * kTile + lane] = p;
        if (lane == 0) sCorr[r] = corr;
      }
    }
    __syncthreads();

    // acc[row, d] = acc * corr + P[row, :] V[:, d] (padded positions have
    // P = 0 and V = 0)
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int r = r_own + i * RSTEP;
      if (r < nr) {
        float a = acc[i] * sCorr[r];
#pragma unroll
        for (int j = 0; j < kTile; ++j)
          a = fmaf(sP[r * kTile + j], sV[j * KP + d_own], a);
        acc[i] = a;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int r = warp + j * kWarps;
    if (r < nr && lane == 0) sL[r] = l[j];
  }
  __syncthreads();
  const long long BH = (long long)B * H;
  if (n_split == 1) {
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int r = r_own + i * RSTEP;
      if (r < nr)
        store(out + ((long long)b * H + h0 + r) * HD + d_own,
              acc[i] / fmaxf(sL[r], 1e-30f));
    }
    return;
  }
  // this split's partials: acc, then l beside it and m from the warp
  // that owns the row
  const long long base = split * BH + (long long)b * H + h0;
  float* ws_m = ws + (long long)n_split * BH * HD;
  float* ws_l = ws_m + (long long)n_split * BH;
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int r = r_own + i * RSTEP;
    if (r < nr) {
      ws[(base + r) * HD + d_own] = acc[i];
      if (d_own == 0) ws_l[base + r] = sL[r];
    }
  }
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int r = warp + j * kWarps;
    if (r < nr && lane == 0) ws_m[base + r] = m[j];
  }
}

// One block per (b, h), one thread per dim: the splits' partials merged
// as out = sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-30).
// The weights e^(m_s - M) go to shared memory first, so the loop over the
// splits issues independent loads rather than a chain of them.
template <typename T>
__global__ void flash_decode_combine(const float* __restrict__ ws,
                                     T* __restrict__ out, int BH, int HD,
                                     int n_split) {
  extern __shared__ float sw[];                // (n_split,) then (n_split,)
  float* swl = sw + n_split;
  __shared__ float red[kMaxCombineWarps];
  const int bh = blockIdx.x, d = threadIdx.x, nw = blockDim.x / 32;
  const float* ws_m = ws + (long long)n_split * BH * HD;
  const float* ws_l = ws_m + (long long)n_split * BH;
  float mx = -INFINITY;
  for (int s = d; s < n_split; s += blockDim.x)
    mx = fmaxf(mx, sw[s] = ws_m[(long long)s * BH + bh]);
#pragma unroll
  for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
  if (d % 32 == 0) red[d / 32] = mx;
  __syncthreads();
  float M = red[0];
  for (int w = 1; w < nw; ++w) M = fmaxf(M, red[w]);
  for (int s = d; s < n_split; s += blockDim.x) {
    sw[s] = expf(sw[s] - M);
    swl[s] = sw[s] * ws_l[(long long)s * BH + bh];
  }
  __syncthreads();
  float num = 0.f, den = 0.f;
  const float* acc = ws + (long long)bh * HD + d;
#pragma unroll 8
  for (int s = 0; s < n_split; ++s) {
    num = fmaf(sw[s], acc[(long long)s * BH * HD], num);
    den += swl[s];
  }
  store(out + (long long)bh * HD + d, num / fmaxf(den, 1e-30f));
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, void* ws,
           int B, int S, int H, int Kv, int lo, int hi, int chunk,
           int n_split, float scale, cudaStream_t stream) {
  const int R = H / Kv;
  const int G = (R + kRows - 1) / kRows;
  dim3 grid((unsigned)n_split, (unsigned)(Kv * G), (unsigned)B);
  flash_decode_split<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(ws), S, H, Kv, R, lo, hi, chunk, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  flash_decode_combine<T><<<(unsigned)(B * H), HD,
                            2 * n_split * sizeof(float), stream>>>(
      static_cast<const float*>(ws), static_cast<T*>(out), B * H, HD,
      n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int by_hd(int hd, const void* q, const void* k, const void* v, void* out,
          void* ws, int B, int S, int H, int Kv, int lo, int hi, int chunk,
          int n_split, float scale, cudaStream_t stream) {
  if (hd == 64)
    return launch<T, 64>(q, k, v, out, ws, B, S, H, Kv, lo, hi, chunk,
                         n_split, scale, stream);
  if (hd == 128)
    return launch<T, 128>(q, k, v, out, ws, B, S, H, Kv, lo, hi, chunk,
                          n_split, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B,H,hd), k and v (B,S,Kv,hd), out (B,H,hd): contiguous on the device,
// fp32 (dtype 0) or bf16 (dtype 1). Positions [lo, hi) are attended, in
// n_split stretches of `chunk` positions (a multiple of 32; every stretch
// non-empty); up to 8 query heads per block. ws holds
// n_split * B * H * (hd + 2) floats when n_split > 1, else may be null.
// Returns the cudaError_t of the launches.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, void* out, void* ws,
                                   int dtype, int B, int S, int H, int Kv,
                                   int hd, int lo, int hi, int chunk,
                                   int n_split, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Kv <= 0 || H % Kv != 0 || lo < 0 || hi > S ||
      lo >= hi || chunk <= 0 || chunk % kTile != 0 || n_split <= 0 ||
      (long long)(n_split - 1) * chunk >= hi - lo ||
      (n_split > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_hd<float>(hd, q, k, v, out, ws, B, S, H, Kv, lo, hi, chunk,
                        n_split, scale, s);
  if (dtype == 1)
    return by_hd<__nv_bfloat16>(hd, q, k, v, out, ws, B, S, H, Kv, lo, hi,
                                chunk, n_split, scale, s);
  return (int)cudaErrorInvalidValue;
}
