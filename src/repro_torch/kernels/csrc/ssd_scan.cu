// Chunked Mamba2 SSD (state-space duality) forward scan on Hopper.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan
// (_ssd_kernel). For each (batch b, head h) and each chunk c of Q steps:
//
//   cs      = cumsum(dA[b,h,c,:])                         (Q,)
//   L[i,j]  = exp(cs[i] - cs[j]) for i >= j, else 0         (Q, Q)
//   y[i,:]  = sum_j (C[i,:].B[j,:]) L[i,j] xd[j,:]          in-chunk term
//           + exp(cs[i]) C[i,:] S_in^T                      carried state
//   S_in    = the (P, N) state entering chunk c: zero before chunk 0, then
//             S_in[c+1] = S_in[c] exp(cs[Q-1]) + S_c with
//             S_c = xd^T (B o exp(cs[Q-1] - cs))             this chunk's
//
// B and C are shared by all heads (ngroups = 1: indexed by (b, c), never
// by h). Inputs and outputs are fp32, and so is every product: plain TF32
// keeps 10 bits of mantissa, some 5e-4 relative a product, where the
// plain version holds the scan at 2e-4 with outputs up to about 25 summed
// over 256 steps. So the tensor cores run 3xTF32: each operand is split
// into a TF32 high part and a TF32 residual, and a b = a_hi b_hi + a_hi
// b_lo + a_lo b_hi (the dropped a_lo b_lo is some 2^-22 of a b), three
// mma.sync.m16n8k8 with fp32 accumulation; each K tile's sum is added to
// the running one in fp32.
//
// Bound on an H100, at the LM path's shape B=2, H=24, nc=8, Q=256, P=64,
// N=128. L is zero above the diagonal, so the in-chunk products need only
// the Q (Q + 1) / 2 causal pairs: C B^T once per (b, c) is Q (Q + 1) N =
// 0.13 GFLOP in all; the masked product and the two state products are
// Q (Q + 1) P + 4 Q N P per (b, h, c), 4.84 GFLOP: 4.97 GFLOP of fp32
// work. Done as 3xTF32 that is 14.9 GFLOP of TF32 tensor-core work, 30 us
// at 495 TFLOP/s (the same work by FFMA at 67 TFLOP/s fp32 would take
// 74 us). The bytes (xd and y once, B, C and dA once, 55 MB) take 16.4 us
// at 3.35 TB/s, so the scan is bound by operations at 30 us
// (chip_smoke.py's ssd_scan phase prints all three).
//
// Design: the SSD decomposition into three launches on the stream, so
// that no block walks the chunks in order.
//  1. ssd_scan_states: one block per (b, h, c) and strip of 128 state
//     columns n. It takes the cumsum of dA in-block (written to the cs
//     scratch for phases 2 and 3) and this chunk's state, stored
//     transposed as S_c^T (N, P) in the state scratch.
//  2. ssd_scan_pass: elementwise over (b, h, n, p), a loop over the
//     chunks that turns the S_c^T in place into the S_in^T entering each
//     chunk. 12.6 MB of scratch at the path's shape, which stays in L2.
//  3. ssd_scan_outputs: one block per (b, c, 64-row band of the chunk,
//     group of heads), the heaviest bands (most causal columns) first.
//     The block builds C B^T for its band once, in shared memory, and
//     reuses it for every head of its group (see the kernel's note for
//     how the decay L is applied without a per-element exp left of the
//     band).
// The wrapper (ssd_scan.py) allocates the scratch and picks the heads a
// block owns (6 at the path's shape: 256 blocks, where the one-block-per-
// (b, h) kernel this replaces ran 48 in series).
//
// What the old kernel lost, and what this one does about it:
//  - 48 blocks on 132 SMs, each walking 8 chunks: the grid above gives
//    384 blocks to phase 1 and 256 to phase 3, all chunks at once.
//  - C B^T recomputed for every head: once per (b, c, band, head group).
//  - products bound by shared-memory loads: tensor-core fragments, from
//    rows padded so that no fragment load has a bank conflict.
//  - scalar, repeated global loads: tiles arrive by 16-byte cp.async into
//    three-stage rings, two tiles in flight during the current one's
//    math, one barrier a tile; the decays scale operands in registers,
//    never a landed tile; B and C of a band are read once per head
//    group, not per head.
//
// Limits, checked by the Python wrapper too: P <= 64 and P % 4 == 0
// (64 columns a block), N % 4 == 0, and the dynamic shared memory of
// phase 3 within the card's 227 KB per block.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // 8 warps
constexpr int kPMax = 64;          // P: the columns of every product
constexpr int kKT1 = 32;           // rows of a phase-1 K tile
constexpr int kStrip = 128;        // state columns n a phase-1 block owns
constexpr int kBand = 64;          // chunk rows a phase-3 block owns
constexpr int kKT3 = 64;           // rows of a phase-3 K tile
constexpr int kCBCols = 64;        // C B^T columns built per B tile
constexpr int kStages = 3;         // the cp.async rings of K tiles
// row strides of 8 mod 32 words: the B fragments (4 rows x 8 columns a
// load) read without bank conflicts; A fragments (8 rows x 4 columns)
// take strides of 4 mod 32
constexpr int kXS = kPMax + 8;     // xd and state rows (P columns)
constexpr int kBS1 = kStrip + 8;   // phase 1's B rows (a strip of n)
constexpr int kWDS = kBand + 4;    // phase 3's diagonal W square

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// a B fragment (rows fq and fq + 4 of column fg), split
struct BFrag {
  uint32_t h0, h1, l0, l1;
};
__device__ __forceinline__ BFrag b_frag(float b0, float b1) {
  BFrag f;
  split_tf32(b0, f.h0, f.l0);
  split_tf32(b1, f.h1, f.l1);
  return f;
}
// d += A B for one m16n8k8 step in 3xTF32, both operands split
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const BFrag& b) {
  mma_tf32(d, ah, b.h0, b.h1);
  mma_tf32(d, ah, b.l0, b.l1);
  mma_tf32(d, al, b.h0, b.h1);
}
// the A fragment of rows 0 .. 16, columns 0 .. 8 of a row-major tile with
// row stride s, its columns times v[0 .. 8] where v is given, split; lane
// 4 g + q holds rows g and g + 8, columns q and q + 4
__device__ __forceinline__ void a_frag(const float* A, int s, int g, int q,
                                       const float* v, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  const float v0 = v ? v[q] : 1.f, v1 = v ? v[q + 4] : 1.f;
  split_tf32(A[g * s + q] * v0, ah[0], al[0]);
  split_tf32(A[(g + 8) * s + q] * v0, ah[1], al[1]);
  split_tf32(A[g * s + q + 4] * v1, ah[2], al[2]);
  split_tf32(A[(g + 8) * s + q + 4] * v1, ah[3], al[3]);
}
// acc += part, then part = 0: a K tile's sum joins the running one in fp32
template <int M>
__device__ __forceinline__ void promote(float (&acc)[M][4][4],
                                        float (&part)[M][4][4]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[m][nt][k] += part[m][nt][k];
        part[m][nt][k] = 0.f;
      }
}

// cs[i] = dA[0] + ... + dA[i] into shared memory: warp 0, each lane a run
// of consecutive steps, then a shuffle scan of the lanes' totals
__device__ __forceinline__ void chunk_cumsum(const float* dac, float* sCs,
                                             int Q) {
  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= 32) return;
  const int per = (Q + 31) / 32;
  const int lo = min(lane * per, Q);
  const int hi = min(lo + per, Q);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) {
    run += dac[i];
    sCs[i] = run;
  }
  float incl = run;
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  const float offset = incl - run;
  for (int i = lo; i < hi; ++i) sCs[i] += offset;
}

// -- phase 1: each chunk's own state ---------------------------------------

// grid (nc * strips, H, B). st[b,h,c] (N, P) = (B_c o decay)^T xd_c with
// decay[l] = exp(cs[Q-1] - cs[l]); cs[b,h,c] (Q,) the cumsum of dA. Warp
// w owns state rows n0 + wr .. wr + 32 (two mma row tiles) and columns
// wc .. wc + 32 (four mma column tiles); A(n, l) = B[l][n].
__global__ void __launch_bounds__(kThreads)
ssd_scan_states_kernel(const float* __restrict__ xd,
                       const float* __restrict__ dA,
                       const float* __restrict__ Bm, float* __restrict__ st,
                       float* __restrict__ cs, int H, int nc, int Q, int P,
                       int N) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Qp = round_up(Q, 4), QK = round_up(Q, kKT1);
  float* sCs = smem;                        // (Qp,)  cumsum of dA
  float* sDec = sCs + Qp;                   // (QK,)  exp(cs[Q-1] - cs), 0 past Q
  float* sX = sDec + QK;                    // kStages x (kKT1, kXS) xd tiles
  float* sB = sX + kStages * kKT1 * kXS;    // kStages x (kKT1, kBS1) B tiles

  const int strips = (N + kStrip - 1) / kStrip;
  const int c = blockIdx.x / strips, strip = blockIdx.x % strips;
  const int h = blockIdx.y, b = blockIdx.z;
  const int n0 = strip * kStrip, nw = min(kStrip, N - n0);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int wr = 32 * (warp % 4), wc = 32 * (warp / 4);
  const int fg = lane / 4, fq = lane % 4;
  const long long bhc = ((long long)b * H + h) * nc + c;
  const float* xc = xd + bhc * Q * P;
  const float* Bc = Bm + ((long long)b * nc + c) * Q * N + n0;

  chunk_cumsum(dA + bhc * Q, sCs, Q);
  __syncthreads();
  const float cs_last = sCs[Q - 1];
  for (int i = t; i < QK; i += kThreads) {
    sDec[i] = i < Q ? expf(cs_last - sCs[i]) : 0.f;
    if (strip == 0 && i < Q) cs[bhc * Q + i] = sCs[i];
  }

  const int p4 = P / 4, n4 = nw / 4;
  // tile kt's rows kt kKT1 .. of xd and B into its ring slot, zeros past Q
  auto issue = [&](int kt) {
    const int l0 = kt * kKT1, s = kt % kStages;
    for (int e = t; e < kKT1 * 16; e += kThreads) {
      const int r = e / 16, q = e % 16, l = l0 + r;
      if (q < p4)
        cp_async16(sX + (s * kKT1 + r) * kXS + 4 * q,
                   xc + (long long)min(l, Q - 1) * P + 4 * q, l < Q);
    }
    for (int e = t; e < kKT1 * 32; e += kThreads) {
      const int r = e / 32, q = e % 32, l = l0 + r;
      if (q < n4)
        cp_async16(sB + (s * kKT1 + r) * kBS1 + 4 * q,
                   Bc + (long long)min(l, Q - 1) * N + 4 * q, l < Q);
    }
  };

  float acc[2][4][4] = {}, part[2][4][4] = {};
  const int tiles = QK / kKT1;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) issue(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < tiles; ++kt) {
    cp_async_wait<kStages - 2>();        // this thread's copies of tile kt
    __syncthreads();                     // tile kt landed; kt - 1 consumed
    if (kt + kStages - 1 < tiles) issue(kt + kStages - 1);
    cp_async_commit();
    const int s = kt % kStages;
    const float* X = sX + s * kKT1 * kXS;
    const float* Bs = sB + s * kKT1 * kBS1;
    const float* dec = sDec + kt * kKT1;   // the decay scales xd's rows
#pragma unroll
    for (int kk = 0; kk < kKT1; kk += 8) {
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float* Ab = Bs + (kk + fq) * kBS1 + wr + 16 * m + fg;
        split_tf32(Ab[0], ah[m][0], al[m][0]);
        split_tf32(Ab[8], ah[m][1], al[m][1]);
        split_tf32(Ab[4 * kBS1], ah[m][2], al[m][2]);
        split_tf32(Ab[4 * kBS1 + 8], ah[m][3], al[m][3]);
      }
      const float d0 = dec[kk + fq], d1 = dec[kk + fq + 4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* Xb = X + (kk + fq) * kXS + wc + 8 * nt + fg;
        const BFrag bf = b_frag(Xb[0] * d0, Xb[4 * kXS] * d1);
#pragma unroll
        for (int m = 0; m < 2; ++m) mma3(part[m][nt], ah[m], al[m], bf);
      }
    }
    promote(acc, part);
  }

  float* out = st + bhc * N * P + (long long)n0 * P;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = wr + 16 * m + fg, p = wc + 8 * nt + 2 * fq;
      if (p < P) {
        if (n < nw)
          *reinterpret_cast<float2*>(out + (long long)n * P + p) =
              make_float2(acc[m][nt][0], acc[m][nt][1]);
        if (n + 8 < nw)
          *reinterpret_cast<float2*>(out + (long long)(n + 8) * P + p) =
              make_float2(acc[m][nt][2], acc[m][nt][3]);
      }
    }
}

// -- phase 2: the state entering each chunk --------------------------------

// grid (ceil(N P / 4 / kThreads), B H): st[b,h,c] <- S_in^T[c], in place.
__global__ void __launch_bounds__(kThreads)
ssd_scan_pass_kernel(float* __restrict__ st, const float* __restrict__ cs,
                     int nc, int Q, int np4) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= np4) return;
  const long long bh = blockIdx.y;
  float4* s = reinterpret_cast<float4*>(st) + bh * nc * np4 + i;
  const float* last = cs + bh * nc * Q + Q - 1;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < nc; ++c) {
    const float4 v = s[(long long)c * np4];
    s[(long long)c * np4] = run;
    const float d = expf(last[(long long)c * Q]);
    run = make_float4(fmaf(run.x, d, v.x), fmaf(run.y, d, v.y),
                      fmaf(run.z, d, v.z), fmaf(run.w, d, v.w));
  }
}

// -- phase 3: the outputs --------------------------------------------------

// Shared-memory layout of phase 3 (floats), the same on host and device.
struct OutLayout {
  int cs_, v, c_, cb, wd, ring, bt, total;
  int c_stride, w_stride, b_stride;
  __host__ __device__ OutLayout(int Q, int N) {
    c_stride = round_up(N, kKT3) + 4;    // C rows, zero past N
    w_stride = round_up(Q, kCBCols) + 4; // C B^T rows
    b_stride = round_up(N, 8) + 4;       // B rows, zero past N
    cs_ = 0;
    v = cs_ + round_up(Q, 4);
    c_ = v + round_up(Q, 4);
    cb = c_ + kBand * c_stride;
    wd = cb + kBand * w_stride;
    ring = wd + kBand * kWDS;
    bt = wd;                             // B rows while C B^T is built
    const int end = ring + kStages * kKT3 * kXS;
    total = end > bt + kCBCols * b_stride ? end : bt + kCBCols * b_stride;
  }
};

// grid (B nc groups, bands), bands = ceil(Q / kBand), band r of blockIdx.y
// counted from the last: rows i0 .. i0 + kBand of chunk c, heads h0 .. h0 +
// hg. s_in[b,h,c] (N, P) = S_in^T, cs[b,h,c] (Q,) the cumsum of dA. Warp
// w owns rows wr .. wr + 16 and columns wc .. wc + 32 (four mma column
// tiles) of each product.
//
// Per head the block runs one product over K tiles of kKT3 rows, its B
// operand streamed through a kStages-deep cp.async ring:
//  - the state tiles: C S_in^T, then times exp(cs[i0]);
//  - the tiles left of the band (j < i0): C B^T (xd o v), then times u_i,
//    with exp(cs[i] - cs[j]) = u_i v_j, u_i = exp(cs[i] - cs[i0]) and v_j =
//    exp(cs[i0] - cs[j]), both <= 1 as cs falls: v scales the columns of
//    the head-independent C B^T as its fragments are loaded;
//  - the diagonal tile (i0 <= j <= i): W = (C B^T) o L built exactly
//    for the band's kBand x kBand square.
__global__ void __launch_bounds__(kThreads)
ssd_scan_outputs_kernel(const float* __restrict__ xd,
                        const float* __restrict__ Bm,
                        const float* __restrict__ Cm,
                        const float* __restrict__ s_in,
                        const float* __restrict__ cs, float* __restrict__ y,
                        int H, int nc, int Q, int P, int N, int hg) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const OutLayout lay(Q, N);
  float* sCs = smem + lay.cs_;     // (Q,)              cumsum of dA, this head
  float* sV = smem + lay.v;        // (Q,)              v_j, this head
  float* sC = smem + lay.c_;       // (kBand, CS)       C rows of the band
  float* sCB = smem + lay.cb;      // (kBand, WS)       C B^T of the band
  float* sWd = smem + lay.wd;      // (kBand, kWDS)     W on the diagonal
  float* sRing = smem + lay.ring;  // kStages x (kKT3, kXS)
  float* sBt = smem + lay.bt;      // (kCBCols, BS)     B rows, C B^T only
  const int CS = lay.c_stride, WS = lay.w_stride, BS = lay.b_stride;

  const int groups = (H + hg - 1) / hg;
  int bx = blockIdx.x;
  const int g = bx % groups;
  bx /= groups;
  const int c = bx % nc, b = bx / nc;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * kBand;
  const int J = min(i0 + kBand, Q);      // causal columns: j < J
  const int NK = round_up(N, kKT3);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int wr = 16 * (warp % 4), wc = 32 * (warp / 4);
  const int fg = lane / 4, fq = lane % 4;
  const float* Bc = Bm + ((long long)b * nc + c) * Q * N;
  const float* Cc = Cm + ((long long)b * nc + c) * Q * N;
  const int n4 = N / 4, p4 = P / 4;

  // C rows of the band (zeros past Q, and in the columns N .. NK)
  for (int e = t; e < kBand * n4; e += kThreads) {
    const int r = e / n4, q = e % n4, i = i0 + r;
    cp_async16(sC + r * CS + 4 * q, Cc + (long long)min(i, Q - 1) * N + 4 * q,
               i < Q);
  }
  cp_async_commit();
  for (int e = t; e < kBand * (NK - N); e += kThreads)
    sC[(e / (NK - N)) * CS + N + e % (NK - N)] = 0.f;

  // C B^T for the band, kCBCols columns a B tile (zeros past N)
  for (int j0 = 0; j0 < J; j0 += kCBCols) {
    for (int e = t; e < kCBCols * n4; e += kThreads) {
      const int r = e / n4, q = e % n4, j = j0 + r;
      cp_async16(sBt + r * BS + 4 * q,
                 Bc + (long long)min(j, Q - 1) * N + 4 * q, j < Q);
    }
    cp_async_commit();
    for (int e = t; e < kCBCols * (BS - N); e += kThreads)
      sBt[(e / (BS - N)) * BS + N + e % (BS - N)] = 0.f;
    cp_async_wait<0>();
    __syncthreads();
    float acc[4][4] = {};
    for (int k = 0; k < N; k += 8) {
      uint32_t ah[4], al[4];
      a_frag(sC + wr * CS + k, CS, fg, fq, nullptr, ah, al);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* Bt = sBt + (wc + 8 * nt + fg) * BS + k + fq;
        mma3(acc[nt], ah, al, b_frag(Bt[0], Bt[4]));
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float* o = sCB + (wr + fg) * WS + j0 + wc + 8 * nt + 2 * fq;
      o[0] = acc[nt][0];
      o[1] = acc[nt][1];
      o[8 * WS] = acc[nt][2];
      o[8 * WS + 1] = acc[nt][3];
    }
    __syncthreads();                     // sBt free for the next B tile
  }

  // K tiles of a head: nS state tiles, nL left of the band, the diagonal
  const int nS = NK / kKT3, nL = i0 / kKT3;
  const int tiles = nS + round_up(J, kKT3) / kKT3;
  const int h_end = min((g + 1) * hg, H);
  for (int h = g * hg; h < h_end; ++h) {
    const long long bhc = ((long long)b * H + h) * nc + c;
    const float* xc = xd + bhc * Q * P;
    const float* sc = s_in + bhc * N * P;
    // K tile kt into its ring slot: rows of S_in^T (kt < nS), then of xd;
    // zeros past N and past Q
    auto issue = [&](int kt) {
      const bool state = kt < nS;
      const int k0 = (state ? kt : kt - nS) * kKT3;
      const int rows = state ? N : Q;
      const float* src = state ? sc : xc;
      float* dst = sRing + (kt % kStages) * kKT3 * kXS;
      for (int e = t; e < kKT3 * 16; e += kThreads) {
        const int r = e / 16, q = e % 16, k = k0 + r;
        if (q < p4)
          cp_async16(dst + r * kXS + 4 * q,
                     src + (long long)min(k, rows - 1) * P + 4 * q, k < rows);
      }
    };
    __syncthreads();                     // the last head done with the ring
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < tiles) issue(s);
      cp_async_commit();
    }

    for (int i = t; i < Q; i += kThreads) {
      const float ci = cs[bhc * Q + i];
      sCs[i] = ci;
      if (i < i0) sV[i] = expf(cs[bhc * Q + i0] - ci);
    }
    __syncthreads();
    // W on the diagonal square: rows i0 + r, columns i0 + j
    for (int r = t / 64; r < kBand; r += kThreads / 64) {
      const int i = i0 + r, j = t % 64, jj = i0 + j;
      float w = 0.f;
      if (i < Q && jj <= i) w = sCB[r * WS + jj] * expf(sCs[i] - sCs[jj]);
      sWd[r * kWDS + j] = w;
    }

    float acc[1][4][4] = {}, part[1][4][4] = {};
    for (int kt = 0; kt < tiles; ++kt) {
      cp_async_wait<kStages - 2>();      // this thread's copies of tile kt
      __syncthreads();                   // tile kt landed; kt - 1 consumed
      if (kt + kStages - 1 < tiles) issue(kt + kStages - 1);
      cp_async_commit();
      const float* X = sRing + (kt % kStages) * kKT3 * kXS;
      const bool state = kt < nS, diag = kt >= nS + nL;
      const int AS = state ? CS : diag ? kWDS : WS;
      const float* A = state ? sC + kt * kKT3
                             : diag ? sWd : sCB + (kt - nS) * kKT3;
      // left of the band: C B^T's columns times v
      const float* v = state || diag ? nullptr : sV + (kt - nS) * kKT3;
#pragma unroll
      for (int kk = 0; kk < kKT3; kk += 8) {
        uint32_t ah[4], al[4];
        a_frag(A + wr * AS + kk, AS, fg, fq, v ? v + kk : nullptr, ah, al);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float* Xb = X + (kk + fq) * kXS + wc + 8 * nt + fg;
          mma3(part[0][nt], ah, al, b_frag(Xb[0], Xb[4 * kXS]));
        }
      }
      promote(acc, part);
      // after the state tiles: times exp(cs[i0]); after the left ones (or
      // the state's, in band 0): times u_i
      const bool s_end = kt == nS - 1, l_end = kt == nS + nL - 1;
      if (s_end || l_end) {
        const float c0 = sCs[i0];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = i0 + wr + fg + 8 * half;
          const float u = i < Q ? expf(sCs[i] - c0) : 0.f;
          const float d = (s_end ? expf(c0) : 1.f) * (l_end ? u : 1.f);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            acc[0][nt][2 * half] *= d;
            acc[0][nt][2 * half + 1] *= d;
          }
        }
      }
    }

    float* yc = y + bhc * Q * P;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int p = wc + 8 * nt + 2 * fq, i = i0 + wr + fg;
      if (p < P) {
        if (i < Q)
          *reinterpret_cast<float2*>(yc + (long long)i * P + p) =
              make_float2(acc[0][nt][0], acc[0][nt][1]);
        if (i + 8 < Q)
          *reinterpret_cast<float2*>(yc + (long long)(i + 8) * P + p) =
              make_float2(acc[0][nt][2], acc[0][nt][3]);
      }
    }
  }
}

size_t states_smem(int Q) {
  return sizeof(float) * ((size_t)round_up(Q, 4) + round_up(Q, kKT1) +
                          kStages * kKT1 * (kXS + kBS1));
}

int check_shape(int Q, int P, int N) {
  return (Q > 0 && P > 0 && N > 0 && P % 4 == 0 && P <= kPMax && N % 4 == 0)
             ? 0
             : (int)cudaErrorInvalidValue;
}

}  // namespace

// Bytes of dynamic shared memory the larger of the two tiled kernels
// needs for (Q, P, N).
extern "C" long long ssd_scan_smem_bytes(int Q, int P, int N) {
  (void)P;
  const long long out = (long long)sizeof(float) * OutLayout(Q, N).total;
  const long long sts = (long long)states_smem(Q);
  return out > sts ? out : sts;
}

// Phase 1. xd (B,H,nc,Q,P), dA (B,H,nc,Q), Bm (B,nc,Q,N) in; st
// (B,H,nc,N,P) and cs (B,H,nc,Q) out; contiguous fp32 on the device.
// Returns the cudaError_t of the launch.
extern "C" int ssd_scan_states_launch(const void* xd, const void* dA,
                                      const void* Bm, void* st, void* cs,
                                      int B, int H, int nc, int Q, int P,
                                      int N, void* stream) {
  if (B <= 0 || H <= 0 || nc <= 0) return 0;
  if (int err = check_shape(Q, P, N)) return err;
  const size_t smem = states_smem(Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_states_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int strips = (N + kStrip - 1) / kStrip;
  dim3 grid((unsigned)(nc * strips), (unsigned)H, (unsigned)B);
  ssd_scan_states_kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xd), static_cast<const float*>(dA),
      static_cast<const float*>(Bm), static_cast<float*>(st),
      static_cast<float*>(cs), H, nc, Q, P, N);
  return (int)cudaGetLastError();
}

// Phase 2. st (B,H,nc,N,P) in place from each chunk's own state to the
// state entering it; cs (B,H,nc,Q) from phase 1.
extern "C" int ssd_scan_pass_launch(void* st, const void* cs, int B, int H,
                                    int nc, int Q, int P, int N,
                                    void* stream) {
  if (B <= 0 || H <= 0 || nc <= 0) return 0;
  if (int err = check_shape(Q, P, N)) return err;
  const int np4 = N * P / 4;
  dim3 grid((unsigned)((np4 + kThreads - 1) / kThreads), (unsigned)(B * H));
  ssd_scan_pass_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(st), static_cast<const float*>(cs), nc, Q, np4);
  return (int)cudaGetLastError();
}

// Phase 3. xd (B,H,nc,Q,P), Bm and Cm (B,nc,Q,N), s_in (B,H,nc,N,P) the
// states entering each chunk (transposed), cs (B,H,nc,Q) in; y
// (B,H,nc,Q,P) out; hg heads a block.
extern "C" int ssd_scan_outputs_launch(const void* xd, const void* Bm,
                                       const void* Cm, const void* s_in,
                                       const void* cs, void* y, int B, int H,
                                       int nc, int Q, int P, int N, int hg,
                                       void* stream) {
  if (B <= 0 || H <= 0 || nc <= 0) return 0;
  if (int err = check_shape(Q, P, N)) return err;
  if (hg <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)OutLayout(Q, N).total;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_outputs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int groups = (H + hg - 1) / hg;
  dim3 grid((unsigned)(B * nc * groups), (unsigned)((Q + kBand - 1) / kBand));
  ssd_scan_outputs_kernel<<<grid, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xd), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(s_in),
      static_cast<const float*>(cs), static_cast<float*>(y), H, nc, Q, P, N,
      hg);
  return (int)cudaGetLastError();
}

// The whole scan: the three phases in order on the stream, st and cs the
// caller's scratch. Returns the first launch's error, if any.
extern "C" int ssd_scan_launch(const void* xd, const void* dA, const void* Bm,
                               const void* Cm, void* y, void* st, void* cs,
                               int B, int H, int nc, int Q, int P, int N,
                               int hg, void* stream) {
  int err = ssd_scan_states_launch(xd, dA, Bm, st, cs, B, H, nc, Q, P, N,
                                   stream);
  if (err) return err;
  err = ssd_scan_pass_launch(st, cs, B, H, nc, Q, P, N, stream);
  if (err) return err;
  return ssd_scan_outputs_launch(xd, Bm, Cm, st, cs, y, B, H, nc, Q, P, N,
                                 hg, stream);
}
