// Single-token GQA attention over a KV cache (flash-decoding) on Hopper.
//
// Replaces the TPU kernel repro/kernels/flash_decode.py::flash_decode
// (_flash_decode_kernel). For batch row b and query head h = kv R + r
// (R = H / Kv query heads share KV head kv):
//
//   out[b,h,:] = sum_p softmax_p(hd^-0.5 q[b,h,:].k[b,p,kv,:]) v[b,p,kv,:]
//
// over the positions p in [lo, hi) = [max(0, L - window), L), or [0, L)
// without a window. Sums are fp32 and the result is stored in q's dtype.
// Positions outside [lo, hi) are never read: with L >= 1 they add exactly
// 0 to the TPU kernel's sums too (exp(-1e30 - m) underflows), so the
// cache's tail need not be zero. The wrapper rejects L = 0 on a whole
// cache (the TPU kernel's degenerate mean of V), as decode never passes it.
//
// Bound on an H100: the K and V bytes, 2 B n Kv hd elem with n = hi - lo.
// At the decode path's (B, H, Kv, hd) = (8, 32, 4, 64) in bf16 with n =
// 2048 that is 16.8 MB, 5.0 us at 3.35 TB/s; its 4 B H n hd = 134 MFLOP
// are 8 operations a byte, far below the 295 at which bf16 tensor-core
// throughput would bound it. chip_smoke.py prints the bound of every case.
//
// A slice of a cache split on its sequence over ranks (the production
// decode step): the cache holds global positions offset .. offset + S - 1,
// L and the window stay global, and the call attends [lo, hi) = [max(0, L
// - window), L) shifted by -offset and clamped to [0, S]. It also writes
// the (B, H) log-sum-exp, lse = m + log(l) from the (max, sum) pair that
// each path carries into its merge (the bf16 warps' or cluster's, the
// fp32 block's or workspace's), in natural-log units, so the ranks'
// partials can be merged (models/attention.py::merge_partials); a bf16
// slice then writes its partial in fp32 (dtype 2), so the merge rounds the
// attention output once, as one call over the whole cache does. An empty
// stretch writes zeros and -inf and reads nothing. The slice's bound is
// the same: the K and V bytes of its attended local positions.
//
// Shared by both dtypes. One block owns a (b, kv) pair and up to kRows = 8
// of its R query heads, so each K and V row is read from device memory
// once for all of them (R > 8 takes ceil(R / 8) head groups). The KV axis
// is split across blocks (flash-decoding): the grid is (n_split, Kv *
// groups, B) and each block runs the online softmax over its stretch of
// positions. With one split the block writes the output. Otherwise the
// splits' partials (max, sum, accumulator) are merged in split-index
// order, so the result does not depend on which block finished first,
// inside the one launch a call makes:
//  - bf16: the n_split <= 8 blocks of a (b, group) are one thread-block
//    cluster. Each leaves its partial in its own shared memory; after a
//    cluster barrier every block merges a share of the outputs, reading
//    the others' partials through distributed shared memory, and a
//    second barrier keeps them alive until all have read. No device
//    memory, no memset, nothing on the host.
//  - fp32 (up to 128 splits, for the long caches it is timed at): each
//    block writes its partial to a workspace; the last block of its
//    (b, group) to finish, found by a __threadfence and an atomic ticket
//    on a per-(b, group) counter, merges them and resets the counter to
//    0, so the wrapper allocates the counters zeroed once.
//
// bf16 path: tensor cores through mma.sync.m16n8k16 (bf16 in, fp32
// accumulate). The point is fewer instructions, not FLOP/s: one mma does
// 2,048 multiply-adds from four ldmatrix-fed registers where an FFMA loop
// reads both operands from shared memory. A block of 4 warps streams
// tiles of 64 positions; K and V tiles arrive in bf16 straight into a
// two-stage shared-memory ring by 16-byte cp.async (zero-filled past the
// stretch), 16 KB a stage at hd 64, with the 16-byte chunks of each row
// XOR-swizzled by the row so that ldmatrix is free of bank conflicts.
// cp.async rather than TMA: a tile is 64 rows strided by Kv hd elements
// starting at any position, which 128 threads cover in 4 copies each of
// K and V at fixed offsets, with the zero fill that a TMA descriptor
// would need a 4-d box for. Deeper rings (3 and 4 stages) and larger
// blocks (8 and 16 warps, tiles of 128 and 256) were measured slower on
// an H100 (PERF.md). A stretch of two tiles has both in flight before
// the first math. Warp w owns positions 16w .. 16w + 15 of every tile and
// runs its own online softmax:
//  - S = q Kt: the block's query heads are the A operand, 8 rows padded
//    to 16 with zeros, as FlashAttention's split-KV decode does; K rows
//    are the B operand (ldmatrix). With R < 8 the missing rows are zeros
//    too, at no cost: the tile is 16 rows whatever R is. q is bf16
//    already, so it enters the product exactly; the fp32 score is scaled
//    by hd^-0.5 log2(e) after it, and the softmax runs in base 2 (exp2f).
//  - max, exp, sum and rescale run on the score fragment; the max is
//    shuffled within the quad of lanes that share a row.
//  - P V reuses the score fragment as the A operand, with V through
//    ldmatrix.trans. The TPU kernel keeps p in fp32; here p is rounded to
//    bf16 for the product, as the JAX model's own decode_attention rounds
//    its probabilities to the cache dtype. The row sums stay fp32 of the
//    unrounded p. tests/test_torch_decode.py holds this rounding to the
//    plain version at the decode path's shapes within the bf16 tolerance.
// At the end of its stretch the block merges its 4 warps' states through
// shared memory (the ring, free by then). What bounds it on an H100
// (PERF.md): a call costs some 3 us at L = 1 (launch, one round trip to
// memory, the merges), and a block's tiles follow one another at the
// latency of its dependent mma, shuffle and exp chain, so long stretches
// are split; the split merge adds a cluster barrier pair.
//
// fp32 path: FFMA, as TF32 would not hold the 3e-4 fp32 tolerance. Tiles
// of 32 positions are loaded with 16-byte vector loads into registers
// (the next tile's while the current one is computed) and stored to
// shared memory as fp32, rows padded by one float; each warp owns query
// rows and computes one position per lane, then each thread owns one
// (row, dim) output (two dims at hd 256) and accumulates P V. Rows a
// block lacks (R < 8) are skipped, not computed. The K and V tiles are
// dynamic shared memory: at hd 256 they are 65.8 KB, past the 48 KB a
// block gets without opting in, and the next tile would take 128 more
// registers a thread, so there each tile is loaded straight into shared
// memory, with no prefetch.
//
// Head dim 256 (paligemma-3b: 8 query heads over one KV head), bf16:
// the same kernel with 32 16-byte chunks a row, so a thread's 16 copies
// of a tile sit 4 rows apart and each takes its own row's swizzle. The
// ring is 128 KB (two stages of 64-position K and V tiles), one block an
// SM; a lane holds the output fragment o[32][4] and q's 16 k-steps, some
// 160 registers before the rest (ptxas's count is in PERF.md).
//
// L on the host or on the device. flash_decode_launch takes [lo, hi)
// and the split as host ints, so a call's grid fits its L.
// flash_decode_launch_len reads L from a device int32, as the TPU kernel
// reads it from SMEM (scalar prefetch), so one launch recorded in a CUDA
// graph serves every L. Its grid is sized for the longest stretch the call
// allows (S, or the window), and every block reads L, clamps it to [1, S]
// (a bad length never reads outside the cache), and plans its split by the
// wrapper's rule (kernels/flash_decode.py::plan): n_split active blocks of
// `chunk` positions. At any L it then attends the same stretches and merges
// them in the same order as the host-int call, so the two are bit-equal.
// The blocks past n_split attend nothing: in bf16 they still take part in
// the cluster's two barriers; in fp32 they leave at once, and the last-
// block ticket counts the n_split active blocks.
//
// Limits, checked by the Python wrapper too: hd in {64, 128, 256}; fp32 or
// bf16, the same for q, K and V; contiguous tensors, the caches 16-byte
// aligned; stretches of whole 64-position tiles; at most kMaxSplits
// splits in fp32 and kMaxCluster in bf16.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;             // query heads per block
constexpr int kChunk = 64;           // a stretch is a multiple of this
constexpr int kMaxSplits = 128;      // fp32: the merge's weights fit in smem
constexpr int kMaxCluster = 8;       // bf16: splits a (portable) cluster holds
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMaxDevices = 64;

// Above 48 KB a kernel takes dynamic shared memory only after opting in,
// once per device: opted is the kernel's own flags.
template <typename Kernel>
int opt_in(Kernel kernel, int smem, bool (&opted)[kMaxDevices]) {
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted[dev] = true;
  }
  return 0;
}

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// What a call attends, [lo, hi), in n_split stretches of `chunk`
// positions: given by the host (len null), or planned by every block from
// the device length *len, its window, the split cap and the least tiles a
// split streams, as kernels/flash_decode.py::plan plans it on the host.
// A slice (`slice` set: an offset, or the log-sum-exp asked for) reads L
// as global and the cache as rows offset .. offset + S - 1 of a longer
// one, so its stretch is [max(0, L - window), L) shifted by -offset and
// clamped to [0, S], and may be empty (n_split 0).
struct Span {
  const int* len;
  int lo, hi, chunk, n_split;
  int window, cap, min_tiles;
  int offset, slice;
};

__device__ __forceinline__ Span resolve(Span a, int S) {
  if (a.len == nullptr) return a;
  int L = *a.len;
  if (!a.slice) L = min(max(L, 1), S);
  const int glo = a.window ? max(0, L - a.window) : 0;
  a.lo = min(max(glo - a.offset, 0), S);
  a.hi = min(max(L - a.offset, 0), S);
  const int n = a.hi - a.lo;
  if (n <= 0) {
    a.chunk = kChunk;
    a.n_split = 0;
    return a;
  }
  const int tiles = (n + kChunk - 1) / kChunk;
  const int splits = max(1, min(tiles / a.min_tiles, a.cap));
  a.chunk = (tiles + splits - 1) / splits * kChunk;
  a.n_split = (n + a.chunk - 1) / a.chunk;
  return a;
}

// -- fp32: the split merge through device memory ---------------------------

// ws holds every split's partials: acc (G, B, H, HD), then m and l
// (G, B, H), G = gridDim.x, of which the first n_split are written. Called
// by every thread of every active block after it wrote its own partial;
// the last of the n_split blocks of the (b, group) merges all of them:
//   out = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30),  w_s = e^(m_s - M)
// and, where lse is not null, lse = M + log(sum_s w_s l_s).
// smem holds 2 kRows kMaxSplits floats.
template <int HD>
__device__ __forceinline__ void merge_splits(const float* ws, float* out,
                                             float* lse, int* counter,
                                             float* smem, int n_split,
                                             long long BH, long long row0,
                                             int nr) {
  __shared__ int s_last;
  __shared__ float sM[kRows];
  const int t = threadIdx.x;
  __threadfence();                      // this block's partial is visible
  __syncthreads();
  if (t == 0) s_last = atomicAdd(counter, 1) == n_split - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* ws_m = ws + (long long)gridDim.x * BH * HD;
  const float* ws_l = ws_m + (long long)gridDim.x * BH;
  float* sw = smem;                     // (n_split, kRows): m, then weights
  float* swl = smem + n_split * kRows;  // l, then the weights times l
  for (int e = t; e < n_split * nr; e += kThreads) {
    const int s = e / nr, r = e % nr;
    sw[s * kRows + r] = __ldcg(ws_m + s * BH + row0 + r);
    swl[s * kRows + r] = __ldcg(ws_l + s * BH + row0 + r);
  }
  __syncthreads();
  if (t < nr) {
    float M = -INFINITY;
    for (int s = 0; s < n_split; ++s) M = fmaxf(M, sw[s * kRows + t]);
    sM[t] = M;
  }
  __syncthreads();
  for (int e = t; e < n_split * nr; e += kThreads) {
    const int s = e / nr, r = e % nr;
    const float w = expf(sw[s * kRows + r] - sM[r]);
    sw[s * kRows + r] = w;
    swl[s * kRows + r] *= w;
  }
  __syncthreads();
  for (int e = t; e < nr * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const float* acc = ws + (row0 + r) * HD + d;
    float num = 0.f, den = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_split; ++s) {
      num = fmaf(sw[s * kRows + r], __ldcg(acc + s * BH * HD), num);
      den += swl[s * kRows + r];
    }
    out[(row0 + r) * HD + d] = num / fmaxf(den, 1e-30f);
    if (lse != nullptr && d == 0) lse[row0 + r] = sM[r] + logf(den);
  }
  if (t == 0) *counter = 0;             // ready for the next call
}

// -- bf16: mma.sync ----------------------------------------------------------

constexpr int kStages = 2;           // tiles in the shared-memory ring

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// c += A B for a 16x16 A of which rows 8..15 are zero (a1 = a3 = 0)
__device__ __forceinline__ void mma_rows8(float (&c)[4], uint32_t a0,
                                          uint32_t a2, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

constexpr int kTile = 16 * kWarps;    // positions per tile: 16 per warp

template <int HD>
__host__ __device__ constexpr int bf16_smem_bytes() {
  return kStages * 2 * kTile * HD * 2;
}

// q (B, H, HD), k and v (B, S, Kv, HD), all bf16; out (B, H, HD) bf16, or
// fp32 (OutT float) for a slice's partial, merged before it is rounded.
template <int HD, typename OutT>
__global__ void __launch_bounds__(kThreads)
flash_decode_bf16(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  OutT* __restrict__ out, float* __restrict__ lse,
                  int S, int H, int Kv, int R, Span span, float scale_log2) {
  constexpr int CPR = HD / 8;                  // 16-byte chunks per row
  constexpr int TILE_BYTES = kTile * HD * 2;   // one of K or V
  constexpr int LOADS = kTile * CPR / kThreads;  // copies a thread issues
  constexpr int RSTEP = kThreads / CPR;        // rows between them
  constexpr int KS = HD / 16;                  // k-steps of q K^T
  constexpr int NB = HD / 8;                   // 8-dim blocks of P V
  static_assert(kThreads % CPR == 0 && kTile % RSTEP == 0,
                "a thread's copies share one column of whole tiles");
  static_assert(((kWarps + 1) * kRows * HD + (2 * kWarps + 2) * kRows) * 4 <=
                    bf16_smem_bytes<HD>(),
                "the warp and split merges fit in the ring");
  extern __shared__ __align__(128) unsigned char smem[];

  const int G = (R + kRows - 1) / kRows;       // head groups per KV head
  const int kv = blockIdx.y / G, g = blockIdx.y % G;
  const int b = blockIdx.z;
  span = resolve(span, S);
  const int split = blockIdx.x, n_split = span.n_split;
  const int h0 = kv * R + g * kRows;
  const int nr = min(kRows, R - g * kRows);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int qr = lane / 4, qc = lane % 4;      // fragment row and column pair
  const long long row0 = (long long)b * H + h0;
  // this block's state for the split merge: acc (kRows, HD), then m and l
  // (kRows), behind the warps' states in the ring
  float* pAcc = reinterpret_cast<float*>(smem) + kWarps * kRows * (HD + 2);

  if (span.hi <= span.lo) {  // an empty slice: zeros and -inf, no barrier
    if (split == 0) {
      for (int e = t; e < nr * HD; e += kThreads) store(out + row0 * HD + e, 0.f);
      if (lse != nullptr && t < nr) lse[row0 + t] = -INFINITY;
    }
    return;
  }
  if (split < n_split) {   // the blocks past n_split attend nothing
    const int p_begin = span.lo + split * span.chunk;
    const int p_end = min(span.hi, p_begin + span.chunk);
    const int n_tiles = (p_end - p_begin + kTile - 1) / kTile;

    // this thread copies rows r0, r0 + RSTEP, ... of every tile at chunk
    // c, which lands at chunk c ^ (row % 8) of its row
    const long long row = (long long)Kv * HD;    // elements between positions
    const int r0 = t / CPR, c = t % CPR;
    const long long off0 = ((long long)b * S * Kv + kv) * HD + c * 8;
    const uint32_t ring = smem_addr(smem);
    auto fetch = [&](int i) {
      const int p0 = p_begin + i * kTile;
      const uint32_t sk = ring + (i % kStages) * 2 * TILE_BYTES;
      const long long off = off0 + (p0 + r0) * row;
#pragma unroll
      for (int j = 0; j < LOADS; ++j) {
        const int rj = r0 + j * RSTEP;
        const bool ok = p0 + rj < p_end;
        const long long o = ok ? off + j * RSTEP * row : off0;
        const uint32_t d = sk + (rj * CPR + (c ^ (rj & 7))) * 16;
        cp_async16(d, k + o, ok ? 16 : 0);
        cp_async16(d + TILE_BYTES, v + o, ok ? 16 : 0);
      }
    };
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      if (i < n_tiles) fetch(i);
      cp_async_commit();
  }

  // this lane's q fragments: row qr, dims 16 ks + 2 qc (+1) and + 8
  uint32_t qa[KS][2];
  {
    const __nv_bfloat16* qrow = q + ((long long)b * H + h0 + qr) * HD;
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = ks * 16 + h * 8 + 2 * qc;
        __nv_bfloat162 x;
        x.x = qr < nr ? qrow[d] : zero;
        x.y = qr < nr ? qrow[d + 1] : zero;
        qa[ks][h] = *reinterpret_cast<uint32_t*>(&x);
      }
  }

  float o[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
    o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
  float m = -INFINITY, l = 0.f;  // row qr, base 2; l is this lane's share

  // the ldmatrix addresses of this lane: x4 matrix sel = lane / 8
  const int sel = lane / 8;
  const int rk = warp * 16 + (sel / 2) * 8 + lane % 8;  // K: 2 position blocks
  const int rv = warp * 16 + (sel % 2) * 8 + lane % 8;  // V: 2 position halves
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 1>();              // tile i has landed
    __syncthreads();
    const uint32_t sk = ring + (i % kStages) * 2 * TILE_BYTES;
    const uint32_t sv = sk + TILE_BYTES;

    // S = q K^T over this warp's 16 positions: two 8-position blocks
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int cc = 2 * ks + sel % 2;
      uint32_t bk[4];
      ldsm_x4(sk + (rk * CPR + (cc ^ (rk & 7))) * 16, bk);
      mma_rows8(s[0], qa[ks][0], qa[ks][1], bk[0], bk[1]);
      mma_rows8(s[1], qa[ks][0], qa[ks][1], bk[2], bk[3]);
    }

    // online softmax of row qr over this lane's 4 positions
    const int pos0 = p_begin + i * kTile + warp * 16 + 2 * qc;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x =
            pos0 + 8 * j + e < p_end ? s[j][e] * scale_log2 : -INFINITY;
        s[j][e] = x;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float corr = exp2f(m - m_use);       // 0 while m is -inf
    float p[2][2], sum = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[j][e] = exp2f(s[j][e] - m_use);
        sum += p[j][e];
      }
    l = l * corr + sum;
    m = m_new;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      o[nb][0] *= corr;
      o[nb][1] *= corr;
    }

    // O += P V: P's A fragment is the score fragment, rounded to bf16
    const uint32_t pa0 = pack_bf16(p[0][0], p[0][1]);
    const uint32_t pa2 = pack_bf16(p[1][0], p[1][1]);
#pragma unroll
    for (int np = 0; np < NB / 2; ++np) {
      const int cc = 2 * np + sel / 2;
      uint32_t bv[4];
      ldsm_x4_trans(sv + (rv * CPR + (cc ^ (rv & 7))) * 16, bv);
      mma_rows8(o[2 * np], pa0, pa2, bv[0], bv[1]);
      mma_rows8(o[2 * np + 1], pa0, pa2, bv[2], bv[3]);
    }
    __syncthreads();                           // the stage is consumed
    if (i + kStages < n_tiles) fetch(i + kStages);
    cp_async_commit();
  }
  cp_async_wait<0>();
  l += __shfl_xor_sync(kFull, l, 1);
  l += __shfl_xor_sync(kFull, l, 2);

  // merge the warps' states in shared memory (the ring is free)
  __syncthreads();
  float* sO = reinterpret_cast<float*>(smem);  // (kWarps, kRows, HD)
  float* sMw = sO + kWarps * kRows * HD;       // (kWarps, kRows)
  float* sLw = sMw + kWarps * kRows;
  if (qc == 0) {
    sMw[warp * kRows + qr] = m;
    sLw[warp * kRows + qr] = l;
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    float* dst = sO + (warp * kRows + qr) * HD + nb * 8 + 2 * qc;
    dst[0] = o[nb][0];
    dst[1] = o[nb][1];
  }
  __syncthreads();
  float* pM = pAcc + kRows * HD;
  float* pL = pM + kRows;
  // warp 0 holds p_begin, so every row's M is finite
  for (int e = t; e < nr * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sMw[w * kRows + r]);
    float acc = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float cw = exp2f(sMw[w * kRows + r] - M);
      acc = fmaf(sO[(w * kRows + r) * HD + d], cw, acc);
      den = fmaf(sLw[w * kRows + r], cw, den);
    }
    if (n_split == 1) {
      store(out + (row0 + r) * HD + d, acc / fmaxf(den, 1e-30f));
      if (lse != nullptr && d == 0) lse[row0 + r] = (M + log2f(den)) * kLn2;
    } else {
      pAcc[e] = acc;
      if (d == 0) {
        pM[r] = M;
        pL[r] = den;
      }
    }
  }
  }
  if (gridDim.x == 1) return;                  // alone in its cluster

  // the blocks of this (b, group) are one cluster: once every active
  // block's state is in its shared memory, active block s merges outputs
  // s kThreads + t, s kThreads + t + n_split kThreads, ..., reading the
  // active blocks' states in split order; then every block waits until
  // all have read its own
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (n_split > 1 && split < n_split) {
    const float* parts[kMaxCluster];
#pragma unroll
    for (int sp = 0; sp < kMaxCluster; ++sp)
      parts[sp] = sp < n_split ? cluster.map_shared_rank(pAcc, sp) : pAcc;
    for (int e = split * kThreads + t; e < nr * HD; e += n_split * kThreads) {
      const int r = e / HD, d = e % HD;
      float ms[kMaxCluster], ls[kMaxCluster], as[kMaxCluster];
#pragma unroll
      for (int sp = 0; sp < kMaxCluster; ++sp) {
        if (sp < n_split) {
          as[sp] = parts[sp][e];
          ms[sp] = parts[sp][kRows * HD + r];
          ls[sp] = parts[sp][kRows * HD + kRows + r];
        }
      }
      float M = -INFINITY;
#pragma unroll
      for (int sp = 0; sp < kMaxCluster; ++sp)
        if (sp < n_split) M = fmaxf(M, ms[sp]);
      float num = 0.f, den = 0.f;
#pragma unroll
      for (int sp = 0; sp < kMaxCluster; ++sp) {
        if (sp < n_split) {
          const float cw = exp2f(ms[sp] - M);
          num = fmaf(as[sp], cw, num);
          den = fmaf(ls[sp], cw, den);
        }
      }
      store(out + (row0 + r) * HD + d, num / fmaxf(den, 1e-30f));
      if (lse != nullptr && d == 0) lse[row0 + r] = (M + log2f(den)) * kLn2;
  }
  }
  cluster.sync();
}

// -- fp32: FFMA ---------------------------------------------------------------

constexpr int kTile32 = 32;          // positions per tile: one per lane

// q (B, H, HD), k and v (B, S, Kv, HD), out (B, H, HD), all fp32.
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_decode_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, float* __restrict__ ws,
                 int* __restrict__ counters, int S, int H, int Kv, int R,
                 Span span, float scale) {
  constexpr int KP = HD + 1;                   // padded shared row
  constexpr int VPR = HD / 4;                  // float4 loads per row
  constexpr int DW = HD < kThreads ? HD : kThreads;  // threads along a row
  constexpr int DPT = HD / DW;                 // output dims per thread
  constexpr int RSTEP = kThreads / DW;         // output rows per pass
  constexpr int ACC = (kRows + RSTEP - 1) / RSTEP;
  constexpr int RPW = (kRows + kWarps - 1) / kWarps;  // score rows per warp
  constexpr bool kPrefetch = HD <= 128;        // the next tile in registers
  static_assert(2 * kRows * kMaxSplits <= kTile32 * KP,
                "the split merge fits in sK");

  extern __shared__ __align__(16) float fsmem[];
  float* sK = fsmem;                           // (kTile32, KP), dynamic
  float* sV = fsmem + kTile32 * KP;
  __shared__ float sQ[kRows * HD];
  __shared__ float sP[kRows * kTile32];
  __shared__ float sCorr[kRows];
  __shared__ float sL[kRows];

  const int G = (R + kRows - 1) / kRows;
  const int kv = blockIdx.y / G, g = blockIdx.y % G;
  const int b = blockIdx.z, B = gridDim.z;
  span = resolve(span, S);
  const int split = blockIdx.x, n_split = span.n_split;
  const int h0 = kv * R + g * kRows;
  const int nr = min(kRows, R - g * kRows);
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const long long BH = (long long)B * H;
  const long long row0 = (long long)b * H + h0;
  if (span.hi <= span.lo) {            // an empty slice: zeros and -inf
    if (split == 0) {
      for (int e = t; e < nr * HD; e += kThreads) out[row0 * HD + e] = 0.f;
      if (lse != nullptr && t < nr) lse[row0 + t] = -INFINITY;
    }
    return;
  }
  if (split >= n_split) return;        // attends nothing; not in the ticket
  const int d_own = t % DW, r_own = t / DW;    // dims d_own + u DW

  const int p_begin = span.lo + split * span.chunk;
  const int p_end = min(span.hi, p_begin + span.chunk);

  for (int e = t; e < kRows * HD; e += kThreads) {
    const int r = e / HD;
    sQ[e] = r < nr ? q[((long long)b * H + h0 + r) * HD + e % HD] * scale
                   : 0.f;
  }
  float m[RPW], l[RPW], acc[ACC][DPT];
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    m[j] = -INFINITY;
    l[j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < ACC; ++i)
#pragma unroll
    for (int u = 0; u < DPT; ++u) acc[i][u] = 0.f;

  const long long row = (long long)Kv * HD;
  const float* kb = k + ((long long)b * S * Kv + kv) * HD;
  const float* vb = v + ((long long)b * S * Kv + kv) * HD;

  // each thread's share of one tile's K and V rows (zero past the
  // stretch): up to hd 128 the next tile's loads are in flight during the
  // current tile's arithmetic; at hd 256 each tile is loaded when due
  constexpr int LPT = (kTile32 * VPR + kThreads - 1) / kThreads;
  float4 rk[kPrefetch ? LPT : 1], rv[kPrefetch ? LPT : 1];
  auto load = [&](int p0, int i, float4& k4, float4& v4) {
    const int e = t + i * kThreads, r = e / VPR, c = e % VPR;
    k4 = v4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (e < kTile32 * VPR && p0 + r < p_end) {
      k4 = *reinterpret_cast<const float4*>(kb + (p0 + r) * row + c * 4);
      v4 = *reinterpret_cast<const float4*>(vb + (p0 + r) * row + c * 4);
    }
  };
  auto put = [&](int i, const float4& k4, const float4& v4) {
    const int e = t + i * kThreads, r = e / VPR, c = e % VPR;
    if (e < kTile32 * VPR) {
      float* dk = sK + r * KP + c * 4;
      float* dv = sV + r * KP + c * 4;
      dk[0] = k4.x; dk[1] = k4.y; dk[2] = k4.z; dk[3] = k4.w;
      dv[0] = v4.x; dv[1] = v4.y; dv[2] = v4.z; dv[3] = v4.w;
    }
  };
  auto fetch = [&](int p0) {
#pragma unroll
    for (int i = 0; i < (kPrefetch ? LPT : 0); ++i)
      load(p0, i, rk[i], rv[i]);
  };

  if constexpr (kPrefetch) {
    if (p_begin < p_end) fetch(p_begin);
  }
  for (int p0 = p_begin; p0 < p_end; p0 += kTile32) {
    __syncthreads();                           // the last tile is consumed
    if constexpr (kPrefetch) {
#pragma unroll
      for (int i = 0; i < LPT; ++i) put(i, rk[i], rv[i]);
    } else {
#pragma unroll 4
      for (int i = 0; i < LPT; ++i) {
        float4 k4, v4;
        load(p0, i, k4, v4);
        put(i, k4, v4);
      }
    }
    __syncthreads();
    if constexpr (kPrefetch) {
      if (p0 + kTile32 < p_end) fetch(p0 + kTile32);
    }

    // scores and the online softmax: warp w owns rows w, w + 4; lane =
    // position in the tile. m and l live in the owning warp's registers
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
        sP[r * kTile32 + lane] = p;
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
#pragma unroll
        for (int u = 0; u < DPT; ++u) {
          float a = acc[i][u] * sCorr[r];
#pragma unroll
          for (int j = 0; j < kTile32; ++j)
            a = fmaf(sP[r * kTile32 + j], sV[j * KP + d_own + u * DW], a);
          acc[i][u] = a;
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int r = warp + j * kWarps;
    if (r < nr && lane == 0) sL[r] = l[j];
  }
  __syncthreads();
  if (n_split == 1) {
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int r = r_own + i * RSTEP;
      if (r < nr)
#pragma unroll
        for (int u = 0; u < DPT; ++u)
          out[(row0 + r) * HD + d_own + u * DW] =
              acc[i][u] / fmaxf(sL[r], 1e-30f);
    }
    if (lse != nullptr) {
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        const int r = warp + j * kWarps;
        if (r < nr && lane == 0) lse[row0 + r] = m[j] + logf(l[j]);
      }
    }
    return;
  }
  // this split's partials: acc, then l beside it and m from the warp
  // that owns the row
  const long long base = split * BH + row0;
  float* ws_m = ws + (long long)gridDim.x * BH * HD;
  float* ws_l = ws_m + (long long)gridDim.x * BH;
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int r = r_own + i * RSTEP;
    if (r < nr) {
#pragma unroll
      for (int u = 0; u < DPT; ++u)
        ws[(base + r) * HD + d_own + u * DW] = acc[i][u];
      if (d_own == 0) ws_l[base + r] = sL[r];
    }
  }
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int r = warp + j * kWarps;
    if (r < nr && lane == 0) ws_m[base + r] = m[j];
  }
  merge_splits<HD>(
      ws, out, lse, counters + (long long)b * gridDim.y + blockIdx.y, sK,
      n_split, BH, row0, nr);
}

// -- launch -------------------------------------------------------------------

template <int HD, typename OutT>
int launch_bf16(dim3 grid, const void* q, const void* k, const void* v,
                void* out, float* lse, int S, int H, int Kv, Span span,
                float scale, cudaStream_t stream) {
  constexpr int smem = bf16_smem_bytes<HD>();
  static bool opted[kMaxDevices];
  const int refused = opt_in(flash_decode_bf16<HD, OutT>, smem, opted);
  if (refused != 0) return refused;
  // one cluster of grid.x blocks per (b, group): the splits
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = grid.x > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, flash_decode_bf16<HD, OutT>,
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<OutT*>(out),
      lse, S, H, Kv, H / Kv, span, scale * kLog2e);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int HD>
int launch_f32(dim3 grid, const void* q, const void* k, const void* v,
               void* out, float* lse, float* ws, int* counters, int S, int H,
               int Kv, Span span, float scale, cudaStream_t stream) {
  constexpr int smem = 2 * kTile32 * (HD + 1) * 4;   // sK and sV
  static bool opted[kMaxDevices];
  const int refused = opt_in(flash_decode_f32<HD>, smem, opted);
  if (refused != 0) return refused;
  flash_decode_f32<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, ws,
      counters, S, H, Kv, H / Kv, span, scale);
  return (int)cudaGetLastError();
}

// the kernel for (dtype, hd) on a grid of n_grid splits
int launch(int n_grid, const void* q, const void* k, const void* v,
           void* out, void* lse_out, void* ws, void* counters, int dtype,
           int B, int S, int H, int Kv, int hd, Span span, float scale,
           void* stream) {
  const int G = (H / Kv + kRows - 1) / kRows;
  const dim3 grid((unsigned)n_grid, (unsigned)(Kv * G), (unsigned)B);
  float* lse = static_cast<float*>(lse_out);
  float* w = static_cast<float*>(ws);
  int* c = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64)
    return launch_f32<64>(grid, q, k, v, out, lse, w, c, S, H, Kv, span, scale, s);
  if (dtype == 0 && hd == 128)
    return launch_f32<128>(grid, q, k, v, out, lse, w, c, S, H, Kv, span, scale,
                           s);
  if (dtype == 0 && hd == 256)
    return launch_f32<256>(grid, q, k, v, out, lse, w, c, S, H, Kv, span, scale,
                           s);
  using bf16 = __nv_bfloat16;
  if (dtype == 1 && hd == 64)
    return launch_bf16<64, bf16>(grid, q, k, v, out, lse, S, H, Kv, span,
                                 scale, s);
  if (dtype == 1 && hd == 128)
    return launch_bf16<128, bf16>(grid, q, k, v, out, lse, S, H, Kv, span,
                                  scale, s);
  if (dtype == 1 && hd == 256)
    return launch_bf16<256, bf16>(grid, q, k, v, out, lse, S, H, Kv, span,
                                  scale, s);
  if (dtype == 2 && hd == 64)
    return launch_bf16<64, float>(grid, q, k, v, out, lse, S, H, Kv, span,
                                  scale, s);
  if (dtype == 2 && hd == 128)
    return launch_bf16<128, float>(grid, q, k, v, out, lse, S, H, Kv, span,
                                   scale, s);
  if (dtype == 2 && hd == 256)
    return launch_bf16<256, float>(grid, q, k, v, out, lse, S, H, Kv, span,
                                   scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B,H,hd), k and v (B,S,Kv,hd), out (B,H,hd): contiguous on the device,
// fp32 (dtype 0) or bf16 (dtype 1), or bf16 operands with an fp32 out
// (dtype 2: a slice's partial). Positions [lo, hi) are attended, in
// n_split stretches of `chunk` positions (a multiple of 64; every stretch
// non-empty; n_split <= 128 in fp32, <= 8 in bf16); up to 8 query heads
// per block. lo == hi (an empty slice, n_split 1) writes zeros. For fp32
// with n_split > 1, ws holds n_split * B * H * (hd + 2) floats and
// counters B * Kv * ceil(H / Kv / 8) ints, all 0 (each call leaves them
// 0); otherwise both may be null. lse, where not null, takes the (B, H)
// fp32 natural-log log-sum-exp of the attended scaled scores (-inf for an
// empty slice). Returns the cudaError_t of the launch.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, void* out, void* ws,
                                   void* counters, void* lse, int dtype,
                                   int B, int S, int H, int Kv, int hd,
                                   int lo, int hi, int chunk, int n_split,
                                   float scale, void* stream) {
  if (B <= 0 || H <= 0 || Kv <= 0 || H % Kv != 0 || lo < 0 || hi > S ||
      lo > hi || chunk <= 0 || chunk % kChunk != 0 || n_split <= 0 ||
      (lo == hi && n_split != 1) ||
      (lo < hi && (long long)(n_split - 1) * chunk >= hi - lo) ||
      (dtype == 0 && (n_split > kMaxSplits ||
                      (n_split > 1 && (ws == nullptr || counters == nullptr)))) ||
      (dtype != 0 && n_split > kMaxCluster))
    return (int)cudaErrorInvalidValue;
  const Span span = {nullptr, lo, hi, chunk, n_split, 0, 0, 1, 0, 0};
  return launch(n_split, q, k, v, out, lse, ws, counters, dtype, B, S, H, Kv,
                hd, span, scale, stream);
}

// The same attention with L read on the device from len (one int32): the
// cache holds the global positions offset .. offset + S - 1, and the
// positions [max(0, L - window), L), or [0, L) with window 0, that fall in
// it are attended, split as the wrapper's plan splits them, with `cap` the
// most splits and `min_tiles` the least 64-position tiles a split streams
// where there are enough. With offset 0 and lse null the kernel clamps L
// to [1, S] (a bad length never reads outside the cache); otherwise L is
// global and the slice's stretch may be empty (zeros and -inf). The grid
// has n_grid splits, enough for the longest stretch, min(window, S) or S;
// the blocks past a length's splits attend nothing. For fp32 with n_grid >
// 1, ws holds n_grid * B * H * (hd + 2) floats and counters as above; lse
// as above. Returns the cudaError_t of the launch.
extern "C" int flash_decode_launch_len(const void* q, const void* k,
                                       const void* v, void* out, void* ws,
                                       void* counters, const void* len,
                                       void* lse, int dtype, int B, int S,
                                       int H, int Kv, int hd, int window,
                                       int offset, int n_grid, int cap,
                                       int min_tiles, float scale,
                                       void* stream) {
  const int n_max = window > 0 && window < S ? window : S;
  const int tiles = (n_max + kChunk - 1) / kChunk;
  if (len == nullptr || B <= 0 || S <= 0 || H <= 0 || Kv <= 0 ||
      H % Kv != 0 || window < 0 || offset < 0 || cap <= 0 ||
      min_tiles <= 0 || n_grid < max(1, min(tiles / min_tiles, cap)) ||
      (dtype == 0 &&
       (n_grid > kMaxSplits ||
        (n_grid > 1 && (ws == nullptr || counters == nullptr)))) ||
      (dtype != 0 && n_grid > kMaxCluster))
    return (int)cudaErrorInvalidValue;
  const Span span = {static_cast<const int*>(len), 0, 0, 0, 0, window, cap,
                     min_tiles, offset, offset != 0 || lse != nullptr};
  return launch(n_grid, q, k, v, out, lse, ws, counters, dtype, B, S, H, Kv,
                hd, span, scale, stream);
}
