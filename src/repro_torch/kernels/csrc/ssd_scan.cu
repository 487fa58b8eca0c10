// Chunked Mamba2 SSD (state-space duality) forward scan on Hopper.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan
// (_ssd_kernel). For each (batch b, head h) and each chunk c of Q steps:
//
//   cs      = cumsum(dA[b,h,c,:])                         (Q,)
//   L[i,j]  = exp(cs[i] - cs[j]) for i >= j, else 0         (Q, Q)
//   y[i,:]  = sum_j (C[i,:].B[j,:]) L[i,j] xd[j,:]          in-chunk term
//           + exp(cs[i]) C[i,:] S^T                         carried state
//   S       = S exp(cs[Q-1]) + sum_l xd[l,:]^T B[l,:] exp(cs[Q-1] - cs[l])
//
// with S the (P, N) state, zero before chunk 0, and B, C shared by all
// heads (ngroups = 1: indexed by (b, c), never by h). Everything is fp32
// on the CUDA cores (FFMA); no TF32, since the plain version holds the
// scan at 2e-4.
//
// Design. The TPU grid (B, H, nc) runs the chunk axis in order and
// carries S in VMEM scratch. GPU blocks run in no order, so here one
// block owns one (b, h) and loops over its chunks, keeping S in shared
// memory from one chunk to the next: the recurrence never leaves the
// block, and the kernel is one launch with no second pass. The
// chunk-parallel alternative (per-chunk states in parallel, a scan over
// nc, then the outputs) fills more SMs but needs three phases and a
// state buffer in device memory; at the slice's shape (B=2, H=24) this
// design runs 48 blocks on 132 SMs, which is what a later redesign (with
// wgmma) has to win back. A chunk's B or C (Q x N fp32, 128 KB at Q=256,
// N=128) does not fit beside the state, so the chunk is walked in tiles
// of T=32 rows: for each row tile i, the causal column tiles j <= i build
// W = (C_i B_j^T) o L_ij in shared memory and accumulate W xd_j into
// registers; the state term is added before, and the state update runs
// after all row tiles (it needs the old S). C B^T is recomputed per head
// (the heads share it), work that the bound below does not count.
//
// Bound on an H100, at the slice's shape B=2, H=24, nc=8, Q=256, P=64,
// N=128. L is zero above the diagonal, so the in-chunk products need
// only the Q (Q + 1) / 2 causal pairs: C B^T once per (b, c) is
// Q (Q + 1) N = 0.13 GFLOP in all; the masked product and the two state
// products are Q (Q + 1) P + 4 Q N P per (b, h, c), 4.84 GFLOP: 4.97
// GFLOP at 67 TFLOP/s fp32 is 74 us. The bytes (xd and y once, B, C and
// dA once, 55 MB) take 16 us at 3.35 TB/s, so the scan is bound by
// operations (chip_smoke.py's ssd_scan phase prints both).
//
// Limits, checked by the Python wrapper too: P <= 128 and P % 16 == 0,
// P * N <= 8192 (the state lives in registers during its update),
// dynamic shared memory within the card's 227 KB per block.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 32;             // rows (and columns) per tile
constexpr int kMaxPC = 8;          // P / 16 output columns per thread
constexpr int kMaxS = 32;          // P * N / kThreads state entries per thread

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ xd, const float* __restrict__ dA,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                float* __restrict__ y, int H, int nc, int Q, int P, int N) {
  extern __shared__ float smem[];
  const int NP = N + 1;             // padded row strides: no bank conflicts
  const int PP = P + 1;
  float* sS = smem;                 // (P, NP)   the carried state
  float* sCs = sS + P * NP;         // (Q,)      cumsum of dA in the chunk
  float* sC = sCs + Q;              // (kT, NP)  rows of C for the row tile
  float* sB = sC + kT * NP;         // (kT, NP)  rows of B for a column tile
  float* sX = sB + kT * NP;         // (kT, PP)  rows of xd for a column tile
  float* sW = sX + kT * PP;         // (kT, kT+1) masked C B^T tile

  const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int ty = t / 16, tx = t % 16;     // output mapping: rows ty, ty+16
  const int pc = P / 16;                  // columns tx + 16 m, m < pc
  const int warp = t / 32, lane = t % 32;

  for (int e = t; e < P * NP; e += kThreads) sS[e] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const long long bhc = ((long long)b * H + h) * nc + c;
    const float* xc = xd + bhc * Q * P;
    const float* dac = dA + bhc * Q;
    const float* Bc = Bm + ((long long)b * nc + c) * Q * N;
    const float* Cc = Cm + ((long long)b * nc + c) * Q * N;
    float* yc = y + bhc * Q * P;

    // cumsum of dA over the chunk: warp 0, each lane a run of
    // consecutive steps, then a shuffle scan of the lanes' totals
    __syncthreads();                       // previous chunk done with sCs
    if (warp == 0) {
      const int per = (Q + 31) / 32;
      const int lo = lane * per;
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
    __syncthreads();
    const float cs_last = sCs[Q - 1];

    for (int i0 = 0; i0 < Q; i0 += kT) {
      for (int e = t; e < kT * N; e += kThreads) {
        const int r = e / N, n = e % N;
        sC[r * NP + n] = (i0 + r < Q) ? Cc[(long long)(i0 + r) * N + n] : 0.f;
      }
      __syncthreads();

      // the carried state's term: exp(cs[i]) C[i,:] S^T
      float acc[2][kMaxPC];
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int m = 0; m < kMaxPC; ++m) acc[k][m] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float c0 = sC[ty * NP + n], c1 = sC[(ty + 16) * NP + n];
#pragma unroll
        for (int m = 0; m < kMaxPC; ++m) {
          if (m < pc) {
            const float s = sS[(tx + 16 * m) * NP + n];
            acc[0][m] = fmaf(c0, s, acc[0][m]);
            acc[1][m] = fmaf(c1, s, acc[1][m]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = i0 + ty + 16 * k;
        const float d = (i < Q) ? expf(sCs[i]) : 0.f;
#pragma unroll
        for (int m = 0; m < kMaxPC; ++m) acc[k][m] *= d;
      }

      // the in-chunk term over the causal column tiles j0 <= i0
      for (int j0 = 0; j0 <= i0; j0 += kT) {
        for (int e = t; e < kT * N; e += kThreads) {
          const int r = e / N, n = e % N;
          sB[r * NP + n] =
              (j0 + r < Q) ? Bc[(long long)(j0 + r) * N + n] : 0.f;
        }
        for (int e = t; e < kT * P; e += kThreads) {
          const int r = e / P, p = e % P;
          sX[r * PP + p] =
              (j0 + r < Q) ? xc[(long long)(j0 + r) * P + p] : 0.f;
        }
        __syncthreads();
        // W[r][s] = (C_r . B_s) L: rows warp + 8k, column lane
#pragma unroll
        for (int k = 0; k < kT / 8; ++k) {
          const int r = warp + 8 * k, s = lane;
          const int i = i0 + r, j = j0 + s;
          float dot = 0.f;
          for (int n = 0; n < N; ++n)
            dot = fmaf(sC[r * NP + n], sB[s * NP + n], dot);
          // mask inside the exp, as the plain version does: exp(-1e30) = 0
          const float lij =
              (i < Q && j < Q && i >= j) ? expf(sCs[i] - sCs[j]) : 0.f;
          sW[r * (kT + 1) + s] = dot * lij;
        }
        __syncthreads();
        for (int s = 0; s < kT; ++s) {
          const float w0 = sW[ty * (kT + 1) + s];
          const float w1 = sW[(ty + 16) * (kT + 1) + s];
#pragma unroll
          for (int m = 0; m < kMaxPC; ++m) {
            if (m < pc) {
              const float x = sX[s * PP + tx + 16 * m];
              acc[0][m] = fmaf(w0, x, acc[0][m]);
              acc[1][m] = fmaf(w1, x, acc[1][m]);
            }
          }
        }
        __syncthreads();                   // before the next tile's loads
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = i0 + ty + 16 * k;
        if (i < Q) {
#pragma unroll
          for (int m = 0; m < kMaxPC; ++m)
            if (m < pc) yc[(long long)i * P + tx + 16 * m] = acc[k][m];
        }
      }
    }

    // state update: S exp(cs_last) + xd^T (B o exp(cs_last - cs)),
    // each thread owning entries t + 256 k of the (P, N) state
    const int ns = (P * N + kThreads - 1) / kThreads;
    const float chunk_decay = expf(cs_last);
    float st[kMaxS];
#pragma unroll
    for (int k = 0; k < kMaxS; ++k) {
      const int e = t + kThreads * k;
      st[k] = (k < ns && e < P * N) ? sS[(e / N) * NP + e % N] * chunk_decay
                                    : 0.f;
    }
    for (int l0 = 0; l0 < Q; l0 += kT) {
      __syncthreads();                     // sB/sX free
      for (int e = t; e < kT * N; e += kThreads) {
        const int r = e / N, n = e % N;
        const int l = l0 + r;
        sB[r * NP + n] = (l < Q) ? Bc[(long long)l * N + n] *
                                       expf(cs_last - sCs[l])
                                 : 0.f;
      }
      for (int e = t; e < kT * P; e += kThreads) {
        const int r = e / P, p = e % P;
        sX[r * PP + p] = (l0 + r < Q) ? xc[(long long)(l0 + r) * P + p] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kMaxS; ++k) {
        const int e = t + kThreads * k;
        if (k < ns && e < P * N) {
          const int p = e / N, n = e % N;
          float a = st[k];
          for (int r = 0; r < kT; ++r)
            a = fmaf(sX[r * PP + p], sB[r * NP + n], a);
          st[k] = a;
        }
      }
    }
    __syncthreads();                       // every thread done reading sS
#pragma unroll
    for (int k = 0; k < kMaxS; ++k) {
      const int e = t + kThreads * k;
      if (k < ns && e < P * N) sS[(e / N) * NP + e % N] = st[k];
    }
  }
}

size_t smem_bytes(int Q, int P, int N) {
  return sizeof(float) * ((size_t)P * (N + 1) + Q + 2 * kT * (N + 1) +
                          kT * (P + 1) + kT * (kT + 1));
}

}  // namespace

// Bytes of dynamic shared memory one block needs for (Q, P, N).
extern "C" long long ssd_scan_smem_bytes(int Q, int P, int N) {
  return (long long)smem_bytes(Q, P, N);
}

// xd (B,H,nc,Q,P), dA (B,H,nc,Q), Bm and Cm (B,nc,Q,N), y (B,H,nc,Q,P):
// contiguous fp32 on the device. Returns the cudaError_t of the launch.
extern "C" int ssd_scan_launch(const void* xd, const void* dA, const void* Bm,
                               const void* Cm, void* y, int B, int H, int nc,
                               int Q, int P, int N, void* stream) {
  if (B <= 0 || H <= 0 || nc <= 0) return 0;
  if (Q <= 0 || P <= 0 || N <= 0 || P % 16 != 0 || P / 16 > kMaxPC ||
      P * N > kMaxS * kThreads)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(Q, P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)H, (unsigned)B);
  ssd_scan_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xd), static_cast<const float*>(dA),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<float*>(y), H, nc, Q, P, N);
  return (int)cudaGetLastError();
}
