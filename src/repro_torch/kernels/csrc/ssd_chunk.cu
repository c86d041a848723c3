// Mamba2 / SSD chunked scan (n_groups = 1) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_chunk.py::ssd_chunk_scan
// (pallas_call at l.93, body `_kernel` l.26).  For x [B, L, H, P],
// dt [B, L, H] (after softplus), a [H] (negative), bm / cm [B, L, N] and
// d_skip [H], all fp32, it walks the chunks of Q steps in order, carrying
// the state [P, N] of each (b, h) in fp32.  Per chunk, with the state from
// *before* the chunk:
//   cs_q    = sum_{k <= q} dt_k * a           (inclusive, summed in order)
//   dtx     = dt * x
//   y_q     = sum_{k <= q} (C_q . B_k) exp(cs_q - cs_k) dtx_k      (intra)
//           + exp(cs_q) (C_q . state)                              (inter)
//           + D * x_q
//   state   = state * exp(cs_end) + sum_k exp(cs_end - cs_k) dtx_k (x) B_k
// and writes the last chunk's state as h_final [B, H, P, N].  On the Mamba2
// serving path (repro/models/mamba2.py::_ssd_chunked, which the kernel
// replaces there) it runs once a layer at prefill: 48 launches at
// mamba2-370m's [64, 512, 32, 64], N = 128, Q = 256.
//
// Where it goes wrong if written naively: exp(cs_q - cs_k) for k > q
// overflows fp32 for the fast heads (|cs| reaches ~10^2 within a chunk), so
// a 0/1 mask times it gives inf * 0 = NaN.  The kernel never evaluates it
// above the diagonal: G[q, k] is written as 0 there.  exp's argument is <= 0
// everywhere else.
//
// What bounds it on this card: operations.  Counting the intra term's
// causal half and C . B once per (b, chunk) (it does not depend on the
// head), one launch at the serving shape is ~52 GFLOP against ~0.6 GB of
// traffic: ~0.8 ms at the 67 TFLOP/s fp32 CUDA-core peak.  This first
// kernel recomputes C . B for every head (~1.9x the bound's operations)
// and uses no tensor cores (the comparisons are fp32; no TF32).
//
// Design: one block of 256 threads per (b, h), the chunk loop inside.
// Shared memory holds the chunk's dtx [Q, P], the state [P, N], one tile of
// 64 query rows of G = (C B^T) * decay [64, Q], that tile's C [64, N] and a
// tile of 32 rows of B [32, N] (rows padded by one float against bank
// conflicts): ~211 KB at Q = 256, P = 64, N = 128, so one block an SM.  The
// cumulative sum is taken by one thread, in order.  Each thread keeps a
// 4 x 4 (y), 4 x 2 (G) or 8 x 4 (state) register tile.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTQ = 64;    // query rows of G and y per tile
constexpr int kTK = 32;    // rows of B staged at a time

__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int rows, int n, int stride) {
  // dst[r * stride + c] = src[r * n + c] for r < rows, c < n.
  for (int e = threadIdx.x; e < rows * n; e += kThreads) {
    const int r = e / n;
    const int c = e - r * n;
    dst[r * stride + c] = src[(size_t)r * n + c];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_scan_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ a,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ d_skip,
                      float* __restrict__ y, float* __restrict__ h_out,
                      int L, int H, int P, int N, int Q) {
  extern __shared__ float smem[];
  const int NS = N + 1;              // padded row of B, C and the state
  const int GS = Q + 1;              // padded row of G
  float* dtx = smem;                 // [Q][P]
  float* st = dtx + Q * P;           // [P][NS]
  float* G = st + P * NS;            // [kTQ][GS]
  float* Ct = G + kTQ * GS;          // [kTQ][NS]
  float* Bt = Ct + kTQ * NS;         // [kTK][NS]
  float* cs = Bt + kTK * NS;         // [Q]
  float* wq = cs + Q;                // [Q]: dt, then exp(cs_end - cs_k)

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int tid = threadIdx.x;
  const float ah = a[h];
  const float dh = d_skip[h];
  const size_t row_stride = (size_t)H * P;   // x / y: one step of L

  for (int e = tid; e < P * NS; e += kThreads) st[e] = 0.0f;

  for (int c0 = 0; c0 < L; c0 += Q) {
    const size_t step0 = (size_t)b * L + c0;   // first step of the chunk
    const float* xc = x + step0 * row_stride + (size_t)h * P;
    float* yc = y + step0 * row_stride + (size_t)h * P;
    const float* bc = bm + step0 * N;
    const float* cc = cm + step0 * N;

    __syncthreads();             // the last chunk's readers are done
    for (int q = tid; q < Q; q += kThreads) wq[q] = dt[(step0 + q) * H + h];
    __syncthreads();
    if (tid == 0) {              // cs in order, as a sequential cumsum
      float run = 0.0f;
      for (int q = 0; q < Q; ++q) {
        run = __fadd_rn(run, __fmul_rn(wq[q], ah));
        cs[q] = run;
      }
    }
    for (int e = tid; e < Q * P; e += kThreads) {
      const int q = e / P;
      const int p = e - q * P;
      dtx[e] = __fmul_rn(wq[q], xc[(size_t)q * row_stride + p]);
    }
    __syncthreads();
    const float cs_end = cs[Q - 1];
    for (int q = tid; q < Q; q += kThreads) wq[q] = expf(cs_end - cs[q]);

    // ---- y, one tile of kTQ query rows at a time ------------------------
    for (int q0 = 0; q0 < Q; q0 += kTQ) {
      const int tq = min(kTQ, Q - q0);
      const int kmax = q0 + tq;          // causal: k < q0 + tq
      __syncthreads();                   // Ct / G of the last tile read
      stage_rows(Ct, cc + (size_t)q0 * N, tq, N, NS);
      {
        // G tile: thread owns q = qq + 16 i (i < 4), k = kk + 16 j (j < 2).
        const int kk = tid % 16;
        const int qq = tid / 16;
        for (int k0 = 0; k0 < kmax; k0 += kTK) {
          const int tk = min(kTK, kmax - k0);
          __syncthreads();               // Bt free (and Ct staged)
          stage_rows(Bt, bc + (size_t)k0 * N, tk, N, NS);
          __syncthreads();
          float acc[4][2] = {};
          for (int n = 0; n < N; ++n) {
            float cv[4], bv[2];
#pragma unroll
            for (int i = 0; i < 4; ++i) cv[i] = Ct[(qq + 16 * i) * NS + n];
#pragma unroll
            for (int j = 0; j < 2; ++j) bv[j] = Bt[(kk + 16 * j) * NS + n];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 2; ++j) acc[i][j] = fmaf(cv[i], bv[j],
                                                           acc[i][j]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int q = qq + 16 * i;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int k = kk + 16 * j;
              if (q >= tq || k >= tk) continue;
              const int gq = q0 + q;
              const int gk = k0 + k;
              // Above the diagonal exp(cs_q - cs_k) may be inf: never
              // evaluated, the weight is 0.
              G[q * GS + gk] = gk <= gq
                  ? __fmul_rn(acc[i][j], expf(cs[gq] - cs[gk])) : 0.0f;
            }
          }
        }
      }
      __syncthreads();                   // G complete
      // y tile: thread owns q = qi + 16 i (i < 4), p = pi + 16 j (j < 4).
      const int pi = tid % 16;
      const int qi = tid / 16;
      float yi[4][4] = {};
      float ye[4][4] = {};
      for (int k = 0; k < kmax; ++k) {
        float g[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) g[i] = G[(qi + 16 * i) * GS + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = dtx[k * P + pi + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) yi[i][j] = fmaf(g[i], xv[j], yi[i][j]);
      }
      for (int n = 0; n < N; ++n) {      // C_q . state, the state before
        float cv[4], sv[4];              // this chunk's update
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Ct[(qi + 16 * i) * NS + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) sv[j] = st[(pi + 16 * j) * NS + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) ye[i][j] = fmaf(cv[i], sv[j], ye[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = qi + 16 * i;
        if (q >= tq) continue;
        const float cin = expf(cs[q0 + q]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = pi + 16 * j;
          if (p >= P) continue;
          const size_t off = (size_t)(q0 + q) * row_stride + p;
          const float v = __fadd_rn(yi[i][j], __fmul_rn(cin, ye[i][j]));
          yc[off] = __fadd_rn(v, __fmul_rn(dh, xc[off]));
        }
      }
    }

    // ---- state update: thread owns p = sp + 8 i (i < 8), n = sn + 32 j --
    const int sn = tid % 32;
    const int sp = tid / 32;
    float acc[8][4] = {};
    for (int k0 = 0; k0 < Q; k0 += kTK) {
      const int tk = min(kTK, Q - k0);
      __syncthreads();                   // Bt free; every y tile done
      stage_rows(Bt, bc + (size_t)k0 * N, tk, N, NS);
      __syncthreads();
      for (int k = 0; k < tk; ++k) {
        const float w = wq[k0 + k];
        float xv[8], bv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          xv[i] = __fmul_rn(w, dtx[(k0 + k) * P + sp + 8 * i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bt[k * NS + sn + 32 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], bv[j],
                                                       acc[i][j]);
      }
    }
    const float dec = expf(cs_end);
    const bool last = c0 + Q >= L;
    float* hb = h_out + (size_t)blockIdx.x * P * N;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = sp + 8 * i;
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = sn + 32 * j;
        if (n >= N) continue;
        const float s = __fadd_rn(__fmul_rn(st[p * NS + n], dec), acc[i][j]);
        st[p * NS + n] = s;              // each entry read and written by
        if (last) hb[p * N + n] = s;     // its one owner
      }
    }
  }
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block needs for chunks of Q steps.
int ssd_chunk_scan_smem(int P, int N, int Q) {
  return (Q * P + P * (N + 1) + kTQ * (Q + 1) + kTQ * (N + 1) +
          kTK * (N + 1) + 2 * Q) *
         (int)sizeof(float);
}

// Launches y [B, L, H, P] and h_out [B, H, P, N] on `stream`; the wrapper
// checks L % Q == 0, P <= 64, N <= 128 and that the shared memory fits.
// Returns cudaGetLastError().
int ssd_chunk_scan_launch(const float* x, const float* dt, const float* a,
                          const float* bm, const float* cm,
                          const float* d_skip, float* y, float* h_out, int B,
                          int L, int H, int P, int N, int Q, void* stream) {
  const int smem = ssd_chunk_scan_smem(P, N, Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_scan_kernel<<<B * H, kThreads, smem, (cudaStream_t)stream>>>(
      x, dt, a, bm, cm, d_skip, y, h_out, L, H, P, N, Q);
  return (int)cudaGetLastError();
}

}  // extern "C"
