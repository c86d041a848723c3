// Mamba2 / SSD chunked scan (n_groups = 1) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_chunk.py::ssd_chunk_scan
// (pallas_call at l.93, body `_kernel` l.26).  For x [B, L, H, P],
// dt [B, L, H] (after softplus), a [H] (negative), bm / cm [B, L, N] and
// d_skip [H], all fp32, it walks the chunks of Q steps in order, carrying
// the state [P, N] of each (b, h) in fp32.  Per chunk, with the state from
// *before* the chunk:
//   cs_q    = sum_{k <= q} dt_k * a           (inclusive)
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
// traffic: ~0.8 ms at the 67 TFLOP/s fp32 CUDA-core peak.  No tensor cores
// (the comparisons are fp32; no TF32).
//
// Design: three kernels, one counted launch of the wrapper.
//  * ssd_chunk_scan_kernel_cumsum: cs of every (b, chunk, h), one thread
//    each, summed in order into a scratch [B, L, H] -- the order of the
//    plain version's torch.cumsum along the chunk axis, whose CUDA scan of
//    a non-innermost dimension runs each column in order.  The log-decays
//    reach ~-700 within a chunk at the serving shape, and their rounding
//    is most of an fp32 evaluation's error there: a warp scan (a parallel
//    scan in another order, tried on the card) left the kernel 1.3e-4 from
//    the plain version, above SSD_TOL, with each of the two ~1.1e-4 from a
//    float64 evaluation.  In order, and one thread a chain, the 4,096
//    chains of the serving shape run side by side.
//  * ssd_chunk_scan_kernel_scores: C . B once per (b, chunk) -- not once
//    per head -- by way (a), a pre-pass into a scratch the wrapper
//    allocates: S^T[b, c, k, q] = B_k . C_q for k <= q, in 64 x 64 tiles of
//    the causal half (4 x 4 a thread).  At the serving shape the scratch is
//    [64, 2, 256, 256] fp32, 33.5 MB, which the 50 MB L2 holds; the head
//    blocks of one b run side by side and read the same tiles.  The tiles
//    of the first row also write C^T [b, c, N, Q] (16.8 MB), so the head
//    kernel stages whole rows.  Way (b), a thread-block cluster sharing
//    C . B through distributed shared memory, would keep the 32 heads of a
//    b in one cluster (at most 16 blocks, the non-portable limit) and tie
//    their schedules together; the pre-pass is simpler and costs one extra
//    read of the scores a head, from L2.
//  * ssd_chunk_scan_kernel: one block of 256 threads per (b, h), the chunk
//    loop inside, ~96 KB of shared memory, so two blocks (16 warps) an SM.
//    Per chunk, after reading cs from the cumsum scratch:
//    - y = [C | G'] x [state^T ; x] as one register-tiled product: each
//      thread owns 8 query rows x 8 columns of p (64 accumulators), the
//      rows two groups of 16 -- warp w holds groups w and 15 - w, so the
//      causal work is the same for every warp -- and each k (or n) step
//      issues four float4 shared loads for 64 FMAs.  The inter term runs
//      first over n in tiles of 16 (skipped in the first chunk, whose state
//      is zero), its rows then scaled by exp(cs_q); the intra term
//      continues the same sums over k in tiles of 16 steps, with
//      G' = (S * exp(cs_q - cs_k)) * dt_k formed in the staged tile (0
//      above the diagonal, exp never evaluated there); a group skips every
//      k tile past its last row, and its diagonal tile is zero above the
//      diagonal;
//    - the state update dstate = x^T x (B * (dt * exp(cs_end - cs))) in
//      tiles of 16 steps, 4 x 8 a thread (32 accumulators), then state =
//      state * exp(cs_end) + dstate by each entry's owner.
//    The plain version rounds dt * x first; the kernel puts dt on the other
//    factor (the same operations, associated otherwise) and sums in
//    another order: within SSD_TOL, not bit-equal.
//    Operands are staged in a ring of three slots by cp.async
//    (mcd_async.cuh; 16 bytes a copy where the rows are aligned, else 4;
//    zeros out of range), two steps ahead; once its own copies have landed
//    each thread applies the factors to the elements it copied (the decay
//    and dt of G', B's dt * exp(cs_end - cs)), and one barrier a step
//    publishes the tile and frees the slot the next copies go to.
// Shapes: Q <= 256 (8 warps x 2 groups of 16 query rows), P <= 64, N <= 128
// (the register tiles); a partial tile (Q, P or N short of it) is zero-filled
// in shared memory.  Every kernel's name holds "ssd_chunk_scan_kernel", the
// name a profile of the scan matches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mcd_async.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQMax = 256;   // query rows a block holds: 8 warps x 2 x 16
constexpr int kPMax = 64;    // columns of y and rows of the state
constexpr int kNMax = 128;   // columns of the state
constexpr int kBK = 16;      // k steps (or n columns) a staged tile
constexpr int kTS = kQMax + 4;   // row stride of a [kBK][q] tile
constexpr int kStages = 3;   // the ring of staged tiles
// A ring slot: one [kBK][kTS] tile (or a [kBK][kNMax] tile of B) and one
// [kBK][kPMax] tile of x.
constexpr int kStage = kBK * kTS + kBK * kPMax;
// Shared floats of the head kernel: the state^T [kNMax][kPMax], the ring,
// and cs / exp(cs) / dt * exp(cs_end - cs) / dt [kQMax] each.
constexpr int kSmemFloats = kNMax * kPMax + kStages * kStage + 4 * kQMax;

constexpr int kST = 64;          // the scores pre-pass: 64 x 64 tiles
constexpr int kSTS = kST + 4;    // row stride of its transposed operands

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// acc[i][j] += u[i] * v[j] for a 4-vector u and two 4-vectors v0, v1.
__device__ __forceinline__ void outer4x8(float (&acc)[4][8], float4 u,
                                         float4 v0, float4 v1) {
  const float a[4] = {u.x, u.y, u.z, u.w};
  const float b[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

// The scores pre-pass: for one (b, chunk) and one 64 x 64 tile (kt <= qt)
// of the causal half, S^T[k][q] = B_k . C_q for k <= q < Q.  Entries above
// the diagonal are not written (the head kernel never reads them).  The
// tiles of the first row (kt = 0) also write C^T[n][q] of their q, the
// head kernel's operand of the inter term, transposed once per (b, chunk).
__global__ void __launch_bounds__(kThreads)
ssd_chunk_scan_kernel_scores(const float* __restrict__ bm,
                             const float* __restrict__ cm,
                             float* __restrict__ scores,
                             float* __restrict__ ctr, int L, int N, int Q,
                             int nc, int tiles) {
  extern __shared__ float smem[];
  float* bt = smem;                   // [N][kSTS]: B_k, k of the tile
  float* ct = bt + N * kSTS;          // [N][kSTS]: C_q, q of the tile
  const int bc = blockIdx.x / tiles;  // (b, chunk)
  int t = blockIdx.x - bc * tiles;
  int kt = 0;                         // the t-th tile of the causal half,
  const int nt = (Q + kST - 1) / kST; // row by row: (kt, qt >= kt)
  while (t >= nt - kt) {
    t -= nt - kt;
    ++kt;
  }
  const int qt = kt + t;
  const int b = bc / nc;
  const int c = bc - b * nc;
  const size_t step0 = (size_t)b * L + (size_t)c * Q;
  const int k0 = kt * kST, q0 = qt * kST;
  const int tid = threadIdx.x;
  // Transposing stores: lane n, 4 rows a thread (conflict-free: kSTS is 4
  // mod 32).
  for (int e = tid; e < (kST / 4) * N; e += kThreads) {
    const int n = e % N;
    const int r4 = 4 * (e / N);
    float vb[4], vc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + r4 + i, q = q0 + r4 + i;
      vb[i] = k < Q ? bm[(step0 + k) * N + n] : 0.0f;
      vc[i] = q < Q ? cm[(step0 + q) * N + n] : 0.0f;
    }
    st4(bt + n * kSTS + r4, vb[0], vb[1], vb[2], vb[3]);
    st4(ct + n * kSTS + r4, vc[0], vc[1], vc[2], vc[3]);
  }
  __syncthreads();
  if (kt == 0) {                      // C^T[n][q] of the chunk, once
    float* out = ctr + (size_t)bc * N * Q;
    for (int e = tid; e < N * kST; e += kThreads) {
      const int n = e / kST, r = e - n * kST;
      if (q0 + r < Q) out[(size_t)n * Q + q0 + r] = ct[n * kSTS + r];
    }
  }
  const int tk = 4 * (tid / 16);      // 4 k rows
  const int tq = 4 * (tid % 16);      // 4 q columns
  float acc[4][4] = {};
  for (int n = 0; n < N; ++n) {
    const float4 u = ld4(bt + n * kSTS + tk);
    const float4 v = ld4(ct + n * kSTS + tq);
    const float a[4] = {u.x, u.y, u.z, u.w};
    const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
  }
  float* out = scores + (size_t)bc * Q * Q;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + tk + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = q0 + tq + j;
      if (k <= q && q < Q) out[(size_t)k * Q + q] = acc[i][j];
    }
  }
}

// cs[b, c Q + q, h] = sum_{k <= q} dt[b, c Q + k, h] * a[h] within each
// chunk c, in order: one thread per (b, chunk, h), h fastest (coalesced).
__global__ void __launch_bounds__(kThreads)
ssd_chunk_scan_kernel_cumsum(const float* __restrict__ dt,
                             const float* __restrict__ a,
                             float* __restrict__ cs, int chains, int H,
                             int Q) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= chains) return;
  const int bc = e / H;               // (b, chunk): its steps are
  const int h = e - bc * H;           // [bc Q, bc Q + Q) of B x L
  const float ah = a[h];
  const size_t i0 = (size_t)bc * Q * H + h;
  float run = 0.0f;
#pragma unroll 8
  for (int q = 0; q < Q; ++q) {
    run = __fadd_rn(run, __fmul_rn(dt[i0 + (size_t)q * H], ah));
    cs[i0 + (size_t)q * H] = run;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_scan_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ bm,
                      const float* __restrict__ d_skip,
                      const float* __restrict__ scores,
                      const float* __restrict__ ctr,
                      const float* __restrict__ csum,
                      float* __restrict__ y, float* __restrict__ h_out,
                      int L, int H, int P, int N, int Q, int vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* st = smem;                   // [kNMax][kPMax]: state^T, st[n][p]
  float* ring = st + kNMax * kPMax;   // kStages x ([kBK][kTS] + [kBK][kPMax])
  float* cs = ring + kStages * kStage;  // [kQMax]
  float* cin = cs + kQMax;            // [kQMax]: exp(cs_q)
  float* dw = cin + kQMax;            // [kQMax]: dt_k * exp(cs_end - cs_k)
  float* dts = dw + kQMax;            // [kQMax]: dt_k

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const float dh = d_skip[h];
  const size_t row_stride = (size_t)H * P;   // x / y: one step of L
  const int Q16 = (Q + kBK - 1) / kBK * kBK; // query rows staged
  // The steps of a chunk: ni over n (the inter term), then nk over k (the
  // intra term), then nk over k again (the state update).
  const int ni = (N + kBK - 1) / kBK, nk = Q16 / kBK;
  const int steps = ni + 2 * nk;

  // y's register tile: rows 16 g + tq + i of the two groups g = gq[0],
  // gq[1]; columns tp + j and 32 + tp + j.
  const int tq = 4 * (lane >> 3), tp = 4 * (lane & 7);
  const int gq[2] = {warp, 15 - warp};
  // The state update's tile: p = sp + i, n = sn + j and 64 + sn + j.
  const int sp = 4 * (tid & 15), sn = 4 * (tid >> 4);

  for (int e = tid; e < kNMax * kPMax; e += kThreads) st[e] = 0.0f;

  for (int c0 = 0; c0 < L; c0 += Q) {
    const size_t step0 = (size_t)b * L + c0;   // first step of the chunk
    const int bc = b * (L / Q) + c0 / Q;
    const float* xc = x + step0 * row_stride + (size_t)h * P;
    float* yc = y + step0 * row_stride + (size_t)h * P;
    const float* bk = bm + step0 * N;
    const float* sc = scores + (size_t)bc * Q * Q;
    const float* cc = ctr + (size_t)bc * N * Q;

    // Chunk c4 (4 floats) of a row whose first `len` floats are valid,
    // from src to dst, zeros past len: 16 bytes at a time where the rows
    // are 16-byte aligned (vec), else 4.  A copy that reads nothing still
    // names a mapped address (x).
    auto copy4 = [&](float* dst, const float* src, int c4, int len) {
      const int v = min(4, max(0, len - 4 * c4));
      if (vec) {
        mcd::cp_async16(dst + 4 * c4, v ? src + 4 * c4 : x, 4 * v);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          mcd::cp_async4(dst + 4 * c4 + i, i < v ? src + 4 * c4 + i : x,
                         i < v);
      }
    };
    // Step s stages into ring slot s % kStages: the tile (C^T rows, the
    // scores S^T rows, or B rows) and, for k steps, the x rows.  Out of
    // range: zeros.  finish(s) then applies each element's factors, by the
    // thread that copied it, once its copies have landed:
    //   intra:  tile[kk][q] = S^T[k][q] * exp(cs_q - cs_k) * dt_k for
    //           k <= q, else 0 (exp never evaluated there)
    //   update: tile[kk][n] = B[k][n] * (dt_k * exp(cs_end - cs_k))
    // (the inter term's exp(cs_q) scales the sums' rows after its steps).
    auto walk = [&](int s, bool copy) {
      float* tile = ring + (s % kStages) * kStage;
      float* xs = tile + kBK * kTS;
      if (s < ni) {                    // C^T rows n0 + kk, q < Q16
        if (!copy) return;
        const int n0 = s * kBK;
        for (int kk = warp; kk < kBK; kk += kThreads / 32) {
          const bool ok = n0 + kk < N;
          for (int c4 = lane; c4 < Q16 / 4; c4 += 32)
            copy4(tile + kk * kTS, cc + (size_t)(n0 + kk) * Q, c4,
                  ok ? Q : 0);
        }
        return;
      }
      const bool intra = s < ni + nk;
      const int k0 = (intra ? s - ni : s - ni - nk) * kBK;
      if (intra) {                     // S^T rows k, q in [k0, Q16)
        for (int kk = warp; kk < kBK; kk += kThreads / 32) {
          const int k = k0 + kk;
          float* d = tile + kk * kTS + k0;
          const float* src = sc + (size_t)k * Q + k0;
          for (int c4 = lane; c4 < (Q16 - k0) / 4; c4 += 32) {
            if (copy) {
              copy4(d, src, c4, k < Q ? Q - k0 : 0);
            } else {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int q = k0 + 4 * c4 + i;
                float* e = d + 4 * c4 + i;
                *e = (k <= q && q < Q)
                         ? __fmul_rn(__fmul_rn(*e, expf(cs[q] - cs[k])),
                                     dts[k])
                         : 0.0f;
              }
            }
          }
        }
      } else {                         // B rows k, n < 128
        for (int e = tid; e < kBK * kNMax / 4; e += kThreads) {
          const int kk = e / (kNMax / 4), c4 = e - kk * (kNMax / 4);
          const int k = k0 + kk;
          float* d = tile + kk * kNMax;
          if (copy) {
            copy4(d, bk + (size_t)k * N, c4, k < Q ? N : 0);
          } else if (k < Q) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              d[4 * c4 + i] = __fmul_rn(d[4 * c4 + i], dw[k]);
          }
        }
      }
      if (copy) {                      // x rows k, p < 64: one chunk each
        const int kk = tid / (kPMax / 4), c4 = tid - kk * (kPMax / 4);
        const int k = k0 + kk;
        copy4(xs + kk * kPMax, xc + (size_t)k * row_stride, c4,
              k < Q ? P : 0);
      }
    };
    // Before step s's products: step s's copies have landed and are
    // finished, the block has met (so every thread is done with step
    // s - 1's slot), and step s + kStages - 1's copies into that slot
    // start.  One commit group a step, empty ones too, so a wait counts
    // steps.
    auto begin = [&](int s) {
      mcd::cp_async_wait<kStages - 2>();
      walk(s, false);
      __syncthreads();
      if (s + kStages - 1 < steps) walk(s + kStages - 1, true);
      mcd::cp_async_commit();
    };

    // ---- the chunk's dt, cs (from the cumsum kernel) and decays --------
    __syncthreads();                   // the last chunk's readers are done
    if (tid < Q) {
      dts[tid] = dt[(step0 + tid) * H + h];
      cs[tid] = csum[(step0 + tid) * H + h];
    }
    __syncthreads();
    const float cs_end = cs[Q - 1];
    if (tid < Q) {
      dw[tid] = __fmul_rn(dts[tid], expf(cs_end - cs[tid]));
      cin[tid] = expf(cs[tid]);
    }
    // The first chunk starts from the zero state: its inter term is zero,
    // and its steps are skipped.
    int s = c0 == 0 ? ni : 0;
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (s + i < steps) walk(s + i, true);
      mcd::cp_async_commit();
    }
    {
      // ---- y: the inter term over n, then the intra term over k --------
      float acc[2][4][8] = {};
      for (; s < ni; ++s) {
        begin(s);
        // Rows n >= N of the tile and of the state are zeros; so are the
        // staged rows q >= Q (a group past Q computes what is not stored).
        const float* tile = ring + (s % kStages) * kStage;
        const float* sr = st + s * kBK * kPMax;
#pragma unroll 4
        for (int nn = 0; nn < kBK; ++nn) {
          const float4 s0 = ld4(sr + nn * kPMax + tp);
          const float4 s1 = ld4(sr + nn * kPMax + 32 + tp);
          outer4x8(acc[0], ld4(tile + nn * kTS + 16 * gq[0] + tq), s0, s1);
          outer4x8(acc[1], ld4(tile + nn * kTS + 16 * gq[1] + tq), s0, s1);
        }
      }
      // exp(cs_q) (C_q . state): each row of the inter sums scaled once.
#pragma unroll
      for (int g = 0; g < 2; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float f = cin[min(16 * gq[g] + tq + i, kQMax - 1)];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[g][i][j] = __fmul_rn(acc[g][i][j], f);
        }
      for (; s < ni + nk; ++s) {
        begin(s);
        const float* tile = ring + (s % kStages) * kStage;
        const float* xs = tile + kBK * kTS;
        // Group g holds rows [16 g, 16 g + 16): the k tiles past its last
        // row add nothing and are not staged for it, so it skips them; its
        // diagonal tile is zero above the diagonal.  gq[1] >= gq[0], so
        // the second group is live whenever the first is.
        const int t = s - ni;
        if (gq[0] >= t) {
#pragma unroll 4
          for (int kk = 0; kk < kBK; ++kk) {
            const float4 d0 = ld4(xs + kk * kPMax + tp);
            const float4 d1 = ld4(xs + kk * kPMax + 32 + tp);
            outer4x8(acc[0], ld4(tile + kk * kTS + 16 * gq[0] + tq), d0, d1);
            outer4x8(acc[1], ld4(tile + kk * kTS + 16 * gq[1] + tq), d0, d1);
          }
        } else if (gq[1] >= t) {
#pragma unroll 4
          for (int kk = 0; kk < kBK; ++kk)
            outer4x8(acc[1], ld4(tile + kk * kTS + 16 * gq[1] + tq),
                     ld4(xs + kk * kPMax + tp),
                     ld4(xs + kk * kPMax + 32 + tp));
        }
      }
#pragma unroll
      for (int g = 0; g < 2; ++g) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = 16 * gq[g] + tq + i;
          if (q >= Q) continue;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int p = (j < 4 ? 0 : 28) + tp + j;
            if (p >= P) continue;
            const size_t off = (size_t)q * row_stride + p;
            yc[off] = __fadd_rn(acc[g][i][j], __fmul_rn(dh, xc[off]));
          }
        }
      }
    }

    // ---- state = state * exp(cs_end) + x^T (B * dt * exp(cs_end - cs)) -
    float ds[4][8] = {};
    for (; s < steps; ++s) {
      begin(s);
      // Rows k >= Q of both tiles are zeros.
      const float* tile = ring + (s % kStages) * kStage;
      const float* xs = tile + kBK * kTS;
#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk)
        outer4x8(ds, ld4(xs + kk * kPMax + sp), ld4(tile + kk * kNMax + sn),
                 ld4(tile + kk * kNMax + 64 + sn));
    }
    const float dec = expf(cs_end);
    const bool last = c0 + Q >= L;
    float* hb = h_out + (size_t)blockIdx.x * P * N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = (j < 4 ? 0 : 60) + sn + j;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = sp + i;
        // Each entry is read and written by its one owner.
        const float v = __fadd_rn(__fmul_rn(st[n * kPMax + p], dec),
                                  ds[i][j]);
        st[n * kPMax + p] = v;
        if (last && p < P && n < N) hb[(size_t)p * N + n] = v;
      }
    }
  }
}

// Shared memory (bytes) a head block needs (the same for every shape the
// kernel takes: Q <= 256, P <= 64, N <= 128).
constexpr int kSmemBytes = kSmemFloats * (int)sizeof(float);

// Shared memory (bytes) a block of the scores pre-pass needs for N.
int scores_smem_bytes(int N) { return 2 * N * kSTS * (int)sizeof(float); }

// The head kernel's shared memory, with the SM's carveout set to the most
// shared memory, so two blocks fit an SM.
cudaError_t fit_head_kernel() {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(ssd_chunk_scan_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

extern "C" {

// The head kernel's resident blocks an SM, as the driver computes them
// (registers, shared memory, threads); returns the CUDA error.
int ssd_chunk_scan_blocks_per_sm(int* blocks) {
  cudaError_t err = fit_head_kernel();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ssd_chunk_scan_kernel, kThreads, kSmemBytes);
}

// Launches the cumsum kernel into `cs` [B, L, H], the scores pre-pass into
// `scores` [B, L / Q, Q, Q] and `ctr` [B, L / Q, N, Q] (C^T), and the head
// kernel, y [B, L, H, P] and h_out [B, H, P, N], on `stream`.  vec != 0:
// every row the head kernel stages starts 16-byte aligned (x, bm aligned;
// P, N and Q multiples of 4), so it copies 16 bytes at a time.  The wrapper
// (kernels/ssd_chunk.py::ssd_plan) checks L % Q == 0, Q <= 256, P <= 64 and
// N <= 128.  Returns cudaGetLastError() of the last launch (0 = launched),
// or cudaErrorInvalidValue for a shape the kernel does not take.
int ssd_chunk_scan_launch(const float* x, const float* dt, const float* a,
                          const float* bm, const float* cm,
                          const float* d_skip, float* scores, float* ctr,
                          float* cs, float* y, float* h_out, int B, int L,
                          int H, int P, int N, int Q, int vec, void* stream) {
  if (Q < 1 || Q > kQMax || L % Q || P > kPMax || N > kNMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nc = L / Q;
  const int chains = B * nc * H;
  ssd_chunk_scan_kernel_cumsum<<<(chains + kThreads - 1) / kThreads,
                                 kThreads, 0, s>>>(dt, a, cs, chains, H, Q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nt = (Q + kST - 1) / kST;
  const int tiles = nt * (nt + 1) / 2;
  const int ssmem = scores_smem_bytes(N);
  err = cudaFuncSetAttribute(
      ssd_chunk_scan_kernel_scores,
      cudaFuncAttributeMaxDynamicSharedMemorySize, ssmem);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_scan_kernel_scores<<<B * nc * tiles, kThreads, ssmem, s>>>(
      bm, cm, scores, ctr, L, N, Q, nc, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = fit_head_kernel();
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_scan_kernel<<<B * H, kThreads, kSmemBytes, s>>>(
      x, dt, bm, d_skip, scores, ctr, cs, y, h_out, L, H, P, N, Q, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// bf16 (the reference's LM dtype): x, B and C bf16, dt, a and D fp32, y
// bf16 and the state fp32, with every operation of the scan in fp32 (the
// TPU kernel upcasts its inputs and keeps the state in fp32,
// ssd_chunk.py:34-68).  A first, simple design, which leaves the three
// fp32 kernels above as they were: ssd_chunk_scan_kernel_widen copies x,
// B and C into fp32 scratches (a bf16 value is exact in fp32), the fp32
// launch runs on them, and ssd_chunk_scan_kernel_narrow rounds y to bf16
// once, where the plain version's y.to(x.dtype) rounds.  At the serving
// shape the two copies move ~0.8 GB besides the scan's own traffic.  It is
// the "widen" path of ssd_plan: the bf16 shapes and pointers that the
// tensor-core kernel further below (ssd_chunk_scan_kernel_bf16_tc) does
// not take.

#include <cuda_bf16.h>

namespace {

constexpr int kCopyBlocks = 132 * 8;   // grid-stride copies: 8 blocks an SM

// dst[i] = float(src[i]), 4 elements a thread (8-byte loads, 16-byte
// stores) where both pointers allow it, the tail one at a time.
__global__ void __launch_bounds__(kThreads)
ssd_chunk_scan_kernel_widen(const __nv_bfloat16* __restrict__ src,
                            float* __restrict__ dst, long long n, int vec) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n4 = vec ? n / 4 : 0;
  for (long long i = first; i < n4; i += stride) {
    const uint2 u = reinterpret_cast<const uint2*>(src)[i];
    const float2 lo =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    reinterpret_cast<float4*>(dst)[i] = make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  for (long long i = 4 * n4 + first; i < n; i += stride)
    dst[i] = __bfloat162float(src[i]);
}

// dst[i] = bf16(src[i]), rounded to nearest even.
__global__ void __launch_bounds__(kThreads)
ssd_chunk_scan_kernel_narrow(const float* __restrict__ src,
                             __nv_bfloat16* __restrict__ dst, long long n,
                             int vec) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n4 = vec ? n / 4 : 0;
  for (long long i = first; i < n4; i += stride) {
    const float4 v = reinterpret_cast<const float4*>(src)[i];
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&lo);
    u.y = *reinterpret_cast<const unsigned*>(&hi);
    reinterpret_cast<uint2*>(dst)[i] = u;
  }
  for (long long i = 4 * n4 + first; i < n; i += stride)
    dst[i] = __float2bfloat16_rn(src[i]);
}

int copy_blocks(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (int)(b < kCopyBlocks ? (b > 0 ? b : 1) : kCopyBlocks);
}

bool aligned(const void* a, const void* b) {
  return ((uintptr_t)a % 8) == 0 && ((uintptr_t)b % 16) == 0;
}

cudaError_t widen(const void* src, float* dst, long long n,
                  cudaStream_t s) {
  const auto* p = reinterpret_cast<const __nv_bfloat16*>(src);
  ssd_chunk_scan_kernel_widen<<<copy_blocks(n), kThreads, 0, s>>>(
      p, dst, n, aligned(src, dst));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The bf16 launch: x, bm and cm widened into the fp32 scratches xw
// [B, L, H, P], bw and cw [B, L, N]; ssd_chunk_scan_launch on them into yw
// [B, L, H, P] fp32 and h_out; y [B, L, H, P] bf16 from yw.  `vec` is the
// fp32 launch's, for the scratches.  Returns the first CUDA error.
int ssd_chunk_scan_bf16_launch(const void* x, const float* dt,
                               const float* a, const void* bm,
                               const void* cm, const float* d_skip,
                               float* scores, float* ctr, float* cs, void* y,
                               float* h_out, float* xw, float* bw, float* cw,
                               float* yw, int B, int L, int H, int P, int N,
                               int Q, int vec, void* stream) {
  if (Q < 1 || Q > kQMax || L % Q || P > kPMax || N > kNMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long nx = (long long)B * L * H * P;
  const long long nb = (long long)B * L * N;
  cudaError_t err = widen(x, xw, nx, s);
  if (err == cudaSuccess) err = widen(bm, bw, nb, s);
  if (err == cudaSuccess) err = widen(cm, cw, nb, s);
  if (err != cudaSuccess) return (int)err;
  const int e = ssd_chunk_scan_launch(xw, dt, a, bw, cw, d_skip, scores, ctr,
                                      cs, yw, h_out, B, L, H, P, N, Q, vec,
                                      stream);
  if (e != 0) return e;
  auto* yb = reinterpret_cast<__nv_bfloat16*>(y);
  ssd_chunk_scan_kernel_narrow<<<copy_blocks(nx), kThreads, 0, s>>>(
      yw, yb, nx, ((uintptr_t)yw % 16) == 0 && ((uintptr_t)y % 8) == 0);
  return (int)cudaGetLastError();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: ssd_chunk_scan_kernel_bf16_tc, the bf16 scan's
// own kernel where TMA can read x, B and C (P and N multiples of 8, P <= 64,
// the three 16-byte aligned; ssd_chunk.py::ssd_plan's "tensor_cores" path;
// the widen path above takes every other bf16 shape).
//
// What bounds it.  With x, B and C at 2 bytes the scan's bytes take 0.106
// ms at the serving shape (356 MB at 3.35 TB/s) and its 53.3 GFLOP 0.054
// ms at the dense bf16 rate: bytes.  The design's own floor is higher: it
// recomputes C . B for every head (the intra term's causal tile pairs) and
// carries each fp32 operand as bf16 pieces: 159 GFLOP of wgmma at the
// serving shape (ssd_plan's "wgmma_flop"), 0.16 ms at the dense rate.
//
// The arithmetic is the fp32 kernel's (the TPU kernel upcasts and computes
// in fp32): x, B and C are bf16 values, exact on the tensor cores, and a
// bf16 x bf16 product is exact in fp32.  Three products have an fp32
// operand that is not a bf16 value -- G' = S exp(cs_q - cs_k) dt_k against
// x, the carried state against C, B' = B dt_k exp(cs_end - cs_k) against
// x -- and rounding one to bf16 once costs 2^-9 relative, ~1e-2 on y at the
// serving scales (tests/test_torch_ssd_split.py).  So each enters as an
// unevaluated sum of bf16 pieces, hi = bf16(v), mid = bf16(v - hi), lo =
// bf16(v - hi - mid) (each difference exact in fp32), one wgmma a piece
// into the same fp32 accumulators: kPiecesG = 3 for G' (two leave ~3e-5 on
// y, past a quarter of SSD_TOL), 2 for the state and B' (their share of y
// and of the state is ~1e-6 with two).
//
// Design: one block of two warpgroups per (b, h), the chunk loop inside.
//  * Per chunk, one thread stages the whole chunk with TMA (128-byte
//    swizzle; boxes of 64 x 64): C and B [Q][128] and x [Q][64] (the
//    head's columns of the [B L, H P] rows), one mbarrier per tile of 64
//    steps (40 KB), so the products start when their tile lands.  Rows
//    past the tensor read as zeros; rows past the chunk are the next
//    chunk's, never stored, and carry no weight (dt = 0 past Q).
//  * y, a 64-row query tile at a time (warpgroup 0 takes tiles 0 and 3,
//    warpgroup 1 tiles 1 and 2: five causal tile pairs each):
//    - inter (past the first chunk): acc = C . state^T over the state's
//      pieces (wgmma, both operands in shared memory), rows then scaled by
//      exp(cs_q), as the fp32 kernel does;
//    - intra, for each key tile kt <= qt: S = C_q . B_k^T (m64n64k16 over
//      N = 128) into registers; G' = (S exp(cs_q - cs_k)) dt_k in fp32 in
//      registers, 0 above the diagonal (where the decay's argument is
//      clamped to 0, so it never overflows, and its value is not used);
//      its pieces are the A operand (the accumulator's layout is mma's A
//      fragment) of acc += G' x, x the MN-major B operand in shared
//      memory;
//    - y = acc + D x, rounded once (bf16; fp32 for the float64 witness).
//  * The state, fp32 in registers across chunks (warpgroup w holds rows
//    n in [64 w, 64 w + 64) of state^T): dstate^T = B'^T x, B'^T the A
//    operand (B read from shared memory with ldmatrix.trans, times dt_k
//    exp(cs_end - cs_k), split); state = state exp(cs_end) + dstate; its
//    pieces go to shared memory as the next chunk's inter operand, the last
//    chunk's state to h_final.
//  * cs comes from ssd_chunk_scan_kernel_cumsum, in order, as at fp32.
//  * Each product group is waited for before its registers are reused;
//    the two warpgroups overlap each other's fp32 work.  (Pipelining inside
//    a warpgroup -- the next tile's S, or half of G' x, in flight during
//    the fp32 work; two buffers of B' pieces -- ran slower on the H100:
//    ptxas serialised the wgmma, C7515 / C7520.)  No split of a sum
//    across blocks, no atomics: two calls are bitwise equal.
// Shared memory 197 KB: one block an SM, 2048 blocks at the serving shape.

#include "mcd_tma.cuh"

namespace {

using namespace mcd;

constexpr int kTcRows = 64;                  // steps of a tile
constexpr int kTcTiles = kQMax / kTcRows;    // tiles of the longest chunk
constexpr int kTcThreads = 256;              // two warpgroups
static_assert(kTcThreads == kQMax, "a thread a step of the chunk");
constexpr int kPiecesG = 3;                  // bf16 pieces of G'
constexpr int kPiecesS = 2;                  // of the carried state
constexpr int kPiecesB = 2;                  // of B'
constexpr int kTcBox = 64 * 64 * 2;          // a TMA box [64][64] of bf16
// Shared memory, bytes from a 1 KB-aligned base: C and B (tile t, column
// box j at box 2t + j), x (box t), the state's pieces ([128 n][64 p], two
// boxes a piece), the fp32 cs, exp(cs), dt exp(cs_end - cs) and dt of the
// chunk, one mbarrier a tile.
constexpr int kTcC = 0;
constexpr int kTcB = kTcC + 2 * kTcTiles * kTcBox;
constexpr int kTcX = kTcB + 2 * kTcTiles * kTcBox;
constexpr int kTcS = kTcX + kTcTiles * kTcBox;
constexpr int kTcF = kTcS + kPiecesS * 2 * kTcBox;
constexpr int kTcBar = kTcF + 4 * kQMax * 4;
constexpr int kTcSmem = 1024 + kTcBar + 8 * kTcTiles;   // + alignment
constexpr uint32_t kTcTileBytes = 5 * kTcBox;  // C, B (two boxes), x

// Byte of element (r, c) of a box of 128-byte rows written with TMA's
// 128-byte swizzle: 16-byte chunk c / 8 of row r sits at chunk (c / 8) ^
// (r % 8).
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

// D[64, 64] (+ D where `accumulate`) = A[64, 16] B[16, 64], both from
// shared memory: A K-major, B K-major (TB 0) or MN-major (TB 1).
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TB));
}

// The same with A from registers (a thread's 4 bf16 pairs of the warp's 16
// rows, mma's A fragment) and B MN-major from shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// The bf16 pieces of (v0, v1) as NP bf16 pairs, hi first: piece i rounds
// what the pieces before it leave (each difference exact in fp32).
template <int NP>
__device__ __forceinline__ void split(float v0, float v1,
                                      uint32_t (&out)[NP]) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
    out[i] = *reinterpret_cast<const uint32_t*>(&p);
    const float2 f = __bfloat1622float2(p);
    v0 = __fsub_rn(v0, f.x);
    v1 = __fsub_rn(v1, f.y);
  }
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// A thread's place in a warpgroup's m64n64 accumulator: acc[4 j + e] is
// row 16 wi + g + 8 (e >> 1), column 8 j + c2 + (e & 1), for warp wi,
// g = lane / 4, c2 = 2 (lane % 4).
template <typename Y>
__global__ void __launch_bounds__(kTcThreads, 1)
ssd_chunk_scan_kernel_bf16_tc(const __grid_constant__ CUtensorMap tm_x,
                              const __grid_constant__ CUtensorMap tm_b,
                              const __grid_constant__ CUtensorMap tm_c,
                              const float* __restrict__ dt,
                              const float* __restrict__ d_skip,
                              const float* __restrict__ csum,
                              Y* __restrict__ y, float* __restrict__ h_out,
                              int L, int H, int P, int N, int Q) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);
  float* const cs = reinterpret_cast<float*>(sm + kTcF);  // past Q: cs_{Q-1}
  float* const ecs = cs + kQMax;      // exp(cs_q); 0 past Q
  float* const wk = ecs + kQMax;      // dt_k exp(cs_end - cs_k); 0 past Q
  float* const dts = wk + kQMax;      // dt_k; 0 past Q
  const uint32_t bars = base + kTcBar;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int wi = (tid & 127) >> 5, lane = tid & 31;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const int nt = (Q + kTcRows - 1) / kTcRows;
  const float dh = d_skip[h];
  const size_t row_stride = (size_t)H * P;

  if (tid == 0) {
    for (int i = 0; i < kTcTiles; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  float st[32];                       // state^T, rows n = 64 wg + ...
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = 0.0f;

  int ci = 0;
  for (int c0 = 0; c0 < L; c0 += Q, ++ci) {
    const int row0 = b * L + c0;      // the chunk's first row of [B L]
    const uint32_t parity = ci & 1;
    __syncthreads();                  // the last chunk's readers are done
    if (tid == 0) {
      for (int t = 0; t < nt; ++t) {
        const uint32_t bar = bars + 8 * t;
        const int r = row0 + t * kTcRows;
        mbar_expect_tx(bar, kTcTileBytes);
        for (int j = 0; j < 2; ++j) {
          tma_load(base + kTcC + (2 * t + j) * kTcBox, &tm_c, bar, 64 * j, r);
          tma_load(base + kTcB + (2 * t + j) * kTcBox, &tm_b, bar, 64 * j, r);
        }
        tma_load(base + kTcX + t * kTcBox, &tm_x, bar, h * P, r);
      }
    }
    {
      const size_t i = (size_t)(row0 + min(tid, Q - 1)) * H + h;
      cs[tid] = csum[i];
      dts[tid] = tid < Q ? dt[i] : 0.0f;
    }
    __syncthreads();
    const float cs_end = cs[Q - 1];
    wk[tid] = tid < Q ? __fmul_rn(dts[tid], expf(cs_end - cs[tid])) : 0.0f;
    ecs[tid] = tid < Q ? expf(cs[tid]) : 0.0f;
    __syncthreads();

    // ---- y, one query tile at a time -----------------------------------
#pragma unroll 1
    for (int i = 0; i < 2; ++i) {
      const int qt = i == 0 ? wg : kTcTiles - 1 - wg;
      if (qt >= nt) continue;
      const int q0 = qt * kTcRows;
      const int qr = 16 * wi + g;     // the thread's rows qr, qr + 8
      const uint32_t ca = base + kTcC + 2 * qt * kTcBox;
      mbar_wait(bars + 8 * qt, parity);
      float acc[32];
      if (ci > 0) {
        // inter: C_q . state^T over the state's pieces, then exp(cs_q)
        wg_fence();
#pragma unroll
        for (int j = 0; j < kPiecesS; ++j)
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
            wgmma_ss<1>(acc,
                        smem_desc(ca + (kk >> 2) * kTcBox + (kk & 3) * 32, 16,
                                  1024, 128),
                        smem_desc(base + kTcS + j * 2 * kTcBox + kk * 2048,
                                  8192, 1024, 128),
                        j > 0 || kk > 0);
        wg_commit();
        wg_wait<0>();
        pin(acc);
        const float f0 = ecs[q0 + qr], f1 = ecs[q0 + qr + 8];
#pragma unroll
        for (int e = 0; e < 32; ++e)
          acc[e] = __fmul_rn(acc[e], (e & 2) ? f1 : f0);
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
      }
      // intra: for each key tile, S = C_q . B_k^T, then acc += G' x_k
#pragma unroll 1
      for (int kt = 0; kt <= qt; ++kt) {
        mbar_wait(bars + 8 * kt, parity);
        const uint32_t bk = base + kTcB + 2 * kt * kTcBox;
        float s[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_ss<0>(s,
                      smem_desc(ca + (kk >> 2) * kTcBox + (kk & 3) * 32, 16,
                                1024, 128),
                      smem_desc(bk + (kk >> 2) * kTcBox + (kk & 3) * 32, 16,
                                1024, 128),
                      kk > 0);
        wg_commit();
        wg_wait<0>();
        pin(s);
        // G' pieces: k16 step ks takes s[8 ks .. 8 ks + 7]; its register
        // r holds row qr + 8 (r & 1), columns 8 i + c2, + 1 of the tile
        // for i = 2 ks + (r >> 1).  cs_k and dt_k of those 16 columns are
        // loaded once a tile.  cs_q - cs_k <= 0 wherever k <= q, so fminf
        // changes no weight that is used, and keeps the masked ones
        // (above the diagonal) from overflowing.
        uint32_t a[4][kPiecesG][4];
        const int k0 = kt * kTcRows;
        const float cq[2] = {cs[q0 + qr], cs[q0 + qr + 8]};
        float2 ck[8], dk[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          ck[i] = *reinterpret_cast<const float2*>(cs + k0 + 8 * i + c2);
          dk[i] = *reinterpret_cast<const float2*>(dts + k0 + 8 * i + c2);
        }
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = 2 * ks + (r >> 1);
            const int q = q0 + qr + 8 * (r & 1), k = k0 + 8 * i + c2;
            const float g0 = __fmul_rn(
                __fmul_rn(s[8 * ks + 2 * r],
                          expf(fminf(cq[r & 1] - ck[i].x, 0.0f))),
                dk[i].x);
            const float g1 = __fmul_rn(
                __fmul_rn(s[8 * ks + 2 * r + 1],
                          expf(fminf(cq[r & 1] - ck[i].y, 0.0f))),
                dk[i].y);
            uint32_t pc[kPiecesG];
            split<kPiecesG>(k <= q ? g0 : 0.0f, k + 1 <= q ? g1 : 0.0f, pc);
#pragma unroll
            for (int j = 0; j < kPiecesG; ++j) a[ks][j][r] = pc[j];
          }
        const uint32_t xk = base + kTcX + kt * kTcBox;
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int j = 0; j < kPiecesG; ++j)
            wgmma_rs(acc, a[ks][j],
                     smem_desc(xk + ks * 2048, 8192, 1024, 128), 1);
        wg_commit();
        wg_wait<0>();
        pin(acc);
      }
      // y = acc + D x, rounded once; rows past Q, columns past P not stored
      const unsigned char* xt = sm + kTcX + qt * kTcBox;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = qr + 8 * hh, p = 8 * jj + c2;
          if (q0 + r >= Q || p >= P) continue;
          const float2 xf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xt + swz(r, p)));
          store_pair(y + (size_t)(row0 + q0 + r) * row_stride +
                         (size_t)h * P + p,
                     __fadd_rn(acc[4 * jj + 2 * hh], __fmul_rn(dh, xf.x)),
                     __fadd_rn(acc[4 * jj + 2 * hh + 1], __fmul_rn(dh, xf.y)));
        }
    }

    // ---- state = state exp(cs_end) + B'^T x, rows n of this warpgroup --
    float ds[32];
#pragma unroll 1
    for (int kt = 0; kt < nt; ++kt) {
      mbar_wait(bars + 8 * kt, parity);
      const uint32_t bt = base + kTcB + (2 * kt + wg) * kTcBox;
      // ldmatrix.trans: matrix m = lane / 8 holds key rows 16 ks + 8 (m >> 1)
      // and the 8 columns n of chunk 2 wi + (m & 1); register m then is the
      // A fragment's register m (rows n, columns k).
      const int m = lane >> 3;
      uint32_t a[4][kPiecesB][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int r = 16 * ks + 8 * (m >> 1) + (lane & 7);
        uint32_t bv[4];
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3},"
            " [%4];\n"
            : "=r"(bv[0]), "=r"(bv[1]), "=r"(bv[2]), "=r"(bv[3])
            : "r"(bt + r * 128 + ((((2 * wi + (m & 1)) ^ r) & 7) << 4)));
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int k = kt * kTcRows + 16 * ks + c2 + 8 * (rr >> 1);
          const float2 bf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&bv[rr]));
          uint32_t pc[kPiecesB];
          split<kPiecesB>(__fmul_rn(bf.x, wk[k]), __fmul_rn(bf.y, wk[k + 1]),
                          pc);
#pragma unroll
          for (int j = 0; j < kPiecesB; ++j) a[ks][j][rr] = pc[j];
        }
      }
      const uint32_t xk = base + kTcX + kt * kTcBox;
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int j = 0; j < kPiecesB; ++j)
          wgmma_rs(ds, a[ks][j], smem_desc(xk + ks * 2048, 8192, 1024, 128),
                   kt > 0 || ks > 0 || j > 0);
      wg_commit();
      wg_wait<0>();
      pin(ds);
    }
    const float dec = expf(cs_end);
#pragma unroll
    for (int e = 0; e < 32; ++e)
      st[e] = __fadd_rn(__fmul_rn(st[e], dec), ds[e]);
    __syncthreads();                  // every inter term has read the pieces
    const int nr = 64 * wg + 16 * wi + g;
    if (c0 + Q < L) {
      // the next chunk's operand: the pieces of state^T, [n][p] rows
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int n = nr + 8 * hh, p = 8 * jj + c2;
          uint32_t pc[kPiecesS];
          split<kPiecesS>(st[4 * jj + 2 * hh], st[4 * jj + 2 * hh + 1], pc);
#pragma unroll
          for (int j = 0; j < kPiecesS; ++j)
            *reinterpret_cast<uint32_t*>(sm + kTcS + j * 2 * kTcBox +
                                         swz(n, p)) = pc[j];
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    } else {
      float* hb = h_out + (size_t)blockIdx.x * P * N;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int n = nr + 8 * hh, p = 8 * jj + c2;
          if (n >= N || p >= P) continue;
          hb[(size_t)p * N + n] = st[4 * jj + 2 * hh];
          hb[(size_t)(p + 1) * N + n] = st[4 * jj + 2 * hh + 1];
        }
    }
  }
}

template <typename Y>
int launch_bf16_tc(const void* x, const float* dt, const float* a,
                   const void* bm, const void* cm, const float* d_skip,
                   float* cs, void* y, float* h_out, int B, int L, int H,
                   int P, int N, int Q, cudaStream_t s) {
  static std::atomic<int> smem_set[kMaxDevices];   // zero: static
  auto kernel = ssd_chunk_scan_kernel_bf16_tc<Y>;
  cudaError_t err = fit_smem(kernel, kTcSmem, smem_set);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tx, tb, tc;
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!tensor_map(&tx, x, bf, 2, H * P, B * L, 64, kTcRows, sw) ||
      !tensor_map(&tb, bm, bf, 2, N, B * L, 64, kTcRows, sw) ||
      !tensor_map(&tc, cm, bf, 2, N, B * L, 64, kTcRows, sw))
    return (int)cudaErrorInvalidValue;
  const int chains = B * (L / Q) * H;
  ssd_chunk_scan_kernel_cumsum<<<(chains + kThreads - 1) / kThreads,
                                 kThreads, 0, s>>>(dt, a, cs, chains, H, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * H, kTcThreads, kTcSmem, s>>>(tx, tb, tc, dt, d_skip, cs,
                                            reinterpret_cast<Y*>(y), h_out, L,
                                            H, P, N, Q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The bf16 launch on the tensor cores: the cumsum kernel into `cs`
// [B, L, H], then ssd_chunk_scan_kernel_bf16_tc, y [B, L, H, P] bf16 (fp32
// where y_f32, the float64 witness's unrounded y) and h_out [B, H, P, N]
// fp32.  Takes P <= 64 and N <= 128, multiples of 8, Q <= 256 dividing L,
// and x, bm, cm 16-byte aligned (ssd_plan's "tensor_cores" path); returns
// cudaErrorInvalidValue for anything else, else the last launch's error.
int ssd_chunk_scan_bf16_tc_launch(const void* x, const float* dt,
                                  const float* a, const void* bm,
                                  const void* cm, const float* d_skip,
                                  float* cs, void* y, float* h_out, int B,
                                  int L, int H, int P, int N, int Q,
                                  int y_f32, void* stream) {
  if (Q < 1 || Q > kQMax || L % Q || P > kPMax || N > kNMax || P % 8 ||
      N % 8 || (long long)B * L > 0x7fffffff ||
      (((uintptr_t)x | (uintptr_t)bm | (uintptr_t)cm) & 15) ||
      encode_tiled() == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (y_f32)
    return launch_bf16_tc<float>(x, dt, a, bm, cm, d_skip, cs, y, h_out, B, L,
                                 H, P, N, Q, s);
  return launch_bf16_tc<__nv_bfloat16>(x, dt, a, bm, cm, d_skip, cs, y, h_out,
                                       B, L, H, P, N, Q, s);
}

}  // extern "C"
