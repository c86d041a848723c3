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
// shape the two copies move ~0.8 GB besides the scan's own traffic; a head
// kernel that stages bf16 tiles itself, on tensor cores, is later work.

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
