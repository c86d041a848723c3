// Sequence-fused MC-dropout GRU layer for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/mcd_gru_seq.py::mcd_gru_seq
// (pallas_call at l.145, body `_kernel` l.44, gate body
// repro/kernels/mcd_gru.py::_gru_update l.39): one launch runs a whole GRU
// layer over all T steps, carrying h on chip, rebuilding the six per-gate
// Bernoulli keep-masks (r, z, n on the x side, then on the h side) from the
// counter hash, applying x*z/(1-p) and h*z/(1-p), and running the three
// gates with separate fp32 x-side and h-side sums:
//   r = sigmoid(gx0 + gh0 + b0),  z = sigmoid(gx1 + gh1 + b1),
//   n = tanh(gx2 + r * gh2 + b2),  h' = (1 - z) * n + z * h.
// `lengths` freezes a row's h once t >= length (ys repeats the frozen h),
// h0 seeds the carry, negative int32 rows (the student flag, the uint32
// high bit) run unmasked, and p == 0 skips masking.  The carry is h alone,
// stored in the activation dtype at every step.
//
// What bounds it on this card: latency and instruction throughput, not
// bytes or operations.  The T steps are dependent; each is a [rows, I+H] x
// [I+H, 3H] product per row, so a layer's time is T times one step's
// critical path (the h exchange, H dependent adds per gate sum, sigmoid,
// tanh), or, where many rows share an SM, T times the instructions its
// warps run in a step -- either far above the bytes and operations of the
// whole layer (its bound).
//
// Two paths, one arithmetic (mcd_cells.cuh: every product and sum rounded
// on its own, in the plain version's order, so both paths, the step kernel
// and the plain version agree bit for bit):
//  * Warp path, for H that divides 32 (every ECG layer: H = 8, 16): a
//    row's H units are H lanes of one warp, 32/H rows a warp.  The T loop
//    has no block barrier: h_{t-1} goes from lane to lane by __shfl_sync
//    (each lane shuffles its own h * fh, the three masked h values of its
//    unit), and every lane -- those of rows past B too -- stays in the loop
//    so the full-mask shuffles are defined.  The unit's column of wh (3H
//    floats) lives in registers and its h-side mask factors too; for the
//    ECG input widths (I = 1, 8, 16) the x-side loop is unrolled at compile
//    time with the unit's column of wx in registers (else wx is read from
//    shared memory); the x-side factors sit in shared memory, filled once.
//    x is copied by cp.async into a per-row ring of 8 steps in shared
//    memory, 6 steps ahead of use, so a step does not wait on a global
//    load, and the x-side sums of step t+1 (which do not depend on h) are
//    taken with no branch before step t's h-side chain, so they overlap
//    it.
//  * Block path, for every other H (the wide H = 128 layer, H = 24), and
//    for an input too wide for the warp path's shared memory: one
//    block owns R whole rows, one thread per (row, unit); h of the tile in
//    shared memory and two block barriers a step separate the reads of
//    h_{t-1} from the writes of h_t; weights read through the read-only
//    path.
//  * Cluster path (mcd_wide.cuh), for every layer the block path refuses
//    (H above 1024; a row's mask factors, x and h above a block's shared
//    memory), as mcd_lstm_seq.cu's: a cluster of C <= 16 blocks a tile of
//    R rows, a block a slice of units, a thread one unit and two rows;
//    each step the owners publish their three masked h values a row in
//    their own shared memory and every block reads the tile's masked
//    h_{t-1} from its peers (distributed shared memory) a chunk at a time
//    between two cluster barriers.  The reset gate scales the unit's own
//    h-side candidate sum, so one exchange a step serves.  The weights
//    stream through the read-only path every step, once a step a cluster.
// The host picks the path, the rows a block and the shared memory
// (kernels/mcd_gru_seq.py::gru_seq_plan) and passes them in; the entry checks
// the shared memory against what the path needs.
// Serving precisions (the TPU kernel's `weight_bits` branch, l.44-74, and
// its bf16 operands), as in mcd_lstm_seq.cu: the fp32 kernels stay as they
// were, and the `_q` kernels after them take bf16 x, h0, ys and h_T over
// weights stored as bf16, int8 codes or packed int4 codes with fp32 [3, H]
// scales -- dequantized once at entry on the warp path, at each read on
// the block path (wx in registers for H = 8, 16 only); bf16 x staged as
// the 4-byte words that hold it, the x-side sums taking its half; rounded
// at the
// masked views, the dequantized weights and h on every write
// (mcd_cells.cuh), so every instantiation is bit-equal to the plain
// version at its precision.  The r * gh2 and z * h terms are fp32
// products of the bf16 h (repro/kernels/mcd_gru.py:71-74).
// The cluster path is right first (~40x its bound at (2048, 2048), B = 64;
// PERF.md).  Left for a later PR: tensor cores for large H; on the
// cluster path, a block's row groups re-reading its weights from L2 and a
// chunk's block barriers.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mcd_async.cuh"
#include "mcd_cells.cuh"
#include "mcd_mask.cuh"
#include "mcd_wide.cuh"

namespace {

constexpr int kGates = 3;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpMaxThreads = 128;
constexpr int kXRing = 8;   // x_t slots a row on the warp path: x is read
                            // kXRing - 2 steps ahead of its x-side sums

__global__ void mcd_gru_seq_kernel(
    const float* __restrict__ x,      // [B, T, I]
    const float* __restrict__ wx,     // [I, 3, H]
    const float* __restrict__ wh,     // [H, 3, H]
    const float* __restrict__ bias,   // [3, H]
    const int32_t* __restrict__ rows, // [B]
    const int32_t* __restrict__ lens, // [B]
    const float* __restrict__ h0,     // [B, H]
    float* __restrict__ ys,           // [B, T, H]
    float* __restrict__ hT,           // [B, H]
    int B, int T, int I, int H, int R, mcd::GateKeys keys, uint32_t thr,
    float scale, int masked) {
  extern __shared__ float smem[];
  float* fx = smem;                     // [R][3][I]
  float* fh = fx + R * kGates * I;      // [R][3][H]
  float* xs = fh + R * kGates * H;      // [R][I]   x_t of the tile
  float* hs = xs + R * I;               // [R][H]   h_{t-1} of the tile

  const int row0 = blockIdx.x * R;
  mcd::fill_mask_factors<kGates>(fx, fh, rows, row0, R, B, I, H, keys, thr,
                                 scale, masked);

  const int r = threadIdx.x / H;        // blockDim.x == R * H
  const int j = threadIdx.x % H;
  const int br = row0 + r;
  const bool active = br < B;
  float h = 0.0f;
  int len = 0;
  if (active) {
    h = h0[(size_t)br * H + j];
    len = lens[br];
  }
  float bj[kGates];
  for (int g = 0; g < kGates; ++g) bj[g] = bias[g * H + j];
  const float* fxr = fx + r * kGates * I;
  const float* fhr = fh + r * kGates * H;
  const float* xr = xs + r * I;
  const float* hr = hs + r * H;

  for (int t = 0; t < T; ++t) {
    hs[threadIdx.x] = h;                // publish h_{t-1} (index r*H + j)
    for (int e = threadIdx.x; e < R * I; e += blockDim.x) {
      const int rr = row0 + e / I;
      xs[e] = rr < B ? x[((size_t)rr * T + t) * I + e % I] : 0.0f;
    }
    __syncthreads();
    if (active) {
      const float h_new =
          mcd::gru_unit(xr, hr, fxr, fhr, wx, wh, bj, I, H, j, h);
      if (t < len) h = h_new;
      ys[((size_t)br * T + t) * H + j] = h;
    }
    __syncthreads();
  }
  if (active) hT[(size_t)br * H + j] = h;
}

// Warp path: blockDim.x = 32 * warps, R = warps * (32 / H) rows a block.
// (Both paths' names hold "mcd_gru_seq_kernel", the name a profile of the
// kernel matches.)
// IX > 0: I == IX, the x-side loop is straight-line code (so its loads and
// products interleave with the h-side chain) and the unit's column of wx
// lives in registers; IX == 0: any I, wx read from shared memory.
template <int H, int IX>
__global__ void __launch_bounds__(kWarpMaxThreads)
mcd_gru_seq_kernel_warp(
    const float* __restrict__ x, const float* __restrict__ wx,
    const float* __restrict__ wh, const float* __restrict__ bias,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ lens,
    const float* __restrict__ h0, float* __restrict__ ys,
    float* __restrict__ hT, int B, int T, int I, int R, mcd::GateKeys keys,
    uint32_t thr, float scale, int masked) {
  constexpr int kRowsPerWarp = 32 / H;
  extern __shared__ float smem[];
  float* fx = smem;                     // [R][3][I]
  float* fh = fx + R * kGates * I;      // [R][3][H]
  float* wxs = fh + R * kGates * H;     // [I][3][H]
  float* xb = wxs + I * kGates * H;     // [R][kXRing][I]  x_t ring

  const int row0 = blockIdx.x * R;
  mcd::fill_mask_factors<kGates>(fx, fh, rows, row0, R, B, I, H, keys, thr,
                                 scale, masked);
  for (int e = threadIdx.x; e < I * kGates * H; e += blockDim.x)
    wxs[e] = wx[e];
  __syncthreads();                      // the only block barrier

  const int lane = threadIdx.x & 31;
  const int r = (threadIdx.x >> 5) * kRowsPerWarp + lane / H;
  const int j = lane % H;
  const int br = row0 + r;
  const bool active = br < B;

  float whr[kGates][H];                 // the unit's column of wh
#pragma unroll
  for (int k = 0; k < H; ++k)
#pragma unroll
    for (int g = 0; g < kGates; ++g)
      whr[g][k] = __ldg(wh + (k * kGates + g) * H + j);
  float wxr[kGates][IX > 0 ? IX : 1];   // ... and of wx, when I == IX
#pragma unroll
  for (int i = 0; i < IX; ++i)
#pragma unroll
    for (int g = 0; g < kGates; ++g)
      wxr[g][i] = wxs[(i * kGates + g) * H + j];
  float fhj[kGates], bj[kGates];
#pragma unroll
  for (int g = 0; g < kGates; ++g) {
    fhj[g] = fh[(r * kGates + g) * H + j];
    bj[g] = bias[g * H + j];
  }
  float h = active ? h0[(size_t)br * H + j] : 0.0f;
  const int len = active ? lens[br] : 0;
  const float* fxr = fx + r * kGates * I;
  const float* xrow = x + (size_t)(active ? br : 0) * T * I;
  float* const ring = xb + r * kXRing * I;
  auto slot = [&](int t) { return ring + (t % kXRing) * I; };

  // The row's lanes copy x_t into its slot (zeros for rows past B, nothing
  // for t >= T); one commit group a step, empty ones too, so a wait counts
  // steps.
  auto stage = [&](int t) {
    if (t < T)
      for (int i = j; i < I; i += H)
        mcd::cp_async4(slot(t) + i, xrow + (size_t)t * I + i, active);
    mcd::cp_async_commit();
  };
  // The x-side gate sums of step t, in index order, once x_t has landed
  // for the row.
  auto x_side = [&](int t, float& s0, float& s1, float& s2) {
    const float* xt = slot(t);
    s0 = s1 = s2 = 0.0f;
    if (IX > 0) {
#pragma unroll
      for (int i = 0; i < (IX > 0 ? IX : 1); ++i) {
        const float xv = xt[i];
        s0 = mcd::gate_term(s0, xv, fxr[i], wxr[0][i]);
        s1 = mcd::gate_term(s1, xv, fxr[IX + i], wxr[1][i]);
        s2 = mcd::gate_term(s2, xv, fxr[2 * IX + i], wxr[2][i]);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < I; ++i) {
        const float xv = xt[i];
        const float* w = wxs + i * kGates * H + j;
        s0 = mcd::gate_term(s0, xv, fxr[i], w[0]);
        s1 = mcd::gate_term(s1, xv, fxr[I + i], w[H]);
        s2 = mcd::gate_term(s2, xv, fxr[2 * I + i], w[2 * H]);
      }
    }
  };

#pragma unroll
  for (int t = 0; t < kXRing - 1; ++t) stage(t);
  mcd::cp_async_wait<kXRing - 2>();     // x_0 has landed
  __syncwarp();
  float x0, x1, x2;                     // x-side sums of the current step
  x_side(0, x0, x1, x2);

  for (int t = 0; t < T; ++t) {
    // No branch from here to the h-side chain: the x-side sums of step
    // t+1 (unused after the last step) and step t's h side interleave.
    mcd::cp_async_wait<kXRing - 3>();   // x_{t+1} has landed
    __syncwarp();                       // ... for the row; x_{t-1} was read
    stage(t + kXRing - 1);              // into x_{t-1}'s slot
    float n0, n1, n2;
    x_side(t + 1, n0, n1, n2);
    // h side: each lane's h * fh for its unit, shuffled to the row's lanes.
    const float hf0 = __fmul_rn(h, fhj[0]);
    const float hf1 = __fmul_rn(h, fhj[1]);
    const float hf2 = __fmul_rn(h, fhj[2]);
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
#pragma unroll
    for (int k = 0; k < H; ++k) {
      a0 = mcd::gate_term_vf(a0, __shfl_sync(kFull, hf0, k, H), whr[0][k]);
      a1 = mcd::gate_term_vf(a1, __shfl_sync(kFull, hf1, k, H), whr[1][k]);
      a2 = mcd::gate_term_vf(a2, __shfl_sync(kFull, hf2, k, H), whr[2][k]);
    }
    const float h_new = mcd::gru_tail(x0, x1, x2, a0, a1, a2, bj, h);
    if (t < len) h = h_new;
    if (active) ys[((size_t)br * T + t) * H + j] = h;
    x0 = n0;
    x1 = n1;
    x2 = n2;
  }
  if (active) hT[(size_t)br * H + j] = h;
}

size_t block_smem_bytes(int R, int I, int H) {
  return (size_t)R * (kGates * (I + H) + I + H) * sizeof(float);
}

// The staged wx at the activation width, padded to whole 4-byte words
// (kernels/common.py::seq_plan).
size_t warp_smem_bytes(int R, int I, int H, size_t act_bytes) {
  return ((size_t)R * (kGates * (I + H) + kXRing * I) +
          ((size_t)kGates * I * H * act_bytes + 3) / 4) *
         sizeof(float);
}

template <typename Kernel>
cudaError_t fit_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int H, int IX>
int launch_warp(const float* x, const float* wx, const float* wh,
                const float* bias, const int32_t* rows, const int32_t* lens,
                const float* h0, float* ys, float* hT, int B, int T, int I,
                int R, size_t smem, const mcd::GateKeys& keys, uint32_t thr,
                float scale, int masked, cudaStream_t stream) {
  const int threads = R * H;            // whole warps
  if (threads % 32 || threads > kWarpMaxThreads)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = fit_smem(mcd_gru_seq_kernel_warp<H, IX>, smem);
  if (err != cudaSuccess) return (int)err;
  mcd_gru_seq_kernel_warp<H, IX>
      <<<(B + R - 1) / R, threads, smem, stream>>>(
          x, wx, wh, bias, rows, lens, h0, ys, hT, B, T, I, R, keys, thr,
          scale, masked);
  return (int)cudaGetLastError();
}

// The fp32 layer: the kernels above, launched as before the serving
// precisions came.
int launch_fp32(const float* x, const float* wx, const float* wh,
                const float* bias, const int32_t* rows, const int32_t* lens,
                const float* h0, float* ys, float* hT, int B, int T, int I,
                int H, int R, int warp, int smem_bytes, const uint32_t* keys6,
                uint32_t thr, float scale, int masked, void* stream) {
  const size_t smem = (size_t)smem_bytes;
  const mcd::GateKeys keys = mcd::to_keys(keys6, 2 * kGates);
  cudaStream_t s = (cudaStream_t)stream;
  if (warp) {
    if (smem < warp_smem_bytes(R, I, H, sizeof(float)))
      return (int)cudaErrorInvalidValue;
#define MCD_GRU_WARP(HH)                                               \
  case HH:                                                             \
    switch (I) {                                                       \
      case 1:                                                          \
        return launch_warp<HH, 1>(x, wx, wh, bias, rows, lens, h0, ys, \
                                  hT, B, T, I, R, smem, keys, thr,     \
                                  scale, masked, s);                   \
      case 8:                                                          \
        return launch_warp<HH, 8>(x, wx, wh, bias, rows, lens, h0, ys, \
                                  hT, B, T, I, R, smem, keys, thr,     \
                                  scale, masked, s);                   \
      case 16:                                                         \
        return launch_warp<HH, 16>(x, wx, wh, bias, rows, lens, h0,    \
                                   ys, hT, B, T, I, R, smem, keys,     \
                                   thr, scale, masked, s);             \
      default:                                                         \
        return launch_warp<HH, 0>(x, wx, wh, bias, rows, lens, h0, ys, \
                                  hT, B, T, I, R, smem, keys, thr,     \
                                  scale, masked, s);                   \
    }
    switch (H) {
      MCD_GRU_WARP(1)
      MCD_GRU_WARP(2)
      MCD_GRU_WARP(4)
      MCD_GRU_WARP(8)
      MCD_GRU_WARP(16)
      MCD_GRU_WARP(32)
      default:
        return (int)cudaErrorInvalidValue;
    }
#undef MCD_GRU_WARP
  }
  if (smem < block_smem_bytes(R, I, H)) return (int)cudaErrorInvalidValue;
  cudaError_t err = fit_smem(mcd_gru_seq_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  mcd_gru_seq_kernel<<<(B + R - 1) / R, R * H, smem, s>>>(
      x, wx, wh, bias, rows, lens, h0, ys, hT, B, T, I, H, R, keys, thr,
      scale, masked);
  return (int)cudaGetLastError();
}

// -- serving precisions: bf16 activations over bf16, int8 or int4 weights --
//
// The same two paths and the same arithmetic order as the fp32 kernels
// above, templated over the activation storage A (bf16) and the weight
// storage W, rounded where the TPU kernel rounds (mcd_cells.cuh).  The fp32
// kernels stay as they were, so their code does not change.

using mcd::bf16;

template <typename A, typename W>
__global__ void mcd_gru_seq_kernel_q(
    const A* __restrict__ x,          // [B, T, I]
    const typename mcd::Storage<W>::type* __restrict__ wx,  // [I, 3, H(/2)]
    const typename mcd::Storage<W>::type* __restrict__ wh,  // [H, 3, H(/2)]
    const float* __restrict__ sx,     // [3, H] scales (quantized W)
    const float* __restrict__ sh,     // [3, H]
    const float* __restrict__ bias,   // [3, H]
    const int32_t* __restrict__ rows, // [B]
    const int32_t* __restrict__ lens, // [B]
    const A* __restrict__ h0,         // [B, H]
    A* __restrict__ ys,               // [B, T, H]
    A* __restrict__ hT,               // [B, H]
    int B, int T, int I, int H, int R, mcd::GateKeys keys, uint32_t thr,
    float scale, int masked) {
  extern __shared__ float smem[];
  float* fx = smem;                     // [R][3][I]
  float* fh = fx + R * kGates * I;      // [R][3][H]
  float* xs = fh + R * kGates * H;      // [R][I]   x_t of the tile
  float* hs = xs + R * I;               // [R][H]   h_{t-1} of the tile

  const int row0 = blockIdx.x * R;
  mcd::fill_mask_factors<kGates>(fx, fh, rows, row0, R, B, I, H, keys, thr,
                                 scale, masked);

  const int r = threadIdx.x / H;        // blockDim.x == R * H
  const int j = threadIdx.x % H;
  const int br = row0 + r;
  const bool active = br < B;
  float h = 0.0f;
  int len = 0;
  if (active) {
    h = mcd::to_f(h0[(size_t)br * H + j]);
    len = lens[br];
  }
  float bj[kGates];
  for (int g = 0; g < kGates; ++g) bj[g] = bias[g * H + j];
  const mcd::Column<A, W, kGates> cx(wx, sx, j, H), ch(wh, sh, j, H);
  const float* fxr = fx + r * kGates * I;
  const float* fhr = fh + r * kGates * H;
  const float* xr = xs + r * I;
  const float* hr = hs + r * H;

  for (int t = 0; t < T; ++t) {
    hs[threadIdx.x] = h;                // publish h_{t-1} (index r*H + j)
    for (int e = threadIdx.x; e < R * I; e += blockDim.x) {
      const int rr = row0 + e / I;
      xs[e] = rr < B ? mcd::to_f(x[((size_t)rr * T + t) * I + e % I])
                     : 0.0f;
    }
    __syncthreads();
    if (active) {
      const float h_new =
          mcd::gru_unit_q<A>(xr, hr, fxr, fhr, cx, ch, bj, I, H, h);
      if (t < len) h = h_new;
      ys[((size_t)br * T + t) * H + j] = mcd::from_f<A>(h);
    }
    __syncthreads();
  }
  if (active) hT[(size_t)br * H + j] = mcd::from_f<A>(h);
}

// Warp path: blockDim.x = 32 * warps, R = warps * (32 / H) rows a block.
// (Both paths' names hold "mcd_gru_seq_kernel", the name a profile of the
// kernel matches.)
// IX > 0: I == IX, the x-side loop is straight-line code (so its loads and
// products interleave with the h-side chain) and the unit's column of wx
// lives in registers; IX == 0: any I, wx read from shared memory.
template <int H, int IX, typename A, typename W>
__global__ void __launch_bounds__(kWarpMaxThreads)
mcd_gru_seq_kernel_warp_q(
    const A* __restrict__ x,
    const typename mcd::Storage<W>::type* __restrict__ wx,
    const typename mcd::Storage<W>::type* __restrict__ wh,
    const float* __restrict__ sx, const float* __restrict__ sh,
    const float* __restrict__ bias,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ lens,
    const A* __restrict__ h0, A* __restrict__ ys, A* __restrict__ hT,
    int B, int T, int I, int R, mcd::GateKeys keys, uint32_t thr,
    float scale, int masked) {
  constexpr int kRowsPerWarp = 32 / H;
  static_assert(std::is_same<A, bf16>::value,
                "the precision kernels take bf16 activations");
  extern __shared__ float smem[];
  float* fx = smem;                     // [R][3][I]
  float* fh = fx + R * kGates * I;      // [R][3][H]
  A* wxs = reinterpret_cast<A*>(fh + R * kGates * H);   // [I][3][H]
  float* xb = fh + R * kGates * H +     // [R][kXRing][I]  x_t ring
              (I * kGates * H * (int)sizeof(A) + 3) / 4;

  const int row0 = blockIdx.x * R;
  mcd::fill_mask_factors<kGates>(fx, fh, rows, row0, R, B, I, H, keys, thr,
                                 scale, masked);
  mcd::stage_weights<A, W, kGates>(wxs, wx, sx, I, H);
  __syncthreads();                      // the only block barrier

  const int lane = threadIdx.x & 31;
  const int r = (threadIdx.x >> 5) * kRowsPerWarp + lane / H;
  const int j = lane % H;
  const int br = row0 + r;
  const bool active = br < B;

  float whr[kGates][H];                 // the unit's column of wh
  {
    const mcd::Column<A, W, kGates> ch(wh, sh, j, H);
#pragma unroll
    for (int k = 0; k < H; ++k)
#pragma unroll
      for (int g = 0; g < kGates; ++g) whr[g][k] = ch(k, g);
  }
  float wxr[kGates][IX > 0 ? IX : 1];   // ... and of wx, when I == IX
#pragma unroll
  for (int i = 0; i < IX; ++i)
#pragma unroll
    for (int g = 0; g < kGates; ++g)
      wxr[g][i] = mcd::to_f(wxs[(i * kGates + g) * H + j]);
  float fhj[kGates], bj[kGates];
#pragma unroll
  for (int g = 0; g < kGates; ++g) {
    fhj[g] = fh[(r * kGates + g) * H + j];
    bj[g] = bias[g * H + j];
  }
  float h = active ? mcd::to_f(h0[(size_t)br * H + j]) : 0.0f;
  const int len = active ? lens[br] : 0;
  const float* fxr = fx + r * kGates * I;
  const A* xrow = x + (size_t)(active ? br : 0) * T * I;
  float* const ring = xb + r * kXRing * I;
  auto slot = [&](int t) { return ring + (t % kXRing) * I; };

  // The row's lanes copy x_t into its slot (zeros for rows past B, nothing
  // for t >= T); one commit group a step, empty ones too, so a wait counts
  // steps.  A bf16 element travels in the aligned 4-byte word that holds
  // it (only its own 2 bytes read when it is the word's low half).
  auto stage = [&](int t) {
    if (t < T)
      for (int i = j; i < I; i += H) {
        const uintptr_t a =
            reinterpret_cast<uintptr_t>(xrow + (size_t)t * I + i);
        mcd::cp_async4_bytes(slot(t) + i,
                             reinterpret_cast<const void*>(a & ~uintptr_t(3)),
                             active ? ((a & 2) ? 4 : 2) : 0);
      }
    mcd::cp_async_commit();
  };
  // The value of element i of x_t from the word that carries it: the
  // word's high half when the element's address is 2 past a 4-byte
  // boundary (the row's first element's parity, then one element a step
  // of I and one an index).
  const uint32_t odd0 = (reinterpret_cast<uintptr_t>(xrow) >> 1) & 1;
  auto x_val = [&](const float* xt, int t, int i) {
    const uint32_t w = __float_as_uint(xt[i]);
    return __uint_as_float(((odd0 + (uint32_t)(t * I + i)) & 1)
                               ? (w & 0xffff0000u) : (w << 16));
  };
  // The x-side gate sums of step t, in index order, once x_t has landed
  // for the row.
  auto x_side = [&](int t, float& s0, float& s1, float& s2) {
    const float* xt = slot(t);
    s0 = s1 = s2 = 0.0f;
    if (IX > 0) {
#pragma unroll
      for (int i = 0; i < (IX > 0 ? IX : 1); ++i) {
        const float xv = x_val(xt, t, i);
        s0 = mcd::gate_term_view<A>(s0, xv, fxr[i], wxr[0][i]);
        s1 = mcd::gate_term_view<A>(s1, xv, fxr[IX + i], wxr[1][i]);
        s2 = mcd::gate_term_view<A>(s2, xv, fxr[2 * IX + i], wxr[2][i]);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < I; ++i) {
        const float xv = x_val(xt, t, i);
        const A* w = wxs + i * kGates * H + j;
        s0 = mcd::gate_term_view<A>(s0, xv, fxr[i], mcd::to_f(w[0]));
        s1 = mcd::gate_term_view<A>(s1, xv, fxr[I + i], mcd::to_f(w[H]));
        s2 = mcd::gate_term_view<A>(s2, xv, fxr[2 * I + i],
                                    mcd::to_f(w[2 * H]));
      }
    }
  };

#pragma unroll
  for (int t = 0; t < kXRing - 1; ++t) stage(t);
  mcd::cp_async_wait<kXRing - 2>();     // x_0 has landed
  __syncwarp();
  float x0, x1, x2;                     // x-side sums of the current step
  x_side(0, x0, x1, x2);

  for (int t = 0; t < T; ++t) {
    // No branch from here to the h-side chain: the x-side sums of step
    // t+1 (unused after the last step) and step t's h side interleave.
    mcd::cp_async_wait<kXRing - 3>();   // x_{t+1} has landed
    __syncwarp();                       // ... for the row; x_{t-1} was read
    stage(t + kXRing - 1);              // into x_{t-1}'s slot
    float n0, n1, n2;
    x_side(t + 1, n0, n1, n2);
    // h side: each lane's h * fh for its unit (rounded to A), shuffled to
    // the row's lanes.
    const float hf0 = mcd::round_to<A>(__fmul_rn(h, fhj[0]));
    const float hf1 = mcd::round_to<A>(__fmul_rn(h, fhj[1]));
    const float hf2 = mcd::round_to<A>(__fmul_rn(h, fhj[2]));
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
#pragma unroll
    for (int k = 0; k < H; ++k) {
      a0 = mcd::gate_term_vf(a0, __shfl_sync(kFull, hf0, k, H), whr[0][k]);
      a1 = mcd::gate_term_vf(a1, __shfl_sync(kFull, hf1, k, H), whr[1][k]);
      a2 = mcd::gate_term_vf(a2, __shfl_sync(kFull, hf2, k, H), whr[2][k]);
    }
    const float h_new =
        mcd::round_to<A>(mcd::gru_tail(x0, x1, x2, a0, a1, a2, bj, h));
    if (t < len) h = h_new;
    if (active) ys[((size_t)br * T + t) * H + j] = mcd::from_f<A>(h);
    x0 = n0;
    x1 = n1;
    x2 = n2;
  }
  if (active) hT[(size_t)br * H + j] = mcd::from_f<A>(h);
}

// The launch's operands, typed for one (A, W) instantiation.
template <typename A, typename W>
struct Args {
  using WT = typename mcd::Storage<W>::type;
  const A* x;
  const WT* wx;
  const WT* wh;
  const float *sx, *sh, *bias;
  const int32_t *rows, *lens;
  const A* h0;
  A *ys, *hT;
};

template <int H, int IX, typename A, typename W>
int launch_warp_q(const Args<A, W>& o, int B, int T, int I, int R, size_t smem,
                  const mcd::GateKeys& keys, uint32_t thr, float scale,
                  int masked, cudaStream_t stream) {
  const int threads = R * H;            // whole warps
  if (threads % 32 || threads > kWarpMaxThreads)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = fit_smem(mcd_gru_seq_kernel_warp_q<H, IX, A, W>, smem);
  if (err != cudaSuccess) return (int)err;
  mcd_gru_seq_kernel_warp_q<H, IX, A, W>
      <<<(B + R - 1) / R, threads, smem, stream>>>(
          o.x, o.wx, o.wh, o.sx, o.sh, o.bias, o.rows, o.lens, o.h0, o.ys,
          o.hT, B, T, I, R, keys, thr, scale, masked);
  return (int)cudaGetLastError();
}

template <typename A, typename W>
int launch_layer_q(const Args<A, W>& o, int B, int T, int I, int H, int R,
                   int warp, size_t smem, const mcd::GateKeys& keys,
                   uint32_t thr, float scale, int masked, cudaStream_t s) {
  if (warp) {
    if (smem < warp_smem_bytes(R, I, H, sizeof(A)))
      return (int)cudaErrorInvalidValue;
#define MCD_GRU_WARP_I(HH, II)                                          \
  return launch_warp_q<HH, II>(o, B, T, I, R, smem, keys, thr, scale, \
                               masked, s);
#define MCD_GRU_WARP(HH)          \
  case HH:                        \
    switch (I) {                  \
      case 1:                     \
        MCD_GRU_WARP_I(HH, 1)     \
      case 8:                     \
        MCD_GRU_WARP_I(HH, 8)     \
      case 16:                    \
        MCD_GRU_WARP_I(HH, 16)    \
      default:                    \
        MCD_GRU_WARP_I(HH, 0)     \
    }
#define MCD_GRU_WARP_ANY_I(HH) \
  case HH:                     \
    MCD_GRU_WARP_I(HH, 0)
    // The input widths in registers for the ECG layers' H only (8, 16);
    // every other H reads wx from shared memory (IX = 0).
    switch (H) {
      MCD_GRU_WARP_ANY_I(1)
      MCD_GRU_WARP_ANY_I(2)
      MCD_GRU_WARP_ANY_I(4)
      MCD_GRU_WARP(8)
      MCD_GRU_WARP(16)
      MCD_GRU_WARP_ANY_I(32)
      default:
        return (int)cudaErrorInvalidValue;
    }
#undef MCD_GRU_WARP_ANY_I
#undef MCD_GRU_WARP
#undef MCD_GRU_WARP_I
  }
  if (smem < block_smem_bytes(R, I, H)) return (int)cudaErrorInvalidValue;
  cudaError_t err = fit_smem(mcd_gru_seq_kernel_q<A, W>, smem);
  if (err != cudaSuccess) return (int)err;
  mcd_gru_seq_kernel_q<A, W><<<(B + R - 1) / R, R * H, smem, s>>>(
      o.x, o.wx, o.wh, o.sx, o.sh, o.bias, o.rows, o.lens, o.h0, o.ys, o.hT,
      B, T, I, H, R, keys, thr, scale, masked);
  return (int)cudaGetLastError();
}

template <typename A, typename W>
int launch_typed_q(const void* x, const void* wx, const void* wh,
                   const float* sx, const float* sh, const float* bias,
                   const int32_t* rows, const int32_t* lens, const void* h0,
                   void* ys, void* hT, int B, int T, int I, int H, int R,
                   int warp, size_t smem, const mcd::GateKeys& keys,
                   uint32_t thr, float scale, int masked, cudaStream_t s) {
  using WT = typename mcd::Storage<W>::type;
  if (!std::is_same<W, A>::value && (sx == nullptr || sh == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args<A, W> o{static_cast<const A*>(x), static_cast<const WT*>(wx),
                     static_cast<const WT*>(wh), sx, sh, bias, rows, lens,
                     static_cast<const A*>(h0), static_cast<A*>(ys),
                     static_cast<A*>(hT)};
  return launch_layer_q<A, W>(o, B, T, I, H, R, warp, smem, keys, thr, scale,
                            masked, s);
}


// -- the cluster path: layers the warp and block paths refuse --------------
//
// As mcd_lstm_seq.cu's cluster path (mcd_wide.cuh): a cluster of C blocks
// owns a tile of R rows, block q of the cluster units [q * units,
// (q + 1) * units), a thread one unit and kWideRowsThread rows; each step
// the owner of unit k publishes its three masked h_{t-1} values in its own
// shared memory and every block reads the tile's whole masked h_{t-1} from
// its peers through distributed shared memory, between two cluster
// barriers.  The x-side and h-side sums stay apart; the reset gate scales
// the unit's own h-side candidate sum (gru_tail), so one exchange a step
// serves.  Every (A, W) instantiation, fp32 included, runs this template.
template <typename A, typename W>
__global__ void __launch_bounds__(mcd::kWideThreads)
mcd_gru_seq_kernel_cluster(
    const A* __restrict__ x,          // [B, T, I]
    const typename mcd::Storage<W>::type* __restrict__ wx,  // [I, 3, H(/2)]
    const typename mcd::Storage<W>::type* __restrict__ wh,  // [H, 3, H(/2)]
    const float* __restrict__ sx, const float* __restrict__ sh,
    const float* __restrict__ bias, const int32_t* __restrict__ rows,
    const int32_t* __restrict__ lens, const A* __restrict__ h0,
    A* __restrict__ ys, A* __restrict__ hT, int B, int T, int I, int H,
    int R, int units, mcd::GateKeys keys, uint32_t thr, float scale,
    int masked) {
  constexpr int kR = mcd::kWideRowsThread;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int slice = (int)cluster.block_rank();
  const int row0 = (int)(blockIdx.x / cluster.num_blocks()) * R;
  extern __shared__ float smem[];
  float* pub = smem;                            // [R][3][units]  masked h
  float* buf = pub + (size_t)R * kGates * units;  // [R][3][kWideChunk]

  const mcd::WideThread th(units, slice, H);
  const int jc = th.unit_ok ? th.j : H - 1;     // a unit to address
  float h[kR], bj[kGates];
  int len[kR];
  int32_t rid[kR];
#pragma unroll
  for (int q = 0; q < kR; ++q) {
    const int br = row0 + th.r0 + q;
    h[q] = br < B && th.unit_ok ? mcd::to_f(h0[(size_t)br * H + th.j])
                                : 0.0f;
    len[q] = br < B ? lens[br] : 0;
    rid[q] = br < B ? rows[br] : -1;
  }
#pragma unroll
  for (int g = 0; g < kGates; ++g) bj[g] = bias[g * H + jc];
  const mcd::Column<A, W, kGates> cx(wx, sx, jc, H), ch(wh, sh, jc, H);

  // The unit's masked h of the thread's rows into pub.
  auto publish = [&]() {
    if (!th.unit_ok) return;
#pragma unroll
    for (int q = 0; q < kR; ++q)
#pragma unroll
      for (int g = 0; g < kGates; ++g)
        pub[((th.r0 + q) * kGates + g) * units + th.ug] =
            mcd::round_to<A>(__fmul_rn(
                h[q], mcd::mask_factor(keys.k[kGates + g], rid[q], H, th.j,
                                       thr, scale, masked)));
  };

  publish();
  for (int t = 0; t < T; ++t) {
    float ax[kR][kGates], ah[kR][kGates];
#pragma unroll
    for (int q = 0; q < kR; ++q)
#pragma unroll
      for (int g = 0; g < kGates; ++g) ax[q][g] = ah[q][g] = 0.0f;
    for (int d0 = 0; d0 < I; d0 += mcd::kWideChunk) {
      const int n = I - d0 < mcd::kWideChunk ? I - d0 : mcd::kWideChunk;
      __syncthreads();                  // buf free
      mcd::stage_masked<A, kGates>(buf, x + (size_t)t * I, (size_t)T * I,
                                   rows, row0, R, B, I, d0, n, keys, 0, thr,
                                   scale, masked);
      __syncthreads();
      if (th.unit_ok) mcd::accumulate(ax, buf, th.r0, cx, d0, n);
    }
    cluster.sync();                     // every block's h_{t-1} published
    for (int d0 = 0; d0 < H; d0 += mcd::kWideChunk) {
      const int n = H - d0 < mcd::kWideChunk ? H - d0 : mcd::kWideChunk;
      __syncthreads();
      mcd::stage_peers<kGates>(buf, pub, R, units, d0, n);
      __syncthreads();
      if (th.unit_ok) mcd::accumulate(ah, buf, th.r0, ch, d0, n);
    }
    cluster.sync();                     // every block has read h_{t-1}
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      const float h_new = mcd::round_to<A>(
          mcd::gru_tail(ax[q][0], ax[q][1], ax[q][2], ah[q][0], ah[q][1],
                        ah[q][2], bj, h[q]));
      if (t < len[q]) h[q] = h_new;
      const int br = row0 + th.r0 + q;
      if (th.unit_ok && br < B)
        ys[((size_t)br * T + t) * H + th.j] = mcd::from_f<A>(h[q]);
    }
    if (t + 1 < T) publish();
  }
#pragma unroll
  for (int q = 0; q < kR; ++q) {
    const int br = row0 + th.r0 + q;
    if (th.unit_ok && br < B) hT[(size_t)br * H + th.j] = mcd::from_f<A>(h[q]);
  }
}

// The cluster path's shared memory: pub [R][3][units] and buf
// [R][3][kWideChunk] floats (kernels/common.py::wide_plan).
size_t cluster_smem_bytes(int R, int units) {
  return (size_t)R * kGates * (units + mcd::kWideChunk) * sizeof(float);
}

template <typename A, typename W>
int launch_cluster_q(const Args<A, W>& o, int B, int T, int I, int H, int R,
                     int C, int units, size_t smem,
                     const mcd::GateKeys& keys, uint32_t thr, float scale,
                     int masked, cudaStream_t s) {
  if (!mcd::wide_plan_ok(H, R, C, units) || C > mcd::kClusterMax ||
      smem < cluster_smem_bytes(R, units))
    return (int)cudaErrorInvalidValue;
  return mcd::launch_cluster(
      mcd_gru_seq_kernel_cluster<A, W>, (B + R - 1) / R, C,
      units * (R / mcd::kWideRowsThread), smem, s, o.x, o.wx, o.wh, o.sx,
      o.sh, o.bias, o.rows, o.lens, o.h0, o.ys, o.hT, B, T, I, H, R, units,
      keys, thr, scale, masked);
}

template <typename A, typename W>
int launch_cluster_typed(const void* x, const void* wx, const void* wh,
                         const float* sx, const float* sh, const float* bias,
                         const int32_t* rows, const int32_t* lens,
                         const void* h0, void* ys, void* hT, int B, int T,
                         int I, int H, int R, int C, int units, size_t smem,
                         const mcd::GateKeys& keys, uint32_t thr, float scale,
                         int masked, cudaStream_t s) {
  using WT = typename mcd::Storage<W>::type;
  if (!std::is_same<W, A>::value && (sx == nullptr || sh == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args<A, W> o{static_cast<const A*>(x), static_cast<const WT*>(wx),
                     static_cast<const WT*>(wh), sx, sh, bias, rows, lens,
                     static_cast<const A*>(h0), static_cast<A*>(ys),
                     static_cast<A*>(hT)};
  return launch_cluster_q<A, W>(o, B, T, I, H, R, C, units, smem, keys, thr,
                                scale, masked, s);
}

}  // namespace

extern "C" {

// Launches one layer on `stream` on the path the host planned (warp != 0:
// the warp path, H must divide 32) with R rows a block and `smem` bytes of
// shared memory, for activations `act` (0: fp32, 1: bf16) and weights of
// `wbits` bits (32: fp32, 16: bf16, 8: int8 codes, 4: packed int4 codes;
// 8 and 4 with the [3, H] scales sx / sh and bf16 activations); returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue when the plan
// or the types do not fit.
int mcd_gru_seq_launch(const void* x, const void* wx, const void* wh,
                       const float* sx, const float* sh, const float* bias,
                       const int32_t* rows, const int32_t* lens,
                       const void* h0, void* ys, void* hT, int B, int T,
                       int I, int H, int R, int warp, int smem_bytes,
                       int act, int wbits, const uint32_t* keys6,
                       uint32_t thr, float scale, int masked, void* stream) {
  const size_t smem = (size_t)smem_bytes;
  const mcd::GateKeys keys = mcd::to_keys(keys6, 2 * kGates);
  cudaStream_t s = (cudaStream_t)stream;
#define MCD_GRU_TYPED(AA, WW)                                                \
  return launch_typed_q<AA, WW>(x, wx, wh, sx, sh, bias, rows, lens, h0, ys, \
                                hT, B, T, I, H, R, warp, smem, keys, thr,    \
                                scale, masked, s);
  if (act == 1 && wbits == 16) MCD_GRU_TYPED(bf16, bf16)
  if (act == 1 && wbits == 8) MCD_GRU_TYPED(bf16, int8_t)
  if (act == 1 && wbits == 4) MCD_GRU_TYPED(bf16, mcd::Int4)
#undef MCD_GRU_TYPED
  if (act != 0 || wbits != 32) return (int)cudaErrorInvalidValue;
  return launch_fp32(static_cast<const float*>(x),
                     static_cast<const float*>(wx),
                     static_cast<const float*>(wh), bias, rows, lens,
                     static_cast<const float*>(h0), static_cast<float*>(ys),
                     static_cast<float*>(hT), B, T, I, H, R, warp, smem_bytes,
                     keys6, thr, scale, masked, stream);
}

// Launches one layer on the cluster path (kernels/common.py::wide_plan):
// clusters of C blocks, each cluster a tile of R rows and each block
// `units` hidden units of them, `smem` bytes of shared memory a block; the
// activations and weights as mcd_gru_seq_launch takes them.  Returns
// cudaGetLastError() (0 = launched), cudaErrorInvalidValue when the plan or
// the types do not fit, cudaErrorInvalidConfiguration when such a cluster
// cannot be resident on the card.
int mcd_gru_seq_cluster_launch(
    const void* x, const void* wx, const void* wh, const float* sx,
    const float* sh, const float* bias, const int32_t* rows,
    const int32_t* lens, const void* h0, void* ys, void* hT, int B, int T,
    int I, int H, int R, int C, int units, int smem_bytes, int act,
    int wbits, const uint32_t* keys6, uint32_t thr, float scale, int masked,
    void* stream) {
  const size_t smem = (size_t)smem_bytes;
  const mcd::GateKeys keys = mcd::to_keys(keys6, 2 * kGates);
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || T < 1 || I < 1 || H < 1) return (int)cudaErrorInvalidValue;
#define MCD_GRU_CLUSTER(AA, WW)                                              \
  return launch_cluster_typed<AA, WW>(x, wx, wh, sx, sh, bias, rows, lens,   \
                                      h0, ys, hT, B, T, I, H, R, C, units,  \
                                      smem, keys, thr, scale, masked, s);
  if (act == 0 && wbits == 32) MCD_GRU_CLUSTER(float, float)
  if (act == 1 && wbits == 16) MCD_GRU_CLUSTER(bf16, bf16)
  if (act == 1 && wbits == 8) MCD_GRU_CLUSTER(bf16, int8_t)
  if (act == 1 && wbits == 4) MCD_GRU_CLUSTER(bf16, mcd::Int4)
#undef MCD_GRU_CLUSTER
  return (int)cudaErrorInvalidValue;
}

// Writes the mask factors of every row: fx [B,3,I], fh [B,3,H].  Every
// GRU kernel (sequence and step) fills its factors with the same
// mcd::fill_mask_factors<3>, so this one export holds the card's GRU mask
// bits against the reference.
int mcd_gru_seq_masks_launch(const int32_t* rows, float* fx, float* fh,
                             int B, int I, int H, const uint32_t* keys6,
                             uint32_t thr, float scale, int masked,
                             void* stream) {
  return mcd::launch_mask_factors<kGates>(rows, fx, fh, B, I, H, keys6, thr,
                                          scale, masked, stream);
}

}  // extern "C"
