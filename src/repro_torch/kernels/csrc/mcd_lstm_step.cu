// One fused MC-dropout LSTM step for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/mcd_lstm.py::mcd_lstm_step
// (pallas_call at l.103, body `_kernel` l.39): one time step of one LSTM
// layer -- the eight per-gate keep-masks rebuilt from the counter hash at
// every call (as the TPU kernel does), x*z/(1-p) and h*z/(1-p), the four
// gate products with fp32 accumulation over the full h row, the
// sigmoid/tanh tail, and c read and written in fp32.  Negative int32 rows
// (the student flag) run unmasked and p == 0 skips masking.  The step
// backend (repro_torch.kernels.ops.fused_lstm_layer) launches it once per
// time step and freezes ragged rows outside the kernel.
//
// What bounds it on this card: latency.  A launch does one [B, I+H] x
// [I+H, 4H] step, a few hundred kB and a few MFLOP at the ECG widths
// (bound ~0.1 us), so its time is the launch ramp, one memory round trip
// for the operands, and the critical path of a row: its mask hashes, one
// dependent chain of I + H multiply-adds a gate, and the sigmoid/tanh tail.
// Anything that waits on the whole block -- a fill of every row's mask
// factors into shared memory and a barrier before the first gate sum, as
// this kernel's first design had -- adds its own latency to that path.
//
// Two paths, one arithmetic (mcd_cells.cuh: every product and sum rounded
// on its own, in the plain version's order -- one chain a gate, the x terms
// in index order, then the h terms, then the bias -- and the shared
// lstm_tail, so both paths, the sequence kernel and the plain version agree
// bit for bit):
//  * Warp path, for H that divides 32 (every ECG layer: H = 8, 16): one
//    step of mcd_lstm_seq.cu's warp path.  A row's H units are H lanes of
//    one warp, 32 / H rows a warp; no shared memory and no block barrier.
//    Each lane loads its row id, hashes its own unit's four h-side keep
//    bits in registers and shuffles h * fh (one value a gate) to the row's
//    lanes.  The x side is spread the same way: lane j takes the columns
//    i = j (mod H), hashes their four x-side bits and shuffles x_i * f_gi,
//    so a row draws each of its 4 (I + H) bits once.  Weights and bias are
//    read through the read-only path (the unit's column of wx and wh), c
//    stays in a register.  Lanes of rows past B stay in every shuffle on
//    zeros, so the full-mask shuffles are defined.  For the ECG input
//    widths (I = 1, 8, 16) the x loop is unrolled at compile time.
//  * Block path, for every other H (the wide H = 128 layer, H = 24): one
//    block owns R whole rows, one thread per (row, unit); the block writes
//    its rows' mask factors, x and the full h rows into shared memory, one
//    barrier, then each thread runs mcd_cells.cuh's lstm_unit.
//  * Split path (mcd_wide.cuh), for every layer the block path refuses
//    (H above 1024; a row's mask factors, x and h above a block's shared
//    memory): a grid of (row tiles x unit slices), a block R rows of a
//    slice of units, a thread one unit and two rows.  h_{t-1} comes from
//    global memory, so the blocks are independent: each stages its rows'
//    masked x and masked h a chunk of 128 at a time (the factors from the
//    hash) and runs mcd_lstm_seq.cu's cluster-path chains, bit for bit.
//    A launch reads each weight once for every tile of R rows.
// The host picks the path, the rows a block and the threads
// (kernels/common.py::step_plan) and passes them in; the entry checks them.
//
// Serving precisions: the fp32 kernels stay as they were, and the `_q`
// kernels after them take bf16 x, h and weights (int8/int4 arrive
// dequantized, as the TPU kernel takes them) and write a bf16 h_out; c
// stays fp32.  They round at the masked views and at h_out
// (mcd_cells.cuh), so each is bit-equal to the plain version and to
// mcd_lstm_seq.cu at its precision.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mcd_cells.cuh"
#include "mcd_mask.cuh"
#include "mcd_wide.cuh"

namespace {

constexpr int kGates = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpMaxThreads = 256;

__global__ void mcd_lstm_step_kernel(
    const float* __restrict__ x,      // [B, I]
    const float* __restrict__ h,      // [B, H]
    const float* __restrict__ c,      // [B, H]
    const float* __restrict__ wx,     // [I, 4, H]
    const float* __restrict__ wh,     // [H, 4, H]
    const float* __restrict__ bias,   // [4, H]
    const int32_t* __restrict__ rows, // [B]
    float* __restrict__ h_out,        // [B, H]
    float* __restrict__ c_out,        // [B, H]
    int B, int I, int H, int R, mcd::GateKeys keys, uint32_t thr,
    float scale, int masked) {
  extern __shared__ float smem[];
  float* fx = smem;                     // [R][4][I]
  float* fh = fx + R * kGates * I;      // [R][4][H]
  float* xs = fh + R * kGates * H;      // [R][I]
  float* hs = xs + R * I;               // [R][H]   the full h rows

  const int row0 = blockIdx.x * R;
  mcd::fill_mask_factors<kGates>(fx, fh, rows, row0, R, B, I, H, keys, thr,
                                 scale, masked);
  for (int e = threadIdx.x; e < R * I; e += blockDim.x) {
    const int rr = row0 + e / I;
    xs[e] = rr < B ? x[(size_t)rr * I + e % I] : 0.0f;
  }
  const int r = threadIdx.x / H;        // blockDim.x == R * H
  const int j = threadIdx.x % H;
  const int br = row0 + r;
  const bool active = br < B;
  hs[threadIdx.x] = active ? h[(size_t)br * H + j] : 0.0f;
  __syncthreads();
  if (!active) return;
  float bj[kGates];
  for (int g = 0; g < kGates; ++g) bj[g] = bias[g * H + j];
  float h_new = hs[threadIdx.x];
  float c_new = c[(size_t)br * H + j];
  mcd::lstm_unit(xs + r * I, hs + r * H, fx + r * kGates * I,
                 fh + r * kGates * H, wx, wh, bj, I, H, j, h_new, c_new);
  h_out[(size_t)br * H + j] = h_new;
  c_out[(size_t)br * H + j] = c_new;
}

// Warp path: blockDim.x = 32 * warps, R = warps * (32 / H) rows a block.
// (Both paths' names hold "mcd_lstm_step_kernel", the name a profile of the
// kernel matches.)  IX > 0: I == IX, the x loop is straight-line code;
// IX == 0: any I.
template <int H, int IX>
__global__ void __launch_bounds__(kWarpMaxThreads) mcd_lstm_step_kernel_warp(
    const float* __restrict__ x, const float* __restrict__ h,
    const float* __restrict__ c, const float* __restrict__ wx,
    const float* __restrict__ wh, const float* __restrict__ bias,
    const int32_t* __restrict__ rows, float* __restrict__ h_out,
    float* __restrict__ c_out, int B, int I_arg, mcd::GateKeys keys,
    uint32_t thr, float scale, int masked) {
  constexpr int kRowsPerWarp = 32 / H;
  const int I = IX > 0 ? IX : I_arg;
  const int lane = threadIdx.x & 31;
  const int br = (blockIdx.x * blockDim.x + threadIdx.x) / 32 * kRowsPerWarp +
                 lane / H;
  const int j = lane % H;
  const bool active = br < B;

  // The row's masking: unmasked for a student row, a row past B, or
  // masked == 0 (its factors are 1, as mcd::fill_mask_factors writes them).
  const int32_t row = active ? __ldg(rows + br) : -1;
  const bool draw = masked && row >= 0;
  auto factor = [&](uint32_t key, int feat, int col) {
    if (!draw) return 1.0f;
    return mcd::keep_bit(key, (uint32_t)row, (uint32_t)feat, (uint32_t)col,
                         thr)
               ? scale
               : 0.0f;
  };

  const float hj = active ? __ldg(h + (size_t)br * H + j) : 0.0f;
  float cj = active ? __ldg(c + (size_t)br * H + j) : 0.0f;
  const float* xrow = x + (size_t)br * I;

  // x side: lane j holds x_i * f_gi for i = s * H + j, one chunk s of H
  // columns at a time; the row's lanes take the terms in index order.
  float a[kGates] = {0.0f, 0.0f, 0.0f, 0.0f};
  auto x_chunk = [&](int s) {
    const int i = s * H + j;
    const bool own = active && i < I;
    const float xv = own ? __ldg(xrow + i) : 0.0f;
    float xf[kGates];
#pragma unroll
    for (int g = 0; g < kGates; ++g)
      xf[g] = __fmul_rn(xv, own ? factor(keys.k[g], I, i) : 1.0f);
#pragma unroll
    for (int l = 0; l < H; ++l) {
      const int il = s * H + l;
      if (il >= I) break;               // uniform across the warp
      const float* w = wx + (size_t)il * kGates * H + j;
#pragma unroll
      for (int g = 0; g < kGates; ++g)
        a[g] = mcd::gate_term_vf(a[g], __shfl_sync(kFull, xf[g], l, H),
                                 __ldg(w + g * H));
    }
  };
  if (IX > 0) {
#pragma unroll
    for (int s = 0; s < (IX + H - 1) / H; ++s) x_chunk(s);
  } else {
    for (int s = 0; s < (I + H - 1) / H; ++s) x_chunk(s);
  }

  // h side: each lane's h * fh for its unit, shuffled to the row's lanes,
  // continuing each gate's chain after its x terms.
  float hf[kGates], bj[kGates];
#pragma unroll
  for (int g = 0; g < kGates; ++g) {
    hf[g] = __fmul_rn(hj, factor(keys.k[kGates + g], H, j));
    bj[g] = __ldg(bias + g * H + j);
  }
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float* w = wh + (size_t)k * kGates * H + j;
#pragma unroll
    for (int g = 0; g < kGates; ++g)
      a[g] = mcd::gate_term_vf(a[g], __shfl_sync(kFull, hf[g], k, H),
                               __ldg(w + g * H));
  }
  const float h_new = mcd::lstm_tail(a[0], a[1], a[2], a[3], bj, cj);
  if (active) {
    h_out[(size_t)br * H + j] = h_new;
    c_out[(size_t)br * H + j] = cj;
  }
}

size_t block_smem_bytes(int R, int I, int H) {
  return (size_t)R * (kGates * (I + H) + I + H) * sizeof(float);
}

template <int H, int IX>
int launch_warp(const float* x, const float* h, const float* c,
                const float* wx, const float* wh, const float* bias,
                const int32_t* rows, float* h_out, float* c_out, int B,
                int I, int R, const mcd::GateKeys& keys, uint32_t thr,
                float scale, int masked, cudaStream_t stream) {
  const int threads = R * H;            // whole warps
  if (threads % 32 || threads > kWarpMaxThreads)
    return (int)cudaErrorInvalidValue;
  mcd_lstm_step_kernel_warp<H, IX><<<(B + R - 1) / R, threads, 0, stream>>>(
      x, h, c, wx, wh, bias, rows, h_out, c_out, B, I, keys, thr, scale,
      masked);
  return (int)cudaGetLastError();
}

// The fp32 step: the kernels above, launched as before the serving
// precisions came.
int launch_fp32(const float* x, const float* h, const float* c,
                const float* wx, const float* wh, const float* bias,
                const int32_t* rows, float* h_out, float* c_out, int B, int I,
                int H, int R, int warp, const uint32_t* keys8, uint32_t thr,
                float scale, int masked, void* stream) {
  const mcd::GateKeys keys = mcd::to_keys(keys8, 2 * kGates);
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || I < 1 || H < 1 || R < 1) return (int)cudaErrorInvalidValue;
  if (warp) {
#define MCD_LSTM_STEP_WARP_I(HH, II)                                      \
  return launch_warp<HH, II>(x, h, c, wx, wh, bias, rows, h_out, c_out, B, \
                             I, R, keys, thr, scale, masked, s);
#define MCD_LSTM_STEP_WARP(HH)      \
  case HH:                          \
    switch (I) {                    \
      case 1:                       \
        MCD_LSTM_STEP_WARP_I(HH, 1) \
      case 8:                       \
        MCD_LSTM_STEP_WARP_I(HH, 8) \
      case 16:                      \
        MCD_LSTM_STEP_WARP_I(HH, 16) \
      default:                      \
        MCD_LSTM_STEP_WARP_I(HH, 0) \
    }
    switch (H) {
      MCD_LSTM_STEP_WARP(1)
      MCD_LSTM_STEP_WARP(2)
      MCD_LSTM_STEP_WARP(4)
      MCD_LSTM_STEP_WARP(8)
      MCD_LSTM_STEP_WARP(16)
      MCD_LSTM_STEP_WARP(32)
      default:
        return (int)cudaErrorInvalidValue;
    }
#undef MCD_LSTM_STEP_WARP
#undef MCD_LSTM_STEP_WARP_I
  }
  if (R * H > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = block_smem_bytes(R, I, H);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mcd_lstm_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  mcd_lstm_step_kernel<<<(B + R - 1) / R, R * H, smem, s>>>(
      x, h, c, wx, wh, bias, rows, h_out, c_out, B, I, H, R, keys, thr,
      scale, masked);
  return (int)cudaGetLastError();
}

// -- serving precisions: bf16 activations and weights ---------------------
//
// The same two paths and the same arithmetic order as the fp32 kernels
// above, at the activation storage A (bf16), rounded at the masked views
// and at h_out (mcd_cells.cuh).  The fp32 kernels stay as they were, so
// their code does not change.

using mcd::bf16;

template <typename A>
__global__ void mcd_lstm_step_kernel_q(
    const A* __restrict__ x,          // [B, I]
    const A* __restrict__ h,          // [B, H]
    const float* __restrict__ c,      // [B, H]
    const A* __restrict__ wx,         // [I, 4, H]
    const A* __restrict__ wh,         // [H, 4, H]
    const float* __restrict__ bias,   // [4, H]
    const int32_t* __restrict__ rows, // [B]
    A* __restrict__ h_out,            // [B, H]
    float* __restrict__ c_out,        // [B, H]
    int B, int I, int H, int R, mcd::GateKeys keys, uint32_t thr,
    float scale, int masked) {
  extern __shared__ float smem[];
  float* fx = smem;                     // [R][4][I]
  float* fh = fx + R * kGates * I;      // [R][4][H]
  float* xs = fh + R * kGates * H;      // [R][I]
  float* hs = xs + R * I;               // [R][H]   the full h rows

  const int row0 = blockIdx.x * R;
  mcd::fill_mask_factors<kGates>(fx, fh, rows, row0, R, B, I, H, keys, thr,
                                 scale, masked);
  for (int e = threadIdx.x; e < R * I; e += blockDim.x) {
    const int rr = row0 + e / I;
    xs[e] = rr < B ? mcd::to_f(x[(size_t)rr * I + e % I]) : 0.0f;
  }
  const int r = threadIdx.x / H;        // blockDim.x == R * H
  const int j = threadIdx.x % H;
  const int br = row0 + r;
  const bool active = br < B;
  hs[threadIdx.x] = active ? mcd::to_f(h[(size_t)br * H + j]) : 0.0f;
  __syncthreads();
  if (!active) return;
  float bj[kGates];
  for (int g = 0; g < kGates; ++g) bj[g] = bias[g * H + j];
  const mcd::Column<A, A, kGates> cx(wx, nullptr, j, H), ch(wh, nullptr, j, H);
  float h_new = hs[threadIdx.x];
  float c_new = c[(size_t)br * H + j];
  mcd::lstm_unit_q<A>(xs + r * I, hs + r * H, fx + r * kGates * I,
                    fh + r * kGates * H, cx, ch, bj, I, H, h_new, c_new);
  h_out[(size_t)br * H + j] = mcd::from_f<A>(h_new);
  c_out[(size_t)br * H + j] = c_new;
}

// Warp path: blockDim.x = 32 * warps, R = warps * (32 / H) rows a block.
// (Both paths' names hold "mcd_lstm_step_kernel", the name a profile of the
// kernel matches.)  IX > 0: I == IX, the x loop is straight-line code;
// IX == 0: any I.
template <int H, int IX, typename A>
__global__ void __launch_bounds__(kWarpMaxThreads) mcd_lstm_step_kernel_warp_q(
    const A* __restrict__ x, const A* __restrict__ h,
    const float* __restrict__ c, const A* __restrict__ wx,
    const A* __restrict__ wh, const float* __restrict__ bias,
    const int32_t* __restrict__ rows, A* __restrict__ h_out,
    float* __restrict__ c_out, int B, int I_arg, mcd::GateKeys keys,
    uint32_t thr, float scale, int masked) {
  constexpr int kRowsPerWarp = 32 / H;
  const int I = IX > 0 ? IX : I_arg;
  const int lane = threadIdx.x & 31;
  const int br = (blockIdx.x * blockDim.x + threadIdx.x) / 32 * kRowsPerWarp +
                 lane / H;
  const int j = lane % H;
  const bool active = br < B;

  // The row's masking: unmasked for a student row, a row past B, or
  // masked == 0 (its factors are 1, as mcd::fill_mask_factors writes them).
  const int32_t row = active ? __ldg(rows + br) : -1;
  const bool draw = masked && row >= 0;
  auto factor = [&](uint32_t key, int feat, int col) {
    if (!draw) return 1.0f;
    return mcd::keep_bit(key, (uint32_t)row, (uint32_t)feat, (uint32_t)col,
                         thr)
               ? scale
               : 0.0f;
  };

  const float hj = active ? mcd::to_f(__ldg(h + (size_t)br * H + j)) : 0.0f;
  float cj = active ? __ldg(c + (size_t)br * H + j) : 0.0f;
  const A* xrow = x + (size_t)br * I;

  // x side: lane j holds x_i * f_gi (rounded to A) for i = s * H + j, one
  // chunk s of H columns at a time; the row's lanes take the terms in index
  // order.
  float a[kGates] = {0.0f, 0.0f, 0.0f, 0.0f};
  auto x_chunk = [&](int s) {
    const int i = s * H + j;
    const bool own = active && i < I;
    const float xv = own ? mcd::to_f(__ldg(xrow + i)) : 0.0f;
    float xf[kGates];
#pragma unroll
    for (int g = 0; g < kGates; ++g)
      xf[g] = mcd::round_to<A>(
          __fmul_rn(xv, own ? factor(keys.k[g], I, i) : 1.0f));
#pragma unroll
    for (int l = 0; l < H; ++l) {
      const int il = s * H + l;
      if (il >= I) break;               // uniform across the warp
      const A* w = wx + (size_t)il * kGates * H + j;
#pragma unroll
      for (int g = 0; g < kGates; ++g)
        a[g] = mcd::gate_term_vf(a[g], __shfl_sync(kFull, xf[g], l, H),
                                 mcd::to_f(__ldg(w + g * H)));
    }
  };
  if (IX > 0) {
#pragma unroll
    for (int s = 0; s < (IX + H - 1) / H; ++s) x_chunk(s);
  } else {
    for (int s = 0; s < (I + H - 1) / H; ++s) x_chunk(s);
  }

  // h side: each lane's h * fh for its unit (rounded to A), shuffled to
  // the row's lanes, continuing each gate's chain after its x terms.
  float hf[kGates], bj[kGates];
#pragma unroll
  for (int g = 0; g < kGates; ++g) {
    hf[g] = mcd::round_to<A>(
        __fmul_rn(hj, factor(keys.k[kGates + g], H, j)));
    bj[g] = __ldg(bias + g * H + j);
  }
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const A* w = wh + (size_t)k * kGates * H + j;
#pragma unroll
    for (int g = 0; g < kGates; ++g)
      a[g] = mcd::gate_term_vf(a[g], __shfl_sync(kFull, hf[g], k, H),
                               mcd::to_f(__ldg(w + g * H)));
  }
  const float h_new = mcd::lstm_tail(a[0], a[1], a[2], a[3], bj, cj);
  if (active) {
    h_out[(size_t)br * H + j] = mcd::from_f<A>(h_new);
    c_out[(size_t)br * H + j] = cj;
  }
}

template <int H, int IX, typename A>
int launch_warp_q(const A* x, const A* h, const float* c, const A* wx,
                  const A* wh, const float* bias, const int32_t* rows,
                  A* h_out, float* c_out, int B, int I, int R,
                  const mcd::GateKeys& keys, uint32_t thr, float scale,
                  int masked, cudaStream_t stream) {
  const int threads = R * H;            // whole warps
  if (threads % 32 || threads > kWarpMaxThreads)
    return (int)cudaErrorInvalidValue;
  mcd_lstm_step_kernel_warp_q<H, IX, A>
      <<<(B + R - 1) / R, threads, 0, stream>>>(
          x, h, c, wx, wh, bias, rows, h_out, c_out, B, I, keys, thr, scale,
          masked);
  return (int)cudaGetLastError();
}

template <typename A>
int launch_typed_q(const void* xv, const void* hv, const float* c,
                   const void* wxv, const void* whv, const float* bias,
                   const int32_t* rows, void* h_outv, float* c_out, int B,
                   int I, int H, int R, int warp, const mcd::GateKeys& keys,
                   uint32_t thr, float scale, int masked, cudaStream_t s) {
  const A* x = static_cast<const A*>(xv);
  const A* h = static_cast<const A*>(hv);
  const A* wx = static_cast<const A*>(wxv);
  const A* wh = static_cast<const A*>(whv);
  A* h_out = static_cast<A*>(h_outv);
  if (warp) {
#define MCD_LSTM_STEP_WARP_I(HH, II)                                      \
  return launch_warp_q<HH, II>(x, h, c, wx, wh, bias, rows, h_out, c_out, B, \
                             I, R, keys, thr, scale, masked, s);
#define MCD_LSTM_STEP_WARP(HH)      \
  case HH:                          \
    switch (I) {                    \
      case 1:                       \
        MCD_LSTM_STEP_WARP_I(HH, 1) \
      case 8:                       \
        MCD_LSTM_STEP_WARP_I(HH, 8) \
      case 16:                      \
        MCD_LSTM_STEP_WARP_I(HH, 16) \
      default:                      \
        MCD_LSTM_STEP_WARP_I(HH, 0) \
    }
    switch (H) {
      MCD_LSTM_STEP_WARP(1)
      MCD_LSTM_STEP_WARP(2)
      MCD_LSTM_STEP_WARP(4)
      MCD_LSTM_STEP_WARP(8)
      MCD_LSTM_STEP_WARP(16)
      MCD_LSTM_STEP_WARP(32)
      default:
        return (int)cudaErrorInvalidValue;
    }
#undef MCD_LSTM_STEP_WARP
#undef MCD_LSTM_STEP_WARP_I
  }
  if (R * H > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = block_smem_bytes(R, I, H);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mcd_lstm_step_kernel_q<A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  mcd_lstm_step_kernel_q<A><<<(B + R - 1) / R, R * H, smem, s>>>(
      x, h, c, wx, wh, bias, rows, h_out, c_out, B, I, H, R, keys, thr,
      scale, masked);
  return (int)cudaGetLastError();
}


// -- the split path: layers the warp and block paths refuse ----------------
//
// H above 1024 or an input too wide for the block path's shared memory
// (mcd_wide.cuh): a grid of (row tiles x unit slices), block (tile, q)
// owning units [q * units, (q + 1) * units) of the tile's R rows, a thread
// one unit and kWideRowsThread rows.  A step reads h_{t-1} from global
// memory, so no block needs another's: each stages its rows' masked x and
// masked h a chunk at a time (the factors from the hash, as
// mcd_lstm_seq.cu's cluster path draws them) and runs the same chains
// in the same order, so the two agree bit for bit.  fp32 and bf16 run this
// one template.
template <typename A>
__global__ void __launch_bounds__(mcd::kWideThreads)
mcd_lstm_step_kernel_split(
    const A* __restrict__ x,          // [B, I]
    const A* __restrict__ h,          // [B, H]
    const float* __restrict__ c,      // [B, H]
    const A* __restrict__ wx,         // [I, 4, H]
    const A* __restrict__ wh,         // [H, 4, H]
    const float* __restrict__ bias,   // [4, H]
    const int32_t* __restrict__ rows, // [B]
    A* __restrict__ h_out,            // [B, H]
    float* __restrict__ c_out,        // [B, H]
    int B, int I, int H, int R, int units, int slices, mcd::GateKeys keys,
    uint32_t thr, float scale, int masked) {
  constexpr int kR = mcd::kWideRowsThread;
  const int slice = (int)blockIdx.x % slices;
  const int row0 = (int)blockIdx.x / slices * R;
  extern __shared__ float smem[];
  float* buf = smem;                    // [R][4][kWideChunk]
  const mcd::WideThread th(units, slice, H);
  const int jc = th.unit_ok ? th.j : H - 1;     // a unit to address
  const mcd::Column<A, A, kGates> cx(wx, nullptr, jc, H),
      ch(wh, nullptr, jc, H);
  float a[kR][kGates];
#pragma unroll
  for (int q = 0; q < kR; ++q)
#pragma unroll
    for (int g = 0; g < kGates; ++g) a[q][g] = 0.0f;
  for (int d0 = 0; d0 < I; d0 += mcd::kWideChunk) {
    const int n = I - d0 < mcd::kWideChunk ? I - d0 : mcd::kWideChunk;
    __syncthreads();                    // buf free
    mcd::stage_masked<A, kGates>(buf, x, (size_t)I, rows, row0, R, B, I, d0,
                                 n, keys, 0, thr, scale, masked);
    __syncthreads();
    if (th.unit_ok) mcd::accumulate(a, buf, th.r0, cx, d0, n);
  }
  for (int d0 = 0; d0 < H; d0 += mcd::kWideChunk) {
    const int n = H - d0 < mcd::kWideChunk ? H - d0 : mcd::kWideChunk;
    __syncthreads();
    mcd::stage_masked<A, kGates>(buf, h, (size_t)H, rows, row0, R, B, H, d0,
                                 n, keys, kGates, thr, scale, masked);
    __syncthreads();
    if (th.unit_ok) mcd::accumulate(a, buf, th.r0, ch, d0, n);
  }
  if (!th.unit_ok) return;
  float bj[kGates];
#pragma unroll
  for (int g = 0; g < kGates; ++g) bj[g] = bias[g * H + th.j];
#pragma unroll
  for (int q = 0; q < kR; ++q) {
    const int br = row0 + th.r0 + q;
    if (br >= B) continue;
    float c_new = c[(size_t)br * H + th.j];
    const float h_new = mcd::round_to<A>(
        mcd::lstm_tail(a[q][0], a[q][1], a[q][2], a[q][3], bj, c_new));
    h_out[(size_t)br * H + th.j] = mcd::from_f<A>(h_new);
    c_out[(size_t)br * H + th.j] = c_new;
  }
}

// The split path's shared memory: buf [R][4][kWideChunk] floats
// (kernels/common.py::wide_plan).
size_t split_smem_bytes(int R) {
  return (size_t)R * kGates * mcd::kWideChunk * sizeof(float);
}

}  // namespace

extern "C" {

// Launches one step on `stream` on the path the host planned (warp != 0:
// the warp path, H must divide 32) with R rows a block, for activations
// and weights `act` (0: fp32, 1: bf16); returns cudaGetLastError() (0 =
// launched), or cudaErrorInvalidValue when the plan does not fit the path.
int mcd_lstm_step_launch(const void* x, const void* h, const float* c,
                         const void* wx, const void* wh, const float* bias,
                         const int32_t* rows, void* h_out, float* c_out,
                         int B, int I, int H, int R, int warp, int act,
                         const uint32_t* keys8, uint32_t thr, float scale,
                         int masked, void* stream) {
  const mcd::GateKeys keys = mcd::to_keys(keys8, 2 * kGates);
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || I < 1 || H < 1 || R < 1) return (int)cudaErrorInvalidValue;
  if (act == 1)
    return launch_typed_q<bf16>(x, h, c, wx, wh, bias, rows, h_out, c_out, B,
                              I, H, R, warp, keys, thr, scale, masked, s);
  if (act != 0) return (int)cudaErrorInvalidValue;
  return launch_fp32(static_cast<const float*>(x),
                     static_cast<const float*>(h), c,
                     static_cast<const float*>(wx),
                     static_cast<const float*>(wh), bias, rows,
                     static_cast<float*>(h_out), c_out, B, I, H, R, warp,
                     keys8, thr, scale, masked, stream);
}

// Launches one step on the split path (kernels/common.py::wide_plan): a
// grid of (row tiles of R rows) x (`slices` slices of `units` hidden
// units), for activations and weights `act` (0: fp32, 1: bf16).  Returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue when the plan
// does not fit the path.
int mcd_lstm_step_split_launch(const void* x, const void* h,
                               const float* c, const void* wx,
                               const void* wh, const float* bias,
                               const int32_t* rows, void* h_out,
                               float* c_out, int B, int I, int H, int R,
                               int slices, int units, int act,
                               const uint32_t* keys8, uint32_t thr,
                               float scale, int masked, void* stream) {
  const mcd::GateKeys keys = mcd::to_keys(keys8, 2 * kGates);
  cudaStream_t s = (cudaStream_t)stream;
  if (B < 1 || I < 1 || H < 1 || !mcd::wide_plan_ok(H, R, slices, units))
    return (int)cudaErrorInvalidValue;
  const int tiles = (B + R - 1) / R;
  const int threads = units * (R / mcd::kWideRowsThread);
  const size_t smem = split_smem_bytes(R);
#define MCD_LSTM_SPLIT(AA)                                                \
  {                                                                       \
    if (smem > 48 * 1024) {                                               \
      cudaError_t err = cudaFuncSetAttribute(                             \
          mcd_lstm_step_kernel_split<AA>,                                 \
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);        \
      if (err != cudaSuccess) return (int)err;                            \
    }                                                                     \
    mcd_lstm_step_kernel_split<AA><<<tiles * slices, threads, smem, s>>>( \
        static_cast<const AA*>(x), static_cast<const AA*>(h), c,          \
        static_cast<const AA*>(wx), static_cast<const AA*>(wh), bias,     \
        rows, static_cast<AA*>(h_out), c_out, B, I, H, R, units, slices,  \
        keys, thr, scale, masked);                                        \
    return (int)cudaGetLastError();                                       \
  }
  if (act == 0) MCD_LSTM_SPLIT(float)
  if (act == 1) MCD_LSTM_SPLIT(bf16)
#undef MCD_LSTM_SPLIT
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
