// Sequence-fused MC-dropout LSTM layer for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/mcd_lstm_seq.py::mcd_lstm_seq
// (pallas_call at l.188, body `_kernel` l.56-128): one launch runs a whole
// LSTM layer over all T steps, carrying (h, c) on chip, rebuilding the eight
// per-gate Bernoulli keep-masks from the counter hash, applying x*z/(1-p)
// and h*z/(1-p), running the four gate products with fp32 accumulation and
// the sigmoid/tanh tail.  `lengths` freezes a row's (h, c) once t >= length
// (ys repeats the frozen h), h0/c0 seed the carry, negative int32 rows (the
// student flag, the uint32 high bit) run unmasked, and p == 0 skips masking.
//
// What bounds it on this card: latency.  The T steps are dependent, and each
// is only a [rows, I+H] x [I+H, 4H] product per batch tile (at the ECG
// classifier's H = 8 that is 64 multiply-adds per thread per step), so the
// time is T times one step's latency (global loads of x_t, a few hundred
// dependent FMAs, two block barriers), far above both the byte and the FLOP
// bound of the whole layer.
//
// What this simple design does about it:
//  * The T loop runs inside the kernel (the TPU grid's sequential axis), so
//    there is one launch per layer, not one per step.
//  * One block owns a tile of R whole batch rows (R*H threads, one per
//    (row, hidden unit)); rows are independent, so no state crosses blocks.
//    h of the tile lives in shared memory, c in a register, both fp32.
//  * Masks are tied across T, so each block computes its rows' mask factors
//    (0, 1/(1-p), or 1 for unmasked rows) once, into shared memory, before
//    the loop.
//  * Weights stay in global memory, read through the read-only path; at
//    these widths they sit in L1/L2 for the whole launch.
// Left for a later PR: weights resident in shared memory, the gate product
// on tensor cores (mma / wgmma) for large H, and a thread-block-cluster
// split of H with h exchanged through distributed shared memory.
//
// The mask stream (mcd_mask.cuh) and the cell body (mcd_cells.cuh) are
// shared with the GRU and step kernels.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mcd_cells.cuh"
#include "mcd_mask.cuh"

namespace {

constexpr int kGates = 4;

__global__ void mcd_lstm_seq_kernel(
    const float* __restrict__ x,      // [B, T, I]
    const float* __restrict__ wx,     // [I, 4, H]
    const float* __restrict__ wh,     // [H, 4, H]
    const float* __restrict__ bias,   // [4, H]
    const int32_t* __restrict__ rows, // [B]
    const int32_t* __restrict__ lens, // [B]
    const float* __restrict__ h0,     // [B, H]
    const float* __restrict__ c0,     // [B, H]
    float* __restrict__ ys,           // [B, T, H]
    float* __restrict__ hT,           // [B, H]
    float* __restrict__ cT,           // [B, H]
    int B, int T, int I, int H, int R, mcd::GateKeys keys, uint32_t thr,
    float scale, int masked) {
  extern __shared__ float smem[];
  float* fx = smem;                     // [R][4][I]
  float* fh = fx + R * kGates * I;      // [R][4][H]
  float* xs = fh + R * kGates * H;      // [R][I]   x_t of the tile
  float* hs = xs + R * I;               // [R][H]   h_{t-1} of the tile

  const int row0 = blockIdx.x * R;
  mcd::fill_mask_factors<kGates>(fx, fh, rows, row0, R, B, I, H, keys, thr,
                                 scale, masked);

  const int r = threadIdx.x / H;        // blockDim.x == R * H
  const int j = threadIdx.x % H;
  const int br = row0 + r;
  const bool active = br < B;
  float h = 0.0f, c = 0.0f;
  int len = 0;
  if (active) {
    h = h0[(size_t)br * H + j];
    c = c0[(size_t)br * H + j];
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
      float h_new = h, c_new = c;
      mcd::lstm_unit(xr, hr, fxr, fhr, wx, wh, bj, I, H, j, h_new, c_new);
      if (t < len) {
        c = c_new;
        h = h_new;
      }
      ys[((size_t)br * T + t) * H + j] = h;
    }
    __syncthreads();
  }
  if (active) {
    hT[(size_t)br * H + j] = h;
    cT[(size_t)br * H + j] = c;
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes for a tile of R rows (the wrapper picks R).
size_t mcd_lstm_seq_smem_bytes(int R, int I, int H) {
  return (size_t)R * (kGates * (I + H) + I + H) * sizeof(float);
}

// Launches one layer on `stream`; returns cudaGetLastError() (0 = launched).
int mcd_lstm_seq_launch(const float* x, const float* wx, const float* wh,
                        const float* bias, const int32_t* rows,
                        const int32_t* lens, const float* h0, const float* c0,
                        float* ys, float* hT, float* cT, int B, int T, int I,
                        int H, int R, const uint32_t* keys8, uint32_t thr,
                        float scale, int masked, void* stream) {
  const size_t smem = mcd_lstm_seq_smem_bytes(R, I, H);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mcd_lstm_seq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (B + R - 1) / R;
  mcd_lstm_seq_kernel<<<blocks, R * H, smem, (cudaStream_t)stream>>>(
      x, wx, wh, bias, rows, lens, h0, c0, ys, hT, cT, B, T, I, H, R,
      mcd::to_keys(keys8, 2 * kGates), thr, scale, masked);
  return (int)cudaGetLastError();
}

// Writes the mask factors of every row: fx [B,4,I], fh [B,4,H].  Every
// LSTM kernel (sequence and step) fills its factors with the same
// mcd::fill_mask_factors<4>, so this one export holds the card's LSTM mask
// bits against the reference.
int mcd_lstm_seq_masks_launch(const int32_t* rows, float* fx, float* fh,
                              int B, int I, int H, const uint32_t* keys8,
                              uint32_t thr, float scale, int masked,
                              void* stream) {
  return mcd::launch_mask_factors<kGates>(rows, fx, fh, B, I, H, keys8, thr,
                                          scale, masked, stream);
}

}  // extern "C"
