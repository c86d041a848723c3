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
// What bounds it on this card: launch latency.  Each launch does one
// [B, I+H] x [I+H, 4H] step (a few microseconds of work at the ECG widths),
// so a T-step layer costs T launches and T host round trips through the
// wrapper; this is the paper's per-step baseline against the
// sequence-fused kernel (mcd_lstm_seq.cu), kept simple and not tuned.
//
// Design: one block owns R whole rows, one thread per (row, hidden unit);
// the block writes its rows' mask factors, x and the full h row into
// shared memory, then each thread runs the shared cell body
// (mcd_cells.cuh), the same arithmetic as the sequence kernel's step.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mcd_cells.cuh"
#include "mcd_mask.cuh"

namespace {

constexpr int kGates = 4;

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

}  // namespace

extern "C" {

// Shared-memory bytes for a tile of R rows (the wrapper picks R).
size_t mcd_lstm_step_smem_bytes(int R, int I, int H) {
  return (size_t)R * (kGates * (I + H) + I + H) * sizeof(float);
}

// Launches one step on `stream`; returns cudaGetLastError() (0 = launched).
int mcd_lstm_step_launch(const float* x, const float* h, const float* c,
                         const float* wx, const float* wh, const float* bias,
                         const int32_t* rows, float* h_out, float* c_out,
                         int B, int I, int H, int R, const uint32_t* keys8,
                         uint32_t thr, float scale, int masked,
                         void* stream) {
  const size_t smem = mcd_lstm_step_smem_bytes(R, I, H);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mcd_lstm_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (B + R - 1) / R;
  mcd_lstm_step_kernel<<<blocks, R * H, smem, (cudaStream_t)stream>>>(
      x, h, c, wx, wh, bias, rows, h_out, c_out, B, I, H, R,
      mcd::to_keys(keys8, 2 * kGates), thr, scale, masked);
  return (int)cudaGetLastError();
}

}  // extern "C"
