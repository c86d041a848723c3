// One fused MC-dropout GRU step for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/mcd_gru.py::mcd_gru_step
// (pallas_call at l.117, body `_kernel` l.77, gate body `_gru_update`
// l.39): one time step of one GRU layer -- the six per-gate keep-masks
// (r, z, n; x side then h side) rebuilt from the counter hash at every
// call, x*z/(1-p) and h*z/(1-p), separate fp32 x-side and h-side gate sums
// over the full h row, and the update
//   r = sigmoid(gx0 + gh0 + b0),  z = sigmoid(gx1 + gh1 + b1),
//   n = tanh(gx2 + r * gh2 + b2),  h' = (1 - z) * n + z * h,
// where the z*h term reads the unit's own h (the TPU kernel's h tile).
// Negative int32 rows (the student flag) run unmasked and p == 0 skips
// masking.  The step backend (repro_torch.kernels.ops.fused_gru_layer)
// launches it once per time step and freezes ragged rows outside.
//
// What bounds it on this card: launch latency, as for mcd_lstm_step.cu --
// one small step per launch; the paper's per-step baseline, not tuned.
//
// Design: one block owns R whole rows, one thread per (row, hidden unit);
// the block writes its rows' mask factors, x and the full h row into
// shared memory, then each thread runs the shared GRU body (mcd_cells.cuh),
// the same arithmetic as the sequence kernel's step.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mcd_cells.cuh"
#include "mcd_mask.cuh"

namespace {

constexpr int kGates = 3;

__global__ void mcd_gru_step_kernel(
    const float* __restrict__ x,      // [B, I]
    const float* __restrict__ h,      // [B, H]
    const float* __restrict__ wx,     // [I, 3, H]
    const float* __restrict__ wh,     // [H, 3, H]
    const float* __restrict__ bias,   // [3, H]
    const int32_t* __restrict__ rows, // [B]
    float* __restrict__ h_out,        // [B, H]
    int B, int I, int H, int R, mcd::GateKeys keys, uint32_t thr,
    float scale, int masked) {
  extern __shared__ float smem[];
  float* fx = smem;                     // [R][3][I]
  float* fh = fx + R * kGates * I;      // [R][3][H]
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
  h_out[(size_t)br * H + j] =
      mcd::gru_unit(xs + r * I, hs + r * H, fx + r * kGates * I,
                    fh + r * kGates * H, wx, wh, bj, I, H, j,
                    hs[threadIdx.x]);
}

}  // namespace

extern "C" {

// Shared-memory bytes for a tile of R rows (the wrapper picks R).
size_t mcd_gru_step_smem_bytes(int R, int I, int H) {
  return (size_t)R * (kGates * (I + H) + I + H) * sizeof(float);
}

// Launches one step on `stream`; returns cudaGetLastError() (0 = launched).
int mcd_gru_step_launch(const float* x, const float* h, const float* wx,
                        const float* wh, const float* bias,
                        const int32_t* rows, float* h_out, int B, int I,
                        int H, int R, const uint32_t* keys6, uint32_t thr,
                        float scale, int masked, void* stream) {
  const size_t smem = mcd_gru_step_smem_bytes(R, I, H);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mcd_gru_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (B + R - 1) / R;
  mcd_gru_step_kernel<<<blocks, R * H, smem, (cudaStream_t)stream>>>(
      x, h, wx, wh, bias, rows, h_out, B, I, H, R,
      mcd::to_keys(keys6, 2 * kGates), thr, scale, masked);
  return (int)cudaGetLastError();
}

}  // extern "C"
