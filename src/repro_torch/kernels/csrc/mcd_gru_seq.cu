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
// high bit) run unmasked, and p == 0 skips masking.  fp32 only: the carry
// is stored in fp32 at every step, the activation dtype.
//
// What bounds it on this card: latency, as for mcd_lstm_seq.  The T steps
// are dependent and each is a [rows, I+H] x [I+H, 3H] product per batch
// tile (at the autoencoder's H = 16, 48 products per gate sum per thread),
// so the time is T times one step's latency (a global load of x_t, a few
// hundred dependent FMAs, two block barriers), far above the byte and FLOP
// bound of the whole layer.
//
// Design (the mcd_lstm_seq.cu design, with no cell state):
//  * The T loop runs inside the kernel (the TPU grid's sequential axis):
//    one launch per layer.
//  * One block owns R whole batch rows, one thread per (row, hidden unit);
//    h of the tile lives in shared memory (and the unit's own h in a
//    register), and two barriers per step separate the reads of h_{t-1}
//    from the writes of h_t.
//  * The mask factors [R][3][I] and [R][3][H] are computed once per block,
//    before the loop (masks are tied across T).
//  * Weights stay in global memory, read through the read-only path; at
//    these widths they sit in L1/L2 for the whole launch.
// Left for a later PR: weights resident in shared memory, tensor cores for
// large H, a cluster split of H, and the int8/int4 in-kernel dequant.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mcd_cells.cuh"
#include "mcd_mask.cuh"

namespace {

constexpr int kGates = 3;

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

}  // namespace

extern "C" {

// Shared-memory bytes for a tile of R rows (the wrapper picks R).
size_t mcd_gru_seq_smem_bytes(int R, int I, int H) {
  return (size_t)R * (kGates * (I + H) + I + H) * sizeof(float);
}

// Launches one layer on `stream`; returns cudaGetLastError() (0 = launched).
int mcd_gru_seq_launch(const float* x, const float* wx, const float* wh,
                       const float* bias, const int32_t* rows,
                       const int32_t* lens, const float* h0, float* ys,
                       float* hT, int B, int T, int I, int H, int R,
                       const uint32_t* keys6, uint32_t thr, float scale,
                       int masked, void* stream) {
  const size_t smem = mcd_gru_seq_smem_bytes(R, I, H);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mcd_gru_seq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (B + R - 1) / R;
  mcd_gru_seq_kernel<<<blocks, R * H, smem, (cudaStream_t)stream>>>(
      x, wx, wh, bias, rows, lens, h0, ys, hT, B, T, I, H, R,
      mcd::to_keys(keys6, 2 * kGates), thr, scale, masked);
  return (int)cudaGetLastError();
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
