// The MC-dropout mask stream on the card, shared by every recurrent kernel
// (mcd_lstm_seq, mcd_gru_seq, mcd_lstm_step, mcd_gru_step), so the LSTM and
// GRU kernels draw the same bits from the same code.
//
// The keep bit of mask (kind, gate g, row, col) is
//   mix32(key ^ mix32(row * feat_dim + col)) >= threshold      (uint32)
// with key = keys[g] (x side) or keys[G + g] (h side) for a cell of G gates:
// the 2G per-gate stream keys of repro/kernels/mcd_lstm.py::gate_keys (G=4)
// and repro/kernels/mcd_gru.py::gate_keys (G=3), exactly the reference's
// stream, so the card reproduces its bits.  Rows are int32: a negative row
// carries the student flag (the uint32 high bit) and runs unmasked.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mcd {

constexpr int kMaxKeys = 8;

struct GateKeys {
  uint32_t k[kMaxKeys];
};

inline GateKeys to_keys(const uint32_t* keys, int n) {
  GateKeys k = {};
  for (int i = 0; i < n && i < kMaxKeys; ++i) k.k[i] = keys[i];
  return k;
}

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ bool keep_bit(uint32_t key, uint32_t row,
                                         uint32_t feat, uint32_t col,
                                         uint32_t thr) {
  return mix32(key ^ mix32(row * feat + col)) >= thr;
}

// Mask factors of rows [row0, row0 + R) into fx [R][G][I] and fh [R][G][H]:
// scale where the keep bit is set, 0 where it is not, 1 for unmasked rows
// (student rows, rows past B, or masked == 0).  The block's threads share
// the work.  Used by the layer kernels (into shared memory) and by the
// mask-export kernel (into global memory), so the exported bits are the
// ones the layers use.
template <int G>
__device__ void fill_mask_factors(float* fx, float* fh, const int32_t* rows,
                                  int row0, int R, int B, int I, int H,
                                  const GateKeys& keys, uint32_t thr,
                                  float scale, int masked) {
  const int nx = R * G * I;
  const int nh = R * G * H;
  for (int e = threadIdx.x; e < nx + nh; e += blockDim.x) {
    const bool xside = e < nx;
    const int feat = xside ? I : H;
    const int local = xside ? e : e - nx;
    const int r = local / (G * feat);
    const int g = (local / feat) % G;
    const int col = local % feat;
    const int br = row0 + r;
    float f = 1.0f;
    if (masked && br < B) {
      const int32_t row = rows[br];
      if (row >= 0) {
        const uint32_t key = keys.k[xside ? g : G + g];
        f = keep_bit(key, (uint32_t)row, (uint32_t)feat, (uint32_t)col, thr)
                ? scale
                : 0.0f;
      }
    }
    (xside ? fx : fh)[local] = f;
  }
}

// One block per row: that row's factors fx [B][G][I], fh [B][G][H].
template <int G>
__global__ void mask_factors_kernel(const int32_t* __restrict__ rows,
                                    float* __restrict__ fx,
                                    float* __restrict__ fh, int B, int I,
                                    int H, GateKeys keys, uint32_t thr,
                                    float scale, int masked) {
  const int r0 = blockIdx.x;
  fill_mask_factors<G>(fx + (size_t)r0 * G * I, fh + (size_t)r0 * G * H,
                       rows, r0, 1, B, I, H, keys, thr, scale, masked);
}

template <int G>
int launch_mask_factors(const int32_t* rows, float* fx, float* fh, int B,
                        int I, int H, const uint32_t* keys, uint32_t thr,
                        float scale, int masked, void* stream) {
  mask_factors_kernel<G><<<B, 128, 0, (cudaStream_t)stream>>>(
      rows, fx, fh, B, I, H, to_keys(keys, 2 * G), thr, scale, masked);
  return (int)cudaGetLastError();
}

// 1 / (1 + exp(-v)), each operation rounded, as torch.sigmoid computes it.
__device__ __forceinline__ float sigmoid(float v) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v)));
}

}  // namespace mcd
