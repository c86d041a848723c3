// One (row, hidden unit) of one MC-dropout recurrent step, shared by the
// sequence kernels (mcd_lstm_seq, mcd_gru_seq) and the step kernels
// (mcd_lstm_step, mcd_gru_step), so a step backend and a sequence backend of
// the same cell run the same arithmetic in the same order.
//
// Operands: xr the row's input [I] and hr its h_{t-1} [H] (shared memory);
// fxr [G][I] and fhr [G][H] the row's mask factors (mcd_mask.cuh); wx
// [I, G, H] and wh [H, G, H] gate-stacked weights in global memory (read
// through the read-only path); j the thread's hidden unit.  Every gate sum
// is accumulated in fp32 over the contraction index in order, x side first.

#pragma once

#include "mcd_mask.cuh"

namespace mcd {

// LSTM (gates i, f, g, o): updates (h, c) of unit j in place.
__device__ __forceinline__ void lstm_unit(const float* xr, const float* hr,
                                          const float* fxr, const float* fhr,
                                          const float* __restrict__ wx,
                                          const float* __restrict__ wh,
                                          const float* bj, int I, int H,
                                          int j, float& h, float& c) {
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  for (int i = 0; i < I; ++i) {
    const float xv = xr[i];
    const float* w = wx + (size_t)i * 4 * H + j;
    a0 += (xv * fxr[i]) * __ldg(w);
    a1 += (xv * fxr[I + i]) * __ldg(w + H);
    a2 += (xv * fxr[2 * I + i]) * __ldg(w + 2 * H);
    a3 += (xv * fxr[3 * I + i]) * __ldg(w + 3 * H);
  }
  for (int k = 0; k < H; ++k) {
    const float hv = hr[k];
    const float* w = wh + (size_t)k * 4 * H + j;
    a0 += (hv * fhr[k]) * __ldg(w);
    a1 += (hv * fhr[H + k]) * __ldg(w + H);
    a2 += (hv * fhr[2 * H + k]) * __ldg(w + 2 * H);
    a3 += (hv * fhr[3 * H + k]) * __ldg(w + 3 * H);
  }
  const float ig = sigmoid(a0 + bj[0]);
  const float fg = sigmoid(a1 + bj[1]);
  const float gg = tanhf(a2 + bj[2]);
  const float og = sigmoid(a3 + bj[3]);
  c = fg * c + ig * gg;
  h = og * tanhf(c);
}

// GRU (gates r, z, n): returns h_new of unit j; h_own is the unit's own
// h_{t-1}, the z*h term.  The x side and the h side keep separate
// accumulators: the reset gate scales the h-side candidate sum alone,
// before the candidate bias lands (repro/kernels/mcd_gru.py::_gru_update).
__device__ __forceinline__ float gru_unit(const float* xr, const float* hr,
                                          const float* fxr, const float* fhr,
                                          const float* __restrict__ wx,
                                          const float* __restrict__ wh,
                                          const float* bj, int I, int H,
                                          int j, float h_own) {
  float x0 = 0.0f, x1 = 0.0f, x2 = 0.0f;
  for (int i = 0; i < I; ++i) {
    const float xv = xr[i];
    const float* w = wx + (size_t)i * 3 * H + j;
    x0 += (xv * fxr[i]) * __ldg(w);
    x1 += (xv * fxr[I + i]) * __ldg(w + H);
    x2 += (xv * fxr[2 * I + i]) * __ldg(w + 2 * H);
  }
  float h0 = 0.0f, h1 = 0.0f, h2 = 0.0f;
  for (int k = 0; k < H; ++k) {
    const float hv = hr[k];
    const float* w = wh + (size_t)k * 3 * H + j;
    h0 += (hv * fhr[k]) * __ldg(w);
    h1 += (hv * fhr[H + k]) * __ldg(w + H);
    h2 += (hv * fhr[2 * H + k]) * __ldg(w + 2 * H);
  }
  const float r = sigmoid(x0 + h0 + bj[0]);
  const float z = sigmoid(x1 + h1 + bj[1]);
  const float n = tanhf(x2 + r * h2 + bj[2]);
  return (1.0f - z) * n + z * h_own;
}

}  // namespace mcd
