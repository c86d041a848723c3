// One (row, hidden unit) of one MC-dropout recurrent step, shared by the
// sequence kernels (the block and warp paths of mcd_lstm_seq and
// mcd_gru_seq) and the step kernels (mcd_lstm_step, mcd_gru_step), so a
// step backend and a sequence backend of the same cell run the same
// arithmetic in the same order.  The warp paths run their own gate sums
// (weights in registers, h by shuffles) and share the tails (lstm_tail,
// gru_tail).
//
// Operands: xr the row's input [I] and hr its h_{t-1} [H] (shared memory);
// fxr [G][I] and fhr [G][H] the row's mask factors (mcd_mask.cuh); wx
// [I, G, H] and wh [H, G, H] gate-stacked weights in global memory (read
// through the read-only path); j the thread's hidden unit.  Every gate sum
// is accumulated in fp32 over the contraction index in order, x side first.
//
// The arithmetic is pinned with round-to-nearest intrinsics: every product
// and every sum is rounded on its own (no contraction into a fused
// multiply-add), as the plain PyTorch versions compute them -- one
// elementwise op per rounding (kernels/mcd_lstm.py::lstm_cell_plain,
// kernels/mcd_gru.py::gru_update_plain).  So nvcc's contraction cannot
// make two paths of one cell, or a kernel and its plain version, differ.

#pragma once

#include "mcd_mask.cuh"

namespace mcd {

// acc + (v * f) * w, each operation rounded: one term of a masked gate sum.
__device__ __forceinline__ float gate_term(float acc, float v, float f,
                                           float w) {
  return __fadd_rn(acc, __fmul_rn(__fmul_rn(v, f), w));
}

// acc + vf * w, each operation rounded, where vf = v * f was rounded before.
__device__ __forceinline__ float gate_term_vf(float acc, float vf, float w) {
  return __fadd_rn(acc, __fmul_rn(vf, w));
}

// The GRU's activations and update from its six gate sums (x side and h
// side apart), as repro/kernels/mcd_gru.py::_gru_update orders them:
//   r = sigmoid(x0 + h0 + b0),  z = sigmoid(x1 + h1 + b1),
//   n = tanh(x2 + r * h2 + b2),  h' = (1 - z) * n + z * h.
__device__ __forceinline__ float gru_tail(float x0, float x1, float x2,
                                          float h0, float h1, float h2,
                                          const float* bj, float h_own) {
  const float r = sigmoid(__fadd_rn(__fadd_rn(x0, h0), bj[0]));
  const float z = sigmoid(__fadd_rn(__fadd_rn(x1, h1), bj[1]));
  const float n =
      tanhf(__fadd_rn(__fadd_rn(x2, __fmul_rn(r, h2)), bj[2]));
  return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, z), n), __fmul_rn(z, h_own));
}

// The LSTM's activations and update from its four gate sums (x side, then
// h side, in one chain a gate), as kernels/mcd_lstm.py::lstm_cell_plain
// orders them:
//   i = sigmoid(a0 + b0), f = sigmoid(a1 + b1), g = tanh(a2 + b2),
//   o = sigmoid(a3 + b3),  c' = f * c + i * g,  h' = o * tanh(c').
// Updates c to c' and returns h'.
__device__ __forceinline__ float lstm_tail(float a0, float a1, float a2,
                                           float a3, const float* bj,
                                           float& c) {
  const float ig = sigmoid(__fadd_rn(a0, bj[0]));
  const float fg = sigmoid(__fadd_rn(a1, bj[1]));
  const float gg = tanhf(__fadd_rn(a2, bj[2]));
  const float og = sigmoid(__fadd_rn(a3, bj[3]));
  c = __fadd_rn(__fmul_rn(fg, c), __fmul_rn(ig, gg));
  return __fmul_rn(og, tanhf(c));
}

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
    a0 = gate_term(a0, xv, fxr[i], __ldg(w));
    a1 = gate_term(a1, xv, fxr[I + i], __ldg(w + H));
    a2 = gate_term(a2, xv, fxr[2 * I + i], __ldg(w + 2 * H));
    a3 = gate_term(a3, xv, fxr[3 * I + i], __ldg(w + 3 * H));
  }
  for (int k = 0; k < H; ++k) {
    const float hv = hr[k];
    const float* w = wh + (size_t)k * 4 * H + j;
    a0 = gate_term(a0, hv, fhr[k], __ldg(w));
    a1 = gate_term(a1, hv, fhr[H + k], __ldg(w + H));
    a2 = gate_term(a2, hv, fhr[2 * H + k], __ldg(w + 2 * H));
    a3 = gate_term(a3, hv, fhr[3 * H + k], __ldg(w + 3 * H));
  }
  h = lstm_tail(a0, a1, a2, a3, bj, c);
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
    x0 = gate_term(x0, xv, fxr[i], __ldg(w));
    x1 = gate_term(x1, xv, fxr[I + i], __ldg(w + H));
    x2 = gate_term(x2, xv, fxr[2 * I + i], __ldg(w + 2 * H));
  }
  float h0 = 0.0f, h1 = 0.0f, h2 = 0.0f;
  for (int k = 0; k < H; ++k) {
    const float hv = hr[k];
    const float* w = wh + (size_t)k * 3 * H + j;
    h0 = gate_term(h0, hv, fhr[k], __ldg(w));
    h1 = gate_term(h1, hv, fhr[H + k], __ldg(w + H));
    h2 = gate_term(h2, hv, fhr[2 * H + k], __ldg(w + 2 * H));
  }
  return gru_tail(x0, x1, x2, h0, h1, h2, bj, h_own);
}

}  // namespace mcd
