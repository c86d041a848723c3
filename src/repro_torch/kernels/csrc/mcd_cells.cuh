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
//
// Serving precisions (repro/kernels/quantize.py), the second half of this
// header.  The activation storage A is __nv_bfloat16 (the fp32 kernels keep
// the functions above); every value is computed on in fp32, where a bf16
// value and the product of two are exact, so the fp32 chains serve both.
// A value is rounded to bf16 (round_to<A>) exactly where the TPU kernels
// round it: (a) the masked views x * s and h * s (a student row or p = 0
// keeps the raw value: its factor is 1), (b) each dequantized weight,
// float32(q) * scale then bf16 (quantize.kernel_weight), and (c) h_t on
// every write.  Gate sums, activations and the LSTM's c stay fp32.  The
// weight storage W is the activation type itself, int8_t codes, or Int4:
// two's-complement nibbles packed two to a byte along H (the even column
// in the low nibble, an odd H padded), with fp32 [G, H] scales.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

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

// -- serving precisions --------------------------------------------------

using bf16 = __nv_bfloat16;

struct Int4 {};   // weight storage tag: packed int4 codes

template <typename W>
struct Storage {
  using type = W;
};
template <>
struct Storage<Int4> {
  using type = uint8_t;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename A>
__device__ __forceinline__ A from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to the activation storage A, held in fp32.
template <typename A>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<A>(v));
}

// The int4 code in the nibble of byte b at bit `shift` (0: the even
// column, 4: the odd one), sign-extended.
__device__ __forceinline__ int int4_code(int b, int shift) {
  const int nib = (b >> shift) & 0xF;
  return nib >= 8 ? nib - 16 : nib;
}

// The code of weight (row dg = d * G + g, column j) of a quantized [D, G, H]
// operand: an int8 code, or an int4 nibble.
__device__ __forceinline__ int code_at(const int8_t* w, size_t dg, int j,
                                       int H) {
  return __ldg(w + dg * H + j);
}
__device__ __forceinline__ int code_at(const uint8_t* w, size_t dg, int j,
                                       int H) {
  return int4_code(__ldg(w + dg * ((H + 1) >> 1) + (j >> 1)), (j & 1) * 4);
}

// The canonical dequant: float32(q) * scale in fp32, rounded to A.
template <typename A>
__device__ __forceinline__ float dequant(int q, float scale) {
  return round_to<A>(__fmul_rn((float)q, scale));
}

// Unit j's column of a gate-stacked weight [D, G, H] in storage W, read as
// the activation values the gate sums take: col(d, g) one value, and
// col.row(d, v) the G values of row d (the row's address formed once, the
// gates at fixed strides, as the fp32 lstm_unit / gru_unit read theirs).
// A quantized column holds its G scales in registers.
template <typename A, typename W, int G>
struct Column {   // W == A: the values as they are stored
  const A* w;
  int H;
  __device__ __forceinline__ Column(const A* w_, const float*, int j, int H_)
      : w(w_ + j), H(H_) {}
  __device__ __forceinline__ void row(int d, float* v) const {
    const A* p = w + (size_t)d * G * H;
#pragma unroll
    for (int g = 0; g < G; ++g) v[g] = to_f(__ldg(p + g * H));
  }
  __device__ __forceinline__ float operator()(int d, int g) const {
    return to_f(__ldg(w + ((size_t)d * G + g) * H));
  }
};

template <typename A, typename W, int G>
struct QColumn {  // int8 or packed int4 codes and their fp32 scales
  using T = typename Storage<W>::type;
  static constexpr bool kInt4 = std::is_same<W, Int4>::value;
  const T* w;       // the unit's code (int4: its byte) in row 0, gate 0
  int stride, shift;
  float s[G];
  __device__ __forceinline__ QColumn(const T* w_, const float* scale, int j,
                                     int H)
      : w(w_ + (kInt4 ? j >> 1 : j)),
        stride(kInt4 ? (H + 1) >> 1 : H),
        shift(kInt4 ? (j & 1) * 4 : 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = __ldg(scale + g * H + j);
  }
  __device__ __forceinline__ int code(const T* p) const {
    if constexpr (kInt4) {
      return int4_code(__ldg(p), shift);
    } else {
      return __ldg(p);
    }
  }
  __device__ __forceinline__ void row(int d, float* v) const {
    const T* p = w + (size_t)d * G * stride;
#pragma unroll
    for (int g = 0; g < G; ++g) v[g] = dequant<A>(code(p + g * stride), s[g]);
  }
  __device__ __forceinline__ float operator()(int d, int g) const {
    return dequant<A>(code(w + ((size_t)d * G + g) * stride), s[g]);
  }
};

template <typename A, int G>
struct Column<A, int8_t, G> : QColumn<A, int8_t, G> {
  using QColumn<A, int8_t, G>::QColumn;
};
template <typename A, int G>
struct Column<A, Int4, G> : QColumn<A, Int4, G> {
  using QColumn<A, Int4, G>::QColumn;
};

// The block's threads copy a [D, G, H] weight into shared memory as
// activation values, dequantizing quantized codes on the way (once, at
// kernel entry).
template <typename A, typename W, int G>
__device__ __forceinline__ void stage_weights(
    A* dst, const typename Storage<W>::type* w, const float* scale, int D,
    int H) {
  for (int e = threadIdx.x; e < D * G * H; e += blockDim.x) {
    if constexpr (std::is_same<W, A>::value) {
      dst[e] = w[e];
    } else {
      const int j = e % H;
      const int dg = e / H;
      dst[e] = from_f<A>(dequant<A>(code_at(w, (size_t)dg, j, H),
                                    __ldg(scale + (dg % G) * H + j)));
    }
  }
}

// acc + round_to<A>(v * f) * w, each operation rounded: one term of a
// masked gate sum at the activation storage A, the masked view rounded.
template <typename A>
__device__ __forceinline__ float gate_term_view(float acc, float v, float f,
                                                float w) {
  return __fadd_rn(acc, __fmul_rn(round_to<A>(__fmul_rn(v, f)), w));
}

// LSTM (gates i, f, g, o): updates (h, c) of unit j in place (h rounded to
// A).  cx, ch: the unit's columns of wx [I, 4, H] and wh [H, 4, H].
template <typename A, typename CX, typename CH>
__device__ __forceinline__ void lstm_unit_q(const float* xr, const float* hr,
                                            const float* fxr,
                                            const float* fhr, const CX& cx,
                                            const CH& ch, const float* bj,
                                            int I, int H, float& h,
                                            float& c) {
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  float w[4];
  for (int i = 0; i < I; ++i) {
    const float xv = xr[i];
    cx.row(i, w);
    a0 = gate_term_view<A>(a0, xv, fxr[i], w[0]);
    a1 = gate_term_view<A>(a1, xv, fxr[I + i], w[1]);
    a2 = gate_term_view<A>(a2, xv, fxr[2 * I + i], w[2]);
    a3 = gate_term_view<A>(a3, xv, fxr[3 * I + i], w[3]);
  }
  for (int k = 0; k < H; ++k) {
    const float hv = hr[k];
    ch.row(k, w);
    a0 = gate_term_view<A>(a0, hv, fhr[k], w[0]);
    a1 = gate_term_view<A>(a1, hv, fhr[H + k], w[1]);
    a2 = gate_term_view<A>(a2, hv, fhr[2 * H + k], w[2]);
    a3 = gate_term_view<A>(a3, hv, fhr[3 * H + k], w[3]);
  }
  h = round_to<A>(lstm_tail(a0, a1, a2, a3, bj, c));
}

// GRU (gates r, z, n): returns h_new of unit j, rounded to A; h_own is the
// unit's own h_{t-1}, the z*h term.  The x side and the h side keep
// separate accumulators: the reset gate scales the h-side candidate sum
// alone, before the candidate bias lands
// (repro/kernels/mcd_gru.py::_gru_update).  cx, ch: the unit's columns of
// wx [I, 3, H] and wh [H, 3, H].
template <typename A, typename CX, typename CH>
__device__ __forceinline__ float gru_unit_q(const float* xr, const float* hr,
                                            const float* fxr,
                                            const float* fhr, const CX& cx,
                                            const CH& ch, const float* bj,
                                            int I, int H, float h_own) {
  float x0 = 0.0f, x1 = 0.0f, x2 = 0.0f;
  float w[3];
  for (int i = 0; i < I; ++i) {
    const float xv = xr[i];
    cx.row(i, w);
    x0 = gate_term_view<A>(x0, xv, fxr[i], w[0]);
    x1 = gate_term_view<A>(x1, xv, fxr[I + i], w[1]);
    x2 = gate_term_view<A>(x2, xv, fxr[2 * I + i], w[2]);
  }
  float h0 = 0.0f, h1 = 0.0f, h2 = 0.0f;
  for (int k = 0; k < H; ++k) {
    const float hv = hr[k];
    ch.row(k, w);
    h0 = gate_term_view<A>(h0, hv, fhr[k], w[0]);
    h1 = gate_term_view<A>(h1, hv, fhr[H + k], w[1]);
    h2 = gate_term_view<A>(h2, hv, fhr[2 * H + k], w[2]);
  }
  return round_to<A>(gru_tail(x0, x1, x2, h0, h1, h2, bj, h_own));
}

}  // namespace mcd
