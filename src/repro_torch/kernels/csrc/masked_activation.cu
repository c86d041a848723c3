// Fused MC-dropout mask generation and application for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bernoulli_mask.py::masked_activation
// (pallas_call at l.50, body `_kernel` l.24): out = where(keep, x * scale, 0)
// for x [B, F] fp32, with keep = mix32(key ^ mix32(row * F + col)) >= thr
// (uint32 arithmetic, mcd_mask.cuh) and scale = float32(1 / (1 - p)).  Every
// row is masked, a row with the high bit set too: this is the reference's
// `ref._mask`, which casts the rows to uint32 and has no student exemption
// (unlike the recurrent kernels).  masked == 0 (p == 0) copies x.  The mask
// bits are made in registers and never stored.  On the LM decode path it is
// the attention site's mask (repro/models/layers.py::apply_site_mask), 28
// launches per prefill and per decode step at qwen3-1.7b's widths.
//
// What bounds it on this card: bytes.  It reads x once and writes out once
// (8 bytes an element) and does ~20 integer operations an element for the
// hash, far under the card's integer rate; at [64, 2048] one launch moves
// 1 MB, so launch latency, not bandwidth, sets its time.
//
// Design: one thread per 4 consecutive elements of a row, with 16-byte
// loads and stores (the wrapper takes this path when F % 4 == 0 and the
// pointers are 16-byte aligned), else one thread per element.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mcd_mask.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float masked_value(float v, uint32_t row,
                                              uint32_t F, uint32_t col,
                                              uint32_t key, uint32_t thr,
                                              float scale) {
  return mcd::keep_bit(key, row, F, col, thr) ? v * scale : 0.0f;
}

__global__ void masked_activation_kernel(const float* __restrict__ x,
                                         const int32_t* __restrict__ rows,
                                         float* __restrict__ out, int B, int F,
                                         uint32_t key, uint32_t thr,
                                         float scale, int masked) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)B * F) return;
  const int b = (int)(e / F);
  const uint32_t col = (uint32_t)(e % F);
  out[e] = masked ? masked_value(x[e], (uint32_t)rows[b], (uint32_t)F, col,
                                 key, thr, scale)
                  : x[e];
}

// F % 4 == 0: thread e4 owns elements [4 * e4, 4 * e4 + 4) of one row.
__global__ void masked_activation_kernel_vec4(
    const float4* __restrict__ x, const int32_t* __restrict__ rows,
    float4* __restrict__ out, int B, int F, uint32_t key, uint32_t thr,
    float scale, int masked) {
  const int64_t e4 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int F4 = F / 4;
  if (e4 >= (int64_t)B * F4) return;
  float4 v = x[e4];
  if (masked) {
    const uint32_t row = (uint32_t)rows[e4 / F4];
    const uint32_t col = 4u * (uint32_t)(e4 % F4);
    const uint32_t f = (uint32_t)F;
    v.x = masked_value(v.x, row, f, col, key, thr, scale);
    v.y = masked_value(v.y, row, f, col + 1, key, thr, scale);
    v.z = masked_value(v.z, row, f, col + 2, key, thr, scale);
    v.w = masked_value(v.w, row, f, col + 3, key, thr, scale);
  }
  out[e4] = v;
}

}  // namespace

extern "C" {

// Launches out = mask(x) on `stream`; vec4 != 0 takes the 16-byte path
// (F % 4 == 0, 16-byte aligned pointers).  Returns cudaGetLastError().
int masked_activation_launch(const float* x, const int32_t* rows, float* out,
                             int B, int F, int vec4, uint32_t key,
                             uint32_t thr, float scale, int masked,
                             void* stream) {
  const int64_t n = vec4 ? (int64_t)B * (F / 4) : (int64_t)B * F;
  const int blocks = (int)((n + kThreads - 1) / kThreads);
  if (vec4) {
    masked_activation_kernel_vec4<<<blocks, kThreads, 0,
                                    (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(x), rows,
        reinterpret_cast<float4*>(out), B, F, key, thr, scale, masked);
  } else {
    masked_activation_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        x, rows, out, B, F, key, thr, scale, masked);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
