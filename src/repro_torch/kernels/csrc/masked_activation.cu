// Fused MC-dropout mask generation and application for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bernoulli_mask.py::masked_activation
// (pallas_call at l.50, body `_kernel` l.24): out = where(keep, x * scale, 0)
// for x [B, F] fp32, with keep = mix32(key ^ mix32(row * F + col)) >= thr
// (uint32 arithmetic, mcd::keep_bit in mcd_mask.cuh) and scale =
// float32(1 / (1 - p)).  Every row is masked, a row with the high bit set
// too: this is the reference's `ref._mask`, which casts the rows to uint32
// and has no student exemption (unlike the recurrent kernels).  masked == 0
// (p == 0) copies x.  The mask bits are made in registers and never stored.
// On the LM paths it is every site mask (repro/models/layers.py::
// apply_site_mask): 28 launches a qwen3-1.7b prefill or decode step at
// [rows, 2048], 48 a mamba2-370m one at [rows, 1024].
//
// What bounds it on this card: bytes.  It reads x once and writes out once
// (8 bytes an element) and does ~20 integer operations an element for the
// hash, far under the card's integer rate.  At prefill ([8192, 2048],
// [32768, 1024]) that is 64-128 MB and the HBM rate sets the time.  At
// decode ([64, 2048], [64, 1024]) a launch moves 0.5-1 MB, under 0.3 us at
// the HBM rate, so the launch ramp and one memory round trip set the time,
// and whatever work sits between a thread's start and its loads, or
// between its loads and its stores, adds to it.
//
// Design: a 2-D launch with no division.  A unit is a float4 on the
// 16-byte path (F % 4 == 0 and both pointers 16-byte aligned), else a
// float; a row holds n = F / 4 or F units.  Block (bx, by) owns units
// [bx * kThreads, (bx + 1) * kThreads) of row by: the row comes from
// blockIdx.y, the column from blockIdx.x and the thread, so no thread
// divides an index (as a flat launch over B * n units would) and none
// loops.  Past gridDim.y's limit of 65535 rows the entry launches the grid
// once for each 65535 rows.  A thread issues its x load
// and the row id's load first, hashes its unit's keep bits while they are
// in flight (the bits depend only on key, row and column), then applies
// them and stores.  The host picks the path (kernels/bernoulli_mask.py::
// mask_plan, which mirrors the grid); the grid follows from the shape.
// Measured on the H100 and dropped (PERF.md §6): two or four float4 a
// thread (slower at the decode shapes), a loop over rows in the kernel
// (slower at decode, though it runs once there), and a grid of one to
// four waves striding over the rows at prefill.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mcd_mask.cuh"

namespace {

constexpr int kThreads = 256;         // threads a block (mask_plan's THREADS)
constexpr int kMaxRowBlocks = 65535;  // gridDim.y's limit

__device__ __forceinline__ float apply(float v, uint32_t row, uint32_t F,
                                       uint32_t col, uint32_t key,
                                       uint32_t thr, float scale) {
  return mcd::keep_bit(key, row, F, col, thr) ? v * scale : 0.0f;
}

// Unit `unit` of the 16-byte path: floats 4 * unit .. 4 * unit + 3.
__device__ __forceinline__ float4 apply(float4 v, uint32_t row, uint32_t F,
                                        uint32_t unit, uint32_t key,
                                        uint32_t thr, float scale) {
  const uint32_t col = 4u * unit;
  v.x = apply(v.x, row, F, col, key, thr, scale);
  v.y = apply(v.y, row, F, col + 1, key, thr, scale);
  v.z = apply(v.z, row, F, col + 2, key, thr, scale);
  v.w = apply(v.w, row, F, col + 3, key, thr, scale);
  return v;
}

// T = float4 (16-byte path) or float: unit blockIdx.x * kThreads + thread
// of row blockIdx.y.
template <typename T>
__global__ void __launch_bounds__(kThreads) masked_activation_kernel(
    const T* __restrict__ x, const int32_t* __restrict__ rows,
    T* __restrict__ out, int n, uint32_t F, uint32_t key, uint32_t thr,
    float scale, int masked) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= n) return;
  const int64_t e = (int64_t)blockIdx.y * n + c;
  T v = x[e];
  if (masked)
    v = apply(v, (uint32_t)__ldg(rows + blockIdx.y), F, (uint32_t)c, key,
              thr, scale);
  out[e] = v;
}

template <typename T>
void launch_rows(const T* x, const int32_t* rows, T* out, int B, int n,
                 uint32_t F, uint32_t key, uint32_t thr, float scale,
                 int masked, cudaStream_t s) {
  const unsigned cols = (unsigned)(((int64_t)n + kThreads - 1) / kThreads);
  for (int r0 = 0; r0 < B; r0 += kMaxRowBlocks) {
    const int nr = B - r0 < kMaxRowBlocks ? B - r0 : kMaxRowBlocks;
    masked_activation_kernel<T><<<dim3(cols, nr), kThreads, 0, s>>>(
        x + (int64_t)r0 * n, rows + r0, out + (int64_t)r0 * n, n, F, key,
        thr, scale, masked);
  }
}

}  // namespace

extern "C" {

// Launches out = mask(x) on `stream`; vec4 != 0 takes the 16-byte path,
// which needs F % 4 == 0 and 16-byte aligned pointers.  The grid is
// (ceil(n / kThreads), B), one launch for each kMaxRowBlocks rows.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for an empty x or a
// 16-byte path that does not fit it.
int masked_activation_launch(const float* x, const int32_t* rows, float* out,
                             int B, int F, int vec4, uint32_t key,
                             uint32_t thr, float scale, int masked,
                             void* stream) {
  if (B < 1 || F < 1) return (int)cudaErrorInvalidValue;
  if (vec4 && (F % 4 || (uintptr_t)x % 16 || (uintptr_t)out % 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec4)
    launch_rows(reinterpret_cast<const float4*>(x), rows,
                reinterpret_cast<float4*>(out), B, F / 4, (uint32_t)F, key,
                thr, scale, masked, s);
  else
    launch_rows(x, rows, out, B, F, (uint32_t)F, key, thr, scale, masked,
                s);
  return (int)cudaGetLastError();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// bf16: the reference's LM dtype.  out = where(keep, bf16(x * scale), 0) for
// x [B, F] bf16, with scale the bf16 value of 1 / (1 - p) (the TPU kernel's
// jnp.asarray(1 / (1 - p), x.dtype), bernoulli_mask.py:35): the product of
// two bf16 values is exact in fp32, so one rounding to bf16 is the bf16
// product, as the plain version's.  The fp32 kernel above is left as it
// was; this is its design with 16-bit elements: a unit is 8 bf16 (16
// bytes) on the 16-byte path (F % 8 == 0 and both pointers 16-byte
// aligned), else one bf16.  Bound by bytes: 4 an element, half the fp32
// kernel's.

#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ __nv_bfloat16 apply_bf16(
    __nv_bfloat16 v, uint32_t row, uint32_t F, uint32_t col, uint32_t key,
    uint32_t thr, float scale) {
  return mcd::keep_bit(key, row, F, col, thr)
             ? __float2bfloat16_rn(__fmul_rn(__bfloat162float(v), scale))
             : __float2bfloat16_rn(0.0f);
}

// Unit `unit` of the 16-byte path: bf16 elements 8 * unit .. 8 * unit + 7.
__device__ __forceinline__ uint4 apply_bf16(uint4 v, uint32_t row,
                                            uint32_t F, uint32_t unit,
                                            uint32_t key, uint32_t thr,
                                            float scale) {
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
  const uint32_t col = 8u * unit;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    e[i] = apply_bf16(e[i], row, F, col + i, key, thr, scale);
  return v;
}

// T = uint4 (8 bf16, the 16-byte path) or __nv_bfloat16.
template <typename T>
__global__ void __launch_bounds__(kThreads) masked_activation_kernel_bf16(
    const T* __restrict__ x, const int32_t* __restrict__ rows,
    T* __restrict__ out, int n, uint32_t F, uint32_t key, uint32_t thr,
    float scale, int masked) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= n) return;
  const int64_t e = (int64_t)blockIdx.y * n + c;
  T v = x[e];
  if (masked)
    v = apply_bf16(v, (uint32_t)__ldg(rows + blockIdx.y), F, (uint32_t)c,
                   key, thr, scale);
  out[e] = v;
}

template <typename T>
void launch_rows_bf16(const T* x, const int32_t* rows, T* out, int B, int n,
                      uint32_t F, uint32_t key, uint32_t thr, float scale,
                      int masked, cudaStream_t s) {
  const unsigned cols = (unsigned)(((int64_t)n + kThreads - 1) / kThreads);
  for (int r0 = 0; r0 < B; r0 += kMaxRowBlocks) {
    const int nr = B - r0 < kMaxRowBlocks ? B - r0 : kMaxRowBlocks;
    masked_activation_kernel_bf16<T><<<dim3(cols, nr), kThreads, 0, s>>>(
        x + (int64_t)r0 * n, rows + r0, out + (int64_t)r0 * n, n, F, key,
        thr, scale, masked);
  }
}

}  // namespace

extern "C" {

// The bf16 launch: as masked_activation_launch, on bf16 x and out, with
// vec8 != 0 taking the 16-byte path (8 elements a thread), which needs
// F % 8 == 0 and 16-byte aligned pointers; `scale` is the bf16 scale's
// value.
int masked_activation_bf16_launch(const void* x, const int32_t* rows,
                                  void* out, int B, int F, int vec8,
                                  uint32_t key, uint32_t thr, float scale,
                                  int masked, void* stream) {
  if (B < 1 || F < 1) return (int)cudaErrorInvalidValue;
  if (vec8 && (F % 8 || (uintptr_t)x % 16 || (uintptr_t)out % 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec8)
    launch_rows_bf16(reinterpret_cast<const uint4*>(x), rows,
                     reinterpret_cast<uint4*>(out), B, F / 8, (uint32_t)F,
                     key, thr, scale, masked, s);
  else
    launch_rows_bf16(reinterpret_cast<const __nv_bfloat16*>(x), rows,
                     reinterpret_cast<__nv_bfloat16*>(out), B, F,
                     (uint32_t)F, key, thr, scale, masked, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
