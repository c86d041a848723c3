// Fused MC-dropout mask and matrix product for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/mcd_matmul.py::mcd_matmul
// (pallas_call at l.64, body `_kernel` l.22): y = (x * z / (1 - p)) @ W for
// x [M, K], W [K, N] fp32, fp32 accumulation, with the keep bit of x[m, k]
// = mix32(key ^ mix32(rows[m] * K + k)) >= thr (uint32; mcd_mask.cuh) at the
// global column k, so any tiling draws the reference's bits.  Every row is
// masked, a row with the high bit set too (the reference's `ref._mask` has
// no student exemption).  masked == 0 (p == 0) is the plain product.  The
// masked operand never exists in device memory: the mask is applied to each
// x tile as it is staged into shared memory.  On the LM decode path it is
// the masked SwiGLU gate/up projection of repro/models/layers.py::
// mlp_forward (K = d_model, N = 2 * d_ff), 28 launches per prefill and per
// decode step.
//
// What bounds it on this card: operations, in fp32 on the CUDA cores
// (67 TFLOP/s against 3.35 TB/s: 20 operations a byte).  At decode
// (M = 64 rows, K = 2048, N = 12288) W is 100 MB and each weight feeds 64
// rows, 2 * 64 / 4 = 32 operations a byte: 48 us of operations against
// 31 us of bytes.  At prefill (M = 8192) operations by far.  TF32 tensor
// cores would lift the ceiling but break the fp32 comparison with the
// reference.  This first version is the simple tiled product and stays far
// from the bound; making it fast (wgmma, TMA, a K split for the decode
// shape) is later work.
//
// Design: 64 x 64 output tiles, K steps of 16, 256 threads each owning a
// 4 x 4 block of outputs (rows ty + 16 i, columns tx + 16 j, so shared
// reads broadcast or fall in distinct banks).  x tiles are stored
// transposed (and padded) so a thread's 4 rows are one column of the tile.
// Ragged edges (M, N, K not multiples of the tile) are masked here: the
// host pads nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mcd_mask.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;
constexpr int kPad = 4;

__global__ void __launch_bounds__(kThreads)
mcd_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const int32_t* __restrict__ rows, float* __restrict__ out,
                  int M, int N, int K, uint32_t key, uint32_t thr, float scale,
                  int masked) {
  __shared__ float xs[kBK][kBM + kPad];   // masked x tile, transposed
  __shared__ float ws[kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int l = 0; l < (kBM * kBK) / kThreads; ++l) {
      const int idx = tid + l * kThreads;
      const int m = idx / kBK;
      const int kk = idx % kBK;
      const int gm = m0 + m;
      const int gk = k0 + kk;
      float v = 0.0f;
      if (gm < M && gk < K) {
        v = x[(size_t)gm * K + gk];
        if (masked)
          v = mcd::keep_bit(key, (uint32_t)rows[gm], (uint32_t)K,
                            (uint32_t)gk, thr)
                  ? v * scale
                  : 0.0f;
      }
      xs[kk][m] = v;
    }
#pragma unroll
    for (int l = 0; l < (kBK * kBN) / kThreads; ++l) {
      const int idx = tid + l * kThreads;
      const int kk = idx / kBN;
      const int n = idx % kBN;
      const int gk = k0 + kk;
      const int gn = n0 + n;
      ws[kk][n] = (gk < K && gn < N) ? w[(size_t)gk * N + gn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) out[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// Launches out [M, N] = mask(x) @ w on `stream`; returns cudaGetLastError().
int mcd_matmul_launch(const float* x, const float* w, const int32_t* rows,
                      float* out, int M, int N, int K, uint32_t key,
                      uint32_t thr, float scale, int masked, void* stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  mcd_matmul_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, w, rows, out, M, N, K, key, thr, scale, masked);
  return (int)cudaGetLastError();
}

}  // extern "C"
