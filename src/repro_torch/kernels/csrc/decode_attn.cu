// One-token (decode) GQA attention over a KV cache for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attn.py::decode_attention
// (pallas_call at l.78, body `_kernel` l.25): for q [B, H, hd] (after RoPE)
// and caches [B, S, KV, hd], fp32, out[b, h] = softmax over positions
// j <= pos of (q[b, h] . k[b, j, g]) * hd^-0.5, applied to v[b, :, g], where
// g = h / rep and rep = H / KV (q heads group as q.reshape(B, KV, rep, hd)).
// The running max, denominator and accumulator are fp32 and combine as the
// TPU kernel's online softmax does (decode_attn.py:43-58): m_new =
// max(m, max_j s), p = exp(s - m_new), corr = exp(m - m_new),
// l = l * corr + sum p, acc = acc * corr + sum_j p v_j, out = acc /
// max(l, 1e-30).  On the LM decode path it is the softmax over the cache of
// repro/models/layers.py::attention_decode, 28 launches per decode step.
//
// What bounds it on this card: bytes.  It reads K and V up to pos once
// (2 * B * (pos + 1) * KV * hd * 4 bytes; 84 MB at B = 64, pos = 159,
// KV = 8, hd = 128) and does ~4 operations per byte read.  The loop stops
// at pos: a block of positions past pos would leave (m, l, acc) unchanged
// bit for bit (p = 0, corr = 1), so it is never loaded.
//
// Design: one block per (batch row, KV head), 128 threads.  The rep query
// heads of the group share each tile of 32 positions of K and V, staged
// through shared memory with 16-byte loads.  Scores: one warp per
// (head, position) dot product, lanes striding hd, reduced by shuffles.
// Softmax update: one warp per head, a lane per position of the tile.
// Accumulate: a thread per output feature d (and d + 128), for every head
// of the group, in registers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBS = 32;          // positions per tile (one per lane)
constexpr int kMaxRep = 8;
constexpr int kMaxHd = 256;
constexpr int kChunks = kMaxHd / kThreads;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ kc,
                        const float* __restrict__ vc, float* __restrict__ out,
                        int H, int S, int KV, int hd, int pos, float scale) {
  extern __shared__ float smem[];
  const int rep = H / KV;
  float* qs = smem;                   // [rep][hd]
  float* ks = qs + rep * hd;          // [kBS][hd]
  float* vs = ks + kBS * hd;          // [kBS][hd]
  float* ss = vs + kBS * hd;          // [rep][kBS] scores, then p
  float* ms = ss + rep * kBS;         // [rep] running max
  float* ls = ms + rep;               // [rep] running denominator
  float* cs = ls + rep;               // [rep] this tile's correction

  const int b = blockIdx.x / KV;
  const int g = blockIdx.x % KV;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const float* qg = q + ((size_t)b * H + (size_t)g * rep) * hd;
  for (int e = tid; e < rep * hd; e += kThreads) qs[e] = qg[e];
  if (tid < rep) {
    ms[tid] = -INFINITY;
    ls[tid] = 0.0f;
  }
  float acc[kMaxRep][kChunks];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r)
#pragma unroll
    for (int c = 0; c < kChunks; ++c) acc[r][c] = 0.0f;

  const int hd4 = hd / 4;
  const int n_valid = pos + 1;
  for (int t0 = 0; t0 < n_valid; t0 += kBS) {
    const int nb = min(kBS, n_valid - t0);
    for (int e = tid; e < nb * hd4; e += kThreads) {
      const int j = e / hd4;
      const int h4 = e % hd4;
      const size_t src = (((size_t)b * S + t0 + j) * KV + g) * hd4 + h4;
      reinterpret_cast<float4*>(ks)[e] =
          reinterpret_cast<const float4*>(kc)[src];
      reinterpret_cast<float4*>(vs)[e] =
          reinterpret_cast<const float4*>(vc)[src];
    }
    __syncthreads();
    for (int pair = warp; pair < rep * kBS; pair += kWarps) {
      const int r = pair / kBS;
      const int j = pair % kBS;
      float s = -INFINITY;
      if (j < nb) {
        float dot = 0.0f;
        for (int h = lane; h < hd; h += 32)
          dot = fmaf(qs[r * hd + h], ks[j * hd + h], dot);
        s = warp_sum(dot) * scale;
      }
      if (lane == 0) ss[r * kBS + j] = s;
    }
    __syncthreads();
    for (int r = warp; r < rep; r += kWarps) {
      const float s = ss[r * kBS + lane];
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float m_safe = isfinite(m_new) ? m_new : 0.0f;
      const float p = isfinite(s) ? expf(s - m_safe) : 0.0f;
      const float psum = warp_sum(p);
      const float corr = isfinite(m_prev) ? expf(m_prev - m_safe) : 0.0f;
      ss[r * kBS + lane] = p;
      __syncwarp();
      if (lane == 0) {
        ms[r] = m_new;
        ls[r] = ls[r] * corr + psum;
        cs[r] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int d = tid + c * kThreads;
      if (d >= hd) continue;
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r >= rep) continue;
        float sum = 0.0f;
        for (int j = 0; j < nb; ++j)
          sum = fmaf(ss[r * kBS + j], vs[j * hd + d], sum);
        acc[r][c] = acc[r][c] * cs[r] + sum;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int d = tid + c * kThreads;
    if (d >= hd) continue;
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r >= rep) continue;
      out[((size_t)b * H + (size_t)g * rep + r) * hd + d] =
          acc[r][c] / fmaxf(ls[r], 1e-30f);
    }
  }
}

size_t smem_bytes(int rep, int hd) {
  return (size_t)(rep * hd + 2 * kBS * hd + rep * kBS + 3 * rep) *
         sizeof(float);
}

}  // namespace

extern "C" {

// Launches out [B, H, hd] on `stream` for positions 0..pos of the caches;
// the wrapper checks 0 <= pos < S, H % KV == 0, H / KV <= 8, hd % 4 == 0,
// hd <= 256 and 16-byte aligned caches.  Returns cudaGetLastError().
int decode_attention_launch(const float* q, const float* kc, const float* vc,
                            float* out, int B, int H, int S, int KV, int hd,
                            int pos, float scale, void* stream) {
  const size_t smem = smem_bytes(H / KV, hd);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  decode_attention_kernel<<<B * KV, kThreads, smem, (cudaStream_t)stream>>>(
      q, kc, vc, out, H, S, KV, hd, pos, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
