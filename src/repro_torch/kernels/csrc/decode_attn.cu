// One-token (decode) GQA attention over a KV cache for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attn.py::decode_attention
// (pallas_call at l.78, body `_kernel` l.25): for q [B, H, hd] (after RoPE)
// and caches [B, S, KV, hd], fp32, out[b, h] = softmax over positions
// j <= pos of (q[b, h] . k[b, j, g]) * hd^-0.5, applied to v[b, :, g], where
// g = h / rep and rep = H / KV (q heads group as q.reshape(B, KV, rep, hd)).
// The running max, denominator and accumulator are fp32 and combine as the
// TPU kernel's online softmax does (decode_attn.py:43-58): m_new =
// max(m, max_j s), m_safe = m_new where finite else 0, p = exp(s - m_safe)
// (0 where s is not finite), corr = exp(m - m_safe) (0 where m is not
// finite), l = l * corr + sum p, acc = acc * corr + sum_j p v_j, out = acc /
// max(l, 1e-30).  pos is read on the device (an int32 the caller may update
// between graph replays) or passed by value; like the TPU kernel's operand
// it may hold anything: pos >= S makes every position live, pos < 0 none
// (out = 0).  On the LM decode path this is the softmax over the cache of
// repro/models/layers.py::attention_decode, 28 launches per decode step.
//
// What bounds it on this card: bytes.  It reads K and V up to pos once
// (2 * B * (pos + 1) * KV * hd * 4 bytes; 84 MB at B = 64, pos = 159,
// KV = 8, hd = 128) and does ~4 operations per byte read.  No position past
// pos is read: its copy zero-fills shared memory instead.
//
// Design (host plan: kernels/decode_attn.py::decode_plan, shapes only, never
// pos, so one launch shape serves every decode step):
// * Positions split over blocks.  The grid is (B * KV, splits); each block
//   walks a contiguous run of 16-position tiles for one (row, KV head) and
//   its rep query heads.  With one split the block writes `out`; otherwise
//   it writes its partial (m, l, acc[rep][hd]) to an fp32 scratch and
//   decode_attention_kernel_merge combines a (row, KV head)'s splits in
//   split order (no atomics; a split with no live position leaves m = -inf,
//   l = 0, acc = 0, which adds nothing).
// * A ring of kStages = 3 tiles in shared memory, filled by 16-byte
//   cp.async copies: one commit group and one barrier a tile, tile t + 2 in
//   flight while tile t computes.  The ring is 48 KB at hd = 128, so four
//   blocks fit an SM and the serving shape's 512 blocks run in one wave.
//   A thread's copies step through the tile by fixed increments (no
//   division in the loop), and the ring's first tiles are in flight before
//   q is loaded.
// * Each warp takes 4 positions of a tile, 8 lanes a position, each lane a
//   strided eighth of hd (conflict-free 128-byte rows), so a score costs 3
//   shuffles; the warp keeps its own online softmax, and for p . V a lane
//   owns 4 features (and 4 more at hd > 128) of every head.  The four
//   warps' partials combine in warp order once, after the last tile.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include <cuda_bf16.h>

#include "mcd_async.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTS = 16;                      // positions a tile
constexpr int kStages = 3;                   // tiles in the ring
constexpr int kPosWarp = kTS / kWarps;       // positions a warp a tile
constexpr int kLanesPos = 32 / kPosWarp;     // lanes sharing a position
constexpr int kMaxRep = 8;
constexpr int kMaxHd = 256;
constexpr int kQK = kMaxHd / 4 / kLanesPos;  // float4s a lane in a dot
constexpr int kPV = kMaxHd / 4 / 32;         // float4s a lane accumulates
constexpr unsigned kFull = 0xffffffffu;
static_assert(kLanesPos == 8 && kPosWarp == 4,
              "the shuffles below reduce over xor 1, 2, 4 (a position's "
              "lanes) and xor 8, 16 (a warp's positions)");

// Dynamic shared memory (bytes): the ring of K and V tiles, then q.
constexpr int smem_bytes(int rep, int hd) {
  return (kStages * 2 * kTS * hd + rep * hd) * (int)sizeof(float);
}
constexpr int kMaxSmem = smem_bytes(kMaxRep, kMaxHd);

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// (m, l, a) <- (m, l, a) followed by (m2, l2, a2): the online-softmax step
// with a partial in place of a tile.
__device__ __forceinline__ void combine(float& m, float& l, float& a,
                                        float m2, float l2, float a2) {
  const float m_new = fmaxf(m, m2);
  const float m_safe = isfinite(m_new) ? m_new : 0.0f;
  const float c1 = isfinite(m) ? expf(m - m_safe) : 0.0f;
  const float c2 = isfinite(m2) ? expf(m2 - m_safe) : 0.0f;
  m = m_new;
  l = l * c1 + l2 * c2;
  a = a * c1 + a2 * c2;
}

// Live positions for a pos that may hold anything: 0..n_live-1.
__device__ __forceinline__ int live_positions(const int* pos_ptr, int pos,
                                              int S) {
  const int p = pos_ptr ? *pos_ptr : pos;
  return p < 0 ? 0 : (p >= S ? S : p + 1);
}

// R: the largest rep this instantiation holds in registers (rep <= R).
template <int R>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ kc,
                        const float* __restrict__ vc, float* __restrict__ out,
                        float* __restrict__ part,
                        const int* __restrict__ pos_ptr, int pos, int H,
                        int S, int KV, int hd, int run, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int rep = H / KV;
  const int hd4 = hd / 4;
  const int tile = kTS * hd;                   // floats of K (or V) a tile
  float* ring = smem;                          // [kStages][K | V][kTS][hd]
  float* qs = smem + kStages * 2 * tile;       // [rep][hd]

  const int bg = blockIdx.x;
  const int b = bg / KV;
  const int g = bg % KV;
  const int splits = gridDim.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int n_live = live_positions(pos_ptr, pos, S);
  const int t_begin = blockIdx.y * run;
  const int t_end = min(t_begin + run, (n_live + kTS - 1) / kTS);

  // Tile t into ring slot `slot`; positions past the live ones zero-fill.
  // Float4 e = tid + kThreads * i of a tile is row e / hd4, column e % hd4:
  // both advance by fixed steps.
  const int row_step = kThreads / hd4;
  const int col_step = kThreads - row_step * hd4;
  const int row0 = tid / hd4;
  const int col0 = tid - row0 * hd4;
  const size_t row_floats = (size_t)KV * hd;   // one position of the cache
  auto load_tile = [&](int t, int slot) {
    float* ks = ring + slot * 2 * tile;
    float* vs = ks + tile;
    const int j0 = t * kTS;
    const size_t base = (((size_t)b * S + j0) * KV + g) * hd;
    int j = row0, c = col0;
    for (int e = tid; e < kTS * hd4; e += kThreads) {
      const bool live = j0 + j < n_live;
      const size_t src = live ? base + j * row_floats + 4 * c : 0;
      mcd::cp_async16(ks + 4 * e, kc + src, live ? 16 : 0);
      mcd::cp_async16(vs + 4 * e, vc + src, live ? 16 : 0);
      j += row_step;
      c += col_step;
      if (c >= hd4) {
        c -= hd4;
        ++j;
      }
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (t_begin + i < t_end) load_tile(t_begin + i, i);
    mcd::cp_async_commit();
  }
  const float* qg = q + ((size_t)b * H + (size_t)g * rep) * hd;
  for (int e = tid; e < rep * hd4; e += kThreads)
    reinterpret_cast<float4*>(qs)[e] = reinterpret_cast<const float4*>(qg)[e];

  float m[R], l[R], acc[R][kPV][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < kPV; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][i][c] = 0.0f;
  }
  const int jw = warp * kPosWarp;              // the warp's first position
  const int jt = jw + lane / kLanesPos;        // this lane's position
  const int part4 = lane % kLanesPos;          // its eighth of hd

  for (int t = t_begin; t < t_end; ++t) {
    mcd::cp_async_wait<kStages - 2>();
    __syncthreads();        // tile t is in; every warp is done with t - 1
    if (t + kStages - 1 < t_end)
      load_tile(t + kStages - 1, (t + kStages - 1 - t_begin) % kStages);
    mcd::cp_async_commit();
    const float* ks = ring + ((t - t_begin) % kStages) * 2 * tile;
    const float* vs = ks + tile;

    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.0f;
#pragma unroll
    for (int k = 0; k < kQK; ++k) {
      const int f = part4 + k * kLanesPos;
      if (f < hd4) {
        const float4 kv = ld4(ks + jt * hd + 4 * f);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < rep) {
            const float4 qv = ld4(qs + r * hd + 4 * f);
            s[r] = fmaf(qv.x, kv.x, s[r]);
            s[r] = fmaf(qv.y, kv.y, s[r]);
            s[r] = fmaf(qv.z, kv.z, s[r]);
            s[r] = fmaf(qv.w, kv.w, s[r]);
          }
        }
      }
    }
    const bool live = t * kTS + jt < n_live;
    float p[R][kPosWarp], corr[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= rep) continue;
      float d = s[r];
      d += __shfl_xor_sync(kFull, d, 1);
      d += __shfl_xor_sync(kFull, d, 2);
      d += __shfl_xor_sync(kFull, d, 4);
      const float sc = live ? d * scale : -INFINITY;
      float mx = fmaxf(sc, __shfl_xor_sync(kFull, sc, 8));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 16));
      const float m_new = fmaxf(m[r], mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.0f;
      const float pj = isfinite(sc) ? expf(sc - m_safe) : 0.0f;
      corr[r] = isfinite(m[r]) ? expf(m[r] - m_safe) : 0.0f;
      float ps = pj + __shfl_xor_sync(kFull, pj, 8);
      ps += __shfl_xor_sync(kFull, ps, 16);
      m[r] = m_new;
      l[r] = l[r] * corr[r] + ps;
#pragma unroll
      for (int u = 0; u < kPosWarp; ++u)
        p[r][u] = __shfl_sync(kFull, pj, u * kLanesPos);
    }
#pragma unroll
    for (int i = 0; i < kPV; ++i) {
      const int f = lane + 32 * i;
      if (f >= hd4) continue;
      float sum[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) sum[r][c] = 0.0f;
#pragma unroll
      for (int u = 0; u < kPosWarp; ++u) {
        const float4 vv = ld4(vs + (jw + u) * hd + 4 * f);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r >= rep) continue;
          sum[r][0] = fmaf(p[r][u], vv.x, sum[r][0]);
          sum[r][1] = fmaf(p[r][u], vv.y, sum[r][1]);
          sum[r][2] = fmaf(p[r][u], vv.z, sum[r][2]);
          sum[r][3] = fmaf(p[r][u], vv.w, sum[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= rep) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][i][c] = acc[r][i][c] * corr[r] + sum[r][c];
      }
    }
  }

  // The warps' partials, combined in warp order; the ring is free once
  // every copy has landed and every warp is past its last tile.
  mcd::cp_async_wait<0>();
  __syncthreads();
  float* wacc = ring;                          // [kWarps][rep][hd]
  float* wm = wacc + kWarps * rep * hd;        // [kWarps][rep]
  float* wl = wm + kWarps * rep;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= rep) continue;
#pragma unroll
    for (int i = 0; i < kPV; ++i) {
      const int f = lane + 32 * i;
      if (f < hd4)
        *reinterpret_cast<float4*>(wacc + (warp * rep + r) * hd + 4 * f) =
            make_float4(acc[r][i][0], acc[r][i][1], acc[r][i][2],
                        acc[r][i][3]);
    }
    if (lane == 0) {
      wm[warp * rep + r] = m[r];
      wl[warp * rep + r] = l[r];
    }
  }
  __syncthreads();
  // The partial of split (bg, y), head r: part [B * KV][splits][rep][hd],
  // then [B * KV][splits][rep][m, l].
  const size_t pidx = ((size_t)bg * splits + blockIdx.y) * rep;
  for (int e = tid; e < rep * hd; e += kThreads) {
    const int r = e / hd;
    const int d = e - r * hd;
    float M = -INFINITY, L = 0.0f, A = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      combine(M, L, A, wm[w * rep + r], wl[w * rep + r],
              wacc[(w * rep + r) * hd + d]);
    if (splits == 1) {
      out[((size_t)b * H + (size_t)g * rep + r) * hd + d] =
          A / fmaxf(L, 1e-30f);
    } else {
      part[(pidx + r) * hd + d] = A;
      if (d == 0) {
        float* ml = part + (size_t)gridDim.x * splits * rep * hd;
        ml[2 * (pidx + r)] = M;
        ml[2 * (pidx + r) + 1] = L;
      }
    }
  }
}

constexpr int kMergeBatch = 8;   // splits whose partials load together

// One thread per output (b, g, r, d): the splits' partials in split order.
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel_merge(const float* __restrict__ part,
                              float* __restrict__ out, int H, int KV, int hd,
                              int splits) {
  const int rep = H / KV;
  const int bg = blockIdx.x;
  const int e = blockIdx.y * kThreads + threadIdx.x;
  if (e >= rep * hd) return;
  const int r = e / hd;
  const int d = e - r * hd;
  const float* part_acc = part;
  const float* part_ml = part + (size_t)gridDim.x * splits * rep * hd;
  float M = -INFINITY, L = 0.0f, A = 0.0f;
  for (int s0 = 0; s0 < splits; s0 += kMergeBatch) {
    float pm[kMergeBatch], pl[kMergeBatch], pa[kMergeBatch];
#pragma unroll
    for (int i = 0; i < kMergeBatch; ++i) {
      const size_t pidx = ((size_t)bg * splits + min(s0 + i, splits - 1)) *
                              rep + r;
      pm[i] = part_ml[2 * pidx];
      pl[i] = part_ml[2 * pidx + 1];
      pa[i] = part_acc[pidx * hd + d];
    }
#pragma unroll
    for (int i = 0; i < kMergeBatch; ++i)
      if (s0 + i < splits) combine(M, L, A, pm[i], pl[i], pa[i]);
  }
  out[((size_t)(bg / KV) * H + (size_t)(bg % KV) * rep + r) * hd + d] =
      A / fmaxf(L, 1e-30f);
}

// The instantiation that holds `rep` heads in registers.
template <typename F>
cudaError_t with_kernel(int rep, F f) {
  if (rep <= 2) return f(decode_attention_kernel<2>);
  if (rep <= 4) return f(decode_attention_kernel<4>);
  return f(decode_attention_kernel<kMaxRep>);
}


// ---------------------------------------------------------------------------
// bf16 (the reference's LM dtype): q and the caches bf16, out bf16, every
// score, weight and sum in fp32 as above (the TPU kernel upcasts q, k and
// v and writes q.dtype, decode_attn.py:36-59).  The fp32 kernels above are
// left as they were; these are their design with 16-bit loads: the ring
// holds bf16 tiles (16-byte copies of 8 elements, half the bytes), q is
// widened into shared memory once, and a lane reads 4 features of K or V as
// 8 bytes and widens them.  The partials of a split stay fp32; the out
// rounds to bf16 once.  Bound by bytes: 42 MB of caches at the serving
// shape (B = 64, 160 positions, KV = 8, hd = 128), 12.7 us at 3.35 TB/s.

constexpr int smem_bytes_bf16(int rep, int hd) {
  return kStages * 2 * kTS * hd * 2 + rep * hd * (int)sizeof(float);
}

__device__ __forceinline__ float4 ld4_bf16(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <int R>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel_bf16(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ kc,
                             const __nv_bfloat16* __restrict__ vc,
                             __nv_bfloat16* __restrict__ out,
                             float* __restrict__ part,
                             const int* __restrict__ pos_ptr, int pos, int H,
                             int S, int KV, int hd, int run, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int rep = H / KV;
  const int hd4 = hd / 4;
  const int hd8 = hd / 8;
  const int tile = kTS * hd;                   // bf16 of K (or V) a tile
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  float* qs = smem + kStages * tile;           // after 2 * kStages tiles

  const int bg = blockIdx.x;
  const int b = bg / KV;
  const int g = bg % KV;
  const int splits = gridDim.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int n_live = live_positions(pos_ptr, pos, S);
  const int t_begin = blockIdx.y * run;
  const int t_end = min(t_begin + run, (n_live + kTS - 1) / kTS);

  // Tile t into ring slot `slot`: 16-byte chunk e = tid + kThreads * i of a
  // tile is row e / hd8, column e % hd8.
  const int row_step = kThreads / hd8;
  const int col_step = kThreads - row_step * hd8;
  const int row0 = tid / hd8;
  const int col0 = tid - row0 * hd8;
  const size_t row_elems = (size_t)KV * hd;
  auto load_tile = [&](int t, int slot) {
    __nv_bfloat16* ks = ring + slot * 2 * tile;
    __nv_bfloat16* vs = ks + tile;
    const int j0 = t * kTS;
    const size_t base = (((size_t)b * S + j0) * KV + g) * hd;
    int j = row0, c = col0;
    for (int e = tid; e < kTS * hd8; e += kThreads) {
      const bool live = j0 + j < n_live;
      const size_t src = live ? base + j * row_elems + 8 * c : 0;
      mcd::cp_async16(ks + 8 * e, kc + src, live ? 16 : 0);
      mcd::cp_async16(vs + 8 * e, vc + src, live ? 16 : 0);
      j += row_step;
      c += col_step;
      if (c >= hd8) {
        c -= hd8;
        ++j;
      }
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (t_begin + i < t_end) load_tile(t_begin + i, i);
    mcd::cp_async_commit();
  }
  const __nv_bfloat16* qg = q + ((size_t)b * H + (size_t)g * rep) * hd;
  for (int e = tid; e < rep * hd4; e += kThreads)
    reinterpret_cast<float4*>(qs)[e] = ld4_bf16(qg + 4 * e);

  float m[R], l[R], acc[R][kPV][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < kPV; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][i][c] = 0.0f;
  }
  const int jw = warp * kPosWarp;
  const int jt = jw + lane / kLanesPos;
  const int part4 = lane % kLanesPos;

  for (int t = t_begin; t < t_end; ++t) {
    mcd::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < t_end)
      load_tile(t + kStages - 1, (t + kStages - 1 - t_begin) % kStages);
    mcd::cp_async_commit();
    const __nv_bfloat16* ks = ring + ((t - t_begin) % kStages) * 2 * tile;
    const __nv_bfloat16* vs = ks + tile;

    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.0f;
#pragma unroll
    for (int k = 0; k < kQK; ++k) {
      const int f = part4 + k * kLanesPos;
      if (f < hd4) {
        const float4 kv = ld4_bf16(ks + jt * hd + 4 * f);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < rep) {
            const float4 qv = ld4(qs + r * hd + 4 * f);
            s[r] = fmaf(qv.x, kv.x, s[r]);
            s[r] = fmaf(qv.y, kv.y, s[r]);
            s[r] = fmaf(qv.z, kv.z, s[r]);
            s[r] = fmaf(qv.w, kv.w, s[r]);
          }
        }
      }
    }
    const bool live = t * kTS + jt < n_live;
    float p[R][kPosWarp], corr[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= rep) continue;
      float d = s[r];
      d += __shfl_xor_sync(kFull, d, 1);
      d += __shfl_xor_sync(kFull, d, 2);
      d += __shfl_xor_sync(kFull, d, 4);
      const float sc = live ? d * scale : -INFINITY;
      float mx = fmaxf(sc, __shfl_xor_sync(kFull, sc, 8));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 16));
      const float m_new = fmaxf(m[r], mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.0f;
      const float pj = isfinite(sc) ? expf(sc - m_safe) : 0.0f;
      corr[r] = isfinite(m[r]) ? expf(m[r] - m_safe) : 0.0f;
      float ps = pj + __shfl_xor_sync(kFull, pj, 8);
      ps += __shfl_xor_sync(kFull, ps, 16);
      m[r] = m_new;
      l[r] = l[r] * corr[r] + ps;
#pragma unroll
      for (int u = 0; u < kPosWarp; ++u)
        p[r][u] = __shfl_sync(kFull, pj, u * kLanesPos);
    }
#pragma unroll
    for (int i = 0; i < kPV; ++i) {
      const int f = lane + 32 * i;
      if (f >= hd4) continue;
      float sum[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) sum[r][c] = 0.0f;
#pragma unroll
      for (int u = 0; u < kPosWarp; ++u) {
        const float4 vv = ld4_bf16(vs + (jw + u) * hd + 4 * f);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r >= rep) continue;
          sum[r][0] = fmaf(p[r][u], vv.x, sum[r][0]);
          sum[r][1] = fmaf(p[r][u], vv.y, sum[r][1]);
          sum[r][2] = fmaf(p[r][u], vv.z, sum[r][2]);
          sum[r][3] = fmaf(p[r][u], vv.w, sum[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= rep) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[r][i][c] = acc[r][i][c] * corr[r] + sum[r][c];
      }
    }
  }

  // The warps' partials, combined in warp order, in the freed ring (it
  // holds kStages * 2 * kTS * hd * 2 bytes, at least the 16 * rep * hd +
  // 32 * rep the partials take).
  mcd::cp_async_wait<0>();
  __syncthreads();
  float* wacc = smem;                          // [kWarps][rep][hd]
  float* wm = wacc + kWarps * rep * hd;        // [kWarps][rep]
  float* wl = wm + kWarps * rep;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= rep) continue;
#pragma unroll
    for (int i = 0; i < kPV; ++i) {
      const int f = lane + 32 * i;
      if (f < hd4)
        *reinterpret_cast<float4*>(wacc + (warp * rep + r) * hd + 4 * f) =
            make_float4(acc[r][i][0], acc[r][i][1], acc[r][i][2],
                        acc[r][i][3]);
    }
    if (lane == 0) {
      wm[warp * rep + r] = m[r];
      wl[warp * rep + r] = l[r];
    }
  }
  __syncthreads();
  const size_t pidx = ((size_t)bg * splits + blockIdx.y) * rep;
  for (int e = tid; e < rep * hd; e += kThreads) {
    const int r = e / hd;
    const int d = e - r * hd;
    float M = -INFINITY, L = 0.0f, A = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      combine(M, L, A, wm[w * rep + r], wl[w * rep + r],
              wacc[(w * rep + r) * hd + d]);
    if (splits == 1) {
      out[((size_t)b * H + (size_t)g * rep + r) * hd + d] =
          __float2bfloat16_rn(A / fmaxf(L, 1e-30f));
    } else {
      part[(pidx + r) * hd + d] = A;
      if (d == 0) {
        float* ml = part + (size_t)gridDim.x * splits * rep * hd;
        ml[2 * (pidx + r)] = M;
        ml[2 * (pidx + r) + 1] = L;
      }
    }
  }
}

// The merge of the fp32 partials into a bf16 out.
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel_merge_bf16(const float* __restrict__ part,
                                   __nv_bfloat16* __restrict__ out, int H,
                                   int KV, int hd, int splits) {
  const int rep = H / KV;
  const int bg = blockIdx.x;
  const int e = blockIdx.y * kThreads + threadIdx.x;
  if (e >= rep * hd) return;
  const int r = e / hd;
  const int d = e - r * hd;
  const float* part_acc = part;
  const float* part_ml = part + (size_t)gridDim.x * splits * rep * hd;
  float M = -INFINITY, L = 0.0f, A = 0.0f;
  for (int s0 = 0; s0 < splits; s0 += kMergeBatch) {
    float pm[kMergeBatch], pl[kMergeBatch], pa[kMergeBatch];
#pragma unroll
    for (int i = 0; i < kMergeBatch; ++i) {
      const size_t pidx = ((size_t)bg * splits + min(s0 + i, splits - 1)) *
                              rep + r;
      pm[i] = part_ml[2 * pidx];
      pl[i] = part_ml[2 * pidx + 1];
      pa[i] = part_acc[pidx * hd + d];
    }
#pragma unroll
    for (int i = 0; i < kMergeBatch; ++i)
      if (s0 + i < splits) combine(M, L, A, pm[i], pl[i], pa[i]);
  }
  out[((size_t)(bg / KV) * H + (size_t)(bg % KV) * rep + r) * hd + d] =
      __float2bfloat16_rn(A / fmaxf(L, 1e-30f));
}

template <typename F>
cudaError_t with_kernel_bf16(int rep, F f) {
  if (rep <= 2) return f(decode_attention_kernel_bf16<2>);
  if (rep <= 4) return f(decode_attention_kernel_bf16<4>);
  return f(decode_attention_kernel_bf16<kMaxRep>);
}

}  // namespace

extern "C" {

// Once per device, when the library is loaded: every instantiation (fp32 and
// bf16) may take
// the most shared memory a shape can ask (kMaxSmem), with the SM's carveout
// set to the most shared memory, so a launch (or a captured one) sets no
// attribute.  Returns the CUDA error.
int decode_attention_init() {
  auto fit = [](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
  };
  for (int rep : {2, 4, kMaxRep}) {
    cudaError_t err = with_kernel(rep, fit);
    if (err == cudaSuccess) err = with_kernel_bf16(rep, fit);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The split kernel's resident blocks an SM for this shape, as the runtime
// computes them (registers, shared memory, threads); returns the CUDA error.
int decode_attention_blocks_per_sm(int H, int KV, int hd, int* blocks) {
  const int rep = H / KV;
  return (int)with_kernel(rep, [&](auto kernel) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, kThreads, smem_bytes(rep, hd));
  });
}

// Launches out [B, H, hd] on `stream` for the live positions of the caches:
// pos from *pos_ptr (an int32 on the device) when pos_ptr is not null, else
// `pos`.  The grid is (B * KV, splits), each block a run of `run` tiles of
// kTS positions; splits > 1 needs `part`, B * KV * splits * rep * (hd + 2)
// floats, and adds the merge kernel.  The wrapper
// (kernels/decode_attn.py::decode_plan) checks H % KV == 0, H / KV <= 8,
// hd % 4 == 0, hd <= 256 and 16-byte aligned q and caches.  Returns
// cudaGetLastError() of the last launch (0 = launched), or
// cudaErrorInvalidValue for a plan that does not cover the cache.
int decode_attention_launch(const float* q, const float* kc, const float* vc,
                            float* out, float* part, const int* pos_ptr,
                            int B, int H, int S, int KV, int hd, int pos,
                            int splits, int run, float scale, void* stream) {
  const int tiles = (S + kTS - 1) / kTS;
  if (B < 1 || KV < 1 || H % KV || H / KV > kMaxRep || hd % 4 || hd > kMaxHd ||
      splits < 1 || run < 1 || (splits - 1) * run >= tiles ||
      splits * run < tiles || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int rep = H / KV;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = with_kernel(rep, [&](auto kernel) {
    kernel<<<dim3(B * KV, splits), kThreads, smem_bytes(rep, hd), s>>>(
        q, kc, vc, out, part, pos_ptr, pos, H, S, KV, hd, run, scale);
    return cudaGetLastError();
  });
  if (err != cudaSuccess || splits == 1) return (int)err;
  decode_attention_kernel_merge<<<
      dim3(B * KV, (rep * hd + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      part, out, H, KV, hd, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"

extern "C" {

// The bf16 split kernel's resident blocks an SM for this shape.
int decode_attention_bf16_blocks_per_sm(int H, int KV, int hd, int* blocks) {
  const int rep = H / KV;
  return (int)with_kernel_bf16(rep, [&](auto kernel) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, kThreads, smem_bytes_bf16(rep, hd));
  });
}

// The bf16 launch: as decode_attention_launch on bf16 q, caches and out
// (the partials fp32), which also needs hd % 8 == 0 (16-byte copies of 8
// elements).
int decode_attention_bf16_launch(const void* q, const void* kc,
                                 const void* vc, void* out, float* part,
                                 const int* pos_ptr, int B, int H, int S,
                                 int KV, int hd, int pos, int splits, int run,
                                 float scale, void* stream) {
  const int tiles = (S + kTS - 1) / kTS;
  if (B < 1 || KV < 1 || H % KV || H / KV > kMaxRep || hd % 8 ||
      hd > kMaxHd || splits < 1 || run < 1 || (splits - 1) * run >= tiles ||
      splits * run < tiles || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int rep = H / KV;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* qb = reinterpret_cast<const __nv_bfloat16*>(q);
  const auto* kb = reinterpret_cast<const __nv_bfloat16*>(kc);
  const auto* vb = reinterpret_cast<const __nv_bfloat16*>(vc);
  auto* ob = reinterpret_cast<__nv_bfloat16*>(out);
  cudaError_t err = with_kernel_bf16(rep, [&](auto kernel) {
    kernel<<<dim3(B * KV, splits), kThreads, smem_bytes_bf16(rep, hd), s>>>(
        qb, kb, vb, ob, part, pos_ptr, pos, H, S, KV, hd, run, scale);
    return cudaGetLastError();
  });
  if (err != cudaSuccess || splits == 1) return (int)err;
  decode_attention_kernel_merge_bf16<<<
      dim3(B * KV, (rep * hd + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      part, ob, H, KV, hd, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
