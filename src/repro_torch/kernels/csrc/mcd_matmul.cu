// Fused MC-dropout mask and matrix product for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/mcd_matmul.py::mcd_matmul
// (pallas_call at l.64, body `_kernel` l.22): y = (x * z / (1 - p)) @ W for
// x [M, K], W [K, N] fp32, fp32 accumulation, with the keep bit of x[m, k]
// = mix32(key ^ mix32(rows[m] * K + k)) >= thr (uint32; mcd_mask.cuh) at the
// global column k, so any tiling draws the reference's bits.  Every row is
// masked, a row with the high bit set too (the reference's `ref._mask` has
// no student exemption).  masked == 0 (p == 0) is the plain product.  The
// masked operand never exists in device memory.  On the LM path it is the
// masked SwiGLU gate/up projection of repro/models/layers.py::mlp_forward
// (K = d_model, N = 2 * d_ff), one launch a layer per prefill and per
// decode step.
//
// What bounds it on this card: operations, in fp32 on the CUDA cores
// (67 TFLOP/s against 3.35 TB/s: 20 operations a byte).  At decode
// (M = 64, K = 2048, N = 12288) W is 100 MB and each weight feeds 64 rows:
// 48 us of operations against 31 us of bytes.  At prefill (M = 8192)
// operations by far.  TF32 tensor cores would lift the ceiling but break
// the fp32 comparison with the reference (bf16 and wgmma are later work).
//
// Design:
//  * The mask is hashed once.  A first pass writes the keep bits, one
//    uint32 word per 32 columns of a row ([M, ceil(K/32)], a scratch the
//    wrapper allocates; a warp's ballot makes a word).  The product's
//    blocks read words, not hashes: before, every column block hashed its
//    x tile again (192 times at N = 12288).
//  * Each output's K-sum runs in index order, one fused multiply-add a term
//    (__fmaf_rn), with no split of K: the kernel is deterministic and, where
//    cuBLAS sums in order too, bit-equal to it.
//  * A cp.async ring in dynamic shared memory: the x tile (raw), the W tile
//    and the tile's keep-bit words go in 16-byte copies (4-byte ones on a
//    ragged or misaligned K or N, zero-filled past the edges), with one
//    block barrier a K step of 32.  A thread copies x chunks of one row and
//    that row's keep-bit word, then masks the x elements it copied
//    (bit ? v * scale : 0, the plain version's value) while transposing them
//    into a double-buffered [k][m] tile, so both operands are read as
//    bank-conflict-free vectors.
//  * Two tiles, picked by the host (mcd_matmul.py::matmul_plan, TILES):
//    - prefill: 128 x 128 outputs, 256 threads of 8 x 8, a 2-stage ring
//      (a K step of 32 is long enough to hide a load), two blocks an SM;
//    - decode: 64 x 96 outputs, 256 threads of 4 x 6, a 3-stage ring: 128
//      blocks for N = 12288, one wave on 132 SMs, where 64 x 64 tiles made
//      1.45 waves.
//    Both were the fastest of the variants tried on an H100 (PERF.md):
//    64 x 48 tiles of 4 x 4 or 8 x 6 a thread, K steps of 16 on a 4-stage
//    ring, warps of 4 x 8 threads, a grouped block order, 16 x 8 and 8 x 16
//    a thread were slower; a split of K in two at decode was faster but
//    gives up the in-order sums, and was not kept.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mcd_async.cuh"
#include "mcd_mask.cuh"

namespace {

constexpr int kPad = 4;   // floats of padding a row of the transposed x tile

// One warp a keep-bit word: bit l of bits[m * KW + kw] is the keep bit of
// column kw * 32 + l of row m (0 past K).  (Its name holds
// "mcd_matmul_kernel", so a profile of the kernel counts both passes.)
__global__ void mcd_matmul_kernel_bits(const int32_t* __restrict__ rows,
                                       uint32_t* __restrict__ bits, int M,
                                       int K, int KW, uint32_t key,
                                       uint32_t thr) {
  const long long word =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (word >= (long long)M * KW) return;           // warp-uniform
  const int lane = threadIdx.x & 31;
  const int m = (int)(word / KW);
  const int k = (int)(word % KW) * 32 + lane;
  const bool keep = k < K && mcd::keep_bit(key, (uint32_t)rows[m],
                                           (uint32_t)K, (uint32_t)k, thr);
  const uint32_t w = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) bits[word] = w;
}

template <int BM, int BN, int TM, int TN, int BK, int STAGES>
struct Tile {
  static_assert(BK == 16 || BK == 32, "a K step lies in one keep-bit word");
  static constexpr int kThreads = (BM / TM) * (BN / TN);
  static constexpr int kChunksA = BM * BK / 4;     // float4s of an x tile
  static constexpr int kChunksB = BK * BN / 4;
  static constexpr int kPerThread = kChunksA / kThreads;  // of one row
  static_assert(kChunksA % kThreads == 0 && (BK / 4) % kPerThread == 0,
                "a thread's x chunks must lie in one row");
  static constexpr int kRawA = BM * BK;             // floats
  static constexpr int kRawB = BK * BN;
  static constexpr int kStage = kRawA + kRawB + kThreads;  // + a word each
  static constexpr int kLdA = BM + kPad;
  static constexpr int kAt = BK * kLdA;
  static constexpr size_t kSmem =
      (size_t)(STAGES * kStage + 2 * kAt) * sizeof(float);
};

template <int BM, int BN, int TM, int TN, int VN, int BK, int STAGES,
          int MIN_BLOCKS>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), MIN_BLOCKS)
mcd_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const uint32_t* __restrict__ bits, float* __restrict__ out,
                  int M, int N, int K, int KW, float scale, int masked,
                  int vec_a, int vec_b) {
  using Tl = Tile<BM, BN, TM, TN, BK, STAGES>;
  constexpr int NT = Tl::kThreads;
  constexpr int TX = BN / TN;           // threads along N
  constexpr int QM = TM / 4;            // float4 groups of rows a thread
  constexpr int QN = TN / VN;           // VN-wide groups of columns
  constexpr int CPT = Tl::kPerThread;
  static_assert(TM % 4 == 0 && TN % VN == 0 && (VN == 4 || VN == 2), "");
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  float* const at_base = smem + STAGES * Tl::kStage;   // [2][BK][kLdA]

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int KT = (K + BK - 1) / BK;

  auto raw_a = [&](int s) { return smem + s * Tl::kStage; };
  auto raw_b = [&](int s) { return smem + s * Tl::kStage + Tl::kRawA; };
  auto words = [&](int s) {
    return reinterpret_cast<uint32_t*>(smem + s * Tl::kStage + Tl::kRawA +
                                       Tl::kRawB);
  };

  // Stage K step kt into ring slot s: this thread's CPT x chunks (all of
  // one row) and that row's keep-bit word, and its W chunks.
  const int ml = tid * CPT / (BK / 4);           // the thread's x row
  const int kq0 = (tid * CPT % (BK / 4)) * 4;
  auto load = [&](int kt, int s) {
    const int k0 = kt * BK;
    float* a = raw_a(s);
    const int gm = m0 + ml;
    if (masked)
      mcd::cp_async4(words(s) + tid,
                     gm < M ? bits + (size_t)gm * KW + k0 / 32 : bits,
                     gm < M);
#pragma unroll
    for (int l = 0; l < CPT; ++l) {
      const int kq = kq0 + 4 * l;
      const int gk = k0 + kq;
      float* dst = a + ml * BK + kq;
      const float* src = x + (size_t)gm * K + gk;
      if (vec_a) {
        const int n = (gm < M && gk < K) ? 4 * min(4, K - gk) : 0;
        mcd::cp_async16(dst, n ? src : x, n);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = gm < M && gk + e < K;
          mcd::cp_async4(dst + e, ok ? src + e : x, ok);
        }
      }
    }
    float* b = raw_b(s);
#pragma unroll
    for (int c = tid; c < Tl::kChunksB; c += NT) {
      const int kl = c / (BN / 4);
      const int nq = (c % (BN / 4)) * 4;
      const int gk = k0 + kl;
      const int gn = n0 + nq;
      float* dst = b + kl * BN + nq;
      const float* src = w + (size_t)gk * N + gn;
      if (vec_b) {
        const int n = (gk < K && gn < N) ? 4 * min(4, N - gn) : 0;
        mcd::cp_async16(dst, n ? src : w, n);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = gk < K && gn + e < N;
          mcd::cp_async4(dst + e, ok ? src + e : w, ok);
        }
      }
    }
  };

  // Mask the x chunks this thread copied and write them transposed.
  auto transform = [&](int kt, int s, float* at) {
    const float* a = raw_a(s);
    const uint32_t word = masked ? words(s)[tid] >> ((kt * BK) & 31) : 0u;
#pragma unroll
    for (int l = 0; l < CPT; ++l) {
      const int kq = kq0 + 4 * l;
      const float4 v4 = *reinterpret_cast<const float4*>(a + ml * BK + kq);
      float v[4] = {v4.x, v4.y, v4.z, v4.w};
      if (masked) {
        const uint32_t bw = word >> kq;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = ((bw >> e) & 1u) ? __fmul_rn(v[e], scale) : 0.0f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) at[(kq + e) * Tl::kLdA + ml] = v[e];
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    mcd::cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    mcd::cp_async_wait<STAGES - 2>();   // this thread's copies of step kt
    const int s = kt % STAGES;
    float* at = at_base + (kt & 1) * Tl::kAt;
    transform(kt, s, at);
    __syncthreads();                    // step kt staged by every thread;
                                        // step kt-1 read by every thread
    if (kt + STAGES - 1 < KT)
      load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    mcd::cp_async_commit();
    const float* b = raw_b(s);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int q = 0; q < QM; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            at + k * Tl::kLdA + q * (BM / QM) + ty * 4);
        av[4 * q] = v.x;
        av[4 * q + 1] = v.y;
        av[4 * q + 2] = v.z;
        av[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < QN; ++q) {
        const float* src = b + k * BN + q * (BN / QN) + tx * VN;
        if (VN == 4) {
          const float4 v = *reinterpret_cast<const float4*>(src);
          bv[4 * q] = v.x;
          bv[4 * q + 1] = v.y;
          bv[4 * q + 2] = v.z;
          bv[4 * q + 3] = v.w;
        } else {
          const float2 v = *reinterpret_cast<const float2*>(src);
          bv[2 * q] = v.x;
          bv[2 * q + 1] = v.y;
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
  }
  mcd::cp_async_wait<0>();

#pragma unroll
  for (int q = 0; q < QM; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gm = m0 + q * (BM / QM) + ty * 4 + i;
      if (gm >= M) continue;
#pragma unroll
      for (int qn = 0; qn < QN; ++qn) {
        const int gn = n0 + qn * (BN / QN) + tx * VN;
        float* o = out + (size_t)gm * N + gn;
        const float* r = &acc[4 * q + i][VN * qn];
        if (vec_b && gn + VN - 1 < N) {
          if (VN == 4)
            *reinterpret_cast<float4*>(o) =
                make_float4(r[0], r[1], r[2], r[3]);
          else
            *reinterpret_cast<float2*>(o) = make_float2(r[0], r[1]);
        } else {
#pragma unroll
          for (int e = 0; e < VN; ++e)
            if (gn + e < N) o[e] = r[e];
        }
      }
    }
}

template <int BM, int BN, int TM, int TN, int VN, int BK, int STAGES,
          int MIN_BLOCKS>
int launch_tile(const float* x, const float* w, const uint32_t* bits,
                float* out, int M, int N, int K, int KW, float scale,
                int masked, size_t smem, cudaStream_t stream) {
  using Tl = Tile<BM, BN, TM, TN, BK, STAGES>;
  auto kernel = mcd_matmul_kernel<BM, BN, TM, TN, VN, BK, STAGES, MIN_BLOCKS>;
  if (smem < Tl::kSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int vec_a = K % 4 == 0 && ((uintptr_t)x & 15) == 0;
  const int vec_b = N % 4 == 0 && ((uintptr_t)w & 15) == 0 &&
                    ((uintptr_t)out & 15) == 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, Tl::kThreads, smem, stream>>>(x, w, bits, out, M, N, K, KW,
                                               scale, masked, vec_a, vec_b);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches out [M, N] = mask(x) @ w on `stream`: the keep-bit pass into
// `bits` ([M, ceil(K/32)] uint32; unused when masked == 0), then the
// product on the tile the host planned, with `smem_bytes` of shared
// memory.  Returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for an unknown tile or too little shared memory.
int mcd_matmul_launch(const float* x, const float* w, const int32_t* rows,
                      uint32_t* bits, float* out, int M, int N, int K,
                      uint32_t key, uint32_t thr, float scale, int masked,
                      int tile, int smem_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int KW = (K + 31) / 32;
  if (masked) {
    const long long threads = (long long)M * KW * 32;
    mcd_matmul_kernel_bits<<<(unsigned)((threads + 255) / 256), 256, 0,
                             s>>>(rows, bits, M, K, KW, key, thr);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = (size_t)smem_bytes;
  // <BM, BN, TM, TN, VN, BK, STAGES, MIN_BLOCKS>: matmul_plan's TILES.
  if (tile == 1)
    return launch_tile<128, 128, 8, 8, 4, 32, 2, 2>(
        x, w, bits, out, M, N, K, KW, scale, masked, smem, s);
  if (tile == 0)
    return launch_tile<64, 96, 4, 6, 2, 32, 3, 1>(
        x, w, bits, out, M, N, K, KW, scale, masked, smem, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// bf16: the reference's LM dtype.  x [M, K] and W [K, N] bf16, the mask
// applied in bf16 (bit ? bf16(x * scale) : 0, scale the bf16 value of
// 1 / (1 - p), as the TPU kernel's x * scale in x.dtype,
// mcd_matmul.py:40-42), each output's K-sum in fp32 in index order, and the
// result written as fp32 (the SwiGLU gate/up product of the LM, the
// reference's preferred_element_type) or rounded to bf16 (out_bf16, the
// TPU kernel's own x.dtype out).  The fp32 kernel above is left as it was;
// this is its design with 16-bit operands: the ring holds raw bf16 tiles
// (16-byte copies of 8 elements, half the bytes a K step), the x elements
// are masked and widened to fp32 into the same transposed [k][m] tile, and
// the W tile is widened to fp32 as the inner loop reads it.  Where K or N
// is not a multiple of 8 or a pointer not 16-byte aligned, the tiles are
// filled by plain 2-byte loads.  Bound on this card: bytes at decode (W is
// 50 MB of bf16 at K = 2048, N = 12288: 15 us at 3.35 TB/s); the fp32 FMAs
// on the CUDA cores cap it at the fp32 kernel's rate (tensor cores are
// later work).

#include <cuda_bf16.h>

namespace {

template <int BM, int BN, int TM, int TN, int BK, int STAGES>
struct TileBf16 {
  static constexpr int kThreads = (BM / TM) * (BN / TN);
  static constexpr int kChunksA = BM * BK / 8;     // 16-byte chunks of x
  static constexpr int kChunksB = BK * BN / 8;
  static constexpr int kPerThread = kChunksA / kThreads;  // of one row
  static_assert(kChunksA % kThreads == 0 && (BK / 8) % kPerThread == 0,
                "a thread's x chunks must lie in one row");
  // Bytes of a ring slot: raw x, raw W, a keep-bit word a thread.
  static constexpr int kRawA = 2 * BM * BK;
  static constexpr int kRawB = 2 * BK * BN;
  static constexpr int kStage = kRawA + kRawB + 4 * kThreads;
  static_assert(kRawA % 16 == 0 && kRawB % 16 == 0, "16-byte regions");
  static constexpr int kLdA = BM + kPad;
  static constexpr int kAt = BK * kLdA;            // floats
  static constexpr size_t kSmem =
      (size_t)STAGES * kStage + (size_t)2 * kAt * sizeof(float);
};

__device__ __forceinline__ float bf(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int BM, int BN, int TM, int TN, int VN, int BK, int STAGES,
          int MIN_BLOCKS>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), MIN_BLOCKS)
mcd_matmul_kernel_bf16(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       const uint32_t* __restrict__ bits,
                       void* __restrict__ out, int M, int N, int K, int KW,
                       float scale, int masked, int vec_a, int vec_b,
                       int out_bf16) {
  using Tl = TileBf16<BM, BN, TM, TN, BK, STAGES>;
  constexpr int NT = Tl::kThreads;
  constexpr int TX = BN / TN;
  constexpr int QM = TM / 4;
  constexpr int QN = TN / VN;
  constexpr int CPT = Tl::kPerThread;
  static_assert(TM % 4 == 0 && TN % VN == 0 && (VN == 4 || VN == 2), "");
  extern __shared__ float4 smem4[];
  unsigned char* const smem = reinterpret_cast<unsigned char*>(smem4);
  float* const at_base =
      reinterpret_cast<float*>(smem + STAGES * Tl::kStage);  // [2][BK][kLdA]

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int KT = (K + BK - 1) / BK;

  auto raw_a = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem + s * Tl::kStage);
  };
  auto raw_b = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(smem + s * Tl::kStage +
                                            Tl::kRawA);
  };
  auto words = [&](int s) {
    return reinterpret_cast<uint32_t*>(smem + s * Tl::kStage + Tl::kRawA +
                                       Tl::kRawB);
  };

  const int ml = tid * CPT / (BK / 8);           // the thread's x row
  const int kq0 = (tid * CPT % (BK / 8)) * 8;
  auto load = [&](int kt, int s) {
    const int k0 = kt * BK;
    __nv_bfloat16* a = raw_a(s);
    const int gm = m0 + ml;
    if (masked)
      mcd::cp_async4(words(s) + tid,
                     gm < M ? bits + (size_t)gm * KW + k0 / 32 : bits,
                     gm < M);
#pragma unroll
    for (int l = 0; l < CPT; ++l) {
      const int kq = kq0 + 8 * l;
      const int gk = k0 + kq;
      __nv_bfloat16* dst = a + ml * BK + kq;
      const __nv_bfloat16* src = x + (size_t)gm * K + gk;
      if (vec_a) {
        const int n = (gm < M && gk < K) ? 2 * min(8, K - gk) : 0;
        mcd::cp_async16(dst, n ? src : x, n);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gm < M && gk + e < K) ? src[e] : __float2bfloat16_rn(0.f);
      }
    }
    __nv_bfloat16* b = raw_b(s);
    for (int c = tid; c < Tl::kChunksB; c += NT) {
      const int kl = c / (BN / 8);
      const int nq = (c % (BN / 8)) * 8;
      const int gk = k0 + kl;
      const int gn = n0 + nq;
      __nv_bfloat16* dst = b + kl * BN + nq;
      const __nv_bfloat16* src = w + (size_t)gk * N + gn;
      if (vec_b) {
        const int n = (gk < K && gn < N) ? 2 * min(8, N - gn) : 0;
        mcd::cp_async16(dst, n ? src : w, n);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = (gk < K && gn + e < N) ? src[e] : __float2bfloat16_rn(0.f);
      }
    }
  };

  // Mask the x elements this thread copied, in bf16, and write them as
  // fp32 into the transposed tile.
  auto transform = [&](int kt, int s, float* at) {
    const __nv_bfloat16* a = raw_a(s);
    const uint32_t word = masked ? words(s)[tid] >> ((kt * BK) & 31) : 0u;
#pragma unroll
    for (int l = 0; l < CPT; ++l) {
      const int kq = kq0 + 8 * l;
      const uint32_t bw = word >> kq;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float v = bf(a[ml * BK + kq + e]);
        if (masked)
          v = ((bw >> e) & 1u) ? bf(__float2bfloat16_rn(__fmul_rn(v, scale)))
                               : 0.0f;
        at[(kq + e) * Tl::kLdA + ml] = v;
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    mcd::cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    mcd::cp_async_wait<STAGES - 2>();
    const int s = kt % STAGES;
    float* at = at_base + (kt & 1) * Tl::kAt;
    transform(kt, s, at);
    __syncthreads();
    if (kt + STAGES - 1 < KT)
      load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    mcd::cp_async_commit();
    const __nv_bfloat16* b = raw_b(s);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int q = 0; q < QM; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            at + k * Tl::kLdA + q * (BM / QM) + ty * 4);
        av[4 * q] = v.x;
        av[4 * q + 1] = v.y;
        av[4 * q + 2] = v.z;
        av[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < QN; ++q) {
        const __nv_bfloat16* src = b + k * BN + q * (BN / QN) + tx * VN;
        if (VN == 4) {
          const uint2 u = *reinterpret_cast<const uint2*>(src);
          const float2 lo = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&u.x));
          const float2 hi = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&u.y));
          bv[4 * q] = lo.x;
          bv[4 * q + 1] = lo.y;
          bv[4 * q + 2] = hi.x;
          bv[4 * q + 3] = hi.y;
        } else {
          const float2 v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(src));
          bv[2 * q] = v.x;
          bv[2 * q + 1] = v.y;
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
  }
  mcd::cp_async_wait<0>();

  float* const of = reinterpret_cast<float*>(out);
  __nv_bfloat16* const ob = reinterpret_cast<__nv_bfloat16*>(out);
#pragma unroll
  for (int q = 0; q < QM; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gm = m0 + q * (BM / QM) + ty * 4 + i;
      if (gm >= M) continue;
#pragma unroll
      for (int qn = 0; qn < QN; ++qn) {
        const int gn = n0 + qn * (BN / QN) + tx * VN;
        const float* r = &acc[4 * q + i][VN * qn];
#pragma unroll
        for (int e = 0; e < VN; ++e) {
          if (gn + e >= N) continue;
          if (out_bf16)
            ob[(size_t)gm * N + gn + e] = __float2bfloat16_rn(r[e]);
          else
            of[(size_t)gm * N + gn + e] = r[e];
        }
      }
    }
}

template <int BM, int BN, int TM, int TN, int VN, int BK, int STAGES,
          int MIN_BLOCKS>
int launch_tile_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                     const uint32_t* bits, void* out, int M, int N, int K,
                     int KW, float scale, int masked, size_t smem,
                     int out_bf16, cudaStream_t stream) {
  using Tl = TileBf16<BM, BN, TM, TN, BK, STAGES>;
  auto kernel =
      mcd_matmul_kernel_bf16<BM, BN, TM, TN, VN, BK, STAGES, MIN_BLOCKS>;
  if (smem < Tl::kSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int vec_a = K % 8 == 0 && ((uintptr_t)x & 15) == 0;
  const int vec_b = N % 8 == 0 && ((uintptr_t)w & 15) == 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, Tl::kThreads, smem, stream>>>(x, w, bits, out, M, N, K, KW,
                                               scale, masked, vec_a, vec_b,
                                               out_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The bf16 launch: as mcd_matmul_launch, on bf16 x and w, the result fp32
// (out_bf16 == 0) or bf16; `scale` is the bf16 scale's value and
// `smem_bytes` the bf16 tile's (matmul_plan with elem_bytes 2).
int mcd_matmul_bf16_launch(const void* x, const void* w, const int32_t* rows,
                           uint32_t* bits, void* out, int M, int N, int K,
                           uint32_t key, uint32_t thr, float scale,
                           int masked, int tile, int smem_bytes,
                           int out_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int KW = (K + 31) / 32;
  if (masked) {
    const long long threads = (long long)M * KW * 32;
    mcd_matmul_kernel_bits<<<(unsigned)((threads + 255) / 256), 256, 0,
                             s>>>(rows, bits, M, K, KW, key, thr);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const auto* xb = reinterpret_cast<const __nv_bfloat16*>(x);
  const auto* wb = reinterpret_cast<const __nv_bfloat16*>(w);
  const size_t smem = (size_t)smem_bytes;
  if (tile == 1)
    return launch_tile_bf16<128, 128, 8, 8, 4, 32, 2, 2>(
        xb, wb, bits, out, M, N, K, KW, scale, masked, smem, out_bf16, s);
  if (tile == 0)
    return launch_tile_bf16<64, 96, 4, 6, 2, 32, 3, 1>(
        xb, wb, bits, out, M, N, K, KW, scale, masked, smem, out_bf16, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
