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
// mcd_matmul.py:40-42), fp32 sums, and the result written as fp32 (the
// SwiGLU gate/up product of the LM, the reference's
// preferred_element_type) or rounded to bf16 (out_bf16, the TPU kernel's
// own x.dtype out).  The fp32 kernel above is left as it was.  Two paths,
// chosen by shape on the host (mcd_matmul.py::matmul_plan, "path"):
//  * the tensor cores (tiles 2 and 3, mcd_matmul_kernel_bf16_tc, below),
//    where K and N are multiples of 8 and x, W and out 16-byte aligned:
//    what TMA can read.  Bounds at qwen3-1.7b's [M, 2048] @ [2048, 12288]:
//    operations at prefill (M = 8192: 0.417 ms at 989 TFLOP/s), bytes at
//    decode (M = 64: W is 50 MB, 16 us at 3.35 TB/s).  The tensor core
//    sums each k16 step in its own order: not the index order of the
//    CUDA-core kernels, the same at every call.
//  * the CUDA cores (tiles 0 and 1, mcd_matmul_kernel_bf16) for any other
//    shape: the fp32 design with 16-bit operands, each output's K-sum in
//    fp32 in index order.  The ring holds raw bf16 tiles (16-byte copies
//    of 8 elements), the x elements are masked and widened to fp32 into
//    the transposed [k][m] tile, and the W tile is widened to fp32 as the
//    inner loop reads it; where K or N is not a multiple of 8 or a pointer
//    not 16-byte aligned, the tiles are filled by plain 2-byte loads.  Its
//    fp32 FMAs cap it at the fp32 kernel's rate.

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (tiles 2 and 3): mcd_matmul_kernel_bf16_tc.
//
// Replaces, for bf16 operands that TMA can read, the same TPU kernel
// (repro/kernels/mcd_matmul.py::mcd_matmul, pallas_call l.64): the product
// on wgmma (m64nNk16, bf16 operands, fp32 accumulators).  Bounds: above.
// Design:
//  * Warp specialised.  The last warp is the producer: one thread keeps a
//    ring of K steps of 64 in flight with TMA, each stage completing on an
//    mbarrier: the x tile [BM][64] and the W tile [64][BN] with the
//    hardware's swizzle, and 4 keep-bit words a row of the tile (the
//    pre-pass above, its rows padded to a multiple of 4 words so that TMA
//    can read them).  The warpgroups before it consume, 64 rows each.
//  * The mask meets the tensor core in shared memory: a consumer
//    warpgroup rewrites its 64 rows of the landed x tile in place, each
//    element bit ? bf16(x * scale) : 0 (one fma.rn.bf16x2 a pair, a single
//    rounding of the exact product: the value of the CUDA-core path and of
//    the plain version), fences the writes to the async proxy, meets at a
//    named barrier and issues wgmma with both operands from shared memory:
//    A K-major, B (the W tile, N contiguous) MN-major with the transpose
//    bit.  The masked x never exists in device memory.  (A from registers,
//    the other form, needs 16 more registers a thread, 32 with a group in
//    flight, beside the 128 accumulators of the prefill tile: ptxas held
//    the block to 168 a thread, serialised the wgmma and spilled, and on
//    an H100 it ran slower at prefill; at decode it was a few percent
//    faster, not worth a second form.)
//  * One wgmma group in flight behind the one being issued: a warpgroup
//    masks step k + 1 while the tensor core runs step k, and hands a stage
//    back to the producer once its group has completed.
//  * The tensor core sums each k16 step in its own order, so the K-sum is
//    not the in-order FMA chain of the CUDA-core kernels; it is the same
//    order at every call (no split of K, no atomics): two calls are
//    bitwise equal.
//  * Two tiles, picked by the host (mcd_matmul.py::TC_TILES):
//    - prefill (tile 2): 128 x 256 outputs, two consumer warpgroups with
//      128 accumulators a thread, a 4-stage ring of 50 KB; the blocks walk
//      the tiles in groups of kGroupM row blocks, so that a wave shares
//      its x and W panels in L2;
//    - decode (tile 3): 64 x 96 outputs, one consumer warpgroup, an
//      8-stage ring of 21 KB: 128 blocks for N = 12288 (one wave on 132
//      SMs), each with ~100 KB of W in flight; every block rereads x
//      (256 KB) from L2.

#include "mcd_tma.cuh"

namespace {

using namespace mcd;

constexpr int kGroupM = 8;              // row blocks of a raster group

// A pair of bf16 x values masked as the plain version: bf16(x * scale)
// where the pair's bit (bit 0 low half, bit 1 high half) is set, else 0.
__device__ __forceinline__ uint32_t mask_pair(uint32_t v, uint32_t bits,
                                              uint32_t scale2) {
  uint32_t prod;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(prod)
      : "r"(v), "r"(scale2), "r"(0x80008000u));
  return prod & (((bits & 1u) ? 0x0000ffffu : 0u) |
                 ((bits & 2u) ? 0xffff0000u : 0u));
}

// D[64, N] = A[64, 16] @ B[16, N] (+ D where `accumulate`), both operands
// from shared memory (A K-major, B MN-major).
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n96(float (&d)[48], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(accumulate));
}



template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t a,
                                      uint64_t b, int accumulate) {
  if constexpr (BN == 256)
    wgmma_n256(d, a, b, accumulate);
  else
    wgmma_n96(d, a, b, accumulate);
}

// The tensor-core tile: WG consumer warpgroups of 64 rows and a producer
// warp, BN columns, K steps of 64 on a ring of STAGES, W staged in swizzle
// atoms of SWB bytes (SWB / 2 columns).  A stage holds x [BM][64] (128-byte
// swizzle), W as BN / (SWB / 2) boxes of [64][SWB / 2] and 4 keep-bit
// words a row, padded to 1 KB; the ring sits on a 1 KB boundary (the
// swizzle's period), the full and empty mbarriers after it.
template <int WG, int BN, int STAGES, int SWB>
struct TileTc {
  static constexpr int kBM = 64 * WG;
  static constexpr int kBK = 64;
  static constexpr int kThreads = 128 * WG + 32;
  static constexpr int kAtom = SWB / 2;
  static constexpr int kX = kBM * kBK * 2;
  static constexpr int kW = kBK * BN * 2;
  static constexpr int kBits = kBM * 16;
  static constexpr int kStage = (kX + kW + kBits + 1023) / 1024 * 1024;
  static constexpr size_t kSmem = 1024 + (size_t)STAGES * kStage + 16 * STAGES;
  static_assert(BN % kAtom == 0 && (BN == 256 || BN == 96), "wgmma width");
};

template <int WG, int BN, int STAGES, int SWB>
__global__ void __launch_bounds__(128 * WG + 32, 1)
mcd_matmul_kernel_bf16_tc(const __grid_constant__ CUtensorMap tm_x,
                          const __grid_constant__ CUtensorMap tm_w,
                          const __grid_constant__ CUtensorMap tm_bits,
                          void* __restrict__ out, int M, int N, int K,
                          float scale, int masked, int out_bf16) {
  using Tl = TileTc<WG, BN, STAGES, SWB>;
  constexpr int BM = Tl::kBM;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);
  const uint32_t bars = base + STAGES * Tl::kStage;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  // This block's tile: groups of kGroupM row blocks, rows fastest.
  const int MB = (M + BM - 1) / BM;
  const int NB = (N + BN - 1) / BN;
  const int per_group = kGroupM * NB;
  const int group = blockIdx.x / per_group;
  const int in_group = blockIdx.x % per_group;
  const int rows_in = min(MB - group * kGroupM, kGroupM);
  const int m0 = (group * kGroupM + in_group % rows_in) * BM;
  const int n0 = (in_group / rows_in) * BN;
  const int KT = (K + Tl::kBK - 1) / Tl::kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * WG);           // a warp of each consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == WG) {
    // Producer: one thread.  The bits box is 4 words (16 bytes, TMA's
    // least) at a 16-byte aligned column: steps 2j and 2j + 1 both load
    // words 4j .. 4j + 3 and read their own two.
    if (threadIdx.x == 128 * WG) {
      const uint32_t tx = Tl::kX + Tl::kW + (masked ? Tl::kBits : 0);
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(empty(s), ((kt / STAGES) & 1) ^ 1);
        const uint32_t st = base + s * Tl::kStage;
        mbar_expect_tx(full(s), tx);
        tma_load(st, &tm_x, full(s), kt * Tl::kBK, m0);
#pragma unroll
        for (int j = 0; j < BN / Tl::kAtom; ++j)
          tma_load(st + Tl::kX + j * Tl::kBK * SWB, &tm_w, full(s),
                   n0 + j * Tl::kAtom, kt * Tl::kBK);
        if (masked)
          tma_load(st + Tl::kX + Tl::kW, &tm_bits, full(s), (kt >> 1) * 4,
                   m0);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows wg * 64 .. + 63 of the tile.
  const int t = threadIdx.x & 127;
  const __nv_bfloat162 sc = __float2bfloat162_rn(scale);
  const uint32_t scale2 = *reinterpret_cast<const uint32_t*>(&sc);
  float acc[BN / 2];   // set by the first wgmma (accumulate 0)

  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(full(s), (kt / STAGES) & 1);
    const uint32_t st = base + s * Tl::kStage;
    unsigned char* const sg = gbase + s * Tl::kStage;
    if (masked) {
      // 4 16-byte chunks a thread; physical chunk pc of row r holds the
      // columns 8 * (pc ^ r % 8) .. + 7 (the 128-byte swizzle).
      const uint32_t* words =
          reinterpret_cast<const uint32_t*>(sg + Tl::kX + Tl::kW) +
          (kt & 1) * 2;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = i * 128 + t;
        const int r = wg * 64 + q / 8;
        const int lc = (q % 8) ^ (r & 7);
        const uint32_t bw = words[r * 4 + lc / 4] >> ((lc % 4) * 8);
        uint4* const v = reinterpret_cast<uint4*>(sg + r * 128 + (q % 8) * 16);
        uint4 u = *v;
        u.x = mask_pair(u.x, bw, scale2);
        u.y = mask_pair(u.y, bw >> 2, scale2);
        u.z = mask_pair(u.z, bw >> 4, scale2);
        u.w = mask_pair(u.w, bw >> 6, scale2);
        *v = u;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    }
    pin(acc);
    wg_fence();
    const uint32_t xa = st + wg * 64 * 128;
    const uint32_t wt = st + Tl::kX;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma<BN>(acc, smem_desc(xa + kk * 32, 16, 8 * 128, 128),
                smem_desc(wt + kk * 16 * SWB, Tl::kBK * SWB, 8 * SWB, SWB),
                kt > 0 || kk > 0);
    wg_commit();
    wg_wait<1>();                        // step kt - 1's group is done
    pin(acc);
    if (kt > 0 && (t & 31) == 0) mbar_arrive(empty((kt - 1) % STAGES));
  }
  wg_wait<0>();
  pin(acc);

  // acc[4j + e]: row g (e < 2) or g + 8 of the warp's 16, column
  // 8j + 2c + (e & 1), for g = lane / 4, c = lane % 4.
  const int rw = wg * 64 + (t >> 5) * 16 + ((t & 31) >> 2);
  const int cw = 2 * (t & 3);
  float* const of = reinterpret_cast<float*>(out);
  __nv_bfloat16* const ob = reinterpret_cast<__nv_bfloat16*>(out);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int gn = n0 + 8 * j + cw;
    if (gn >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + rw + 8 * h;
      if (gm >= M) continue;
      const size_t o = (size_t)gm * N + gn;
      const float lo = acc[4 * j + 2 * h], hi = acc[4 * j + 2 * h + 1];
      if (out_bf16)
        *reinterpret_cast<__nv_bfloat162*>(ob + o) =
            __floats2bfloat162_rn(lo, hi);
      else
        *reinterpret_cast<float2*>(of + o) = make_float2(lo, hi);
    }
  }
}

template <int WG, int BN, int STAGES, int SWB>
int launch_tile_tc(const __nv_bfloat16* x, const __nv_bfloat16* w,
                   const uint32_t* bits, int KWb, void* out, int M, int N,
                   int K, float scale, int masked, size_t smem, int out_bf16,
                   cudaStream_t stream) {
  using Tl = TileTc<WG, BN, STAGES, SWB>;
  auto kernel = mcd_matmul_kernel_bf16_tc<WG, BN, STAGES, SWB>;
  if (smem < Tl::kSmem || encode_tiled() == nullptr || K % 8 != 0 ||
      N % 8 != 0 || (((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) & 15))
    return (int)cudaErrorInvalidValue;
  static std::atomic<int> smem_set[kMaxDevices];   // zero: static
  const cudaError_t err = fit_smem(kernel, (int)smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tx, tw, tb = {};
  if (!tensor_map(&tx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K, M, Tl::kBK,
                  Tl::kBM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&tw, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, N, K, Tl::kAtom,
                  Tl::kBK,
                  SWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                             : CU_TENSOR_MAP_SWIZZLE_64B) ||
      (masked && !tensor_map(&tb, bits, CU_TENSOR_MAP_DATA_TYPE_UINT32, 4,
                             KWb, M, 4, Tl::kBM, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return (int)cudaErrorInvalidValue;
  const long long tiles =
      (long long)((M + Tl::kBM - 1) / Tl::kBM) * ((N + BN - 1) / BN);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)tiles, Tl::kThreads, smem, stream>>>(
      tx, tw, tb, out, M, N, K, scale, masked, out_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The bf16 launch: as mcd_matmul_launch, on bf16 x and w, the result fp32
// (out_bf16 == 0) or bf16; `scale` is the bf16 scale's value and
// `smem_bytes` the tile's (matmul_plan with elem_bytes 2).  Tiles 0 and 1
// run on the CUDA cores, 2 and 3 on the tensor cores; for those the
// keep-bit pass writes rows of ceil(K/32) words rounded up to a multiple
// of 4 (the extra words zero), the row pitch TMA needs.
int mcd_matmul_bf16_launch(const void* x, const void* w, const int32_t* rows,
                           uint32_t* bits, void* out, int M, int N, int K,
                           uint32_t key, uint32_t thr, float scale,
                           int masked, int tile, int smem_bytes,
                           int out_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int KW = (K + 31) / 32;
  const int KWb = tile >= 2 ? (KW + 3) / 4 * 4 : KW;
  if (masked) {
    const long long threads = (long long)M * KWb * 32;
    mcd_matmul_kernel_bits<<<(unsigned)((threads + 255) / 256), 256, 0,
                             s>>>(rows, bits, M, K, KWb, key, thr);
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
  // <WG, BN, STAGES, SWB>: matmul_plan's TC_TILES.
  if (tile == 2)
    return launch_tile_tc<2, 256, 4, 128>(xb, wb, bits, KWb, out, M, N, K,
                                          scale, masked, smem, out_bf16, s);
  if (tile == 3)
    return launch_tile_tc<1, 96, 8, 64>(xb, wb, bits, KWb, out, M, N, K,
                                        scale, masked, smem, out_bf16, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
