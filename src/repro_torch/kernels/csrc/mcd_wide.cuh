// The wide path of the recurrent kernels, shared by the sequence kernels'
// cluster path (mcd_lstm_seq.cu, mcd_gru_seq.cu) and the step kernels'
// split path (mcd_lstm_step.cu, mcd_gru_step.cu): the layers the warp and
// block paths refuse -- H above 1024 (the block path's one thread a hidden
// unit and 1024 threads a block) and inputs whose rows' mask factors, x and
// h overflow a block's shared memory.
//
// The hidden units are cut into slices of `units` contiguous units, one
// slice a block; the rows into tiles of R rows.  A thread owns one unit of
// its block's slice and kWideRowsThread rows of the tile, and keeps each of
// its (row, unit) gate sums in one register chain, in the plain version's
// order (x terms in index order, then h terms, then the bias; every product
// and sum rounded on its own, mcd_cells.cuh), so the wide path computes the
// bits of the warp and block paths and of the plain version.  The split is
// over output units only, never over a contraction.
//
// The contraction is staged in chunks of kWideChunk indices: the block's
// threads write the masked values of a chunk for the tile's rows into
// shared memory ([R][G][kWideChunk] floats), then each thread runs its
// terms over the chunk, reading its unit's weights through the read-only
// path (dequantizing a code at each read, its scales in registers).  So
// neither I nor H is bounded by shared memory: the x-side mask factors are
// recomputed from the hash at each chunk (mask_factor, the bits of
// fill_mask_factors) and never held whole.  A thread reads each weight
// once a step for its kWideRowsThread rows; the threads of a block that own
// the same unit for other rows read the same address.
//
// What bounds it on this card: operations.  Every gate term is a rounded
// product and a rounded sum (two instructions, no fused multiply-add: the
// bits of the plain version), so a layer's bound is its fp32 operations
// over the CUDA cores' rate -- 0.30 ms at (I, H) = (2048, 2048), 64 rows,
// 8 steps -- far above its bytes once a cluster reads each weight once a
// step.  As built the path runs 40-55x that bound (PERF.md): a block's row
// groups sit in separate warps and each re-reads the block's weight slice
// (a chunk's slice, 256 KB at 128 units, does not stay in L1) from L2, and
// every chunk costs two block barriers.  Right first; faster is later work
// (ROADMAP.md, B2).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "mcd_cells.cuh"
#include "mcd_mask.cuh"

namespace mcd {

constexpr int kWideChunk = 128;     // contraction indices a staged chunk
constexpr int kWideRowsThread = 2;  // rows a thread carries
constexpr int kWideThreads = 1024;  // threads a block at most
constexpr int kClusterMax = 16;     // blocks a cluster (non-portable > 8)

// The factor of one masked element, as fill_mask_factors writes it: the
// scale where the keep bit is set, 0 where it is not, 1 for an unmasked row
// (a student row, a row past B -- passed as -1 -- or masked == 0).
__device__ __forceinline__ float mask_factor(uint32_t key, int32_t row,
                                             int feat, int col, uint32_t thr,
                                             float scale, int masked) {
  if (!masked || row < 0) return 1.0f;
  return keep_bit(key, (uint32_t)row, (uint32_t)feat, (uint32_t)col, thr)
             ? scale
             : 0.0f;
}

// A thread of a wide block: unit ug of the block's slice (unit j of the
// layer; unit_ok when j < H, the last slice being ragged) and the tile's
// rows r0 .. r0 + kWideRowsThread - 1.
struct WideThread {
  int ug, r0, j;
  bool unit_ok;
  __device__ __forceinline__ WideThread(int units, int slice, int H)
      : ug((int)threadIdx.x % units),
        r0((int)threadIdx.x / units * kWideRowsThread),
        j(slice * units + (int)threadIdx.x % units),
        unit_ok(slice * units + (int)threadIdx.x % units < H) {}
};

// The masked values of columns [d0, d0 + n) of the tile's R rows into buf
// [R][G][kWideChunk]: round_to<A>(src[row][d] * factor), the factor of gate
// g drawn with keys.k[k0 + g] over a row of `feat` columns.  Rows past B
// read as 0.  The block's threads share the work; the caller brackets it
// with block barriers.
template <typename A, int G>
__device__ __forceinline__ void stage_masked(
    float* buf, const A* __restrict__ src, size_t row_stride,
    const int32_t* __restrict__ rows, int row0, int R, int B, int feat,
    int d0, int n, const GateKeys& keys, int k0, uint32_t thr, float scale,
    int masked) {
  for (int e = threadIdx.x; e < R * n; e += blockDim.x) {
    const int r = e / n;
    const int dd = e - r * n;
    const int br = row0 + r;
    float v = 0.0f;
    int32_t row = -1;
    if (br < B) {
      v = to_f(src[(size_t)br * row_stride + d0 + dd]);
      row = __ldg(rows + br);
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
      buf[(r * G + g) * kWideChunk + dd] = round_to<A>(__fmul_rn(
          v, mask_factor(keys.k[k0 + g], row, feat, d0 + dd, thr, scale,
                         masked)));
  }
}

// The gate terms of a staged chunk for the thread's rows, continuing each
// chain in index order: acc[q][g] += buf[r0 + q][g][dd] * w(d0 + dd, g).
template <int G, typename Col>
__device__ __forceinline__ void accumulate(float (&acc)[kWideRowsThread][G],
                                           const float* buf, int r0,
                                           const Col& col, int d0, int n) {
#pragma unroll 4
  for (int dd = 0; dd < n; ++dd) {
    float w[G];
    col.row(d0 + dd, w);
#pragma unroll
    for (int q = 0; q < kWideRowsThread; ++q)
#pragma unroll
      for (int g = 0; g < G; ++g)
        acc[q][g] = gate_term_vf(
            acc[q][g], buf[((r0 + q) * G + g) * kWideChunk + dd], w[g]);
  }
}

// The cluster path's h side: the masked h_{t-1} of columns [d0, d0 + n)
// for the tile's R rows, read from the blocks that own them (pub [R][G]
// [units] in each block's shared memory; unit k lives in block k / units)
// into this block's buf [R][G][kWideChunk].
template <int G>
__device__ __forceinline__ void stage_peers(float* buf, float* pub, int R,
                                            int units, int d0, int n) {
  const cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  for (int e = threadIdx.x; e < R * G * n; e += blockDim.x) {
    const int rg = e / n;               // r * G + g
    const int dd = e - rg * n;
    const int k = d0 + dd;
    const float* src = cluster.map_shared_rank(pub, (unsigned)(k / units));
    buf[rg * kWideChunk + dd] = src[rg * units + k % units];
  }
}

// Whether clusters of C blocks of `kernel` at this shape can be resident
// (cudaOccupancyMaxActiveClusters >= 1); the answer is kept per (kernel, C,
// threads, shared memory), so a launch captured in a CUDA graph asks no
// query once an eager launch of the same shape has.
inline cudaError_t cluster_fits(const void* kernel,
                                const cudaLaunchConfig_t& cfg, int C) {
  struct Fit {
    const void* fn;
    int C, threads;
    size_t smem;
    cudaError_t err;
  };
  static Fit seen[64];
  static int n_seen = 0;
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].fn == kernel && seen[i].C == C &&
        seen[i].threads == (int)cfg.blockDim.x &&
        seen[i].smem == cfg.dynamicSmemBytes)
      return seen[i].err;
  int active = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (err == cudaSuccess && active < 1) err = cudaErrorInvalidConfiguration;
  if (n_seen < 64)
    seen[n_seen++] = Fit{kernel, C, (int)cfg.blockDim.x,
                         cfg.dynamicSmemBytes, err};
  return err;
}

// Launch `kernel` as `clusters` clusters of C blocks of `threads` threads
// with `smem` bytes of dynamic shared memory on stream s; returns a CUDA
// error: cudaErrorInvalidConfiguration when such a cluster cannot be
// resident on the card (nothing falls back).
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), int clusters, int C,
                   int threads, size_t smem, cudaStream_t s,
                   Args&&... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (C > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * C), 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cluster_fits((const void*)kernel, cfg, C);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Whether (R, C, units) is a wide plan for H at most kWideThreads threads a
// block: R whole row groups, every unit in a slice and no slice empty.
inline bool wide_plan_ok(int H, int R, int C, int units) {
  if (R < kWideRowsThread || R % kWideRowsThread || C < 1 || units < 1)
    return false;
  if ((long long)units * (R / kWideRowsThread) > kWideThreads) return false;
  return (long long)C * units >= H && (long long)(C - 1) * units < H;
}

}  // namespace mcd
