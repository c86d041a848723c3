// Asynchronous copies from global to shared memory (cp.async, sm_80 and
// later), shared by mcd_matmul.cu, mcd_gru_seq.cu, mcd_lstm_seq.cu and
// ssd_chunk.cu.  A copy whose
// `valid` is false reads nothing and zero-fills its destination, so a
// ragged edge needs no branch around the copy; `src` must still be a
// mapped address (callers pass the tensor's base).

#pragma once

#include <cuda_runtime.h>

namespace mcd {

// 16 bytes; dst and src 16-byte aligned.  `bytes` (0..16) are read, the
// rest of the 16 zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

// 4 bytes, or a zero when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

// 4 bytes from a 4-byte aligned src, of which `bytes` (0, 2 or 4) are read
// and the rest zero-filled.
__device__ __forceinline__ void cp_async4_bytes(void* dst, const void* src,
                                                int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's groups are in flight; its own
// completed copies are then visible to it (others' need a barrier).
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace mcd
