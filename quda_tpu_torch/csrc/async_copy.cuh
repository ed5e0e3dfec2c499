// Asynchronous global -> shared copies (cp.async, sm_80 and later), shared
// by the multi-RHS kernels that stage operands in shared memory: the coarse
// stencil's multi-RHS form (B8-mrhs, coarse.cu) and the hops that stage a
// tile's links (mrhs_tile.cuh: B5, B5-eo and S2-mrhs-full).
//
// A thread issues copies, closes them into a group (commit), and waits
// until at most N of its groups are still in flight (wait<N>); the block's
// __syncthreads() after the wait makes every thread's copies visible to
// all.  The 16-byte form needs both addresses 16-byte aligned; the 4-byte
// form serves rows whose starts are not.
#pragma once

#include <cuda_runtime.h>

namespace qtt {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes, cached in L2 only (the staged operand is read from shared
// memory afterwards)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// VEC floats (4 or 1) from src to dst
template <int VEC>
__device__ __forceinline__ void cp_async_vec(float* dst, const float* src) {
  static_assert(VEC == 4 || VEC == 1, "16- or 4-byte copies");
  if constexpr (VEC == 4) {
    cp_async16(dst, src);
  } else {
    cp_async4(dst, src);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace qtt
