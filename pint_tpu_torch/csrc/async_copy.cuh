// Asynchronous global -> shared copies (cp.async, sm_80 and later) for the
// hand-written kernels of pint_tpu_torch/csrc. Each thread issues its own
// copies; a copy whose predicate is false reads nothing and fills its
// destination with zeros (the src-size operand is 0), so masked edges
// need no second store. `src` must still be a valid address: callers pass
// the operand's base pointer for a masked copy.
#pragma once

#include <cuda_runtime.h>

namespace pint_async {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes, L2 only (.cg); dst and src 16-byte aligned
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(n) : "memory");
}

// 4 bytes (.ca: the only cache mode below 16 bytes); any float address
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool pred) {
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(n) : "memory");
}

// close the copies this thread issued since the last commit into a group
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's groups are still in flight; a
// __syncthreads() after it makes every thread's landed copies visible
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace pint_async

namespace pint_bulk {

// shared -> global bulk copy by the Tensor Memory Accelerator (sm_90):
// one thread moves `bytes` (a multiple of 16, both addresses 16-byte
// aligned) while the block goes on; completion is tracked per thread in
// bulk groups
__device__ __forceinline__ void store(float* gdst, const float* ssrc,
                                      unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      :: "l"(gdst), "r"(pint_async::smem_addr(ssrc)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until this thread's bulk stores have read their shared source
__device__ __forceinline__ void wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// wait until this thread's bulk stores are complete
__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// order this thread's generic-proxy writes to shared memory before
// later async-proxy reads of it (the bulk store); then a barrier
__device__ __forceinline__ void fence_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace pint_bulk
