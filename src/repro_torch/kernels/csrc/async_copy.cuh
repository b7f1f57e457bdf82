// Asynchronous global -> shared copies (cp.async, sm_80+), shared by the
// kernels of this directory.  A copy is issued by one thread, lands in
// shared memory without passing through registers, and is waited for with
// cp_async_wait<N>() (all but the N most recently committed groups done)
// followed by a block barrier.
#pragma once
#include <stdint.h>

namespace repro {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes, bypassing L1 (both addresses 16-byte aligned)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// 4 bytes (both addresses 4-byte aligned)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy `count` contiguous floats from global `src` to shared `dst` (dst
// 16-byte aligned), spread over `nthreads` threads: 16-byte copies when
// `src` is 16-byte aligned, 4-byte copies for the rest.
__device__ __forceinline__ void copy_floats_async(float* dst, const float* src,
                                                  int count, int tid,
                                                  int nthreads) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nvec = count >> 2;
    for (int i = tid; i < nvec; i += nthreads)
      cp_async16(dst + 4 * i, src + 4 * i);
    done = nvec << 2;
  }
  for (int i = done + tid; i < count; i += nthreads)
    cp_async4(dst + i, src + i);
}

}  // namespace repro
