// mbarrier and bulk-copy primitives of Hopper (sm_90) as inline PTX, shared
// by the kernels that stream device memory into shared-memory rings
// (fbank.cu, stats_pooling.cu). Shared-memory addresses are u32 (smem_u32).
//
// The pattern: a stage's "full" barrier is initialised with count 1; the
// thread that requests a copy arrives on it once and names the bytes to
// come (mbar_arrive_expect_tx), the copy's completion is counted in bytes
// on the same barrier, and readers wait for the phase (mbar_wait) before
// they touch the stage. A stage's "empty" barrier counts one arrive from
// each reading warp; the requesting thread waits on it before it refills.
// Phase parity: use k of a barrier waits with parity k & 1; the first wait
// on an "empty" barrier uses parity 1 and passes at once.

#pragma once

#include <stdint.h>

namespace {


__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// bytes (a multiple of 16) from device to shared memory, both 16-byte
// aligned; completion is counted on the mbarrier
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

}  // namespace
