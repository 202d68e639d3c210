// mbarrier and bulk-copy primitives of Hopper (sm_90) as inline PTX, shared
// by the kernels that stream device memory into shared-memory rings
// (fbank.cu, stats_pooling.cu, att_pooling.cu, res2_chain.cu).
// Shared-memory addresses are u32 (smem_u32).
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

// The element-wise asynchronous copies (cp.async): for sources that are not
// 16-byte aligned, which the bulk copy and TMA refuse (a [C, T] bf16 row of
// T = 998 frames starts 1996 bytes after the last). A thread's copies form
// a group at cp_async_commit; cp_async_wait<n> waits until at most n of the
// thread's groups are still in flight, and a __syncthreads after it makes
// every thread's landed copies visible to all.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

// 16 bytes, of which the first src_bytes (0 or 16) are read and the rest
// zero-filled: the ragged edge of a tile reads nothing past its rows
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes, of which the first src_bytes (0 or 4) are read and the rest
// zero-filled
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
