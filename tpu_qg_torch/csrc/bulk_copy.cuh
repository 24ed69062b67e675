// The producer side of the row-streaming kernels (K1 and K12's step_rows
// in step_kernel.cu, K10 and K11's mg_rows in mg_kernels.cu): mbarriers
// that complete on the bytes of the 1-D bulk copies (the TMA engine without
// a tensor map) they were told to expect, and the copies themselves.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// An mbarrier that completes a phase on one arrival and the bytes of the
// copies it was told to expect.
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n\t"
               "fence.mbarrier_init.release.cluster;"
               :: "r"(smem_addr(bar)) : "memory");
}

// Invalidates an mbarrier whose phases are all complete, before its memory
// holds anything else (or another init).
__device__ __forceinline__ void mbar_inval(unsigned long long* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  unsigned long long state;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;"
               : "=l"(state) : "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile("{\n\t.reg .pred done;\n\t"
               "WAIT_%=:\n\t"
               "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
               "@!done bra WAIT_%=;\n\t}"
               :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// Orders this block's earlier shared-memory reads (behind a block or warp
// barrier) before the bulk copies that follow.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A 1-D bulk copy (the TMA engine, no tensor map) of `bytes` (a multiple of
// 16, both ends 16-byte aligned) from device memory to shared memory,
// completing on `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Row `src` of a periodic field, from column y0 - 4 to y0 + w + 4, into
// `dst` in three bulk copies: the 16-byte piece at column `left` = (y0 - 4)
// mod P, the w columns of the strip and the 16-byte piece at `right` =
// (y0 + w) mod P (the only place the y wrap is taken). w is a multiple of
// 4 and every piece 16-byte aligned.
__device__ __forceinline__ void bulk_row(float* dst, const float* src, int y0,
                                         int w, int left, int right,
                                         unsigned long long* bar) {
  bulk_copy(dst, src + left, 16u, bar);
  bulk_copy(dst + 4, src + y0, static_cast<unsigned>(w) * 4u, bar);
  bulk_copy(dst + 4 + w, src + right, 16u, bar);
}

// 16 bytes of a ring row in shared memory.
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

}  // namespace
