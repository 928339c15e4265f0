// The tile ring's parts, shared by the port's CUDA sources (glm_fused.cu,
// sparse_glm.cu): mbarriers in shared memory and 1-D TMA bulk copies
// (cp.async.bulk, no tensor map) of a 16-byte-aligned span of global
// memory into shared memory, completing on an mbarrier. sm_90 or later.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace glm {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Returns once the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// The 16-byte-aligned span of global memory around base[lo, hi) (elements of
// es bytes), and how many elements into it base[lo] sits.
struct Cover {
  unsigned long long src;
  uint32_t bytes;
};

__device__ __forceinline__ Cover cover(const void* base, int es, long long lo, long long hi) {
  const unsigned long long a = reinterpret_cast<unsigned long long>(base) + lo * es;
  const unsigned long long b = reinterpret_cast<unsigned long long>(base) + hi * es;
  const unsigned long long a16 = a & ~15ull;
  return {a16, hi > lo ? static_cast<uint32_t>(((b + 15ull) & ~15ull) - a16) : 0u};
}

__device__ __forceinline__ int cover_skip(const void* base, int es, long long lo) {
  return static_cast<int>(((reinterpret_cast<unsigned long long>(base) + lo * es) & 15ull) / es);
}

__device__ __forceinline__ void bulk_copy(unsigned char* dst, const Cover& c, uint64_t* bar) {
  if (c.bytes == 0) return;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(c.src), "r"(c.bytes), "r"(smem_addr(bar))
      : "memory");
}

// Orders a stage's earlier generic-proxy reads (released to the producer
// through its empty barrier) before the async-proxy writes of its refill.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Makes the mbarrier initializations visible to the async proxy.
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

}  // namespace glm
