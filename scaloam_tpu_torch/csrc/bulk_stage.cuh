// Staging of global arrays into shared memory by bulk asynchronous copies
// (cp.async.bulk global -> shared, completing on one mbarrier), the scheme
// of csrc/gn_odometry.cu, for the kernels that stage a block's slice once:
// csrc/hess_matvec.cu and csrc/kabsch_step.cu.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace bulk {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

struct Copy {
  unsigned char* dst;        // shared
  const unsigned char* src;  // global
  uint32_t n;                // bytes
};

template <typename T>
__device__ __forceinline__ Copy copy(T* dst, const T* src, long long count) {
  return {reinterpret_cast<unsigned char*>(dst), reinterpret_cast<const unsigned char*>(src),
          count > 0 ? static_cast<uint32_t>(count * sizeof(T)) : 0u};
}

// Bytes of c that go by bulk copy: both ends 16-aligned, a multiple of 16.
__device__ __forceinline__ uint32_t bulk_bytes(const Copy& c) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(c.dst) | reinterpret_cast<uintptr_t>(c.src)) & 15) == 0;
  return aligned ? (c.n & ~15u) : 0u;
}

// Copies every c.src into c.dst: thread 0 issues one cp.async.bulk per array
// completing on *bar (used once, phase 0); all threads of the block copy the
// tails (and any misaligned array) byte by byte. On return the whole block
// sees every byte. Every thread of the block calls it.
template <int N>
__device__ void stage(const Copy (&cs)[N], uint64_t* bar) {
  const uint32_t bar_s = smem_u32(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_s) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    uint32_t total = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) total += bulk_bytes(cs[i]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar_s), "r"(total)
                 : "memory");
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const uint32_t b = bulk_bytes(cs[i]);
      if (b)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                smem_u32(cs[i].dst)),
            "l"(cs[i].src), "r"(b), "r"(bar_s)
            : "memory");
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    for (uint32_t k = bulk_bytes(cs[i]) + threadIdx.x; k < cs[i].n; k += blockDim.x)
      cs[i].dst[k] = cs[i].src[k];
  __syncthreads();  // the barrier is initialised; the tails are written
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar_s), "r"(0u)
        : "memory");
  }
}

}  // namespace bulk
