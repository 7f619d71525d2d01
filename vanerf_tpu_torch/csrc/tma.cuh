// One-dimensional bulk copies (TMA) into shared memory, completing on
// mbarriers: the helpers kernels A / 7 (mesh_query.cu) and 11 / 12
// (fused_mlp.cu, fused_mlp_bf16.cu) stage their tables with.
#pragma once

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* b,
                                         unsigned count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(b)),
               "r"(count)
               : "memory");
}

// One arrival (of the count the barrier was made with), no bytes.
__device__ __forceinline__ void bar_arrive(unsigned long long* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(b))
               : "memory");
}

__device__ __forceinline__ void bar_expect(unsigned long long* b,
                                           unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(b)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(b))
      : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void bar_wait(unsigned long long* b,
                                         unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(b)),
      "r"(parity)
      : "memory");
}

// bar_wait that gives up: true once the phase has completed, false after
// `tries` polls (each poll may suspend the thread for a while), so that a
// producer and consumers that disagree on the count of copies end the
// kernel with an error instead of hanging the card.
__device__ __forceinline__ bool bar_wait_bounded(unsigned long long* b,
                                                 unsigned parity,
                                                 unsigned tries) {
  for (unsigned i = 0; i < tries; ++i) {
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(b)), "r"(parity)
        : "memory");
    if (done) return true;
  }
  return false;
}
