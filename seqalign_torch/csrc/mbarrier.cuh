// The shared-memory barriers of the window walks: K2 (csrc/walk.cu) and
// K4's single-pair walk (csrc/batch_walk.cu).  A walker thread posts a
// request for a window on one mbarrier and loader warps report the load
// on another; these are the PTX operations both use, and the GPU's
// nanosecond clock their traces read.

#pragma once

#include <stdint.h>

namespace sa_mbar {

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* bar, int n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem(bar)), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(unsigned long long* bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}"
      :: "r"(smem(bar)) : "memory");
}

// Whether the phase of parity `parity` has completed (no waiting).
__device__ __forceinline__ bool bar_test(unsigned long long* bar,
                                         uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(ok) : "r"(smem(bar)), "r"(parity) : "memory");
  return ok != 0;
}

// Waits for the phase of parity `parity`.  A window's load takes
// microseconds and a request comes within a window's walk; a wait of 2^28
// tries (seconds) means the schedule is broken, and the kernel traps
// (the launch then fails) rather than hang the card.
__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         uint32_t parity) {
  uint32_t ok;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(ok) : "r"(smem(bar)), "r"(parity) : "memory");
    if (ok) return;
    if (tries == (1u << 28)) __trap();
  }
}

__device__ __forceinline__ long long clock_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

}  // namespace sa_mbar
