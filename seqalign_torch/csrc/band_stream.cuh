// The band streams of K1 (wavefront.cu) and K5 (strip.cu): a kernel that
// runs as a chain of one-warp bands hands each band's last row to the next
// band through a stream of tagged 64-bit words in global memory (the
// value in the low half, its step or column + 1 as the tag in the high
// half).  A 64-bit aligned access is single-copy atomic, so a consumer
// that reads a matching tag has the value: the producer stores with no
// fence, and the consumer waits on the tags alone.  Relaxed accesses at
// GPU scope go to L2, so a consumer never reads a stale L1 line.  Each
// kernel's head note sets out its own protocol; the helpers below are
// what the two share, and each compiles to the one instruction named.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace band_stream {

// Reloads of a stream window before a waiting band gives up (each one a
// load from L2 and a 64 ns sleep: tens of seconds) and traps.
constexpr int kMaxSpins = 1 << 24;

// st.relaxed.gpu of (tag << 32 | value) at p.
__device__ __forceinline__ void store_tagged(unsigned long long* p,
                                             int32_t value, int tag) {
  const unsigned long long word =
      (static_cast<unsigned long long>(static_cast<uint32_t>(tag)) << 32) |
      static_cast<uint32_t>(value);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(word));
}

// ld.relaxed.gpu of the tagged word at p.
__device__ __forceinline__ unsigned long long load_tagged(
    const unsigned long long* p) {
  unsigned long long word;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(word) : "l"(p));
  return word;
}

// The low 32 bits of the GPU's nanosecond clock, for a band's trace.
__device__ __forceinline__ uint32_t clock_ns() {
  uint64_t ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return static_cast<uint32_t>(ns);
}

// The SM this CTA runs on, for the SM log.
__device__ __forceinline__ int sm_id() {
  int id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  return id;
}

}  // namespace band_stream
