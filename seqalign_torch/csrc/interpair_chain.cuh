// The chain of K3 (interpair.cu, int32 cells) and K3-cell16
// (interpair16.cu, int16 cells): what the two kernels share on the card
// (interpair_host.cuh holds what they share on the host).
//
// A CTA fills the DP matrices of neighbouring pairs, one pair a lane (two
// in K3-cell16), and its W warps split the pairs' rows: warp w owns the
// stripes of 16 rows s = w, w + W, w + 2W, ...  A warp sweeps a stripe's
// columns in blocks of SB columns, the stripe's 16 H values (and E) in
// registers, as the one-thread-a-pair kernel did.  Only the stripe's
// bottom row (and its F, affine) crosses to the next stripe:
//
// * from warp w to warp w + 1 through warp w's ring in shared memory,
//   kRingCols columns x 32 lanes of one 32-bit word (column c of the
//   warp's block g at entry (g * SB + c) mod kRingCols, so that blocks g
//   and g + kRingCols / SB share entries whatever their columns), a
//   second ring for F;
// * from warp W - 1 to warp 0 (stripe s = pW - 1 to pW) through the
//   [column][pair] scratch in global memory (L2-resident), which holds a
//   whole row, so that warp W - 1 never waits for warp 0.
//
// Every warp counts the blocks it has finished in progress[w] (shared
// memory), across its stripes: block q of the stripe of pass p is the
// warp's block g = p * nblocks + q.  A warp reads the top row of its
// block g once its source has finished the same block, warp w - 1's g or
// warp W - 1's g - nblocks (the stripe before, in the pass before), and
// it overwrites a ring block only once warp w + 1 has finished the block
// kRingCols / SB earlier that used the same entries of the ring.  After a
// block the lanes' stores are ordered by __syncwarp and lane 0 publishes
// the count with a release store at CTA scope; a waiting warp's lanes read
// it with acquire loads, so the ring's values (and the global scratch's)
// are visible once the count is.  Each wait is on a block that an earlier
// stripe, or the same stripe of an earlier pass, finishes without waiting
// on the waiter: no deadlock for any W, SB and stripe count.  A wait of
// 2^24 sleeps (seconds) means the schedule is broken, and the kernel
// traps (the launch then fails) rather than hang the card.
//
// At the end each warp's lanes hold their pairs' trackers over the warp's
// rows (value, row, column); the CTA merges them through shared memory:
// the largest value, then the smallest row, which keeps local's
// row-major first occurrence (a row lies in one warp, whose tracker keeps
// its first column).  Semi's row m and global's cell (m, n) lie in one
// stripe, so only that warp's tracker holds a value above the start.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "band_stream.cuh"

namespace interpair_chain {

constexpr int kWarp = 32;
constexpr int kRows = 16;      // DP rows of a stripe = rows of a word
constexpr int kRingCols = 32;  // columns a warp's ring holds
constexpr int kMaxSpins = 1 << 24;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGlobal = 0, kLocal = 1, kSemi = 2;  // the mode argument
constexpr int kMaxWarps = 16;  // a CTA's most: 128 registers a thread
// A warp's trace (an all-shapes build's probe reads it): the sleeps
// waiting for the top row, the sleeps waiting for a free ring block, and
// the GPU's nanosecond clock (low 32 bits) at the kernel's start and after
// the warp's last block.
constexpr int kTraceWords = 4;

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.cta.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Waits (every lane) until *count >= need; returns the sleeps.
__device__ __forceinline__ int wait_for(const int* count, int need) {
  int sleeps = 0;
  while (load_acquire(count) < need) {
    if (++sleeps == kMaxSpins) __trap();
    __nanosleep(32);
  }
  __syncwarp();
  return sleeps;
}

// Publishes that the warp has finished `blocks` blocks: its lanes'
// stores before this call are visible to a warp that reads the count.
__device__ __forceinline__ void publish(int* count, int blocks) {
  __syncwarp();
  if ((threadIdx.x & (kWarp - 1)) == 0) store_release(count, blocks);
}

// The warp's schedule over its stripes: the waits before a block and
// the count after it.  The sleeps of lane 0 go to sleeps[0][warp] (for
// the row above) and sleeps[1][warp] (for a ring block), in shared
// memory, for the trace.
template <int kSB>
struct Chain {
  static constexpr int kSlots = kRingCols / kSB;  // blocks a ring holds
  int* progress;  // [W] blocks finished, shared memory
  int* sleeps;    // [2][W], shared memory
  int warp, warps, nblocks;
  int blocks_done = 0;  // g of the block running

  __device__ __forceinline__ void note(int what, int n) {
    if (n != 0 && (threadIdx.x & (kWarp - 1)) == 0) {
      sleeps[what * warps + warp] += n;
    }
  }

  // Before block g of stripe s: wait for the rows it reads, and for the
  // ring block it will overwrite (`to_ring`).
  __device__ __forceinline__ void begin_block(int s, bool to_ring) {
    if (s > 0) {
      const int src = warp == 0 ? warps - 1 : warp - 1;
      const int need =
          (warp == 0 ? blocks_done - nblocks : blocks_done) + 1;
      note(0, wait_for(progress + src, need));
    }
    if (to_ring) {
      note(1, wait_for(progress + warp + 1, blocks_done - kSlots + 1));
    }
  }

  __device__ __forceinline__ void end_block() {
    ++blocks_done;
    publish(progress + warp, blocks_done);
  }
};

// Semi's and global's tracker of one pair over one column: `hm` is the
// column's H in row m (the stripe holds row m).  Semi keeps the first
// largest H of row m over the columns j < n (and, with words, its cell),
// global H[m, n].  K3-cell16 tracks this way only with words.
template <int kMode, bool kDirs = true>
__device__ __forceinline__ void track_row_m(int hm, int j, int n, int m,
                                            int& acc, int& bi, int& bj) {
  if (kMode == kSemi) {
    if (j < n && hm > acc) {
      acc = hm;
      if (kDirs) {
        bi = m;
        bj = j + 1;
      }
    }
  } else if (j == n - 1) {
    acc = hm;
  }
}

// A tracker that beats `cur`: a larger value, or an equal one in an
// earlier row.
__device__ __forceinline__ bool beats(int value, int row, int cur_value,
                                      int cur_row) {
  return value > cur_value || (value == cur_value && row < cur_row);
}

// The CTA's merge of its warps' trackers for `pairs` pairs a warp (32 or
// 64): every thread calls it after its last block with its trackers of
// pairs lane * per .. lane * per + per - 1 (per = pairs / 32) in
// acc/bi/bj[0 .. per); on return warp 0's lanes hold the CTA's.  `buf`
// is shared memory of 3 * W * pairs words that no warp uses any more
// (the rings).
template <int kPer>
__device__ __forceinline__ void merge(int32_t* buf, int warps, int* acc,
                                      int* bi, int* bj) {
  constexpr int kPairs = kWarp * kPer;
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  __syncthreads();
  int32_t* vals = buf;
  int32_t* rows = buf + warps * kPairs;
  int32_t* cols = buf + 2 * warps * kPairs;
#pragma unroll
  for (int x = 0; x < kPer; ++x) {
    const int at = warp * kPairs + lane * kPer + x;
    vals[at] = acc[x];
    rows[at] = bi[x];
    cols[at] = bj[x];
  }
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < warps; ++w) {
#pragma unroll
    for (int x = 0; x < kPer; ++x) {
      const int at = w * kPairs + lane * kPer + x;
      const int v = vals[at];
      const int i = rows[at];
      if (beats(v, i, acc[x], bi[x])) {
        acc[x] = v;
        bi[x] = i;
        bj[x] = cols[at];
      }
    }
  }
}

}  // namespace interpair_chain
