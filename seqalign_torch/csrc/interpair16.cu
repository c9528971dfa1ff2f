// K3-cell16: the inter-pair batch fill in int16 cells, linear or affine
// (Gotoh) gaps, two pairs a lane in the halves of 32-bit registers, each
// pair's stripes of 16 rows a chain of warps.
//
// Replaces seqalign_tpu/ops/pallas_fill.py::_interpair_kernel with
// cell16=True (launched by batch_score_pallas and batch_fill_dirs_pallas),
// the int16 cell mode that BatchAligner takes under SEQALIGN_INT16_CELLS.
//
// Semantics: those of csrc/interpair.cu (the int32 K3; its header states
// the recurrence, the boundaries, the direction codes, the run bits and
// the tracking), with every DP value an int16 and the sentinels of the
// JAX kernel's int16 mode: E and F start at NEG_16 = -2^14 in place of
// -2^29, and the best-cell trackers at NEG_16 in place of -2^30.  The
// boundary values are the int32 ones cut to 16 bits, as the JAX kernel's
// astype(int16) does.  Scores, best cells and words stay int32.  Callers
// gate the kernel on int16_cells_ok over the padded widths: inside that
// bound no value wraps, so on real pairs every output equals the int32
// kernel's; a padding pair (n = 0) scores NEG_16 in global and semi mode
// where the int32 kernel gives -2^30 (0 for local, as there).
//
// What bounds it on an H100: as the int32 K3, integer operations and how
// many of them the threads can issue.  Two cells share one 32-bit
// register, so the packed max, add and subtract (__vmaxs2, __vadd2,
// __vsub2) and the Hopper DPX instructions (__viaddmax_s16x2 for
// max(diag + s, gap), its _relu form for local's floor at 0,
// __vibmax_s16x2 for a max with its a >= b predicates, which give the
// DIAG and LEFT/TOP tests and the run bits) do the H, E and F work of two
// pairs in one instruction each.  The substitution lookup (two 16-bit
// shared-memory reads packed with __byte_perm) and the 2-bit direction
// codes stay per pair; local's trackers take a column's packed maximum
// (__vimax3_s16x2) at once, semi's and global's row m's value.
//
// The design: the int32 K3's chain (interpair_chain.cuh): a CTA's W
// warps split the stripes of its pairs, the stripe's bottom row handed
// to the next warp through a ring in shared memory and from the last
// warp to the first through a global scratch.  Lane l of a CTA owns pairs
// 2l and 2l+1 of its 64 (low and high halves), so a warp is 64 pairs and
// bench.py's 8,192 pairs of 512 rows run 128 CTAs of 16 warps where two
// pairs a thread ran 4,096 threads (the batch is even: the wrapper pads
// an odd score-only batch with one padding pair).  A lane reads both pairs' letters of a
// column as one 16-bit load from the [column][pair] int8 layout, keeps a
// stripe's 16 packed H values (and E, affine) in registers across the
// columns, and hands its bottom row (and F) on as one uint32 a column:
// the rings and the [column][pair-pair] scratch hold half the int32
// kernel's bytes a pair.  It writes its two pairs' words of a column as
// one 8-byte store (the two pairs are neighbouring slots of one tile), a
// warp's 64 words 256 contiguous bytes.  The score matrix is a dense
// k x k int16 table, as in the int32 K3.  The score-only variant keeps
// packed trackers: local's takes each column's packed maximum, semi's and
// global's per row and per column half-masks (0xFFFF where the cell is
// tracked) select the cells, semi's with a max, global's alone.  It fills
// the CTA's rows <= max m and columns < max n; the words variant fills every cell, padding
// included, so every word matches the TPU kernel's.  Shapes as in the
// int32 K3 (warps_of, block_of; probes/interpair_shapes.py), every
// variant up to 16 warps, 128 registers a thread (a row's two pattern
// letters share one).
//
// The search layout (sa_interpair16_search), that of csrc/interpair.cu:
// the query shared by every pair, (m_rows,) with ms (1,), and the texts
// in groups of 64 pairs, group g a (width, 64) block at byte groups[g] -
// groups[0]; CTA c takes group c, its lane l pairs 2l and 2l+1, and the
// [column][pair-pair] scratch a group's block at half its texts' offset.
// Its instances are its own (kSearch), as in csrc/interpair.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "interpair_chain.cuh"
#include "interpair_host.cuh"
#include "launch_error.cuh"

namespace {

using namespace interpair_chain;

constexpr int kNeg16 = -(1 << 14);

// v cut to 16 bits in both halves.
__device__ __forceinline__ uint32_t splat(int v) {
  return (static_cast<uint32_t>(v) & 0xFFFFu) * 0x00010001u;
}

__device__ __forceinline__ int lo16(uint32_t x) {
  return static_cast<int16_t>(x & 0xFFFFu);
}

__device__ __forceinline__ int hi16(uint32_t x) {
  return static_cast<int32_t>(x) >> 16;
}

// 0xFFFF in each half whose predicate holds.
__device__ __forceinline__ uint32_t halves(bool lo, bool hi) {
  return (lo ? 0x0000FFFFu : 0u) | (hi ? 0xFFFF0000u : 0u);
}

// 2-bit direction code: DIAG (1) unless the gap move is at least the
// diagonal, then LEFT (0) if it is, else TOP (2); STOP (3) for local.
__device__ __forceinline__ uint32_t dir_code(bool not_diag, bool is_left,
                                             bool stop) {
  return stop ? 3u : (not_diag ? (is_left ? 0u : 2u) : 1u);
}

// Local's trackers over one column of a stripe, both pairs at once: the
// largest H among each pair's tracked cells (its first ok_lo / ok_hi
// rows of the stripe, the column j < n), packed; score-only into the
// packed tracker acc2, with words then each pair's first row holding it,
// as the int32 kernel's track_column.  Local's H is >= 0, so -1 tracks
// nothing.
template <bool kDirs>
__device__ __forceinline__ void track_column16(
    const uint32_t (&h)[kRows], int j, int i0, int n_lo, int n_hi,
    int ok_lo, int ok_hi, bool full_rows, uint32_t& acc2, int (&acc)[2],
    int (&bi)[2], int (&bj)[2]) {
  uint32_t cmax2;
  if (full_rows) {
    cmax2 = h[0];
#pragma unroll
    for (int r = 1; r + 1 < kRows; r += 2) {
      cmax2 = __vimax3_s16x2(cmax2, h[r], h[r + 1]);
    }
    cmax2 = __vmaxs2(cmax2, h[kRows - 1]);
  } else {
    cmax2 = 0xFFFFFFFFu;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      cmax2 = __vmaxs2(cmax2, h[r] | ~halves(r < ok_lo, r < ok_hi));
    }
  }
  cmax2 |= ~halves(j < n_lo && ok_lo > 0, j < n_hi && ok_hi > 0);
  if (!kDirs) {
    acc2 = __vmaxs2(acc2, cmax2);
    return;
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int v = x == 0 ? lo16(cmax2) : hi16(cmax2);
    const int ok = x == 0 ? ok_lo : ok_hi;
    if (v < 0 || v < acc[x]) continue;
    int first = 0;
#pragma unroll
    for (int r = kRows - 1; r >= 0; --r) {
      const int hv = x == 0 ? lo16(h[r]) : hi16(h[r]);
      first = hv == v && r < ok ? r : first;
    }
    const int i = i0 + first + 1;
    if (v > acc[x] || i < bi[x]) {
      acc[x] = v;
      bi[x] = i;
      bj[x] = j + 1;
    }
  }
}

template <int kMode, bool kDirs, bool kAffine, int kSB, bool kSearch>
__global__ void __launch_bounds__(kWarp * kMaxWarps) interpair16_kernel(
    const int8_t* __restrict__ texts,     // (n_cols, b) letters
    const int8_t* __restrict__ patterns,  // (m_rows, b) letters
    const int32_t* __restrict__ ns, const int32_t* __restrict__ ms,
    const int32_t* __restrict__ score_matrix, int k, int gap, int ge,
    int64_t b, int n_cols, int m_rows, int tile_pairs,
    uint32_t* __restrict__ row,   // (n_cols, b/2) scratch
    uint32_t* __restrict__ frow,  // (n_cols, b/2) scratch, affine only
    int32_t* __restrict__ scores, int32_t* __restrict__ best_is,
    int32_t* __restrict__ best_js, int32_t* __restrict__ dirs,
    int32_t* __restrict__ dirs2, int32_t* __restrict__ trace,
    const int64_t* __restrict__ groups) {  // kSearch only
  static_assert(kRingCols % kSB == 0 && (kSB & (kSB - 1)) == 0,
                "a ring holds whole blocks of a power of two");
  static_assert(!(kSearch && kDirs), "the search layout is score-only");
  // The warps' rings, H then F: [plane][warp][kRingCols][lane].
  extern __shared__ uint32_t rings16[];
  __shared__ int16_t sub[32 * 32];
  __shared__ int progress[kMaxWarps];
  __shared__ int sleeps[2 * kMaxWarps];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  for (int x = threadIdx.x; x < 32 * 32; x += blockDim.x) {
    sub[x] = static_cast<int16_t>(x < k * k ? score_matrix[x] : 0);
  }
  if (threadIdx.x < 2 * warps) {
    sleeps[threadIdx.x] = 0;
    if (threadIdx.x < warps) progress[threadIdx.x] = 0;
  }
  __syncthreads();
  const int64_t half_b = b / 2;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kWarp + lane;
  const bool real = t < half_b;
  const int64_t p = 2 * t;  // pair p in the low halves, p + 1 in the high
  // Column j of the two pairs' letters (uint16) and scratch (uint32) lies
  // at base + j * stride.
  const int64_t stride = kSearch ? kWarp : half_b;
  const int64_t base =
      kSearch ? (groups[blockIdx.x] - groups[0]) / 2 + lane : t;
  const int n_lo = real ? min(ns[p], n_cols) : 0;
  const int n_hi = real ? min(ns[p + 1], n_cols) : 0;
  const int m_lo = real ? min(ms[kSearch ? 0 : p], m_rows) : 0;
  const int m_hi = real ? min(ms[kSearch ? 0 : p + 1], m_rows) : 0;
  const int num_w = m_rows / kRows;
  const int stripes =
      kDirs ? num_w
            : (static_cast<int>(__reduce_max_sync(
                   kFull, max(max(m_lo, m_hi), 0))) +
               kRows - 1) / kRows;
  const int cols =
      kDirs ? n_cols
            : static_cast<int>(
                  __reduce_max_sync(kFull, max(max(n_lo, n_hi), 0)));
  const int64_t tile = p / tile_pairs;
  const int64_t slot = p - tile * tile_pairs;
  const uint16_t* __restrict__ texts2 =
      reinterpret_cast<const uint16_t*>(texts);
  const uint16_t* __restrict__ patterns2 =
      reinterpret_cast<const uint16_t*>(patterns);
  const uint32_t gap2 = splat(gap);
  const uint32_t ext2 = splat(ge);
  const uint32_t neg2 = splat(kNeg16);
  Chain<kSB> chain{progress, sleeps, warp, warps, (cols + kSB - 1) / kSB};
  const int ring_plane = warps * kRingCols * kWarp;
  if (trace != nullptr && lane == 0) {
    trace[(blockIdx.x * warps + warp) * kTraceWords + 2] =
        static_cast<int32_t>(band_stream::clock_ns());
  }
  uint32_t acc2 = neg2;  // score-only trackers, packed
  int acc[2] = {kNeg16, kNeg16};  // the words variant's, low and high pair
  int bi[2] = {0, 0};
  int bj[2] = {0, 0};

  for (int s = warp; s < stripes; s += warps) {
    const int i0 = s * kRows;  // the DP row above the stripe
    uint32_t h[kRows];         // H[i0+1+r, j]: the stripe's left column
    uint32_t e[kRows];         // E[i0+1+r, j] (affine)
    uint32_t prow[kRows];      // the table's byte offsets of row i0+1+r's
                               // pattern letters (times k), the two
                               // pairs' in the halves
    uint32_t rmask[kRows];     // semi, global score-only: the rows each
                               // pair tracks
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r + 1;
      if (kAffine) {
        h[r] = kMode == kLocal ? 0u : splat(-gap - ge * (i0 + r));
        e[r] = neg2;
      } else {
        h[r] = kMode == kLocal ? 0u : splat(-gap * i);
      }
      const uint32_t letters =
          real && i0 + r < m_rows
              ? (kSearch ? static_cast<uint8_t>(patterns[i0 + r]) * 0x101u
                         : patterns2[(i0 + r) * stride + base])
              : 0u;
      prow[r] = ((letters & 31) * k | (((letters >> 8) & 31) * k) << 16) *
                sizeof(int16_t);
      if (!kDirs && kMode != kLocal) rmask[r] = halves(i == m_lo, i == m_hi);
    }
    // Local: the stripe's rows each pair tracks (rows <= m); semi and
    // global words: row m's place in the stripe.
    const int ok_lo = min(max(m_lo - i0, 0), kRows);
    const int ok_hi = min(max(m_hi - i0, 0), kRows);
    const int row_m_lo = m_lo - i0 - 1;
    const int row_m_hi = m_hi - i0 - 1;
    const bool full_rows = __all_sync(
        kFull, (ok_lo == 0 || ok_lo == kRows) && (ok_hi == 0 || ok_hi == kRows));
    // H[i0, 0]
    uint32_t diag0;
    if (kMode == kLocal) {
      diag0 = 0u;
    } else if (kAffine) {
      diag0 = i0 == 0 ? 0u : splat(-gap - ge * (i0 - 1));
    } else {
      diag0 = splat(-gap * i0);
    }
    int32_t* words = nullptr;
    int32_t* words2 = nullptr;
    if (kDirs) {
      const int64_t at = (tile * num_w + s) * n_cols * tile_pairs + slot;
      words = dirs + at;
      if (kAffine) words2 = dirs2 + at;
    }
    // The stripe's bottom row goes to the next warp's ring, or from the
    // last warp to the global scratch for the next pass.
    const bool to_next = s + 1 < stripes;
    const bool to_ring = to_next && warp + 1 < warps;
    const bool to_global = to_next && warp + 1 == warps && real;
    const uint32_t* in_h =
        rings16 + max(warp - 1, 0) * kRingCols * kWarp + lane;
    uint32_t* out_h = rings16 + warp * kRingCols * kWarp + lane;
    // The ring entry of column c of the block running: blocks g and
    // g + kRingCols / kSB share entries, whatever their columns.
    auto ring_at = [&](int c) {
      return (chain.blocks_done * kSB + c) & (kRingCols - 1);
    };
    // H[i0, j+1] of the row above: row 0's boundary, the ring of the
    // warp above, or (warp 0) the global scratch.
    auto top_at = [&](int j, int c) -> uint32_t {
      if (s == 0) {
        if (kMode != kGlobal) return 0u;
        return splat(kAffine ? -gap - ge * j : -gap * (j + 1));
      }
      if (warp > 0) return in_h[ring_at(c) * kWarp];
      return real ? row[j * stride + base] : 0u;
    };
    // F[i0, j+1] (affine): row 0 starts no run.
    auto ftop_at = [&](int j, int c) -> uint32_t {
      if (s == 0) return neg2;
      if (warp > 0) return in_h[ring_plane + ring_at(c) * kWarp];
      return real ? frow[j * stride + base] : 0u;
    };
    uint32_t top_next = 0;
    uint32_t ftop_next = 0;
    uint32_t t_next = cols > 0 && real ? texts2[base] : 0u;
    for (int j = 0; j < cols; ++j) {
      const int c = j & (kSB - 1);
      if (c == 0) {
        chain.begin_block(s, to_ring);
        top_next = top_at(j, 0);
        if (kAffine) ftop_next = ftop_at(j, 0);
      }
      const uint32_t top0 = top_next;
      const uint32_t ftop0 = ftop_next;
      // The two pairs' text letters' byte offsets, in the halves.
      const uint32_t t2 =
          ((t_next & 31) | ((t_next >> 8) & 31) << 16) * sizeof(int16_t);
      if (j + 1 < cols) {
        if (real) t_next = texts2[(j + 1) * stride + base];
        if (c + 1 < kSB) {
          top_next = top_at(j + 1, c + 1);
          if (kAffine) ftop_next = ftop_at(j + 1, c + 1);
        }
      }
      // Semi, global score-only: the columns each pair tracks.
      uint32_t cmask = 0;
      if (!kDirs && kMode != kLocal) {
        cmask = kMode == kGlobal ? halves(j == n_lo - 1, j == n_hi - 1)
                                 : halves(j < n_lo, j < n_hi);
      }
      uint32_t up = top0;   // H[i-1, j+1], new this column
      uint32_t f = ftop0;   // F[i-1, j+1] (affine)
      uint32_t dg = diag0;  // H[i-1, j], from the last column
      uint32_t word_lo = 0, word_hi = 0, word2_lo = 0, word2_hi = 0;
      uint32_t hm_lo = 0, hm_hi = 0;  // semi, global words: H in row m
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const uint32_t left = h[r];
        const uint32_t at2 = prow[r] + t2;  // both table byte offsets
        const char* table = reinterpret_cast<const char*>(sub);
        const uint32_t s2 = __byte_perm(
            *reinterpret_cast<const uint16_t*>(table + (at2 & 0xFFFF)),
            *reinterpret_cast<const uint16_t*>(table + (at2 >> 16)),
            0x5410);
        uint32_t cur;
        if constexpr (!kDirs) {
          uint32_t gap_best;
          if constexpr (kAffine) {
            // E = max(E - ge, left - g), F = max(F - ge, up - g).
            e[r] = __vmaxs2(__vsub2(e[r], ext2), __vsub2(left, gap2));
            f = __vmaxs2(__vsub2(f, ext2), __vsub2(up, gap2));
            gap_best = __vmaxs2(e[r], f);
          } else {
            gap_best = __vsub2(__vmaxs2(up, left), gap2);
          }
          // max(diag + s, gap_best), floored at 0 for local.
          cur = kMode == kLocal ? __viaddmax_s16x2_relu(dg, s2, gap_best)
                                : __viaddmax_s16x2(dg, s2, gap_best);
          if (kMode == kSemi) {
            const uint32_t ok = rmask[r] & cmask;
            acc2 = __vmaxs2(acc2, (cur & ok) | (neg2 & ~ok));
          } else if (kMode == kGlobal) {
            const uint32_t ok = rmask[r] & cmask;
            acc2 = (cur & ok) | (acc2 & ~ok);
          }
        } else {
          const uint32_t diag = __vadd2(dg, s2);
          uint32_t gap_best;
          bool left_hi, left_lo;  // the gap move is LEFT (E >= F)
          if constexpr (kAffine) {
            const uint32_t e_ext = __vsub2(e[r], ext2);
            const uint32_t f_ext = __vsub2(f, ext2);
            bool eo_hi, eo_lo, fo_hi, fo_lo;  // opening >= extending
            e[r] = __vibmax_s16x2(__vsub2(left, gap2), e_ext, &eo_hi,
                                  &eo_lo);
            f = __vibmax_s16x2(__vsub2(up, gap2), f_ext, &fo_hi, &fo_lo);
            gap_best = __vibmax_s16x2(e[r], f, &left_hi, &left_lo);
            // Run bits: the run goes on where extending beats opening.
            word2_lo |= (static_cast<uint32_t>(!eo_lo) |
                         (static_cast<uint32_t>(!fo_lo) << 1))
                        << (2 * r);
            word2_hi |= (static_cast<uint32_t>(!eo_hi) |
                         (static_cast<uint32_t>(!fo_hi) << 1))
                        << (2 * r);
          } else {
            gap_best =
                __vsub2(__vibmax_s16x2(left, up, &left_hi, &left_lo), gap2);
          }
          bool nd_hi, nd_lo;  // not DIAG: gap_best >= diag
          const uint32_t best =
              __vibmax_s16x2(gap_best, diag, &nd_hi, &nd_lo);
          cur = kMode == kLocal ? __vimax_s16x2_relu(best, 0u) : best;
          const bool local = kMode == kLocal;
          word_lo |= dir_code(nd_lo, left_lo, local && lo16(best) <= 0)
                     << (2 * r);
          word_hi |= dir_code(nd_hi, left_hi, local && hi16(best) <= 0)
                     << (2 * r);
          if (kMode != kLocal) {
            hm_lo = r == row_m_lo ? cur : hm_lo;
            hm_hi = r == row_m_hi ? cur : hm_hi;
          }
        }
        h[r] = cur;
        dg = left;
        up = cur;
      }
      diag0 = top0;
      if (kMode == kLocal) {
        track_column16<kDirs>(h, j, i0, n_lo, n_hi, ok_lo, ok_hi, full_rows,
                              acc2, acc, bi, bj);
      } else if (kDirs) {
        if (row_m_lo >= 0 && row_m_lo < kRows) {
          track_row_m<kMode>(lo16(hm_lo), j, n_lo, m_lo, acc[0], bi[0],
                             bj[0]);
        }
        if (row_m_hi >= 0 && row_m_hi < kRows) {
          track_row_m<kMode>(hi16(hm_hi), j, n_hi, m_hi, acc[1], bi[1],
                             bj[1]);
        }
      }
      // H[i0+16, j+1] (and F) for the next stripe.
      if (to_ring) {
        out_h[ring_at(c) * kWarp] = up;
        if (kAffine) out_h[ring_plane + ring_at(c) * kWarp] = f;
      } else if (to_global) {
        row[j * stride + base] = up;
        if (kAffine) frow[j * stride + base] = f;
      }
      if (kDirs) {
        const int64_t at = static_cast<int64_t>(j) * tile_pairs;
        *reinterpret_cast<uint2*>(words + at) = make_uint2(word_lo, word_hi);
        if (kAffine) {
          *reinterpret_cast<uint2*>(words2 + at) =
              make_uint2(word2_lo, word2_hi);
        }
      }
      if (c == kSB - 1 || j + 1 == cols) chain.end_block();
    }
  }
  if (trace != nullptr && lane == 0) {
    int32_t* mine = trace + (blockIdx.x * warps + warp) * kTraceWords;
    mine[0] = sleeps[warp];
    mine[1] = sleeps[warps + warp];
    mine[3] = static_cast<int32_t>(band_stream::clock_ns());
  }
  if (!kDirs) {
    acc[0] = lo16(acc2);
    acc[1] = hi16(acc2);
  }
  merge<2>(reinterpret_cast<int32_t*>(rings16), warps, acc, bi, bj);
  if (warp == 0 && real) {
    scores[p] = kMode == kLocal ? max(acc[0], 0) : acc[0];
    scores[p + 1] = kMode == kLocal ? max(acc[1], 0) : acc[1];
    if (kDirs) {
      best_is[p] = bi[0];
      best_js[p] = bj[0];
      best_is[p + 1] = bi[1];
      best_js[p + 1] = bj[1];
    }
  }
}

// K3-cell16's traits (interpair_host.cuh): two pairs a lane, packed scratch.
struct Cells16 {
  using Word = uint32_t;
  static constexpr int kPerLane = 2;
  template <int kMode, bool kDirs, bool kAffine, int kSB, bool kSearch>
  static auto kernel() {
    return interpair16_kernel<kMode, kDirs, kAffine, kSB, kSearch>;
  }
  // The shape in code per variant, as the int32 K3's (warps_of, block_of;
  // probes/interpair_shapes.py --time, NVIDIA H100 80GB HBM3, 700 W):
  // score-only, linear at most 16 warps x 8 columns, 0.872 ms (8 x 8:
  // 1.216), affine 16 x 4, 1.121; with words, linear 8 x 4, 1.200 (16 x 2:
  // 1.223), affine 16 x 2, 1.981 (8 x 4: 1.978).
  static constexpr int warps_of(bool dirs, bool affine) {
    return dirs && !affine ? 8 : kMaxWarps;
  }
  static constexpr int block_of(bool dirs, bool affine) {
    if (dirs) return affine ? 2 : 4;
    return affine ? 4 : 8;
  }
};

}  // namespace

// Fills a batch of b pairs in int16 cells; the arguments are those of
// sa_interpair_fill (csrc/interpair.cu), except that b must be even and
// row and frow are (n_cols, b/2) uint32 scratch (two int16 cells each).
// With dirs, tile_pairs must be even too.  Returns the launch's
// cudaError_t.
extern "C" int sa_interpair16_fill(
    const int8_t* texts, const int8_t* patterns, const int32_t* ns,
    const int32_t* ms, const int32_t* score_matrix, int k, int gap,
    int gap_extend, int affine, int64_t b, int n_cols, int m_rows,
    int tile_pairs, int mode, int with_dirs, int32_t* row, int32_t* frow,
    int32_t* scores, int32_t* best_is, int32_t* best_js, int32_t* dirs,
    int32_t* dirs2, void* stream) {
  return interpair_host::fill<Cells16, true>(
      texts, patterns, ns, ms, score_matrix, k, gap, gap_extend, affine, b,
      n_cols, m_rows, tile_pairs, mode, with_dirs, row, frow, scores,
      best_is, best_js, dirs, dirs2, 0, 0, nullptr, nullptr, stream);
}

// Scores of b pairs in int16 cells in the search layout; the arguments
// are those of sa_interpair_search (csrc/interpair.cu), with row and frow
// uint32 scratch of half the texts' extent.  Returns the launch's
// cudaError_t.
extern "C" int sa_interpair16_search(
    const int8_t* texts, const int64_t* groups, const int8_t* patterns,
    const int32_t* ns, const int32_t* ms, const int32_t* score_matrix, int k,
    int gap, int gap_extend, int affine, int64_t b, int n_cols, int m_rows,
    int mode, int32_t* row, int32_t* frow, int32_t* scores, void* stream) {
  return interpair_host::search<Cells16>(
      texts, groups, patterns, ns, ms, score_matrix, k, gap, gap_extend,
      affine, b, n_cols, m_rows, mode, row, frow, scores, stream);
}

// The shape sa_interpair16_fill takes; out as sa_interpair_shape's.
extern "C" void sa_interpair16_shape(int with_dirs, int affine, int m_rows,
                                     int64_t b, int* out) {
  interpair_host::shape<Cells16>(with_dirs, affine, m_rows, b, out);
}

#ifdef SA_INTERPAIR_ALL_SHAPES
// sa_interpair16_fill at `warps` warps a CTA and `sb` columns a block (2,
// 4, 8 or 16); `trace` as sa_interpair_fill_shape's.
extern "C" int sa_interpair16_fill_shape(
    const int8_t* texts, const int8_t* patterns, const int32_t* ns,
    const int32_t* ms, const int32_t* score_matrix, int k, int gap,
    int gap_extend, int affine, int64_t b, int n_cols, int m_rows,
    int tile_pairs, int mode, int with_dirs, int32_t* row, int32_t* frow,
    int32_t* scores, int32_t* best_is, int32_t* best_js, int32_t* dirs,
    int32_t* dirs2, int warps, int sb, int32_t* trace, void* stream) {
  return interpair_host::fill<Cells16>(
      texts, patterns, ns, ms, score_matrix, k, gap, gap_extend, affine, b,
      n_cols, m_rows, tile_pairs, mode, with_dirs, row, frow, scores,
      best_is, best_js, dirs, dirs2, warps, sb, trace, nullptr, stream);
}
#endif
