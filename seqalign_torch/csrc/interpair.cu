// K3: inter-pair batch fill, linear or affine (Gotoh) gaps, 32 pairs a
// CTA, one a lane, each pair's stripes of 16 rows a chain of warps.
//
// Replaces seqalign_tpu/ops/pallas_fill.py::_interpair_kernel (launched
// by batch_score_pallas and batch_fill_dirs_pallas) for int32 cells, in
// its linear and affine modes.
//
// Semantics (identical to the TPU kernel): pair p fills its own
// (m_rows+1) x (n_cols+1) DP matrix.  Row 0 is -gap*j (global) or 0
// (local, semi); column 0 is -gap*i (global, semi) or 0 (local).  A cell
// is H = max(diag + s, max(top, left) - gap), floored at 0 for local.
// Its direction is DIAG (1) if diag > max(top, left) - gap, else LEFT (0)
// if left >= top, else TOP (2); local writes STOP (3) where
// max(diag, max(top, left) - gap) <= 0.  Word (t, w, j, slot) holds rows
// 16w+1..16w+16 at column j+1 of pair t*tile_pairs + slot, row 16w+1+r at
// bits 2r.  Tracking: local takes the best cell with j < n and i <= m,
// the first in row-major order; semi the first best cell of row m with
// j < n; global the cell (m, n).  The score is local's best floored at 0,
// semi's best, or global's H[m, n]; a pair with no tracked cell (n = 0
// padding) scores -2^30, or 0 for local, as on the TPU.
//
// Affine (gap = open g, ge = extend): row 0 is -g - ge*(j-1) for j >= 1
// (global) or 0; column 0 is -g - ge*(i-1) for i >= 1 (global, semi) or
// 0, H[0, 0] = 0.  E (left runs) starts at -2^29 in column 0 and F (top
// runs) in row 0; E = max(E - ge, left - g), F = max(F - ge, top - g),
// H = max(diag + s, max(E, F)), floored at 0 for local.  The direction
// is DIAG if diag > max(E, F), else LEFT if E >= F, else TOP (STOP for
// local where max(diag, max(E, F)) <= 0).  The run-bit plane dirs2 has
// the words' layout: bit 2r is E - ge > left - g (the left run goes on),
// bit 2r+1 is F - ge > top - g.  Tracking and scores as linear.
//
// What bounds it on an H100: the fill is integer work, about 10 int32
// operations a cell (4 for H, 6 for the direction word) plus the
// best-cell tracking, 16 for affine (10 for H with E and F, 6 for the
// direction) and 4 more for the run bits; a batch of 512 x 512 pairs
// writes 2 bits a cell (4 affine), far less than the card moves in the
// time the operations take.  So it is bound by operations: by the
// integer pipe, which issues two warp instructions a clock an SM, once
// enough chains are in flight (every cell of a stripe column waits on
// the cell above it).
//
// The design (interpair_chain.cuh sets out the chain): a CTA takes 32
// neighbouring pairs, one a lane, and W warps; warp w fills the stripes
// w, w + W, ... of all 32 pairs, so bench.py's 8,192 pairs of 512 rows
// run 256 CTAs of 16 warps where one thread a pair ran 256 threads.  A
// lane keeps its stripe's 16 H values (and E) and pattern rows in
// registers for a whole sweep across the columns; the stripe's bottom
// row (and F) goes to the next warp through a ring in shared memory, or
// from the last warp to the first through the global scratch
// row[j][pair] (frow), read back one pass later.  Every letter, scratch
// and word access is indexed [column][pair], so a warp touches 32
// neighbouring addresses: a column's 32 words are one 128-byte store.
// The next column's letter and (inside a block) its top value are loaded
// before the current column is computed.  A cell takes few integer
// instructions: H is one DPX add-max (__viaddmax_s32, its _relu form for
// local; score-only, the chain from the cell above is that one op),
// __vibmax_s32 gives a max with its >= test (LEFT, the run bits), and
// the trackers run a column at a time (track_column, track_row_m).  The
// score matrix sits in shared memory as a dense k x k table (sub[a * k +
// c]; zeros past k * k, letters masked to 5 bits, so no read leaves the
// 32 x 32 array): a lane's read goes to bank (a * k + c) mod 32, so a DNA
// warp's 16 distinct entries never share a bank, where a 32-wide table
// put every lane with text letter c in bank c.  The score-only variant
// fills only the cells its outputs depend on, the CTA's rows <= max m
// and columns < max n (the trackers skip the rest); the dirs variant
// fills every cell, padding included, so every word matches the TPU
// kernel's.  The affine mode is a template parameter, so the linear
// instances keep their loop unchanged.
//
// Shapes: W warps a CTA and SB columns a block are chosen per variant
// (warps_of, block_of below) by the least time at the main path's shapes
// (probes/interpair_shapes.py --time); W shrinks to the stripes, evened
// over the passes, and a grid of fewer CTAs than SMs takes 16.  Registers: a CTA runs up to 16
// warps, so a thread may hold 128 registers: a stripe's h, e and pattern
// rows (two rows a register; at 32 warps' 64 registers ptxas spilled
// the linear score-only variant); ptxas spills nothing (chip_smoke.py
// checks every instance).  Only the
// probe's build, with SA_INTERPAIR_ALL_SHAPES, takes any W up to 16 and
// SB of 2, 4, 8, 16 as arguments, and a trace buffer
// (interpair_chain.cuh's kTraceWords a warp).
//
// The search layout (sa_interpair_search; parallel/search.py's database,
// score-only): one pattern, the query, shared by every pair and read as
// (m_rows,) letters with ms (1,); the texts lie in groups of 64 pairs,
// group g a (width, 64) [column][pair] block at byte groups[g] -
// groups[0], CTA c taking pairs (c % 2) * 32 .. + 31 of group c / 2.
// The row and frow scratch have the texts' layout in int32 (a group's
// block at the same offsets), so a CTA's reads and its scratch stay on
// 32 neighbouring addresses a column.  ns and scores stay (b,), pair
// 64g + l being column l of group g.
// It has score-only instances of its own (kSearch), so the batch's
// instances keep their indexing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "interpair_chain.cuh"
#include "interpair_host.cuh"
#include "launch_error.cuh"

namespace {

using namespace interpair_chain;

constexpr int kNegInf = -(1 << 30);
constexpr int kNegHalf = -(1 << 29);  // E and F before any run (NEG_INF // 2)

// Local's tracker over one column of a stripe: the largest H among the
// lane's tracked cells (its first rows_ok rows of the stripe, the column
// j < n), then, with words, that value's first row: a larger value, or
// an equal one in an earlier row, wins, which is what the cell-by-cell
// rule gives in the column's order.  full_rows: every lane tracks all of
// the stripe's rows or none (warp-uniform), so the maximum needs no row
// mask.  Local's H is >= 0, so -1 tracks nothing.
template <bool kDirs>
__device__ __forceinline__ void track_column(const int (&h)[kRows], int j,
                                             int i0, int n, int rows_ok,
                                             bool full_rows, int& acc,
                                             int& bi, int& bj) {
  int cmax;
  if (full_rows) {
    cmax = h[0];
#pragma unroll
    for (int r = 1; r + 1 < kRows; r += 2) {
      cmax = __vimax3_s32(cmax, h[r], h[r + 1]);
    }
    cmax = max(cmax, h[kRows - 1]);
  } else {
    cmax = -1;
#pragma unroll
    for (int r = 0; r < kRows; ++r) cmax = r < rows_ok ? max(cmax, h[r]) : cmax;
  }
  if (j >= n || rows_ok == 0) cmax = -1;
  if (!kDirs) {
    acc = max(acc, cmax);
    return;
  }
  if (cmax < 0 || cmax < acc) return;
  int first = 0;
#pragma unroll
  for (int r = kRows - 1; r >= 0; --r) {
    first = h[r] == cmax && r < rows_ok ? r : first;
  }
  const int i = i0 + first + 1;
  if (cmax > acc || i < bi) {
    acc = cmax;
    bi = i;
    bj = j + 1;
  }
}

template <int kMode, bool kDirs, bool kAffine, int kSB, bool kSearch>
__global__ void __launch_bounds__(kWarp * kMaxWarps)
    interpair_kernel(
        const int8_t* __restrict__ texts,     // (n_cols, b) letters
        const int8_t* __restrict__ patterns,  // (m_rows, b) letters
        const int32_t* __restrict__ ns, const int32_t* __restrict__ ms,
        const int32_t* __restrict__ score_matrix, int k, int gap, int ge,
        int64_t b, int n_cols, int m_rows, int tile_pairs,
        int32_t* __restrict__ row,   // (n_cols, b) scratch
        int32_t* __restrict__ frow,  // (n_cols, b) scratch, affine only
        int32_t* __restrict__ scores, int32_t* __restrict__ best_is,
        int32_t* __restrict__ best_js, int32_t* __restrict__ dirs,
        int32_t* __restrict__ dirs2, int32_t* __restrict__ trace,
        const int64_t* __restrict__ groups) {  // kSearch only
  static_assert(kRingCols % kSB == 0 && (kSB & (kSB - 1)) == 0,
                "a ring holds whole blocks of a power of two");
  static_assert(!(kSearch && kDirs), "the search layout is score-only");
  // The warps' rings, H then F: [plane][warp][kRingCols][lane].
  extern __shared__ int32_t rings[];
  __shared__ int32_t sub[32 * 32];
  __shared__ int progress[kMaxWarps];
  __shared__ int sleeps[2 * kMaxWarps];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  for (int x = threadIdx.x; x < 32 * 32; x += blockDim.x) {
    sub[x] = x < k * k ? score_matrix[x] : 0;
  }
  if (threadIdx.x < 2 * warps) {
    sleeps[threadIdx.x] = 0;
    if (threadIdx.x < warps) progress[threadIdx.x] = 0;
  }
  __syncthreads();
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kWarp + lane;
  const bool real = p < b;
  // Column j of the pair's letters and scratch lies at base + j * stride.
  const int64_t stride = kSearch ? 2 * kWarp : b;
  const int64_t base = kSearch ? groups[blockIdx.x / 2] - groups[0] +
                                     (blockIdx.x % 2) * kWarp + lane
                               : p;
  const int n = real ? min(ns[p], n_cols) : 0;
  const int m = real ? min(ms[kSearch ? 0 : p], m_rows) : 0;
  const int num_w = m_rows / kRows;
  const int stripes =
      kDirs ? num_w
            : (static_cast<int>(__reduce_max_sync(kFull, max(m, 0))) +
               kRows - 1) / kRows;
  const int cols =
      kDirs ? n_cols : static_cast<int>(__reduce_max_sync(kFull, max(n, 0)));
  const int64_t tile = p / tile_pairs;
  const int64_t slot = p - tile * tile_pairs;
  Chain<kSB> chain{progress, sleeps, warp, warps, (cols + kSB - 1) / kSB};
  const int ring_plane = warps * kRingCols * kWarp;
  if (trace != nullptr && lane == 0) {
    trace[(blockIdx.x * warps + warp) * kTraceWords + 2] =
        static_cast<int32_t>(band_stream::clock_ns());
  }
  int acc = kNegInf;
  int bi = 0;
  int bj = 0;

  for (int s = warp; s < stripes; s += warps) {
    const int i0 = s * kRows;  // the DP row above the stripe
    int h[kRows];              // H[i0+1+r, j]: the stripe's left column
    int e[kRows];              // E[i0+1+r, j] (affine)
    // The table's byte offset of row i0+1+r's pattern letter (times k):
    // rows 2q and 2q+1 in the halves of prow[q] (8 registers where 16
    // held one each let an SM run more warps).
    uint32_t prow[kRows / 2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (kAffine) {
        h[r] = kMode == kLocal ? 0 : -gap - ge * (i0 + r);
        e[r] = kNegHalf;
      } else {
        h[r] = kMode == kLocal ? 0 : -gap * (i0 + r + 1);
      }
      const int8_t letter =
          real && i0 + r < m_rows
              ? patterns[kSearch ? i0 + r : (i0 + r) * stride + base]
              : int8_t{0};
      const uint32_t at =
          (static_cast<uint8_t>(letter) & 31) * k * sizeof(int32_t);
      if (r % 2 == 0) {
        prow[r / 2] = at;
      } else {
        prow[r / 2] |= at << 16;
      }
    }
    // H[i0, 0]
    int diag0;
    if (kMode == kLocal) {
      diag0 = 0;
    } else if (kAffine) {
      diag0 = i0 == 0 ? 0 : -gap - ge * (i0 - 1);
    } else {
      diag0 = -gap * i0;
    }
    // Local: the stripe's rows the lane tracks (rows <= m); semi and
    // global: row m's place in the stripe.
    const int rows_ok = min(max(m - i0, 0), kRows);
    const int row_m = m - i0 - 1;
    const bool full_rows =
        __all_sync(kFull, rows_ok == 0 || rows_ok == kRows);
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
    const int32_t* in_h =
        rings + max(warp - 1, 0) * kRingCols * kWarp + lane;
    int32_t* out_h = rings + warp * kRingCols * kWarp + lane;
    // The ring entry of column c of the block running: blocks g and
    // g + kRingCols / kSB share entries, whatever their columns.
    auto ring_at = [&](int c) {
      return (chain.blocks_done * kSB + c) & (kRingCols - 1);
    };
    // H[i0, j+1] of the row above: row 0's boundary, the ring of the
    // warp above, or (warp 0) the global scratch.
    auto top_at = [&](int j, int c) {
      if (s == 0) {
        if (kMode != kGlobal) return 0;
        return kAffine ? -gap - ge * j : -gap * (j + 1);
      }
      if (warp > 0) return in_h[ring_at(c) * kWarp];
      return real ? row[j * stride + base] : 0;
    };
    // F[i0, j+1] (affine): row 0 starts no run.
    auto ftop_at = [&](int j, int c) {
      if (s == 0) return kNegHalf;
      if (warp > 0) return in_h[ring_plane + ring_at(c) * kWarp];
      return real ? frow[j * stride + base] : 0;
    };
    int top_next = 0;
    int ftop_next = 0;
    int8_t t_next = cols > 0 && real ? texts[base] : int8_t{0};
    for (int j = 0; j < cols; ++j) {
      const int c = j & (kSB - 1);
      if (c == 0) {
        chain.begin_block(s, to_ring);
        top_next = top_at(j, 0);
        if (kAffine) ftop_next = ftop_at(j, 0);
      }
      const int top0 = top_next;
      const int ftop0 = ftop_next;
      const int t = static_cast<uint8_t>(t_next) & 31;
      if (j + 1 < cols) {
        if (real) t_next = texts[(j + 1) * stride + base];
        if (c + 1 < kSB) {
          top_next = top_at(j + 1, c + 1);
          if (kAffine) ftop_next = ftop_at(j + 1, c + 1);
        }
      }
      int up = top0;     // H[i-1, j+1], new this column
      int f = ftop0;     // F[i-1, j+1] (affine)
      int dg = diag0;    // H[i-1, j], from the last column
      uint32_t word = 0;
      uint32_t word2 = 0;
      // The text letter's byte offset in both halves, and the table's
      // byte offsets of rows r and r+1.
      const uint32_t t4 = t * sizeof(int32_t) * 0x10001u;
      uint32_t at2 = 0;
      int hm = 0;  // semi, global: H in row m
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int left = h[r];
        if (r % 2 == 0) at2 = prow[r / 2] + t4;
        const int sc = *reinterpret_cast<const int32_t*>(
            reinterpret_cast<const char*>(sub) +
            (r % 2 == 0 ? at2 & 0xFFFF : at2 >> 16));
        int cur;
        // H = max(diag + s, gap_best): one DPX add-max (its _relu form
        // floors local's H at 0), the same value as the max of the three.
        if constexpr (!kAffine) {
          const int left_open = left - gap;
          if constexpr (!kDirs) {
            // Score-only: max(max(diag + s, left - gap), up - gap), so
            // that the chain from the cell above is one DPX op.
            const int dl = __viaddmax_s32(dg, sc, left_open);
            cur = kMode == kLocal ? __viaddmax_s32_relu(up, -gap, dl)
                                  : __viaddmax_s32(up, -gap, dl);
          } else {
            bool is_left;  // left - gap >= up - gap
            const int gap_best = __vibmax_s32(left_open, up - gap, &is_left);
            cur = kMode == kLocal ? __viaddmax_s32_relu(dg, sc, gap_best)
                                  : __viaddmax_s32(dg, sc, gap_best);
            // DIAG iff diag + s > gap_best, i.e. H > gap_best (local's
            // H = 0, where H <= gap_best may not hold, is STOP).
            uint32_t d = cur > gap_best ? 1u : (is_left ? 0u : 2u);
            if (kMode == kLocal && cur == 0) d = 3u;
            word |= d << (2 * r);
          }
        } else {
          const int e_ext = e[r] - ge;
          const int f_ext = f - ge;
          bool e_opens, f_opens;  // opening a run >= extending it
          e[r] = __vibmax_s32(left - gap, e_ext, &e_opens);
          f = __vibmax_s32(up - gap, f_ext, &f_opens);
          bool is_left;  // E >= F
          const int gap_best = __vibmax_s32(e[r], f, &is_left);
          cur = kMode == kLocal ? __viaddmax_s32_relu(dg, sc, gap_best)
                                : __viaddmax_s32(dg, sc, gap_best);
          if (kDirs) {
            uint32_t d = cur > gap_best ? 1u : (is_left ? 0u : 2u);
            if (kMode == kLocal && cur == 0) d = 3u;
            word |= d << (2 * r);
            // Run bits: the run goes on where extending beats opening.
            word2 |= (static_cast<uint32_t>(!e_opens) |
                      (static_cast<uint32_t>(!f_opens) << 1))
                     << (2 * r);
          }
        }
        if (kMode != kLocal) hm = r == row_m ? cur : hm;
        h[r] = cur;
        dg = left;
        up = cur;
      }
      diag0 = top0;
      if (kMode == kLocal) {
        track_column<kDirs>(h, j, i0, n, rows_ok, full_rows, acc, bi, bj);
      } else if (row_m >= 0 && row_m < kRows) {
        track_row_m<kMode, kDirs>(hm, j, n, m, acc, bi, bj);
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
        words[static_cast<int64_t>(j) * tile_pairs] = word;
        if (kAffine) words2[static_cast<int64_t>(j) * tile_pairs] = word2;
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
  merge<1>(rings, warps, &acc, &bi, &bj);
  if (warp == 0 && real) {
    scores[p] = kMode == kLocal ? max(acc, 0) : acc;
    if (kDirs) {
      best_is[p] = bi;
      best_js[p] = bj;
    }
  }
}

// K3's traits (interpair_host.cuh): one pair a lane, int32 scratch.
struct Cells32 {
  using Word = int32_t;
  static constexpr int kPerLane = 1;
  template <int kMode, bool kDirs, bool kAffine, int kSB, bool kSearch>
  static auto kernel() {
    return interpair_kernel<kMode, kDirs, kAffine, kSB, kSearch>;
  }
  // The shape in code per variant: the most warps a CTA runs on a grid
  // that fills the card (evened over the stripes) and the columns a
  // block, each the least time of its variant at the main path's shape,
  // or within 2 % of it (probes/interpair_shapes.py --time, NVIDIA H100
  // 80GB HBM3, 700 W): score-only 8,192 x 512^2, linear at most 16 warps
  // x 8 columns, 1.192 ms (16 x 4: 1.175; 8 x 8: 1.314), affine 8 x 8,
  // 1.800 (16 x 4: 1.809); with words 16,384 x 256^2, linear 8 x 4, 1.285
  // (4 x 8: 1.359; 16 x 8: 1.553), affine 8 x 2, 2.276 (8 x 4: 2.266).
  // More warps a CTA keep more chains in flight on an SM until registers
  // cap its CTAs; small blocks shorten the pipeline's fill and cost a
  // handoff every few columns.
  static constexpr int warps_of(bool dirs, bool affine) {
    return dirs || affine ? 8 : 16;
  }
  static constexpr int block_of(bool dirs, bool affine) {
    if (dirs) return affine ? 2 : 4;
    return 8;
  }
};

}  // namespace

// Fills a batch of b pairs.  texts: (n_cols, b) and patterns: (m_rows, b)
// int8 letters in 0..k-1, [column][pair]; ns, ms: (b,) lengths with
// 0 <= ns <= n_cols, 0 <= ms <= m_rows; score_matrix: (k, k) int32;
// row: (n_cols, b) int32 scratch; scores: (b,).  With dirs (m_rows a
// multiple of 16, b a multiple of tile_pairs): best_is, best_js (b,) and
// dirs (b/tile_pairs, m_rows/16, n_cols, tile_pairs) int32; otherwise
// they may be null.  mode: 0 global, 1 local, 2 semi.  affine: gap is
// the open cost and gap_extend the extend cost; frow is a second
// (n_cols, b) int32 scratch and, with dirs, dirs2 the run bits, shaped
// like dirs (both may be null when not affine).  Returns the launch's
// cudaError_t.
extern "C" int sa_interpair_fill(
    const int8_t* texts, const int8_t* patterns, const int32_t* ns,
    const int32_t* ms, const int32_t* score_matrix, int k, int gap,
    int gap_extend, int affine, int64_t b, int n_cols, int m_rows,
    int tile_pairs, int mode, int with_dirs, int32_t* row, int32_t* frow,
    int32_t* scores, int32_t* best_is, int32_t* best_js, int32_t* dirs,
    int32_t* dirs2, void* stream) {
  return interpair_host::fill<Cells32, true>(
      texts, patterns, ns, ms, score_matrix, k, gap, gap_extend, affine, b,
      n_cols, m_rows, tile_pairs, mode, with_dirs, row, frow, scores,
      best_is, best_js, dirs, dirs2, 0, 0, nullptr, nullptr, stream);
}

// Scores of b pairs in the search layout (the header's): texts the
// groups' blocks from groups[0] on, groups (b / 64,) int64 byte offsets,
// patterns (m_rows,) the query and ms (1,) its length, ns and scores
// (b,), row and frow (affine) int32 scratch of the texts' extent
// (groups[b / 64 - 1] - groups[0] + the last block), the rest as
// sa_interpair_fill's, score-only.  Returns the launch's cudaError_t.
extern "C" int sa_interpair_search(
    const int8_t* texts, const int64_t* groups, const int8_t* patterns,
    const int32_t* ns, const int32_t* ms, const int32_t* score_matrix, int k,
    int gap, int gap_extend, int affine, int64_t b, int n_cols, int m_rows,
    int mode, int32_t* row, int32_t* frow, int32_t* scores, void* stream) {
  return interpair_host::search<Cells32>(
      texts, groups, patterns, ns, ms, score_matrix, k, gap, gap_extend,
      affine, b, n_cols, m_rows, mode, row, frow, scores, stream);
}

// The shape sa_interpair_fill takes for the variant on a batch of b pairs
// of m_rows pattern rows: out[0] warps a CTA, out[1] columns a block,
// out[2] the most warps a CTA may run, out[3] the variant's most for a
// grid that fills the card (warps_of); out[0] is 0 when the device
// cannot be read.
extern "C" void sa_interpair_shape(int with_dirs, int affine, int m_rows,
                                   int64_t b, int* out) {
  interpair_host::shape<Cells32>(with_dirs, affine, m_rows, b, out);
}

#ifdef SA_INTERPAIR_ALL_SHAPES
// sa_interpair_fill at `warps` warps a CTA and `sb` columns a block (2,
// 4, 8 or 16); `trace`, when not null, gets kTraceWords int32 a warp,
// (CTA * warps + warp) * kTraceWords.
extern "C" int sa_interpair_fill_shape(
    const int8_t* texts, const int8_t* patterns, const int32_t* ns,
    const int32_t* ms, const int32_t* score_matrix, int k, int gap,
    int gap_extend, int affine, int64_t b, int n_cols, int m_rows,
    int tile_pairs, int mode, int with_dirs, int32_t* row, int32_t* frow,
    int32_t* scores, int32_t* best_is, int32_t* best_js, int32_t* dirs,
    int32_t* dirs2, int warps, int sb, int32_t* trace, void* stream) {
  return interpair_host::fill<Cells32>(
      texts, patterns, ns, ms, score_matrix, k, gap, gap_extend, affine, b,
      n_cols, m_rows, tile_pairs, mode, with_dirs, row, frow, scores,
      best_is, best_js, dirs, dirs2, warps, sb, trace, nullptr, stream);
}
#endif
