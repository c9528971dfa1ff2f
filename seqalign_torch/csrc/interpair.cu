// K3: inter-pair batch fill, linear or affine (Gotoh) gaps, one pair per
// thread.
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
// time the operations take.  So it is bound by operations, and in
// practice by how many of them the threads can issue: one thread a pair
// gives only 8,192-16,384 threads, 2-4 warps an SM, and every cell of a
// stripe column depends on the cell above it.
//
// What the design does about it: a thread walks its pair in stripes of
// 16 rows.  The stripe's 16 H values (and affine E values) and pattern
// rows stay in registers for a whole sweep across the columns, so only
// one value a column crosses stripes: the stripe's bottom row goes to a
// global scratch row[j][pair] (and its F to frow[j][pair]) and comes
// back for the next stripe (L2-resident at the main path's shapes).
// Every scratch, letter and word access is indexed [column][pair], so
// the 32 threads of a warp touch 32 neighbouring addresses.  The next
// column's letter and top value are loaded before the current column is
// computed.  The score matrix sits in shared memory as a 32 x 32 table
// (zeros outside k x k, letters masked to 5 bits, so no letter reads
// outside it).  The block size is the largest of 256..32 threads that
// still gives at least one block per SM.  The score-only variant fills
// only the cells its outputs depend on (rows <= m, columns < n of its own
// pair); the dirs variant fills every cell, padding included, so every
// word matches the TPU kernel's.  The affine mode is a template
// parameter, so the linear instances keep their loop unchanged.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_error.cuh"

namespace {

constexpr int kRows = 16;  // DP rows of a stripe = rows of a direction word
constexpr int kNegInf = -(1 << 30);
constexpr int kNegHalf = -(1 << 29);  // E and F before any run (NEG_INF // 2)
constexpr int kMaxThreads = 256;
constexpr int kGlobal = 0, kLocal = 1, kSemi = 2;

template <int kMode, bool kDirs, bool kAffine>
__global__ void __launch_bounds__(kMaxThreads) interpair_kernel(
    const int8_t* __restrict__ texts,     // (n_cols, b) letters
    const int8_t* __restrict__ patterns,  // (m_rows, b) letters
    const int32_t* __restrict__ ns, const int32_t* __restrict__ ms,
    const int32_t* __restrict__ score_matrix, int k, int gap, int ge,
    int64_t b, int n_cols, int m_rows, int tile_pairs,
    int32_t* __restrict__ row,   // (n_cols, b) scratch
    int32_t* __restrict__ frow,  // (n_cols, b) scratch, affine only
    int32_t* __restrict__ scores, int32_t* __restrict__ best_is,
    int32_t* __restrict__ best_js, int32_t* __restrict__ dirs,
    int32_t* __restrict__ dirs2) {
  __shared__ int32_t sub[32 * 32];
  for (int x = threadIdx.x; x < 32 * 32; x += blockDim.x) {
    const int a = x >> 5;
    const int c = x & 31;
    sub[x] = (a < k && c < k) ? score_matrix[a * k + c] : 0;
  }
  __syncthreads();
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (p >= b) return;
  const int n = min(ns[p], n_cols);
  const int m = min(ms[p], m_rows);
  const int num_w = m_rows / kRows;
  const int stripes = kDirs ? num_w : (max(m, 0) + kRows - 1) / kRows;
  const int cols = kDirs ? n_cols : max(n, 0);
  const int64_t tile = p / tile_pairs;
  const int64_t slot = p - tile * tile_pairs;
  int acc = kNegInf;
  int bi = 0;
  int bj = 0;

  for (int w = 0; w < stripes; ++w) {
    const int i0 = w * kRows;  // the DP row above the stripe
    int h[kRows];              // H[i0+1+r, j]: the stripe's left column
    int e[kRows];              // E[i0+1+r, j] (affine)
    int prow[kRows];           // pattern letter of row i0+1+r, times 32
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (kAffine) {
        h[r] = kMode == kLocal ? 0 : -gap - ge * (i0 + r);
        e[r] = kNegHalf;
      } else {
        h[r] = kMode == kLocal ? 0 : -gap * (i0 + r + 1);
      }
      const int8_t letter =
          i0 + r < m_rows ? patterns[(i0 + r) * b + p] : int8_t{0};
      prow[r] = (static_cast<uint8_t>(letter) & 31) << 5;
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
    int32_t* words = nullptr;
    int32_t* words2 = nullptr;
    if (kDirs) {
      const int64_t at = (tile * num_w + w) * n_cols * tile_pairs + slot;
      words = dirs + at;
      if (kAffine) words2 = dirs2 + at;
    }
    // H[i0, j+1] of the row above: row 0's boundary, or the scratch.
    auto top_at = [&](int j) {
      if (w == 0) {
        if (kMode != kGlobal) return 0;
        return kAffine ? -gap - ge * j : -gap * (j + 1);
      }
      return row[j * b + p];
    };
    // F[i0, j+1] (affine): row 0 starts no run.
    auto ftop_at = [&](int j) {
      return w == 0 ? kNegHalf : frow[j * b + p];
    };
    int top_next = 0;
    int ftop_next = 0;
    int8_t t_next = 0;
    if (cols > 0) {
      top_next = top_at(0);
      if (kAffine) ftop_next = ftop_at(0);
      t_next = texts[p];
    }
    for (int j = 0; j < cols; ++j) {
      const int top0 = top_next;
      const int ftop0 = ftop_next;
      const int t = static_cast<uint8_t>(t_next) & 31;
      if (j + 1 < cols) {
        top_next = top_at(j + 1);
        if (kAffine) ftop_next = ftop_at(j + 1);
        t_next = texts[(j + 1) * b + p];
      }
      int up = top0;     // H[i-1, j+1], new this column
      int f = ftop0;     // F[i-1, j+1] (affine)
      int dg = diag0;    // H[i-1, j], from the last column
      uint32_t word = 0;
      uint32_t word2 = 0;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int left = h[r];
        const int diag = dg + sub[prow[r] | t];
        int cur;
        if constexpr (!kAffine) {
          const int gap_best = max(up, left) - gap;
          const int best = max(diag, gap_best);
          cur = kMode == kLocal ? max(best, 0) : best;
          if (kDirs) {
            int d = diag > gap_best ? 1 : (left >= up ? 0 : 2);
            if (kMode == kLocal && best <= 0) d = 3;
            word |= static_cast<uint32_t>(d) << (2 * r);
          }
        } else {
          const int e_ext = e[r] - ge;
          const int e_open = left - gap;
          const int f_ext = f - ge;
          const int f_open = up - gap;
          e[r] = max(e_ext, e_open);
          f = max(f_ext, f_open);
          const int gap_best = max(e[r], f);
          const int best = max(diag, gap_best);
          cur = kMode == kLocal ? max(best, 0) : best;
          if (kDirs) {
            int d = diag > gap_best ? 1 : (e[r] >= f ? 0 : 2);
            if (kMode == kLocal && best <= 0) d = 3;
            word |= static_cast<uint32_t>(d) << (2 * r);
            word2 |= (static_cast<uint32_t>(e_ext > e_open) |
                      (static_cast<uint32_t>(f_ext > f_open) << 1))
                     << (2 * r);
          }
        }
        const int i = i0 + r + 1;
        if (kMode == kLocal) {
          const bool ok = j < n && i <= m;
          if (kDirs) {
            // Stripes visit rows out of row-major order: an equal value
            // in an earlier row wins.
            const bool better = ok && (cur > acc || (cur == acc && i < bi));
            bi = better ? i : bi;
            bj = better ? j + 1 : bj;
          }
          acc = ok ? max(acc, cur) : acc;
        } else if (kMode == kSemi) {
          const bool ok = i == m && j < n;
          if (kDirs) {
            const bool better = ok && cur > acc;
            bi = better ? i : bi;
            bj = better ? j + 1 : bj;
          }
          acc = ok ? max(acc, cur) : acc;
        } else {
          acc = (i == m && j == n - 1) ? cur : acc;
        }
        h[r] = cur;
        dg = left;
        up = cur;
      }
      diag0 = top0;
      row[j * b + p] = up;  // H[i0+16, j+1] for the next stripe
      if (kAffine) frow[j * b + p] = f;
      if (kDirs) {
        words[static_cast<int64_t>(j) * tile_pairs] = word;
        if (kAffine) words2[static_cast<int64_t>(j) * tile_pairs] = word2;
      }
    }
  }
  scores[p] = kMode == kLocal ? max(acc, 0) : acc;
  if (kDirs) {
    best_is[p] = bi;
    best_js[p] = bj;
  }
}

struct Args {
  const int8_t* texts;
  const int8_t* patterns;
  const int32_t* ns;
  const int32_t* ms;
  const int32_t* score_matrix;
  int k, gap, ge;
  int64_t b;
  int n_cols, m_rows, tile_pairs;
  int32_t *row, *frow, *scores, *best_is, *best_js, *dirs, *dirs2;
};

template <int kMode, bool kDirs, bool kAffine>
void launch(const Args& a, int blocks, int threads, cudaStream_t stream) {
  interpair_kernel<kMode, kDirs, kAffine><<<blocks, threads, 0, stream>>>(
      a.texts, a.patterns, a.ns, a.ms, a.score_matrix, a.k, a.gap, a.ge,
      a.b, a.n_cols, a.m_rows, a.tile_pairs, a.row, a.frow, a.scores,
      a.best_is, a.best_js, a.dirs, a.dirs2);
}

template <int kMode>
void launch_mode(const Args& a, bool with_dirs, bool affine, int blocks,
                 int threads, cudaStream_t stream) {
  if (affine) {
    if (with_dirs) {
      launch<kMode, true, true>(a, blocks, threads, stream);
    } else {
      launch<kMode, false, true>(a, blocks, threads, stream);
    }
  } else if (with_dirs) {
    launch<kMode, true, false>(a, blocks, threads, stream);
  } else {
    launch<kMode, false, false>(a, blocks, threads, stream);
  }
}

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
extern "C" int sa_interpair_fill(const int8_t* texts, const int8_t* patterns,
                                 const int32_t* ns, const int32_t* ms,
                                 const int32_t* score_matrix, int k, int gap,
                                 int gap_extend, int affine, int64_t b,
                                 int n_cols, int m_rows, int tile_pairs,
                                 int mode, int with_dirs, int32_t* row,
                                 int32_t* frow, int32_t* scores,
                                 int32_t* best_is, int32_t* best_js,
                                 int32_t* dirs, int32_t* dirs2,
                                 void* stream) {
  if (k < 1 || k > 32 || b < 0 || n_cols < 1 || m_rows < 1 ||
      tile_pairs < 1 || mode < 0 || mode > 2 ||
      (with_dirs && (m_rows % kRows || b % tile_pairs)) ||
      (affine && (frow == nullptr || (with_dirs && dirs2 == nullptr)))) {
    return cudaErrorInvalidValue;
  }
  if (b == 0) return cudaSuccess;
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  int threads = kMaxThreads;
  while (threads > 32 && (b + threads - 1) / threads < sms) threads /= 2;
  const int64_t blocks = (b + threads - 1) / threads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const Args a{texts, patterns, ns, ms, score_matrix, k, gap,
               affine ? gap_extend : 0, b, n_cols, m_rows, tile_pairs, row,
               frow, scores, best_is, best_js, dirs, dirs2};
  const bool d = with_dirs != 0;
  const bool af = affine != 0;
  const int grid = static_cast<int>(blocks);
  if (mode == kGlobal) {
    launch_mode<kGlobal>(a, d, af, grid, threads, s);
  } else if (mode == kLocal) {
    launch_mode<kLocal>(a, d, af, grid, threads, s);
  } else {
    launch_mode<kSemi>(a, d, af, grid, threads, s);
  }
  return cudaGetLastError();
}
