// K3-cell16: the inter-pair batch fill in int16 cells, linear or affine
// (Gotoh) gaps, two pairs per thread in the halves of 32-bit registers.
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
// shared-memory reads packed with __byte_perm), the 2-bit direction codes
// and the best-cell tracking of the words variant stay per pair.
//
// The design: thread t owns pairs 2t (low halves) and 2t+1 (high
// halves), so a batch of B pairs runs B/2 threads (the batch is even: the
// wrapper pads an odd score-only batch with one padding pair).  It reads
// both pairs' letters of a column as one 16-bit load from the
// [column][pair] int8 layout, keeps a stripe's 16 packed H values (and
// E, affine) in registers across the columns, and round-trips the
// stripe's bottom row (and F) through a [column][pair-pair] uint32
// scratch, half the int32 kernel's scratch bytes.  It writes its two
// pairs' words of a column as one 8-byte store (the two pairs are
// neighbouring slots of one tile).  The score-only variant keeps packed
// trackers: per row and per column half-masks (0xFFFF where the cell is
// tracked) select the cells, so local's best is one masked max (a masked
// cell counts 0, which the floor at 0 makes harmless), semi's a select
// and a max, global's a select.  It fills the cells of the longer of its
// two pairs; the words variant fills every cell, padding included, so
// every word matches the TPU kernel's.  Two pairs a thread halve the
// threads: 8,192 pairs give 4,096, under one warp an SM on 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_error.cuh"

namespace {

constexpr int kRows = 16;  // DP rows of a stripe = rows of a direction word
constexpr int kNeg16 = -(1 << 14);
constexpr int kMaxThreads = 256;
constexpr int kGlobal = 0, kLocal = 1, kSemi = 2;

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

// The words variant's tracker of one pair (the int32 kernel's).
template <int kMode>
__device__ __forceinline__ void track(int cur, int i, int j, int n, int m,
                                      int& acc, int& bi, int& bj) {
  if (kMode == kLocal) {
    const bool ok = j < n && i <= m;
    // Stripes visit rows out of row-major order: an equal value in an
    // earlier row wins.
    const bool better = ok && (cur > acc || (cur == acc && i < bi));
    bi = better ? i : bi;
    bj = better ? j + 1 : bj;
    acc = ok ? max(acc, cur) : acc;
  } else if (kMode == kSemi) {
    const bool ok = i == m && j < n;
    const bool better = ok && cur > acc;
    bi = better ? i : bi;
    bj = better ? j + 1 : bj;
    acc = ok ? max(acc, cur) : acc;
  } else {
    acc = (i == m && j == n - 1) ? cur : acc;
  }
}

template <int kMode, bool kDirs, bool kAffine>
__global__ void __launch_bounds__(kMaxThreads) interpair16_kernel(
    const int8_t* __restrict__ texts,     // (n_cols, b) letters
    const int8_t* __restrict__ patterns,  // (m_rows, b) letters
    const int32_t* __restrict__ ns, const int32_t* __restrict__ ms,
    const int32_t* __restrict__ score_matrix, int k, int gap, int ge,
    int64_t b, int n_cols, int m_rows, int tile_pairs,
    uint32_t* __restrict__ row,   // (n_cols, b/2) scratch
    uint32_t* __restrict__ frow,  // (n_cols, b/2) scratch, affine only
    int32_t* __restrict__ scores, int32_t* __restrict__ best_is,
    int32_t* __restrict__ best_js, int32_t* __restrict__ dirs,
    int32_t* __restrict__ dirs2) {
  __shared__ int16_t sub[32 * 32];
  for (int x = threadIdx.x; x < 32 * 32; x += blockDim.x) {
    const int a = x >> 5;
    const int c = x & 31;
    sub[x] = static_cast<int16_t>((a < k && c < k) ? score_matrix[a * k + c]
                                                   : 0);
  }
  __syncthreads();
  const int64_t half_b = b / 2;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= half_b) return;
  const int64_t p = 2 * t;  // pair p in the low halves, p + 1 in the high
  const int n_lo = min(ns[p], n_cols);
  const int n_hi = min(ns[p + 1], n_cols);
  const int m_lo = min(ms[p], m_rows);
  const int m_hi = min(ms[p + 1], m_rows);
  const int num_w = m_rows / kRows;
  const int stripes =
      kDirs ? num_w : (max(max(m_lo, m_hi), 0) + kRows - 1) / kRows;
  const int cols = kDirs ? n_cols : max(max(n_lo, n_hi), 0);
  const int64_t tile = p / tile_pairs;
  const int64_t slot = p - tile * tile_pairs;
  const uint16_t* __restrict__ texts2 =
      reinterpret_cast<const uint16_t*>(texts);
  const uint16_t* __restrict__ patterns2 =
      reinterpret_cast<const uint16_t*>(patterns);
  const uint32_t gap2 = splat(gap);
  const uint32_t ext2 = splat(ge);
  const uint32_t neg2 = splat(kNeg16);
  uint32_t acc2 = neg2;  // score-only trackers, packed
  int acc_lo = kNeg16, acc_hi = kNeg16;  // the words variant's, per pair
  int bi_lo = 0, bj_lo = 0, bi_hi = 0, bj_hi = 0;

  for (int w = 0; w < stripes; ++w) {
    const int i0 = w * kRows;  // the DP row above the stripe
    uint32_t h[kRows];         // H[i0+1+r, j]: the stripe's left column
    uint32_t e[kRows];         // E[i0+1+r, j] (affine)
    int prow_lo[kRows];        // pattern letters of row i0+1+r, times 32
    int prow_hi[kRows];
    uint32_t rmask[kRows];     // score-only: the rows each pair tracks
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
          i0 + r < m_rows ? patterns2[(i0 + r) * half_b + t] : 0u;
      prow_lo[r] = (letters & 31) << 5;
      prow_hi[r] = ((letters >> 8) & 31) << 5;
      if (!kDirs) {
        rmask[r] = kMode == kLocal ? halves(i <= m_lo, i <= m_hi)
                                   : halves(i == m_lo, i == m_hi);
      }
    }
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
      const int64_t at = (tile * num_w + w) * n_cols * tile_pairs + slot;
      words = dirs + at;
      if (kAffine) words2 = dirs2 + at;
    }
    // H[i0, j+1] of the row above: row 0's boundary, or the scratch.
    auto top_at = [&](int j) -> uint32_t {
      if (w == 0) {
        if (kMode != kGlobal) return 0u;
        return splat(kAffine ? -gap - ge * j : -gap * (j + 1));
      }
      return row[j * half_b + t];
    };
    // F[i0, j+1] (affine): row 0 starts no run.
    auto ftop_at = [&](int j) -> uint32_t {
      return w == 0 ? neg2 : frow[j * half_b + t];
    };
    uint32_t top_next = 0;
    uint32_t ftop_next = 0;
    uint32_t t_next = 0;
    if (cols > 0) {
      top_next = top_at(0);
      if (kAffine) ftop_next = ftop_at(0);
      t_next = texts2[t];
    }
    for (int j = 0; j < cols; ++j) {
      const uint32_t top0 = top_next;
      const uint32_t ftop0 = ftop_next;
      const int t_lo = t_next & 31;
      const int t_hi = (t_next >> 8) & 31;
      if (j + 1 < cols) {
        top_next = top_at(j + 1);
        if (kAffine) ftop_next = ftop_at(j + 1);
        t_next = texts2[(j + 1) * half_b + t];
      }
      // Score-only: the columns each pair tracks.
      uint32_t cmask = 0;
      if (!kDirs) {
        cmask = kMode == kGlobal ? halves(j == n_lo - 1, j == n_hi - 1)
                                 : halves(j < n_lo, j < n_hi);
      }
      uint32_t up = top0;   // H[i-1, j+1], new this column
      uint32_t f = ftop0;   // F[i-1, j+1] (affine)
      uint32_t dg = diag0;  // H[i-1, j], from the last column
      uint32_t word_lo = 0, word_hi = 0, word2_lo = 0, word2_hi = 0;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const uint32_t left = h[r];
        const uint32_t s = __byte_perm(
            static_cast<uint16_t>(sub[prow_lo[r] | t_lo]),
            static_cast<uint16_t>(sub[prow_hi[r] | t_hi]), 0x5410);
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
          cur = kMode == kLocal ? __viaddmax_s16x2_relu(dg, s, gap_best)
                                : __viaddmax_s16x2(dg, s, gap_best);
          const uint32_t ok = rmask[r] & cmask;
          if (kMode == kLocal) {
            acc2 = __vmaxs2(acc2, cur & ok);
          } else if (kMode == kSemi) {
            acc2 = __vmaxs2(acc2, (cur & ok) | (neg2 & ~ok));
          } else {
            acc2 = (cur & ok) | (acc2 & ~ok);
          }
        } else {
          const uint32_t diag = __vadd2(dg, s);
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
          const int i = i0 + r + 1;
          track<kMode>(lo16(cur), i, j, n_lo, m_lo, acc_lo, bi_lo, bj_lo);
          track<kMode>(hi16(cur), i, j, n_hi, m_hi, acc_hi, bi_hi, bj_hi);
        }
        h[r] = cur;
        dg = left;
        up = cur;
      }
      diag0 = top0;
      row[j * half_b + t] = up;  // H[i0+16, j+1] for the next stripe
      if (kAffine) frow[j * half_b + t] = f;
      if (kDirs) {
        const int64_t at = static_cast<int64_t>(j) * tile_pairs;
        *reinterpret_cast<uint2*>(words + at) = make_uint2(word_lo, word_hi);
        if (kAffine) {
          *reinterpret_cast<uint2*>(words2 + at) =
              make_uint2(word2_lo, word2_hi);
        }
      }
    }
  }
  if (!kDirs) {
    acc_lo = lo16(acc2);
    acc_hi = hi16(acc2);
  }
  scores[p] = kMode == kLocal ? max(acc_lo, 0) : acc_lo;
  scores[p + 1] = kMode == kLocal ? max(acc_hi, 0) : acc_hi;
  if (kDirs) {
    best_is[p] = bi_lo;
    best_js[p] = bj_lo;
    best_is[p + 1] = bi_hi;
    best_js[p + 1] = bj_hi;
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
  uint32_t *row, *frow;
  int32_t *scores, *best_is, *best_js, *dirs, *dirs2;
};

template <int kMode, bool kDirs, bool kAffine>
void launch(const Args& a, int blocks, int threads, cudaStream_t stream) {
  interpair16_kernel<kMode, kDirs, kAffine><<<blocks, threads, 0, stream>>>(
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
  if (k < 1 || k > 32 || b < 0 || b % 2 || n_cols < 1 || m_rows < 1 ||
      tile_pairs < 1 || mode < 0 || mode > 2 ||
      (with_dirs && (m_rows % kRows || tile_pairs % 2 || b % tile_pairs)) ||
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
  const int64_t threads_needed = b / 2;
  int threads = kMaxThreads;
  while (threads > 32 && (threads_needed + threads - 1) / threads < sms) {
    threads /= 2;
  }
  const int64_t blocks = (threads_needed + threads - 1) / threads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const Args a{texts, patterns, ns, ms, score_matrix, k, gap,
               affine ? gap_extend : 0, b, n_cols, m_rows, tile_pairs,
               reinterpret_cast<uint32_t*>(row),
               reinterpret_cast<uint32_t*>(frow), scores, best_is, best_js,
               dirs, dirs2};
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
