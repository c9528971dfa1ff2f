// Native reference oracle for the TPU alignment engine.
//
// Implements the exact observable semantics of the reference CPU engine
// (reference: alignSequenceCPU.cpp) as a small C-ABI shared library:
//   * Needleman-Wunsch (global) and Smith-Waterman (local) DP fill with a
//     linear gap penalty and an integer substitution matrix,
//   * the reference's tie policy (diagonal wins only when strictly
//     greater than both gap moves; left beats top on gap ties,
//     alignSequenceCPU.cpp:265-269),
//   * traceback semantics incl. the NW first-row/first-column direction
//     overrides (alignSequenceCPU.cpp:77-81) and the SW early-exit on
//     reaching the first row/column (alignSequenceCPU.cpp:44-46).
//
// The implementation is a fresh design (single templated fill, C ABI,
// caller-owned buffers, no globals); only the behavior is shared.
//
// Sequences are passed as int8 alphabet indices. Aligned outputs are
// emitted as uint8 alphabet indices where index==alphabet_size denotes
// the gap character.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <utility>

namespace {

enum Dir : uint8_t { kLeft = 0, kDiag = 1, kTop = 2, kStop = 3 };

struct Best {
  int32_t score;
  uint8_t dir;
};

// Reference tie policy: LEFT >= TOP among gap moves; DIAG only if strictly
// greater than both.
inline Best pick(int32_t from_left, int32_t from_top, int32_t from_diag) {
  const int32_t gap_best = from_left >= from_top ? from_left : from_top;
  if (from_diag > gap_best) return {from_diag, kDiag};
  return {gap_best, from_left >= from_top ? static_cast<uint8_t>(kLeft)
                                          : static_cast<uint8_t>(kTop)};
}

// Row-sweep DP fill writing the full (m+1)x(n+1) direction matrix.
// For kLocal, returns {max_score, flat index of its first row-major
// occurrence}; for global, returns {bottom-right score, 0}.
template <bool kLocal>
std::pair<int32_t, int64_t> fill(const int8_t* text, int64_t n,
                                 const int8_t* pattern, int64_t m,
                                 const int32_t* score_matrix, int32_t k,
                                 int32_t gap, uint8_t* dirs, int32_t* row_a,
                                 int32_t* row_b) {
  const int64_t cols = n + 1;
  int32_t* prev = row_a;
  int32_t* curr = row_b;

  for (int64_t j = 0; j < cols; ++j) {
    curr[j] = kLocal ? 0 : static_cast<int32_t>(-gap * j);
    dirs[j] = kLocal ? kStop : kLeft;
  }

  int32_t max_score = 0;
  int64_t max_idx = 0;
  for (int64_t i = 1; i <= m; ++i) {
    std::swap(prev, curr);
    uint8_t* dir_row = dirs + i * cols;
    curr[0] = kLocal ? 0 : static_cast<int32_t>(-gap * i);
    dir_row[0] = kLocal ? kStop : kTop;
    const int32_t* sub_row = score_matrix + static_cast<int64_t>(pattern[i - 1]) * k;
    for (int64_t j = 1; j < cols; ++j) {
      const Best b = pick(curr[j - 1] - gap, prev[j] - gap,
                          prev[j - 1] + sub_row[text[j - 1]]);
      if (kLocal) {
        dir_row[j] = b.score > 0 ? b.dir : static_cast<uint8_t>(kStop);
        curr[j] = b.score > 0 ? b.score : 0;
        if (curr[j] > max_score) {
          max_score = curr[j];
          max_idx = i * cols + j;
        }
      } else {
        dir_row[j] = b.dir;
        curr[j] = b.score;
      }
    }
  }
  if (kLocal) return {max_score, max_idx};
  return {curr[n], 0};
}

// Semi-global ("fit") fill — an extension beyond the reference (its
// SEMI_GLOBAL enum value is unreachable from the CLI): the pattern is
// aligned globally while text end-gaps are free.  Boundary H[0][j] = 0,
// H[i][0] = -g*i; same recurrence and tie policy as NW; the score is
// the maximum of the LAST row, first (smallest-column) occurrence.
// Returns {score, flat index of that cell}.
std::pair<int32_t, int64_t> fill_semi(const int8_t* text, int64_t n,
                                      const int8_t* pattern, int64_t m,
                                      const int32_t* score_matrix, int32_t k,
                                      int32_t gap, uint8_t* dirs,
                                      int32_t* row_a, int32_t* row_b) {
  const int64_t cols = n + 1;
  int32_t* prev = row_a;
  int32_t* curr = row_b;
  for (int64_t j = 0; j < cols; ++j) {
    curr[j] = 0;
    dirs[j] = kLeft;
  }
  for (int64_t i = 1; i <= m; ++i) {
    std::swap(prev, curr);
    uint8_t* dir_row = dirs + i * cols;
    curr[0] = static_cast<int32_t>(-gap * i);
    dir_row[0] = kTop;
    const int32_t* sub_row =
        score_matrix + static_cast<int64_t>(pattern[i - 1]) * k;
    for (int64_t j = 1; j < cols; ++j) {
      const Best b = pick(curr[j - 1] - gap, prev[j] - gap,
                          prev[j - 1] + sub_row[text[j - 1]]);
      dir_row[j] = b.dir;
      curr[j] = b.score;
    }
  }
  // First occurrence over j >= 1 (H[m][j>=1] >= H[m][0] always — an
  // all-TOP path from the free zero row — so j = 0 can only tie; the
  // accelerator trackers never see j = 0, and all engines agree on
  // starting the fit at j >= 1).
  int64_t arg = n >= 1 ? 1 : 0;
  int32_t best = curr[arg];
  for (int64_t j = arg + 1; j < cols; ++j) {
    if (curr[j] > best) {
      best = curr[j];
      arg = j;
    }
  }
  return {best, m * cols + arg};
}

inline void emit(const int8_t* text, const int8_t* pattern, int32_t k,
                 uint8_t dir, int64_t ti, int64_t pi, uint8_t* out_text,
                 uint8_t* out_pattern, int64_t pos) {
  const bool take_text = dir == kDiag || dir == kLeft;
  const bool take_pattern = dir == kDiag || dir == kTop;
  out_text[pos] = take_text ? static_cast<uint8_t>(text[ti])
                            : static_cast<uint8_t>(k);
  out_pattern[pos] = take_pattern ? static_cast<uint8_t>(pattern[pi])
                                  : static_cast<uint8_t>(k);
}

inline int64_t step_back(int64_t curr, uint8_t dir, int64_t cols) {
  if (dir == kLeft) return curr - 1;
  if (dir == kDiag) return curr - cols - 1;
  if (dir == kTop) return curr - cols;
  return curr;
}

}  // namespace

extern "C" {

// Traceback of a global alignment from a full direction matrix.
// Walks from `start` (the flat index of cell (m, n) — which may differ
// from rows*cols-1 when the matrix is column-padded) to cell 0; the
// first column forces TOP and the first row forces LEFT regardless of
// stored directions.
void sa_traceback_nw(const uint8_t* dirs, int64_t start, int64_t cols,
                     const int8_t* text, const int8_t* pattern, int32_t k,
                     uint8_t* out_text, uint8_t* out_pattern,
                     int64_t* out_len, int64_t* out_start_text,
                     int64_t* out_start_pattern) {
  int64_t curr = start;
  int64_t ti = (start % cols) - 1;  // == text length - 1
  int64_t pi = (start / cols) - 1;
  int64_t len = 0;
  while (curr > 0) {
    uint8_t dir = dirs[curr];
    if (curr % cols == 0) {
      dir = kTop;
    } else if (curr < cols) {
      dir = kLeft;
    }
    emit(text, pattern, k, dir, ti, pi, out_text, out_pattern, len++);
    if (dir == kDiag || dir == kLeft) ti = ti > 0 ? ti - 1 : 0;
    if (dir == kDiag || dir == kTop) pi = pi > 0 ? pi - 1 : 0;
    curr = step_back(curr, dir, cols);
  }
  *out_len = len;
  *out_start_text = ti;
  *out_start_pattern = pi;
  std::reverse(out_text, out_text + len);
  std::reverse(out_pattern, out_pattern + len);
}

// Traceback of a local alignment starting from the best cell's flat
// index. Stops at a STOP direction or on reaching the first row/column
// (without updating the sequence cursors on that final hop, matching the
// reference's loop structure).
void sa_traceback_sw(const uint8_t* dirs, int64_t start, int64_t rows,
                     int64_t cols, const int8_t* text, const int8_t* pattern,
                     int32_t k, uint8_t* out_text, uint8_t* out_pattern,
                     int64_t* out_len, int64_t* out_start_text,
                     int64_t* out_start_pattern) {
  int64_t ti = (start % cols) - 1;
  int64_t pi = (start / cols) - 1;
  int64_t curr = start;
  int64_t len = 0;
  while (dirs[curr] != kStop) {
    const uint8_t dir = dirs[curr];
    emit(text, pattern, k, dir, ti, pi, out_text, out_pattern, len++);
    curr = step_back(curr, dir, cols);
    if (curr % cols == 0 || curr < cols) break;
    if (dir == kDiag || dir == kLeft) ti = ti > 0 ? ti - 1 : 0;
    if (dir == kDiag || dir == kTop) pi = pi > 0 ? pi - 1 : 0;
  }
  *out_len = len;
  *out_start_text = ti;
  *out_start_pattern = pi;
  std::reverse(out_text, out_text + len);
  std::reverse(out_pattern, out_pattern + len);
}

// Semi-global traceback from the best last-row cell's flat index: walks
// like NW (first column forces TOP) but stops on reaching row 0; the
// free text end-gaps are not emitted.  start_text = the text index
// where the fitted pattern begins; start_pattern = 0.
void sa_traceback_semi(const uint8_t* dirs, int64_t start, int64_t cols,
                       const int8_t* text, const int8_t* pattern, int32_t k,
                       uint8_t* out_text, uint8_t* out_pattern,
                       int64_t* out_len, int64_t* out_start_text,
                       int64_t* out_start_pattern) {
  int64_t i = start / cols;
  int64_t j = start % cols;
  int64_t len = 0;
  while (i > 0) {
    const uint8_t dir = j == 0 ? static_cast<uint8_t>(kTop)
                               : dirs[i * cols + j];
    emit(text, pattern, k, dir, j - 1, i - 1, out_text, out_pattern, len++);
    if (dir == kDiag || dir == kLeft) --j;
    if (dir == kDiag || dir == kTop) --i;
  }
  *out_len = len;
  *out_start_text = j;
  *out_start_pattern = 0;
  std::reverse(out_text, out_text + len);
  std::reverse(out_pattern, out_pattern + len);
}

// DP fill only: writes the (m+1)x(n+1) uint8 direction matrix into
// `dirs`, the optimal score into `out_score`, and (local only) the flat
// index of the best cell into `out_best_idx`.
// algo: 0 = global/NW, 1 = local/SW. Returns 0 on success, 1 on OOM.
int32_t sa_fill(int32_t algo, const int8_t* text, int64_t n,
                const int8_t* pattern, int64_t m, const int32_t* score_matrix,
                int32_t k, int32_t gap, uint8_t* dirs, int32_t* out_score,
                int64_t* out_best_idx) {
  const int64_t cols = n + 1;
  int32_t* rows_buf =
      static_cast<int32_t*>(std::malloc(sizeof(int32_t) * 2 * cols));
  if (rows_buf == nullptr) return 1;
  std::pair<int32_t, int64_t> result;
  if (algo == 0) {
    result = fill<false>(text, n, pattern, m, score_matrix, k, gap, dirs,
                         rows_buf, rows_buf + cols);
  } else if (algo == 2) {
    result = fill_semi(text, n, pattern, m, score_matrix, k, gap, dirs,
                       rows_buf, rows_buf + cols);
  } else {
    result = fill<true>(text, n, pattern, m, score_matrix, k, gap, dirs,
                        rows_buf, rows_buf + cols);
  }
  std::free(rows_buf);
  *out_score = result.first;
  *out_best_idx = result.second;
  return 0;
}

// Full oracle alignment: fill + traceback in one call.
// Output buffers must hold at least n+m+1 bytes each.
// Returns 0 on success, 1 on OOM.
int32_t sa_align(int32_t algo, const int8_t* text, int64_t n,
                 const int8_t* pattern, int64_t m,
                 const int32_t* score_matrix, int32_t k, int32_t gap,
                 uint8_t* out_text, uint8_t* out_pattern, int64_t* out_len,
                 int64_t* out_start_text, int64_t* out_start_pattern,
                 int32_t* out_score) {
  const int64_t rows = m + 1;
  const int64_t cols = n + 1;
  uint8_t* dirs = static_cast<uint8_t*>(std::malloc(rows * cols));
  if (dirs == nullptr) return 1;

  int64_t best_idx = 0;
  if (sa_fill(algo, text, n, pattern, m, score_matrix, k, gap, dirs,
              out_score, &best_idx) != 0) {
    std::free(dirs);
    return 1;
  }
  if (algo == 0) {
    sa_traceback_nw(dirs, rows * cols - 1, cols, text, pattern, k, out_text,
                    out_pattern, out_len, out_start_text, out_start_pattern);
  } else if (algo == 2) {
    sa_traceback_semi(dirs, best_idx, cols, text, pattern, k, out_text,
                      out_pattern, out_len, out_start_text,
                      out_start_pattern);
  } else {
    sa_traceback_sw(dirs, best_idx, rows, cols, text, pattern, k, out_text,
                    out_pattern, out_len, out_start_text, out_start_pattern);
  }
  std::free(dirs);
  return 0;
}

// ---------------------------------------------------------------------------
// Packed-direction tracebacks for the TPU fill kernel's output format:
// int32 words, word row w at column position p (= j-1) holds the 2-bit
// directions of DP rows 16w+1 .. 16w+16 (bits 2k..2k+1 for row 16w+k+1).
// DP row 0 / column 0 are implicit (never dereferenced, see the boundary
// overrides / break rules of the unpacked walks above).

namespace {

inline uint8_t packed_dir(const int32_t* words, int64_t p_cols, int64_t i,
                          int64_t j) {
  const int32_t w = words[((i - 1) >> 4) * p_cols + (j - 1)];
  return static_cast<uint8_t>((w >> (2 * ((i - 1) & 15))) & 3);
}

}  // namespace

// Global traceback from DP cell (m, n) over packed directions.
void sa_traceback_nw_packed(const int32_t* words, int64_t p_cols, int64_t n,
                            int64_t m, const int8_t* text,
                            const int8_t* pattern, int32_t k,
                            uint8_t* out_text, uint8_t* out_pattern,
                            int64_t* out_len, int64_t* out_start_text,
                            int64_t* out_start_pattern) {
  int64_t i = m;
  int64_t j = n;
  int64_t ti = n - 1;
  int64_t pi = m - 1;
  int64_t len = 0;
  while (i > 0 || j > 0) {
    uint8_t dir;
    if (j == 0) {
      dir = kTop;
    } else if (i == 0) {
      dir = kLeft;
    } else {
      dir = packed_dir(words, p_cols, i, j);
    }
    emit(text, pattern, k, dir, ti, pi, out_text, out_pattern, len++);
    if (dir == kDiag || dir == kLeft) {
      ti = ti > 0 ? ti - 1 : 0;
      --j;
    }
    if (dir == kDiag || dir == kTop) {
      pi = pi > 0 ? pi - 1 : 0;
      --i;
    }
  }
  *out_len = len;
  *out_start_text = ti;
  *out_start_pattern = pi;
  std::reverse(out_text, out_text + len);
  std::reverse(out_pattern, out_pattern + len);
}

// Local traceback from the best cell (bi, bj) over packed directions.
void sa_traceback_sw_packed(const int32_t* words, int64_t p_cols, int64_t bi,
                            int64_t bj, const int8_t* text,
                            const int8_t* pattern, int32_t k,
                            uint8_t* out_text, uint8_t* out_pattern,
                            int64_t* out_len, int64_t* out_start_text,
                            int64_t* out_start_pattern) {
  int64_t i = bi;
  int64_t j = bj;
  int64_t ti = bj - 1;
  int64_t pi = bi - 1;
  int64_t len = 0;
  while (i > 0 && j > 0 && packed_dir(words, p_cols, i, j) != kStop) {
    const uint8_t dir = packed_dir(words, p_cols, i, j);
    emit(text, pattern, k, dir, ti, pi, out_text, out_pattern, len++);
    if (dir == kDiag || dir == kLeft) --j;
    if (dir == kDiag || dir == kTop) --i;
    if (j == 0 || i == 0) break;
    if (dir == kDiag || dir == kLeft) ti = ti > 0 ? ti - 1 : 0;
    if (dir == kDiag || dir == kTop) pi = pi > 0 ? pi - 1 : 0;
  }
  *out_len = len;
  *out_start_text = ti;
  *out_start_pattern = pi;
  std::reverse(out_text, out_text + len);
  std::reverse(out_pattern, out_pattern + len);
}

// ---------------------------------------------------------------------------
// Skewed-word tracebacks for the wavefront kernel's output format:
// strip c = (i-1)/(rps*slots) owns rows of slots s = ((i-1)%(rps*slots))/rps;
// the sweep step of cell (i, j) is t = j-1+s, and word (c, (t/16)*rps+r, s)
// holds its 2-bit direction at bit 2*(t%16).

namespace {

inline uint8_t skewed_dir(const int32_t* words, int64_t words_per_strip,
                          int64_t rps, int64_t slots, int64_t i, int64_t j) {
  const int64_t ri = (i - 1) % (rps * slots);
  const int64_t c = (i - 1) / (rps * slots);
  const int64_t s = ri / rps;
  const int64_t r = ri % rps;
  const int64_t t = j - 1 + s;
  const int32_t w =
      words[c * words_per_strip + ((t >> 4) * rps + r) * slots + s];
  return static_cast<uint8_t>((w >> (2 * (t & 15))) & 3);
}

}  // namespace

void sa_traceback_nw_skewed(const int32_t* words, int64_t steps_pad,
                            int64_t rps, int64_t slots, int64_t n, int64_t m,
                            const int8_t* text, const int8_t* pattern,
                            int32_t k, uint8_t* out_text,
                            uint8_t* out_pattern, int64_t* out_len,
                            int64_t* out_start_text,
                            int64_t* out_start_pattern) {
  const int64_t wps = (steps_pad >> 4) * rps * slots;
  int64_t i = m;
  int64_t j = n;
  int64_t ti = n - 1;
  int64_t pi = m - 1;
  int64_t len = 0;
  while (i > 0 || j > 0) {
    uint8_t dir;
    if (j == 0) {
      dir = kTop;
    } else if (i == 0) {
      dir = kLeft;
    } else {
      dir = skewed_dir(words, wps, rps, slots, i, j);
    }
    emit(text, pattern, k, dir, ti, pi, out_text, out_pattern, len++);
    if (dir == kDiag || dir == kLeft) {
      ti = ti > 0 ? ti - 1 : 0;
      --j;
    }
    if (dir == kDiag || dir == kTop) {
      pi = pi > 0 ? pi - 1 : 0;
      --i;
    }
  }
  *out_len = len;
  *out_start_text = ti;
  *out_start_pattern = pi;
  std::reverse(out_text, out_text + len);
  std::reverse(out_pattern, out_pattern + len);
}

void sa_traceback_sw_skewed(const int32_t* words, int64_t steps_pad,
                            int64_t rps, int64_t slots, int64_t bi,
                            int64_t bj,
                            const int8_t* text, const int8_t* pattern,
                            int32_t k, uint8_t* out_text,
                            uint8_t* out_pattern, int64_t* out_len,
                            int64_t* out_start_text,
                            int64_t* out_start_pattern) {
  const int64_t wps = (steps_pad >> 4) * rps * slots;
  int64_t i = bi;
  int64_t j = bj;
  int64_t ti = bj - 1;
  int64_t pi = bi - 1;
  int64_t len = 0;
  while (i > 0 && j > 0 && skewed_dir(words, wps, rps, slots, i, j) != kStop) {
    const uint8_t dir = skewed_dir(words, wps, rps, slots, i, j);
    emit(text, pattern, k, dir, ti, pi, out_text, out_pattern, len++);
    if (dir == kDiag || dir == kLeft) --j;
    if (dir == kDiag || dir == kTop) --i;
    if (j == 0 || i == 0) break;
    if (dir == kDiag || dir == kLeft) ti = ti > 0 ? ti - 1 : 0;
    if (dir == kDiag || dir == kTop) pi = pi > 0 ? pi - 1 : 0;
  }
  *out_len = len;
  *out_start_text = ti;
  *out_start_pattern = pi;
  std::reverse(out_text, out_text + len);
  std::reverse(out_pattern, out_pattern + len);
}

// ---------------------------------------------------------------------------
// Affine-gap (Gotoh) score-only fill — an extension beyond the linear-gap
// reference: a gap run of length L costs open + (L-1)*extend, so
// open == extend degenerates exactly to the linear engine.  algo: 0
// global, 1 local, 2 semi-global (fit: free text end-gaps as in
// fill_semi, affine pattern gaps).  Score and (for local/semi) the
// best cell, same strict-improvement first-occurrence rule as the
// linear fills (local: row-major over all cells; semi: the last row).
int32_t sa_fill_affine(int32_t algo, const int8_t* text, int64_t n,
                       const int8_t* pattern, int64_t m,
                       const int32_t* score_matrix, int32_t k,
                       int32_t open, int32_t extend, int32_t* out_score,
                       int64_t* out_best) {
  const int64_t cols = n + 1;
  const bool local = algo == 1;
  const bool semi = algo == 2;
  const int32_t kNegInf = -(1 << 29);
  int32_t* h_prev = static_cast<int32_t*>(std::malloc(sizeof(int32_t) * cols));
  int32_t* h_curr = static_cast<int32_t*>(std::malloc(sizeof(int32_t) * cols));
  int32_t* f_row = static_cast<int32_t*>(std::malloc(sizeof(int32_t) * cols));
  if (!h_prev || !h_curr || !f_row) {
    std::free(h_prev);
    std::free(h_curr);
    std::free(f_row);
    return 1;
  }
  for (int64_t j = 0; j < cols; ++j) {
    h_curr[j] =
        (local || semi)
            ? 0
            : (j == 0 ? 0 : static_cast<int32_t>(-open - (j - 1) * extend));
    f_row[j] = kNegInf;
  }
  int32_t max_score = 0;
  int64_t max_idx = 0;
  for (int64_t i = 1; i <= m; ++i) {
    std::swap(h_prev, h_curr);
    h_curr[0] =
        local ? 0 : static_cast<int32_t>(-open - (i - 1) * extend);
    int32_t e = kNegInf;
    const int32_t* sub_row =
        score_matrix + static_cast<int64_t>(pattern[i - 1]) * k;
    for (int64_t j = 1; j < cols; ++j) {
      e = std::max(e - extend, h_curr[j - 1] - open);
      f_row[j] = std::max(f_row[j] - extend, h_prev[j] - open);
      int32_t h = std::max(h_prev[j - 1] + sub_row[text[j - 1]],
                           std::max(e, f_row[j]));
      if (local) {
        h = std::max(h, 0);
        if (h > max_score) {
          max_score = h;
          max_idx = i * cols + j;
        }
      }
      h_curr[j] = h;
    }
  }
  if (semi) {
    // First occurrence over the last row, j >= 1 (as fill_semi).
    int64_t arg = n >= 1 ? 1 : 0;
    max_score = h_curr[arg];
    for (int64_t j = arg + 1; j < cols; ++j) {
      if (h_curr[j] > max_score) {
        max_score = h_curr[j];
        arg = j;
      }
    }
    max_idx = m * cols + arg;
  }
  *out_score = (local || semi) ? max_score : h_curr[n];
  *out_best = max_idx;
  std::free(h_prev);
  std::free(h_curr);
  std::free(f_row);
  return 0;
}

// Affine-gap full alignment (score + traceback).  Three-state Gotoh
// walk over full H/E/F matrices (12 bytes/cell — the affine CPU path
// caps out earlier than the 1-byte linear matrix).  algo: 0 global,
// 1 local, 2 semi-global (fit: free text end-gaps, best last-row cell,
// walk stops on row 0 — as sa_traceback_semi).  Tie policy, defined
// by this oracle (no reference analog): in state H a gap state wins
// unless the diagonal is strictly greater, E (LEFT) beating F (TOP) on
// ties — mirroring the linear policy; inside a gap state, ties between
// extending and closing the run close it (switch back to H).
int32_t sa_align_affine(int32_t algo, const int8_t* text, int64_t n,
                        const int8_t* pattern, int64_t m,
                        const int32_t* score_matrix, int32_t k,
                        int32_t open, int32_t extend, uint8_t* out_text,
                        uint8_t* out_pattern, int64_t* out_len,
                        int64_t* out_start_text, int64_t* out_start_pattern,
                        int32_t* out_score) {
  const int64_t cols = n + 1;
  const bool local = algo == 1;
  const bool semi = algo == 2;
  const int32_t kNegInf = -(1 << 29);
  const int64_t cells = (m + 1) * cols;
  int32_t* H = static_cast<int32_t*>(std::malloc(sizeof(int32_t) * cells));
  int32_t* E = static_cast<int32_t*>(std::malloc(sizeof(int32_t) * cells));
  int32_t* F = static_cast<int32_t*>(std::malloc(sizeof(int32_t) * cells));
  if (!H || !E || !F) {
    std::free(H);
    std::free(E);
    std::free(F);
    return 1;
  }
  H[0] = 0;
  for (int64_t j = 1; j <= n; ++j) {
    H[j] = (local || semi)
               ? 0
               : static_cast<int32_t>(-open - (j - 1) * extend);
    E[j] = kNegInf;
    F[j] = kNegInf;
  }
  E[0] = kNegInf;
  F[0] = kNegInf;
  int32_t max_score = 0;
  int64_t max_i = 0, max_j = 0;
  for (int64_t i = 1; i <= m; ++i) {
    int32_t* h = H + i * cols;
    int32_t* e = E + i * cols;
    int32_t* f = F + i * cols;
    const int32_t* hp = H + (i - 1) * cols;
    const int32_t* fp = F + (i - 1) * cols;
    h[0] = local ? 0 : static_cast<int32_t>(-open - (i - 1) * extend);
    e[0] = kNegInf;
    f[0] = kNegInf;
    const int32_t* sub_row =
        score_matrix + static_cast<int64_t>(pattern[i - 1]) * k;
    for (int64_t j = 1; j <= n; ++j) {
      e[j] = std::max(e[j - 1] - extend, h[j - 1] - open);
      f[j] = std::max(fp[j] - extend, hp[j] - open);
      int32_t v = std::max(hp[j - 1] + sub_row[text[j - 1]],
                           std::max(e[j], f[j]));
      if (local) {
        v = std::max(v, 0);
        if (v > max_score) {
          max_score = v;
          max_i = i;
          max_j = j;
        }
      }
      h[j] = v;
    }
  }

  if (semi) {
    // First occurrence over the last row, j >= 1 (as fill_semi).
    const int32_t* last = H + m * cols;
    max_j = n >= 1 ? 1 : 0;
    max_score = last[max_j];
    for (int64_t j = max_j + 1; j <= n; ++j) {
      if (last[j] > max_score) {
        max_score = last[j];
        max_j = j;
      }
    }
    max_i = m;
  }
  int64_t i = (local || semi) ? max_i : m;
  int64_t j = (local || semi) ? max_j : n;
  *out_score = (local || semi) ? max_score : H[m * cols + n];
  int64_t len = 0;
  int state = 0;  // 0 = H, 1 = E (LEFT run), 2 = F (TOP run)
  while (true) {
    if (state == 0) {
      if (local && (i == 0 || j == 0 || H[i * cols + j] == 0)) break;
      if (semi && i == 0) break;
      if (!local && i == 0 && j == 0) break;
      uint8_t dir;
      if (j == 0) {
        dir = kTop;
      } else if (i == 0) {
        dir = kLeft;
      } else {
        const int32_t v = H[i * cols + j];
        const int32_t gap_best =
            std::max(E[i * cols + j], F[i * cols + j]);
        const int32_t diag =
            H[(i - 1) * cols + (j - 1)] +
            score_matrix[static_cast<int64_t>(pattern[i - 1]) * k +
                         text[j - 1]];
        if (diag == v && diag > gap_best) {
          dir = kDiag;
        } else if (E[i * cols + j] == v) {
          state = 1;
          continue;
        } else if (F[i * cols + j] == v) {
          state = 2;
          continue;
        } else {
          dir = kDiag;  // diag == v tie with a gap state below it
        }
      }
      emit(text, pattern, k, dir, j - 1, i - 1, out_text, out_pattern,
           len++);
      if (dir == kDiag || dir == kLeft) --j;
      if (dir == kDiag || dir == kTop) --i;
    } else if (state == 1) {
      emit(text, pattern, k, kLeft, j - 1, i - 1, out_text, out_pattern,
           len++);
      const int32_t v = E[i * cols + j];
      --j;
      // Close the run on ties (prefer H) — our documented policy.
      if (j > 0 && H[i * cols + j] - open == v) {
        state = 0;
      } else if (j > 0 && E[i * cols + j] - extend == v) {
        state = 1;
      } else {
        state = 0;
      }
    } else {
      emit(text, pattern, k, kTop, j - 1, i - 1, out_text, out_pattern,
           len++);
      const int32_t v = F[i * cols + j];
      --i;
      if (i > 0 && H[i * cols + j] - open == v) {
        state = 0;
      } else if (i > 0 && F[i * cols + j] - extend == v) {
        state = 2;
      } else {
        state = 0;
      }
    }
  }
  *out_len = len;
  *out_start_text = j > 0 ? j : 0;
  *out_start_pattern = i > 0 ? i : 0;
  std::reverse(out_text, out_text + len);
  std::reverse(out_pattern, out_pattern + len);
  std::free(H);
  std::free(E);
  std::free(F);
  return 0;
}

// ---------------------------------------------------------------------------
// Checkpointed-traceback support (ops/checkpoint.py): very long pairs
// are filled score-only with tile boundary checkpoints; the traceback
// re-fills only the tiles the optimal path crosses (directions are
// recomputed exactly, so alignments stay byte-identical).  These two
// helpers walk one recomputed tile and replay the accumulated move list
// with the exact cursor semantics of the full packed walks above.

// Walk packed tile directions from global cell (*io_i, *io_j) while it
// stays inside the tile (rows row_lo+1.., columns col_lo+1..; words are
// in tile-local coordinates with row stride p_cols).  Moves are
// appended in walk (end-to-start) order.  Local mode stops at a STOP
// direction or on reaching the global first row/column (the reference's
// loop structure, alignSequenceCPU.cpp:19,44-46) and sets *out_done.
// Returns the number of moves emitted.
int64_t sa_walk_packed_window(const int32_t* words, int64_t p_cols,
                              int64_t row_lo, int64_t col_lo,
                              int32_t local, int64_t* io_i, int64_t* io_j,
                              uint8_t* out_moves, int64_t cap,
                              int32_t* out_done) {
  int64_t i = *io_i;
  int64_t j = *io_j;
  int64_t len = 0;
  *out_done = 0;
  // cap bounds the buffer against malformed words (a STOP direction in
  // global mode moves neither cursor; valid fills never produce one).
  while (i > row_lo && j > col_lo && len < cap) {
    const uint8_t dir = packed_dir(words, p_cols, i - row_lo, j - col_lo);
    if (local && dir == kStop) {
      *out_done = 1;
      break;
    }
    out_moves[len++] = dir;
    if (dir == kDiag || dir == kLeft) --j;
    if (dir == kDiag || dir == kTop) --i;
    if (local && (i == 0 || j == 0)) {
      *out_done = 1;
      break;
    }
  }
  *io_i = i;
  *io_j = j;
  return len;
}

// sa_walk_packed_window over the wavefront kernel's *skewed* word format
// (one re-filled tile, words in tile-local coordinates; see skewed_dir).
int64_t sa_walk_skewed_window(const int32_t* words, int64_t rps,
                              int64_t slots, int64_t row_lo, int64_t col_lo,
                              int32_t local, int64_t* io_i, int64_t* io_j,
                              uint8_t* out_moves, int64_t cap,
                              int32_t* out_done) {
  int64_t i = *io_i;
  int64_t j = *io_j;
  int64_t len = 0;
  *out_done = 0;
  while (i > row_lo && j > col_lo && len < cap) {
    const uint8_t dir =
        skewed_dir(words, 0, rps, slots, i - row_lo, j - col_lo);
    if (local && dir == kStop) {
      *out_done = 1;
      break;
    }
    out_moves[len++] = dir;
    if (dir == kDiag || dir == kLeft) --j;
    if (dir == kDiag || dir == kTop) --i;
    if (local && (i == 0 || j == 0)) {
      *out_done = 1;
      break;
    }
  }
  *io_i = i;
  *io_j = j;
  return len;
}

// Replay a move list recorded in walk (end-to-start) order starting at
// cell (start_i, start_j), emitting aligned characters with the same
// cursor/clamp semantics as sa_traceback_nw_packed / _sw_packed (for
// global replays the forced first-row/column moves must already be in
// the list).
void sa_emit_moves(const uint8_t* moves, int64_t len, int64_t start_i,
                   int64_t start_j, int32_t local, const int8_t* text,
                   const int8_t* pattern, int32_t k, uint8_t* out_text,
                   uint8_t* out_pattern, int64_t* out_len,
                   int64_t* out_start_text, int64_t* out_start_pattern) {
  int64_t i = start_i;
  int64_t j = start_j;
  int64_t ti = start_j - 1;
  int64_t pi = start_i - 1;
  for (int64_t p = 0; p < len; ++p) {
    const uint8_t dir = moves[p];
    emit(text, pattern, k, dir, ti, pi, out_text, out_pattern, p);
    if (local) {
      if (dir == kDiag || dir == kLeft) --j;
      if (dir == kDiag || dir == kTop) --i;
      if (j == 0 || i == 0) break;  // final hop: cursors stay (reference)
      if (dir == kDiag || dir == kLeft) ti = ti > 0 ? ti - 1 : 0;
      if (dir == kDiag || dir == kTop) pi = pi > 0 ? pi - 1 : 0;
    } else {
      if (dir == kDiag || dir == kLeft) ti = ti > 0 ? ti - 1 : 0;
      if (dir == kDiag || dir == kTop) pi = pi > 0 ? pi - 1 : 0;
    }
  }
  *out_len = len;
  *out_start_text = ti;
  *out_start_pattern = pi;
  std::reverse(out_text, out_text + len);
  std::reverse(out_pattern, out_pattern + len);
}

// Batched replay of per-pair 2-bit packed move lists (the device
// walkers' output layout: move p of a pair sits at bits 2*(p%16) of its
// word p/16) into aligned index arrays — one call per bucket instead of
// one ctypes round trip per pair, which dominated the end-to-end batch
// wall (~106 us/pair of Python/ctypes vs ~1 us/pair here).
//
// mode 0: global (NW) replay — clamped emit cursors, full move list
//   (matches sa_emit_moves local=0; forced first-row/column moves are
//   already in the list, reference alignSequenceCPU.cpp:77-81).
// mode 1: local (SW) replay — early exit when a move lands the walk
//   cursor on the first row/column, with the final hop's emit cursors
//   left un-decremented (matches sa_emit_moves local=1 and the
//   reference's traceBackSW cursor quirk, alignSequenceCPU.cpp:44-46).
// mode 2: affine replay — straight cursor walk with no clamp quirks,
//   start offsets = final cursors floored at 0 (the affine oracle's
//   emission semantics, sa_align_affine).
//
// packed is pair-major (b x words_per_pair) int32; texts/patterns are
// padded row-major int8 letter matrices with the given strides; the
// aligned outputs land reversed-in-place (start-to-end order) in
// (b x out_stride) uint8 rows, lengths in lens (unchanged), start
// offsets in out_start_text / out_start_pattern.
void sa_emit_moves_batch(const int32_t* packed, int64_t words_per_pair,
                         const int32_t* lens, const int32_t* start_is,
                         const int32_t* start_js, int32_t mode,
                         const int8_t* texts, int64_t text_stride,
                         const int8_t* patterns, int64_t pattern_stride,
                         int32_t k, int64_t b, int64_t out_stride,
                         uint8_t* out_text, uint8_t* out_pattern,
                         int32_t* out_start_text,
                         int32_t* out_start_pattern) {
  for (int64_t row = 0; row < b; ++row) {
    const int32_t* words = packed + row * words_per_pair;
    const int8_t* text = texts + row * text_stride;
    const int8_t* pattern = patterns + row * pattern_stride;
    uint8_t* ot = out_text + row * out_stride;
    uint8_t* op = out_pattern + row * out_stride;
    const int64_t len = lens[row];
    int64_t i = start_is[row];
    int64_t j = start_js[row];
    if (mode == 2) {
      for (int64_t p = 0; p < len; ++p) {
        const uint8_t dir = (words[p >> 4] >> (2 * (p & 15))) & 3;
        const bool take_t = dir != kTop;
        const bool take_p = dir != kLeft;
        ot[p] = take_t ? static_cast<uint8_t>(text[j > 0 ? j - 1 : 0])
                       : static_cast<uint8_t>(k);
        op[p] = take_p ? static_cast<uint8_t>(pattern[i > 0 ? i - 1 : 0])
                       : static_cast<uint8_t>(k);
        j -= take_t;
        i -= take_p;
      }
      out_start_text[row] = static_cast<int32_t>(j > 0 ? j : 0);
      out_start_pattern[row] = static_cast<int32_t>(i > 0 ? i : 0);
    } else {
      int64_t ti = j - 1;
      int64_t pi = i - 1;
      for (int64_t p = 0; p < len; ++p) {
        const uint8_t dir = (words[p >> 4] >> (2 * (p & 15))) & 3;
        emit(text, pattern, k, dir, ti, pi, ot, op, p);
        if (mode == 1) {
          if (dir == kDiag || dir == kLeft) --j;
          if (dir == kDiag || dir == kTop) --i;
          if (j == 0 || i == 0) break;  // final hop: cursors stay
        }
        if (dir == kDiag || dir == kLeft) ti = ti > 0 ? ti - 1 : 0;
        if (dir == kDiag || dir == kTop) pi = pi > 0 ? pi - 1 : 0;
      }
      out_start_text[row] = static_cast<int32_t>(ti);
      out_start_pattern[row] = static_cast<int32_t>(pi);
    }
    std::reverse(ot, ot + len);
    std::reverse(op, op + len);
  }
}

}  // extern "C"
