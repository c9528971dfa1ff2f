// K5: prefix-max fill of one region of the DP matrix (a block of rows x
// one column strip), linear gaps, global or local.
//
// Replaces seqalign_tpu/ops/pallas_fill.py::_strip_kernel (launched by
// strip_fill_pallas; wrapped by pair_fill_pallas, looped by
// ops/tiled.py::tiled_fill).
//
// Semantics (identical to the TPU kernel).  Row i = row_base + rr + 1 of
// the region, over the strip's columns j = strip_off + 1 .. strip_off + W:
//   diag = S[i-1, j-1] + sub(pat[rr], text[j])   (PAD_SCORE past column n;
//          S[i-1, strip_off] is left_col[rr])
//   top  = S[i-1, j] - g,  tmp = max(diag, top)  (local: max(tmp, 0))
//   S[i, j] = max over k <= j of (tmp[k] + g k), with the left boundary
//          left_col[rr+1] + g strip_off in front, minus g j.
// The 2-bit direction under the reference's tie policy: left = S[i, j-1]
// - g, gap_best = max(left, top); DIAG (1) if diag > gap_best, else LEFT
// (0) if left >= top, else TOP (2); local: STOP (3) when max(diag,
// gap_best) <= 0.  Row rr's direction sits at bits 2*(rr%16) of word
// (rr/16, column).  rcol[rr] is the strip's last column.  Local: the best
// moves only on a row maximum over columns <= n strictly above it, for
// i <= m, to (i, the first column of that maximum).  Global: at i == m
// the score becomes max(score, S[m, n]) when the strip holds column n.
// Rows past m and columns past n are computed and written like the rest.
//
// What bounds it on an H100: every row depends on the one above and every
// cell of a row on the cells to its left, so one region is one chain of
// rows through one CTA on one SM; the operations per cell (about 21 with
// words, 13 score-only) on that SM's 64 int32 lanes, and two barriers a
// row, bound it.  The bytes (the words, 2 bits a cell) are small.
//
// What the design does about it: each thread owns a contiguous run of CPT
// columns (16, 32 or 64; up to 1024 threads) and keeps the row above in
// registers.  A row takes two passes over the run: the first reduces the
// run's prefix-max input to one value, a block-wide exclusive max-scan
// (warp shuffles and one array of 32 warp totals) gives each thread the
// chain's value at its left edge, and the second pass recomputes the
// cells with that carry, the directions and the best.  The left neighbour
// of a thread's first column in the new row is the carry itself less
// g (j-1), so no value crosses threads otherwise.  The text letters (in a
// [column of run][thread] layout) and the (k+1)-wide substitution rows,
// the last entry PAD_SCORE for columns past n, sit in shared memory; the
// pattern and the left column are staged 128 rows at a time.  Direction
// words are gathered as 16-bit halves (8 rows) in shared memory
// ([column of run][thread], one padding pair a column against bank
// conflicts), at most 128 KB at 65,536 columns, and written to the words
// in device memory as 16-bit stores, coalesced, every 8 rows.  Offsets
// into the words are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "launch_error.cuh"

namespace {

constexpr int32_t kPadScore = -(1 << 24);
constexpr int32_t kMin = INT32_MIN;  // identity of max
constexpr int kMaxThreads = 1024;
constexpr int kStage = 128;          // rows of pattern / left column staged
constexpr int kMaxK = 32;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int text_bytes(int cpt, int tp) {
  return cpt * tp;
}

__host__ __device__ constexpr int slab_bytes(int cpt, int tp) {
  return cpt * (tp + 2) * 2;
}

template <int CPT, bool LOCAL, bool DIRS>
__global__ void __launch_bounds__(kMaxThreads, 1) strip_fill_kernel(
    const int8_t* __restrict__ text, const int32_t* __restrict__ pattern,
    const int32_t* __restrict__ sm, int k, int g, int n, int m,
    int row_base, int strip_off, int w, int rows,
    const int32_t* __restrict__ left_col,
    const int32_t* __restrict__ prev_in,
    const int32_t* __restrict__ state_in, int32_t* __restrict__ words,
    int32_t* __restrict__ state_out, int32_t* __restrict__ prev_out,
    int32_t* __restrict__ rcol) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ int32_t sm_s[kMaxK * (kMaxK + 1)];
  __shared__ int32_t pat_s[kStage];
  __shared__ int32_t lc_s[kStage + 1];
  __shared__ int32_t wtot[kMaxThreads / 32];
  __shared__ long long wkey[kMaxThreads / 32];
  __shared__ int32_t score_s;

  const int t = threadIdx.x;
  const int tp = blockDim.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = tp >> 5;
  const int owners = w / CPT;
  const bool owns = t < owners;
  const int kp = k + 1;
  int8_t* text_s = reinterpret_cast<int8_t*>(dyn);
  uint16_t* slab =
      reinterpret_cast<uint16_t*>(dyn + ((text_bytes(CPT, tp) + 15) & ~15));

  for (int e = t; e < k * kp; e += tp) {
    const int a = e / kp;
    const int b = e - a * kp;
    sm_s[e] = b < k ? sm[a * k + b] : kPadScore;
  }
  for (int col = t; col < w; col += tp) {
    const int owner = col / CPT;
    const int c = col - owner * CPT;
    text_s[c * tp + owner] =
        strip_off + col + 1 <= n ? text[col] : static_cast<int8_t>(k);
  }
  if (t == 0) score_s = state_in[3];

  const int c0 = t * CPT;
  const int32_t gj0 = g * (strip_off + c0 + 1);
  // Columns c < climit of the run are <= n (local best).
  const int climit = n - (strip_off + c0);
  int32_t h[CPT];
  int32_t leftprev = 0;
  if (owns) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) h[c] = prev_in[c0 + c];
    leftprev = t == 0 ? left_col[0] : prev_in[c0 - 1];
  }
  int32_t best = state_in[0];
  int32_t bi = state_in[1];
  int32_t bj = state_in[2];

  for (int rr = 0; rr < rows; ++rr) {
    const int sr = rr & (kStage - 1);
    if (sr == 0) {
      for (int e = t; e <= kStage; e += tp) {
        if (e < kStage) pat_s[e] = pattern[rr + e];
        lc_s[e] = left_col[rr + e];
      }
      __syncthreads();
    }
    const int i = row_base + rr + 1;
    const int32_t* smrow = sm_s + pat_s[sr] * kp;
    const int32_t boundary = lc_s[sr + 1] + g * strip_off;

    // Pass 1: the run's largest prefix-max input tmp + g j.
    int32_t run = kMin;
    if (owns) {
      int32_t ol = leftprev;
      int32_t gj = gj0;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int32_t s = smrow[text_s[c * tp + t]];
        const int32_t o = h[c];
        const int32_t tmp = LOCAL ? __viaddmax_s32_relu(ol, s, o - g)
                                  : __viaddmax_s32(ol, s, o - g);
        run = __viaddmax_s32(tmp, gj, run);
        gj += g;
        ol = o;
      }
    }
    // Block-wide exclusive max-scan of the runs.
    int32_t v = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t u = __shfl_up_sync(kFull, v, o);
      if (lane >= o) v = max(v, u);
    }
    int32_t excl = __shfl_up_sync(kFull, v, 1);
    if (lane == 0) excl = kMin;
    if (lane == 31) wtot[warp] = v;
    __syncthreads();
    int32_t wp = lane < warp ? wtot[lane] : kMin;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      wp = max(wp, __shfl_xor_sync(kFull, wp, o));
    }
    excl = max(max(excl, wp), boundary);

    // Pass 2: the row with the carry, its directions and its best.
    int32_t rmax = kMin;
    int32_t rj = 0;
    if (owns) {
      int32_t carry = excl;
      int32_t ol = leftprev;
      int32_t gj = gj0;
      int32_t lv = excl - (gj0 - g);  // S[i, strip_off + c0]
      leftprev = lv;
      const int r8 = rr & 7;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int32_t s = smrow[text_s[c * tp + t]];
        const int32_t o = h[c];
        const int32_t diag = ol + s;
        const int32_t top = o - g;
        int32_t tmp = max(diag, top);
        if (LOCAL) tmp = max(tmp, 0);
        carry = __viaddmax_s32(tmp, gj, carry);
        const int32_t cell = carry - gj;
        if (DIRS) {
          const int32_t left = lv - g;
          const int32_t gap_best = max(left, top);
          uint32_t d = diag > gap_best ? 1u : (left >= top ? 0u : 2u);
          if (LOCAL && max(diag, gap_best) <= 0) d = 3u;
          uint16_t* at = slab + c * (tp + 2) + t;
          uint32_t bits = d << (2 * r8);
          if (r8) bits |= *at;
          *at = static_cast<uint16_t>(bits);
        }
        if (LOCAL && c < climit && cell > rmax) {
          rmax = cell;
          rj = strip_off + c0 + c + 1;
        }
        h[c] = cell;
        ol = o;
        lv = cell;
        gj += g;
      }
      if (t == owners - 1) rcol[rr] = h[CPT - 1];
      if (!LOCAL && i == m) {
        const int cn = n - strip_off - 1 - c0;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          if (c == cn) score_s = max(score_s, h[c]);
        }
      }
    }
    long long key = 0;
    if (LOCAL) {
      // Largest value, then the smallest column, of the row.
      key = static_cast<long long>(
                static_cast<unsigned long long>(static_cast<uint32_t>(rmax))
                << 32) |
            static_cast<uint32_t>(0x7fffffff - rj);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        key = max(key, __shfl_xor_sync(kFull, key, o));
      }
      if (lane == 0) wkey[warp] = key;
    }
    __syncthreads();
    if (LOCAL) {
      key = lane < nwarps ? wkey[lane] : LLONG_MIN;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        key = max(key, __shfl_xor_sync(kFull, key, o));
      }
      const int32_t rm = static_cast<int32_t>(key >> 32);
      if (rm > best && i <= m) {
        best = rm;
        bi = i;
        bj = 0x7fffffff - static_cast<int32_t>(key & 0xffffffffll);
      }
    }
    if (DIRS && (rr & 7) == 7) {
      // Flush 8 rows: the low (rows 0-7) or high half of word row rr/16.
      uint16_t* out = reinterpret_cast<uint16_t*>(words);
      const int64_t base = static_cast<int64_t>(rr >> 4) * w;
      const int half = (rr >> 3) & 1;
      for (int col = t; col < w; col += tp) {
        const int owner = col / CPT;
        const int c = col - owner * CPT;
        out[(base + col) * 2 + half] = slab[c * (tp + 2) + owner];
      }
    }
  }
  if (owns) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) prev_out[c0 + c] = h[c];
  }
  __syncthreads();
  if (t == 0) {
    state_out[0] = best;
    state_out[1] = bi;
    state_out[2] = bj;
    state_out[3] = score_s;
  }
}

template <int CPT, bool LOCAL, bool DIRS>
cudaError_t launch(int tp, cudaStream_t s, const int8_t* text,
                   const int32_t* pattern, const int32_t* sm, int k, int g,
                   int n, int m, int row_base, int strip_off, int w,
                   int rows, const int32_t* left_col, const int32_t* prev_in,
                   const int32_t* state_in, int32_t* words,
                   int32_t* state_out, int32_t* prev_out, int32_t* rcol) {
  const int bytes = ((text_bytes(CPT, tp) + 15) & ~15) +
                    (DIRS ? slab_bytes(CPT, tp) : 0);
  auto kernel = strip_fill_kernel<CPT, LOCAL, DIRS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<1, tp, bytes, s>>>(text, pattern, sm, k, g, n, m, row_base,
                              strip_off, w, rows, left_col, prev_in,
                              state_in, words, state_out, prev_out, rcol);
  return cudaGetLastError();
}

template <int CPT>
cudaError_t dispatch(bool local, bool dirs, int tp, cudaStream_t s,
                     const int8_t* text, const int32_t* pattern,
                     const int32_t* sm, int k, int g, int n, int m,
                     int row_base, int strip_off, int w, int rows,
                     const int32_t* left_col, const int32_t* prev_in,
                     const int32_t* state_in, int32_t* words,
                     int32_t* state_out, int32_t* prev_out, int32_t* rcol) {
#define SA_STRIP_ARGS                                                     \
  tp, s, text, pattern, sm, k, g, n, m, row_base, strip_off, w, rows,    \
      left_col, prev_in, state_in, words, state_out, prev_out, rcol
  if (local) {
    return dirs ? launch<CPT, true, true>(SA_STRIP_ARGS)
                : launch<CPT, true, false>(SA_STRIP_ARGS);
  }
  return dirs ? launch<CPT, false, true>(SA_STRIP_ARGS)
              : launch<CPT, false, false>(SA_STRIP_ARGS);
#undef SA_STRIP_ARGS
}

}  // namespace

// Fills one region.  text: (w,) int8 letters of the strip's columns (any
// letter in 0..k-1 past n); pattern: (rows,) int32 letters in 0..k-1;
// sm: (k, k) int32; left_col: (rows + 1,); prev_in: (w,) the row above;
// state_in: (4,) [best, best_i, best_j, score].  words: (rows/16, w)
// int32, or null for the score-only fill; state_out (4,), prev_out (w,),
// rcol (rows,).  w is a multiple of 1024 up to 65,536; rows a multiple
// of 128.  Returns the launch's cudaError_t.
extern "C" int sa_strip_fill(const int8_t* text, const int32_t* pattern,
                             const int32_t* sm, int k, int gap, int n, int m,
                             int row_base, int strip_off, int w, int rows,
                             const int32_t* left_col, const int32_t* prev_in,
                             const int32_t* state_in, int local,
                             int32_t* words, int32_t* state_out,
                             int32_t* prev_out, int32_t* rcol, void* stream) {
  if (k < 1 || k > kMaxK || w < 1024 || w % 1024 || w > 65536 ||
      rows < kStage || rows % kStage) {
    return cudaErrorInvalidValue;
  }
  int cpt = 16;
  while (cpt * kMaxThreads < w) cpt *= 2;
  const int tp = (w / cpt + 31) / 32 * 32;
  const bool dirs = words != nullptr;
  auto s = static_cast<cudaStream_t>(stream);
#define SA_STRIP_CALL(CPT)                                                 \
  dispatch<CPT>(local != 0, dirs, tp, s, text, pattern, sm, k, gap, n, m, \
                row_base, strip_off, w, rows, left_col, prev_in, state_in, \
                words, state_out, prev_out, rcol)
  if (cpt == 16) return SA_STRIP_CALL(16);
  if (cpt == 32) return SA_STRIP_CALL(32);
  return SA_STRIP_CALL(64);
#undef SA_STRIP_CALL
}
