// K1: skewed-wavefront fill of one strip of rps*slots DP rows, for linear
// or affine (Gotoh) gap costs: with the 2-bit skewed direction words, or
// score-only; with column checkpoints; from the arithmetic column-0
// boundary or from a given left boundary column.
//
// Replaces seqalign_tpu/ops/wavefront.py::_wavefront_kernel (launched by
// wavefront_strip), in its global / local / semi-global modes, linear and
// affine, with and without dirs, ckpt_every and left_in.
//
// Semantics (identical to the TPU kernel, cell for cell): slot s owns DP
// rows i0+rps*s+1 .. i0+rps*s+rps and at sweep step t computes column
// j = t-s+1 of all of them.  Slots the wave has not reached (j < 1) keep
// their left boundary column in their state: S[i, 0] of the arithmetic
// boundary, or left_in (the checkpoint engine's tile re-fill, whose
// columns are relative to the tile's first column).  Word (t/16)*rps + r,
// column s, holds the direction of step t of slot s's row r at bits
// 2*(t%16): LEFT 0, DIAG 1, TOP 2, STOP 3.  DIAG wins only when strictly
// greater than the best gap move, LEFT beats TOP on ties, local marks
// STOP where the best move is <= 0.  Local tracks every row's running
// maximum and first best column; semi-global runs the global recurrence
// (the caller passes a zero top row) and tracks row m only; global keeps
// S[m, n] in the snap of the slot owning row m.  The last slot's last
// row streams out once per step (the next strip's top row).  A launch
// with ckpt_every = C > 0 is the score-only variant, which stores no
// words and keeps column checkpoints instead: ckpts row q*rps + r,
// column s holds S[i0+rps*s+r+1, (q+1)*C]; entries of columns the slot
// does not reach within the strip's steps keep what the caller put
// there (the wrapper zeroes them).  ckpt_every = 0 stores the words.
//
// Affine (gap = the open cost, ext the extend cost; a run of L gaps costs
// gap + (L-1)*ext): E (the LEFT run) carries along each row, F (the TOP
// run) down each column, e = max(E - ext, left - gap), f = max(F_above -
// ext, top - gap), and the gap move is max(e, f); LEFT wins over TOP when
// e >= f.  E and F start at NEG_HALF = -(1 << 29), which survives
// repeated extends.  The column-0 boundary is H[i, 0] = -(gap + (i-1)*ext)
// and H[0, 0] = 0.  Slots the wave has not reached pass F from above
// unchanged and keep E.  F crosses slots like H: a slot's last-row F goes
// to the next slot, slot 0 reads fbot_in, and the last slot's streams out
// as fbot_out.  A second word plane, dirs2, holds the run bits of each
// cell: bit 0 when extending E strictly beats opening it, bit 1 the same
// for F (ties close the run).  The score-only variant keeps E's column
// checkpoints beside H's (ckpts_e, captured after E's update); left_e
// gives a left column's E beside left_in.
//
// What bounds it on an H100: the DP is a chain of dependent integer
// max/add/select operations, about 10 per cell with words and 4 for the
// score alone (affine: about 19 and 9), with no tensor-core form; the
// 2-bit words are the only bytes it must write (a quarter of a byte per
// cell, half a byte affine; the checkpoints are 4 or 8 bytes per C
// cells), so the int32 issue rate bounds it, not memory.  This first
// design runs one block on one SM (no inter-block protocol), so it
// reaches at most 1/132 of the card's integer rate.
//
// What the design does about it: one block of min(slots, 1024) threads;
// thread p owns slots p, p+B, p+2B, ... (B = blockDim), so each thread
// holds rps*slots/B cells of H (and E) and their word accumulators in
// registers and consecutive threads store consecutive words.  The only
// values that cross slots, a slot's last row of H (and F), go through
// double-buffered shared arrays, so one __syncthreads() per step is the
// whole protocol.  The substitution matrix and a window of the text and
// of the top-row streams are staged in shared memory; the affine
// variants' F arrays take 34 KB of dynamic shared memory beyond the
// linear 46 KB of static arrays, past the 48 KB a block gets without
// opting in.  At rps*slots/B = 64 cells per thread (rps 16, slots 4096)
// the state exceeds the 64 registers a 1024-thread block allows, and the
// compiler spills to local memory; the score-only variant (a template
// parameter) keeps no word accumulators, and the linear variants (the
// template parameter AFFINE) keep no E.  The TPU captures checkpoints
// into vector scratch and flushes them once per word group because it
// cannot scatter; here a thread stores its slot's rps values straight to
// global memory at the step its slot reaches a checkpoint column.  Only
// the score-only variant has that test in its loop (no caller wants
// checkpoints with words, nor a score alone without them), so the
// variant with words keeps the registers it had without checkpoints.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_error.cuh"

namespace {

constexpr int32_t kNegInf = -(1 << 30);
constexpr int32_t kNegHalf = kNegInf / 2;  // affine E/F "minus infinity"
constexpr int kTextRing = 8192;    // bytes; >= slots + 512 for slots <= 4096
constexpr int kBottomRing = 512;   // >= 2 prefetch chunks
constexpr int kChunk = 256;        // prefetch granularity (steps)
constexpr int kMaxSlots = 4096;
constexpr int kMaxAlpha = 32;
// Dynamic shared memory of the affine variants: the last rows' F,
// double-buffered, then the ring of the F top-row stream.
constexpr int kAffineSmemBytes = (2 * kMaxSlots + kBottomRing) * 4;

template <int RPS, int SPT, bool TRACK, bool DIRS, bool AFFINE>
__global__ void __launch_bounds__(1024)
wavefront_strip_kernel(const int32_t* __restrict__ text,
                       const int32_t* __restrict__ bottom_in,
                       const int32_t* __restrict__ fbot_in,
                       const int32_t* __restrict__ pattern,
                       const int32_t* __restrict__ score_matrix,
                       const int32_t* __restrict__ left_in,
                       const int32_t* __restrict__ left_e,
                       int32_t* __restrict__ dirs,
                       int32_t* __restrict__ dirs2,
                       int32_t* __restrict__ bottom_out,
                       int32_t* __restrict__ fbot_out,
                       int32_t* __restrict__ rowmax,
                       int32_t* __restrict__ argj,
                       int32_t* __restrict__ snap,
                       int32_t* __restrict__ ckpts,
                       int32_t* __restrict__ ckpts_e,
                       int steps, int slots, int k, int gap, int ext, int n,
                       int m, int i0, int local, int ckpt_every) {
  __shared__ uint8_t text_ring[kTextRing];
  __shared__ int32_t bottom_ring[kBottomRing];
  __shared__ int32_t last_row[2][kMaxSlots];
  __shared__ int32_t sub[kMaxAlpha * kMaxAlpha];
  extern __shared__ int32_t affine_smem[];  // AFFINE only
  int32_t* const last_f = affine_smem;      // [2][kMaxSlots]
  int32_t* const fbot_ring = affine_smem + 2 * kMaxSlots;

  const int p = threadIdx.x;
  const int B = blockDim.x;
  // Checkpoint column j = (q+1)*C is captured when j & ckpt_mask == 0.
  const int ckpt_mask = DIRS ? -1 : ckpt_every - 1;
  const int ckpt_shift = DIRS ? 0 : __ffs(ckpt_every) - 1;

  for (int x = p; x < k * k; x += B) sub[x] = score_matrix[x];
  for (int x = p; x < kChunk && x < steps; x += B) {
    text_ring[x] = static_cast<uint8_t>(text[x] & (kMaxAlpha - 1));
    bottom_ring[x] = bottom_in[x];
    if (AFFINE) fbot_ring[x] = fbot_in[x];
  }

  int32_t H[SPT][RPS];
  int32_t word[DIRS ? SPT : 1][DIRS ? RPS : 1];
  int32_t E[AFFINE ? SPT : 1][AFFINE ? RPS : 1];
  int32_t word2[AFFINE && DIRS ? SPT : 1][AFFINE && DIRS ? RPS : 1];
  int32_t pat[SPT][RPS];
  int32_t topsh[SPT];
  int32_t best_v[TRACK ? SPT : 1][TRACK ? RPS : 1];
  int32_t best_j[TRACK ? SPT : 1][TRACK ? RPS : 1];
  int32_t snap_v[SPT];

#pragma unroll
  for (int q = 0; q < SPT; ++q) {
    const int s = q * B + p;
    const int ibase = i0 + RPS * s;
    if (left_in != nullptr) {
      topsh[q] = left_in[s];
    } else if (local) {
      topsh[q] = 0;
    } else if (AFFINE) {
      topsh[q] = ibase == 0 ? 0 : -(gap + (ibase - 1) * ext);
    } else {
      topsh[q] = -(gap * ibase);
    }
    snap_v[q] = kNegInf;
#pragma unroll
    for (int r = 0; r < RPS; ++r) {
      if (left_in != nullptr) {
        H[q][r] = left_in[(r + 1) * slots + s];
      } else if (local) {
        H[q][r] = 0;
      } else {
        H[q][r] = AFFINE ? -(gap + (ibase + r) * ext)
                         : -(gap * (ibase + r + 1));
      }
      if (DIRS) word[q][r] = 0;
      if (AFFINE) {
        E[q][r] = left_e != nullptr ? left_e[(r + 1) * slots + s] : kNegHalf;
        if (DIRS) word2[q][r] = 0;
      }
      pat[q][r] = (pattern[r * slots + s] & (kMaxAlpha - 1)) * k;
      if (TRACK) {
        best_v[q][r] = kNegInf;
        best_j[q][r] = 0;
      }
    }
    // Step 0 reads the neighbours' last rows "after step -1": the
    // boundary column, and F's minus infinity.
    last_row[1][s] = H[q][RPS - 1];
    if (AFFINE) last_f[kMaxSlots + s] = kNegHalf;
  }
  __syncthreads();

  for (int t = 0; t < steps; ++t) {
    const int u = t & 15;
    // Prefetch the text and top-row values of steps t+256 .. t+511; the
    // ring slots they overwrite were last read >= 256 steps ago.
    if ((t & (kChunk - 1)) == 0) {
      for (int x = p; x < kChunk; x += B) {
        const int tt = t + kChunk + x;
        if (tt < steps) {
          text_ring[tt & (kTextRing - 1)] =
              static_cast<uint8_t>(text[tt] & (kMaxAlpha - 1));
          bottom_ring[tt & (kBottomRing - 1)] = bottom_in[tt];
          if (AFFINE) fbot_ring[tt & (kBottomRing - 1)] = fbot_in[tt];
        }
      }
    }
    const int32_t* prev_last = last_row[(t + 1) & 1];
    int32_t* cur_last = last_row[t & 1];
    const int32_t* prev_f = last_f + ((t + 1) & 1) * kMaxSlots;
    int32_t* cur_f = last_f + (t & 1) * kMaxSlots;
    int32_t f_stream = 0;  // the last slot's last-row F after this step
#pragma unroll
    for (int q = 0; q < SPT; ++q) {
      const int s = q * B + p;
      const int j = t - s + 1;
      const bool started = j >= 1;
      const int w = t - s >= 0 ? text_ring[(t - s) & (kTextRing - 1)] : 0;
      // The neighbour slot's last row at this column (its value after
      // the previous step), and at the previous column (topsh).
      const int32_t nb_top =
          s == 0 ? bottom_ring[t & (kBottomRing - 1)] : prev_last[s - 1];
      int32_t top = nb_top;
      int32_t diag_src = topsh[q];
      // F of the cell above (affine).
      int32_t f_above = 0;
      if (AFFINE) {
        f_above = s == 0 ? fbot_ring[t & (kBottomRing - 1)] : prev_f[s - 1];
      }
      const int ibase = i0 + RPS * s;
#pragma unroll
      for (int r = 0; r < RPS; ++r) {
        const int32_t diag = diag_src + sub[pat[q][r] + w];
        const int32_t left = H[q][r];
        int32_t gap_best, e_ext = 0, e_open = 0, e_new = 0, f_ext = 0,
                          f_open = 0, f_new = 0;
        if (AFFINE) {
          e_ext = E[q][r] - ext;
          e_open = left - gap;
          e_new = max(e_ext, e_open);
          f_ext = f_above - ext;
          f_open = top - gap;
          f_new = max(f_ext, f_open);
          gap_best = max(e_new, f_new);
        } else {
          gap_best = max(top, left) - gap;
        }
        const int32_t best = max(diag, gap_best);
        const int32_t newval = local ? max(best, 0) : best;
        const int32_t cur = started ? newval : left;
        if (DIRS) {
          const bool left_wins = AFFINE ? e_new >= f_new : left >= top;
          int32_t d = diag > gap_best ? 1 : (left_wins ? 0 : 2);
          if (local && best <= 0) d = 3;
          word[q][r] = u == 0 ? d : (word[q][r] | (d << (2 * u)));
          if (AFFINE) {
            const int32_t d2 = static_cast<int32_t>(e_ext > e_open) |
                               (static_cast<int32_t>(f_ext > f_open) << 1);
            word2[q][r] = u == 0 ? d2 : (word2[q][r] | (d2 << (2 * u)));
          }
        }
        if (AFFINE && started) {
          E[q][r] = e_new;
          f_above = f_new;
        }
        const int i = ibase + r + 1;
        if (TRACK) {
          const bool row_ok = local ? i <= m : i == m;
          if (started && j <= n && row_ok && newval > best_v[q][r]) {
            best_v[q][r] = newval;
            best_j[q][r] = j;
          }
        } else if (i == m && j == n) {
          snap_v[q] = newval;
        }
        diag_src = left;
        top = cur;
        H[q][r] = cur;
      }
      topsh[q] = nb_top;
      cur_last[s] = H[q][RPS - 1];
      if (AFFINE) {
        cur_f[s] = f_above;
        if (q == SPT - 1) f_stream = f_above;
      }
      if (!DIRS && started && (j & ckpt_mask) == 0) {
        const int64_t row0 =
            static_cast<int64_t>((j >> ckpt_shift) - 1) * RPS;
#pragma unroll
        for (int r = 0; r < RPS; ++r) {
          ckpts[(row0 + r) * slots + s] = H[q][r];
          if (AFFINE) ckpts_e[(row0 + r) * slots + s] = E[q][r];
        }
      }
      if (DIRS && u == 15) {
        const int64_t row0 = static_cast<int64_t>(t >> 4) * RPS;
#pragma unroll
        for (int r = 0; r < RPS; ++r) {
          dirs[(row0 + r) * slots + s] = word[q][r];
          if (AFFINE) dirs2[(row0 + r) * slots + s] = word2[q][r];
        }
      }
    }
    if (p == B - 1) {
      bottom_out[t] = H[SPT - 1][RPS - 1];
      if (AFFINE) fbot_out[t] = f_stream;
    }
    __syncthreads();
  }

#pragma unroll
  for (int q = 0; q < SPT; ++q) {
    const int s = q * B + p;
    snap[s] = snap_v[q];
#pragma unroll
    for (int r = 0; r < RPS; ++r) {
      rowmax[r * slots + s] = TRACK ? best_v[q][r] : kNegInf;
      argj[r * slots + s] = TRACK ? best_j[q][r] : 0;
    }
  }
}

struct Args {
  const int32_t* text;
  const int32_t* bottom_in;
  const int32_t* fbot_in;
  const int32_t* pattern;
  const int32_t* score_matrix;
  const int32_t* left_in;
  const int32_t* left_e;
  int32_t* dirs;
  int32_t* dirs2;
  int32_t* bottom_out;
  int32_t* fbot_out;
  int32_t* rowmax;
  int32_t* argj;
  int32_t* snap;
  int32_t* ckpts;
  int32_t* ckpts_e;
  int steps, slots, k, gap, ext, n, m, i0, local, ckpt_every;
};

template <int RPS, int SPT, bool TRACK, bool DIRS, bool AFFINE>
cudaError_t launch(const Args& a, int threads, cudaStream_t stream) {
  auto kernel = wavefront_strip_kernel<RPS, SPT, TRACK, DIRS, AFFINE>;
  const int smem = AFFINE ? kAffineSmemBytes : 0;
  if (AFFINE) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<1, threads, smem, stream>>>(
      a.text, a.bottom_in, a.fbot_in, a.pattern, a.score_matrix, a.left_in,
      a.left_e, a.dirs, a.dirs2, a.bottom_out, a.fbot_out, a.rowmax, a.argj,
      a.snap, a.ckpts, a.ckpts_e, a.steps, a.slots, a.k, a.gap, a.ext, a.n,
      a.m, a.i0, a.local, a.ckpt_every);
  return cudaGetLastError();
}

// Words exactly when there are no checkpoints (the score-only variant).
template <int RPS, int SPT, bool TRACK>
cudaError_t launch_variant(const Args& a, bool affine, int threads,
                           cudaStream_t stream) {
  const bool dirs = a.ckpt_every == 0;
  if (affine) {
    return dirs ? launch<RPS, SPT, TRACK, true, true>(a, threads, stream)
                : launch<RPS, SPT, TRACK, false, true>(a, threads, stream);
  }
  return dirs ? launch<RPS, SPT, TRACK, true, false>(a, threads, stream)
              : launch<RPS, SPT, TRACK, false, false>(a, threads, stream);
}

template <int RPS, int SPT>
cudaError_t launch_flags(const Args& a, bool track, bool affine, int threads,
                         cudaStream_t stream) {
  return track ? launch_variant<RPS, SPT, true>(a, affine, threads, stream)
               : launch_variant<RPS, SPT, false>(a, affine, threads, stream);
}

template <int RPS>
cudaError_t launch_spt(const Args& a, int spt, bool track, bool affine,
                       int threads, cudaStream_t stream) {
  switch (spt) {
    case 1: return launch_flags<RPS, 1>(a, track, affine, threads, stream);
    case 2: return launch_flags<RPS, 2>(a, track, affine, threads, stream);
    case 4: return launch_flags<RPS, 4>(a, track, affine, threads, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Fills one strip.  text / bottom_in: (steps,) int32; pattern: (rps,
// slots) int32; score_matrix: (k, k) int32; left_in: null (the arithmetic
// column-0 boundary) or (rps+1, slots), row 0 the slot's corner value
// S[i0+rps*s, col_lo] and row r+1 its row r's S[i0+rps*s+r+1, col_lo];
// dirs: (steps/16*rps, slots) when ckpt_every is 0, else unused;
// bottom_out: (steps,); rowmax / argj: (rps, slots); snap: (slots,);
// ckpts: (max(1, steps/ckpt_every)*rps, slots) when ckpt_every > 0, else
// unused.  affine (gap the open cost, ext the extend cost) also takes
// fbot_in (steps,), the strip's top row of F, and with left_in the left
// column's E, left_e (rps+1, slots) (row 0 unused); and writes dirs2
// (shaped like dirs) with the words, fbot_out (steps,), and ckpts_e
// (shaped like ckpts) with the checkpoints.  Linear launches pass null
// for those.  steps is a multiple of 256, slots a multiple of 128 up to
// 1024 or one of 2048 and 4096, rps one of 1, 2, 4, 8, 16, k <= 32,
// ckpt_every 0 (words) or a power of two >= slots + 16 (score-only with
// checkpoints).  semi selects row-m tracking on the global recurrence.
// Returns the launch's cudaError_t (0 on success); the kernel runs on
// `stream`.
extern "C" int sa_wavefront_strip(
    const int32_t* text, const int32_t* bottom_in, const int32_t* fbot_in,
    const int32_t* pattern, const int32_t* score_matrix,
    const int32_t* left_in, const int32_t* left_e, int32_t* dirs,
    int32_t* dirs2, int32_t* bottom_out, int32_t* fbot_out, int32_t* rowmax,
    int32_t* argj, int32_t* snap, int32_t* ckpts, int32_t* ckpts_e,
    int steps, int slots, int rps, int k, int gap, int ext, int n, int m,
    int i0, int local, int semi, int affine, int ckpt_every, void* stream) {
  const bool words = ckpt_every == 0;
  if (steps <= 0 || steps % kChunk != 0 || slots % 128 != 0 ||
      slots > kMaxSlots || k < 1 || k > kMaxAlpha || (local && semi) ||
      ckpt_every < 0 || (words && dirs == nullptr) ||
      (!words &&
       (ckpts == nullptr || (ckpt_every & (ckpt_every - 1)) != 0 ||
        ckpt_every < slots + 16)) ||
      (affine &&
       (fbot_in == nullptr || fbot_out == nullptr ||
        (left_in != nullptr && left_e == nullptr) ||
        (words ? dirs2 == nullptr : ckpts_e == nullptr)))) {
    return cudaErrorInvalidValue;
  }
  const int threads = slots < 1024 ? slots : 1024;
  const int spt = slots / threads;
  const bool track = local || semi;
  const Args a{text, bottom_in, fbot_in, pattern, score_matrix, left_in,
               left_e, dirs, dirs2, bottom_out, fbot_out, rowmax, argj, snap,
               ckpts, ckpts_e, steps, slots, k, gap, ext, n, m, i0, local,
               ckpt_every};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aff = affine != 0;
  switch (rps) {
    case 1: return launch_spt<1>(a, spt, track, aff, threads, s);
    case 2: return launch_spt<2>(a, spt, track, aff, threads, s);
    case 4: return launch_spt<4>(a, spt, track, aff, threads, s);
    case 8: return launch_spt<8>(a, spt, track, aff, threads, s);
    case 16: return launch_spt<16>(a, spt, track, aff, threads, s);
    default: return cudaErrorInvalidValue;
  }
}
