// K1: skewed-wavefront fill of one strip of rps*slots DP rows, for linear
// gap costs: with the 2-bit skewed direction words, or score-only; with
// column checkpoints; from the arithmetic column-0 boundary or from a
// given left boundary column.
//
// Replaces seqalign_tpu/ops/wavefront.py::_wavefront_kernel (launched by
// wavefront_strip), in its linear global / local / semi-global modes,
// with and without dirs, ckpt_every and left_in.
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
// What bounds it on an H100: the DP is a chain of dependent integer
// max/add/select operations, about 15 per cell with words and 4 for the
// score alone, with no tensor-core form; the 2-bit words are the only
// bytes it must write (a quarter of a byte per cell; the checkpoints are
// 4 bytes per C cells), so the int32 issue rate bounds it, not memory.
// This first design runs one block on one SM (no inter-block protocol),
// so it reaches at most 1/132 of the card's integer rate.
//
// What the design does about it: one block of min(slots, 1024) threads;
// thread p owns slots p, p+B, p+2B, ... (B = blockDim), so each thread
// holds rps*slots/B cells of H and their word accumulators in registers
// and consecutive threads store consecutive words.  The only value that
// crosses slots, a slot's last row, goes through a double-buffered
// shared array, so one __syncthreads() per step is the whole protocol.
// The substitution matrix and a window of the text and of the top-row
// stream are staged in shared memory.  At rps*slots/B = 64 cells per
// thread (rps 16, slots 4096) the state exceeds the 64 registers a
// 1024-thread block allows, and the compiler spills to local memory; the
// score-only variant (a template parameter) keeps no word accumulators.
// The TPU captures checkpoints into vector scratch and flushes them once
// per word group because it cannot scatter; here a thread stores its
// slot's rps values straight to global memory at the step its slot
// reaches a checkpoint column.  Only the score-only variant has that
// test in its loop (no caller wants checkpoints with words, nor a score
// alone without them), so the variant with words keeps the registers it
// had without checkpoints.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kNegInf = -(1 << 30);
constexpr int kTextRing = 8192;    // bytes; >= slots + 512 for slots <= 4096
constexpr int kBottomRing = 512;   // >= 2 prefetch chunks
constexpr int kChunk = 256;        // prefetch granularity (steps)
constexpr int kMaxSlots = 4096;
constexpr int kMaxAlpha = 32;

template <int RPS, int SPT, bool TRACK, bool DIRS>
__global__ void __launch_bounds__(1024)
wavefront_strip_kernel(const int32_t* __restrict__ text,
                       const int32_t* __restrict__ bottom_in,
                       const int32_t* __restrict__ pattern,
                       const int32_t* __restrict__ score_matrix,
                       const int32_t* __restrict__ left_in,
                       int32_t* __restrict__ dirs,
                       int32_t* __restrict__ bottom_out,
                       int32_t* __restrict__ rowmax,
                       int32_t* __restrict__ argj,
                       int32_t* __restrict__ snap,
                       int32_t* __restrict__ ckpts,
                       int steps, int slots, int k, int gap, int n, int m,
                       int i0, int local, int ckpt_every) {
  __shared__ uint8_t text_ring[kTextRing];
  __shared__ int32_t bottom_ring[kBottomRing];
  __shared__ int32_t last_row[2][kMaxSlots];
  __shared__ int32_t sub[kMaxAlpha * kMaxAlpha];

  const int p = threadIdx.x;
  const int B = blockDim.x;
  // Checkpoint column j = (q+1)*C is captured when j & ckpt_mask == 0.
  const int ckpt_mask = DIRS ? -1 : ckpt_every - 1;
  const int ckpt_shift = DIRS ? 0 : __ffs(ckpt_every) - 1;

  for (int x = p; x < k * k; x += B) sub[x] = score_matrix[x];
  for (int x = p; x < kChunk && x < steps; x += B) {
    text_ring[x] = static_cast<uint8_t>(text[x] & (kMaxAlpha - 1));
    bottom_ring[x] = bottom_in[x];
  }

  int32_t H[SPT][RPS];
  int32_t word[DIRS ? SPT : 1][DIRS ? RPS : 1];
  int32_t pat[SPT][RPS];
  int32_t topsh[SPT];
  int32_t best_v[TRACK ? SPT : 1][TRACK ? RPS : 1];
  int32_t best_j[TRACK ? SPT : 1][TRACK ? RPS : 1];
  int32_t snap_v[SPT];

#pragma unroll
  for (int q = 0; q < SPT; ++q) {
    const int s = q * B + p;
    const int ibase = i0 + RPS * s;
    topsh[q] = left_in != nullptr ? left_in[s]
                                  : (local ? 0 : -(gap * ibase));
    snap_v[q] = kNegInf;
#pragma unroll
    for (int r = 0; r < RPS; ++r) {
      H[q][r] = left_in != nullptr ? left_in[(r + 1) * slots + s]
                                   : (local ? 0 : -(gap * (ibase + r + 1)));
      if (DIRS) word[q][r] = 0;
      pat[q][r] = (pattern[r * slots + s] & (kMaxAlpha - 1)) * k;
      if (TRACK) {
        best_v[q][r] = kNegInf;
        best_j[q][r] = 0;
      }
    }
    // Step 0 reads the neighbours' last rows "after step -1": the
    // boundary column.
    last_row[1][s] = H[q][RPS - 1];
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
        }
      }
    }
    const int32_t* prev_last = last_row[(t + 1) & 1];
    int32_t* cur_last = last_row[t & 1];
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
      const int ibase = i0 + RPS * s;
#pragma unroll
      for (int r = 0; r < RPS; ++r) {
        const int32_t diag = diag_src + sub[pat[q][r] + w];
        const int32_t left = H[q][r];
        const int32_t gap_best = max(top, left) - gap;
        const int32_t best = max(diag, gap_best);
        const int32_t newval = local ? max(best, 0) : best;
        const int32_t cur = started ? newval : left;
        if (DIRS) {
          int32_t d = diag > gap_best ? 1 : (left >= top ? 0 : 2);
          if (local && best <= 0) d = 3;
          word[q][r] = u == 0 ? d : (word[q][r] | (d << (2 * u)));
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
      if (!DIRS && started && (j & ckpt_mask) == 0) {
        const int64_t row0 =
            static_cast<int64_t>((j >> ckpt_shift) - 1) * RPS;
#pragma unroll
        for (int r = 0; r < RPS; ++r) {
          ckpts[(row0 + r) * slots + s] = H[q][r];
        }
      }
      if (DIRS && u == 15) {
        const int64_t row0 = static_cast<int64_t>(t >> 4) * RPS;
#pragma unroll
        for (int r = 0; r < RPS; ++r) {
          dirs[(row0 + r) * slots + s] = word[q][r];
        }
      }
    }
    if (p == B - 1) bottom_out[t] = H[SPT - 1][RPS - 1];
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
  const int32_t* pattern;
  const int32_t* score_matrix;
  const int32_t* left_in;
  int32_t* dirs;
  int32_t* bottom_out;
  int32_t* rowmax;
  int32_t* argj;
  int32_t* snap;
  int32_t* ckpts;
  int steps, slots, k, gap, n, m, i0, local, ckpt_every;
};

template <int RPS, int SPT, bool TRACK, bool DIRS>
cudaError_t launch(const Args& a, int threads, cudaStream_t stream) {
  wavefront_strip_kernel<RPS, SPT, TRACK, DIRS><<<1, threads, 0, stream>>>(
      a.text, a.bottom_in, a.pattern, a.score_matrix, a.left_in, a.dirs,
      a.bottom_out, a.rowmax, a.argj, a.snap, a.ckpts, a.steps, a.slots,
      a.k, a.gap, a.n, a.m, a.i0, a.local, a.ckpt_every);
  return cudaGetLastError();
}

// Words exactly when there are no checkpoints (the score-only variant).
template <int RPS, int SPT>
cudaError_t launch_flags(const Args& a, bool track, int threads,
                         cudaStream_t stream) {
  const bool dirs = a.ckpt_every == 0;
  if (track) {
    return dirs ? launch<RPS, SPT, true, true>(a, threads, stream)
                : launch<RPS, SPT, true, false>(a, threads, stream);
  }
  return dirs ? launch<RPS, SPT, false, true>(a, threads, stream)
              : launch<RPS, SPT, false, false>(a, threads, stream);
}

template <int RPS>
cudaError_t launch_spt(const Args& a, int spt, bool track, int threads,
                       cudaStream_t stream) {
  switch (spt) {
    case 1: return launch_flags<RPS, 1>(a, track, threads, stream);
    case 2: return launch_flags<RPS, 2>(a, track, threads, stream);
    case 4: return launch_flags<RPS, 4>(a, track, threads, stream);
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
// unused.  steps is a multiple of 256, slots a multiple of 128 up to 1024
// or one of 2048 and 4096, rps one of 1, 2, 4, 8, 16, k <= 32,
// ckpt_every 0 (words) or a power of two >= slots + 16 (score-only with
// checkpoints).  semi selects row-m tracking on the global recurrence.
// Returns the launch's cudaError_t (0 on success); the kernel runs on
// `stream`.
extern "C" int sa_wavefront_strip(
    const int32_t* text, const int32_t* bottom_in, const int32_t* pattern,
    const int32_t* score_matrix, const int32_t* left_in, int32_t* dirs,
    int32_t* bottom_out, int32_t* rowmax, int32_t* argj, int32_t* snap,
    int32_t* ckpts, int steps, int slots, int rps, int k, int gap, int n,
    int m, int i0, int local, int semi, int ckpt_every, void* stream) {
  if (steps <= 0 || steps % kChunk != 0 || slots % 128 != 0 ||
      slots > kMaxSlots || k < 1 || k > kMaxAlpha || (local && semi) ||
      ckpt_every < 0 || (ckpt_every == 0 && dirs == nullptr) ||
      (ckpt_every > 0 &&
       (ckpts == nullptr || (ckpt_every & (ckpt_every - 1)) != 0 ||
        ckpt_every < slots + 16))) {
    return cudaErrorInvalidValue;
  }
  const int threads = slots < 1024 ? slots : 1024;
  const int spt = slots / threads;
  const bool track = local || semi;
  const Args a{text, bottom_in, pattern, score_matrix, left_in, dirs,
               bottom_out, rowmax, argj, snap, ckpts, steps, slots, k, gap,
               n, m, i0, local, ckpt_every};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rps) {
    case 1: return launch_spt<1>(a, spt, track, threads, s);
    case 2: return launch_spt<2>(a, spt, track, threads, s);
    case 4: return launch_spt<4>(a, spt, track, threads, s);
    case 8: return launch_spt<8>(a, spt, track, threads, s);
    case 16: return launch_spt<16>(a, spt, track, threads, s);
    default: return cudaErrorInvalidValue;
  }
}
