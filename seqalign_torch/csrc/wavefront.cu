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
// columns are relative to the tile's first column); they still run the
// cell and write its direction bits.  Word (t/16)*rps + r, column s,
// holds the direction of step t of slot s's row r at bits 2*(t%16): LEFT
// 0, DIAG 1, TOP 2, STOP 3.  DIAG wins only when strictly greater than
// the best gap move, LEFT beats TOP on ties, local marks STOP where the
// best move is <= 0.  Local tracks every row's running maximum and first
// best column; semi-global runs the global recurrence (the caller passes
// a zero top row) and tracks row m only; global keeps S[m, n] in the snap
// of the slot owning row m.  The last slot's last row streams out once
// per step (the next strip's top row).  A launch with ckpt_every = C > 0
// is the score-only variant, which stores no words and keeps column
// checkpoints instead: ckpts row q*rps + r, column s holds
// S[i0+rps*s+r+1, (q+1)*C]; entries of columns the slot does not reach
// within the strip's steps keep what the caller put there (the wrapper
// zeroes them).  ckpt_every = 0 stores the words.
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
// max/add/select operations, 11 per cell with words and 5 for the score
// alone, the table index counted (affine: about 20 and 10), with no
// tensor-core form; the 2-bit words are the only bytes it must write (a
// quarter of a byte per cell, half a byte affine; the checkpoints are 4
// or 8 bytes per C cells), so the int32 issue rate bounds it, not memory.
// Within a step the rps rows of a slot are one dependent chain, so a
// lane's step costs the chain's latency and the loop's own work; the
// card's rate needs many such chains in flight on every SM, and that work
// spread over several steps.
//
// The cell (cell() below) runs on Hopper's DPX instructions, as K3's
// does.  Score-only, H = max(top - gap, max(left - gap, diag + s)) is two
// add-max instructions (VIADDMNMX), one of them on the chain from the row
// above; with words, max(left, top) and LEFT's win (left >= top) come
// from one __vibmax_s32 (a compare and a select in SASS), H = max(diag +
// s, that - gap) from one add-max, and DIAG wins iff H > that - gap;
// affine, E, F and the gap move are __vibmax_s32 whose predicates are the
// run bits and LEFT's win.  The _relu forms floor local's H at 0, where
// STOP is H == 0.  The mode (global, local, semi-global) is a template
// parameter, so the floor, the STOP test and the trackers compile out
// where they do not apply.  A lane runs a block whose columns are all
// >= 1 (and, tracking, <= n; none global's n or a checkpoint's) on a
// started path without the pre-start select, the range tests, the snap
// and the checkpoints; the other blocks (the pipeline's first and last)
// take the general path.
//
// The design: a strip is a chain of bands that spans the card.  A band
// is one warp and owns the 32/SPLIT consecutive slots [s0, s0+32/SPLIT);
// each slot's rps rows are split over SPLIT consecutive lanes, rps/SPLIT
// rows each, so a lane's chain a step is rps/SPLIT rows long.  A CTA is
// SPLIT warps, the 32 slots [32v, 32v+32), so a 4096-slot strip is 128
// CTAs, about one an SM.  Every band runs every global step t of its
// slots, the pre-start steps included, with the same column j = t-s+1,
// text letter t-s and word row t/16 as a single block would.
//
// Inside a band a lane runs SB consecutive steps (a block) an iteration:
// block b at iteration b + d.  The only values that cross lanes, a lane's
// last row of H (and F) after each step of its block, go to the next
// lane through SB __shfl_up_sync at the start of the next iteration, so
// each lane reads the lane above's previous iteration.  Within a slot the
// lane below needs the same steps, across slots the steps before (the
// last of the block before, kept in a carry, and all but the last of this
// one).  So d grows by one from lane to lane (d = lane), but with SB = 1
// only within a slot (d = slot_in_band*(SPLIT-1) + lane_in_slot).  A lane
// before its first block publishes its boundary column (and F's minus
// infinity), the "after step -1" values.  Lanes that run behind each
// other finish their 16-step words at different iterations, so a finished
// word is parked in registers and the warp stores them every 16/SB
// iterations.
//
// Between bands: the band's last lane stores its last row after step t
// into the band's stream in global memory, as one 64-bit word (the value,
// and t+1 as a tag) with a relaxed store at GPU scope.  The next band's
// lane 0 needs that value at step t+1 (band 0 reads bottom_in[t] at step
// t, and at step 0 a band reads the upper slot's boundary value).  The
// consumer warp loads 32 stream words at once (relaxed loads at GPU
// scope, which read L2, never a stale L1 line; band_stream.cuh's helpers,
// which K5 shares), and uses the prefix whose
// tags match; when its block's entries are not all there yet it sleeps
// and reloads.  A 64-bit aligned access is single-copy atomic, so a
// matching tag carries its value: no fence, no counter and no wait on the
// producer's side.  The streams are full length ((bands-1) x steps
// words, twice affine), so a producer never waits for a consumer.  The
// last band writes bottom_out and fbot_out directly.  sa_wavefront_strip
// zeroes the scratch (tags and ticket) on the launch's stream before
// every launch, so a tag of an earlier launch is never taken for this
// one's.
//
// Why it cannot deadlock: each CTA takes its number from a ticket in
// global memory (atomicAdd at entry) and owns the bands of that number,
// so band b waits only on band b-1, which belongs to the same CTA (its
// warps are resident together) or to a CTA that took its ticket earlier
// and so is resident already.  That holds for any grid and any residency,
// without a cooperative launch.
//
// Registers: a lane holds rps/SPLIT rows of H, its rows' pointers into
// the score table, by variant E, the word accumulators, the parked words
// and the trackers, and SB values of each handed-on row; no block-wide
// launch bound caps them, and ptxas spills nothing (chip_smoke.py checks
// every instance).  Shared memory holds the substitution matrix only.
// SPLIT and SB are fixed per (rps, variant) at the shape that measured
// fastest (shape_of below; probes/wavefront_shapes.py times every shape).
// The TPU captures checkpoints into vector scratch and flushes them once
// per word group because it cannot scatter; here a lane stores its rows
// straight to global memory at the step its slot reaches a checkpoint
// column, on the general path.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "band_stream.cuh"
#include "launch_error.cuh"

namespace {

using namespace band_stream;

constexpr int32_t kNegInf = -(1 << 30);
constexpr int32_t kNegHalf = kNegInf / 2;  // affine E/F "minus infinity"
constexpr int kMaxSlots = 4096;
constexpr int kMaxAlpha = 32;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 256;  // steps come in whole blocks of this many
// Scratch: kCounterWords int32, then the bands' H streams, then (affine)
// their F streams, each (bands-1) x steps 64-bit words.  The counters:
// the ticket at 0; the stream windows all bands loaded at 1, and the
// loads that found no entry ready at 2; the blocks all lanes ran on the
// started path and on the general path, 64-bit, at kStarted and kGeneral;
// each CTA's SM + 1 at kSmOffset + its ticket; each band's first and last
// iteration on the GPU's nanosecond clock (its low 32 bits: when its top
// input for step 0 or 1 was there, and at its end) at kBandStart + band
// and kBandEnd + band.  probes/wavefront_shapes.py --trace reads them.
constexpr int kCounterWords = 4096;
constexpr int kStarted = 4;
constexpr int kGeneral = 6;
constexpr int kSmOffset = 1024;
constexpr int kBandStart = 2048;
constexpr int kBandEnd = 3072;
constexpr int kGlobal = 0, kLocal = 1, kSemi = 2;  // the recurrence's mode

// The shape of a launch, by rps and variant: the lanes a slot's rows are
// split over and the steps a lane runs an iteration.  Each is the fastest
// of splits 1, 2, 4 x blocks 1, 2, 4 at the main path's shapes on an
// NVIDIA H100 80GB HBM3 at 700 W (probes/wavefront_shapes.py --time).  A
// longer chain a lane (fewer lanes) and a block of more steps both cut the
// per-step overhead, and both lengthen the pipeline's fill.  So the
// checkpoint engine's tiles and the sequence-parallel chunks (from a left
// column, 36,864 steps, two thirds of them the fill's at 4 x 4) take one
// lane a slot and mostly one step a block, where a band's lanes run in
// step (d = 0); local's trackers lengthen a lane's step, so its rps 8
// words split wider.
struct Shape {
  int split, block;
};

__host__ __device__ constexpr Shape shape_of(int rps, bool dirs, bool affine,
                                             bool local, bool left) {
  if (left && rps >= 16) return {1, dirs || affine ? 1 : 4};
  if (left && dirs && rps == 4) return {1, affine ? 1 : 4};
  if (!dirs) return {rps >= 16 ? 4 : rps >= 8 && !affine ? 2 : 1, 4};
  const int split = rps >= 16  ? 4
                    : rps >= 8 ? (local && !affine ? 4 : 2)
                    : rps >= 4 ? 2
                               : 1;
  return {split, affine && rps >= 8 ? 2 : 4};
}

// One cell: H from the cell above (top), to its left and on its diagonal
// (diag, and s the substitution's score), and with words its 2-bit
// direction (dir); affine also its E and F from the left's E (e_in) and
// the F above (f_in), and with words their run bits (run).  The values
// are the recurrence's whether the slot has started or not: the caller
// keeps a slot's left column (and E, and passes F on) until it starts.
template <int MODE, bool DIRS, bool AFFINE>
__device__ __forceinline__ int32_t cell(int32_t top, int32_t left,
                                        int32_t diag, int32_t s, int gap,
                                        int ext, int32_t e_in, int32_t f_in,
                                        int32_t& e, int32_t& f, uint32_t& dir,
                                        uint32_t& run) {
  constexpr bool kRelu = MODE == kLocal;  // H floored at 0
  int32_t h, gap_best;
  bool is_left;  // LEFT beats TOP, ties included
  if (!AFFINE && !DIRS) {
    // max(top - gap, max(left - gap, diag + s)): one add-max on the
    // chain from the row above.
    const int32_t dl = __viaddmax_s32(left, -gap, diag + s);
    return kRelu ? __viaddmax_s32_relu(top, -gap, dl)
                 : __viaddmax_s32(top, -gap, dl);
  }
  if (!AFFINE) {
    gap_best = __vibmax_s32(left, top, &is_left) - gap;
  } else if (!DIRS) {
    e = __viaddmax_s32(left, -gap, e_in - ext);
    f = __viaddmax_s32(top, -gap, f_in - ext);
    const int32_t de = __viaddmax_s32(diag, s, e);
    return kRelu ? __vimax_s32_relu(de, f) : max(de, f);
  } else {
    bool e_opens, f_opens;  // opening the run >= extending it
    e = __vibmax_s32(left - gap, e_in - ext, &e_opens);
    f = __vibmax_s32(top - gap, f_in - ext, &f_opens);
    gap_best = __vibmax_s32(e, f, &is_left);
    run = static_cast<uint32_t>(!e_opens) |
          (static_cast<uint32_t>(!f_opens) << 1);
  }
  h = kRelu ? __viaddmax_s32_relu(diag, s, gap_best)
            : __viaddmax_s32(diag, s, gap_best);
  // DIAG iff diag + s > gap_best, i.e. H > gap_best (local's H = 0, where
  // H <= gap_best may not hold, is STOP).
  dir = h > gap_best ? 1u : (is_left ? 0u : 2u);
  if (kRelu && h == 0) dir = 3u;
  return h;
}

template <int RPS, int SPLIT, int SB, int MODE, bool DIRS, bool AFFINE>
__global__ void wavefront_strip_kernel(
    const int32_t* __restrict__ text, const int32_t* __restrict__ bottom_in,
    const int32_t* __restrict__ fbot_in, const int32_t* __restrict__ pattern,
    const int32_t* __restrict__ score_matrix,
    const int32_t* __restrict__ left_in, const int32_t* __restrict__ left_e,
    int32_t* __restrict__ dirs, int32_t* __restrict__ dirs2,
    int32_t* __restrict__ bottom_out, int32_t* __restrict__ fbot_out,
    int32_t* __restrict__ rowmax, int32_t* __restrict__ argj,
    int32_t* __restrict__ snap, int32_t* __restrict__ ckpts,
    int32_t* __restrict__ ckpts_e, int32_t* __restrict__ counters,
    unsigned long long* __restrict__ streams, int steps, int slots, int k,
    int gap, int ext, int n, int m, int i0, int ckpt_every) {
  constexpr bool TRACK = MODE != kGlobal;
  constexpr int RT = RPS / SPLIT;     // rows a lane
  constexpr int SPB = kWarp / SPLIT;  // slots a band
  // Iterations lane 31 runs behind lane 0 (d below), and iterations a
  // lane takes to finish a word.
  constexpr int kLastLag = SB == 1 ? (SPB - 1) * (SPLIT - 1) + SPLIT - 1
                                   : kWarp - 1;
  constexpr int kWordIters = 16 / SB;
  __shared__ int32_t sub[kMaxAlpha * kMaxAlpha];
  __shared__ int ticket;

  if (threadIdx.x == 0) {
    ticket = atomicAdd(counters, 1);
    counters[kSmOffset + ticket] = sm_id() + 1;
  }
  for (int x = threadIdx.x; x < k * k; x += blockDim.x) {
    sub[x] = score_matrix[x];
  }
  __syncthreads();

  const int lane = threadIdx.x & (kWarp - 1);
  const int bands = slots / SPB;
  const int band = ticket * SPLIT + (threadIdx.x >> 5);
  const int part = lane % SPLIT;       // which rps/SPLIT rows of the slot
  const int s = band * SPB + lane / SPLIT;
  // The lane runs block b (steps b*SB .. b*SB+SB-1) at iteration b + d.
  const int d = SB == 1 ? (lane / SPLIT) * (SPLIT - 1) + part : lane;
  const int r0 = part * RT;            // the lane's first row in its slot
  const int ibase = i0 + RPS * s;
  // Checkpoint column j = (q+1)*C is captured when j & ckpt_mask == 0.
  const int ckpt_mask = DIRS ? -1 : ckpt_every - 1;
  const int ckpt_shift = DIRS ? 0 : __ffs(ckpt_every) - 1;

  // Column-0 value of DP row i (1-based), without a left column.
  auto boundary = [&](int i) -> int32_t {
    if (MODE == kLocal) return 0;
    if (AFFINE) return i == 0 ? 0 : -(gap + (i - 1) * ext);
    return -(gap * i);
  };

  // A word takes a step's 2 bits at its top and shifts right by 2, so
  // after its 16th step it holds step 16g + x at bits 2x.
  constexpr bool kParked = DIRS && kLastLag > 0;
  int32_t H[RT];
  uint32_t word[DIRS ? RT : 1];
  int32_t E[AFFINE ? RT : 1];
  uint32_t word2[AFFINE && DIRS ? RT : 1];
  // Lanes that run behind each other finish their words at different
  // iterations; a finished word waits here until the warp stores all at
  // once.
  uint32_t done[kParked ? RT : 1];
  uint32_t done2[kParked && AFFINE ? RT : 1];
  int done_row0 = -1;  // word row of done's first row; -1: nothing waits
  // Each row's row of the substitution table (its pattern letter's).
  const int32_t* prow[RT];
  // Each row's running maximum and its first column (local: every row,
  // semi-global: row m; rows past m are dropped at the end).
  int32_t best_v[TRACK ? RT : 1];
  int32_t best_j[TRACK ? RT : 1];
  int32_t snap_v = kNegInf;
  // The row above the lane's first row, at the previous step (at step 0,
  // its boundary column): the first row's diagonal source.
  int32_t topsh = left_in != nullptr ? left_in[r0 * slots + s]
                                     : boundary(ibase + r0);
#pragma unroll
  for (int rr = 0; rr < RT; ++rr) {
    const int r = r0 + rr;
    H[rr] = left_in != nullptr ? left_in[(r + 1) * slots + s]
                               : boundary(ibase + r + 1);
    if (DIRS) word[rr] = 0;
    if (AFFINE) {
      E[rr] = left_e != nullptr ? left_e[(r + 1) * slots + s] : kNegHalf;
      if (DIRS) word2[rr] = 0;
    }
    prow[rr] = sub + (pattern[r * slots + s] & (kMaxAlpha - 1)) * k;
    if (TRACK) {
      best_v[rr] = kNegInf;
      best_j[rr] = 0;
    }
  }

  // The lane's last row of H and F after each step of its latest block
  // ("after step -1" before its first: the boundary column and F's minus
  // infinity).
  int32_t pub[SB], pub_f[SB];
#pragma unroll
  for (int x = 0; x < SB; ++x) {
    pub[x] = H[RT - 1];
    pub_f[x] = kNegHalf;
  }
  // The lane above's last row (and F) at the step before the block: with
  // SB > 1 a slot's first lane needs it (the last value the lane above
  // handed on an iteration earlier).
  int32_t carry = pub[0], carry_f = kNegHalf;
  // Lane 0's top input at step 0 in a band after the first: the upper
  // slot's last row at the boundary column.
  const int s0 = band * SPB;
  const int32_t top0 =
      band == 0 ? 0
                : (left_in != nullptr ? left_in[RPS * slots + s0 - 1]
                                      : boundary(i0 + RPS * s0));
  const int64_t plane = static_cast<int64_t>(bands - 1) * steps;
  const unsigned long long* up =
      band > 0 ? streams + static_cast<int64_t>(band - 1) * steps : nullptr;
  unsigned long long* mine =
      band < bands - 1 ? streams + static_cast<int64_t>(band) * steps
                       : nullptr;
  // Lane 0 reads entries e0 .. e0+SB-1 of its top input at block b, e0 =
  // b*SB - off (band 0: bottom_in[t] at step t; later bands: the upper
  // band's value after step t-1, top0 for entry -1).  A window of 32
  // entries from wbase, one a lane, of which the first wlen are valid.
  const int off = band == 0 ? 0 : 1;
  int wbase = 0, wlen = 0;
  int32_t wv = 0, wf = 0;
  int loads = 0, misses = 0;  // stream windows loaded; loads none ready
  int started_blocks = 0;     // blocks run on the started path
  // The text letters of the lane's next block (text[t - s], 0 before the
  // text), loaded an iteration ahead.
  int letter[SB];
#pragma unroll
  for (int x = 0; x < SB; ++x) letter[x] = x - s >= 0 ? text[x - s] : 0;
  // A slot's snap row (global: S[m, n]) or tracked row (semi-global: row
  // m) is row m_rr of this lane, if any.
  const int m_rr = m - 1 - ibase - r0;

  const int blocks = steps / SB;
  const int iters = blocks + kLastLag;
  for (int tau = 0; tau < iters; ++tau) {
    int32_t nb[SB], nb_f[SB];
#pragma unroll
    for (int x = 0; x < SB; ++x) {
      nb[x] = __shfl_up_sync(kFull, pub[x], 1);
      nb_f[x] = AFFINE ? __shfl_up_sync(kFull, pub_f[x], 1) : 0;
    }
    // The top input of the lane's first row at each step of its block:
    // the lane above's block of this iteration within a slot; across
    // slots the step before, so the carry and all but its last.
    int32_t topv[SB], topf[SB];
#pragma unroll
    for (int x = 0; x < SB; ++x) {
      const bool shifted = SB > 1 && part == 0;
      topv[x] = !shifted ? nb[x] : (x == 0 ? carry : nb[x - 1]);
      topf[x] = !shifted ? nb_f[x] : (x == 0 ? carry_f : nb_f[x - 1]);
    }
    carry = nb[SB - 1];
    carry_f = nb_f[SB - 1];
    if (tau < blocks) {  // lane 0's block tau: its top inputs
      const int e0 = tau * SB - off;
      if (e0 + SB > wbase + wlen) {
        wbase = max(e0, 0);
        const int x = wbase + lane;
        if (band == 0) {
          if (x < steps) {
            wv = bottom_in[x];
            if (AFFINE) wf = fbot_in[x];
          }
          wlen = kWarp;
        } else {
          for (int spins = 0;; ++spins) {
            // A band waits only on one that runs (the head note), so a
            // wait of many seconds is a fault: end the launch with an
            // error instead of hanging the card.
            if (spins == kMaxSpins) __trap();
            bool ok = true;
            if (x < steps) {
              const unsigned long long e = load_tagged(up + x);
              ok = static_cast<int>(e >> 32) == x + 1;
              wv = static_cast<int32_t>(static_cast<uint32_t>(e));
              if (AFFINE) {
                const unsigned long long ef = load_tagged(up + plane + x);
                ok = ok && static_cast<int>(ef >> 32) == x + 1;
                wf = static_cast<int32_t>(static_cast<uint32_t>(ef));
              }
            }
            const unsigned ready = __ballot_sync(kFull, ok);
            wlen = ready == kFull ? kWarp : __ffs(~ready) - 1;
            ++loads;
            if (wlen >= e0 + SB - wbase) break;
            ++misses;
            __nanosleep(64);
          }
        }
        if (e0 <= 0 && lane == 0) counters[kBandStart + band] = clock_ns();
      }
#pragma unroll
      for (int x = 0; x < SB; ++x) {
        const int e = e0 + x;
        const int32_t v = __shfl_sync(kFull, wv, max(e - wbase, 0));
        const int32_t vf =
            AFFINE ? __shfl_sync(kFull, wf, max(e - wbase, 0)) : 0;
        if (lane == 0) {
          topv[x] = e < 0 ? top0 : v;
          topf[x] = e < 0 ? kNegHalf : vf;
        }
      }
    }
    const int blk = tau - d;
    if (blk >= 0 && blk < blocks) {
      int w[SB];
#pragma unroll
      for (int x = 0; x < SB; ++x) {
        w[x] = letter[x] & (kMaxAlpha - 1);
        const int tn = (blk + 1) * SB + x - s;  // next block's letter
        if (blk + 1 < blocks && tn >= 0) letter[x] = text[tn];
      }
      const int j0 = blk * SB - s + 1;  // the block's first column
      const int j1 = j0 + SB - 1;       // and its last
      // The block's steps, on the started path (every column of the
      // block is >= 1 and, tracking, <= n, and none is global's n or a
      // checkpoint's) or the general one.
      auto run_block = [&](auto started_path) {
        constexpr bool kAll = decltype(started_path)::value;
#pragma unroll
        for (int x = 0; x < SB; ++x) {
          const int t = blk * SB + x;
          const int j = j0 + x;
          const bool started = kAll || j >= 1;
          int32_t top = topv[x];
          int32_t diag_src = x == 0 ? topsh : topv[x - 1];
          int32_t f_above = topf[x];
#pragma unroll
          for (int rr = 0; rr < RT; ++rr) {
            const int32_t left = H[rr];
            int32_t e_new = 0, f_new = 0;
            uint32_t dir = 0, run = 0;
            const int32_t h = cell<MODE, DIRS, AFFINE>(
                top, left, diag_src, prow[rr][w[x]], gap, ext,
                AFFINE ? E[rr] : 0, f_above, e_new, f_new, dir, run);
            const int32_t cur = started ? h : left;
            if (DIRS) {
              word[rr] = __funnelshift_r(word[rr], dir, 2);
              if (AFFINE) word2[rr] = __funnelshift_r(word2[rr], run, 2);
            }
            if (AFFINE && started) {
              E[rr] = e_new;
              f_above = f_new;
            }
            if (TRACK && (MODE == kLocal || rr == m_rr)) {
              if (kAll) {
                bool keep;  // the best so far >= h: the first column stays
                best_v[rr] = __vibmax_s32(best_v[rr], h, &keep);
                best_j[rr] = keep ? best_j[rr] : j;
              } else if (started && j <= n && h > best_v[rr]) {
                best_v[rr] = h;
                best_j[rr] = j;
              }
            }
            diag_src = left;
            top = cur;
            H[rr] = cur;
          }
          if (!kAll && !TRACK && j == n) {
#pragma unroll
            for (int rr = 0; rr < RT; ++rr) {
              if (rr == m_rr) snap_v = H[rr];
            }
          }
          pub[x] = H[RT - 1];
          pub_f[x] = f_above;
          if (!kAll && !DIRS && started && (j & ckpt_mask) == 0) {
            const int64_t row0 =
                static_cast<int64_t>((j >> ckpt_shift) - 1) * RPS + r0;
#pragma unroll
            for (int rr = 0; rr < RT; ++rr) {
              ckpts[(row0 + rr) * slots + s] = H[rr];
              if (AFFINE) ckpts_e[(row0 + rr) * slots + s] = E[rr];
            }
          }
          if (DIRS && (t & 15) == 15) {
            if (kParked) {
#pragma unroll
              for (int rr = 0; rr < RT; ++rr) {
                done[rr] = word[rr];
                if (AFFINE) done2[rr] = word2[rr];
              }
              done_row0 = (t >> 4) * RPS + r0;
            } else {
              const int64_t row0 = static_cast<int64_t>(t >> 4) * RPS + r0;
#pragma unroll
              for (int rr = 0; rr < RT; ++rr) {
                dirs[(row0 + rr) * slots + s] =
                    static_cast<int32_t>(word[rr]);
                if (AFFINE) {
                  dirs2[(row0 + rr) * slots + s] =
                      static_cast<int32_t>(word2[rr]);
                }
              }
            }
          }
        }
      };
      if (j0 >= 1 && (TRACK ? j1 <= n : j1 < n || j0 > n) &&
          (DIRS || ((j0 - 1) >> ckpt_shift) == (j1 >> ckpt_shift))) {
        run_block(std::true_type());
        ++started_blocks;
      } else {
        run_block(std::false_type());
      }
      topsh = topv[SB - 1];
      if (lane == kWarp - 1) {
#pragma unroll
        for (int x = 0; x < SB; ++x) {
          const int t = blk * SB + x;
          if (mine != nullptr) {
            store_tagged(mine + t, pub[x], t + 1);
            if (AFFINE) store_tagged(mine + plane + t, pub_f[x], t + 1);
          } else {
            bottom_out[t] = pub[x];
            if (AFFINE) fbot_out[t] = pub_f[x];
          }
        }
      }
    }  // blk in [0, blocks)
    // Every 16 steps the warp stores the words its lanes finished since
    // the last time (each lane finishes one every 16 steps).
    if (kParked && ((tau % kWordIters) == kWordIters - 1 ||
                    tau == iters - 1) &&
        done_row0 >= 0) {
#pragma unroll
      for (int rr = 0; rr < RT; ++rr) {
        const int64_t x = static_cast<int64_t>(done_row0 + rr) * slots + s;
        dirs[x] = static_cast<int32_t>(done[rr]);
        if (AFFINE) dirs2[x] = static_cast<int32_t>(done2[rr]);
      }
      done_row0 = -1;
    }
  }

  const int started_all = __reduce_add_sync(kFull, started_blocks);
  if (lane == 0) {
    counters[kBandEnd + band] = clock_ns();
    atomicAdd(counters + 1, loads);
    atomicAdd(counters + 2, misses);
    atomicAdd(reinterpret_cast<unsigned long long*>(counters + kStarted),
              static_cast<unsigned long long>(started_all));
    atomicAdd(reinterpret_cast<unsigned long long*>(counters + kGeneral),
              static_cast<unsigned long long>(kWarp * blocks - started_all));
  }
  // snap: the lane holding row m of its slot, else the slot's first lane.
  const int mrow = m - 1 - ibase;
  if (part == (mrow >= 0 && mrow < RPS ? mrow / RT : 0)) snap[s] = snap_v;
#pragma unroll
  for (int rr = 0; rr < RT; ++rr) {
    const int i = ibase + r0 + rr + 1;
    const bool row_ok = TRACK && (MODE == kLocal ? i <= m : i == m);
    rowmax[(r0 + rr) * slots + s] = row_ok ? best_v[rr] : kNegInf;
    argj[(r0 + rr) * slots + s] = row_ok ? best_j[rr] : 0;
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
  int32_t* counters;
  unsigned long long* streams;
  int steps, slots, k, gap, ext, n, m, i0, ckpt_every;
};

template <int RPS, int SPLIT, int SB, int MODE, bool DIRS, bool AFFINE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  // One CTA of SPLIT warps (SPLIT bands) for each 32 slots.
  wavefront_strip_kernel<RPS, SPLIT, SB, MODE, DIRS, AFFINE>
      <<<a.slots / kWarp, SPLIT * kWarp, 0, stream>>>(
          a.text, a.bottom_in, a.fbot_in, a.pattern, a.score_matrix,
          a.left_in, a.left_e, a.dirs, a.dirs2, a.bottom_out, a.fbot_out,
          a.rowmax, a.argj, a.snap, a.ckpts, a.ckpts_e, a.counters,
          a.streams, a.steps, a.slots, a.k, a.gap, a.ext, a.n, a.m, a.i0,
          a.ckpt_every);
  return cudaGetLastError();
}

#ifdef SA_WAVEFRONT_ALL_SHAPES
template <int RPS, int SPLIT, int MODE, bool DIRS, bool AFFINE>
cudaError_t launch_block(const Args& a, int block, cudaStream_t stream) {
  switch (block) {
    case 1: return launch<RPS, SPLIT, 1, MODE, DIRS, AFFINE>(a, stream);
    case 2: return launch<RPS, SPLIT, 2, MODE, DIRS, AFFINE>(a, stream);
    case 4: return launch<RPS, SPLIT, 4, MODE, DIRS, AFFINE>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}
#endif

// The variant's shapes in code (shape_of, with and without a left
// column), or with SA_WAVEFRONT_ALL_SHAPES (probes/wavefront_shapes.py) any
// split of 1, 2, 4 that divides RPS and any block of 1, 2, 4.
template <int RPS, bool DIRS, bool AFFINE, int MODE>
cudaError_t launch_in_mode(const Args& a, int split, int block,
                           cudaStream_t stream) {
  constexpr Shape kOwn = shape_of(RPS, DIRS, AFFINE, MODE == kLocal, false);
  constexpr Shape kLeft = shape_of(RPS, DIRS, AFFINE, MODE == kLocal, true);
  if (split == kOwn.split && block == kOwn.block) {
    return launch<RPS, kOwn.split, kOwn.block, MODE, DIRS, AFFINE>(a, stream);
  }
  if (split == kLeft.split && block == kLeft.block) {
    return launch<RPS, kLeft.split, kLeft.block, MODE, DIRS, AFFINE>(a,
                                                                     stream);
  }
#ifdef SA_WAVEFRONT_ALL_SHAPES
  if (split == 1) {
    return launch_block<RPS, 1, MODE, DIRS, AFFINE>(a, block, stream);
  }
  if constexpr (RPS % 2 == 0) {
    if (split == 2) {
      return launch_block<RPS, 2, MODE, DIRS, AFFINE>(a, block, stream);
    }
  }
  if constexpr (RPS % 4 == 0) {
    if (split == 4) {
      return launch_block<RPS, 4, MODE, DIRS, AFFINE>(a, block, stream);
    }
  }
#endif
  return cudaErrorInvalidValue;
}

template <int RPS, bool DIRS, bool AFFINE>
cudaError_t launch_shape(const Args& a, int split, int block, int mode,
                         cudaStream_t stream) {
  switch (mode) {
    case kLocal:
      return launch_in_mode<RPS, DIRS, AFFINE, kLocal>(a, split, block,
                                                       stream);
    case kSemi:
      return launch_in_mode<RPS, DIRS, AFFINE, kSemi>(a, split, block,
                                                      stream);
    default:
      return launch_in_mode<RPS, DIRS, AFFINE, kGlobal>(a, split, block,
                                                        stream);
  }
}

// Words exactly when there are no checkpoints (the score-only variant).
template <int RPS>
cudaError_t launch_variant(const Args& a, int split, int block, int mode,
                           bool affine, cudaStream_t stream) {
  const bool dirs = a.ckpt_every == 0;
  if (affine) {
    return dirs ? launch_shape<RPS, true, true>(a, split, block, mode, stream)
                : launch_shape<RPS, false, true>(a, split, block, mode,
                                                 stream);
  }
  return dirs ? launch_shape<RPS, true, false>(a, split, block, mode, stream)
              : launch_shape<RPS, false, false>(a, split, block, mode,
                                                stream);
}

int64_t scratch_bytes(int steps, int slots, int split, int affine) {
  const int64_t bands = static_cast<int64_t>(slots) / (kWarp / split);
  return kCounterWords * 4 +
         (bands - 1) * steps * 8 * (affine ? 2 : 1);
}

int run(const int32_t* text, const int32_t* bottom_in,
        const int32_t* fbot_in, const int32_t* pattern,
        const int32_t* score_matrix, const int32_t* left_in,
        const int32_t* left_e, int32_t* dirs, int32_t* dirs2,
        int32_t* bottom_out, int32_t* fbot_out, int32_t* rowmax,
        int32_t* argj, int32_t* snap, int32_t* ckpts, int32_t* ckpts_e,
        int steps, int slots, int rps, int k, int gap, int ext, int n,
        int m, int i0, int local, int semi, int affine, int ckpt_every,
        int split, int block, void* scratch, void* stream) {
  const bool words = ckpt_every == 0;
  if (steps <= 0 || steps % kChunk != 0 || slots % 128 != 0 ||
      slots > kMaxSlots || k < 1 || k > kMaxAlpha || (local && semi) ||
      ckpt_every < 0 || (words && dirs == nullptr) || scratch == nullptr ||
      (split != 1 && split != 2 && split != 4) || rps % split != 0 ||
      (block != 1 && block != 2 && block != 4) ||
      (!words &&
       (ckpts == nullptr || (ckpt_every & (ckpt_every - 1)) != 0 ||
        ckpt_every < slots + 16)) ||
      (affine &&
       (fbot_in == nullptr || fbot_out == nullptr ||
        (left_in != nullptr && left_e == nullptr) ||
        (words ? dirs2 == nullptr : ckpts_e == nullptr)))) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The ticket, the SM log and every stream tag start at 0 each launch.
  const cudaError_t err = cudaMemsetAsync(
      scratch, 0, static_cast<size_t>(scratch_bytes(steps, slots, split,
                                                    affine)),
      s);
  if (err != cudaSuccess) return err;
  auto* counters = static_cast<int32_t*>(scratch);
  const Args a{text, bottom_in, fbot_in, pattern, score_matrix, left_in,
               left_e, dirs, dirs2, bottom_out, fbot_out, rowmax, argj, snap,
               ckpts, ckpts_e, counters,
               reinterpret_cast<unsigned long long*>(counters + kCounterWords),
               steps, slots, k, gap, ext, n, m, i0, ckpt_every};
  const int mode = local ? kLocal : semi ? kSemi : kGlobal;
  const bool aff = affine != 0;
  switch (rps) {
    case 1: return launch_variant<1>(a, split, block, mode, aff, s);
    case 2: return launch_variant<2>(a, split, block, mode, aff, s);
    case 4: return launch_variant<4>(a, split, block, mode, aff, s);
    case 8: return launch_variant<8>(a, split, block, mode, aff, s);
    case 16: return launch_variant<16>(a, split, block, mode, aff, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Lanes a slot's rows are split over, and steps a lane runs an
// iteration, for a launch of this rps and variant (ckpt_every 0: with
// words; left: from a left column).
extern "C" int sa_wavefront_split(int rps, int affine, int ckpt_every,
                                  int local, int left) {
  return shape_of(rps, ckpt_every == 0, affine != 0, local != 0, left != 0)
      .split;
}

extern "C" int sa_wavefront_block(int rps, int affine, int ckpt_every,
                                  int local, int left) {
  return shape_of(rps, ckpt_every == 0, affine != 0, local != 0, left != 0)
      .block;
}

// Bytes of the scratch a launch needs at that split.
extern "C" long long sa_wavefront_scratch_bytes(int steps, int slots,
                                                int split, int affine) {
  return scratch_bytes(steps, slots, split, affine);
}

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
// for those.  scratch: sa_wavefront_scratch_bytes(steps, slots,
// sa_wavefront_split(rps, affine, ckpt_every, local, left_in != null),
// affine) bytes of device
// memory, 8-byte aligned, the caller's; it is zeroed on `stream` first.
// steps is a multiple of 256, slots a multiple of 128 up to 1024 or one
// of 2048 and 4096, rps one of 1, 2, 4, 8, 16, k <= 32, ckpt_every 0
// (words) or a power of two >= slots + 16 (score-only with checkpoints).
// semi selects row-m tracking on the global recurrence.  Returns the
// launch's cudaError_t (0 on success); the kernel runs on `stream`.
extern "C" int sa_wavefront_strip(
    const int32_t* text, const int32_t* bottom_in, const int32_t* fbot_in,
    const int32_t* pattern, const int32_t* score_matrix,
    const int32_t* left_in, const int32_t* left_e, int32_t* dirs,
    int32_t* dirs2, int32_t* bottom_out, int32_t* fbot_out, int32_t* rowmax,
    int32_t* argj, int32_t* snap, int32_t* ckpts, int32_t* ckpts_e,
    int steps, int slots, int rps, int k, int gap, int ext, int n, int m,
    int i0, int local, int semi, int affine, int ckpt_every, void* scratch,
    void* stream) {
  return run(text, bottom_in, fbot_in, pattern, score_matrix, left_in,
             left_e, dirs, dirs2, bottom_out, fbot_out, rowmax, argj, snap,
             ckpts, ckpts_e, steps, slots, rps, k, gap, ext, n, m, i0, local,
             semi, affine, ckpt_every,
             sa_wavefront_split(rps, affine, ckpt_every, local,
                                left_in != nullptr),
             sa_wavefront_block(rps, affine, ckpt_every, local,
                                left_in != nullptr),
             scratch, stream);
}

#ifdef SA_WAVEFRONT_ALL_SHAPES
// sa_wavefront_strip at a given split (1, 2 or 4, dividing rps) and block
// (1, 2 or 4), for probes/wavefront_shapes.py.
extern "C" int sa_wavefront_strip_shape(
    const int32_t* text, const int32_t* bottom_in, const int32_t* fbot_in,
    const int32_t* pattern, const int32_t* score_matrix,
    const int32_t* left_in, const int32_t* left_e, int32_t* dirs,
    int32_t* dirs2, int32_t* bottom_out, int32_t* fbot_out, int32_t* rowmax,
    int32_t* argj, int32_t* snap, int32_t* ckpts, int32_t* ckpts_e,
    int steps, int slots, int rps, int k, int gap, int ext, int n, int m,
    int i0, int local, int semi, int affine, int ckpt_every, int split,
    int block, void* scratch, void* stream) {
  return run(text, bottom_in, fbot_in, pattern, score_matrix, left_in,
             left_e, dirs, dirs2, bottom_out, fbot_out, rowmax, argj, snap,
             ckpts, ckpts_e, steps, slots, rps, k, gap, ext, n, m, i0, local,
             semi, affine, ckpt_every, split, block, scratch, stream);
}
#endif
