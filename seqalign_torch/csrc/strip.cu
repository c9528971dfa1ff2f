// K5: fill of one region of the DP matrix (a block of rows x one column
// strip), linear gaps, global or local, with the 2-bit direction words or
// score-only.
//
// Replaces seqalign_tpu/ops/pallas_fill.py::_strip_kernel (launched by
// strip_fill_pallas; wrapped by pair_fill_pallas, looped by
// ops/tiled.py::tiled_fill).
//
// Semantics (identical to the TPU kernel).  Row i = row_base + rr + 1 of
// the region, over the strip's columns j = strip_off + c + 1, c = 0 ..
// w-1:
//   diag = S[i-1, j-1] + sub(pat[rr], text[c])   (PAD_SCORE past column n;
//          S[i-1, strip_off] is left_col[rr], S[row_base, j] prev_in[c])
//   S[i, j] = max(diag, S[i-1, j] - g, S[i, j-1] - g)  (local: and 0),
//          S[i, strip_off] being left_col[rr+1].
// The TPU kernel fills a whole row at once as a running maximum of
// max(diag, top) + g j, because its vector unit wants rows; the values
// are the same.  The 2-bit direction under the reference's tie policy:
// left = S[i, j-1] - g, top = S[i-1, j] - g, gap_best = max(left, top);
// DIAG (1) if diag > gap_best, else LEFT (0) if left >= top, else TOP
// (2); local: STOP (3) when max(diag, gap_best) <= 0.  Row rr's direction
// sits at bits 2*(rr%16) of word (rr/16, column).  rcol[rr] is the
// strip's last column, prev_out the region's last row.  Local: the state
// moves to the largest row maximum over columns <= n strictly above
// state_in[0], among rows i <= m, the smallest such row and the first
// column of that maximum in it; if no row qualifies state_in stands.
// Global: the score becomes max(state_in[3], S[m, n]) when the region
// holds row m and the strip column n.  Rows past m and columns past n
// are computed and written like the rest.
//
// What bounds it on an H100: every cell depends on the one to its left
// and the one above, so the card's rate needs many dependent chains in
// flight; the work is integer max/add/select, about 12 operations a cell
// with words and 6 score-only, with no tensor-core form; the words are the
// only bytes of note (a quarter of a byte a cell).  So the int32 instruction
// rate bounds it, and, short of it, the latency of each lane's chain.
//
// The design: a region is a chain of bands that spans the card.  A band
// is one warp (one CTA) and owns 32*RPL consecutive rows; lane l owns RPL
// of them and sweeps the region's w columns, SB columns (a block) an
// iteration: block b at iteration b + l.  The only values that cross
// lanes, a lane's last row after each column of its block, go to the
// lane below through SB __shfl_up_sync at the start of the next
// iteration, so a lane reads the block the lane above finished an
// iteration earlier.  Every lane starts from left_col: its rows' left
// boundary, and left_col[r0] (the row above its first row, r0) as the
// diagonal source of its first column; band 0's lane 0 reads prev_in as
// the row above.
//
// Between bands: the band's last lane stores its last row at column c
// into the band's stream in global memory, as one 64-bit word (the value,
// and c+1 as a tag) with a relaxed store at GPU scope (band_stream.cuh's
// helpers, which K1 shares).  The next band's
// lane 0 needs it at column c.  The warp loads 32 stream words at once
// (relaxed loads at GPU scope, which read L2, never a stale L1 line) and
// uses the prefix whose tags match; when its block's entries are not all
// there yet it sleeps and reloads, and after a bounded wait it traps.  A
// 64-bit aligned access is single-copy atomic, so a matching tag carries
// its value: no fence and no wait on the producer's side.  The streams
// are full length ((bands-1) x w words), so a producer never waits.  The
// last band writes prev_out directly.  sa_strip_fill zeroes the scratch
// (tags, ticket, counters) on the launch's stream before every launch.
// Each CTA takes its band from a ticket (atomicAdd at entry), so band b
// waits only on band b-1, which took its ticket earlier and is resident:
// no deadlock for any grid and any residency.
//
// Words: a lane's RPL rows of a column are 2*RPL bits of one byte of the
// column's word.  With RPL 4 a lane owns the byte and stores it alone (a
// byte store needs no read-modify-write); with RPL 1 or 2 the 4/RPL lanes
// of a byte hand their bits down the same way as their rows (one
// __shfl_up_sync of SB bytes an iteration) and the last of them stores.
//
// The local best: each lane keeps its rows' maxima over columns <= n and
// their first columns; at the end the band reduces its rows i <= m to
// one candidate (the largest value, then the smallest row), and the last
// CTA to finish (a counter) merges the bands' candidates the same way and
// writes state_out.  Global: the lane owning row m keeps S[m, n] and the
// last CTA writes the score.
//
// RPL and SB are compile-time constants per variant (rows_of and kBlock
// below), the shape of least time summed over the main path's shapes of
// the variant (probes/strip_shapes.py --time); only the probe's build,
// with SA_STRIP_ALL_SHAPES, takes any RPL of 1, 2, 4 and SB of 1, 2, 4,
// 8 as arguments.  Registers: a lane
// holds RPL rows, their pattern offsets and trackers, and SB values of
// each handed-on row; ptxas spills nothing (chip_smoke.py checks every
// instance).  Shared memory holds the substitution matrix only.

#include <cuda_runtime.h>
#include <stdint.h>

#include "band_stream.cuh"
#include "launch_error.cuh"

namespace {

using namespace band_stream;

constexpr int32_t kPadScore = -(1 << 24);
constexpr int32_t kNegInf = -(1 << 30);
constexpr int kMaxK = 32;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsQuantum = 128;
constexpr int kMaxRows = 16384;
constexpr int kMaxBands = kMaxRows / kWarp;  // at one row a lane
// Scratch: kCounterWords int32, then the bands' streams, (bands-1) x w
// 64-bit words.  The counters: the ticket at kTicket; the CTAs done at
// kDone; S[m, n] and whether it was seen at kSnapValue, kSnapSet; the
// stream windows all bands loaded and those that found no entry ready at
// kLoads, kMisses; each CTA's SM + 1 at kSmLog + its ticket; each band's
// first and last iteration on the GPU's nanosecond clock (its low 32
// bits) at kBandStart + band and kBandEnd + band; each band's local
// candidate (set, value, row, column) at kCand + 4 band.
// probes/strip_shapes.py --trace reads them.
constexpr int kCounterWords = 4096;
constexpr int kTicket = 0;
constexpr int kDone = 1;
constexpr int kSnapSet = 2;
constexpr int kSnapValue = 3;
constexpr int kLoads = 4;
constexpr int kMisses = 5;
constexpr int kSmLog = 512;
constexpr int kBandStart = 1024;
constexpr int kBandEnd = 1536;
constexpr int kCand = 2048;
static_assert(kCand + 4 * kMaxBands <= kCounterWords, "counters overlap");

// The shape of a launch by variant: the rows a lane owns (rows_of) and
// the columns a lane runs an iteration (kBlock), each the least time
// summed over the main path's shapes of the variant on an NVIDIA H100
// 80GB HBM3 at 700 W (probes/strip_shapes.py --time): with words, the
// full-width interior block and the single region, global and local
// (2 x 8: 5.99 + 7.14 + 7.38 ms, against 5.51 + 7.12 + 8.02 at 4 x 8);
// score-only, the long pair's block (4 x 8: 5.60 ms, against 7.39 at
// 2 x 8).  More columns an iteration cut the loop's own work a column and
// lengthen the pipeline's fill (one iteration a lane).
constexpr int rows_of(bool dirs) { return dirs ? 2 : 4; }

constexpr int kBlock = 8;

// A local candidate as one ordered key: the larger value, then the
// smaller row, is the larger key; 0 is below every candidate.
__device__ __forceinline__ unsigned long long cand_key(int32_t value,
                                                       int32_t row) {
  return (static_cast<unsigned long long>(static_cast<uint32_t>(value) ^
                                          0x80000000u)
          << 32) |
         static_cast<uint32_t>(~static_cast<uint32_t>(row));
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long y = __shfl_xor_sync(kFull, x, o);
    x = y > x ? y : x;
  }
  return x;
}

template <int RPL, int SB, bool LOCAL, bool DIRS>
__global__ void __launch_bounds__(kWarp) strip_band_kernel(
    const int8_t* __restrict__ text, const int32_t* __restrict__ pattern,
    const int32_t* __restrict__ sm, int k, int g, int n, int m,
    int row_base, int strip_off, int w, int rows,
    const int32_t* __restrict__ left_col,
    const int32_t* __restrict__ prev_in,
    const int32_t* __restrict__ state_in, int32_t* __restrict__ words,
    int32_t* __restrict__ state_out, int32_t* __restrict__ prev_out,
    int32_t* __restrict__ rcol, int32_t* __restrict__ counters,
    unsigned long long* __restrict__ streams) {
  static_assert(RPL == 1 || RPL == 2 || RPL == 4, "RPL divides a byte");
  constexpr int G = 4 / RPL;        // lanes whose rows share a word byte
  constexpr int PW = (SB + 3) / 4;  // 32-bit words of a block's bytes
  __shared__ int32_t sub[kMaxK * (kMaxK + 1)];

  const int lane = threadIdx.x;
  int ticket = 0;
  if (lane == 0) {
    ticket = atomicAdd(counters + kTicket, 1);
    counters[kSmLog + ticket] = sm_id() + 1;
  }
  const int band = __shfl_sync(kFull, ticket, 0);
  const int kp = k + 1;
  for (int e = lane; e < k * kp; e += kWarp) {
    const int a = e / kp;
    const int b = e - a * kp;
    sub[e] = b < k ? sm[a * k + b] : kPadScore;
  }
  __syncwarp();

  const int bands = rows / (kWarp * RPL);
  const int r0 = band * kWarp * RPL + lane * RPL;  // the lane's first row
  // Columns c < climit are <= n: their letters score, later ones pad.
  const int climit = n - strip_off;
  int32_t H[RPL];
  int pat[RPL];
  int32_t best_v[LOCAL ? RPL : 1];
  int best_c[LOCAL ? RPL : 1];
#pragma unroll
  for (int rr = 0; rr < RPL; ++rr) {
    H[rr] = left_col[r0 + rr + 1];
    pat[rr] = (pattern[r0 + rr] & (kMaxK - 1)) * kp;
    if (LOCAL) {
      best_v[rr] = kNegInf;
      best_c[rr] = 0;
    }
  }
  // The row above the lane's first row at the column before its block.
  int32_t topsh = left_col[r0];
  // Global: S[m, n] is row snap_rr of this lane at column snap_col.
  const int snap_rr = m - 1 - row_base - r0;
  const bool snap_mine = !LOCAL && snap_rr >= 0 && snap_rr < RPL &&
                         climit >= 1 && climit <= w;
  const int snap_col = snap_mine ? climit - 1 : -1;
  int32_t snap_v = 0;

  // The lane's last row after each column of its latest block, and the
  // word bytes of its block with those of the lanes above in its byte.
  int32_t pub[SB];
  uint32_t pbits[PW];
#pragma unroll
  for (int x = 0; x < SB; ++x) pub[x] = 0;
#pragma unroll
  for (int p = 0; p < PW; ++p) pbits[p] = 0;
  // The byte of each word the lane's rows fill, and their shift in it.
  uint8_t* wbytes =
      DIRS ? reinterpret_cast<uint8_t*>(words) +
                 (static_cast<int64_t>(r0 >> 4) * w) * 4 + ((r0 & 15) >> 2)
           : nullptr;
  const int bshift = 2 * (r0 & 3);
  const bool stores_byte = (lane % G) == G - 1;

  const unsigned long long* up =
      band > 0 ? streams + static_cast<int64_t>(band - 1) * w : nullptr;
  unsigned long long* mine =
      band < bands - 1 ? streams + static_cast<int64_t>(band) * w : nullptr;
  // Lane 0 reads entries tau*SB .. tau*SB+SB-1 of its top input at block
  // tau from a window of entries [wbase, wbase + wlen), one a lane (wlen a
  // multiple of SB).  The 32 entries after it are loaded (pv) at the
  // window's last block, an iteration before they are needed, so the load
  // runs beside that iteration's cells.
  auto fetch = [&](int base) -> unsigned long long {
    const int x = base + lane;
    if (x >= w) return 0;
    if (band == 0) return static_cast<uint32_t>(prev_in[x]);
    return load_tagged(up + x);
  };
  int wbase = 0, wlen = 0;
  int32_t wv = 0;
  unsigned long long pv = fetch(0);
  int loads = 0, misses = 0;
  // The letters of the lane's next block, loaded an iteration ahead (a
  // column past n takes the pad letter k where it is used).
  const uint8_t* letters = reinterpret_cast<const uint8_t*>(text);
  uint32_t letter[SB];
#pragma unroll
  for (int x = 0; x < SB; ++x) letter[x] = letters[x];

  const int blocks = w / SB;
  const int iters = blocks + kWarp - 1;
  for (int tau = 0; tau < iters; ++tau) {
    int32_t topv[SB];
#pragma unroll
    for (int x = 0; x < SB; ++x) topv[x] = __shfl_up_sync(kFull, pub[x], 1);
    uint32_t above[PW];
#pragma unroll
    for (int p = 0; p < PW; ++p) {
      above[p] = DIRS && G > 1 ? __shfl_up_sync(kFull, pbits[p], 1) : 0u;
    }
    if (tau < blocks) {  // lane 0's block tau: its top inputs
      const int e0 = tau * SB;
      if (e0 >= wbase + wlen) {  // the window is spent: take pv's entries
        wbase = e0;
        const int x = wbase + lane;
        for (int spins = 0;; ++spins) {
          // A band waits only on one that runs (the head note), so a wait
          // of many seconds is a fault: end the launch with an error
          // instead of hanging the card.
          if (spins == kMaxSpins) __trap();
          const bool ok = band == 0 || x >= w ||
                          static_cast<int>(pv >> 32) == x + 1;
          const unsigned ready = __ballot_sync(kFull, ok);
          const int n_ready = ready == kFull ? kWarp : __ffs(~ready) - 1;
          wlen = n_ready - n_ready % SB;
          ++loads;
          if (wlen > 0) break;
          ++misses;
          __nanosleep(64);
          pv = fetch(wbase);
        }
        wv = static_cast<int32_t>(static_cast<uint32_t>(pv));
        if (e0 == 0 && lane == 0) counters[kBandStart + band] = clock_ns();
      }
#pragma unroll
      for (int x = 0; x < SB; ++x) {
        const int32_t v = __shfl_sync(kFull, wv, e0 + x - wbase);
        if (lane == 0) topv[x] = v;
      }
      if (e0 + SB == wbase + wlen && e0 + SB < w) pv = fetch(e0 + SB);
    }
    const int blk = tau - lane;
    if (blk >= 0 && blk < blocks) {
      int lt[SB];
      // The next block's letters (the last block reloads its own).
      const int next = min((blk + 1) * SB, w - SB);
#pragma unroll
      for (int x = 0; x < SB; ++x) {
        lt[x] = blk * SB + x < climit ? static_cast<int>(letter[x]) : k;
        letter[x] = letters[next + x];
      }
      uint32_t bits[PW];
#pragma unroll
      for (int p = 0; p < PW; ++p) bits[p] = 0;
#pragma unroll
      for (int x = 0; x < SB; ++x) {
        const int c = blk * SB + x;
        int32_t top = topv[x];
        int32_t diag_src = x == 0 ? topsh : topv[x - 1];
#pragma unroll
        for (int rr = 0; rr < RPL; ++rr) {
          const int32_t diag = diag_src + sub[pat[rr] + lt[x]];
          const int32_t left = H[rr];
          const int32_t gap_best = max(top, left) - g;
          const int32_t best = max(diag, gap_best);
          const int32_t cell = LOCAL ? max(best, 0) : best;
          if (DIRS) {
            uint32_t d = diag > gap_best ? 1u : (left >= top ? 0u : 2u);
            if (LOCAL && best <= 0) d = 3u;
            bits[x >> 2] |= d << (8 * (x & 3) + 2 * rr);
          }
          if (LOCAL && c < climit && cell > best_v[rr]) {
            best_v[rr] = cell;
            best_c[rr] = c;
          }
          diag_src = left;
          top = cell;
          H[rr] = cell;
        }
        if (!LOCAL && c == snap_col) {
#pragma unroll
          for (int rr = 0; rr < RPL; ++rr) {
            if (rr == snap_rr) snap_v = H[rr];
          }
        }
        pub[x] = H[RPL - 1];
      }
      topsh = topv[SB - 1];
      if (DIRS) {
#pragma unroll
        for (int p = 0; p < PW; ++p) {
          bits[p] <<= bshift;
          if (G > 1 && lane % G != 0) bits[p] |= above[p];
          pbits[p] = bits[p];
        }
        if (stores_byte) {
#pragma unroll
          for (int x = 0; x < SB; ++x) {
            wbytes[static_cast<int64_t>(blk * SB + x) * 4] =
                static_cast<uint8_t>(bits[x >> 2] >> (8 * (x & 3)));
          }
        }
      }
      if (lane == kWarp - 1) {
#pragma unroll
        for (int x = 0; x < SB; ++x) {
          const int c = blk * SB + x;
          if (mine != nullptr) {
            store_tagged(mine + c, pub[x], c + 1);
          } else {
            prev_out[c] = pub[x];
          }
        }
      }
    }  // blk in [0, blocks)
  }

#pragma unroll
  for (int rr = 0; rr < RPL; ++rr) rcol[r0 + rr] = H[rr];

  // The band's candidate (local) or S[m, n] (global), through lane 0.
  int32_t cv = 0, crow = 0, ccol = 0;
  bool cset = false;
  if (LOCAL) {
    unsigned long long key = 0;
    int col = 0;
#pragma unroll
    for (int rr = 0; rr < RPL; ++rr) {
      const int i = row_base + r0 + rr + 1;
      const unsigned long long kk = cand_key(best_v[rr], i);
      if (i <= m && kk > key) {
        key = kk;
        col = best_c[rr];
      }
    }
    const unsigned long long top = warp_max(key);
    const unsigned who = __ballot_sync(kFull, top != 0 && key == top);
    if (who) {
      const int src = __ffs(who) - 1;
      cv = __shfl_sync(kFull, static_cast<int32_t>((top >> 32) ^ 0x80000000u),
                       src);
      crow = __shfl_sync(kFull, static_cast<int32_t>(~static_cast<uint32_t>(
                                    top & 0xffffffffu)),
                         src);
      ccol = __shfl_sync(kFull, strip_off + col + 1, src);
      cset = true;
    }
  } else {
    const unsigned who = __ballot_sync(kFull, snap_mine);
    if (who) {
      cv = __shfl_sync(kFull, snap_v, __ffs(who) - 1);
      cset = true;
    }
  }
  int last = 0;
  if (lane == 0) {
    if (LOCAL && cset) {
      int32_t* cand = counters + kCand + 4 * band;
      cand[1] = cv;
      cand[2] = crow;
      cand[3] = ccol;
      cand[0] = 1;
    } else if (!LOCAL && cset) {
      counters[kSnapValue] = cv;
      counters[kSnapSet] = 1;
    }
    counters[kBandEnd + band] = clock_ns();
    atomicAdd(counters + kLoads, loads);
    atomicAdd(counters + kMisses, misses);
    __threadfence();
    last = atomicAdd(counters + kDone, 1) == bands - 1;
  }
  if (!__shfl_sync(kFull, last, 0)) return;

  // The last CTA to finish: every band's candidate is written.
  __threadfence();
  if (LOCAL) {
    unsigned long long key = 0;
    int col = 0;
    for (int b = lane; b < bands; b += kWarp) {
      const int32_t* cand = counters + kCand + 4 * b;
      if (__ldcg(cand) != 0) {
        const unsigned long long kk = cand_key(__ldcg(cand + 1),
                                               __ldcg(cand + 2));
        if (kk > key) {
          key = kk;
          col = __ldcg(cand + 3);
        }
      }
    }
    const unsigned long long top = warp_max(key);
    const unsigned who = __ballot_sync(kFull, top != 0 && key == top);
    const int jcol = __shfl_sync(kFull, col, who ? __ffs(who) - 1 : 0);
    if (lane == 0) {
      const int32_t value = static_cast<int32_t>((top >> 32) ^ 0x80000000u);
      if (who && value > state_in[0]) {
        state_out[0] = value;
        state_out[1] = static_cast<int32_t>(
            ~static_cast<uint32_t>(top & 0xffffffffu));
        state_out[2] = jcol;
      } else {
        state_out[0] = state_in[0];
        state_out[1] = state_in[1];
        state_out[2] = state_in[2];
      }
      state_out[3] = state_in[3];
    }
  } else if (lane == 0) {
    state_out[0] = state_in[0];
    state_out[1] = state_in[1];
    state_out[2] = state_in[2];
    state_out[3] = __ldcg(counters + kSnapSet) != 0
                       ? max(state_in[3], __ldcg(counters + kSnapValue))
                       : state_in[3];
  }
}

struct Args {
  const int8_t* text;
  const int32_t* pattern;
  const int32_t* sm;
  int k, g, n, m, row_base, strip_off, w, rows;
  const int32_t* left_col;
  const int32_t* prev_in;
  const int32_t* state_in;
  int32_t* words;
  int32_t* state_out;
  int32_t* prev_out;
  int32_t* rcol;
  int32_t* counters;
  unsigned long long* streams;
};

template <int RPL, int SB, bool LOCAL, bool DIRS>
cudaError_t launch(const Args& a, cudaStream_t s) {
  // One CTA of one warp a band.
  strip_band_kernel<RPL, SB, LOCAL, DIRS><<<a.rows / (kWarp * RPL), kWarp, 0,
                                            s>>>(
      a.text, a.pattern, a.sm, a.k, a.g, a.n, a.m, a.row_base, a.strip_off,
      a.w, a.rows, a.left_col, a.prev_in, a.state_in, a.words, a.state_out,
      a.prev_out, a.rcol, a.counters, a.streams);
  return cudaGetLastError();
}

int64_t scratch_bytes(int w, int rows, int rpl) {
  const int64_t bands = rows / (kWarp * rpl);
  return kCounterWords * 4 + (bands - 1) * w * 8;
}

// Checks the region's limits, zeroes the scratch of a launch at rpl rows
// a lane on the stream, and returns the launch's arguments in *a.
cudaError_t prepare(const int8_t* text, const int32_t* pattern,
                    const int32_t* sm, int k, int gap, int n, int m,
                    int row_base, int strip_off, int w, int rows,
                    const int32_t* left_col, const int32_t* prev_in,
                    const int32_t* state_in, int32_t* words,
                    int32_t* state_out, int32_t* prev_out, int32_t* rcol,
                    int rpl, void* scratch, cudaStream_t s, Args* a) {
  if (k < 1 || k > kMaxK || w < 1024 || w % 1024 || w > 65536 ||
      rows < kRowsQuantum || rows % kRowsQuantum || rows > kMaxRows ||
      scratch == nullptr) {
    return cudaErrorInvalidValue;
  }
  // The ticket, the counters, the candidates and every stream tag start
  // at 0 each launch.
  const cudaError_t err = cudaMemsetAsync(
      scratch, 0, static_cast<size_t>(scratch_bytes(w, rows, rpl)), s);
  if (err != cudaSuccess) return err;
  auto* counters = static_cast<int32_t*>(scratch);
  *a = Args{text, pattern, sm, k, gap, n, m, row_base, strip_off, w, rows,
            left_col, prev_in, state_in, words, state_out, prev_out, rcol,
            counters,
            reinterpret_cast<unsigned long long*>(counters + kCounterWords)};
  return cudaSuccess;
}

#ifdef SA_STRIP_ALL_SHAPES
template <int RPL, int SB>
cudaError_t launch_variant(const Args& a, bool local, cudaStream_t s) {
  const bool dirs = a.words != nullptr;
  if (local) {
    return dirs ? launch<RPL, SB, true, true>(a, s)
                : launch<RPL, SB, true, false>(a, s);
  }
  return dirs ? launch<RPL, SB, false, true>(a, s)
              : launch<RPL, SB, false, false>(a, s);
}

template <int RPL>
cudaError_t launch_block(const Args& a, int block, bool local,
                         cudaStream_t s) {
  switch (block) {
    case 1: return launch_variant<RPL, 1>(a, local, s);
    case 2: return launch_variant<RPL, 2>(a, local, s);
    case 4: return launch_variant<RPL, 4>(a, local, s);
    case 8: return launch_variant<RPL, 8>(a, local, s);
    default: return cudaErrorInvalidValue;
  }
}
#endif

}  // namespace

// Rows a lane owns in a launch with words (dirs 1) or score-only (dirs 0).
extern "C" int sa_strip_rows_per_lane(int dirs) { return rows_of(dirs != 0); }

// Bytes of the scratch a launch of w columns x rows at rpl rows a lane
// needs.
extern "C" long long sa_strip_scratch_bytes(int w, int rows, int rpl) {
  return scratch_bytes(w, rows, rpl);
}

// Fills one region.  text: (w,) int8 letters of the strip's columns (any
// letter in 0..k-1 past n); pattern: (rows,) int32 letters in 0..k-1;
// sm: (k, k) int32; left_col: (rows + 1,); prev_in: (w,) the row above;
// state_in: (4,) [best, best_i, best_j, score].  words: (rows/16, w)
// int32, or null for the score-only fill; state_out (4,), prev_out (w,),
// rcol (rows,).  w is a multiple of 1024 up to 65,536; rows a multiple
// of 128 up to 16,384.  scratch: sa_strip_scratch_bytes(w, rows,
// sa_strip_rows_per_lane(words != null)) bytes of device memory, 8-byte
// aligned, the caller's; it is zeroed on `stream` first.  Returns the
// launch's cudaError_t; the kernel runs on `stream`.
extern "C" int sa_strip_fill(const int8_t* text, const int32_t* pattern,
                             const int32_t* sm, int k, int gap, int n, int m,
                             int row_base, int strip_off, int w, int rows,
                             const int32_t* left_col, const int32_t* prev_in,
                             const int32_t* state_in, int local,
                             int32_t* words, int32_t* state_out,
                             int32_t* prev_out, int32_t* rcol, void* scratch,
                             void* stream) {
  constexpr int kWordsRpl = rows_of(true), kScoreRpl = rows_of(false);
  const bool dirs = words != nullptr;
  auto s = static_cast<cudaStream_t>(stream);
  Args a;
  const cudaError_t err = prepare(
      text, pattern, sm, k, gap, n, m, row_base, strip_off, w, rows, left_col,
      prev_in, state_in, words, state_out, prev_out, rcol, rows_of(dirs),
      scratch, s, &a);
  if (err != cudaSuccess) return err;
  if (dirs) {
    return local ? launch<kWordsRpl, kBlock, true, true>(a, s)
                 : launch<kWordsRpl, kBlock, false, true>(a, s);
  }
  return local ? launch<kScoreRpl, kBlock, true, false>(a, s)
               : launch<kScoreRpl, kBlock, false, false>(a, s);
}

#ifdef SA_STRIP_ALL_SHAPES
// sa_strip_fill at a given rpl (1, 2 or 4) and block (1, 2, 4 or 8), for
// probes/strip_shapes.py; the scratch is sa_strip_scratch_bytes(w, rows,
// rpl) bytes.
extern "C" int sa_strip_fill_shape(
    const int8_t* text, const int32_t* pattern, const int32_t* sm, int k,
    int gap, int n, int m, int row_base, int strip_off, int w, int rows,
    const int32_t* left_col, const int32_t* prev_in, const int32_t* state_in,
    int local, int32_t* words, int32_t* state_out, int32_t* prev_out,
    int32_t* rcol, int rpl, int block, void* scratch, void* stream) {
  if ((rpl != 1 && rpl != 2 && rpl != 4) ||
      (block != 1 && block != 2 && block != 4 && block != 8)) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  Args a;
  const cudaError_t err = prepare(
      text, pattern, sm, k, gap, n, m, row_base, strip_off, w, rows, left_col,
      prev_in, state_in, words, state_out, prev_out, rcol, rpl, scratch, s,
      &a);
  if (err != cudaSuccess) return err;
  switch (rpl) {
    case 1: return launch_block<1>(a, block, local != 0, s);
    case 2: return launch_block<2>(a, block, local != 0, s);
    default: return launch_block<4>(a, block, local != 0, s);
  }
}
#endif
