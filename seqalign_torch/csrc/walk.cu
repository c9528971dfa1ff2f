// K2: traceback walk over K1's skewed direction words, linear or affine
// (Gotoh) gaps.
//
// Replaces seqalign_tpu/ops/pallas_walk.py::_walker_kernel (launched by
// pallas_walk_skewed_window), in its linear and affine modes.
//
// Semantics (identical to the TPU walker): start at cell (i0, j0) and
// follow the stored directions while i > row_lo and j > col_lo.  Cell
// (i, j) of the tile lives in slot s = (i-row_lo-1)/rps, row r =
// (i-row_lo-1)%rps, sweep step t = j-col_lo-1+s, at bits 2*(t%16) of
// word (t/16)*rps + r, column s.  Local walks stop on STOP (not
// recorded) and after a move that reaches row 0 or column 0, and then
// report done = 1.  Move p goes to bits 2*(p%16) of move word p/16.
// Unlike the TPU walker the kernel never writes past the move buffer:
// at its end it stops with done = 0.  Affine walks (words2, K1's run-bit
// plane, not null) carry a state from state0: 0 in H, 1 in an E run
// (the move is LEFT whatever the word says), 2 in an F run (TOP).  After
// each move the state is the run the move stays in: 1 after a LEFT whose
// cell has run bit 0, 2 after a TOP whose cell has bit 1, else 0.  A
// local walk stops on STOP only in state 0.  Linear walks stay in 0.
//
// What bounds it on an H100: the path is one dependent chain.  Each
// move's word decides the next move's address, so a move costs at least
// one dependent load; the bytes and the operations are negligible.  The
// words of a large pair (4.66 GB at full width) are far beyond the 50 MB
// L2, so a walk that loads each move's word from device memory pays
// close to HBM latency a move (≈ 263 ns; P1, csrc/probe_chase.cu); from
// shared memory a dependent load costs ≈ 25 ns.
//
// What the design does about it: one CTA; lane 0 of warp 0 walks, and
// reads every word (and run bit) from a window staged in shared memory;
// six other warps (1-3 and 5-7, on the other three SM sub-partitions
// than the walker's) only load windows.  A window is a rectangle of S
// slots x G word groups (16 sweep steps a group) with all rps rows of
// each slot, laid out [G][rps][S] int32 (an affine walk keeps a second
// plane for words2 at the same offsets).  It is anchored at a cell of
// the walk: the cell's slot is among its top four (its low slot s0 is a
// multiple of 4, so each row of S slots is whole 16-byte chunks of one
// word row), its top group is the cell's, and it is clipped at slot 0
// and group 0 (entries below them are never loaded and never read, as
// the walk stops there).  The walk's row and step only decrease
// (ops/walk.py), so once it leaves a window it never returns.  There are
// two buffers.  When the walk has gone half the rows, or half the steps,
// from the resident window's anchor to its edge, the walker posts a
// request for a window anchored at its current cell into the other
// buffer and walks on, so the load has the other half to land; it polls
// the load every 16 rows or one group of steps after that and switches as
// soon as the load has landed (a cell the walk reaches inside the
// resident window is inside the requested one too: the request's edges
// lie at or beyond the resident window's).  It waits only if the walk
// reaches the resident window's edge first; if the cell it reached is
// not inside the requested window, it loads one at that cell and waits
// (a miss).  So every read is of the resident buffer.  The window shape
// (window_slots, window_groups) is fixed per rps and variant at compile
// time; the build with SA_WALK_ALL_SHAPES (probes/walk_shapes.py) takes
// it as arguments and can write the walker's trace (windows, waits,
// misses, ns a move).
//
// The move loop: the walker keeps the cell's offset in the window
// incrementally, computing the offsets of the three possible moves while
// the word's load is in flight and selecting one by the word's two bits,
// tested with masks made before the load; so a move's chain is the load,
// a bit test, two selects and the address.  Moves run in batches that
// cannot reach a window event, the tile's edge or the move buffer's end
// (the batch's length comes from the distances to them, as a move takes
// the row, column and count by at most 1 and the step by at most 2), so
// the loop's branch does not wait on the words; the row and column are
// recovered from the offset after each batch.  A move enters the move
// word with one funnel shift.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_error.cuh"
#include "mbarrier.cuh"

namespace {

constexpr int kWarps = 8;  // warp 0 walks; warps 1-3 and 5-7 load
constexpr int kThreads = 32 * kWarps;
constexpr int kLoaders = 32 * 6;
constexpr int kUnroll = 8;  // 16-byte loads a loader keeps in flight
constexpr int kStopRequest = -1;

// The window per rps and variant: S slots (rows: S * rps) and G word
// groups (steps: 16 G), 512 rows x 512 steps linear, 256 x 512 affine
// (two planes), the least time over the main path's walks by
// probes/walk_shapes.py --time.  Two buffers of S * G * rps int32 a plane
// must fit the 227 KB of shared memory a CTA can have: 128 KB.
constexpr int window_slots(int rps, bool affine) {
  return (affine ? 256 : 512) / rps;
}
constexpr int window_groups(int, bool) { return 32; }

__host__ __device__ constexpr int ilog2(int x) {
  return x <= 1 ? 0 : 1 + ilog2(x / 2);
}

template <int RPS, int S, int G, bool AFFINE>
constexpr int window_bytes() {
  return 2 * S * G * RPS * 4 * (AFFINE ? 2 : 1);
}

struct WalkArgs {
  const int32_t* words;
  const int32_t* words2;
  int slots, word_rows, row_lo, col_lo, i0, j0, state0, capacity;
  int32_t* moves;
  int32_t* result;
  long long* trace;  // null, or the walker's trace (probe build)
};

// A window of the walk: its low slot and word group, and the row and step
// below which the walk has passed its middle.
struct Window {
  int s0, b0, mid_a, mid_t;
};
constexpr int kNever = -(1 << 30);

// The walker's request to the loaders and the two barriers.
struct Control {
  unsigned long long req;   // mbarrier: one arrival a request (the walker)
  unsigned long long done;  // mbarrier: kLoaders arrivals a load
  int buf, s0, b0;          // buffer (kStopRequest: quit), low slot, group
};

using sa_mbar::bar_arrive;
using sa_mbar::bar_init;
using sa_mbar::bar_test;
using sa_mbar::bar_wait;
using sa_mbar::clock_ns;

// A loader: waits for each request and copies its share of the window's
// 16-byte chunks (rows b0*rps .. (b0+G)*rps - 1 of the words, slots s0 ..
// s0+S-1, the parts at or past row 0 and slot 0) into the buffer, then
// arrives on `done`.
template <int RPS, int S, int G, bool AFFINE>
__device__ void load_windows(const WalkArgs& p, Control& ctl,
                             int32_t* window, int me) {
  constexpr int kChunks = S / 4;
  constexpr int kItems = G * RPS * kChunks;
  constexpr int kPlane = S * G * RPS;
  constexpr int kBuf = kPlane * (AFFINE ? 2 : 1);
  uint32_t parity = 0;
  for (;;) {
    bar_wait(&ctl.req, parity);
    parity ^= 1;
    const int buf = ctl.buf;
    if (buf == kStopRequest) return;
    const int s0 = ctl.s0;
    const long long row0 = static_cast<long long>(ctl.b0) * RPS;
    int32_t* dst = window + buf * kBuf;
    for (int base = me; base < kItems; base += kLoaders * kUnroll) {
      int4 v[kUnroll], v2[kUnroll];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int it = base + u * kLoaders;
        const int q = it / kChunks;
        const int slot = s0 + 4 * (it % kChunks);
        const long long row = row0 + q;
        ok[u] = it < kItems && row >= 0 && row < p.word_rows && slot >= 0 &&
                slot < p.slots;
        if (ok[u]) {
          const long long g = row * p.slots + slot;
          v[u] = __ldg(reinterpret_cast<const int4*>(p.words + g));
          if (AFFINE) v2[u] = __ldg(reinterpret_cast<const int4*>(p.words2 + g));
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (ok[u]) {
          const int it = base + u * kLoaders;
          const int at = (it / kChunks) * S + 4 * (it % kChunks);
          *reinterpret_cast<int4*>(dst + at) = v[u];
          if (AFFINE) *reinterpret_cast<int4*>(dst + kPlane + at) = v2[u];
        }
      }
    }
    bar_arrive(&ctl.done);
  }
}

// The walker (lane 0 of warp 0).  Cell (i, j) is held as a = i-row_lo-1
// (the tile's row, 0-based) and c = j-col_lo-1, with r = a % RPS, the
// sweep step t = c + a / RPS and off, the cell's offset in the resident
// window: ((t/16 - b0) * RPS + r) * S + (a/RPS - s0).
template <int RPS, int S, int G, bool AFFINE, bool LOCAL>
__device__ void walk(const WalkArgs& p, Control& ctl, int32_t* window) {
  constexpr int LR = ilog2(RPS);
  constexpr int kGroup = RPS * S;  // ints of one word group in a window
  constexpr int kPlane = G * kGroup;
  constexpr int kBuf = kPlane * (AFFINE ? 2 : 1);
  static_assert((1 << LR) == RPS && S % 8 == 0 && G >= 2, "window shape");
#ifdef SA_WALK_ALL_SHAPES
  const bool trace = p.trace != nullptr;
#else
  constexpr bool trace = false;  // the production build writes no trace
#endif
  long long loads = 0, waits = 0, wait_ns = 0, misses = 0, polls = 0,
            early = 0, first_ns = 0;
  const long long t_start = trace ? clock_ns() : 0;

  int a = p.i0 - p.row_lo - 1;
  int c = p.j0 - p.col_lo - 1;
  int st = p.state0;
  int count = 0, done = 0;
  uint32_t mw = 0;  // the move word being filled, newest move on top
  int32_t* const moves = p.moves;
  const int cap = p.capacity;
  uint32_t parity = 0;  // loads consumed, mod 2
  bool pending = false;
  if (a >= 0 && c >= 0 && cap > 0) {
    int s = a >> LR;
    int t = c + s;
    // A window anchored at the current cell: its low slot and group, and
    // its middle from the anchor: the walk has passed it once it has gone
    // down half the rows, or half the steps, from the anchor to the
    // window's low edge (never, where the edge is row 0 or step 0).
    auto request = [&](int buf, Window& w) {
      w.s0 = (s - S + 4) & ~3;
      w.b0 = (t >> 4) - G + 1;
      w.mid_a = w.s0 > 0 ? a - (a - w.s0 * RPS + 2) / 2 + 1 : kNever;
      w.mid_t = w.b0 > 0 ? t - (t - w.b0 * 16 + 2) / 2 + 1 : kNever;
      ctl.buf = buf;
      ctl.s0 = w.s0;
      ctl.b0 = w.b0;
      bar_arrive(&ctl.req);
      ++loads;
    };
    auto wait_load = [&]() {
      const long long t0 = trace ? clock_ns() : 0;
      bar_wait(&ctl.done, parity);
      parity ^= 1;
      return trace ? clock_ns() - t0 : 0;
    };
    auto inside = [&](const Window& w) { return s >= w.s0 && t >= w.b0 * 16; };
    int cur = 0;
    Window res, next;  // the resident window, the requested one
    request(0, res);
    first_ns = wait_load();
    const int32_t* buf = window;
    int r = a & (RPS - 1);
    int off = ((t >> 4) - res.b0) * kGroup + r * S + (s - res.s0);
    int ev_a = 0, ev_t = 0;  // the next window event: a < ev_a or t < ev_t
    bool event = true;
    for (;;) {
      if (a < 0 || c < 0) {
        if (LOCAL) done = a + p.row_lo + 1 == 0 || c + p.col_lo + 1 == 0;
        break;
      }
      if (count >= cap) break;
      if (event) {
        s = a >> LR;
        bool fresh = false;
        if (!pending && (a < res.mid_a || t < res.mid_t)) {
          request(cur ^ 1, next);
          pending = fresh = true;
        }
        if (pending) {
          const bool outside = !inside(res);
          if (outside || (!fresh && bar_test(&ctl.done, parity))) {
            if (outside) {
              wait_ns += wait_load();
              ++waits;
            } else {
              parity ^= 1;
              ++early;
            }
            cur ^= 1;
            res = next;
            pending = false;
            if (!inside(res)) {
              // The walk left the requested window before it landed.
              request(cur, res);
              wait_ns += wait_load();
              ++misses;
            }
            buf = window + cur * kBuf;
            off = ((t >> 4) - res.b0) * kGroup + r * S + (s - res.s0);
            if (a < res.mid_a || t < res.mid_t) {
              request(cur ^ 1, next);
              pending = true;
            }
          } else if (!fresh) {
            ++polls;
          }
        }
        // Pending: the resident window's edge, and the next poll 16 rows
        // or a group of steps on; else the resident window's middle.
        const int lo = res.s0 > 0 ? res.s0 * RPS : 0;
        ev_a = pending ? max(lo, a - 15) : max(res.mid_a, 0);
        ev_t = pending ? max(res.b0 * 16, t & ~15) : res.mid_t;
      }
      // The moves inside the window, until an event, an edge or the end
      // of the move buffer: batches of k moves that cannot reach any of
      // them (a, c and count move by at most 1 a move, t by at most 2),
      // so that the loop's branch does not wait on the words, each batch
      // followed by the check; near them, batches of one move.
      for (;;) {
        int k = min(min(a - ev_a, (t - ev_t) >> 1), min(c, cap - 1 - count));
        k = max(k, 1);
        do {
          const int w = buf[off];
          const int w2 = AFFINE ? buf[off + kPlane] : 0;
          // While the load is in flight: the masks of the cell's two
          // bits (an affine walk in a run forces LEFT, 00, or TOP, 10),
          // and the three moves' next offsets (STOP keeps the cell).
          const int sh = 2 * (t & 15);
          const bool in_h = !AFFINE || st == 0;
          const uint32_t m0 = in_h ? 1u << sh : 0u;
          const uint32_t m1 = in_h ? 2u << sh : 0u;
          const bool force1 = AFFINE && st == 2;
          const bool r0 = RPS == 1 || r == 0;
          const int cross = sh == 0 ? kGroup : 0;
          const int off_l = off - cross;
          const int off_t = r0 ? off + (RPS - 1) * S - 1 - cross : off - S;
          const int off_d = off_t - (sh == 2 * r0 ? kGroup : 0);
          const bool b0 = (static_cast<uint32_t>(w) & m0) != 0;
          const bool b1 = ((static_cast<uint32_t>(w) & m1) != 0) || force1;
          if (LOCAL && b0 && b1) {  // STOP (a forced move is never STOP)
            done = 1;
            break;
          }
          // The move enters the move word at its top two bits: after 16
          // moves the word holds them in order.
          const uint32_t d = AFFINE ? (b1 ? 2u : 0u) | (b0 ? 1u : 0u)
                                    : static_cast<uint32_t>(w) >> sh;
          mw = __funnelshift_r(mw, d, 2);
          if ((count & 15) == 15) moves[count >> 4] = static_cast<int32_t>(mw);
          ++count;
          if (AFFINE) {
            const int bits = (w2 >> sh) & 3;
            st = !b0 && !b1 && (bits & 1) ? 1
                 : (!b0 && b1 && (bits & 2) ? 2 : 0);
          }
          const bool di = b0 != b1;  // DIAG or TOP: the row goes down
          off = b1 ? (b0 ? off : off_t) : (b0 ? off_d : off_l);
          t -= !b1 + (di && r0);
          r = (r - di) & (RPS - 1);
        } while (--k);
        // The cell's slot from its offset, and its row and column.
        s = off - ((t >> 4) - res.b0) * kGroup - r * S + res.s0;
        a = s * RPS + r;
        c = t - s;
        if (done || a < ev_a || t < ev_t || c < 0 || count >= cap) break;
      }
      if (done) break;
      event = a < ev_a || t < ev_t;
    }
    if (count & 15) {
      moves[count >> 4] = static_cast<int32_t>(mw >> (32 - 2 * (count & 15)));
    }
    if (pending) wait_load();
  }
  p.result[0] = count;
  p.result[1] = a + p.row_lo + 1;
  p.result[2] = c + p.col_lo + 1;
  p.result[3] = st;
  p.result[4] = done;
  // The loaders are idle (every load consumed): let them go.
  ctl.buf = kStopRequest;
  bar_arrive(&ctl.req);
  if (trace) {
    long long* out = p.trace;
    out[0] = loads;
    out[1] = waits;
    out[2] = wait_ns;
    out[3] = misses;
    out[4] = polls;
    out[5] = early;
    out[6] = first_ns;
    out[7] = clock_ns() - t_start;
    out[8] = count;
  }
}

template <int RPS, int S, int G, bool AFFINE, bool LOCAL>
__global__ void __launch_bounds__(kThreads, 1)
    walk_window_kernel(const WalkArgs args) {
  extern __shared__ int4 window4[];
  int32_t* window = reinterpret_cast<int32_t*>(window4);
  __shared__ Control ctl;
  if (threadIdx.x == 0) {
    bar_init(&ctl.req, 1);
    bar_init(&ctl.done, kLoaders);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  if (warp & 3) {
    load_windows<RPS, S, G, AFFINE>(
        args, ctl, window, (warp - 1 - (warp >> 2)) * 32 + (threadIdx.x & 31));
  } else if (threadIdx.x == 0) {
    walk<RPS, S, G, AFFINE, LOCAL>(args, ctl, window);
  }
}

template <int RPS, int S, int G, bool AFFINE>
cudaError_t launch(const WalkArgs& a, bool local, cudaStream_t stream) {
  constexpr int kBytes = window_bytes<RPS, S, G, AFFINE>();
  static_assert(kBytes <= 232448, "the window must fit shared memory");
  auto kernel = local ? walk_window_kernel<RPS, S, G, AFFINE, true>
                      : walk_window_kernel<RPS, S, G, AFFINE, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return err;
  kernel<<<1, kThreads, kBytes, stream>>>(a);
  return cudaGetLastError();
}

template <int RPS>
cudaError_t launch_production(const WalkArgs& a, bool local,
                              cudaStream_t s) {
  if (a.words2 != nullptr) {
    return launch<RPS, window_slots(RPS, true), window_groups(RPS, true),
                  true>(a, local, s);
  }
  return launch<RPS, window_slots(RPS, false), window_groups(RPS, false),
                false>(a, local, s);
}

cudaError_t prepare(const int32_t* words, const int32_t* words2, int rps,
                    int slots, int row_lo, int col_lo, int i0, int j0,
                    int state0, int32_t* moves, int64_t move_words,
                    int32_t* result, long long* trace, WalkArgs* a) {
  const auto aligned = [](const void* x) {
    return reinterpret_cast<uintptr_t>(x) % 16 == 0;
  };
  if (rps < 1 || slots < 1 || slots % 4 || move_words < 0 || state0 < 0 ||
      state0 > 2 || (words2 == nullptr && state0 != 0) || row_lo < 0 ||
      col_lo < 0 || !aligned(words) ||
      (words2 != nullptr && !aligned(words2))) {
    return cudaErrorInvalidValue;
  }
  // The step of the start cell bounds every group the walk reads.
  const long long il = static_cast<long long>(i0) - row_lo - 1;
  const long long t0 = j0 - col_lo - 1 + (il < 0 ? 0 : il / rps);
  const long long word_rows = (t0 / 16 + 1) * rps;
  const long long capacity = move_words * 16;
  *a = WalkArgs{words, words2, slots,
                static_cast<int>(word_rows < 0 ? 0 : word_rows), row_lo,
                col_lo, i0, j0, state0,
                static_cast<int>(capacity < INT32_MAX ? capacity : INT32_MAX),
                moves, result, trace};
  return cudaSuccess;
}

#ifdef SA_WALK_ALL_SHAPES
// The shapes the all-shapes build takes (rps, slots, groups): the least
// (8 x 2) and the production shape at every rps; more at rps 16, the
// main path's.  Linear, then affine (half the shared memory a plane).
#define SA_WALK_LINEAR_SHAPES(X)                                          \
  X(1, 8, 2) X(2, 8, 2) X(4, 8, 2) X(8, 8, 2) X(16, 8, 2)                 \
  X(1, 512, 32) X(2, 256, 32) X(4, 128, 32) X(8, 64, 32) X(16, 32, 32)    \
  X(16, 8, 32) X(16, 8, 128) X(16, 16, 16) X(16, 16, 64) X(16, 32, 16)
#define SA_WALK_AFFINE_SHAPES(X)                                          \
  X(1, 8, 2) X(2, 8, 2) X(4, 8, 2) X(8, 8, 2) X(16, 8, 2)                 \
  X(1, 256, 32) X(2, 128, 32) X(4, 64, 32) X(8, 32, 32) X(16, 16, 32)    \
  X(16, 8, 32) X(16, 8, 64) X(16, 16, 16) X(16, 32, 16)

cudaError_t launch_shape(const WalkArgs& a, int rps, int S, int G,
                         bool local, cudaStream_t s) {
#define SA_WALK_TRY(R, SS, GG, AFF)                                       \
  if (rps == R && S == SS && G == GG) {                                   \
    return launch<R, SS, GG, AFF>(a, local, s);                           \
  }
#define SA_WALK_LINEAR(R, SS, GG) SA_WALK_TRY(R, SS, GG, false)
#define SA_WALK_AFFINE(R, SS, GG) SA_WALK_TRY(R, SS, GG, true)
  if (a.words2 == nullptr) {
    SA_WALK_LINEAR_SHAPES(SA_WALK_LINEAR)
  } else {
    SA_WALK_AFFINE_SHAPES(SA_WALK_AFFINE)
  }
  return cudaErrorInvalidValue;
}
#endif

}  // namespace

// The window shape of a launch at this rps (1, 2, 4, 8 or 16) and
// variant: slots and word groups (0 for another rps).
extern "C" int sa_walk_window_slots(int rps, int affine) {
  return rps == 1 || rps == 2 || rps == 4 || rps == 8 || rps == 16
             ? window_slots(rps, affine != 0) : 0;
}

extern "C" int sa_walk_window_groups(int rps, int affine) {
  return sa_walk_window_slots(rps, affine) ? window_groups(rps, affine != 0)
                                           : 0;
}

// Walks from (i0, j0) in state state0.  words: (W, slots) int32 skewed
// words, 16-byte aligned; words2: null (linear; state0 must be 0) or the
// run bits, shaped like words; rps 1, 2, 4, 8 or 16; row_lo, col_lo >= 0;
// moves: (move_words,) int32, room for 16*move_words moves; result: (5,)
// int32 = count, i, j, state, done.  Returns the launch's cudaError_t.
extern "C" int sa_walk_skewed(const int32_t* words, const int32_t* words2,
                              int rps, int slots, int row_lo, int col_lo,
                              int i0, int j0, int state0, int local,
                              int32_t* moves, int64_t move_words,
                              int32_t* result, void* stream) {
  WalkArgs a;
  cudaError_t err = prepare(words, words2, rps, slots, row_lo, col_lo, i0,
                            j0, state0, moves, move_words, result, nullptr,
                            &a);
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  switch (rps) {
    case 1: return launch_production<1>(a, local != 0, s);
    case 2: return launch_production<2>(a, local != 0, s);
    case 4: return launch_production<4>(a, local != 0, s);
    case 8: return launch_production<8>(a, local != 0, s);
    case 16: return launch_production<16>(a, local != 0, s);
    default: return cudaErrorInvalidValue;
  }
}

#ifdef SA_WALK_ALL_SHAPES
// sa_walk_skewed with a window of `win_slots` x `win_groups` (one of the
// SA_WALK_*_SHAPES), for probes/walk_shapes.py; trace: null, or 9 int64
// the walker writes: windows loaded, waits at a window's edge, their ns,
// misses, polls that found the load still running, switches on a poll,
// the first window's ns, the walker's ns, moves.
extern "C" int sa_walk_skewed_shape(
    const int32_t* words, const int32_t* words2, int rps, int slots,
    int row_lo, int col_lo, int i0, int j0, int state0, int local,
    int32_t* moves, int64_t move_words, int32_t* result, int win_slots,
    int win_groups, long long* trace, void* stream) {
  WalkArgs a;
  cudaError_t err = prepare(words, words2, rps, slots, row_lo, col_lo, i0,
                            j0, state0, moves, move_words, result, trace,
                            &a);
  if (err != cudaSuccess) return err;
  return launch_shape(a, rps, win_slots, win_groups, local != 0,
                      static_cast<cudaStream_t>(stream));
}
#endif
