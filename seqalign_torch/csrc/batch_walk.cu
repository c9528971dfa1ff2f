// K4: traceback walks over 16-row direction words: the batch walk, one
// walk a pair over K3's words, linear or affine (Gotoh) gaps; and the
// single-pair walk over the strip engine's words (walk_packed), linear.
//
// Replaces seqalign_tpu/ops/batch_traceback.py::_batch_walker_kernel
// (launched by batch_pallas_traceback) in its linear and affine modes;
// its state machine is also that of the lockstep walk
// batch_device_traceback, and of ops/traceback.py::device_traceback for
// the single pair.
//
// Semantics (identical to the TPU walker): pair p starts at (ms, ns)
// for global and at (bis, bjs) for local and semi.  Each step reads the
// direction of cell (max(i,1), max(j,1)): word (tile, (i-1)/16, j-1,
// slot) at bits 2*((i-1)%16).  Global and semi force TOP in column 0 and
// LEFT in row 0; local stops on STOP without recording it.  Move k goes
// to bits 2*(k%16) of word (k/16, p).  A walk lives while i > 0 and
// j > 0 (local), i > 0 (semi) or i > 0 or j > 0 (global), and stops at
// max_len moves, the end of its buffer.  Words past a pair's last move
// are left as the caller gave them (zeros).  A start outside the words
// walks no move.  The single-pair walk reads word (w, p) of a (W, P)
// array at w * P + p (one pair, tile_pairs = 1), global or local.
//
// Affine walks (dirs2, K3's run bits, not null) carry a state, 0 in H at
// the start: in state 1 (an E run) the move is LEFT and in state 2 (an F
// run) TOP, whatever the word says, before the global/semi edge
// overrides; local stops on STOP only in state 0.  After a move the
// state is 1 if it was LEFT and the run bits of the cell read,
// (max(i,1), max(j,1)), have bit 0, 2 if it was TOP and they have bit 1,
// else 0.  The logic is K2's affine walk (csrc/walk.cu) over K3's
// layout.
//
// What bounds it on an H100: a walk is a chain, each move's word chosen
// by the move before it, and the words of a 16,384-pair chunk of 256 x
// 256 pairs (256 MiB) or of the full-width pair (3.6 GB) are far beyond
// the 50 MB L2: a move that waits for its word from device memory pays
// close to HBM latency (≈ 263 ns; P1, csrc/probe_chase.cu).  The bytes
// and operations are small.  But in a word row the next word is known
// before the move is: after LEFT or DIAG it is the column to the left,
// after TOP the same word; only a move into the word row below (one a
// 16 vertical moves) chooses a word the walk could not know.  So both
// designs load a word row's next columns ahead of the path, and the
// dependent chain costs one latency a word-row crossing instead of one a
// move.  The batch walk then reads one 32-byte sector a word (a pair's
// words lie tile_pairs x 4 B apart): its floor is the sectors over the
// memory rate.  The single-pair walk's floor is its moves' chain.
//
// (a) The batch walk: one lane a pair, 32 consecutive pairs a warp (the
// moves' [word][pair] stores coalesce).  Each lane keeps a run of the
// next R column words of its word row, (w, jc), (w, jc-1), ..., in a
// ring of R slots of shared memory ([plane][slot][lane]: a warp's reads
// never conflict), filled by 4-byte cp.async copies (an affine lane
// copies the run-bit word beside each).  Every iteration of the loop
// each live lane makes at most one move and issues at most one copy, the
// warp commits one group and waits until at most R-1 groups are in
// flight: a copy issued R iterations ago has landed.  A lane issues the
// next column whenever its run holds fewer than R, so a word becomes the
// head at least R iterations after its copy was issued and the lane
// never waits inside a word row; when the path crosses into word row
// w-1 the lane restarts its run at the new cell and makes no move until
// the new head's copy is R iterations old, while the other lanes of its
// warp go on.  A copy goes to the slot of the copy R before it, which
// has left the run and, issued at least R iterations earlier, has
// landed: an abandoned row's copies never land on a restarted run.
// Every lane runs every iteration's code, its move and copy under
// predicates: the lanes of a warp wait, move and restart at different
// iterations, and branches around them serialise the warp.  With about
// 4 warps an SM nothing hides a warp's own chain of dependent
// instructions, so an iteration costs ≈ 0.3 µs and a restart R
// iterations: R trades that wait against the copies a restart wastes
// (up to R-1 columns past the crossing), which the random 32-byte
// sectors the copies read make dear.  R and the block size are fixed at
// compile time (kRun, kBatchThreads); the build with
// SA_BATCH_WALK_ALL_SHAPES (probes/batch_walk_shapes.py) takes them as
// arguments and can write the walk's trace (copies, restarts, iterations
// waiting, warp iterations).
//
// (b) The single-pair walk: one CTA; warp 0 walks, every lane holding
// the same state, and reads every word from a window of WR word rows x
// WC columns staged in shared memory, laid out row-major as the words
// are; six other warps (1-3 and 5-7) load windows with 16-byte loads
// (so P must be a multiple of 4 and the words 16-byte aligned, as the
// strip engine's are) into a second buffer on the walker's request (mbarriers, csrc/mbarrier.cuh): K2's protocol
// (csrc/walk.cu).  A window is anchored at a cell of the walk: its top
// word row is the cell's and its low column c0, a multiple of 4, leaves
// the cell's column among its four rightmost.  When the walk has gone
// half the rows or half the columns from the anchor to the window's low
// edges it requests a window anchored at its cell and polls it every 16
// rows or kPollCols columns, switching when it has landed, waiting only
// at the resident window's edge, and loading one at its cell if it has
// left the requested window too (a miss).  Inside a window the words of
// a run of LEFT moves are known before the moves are (the next columns
// of the cell's word row, at the same bits): in a step lane q reads the
// word of column jc - q, a ballot finds the first that is not LEFT, and
// the warp makes the LEFT moves before it at once, then its move.  The
// path of the full-width pair (280,482 columns, 48,632 rows) is 83 %
// LEFT: a step makes ≈ 4.7 moves.  A step is a chain of one
// shared-memory load, a ballot and a shuffle, its updates selects under
// predicates; what bounds the walk is that chain, one step a move that
// is not LEFT.  Forced moves along row 0 and column 0 read nothing and
// are written a word at a time.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "launch_error.cuh"
#include "mbarrier.cuh"

namespace {

using sa_mbar::bar_arrive;
using sa_mbar::bar_init;
using sa_mbar::bar_test;
using sa_mbar::bar_wait;
using sa_mbar::clock_ns;
using sa_mbar::smem;

constexpr int kLeft = 0, kDiag = 1, kTop = 2, kStop = 3;
constexpr int kGlobal = 0, kLocal = 1, kSemi = 2;

// (a)'s shape: the run's columns (a power of 2) and the most threads a
// block; the launch halves the block while the grid has fewer blocks
// than SMs.  The least time over the main path's chunks by
// probes/batch_walk_shapes.py --time.
constexpr int kRun = 4;
constexpr int kBatchThreads = 128;

// (b)'s window: word rows x columns, 64 KB a buffer (the least time at
// the full-width walk by probes/batch_walk_shapes.py --time).
constexpr int kWinRows = 16;
constexpr int kWinCols = 1024;

template <int kMode>
__device__ __forceinline__ bool alive_at(int i, int j) {
  if (kMode == kLocal) return i > 0 && j > 0;
  if (kMode == kSemi) return i > 0;
  return i > 0 || j > 0;
}

// ---------------------------------------------------------------------
// (a) The batch walk.

struct BatchArgs {
  const int32_t* dirs;
  const int32_t* dirs2;
  const int32_t* ns;
  const int32_t* ms;
  const int32_t* bis;
  const int32_t* bjs;
  int64_t b;
  int num_w, n_cols, tile_pairs;
  int64_t max_len;
  int32_t* packed;
  int32_t* lengths;
  int32_t* fi;
  int32_t* fj;
  // Null, or the walk's trace (probe build), 9 counters: copies issued,
  // restarts, lane iterations waiting for a head, moves, warp iterations,
  // the most iterations of a warp, the first block's start and the last
  // block's end on the GPU's nanosecond clock, and the warps' ns in the
  // wait for copies.
  unsigned long long* trace;
};

__device__ __forceinline__ void copy4(uint32_t dst, const int32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// Whether a walk at (i, j) reads a word: always affine or local; a
// linear global or semi walk in row 0 or column 0 is forced.
template <int kMode, bool kAffine>
__device__ __forceinline__ bool reads_at(int i, int j) {
  return kAffine || kMode == kLocal || (i > 0 && j > 0);
}

template <int kMode, bool kAffine, int R>
__global__ void batch_walk_kernel(const BatchArgs a) {
  extern __shared__ int32_t ring[];  // [plane][R slots][blockDim]
  static_assert((R & (R - 1)) == 0 && R >= 1 && R <= 32, "run");
#ifdef SA_BATCH_WALK_ALL_SHAPES
  const bool trace = a.trace != nullptr;
#else
  constexpr bool trace = false;  // the production build writes no trace
#endif
  const long long t_start = trace ? clock_ns() : 0;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * nt + tid;
  const bool real = p < a.b;
  const int32_t* base = a.dirs;
  const int32_t* base2 = a.dirs2;
  int i = 0, j = 0;
  if (real) {
    const int64_t tile = p / a.tile_pairs;
    const int64_t offset =
        tile * a.num_w * a.n_cols * a.tile_pairs + (p - tile * a.tile_pairs);
    base += offset;
    if (kAffine) base2 += offset;
    i = kMode == kGlobal ? a.ms[p] : a.bis[p];
    j = kMode == kGlobal ? a.ns[p] : a.bjs[p];
  }
  const bool inside =
      real && i >= 0 && i <= a.num_w * 16 && j >= 0 && j <= a.n_cols;
  bool alive = inside && alive_at<kMode>(i, j);
  const int max_len = static_cast<int>(a.max_len);
  int k = 0;
  uint32_t word = 0;
  int32_t* out = a.packed + (real ? p : 0);  // move word k/16 of the pair
  int state = 0;  // affine: 0 in H, 1 in an E run, 2 in an F run
  // The run: its word row, head column and columns issued (the head and
  // those left of it); the copies issued (the ring's slot counter); the
  // iteration from which the head's copy has landed.
  int run_w = -1, run_c = 0, run_n = 0;
  unsigned cnt = 0;
  int ready = INT_MAX;
  int it = 0;
  unsigned long long restarts = 0, waiting = 0, wait_ns = 0;
  const int32_t* const mine = ring + tid;
  const uint32_t mine_s = smem(mine);
  const int bits_at = R * nt;  // the run bits' plane
  // Every lane runs every iteration's code, its moves and copies under
  // predicates: a warp's lanes wait, move and restart at different
  // iterations, and branches around them would serialise the warp.
  while (__any_sync(0xffffffffu, alive)) {
    // The head and its run bits, read whether or not needed.
    const int at = ((cnt - run_n) & (R - 1)) * nt;
    const uint32_t w1 = mine[at];
    const uint32_t w2 = kAffine ? mine[bits_at + at] : 0u;
    const bool go = alive && (!reads_at<kMode, kAffine>(i, j) || it >= ready);
    const int shift = 2 * ((max(i, 1) - 1) & 15);
    int d = (w1 >> shift) & 3;
    const int bits = (w2 >> shift) & 3;
    bool stop = false;
    if (kAffine) {
      d = state == 1 ? kLeft : (state == 2 ? kTop : d);
      if (kMode == kLocal) {
        stop = state == 0 && d == kStop;
      } else {
        d = j == 0 ? kTop : (i == 0 ? kLeft : d);
      }
    } else if (kMode != kLocal) {
      d = j == 0 ? kTop : (i == 0 ? kLeft : d);
    } else {
      stop = d == kStop;
    }
    const bool mv = go && !stop;
    alive = alive && !(go && stop);
    if (mv) word |= static_cast<uint32_t>(d) << (2 * (k & 15));
    if (mv && (k & 15) == 15) {
      *out = static_cast<int32_t>(word);
      out += a.b;
      word = 0;
    }
    k += mv;
    if (kAffine && mv) {
      state = d == kLeft && (bits & 1) ? 1 : (d == kTop && (bits & 2) ? 2 : 0);
    }
    i -= mv && (d == kDiag || d == kTop);
    j -= mv && (d == kDiag || d == kLeft);
    alive = alive && (!mv || (alive_at<kMode>(i, j) && k < max_len));
    if (trace) waiting += alive && !go;
    // The run follows the walk's cell: a new word row restarts it, a
    // column to the left consumes its head; then one more column.
    const bool keep = alive && reads_at<kMode, kAffine>(i, j);
    const int ic = max(i, 1) - 1;
    const int jc = max(j, 1) - 1;
    const int w = ic >> 4;
    const bool restart = keep && w != run_w;
    const bool consume = keep && !restart && jc != run_c;
    if (trace) restarts += restart;
    run_w = restart ? w : run_w;
    run_c = restart || consume ? jc : run_c;
    run_n = restart ? 0 : run_n - consume;
    ready = restart ? it + R : ready;
    const int col = run_c - run_n;
    if (keep && run_n < R && col >= 0) {
      const int slot = (cnt & (R - 1)) * nt;
      const int64_t src =
          (static_cast<int64_t>(w) * a.n_cols + col) * a.tile_pairs;
      copy4(mine_s + 4u * slot, base + src);
      if (kAffine) copy4(mine_s + 4u * (bits_at + slot), base2 + src);
      ++cnt;
      ++run_n;
    }
    commit_copies();
    const long long t0 = trace ? clock_ns() : 0;
    wait_copies<R - 1>();
    if (trace) wait_ns += clock_ns() - t0;
    ++it;
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  if (real) {
    if (k & 15) *out = static_cast<int32_t>(word);
    a.lengths[p] = k;
    a.fi[p] = i;
    a.fj[p] = j;
  }
  if (trace) {
    unsigned long long* t = a.trace;
    atomicAdd(t + 0, static_cast<unsigned long long>(cnt));
    atomicAdd(t + 1, restarts);
    atomicAdd(t + 2, waiting);
    atomicAdd(t + 3, static_cast<unsigned long long>(k));
    if ((tid & 31) == 0) {
      atomicAdd(t + 4, static_cast<unsigned long long>(it));
      atomicMax(t + 5, static_cast<unsigned long long>(it));
      atomicAdd(t + 8, wait_ns);
    }
    atomicMin(t + 6, static_cast<unsigned long long>(t_start));
    atomicMax(t + 7, static_cast<unsigned long long>(clock_ns()));
  }
}

template <int kMode, int R>
cudaError_t launch_batch(const BatchArgs& a, int threads, cudaStream_t s) {
  const int64_t blocks = (a.b + threads - 1) / threads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const bool affine = a.dirs2 != nullptr;
  const int bytes = R * threads * 4 * (affine ? 2 : 1);
  auto kernel = affine ? batch_walk_kernel<kMode, true, R>
                       : batch_walk_kernel<kMode, false, R>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<int>(blocks), threads, bytes, s>>>(a);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_batch_mode(const BatchArgs& a, int mode, int threads,
                              cudaStream_t s) {
  if (mode == kGlobal) return launch_batch<kGlobal, R>(a, threads, s);
  if (mode == kLocal) return launch_batch<kLocal, R>(a, threads, s);
  return launch_batch<kSemi, R>(a, threads, s);
}

// The block: `threads` if given, else the largest of kBatchThreads..32
// that still gives every SM a block.
cudaError_t batch_threads(int64_t b, int* threads) {
  if (*threads > 0) {
    return *threads % 32 == 0 && *threads <= 1024 ? cudaSuccess
                                                  : cudaErrorInvalidValue;
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  int t = kBatchThreads;
  while (t > 32 && (b + t - 1) / t < sms) t /= 2;
  *threads = t;
  return cudaSuccess;
}

cudaError_t batch_args(const int32_t* dirs, const int32_t* dirs2,
                       const int32_t* ns, const int32_t* ms,
                       const int32_t* bis, const int32_t* bjs, int64_t b,
                       int num_w, int n_cols, int tile_pairs, int mode,
                       int64_t max_len, int32_t* packed, int32_t* lengths,
                       int32_t* fi, int32_t* fj,
                       unsigned long long* trace, BatchArgs* a) {
  if (b < 0 || num_w < 1 || n_cols < 1 || tile_pairs < 1 || b % tile_pairs ||
      max_len < 16 || max_len % 16 || max_len > INT_MAX || mode < 0 ||
      mode > 2) {
    return cudaErrorInvalidValue;
  }
  *a = BatchArgs{dirs, dirs2, ns, ms, bis, bjs, b, num_w, n_cols,
                 tile_pairs, max_len, packed, lengths, fi, fj, trace};
  return cudaSuccess;
}

// ---------------------------------------------------------------------
// (b) The single-pair walk.

constexpr int kWarps = 8;  // warp 0 walks; warps 1-3 and 5-7 load
constexpr int kThreads = 32 * kWarps;
constexpr int kLoaders = 32 * 6;
constexpr int kUnroll = 8;   // loads a loader keeps in flight
constexpr int kGuard = 32;   // words before a buffer's window (see walk)
constexpr int kPollCols = 32;
constexpr int kStopRequest = -1;
constexpr int kNever = -(1 << 30);

template <int WR, int WC>
__host__ __device__ constexpr int buffer_words() {
  return kGuard + WR * WC;
}

template <int WR, int WC>
constexpr int window_bytes() {
  return 2 * buffer_words<WR, WC>() * 4;
}

struct PackedArgs {
  const int32_t* words;
  int num_w, n_cols, i0, j0, capacity;
  int32_t* moves;
  int32_t* result;
  // Null, or the walker's trace (probe build), 11 counters: windows
  // loaded, waits at a window's edge, their ns, misses, polls that found
  // the load running, switches on a poll, the first window's ns, the
  // walker's ns, moves, crossings into a word row below, steps.
  long long* trace;
};

// A window: its low word row and column, and the row and column below
// which the walk has passed its middle.
struct Window {
  int w0, c0, mid_i, mid_c;
};

struct Control {
  unsigned long long req;   // mbarrier: one arrival a request (the walker)
  unsigned long long done;  // mbarrier: kLoaders arrivals a load
  int buf, w0, c0;          // buffer (kStopRequest: quit), low row, column
};

// A loader: waits for each request and copies its share of the window
// (word rows w0 .. w0+WR-1, columns c0 .. c0+WC-1, the parts inside the
// words) into the buffer, then arrives on `done`.
template <int WR, int WC>
__device__ void load_windows(const PackedArgs& p, Control& ctl,
                             int32_t* window, int me) {
  constexpr int kBuf = buffer_words<WR, WC>();
  uint32_t parity = 0;
  for (;;) {
    bar_wait(&ctl.req, parity);
    parity ^= 1;
    const int buf = ctl.buf;
    if (buf == kStopRequest) return;
    const int w0 = ctl.w0;
    const int c0 = ctl.c0;
    int32_t* dst = window + buf * kBuf + kGuard;
    constexpr int kChunks = WC / 4;
    constexpr int kItems = WR * kChunks;
    for (int first = me; first < kItems; first += kLoaders * kUnroll) {
      int4 v[kUnroll];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int it = first + u * kLoaders;
        const int row = w0 + it / kChunks;
        const int col = c0 + 4 * (it % kChunks);
        ok[u] = it < kItems && row >= 0 && row < p.num_w && col >= 0 &&
                col < p.n_cols;
        if (ok[u]) {
          v[u] = __ldg(reinterpret_cast<const int4*>(
              p.words + static_cast<int64_t>(row) * p.n_cols + col));
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (ok[u]) {
          const int it = first + u * kLoaders;
          *reinterpret_cast<int4*>(dst + 4 * it) = v[u];
        }
      }
    }
    bar_arrive(&ctl.done);
  }
}

// Appends `n` copies of move d (forced: TOP or LEFT) to the move words,
// whole words at a time past the current one.
__device__ __forceinline__ void forced_moves(int32_t* moves, int& count,
                                             uint32_t& mw, uint32_t d,
                                             int n) {
  for (; n > 0 && (count & 15); --n) {
    mw = __funnelshift_r(mw, d, 2);
    if ((count & 15) == 15) moves[count >> 4] = static_cast<int32_t>(mw);
    ++count;
  }
  const int32_t full = d == kTop ? static_cast<int32_t>(0xAAAAAAAAu) : 0;
  for (; n >= 16; n -= 16) {
    moves[count >> 4] = full;
    count += 16;
  }
  for (; n > 0; --n) {
    mw = __funnelshift_r(mw, d, 2);
    ++count;
  }
}

// The walker (warp 0, every lane holding the same state).  The cell
// (i, j) reads word (ic/16, jc) with ic = i-1, jc = j-1; in the resident
// window it sits at kGuard + (ic/16 - w0) * WC + (jc - c0) of its
// buffer.  Lane 0 alone posts requests and writes the moves.
template <int WR, int WC, bool LOCAL>
__device__ void walk(const PackedArgs& p, Control& ctl, int32_t* window) {
  constexpr int kBuf = buffer_words<WR, WC>();
  constexpr unsigned kAll = 0xffffffffu;
  static_assert(WR >= 2 && WC >= 8 && WC % 4 == 0, "window shape");
#ifdef SA_BATCH_WALK_ALL_SHAPES
  const bool trace = p.trace != nullptr;
#else
  constexpr bool trace = false;  // the production build writes no trace
#endif
  const int lane = threadIdx.x & 31;
  long long loads = 0, waits = 0, wait_ns = 0, misses = 0, polls = 0,
            early = 0, first_ns = 0, crossings = 0, steps = 0;
  const long long t_start = trace ? clock_ns() : 0;

  int i = p.i0, j = p.j0;
  int count = 0;
  uint32_t mw = 0;  // the move word being filled, newest move on top
  int32_t* const moves = p.moves;
  const int cap = p.capacity;
  bool stopped = false;  // local: the walk met STOP
  uint32_t parity = 0;   // loads consumed, mod 2
  bool pending = false;
  if (i > 0 && j > 0 && cap > 0) {
    int ic = i - 1, jc = j - 1;
    // A window anchored at the current cell, and its middle from the
    // anchor (never, where its low edge is row 0 or column 0).
    auto request = [&](int buf, Window& w) {
      w.w0 = (ic >> 4) - WR + 1;
      w.c0 = (jc - WC + 4) & ~3;
      w.mid_i = w.w0 > 0 ? ic - (ic - w.w0 * 16 + 2) / 2 + 1 : kNever;
      w.mid_c = w.c0 > 0 ? jc - (jc - w.c0 + 2) / 2 + 1 : kNever;
      if (lane == 0) {
        ctl.buf = buf;
        ctl.w0 = w.w0;
        ctl.c0 = w.c0;
        bar_arrive(&ctl.req);
      }
      __syncwarp();
      ++loads;
    };
    auto wait_load = [&]() {
      const long long t0 = trace ? clock_ns() : 0;
      bar_wait(&ctl.done, parity);
      parity ^= 1;
      return trace ? clock_ns() - t0 : 0;
    };
    auto inside = [&](const Window& w) {
      return ic >= w.w0 * 16 && jc >= w.c0;
    };
    int cur = 0;
    Window res, next;  // the resident window, the requested one
    request(0, res);
    first_ns = wait_load();
    const int32_t* buf = window + kGuard;
    int ev_i = 0, ev_c = 0;  // the next window event: ic < ev_i, jc < ev_c
    bool event = true;
    while (i > 0 && j > 0 && count < cap) {
      ic = i - 1;
      jc = j - 1;
      if (event) {
        bool fresh = false;
        if (!pending && (ic < res.mid_i || jc < res.mid_c)) {
          request(cur ^ 1, next);
          pending = fresh = true;
        }
        if (pending) {
          const bool outside = !inside(res);
          // Lane 0's test for the whole warp; every lane then waits on
          // the completed phase, which returns at once, to read the
          // buffer the loaders wrote.
          const bool landed =
              !fresh && __shfl_sync(kAll, bar_test(&ctl.done, parity), 0);
          if (outside || landed) {
            if (outside) {
              wait_ns += wait_load();
              ++waits;
            } else {
              wait_load();
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
            buf = window + cur * kBuf + kGuard;
            if (ic < res.mid_i || jc < res.mid_c) {
              request(cur ^ 1, next);
              pending = true;
            }
          } else if (!fresh) {
            ++polls;
          }
        }
        // Pending: the resident window's edges, and the next poll 16
        // rows or kPollCols columns on; else the resident window's
        // middle.
        ev_i = pending ? max(res.w0 * 16, ic - 15) : res.mid_i;
        ev_c = pending ? max(res.c0, jc - kPollCols) : res.mid_c;
      }
      // Steps that cannot reach a window event, row 0, column 0 or the
      // end of the move buffer (a move takes ic, jc and the count by at
      // most 1).  In a step lane q reads the word of column jc - q of
      // the cell's word row (below the window's first row, the guard
      // words): the LEFT moves at their head are known before any of
      // them is made, and the warp makes them at once, then the move of
      // the first word that is not LEFT.
      int off = ((ic >> 4) - res.w0) * WC + (jc - res.c0);
      int sh = 2 * (ic & 15);
      int k = min(min(ic - ev_i, jc - ev_c), min(min(i, j), cap - count));
      k = max(k, 1);
      // The step's updates are selects under predicates: branches
      // around them put the warp's convergence barriers on the chain.
      while (k > 0) {
        ++steps;
        const uint32_t code =
            (static_cast<uint32_t>(buf[off - lane]) >> sh) & 3;
        const unsigned other = __ballot_sync(kAll, code != kLeft);
        const int left = min(other ? __ffs(other) - 1 : 32, k);
        const uint32_t d = __shfl_sync(kAll, code, left & 31);
        // The LEFT moves (00): the move word shifts in zeros, and is
        // written if it fills.
        const int r = count & 15;
        const bool full = r + left >= 16;
        if (lane == 0 && full) {
          moves[count >> 4] = static_cast<int32_t>(
              static_cast<uint64_t>(mw) >> (2 * (16 - r)));
        }
        mw = full ? 0u
                  : static_cast<uint32_t>(static_cast<uint64_t>(mw) >>
                                          (2 * min(left, 16)));
        count += left;
        off -= left;
        j -= left;
        k -= left;
        // Then the first move that is not LEFT, if the step reached it.
        const bool mv = left < 32 && k > 0;
        if (LOCAL && mv && d == kStop) {
          stopped = true;
          break;
        }
        const uint32_t mw2 = __funnelshift_r(mw, d, 2);
        if (lane == 0 && mv && (count & 15) == 15) {
          moves[count >> 4] = static_cast<int32_t>(mw2);
        }
        mw = mv ? mw2 : mw;
        count += mv;
        k -= mv;
        const bool up = mv && d != kStop;  // DIAG or TOP (global STOP: none)
        const int col = up && d == kDiag;
        const bool cross = up && sh == 0;  // into the word row below
        i -= up;
        j -= col;
        off -= col + (cross ? WC : 0);
        sh = up ? (cross ? 30 : sh - 2) : sh;
        if (trace) crossings += cross;
      }
      if (stopped) break;
      event = i - 1 < ev_i || j - 1 < ev_c;
    }
    if (pending) wait_load();
  }
  if (lane != 0) return;
  // Global: forced moves along column 0 (TOP) or row 0 (LEFT).
  if (!LOCAL && !stopped && count < cap) {
    if (j == 0 && i > 0) {
      const int n = min(i, cap - count);
      forced_moves(moves, count, mw, kTop, n);
      i -= n;
    } else if (i == 0 && j > 0) {
      const int n = min(j, cap - count);
      forced_moves(moves, count, mw, kLeft, n);
      j -= n;
    }
  }
  if (count & 15) {
    moves[count >> 4] = static_cast<int32_t>(mw >> (32 - 2 * (count & 15)));
  }
  p.result[0] = count;
  p.result[1] = i;
  p.result[2] = j;
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
    out[9] = crossings;
    out[10] = steps;
  }
}

template <int WR, int WC, bool LOCAL>
__global__ void __launch_bounds__(kThreads, 1)
    packed_walk_kernel(const PackedArgs args) {
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
    load_windows<WR, WC>(args, ctl, window,
                         (warp - 1 - (warp >> 2)) * 32 + (threadIdx.x & 31));
  } else if (warp == 0) {
    walk<WR, WC, LOCAL>(args, ctl, window);
  }
}

template <int WR, int WC>
cudaError_t launch_packed(const PackedArgs& a, bool local, cudaStream_t s) {
  constexpr int kBytes = window_bytes<WR, WC>();
  static_assert(kBytes <= 232448, "the window must fit shared memory");
  auto kernel = local ? packed_walk_kernel<WR, WC, true>
                      : packed_walk_kernel<WR, WC, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return err;
  kernel<<<1, kThreads, kBytes, s>>>(a);
  return cudaGetLastError();
}

cudaError_t packed_args(const int32_t* words, int num_w, int n_cols, int i0,
                        int j0, int32_t* moves, int64_t move_words,
                        int32_t* result, long long* trace, PackedArgs* a) {
  if (num_w < 1 || n_cols < 1 || move_words < 1 || i0 < 0 ||
      i0 > 16 * num_w || j0 < 0 || j0 > n_cols) {
    return cudaErrorInvalidValue;
  }
  // The loaders read a window row in 16-byte chunks from column c0, a
  // multiple of 4.
  if (n_cols % 4 != 0 || reinterpret_cast<uintptr_t>(words) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const int64_t capacity = move_words * 16;
  *a = PackedArgs{words, num_w, n_cols, i0, j0,
                  static_cast<int>(capacity < INT_MAX ? capacity : INT_MAX),
                  moves, result, trace};
  return cudaSuccess;
}

#ifdef SA_BATCH_WALK_ALL_SHAPES
// The shapes the all-shapes build takes: runs (the least, 1, and more)
// for (a); windows (word rows, columns) for (b), the least (2 x 8) and
// 64 KB and 32 KB buffers.
#define SA_BATCH_WALK_RUNS(X) X(1) X(2) X(4) X(8) X(16) X(32)
#define SA_PACKED_WALK_WINDOWS(X)                                         \
  X(2, 8) X(2, 8192) X(4, 4096) X(8, 2048) X(16, 1024) X(32, 512)         \
  X(64, 256) X(8, 1024) X(16, 512)

cudaError_t launch_batch_shape(const BatchArgs& a, int mode, int run,
                               int threads, cudaStream_t s) {
#define SA_BATCH_WALK_TRY(R) \
  if (run == R) return launch_batch_mode<R>(a, mode, threads, s);
  SA_BATCH_WALK_RUNS(SA_BATCH_WALK_TRY)
  return cudaErrorInvalidValue;
}

cudaError_t launch_packed_shape(const PackedArgs& a, bool local, int rows,
                                int cols, cudaStream_t s) {
#define SA_PACKED_WALK_TRY(WR, WC) \
  if (rows == WR && cols == WC) return launch_packed<WR, WC>(a, local, s);
  SA_PACKED_WALK_WINDOWS(SA_PACKED_WALK_TRY)
  return cudaErrorInvalidValue;
}
#endif

}  // namespace

// The production shapes: (a)'s run and most threads a block; (b)'s
// window rows and columns.  which: 0 run, 1 threads, 2 rows, 3 columns.
extern "C" int sa_batch_walk_shape_of(int which) {
  switch (which) {
    case 0: return kRun;
    case 1: return kBatchThreads;
    case 2: return kWinRows;
    case 3: return kWinCols;
    default: return 0;
  }
}

// Walks b pairs.  dirs: (b/tile_pairs, num_w, n_cols, tile_pairs) int32
// from K3; dirs2: null (linear) or K3's run bits, shaped like dirs; ns,
// ms, bis, bjs: (b,) int32; packed: (max_len/16, b) int32, zeroed by the
// caller; lengths, fi, fj: (b,) int32 out.  mode: 0 global, 1 local, 2
// semi.  Returns the launch's cudaError_t.
extern "C" int sa_batch_walk(const int32_t* dirs, const int32_t* dirs2,
                             const int32_t* ns, const int32_t* ms,
                             const int32_t* bis,
                             const int32_t* bjs, int64_t b, int num_w,
                             int n_cols, int tile_pairs, int mode,
                             int64_t max_len, int32_t* packed,
                             int32_t* lengths, int32_t* fi, int32_t* fj,
                             void* stream) {
  BatchArgs a;
  cudaError_t err = batch_args(dirs, dirs2, ns, ms, bis, bjs, b, num_w,
                               n_cols, tile_pairs, mode, max_len, packed,
                               lengths, fi, fj, nullptr, &a);
  if (err != cudaSuccess) return err;
  if (b == 0) return cudaSuccess;
  int threads = 0;
  err = batch_threads(b, &threads);
  if (err != cudaSuccess) return err;
  return launch_batch_mode<kRun>(a, mode, threads,
                                 static_cast<cudaStream_t>(stream));
}

// Walks one pair over (num_w, n_cols) int32 words from (i0, j0), global
// (local 0) or local; moves: (move_words,) int32, zeroed by the caller,
// room for 16*move_words moves; result: (3,) int32 = count, i, j.
// Returns the launch's cudaError_t: cudaErrorInvalidValue for a start
// outside the words, n_cols not a multiple of 4 or words not 16-byte
// aligned.
extern "C" int sa_walk_packed(const int32_t* words, int num_w, int n_cols,
                              int i0, int j0, int local, int32_t* moves,
                              int64_t move_words, int32_t* result,
                              void* stream) {
  PackedArgs a;
  const cudaError_t err = packed_args(words, num_w, n_cols, i0, j0, moves,
                                      move_words, result, nullptr, &a);
  if (err != cudaSuccess) return err;
  return launch_packed<kWinRows, kWinCols>(a, local != 0,
                                           static_cast<cudaStream_t>(stream));
}

#ifdef SA_BATCH_WALK_ALL_SHAPES
// sa_batch_walk with a run of `run` columns (one of SA_BATCH_WALK_RUNS)
// and `threads` a block (0: the production rule), for
// probes/batch_walk_shapes.py; trace: null, or 9 uint64 (BatchArgs),
// zeroed but for entry 6, UINT64_MAX.
extern "C" int sa_batch_walk_shape(
    const int32_t* dirs, const int32_t* dirs2, const int32_t* ns,
    const int32_t* ms, const int32_t* bis, const int32_t* bjs, int64_t b,
    int num_w, int n_cols, int tile_pairs, int mode, int64_t max_len,
    int32_t* packed, int32_t* lengths, int32_t* fi, int32_t* fj, int run,
    int threads, unsigned long long* trace, void* stream) {
  BatchArgs a;
  cudaError_t err = batch_args(dirs, dirs2, ns, ms, bis, bjs, b, num_w,
                               n_cols, tile_pairs, mode, max_len, packed,
                               lengths, fi, fj, trace, &a);
  if (err != cudaSuccess) return err;
  if (b == 0) return cudaSuccess;
  err = batch_threads(b, &threads);
  if (err != cudaSuccess) return err;
  return launch_batch_shape(a, mode, run, threads,
                            static_cast<cudaStream_t>(stream));
}

// sa_walk_packed with a window of `rows` x `cols` (one of
// SA_PACKED_WALK_WINDOWS); trace: null, or 11 int64 (PackedArgs).
extern "C" int sa_walk_packed_shape(const int32_t* words, int num_w,
                                    int n_cols, int i0, int j0, int local,
                                    int32_t* moves, int64_t move_words,
                                    int32_t* result, int rows, int cols,
                                    long long* trace, void* stream) {
  PackedArgs a;
  const cudaError_t err = packed_args(words, num_w, n_cols, i0, j0, moves,
                                      move_words, result, trace, &a);
  if (err != cudaSuccess) return err;
  return launch_packed_shape(a, local != 0, rows, cols,
                             static_cast<cudaStream_t>(stream));
}
#endif
