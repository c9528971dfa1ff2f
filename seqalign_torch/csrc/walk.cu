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
// What bounds it on an H100: every move depends on the word the last
// one read, so the walk is a chain of dependent loads from device
// memory (the words of a large pair are far bigger than the 50 MB L2),
// one latency per move; the bytes and operations are negligible.  An
// affine move reads its word and its run bits with two independent
// loads, so they share the latency.
//
// What the design does about it: nothing yet.  One thread chases the
// path with plain global loads, keeping the current move word in a
// register and storing it once per 16 moves.  Staging a window of word
// rows in shared memory ahead of the walk, as the TPU walker does in
// VMEM, is left for later.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_error.cuh"

namespace {

constexpr int kLeft = 0, kDiag = 1, kTop = 2, kStop = 3;

// AFFINE is a template parameter so that the linear walk keeps the loop
// it had without the gap state: its move chain is the latency that bounds
// the kernel.
template <bool AFFINE>
__global__ void walk_skewed_kernel(const int32_t* __restrict__ words,
                                   const int32_t* __restrict__ words2,
                                   int rps, int slots, int row_lo,
                                   int col_lo, int i0, int j0, int state0,
                                   int local, int32_t* __restrict__ moves,
                                   int64_t capacity,
                                   int32_t* __restrict__ result) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  int i = i0;
  int j = j0;
  int state = state0;
  int64_t count = 0;
  int done = 0;
  uint32_t move_word = 0;
  while (!done && i > row_lo && j > col_lo) {
    if (count >= capacity) break;
    const int il = i - row_lo - 1;
    const int s = il / rps;
    const int r = il - s * rps;
    const int t = j - col_lo - 1 + s;
    const int64_t idx = (static_cast<int64_t>(t >> 4) * rps + r) * slots + s;
    const int32_t word = words[idx];
    const int32_t word2 = AFFINE ? words2[idx] : 0;
    const int shift = 2 * (t & 15);
    int d = (word >> shift) & 3;
    if (AFFINE && state != 0) d = state == 1 ? kLeft : kTop;
    if (local && state == 0 && d == kStop) {
      done = 1;
      break;
    }
    move_word |= static_cast<uint32_t>(d) << (2 * (count & 15));
    if ((count & 15) == 15) {
      moves[count >> 4] = static_cast<int32_t>(move_word);
      move_word = 0;
    }
    ++count;
    if (AFFINE) {
      const int bits = (word2 >> shift) & 3;
      state = d == kLeft && (bits & 1) ? 1
              : (d == kTop && (bits & 2) ? 2 : 0);
    }
    if (d == kDiag || d == kTop) --i;
    if (d == kDiag || d == kLeft) --j;
    if (local && (i == 0 || j == 0)) done = 1;
  }
  if (count & 15) moves[count >> 4] = static_cast<int32_t>(move_word);
  result[0] = static_cast<int32_t>(count);
  result[1] = i;
  result[2] = j;
  result[3] = state;
  result[4] = done;
}

}  // namespace

// Walks from (i0, j0) in state state0.  words: (W, slots) int32 skewed
// words; words2: null (linear; state0 must be 0) or the run bits, shaped
// like words; moves: (move_words,) int32, room for 16*move_words moves;
// result: (5,) int32 = count, i, j, state, done.  Returns the launch's
// cudaError_t.
extern "C" int sa_walk_skewed(const int32_t* words, const int32_t* words2,
                              int rps, int slots, int row_lo, int col_lo,
                              int i0, int j0, int state0, int local,
                              int32_t* moves, int64_t move_words,
                              int32_t* result, void* stream) {
  if (rps < 1 || slots < 1 || move_words < 0 || state0 < 0 || state0 > 2 ||
      (words2 == nullptr && state0 != 0)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = words2 != nullptr ? walk_skewed_kernel<true>
                                  : walk_skewed_kernel<false>;
  kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      words, words2, rps, slots, row_lo, col_lo, i0, j0, state0, local,
      moves, move_words * 16, result);
  return cudaGetLastError();
}
