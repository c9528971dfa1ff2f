// K4: per-pair traceback walk over K3's direction words, linear or
// affine (Gotoh) gaps.
//
// Replaces seqalign_tpu/ops/batch_traceback.py::_batch_walker_kernel
// (launched by batch_pallas_traceback) in its linear and affine modes;
// its state machine is also that of the lockstep walk
// batch_device_traceback.
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
// walks no move.
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
// What bounds it on an H100: each move depends on the word the last one
// read, so a walk is a chain of dependent loads; the words of one
// 16,384-pair chunk of 256 x 256 pairs (256 MiB) exceed the 50 MB L2.
// The bytes (one word read a move; affine, the word of each move taken
// in state H and the run bits of each LEFT or TOP move) and operations
// are small: latency bounds it, hidden only by the number of walks in
// flight.  An
// affine move reads its run bits beside its word, with two independent
// loads that share the latency (one inside a run, where the word is not
// needed).
//
// What the design does about it: one thread a pair, so every pair of
// the chunk has one load in flight at a time and the latencies overlap
// across the 16,384 threads.  The words are read in place, at 64-bit
// offsets: the TPU walker's pair-major transpose and VMEM window exist
// for Mosaic and are not needed.  The current move word stays in a
// register and is stored once per 16 moves, [word][pair], so a warp's
// stores are coalesced.  The block size is the largest of 128..32
// threads that still gives at least one block per SM.  The affine mode
// is a template parameter, so the linear instances (also the strip
// engine's single-pair walk) keep their loop unchanged.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_error.cuh"

namespace {

constexpr int kLeft = 0, kDiag = 1, kTop = 2, kStop = 3;
constexpr int kGlobal = 0, kLocal = 1, kSemi = 2;
constexpr int kThreads = 128;

template <int kMode>
__device__ __forceinline__ bool alive_at(int i, int j) {
  if (kMode == kLocal) return i > 0 && j > 0;
  if (kMode == kSemi) return i > 0;
  return i > 0 || j > 0;
}

template <int kMode, bool kAffine>
__global__ void __launch_bounds__(kThreads) batch_walk_kernel(
    const int32_t* __restrict__ dirs, const int32_t* __restrict__ dirs2,
    const int32_t* __restrict__ ns, const int32_t* __restrict__ ms,
    const int32_t* __restrict__ bis, const int32_t* __restrict__ bjs,
    int64_t b, int num_w, int n_cols, int tile_pairs, int64_t max_len,
    int32_t* __restrict__ packed, int32_t* __restrict__ lengths,
    int32_t* __restrict__ fi, int32_t* __restrict__ fj) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (p >= b) return;
  const int64_t tile = p / tile_pairs;
  const int64_t slot = p - tile * tile_pairs;
  const int64_t offset = tile * num_w * n_cols * tile_pairs + slot;
  const int32_t* base = dirs + offset;
  const int32_t* base2 = kAffine ? dirs2 + offset : nullptr;
  int i = kMode == kGlobal ? ms[p] : bis[p];
  int j = kMode == kGlobal ? ns[p] : bjs[p];
  const bool inside = i >= 0 && i <= num_w * 16 && j >= 0 && j <= n_cols;
  bool alive = inside && alive_at<kMode>(i, j);
  int64_t k = 0;
  uint32_t word = 0;
  int state = 0;  // affine: 0 in H, 1 in an E run, 2 in an F run
  while (alive && k < max_len) {
    int d;
    int bits = 0;
    if (kAffine) {
      const int ic = max(i, 1) - 1;
      const int jc = max(j, 1) - 1;
      const int64_t at = (static_cast<int64_t>(ic >> 4) * n_cols + jc) *
                         tile_pairs;
      const int shift = 2 * (ic & 15);
      bits = (base2[at] >> shift) & 3;
      d = state == 1 ? kLeft
                     : (state == 2 ? kTop : (base[at] >> shift) & 3);
      if (kMode == kLocal) {
        if (state == 0 && d == kStop) break;
      } else if (j == 0) {
        d = kTop;
      } else if (i == 0) {
        d = kLeft;
      }
    } else if (kMode != kLocal && j == 0) {
      d = kTop;
    } else if (kMode != kLocal && i == 0) {
      d = kLeft;
    } else {
      const int ic = max(i, 1) - 1;
      const int jc = max(j, 1) - 1;
      const int64_t at = (static_cast<int64_t>(ic >> 4) * n_cols + jc) *
                         tile_pairs;
      d = (base[at] >> (2 * (ic & 15))) & 3;
      if (kMode == kLocal && d == kStop) break;
    }
    word |= static_cast<uint32_t>(d) << (2 * (k & 15));
    if ((k & 15) == 15) {
      packed[(k >> 4) * b + p] = static_cast<int32_t>(word);
      word = 0;
    }
    ++k;
    if (kAffine) {
      state = d == kLeft && (bits & 1) ? 1 : (d == kTop && (bits & 2) ? 2 : 0);
    }
    if (d == kDiag || d == kTop) --i;
    if (d == kDiag || d == kLeft) --j;
    alive = alive_at<kMode>(i, j);
  }
  if (k & 15) packed[(k >> 4) * b + p] = static_cast<int32_t>(word);
  lengths[p] = static_cast<int32_t>(k);
  fi[p] = i;
  fj[p] = j;
}

template <int kMode>
void launch(bool affine, int grid, int threads, cudaStream_t s,
            const int32_t* dirs, const int32_t* dirs2, const int32_t* ns,
            const int32_t* ms, const int32_t* bis, const int32_t* bjs,
            int64_t b, int num_w, int n_cols, int tile_pairs, int64_t max_len,
            int32_t* packed, int32_t* lengths, int32_t* fi, int32_t* fj) {
  auto kernel = affine ? batch_walk_kernel<kMode, true>
                       : batch_walk_kernel<kMode, false>;
  kernel<<<grid, threads, 0, s>>>(dirs, dirs2, ns, ms, bis, bjs, b, num_w,
                                  n_cols, tile_pairs, max_len, packed,
                                  lengths, fi, fj);
}

}  // namespace

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
  if (b < 0 || num_w < 1 || n_cols < 1 || tile_pairs < 1 || b % tile_pairs ||
      max_len < 16 || max_len % 16 || mode < 0 || mode > 2) {
    return cudaErrorInvalidValue;
  }
  if (b == 0) return cudaSuccess;
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  int threads = kThreads;
  while (threads > 32 && (b + threads - 1) / threads < sms) threads /= 2;
  const int64_t blocks = (b + threads - 1) / threads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int grid = static_cast<int>(blocks);
  const bool affine = dirs2 != nullptr;
  if (mode == kGlobal) {
    launch<kGlobal>(affine, grid, threads, s, dirs, dirs2, ns, ms, bis, bjs,
                    b, num_w, n_cols, tile_pairs, max_len, packed, lengths,
                    fi, fj);
  } else if (mode == kLocal) {
    launch<kLocal>(affine, grid, threads, s, dirs, dirs2, ns, ms, bis, bjs,
                   b, num_w, n_cols, tile_pairs, max_len, packed, lengths,
                   fi, fj);
  } else {
    launch<kSemi>(affine, grid, threads, s, dirs, dirs2, ns, ms, bis, bjs,
                  b, num_w, n_cols, tile_pairs, max_len, packed, lengths,
                  fi, fj);
  }
  return cudaGetLastError();
}
