// The host side of K3 (interpair.cu, int32 cells) and K3-cell16
// (interpair16.cu, int16 cells): the argument checks, the shape in code,
// the launch and the bodies of both sources' C entries, templated on the
// traits T each source defines beside its kernel: T::Word, a word of the
// row and frow scratch; T::kPerLane, pairs a lane (1 or 2: a CTA takes
// kWarp * kPerLane pairs, and with two the batch and, with words,
// tile_pairs must be even); T::kernel<kMode, kDirs, kAffine, kSB,
// kSearch>(), the kernel's instance; and T::warps_of and T::block_of, the
// variant's most warps a CTA on a grid that fills the card and its
// columns a block.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "interpair_chain.cuh"

namespace interpair_host {

using namespace interpair_chain;

template <class T>
struct Args {
  const int8_t *texts, *patterns;
  const int32_t *ns, *ms, *score_matrix;
  int k, gap, ge;
  int64_t b;
  int n_cols, m_rows, tile_pairs;
  typename T::Word *row, *frow;
  int32_t *scores, *best_is, *best_js, *dirs, *dirs2, *trace;
  const int64_t* groups;
  int grid, warps, sb;  // CTAs, warps a CTA, columns a block
  cudaStream_t stream;
};

template <class T, int kMode, bool kDirs, bool kAffine, int kSB, bool kSearch>
cudaError_t launch(const Args<T>& a) {
  const auto kernel = T::template kernel<kMode, kDirs, kAffine, kSB, kSearch>();
  const int ring_bytes = (kAffine ? 2 : 1) * a.warps * kRingCols * kWarp *
                         sizeof(typename T::Word);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ring_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<a.grid, a.warps * kWarp, ring_bytes, a.stream>>>(
      a.texts, a.patterns, a.ns, a.ms, a.score_matrix, a.k, a.gap, a.ge,
      a.b, a.n_cols, a.m_rows, a.tile_pairs, a.row, a.frow, a.scores,
      a.best_is, a.best_js, a.dirs, a.dirs2, a.trace, a.groups);
  return cudaGetLastError();
}

template <class T, int kMode, bool kDirs, bool kAffine, bool kSearch>
cudaError_t launch_block(const Args<T>& a) {
#ifdef SA_INTERPAIR_ALL_SHAPES
  switch (a.sb) {
    case 2: return launch<T, kMode, kDirs, kAffine, 2, kSearch>(a);
    case 4: return launch<T, kMode, kDirs, kAffine, 4, kSearch>(a);
    case 8: return launch<T, kMode, kDirs, kAffine, 8, kSearch>(a);
    case 16: return launch<T, kMode, kDirs, kAffine, 16, kSearch>(a);
    default: return cudaErrorInvalidValue;
  }
#else
  constexpr int kSB = T::block_of(kDirs, kAffine);
  if (a.sb != kSB) return cudaErrorInvalidValue;
  return launch<T, kMode, kDirs, kAffine, kSB, kSearch>(a);
#endif
}

template <class T, int kMode>
cudaError_t launch_mode(const Args<T>& a, bool with_dirs, bool affine) {
  // The search layout's score-only instances of their own (kSearch).
  if (a.groups != nullptr) {
    return affine ? launch_block<T, kMode, false, true, true>(a)
                  : launch_block<T, kMode, false, false, true>(a);
  }
  if (affine) {
    return with_dirs ? launch_block<T, kMode, true, true, false>(a)
                     : launch_block<T, kMode, false, true, false>(a);
  }
  return with_dirs ? launch_block<T, kMode, true, false, false>(a)
                   : launch_block<T, kMode, false, false, false>(a);
}

// The warps a CTA runs in code for a batch of b pairs on a card of `sms`
// SMs: the variant's most (warps_of), or kMaxWarps when the grid has
// fewer CTAs than the card has SMs (a long pair of a ragged batch then
// runs on an SM of its own, and its chain has every warp a CTA may
// take), evened over the passes of the stripes of m_rows rows.
template <class T>
int warps_in_code(bool with_dirs, bool affine, int m_rows, int64_t b,
                  int sms) {
  constexpr int kPairs = kWarp * T::kPerLane;
  const int64_t ctas = (b + kPairs - 1) / kPairs;
  const int most = ctas < sms ? kMaxWarps : T::warps_of(with_dirs, affine);
  const int stripes = max((m_rows + kRows - 1) / kRows, 1);
  const int passes = (stripes + most - 1) / most;
  return (stripes + passes - 1) / passes;
}

// The number of SMs of the current device.
inline cudaError_t multiprocessors(int* sms) {
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

// The fill of b pairs at `warps` warps a CTA and `sb` columns a block
// (sa_interpair[16]_fill_shape), or with kInCode at the shape in code
// (sa_interpair[16]_fill and _search, which pass 0 for both).
template <class T, bool kInCode = false>
int fill(const int8_t* texts, const int8_t* patterns, const int32_t* ns,
         const int32_t* ms, const int32_t* score_matrix, int k, int gap,
         int gap_extend, int affine, int64_t b, int n_cols, int m_rows,
         int tile_pairs, int mode, int with_dirs, int32_t* row,
         int32_t* frow, int32_t* scores, int32_t* best_is, int32_t* best_js,
         int32_t* dirs, int32_t* dirs2, int warps, int sb, int32_t* trace,
         const int64_t* groups, void* stream) {
  const bool d = with_dirs != 0;
  const bool af = affine != 0;
  if (kInCode) {
    int sms = 0;
    const cudaError_t err = multiprocessors(&sms);
    if (err != cudaSuccess) return err;
    warps = warps_in_code<T>(d, af, m_rows, b, sms);
    sb = T::block_of(d, af);
  }
  constexpr int kPer = T::kPerLane;
  if (k < 1 || k > 32 || b < 0 || b % kPer || n_cols < 1 || m_rows < 1 ||
      tile_pairs < 1 || mode < 0 || mode > 2 ||
      (with_dirs && (m_rows % kRows || tile_pairs % kPer || b % tile_pairs)) ||
      (groups != nullptr && (with_dirs || b % (2 * kWarp))) ||
      (affine && (frow == nullptr || (with_dirs && dirs2 == nullptr))) ||
      warps < 1 || warps > kMaxWarps) {
    return cudaErrorInvalidValue;
  }
  if (b == 0) return cudaSuccess;
  const int64_t blocks = (b + kWarp * kPer - 1) / (kWarp * kPer);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  using Word = typename T::Word;
  const Args<T> a{texts, patterns, ns, ms, score_matrix, k, gap,
                  affine ? gap_extend : 0, b, n_cols, m_rows, tile_pairs,
                  reinterpret_cast<Word*>(row), reinterpret_cast<Word*>(frow),
                  scores, best_is, best_js, dirs, dirs2, trace, groups,
                  static_cast<int>(blocks), warps, sb,
                  static_cast<cudaStream_t>(stream)};
  if (mode == kGlobal) return launch_mode<T, kGlobal>(a, d, af);
  if (mode == kLocal) return launch_mode<T, kLocal>(a, d, af);
  return launch_mode<T, kSemi>(a, d, af);
}

// The body of sa_interpair[16]_search, at the shape in code.
template <class T>
int search(const int8_t* texts, const int64_t* groups,
           const int8_t* patterns, const int32_t* ns, const int32_t* ms,
           const int32_t* score_matrix, int k, int gap, int gap_extend,
           int affine, int64_t b, int n_cols, int m_rows, int mode,
           int32_t* row, int32_t* frow, int32_t* scores, void* stream) {
  if (groups == nullptr) return cudaErrorInvalidValue;
  // Score-only: tile_pairs (any even) places no word.
  return fill<T, true>(texts, patterns, ns, ms, score_matrix, k, gap,
                       gap_extend, affine, b, n_cols, m_rows, 128, mode, 0,
                       row, frow, scores, nullptr, nullptr, nullptr, nullptr,
                       0, 0, nullptr, groups, stream);
}

// The body of sa_interpair[16]_shape.
template <class T>
void shape(int with_dirs, int affine, int m_rows, int64_t b, int* out) {
  const bool d = with_dirs != 0;
  const bool af = affine != 0;
  int sms = 0;
  out[0] = multiprocessors(&sms) == cudaSuccess
               ? warps_in_code<T>(d, af, m_rows, b, sms)
               : 0;
  out[1] = T::block_of(d, af);
  out[2] = kMaxWarps;
  out[3] = T::warps_of(d, af);
}

}  // namespace interpair_host
