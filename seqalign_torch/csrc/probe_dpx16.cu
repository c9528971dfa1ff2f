// P2: which packed int16 (s16x2) formulations of the int16 cell mode's
// operations are exact on Hopper, and how fast each runs beside its
// int32 counterpart.
//
// Replaces scripts/mosaic_micro_probe.py::_run (the dev probe that asked
// Mosaic, for each int16 op pattern of seqalign_tpu/ops/pallas_fill.py's
// cell16 mode, whether a TPU lowers it).  On the card every pattern
// compiles; the questions are exactness and rate.  Variant v of
// op16<v> takes three words, each two int16 lanes (the low half first),
// and gives a word of two int16 results; op32<v> is the int32 counterpart
// of a variant, one lane a word.  The expressions are those of the
// Python side (seqalign_torch/probes/dpx16.py), which holds them against
// torch.int16 arithmetic (wrapping, as jax.numpy's).
//
// Two kernels a variant: apply writes op(a[i], b[i], c[i]) for every word
// (the exactness check; bound by its bytes), and rate runs the op many
// times on words held in registers, eight chains a thread (bound by the
// issue rate of the op's instructions, which is what it measures).  Each
// op of the rate kernel takes its second and third operands from the
// next two chains, so every result is a new value: with operands fixed
// for the whole loop, ptxas may fold repeats of an idempotent op (max,
// min, or) or of an add, and an empty asm statement cannot stop it (it
// leaves nothing in the PTX that ptxas reads).  The loop is unrolled
// kUnroll times, so its body holds kUnroll x kChains ops, which is what
// `python -m seqalign_torch.probes.dpx16 --sass` counts instructions
// against.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_error.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChains = 8;
constexpr int kUnroll = 4;

__device__ __forceinline__ int lo16(uint32_t x) {
  return static_cast<int16_t>(x & 0xFFFFu);
}

__device__ __forceinline__ int hi16(uint32_t x) {
  return static_cast<int32_t>(x) >> 16;
}

__device__ __forceinline__ uint32_t pack(int lo, int hi) {
  return (static_cast<uint32_t>(lo) & 0xFFFFu) |
         (static_cast<uint32_t>(hi) << 16);
}

constexpr uint32_t kOnes = 0x00010001u;

// add.s16x2 as one PTX instruction (sm_90).
__device__ __forceinline__ uint32_t add_s16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("add.s16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// The int16 variants, numbered as VARIANTS16 in probes/dpx16.py.
template <int V>
__device__ __forceinline__ uint32_t op16(uint32_t a, uint32_t b,
                                         uint32_t c) {
  if constexpr (V == 0) {  // cmp16: where(a > b, a, b + 1)
    const uint32_t m = __vcmpgts2(a, b);
    return (a & m) | (__vadd2(b, kOnes) & ~m);
  } else if constexpr (V == 1) {  // cmp32_sel16: compare widened halves
    return pack(lo16(a) > lo16(b) ? lo16(a) : lo16(b) + 1,
                hi16(a) > hi16(b) ? hi16(a) : hi16(b) + 1);
  } else if constexpr (V == 2) {  // cmp16_to_val: (a > b) + b
    return __vadd2(__vcmpgts2(a, b) & kOnes, b);
  } else if constexpr (V == 3) {  // cmp32_to_val16: widened compare, packed add
    return __vadd2(pack(lo16(a) > lo16(b), hi16(a) > hi16(b)), b);
  } else if constexpr (V == 4) {  // cmp32_val32_narrow: all widened
    return pack((lo16(a) > lo16(b)) + lo16(b), (hi16(a) > hi16(b)) + hi16(b));
  } else if constexpr (V == 5) {  // max16: max(a, b - 1)
    return __vmaxs2(a, __vsub2(b, kOnes));
  } else if constexpr (V == 6) {  // shr16_var: (a >> (b & 7)) & 0xFF
    return pack((lo16(a) >> (lo16(b) & 7)) & 0xFF,
                (hi16(a) >> (hi16(b) & 7)) & 0xFF);
  } else if constexpr (V == 7) {  // eq16_arith: 1 - min(|a - b|, 1)
    return __vsub2(kOnes, __vmins2(__vabs2(__vsub2(a, b)), kOnes));
  } else if constexpr (V == 8) {  // ext_narrow: int16(int32(a) + int32(b))
    return pack(lo16(a) + lo16(b), hi16(a) + hi16(b));
  } else if constexpr (V == 9) {  // add16
    return __vadd2(a, b);
  } else if constexpr (V == 10) {  // sub16
    return __vsub2(a, b);
  } else if constexpr (V == 11) {  // mul16 (no packed multiply)
    return pack(lo16(a) * lo16(b), hi16(a) * hi16(b));
  } else if constexpr (V == 12) {  // or16
    return a | b;
  } else if constexpr (V == 13) {  // shl16_const: (a << 1) + b
    return __vadd2((a << 1) & 0xFFFEFFFEu, b);
  } else if constexpr (V == 14) {  // min16: min(a, b - 1)
    return __vmins2(a, __vsub2(b, kOnes));
  } else if constexpr (V == 15) {  // cmp16_zero: where(a > 0, a, b)
    const uint32_t m = __vcmpgts2(a, 0u);
    return (a & m) | (b & ~m);
  } else if constexpr (V == 16) {  // vimax3: max(a, b, c)
    return __vimax3_s16x2(a, b, c);
  } else if constexpr (V == 17) {  // viaddmax: max(a + b, c)
    return __viaddmax_s16x2(a, b, c);
  } else if constexpr (V == 18) {  // viaddmax_relu: max(a + b, c, 0)
    return __viaddmax_s16x2_relu(a, b, c);
  } else if constexpr (V == 19) {  // vibmax: max(a, b) + (a >= b)
    bool hi, lo;
    const uint32_t m = __vibmax_s16x2(a, b, &hi, &lo);
    return __vadd2(m, pack(lo, hi));
  } else if constexpr (V == 20) {  // vimax_relu: max(a, b, 0)
    return __vimax_s16x2_relu(a, b);
  } else {  // V == 21, add16_asm: add.s16x2
    return add_s16x2(a, b);
  }
}

constexpr int kVariants16 = 22;

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

// The int32 counterparts, numbered as VARIANTS32 in probes/dpx16.py.
template <int V>
__device__ __forceinline__ int op32(int a, int b, int c) {
  if constexpr (V == 0) {  // sel32: where(a > b, a, b + 1)
    return a > b ? a : wrap_add(b, 1);
  } else if constexpr (V == 1) {  // cmp32: (a > b) + b
    return wrap_add(a > b, b);
  } else if constexpr (V == 2) {  // max32: max(a, b - 1)
    return max(a, wrap_sub(b, 1));
  } else if constexpr (V == 3) {  // shr32_var: (a >> (b & 7)) & 0xFF
    return (a >> (b & 7)) & 0xFF;
  } else if constexpr (V == 4) {  // eq32_arith: 1 - min(|a - b|, 1)
    const int d = wrap_sub(a, b);
    return wrap_sub(1, min(d < 0 ? wrap_sub(0, d) : d, 1));
  } else if constexpr (V == 5) {  // add32
    return wrap_add(a, b);
  } else if constexpr (V == 6) {  // sub32
    return wrap_sub(a, b);
  } else if constexpr (V == 7) {  // mul32
    return static_cast<int>(static_cast<uint32_t>(a) *
                            static_cast<uint32_t>(b));
  } else if constexpr (V == 8) {  // or32
    return a | b;
  } else if constexpr (V == 9) {  // shl32_const: (a << 1) + b
    return wrap_add(static_cast<int>(static_cast<uint32_t>(a) << 1), b);
  } else if constexpr (V == 10) {  // min32: min(a, b - 1)
    return min(a, wrap_sub(b, 1));
  } else if constexpr (V == 11) {  // sel32_zero: where(a > 0, a, b)
    return a > 0 ? a : b;
  } else if constexpr (V == 12) {  // vimax3_s32
    return __vimax3_s32(a, b, c);
  } else if constexpr (V == 13) {  // viaddmax_s32
    return __viaddmax_s32(a, b, c);
  } else if constexpr (V == 14) {  // viaddmax_s32_relu
    return __viaddmax_s32_relu(a, b, c);
  } else if constexpr (V == 15) {  // vibmax_s32: max(a, b) + (a >= b)
    bool pred;
    const int m = __vibmax_s32(a, b, &pred);
    return wrap_add(m, pred);
  } else {  // V == 16, vimax_s32_relu
    return __vimax_s32_relu(a, b);
  }
}

constexpr int kVariants32 = 17;

template <int V, bool k16>
__device__ __forceinline__ uint32_t op(uint32_t a, uint32_t b, uint32_t c) {
  if constexpr (k16) {
    return op16<V>(a, b, c);
  } else {
    return static_cast<uint32_t>(op32<V>(static_cast<int>(a),
                                         static_cast<int>(b),
                                         static_cast<int>(c)));
  }
}

template <int V, bool k16>
__global__ void __launch_bounds__(kThreads) apply_kernel(
    const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
    const uint32_t* __restrict__ c, uint32_t* __restrict__ out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    out[i] = op<V, k16>(a[i], b[i], c[i]);
  }
}

template <int V, bool k16>
__global__ void __launch_bounds__(kThreads) rate_kernel(
    const uint32_t* __restrict__ words, uint32_t* __restrict__ out,
    int64_t n, int reps) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  uint32_t x[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k) {
    x[k] = words[(3 * tid + k) % n] ^ (0x9E3779B9u * k);
  }
#pragma unroll kUnroll
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      x[k] = op<V, k16>(x[k], x[(k + 1) % kChains], x[(k + 2) % kChains]);
    }
  }
  uint32_t folded = 0;
#pragma unroll
  for (int k = 0; k < kChains; ++k) folded ^= x[k];
  out[tid] = folded;
}

template <int V, bool k16>
cudaError_t launch_one(int which, const uint32_t* a, const uint32_t* b,
                       const uint32_t* c, uint32_t* out, int64_t n,
                       int blocks, int reps, cudaStream_t s) {
  if (which == 0) {
    apply_kernel<V, k16><<<blocks, kThreads, 0, s>>>(a, b, c, out, n);
  } else {
    rate_kernel<V, k16><<<blocks, kThreads, 0, s>>>(a, out, n, reps);
  }
  return cudaGetLastError();
}

// Dispatch a runtime variant number to its template instance.
template <int V, bool k16>
cudaError_t dispatch(int v, int which, const uint32_t* a, const uint32_t* b,
                     const uint32_t* c, uint32_t* out, int64_t n, int blocks,
                     int reps, cudaStream_t s) {
  if (v == V) return launch_one<V, k16>(which, a, b, c, out, n, blocks, reps, s);
  if constexpr (V + 1 < (k16 ? kVariants16 : kVariants32)) {
    return dispatch<V + 1, k16>(v, which, a, b, c, out, n, blocks, reps, s);
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace

// which = 0: out[i] = op(a[i], b[i], c[i]) for i < n (n words of two int16
// lanes with int16 = 1, else of one int32 lane), a grid of `blocks`
// blocks of 256 threads striding over the words.  which = 1: the rate
// kernel, blocks x 256 threads, each running reps rounds of the op on
// its 8 chains (chain k takes chains k+1 and k+2, mod 8, as operands),
// the chains started from words of a (n words), one word a thread
// written to out.
// Returns the launch's cudaError_t.
extern "C" int sa_probe_dpx16(int int16, int variant, int which,
                              const uint32_t* a, const uint32_t* b,
                              const uint32_t* c, uint32_t* out, int64_t n,
                              int blocks, int reps, void* stream) {
  if (n < 1 || blocks < 1 || reps < 0 || (which != 0 && which != 1)) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (int16) return dispatch<0, true>(variant, which, a, b, c, out, n, blocks, reps, s);
  return dispatch<0, false>(variant, which, a, b, c, out, n, blocks, reps, s);
}
