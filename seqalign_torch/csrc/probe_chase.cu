// P1: the cost of a dependent chain of scalar loads, from shared memory,
// from L2 and from HBM.
//
// Replaces scripts/probe_walk_costs.py::probe_pallas_chase (the dev probe
// that timed the same chain over a 2 MiB VMEM table inside a Pallas
// kernel, which guided the walkers' design).  One thread runs the TPU
// kernel's recurrence over a (rows, 128) int32 table, rows a power of
// two: acc = seed, r0 = seed & (rows - 1), r2 = 0; step k reads
// v = table[r0][r2], then acc += v, r0 = (v + k) & (rows - 1),
// r2 = (v >> 6) & 127.  acc (wrapping int32) is the result.
//
// What bounds it: latency, not bandwidth or issue: each load's address
// depends on the value the load before it returned, so the time a step
// is the latency of one load plus a few integer operations.  That is the
// number it measures, for three places of the table: shared memory (the
// block loads the table first, every thread at once, then one thread
// chases), L2 and HBM (ld.global.cg, which skips L1, so a table larger
// than L2 is read from HBM and one under L2's 50 MB, once warm, from L2).

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_error.cuh"

namespace {

constexpr int kLane = 128;
constexpr int kLoadThreads = 1024;

__global__ void __launch_bounds__(kLoadThreads) chase_shared(
    const int32_t* __restrict__ table, int rows, int steps, int seed,
    int32_t* __restrict__ out) {
  extern __shared__ int32_t tab[];
  const int words = rows * kLane;
  for (int x = threadIdx.x; x < words; x += blockDim.x) tab[x] = table[x];
  __syncthreads();
  if (threadIdx.x != 0) return;
  uint32_t acc = static_cast<uint32_t>(seed);
  int r0 = seed & (rows - 1);
  int r2 = 0;
  for (int k = 0; k < steps; ++k) {
    const int v = tab[r0 * kLane + r2];
    acc += static_cast<uint32_t>(v);
    r0 = (v + k) & (rows - 1);
    r2 = (v >> 6) & (kLane - 1);
  }
  out[0] = static_cast<int32_t>(acc);
}

__global__ void chase_global(const int32_t* __restrict__ table, int rows,
                             int steps, int seed, int32_t* __restrict__ out) {
  uint32_t acc = static_cast<uint32_t>(seed);
  int r0 = seed & (rows - 1);
  int r2 = 0;
  for (int k = 0; k < steps; ++k) {
    const int v = __ldcg(table + static_cast<int64_t>(r0) * kLane + r2);
    acc += static_cast<uint32_t>(v);
    r0 = (v + k) & (rows - 1);
    r2 = (v >> 6) & (kLane - 1);
  }
  out[0] = static_cast<int32_t>(acc);
}

}  // namespace

// Runs the chase over table (rows x 128 int32, rows a power of two) for
// `steps` steps from `seed`, writing acc to out[0]: from shared memory
// with shared = 1 (the table must fit one block's 227 KB), else from
// global memory.  Returns the launch's cudaError_t.
extern "C" int sa_probe_chase(const int32_t* table, int rows, int steps,
                              int seed, int shared, int32_t* out,
                              void* stream) {
  if (rows < 1 || (rows & (rows - 1)) || steps < 0) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (shared) {
    const size_t bytes = static_cast<size_t>(rows) * kLane * sizeof(int32_t);
    cudaError_t err = cudaFuncSetAttribute(
        chase_shared, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    chase_shared<<<1, kLoadThreads, bytes, s>>>(table, rows, steps, seed,
                                                 out);
  } else {
    chase_global<<<1, 1, 0, s>>>(table, rows, steps, seed, out);
  }
  return cudaGetLastError();
}
