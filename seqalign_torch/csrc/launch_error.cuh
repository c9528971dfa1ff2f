// The name and text of a cudaError_t, for the Python wrappers' launch
// failures.  Every kernel library includes this header, so each exports
// the same helper; ops/_build.py::check_launch reads it through the
// library whose launch failed.

#pragma once

#include <cuda_runtime.h>
#include <stdio.h>

// Writes "<name>: <text>" of error code `code` (e.g.
// "cudaErrorMemoryAllocation: out of memory") into out[0..size), always
// NUL-terminated.  Returns the length snprintf reports.
extern "C" int sa_error_text(int code, char* out, int size) {
  const auto err = static_cast<cudaError_t>(code);
  return snprintf(out, static_cast<size_t>(size), "%s: %s",
                  cudaGetErrorName(err), cudaGetErrorString(err));
}
