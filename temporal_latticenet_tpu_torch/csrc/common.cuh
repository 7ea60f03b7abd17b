// Shared by the port's CUDA sources: the plain C export macro and the error
// string every library exposes to its ctypes wrapper.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define TLN_API extern "C" __attribute__((visibility("default")))

TLN_API const char* tln_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Each launcher returns cudaGetLastError() right after its launches, so a
// refused launch (bad configuration) surfaces in the wrapper.
static inline int tln_last_error() {
  return static_cast<int>(cudaGetLastError());
}
