// Shared by every kernel library of the port (one shared library per csrc/*.cu).
#pragma once

#include <cuda_runtime.h>

// Names a CUDA error code for the Python wrapper, which gets the code back
// from each entry point (cudaGetLastError() after the launch).
extern "C" const char* l2i_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
