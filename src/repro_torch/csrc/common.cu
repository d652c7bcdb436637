// The error-string entry point of the kernels' shared library: every launch
// entry point returns cudaGetLastError(), and the wrapper reports it by name.
#include "common.cuh"

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
