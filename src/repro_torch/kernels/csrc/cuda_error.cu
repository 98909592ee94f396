// The message of a CUDA error code, for the wrappers of every kernel in this
// directory (each C entry returns cudaGetLastError() as an int).

#include <cuda_runtime.h>

extern "C" const char* navix_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
