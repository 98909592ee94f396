// What every kernel wrapper in this directory shares at run time: the
// message of a CUDA error code (each C entry returns cudaGetLastError() as
// an int), and an empty kernel launched through the same ctypes route,
// whose time is the launch floor a measurement states beside a kernel's
// time where its bytes bound says nothing (a one-lane launch).

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" const char* navix_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches an empty kernel of (grid_x, grid_y) blocks of `threads` threads
// on `stream`; returns cudaGetLastError().
extern "C" int navix_empty_kernel(int grid_x, int grid_y, int threads,
                                  void* stream) {
  if (grid_x <= 0 || grid_y <= 0 || threads <= 0)
    return (int)cudaErrorInvalidValue;
  empty_kernel<<<dim3((unsigned)grid_x, (unsigned)grid_y), threads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
