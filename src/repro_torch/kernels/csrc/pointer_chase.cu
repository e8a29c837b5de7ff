// A latency calibration, not a kernel of the port's path: one thread
// following i = next[i] through an array, so that the time of one
// dependent load from L2 or from HBM can be set beside the ns per
// step of kernel F's walk (kernels/calibrate.py).

#include <cuda_runtime.h>

namespace {

__global__ void chase_kernel(const int* next, int start, int steps,
                             int* out) {
  int i = start;
  for (int s = 0; s < steps; ++s) i = next[i];
  *out = i;
}

}  // namespace

extern "C" int pointer_chase(const int* next, int start, int steps,
                             int* out, void* stream) {
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      next, start, steps, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
