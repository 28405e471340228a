// Error text of a cudaError_t returned by the kernel entry points.
#include "common.cuh"

SHOT_EXPORT const char* shot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
