// Shared helpers of the hand-written kernels: a warp reduction and the
// plain C launch convention (enqueue on the given stream, return the launch
// error code; the Python wrapper raises when it is not cudaSuccess).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define SHOT_EXPORT extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

inline int last_launch_error() { return static_cast<int>(cudaGetLastError()); }
