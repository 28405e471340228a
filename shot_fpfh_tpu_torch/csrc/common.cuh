// Shared helpers of the hand-written kernels: warp/block reductions and the
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

// Sum N per-thread values over the whole block; the totals are returned to
// every thread.  `scratch` holds at least N * (blockDim.x / 32) floats.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) scratch[k * n_warps + warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float s = 0.f;
    for (int w = 0; w < n_warps; ++w) s += scratch[k * n_warps + w];
    v[k] = s;
  }
  __syncthreads();
}

inline int last_launch_error() { return static_cast<int>(cudaGetLastError()); }
