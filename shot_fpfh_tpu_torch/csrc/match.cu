// K2: descriptor distance product with a fused top-2 reduction.
//
// Replaces the TPU kernel shot_fpfh_tpu/ops/pallas_match.py::top2_matmul_pallas
// (_kernel), which does one MXU dot per (1024, 4096) tile and keeps the
// per-row (i1, d1², d2²) carry in VMEM.
//
// Here a block owns 32 rows of `a` and sweeps every 64-row tile of `b`: both
// tiles are staged in shared memory 32 features at a time (as bf16 in the
// default mode, f32 in f32 mode), each thread accumulates a 4x2 block of
// dot products in f32, and the squared distances ‖a‖² + ‖b‖² − 2 a·b
// (norms of the rounded values, computed by the wrapper) feed a running
// top-2 kept in registers.  Each thread scans its columns in index order
// with a strict `<`, so the lower index wins ties; the 32 lanes that share a
// row merge their partial top-2s once at the end with the same rule.  No
// distance tile ever reaches device memory.
//
// Bound on the H100: arithmetic on the CUDA cores.  n·m·D multiply-adds
// (4096² x 352 ≈ 5.9 G) at the SIMT float32 rate; wgmma on the tensor cores
// and TMA staging are for a later revision.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 32;   // rows of a per block
constexpr int kBK = 64;   // rows of b per tile
constexpr int kDK = 32;   // features staged per step
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kBQ / (kThreads / 32);  // 4
constexpr int kColsPerThread = kBK / 32;               // 2

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// (d1, i1, d2) of the union of two disjoint column sets: the smaller d1
// wins, the lower index on equal d1; d2 is the second of the merged four.
__device__ __forceinline__ void merge_top2(float& d1, int& i1, float& d2,
                                           float od1, int oi1, float od2) {
  const bool take = od1 < d1 || (od1 == d1 && oi1 < i1);
  const float nd2 = fminf(fmaxf(d1, od1), fminf(d2, od2));
  if (take) {
    d1 = od1;
    i1 = oi1;
  }
  d2 = nd2;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
top2_kernel(const T* __restrict__ a, const T* __restrict__ b,
            const float* __restrict__ an, const float* __restrict__ bn,
            const unsigned char* __restrict__ b_valid, int* __restrict__ i1_out,
            float* __restrict__ d1_out, float* __restrict__ d2_out, int n, int m,
            int dim) {
  __shared__ T as[kDK][kBQ + 1];
  __shared__ T bs[kDK][kBK + 1];
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kBQ;

  float an_r[kRowsPerThread];
  float best1[kRowsPerThread], best2[kRowsPerThread];
  int idx1[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = row0 + ty + 8 * i;
    an_r[i] = row < n ? an[row] : 0.f;
    best1[i] = best2[i] = INFINITY;
    idx1[i] = 0;
  }

  for (int col0 = 0; col0 < m; col0 += kBK) {
    float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < dim; k0 += kDK) {
      // stage: lanes walk consecutive features of one row (coalesced)
#pragma unroll
      for (int e = threadIdx.x; e < kBQ * kDK; e += kThreads) {
        const int r = e / kDK, k = e % kDK;
        const int row = row0 + r, kk = k0 + k;
        as[k][r] = (row < n && kk < dim) ? a[(long long)row * dim + kk] : zero_of<T>();
      }
#pragma unroll
      for (int e = threadIdx.x; e < kBK * kDK; e += kThreads) {
        const int r = e / kDK, k = e % kDK;
        const int col = col0 + r, kk = k0 + k;
        bs[k][r] = (col < m && kk < dim) ? b[(long long)col * dim + kk] : zero_of<T>();
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kDK; ++k) {
        float av[kRowsPerThread], bv[kColsPerThread];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) av[i] = to_f32(as[k][ty + 8 * i]);
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) bv[j] = to_f32(bs[k][tx + 32 * j]);
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

    // epilogue: masked squared distances into the running top-2, columns
    // in increasing index order (tx, then tx + 32)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int col = col0 + tx + 32 * j;
      const bool ok = col < m && b_valid[col];
      const float bnv = ok ? bn[col] : 0.f;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float d = ok ? fmaxf((an_r[i] + bnv) - 2.f * acc[i][j], 0.f) : INFINITY;
        if (d < best1[i]) {
          best2[i] = best1[i];
          best1[i] = d;
          idx1[i] = col;
        } else if (d < best2[i]) {
          best2[i] = d;
        }
      }
    }
  }

  // the 32 lanes of a warp share its rows: butterfly-merge their top-2s
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od1 = __shfl_xor_sync(0xffffffffu, best1[i], off);
      const int oi1 = __shfl_xor_sync(0xffffffffu, idx1[i], off);
      const float od2 = __shfl_xor_sync(0xffffffffu, best2[i], off);
      merge_top2(best1[i], idx1[i], best2[i], od1, oi1, od2);
    }
    const int row = row0 + ty + 8 * i;
    if (tx == 0 && row < n) {
      i1_out[row] = idx1[i];
      d1_out[row] = best1[i];
      d2_out[row] = best2[i];
    }
  }
}

}  // namespace

SHOT_EXPORT int top2_match(const void* a, const void* b, const float* an,
                           const float* bn, const unsigned char* b_valid, int* i1,
                           float* d1, float* d2, int n, int m, int dim, int use_bf16,
                           cudaStream_t stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kBQ - 1) / kBQ;
  if (use_bf16) {
    top2_kernel<__nv_bfloat16><<<blocks, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
        an, bn, b_valid, i1, d1, d2, n, m, dim);
  } else {
    top2_kernel<float><<<blocks, kThreads, 0, stream>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), an, bn, b_valid,
        i1, d1, d2, n, m, dim);
  }
  return last_launch_error();
}
