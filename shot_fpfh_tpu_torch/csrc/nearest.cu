// K7's 1-NN mode: each query's nearest grid row, found and reduced inside
// one kernel.
//
// Computes, for the grid 1-NN of the evaluation's frac_within (and of
// ICP's plain loop), what shot_fpfh_tpu/ops/grid_hash.py::grid_nearest_neighbor
// computes in XLA (the grouped window fetch, then an argmin over the (Q, W)
// window in 2,048-query chunks), and what the port had run as K7
// (radius_dist_kernel at radius +inf, pallas_radius.py:497's kernel)
// writing a (Q, W) plane of rows and distances, then a min and two
// gathers, in chunks of 6,700 queries.  Here one launch takes every query
// and writes only (dist, orig_idx of the nearest row): each query's walk
// is nearest.cuh's (shared with ICP's iteration kernel, icp_step.cu).
//
// Bound on the H100: the table (100k rows, 1.2 MB at ICP's shape) and the
// cell-start table stay in the 50 MB L2, and the output is 12 bytes a
// query, so the kernel is bound by the rate it issues loads and distance
// tests at, not by HBM.  A group of kLanes lanes serves one query (32 or
// 8; the wrapper picks from the window cap).  No (Q, W) plane exists.

#include "nearest.cuh"

namespace {

constexpr int kWarps = 8;  // warps a block

template <int kLanes>
__global__ void __launch_bounds__(32 * kWarps)
nearest_kernel(const float* __restrict__ table, int stride,
               const long long* __restrict__ orig_idx,
               const long long* __restrict__ cell_starts, const float* __restrict__ origin,
               float cell_size, long long d0, long long d1, long long d2, int halo, int w,
               const float* __restrict__ queries, int q, float* __restrict__ dist,
               long long* __restrict__ idx) {
  constexpr int kGroups = 32 / kLanes;  // queries a warp
  const int side = 2 * halo + 1, n_runs = side * side;
  const int lane = threadIdx.x & 31, sub = lane % kLanes;
  const int group = threadIdx.x / kLanes;  // the query's group in the block
  const int qi = blockIdx.x * kWarps * kGroups + group;
  // whole warps past the last query leave; a warp with a live group keeps
  // every lane for its shuffles, its dead groups walking empty windows
  if (qi - lane / kLanes >= q) return;
  const bool live = qi < q;

  // per group: its runs' start rows and end slots
  extern __shared__ __align__(16) unsigned char smem[];
  long long* run_start = reinterpret_cast<long long*>(smem) + group * n_runs;
  int* run_end = reinterpret_cast<int*>(reinterpret_cast<long long*>(smem) +
                                        kWarps * kGroups * n_runs) +
                 group * n_runs;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    qx = queries[3 * qi];
    qy = queries[3 * qi + 1];
    qz = queries[3 * qi + 2];
  }
  float best;
  long long row;
  nn::nearest_row<kLanes>(table, stride, cell_starts, origin, cell_size, d0, d1, d2, halo, w,
                          live, qx, qy, qz, run_start, run_end, best, row);
  if (!live || sub != 0) return;
  dist[qi] = best;
  idx[qi] = orig_idx[row];
}

// dynamic shared memory a block: each group's run starts and end slots
template <int kLanes>
size_t nearest_smem(int n_runs) {
  return (size_t)kWarps * (32 / kLanes) * nn::group_smem(n_runs);
}

template <int kLanes>
int launch_nearest(const float* table, int stride, const long long* orig_idx,
                   const long long* cell_starts, const float* origin, float cell_size,
                   long long d0, long long d1, long long d2, int halo, int w,
                   const float* queries, int q, float* dist, long long* idx,
                   cudaStream_t stream) {
  const int side = 2 * halo + 1;
  const size_t smem = nearest_smem<kLanes>(side * side);
  if (smem > 48 * 1024) {  // halos past 4 at 8 lanes a query
    const cudaError_t err = cudaFuncSetAttribute(
        nearest_kernel<kLanes>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int per_block = kWarps * (32 / kLanes);
  const int blocks = (q + per_block - 1) / per_block;
  nearest_kernel<kLanes><<<blocks, 32 * kWarps, smem, stream>>>(
      table, stride, orig_idx, cell_starts, origin, cell_size, d0, d1, d2, halo, w, queries, q,
      dist, idx);
  return last_launch_error();
}

}  // namespace

// lanes: lanes a query, 32 or 8.
SHOT_EXPORT int nearest(const float* table, int stride, const long long* orig_idx,
                        const long long* cell_starts, const float* origin, float cell_size,
                        long long d0, long long d1, long long d2, int halo, int w,
                        const float* queries, int q, int lanes, float* dist, long long* idx,
                        cudaStream_t stream) {
  if (q <= 0) return 0;
  if (stride < 3 || halo < 0 || w <= 0) return (int)cudaErrorInvalidValue;
  switch (lanes) {
    case 32:
      return launch_nearest<32>(table, stride, orig_idx, cell_starts, origin, cell_size, d0, d1,
                                d2, halo, w, queries, q, dist, idx, stream);
    case 8:
      return launch_nearest<8>(table, stride, orig_idx, cell_starts, origin, cell_size, d0, d1,
                               d2, halo, w, queries, q, dist, idx, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
