// K7's 1-NN mode: each query's nearest grid row, found and reduced inside
// one kernel.
//
// Computes, for the grid 1-NN of ICP and of the evaluation's frac_within,
// what shot_fpfh_tpu/ops/grid_hash.py::grid_nearest_neighbor computes in
// XLA (the grouped window fetch, then an argmin over the (Q, W) window in
// 2,048-query chunks), and what the port had run as K7
// (radius_dist_kernel at radius +inf, pallas_radius.py:497's kernel)
// writing a (Q, W) plane of rows and distances, then a min and two
// gathers, in chunks of 6,700 queries.  Here
// one launch takes every query and writes only (dist, orig_idx of the
// nearest row): for each query, inside the kernel,
//   - its cell, floor((q − origin) / cell_size) with one IEEE division
//     (runs::query_cell, as grid_hash._query_cells);
//   - its (2h+1)² z-column runs from the grid's cell-start table, with the
//     clamps and empty-run rules of grid_hash._zcolumn_runs
//     (runs::zcolumn_run);
//   - the runs walked in window order: slot j is the j-th row of the runs
//     concatenated (at most the grid's window cap, as the window was), its
//     distance sqrtf(fmaf(dz, dz, fmaf(dy, dy, dx * dx))), built -fmad=false
//     like K7's, so every distance equals K7's bit for bit;
//   - the minimum, the lowest slot winning a tie (JAX's argmin, torch's
//     min); no finite distance (an empty window, a NaN query) gives +inf and
//     slot 0's row, which is what the argmin over an all-inf window row
//     gives: the first row of the first non-empty run, else row 0.
//
// Bound on the H100: the table (100k rows, 1.2 MB at ICP's shape) and the
// cell-start table stay in the 50 MB L2, and the output is 12 bytes a
// query, so the kernel is bound by the rate it issues loads and distance
// tests at, not by HBM.  A group of kLanes lanes serves one query (32 or
// 8; the wrapper picks from the window cap): one run a lane for the run
// bounds and a shuffle scan of their lengths, then the lanes stride over
// the window's slots (a lane's slots rise by kLanes, so its run index only
// moves forward: no search), reading consecutive rows of a run with
// consecutive lanes, each keeping its own (distance, slot) minimum; a
// shuffle reduction of those ends the query.  No (Q, W) plane exists.

#include <limits.h>

#include "common.cuh"
#include "runs.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // warps a block

// the run of slot j (j below the last run's end): the first run whose end
// slot is past j, walked forward from run r
__device__ __forceinline__ int run_at(const int* run_end, int r, int j) {
  while (run_end[r] <= j) ++r;
  return r;
}

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
  long long cell[3] = {0, 0, 0};
  if (live) {
    qx = queries[3 * qi];
    qy = queries[3 * qi + 1];
    qz = queries[3 * qi + 2];
    runs::query_cell(origin, cell_size, qx, qy, qz, cell);
  }

  // the runs: start rows, and the window slot each one ends at (clamped to w)
  int filled = 0;  // slots of the runs scanned so far, at most w
  for (int r0 = 0; r0 < n_runs; r0 += kLanes) {
    const int r = r0 + sub;
    long long s = 0, e = 0;
    if (live && r < n_runs) runs::zcolumn_run(cell_starts, d0, d1, d2, halo, cell, r, s, e);
    long long incl = e - s;
#pragma unroll
    for (int d = 1; d < kLanes; d <<= 1) {
      const long long t = __shfl_up_sync(kFull, incl, d, kLanes);
      if (sub >= d) incl += t;
    }
    if (r < n_runs) {
      run_start[r] = s;
      run_end[r] = (int)min((long long)filled + incl, (long long)w);
    }
    filled = (int)min((long long)filled + __shfl_sync(kFull, incl, kLanes - 1, kLanes),
                      (long long)w);
  }
  __syncwarp();

  // this lane's slots, sub, sub + kLanes, ...: its (distance, slot) minimum
  float best = __int_as_float(0x7f800000);
  int best_slot = INT_MAX;  // none finite yet
  int r = 0;
  for (int j = sub; j < filled; j += kLanes) {
    r = run_at(run_end, r, j);
    const long long row = run_start[r] + (j - (r > 0 ? run_end[r - 1] : 0));
    const float* p = table + row * stride;
    const float dx = __ldg(p) - qx, dy = __ldg(p + 1) - qy, dz = __ldg(p + 2) - qz;
    const float d = sqrtf(fmaf(dz, dz, fmaf(dy, dy, dx * dx)));
    if (d < best) {  // a NaN never wins; a later slot of this lane wins no tie
      best = d;
      best_slot = j;
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    const float other = __shfl_xor_sync(kFull, best, off, kLanes);
    const int other_slot = __shfl_xor_sync(kFull, best_slot, off, kLanes);
    if (other < best || (other == best && other_slot < best_slot)) {
      best = other;
      best_slot = other_slot;
    }
  }
  if (!live || sub != 0) return;
  if (best_slot == INT_MAX) best_slot = 0;  // the argmin of an all-inf row
  long long row = 0;                        // an empty window's slot 0
  if (best_slot < filled) {
    const int rb = run_at(run_end, 0, best_slot);
    row = run_start[rb] + (best_slot - (rb > 0 ? run_end[rb - 1] : 0));
  }
  dist[qi] = best;
  idx[qi] = orig_idx[row];
}

// dynamic shared memory a block: each group's run starts and end slots
template <int kLanes>
size_t nearest_smem(int n_runs) {
  return (size_t)kWarps * (32 / kLanes) * n_runs * (sizeof(long long) + sizeof(int));
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
