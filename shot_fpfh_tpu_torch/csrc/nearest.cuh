// K7's 1-NN walk: one query's nearest row of its z-column window on a grid
// with a cell-start table, found by a group of kLanes lanes (32 or 8).
//
// Shared by nearest_kernel (nearest.cu: the 1-NN of every query, written
// out) and icp_step_kernel (icp_step.cu: ICP's iteration, which sums its
// normal equations over the rows it finds), so both keep K7's 1-NN
// distances and its first-minimum tie rule bit for bit.  For the query:
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
// One run a lane for the run bounds and a shuffle scan of their lengths,
// then the lanes stride over the window's slots (a lane's slots rise by
// kLanes, so its run index only moves forward: no search), reading
// consecutive rows of a run with consecutive lanes, each keeping its own
// (distance, slot) minimum; a shuffle reduction of those ends the query.
#pragma once

#include <limits.h>

#include "common.cuh"
#include "runs.cuh"

namespace nn {

constexpr unsigned kFull = 0xffffffffu;

// the run of slot j (j below the last run's end): the first run whose end
// slot is past j, walked forward from run r
__device__ __forceinline__ int run_at(const int* run_end, int r, int j) {
  while (run_end[r] <= j) ++r;
  return r;
}

// shared memory of one group: its runs' start rows and end slots
constexpr size_t group_smem(int n_runs) {
  return (size_t)n_runs * (sizeof(long long) + sizeof(int));
}

// The nearest row (a row of the cell-sorted table) of the query (qx, qy, qz)
// and its distance, on every lane of the group.  Every lane of the warp
// calls it (the shuffles take the whole warp); a group that is not live
// walks an empty window (+inf, row 0).  run_start and run_end: the group's
// n_runs entries of shared memory; the caller syncs the warp before it
// writes them again.
template <int kLanes>
__device__ __forceinline__ void nearest_row(const float* __restrict__ table, int stride,
                                            const long long* __restrict__ cell_starts,
                                            const float* __restrict__ origin, float cell_size,
                                            long long d0, long long d1, long long d2, int halo,
                                            int w, bool live, float qx, float qy, float qz,
                                            long long* run_start, int* run_end, float& best,
                                            long long& row) {
  const int side = 2 * halo + 1, n_runs = side * side;
  const int sub = (threadIdx.x & 31) % kLanes;
  long long cell[3] = {0, 0, 0};
  if (live) runs::query_cell(origin, cell_size, qx, qy, qz, cell);

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
  best = __int_as_float(0x7f800000);
  int best_slot = INT_MAX;  // none finite yet
  int r = 0;
  for (int j = sub; j < filled; j += kLanes) {
    r = run_at(run_end, r, j);
    const long long slot_row = run_start[r] + (j - (r > 0 ? run_end[r - 1] : 0));
    const float* p = table + slot_row * stride;
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
  if (best_slot == INT_MAX) best_slot = 0;  // the argmin of an all-inf row
  row = 0;                                  // an empty window's slot 0
  if (best_slot < filled) {
    const int rb = run_at(run_end, 0, best_slot);
    row = run_start[rb] + (best_slot - (rb > 0 ? run_end[rb - 1] : 0));
  }
}

}  // namespace nn
