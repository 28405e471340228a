// A query's runs of the grid, shared by K5 (shot_runs.cu), K6
// (spfh_runs.cu) and K7's 1-NN walk (nearest.cuh): its cell, and the runs of
// the cell-sorted table that hold every point within halo·cell_size of it,
// with the arithmetic of ops/grid_hash.py::_query_cells and of
// ops/shot_dma.py::_xyrow_runs (2h+1 xy-row runs: K5, K6) or
// ops/grid_hash.py::_zcolumn_runs ((2h+1)² z-column runs: the 1-NN, the
// SPFH pass and SHOT's grid kernel).  Each kernel finds its
// queries' runs itself from the grid's cell-start table, one run a lane, so
// the wrapper launches no index ops.  Also the window routes' radius test
// as the walks take it (sq_bound).
#pragma once

#include <math.h>

namespace runs {

// grid_hash._query_cells: floor((q − origin) / cell_size), one IEEE division
__device__ __forceinline__ void query_cell(const float* origin, float cell_size, float x,
                                           float y, float z, long long (&c)[3]) {
  c[0] = (long long)floorf(__fdiv_rn(x - origin[0], cell_size));
  c[1] = (long long)floorf(__fdiv_rn(y - origin[1], cell_size));
  c[2] = (long long)floorf(__fdiv_rn(z - origin[2], cell_size));
}

// shot_dma._xyrow_runs for offset k (0 .. 2h) of the cell c: the sorted
// rows [s, e) of the cells (x+k−h, max(y−h, 0) .. min(y+h, d1−1), all z),
// consecutive in the z-minor id; (0, 0) off the grid
__device__ __forceinline__ void xyrow_run(const long long* cell_starts, long long d0,
                                          long long d1, long long d2, int h,
                                          const long long (&c)[3], int k, long long& s,
                                          long long& e) {
  const long long x = c[0] + k - h;
  const long long y_lo = c[1] - h > 0 ? c[1] - h : 0;
  const long long y_hi = c[1] + h < d1 - 1 ? c[1] + h : d1 - 1;
  s = e = 0;
  if (x < 0 || x >= d0 || y_hi < y_lo || c[1] < -h || c[1] > d1 + h - 1) return;
  const long long last = d0 * d1 * d2;
  const long long lo = (x * d1 + y_lo) * d2, hi = (x * d1 + y_hi + 1) * d2;
  s = cell_starts[lo < 0 ? 0 : (lo > last ? last : lo)];
  e = cell_starts[hi < 0 ? 0 : (hi > last ? last : hi)];
  e = e > s ? e : s;
}

// a + b as the twins' int64 tensors add: wrapping at the ends of the range
// (a NaN or infinite query's cell is converted to one of them)
__device__ __forceinline__ long long wrap_add(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}

// grid_hash._zcolumn_runs (with a cell-start table) for run k (0 ..
// (2h+1)² − 1, offset (k / (2h+1) − h, k % (2h+1) − h)) of the cell c: the
// sorted rows [s, e) of the cells (x+dx, y+dy, max(z−h, 0) .. min(z+h,
// d2−1)), consecutive in the z-minor id; (0, 0) off the grid
__device__ __forceinline__ void zcolumn_run(const long long* cell_starts, long long d0,
                                            long long d1, long long d2, int h,
                                            const long long (&c)[3], int k, long long& s,
                                            long long& e) {
  const int side = 2 * h + 1;
  const long long x = wrap_add(c[0], k / side - h), y = wrap_add(c[1], k % side - h);
  const long long z_lo = (c[2] > h ? c[2] : h) - h;
  const long long z_top = wrap_add(c[2], h);
  const long long z_hi = z_top < d2 - 1 ? z_top : d2 - 1;
  s = e = 0;
  if (x < 0 || x >= d0 || y < 0 || y >= d1 || c[2] < -h || c[2] > d2 + h - 1 || z_hi < z_lo)
    return;
  const long long last = d0 * d1 * d2;
  const long long base = (x * d1 + y) * d2;
  const long long lo = base + z_lo, hi = base + z_hi + 1;
  s = cell_starts[lo < 0 ? 0 : (lo > last ? last : lo)];
  e = cell_starts[hi < 0 ? 0 : (hi > last ? last : hi)];
  e = e > s ? e : s;
}

// The largest x with sqrtf(x) <= r (sqrtf is correctly rounded and does not
// decrease, so the window routes' test sqrtf(x) <= r is x <= bound); -1 for
// a negative or NaN radius, where no slot is in radius.
__device__ __forceinline__ float sq_bound(float r) {
  if (!(r >= 0.f)) return -1.f;
  if (isinf(r)) return INFINITY;
  float x = r * r;  // within an ulp or two of the bound, or +inf
  while (x > 0.f && sqrtf(x) > r) x = nextafterf(x, 0.f);
  while (sqrtf(nextafterf(x, INFINITY)) <= r) x = nextafterf(x, INFINITY);
  return x;
}

}  // namespace runs
