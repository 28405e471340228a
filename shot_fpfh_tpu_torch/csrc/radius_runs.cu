// K7 and K8: a query's grid runs written out as its compacted window.
//
// Replace the TPU kernels of shot_fpfh_tpu/ops/pallas_radius.py:
//   K8  fetch_windows_pallas      (_fetch_kernel via _fetch_call): the dense
//       window fetch, each candidate's table row feature first plus its
//       distance;
//   K7  grid_radius_search_pallas (_dist_kernel via _dist_call): the masked
//       candidate distances a radius search selects from (top-k stays
//       outside).
// The TPU kernels DMA each query's 9 z-column runs into VMEM at a tile-padded
// width; here the window is the port's compacted one (ops/radius_runs.py):
// slot j of a query holds the j-th row of its runs concatenated in order
// (any number of runs: halo 1 or 2, from the cell table or a binary search),
// and the slots past the runs hold row 0, not valid.  Distances are
// sqrtf(fmaf(dz, dz, fmaf(dy, dy, dx * dx))) like the plain twins' _fp.sqnorm3
// (built -fmad=false, so dx * dx is rounded on its own).
//
// One warp serves one query: it walks the runs in order, each run's rows on
// consecutive lanes, so table reads and window writes are coalesced; the
// slot offset of a run is the running sum of the lengths before it.
//
// Bound on the H100: bytes.  Both kernels write every slot of the (Q, W)
// window (K8: F + 1 floats, a bool and an int64 a slot; K7: a float and an
// int64) and read each run row once; a distance is ~11 operations a slot.

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <bool kFetch>
__global__ void runs_window_kernel(const float* __restrict__ table, int stride,
                                   const float* __restrict__ queries,
                                   const long long* __restrict__ starts,
                                   const long long* __restrict__ ends, int n_runs, int q,
                                   int w, float radius, float* __restrict__ vals,
                                   float* __restrict__ dist, bool* __restrict__ valid,
                                   long long* __restrict__ rows) {
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (qi >= q) return;  // whole warps exit together
  const float qx = queries[3 * qi], qy = queries[3 * qi + 1], qz = queries[3 * qi + 2];
  const long long base = (long long)qi * w;              // row qi of (Q, W)
  const long long vbase = (long long)qi * stride * w;    // plane 0 of vals (Q, F, W)
  const float inf = __int_as_float(0x7f800000);

  // one slot: sorted row `row` (row 0 on padding slots, `in_run` false)
  auto put = [&](long long slot, long long row, bool in_run) {
    const float* p = table + row * stride;
    const float dx = p[0] - qx, dy = p[1] - qy, dz = p[2] - qz;
    const float d = sqrtf(fmaf(dz, dz, fmaf(dy, dy, dx * dx)));
    rows[base + slot] = row;
    if constexpr (kFetch) {
      for (int f = 0; f < stride; ++f) vals[vbase + (long long)f * w + slot] = p[f];
      dist[base + slot] = d;
      valid[base + slot] = in_run;
    } else {
      dist[base + slot] = (in_run && d <= radius) ? d : inf;
    }
  };

  long long off = 0;  // slots filled by the runs before this one
  for (int r = 0; r < n_runs && off < w; ++r) {
    const long long s = starts[(long long)qi * n_runs + r];
    const long long len = min(ends[(long long)qi * n_runs + r] - s, (long long)w - off);
    for (long long i = lane; i < len; i += 32) put(off + i, s + i, true);
    off += max(len, 0LL);
  }
  for (long long slot = off + lane; slot < w; slot += 32) put(slot, 0, false);
}

}  // namespace

SHOT_EXPORT int fetch_windows(const float* table, int stride, const float* queries,
                              const long long* starts, const long long* ends, int n_runs,
                              int q, int w, float* vals, float* dist, bool* valid,
                              long long* rows, cudaStream_t stream) {
  if (q <= 0 || w <= 0) return 0;
  const int blocks = (q + kWarpsPerBlock - 1) / kWarpsPerBlock;
  runs_window_kernel<true><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      table, stride, queries, starts, ends, n_runs, q, w, 0.f, vals, dist, valid, rows);
  return last_launch_error();
}

SHOT_EXPORT int radius_dist(const float* table, int stride, const float* queries,
                            const long long* starts, const long long* ends, int n_runs,
                            int q, int w, float radius, long long* rows, float* dist,
                            cudaStream_t stream) {
  if (q <= 0 || w <= 0) return 0;
  const int blocks = (q + kWarpsPerBlock - 1) / kWarpsPerBlock;
  runs_window_kernel<false><<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      table, stride, queries, starts, ends, n_runs, q, w, radius, nullptr, dist, nullptr,
      rows);
  return last_launch_error();
}
