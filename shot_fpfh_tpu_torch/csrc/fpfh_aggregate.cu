// K7's FPFH aggregation mode: FPFH's second pass, the 1/d weighted sum of
// each keypoint's neighbours' SPFH rows, found and summed inside one kernel.
//
// Computes what shot_fpfh_tpu/models/fpfh.py::_fpfh_window_aggregate
// computes in XLA (the grouped window fetch, then an einsum over the
// gathered (C, W, D) neighbour rows, in 4,096-keypoint chunks), and what the
// port had run as K7 (radius_dist_kernel, pallas_radius.py:497's kernel)
// writing a (Q, W) plane of rows and distances, then a gather of the
// neighbours' SPFH rows into a (C, W, D) block and an einsum, in chunks of
// 2^26 / (W·D) keypoints.  Here one launch takes every keypoint of the call
// and writes only its FPFH row (and, when asked, its count):
//   out[k] = spfh[row_k] + (Σ spfh[row_j] / d_j) / max(1, count_k)
// over the window slots j in radius (d_j <= r) with d_j > 0; count_k counts
// every slot in radius (the keypoint's own row, d = 0, included).  For each
// keypoint, inside the kernel:
//   - its query, the xyz of its table row; its cell and (2h+1)² z-column
//     runs from the cell-start table (runs.cuh, as nearest.cu);
//   - pass 1: the lanes stride the window's slots in window order (slot j
//     is the j-th row of the runs concatenated, at most the window cap),
//     each computing d = sqrtf(fmaf(dz, dz, fmaf(dy, dy, dx * dx))), built
//     -fmad=false like K7, so each d and each radius test equals K7's; the
//     slots in radius are counted, and those with d > 0 listed with their
//     weight 1/d (__fdiv_rn, as _fp.div) in shared memory in ascending slot
//     order (a ballot and a prefix count);
//   - pass 2: the warp walks the list, the lanes splitting the columns: a
//     neighbour's SPFH row is read as 4 coalesced loads of 32 floats, and
//     each lane keeps 4 columns' sums (fmaf, ascending slot order); D past
//     128 loops over column tiles of 128;
//   - a window whose slots outnumber the list runs both passes over tiles
//     of kList slots, in order; with D past 128 as well, pass 1 is redone
//     for each column tile, so the sum of every column stays in slot order.
// The plain twin (ops/radius_runs.py::fpfh_aggregate_plain) sums with an
// einsum, in no defined order: the two agree to float32 rounding, and their
// counts exactly.
//
// Bound on the H100: bytes at best.  The compulsory traffic is the table's
// xyz of the windows' rows and the SPFH rows of the union of the
// neighbourhoods (each read once), and the output; the work is ~11
// operations a window slot and 2·D an in-radius neighbour.  A keypoint's
// neighbours are shared with the keypoints near it, so each SPFH row is read
// by tens of keypoints: the design leans on the 50 MB L2 holding the rows of
// the keypoints in flight (the wrapper launches them in sorted-row order, so
// that warps in flight work on neighbouring cells: 2.6x faster than the
// caller's order at 10^6 points).  No (Q, W) window and no (C, W, D) block
// exist.  Measured on an H100 (chip_smoke.py): 4.32 ms alone for 78,259
// keypoints × 573 neighbours × 125 columns of a 10^6-point cloud, ~22 GB
// of rows read through L2 against a 0.185 ms bound; reading each shared
// row once for a group of keypoints is the next lever.

#include "common.cuh"
#include "runs.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;        // keypoints a block, one warp each
constexpr int kList = 512;       // listed neighbours a warp (a slot tile)
constexpr int kColTile = 128;    // columns a walk of the list: 4 a lane

// the run of slot j (j below the last run's end): the first run whose end
// slot is past j, walked forward from run r
__device__ __forceinline__ int run_at(const int* run_end, int r, int j) {
  while (run_end[r] <= j) ++r;
  return r;
}

__global__ void __launch_bounds__(32 * kWarps)
fpfh_aggregate_kernel(const float* __restrict__ table, int stride,
                      const long long* __restrict__ cell_starts,
                      const float* __restrict__ origin, float cell_size, long long d0,
                      long long d1, long long d2, int halo, int w,
                      const float* __restrict__ spfh, int dim,
                      const long long* __restrict__ kp_rows, const long long* __restrict__ order,
                      int q, float radius, float* __restrict__ out, int* __restrict__ counts) {
  const int side = 2 * halo + 1, n_runs = side * side;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= q) return;  // whole warps leave; no block barrier follows

  // per warp: its list (rows, weights), then its runs' start rows and end
  // slots
  extern __shared__ __align__(16) unsigned char smem[];
  int* list_row = reinterpret_cast<int*>(smem) + warp * kList;
  float* list_wt = reinterpret_cast<float*>(smem) + kWarps * kList + warp * kList;
  long long* run_start =
      reinterpret_cast<long long*>(smem + 2 * kWarps * kList * sizeof(int)) + warp * n_runs;
  int* run_end = reinterpret_cast<int*>(reinterpret_cast<long long*>(
                     smem + 2 * kWarps * kList * sizeof(int)) + kWarps * n_runs) +
                 warp * n_runs;

  const long long k = order != nullptr ? order[i] : i;  // the keypoint's output row
  const long long kp = kp_rows[k];
  const float* self = table + kp * stride;
  const float qx = self[0], qy = self[1], qz = self[2];
  long long cell[3];
  runs::query_cell(origin, cell_size, qx, qy, qz, cell);

  // the runs: start rows, and the window slot each one ends at (clamped to w)
  int filled = 0;  // slots of the runs scanned so far, at most w
  for (int r0 = 0; r0 < n_runs; r0 += 32) {
    const int r = r0 + lane;
    long long s = 0, e = 0;
    if (r < n_runs) runs::zcolumn_run(cell_starts, d0, d1, d2, halo, cell, r, s, e);
    long long incl = e - s;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long t = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += t;
    }
    if (r < n_runs) {
      run_start[r] = s;
      run_end[r] = (int)min((long long)filled + incl, (long long)w);
    }
    filled = (int)min((long long)filled + __shfl_sync(kFull, incl, 31), (long long)w);
  }
  __syncwarp();

  int count = 0;   // slots in radius (every lane holds the same)
  int listed = 0;  // entries of the list
  for (int col = 0; col < dim; col += kColTile) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    int r = 0;  // this lane's run, moving forward with its slots
    for (int tile = 0; tile < filled; tile += kList) {
      // pass 1 over the slot tile: once, unless the list must be refilled
      if (col == 0 || filled > kList) {
        const int tile_end = min(tile + kList, filled);
        listed = 0;
        for (int j0 = tile; j0 < tile_end; j0 += 32) {
          const int j = j0 + lane;
          bool in = false, keep = false;
          float d = 0.f;
          long long row = 0;
          if (j < tile_end) {
            r = run_at(run_end, r, j);
            row = run_start[r] + (j - (r > 0 ? run_end[r - 1] : 0));
            const float* p = table + row * stride;
            const float dx = __ldg(p) - qx, dy = __ldg(p + 1) - qy, dz = __ldg(p + 2) - qz;
            d = sqrtf(fmaf(dz, dz, fmaf(dy, dy, dx * dx)));
            in = d <= radius;  // a NaN distance is never in radius
            keep = in && d > 0.f;
          }
          if (col == 0) count += __popc(__ballot_sync(kFull, in));
          const unsigned kept = __ballot_sync(kFull, keep);
          if (keep) {
            const int at = listed + __popc(kept & ((1u << lane) - 1u));
            list_row[at] = (int)row;
            list_wt[at] = __fdiv_rn(1.f, d);
          }
          listed += __popc(kept);
        }
        __syncwarp();
      }
      // pass 2: the listed rows' columns col + lane + 32t
#pragma unroll 4
      for (int e = 0; e < listed; ++e) {
        const float wt = list_wt[e];
        const float* src = spfh + (long long)list_row[e] * dim + col;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int c = lane + 32 * t;
          if (col + c < dim) acc[t] = fmaf(__ldg(src + c), wt, acc[t]);
        }
      }
      __syncwarp();  // the list is rewritten by the next tile's pass 1
    }
    const float n = (float)max(count, 1);
    const float* own = spfh + kp * dim + col;
    float* dst = out + k * dim + col;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int c = lane + 32 * t;
      if (col + c < dim) dst[c] = __ldg(own + c) + __fdiv_rn(acc[t], n);
    }
  }
  if (counts != nullptr && lane == 0) counts[k] = count;
}

// dynamic shared memory a block: each warp's list, run starts and end slots
size_t aggregate_smem(int n_runs) {
  return (size_t)kWarps * (kList * (sizeof(int) + sizeof(float)) +
                           n_runs * (sizeof(long long) + sizeof(int)));
}

}  // namespace

// order: null (keypoint i on warp i) or a permutation of 0 .. q-1 (warp i
// takes keypoint order[i]); counts may be null (not written).
SHOT_EXPORT int fpfh_aggregate(const float* table, int stride, const long long* cell_starts,
                               const float* origin, float cell_size, long long d0,
                               long long d1, long long d2, int halo, int w, const float* spfh,
                               int dim, const long long* kp_rows, const long long* order, int q,
                               float radius, float* out, int* counts, cudaStream_t stream) {
  if (q <= 0) return 0;
  if (stride < 3 || halo < 0 || w <= 0 || dim <= 0) return (int)cudaErrorInvalidValue;
  const int side = 2 * halo + 1;
  const size_t smem = aggregate_smem(side * side);
  if (smem > 48 * 1024) {  // halos past 12
    const cudaError_t err = cudaFuncSetAttribute(
        fpfh_aggregate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (q + kWarps - 1) / kWarps;
  fpfh_aggregate_kernel<<<blocks, 32 * kWarps, smem, stream>>>(
      table, stride, cell_starts, origin, cell_size, d0, d1, d2, halo, w, spfh, dim, kp_rows,
      order, q, radius, out, counts);
  return last_launch_error();
}
