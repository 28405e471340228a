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
// One warp serves one query, and its lanes follow the window's slots, not
// the runs' rows, so every lane writes on every step whatever the runs'
// lengths:
//   - the run bounds are read once, one run a lane, and a warp scan of their
//     lengths gives each run's end slot (shared memory); a slot finds its
//     run by a binary search over those, its row by the offset in the run;
//   - row 0's distance, which every padding slot holds, is computed once a
//     query (its values are one uniform load a plane);
//   - a step fills 128 slots, 4 a lane 32 apart: the table rows a warp
//     reads are consecutive within a run, and each store instruction writes
//     32 consecutive slots of a plane (16-byte stores of 4 slots a lane,
//     staged through shared memory to the planes' aligned groups, were
//     slower at the FPFH chunk and on K7's shapes).
// The two kernels share this walk (fetch_windows_kernel and
// radius_dist_kernel, two names the profiler tells apart).  K8 may skip the
// rows plane, which no caller of the window reads but the tests.
//
// Bound on the H100: bytes.  K8 writes every slot of the (Q, W) window (F + 1
// floats, a bool and, unless skipped, an int64 a slot), K7 a float and an
// int64, and both read each run row once; a distance is ~11 operations.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;   // queries a block, one warp each
constexpr int kTile = 128;  // slots a warp fills a step: 4 a lane, 32 apart

// Stores a step's slots of a (Q, W) plane row whose slot 0 is at `plane`:
// this lane's slots tile + 32t + lane are v[t]; a warp's store instruction
// writes 32 consecutive slots.
template <class T>
__device__ __forceinline__ void store_tile(T* plane, int w, int tile, const T (&v)[4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if (tile + 32 * t + lane < w) plane[tile + 32 * t + lane] = v[t];
}

// The first run whose last slot (exclusive) is past slot j: a binary search
// over the scanned run ends, which do not decrease.
__device__ __forceinline__ int run_of(const int* run_end, int n_runs, int j) {
  int lo = 0, hi = n_runs - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (run_end[mid] > j) hi = mid;
    else lo = mid + 1;
  }
  return lo;
}

__device__ __forceinline__ float distance(const float* p, float qx, float qy, float qz) {
  const float dx = p[0] - qx, dy = p[1] - qy, dz = p[2] - qz;
  return sqrtf(fmaf(dz, dz, fmaf(dy, dy, dx * dx)));
}

// kFetch: K8 (vals, dist, valid and, when not null, rows); else K7 (rows and
// the distance where the slot is valid and within `radius`, else +inf).
template <bool kFetch>
__device__ __forceinline__ void window_walk(const float* __restrict__ table, int stride,
                                            const float* __restrict__ queries,
                                            const long long* __restrict__ starts,
                                            const long long* __restrict__ ends, int n_runs,
                                            int q, int w, float radius, float* __restrict__ vals,
                                            float* __restrict__ dist, bool* __restrict__ valid,
                                            long long* __restrict__ rows) {
  // per warp: its runs' start rows and end slots
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  long long* run_start = reinterpret_cast<long long*>(smem) + warp * n_runs;
  int* run_end = reinterpret_cast<int*>(reinterpret_cast<long long*>(smem) + kWarps * n_runs) +
                 warp * n_runs;
  const int qi = blockIdx.x * kWarps + warp;
  if (qi >= q) return;  // whole warps leave; no block barrier follows
  const float qx = queries[3 * qi], qy = queries[3 * qi + 1], qz = queries[3 * qi + 2];

  // the runs: start rows, and the window slot each one ends at (clamped to w)
  int filled = 0;  // slots of the runs scanned so far, at most w
  for (int r0 = 0; r0 < n_runs; r0 += 32) {
    const int r = r0 + lane;
    long long s = 0, len = 0;
    if (r < n_runs) {
      s = starts[(long long)qi * n_runs + r];
      len = max(ends[(long long)qi * n_runs + r] - s, 0LL);
    }
    long long incl = len;
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
  const float d0 = distance(table, qx, qy, qz);  // row 0: every padding slot's
  const float inf = __int_as_float(0x7f800000);

  const long long base = (long long)qi * w;  // row qi of (Q, W)
  for (int tile = 0; tile < w; tile += kTile) {
    long long row[4];
    bool in[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = tile + 32 * t + lane;
      in[t] = j < filled;
      row[t] = 0;
      if (in[t]) {
        const int r = run_of(run_end, n_runs, j);
        row[t] = run_start[r] + (j - (r > 0 ? run_end[r - 1] : 0));
      }
    }
    float d[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      d[t] = in[t] ? distance(table + row[t] * stride, qx, qy, qz) : d0;
      if constexpr (!kFetch) d[t] = (in[t] && d[t] <= radius) ? d[t] : inf;
    }
    store_tile(dist + base, w, tile, d);
    if (rows != nullptr) store_tile(rows + base, w, tile, row);
    if constexpr (kFetch) {
      store_tile(valid + base, w, tile, in);
      float* plane = vals + (long long)qi * stride * w;
      for (int f = 0; f < stride; ++f, plane += w) {
        float v[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) v[t] = in[t] ? table[row[t] * stride + f] : table[f];
        store_tile(plane, w, tile, v);
      }
    }
  }
}

__global__ void __launch_bounds__(32 * kWarps)
fetch_windows_kernel(const float* __restrict__ table, int stride,
                     const float* __restrict__ queries, const long long* __restrict__ starts,
                     const long long* __restrict__ ends, int n_runs, int q, int w,
                     float* __restrict__ vals, float* __restrict__ dist,
                     bool* __restrict__ valid, long long* __restrict__ rows) {
  window_walk<true>(table, stride, queries, starts, ends, n_runs, q, w, 0.f, vals, dist, valid,
                    rows);
}

__global__ void __launch_bounds__(32 * kWarps)
radius_dist_kernel(const float* __restrict__ table, int stride,
                   const float* __restrict__ queries, const long long* __restrict__ starts,
                   const long long* __restrict__ ends, int n_runs, int q, int w, float radius,
                   long long* __restrict__ rows, float* __restrict__ dist) {
  window_walk<false>(table, stride, queries, starts, ends, n_runs, q, w, radius, nullptr, dist,
                     nullptr, rows);
}

// dynamic shared memory a block: each warp's run starts and end slots
size_t walk_smem(int n_runs) {
  return (size_t)kWarps * n_runs * (sizeof(long long) + sizeof(int));
}

// the runs' share of shared memory past 40 KB needs the opt-in to more than
// 48 KB a block
template <class Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem > 40 * 1024)
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  return 0;
}

}  // namespace

// rows may be null: the rows plane is not written.
SHOT_EXPORT int fetch_windows(const float* table, int stride, const float* queries,
                              const long long* starts, const long long* ends, int n_runs,
                              int q, int w, float* vals, float* dist, bool* valid,
                              long long* rows, cudaStream_t stream) {
  if (q <= 0 || w <= 0) return 0;
  if (stride < 3 || n_runs < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = walk_smem(n_runs);
  if (const int err = prepare(fetch_windows_kernel, smem)) return err;
  const int blocks = (q + kWarps - 1) / kWarps;
  fetch_windows_kernel<<<blocks, 32 * kWarps, smem, stream>>>(
      table, stride, queries, starts, ends, n_runs, q, w, vals, dist, valid, rows);
  return last_launch_error();
}

SHOT_EXPORT int radius_dist(const float* table, int stride, const float* queries,
                            const long long* starts, const long long* ends, int n_runs,
                            int q, int w, float radius, long long* rows, float* dist,
                            cudaStream_t stream) {
  if (q <= 0 || w <= 0) return 0;
  if (stride < 3 || n_runs < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = walk_smem(n_runs);
  if (const int err = prepare(radius_dist_kernel, smem)) return err;
  const int blocks = (q + kWarps - 1) / kWarps;
  radius_dist_kernel<<<blocks, 32 * kWarps, smem, stream>>>(table, stride, queries, starts,
                                                            ends, n_runs, q, w, radius, rows,
                                                            dist);
  return last_launch_error();
}
