// K5: SHOT frames + soft binning + 352-bin histogram read straight from the
// grid's xy-row runs.
//
// Replaces the TPU kernel shot_fpfh_tpu/ops/pallas_shot_dma.py::
// shot_descriptor_dma (_dma_kernel), which DMAs each query's 2h+1 xy-row
// runs of the (n_tiles, 8, 128) table into VMEM and runs K1's body on them.
//
// Here one thread block serves one keypoint: each of the three passes of
// shot.cuh (frames, sign votes, binning; shared with K1) walks the
// keypoint's contiguous runs of the cell-sorted [x y z nx ny nz ...] table,
// consecutive threads on consecutive rows, so no (Q, W) window is gathered.
// A row is in the descriptor plane when its squared distance, the
// reference's contracted fma(dz, dz, fma(dy, dy, dx*dx)), is <= r*r (K3's
// and K6's rule), with d = sqrt of it; in bi-scale mode the frame plane is
// the rows with that squared distance <= r_rf*r_rf.  The block also counts
// the descriptor plane's rows with d > 0, which the caller's
// min-neighborhood rule reads.  Three modes, as K1: own frames, given
// frames (passes 1–2 skipped), bi-scale.
//
// Bound on the H100: operations.  The table is ~24 B a point and comes from
// L2 for every keypoint whose runs cover it; each pass tests every row of
// the runs (~10 flops), pass 3 bins the in-radius neighbors (~130 flops, an
// atan2f and an acosf each, five shared-memory atomics), while the bytes
// that must cross device memory are the table once and the output rows.
#include "common.cuh"
#include "shot.cuh"

namespace {

// One keypoint's xy-row runs as a neighbor source of shot::keypoint_histogram.
struct RunSource {
  const float* table;
  int stride;
  const long long* starts;  // this keypoint's n_runs run bounds
  const long long* ends;
  int n_runs;
  float kx, ky, kz;
  float rr;        // descriptor plane: squared radius
  float rr_frame;  // frame plane: squared radius (rf_radius² in bi-scale mode)

  template <class F>
  __device__ void frame_neighbors(F f) const {
    for (int run = 0; run < n_runs; ++run)
      for (long long i = starts[run] + threadIdx.x; i < ends[run]; i += blockDim.x) {
        const float* p = table + i * stride;
        const float dx = p[0] - kx, dy = p[1] - ky, dz = p[2] - kz;
        const float rho2 = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
        if (!(rho2 <= rr_frame)) continue;
        f(dx, dy, dz, sqrtf(rho2));
      }
  }

  template <class F>
  __device__ void bin_neighbors(F f) const {
    for (int run = 0; run < n_runs; ++run)
      for (long long i = starts[run] + threadIdx.x; i < ends[run]; i += blockDim.x) {
        const float* p = table + i * stride;
        const float dx = p[0] - kx, dy = p[1] - ky, dz = p[2] - kz;
        const float rho2 = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
        if (!(rho2 <= rr) || !(rho2 > 0.f)) continue;
        f(dx, dy, dz, p[3], p[4], p[5], sqrtf(rho2));
      }
  }
};

__global__ void __launch_bounds__(shot::kThreads)
shot_runs_kernel(const float* __restrict__ table, int stride, const float* __restrict__ kp,
                 const long long* __restrict__ starts, const long long* __restrict__ ends,
                 int n_runs, const float* __restrict__ rfs_in, float radius, float rf_radius,
                 float* __restrict__ hist, float* __restrict__ rfs_out,
                 float* __restrict__ count) {
  __shared__ float hist_s[shot::kDim];
  __shared__ float scratch[8 * (shot::kThreads / 32)];
  __shared__ float frame[9];  // row-major rf: columns are the x, y, z axes
  const int qi = blockIdx.x;
  RunSource src;
  src.table = table;
  src.stride = stride;
  src.starts = starts + (long long)qi * n_runs;
  src.ends = ends + (long long)qi * n_runs;
  src.n_runs = n_runs;
  src.kx = kp[3 * qi];
  src.ky = kp[3 * qi + 1];
  src.kz = kp[3 * qi + 2];
  src.rr = radius * radius;
  src.rr_frame = rf_radius * rf_radius;

  float n[1] = {shot::keypoint_histogram(src, radius, rf_radius,
                                         rfs_in == nullptr ? nullptr : rfs_in + 9 * qi,
                                         rfs_out == nullptr ? nullptr : rfs_out + 9 * qi,
                                         hist_s, scratch, frame)};
  block_sum<1>(n, scratch);
  for (int i = threadIdx.x; i < shot::kDim; i += blockDim.x)
    hist[(long long)qi * shot::kDim + i] = hist_s[i];
  if (threadIdx.x == 0) count[qi] = n[0];
}

}  // namespace

// rf_radius is the frame plane's radius: the descriptor radius unless in
// bi-scale mode.
SHOT_EXPORT int shot_runs(const float* table, int stride, const float* kp,
                          const long long* starts, const long long* ends, int n_runs, int q,
                          const float* rfs_in, float radius, float rf_radius, float* hist,
                          float* rfs_out, float* count, cudaStream_t stream) {
  if (q <= 0) return 0;
  shot_runs_kernel<<<q, shot::kThreads, 0, stream>>>(table, stride, kp, starts, ends, n_runs,
                                                     rfs_in, radius, rf_radius, hist, rfs_out,
                                                     count);
  return last_launch_error();
}
