// K1: SHOT local reference frames + soft binning + 352-bin histogram.
//
// Replaces the TPU kernel
// shot_fpfh_tpu/ops/pallas_shot_fused.py::shot_binning_histogram
// (_binning_histogram_body, _lrf_planes), which builds one-hot operands in
// VMEM and contracts them on the MXU.
//
// Here one thread block serves one keypoint and reads its feature-first
// window (vals (Q, F, W): x y z nx ny nz planes; dist (Q, W), +inf where
// invalid) in the three coalesced passes of shot.cuh (frames, sign votes,
// binning into a shared-memory histogram).  Three modes, as the TPU kernel:
//   - own frames: passes 1–2 over the lanes where dist is finite;
//   - given frames (multiscale sharing): passes 1–2 are skipped;
//   - bi-scale: passes 1–2 read a second validity plane, rf_dist (Q, W), with
//     weights max(rf_radius − d, 0); pass 3 still bins from dist.
// The one-hot matmuls of the TPU kernel were an MXU workaround and are gone.
//
// Bound on the H100: the per-neighbor transcendentals (atan2, acos) and the
// shared-memory atomics of pass 3; the window is read three times but is a
// few KB per keypoint and stays in L1/L2.  The Jacobi is serial on one
// thread (36 trig calls), small beside a window of hundreds of neighbors.
#include "common.cuh"
#include "shot.cuh"

namespace {

// The window's planes as a neighbor source of shot::keypoint_histogram.
struct WindowSource {
  const float *vx, *vy, *vz, *nx, *ny, *nz;
  const float* dist;        // descriptor plane: distance or +inf
  const float* frame_dist;  // frame plane: dist, or the bi-scale rf_dist
  float kx, ky, kz;
  int w_len;

  template <class F>
  __device__ void frame_neighbors(F f) const {
    for (int w = threadIdx.x; w < w_len; w += blockDim.x) {
      const float d = frame_dist[w];
      if (!(d < INFINITY)) continue;
      f(vx[w] - kx, vy[w] - ky, vz[w] - kz, d);
    }
  }

  template <class F>
  __device__ void bin_neighbors(F f) const {
    for (int w = threadIdx.x; w < w_len; w += blockDim.x) {
      const float rho = dist[w];
      if (!(rho < INFINITY) || !(rho > 0.f)) continue;
      f(vx[w] - kx, vy[w] - ky, vz[w] - kz, nx[w], ny[w], nz[w], rho);
    }
  }
};

__global__ void __launch_bounds__(shot::kThreads)
shot_hist_kernel(const float* __restrict__ vals, const float* __restrict__ dist,
                 const float* __restrict__ rf_dist, const float* __restrict__ kp,
                 const float* __restrict__ rfs_in, float* __restrict__ hist,
                 float* __restrict__ rfs_out, int nf, int w_len, float radius,
                 float rf_radius) {
  __shared__ float hist_s[shot::kDim];
  __shared__ float scratch[8 * (shot::kThreads / 32)];
  __shared__ float frame[9];  // row-major rf: columns are the x, y, z axes
  const int qi = blockIdx.x;
  WindowSource src;
  src.vx = vals + (long long)qi * nf * w_len;
  src.vy = src.vx + w_len;
  src.vz = src.vy + w_len;
  src.nx = src.vz + w_len;
  src.ny = src.nx + w_len;
  src.nz = src.ny + w_len;
  src.dist = dist + (long long)qi * w_len;
  src.frame_dist = rf_dist == nullptr ? src.dist : rf_dist + (long long)qi * w_len;
  src.kx = kp[3 * qi];
  src.ky = kp[3 * qi + 1];
  src.kz = kp[3 * qi + 2];
  src.w_len = w_len;

  shot::keypoint_histogram(src, radius, rf_dist == nullptr ? radius : rf_radius,
                           rfs_in == nullptr ? nullptr : rfs_in + 9 * qi,
                           rfs_out == nullptr ? nullptr : rfs_out + 9 * qi, hist_s, scratch,
                           frame);
  for (int i = threadIdx.x; i < shot::kDim; i += blockDim.x)
    hist[(long long)qi * shot::kDim + i] = hist_s[i];
}

}  // namespace

SHOT_EXPORT int shot_binning_histogram(const float* vals, const float* dist,
                                       const float* rf_dist, const float* kp,
                                       const float* rfs_in, float* hist, float* rfs_out, int q,
                                       int nf, int w_len, float radius, float rf_radius,
                                       cudaStream_t stream) {
  if (q <= 0) return 0;
  shot_hist_kernel<<<q, shot::kThreads, 0, stream>>>(vals, dist, rf_dist, kp, rfs_in, hist,
                                                     rfs_out, nf, w_len, radius, rf_radius);
  return last_launch_error();
}
