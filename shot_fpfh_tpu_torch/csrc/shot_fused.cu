// K1: SHOT local reference frames + soft binning + 352-bin histogram.
//
// Replaces the TPU kernel
// shot_fpfh_tpu/ops/pallas_shot_fused.py::shot_binning_histogram
// (_binning_histogram_body, _lrf_planes), which builds one-hot operands in
// VMEM and contracts them on the MXU.
//
// viol: the debug checks' two counters (shot.cuh), or null.
//
// Input: each keypoint's feature-first window (vals (Q, F, W): x y z nx ny nz
// planes; dist (Q, W), +inf where invalid).  Three modes, as the TPU kernel:
//   - own frames: passes 1–2 over the lanes where dist is finite;
//   - given frames (multiscale sharing): passes 1–2 are skipped;
//   - bi-scale: passes 1–2 read a second validity plane, rf_dist (Q, W), with
//     weights max(rf_radius − d, 0); pass 3 still bins from dist.
// The one-hot matmuls of the TPU kernel were an MXU workaround and are gone.
//
// Design for the H100: one warp serves one keypoint, eight keypoints a
// block, and no block barrier is crossed.
//   - Passes 1–2 stride the window's frame plane, four loads a lane in
//     flight; the covariance and the sign votes are reduced with xor
//     shuffles, which leave the same sums, bit for bit, in every lane, so
//     every lane runs the Jacobi (shot.cuh) and holds the frame in
//     registers: a block runs eight Jacobis at once and broadcasts nothing.
//   - Pass 3 compacts the descriptor plane as it streams it: a ballot over
//     32 lanes appends the finite lanes with d > 0 to a 64-slot list in
//     shared memory, and every time 32 are listed the whole warp bins them,
//     so the atan2/acos work runs on full warps whatever the window's fill.
//   - Each warp adds into its own 352-float histogram in shared memory;
//     lanes that add to the same bin (__match_any_sync) sum their weights by
//     shuffles first, so each distinct bin of a step takes one atomic.
// The warp body (passes, reductions, list, binning) is shot.cuh's
// keypoint_histogram, which K5 runs on its xy-row runs; this file gives it
// the window as its neighbor source.
// Bound on the H100: bytes (the dist plane and the finite lanes' six value
// planes, read once); each binned neighbor costs ~150 operations.
#include "common.cuh"
#include "shot.cuh"

namespace {

constexpr int kWarps = 8;  // keypoints a block, one warp each
using shot::kUnroll;       // window lanes a thread loads at once

// One keypoint's window as a neighbor source of shot::keypoint_histogram:
// the frame passes stride the frame plane, kUnroll loads a lane in flight;
// an item is a window lane.
struct Window {
  const float *vx, *vy, *vz, *nx, *ny, *nz;
  const float* dist;        // descriptor plane: distance or +inf
  const float* frame_dist;  // frame plane: dist, or the bi-scale rf_dist
  float kx, ky, kz;
  int w;

  // pass 1 (kVotes false): the covariance sums of add_covariance; pass 2:
  // the sign votes of add_votes against the axes x and z
  template <bool kVotes, int N>
  __device__ __forceinline__ void frame_pass(float r_frame, const float (&x)[3],
                                             const float (&z)[3], float (&acc)[N]) const {
    const int lane = threadIdx.x & 31;
    for (int base = 0; base < w; base += 32 * kUnroll) {
      float d[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + 32 * u + lane;
        d[u] = i < w ? frame_dist[i] : INFINITY;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!(d[u] < INFINITY)) continue;
        const int i = base + 32 * u + lane;
        const float cx = vx[i] - kx, cy = vy[i] - ky, cz = vz[i] - kz;
        if constexpr (kVotes)
          shot::add_votes(acc, cx, cy, cz, x[0], x[1], x[2], z[0], z[1], z[2]);
        else
          shot::add_covariance(acc, cx, cy, cz, d[u], r_frame);
      }
    }
  }

  __device__ __forceinline__ void covariance(float (&s)[8], float r_frame) const {
    const float none[3] = {0.f, 0.f, 0.f};
    frame_pass<false>(r_frame, none, none, s);
  }

  __device__ __forceinline__ void votes(const float (&x)[3], const float (&z)[3],
                                        float (&v)[4]) const {
    frame_pass<true>(0.f, x, z, v);
  }

  // pass 3's candidates: the window's lanes, kUnroll a lane in flight
  using Cursor = int;  // the next step's first lane
  __device__ __forceinline__ int start() const { return 0; }

  __device__ __forceinline__ bool next(int& base, bool (&take)[kUnroll]) const {
    if (base >= w) return false;
    const int lane = threadIdx.x & 31;
    float rho[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + 32 * u + lane;
      rho[u] = i < w ? dist[i] : INFINITY;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) take[u] = rho[u] < INFINITY && rho[u] > 0.f;
    base += 32 * kUnroll;
    return true;
  }

  __device__ __forceinline__ int item(int base, int u) const {
    return base - 32 * kUnroll + 32 * u + (threadIdx.x & 31);
  }

  __device__ __forceinline__ void bin(const shot::Frame& f, float r, int i, int (&idx)[5],
                                      float (&wt)[5], unsigned& bad) const {
    shot::bin_weights(f, vx[i] - kx, vy[i] - ky, vz[i] - kz, nx[i], ny[i], nz[i], dist[i], r,
                      idx, wt, bad);
  }
};

__global__ void __launch_bounds__(32 * kWarps)
shot_hist_kernel(const float* __restrict__ vals, const float* __restrict__ dist,
                 const float* __restrict__ rf_dist, const float* __restrict__ kp,
                 const float* __restrict__ rfs_in, float* __restrict__ hist,
                 float* __restrict__ rfs_out, int q, int nf, int w_len, float radius,
                 float rf_radius, int* __restrict__ viol) {
  __shared__ __align__(16) float hist_s[kWarps][shot::kDim];
  __shared__ int list_s[kWarps][64];  // pass 3's compacted lanes: one step + carry
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kWarps + warp;
  if (qi >= q) return;  // whole warps leave; no block barrier follows
  float* h = hist_s[warp];
  for (int k = lane; k < shot::kDim / 4; k += 32)
    reinterpret_cast<float4*>(h)[k] = make_float4(0.f, 0.f, 0.f, 0.f);

  Window win;
  win.vx = vals + (long long)qi * nf * w_len;
  win.vy = win.vx + w_len;
  win.vz = win.vy + w_len;
  win.nx = win.vz + w_len;
  win.ny = win.nx + w_len;
  win.nz = win.ny + w_len;
  win.dist = dist + (long long)qi * w_len;
  win.frame_dist = rf_dist == nullptr ? win.dist : rf_dist + (long long)qi * w_len;
  win.kx = kp[3 * qi];
  win.ky = kp[3 * qi + 1];
  win.kz = kp[3 * qi + 2];
  win.w = w_len;

  shot::keypoint_histogram(win, radius, rf_dist == nullptr ? radius : rf_radius,
                           rfs_in == nullptr ? nullptr : rfs_in + 9 * qi,
                           rfs_out == nullptr ? nullptr : rfs_out + 9 * qi, h,
                           list_s[warp], viol);

  float4* out = reinterpret_cast<float4*>(hist + (long long)qi * shot::kDim);
  for (int k = lane; k < shot::kDim / 4; k += 32) out[k] = reinterpret_cast<const float4*>(h)[k];
}

}  // namespace

SHOT_EXPORT int shot_binning_histogram(const float* vals, const float* dist,
                                       const float* rf_dist, const float* kp,
                                       const float* rfs_in, float* hist, float* rfs_out, int q,
                                       int nf, int w_len, float radius, float rf_radius,
                                       int* viol, cudaStream_t stream) {
  if (q <= 0) return 0;
  const int blocks = (q + kWarps - 1) / kWarps;
  shot_hist_kernel<<<blocks, 32 * kWarps, 0, stream>>>(vals, dist, rf_dist, kp, rfs_in, hist,
                                                       rfs_out, q, nf, w_len, radius, rf_radius,
                                                       viol);
  return last_launch_error();
}
