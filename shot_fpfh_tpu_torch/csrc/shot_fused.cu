// K1: SHOT local reference frames + soft binning + 352-bin histogram.
//
// Replaces the TPU kernel
// shot_fpfh_tpu/ops/pallas_shot_fused.py::shot_binning_histogram
// (_binning_histogram_body, _lrf_planes), which builds one-hot operands in
// VMEM and contracts them on the MXU.
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
// Bound on the H100: bytes (the dist plane and the finite lanes' six value
// planes, read once); each binned neighbor costs ~150 operations.
#include "common.cuh"
#include "shot.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;   // keypoints a block, one warp each
constexpr int kUnroll = 4;  // window lanes a thread loads at once

// Sums N values over the warp.  The xor butterfly adds a + b in one lane
// and b + a in its partner, so every lane ends with the same sums.
template <int N>
__device__ __forceinline__ void warp_allsum(float (&v)[N]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] += __shfl_xor_sync(kFull, v[k], off);
}

// hist[idx] += wt for every lane of the warp (all lanes call it; idx < 0
// adds nothing).  Lanes with the same idx sum their weights by shuffles in a
// tree over their ranks, and the lowest of them adds the sum: one atomic a
// distinct bin.
__device__ __forceinline__ void warp_add(float* hist, int idx, float wt) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(kFull, idx);
  unsigned rank = __popc(peers & ((1u << lane) - 1u));   // peers below this lane
  unsigned above = peers & ~((2u << lane) - 1u);         // peers above it
  float sum = wt;
  while (__any_sync(kFull, above)) {
    const int next = __ffs(above);  // 1 + the next peer above, or 0
    const float t = __shfl_sync(kFull, sum, (next - 1) & 31);
    if (next) sum += t;
    // odd ranks have been summed into the peer below them: drop them
    above &= ~__ballot_sync(kFull, rank & 1u);
    rank >>= 1;
  }
  if (idx >= 0 && lane == __ffs(peers) - 1) atomicAdd(hist + idx, sum);
}

struct Window {
  const float *vx, *vy, *vz, *nx, *ny, *nz;
  const float* dist;        // descriptor plane: distance or +inf
  const float* frame_dist;  // frame plane: dist, or the bi-scale rf_dist
  float kx, ky, kz;
  int w;
};

// Pass 1 (kVotes false): the covariance sums of add_covariance; pass 2:
// the sign votes of add_votes against the axes x and z.
template <bool kVotes, int N>
__device__ __forceinline__ void frame_pass(const Window& win, float r_frame, const float (&x)[3],
                                           const float (&z)[3], float (&acc)[N]) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < win.w; base += 32 * kUnroll) {
    float d[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + 32 * u + lane;
      d[u] = i < win.w ? win.frame_dist[i] : INFINITY;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!(d[u] < INFINITY)) continue;
      const int i = base + 32 * u + lane;
      const float cx = win.vx[i] - win.kx, cy = win.vy[i] - win.ky, cz = win.vz[i] - win.kz;
      if constexpr (kVotes)
        shot::add_votes(acc, cx, cy, cz, x[0], x[1], x[2], z[0], z[1], z[2]);
      else
        shot::add_covariance(acc, cx, cy, cz, d[u], r_frame);
    }
  }
  warp_allsum(acc);
}

// Bins window lane i (i < 0: none) of every lane into the warp's histogram.
__device__ __forceinline__ void bin_lanes(const Window& win, const shot::Frame& f, float r,
                                          float* hist, int i) {
  int idx[5] = {-1, -1, -1, -1, -1};
  float wt[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (i >= 0)
    shot::bin_weights(f, win.vx[i] - win.kx, win.vy[i] - win.ky, win.vz[i] - win.kz, win.nx[i],
                      win.ny[i], win.nz[i], win.dist[i], r, idx, wt);
#pragma unroll
  for (int c = 0; c < 5; ++c) warp_add(hist, idx[c], wt[c]);
}

__global__ void __launch_bounds__(32 * kWarps)
shot_hist_kernel(const float* __restrict__ vals, const float* __restrict__ dist,
                 const float* __restrict__ rf_dist, const float* __restrict__ kp,
                 const float* __restrict__ rfs_in, float* __restrict__ hist,
                 float* __restrict__ rfs_out, int q, int nf, int w_len, float radius,
                 float rf_radius) {
  __shared__ __align__(16) float hist_s[kWarps][shot::kDim];
  __shared__ int list_s[kWarps][64];  // pass 3's compacted lanes: one step + carry
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kWarps + warp;
  if (qi >= q) return;  // whole warps leave; no block barrier follows
  float* h = hist_s[warp];
  int* list = list_s[warp];
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

  float frame[9];  // row-major rf, the same in every lane: columns x, y, z
  if (rfs_in == nullptr) {
    const float r_frame = rf_dist == nullptr ? radius : rf_radius;
    float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float x[3] = {0.f, 0.f, 0.f}, z[3] = {0.f, 0.f, 0.f};
    frame_pass<false>(win, r_frame, x, z, s);
    shot::frame_axes(s, x, z);
    float votes[4] = {0.f, 0.f, 0.f, 0.f};
    frame_pass<true>(win, r_frame, x, z, votes);
    shot::signed_frame(x, z, votes, s[7], frame);
    if (lane == 0)
      for (int i = 0; i < 9; ++i) rfs_out[9 * qi + i] = frame[i];
  } else {
    for (int i = 0; i < 9; ++i) frame[i] = rfs_in[9 * qi + i];
  }
  const shot::Frame f(frame);
  __syncwarp();  // the histogram is zeroed

  // pass 3: stream the descriptor plane, list its lanes with 0 < d < inf,
  // bin them 32 at a time
  const unsigned below = (1u << lane) - 1u;
  int n = 0;  // listed lanes not binned yet (the same in every lane)
  for (int base = 0; base < w_len; base += 32 * kUnroll) {
    float rho[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + 32 * u + lane;
      rho[u] = i < w_len ? win.dist[i] : INFINITY;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool take = rho[u] < INFINITY && rho[u] > 0.f;
      const unsigned ballot = __ballot_sync(kFull, take);
      if (take) list[n + __popc(ballot & below)] = base + 32 * u + lane;
      n += __popc(ballot);
      if (n >= 32) {
        __syncwarp();
        const int i = list[lane];
        const int carry = lane < n - 32 ? list[32 + lane] : 0;
        __syncwarp();
        if (lane < n - 32) list[lane] = carry;
        n -= 32;
        bin_lanes(win, f, radius, h, i);
      }
    }
  }
  __syncwarp();
  if (n > 0) bin_lanes(win, f, radius, h, lane < n ? list[lane] : -1);
  __syncwarp();

  float4* out = reinterpret_cast<float4*>(hist + (long long)qi * shot::kDim);
  for (int k = lane; k < shot::kDim / 4; k += 32) out[k] = reinterpret_cast<const float4*>(h)[k];
}

}  // namespace

SHOT_EXPORT int shot_binning_histogram(const float* vals, const float* dist,
                                       const float* rf_dist, const float* kp,
                                       const float* rfs_in, float* hist, float* rfs_out, int q,
                                       int nf, int w_len, float radius, float rf_radius,
                                       cudaStream_t stream) {
  if (q <= 0) return 0;
  const int blocks = (q + kWarps - 1) / kWarps;
  shot_hist_kernel<<<blocks, 32 * kWarps, 0, stream>>>(vals, dist, rf_dist, kp, rfs_in, hist,
                                                       rfs_out, q, nf, w_len, radius, rf_radius);
  return last_launch_error();
}
