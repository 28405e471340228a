// K4: SPFH Darboux angles + binning + histogram on a candidate window.
//
// Replaces the TPU kernel
// shot_fpfh_tpu/ops/pallas_fpfh_fused.py::spfh_histogram (_darboux,
// _spfh_hist_joint, _spfh_hist_decorr), which builds one-hot operands in VMEM
// and contracts them on the MXU.
//
// Input: each query's feature-first window (vals (C, F, W): x y z nx ny nz
// planes; dist (C, W), +inf where invalid).  Lanes that are not finite, or
// are the query itself (d == 0), get no bin, so a non-finite padding value
// never reaches one.  Each other lane adds one count to its n^3 joint bin
// or, decorrelated, one to each in-range angle's bin of the 3n interleaved
// layout (spfh.cuh).  The output is unnormalized: the caller divides by the
// neighborhood count, self included.
//
// Design for the H100: one warp serves one query, up to eight a block, and
// no block barrier is crossed.
//   - The warp streams the dist plane, four loads a lane in flight; a ballot
//     appends the lanes with 0 < d < inf to a 64-slot list in shared memory,
//     and every time 32 are listed the whole warp reads their six value
//     planes and runs their Darboux angles and bins, so the atan2 work runs
//     on full warps and the value planes are read only at listed lanes.
//   - Each warp counts into its own histogram of ints in shared memory;
//     lanes that add to the same bin (__match_any_sync) add their number in
//     one atomic, so each distinct bin of a step takes one atomic however
//     concentrated the neighbors' bins are.  Counts are whole numbers under
//     2^24, so the float written at the end equals the twin's float sum.
// Bound on the H100: bytes (the dist plane, and the value planes at the
// finite lanes, read once); each listed lane does ~70 flops and one atan2f.
#include "common.cuh"
#include "spfh.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnroll = 4;  // window lanes a thread loads at once

struct Window {
  const float *vx, *vy, *vz, *nx, *ny, *nz;
  const float* dist;
  float qx, qy, qz, ux, uy, uz;
};

// Bins window lane i (i < 0: none) of every lane into the warp's histogram.
__device__ __forceinline__ void bin_lanes(const Window& win, const spfh::Bins& bins,
                                          bool decorrelated, int* hist, int i) {
  int idx[3] = {-1, -1, -1};
  if (i >= 0) {
    float alpha, phi, theta;
    spfh::darboux_angles(win.vx[i] - win.qx, win.vy[i] - win.qy, win.vz[i] - win.qz, win.nx[i],
                         win.ny[i], win.nz[i], win.ux, win.uy, win.uz, win.dist[i], &alpha, &phi,
                         &theta);
    spfh::bin_slots(bins, decorrelated, alpha, phi, theta, idx);
  }
  spfh::warp_count(hist, idx[0]);
  if (decorrelated) {
    spfh::warp_count(hist, idx[1]);
    spfh::warp_count(hist, idx[2]);
  }
}

__global__ void __launch_bounds__(256)
spfh_hist_kernel(const float* __restrict__ vals, const float* __restrict__ dist,
                 const float* __restrict__ queries, const float* __restrict__ qnormals,
                 float* __restrict__ out, int c, int nf, int w_len, int n_bins,
                 int decorrelated) {
  extern __shared__ int smem[];  // warps x (d_out counts), then warps x 64 list slots
  const int d_out = spfh::out_dim(n_bins, decorrelated);
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qi = blockIdx.x * warps + warp;
  if (qi >= c) return;  // whole warps leave; no block barrier follows
  int* hist = smem + warp * d_out;
  int* list = smem + warps * d_out + warp * 64;
  for (int k = lane; k < d_out; k += 32) hist[k] = 0;

  Window win;
  win.vx = vals + (long long)qi * nf * w_len;
  win.vy = win.vx + w_len;
  win.vz = win.vy + w_len;
  win.nx = win.vz + w_len;
  win.ny = win.nx + w_len;
  win.nz = win.ny + w_len;
  win.dist = dist + (long long)qi * w_len;
  win.qx = queries[3 * qi];
  win.qy = queries[3 * qi + 1];
  win.qz = queries[3 * qi + 2];
  win.ux = qnormals[3 * qi];
  win.uy = qnormals[3 * qi + 1];
  win.uz = qnormals[3 * qi + 2];
  const spfh::Bins bins(n_bins);
  const bool dec = decorrelated != 0;
  __syncwarp();  // the histogram is zeroed

  const unsigned below = (1u << lane) - 1u;
  int n = 0;  // listed lanes not binned yet (the same in every lane)
  for (int base = 0; base < w_len; base += 32 * kUnroll) {
    float d[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + 32 * u + lane;
      d[u] = i < w_len ? win.dist[i] : INFINITY;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool take = d[u] < INFINITY && d[u] > 0.f;
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
        bin_lanes(win, bins, dec, hist, i);
      }
    }
  }
  __syncwarp();
  if (n > 0) bin_lanes(win, bins, dec, hist, lane < n ? list[lane] : -1);
  __syncwarp();
  float* o = out + (long long)qi * d_out;
  for (int k = lane; k < d_out; k += 32) o[k] = (float)hist[k];
}

}  // namespace

SHOT_EXPORT int spfh_histogram(const float* vals, const float* dist, const float* queries,
                               const float* qnormals, float* out, int c, int nf, int w_len,
                               int n_bins, int decorrelated, cudaStream_t stream) {
  if (c <= 0) return 0;
  // eight warps a block while their histograms and lists fit in 48 KB
  const int slots = spfh::out_dim(n_bins, decorrelated) + 64;
  const int fit = 48 * 1024 / (int)sizeof(int) / slots;
  const int warps = fit < 1 ? 1 : (fit > 8 ? 8 : fit);
  const size_t smem = sizeof(int) * warps * slots;
  spfh_hist_kernel<<<(c + warps - 1) / warps, 32 * warps, smem, stream>>>(
      vals, dist, queries, qnormals, out, c, nf, w_len, n_bins, decorrelated);
  return last_launch_error();
}
