// K4: SPFH Darboux angles + binning + histogram on a candidate window.
//
// Replaces the TPU kernel
// shot_fpfh_tpu/ops/pallas_fpfh_fused.py::spfh_histogram (_darboux,
// _spfh_hist_joint, _spfh_hist_decorr), which builds one-hot operands in VMEM
// and contracts them on the MXU.
//
// Here one thread block serves one query and walks its feature-first window
// (vals (C, F, W): x y z nx ny nz planes; dist (C, W), +inf where invalid)
// with consecutive threads on consecutive lanes (coalesced).  Lanes that are
// not finite, or are the query itself (d == 0), are skipped before any
// arithmetic, so a non-finite padding value never reaches a bin.  Each other
// lane computes its Darboux angles and adds one count per bin into an
// n^3-float (joint) or 3n-float (decorrelated) histogram in shared memory by
// atomicAdd (spfh.cuh).  The output is unnormalized: the caller divides by
// the neighborhood count, self included.
//
// Bound on the H100: bytes.  Each lane reads 7 floats once (28 B) and does
// ~70 flops and one atan2f, ~2.5 flop/B against the card's ~20 flop/B
// balance point; the histogram atomics stay in shared memory.
#include "common.cuh"
#include "spfh.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
spfh_hist_kernel(const float* __restrict__ vals, const float* __restrict__ dist,
                 const float* __restrict__ queries, const float* __restrict__ qnormals,
                 float* __restrict__ out, int nf, int w_len, int n_bins, int decorrelated) {
  extern __shared__ float hist_s[];
  const int d_out = spfh::out_dim(n_bins, decorrelated);
  const int qi = blockIdx.x;
  const float* vx = vals + (long long)qi * nf * w_len;
  const float* vy = vx + w_len;
  const float* vz = vy + w_len;
  const float* nxp = vz + w_len;
  const float* nyp = nxp + w_len;
  const float* nzp = nyp + w_len;
  const float* dq = dist + (long long)qi * w_len;
  const float qx = queries[3 * qi], qy = queries[3 * qi + 1], qz = queries[3 * qi + 2];
  const float ux = qnormals[3 * qi], uy = qnormals[3 * qi + 1], uz = qnormals[3 * qi + 2];
  const spfh::Bins bins(n_bins);

  for (int i = threadIdx.x; i < d_out; i += kThreads) hist_s[i] = 0.f;
  __syncthreads();
  for (int w = threadIdx.x; w < w_len; w += kThreads) {
    const float d = dq[w];
    if (!(d < INFINITY) || !(d > 0.f)) continue;
    float alpha, phi, theta;
    spfh::darboux_angles(vx[w] - qx, vy[w] - qy, vz[w] - qz, nxp[w], nyp[w], nzp[w], ux,
                         uy, uz, d, &alpha, &phi, &theta);
    spfh::add_neighbor(hist_s, bins, decorrelated != 0, alpha, phi, theta);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < d_out; i += kThreads)
    out[(long long)qi * d_out + i] = hist_s[i];
}

}  // namespace

SHOT_EXPORT int spfh_histogram(const float* vals, const float* dist, const float* queries,
                               const float* qnormals, float* out, int c, int nf, int w_len,
                               int n_bins, int decorrelated, cudaStream_t stream) {
  if (c <= 0) return 0;
  const size_t smem = sizeof(float) * spfh::out_dim(n_bins, decorrelated);
  spfh_hist_kernel<<<c, kThreads, smem, stream>>>(vals, dist, queries, qnormals, out, nf,
                                                  w_len, n_bins, decorrelated);
  return last_launch_error();
}
