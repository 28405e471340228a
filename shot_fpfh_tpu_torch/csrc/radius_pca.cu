// K3: streaming radius covariance behind normals.
//
// Replaces the TPU kernel shot_fpfh_tpu/ops/pallas_radius.py::radius_pca_pallas
// (_pca_kernel via _pca_call), which DMAs each query's 9 z-column runs of the
// cell-sorted cloud into VMEM and reduces them there.
//
// Here one warp serves one query: it walks the query's contiguous runs with
// consecutive lanes on consecutive rows (coalesced loads), keeps the points
// within the query's own squared radius, and warp-reduces the count, Σd and
// the six second moments of d = p - q.  The host finalizes covariance and
// barycenter from these 10 sums (ops/grid_hash.py::moments_to_pca).
//
// Bound on the H100: bytes.  Each query reads its window (about 9 runs x
// the column occupancy x 12 bytes) once and does ~20 flops per point, far
// below the card's ~20 flop/byte balance point; neighboring queries share
// runs, so most of those reads hit L2.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void radius_pca_kernel(const float* __restrict__ table, int stride,
                                  const float* __restrict__ queries,
                                  const float* __restrict__ r2,
                                  const long long* __restrict__ starts,
                                  const long long* __restrict__ ends,
                                  int n_runs, int q, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (qi >= q) return;  // whole warps exit together
  const float qx = queries[3 * qi], qy = queries[3 * qi + 1], qz = queries[3 * qi + 2];
  const float rr = r2[qi];
  float acc[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) acc[k] = 0.f;
  for (int run = 0; run < n_runs; ++run) {
    const long long s = starts[(long long)qi * n_runs + run];
    const long long e = ends[(long long)qi * n_runs + run];
    for (long long i = s + lane; i < e; i += 32) {
      const float* p = table + i * stride;
      const float dx = p[0] - qx, dy = p[1] - qy, dz = p[2] - qz;
      // the reference's contracted x²+y²+z² (see _fp.py)
      const float d2 = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
      if (d2 <= rr) {
        acc[0] += 1.f;
        acc[1] += dx;
        acc[2] += dy;
        acc[3] += dz;
        acc[4] += dx * dx;
        acc[5] += dy * dy;
        acc[6] += dz * dz;
        acc[7] += dx * dy;
        acc[8] += dx * dz;
        acc[9] += dy * dz;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 10; ++k) acc[k] = warp_sum(acc[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 10; ++k) out[10 * qi + k] = acc[k];
  }
}

}  // namespace

SHOT_EXPORT int radius_pca(const float* table, int stride, const float* queries,
                           const float* r2, const long long* starts,
                           const long long* ends, int n_runs, int q, float* out,
                           cudaStream_t stream) {
  if (q <= 0) return 0;
  const int blocks = (q + kWarpsPerBlock - 1) / kWarpsPerBlock;
  radius_pca_kernel<<<blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      table, stride, queries, r2, starts, ends, n_runs, q, out);
  return last_launch_error();
}
