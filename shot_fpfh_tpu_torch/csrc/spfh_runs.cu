// K6: count-normalized SPFH straight from the grid's xy-row runs.
//
// Replaces the TPU kernels shot_fpfh_tpu/ops/pallas_shot_dma.py::spfh_block_dma
// (_spfh_dma_kernel) and spfh_sorted_dma, which DMA each query's 2h+1
// xy-row runs of the (n_tiles, 8, 128) table into VMEM and run K4's body.
//
// Here one warp serves one query: it walks the query's contiguous runs of
// the cell-sorted [x y z nx ny nz ...] table with consecutive lanes on
// consecutive rows (coalesced, as K3 walks its z-column runs), so no (Q, W)
// window is ever gathered.  A row is in the neighborhood when its squared
// distance, the reference's contracted fma(dz, dz, fma(dy, dy, dx*dx)), is
// <= r*r; every such row counts (the query itself too), and every one but
// the query adds its Darboux bins (spfh.cuh, shared with K4) into the
// warp's own histogram in shared memory.  The warp then divides by
// max(count, 1) and writes the row.
//
// Bound on the H100: operations.  The table is ~24 B a point and read from
// L2 by every query whose runs cover it; each query tests ~5 runs of rows
// (~10 flops each) and bins its in-radius neighbors (~70 flops and one
// atan2f each), while the bytes that must cross device memory are the
// table once and the output rows.
#include "common.cuh"
#include "spfh.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
spfh_runs_kernel(const float* __restrict__ table, int stride,
                 const float* __restrict__ queries, const float* __restrict__ qnormals,
                 const long long* __restrict__ starts, const long long* __restrict__ ends,
                 int n_runs, int q, float radius, int n_bins, int decorrelated,
                 float* __restrict__ out) {
  extern __shared__ float smem[];
  const int d_out = spfh::out_dim(n_bins, decorrelated);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int qi = blockIdx.x * kWarpsPerBlock + warp;
  if (qi >= q) return;  // whole warps exit together; no block barrier below
  float* hist = smem + warp * d_out;
  for (int i = lane; i < d_out; i += 32) hist[i] = 0.f;
  __syncwarp();

  const float qx = queries[3 * qi], qy = queries[3 * qi + 1], qz = queries[3 * qi + 2];
  const float ux = qnormals[3 * qi], uy = qnormals[3 * qi + 1], uz = qnormals[3 * qi + 2];
  const float rr = radius * radius;
  const spfh::Bins bins(n_bins);
  float count = 0.f;
  for (int run = 0; run < n_runs; ++run) {
    const long long s = starts[(long long)qi * n_runs + run];
    const long long e = ends[(long long)qi * n_runs + run];
    for (long long i = s + lane; i < e; i += 32) {
      const float* p = table + i * stride;
      const float dx = p[0] - qx, dy = p[1] - qy, dz = p[2] - qz;
      const float rho2 = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
      if (!(rho2 <= rr)) continue;
      count += 1.f;
      if (!(rho2 > 0.f)) continue;
      float alpha, phi, theta;
      spfh::darboux_angles(dx, dy, dz, p[3], p[4], p[5], ux, uy, uz, sqrtf(rho2), &alpha,
                           &phi, &theta);
      spfh::add_neighbor(hist, bins, decorrelated != 0, alpha, phi, theta);
    }
  }
  count = __shfl_sync(0xffffffffu, warp_sum(count), 0);
  __syncwarp();
  const float denom = fmaxf(count, 1.f);
  for (int i = lane; i < d_out; i += 32) out[(long long)qi * d_out + i] = hist[i] / denom;
}

}  // namespace

SHOT_EXPORT int spfh_runs(const float* table, int stride, const float* queries,
                          const float* qnormals, const long long* starts,
                          const long long* ends, int n_runs, int q, float radius,
                          int n_bins, int decorrelated, float* out, cudaStream_t stream) {
  if (q <= 0) return 0;
  const int blocks = (q + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const size_t smem = sizeof(float) * kWarpsPerBlock * spfh::out_dim(n_bins, decorrelated);
  spfh_runs_kernel<<<blocks, 32 * kWarpsPerBlock, smem, stream>>>(
      table, stride, queries, qnormals, starts, ends, n_runs, q, radius, n_bins,
      decorrelated, out);
  return last_launch_error();
}
