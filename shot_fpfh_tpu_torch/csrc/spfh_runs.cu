// K6: count-normalized SPFH straight from the grid's xy-row runs.
//
// Replaces the TPU kernels shot_fpfh_tpu/ops/pallas_shot_dma.py::spfh_block_dma
// (_spfh_dma_kernel) and spfh_sorted_dma, which DMA each query's 2h+1
// xy-row runs of the (n_tiles, 8, 128) table into VMEM and run K4's body.
//
// A row of the cell-sorted [x y z nx ny nz ...] table is in a query's
// neighborhood when its squared distance, the reference's contracted
// fma(dz, dz, fma(dy, dy, dx*dx)), is <= r*r; every such row counts (the
// query itself too), and every one but the query (d = 0) adds its Darboux
// bins (spfh.cuh, shared with K4).  The row is the histogram divided by
// max(count, 1).
//
// Design for the H100: one warp a query, eight a block, no block barrier.
//   - The warp finds its query's runs from the grid's cell-start table
//     (runs.cuh, shared with K5: one run a lane), so the wrapper launches
//     no index ops.
//   - The walk puts the lanes on consecutive rows of a run, kUnroll rows a
//     lane in flight, with 32-bit row indices.  A ballot appends the rows
//     in radius to a ring of rows in shared memory; the count is the
//     number of rows listed.
//   - Whenever 32 rows are listed the whole warp bins them, one a lane, so
//     the atan2 work runs on full warps: each lane reads its row again,
//     drops it at d = 0, and takes d_safe = sqrtf of the same fma chain the
//     walk tested.  The binning has one call site, so its code is inlined
//     once.
//   - Each warp counts into its own histogram of ints in shared memory,
//     one atomic a distinct bin of a step (spfh::warp_count); counts are
//     whole numbers under 2^24, so the float row equals the twin's.
// Bound on the H100: operations.  The table is ~24 B a point and comes
// from L1 or L2 for every query whose runs cover it; the walk issues about
// one instruction a row, and a binned neighbor about two hundred (its IEEE
// square root and division, the accurate atan2f with its own division,
// three bin indices and the warp's atomic), where the bound counts ~75
// flops.  Cutting either part's instructions moved the kernel by a few per
// cent at most (PERF.md): neither alone sets its time.
#include "common.cuh"
#include "runs.cuh"
#include "spfh.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;    // queries a block, one warp each
constexpr int kUnroll = 4;   // rows a lane loads at once
// listed rows a warp holds: a step appends at most 32 * kUnroll rows to
// fewer than 32 not yet binned, and the 32 slots binned last are not
// written by the next step either
constexpr int kRing = 256;
static_assert(kRing >= 32 * kUnroll + 64 && (kRing & (kRing - 1)) == 0,
              "the ring holds a step and the slots binned before it, and wraps by mask");

// One query's neighborhood as its warp accumulates it: the listed rows and
// the binning into the warp's histogram.  Every lane of the warp calls
// every member together.
struct Query {
  const float* table;
  int stride;
  float qx, qy, qz, ux, uy, uz;
  float rr;
  spfh::Bins bins;
  bool dec;
  int* hist;  // the warp's d_out counts in shared memory
  int* ring;  // the warp's kRing listed rows in shared memory
  int head;   // rows listed and binned (the ring's read position)
  int n;      // rows listed, not binned yet

  __device__ Query(const float* table_, int stride_, const float* q, const float* u,
                   float radius, int n_bins, bool dec_, int* hist_, int* ring_)
      : table(table_), stride(stride_), qx(q[0]), qy(q[1]), qz(q[2]), ux(u[0]), uy(u[1]),
        uz(u[2]), rr(radius * radius), bins(n_bins), dec(dec_), hist(hist_), ring(ring_),
        head(0), n(0) {}

  __device__ __forceinline__ float rho2(const float* p, float& dx, float& dy, float& dz) const {
    dx = p[0] - qx;
    dy = p[1] - qy;
    dz = p[2] - qz;
    return fmaf(dz, dz, fmaf(dy, dy, dx * dx));
  }

  // bins table row `row` of every lane (row < 0, or the query itself: none)
  __device__ __forceinline__ void bin(int row) const {
    int idx[3] = {-1, -1, -1};
    if (row >= 0) {
      const float* p = table + (long long)row * stride;
      float dx, dy, dz;
      const float d2 = rho2(p, dx, dy, dz);
      if (d2 > 0.f) {
        float alpha, phi, theta;
        spfh::darboux_angles(dx, dy, dz, p[3], p[4], p[5], ux, uy, uz, sqrtf(d2), &alpha, &phi,
                             &theta);
        spfh::bin_slots(bins, dec, alpha, phi, theta, idx);
      }
    }
    spfh::warp_count(hist, idx[0]);
    if (dec) {
      spfh::warp_count(hist, idx[1]);
      spfh::warp_count(hist, idx[2]);
    }
  }

  // bins the listed rows 32 at a time while 32 are listed (all: until none)
  __device__ __forceinline__ void drain(bool all) {
    const int lane = threadIdx.x & 31;
    while (n >= 32 || (all && n > 0)) {
      __syncwarp();  // the listed rows are written
      const int row = lane < n ? ring[(head + lane) & (kRing - 1)] : -1;
      head += 32;
      n = n > 32 ? n - 32 : 0;
      bin(row);
    }
  }

  // lists the rows of [lo, hi) in radius, lanes on consecutive rows, and
  // bins them as they fill the warp
  __device__ __forceinline__ void walk(int lo, int hi) {
    const int lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1u;
    for (int base = lo; base < hi; base += 32 * kUnroll) {
      float d2[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + 32 * u + lane;
        float dx, dy, dz;
        d2[u] = i < hi ? rho2(table + (long long)i * stride, dx, dy, dz) : INFINITY;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool in = d2[u] <= rr;
        const unsigned ballot = __ballot_sync(kFull, in);
        if (in) ring[(head + n + __popc(ballot & below)) & (kRing - 1)] = base + 32 * u + lane;
        n += __popc(ballot);
      }
      drain(false);
    }
  }
};

__global__ void __launch_bounds__(32 * kWarps)
spfh_runs_kernel(const float* __restrict__ table, int stride,
                 const long long* __restrict__ cell_starts, const float* __restrict__ origin,
                 float cell_size, long long d0, long long d1, long long d2, int halo,
                 const float* __restrict__ queries, const float* __restrict__ qnormals,
                 int qstride, int q, float radius, int n_bins, int decorrelated,
                 float* __restrict__ out) {
  extern __shared__ int smem[];  // kWarps x d_out counts, then kWarps x kRing rows
  const int d_out = spfh::out_dim(n_bins, decorrelated);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kWarps + warp;
  if (qi >= q) return;  // whole warps leave; no block barrier follows
  Query qr(table, stride, queries + (long long)qi * qstride, qnormals + (long long)qi * qstride,
           radius, n_bins, decorrelated != 0, smem + warp * d_out,
           smem + kWarps * d_out + warp * kRing);
  for (int k = lane; k < d_out; k += 32) qr.hist[k] = 0;

  long long c[3];
  runs::query_cell(origin, cell_size, qr.qx, qr.qy, qr.qz, c);
  const int n_runs = 2 * halo + 1;
  long long s = 0, e = 0;
  if (lane < n_runs) runs::xyrow_run(cell_starts, d0, d1, d2, halo, c, lane, s, e);
  const int run_s = (int)s, run_e = (int)e;  // rows < 2^31 (the wrapper checks)
  __syncwarp();  // the histogram is zeroed

  for (int run = 0; run < n_runs; ++run)
    qr.walk(__shfl_sync(kFull, run_s, run), __shfl_sync(kFull, run_e, run));
  const int count = qr.head + qr.n;  // every row listed: the neighborhood, the query too
  qr.drain(true);
  __syncwarp();
  const float denom = (float)(count > 1 ? count : 1);
  float* o = out + (long long)qi * d_out;
  for (int k = lane; k < d_out; k += 32) o[k] = (float)qr.hist[k] / denom;
}

}  // namespace

// The grid as ops/grid_hash.py::HashGrid holds it (cell-start table,
// origin, cell size, dims, halo <= 15) and q queries with their normals,
// query i at queries + i * qstride (the table's own rows, or a (q, 3)
// array).
SHOT_EXPORT int spfh_runs(const float* table, int stride, const long long* cell_starts,
                          const float* origin, float cell_size, long long d0, long long d1,
                          long long d2, int halo, const float* queries, const float* qnormals,
                          int qstride, int q, float radius, int n_bins, int decorrelated,
                          float* out, cudaStream_t stream) {
  if (q <= 0) return 0;
  if (halo < 0 || 2 * halo + 1 > 32) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (q + kWarps - 1) / kWarps;
  const size_t smem = sizeof(int) * kWarps * (spfh::out_dim(n_bins, decorrelated) + kRing);
  if (smem > 48 * 1024) {  // joint histograms of more than 10^3 bins
    const cudaError_t err = cudaFuncSetAttribute(
        spfh_runs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  spfh_runs_kernel<<<blocks, 32 * kWarps, smem, stream>>>(
      table, stride, cell_starts, origin, cell_size, d0, d1, d2, halo, queries, qnormals,
      qstride, q, radius, n_bins, decorrelated, out);
  return last_launch_error();
}
