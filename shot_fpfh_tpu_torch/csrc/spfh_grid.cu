// FPFH's SPFH pass on the grid window route: each query's count-normalized
// SPFH row straight from the grid's z-column runs, in one launch a cloud.
//
// Replaces, on this route, the pair of TPU kernels
// shot_fpfh_tpu/ops/pallas_radius.py::fetch_windows_pallas (the window
// fetch) and shot_fpfh_tpu/ops/pallas_fpfh_fused.py::spfh_histogram (the
// angles and bins over that window), which the port had run as K8
// (radius_runs.cu, fetch_windows_kernel) writing each query's (F + 2)-plane
// window to device memory, PyTorch's radius mask, count and `where` over it,
// and K4 (spfh_fused.cu) reading it back, in 8,192-query chunks.  Here no
// window exists: for each query, inside the kernel,
//   - its cell and (2h+1)² z-column runs come from the cell-start table
//     (runs.cuh), one run a lane; the runs are walked in window order and
//     cut at the window cap w, as fpfh_aggregate.cu cuts them, so the slots
//     walked are the window's valid slots;
//   - a slot is in radius when d = sqrtf(fmaf(dz, dz, fmaf(dy, dy, dx * dx)))
//     <= radius, K8's distance and the route's test.  sqrtf is correctly
//     rounded, so it does not decrease, and that test holds exactly for the
//     squared distances up to the largest float whose sqrtf is <= radius
//     (runs.cuh, sq_bound): the walk compares the fma chain with that bound
//     and takes no square root;
//   - a ballot lists the slots in radius in a ring in shared memory, the
//     count being the number listed (the query's own row and any duplicate
//     at d = 0 included); whenever 32 are listed the warp bins them, one a
//     lane, so the atan2 work runs on full warps: each lane reads its row
//     again, takes d = sqrtf of the same chain, drops d = 0 and bins
//     spfh.cuh's Darboux angles with d_safe = d into the warp's histogram of
//     ints (spfh::warp_count);
//   - the row written is __fdiv_rn(hist, max(count, 1)), what the chunked
//     route's `spfh_histogram(...) / count` gives; counts are whole numbers
//     under 2^24, so the row equals that route's bit for bit (both built
//     -fmad=false).
// A query off the grid (the far sentinel of padded queries) has no run and
// gets a zero row.
//
// Design for the H100: one warp a query, eight a block, no block barrier;
// queries in the caller's order, which the FPFH pass gives grid-sorted, so
// the warps of a block and of neighbouring blocks walk the same runs and
// read the same table rows (24 B a point: a 10^6-point table is 24 MB and
// stays in the 50 MB L2; the rows a block walks are served from L1).  The
// walk reads each slot's point from a copy of the table's xyz padded to 16
// B a row (the wrapper makes it), one 16-byte load a slot.
// Bound on the H100: operations.  The compulsory traffic is the table once
// and the output; the work is ~20 instructions a walked slot and, for each
// binned neighbour, about two hundred (the square root, four IEEE
// divisions, the accurate atan2f, three bin indices, the warp's match and
// atomic), where the bound counts ~75 flops.  Measured alone on an H100 at
// 10^6 points, radius 3.0 (~36k slots, ~17k neighbours a query): 158.5 ms
// joint, of which the walk without the binning takes 38 ms; the binning
// issues ~200 instructions a neighbour at about the SMs' issue rate, so it
// is the floor while spfh.cuh's arithmetic stands.  Tried and dropped
// (PERF.md): three 4-byte loads a slot from the 24-byte rows (166.5 ms),
// a float2 and a float load (165.6), sqrtf in the walk (180.5), eight rows
// a lane in flight (165.5), four warps a block (168.2).
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
  const float4* xyz;  // the table's points, 16 B a row
  const float* table;
  int stride;
  float qx, qy, qz, ux, uy, uz;
  float bound;  // runs::sq_bound(radius)
  spfh::Bins bins;
  bool dec;
  int* hist;  // the warp's d_out counts in shared memory
  int* ring;  // the warp's kRing listed rows in shared memory
  int head;   // rows listed and binned (the ring's read position)
  int n;      // rows listed, not binned yet

  __device__ Query(const float4* xyz_, const float* table_, int stride_, const float* q,
                   const float* u, float bound_, int n_bins, bool dec_, int* hist_, int* ring_)
      : xyz(xyz_),
        table(table_), stride(stride_), qx(q[0]), qy(q[1]), qz(q[2]), ux(u[0]), uy(u[1]),
        uz(u[2]), bound(bound_), bins(n_bins), dec(dec_), hist(hist_), ring(ring_), head(0),
        n(0) {}

  // K8's squared distance, before its square root
  __device__ __forceinline__ float rho2(const float* p, float& dx, float& dy, float& dz) const {
    dx = __ldg(p) - qx;
    dy = __ldg(p + 1) - qy;
    dz = __ldg(p + 2) - qz;
    return fmaf(dz, dz, fmaf(dy, dy, dx * dx));
  }

  // bins table row `row` of every lane (row < 0, or d = 0: none)
  __device__ __forceinline__ void bin(int row) const {
    int idx[3] = {-1, -1, -1};
    if (row >= 0) {
      const float* p = table + (long long)row * stride;
      float dx, dy, dz;
      const float d = sqrtf(rho2(p, dx, dy, dz));
      if (d > 0.f && d < INFINITY) {  // K4's test
        float alpha, phi, theta;
        spfh::darboux_angles(dx, dy, dz, __ldg(p + 3), __ldg(p + 4), __ldg(p + 5), ux, uy, uz, d,
                             &alpha, &phi, &theta);
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
        d2[u] = INFINITY;
        if (i < hi) {
          const float4 p = __ldg(xyz + i);
          const float dx = p.x - qx, dy = p.y - qy, dz = p.z - qz;
          d2[u] = fmaf(dz, dz, fmaf(dy, dy, dx * dx));  // rho2's chain
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + 32 * u + lane;
        const bool in = i < hi && d2[u] <= bound;  // a NaN distance never is
        const unsigned ballot = __ballot_sync(kFull, in);
        if (in) ring[(head + n + __popc(ballot & below)) & (kRing - 1)] = i;
        n += __popc(ballot);
      }
      drain(false);
    }
  }
};

__global__ void __launch_bounds__(32 * kWarps)
spfh_grid_kernel(const float* __restrict__ table, int stride, const float4* __restrict__ xyz,
                 const long long* __restrict__ cell_starts, const float* __restrict__ origin,
                 float cell_size, long long d0, long long d1, long long d2, int halo, int w,
                 const float* __restrict__ queries, const float* __restrict__ qnormals,
                 int qstride, int q, float radius, int n_bins, int decorrelated,
                 float* __restrict__ out) {
  extern __shared__ int smem[];  // kWarps x d_out counts, then kWarps x kRing rows
  const int d_out = spfh::out_dim(n_bins, decorrelated);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kWarps + warp;
  if (qi >= q) return;  // whole warps leave; no block barrier follows
  Query qr(xyz, table, stride, queries + (long long)qi * qstride,
           qnormals + (long long)qi * qstride, runs::sq_bound(radius), n_bins,
           decorrelated != 0, smem + warp * d_out, smem + kWarps * d_out + warp * kRing);
  for (int k = lane; k < d_out; k += 32) qr.hist[k] = 0;
  long long c[3];
  runs::query_cell(origin, cell_size, qr.qx, qr.qy, qr.qz, c);
  __syncwarp();  // the histogram is zeroed

  // the runs in window order, one a lane (32 at a time), cut at w slots
  const int n_runs = (2 * halo + 1) * (2 * halo + 1);
  int filled = 0;  // slots walked, at most w (the same in every lane)
  for (int r0 = 0; r0 < n_runs && filled < w; r0 += 32) {
    long long s = 0, e = 0;
    if (r0 + lane < n_runs)
      runs::zcolumn_run(cell_starts, d0, d1, d2, halo, c, r0 + lane, s, e);
    const int in_step = min(32, n_runs - r0);
    for (int k = 0; k < in_step && filled < w; ++k) {
      const int rs = (int)__shfl_sync(kFull, s, k);  // rows < 2^30 (the wrapper checks)
      const int len = min((int)(__shfl_sync(kFull, e, k) - rs), w - filled);
      qr.walk(rs, rs + len);
      filled += len;
    }
  }
  const int count = qr.head + qr.n;  // every slot listed: the query's own row too
  qr.drain(true);
  __syncwarp();
  const float denom = (float)(count > 1 ? count : 1);
  float* o = out + (long long)qi * d_out;
  for (int k = lane; k < d_out; k += 32) o[k] = __fdiv_rn((float)qr.hist[k], denom);
}

}  // namespace

// The grid as ops/grid_hash.py::HashGrid holds it (cell-sorted table of
// stride >= 6 floats, cell-start table, origin, cell size, dims, halo,
// window cap w), xyz: the table's points as (N, 4) floats (16-byte
// aligned), and q queries with their normals, query i at queries + i *
// qstride (the table's own rows, or a (q, 3) array).
SHOT_EXPORT int spfh_grid(const float* table, int stride, const float* xyz,
                          const long long* cell_starts,
                          const float* origin, float cell_size, long long d0, long long d1,
                          long long d2, int halo, int w, const float* queries,
                          const float* qnormals, int qstride, int q, float radius, int n_bins,
                          int decorrelated, float* out, cudaStream_t stream) {
  if (q <= 0) return 0;
  if (stride < 6 || halo < 0 || w < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (q + kWarps - 1) / kWarps;
  const size_t smem = sizeof(int) * kWarps * (spfh::out_dim(n_bins, decorrelated) + kRing);
  if (smem > 48 * 1024) {  // joint histograms of more than 10^3 bins
    const cudaError_t err = cudaFuncSetAttribute(
        spfh_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  spfh_grid_kernel<<<blocks, 32 * kWarps, smem, stream>>>(
      table, stride, reinterpret_cast<const float4*>(xyz), cell_starts, origin, cell_size, d0,
      d1, d2, halo, w, queries, qnormals,
      qstride, q, radius, n_bins, decorrelated, out);
  return last_launch_error();
}
