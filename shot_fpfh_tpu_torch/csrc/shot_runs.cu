// K5: SHOT frames + soft binning + 352-bin histogram read straight from the
// grid's xy-row runs.
//
// Replaces the TPU kernel shot_fpfh_tpu/ops/pallas_shot_dma.py::
// shot_descriptor_dma (_dma_kernel), which DMAs each query's 2h+1 xy-row
// runs of the (n_tiles, 8, 128) table into VMEM and runs K1's body on them.
//
// A row is in the descriptor plane when its squared distance, the
// reference's contracted fma(dz, dz, fma(dy, dy, dx*dx)), is <= r*r (K3's
// and K6's rule), with d = sqrt of it; in bi-scale mode the frame plane is
// the rows with that squared distance <= r_rf*r_rf.  The kernel also counts
// the descriptor plane's rows with d > 0, which the caller's
// min-neighborhood rule reads.  Three modes, as K1: own frames, given
// frames (passes 1–2 skipped), bi-scale.
//
// Design for the H100: one warp a keypoint, eight a block, no block
// barrier, through K1's warp body (shot.cuh::keypoint_histogram) with the
// keypoint's runs of the cell-sorted [x y z nx ny nz ...] table as its
// neighbor source, so no (Q, W) window is gathered.
//   - The warp finds its keypoint's runs from the grid's cell-start table
//     (runs.cuh, shared with K6: the arithmetic of shot_dma._xyrow_runs,
//     one run a lane), so the wrapper launches no index ops.
//   - A walk puts the lanes on consecutive rows of each run, kUnroll rows a
//     lane in flight.
//   - Pass 1 walks the runs of the frame plane's own halo (bi-scale: the
//     halo that covers the frame radius, smaller than the descriptor's)
//     once: it sums the covariance and, by ballot, lists the frame plane's
//     rows in a per-warp list of kFrameSlots rows in shared memory.
//     Pass 2 (the sign votes) reads the list.  With own frames the frame
//     plane is the descriptor plane, so pass 3 bins from
//     the list too and the runs are walked once; in bi-scale mode (and with
//     given frames) pass 3 walks them.  A frame plane larger than the list
//     walks the runs again in passes 2 and 3, with the same result.
//   - Pass 3 bins 32 listed neighbors at a time on full warps, one atomic a
//     distinct bin, as K1 does.
// Bound on the H100: operations.  The table is ~24 B a point and comes from
// L2 for every keypoint whose runs cover it; each walk tests every row of
// the runs (~10 flops), pass 3 bins the in-radius neighbors (~130 flops, an
// atan2f and an acosf each), while the bytes that must cross device memory
// are the table once and the output rows.
#include "common.cuh"
#include "runs.cuh"
#include "shot.cuh"

namespace {

constexpr int kWarps = 8;          // keypoints a block, one warp each
using shot::kFull;
using shot::kUnroll;               // rows a lane loads at once
constexpr int kFrameSlots = 1024;  // frame-plane rows a warp lists

// A walk over a keypoint's runs: the run it is in, and the next step's
// first row and the run's end
struct RunStep {
  int run;
  long long base, end;
};

// One keypoint's xy-row runs as a neighbor source of
// shot::keypoint_histogram; an item is a table row.
struct Runs {
  const float* table;
  int stride;
  int n_runs, n_frame_runs;
  long long run_s, run_e;      // lane k < n_runs: run k's rows [run_s, run_e)
  long long frame_s, frame_e;  // lane k < n_frame_runs: the frame plane's run k
  float kx, ky, kz;
  float rr;        // descriptor plane: squared radius
  float rr_frame;  // frame plane: squared radius (rf_radius² in bi-scale mode)
  int* frame_list;  // kFrameSlots rows of shared memory
  int n_frame;      // frame-plane rows pass 1 saw (listed while <= kFrameSlots)
  int n_zero;       // of them, rows at the keypoint (d = 0)
  bool listed;      // pass 1 ran and the list holds the whole frame plane

  __device__ __forceinline__ void offsets(long long i, float& dx, float& dy, float& dz) const {
    const float* p = table + i * stride;
    dx = p[0] - kx;
    dy = p[1] - ky;
    dz = p[2] - kz;
  }

  // The next step of a walk over the runs (kFrame: the frame plane's runs;
  // st starts at {-1, 0, 0}): the lanes on consecutive rows of a run,
  // kUnroll rows a lane; rho2 = +inf past the run's end.  False when the
  // runs are done; the same in every lane.
  template <bool kFrame>
  __device__ __forceinline__ bool rows(RunStep& st, int (&row)[kUnroll], float (&dx)[kUnroll],
                                       float (&dy)[kUnroll], float (&dz)[kUnroll],
                                       float (&rho2)[kUnroll]) const {
    while (st.base >= st.end) {
      if (++st.run >= (kFrame ? n_frame_runs : n_runs)) return false;
      st.base = __shfl_sync(kFull, kFrame ? frame_s : run_s, st.run);
      st.end = __shfl_sync(kFull, kFrame ? frame_e : run_e, st.run);
    }
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = st.base + 32 * u + lane;
      if (i < st.end)
        offsets(i, dx[u], dy[u], dz[u]);
      else
        dx[u] = dy[u] = dz[u] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = st.base + 32 * u + lane;
      row[u] = (int)i;
      rho2[u] = i < st.end ? fmaf(dz[u], dz[u], fmaf(dy[u], dy[u], dx[u] * dx[u])) : INFINITY;
    }
    st.base += 32 * kUnroll;
    return true;
  }

  __device__ __forceinline__ void covariance(float (&s)[8], float r_frame) {
    const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
    int n = 0, zero = 0;
    RunStep st = {-1, 0, 0};
    int row[kUnroll];
    float dx[kUnroll], dy[kUnroll], dz[kUnroll], rho2[kUnroll];
    while (rows<true>(st, row, dx, dy, dz, rho2)) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool in = rho2[u] <= rr_frame;
        if (in) shot::add_covariance(s, dx[u], dy[u], dz[u], sqrtf(rho2[u]), r_frame);
        const unsigned ballot = __ballot_sync(kFull, in);
        const int slot = n + __popc(ballot & below);
        if (in && slot < kFrameSlots) frame_list[slot] = row[u];
        n += __popc(ballot);
        zero += __popc(__ballot_sync(kFull, in && !(rho2[u] > 0.f)));
      }
    }
    n_frame = n;
    n_zero = zero;
    listed = n <= kFrameSlots;
    __syncwarp();  // the list is complete
  }

  __device__ __forceinline__ void votes(const float (&x)[3], const float (&z)[3],
                                        float (&v)[4]) const {
    if (listed) {
      for (int k = threadIdx.x & 31; k < n_frame; k += 32) {
        float dx, dy, dz;
        offsets(frame_list[k], dx, dy, dz);
        shot::add_votes(v, dx, dy, dz, x[0], x[1], x[2], z[0], z[1], z[2]);
      }
      return;
    }
    RunStep st = {-1, 0, 0};
    int row[kUnroll];
    float dx[kUnroll], dy[kUnroll], dz[kUnroll], rho2[kUnroll];
    while (rows<true>(st, row, dx, dy, dz, rho2)) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (rho2[u] <= rr_frame)
          shot::add_votes(v, dx[u], dy[u], dz[u], x[0], x[1], x[2], z[0], z[1], z[2]);
    }
  }

  // pass 3 bins from the frame list: own frames, the list complete
  __device__ __forceinline__ bool from_list() const {
    return listed && rr_frame == rr && n_frame_runs == n_runs;
  }

  // pass 3's candidates: the frame list's rows (those with d = 0 are
  // dropped by bin), or the runs' rows with 0 < d <= r
  struct Cursor {
    RunStep st;
    int k;  // the next step's first list slot
  };
  __device__ __forceinline__ Cursor start() const { return Cursor{{-1, 0, 0}, 0}; }

  __device__ __forceinline__ bool next(Cursor& c, bool (&take)[kUnroll]) const {
    if (from_list()) {
      if (c.k >= n_frame) return false;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) take[u] = c.k + 32 * u + (int)(threadIdx.x & 31) < n_frame;
      c.k += 32 * kUnroll;
      return true;
    }
    int row[kUnroll];
    float dx[kUnroll], dy[kUnroll], dz[kUnroll], rho2[kUnroll];
    if (!rows<false>(c.st, row, dx, dy, dz, rho2)) return false;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) take[u] = rho2[u] <= rr && rho2[u] > 0.f;
    return true;
  }

  __device__ __forceinline__ int item(const Cursor& c, int u) const {
    const int lane = threadIdx.x & 31;
    if (from_list()) return frame_list[c.k - 32 * kUnroll + 32 * u + lane];
    return (int)(c.st.base - 32 * kUnroll + 32 * u + lane);
  }

  __device__ __forceinline__ void bin(const shot::Frame& f, float r, int row, int (&idx)[5],
                                      float (&wt)[5], unsigned& bad) const {
    float dx, dy, dz;
    offsets(row, dx, dy, dz);
    const float rho2 = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
    if (!(rho2 > 0.f)) return;
    const float* p = table + (long long)row * stride;
    shot::bin_weights(f, dx, dy, dz, p[3], p[4], p[5], sqrtf(rho2), r, idx, wt, bad);
  }
};

__global__ void __launch_bounds__(32 * kWarps)
shot_runs_kernel(const float* __restrict__ table, int stride,
                 const long long* __restrict__ cell_starts, const float* __restrict__ origin,
                 float cell_size, long long d0, long long d1, long long d2, int halo,
                 int frame_halo, const float* __restrict__ kp, int q,
                 const float* __restrict__ rfs_in,
                 float radius, float rf_radius, float* __restrict__ hist,
                 float* __restrict__ rfs_out, float* __restrict__ count,
                 int* __restrict__ viol) {
  __shared__ __align__(16) float hist_s[kWarps][shot::kDim];
  __shared__ int list_s[kWarps][64];  // pass 3's compacted rows: one step + carry
  __shared__ int frame_s[kWarps][kFrameSlots];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kWarps + warp;
  if (qi >= q) return;  // whole warps leave; no block barrier follows
  float* h = hist_s[warp];
  for (int k = lane; k < shot::kDim / 4; k += 32)
    reinterpret_cast<float4*>(h)[k] = make_float4(0.f, 0.f, 0.f, 0.f);

  Runs src;
  src.table = table;
  src.stride = stride;
  src.n_runs = 2 * halo + 1;
  src.kx = kp[3 * qi];
  src.ky = kp[3 * qi + 1];
  src.kz = kp[3 * qi + 2];
  long long c[3];
  runs::query_cell(origin, cell_size, src.kx, src.ky, src.kz, c);
  src.n_frame_runs = 2 * frame_halo + 1;
  src.run_s = src.run_e = src.frame_s = src.frame_e = 0;
  if (lane < src.n_runs)
    runs::xyrow_run(cell_starts, d0, d1, d2, halo, c, lane, src.run_s, src.run_e);
  if (lane < src.n_frame_runs)
    runs::xyrow_run(cell_starts, d0, d1, d2, frame_halo, c, lane, src.frame_s,
                    src.frame_e);
  src.rr = radius * radius;
  src.rr_frame = rf_radius * rf_radius;
  src.frame_list = frame_s[warp];
  src.n_frame = src.n_zero = 0;
  src.listed = false;

  const int n = shot::keypoint_histogram(src, radius, rf_radius,
                                         rfs_in == nullptr ? nullptr : rfs_in + 9 * qi,
                                         rfs_out == nullptr ? nullptr : rfs_out + 9 * qi, h,
                                         list_s[warp], viol);
  // the binned rows: the listed frame plane holds the d = 0 rows too
  if (lane == 0) count[qi] = (float)(src.from_list() ? n - src.n_zero : n);
  float4* out = reinterpret_cast<float4*>(hist + (long long)qi * shot::kDim);
  for (int k = lane; k < shot::kDim / 4; k += 32) out[k] = reinterpret_cast<const float4*>(h)[k];
}

}  // namespace

// The grid as ops/grid_hash.py::HashGrid holds it (cell-start table,
// origin, cell size, dims, halo <= 15); rf_radius is the frame plane's
// radius: the descriptor radius unless in bi-scale mode, and frame_halo
// (<= halo) the halo whose runs cover it; viol: the debug checks' two
// counters (shot.cuh), or null.
SHOT_EXPORT int shot_runs(const float* table, int stride, const long long* cell_starts,
                          const float* origin, float cell_size, long long d0, long long d1,
                          long long d2, int halo, int frame_halo, const float* kp, int q,
                          const float* rfs_in, float radius, float rf_radius, float* hist,
                          float* rfs_out, float* count, int* viol, cudaStream_t stream) {
  if (q <= 0) return 0;
  if (2 * halo + 1 > 32 || frame_halo < 0 || frame_halo > halo)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (q + kWarps - 1) / kWarps;
  shot_runs_kernel<<<blocks, 32 * kWarps, 0, stream>>>(
      table, stride, cell_starts, origin, cell_size, d0, d1, d2, halo, frame_halo, kp, q, rfs_in,
      radius, rf_radius, hist, rfs_out, count, viol);
  return last_launch_error();
}
