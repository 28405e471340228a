// SG: SHOT frames + soft binning + 352-bin histogram straight from the
// grid's z-column runs, in one launch a cloud.
//
// Replaces, on SHOT's grid window route, the pair of TPU kernels
// shot_fpfh_tpu/ops/pallas_radius.py::fetch_windows_pallas (the window
// fetch) and shot_fpfh_tpu/ops/pallas_shot_fused.py::shot_binning_histogram
// (frames, bins and histogram over that window), which the port runs as K8
// (radius_runs.cu) writing each keypoint's window to device memory,
// PyTorch's radius planes over it, and K1 (shot_fused.cu) reading it back,
// in keypoint chunks.  Here no window exists: for each keypoint, inside the
// kernel,
//   - its cell and (2h+1)² z-column runs come from the cell-start table
//     (runs.cuh), one run a lane; the runs are concatenated in window order
//     and cut at the window cap w, as K8 concatenates them, so position s
//     of the concatenation is window slot s, and lane s % 32 takes it at the
//     same kUnroll step as K1's Window source does;
//   - a slot is in the descriptor plane when fmaf(dz, dz, fmaf(dy, dy,
//     dx * dx)) <= sq_bound(radius) (runs.cuh), which is the route's
//     sqrtf(ρ²) <= radius exactly; in bi-scale mode it is in the frame plane
//     when the same chain is <= sq_bound(rf_radius); d = sqrtf of the chain
//     is K8's distance, and d = 0 is not binned, as in K1.
// So each lane sums the covariance over the same slots in the same order as
// K1, pass 3 lists the same neighbours in the same order and bins them in
// the same groups of 32, and the rows and frames equal the K8 + K1 route's
// bit for bit (all sources built -fmad=false).  The kernel also counts the
// descriptor plane's rows with d > 0, which the caller's min-neighborhood
// rule reads.  Three modes, as K1: own frames, given frames (passes 1–2
// skipped), bi-scale.  A keypoint off the grid (the far sentinel of padded
// keypoints) has no run: a zero row, count 0 and the identity frame.
//
// Design for the H100: one warp a keypoint, eight a block, no block
// barrier, through K1's warp body (shot.cuh::keypoint_histogram) with the
// keypoint's runs as its neighbour source (GridRuns).
//   - A walk steps through one run at a time, 32 · kUnroll window positions
//     a step, each lane on its positions (one 16-byte load a slot from a
//     copy of the table's xyz padded to 16 B a row, which the wrapper makes;
//     the normals are read only for binned rows).
//   - Pass 1 walks the runs once: it sums the covariance over the frame
//     plane and, by ballot, lists the frame plane's rows in window order in
//     a per-warp list of kFrameSlots rows in shared memory.  Pass 2 (the
//     sign votes) reads the list.  With own frames the frame plane is the
//     descriptor plane, so pass 3 bins from the list too and the runs are
//     walked once; in bi-scale mode (and with given frames) pass 3 walks
//     them.  A frame plane larger than the list walks the runs again in
//     passes 2 and 3, with the same result.
//   - Pass 3 bins 32 listed neighbours at a time on full warps, one atomic a
//     distinct bin, as K1 does.
// Bound on the H100: operations.  The table is ~40 B a point (the 16-byte
// copy and the normals) and comes from L2 for every keypoint whose runs
// cover it; each walk tests every slot of the window (~10 flops), pass 3
// bins the neighbours in radius (~150 operations, an atan2f and an acosf
// each), while the bytes that must cross device memory are the table once
// and the output rows.
#include "common.cuh"
#include "runs.cuh"
#include "shot.cuh"

namespace {

constexpr int kWarps = 8;          // keypoints a block, one warp each
using shot::kFull;
using shot::kUnroll;               // window positions a lane loads at once
constexpr int kFrameSlots = 1024;  // frame-plane rows a warp lists

// A walk over a keypoint's runs in window order: the runs held one a lane
// (runs r0 .. r0 + 31), the run being walked (its first window position p0,
// its first row rs and its length len, cut at the cap), and the next step's
// first position pb.  Every member is the same in every lane but s and e.
struct Walk {
  int r0, run;
  long long s, e;  // this lane's run r0 + lane: rows [s, e)
  int p0, rs, len, pb;
};

// One keypoint's z-column runs as a neighbour source of
// shot::keypoint_histogram; an item is a table row.
struct GridRuns {
  const float4* xyz;  // the table's points, 16 B a row
  const float* table;
  int stride;
  const long long* cell_starts;
  long long d0, d1, d2;
  int halo, n_runs, w;
  long long c[3];        // the keypoint's cell
  float kx, ky, kz;
  float bound;           // descriptor plane: sq_bound(radius)
  float bound_frame;     // frame plane: sq_bound(rf_radius), or bound
  int* frame_list;       // kFrameSlots rows of shared memory: ~row where d = 0
  int n_frame;           // frame-plane rows pass 1 saw (listed while <= kFrameSlots)
  bool listed;           // pass 1 ran and the list holds the whole frame plane

  __device__ __forceinline__ void load_runs(Walk& wk) const {
    const int lane = threadIdx.x & 31;
    wk.s = wk.e = 0;
    if (wk.r0 + lane < n_runs)
      runs::zcolumn_run(cell_starts, d0, d1, d2, halo, c, wk.r0 + lane, wk.s, wk.e);
  }

  __device__ __forceinline__ Walk begin() const {
    Walk wk;
    wk.r0 = 0;
    wk.run = -1;
    wk.p0 = wk.rs = wk.len = wk.pb = 0;
    load_runs(wk);
    return wk;
  }

  // The next step of a walk: position pb + 32u + lane for u < kUnroll, its
  // row and offsets, and rho2 = the fma chain, +inf where the position is
  // not in the run.  False when the window is done; the same in every lane.
  __device__ __forceinline__ bool step(Walk& wk, int (&row)[kUnroll], float (&dx)[kUnroll],
                                       float (&dy)[kUnroll], float (&dz)[kUnroll],
                                       float (&rho2)[kUnroll]) const {
    while (wk.pb >= wk.p0 + wk.len) {
      wk.p0 += wk.len;
      if (wk.p0 >= w || ++wk.run >= n_runs) return false;
      if (wk.run >= wk.r0 + 32) {
        wk.r0 += 32;
        load_runs(wk);
      }
      const long long s = __shfl_sync(kFull, wk.s, wk.run - wk.r0);
      const long long e = __shfl_sync(kFull, wk.e, wk.run - wk.r0);
      wk.rs = (int)s;  // rows < 2^30 (the wrapper checks)
      wk.len = (int)min(e - s, (long long)(w - wk.p0));
      wk.pb = wk.p0 & ~31;
    }
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = wk.pb + 32 * u + lane;
      row[u] = wk.rs + (p - wk.p0);
      dx[u] = dy[u] = dz[u] = 0.f;
      rho2[u] = INFINITY;
      if (p >= wk.p0 && p < wk.p0 + wk.len) {
        const float4 pt = __ldg(xyz + row[u]);
        dx[u] = pt.x - kx;
        dy[u] = pt.y - ky;
        dz[u] = pt.z - kz;
        rho2[u] = fmaf(dz[u], dz[u], fmaf(dy[u], dy[u], dx[u] * dx[u]));
      }
    }
    wk.pb += 32 * kUnroll;
    return true;
  }

  // in a plane of squared bound b: the slot is in the window, d <= r and d
  // is finite (a NaN distance never is), as K1 reads the route's +inf planes
  __device__ __forceinline__ static bool in_plane(float rho2, float b) {
    return rho2 <= b && rho2 < INFINITY;
  }

  __device__ __forceinline__ void offsets(int i, float& dx, float& dy, float& dz) const {
    const float4 pt = __ldg(xyz + i);
    dx = pt.x - kx;
    dy = pt.y - ky;
    dz = pt.z - kz;
  }

  // pass 1: the covariance over the frame plane, its rows listed
  __device__ __forceinline__ void covariance(float (&s)[8], float r_frame) {
    const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
    int n = 0;
    Walk wk = begin();
    int row[kUnroll];
    float dx[kUnroll], dy[kUnroll], dz[kUnroll], rho2[kUnroll];
    while (step(wk, row, dx, dy, dz, rho2)) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool in = in_plane(rho2[u], bound_frame);
        if (in) shot::add_covariance(s, dx[u], dy[u], dz[u], sqrtf(rho2[u]), r_frame);
        const unsigned ballot = __ballot_sync(kFull, in);
        const int slot = n + __popc(ballot & below);
        if (in && slot < kFrameSlots) frame_list[slot] = rho2[u] > 0.f ? row[u] : ~row[u];
        n += __popc(ballot);
      }
    }
    n_frame = n;
    listed = n <= kFrameSlots;
    __syncwarp();  // the list is complete
  }

  // pass 2: the sign votes over the frame plane (whole-number counts, so
  // their order is free)
  __device__ __forceinline__ void votes(const float (&x)[3], const float (&z)[3],
                                        float (&v)[4]) const {
    if (listed) {
      for (int k = threadIdx.x & 31; k < n_frame; k += 32) {
        const int i = frame_list[k];
        float dx, dy, dz;
        offsets(i >= 0 ? i : ~i, dx, dy, dz);
        shot::add_votes(v, dx, dy, dz, x[0], x[1], x[2], z[0], z[1], z[2]);
      }
      return;
    }
    Walk wk = begin();
    int row[kUnroll];
    float dx[kUnroll], dy[kUnroll], dz[kUnroll], rho2[kUnroll];
    while (step(wk, row, dx, dy, dz, rho2)) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (in_plane(rho2[u], bound_frame))
          shot::add_votes(v, dx[u], dy[u], dz[u], x[0], x[1], x[2], z[0], z[1], z[2]);
    }
  }

  // pass 3 bins from the frame list: own frames, the list complete
  __device__ __forceinline__ bool from_list() const { return listed && bound_frame == bound; }

  // pass 3's candidates in window order: the frame list's rows with d > 0,
  // or the walk's slots with 0 < d <= r
  struct Cursor {
    Walk wk;
    int k;               // the next step's first list slot
    int row[kUnroll];    // the step's rows
  };
  __device__ __forceinline__ Cursor start() const {
    Cursor c;
    c.wk = begin();
    c.k = 0;
    return c;
  }

  __device__ __forceinline__ bool next(Cursor& c, bool (&take)[kUnroll]) const {
    const int lane = threadIdx.x & 31;
    if (from_list()) {
      if (c.k >= n_frame) return false;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = c.k + 32 * u + lane;
        const int i = k < n_frame ? frame_list[k] : -1;
        take[u] = i >= 0;
        c.row[u] = i;
      }
      c.k += 32 * kUnroll;
      return true;
    }
    float dx[kUnroll], dy[kUnroll], dz[kUnroll], rho2[kUnroll];
    if (!step(c.wk, c.row, dx, dy, dz, rho2)) return false;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) take[u] = in_plane(rho2[u], bound) && rho2[u] > 0.f;
    return true;
  }

  __device__ __forceinline__ int item(const Cursor& c, int u) const { return c.row[u]; }

  __device__ __forceinline__ void bin(const shot::Frame& f, float r, int i, int (&idx)[5],
                                      float (&wt)[5], unsigned& bad) const {
    float dx, dy, dz;
    offsets(i, dx, dy, dz);
    const float rho = sqrtf(fmaf(dz, dz, fmaf(dy, dy, dx * dx)));  // K8's distance
    const float* p = table + (long long)i * stride;
    shot::bin_weights(f, dx, dy, dz, __ldg(p + 3), __ldg(p + 4), __ldg(p + 5), rho, r, idx, wt,
                      bad);
  }
};

__global__ void __launch_bounds__(32 * kWarps)
shot_grid_kernel(const float* __restrict__ table, int stride, const float4* __restrict__ xyz,
                 const long long* __restrict__ cell_starts, const float* __restrict__ origin,
                 float cell_size, long long d0, long long d1, long long d2, int halo, int w,
                 const float* __restrict__ kp, int q, const float* __restrict__ rfs_in,
                 float radius, float rf_radius, float* __restrict__ hist,
                 float* __restrict__ rfs_out, int* __restrict__ count, int* __restrict__ viol) {
  __shared__ __align__(16) float hist_s[kWarps][shot::kDim];
  __shared__ int list_s[kWarps][64];  // pass 3's compacted rows: one step + carry
  __shared__ int frame_s[kWarps][kFrameSlots];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kWarps + warp;
  if (qi >= q) return;  // whole warps leave; no block barrier follows
  float* h = hist_s[warp];
  for (int k = lane; k < shot::kDim / 4; k += 32)
    reinterpret_cast<float4*>(h)[k] = make_float4(0.f, 0.f, 0.f, 0.f);

  GridRuns src;
  src.xyz = xyz;
  src.table = table;
  src.stride = stride;
  src.cell_starts = cell_starts;
  src.d0 = d0;
  src.d1 = d1;
  src.d2 = d2;
  src.halo = halo;
  src.n_runs = (2 * halo + 1) * (2 * halo + 1);
  src.w = w;
  src.kx = kp[3 * qi];
  src.ky = kp[3 * qi + 1];
  src.kz = kp[3 * qi + 2];
  runs::query_cell(origin, cell_size, src.kx, src.ky, src.kz, src.c);
  src.bound = runs::sq_bound(radius);
  src.bound_frame = rf_radius == radius ? src.bound : runs::sq_bound(rf_radius);
  src.frame_list = frame_s[warp];
  src.n_frame = 0;
  src.listed = false;

  const int n = shot::keypoint_histogram(src, radius, rf_radius,
                                         rfs_in == nullptr ? nullptr : rfs_in + 9 * qi,
                                         rfs_out == nullptr ? nullptr : rfs_out + 9 * qi, h,
                                         list_s[warp], viol);
  if (lane == 0) count[qi] = n;  // the binned rows: the descriptor plane's with d > 0
  float4* out = reinterpret_cast<float4*>(hist + (long long)qi * shot::kDim);
  for (int k = lane; k < shot::kDim / 4; k += 32) out[k] = reinterpret_cast<const float4*>(h)[k];
}

}  // namespace

// The grid as ops/grid_hash.py::HashGrid holds it (cell-sorted table of
// stride >= 6 floats, cell-start table, origin, cell size, dims, halo,
// window cap w), xyz: the table's points as (N, 4) floats (16-byte
// aligned), q keypoints (q, 3); rfs_in: given frames (q, 9) or null;
// rf_radius: the frame plane's radius, the descriptor radius unless in
// bi-scale mode; viol: the debug checks' two counters (shot.cuh), or null.
SHOT_EXPORT int shot_grid(const float* table, int stride, const float* xyz,
                          const long long* cell_starts, const float* origin, float cell_size,
                          long long d0, long long d1, long long d2, int halo, int w,
                          const float* kp, int q, const float* rfs_in, float radius,
                          float rf_radius, float* hist, float* rfs_out, int* count, int* viol,
                          cudaStream_t stream) {
  if (q <= 0) return 0;
  if (stride < 6 || halo < 0 || w < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (q + kWarps - 1) / kWarps;
  shot_grid_kernel<<<blocks, 32 * kWarps, 0, stream>>>(
      table, stride, reinterpret_cast<const float4*>(xyz), cell_starts, origin, cell_size, d0,
      d1, d2, halo, w, kp, q, rfs_in, radius, rf_radius, hist, rfs_out, count, viol);
  return last_launch_error();
}
