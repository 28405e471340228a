// K3: streaming radius covariance behind normals.
//
// Replaces the TPU kernel shot_fpfh_tpu/ops/pallas_radius.py::radius_pca_pallas
// (_pca_kernel via _pca_call), which DMAs each query's 9 z-column runs of the
// cell-sorted cloud into VMEM and reduces them there.
//
// Two entry points.  radius_pca_keys writes each query's linear cell id; the
// wrapper sorts them (ops/radius_pca.py::cell_order), so a tile of kTile
// consecutive sorted queries shares its runs.  radius_pca then serves one tile
// a block, one query a thread: each thread finds its cell and its z-column
// runs in the grid itself (the cell-start table, or a binary search over the
// sorted cell ids), the block reduces them to the tile's union for each
// (dx, dy) offset (smallest start to largest end: a warp min/max, then one
// shared-memory atomic a warp), stages those unions' xyz into shared memory
// with cp.async, and each thread walks only its own runs inside the staged
// rows, keeps the points with fma(dz,dz,fma(dy,dy,dx·dx)) <= r² and sums the
// count, Σd and the six second moments of d = p − q in registers: no warp
// reductions, every lane busy.  A union larger than the staging buffer is
// staged in chunks; a tile whose union exceeds kDirectRows (queries far
// apart) reads its runs from device memory instead.  Each thread adds its
// rows in the same order on every route, so a query's sums do not depend on
// its tile.  ops/radius_pca.py::tile_plan is the plain twin of the order, the
// runs and the unions; the kernel writes its unions out when asked, so the
// two can be held to each other.  The host finalizes covariance and
// barycenter from the 10 sums (ops/grid_hash.py::moments_to_pca).
//
// Bound on the H100: bytes.  The cloud's rows are read about once per tile
// that needs them (most reads hit L2) and each kept point costs ~20 flops, far
// below the card's flop/byte balance; the previous design (a warp per query,
// lanes idle on short runs, a dependent chain per run) was bound by latency
// and lane use instead.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kTile = 128;       // queries (threads) per block
constexpr int kCap = 2048;       // staged rows per chunk (32 KB)
constexpr int kMaxRuns = 49;     // runs per query (halo <= 3)
constexpr long long kDirectRows = 16 * kCap;

// ops/grid_hash.py::HashGrid as the kernels read it
struct Grid {
  const float* table;            // (n_rows, stride) cell-sorted [points | extras]
  const long long* cell_starts;  // (d0·d1·d2 + 1,) first row per cell id, or null
  const long long* ids;          // (n_rows,) ascending cell ids (used without a table)
  const float* origin;           // (3,)
  long long n_rows, d0, d1, d2;
  float cell_size;
  int stride, halo;
};

// grid_hash._query_cells: floor((q − origin) / cell_size), one IEEE division
__device__ __forceinline__ void query_cell(const Grid& g, float qx, float qy, float qz,
                                           long long c[3]) {
  c[0] = static_cast<long long>(floorf(__fdiv_rn(qx - g.origin[0], g.cell_size)));
  c[1] = static_cast<long long>(floorf(__fdiv_rn(qy - g.origin[1], g.cell_size)));
  c[2] = static_cast<long long>(floorf(__fdiv_rn(qz - g.origin[2], g.cell_size)));
}

// torch.searchsorted over the ascending ids: the first position whose id is
// >= v (right: > v)
template <bool kRight>
__device__ __forceinline__ long long search(const long long* ids, long long n, long long v) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (kRight ? ids[mid] <= v : ids[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// grid_hash._zcolumn_runs for offset k of the cell c: the sorted rows
// [start, end) of the cells (x+dx, y+dy, max(z−h, 0) .. min(z+h, d2−1));
// (0, 0) off the grid
__device__ __forceinline__ int2 zrun(const Grid& g, const long long c[3], int k) {
  const int h = g.halo, w = 2 * h + 1;
  const long long x = c[0] + k / w - h, y = c[1] + k % w - h;
  const long long z_lo = (c[2] > h ? c[2] : h) - h;
  const long long z_hi = c[2] + h < g.d2 - 1 ? c[2] + h : g.d2 - 1;
  if (x < 0 || x >= g.d0 || y < 0 || y >= g.d1 || c[2] < -h || c[2] > g.d2 + h - 1 ||
      z_hi < z_lo)
    return make_int2(0, 0);
  const long long base = (x * g.d1 + y) * g.d2;
  long long s, e;
  if (g.cell_starts != nullptr) {
    s = g.cell_starts[base + z_lo];
    e = g.cell_starts[base + z_hi + 1];
  } else {
    s = search<false>(g.ids, g.n_rows, base + z_lo);
    e = search<true>(g.ids, g.n_rows, base + z_hi);
  }
  return make_int2(static_cast<int>(s), static_cast<int>(e > s ? e : s));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

struct Moments {
  float acc[10];
  float qx, qy, qz, rr;

  __device__ __forceinline__ void add(float px, float py, float pz) {
    const float dx = px - qx, dy = py - qy, dz = pz - qz;
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
};

__global__ void cell_keys_kernel(Grid g, const float* __restrict__ queries, int q,
                                 long long* __restrict__ keys) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  long long c[3];
  query_cell(g, queries[3 * i], queries[3 * i + 1], queries[3 * i + 2], c);
  // (x·d1 + y)·d2 + z, wrapping as torch's int64 arithmetic does
  using u64 = unsigned long long;
  keys[i] = static_cast<long long>(
      (static_cast<u64>(c[0]) * static_cast<u64>(g.d1) + static_cast<u64>(c[1])) *
          static_cast<u64>(g.d2) +
      static_cast<u64>(c[2]));
}

__global__ void __launch_bounds__(kTile)
radius_pca_kernel(Grid g, const float* __restrict__ queries, const float* __restrict__ r2,
                  const long long* __restrict__ order, int q, float* __restrict__ out,
                  long long* __restrict__ lo_out, long long* __restrict__ hi_out) {
  __shared__ float4 rows[kCap];
  __shared__ int run_lo[kMaxRuns], run_hi[kMaxRuns];
  __shared__ long long run_pos[kMaxRuns + 1];
  const int n_runs = (2 * g.halo + 1) * (2 * g.halo + 1);
  const int si = blockIdx.x * kTile + threadIdx.x;
  const bool active = si < q;
  if (threadIdx.x < n_runs) {
    run_lo[threadIdx.x] = INT_MAX;
    run_hi[threadIdx.x] = 0;
  }

  Moments m;
#pragma unroll
  for (int k = 0; k < 10; ++k) m.acc[k] = 0.f;
  m.qx = m.qy = m.qz = m.rr = 0.f;
  long long qi = 0, c[3] = {0, 0, 0};
  if (active) {
    qi = order[si];
    m.qx = queries[3 * qi];
    m.qy = queries[3 * qi + 1];
    m.qz = queries[3 * qi + 2];
    m.rr = r2[qi];
    query_cell(g, m.qx, m.qy, m.qz, c);
  }
  __syncthreads();

  // the tile's union for each offset: min start and max end of the
  // non-empty runs, a warp at a time
  for (int k = 0; k < n_runs; ++k) {
    const int2 r = active ? zrun(g, c, k) : make_int2(0, 0);
    const bool nonempty = r.y > r.x;
    const int lo = __reduce_min_sync(0xffffffffu, nonempty ? r.x : INT_MAX);
    const int hi = __reduce_max_sync(0xffffffffu, nonempty ? r.y : 0);
    if ((threadIdx.x & 31) == 0 && hi > 0) {
      atomicMin(&run_lo[k], lo);
      atomicMax(&run_hi[k], hi);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // the unions side by side: union k holds staged positions
    // [run_pos[k], run_pos[k + 1]); an offset no query has is (0, 0)
    run_pos[0] = 0;
    for (int k = 0; k < n_runs; ++k) {
      if (run_hi[k] <= run_lo[k]) run_lo[k] = run_hi[k] = 0;
      run_pos[k + 1] = run_pos[k] + run_hi[k] - run_lo[k];
    }
  }
  __syncthreads();
  if (lo_out != nullptr && threadIdx.x < n_runs) {
    const long long at = static_cast<long long>(blockIdx.x) * n_runs + threadIdx.x;
    lo_out[at] = run_lo[threadIdx.x];
    hi_out[at] = run_hi[threadIdx.x];
  }
  const long long total = run_pos[n_runs];

  if (total > kDirectRows) {
    if (active) {
      for (int k = 0; k < n_runs; ++k) {
        const int2 r = zrun(g, c, k);
        for (long long i = r.x; i < r.y; ++i) {
          const float* p = g.table + i * g.stride;
          m.add(p[0], p[1], p[2]);
        }
      }
    }
  } else {
    for (long long u0 = 0; u0 < total; u0 += kCap) {
      const long long u1 = u0 + kCap < total ? u0 + kCap : total;
      __syncthreads();  // every thread is done with the previous chunk
      for (int k = 0; k < n_runs; ++k) {
        const long long a = run_pos[k] > u0 ? run_pos[k] : u0;
        const long long b = run_pos[k + 1] < u1 ? run_pos[k + 1] : u1;
        for (long long p = a + threadIdx.x; p < b; p += kTile) {
          const float* src = g.table + (run_lo[k] + (p - run_pos[k])) * g.stride;
          float* dst = reinterpret_cast<float*>(&rows[p - u0]);
          cp_async4(dst, src);
          cp_async4(dst + 1, src + 1);
          cp_async4(dst + 2, src + 2);
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      if (active) {
        for (int k = 0; k < n_runs; ++k) {
          // the query's own run, as staged positions, inside this chunk
          const int2 r = zrun(g, c, k);
          if (r.y <= r.x) continue;
          const long long base = run_pos[k] - run_lo[k];
          const int a = static_cast<int>((base + r.x > u0 ? base + r.x : u0) - u0);
          const int b = static_cast<int>((base + r.y < u1 ? base + r.y : u1) - u0);
          for (int p = a; p < b; ++p) {
            const float4 v = rows[p];
            m.add(v.x, v.y, v.z);
          }
        }
      }
    }
  }
  if (active) {
    float* o = out + 10 * qi;
#pragma unroll
    for (int k = 0; k < 10; ++k) o[k] = m.acc[k];
  }
}

Grid make_grid(const float* table, int stride, long long n_rows, const long long* cell_starts,
               const long long* ids, const float* origin, float cell_size, long long d0,
               long long d1, long long d2, int halo) {
  return Grid{table, cell_starts, ids, origin, n_rows, d0, d1, d2, cell_size, stride, halo};
}

}  // namespace

// keys (Q,) int64: each query's linear cell id in the grid
SHOT_EXPORT int radius_pca_keys(const float* table, int stride, long long n_rows,
                                const long long* cell_starts, const long long* ids,
                                const float* origin, float cell_size, long long d0, long long d1,
                                long long d2, int halo, const float* queries, int q,
                                long long* keys, cudaStream_t stream) {
  if (q <= 0) return 0;
  const Grid g = make_grid(table, stride, n_rows, cell_starts, ids, origin, cell_size, d0, d1,
                           d2, halo);
  cell_keys_kernel<<<(q + 255) / 256, 256, 0, stream>>>(g, queries, q, keys);
  return last_launch_error();
}

// queries (Q, 3), r2 (Q,) in the caller's order; order (Q,) sorted position ->
// query; out (Q, 10) in the caller's order.  lo_out / hi_out (ceil(Q / 128),
// (2·halo+1)²) int64 get the tiles' unions when not null.
SHOT_EXPORT int radius_pca(const float* table, int stride, long long n_rows,
                           const long long* cell_starts, const long long* ids,
                           const float* origin, float cell_size, long long d0, long long d1,
                           long long d2, int halo, const float* queries, const float* r2,
                           const long long* order, int q, float* out, long long* lo_out,
                           long long* hi_out, cudaStream_t stream) {
  if (q <= 0) return 0;
  if ((2 * halo + 1) * (2 * halo + 1) > kMaxRuns || n_rows > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Grid g = make_grid(table, stride, n_rows, cell_starts, ids, origin, cell_size, d0, d1,
                           d2, halo);
  const int blocks = (q + kTile - 1) / kTile;
  radius_pca_kernel<<<blocks, kTile, 0, stream>>>(g, queries, r2, order, q, out, lo_out,
                                                  hi_out);
  return last_launch_error();
}
