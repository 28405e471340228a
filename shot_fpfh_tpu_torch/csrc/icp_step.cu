// IS: one whole point-to-plane ICP iteration in one launch.
//
// Replaces no TPU kernel: JAX's _icp_loop body (shot_fpfh_tpu/registration/
// icp.py) is XLA around the grid 1-NN, and the port had run it as
// registration/icp.py::_step, ~170 small operations an iteration issued by
// the host (the move, K7's 1-NN mode, the weights and gathers, the normal
// equations' cross, cat and einsums, the Tikhonov term, a 6x6
// torch.linalg.solve_ex, the Euler rotation, the composition and its
// quaternion round trip, five wheres).  _step stays the plain twin that
// the tests hold this kernel to, and the route of every other case.
//
// The loop's state lives in device memory: fstate = rotation (row-major 9),
// translation (3), rms; istate = iterations run, done, and the launch's
// ticket.  A launch with done set does nothing, so the host enqueues
// ICP_BLOCK launches and reads done once a block, as it did with _step.
// Otherwise, in one launch:
//   1. each scan point, one group of kLanes lanes a point (group g of the
//      grid's G takes the points g, g + G, ... in turn; the wrapper fixes the
//      grid, so a point's place in the sums depends on its index alone), is
//      moved by the state's transform, ((r0·s0 + r1·s1) + r2·s2) + t, and
//      finds its nearest ref row by K7's 1-NN walk (nearest.cuh, shared with
//      nearest_kernel: the same distances and first-minimum tie rule bit for
//      bit);
//   2. its weight is w = (d <= d_max) · weights[i] (weights: optional, 0 on
//      padding rows), its neighbour r and normal n are read by the row's
//      original index, and with G = [s × n | n] and h = (r − s)·n the group
//      adds w·G_i·G_j (the 21 entries of GᵀG's upper triangle), w·G_i·h (6),
//      w·|h| and w to its 29 sums, one sum a lane (8 lanes: four a lane), in
//      float32 in the group's point order, every point summed as _step sums
//      it (a zero weight adds 0·finite; a NaN point adds NaN);
//   3. the block adds its groups' sums in group order and writes one
//      partial row; the last block to finish (a ticket counter behind
//      __threadfence) adds the partial rows in a fixed order, so two runs
//      give the same bits;
//   4. one thread of that block solves: GᵀG plus 1e-8·trace on the
//      diagonal, LU with partial pivoting (getrf's rule: the first largest
//      pivot, no elimination under a zero pivot, so a singular system gives
//      inf or NaN as LAPACK's does), the Euler angles to R = Rz Ry Rx,
//      the composition delta ∘ tf renormalised through the quaternion
//      (Shepperd, the largest pivot), rms = Σw|h| / max(Σw, 1) and done =
//      rms < rms_threshold, written back with the iteration count; it
//      resets the ticket for the next launch.
// Float32 throughout, built -fmad=false like every kernel here; the sums
// run in another order than _step's, so the two agree to float32 rounding.
//
// Bound on the H100: as K7's 1-NN mode, the rate the walk issues loads and
// distance tests at (the ref's table stays in L2); the sums, the gathers
// and the solve add little.  The host's work an iteration is one launch.
#include "nearest.cuh"

namespace {

constexpr int kWarps = 8;   // warps a block
constexpr int kSums = 29;   // GᵀG's upper triangle 21, Gᵀh 6, Σ w·|h|, Σ w
constexpr int kRow = 32;    // floats a partial row
constexpr int kChunks = kWarps;  // the last block's chunks of partial rows

// v[i] without a dynamic index into registers
__device__ __forceinline__ float pick(const float (&v)[6], int i) {
  float out = v[0];
#pragma unroll
  for (int m = 1; m < 6; ++m) out = i == m ? v[m] : out;
  return out;
}

// the solve and the state update, on one thread: tot holds the 29 sums
__device__ void finish(const float* tot, float rms_threshold, float* fstate, int* istate) {
  float a[6][6], b[6];
  int k = 0;
  for (int i = 0; i < 6; ++i)
    for (int j = i; j < 6; ++j) a[i][j] = a[j][i] = tot[k++];
  for (int i = 0; i < 6; ++i) b[i] = tot[21 + i];
  // solve_point_to_plane_from_normal_eq's Tikhonov term: eye·1e-8·trace
  float trace = a[0][0];
  for (int i = 1; i < 6; ++i) trace += a[i][i];
  const float reg = 1e-8f * trace;
  for (int i = 0; i < 6; ++i) a[i][i] += reg;
  // LU with partial pivoting (getrf), then the two triangular solves
  for (int c = 0; c < 6; ++c) {
    int p = c;
    float big = fabsf(a[c][c]);
    for (int r = c + 1; r < 6; ++r)
      if (fabsf(a[r][c]) > big) {
        big = fabsf(a[r][c]);
        p = r;
      }
    if (p != c) {
      for (int j = 0; j < 6; ++j) {
        const float t = a[c][j];
        a[c][j] = a[p][j];
        a[p][j] = t;
      }
      const float t = b[c];
      b[c] = b[p];
      b[p] = t;
    }
    if (a[c][c] == 0.f) continue;
    for (int r = c + 1; r < 6; ++r) {
      const float l = a[r][c] / a[c][c];
      for (int j = c + 1; j < 6; ++j) a[r][j] -= l * a[c][j];
      b[r] -= l * b[c];
    }
  }
  float x[6];
  for (int i = 5; i >= 0; --i) {
    float s = b[i];
    for (int j = i + 1; j < 6; ++j) s -= a[i][j] * x[j];
    x[i] = s / a[i][i];
  }

  // core/transform.py::euler_xyz_to_matrix: R = Rz(c) Ry(b) Rx(a)
  const float ca = cosf(x[0]), sa = sinf(x[0]);
  const float cb = cosf(x[1]), sb = sinf(x[1]);
  const float cc = cosf(x[2]), sc = sinf(x[2]);
  const float d[3][3] = {{cc * cb, cc * sb * sa - sc * ca, cc * sb * ca + sc * sa},
                         {sc * cb, sc * sb * sa + cc * ca, sc * sb * ca - cc * sa},
                         {-sb, cb * sa, cb * ca}};

  // delta ∘ tf: rotation d·R, translation d·t + x[3:]
  float m[3][3], t[3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)
      m[i][j] = d[i][0] * fstate[j] + d[i][1] * fstate[3 + j] + d[i][2] * fstate[6 + j];
    t[i] = d[i][0] * fstate[9] + d[i][1] * fstate[10] + d[i][2] * fstate[11] + x[3 + i];
  }

  // RigidTransform.normalize_rotation: matrix_to_quaternion (Shepperd, the
  // first largest pivot), then quaternion_to_matrix; each normalises q
  const float tr = m[0][0] + m[1][1] + m[2][2];
  const float piv[4] = {1.f + tr, 1.f + m[0][0] - m[1][1] - m[2][2],
                        1.f - m[0][0] + m[1][1] - m[2][2], 1.f - m[0][0] - m[1][1] + m[2][2]};
  int best = 0;
  for (int i = 1; i < 4; ++i)
    if (piv[i] > piv[best]) best = i;
  float q[4];  // x, y, z, w
  if (best == 0) {
    q[0] = m[2][1] - m[1][2], q[1] = m[0][2] - m[2][0], q[2] = m[1][0] - m[0][1], q[3] = piv[0];
  } else if (best == 1) {
    q[0] = piv[1], q[1] = m[0][1] + m[1][0], q[2] = m[0][2] + m[2][0], q[3] = m[2][1] - m[1][2];
  } else if (best == 2) {
    q[0] = m[0][1] + m[1][0], q[1] = piv[2], q[2] = m[1][2] + m[2][1], q[3] = m[0][2] - m[2][0];
  } else {
    q[0] = m[0][2] + m[2][0], q[1] = m[1][2] + m[2][1], q[2] = piv[3], q[3] = m[1][0] - m[0][1];
  }
  for (int pass = 0; pass < 2; ++pass) {
    const float norm = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
    for (int i = 0; i < 4; ++i) q[i] = q[i] / norm;
  }
  const float qx = q[0], qy = q[1], qz = q[2], qw = q[3];
  const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
  const float xy = qx * qy, xz = qx * qz, yz = qy * qz;
  const float wx = qw * qx, wy = qw * qy, wz = qw * qz;
  const float rot[9] = {1.f - 2.f * (yy + zz), 2.f * (xy - wz), 2.f * (xz + wy),
                        2.f * (xy + wz), 1.f - 2.f * (xx + zz), 2.f * (yz - wx),
                        2.f * (xz - wy), 2.f * (yz + wx), 1.f - 2.f * (xx + yy)};

  // rms = r_sum / clamp(w_sum, min=1) (a NaN sum stays NaN)
  const float w_sum = tot[28];
  const float rms = tot[27] / (w_sum < 1.f ? 1.f : w_sum);
  for (int i = 0; i < 9; ++i) fstate[i] = rot[i];
  for (int i = 0; i < 3; ++i) fstate[9 + i] = t[i];
  fstate[12] = rms;
  istate[0] += 1;
  istate[1] = rms < rms_threshold;
  istate[2] = 0;  // the ticket, for the next launch
}

// at most 40 registers a thread, so six blocks share an SM (the wrapper's
// grid is six an SM): on an H100 at the cells' 10^6 ICP shape (71k points,
// window cap 1,530) 0.290 ms a launch alone, against 0.316 with 64
// registers and four blocks an SM
template <int kLanes>
__global__ void __launch_bounds__(32 * kWarps, 6)
icp_step_kernel(const float* __restrict__ table, int stride,
                const long long* __restrict__ orig_idx,
                const long long* __restrict__ cell_starts, const float* __restrict__ origin,
                float cell_size, long long d0, long long d1, long long d2, int halo, int w,
                const float* __restrict__ ref, const float* __restrict__ normals,
                const float* __restrict__ scan, const float* __restrict__ weights, int q,
                float d_max, float rms_threshold, float* fstate, int* istate,
                float* partials) {
  constexpr int kGroups = 32 / kLanes;           // points a warp at a time
  constexpr int kBlockGroups = kWarps * kGroups;
  constexpr int kPer = (kSums + kLanes - 1) / kLanes;  // sums a lane
  __shared__ float group_sums[kBlockGroups][kSums];
  __shared__ float chunk_sums[kChunks][kRow];
  __shared__ float tot[kRow];
  __shared__ float tf[12];
  __shared__ bool last;

  if (istate[1]) return;  // done: the state stays, as _step's wheres leave it
  if (threadIdx.x < 12) tf[threadIdx.x] = fstate[threadIdx.x];
  __syncthreads();

  const int side = 2 * halo + 1, n_runs = side * side;
  const int lane = threadIdx.x & 31, sub = lane % kLanes, warp = threadIdx.x / 32;
  const int group = threadIdx.x / kLanes;  // the group in the block
  extern __shared__ __align__(16) unsigned char smem[];
  long long* run_start = reinterpret_cast<long long*>(smem) + group * n_runs;
  int* run_end = reinterpret_cast<int*>(reinterpret_cast<long long*>(smem) +
                                        kBlockGroups * n_runs) +
                 group * n_runs;

  // this lane's sums: k = sub + m·kLanes; for k < 21 GᵀG's (i, j)
  int sum_k[kPer], sum_i[kPer], sum_j[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    int k = sub + m * kLanes, i = 0;
    sum_k[m] = k;
    if (k < 21) {
      while (k >= 6 - i) k -= 6 - i++;
      sum_i[m] = i, sum_j[m] = i + k;
    } else {
      sum_i[m] = k - 21, sum_j[m] = 0;
    }
  }
  float acc[kPer];
#pragma unroll
  for (int m = 0; m < kPer; ++m) acc[m] = 0.f;

  // whole warps walk the points, a group a point; a warp's dead groups walk
  // empty windows so that every lane takes part in the shuffles
  for (int base = (blockIdx.x * kWarps + warp) * kGroups; base < q;
       base += gridDim.x * kBlockGroups) {
    const int p = base + (lane / kLanes);
    const bool live = p < q;
    float sx = 0.f, sy = 0.f, sz = 0.f;
    if (live) {
      const float px = scan[3 * p], py = scan[3 * p + 1], pz = scan[3 * p + 2];
      sx = tf[0] * px + tf[1] * py + tf[2] * pz + tf[9];
      sy = tf[3] * px + tf[4] * py + tf[5] * pz + tf[10];
      sz = tf[6] * px + tf[7] * py + tf[8] * pz + tf[11];
    }
    float dist;
    long long row;
    nn::nearest_row<kLanes>(table, stride, cell_starts, origin, cell_size, d0, d1, d2, halo, w,
                            live, sx, sy, sz, run_start, run_end, dist, row);
    if (live) {
      float wt = dist <= d_max ? 1.f : 0.f;
      if (weights != nullptr) wt = wt * weights[p];
      const long long o = orig_idx[row];
      const float rx = ref[3 * o], ry = ref[3 * o + 1], rz = ref[3 * o + 2];
      const float nx = normals[3 * o], ny = normals[3 * o + 1], nz = normals[3 * o + 2];
      const float g[6] = {sy * nz - sz * ny, sz * nx - sx * nz, sx * ny - sy * nx, nx, ny, nz};
      const float h = (rx - sx) * nx + (ry - sy) * ny + (rz - sz) * nz;
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        const int k = sum_k[m];
        const float gi = pick(g, sum_i[m]) * wt;
        acc[m] += k < 21 ? gi * pick(g, sum_j[m])
                  : k < 27 ? gi * h
                  : k == 27 ? fabsf(h) * wt
                  : k == 28 ? wt
                            : 0.f;
      }
    }
    __syncwarp();  // the group's runs are written again by its next point
  }

  // the block's sums, in group order, then its partial row
#pragma unroll
  for (int m = 0; m < kPer; ++m)
    if (sum_k[m] < kSums) group_sums[group][sum_k[m]] = acc[m];
  __syncthreads();
  if (threadIdx.x < kSums) {
    float s = group_sums[0][threadIdx.x];
    for (int g = 1; g < kBlockGroups; ++g) s += group_sums[g][threadIdx.x];
    partials[blockIdx.x * kRow + threadIdx.x] = s;
  }
  __threadfence();  // the row is visible before the ticket counts it
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(reinterpret_cast<unsigned*>(istate + 2), 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  // the last block: the partial rows in a fixed order (chunk c holds rows
  // c, c + kChunks, ...; then the chunks in order), read from L2
  __threadfence();
  const int k = threadIdx.x % kRow, c = threadIdx.x / kRow;
  if (k < kSums) {
    float s = 0.f;
#pragma unroll 8
    for (int r = c; r < (int)gridDim.x; r += kChunks) s += __ldcg(partials + r * kRow + k);
    chunk_sums[c][k] = s;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    float s = chunk_sums[0][threadIdx.x];
    for (int cc = 1; cc < kChunks; ++cc) s += chunk_sums[cc][threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) finish(tot, rms_threshold, fstate, istate);
}

template <int kLanes>
int launch_icp_step(const float* table, int stride, const long long* orig_idx,
                    const long long* cell_starts, const float* origin, float cell_size,
                    long long d0, long long d1, long long d2, int halo, int w, const float* ref,
                    const float* normals, const float* scan, const float* weights, int q,
                    float d_max, float rms_threshold, float* fstate, int* istate,
                    float* partials, int blocks, cudaStream_t stream) {
  const int side = 2 * halo + 1;
  const size_t smem = (size_t)kWarps * (32 / kLanes) * nn::group_smem(side * side);
  if (smem > 40 * 1024) {  // past 48 KB with the static arrays
    const cudaError_t err = cudaFuncSetAttribute(
        icp_step_kernel<kLanes>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  icp_step_kernel<kLanes><<<blocks, 32 * kWarps, smem, stream>>>(
      table, stride, orig_idx, cell_starts, origin, cell_size, d0, d1, d2, halo, w, ref,
      normals, scan, weights, q, d_max, rms_threshold, fstate, istate, partials);
  return last_launch_error();
}

}  // namespace

// One ICP iteration on the state (fstate, istate); weights may be null.
// lanes: lanes a point, 32 or 8; blocks: the grid, and the rows of
// partials (blocks × 32 floats).
SHOT_EXPORT int icp_step(const float* table, int stride, const long long* orig_idx,
                         const long long* cell_starts, const float* origin, float cell_size,
                         long long d0, long long d1, long long d2, int halo, int w,
                         const float* ref, const float* normals, const float* scan,
                         const float* weights, int q, int lanes, float d_max,
                         float rms_threshold, float* fstate, int* istate, float* partials,
                         int blocks, cudaStream_t stream) {
  if (stride < 3 || halo < 0 || w <= 0 || q < 0 || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  switch (lanes) {
    case 32:
      return launch_icp_step<32>(table, stride, orig_idx, cell_starts, origin, cell_size, d0, d1,
                                 d2, halo, w, ref, normals, scan, weights, q, d_max,
                                 rms_threshold, fstate, istate, partials, blocks, stream);
    case 8:
      return launch_icp_step<8>(table, stride, orig_idx, cell_starts, origin, cell_size, d0, d1,
                                d2, halo, w, ref, normals, scan, weights, q, d_max,
                                rms_threshold, fstate, istate, partials, blocks, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
