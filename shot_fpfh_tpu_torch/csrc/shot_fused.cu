// K1: SHOT local reference frames + soft binning + 352-bin histogram.
//
// Replaces the TPU kernel
// shot_fpfh_tpu/ops/pallas_shot_fused.py::shot_binning_histogram
// (_binning_histogram_body, _lrf_planes), which builds one-hot operands in
// VMEM and contracts them on the MXU.
//
// Here one thread block serves one keypoint and reads its feature-first
// window (vals (Q, F, W): x y z nx ny nz planes; dist (Q, W), +inf where
// invalid) in three coalesced passes:
//   1. block-reduce the (r − d)-weighted covariance; one thread runs the
//      cyclic Jacobi of ops/eigh3.py (4 sweeps, atan2/cos/sin rotations,
//      ascending sort network), taking x = largest, z = smallest axis;
//   2. block-reduce the x/z majority sign votes (a tie keeps the sign),
//      y = z × x, identity for an empty window;
//   3. bin every valid neighbor with the reference conventions
//      (ops/descriptor_bins.py) and atomicAdd its five weighted
//      contributions, in f32, into a 352-float histogram in shared memory.
// With given frames (multiscale sharing) passes 1–2 are skipped.  The
// one-hot matmuls of the TPU kernel were an MXU workaround and are gone.
//
// Bound on the H100: the per-neighbor transcendentals (atan2, acos) and the
// shared-memory atomics of pass 3; the window is read three times but is a
// few KB per keypoint and stays in L1/L2.  The Jacobi is serial on one
// thread (36 trig calls), small beside a window of hundreds of neighbors.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCos = 11, kLo = 32, kDim = kCos * kLo;
// the reference's double constants, rounded once to float32
constexpr double kPiD = 3.14159265358979323846;
constexpr float kHalfPi = (float)(kPiD / 2.0);
constexpr float kPi14 = (float)(kPiD * 0.25);
constexpr float kPi34 = (float)(kPiD * 0.75);
constexpr float kAzSize = (float)(2.0 * kPiD / 8.0);
constexpr float kNegPi = (float)(-kPiD);

__device__ __forceinline__ int sgn(float x) { return (x > 0.f) - (x < 0.f); }
__device__ __forceinline__ int wrap(int v, int n) {
  v = v < 0 ? v + n : v;
  return v >= n ? v - n : v;
}

// One Jacobi rotation zeroing a[p][q] (same update order as ops/eigh3.py).
__device__ void jacobi_rotate(float a[3][3], float v[3][3], int p, int q) {
  const int r = 3 - p - q;
  const float app = a[p][p], aqq = a[q][q], apq = a[p][q];
  const float apr = a[p][r], aqr = a[q][r];
  const float theta = 0.5f * atan2f(2.0f * apq, aqq - app);
  const float c = cosf(theta), s = sinf(theta);
  const float c2 = c * c, s2 = s * s, cs = c * s;
  a[p][p] = c2 * app - 2.0f * cs * apq + s2 * aqq;
  a[q][q] = s2 * app + 2.0f * cs * apq + c2 * aqq;
  a[p][q] = a[q][p] = cs * (app - aqq) + (c2 - s2) * apq;
  a[p][r] = a[r][p] = c * apr - s * aqr;
  a[q][r] = a[r][q] = s * apr + c * aqr;
  for (int row = 0; row < 3; ++row) {
    const float vp = v[row][p], vq = v[row][q];
    v[row][p] = c * vp - s * vq;
    v[row][q] = s * vp + c * vq;
  }
}

// Symmetric 3x3 eigh: eigenvalues ascending in w, eigenvectors as columns.
__device__ void eigh3x3(const float cov[3][3], float w[3], float vec[3][3]) {
  float scale = 0.f;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) scale = fmaxf(scale, fabsf(cov[i][j]));
  scale = fmaxf(scale, 1e-30f);
  float a[3][3], v[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      a[i][j] = cov[i][j] / scale;
      v[i][j] = i == j ? 1.f : 0.f;
    }
  for (int sweep = 0; sweep < 4; ++sweep) {
    jacobi_rotate(a, v, 0, 1);
    jacobi_rotate(a, v, 0, 2);
    jacobi_rotate(a, v, 1, 2);
  }
  int col[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i) w[i] = a[i][i] * scale;
  const int pairs[3][2] = {{0, 1}, {1, 2}, {0, 1}};
  for (int t = 0; t < 3; ++t) {
    const int i = pairs[t][0], j = pairs[t][1];
    if (w[i] > w[j]) {
      const float tw = w[i];
      w[i] = w[j];
      w[j] = tw;
      const int tc = col[i];
      col[i] = col[j];
      col[j] = tc;
    }
  }
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) vec[r][c] = v[r][col[c]];
}

__device__ __forceinline__ int azimuth_bin(float x, float y) {
  const int a = (y > 0.f) || (y == 0.f && x < 0.f);
  const int h = (x > 0.f) || (x == 0.f && y > 0.f);
  const int cond = (x * y > 0.f) || (x == 0.f);
  const int lt = fabsf(x) < fabsf(y);
  const int gt = fabsf(x) > fabsf(y);
  const int corner = cond * lt + (1 - cond) * gt;
  const int xr = a + h - 2 * a * h;
  return 4 * a + 2 * xr + corner;
}

__device__ __forceinline__ int cell_index(int az, int elev, int rad) {
  return (az * 2 + elev) * 2 + rad;
}

__global__ void __launch_bounds__(kThreads)
shot_hist_kernel(const float* __restrict__ vals, const float* __restrict__ dist,
                 const float* __restrict__ kp, const float* __restrict__ rfs_in,
                 float* __restrict__ hist, float* __restrict__ rfs_out, int nf,
                 int w_len, float radius) {
  __shared__ float hist_s[kDim];
  __shared__ float scratch[8 * (kThreads / 32)];
  __shared__ float frame[9];  // row-major rf: columns are the x, y, z axes
  const int qi = blockIdx.x;
  const float* vx = vals + (long long)qi * nf * w_len;
  const float* vy = vx + w_len;
  const float* vz = vy + w_len;
  const float* nxp = vz + w_len;
  const float* nyp = nxp + w_len;
  const float* nzp = nyp + w_len;
  const float* dq = dist + (long long)qi * w_len;
  const float kx = kp[3 * qi], ky = kp[3 * qi + 1], kz = kp[3 * qi + 2];
  const float r = radius;

  for (int i = threadIdx.x; i < kDim; i += kThreads) hist_s[i] = 0.f;

  if (rfs_in == nullptr) {
    // pass 1: (r - d)-weighted covariance of the centered window
    float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int w = threadIdx.x; w < w_len; w += kThreads) {
      const float d = dq[w];
      if (!(d < INFINITY)) continue;
      const float cx = vx[w] - kx, cy = vy[w] - ky, cz = vz[w] - kz;
      const float wgt = fmaxf(r - d, 0.f);
      s[0] += wgt;
      s[1] += (wgt * cx) * cx;
      s[2] += (wgt * cx) * cy;
      s[3] += (wgt * cx) * cz;
      s[4] += (wgt * cy) * cy;
      s[5] += (wgt * cy) * cz;
      s[6] += (wgt * cz) * cz;
      s[7] += 1.f;
    }
    block_sum<8>(s, scratch);
    if (threadIdx.x == 0) {
      const float wsum = fmaxf(s[0], 1e-12f);
      const float cov[3][3] = {{s[1] / wsum, s[2] / wsum, s[3] / wsum},
                               {s[2] / wsum, s[4] / wsum, s[5] / wsum},
                               {s[3] / wsum, s[5] / wsum, s[6] / wsum}};
      float ev[3], vec[3][3];
      eigh3x3(cov, ev, vec);
      frame[0] = vec[0][2];  // x axis: largest eigenvalue
      frame[3] = vec[1][2];
      frame[6] = vec[2][2];
      frame[2] = vec[0][0];  // z axis: smallest eigenvalue
      frame[5] = vec[1][0];
      frame[8] = vec[2][0];
    }
    __syncthreads();
    // pass 2: majority sign votes of the neighbors' projections
    const float x0 = frame[0], x1 = frame[3], x2 = frame[6];
    const float z0 = frame[2], z1 = frame[5], z2 = frame[8];
    float votes[4] = {0.f, 0.f, 0.f, 0.f};
    for (int w = threadIdx.x; w < w_len; w += kThreads) {
      if (!(dq[w] < INFINITY)) continue;
      const float cx = vx[w] - kx, cy = vy[w] - ky, cz = vz[w] - kz;
      const float px = cx * x0 + cy * x1 + cz * x2;
      const float pz = cx * z0 + cy * z1 + cz * z2;
      votes[px < 0.f ? 0 : 1] += 1.f;
      votes[pz < 0.f ? 2 : 3] += 1.f;
    }
    block_sum<4>(votes, scratch);
    if (threadIdx.x == 0) {
      const float fx = votes[0] > votes[1] ? -1.f : 1.f;
      const float fz = votes[2] > votes[3] ? -1.f : 1.f;
      float xa[3] = {x0 * fx, x1 * fx, x2 * fx};
      float za[3] = {z0 * fz, z1 * fz, z2 * fz};
      float ya[3] = {za[1] * xa[2] - za[2] * xa[1], za[2] * xa[0] - za[0] * xa[2],
                     za[0] * xa[1] - za[1] * xa[0]};
      if (s[7] == 0.f) {  // empty window: identity frame
        for (int i = 0; i < 3; ++i) xa[i] = ya[i] = za[i] = 0.f;
        xa[0] = ya[1] = za[2] = 1.f;
      }
      for (int i = 0; i < 3; ++i) {
        frame[3 * i] = xa[i];
        frame[3 * i + 1] = ya[i];
        frame[3 * i + 2] = za[i];
      }
      for (int i = 0; i < 9; ++i) rfs_out[9 * qi + i] = frame[i];
    }
  } else if (threadIdx.x < 9) {
    frame[threadIdx.x] = rfs_in[9 * qi + threadIdx.x];
  }
  __syncthreads();

  // pass 3: local coordinates, angles, soft bins, histogram
  const float x0 = frame[0], x1 = frame[3], x2 = frame[6];
  const float y0 = frame[1], y1 = frame[4], y2 = frame[7];
  const float z0 = frame[2], z1 = frame[5], z2 = frame[8];
  const float half = r / 2.0f, r34 = r * 0.75f, r14 = r * 0.25f;
  for (int w = threadIdx.x; w < w_len; w += kThreads) {
    const float rho = dq[w];
    if (!(rho < INFINITY) || !(rho > 0.f)) continue;
    const float cx = vx[w] - kx, cy = vy[w] - ky, cz = vz[w] - kz;
    const float lx = cx * x0 + cy * x1 + cz * x2;
    const float ly = cx * y0 + cy * y1 + cz * y2;
    const float lz = cx * z0 + cy * z1 + cz * z2;
    const float cosine = fminf(fmaxf(nxp[w] * z0 + nyp[w] * z1 + nzp[w] * z2, -1.f), 1.f);
    const float theta = atan2f(ly, lx);
    const float phi = acosf(fminf(fmaxf(lz / rho, -1.f), 1.f));

    const float cos_pos = (cosine + 1.0f) * 5.5f - 0.5f;
    const int cos_bin = (int)rintf(cos_pos);  // round half to even
    const int az_bin = azimuth_bin(lx, ly);
    const int elev_bin = lz > 0.f;
    const int rad_bin = rho > half;

    const float delta_cos = cos_pos - (float)cos_bin;
    const float abs_cos = fabsf(delta_cos);
    const int cos_nb = wrap(cos_bin + sgn(delta_cos), kCos);

    const float inner = (rho > half && rho < r34) ? (r34 - rho) / half : 0.f;
    const float outer = (rho < half && rho > r14) ? (rho - r14) / half : 0.f;
    const float husk_cur = (rho < half ? 1.0f - fabsf(rho - r14) / half : 0.f) +
                           (rho > half ? 1.0f - fabsf(rho - r34) / half : 0.f);

    const bool at_edge = fabsf(phi - kHalfPi) < 1e-10f;
    const float upper = (((phi > kHalfPi) || (at_edge && lz <= 0.f)) && phi <= kPi34)
                            ? (kPi34 - phi) / kHalfPi : 0.f;
    const float lower = (((phi < kHalfPi) && (!at_edge || lz > 0.f)) && phi >= kPi14)
                            ? (phi - kPi14) / kHalfPi : 0.f;
    const float vert_cur = (phi < kHalfPi ? 1.0f - fabsf(phi - kPi14) / kHalfPi : 0.f) +
                           (phi >= kHalfPi ? 1.0f - fabsf(phi - kPi34) / kHalfPi : 0.f);

    const float delta_az = fminf(
        fmaxf((theta - (kNegPi + (float)az_bin * kAzSize)) / kAzSize - 0.5f, -0.5f), 0.5f);
    const float abs_az = fabsf(delta_az);
    const int az_nb = wrap(az_bin + sgn(delta_az), 8);

    const int base = cell_index(az_bin, elev_bin, rad_bin);
    const float w_same = (1.0f - abs_cos) + husk_cur + vert_cur + (1.0f - abs_az);
    const float w_husk = rad_bin == 0 ? outer : inner;
    const float w_vert = elev_bin == 0 ? upper : lower;
    float* hc = hist_s + cos_bin * kLo;
    atomicAdd(hc + base, w_same);
    atomicAdd(hc + cell_index(az_bin, elev_bin, 1 - rad_bin), w_husk);
    atomicAdd(hc + cell_index(az_bin, 1 - elev_bin, rad_bin), w_vert);
    atomicAdd(hc + cell_index(az_nb, elev_bin, rad_bin), abs_az);
    atomicAdd(hist_s + cos_nb * kLo + base, abs_cos);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kDim; i += kThreads) hist[(long long)qi * kDim + i] = hist_s[i];
}

}  // namespace

SHOT_EXPORT int shot_binning_histogram(const float* vals, const float* dist,
                                       const float* kp, const float* rfs_in,
                                       float* hist, float* rfs_out, int q, int nf,
                                       int w_len, float radius, cudaStream_t stream) {
  if (q <= 0) return 0;
  shot_hist_kernel<<<q, kThreads, 0, stream>>>(vals, dist, kp, rfs_in, hist, rfs_out,
                                               nf, w_len, radius);
  return last_launch_error();
}
