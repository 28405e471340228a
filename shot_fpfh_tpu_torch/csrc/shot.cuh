// SHOT per-keypoint stage shared by K1 (shot_fused.cu, window route) and K5
// (shot_runs.cu, xy-row run route), as the TPU kernels share
// pallas_shot_fused.py::_binning_histogram_body.
//
// One thread block serves one keypoint, in three passes over its neighbors:
//   1. block-reduce the (r_frame − d)-weighted covariance over the frame
//      plane; one thread runs the cyclic Jacobi of ops/eigh3.py (4 sweeps,
//      atan2/cos/sin rotations, ascending sort network), taking x = largest,
//      z = smallest axis;
//   2. block-reduce the x/z majority sign votes over the frame plane (a tie
//      keeps the sign), y = z × x, identity for an empty frame plane;
//   3. bin every neighbor of the descriptor plane with d > 0 by the
//      reference conventions (ops/descriptor_bins.py) and atomicAdd its five
//      weighted contributions, in f32, into a 352-float histogram in shared
//      memory.
// The frame plane is the descriptor plane, except in bi-scale mode, where it
// holds the neighbors within the frame radius.  With given frames (multiscale
// sharing) passes 1–2 are skipped.
//
// A neighbor source supplies the planes.  It has two member templates that
// call f on the calling thread's strided share of the neighbors:
//   frame_neighbors(f): f(cx, cy, cz, d) for each frame-plane neighbor;
//   bin_neighbors(f):   f(cx, cy, cz, nx, ny, nz, rho) for each
//                       descriptor-plane neighbor with rho > 0,
// where (cx, cy, cz) is the neighbor minus the keypoint.
//
// The float32 order of every step is that of the plain PyTorch twins
// (ops/shot_fused.py), and the sources are built -fmad=false: SHOT's bins are
// hard in all but one dimension, so a last-bit change moves a neighbor's
// weight to another bin.
#pragma once

#include <math.h>

#include "common.cuh"

namespace shot {

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
__device__ inline void jacobi_rotate(float a[3][3], float v[3][3], int p, int q) {
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
__device__ inline void eigh3x3(const float cov[3][3], float w[3], float vec[3][3]) {
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

// A local frame's axes, read from the row-major frame (columns x, y, z).
struct Frame {
  float x0, x1, x2, y0, y1, y2, z0, z1, z2;
  __device__ explicit Frame(const float* f)
      : x0(f[0]), x1(f[3]), x2(f[6]), y0(f[1]), y1(f[4]), y2(f[7]), z0(f[2]), z1(f[5]),
        z2(f[8]) {}
};

// Pass 1 term: the neighbor's (r − d)-weighted second moments and its count.
__device__ __forceinline__ void add_covariance(float (&s)[8], float cx, float cy, float cz,
                                               float d, float r) {
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

// Pass 2 term: the neighbor's votes on the signs of the x and z axes.
__device__ __forceinline__ void add_votes(float (&votes)[4], float cx, float cy, float cz,
                                          float x0, float x1, float x2, float z0, float z1,
                                          float z2) {
  const float px = cx * x0 + cy * x1 + cz * x2;
  const float pz = cx * z0 + cy * z1 + cz * z2;
  votes[px < 0.f ? 0 : 1] += 1.f;
  votes[pz < 0.f ? 2 : 3] += 1.f;
}

// Pass 3 term: one neighbor's soft bins, added into the shared histogram.
__device__ __forceinline__ void bin_neighbor(float* hist, const Frame& f, float cx, float cy,
                                             float cz, float nx, float ny, float nz, float rho,
                                             float r) {
  const float half = r / 2.0f, r34 = r * 0.75f, r14 = r * 0.25f;
  const float lx = cx * f.x0 + cy * f.x1 + cz * f.x2;
  const float ly = cx * f.y0 + cy * f.y1 + cz * f.y2;
  const float lz = cx * f.z0 + cy * f.z1 + cz * f.z2;
  const float cosine = fminf(fmaxf(nx * f.z0 + ny * f.z1 + nz * f.z2, -1.f), 1.f);
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
  float* hc = hist + cos_bin * kLo;
  atomicAdd(hc + base, w_same);
  atomicAdd(hc + cell_index(az_bin, elev_bin, 1 - rad_bin), w_husk);
  atomicAdd(hc + cell_index(az_bin, 1 - elev_bin, rad_bin), w_vert);
  atomicAdd(hc + cell_index(az_nb, elev_bin, rad_bin), abs_az);
  atomicAdd(hist + cos_nb * kLo + base, abs_cos);
}

// The three passes for the block's keypoint.  `frame_in` (9 floats,
// row-major) gives the frame, or is null to compute it from the frame plane
// with radius `r_frame`; computed frames go to `frame_out` (9 floats).
// Leaves the histogram in `hist_s` (kDim floats) and the frame in `frame`
// (9 floats) of shared memory, after a barrier; `scratch` holds
// 8 * (blockDim.x / 32) floats.  Returns the number of neighbors this thread
// binned.
template <class Source>
__device__ float keypoint_histogram(const Source& src, float r, float r_frame,
                                    const float* frame_in, float* frame_out, float* hist_s,
                                    float* scratch, float* frame) {
  for (int i = threadIdx.x; i < kDim; i += blockDim.x) hist_s[i] = 0.f;

  if (frame_in == nullptr) {
    float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    src.frame_neighbors(
        [&](float cx, float cy, float cz, float d) { add_covariance(s, cx, cy, cz, d, r_frame); });
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
    const float x0 = frame[0], x1 = frame[3], x2 = frame[6];
    const float z0 = frame[2], z1 = frame[5], z2 = frame[8];
    float votes[4] = {0.f, 0.f, 0.f, 0.f};
    src.frame_neighbors([&](float cx, float cy, float cz, float) {
      add_votes(votes, cx, cy, cz, x0, x1, x2, z0, z1, z2);
    });
    block_sum<4>(votes, scratch);
    if (threadIdx.x == 0) {
      const float fx = votes[0] > votes[1] ? -1.f : 1.f;
      const float fz = votes[2] > votes[3] ? -1.f : 1.f;
      float xa[3] = {x0 * fx, x1 * fx, x2 * fx};
      float za[3] = {z0 * fz, z1 * fz, z2 * fz};
      float ya[3] = {za[1] * xa[2] - za[2] * xa[1], za[2] * xa[0] - za[0] * xa[2],
                     za[0] * xa[1] - za[1] * xa[0]};
      if (s[7] == 0.f) {  // empty frame plane: identity frame
        for (int i = 0; i < 3; ++i) xa[i] = ya[i] = za[i] = 0.f;
        xa[0] = ya[1] = za[2] = 1.f;
      }
      for (int i = 0; i < 3; ++i) {
        frame[3 * i] = xa[i];
        frame[3 * i + 1] = ya[i];
        frame[3 * i + 2] = za[i];
      }
      for (int i = 0; i < 9; ++i) frame_out[i] = frame[i];
    }
  } else if (threadIdx.x < 9) {
    frame[threadIdx.x] = frame_in[threadIdx.x];
  }
  __syncthreads();

  const Frame f(frame);
  float n_binned = 0.f;
  src.bin_neighbors([&](float cx, float cy, float cz, float nx, float ny, float nz, float rho) {
    bin_neighbor(hist_s, f, cx, cy, cz, nx, ny, nz, rho, r);
    n_binned += 1.f;
  });
  __syncthreads();
  return n_binned;
}

}  // namespace shot
