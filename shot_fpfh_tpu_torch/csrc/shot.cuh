// SHOT per-keypoint stage shared by K1 (shot_fused.cu, window route) and K5
// (shot_runs.cu, xy-row run route), as the TPU kernels share
// pallas_shot_fused.py::_binning_histogram_body: the per-neighbor terms, the
// frame steps, and the warp body both kernels run, one warp a keypoint.
//
// Three passes over a keypoint's neighbors:
//   1. reduce the (r_frame − d)-weighted covariance over the frame plane
//      (add_covariance); the cyclic Jacobi of ops/eigh3.py (eigh3x3: 4
//      sweeps, atan2/cos/sin rotations, ascending sort network) gives
//      x = largest, z = smallest axis (frame_axes);
//   2. reduce the x/z majority sign votes over the frame plane (add_votes; a
//      tie keeps the sign), y = z × x, identity for an empty frame plane
//      (signed_frame);
//   3. bin every neighbor of the descriptor plane with d > 0 by the
//      reference conventions (ops/descriptor_bins.py) into five weighted
//      contributions (bin_weights), added in f32 into a 352-float histogram
//      in shared memory.
// The frame plane is the descriptor plane, except in bi-scale mode, where it
// holds the neighbors within the frame radius.  With given frames (multiscale
// sharing) passes 1–2 are skipped.
//
// The warp body (keypoint_histogram) reduces passes 1–2 with xor shuffles,
// which leave the same sums, bit for bit, in every lane, so every lane runs
// the Jacobi and holds the frame in registers.  Pass 3 compacts the
// neighbors by ballot into a 64-slot list in shared memory and bins them 32
// at a time, so the atan2/acos work runs on full warps; lanes that add to
// the same bin sum their weights by shuffles first (warp_add), so each
// distinct bin of a step takes one atomic.  It takes a neighbor source, a
// struct whose members every lane of the warp calls together (no lambdas,
// whose calls need not inline: the whole body inlines, so its state stays in
// registers):
//   covariance(s, r_frame): adds the lane's share of the frame plane's
//                           add_covariance terms to s;
//   votes(x, z, v):         adds the lane's share of its add_votes terms;
//   Cursor, start(), next(cursor, take): pass 3's candidates, kUnroll a
//                           lane at each step, the same number of steps in
//                           every lane (false when done); take[u]: the
//                           candidate is in the descriptor plane with d > 0;
//   item(cursor, u):        the item of the lane's candidate u of the step
//                           next just took;
//   bin(f, r, item, idx, wt, bad): bin_weights of a listed item under
//                           frame f (none, idx left -1, if it has d = 0).
//
// The debug checks (the CLI's --debug_shot): given a device counter, the
// warp body adds to it, per binned neighbor, whether any of its five bins
// left its range (counter[0]) and whether its summed weight is NaN or
// outside (0, 4 + 1e-3] (counter[1]), the twin's _binning_violations
// (ops/shot_fused.py); a null counter skips them.  An index outside the
// histogram is never added (the reference's one-hot drops it).
//
// The float32 order of every per-neighbor step is that of the plain PyTorch
// twins (ops/shot_fused.py), and the sources are built -fmad=false: SHOT's
// bins are hard in all but one dimension, so a last-bit change moves a
// neighbor's weight to another bin.  The order of the sums over neighbors
// (covariance, votes, histogram) is free.
#pragma once

#include <math.h>

#include "common.cuh"

namespace shot {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnroll = 4;  // candidates a lane loads at once
constexpr int kCos = 11, kLo = 32, kDim = kCos * kLo;
// the reference's double constants, rounded once to float32
constexpr double kPiD = 3.14159265358979323846;
constexpr float kHalfPi = (float)(kPiD / 2.0);
constexpr float kPi14 = (float)(kPiD * 0.25);
constexpr float kPi34 = (float)(kPiD * 0.75);
constexpr float kAzSize = (float)(2.0 * kPiD / 8.0);
constexpr float kNegPi = (float)(-kPiD);

__device__ __forceinline__ int sgn(float x) { return (x > 0.f) - (x < 0.f); }
// x clamped to [lo, hi], a NaN kept, as torch.clamp and jnp.clip keep it
// (fminf/fmaxf return the other operand for a NaN); a finite x gives
// fminf(fmaxf(x, lo), hi) bit for bit
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ int wrap(int v, int n) {
  v = v < 0 ? v + n : v;
  return v >= n ? v - n : v;
}

// One Jacobi rotation zeroing a[p][q] (same update order as ops/eigh3.py).
__device__ __forceinline__ void jacobi_rotate(float a[3][3], float v[3][3], int p, int q) {
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
__device__ __forceinline__ void eigh3x3(const float cov[3][3], float w[3], float vec[3][3]) {
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
  // v's column col[c], selected rather than indexed, so v stays in registers
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      vec[r][c] = col[c] == 0 ? v[r][0] : (col[c] == 1 ? v[r][1] : v[r][2]);
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

// Pass 3 term: one neighbor's five soft-bin contributions, as histogram
// indices (cos_bin * 32 + cell) and weights; bad gets bit 0 when a bin is
// out of its range and bit 1 when the weights' sum is unsound.
__device__ __forceinline__ void bin_weights(const Frame& f, float cx, float cy, float cz,
                                            float nx, float ny, float nz, float rho, float r,
                                            int (&idx)[5], float (&wt)[5], unsigned& bad) {
  const float half = r / 2.0f, r34 = r * 0.75f, r14 = r * 0.25f;
  const float lx = cx * f.x0 + cy * f.x1 + cz * f.x2;
  const float ly = cx * f.y0 + cy * f.y1 + cz * f.y2;
  const float lz = cx * f.z0 + cy * f.z1 + cz * f.z2;
  const float cosine = clamp_nan(nx * f.z0 + ny * f.z1 + nz * f.z2, -1.f, 1.f);
  const float theta = atan2f(ly, lx);
  const float phi = acosf(clamp_nan(lz / rho, -1.f, 1.f));

  const float cos_pos = (cosine + 1.0f) * 5.5f - 0.5f;
  const int cos_bin = (int)rintf(cos_pos);  // round half to even
  const int az_bin = azimuth_bin(lx, ly);
  const int elev_bin = lz > 0.f;
  const int rad_bin = rho > half;

  const float delta_cos = cos_pos - (float)cos_bin;
  const float abs_cos = fabsf(delta_cos);
  const int cos_nb = wrap(cos_bin + sgn(delta_cos), kCos);

  // each two-sided weight of the reference (twin: ops/descriptor_bins.py)
  // divides only its taken side: that division has the twin's operands, and
  // the other side's 0.f that the twin adds changes nothing (the taken side
  // is never -0), so the weights are the twin's bit for bit
  const bool at_edge = fabsf(phi - kHalfPi) < 1e-10f;
  const bool husk_nb_on = rad_bin ? rho < r34 : (rho < half && rho > r14);
  const float husk_nb = husk_nb_on ? (rad_bin ? r34 - rho : rho - r14) / half : 0.f;
  const float husk_cur =
      rho != half ? 1.0f - fabsf(rho - (rho < half ? r14 : r34)) / half : 0.f;
  const bool vert_nb_on =
      elev_bin ? (((phi < kHalfPi) && (!at_edge || lz > 0.f)) && phi >= kPi14)
               : (((phi > kHalfPi) || (at_edge && lz <= 0.f)) && phi <= kPi34);
  // the twin's off side is 0 · (phi term), NaN for a NaN phi (a NaN frame or
  // normal): kept, so the NaN lands in the bins the twin's does
  const float vert_nb = vert_nb_on ? (elev_bin ? phi - kPi14 : kPi34 - phi) / kHalfPi
                                   : (isnan(phi) ? phi : 0.f);
  const float vert_cur = 1.0f - fabsf(phi - (phi < kHalfPi ? kPi14 : kPi34)) / kHalfPi;

  const float delta_az =
      clamp_nan((theta - (kNegPi + (float)az_bin * kAzSize)) / kAzSize - 0.5f, -0.5f, 0.5f);
  const float abs_az = fabsf(delta_az);
  const int az_nb = wrap(az_bin + sgn(delta_az), 8);

  const int base = cell_index(az_bin, elev_bin, rad_bin);
  const int hc = cos_bin * kLo;
  idx[0] = hc + base;
  wt[0] = (1.0f - abs_cos) + husk_cur + vert_cur + (1.0f - abs_az);
  idx[1] = hc + cell_index(az_bin, elev_bin, 1 - rad_bin);
  wt[1] = husk_nb;
  idx[2] = hc + cell_index(az_bin, 1 - elev_bin, rad_bin);
  wt[2] = vert_nb;
  idx[3] = hc + cell_index(az_nb, elev_bin, rad_bin);
  wt[3] = abs_az;
  idx[4] = cos_nb * kLo + base;
  wt[4] = abs_cos;

  const float total = wt[0] + wt[1] + wt[2] + wt[3] + wt[4];
  const bool bad_bin = (unsigned)cos_bin >= (unsigned)kCos ||
                       (unsigned)cos_nb >= (unsigned)kCos || (unsigned)az_bin >= 8u ||
                       (unsigned)elev_bin >= 2u || (unsigned)rad_bin >= 2u;
  const bool bad_wt = isnan(total) || total > 4.001f || total <= 0.f;
  bad = (bad_bin ? 1u : 0u) | (bad_wt ? 2u : 0u);
}

// The Jacobi frame of a reduced covariance: the x axis (largest eigenvalue)
// and the z axis (smallest), from s = {Σw, Σw·cx·cx, Σw·cx·cy, Σw·cx·cz,
// Σw·cy·cy, Σw·cy·cz, Σw·cz·cz, count}.
__device__ __forceinline__ void frame_axes(const float (&s)[8], float (&x)[3], float (&z)[3]) {
  const float wsum = fmaxf(s[0], 1e-12f);
  const float cov[3][3] = {{s[1] / wsum, s[2] / wsum, s[3] / wsum},
                           {s[2] / wsum, s[4] / wsum, s[5] / wsum},
                           {s[3] / wsum, s[5] / wsum, s[6] / wsum}};
  float ev[3], vec[3][3];
  eigh3x3(cov, ev, vec);
  for (int i = 0; i < 3; ++i) {
    x[i] = vec[i][2];
    z[i] = vec[i][0];
  }
}

// The signed frame, row-major (columns x, y, z): x and z flipped where the
// votes {x < 0, x >= 0, z < 0, z >= 0} say so (a tie keeps the sign),
// y = z × x; the identity when the frame plane was empty (count s7 == 0).
__device__ __forceinline__ void signed_frame(const float (&x)[3], const float (&z)[3],
                                             const float (&votes)[4], float s7,
                                             float (&frame)[9]) {
  const float fx = votes[0] > votes[1] ? -1.f : 1.f;
  const float fz = votes[2] > votes[3] ? -1.f : 1.f;
  float xa[3] = {x[0] * fx, x[1] * fx, x[2] * fx};
  float za[3] = {z[0] * fz, z[1] * fz, z[2] * fz};
  float ya[3] = {za[1] * xa[2] - za[2] * xa[1], za[2] * xa[0] - za[0] * xa[2],
                 za[0] * xa[1] - za[1] * xa[0]};
  if (s7 == 0.f) {
    for (int i = 0; i < 3; ++i) xa[i] = ya[i] = za[i] = 0.f;
    xa[0] = ya[1] = za[2] = 1.f;
  }
  for (int i = 0; i < 3; ++i) {
    frame[3 * i] = xa[i];
    frame[3 * i + 1] = ya[i];
    frame[3 * i + 2] = za[i];
  }
}

// Sums N values over the warp.  The xor butterfly adds a + b in one lane
// and b + a in its partner, so every lane ends with the same sums.
template <int N>
__device__ __forceinline__ void warp_allsum(float (&v)[N]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] += __shfl_xor_sync(kFull, v[k], off);
}

// hist[idx] += wt for every lane of the warp (all lanes call it; an idx
// outside [0, kDim) adds nothing).  Lanes with the same idx sum their weights by shuffles in a
// tree over their ranks, and the lowest of them adds the sum: one atomic a
// distinct bin.
__device__ __forceinline__ void warp_add(float* hist, int idx, float wt) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(kFull, idx);
  unsigned rank = __popc(peers & ((1u << lane) - 1u));   // peers below this lane
  unsigned above = peers & ~((2u << lane) - 1u);         // peers above it
  float sum = wt;
  while (__any_sync(kFull, above)) {
    const int next = __ffs(above);  // 1 + the next peer above, or 0
    const float t = __shfl_sync(kFull, sum, (next - 1) & 31);
    if (next) sum += t;
    // odd ranks have been summed into the peer below them: drop them
    above &= ~__ballot_sync(kFull, rank & 1u);
    rank >>= 1;
  }
  if ((unsigned)idx < (unsigned)kDim && lane == __ffs(peers) - 1) atomicAdd(hist + idx, sum);
}

// Bins item i of every lane (i < 0: none) into the warp's histogram; with
// a debug counter, counts the lanes' bad bins and bad weight sums into it.
template <class Source>
__device__ __forceinline__ void bin_lanes(const Source& src, const Frame& f, float r, float* hist,
                                          int* viol, int i) {
  int idx[5] = {-1, -1, -1, -1, -1};
  float wt[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  unsigned bad = 0u;
  if (i >= 0) src.bin(f, r, i, idx, wt, bad);
#pragma unroll
  for (int c = 0; c < 5; ++c) warp_add(hist, idx[c], wt[c]);
  if (viol != nullptr) {  // the same in every lane
    const unsigned bad_bin = __ballot_sync(kFull, bad & 1u);
    const unsigned bad_wt = __ballot_sync(kFull, bad & 2u);
    if ((threadIdx.x & 31) == 0 && (bad_bin | bad_wt)) {
      atomicAdd(viol, __popc(bad_bin));
      atomicAdd(viol + 1, __popc(bad_wt));
    }
  }
}

// One keypoint, one warp: its frame (the 9 row-major floats of frame_in, or,
// when frame_in is null, computed from the source's frame plane with radius
// r_frame and written to frame_out) and its histogram, added into `hist`
// (kDim floats of shared memory, zeroed by the caller, complete at return);
// `list` is 64 ints of shared memory; `viol` the debug counter or null.
// Returns the number of candidates listed (take), the same in every lane.
template <class Source>
__device__ __forceinline__ int keypoint_histogram(Source& src, float r, float r_frame,
                                                  const float* frame_in, float* frame_out,
                                                  float* hist, int* list, int* viol) {
  const int lane = threadIdx.x & 31;
  float frame[9];  // row-major rf, the same in every lane: columns x, y, z
  if (frame_in == nullptr) {
    float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float x[3] = {0.f, 0.f, 0.f}, z[3] = {0.f, 0.f, 0.f};
    src.covariance(s, r_frame);
    warp_allsum(s);
    frame_axes(s, x, z);
    float votes[4] = {0.f, 0.f, 0.f, 0.f};
    src.votes(x, z, votes);
    warp_allsum(votes);
    signed_frame(x, z, votes, s[7], frame);
    if (lane == 0)
      for (int i = 0; i < 9; ++i) frame_out[i] = frame[i];
  } else {
    for (int i = 0; i < 9; ++i) frame[i] = frame_in[i];
  }
  const Frame f(frame);
  __syncwarp();  // the histogram is zeroed

  // pass 3: list the candidates with 0 < d <= r as they stream, bin them 32
  // at a time
  const unsigned below = (1u << lane) - 1u;
  int n = 0;       // listed items not binned yet (the same in every lane)
  int listed = 0;
  typename Source::Cursor cursor = src.start();
  bool take[kUnroll];
  while (src.next(cursor, take)) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned ballot = __ballot_sync(kFull, take[u]);
      if (take[u]) list[n + __popc(ballot & below)] = src.item(cursor, u);
      n += __popc(ballot);
      listed += __popc(ballot);
      if (n >= 32) {
        __syncwarp();
        const int i = list[lane];
        const int carry = lane < n - 32 ? list[32 + lane] : 0;
        __syncwarp();
        if (lane < n - 32) list[lane] = carry;
        n -= 32;
        bin_lanes(src, f, r, hist, viol, i);
      }
    }
  }
  __syncwarp();
  if (n > 0) bin_lanes(src, f, r, hist, viol, lane < n ? list[lane] : -1);
  __syncwarp();
  return listed;
}

}  // namespace shot
