// SPFH per-neighbor stage shared by K4 (spfh_fused.cu) and K6 (spfh_runs.cu):
// the reference Darboux angles and numpy-histogramdd binning, and the
// warp's adds into a histogram of ints in shared memory.  The float32 order of every step is that of
// ops/descriptor_bins.py::darboux_angles and ops/histogram.py::bin_index
// (the sources are built -fmad=false, so each product rounds on its own as
// in the eager PyTorch twins): SPFH weights are 0/1, so any rounding
// difference would show as a whole count moved to another bin.
#pragma once

#include <math.h>

namespace spfh {

constexpr double kPiD = 3.14159265358979323846;

// Bin widths and the theta range, from the reference's double constants
// rounded once to float32 (bin_index takes width = (hi - lo) / n in Python
// float and applies it in float32).
struct Bins {
  int n;
  float width_unit;  // alpha and phi on [-1, 1]
  float width_theta;  // theta on [-pi/2, pi/2]
  float lo_theta, hi_theta;
  __device__ explicit Bins(int n_bins)
      : n(n_bins),
        width_unit((float)(2.0 / n_bins)),
        width_theta((float)(kPiD / n_bins)),
        lo_theta((float)(-kPiD / 2.0)),
        hi_theta((float)(kPiD / 2.0)) {}
};

// (alpha, phi, theta) of one neighbor: u = query normal, v = diff x u
// (unnormalized, as the reference), w = u x v.
__device__ __forceinline__ void darboux_angles(float dx, float dy, float dz, float nx,
                                               float ny, float nz, float ux, float uy,
                                               float uz, float d_safe, float* alpha,
                                               float* phi, float* theta) {
  const float vx = dy * uz - dz * uy;
  const float vy = dz * ux - dx * uz;
  const float vz = dx * uy - dy * ux;
  const float wx = uy * vz - uz * vy;
  const float wy = uz * vx - ux * vz;
  const float wz = ux * vy - uy * vx;
  *alpha = vx * nx + vy * ny + vz * nz;
  *phi = (dx * ux + dy * uy + dz * uz) / d_safe;
  *theta = atan2f(nx * wx + ny * wy + nz * wz, nx * ux + ny * uy + nz * uz);
}

// Left-inclusive uniform bin on [lo, hi], right edge folded into the last
// bin; `in` is false outside the range (and for NaN).
__device__ __forceinline__ int bin_index(float x, float lo, float hi, float width, int n,
                                         bool* in) {
  *in = x >= lo && x <= hi;
  const float raw = floorf((x - lo) / width);
  return (int)fminf(fmaxf(raw, 0.f), (float)(n - 1));
}

// The histogram slots of one valid neighbor (self excluded by the caller):
// joint, idx[0] = its n^3 bin (alpha major, theta minor) when all three
// angles are in range; decorrelated, one slot per in-range angle in the
// interleaved layout (bin k: alpha, phi, theta at 3k, 3k+1, 3k+2).  Slots
// that take no count are -1.
__device__ __forceinline__ void bin_slots(const Bins& b, bool decorrelated, float alpha,
                                          float phi, float theta, int (&idx)[3]) {
  bool a_in, p_in, t_in;
  const int a = bin_index(alpha, -1.f, 1.f, b.width_unit, b.n, &a_in);
  const int p = bin_index(phi, -1.f, 1.f, b.width_unit, b.n, &p_in);
  const int t = bin_index(theta, b.lo_theta, b.hi_theta, b.width_theta, b.n, &t_in);
  if (decorrelated) {
    idx[0] = a_in ? 3 * a : -1;
    idx[1] = p_in ? 3 * p + 1 : -1;
    idx[2] = t_in ? 3 * t + 2 : -1;
  } else {
    idx[0] = a_in && p_in && t_in ? (a * b.n + p) * b.n + t : -1;
    idx[1] = idx[2] = -1;
  }
}

// hist[idx] += 1 for every lane of the warp (all lanes call it; idx < 0
// adds nothing): the lanes with the same idx (__match_any_sync) add their
// number in one atomic by the lowest of them.
__device__ __forceinline__ void warp_count(int* hist, int idx) {
  const unsigned peers = __match_any_sync(0xffffffffu, idx);
  if (idx >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(hist + idx, __popc(peers));
}

__host__ __device__ __forceinline__ int out_dim(int n_bins, int decorrelated) {
  return decorrelated ? 3 * n_bins : n_bins * n_bins * n_bins;
}

}  // namespace spfh
