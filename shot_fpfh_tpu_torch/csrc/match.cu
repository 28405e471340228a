// K2: descriptor distance product with a fused top-2 reduction.
//
// Replaces the TPU kernel shot_fpfh_tpu/ops/pallas_match.py::top2_matmul_pallas
// (_kernel), which does one MXU dot per (1024, 4096) tile and keeps the
// per-row (i1, d1², d2²) carry in VMEM.
//
// Grid: (row blocks of 128 rows of `a`) x (column splits of `b`).  A split
// is a run of whole 128-column tiles of `b` (split s takes tiles
// [s·T/S, (s+1)·T/S)), so the grid fills the card even when n alone gives
// under one wave.  Each block sweeps its split's tiles and keeps, per row, a
// running top-2 of the squared distances (‖a‖² + ‖b‖²) − 2 a·b in registers.
// A prep kernel first rounds both operands to the product's type, pads their
// features with zeros to the K step and takes the squared norms of the
// rounded rows; an invalid ref, and the padding up to a whole tile, get
// ‖b‖² = +inf, so their distances are +inf.  Each thread
// scans its columns in increasing index with a strict `<`, so the lower
// index wins ties and a tie with the best goes into d2; the lanes that share
// a row merge with merge_top2's index rule.  Each (row block, split) writes a
// partial (i1, d1, d2); top2_merge_kernel merges the partials in split order
// with the same rule.  No distance tile ever reaches device memory.
//
// bf16 mode: two warpgroups, each owning 64 rows, run wgmma.m64n128k16 (f32
// accumulators in registers) on a 3-stage ring of 64-feature slabs of both
// tiles that cp.async fills ahead of the product.  A slab row is 128 bytes
// (64 features) in the 128-byte swizzle the shared-memory descriptors name:
// 16-byte chunk c of row r sits at chunk c ^ (r % 8), so neither the copies
// nor the tensor cores' reads collide on banks.  The top-2 runs on the
// accumulator fragments.
// f32 mode (full float32, as JAX's Precision.HIGHEST): the same grid and
// merge on the CUDA cores, 8x8 outputs a thread from float4 shared loads.
//
// Bound on the H100: operations.  2·n·m·D on the tensor cores (bf16) or the
// CUDA cores (f32); the operands are read a few times from L2 and the output
// is 12 bytes a row.  The design keeps the tensor cores fed from shared
// memory and the card full of blocks; the epilogue costs a few instructions
// per distance beside 2·D multiply-adds.
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBM = 128;        // rows of a per block
constexpr int kBN = 128;        // rows of b per tile
constexpr int kThreads = 256;
// bf16: features per pipeline stage, stages in the ring
constexpr int kBK = 64;
constexpr int kStages = 3;
constexpr int kSlabBytes = kBM * kBK * 2;           // 16 KB, one tile's slab
constexpr int kStageBytes = 2 * kSlabBytes;         // a's and b's slabs
constexpr int kSmemBytes = kStages * kStageBytes + 1024;   // 96 KB + alignment
// f32: features per step
constexpr int kFK = 8;

// (d1, i1, d2) of the union of two disjoint column sets: the smaller d1
// wins, the lower index on equal d1; d2 is the second of the merged four.
__device__ __forceinline__ void merge_top2(float& d1, int& i1, float& d2,
                                           float od1, int oi1, float od2) {
  const bool take = od1 < d1 || (od1 == d1 && oi1 < i1);
  const float nd2 = fminf(fmaxf(d1, od1), fminf(d2, od2));
  if (take) {
    d1 = od1;
    i1 = oi1;
  }
  d2 = nd2;
}

// candidate `col` (columns arrive in increasing index) into a running
// top-2: its squared distance max((‖a‖² + ‖b‖²) − 2·dot, 0) from s = ‖a‖² +
// ‖b‖².  2·dot is exact, so the fused s − 2·dot rounds once, as the twin's
// subtraction does; most candidates stop at the first comparison (the clamp
// cannot bring a value at or above d2 under it).
__device__ __forceinline__ void push_top2(float& d1, int& i1, float& d2, float s, float dot,
                                          int col) {
  const float x = fmaf(-2.f, dot, s);
  if (x < d2) {
    const float d = fmaxf(x, 0.f);
    if (d < d1) {
      d2 = d1;
      d1 = d;
      i1 = col;
    } else if (d < d2) {
      d2 = d;
    }
  }
}

// the tile range of column split `split` of `splits` over T tiles
__device__ __forceinline__ void split_tiles(int m, int splits, int split, int& t0, int& t1) {
  const long long tiles = (m + kBN - 1) / kBN;
  t0 = static_cast<int>(tiles * split / splits);
  t1 = static_cast<int>(tiles * (split + 1) / splits);
}

// ---- bf16: wgmma on a cp.async ring -------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills zeros (rows past the edge)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor, K-major, 128-byte swizzle: rows of 128
// bytes, 8-row atoms of 1024 bytes (the stride between 8-row groups, SBO);
// the leading offset is unused in this mode (1).  A k16 step starts 32 bytes
// further into the rows.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64x128, f32) = [D +] A (64x16, smem) · B (128x16, smem)^T
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// one 128-row x 64-feature slab, swizzled: 8 consecutive threads copy one
// row's 128 bytes; chunk c of row r lands at r·128 + 16·(c ^ (r % 8))
__device__ __forceinline__ void load_slab(uint32_t dst, const __nv_bfloat16* src, int row0,
                                          int rows, int dim, int k0) {
#pragma unroll
  for (int it = 0; it < kBM * kBK / 8 / kThreads; ++it) {
    const int q = it * kThreads + threadIdx.x;
    const int row = q >> 3;
    const int c = q & 7;
    const bool ok = row0 + row < rows;
    const long long at = ok ? static_cast<long long>(row0 + row) * dim + k0 + c * 8 : 0;
    const __nv_bfloat16* p = src + at;
    cp_async16(dst + row * 128 + ((c ^ (row & 7)) << 4), p, ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
top2_wgmma_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
                  const float* __restrict__ an, const float* __restrict__ bn,
                  int* __restrict__ part_i, float* __restrict__ part_d1,
                  float* __restrict__ part_d2, int n, int m, int dim, int splits) {
  extern __shared__ __align__(128) unsigned char smem[];
  // swizzle atoms are 1024-byte aligned
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;
  const int row0 = blockIdx.x * kBM;
  const int split = blockIdx.y;
  int t0, t1;
  split_tiles(m, splits, split, t0, t1);
  const int k_steps = dim / kBK;
  const int total = (t1 - t0) * k_steps;

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  // this thread's two rows of its warpgroup's 64 (the wgmma D layout)
  float an_r[2], best1[2], best2[2];
  int idx1[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * i;
    an_r[i] = row < n ? an[row] : 0.f;
    best1[i] = best2[i] = INFINITY;
    idx1[i] = 0;
  }

  auto load_step = [&](int step) {
    const uint32_t stage = base + (step % kStages) * kStageBytes;
    const int tile = t0 + step / k_steps;
    const int k0 = (step % k_steps) * kBK;
    load_slab(stage, a, row0, n, dim, k0);
    load_slab(stage + kSlabBytes, b, tile * kBN, m, dim, k0);
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load_step(s);
    cp_async_commit();
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int step = 0; step < total; ++step) {
    cp_async_wait<kStages - 2>();
    // the copies were made through the generic proxy; wgmma reads through
    // the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    // refill the stage consumed one step ago (its wgmmas have completed)
    if (step + kStages - 1 < total) load_step(step + kStages - 1);
    cp_async_commit();

    const int kt = step % k_steps;
    const uint32_t stage = base + (step % kStages) * kStageBytes;
    const uint32_t sa = stage + wg * 64 * 128;
    const uint32_t sb = stage + kSlabBytes;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wgmma_m64n128k16(acc, smem_desc(sa + kk * 32), smem_desc(sb + kk * 32), kt > 0 || kk > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);

    if (kt == k_steps - 1) {
      // epilogue on the fragments: register 4j + 2i + e holds row i's
      // column 8j + 2(lane % 4) + e of the tile; j, then e, ascending
      const int col_base = (t0 + step / k_steps) * kBN + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const float2 bnv = __ldg(reinterpret_cast<const float2*>(bn + col_base + 8 * j));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col_base + 8 * j + e;
          const float bne = e ? bnv.y : bnv.x;
#pragma unroll
          for (int i = 0; i < 2; ++i)
            push_top2(best1[i], idx1[i], best2[i], an_r[i] + bne, acc[4 * j + 2 * i + e], col);
        }
      }
    }
  }
  cp_async_wait<0>();

  // the four lanes of a quad share their rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float od1 = __shfl_xor_sync(0xffffffffu, best1[i], off);
      const int oi1 = __shfl_xor_sync(0xffffffffu, idx1[i], off);
      const float od2 = __shfl_xor_sync(0xffffffffu, best2[i], off);
      merge_top2(best1[i], idx1[i], best2[i], od1, oi1, od2);
    }
    const int row = row0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * i;
    if ((lane & 3) == 0 && row < n) {
      const long long at = static_cast<long long>(split) * n + row;
      part_i[at] = idx1[i];
      part_d1[at] = best1[i];
      part_d2[at] = best2[i];
    }
  }
}

// ---- f32: register-blocked FFMA ----------------------------------------

// thread (ty, tx) of 16 x 16 owns rows ty·4 + {0..3} and 64 + ty·4 + {0..3},
// columns tx·4 + {0..3} and 64 + tx·4 + {0..3} of the 128 x 128 tile
__device__ __forceinline__ int own_offset(int i, int t) { return (i >> 2) * 64 + t * 4 + (i & 3); }

__global__ void __launch_bounds__(kThreads)
top2_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ an, const float* __restrict__ bn,
                int* __restrict__ part_i, float* __restrict__ part_d1,
                float* __restrict__ part_d2, int n, int m, int dim, int splits) {
  __shared__ __align__(16) float as[2][kFK][kBM];
  __shared__ __align__(16) float bs[2][kFK][kBN];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int row0 = blockIdx.x * kBM;
  const int split = blockIdx.y;
  int t0, t1;
  split_tiles(m, splits, split, t0, t1);
  const int k_steps = dim / kFK;
  // staging: thread t moves features lk .. lk+3 of tile row lrow
  const int lrow = threadIdx.x >> 1;
  const int lk = (threadIdx.x & 1) * 4;
  const bool a_ok = row0 + lrow < n;
  const float* a_src = a + (a_ok ? static_cast<long long>(row0 + lrow) * dim + lk : 0);

  float best1[8], best2[8];
  int idx1[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best1[i] = best2[i] = INFINITY;
    idx1[i] = 0;
  }

  for (int tile = t0; tile < t1; ++tile) {
    const int col0 = tile * kBN;
    const bool b_ok = col0 + lrow < m;
    const float* b_src = b + (b_ok ? static_cast<long long>(col0 + lrow) * dim + lk : 0);
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 va = a_ok ? *reinterpret_cast<const float4*>(a_src) : zero;
    float4 vb = b_ok ? *reinterpret_cast<const float4*>(b_src) : zero;
    auto stage = [&](int buf) {
      as[buf][lk][lrow] = va.x;
      as[buf][lk + 1][lrow] = va.y;
      as[buf][lk + 2][lrow] = va.z;
      as[buf][lk + 3][lrow] = va.w;
      bs[buf][lk][lrow] = vb.x;
      bs[buf][lk + 1][lrow] = vb.y;
      bs[buf][lk + 2][lrow] = vb.z;
      bs[buf][lk + 3][lrow] = vb.w;
    };
    stage(0);
    __syncthreads();

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int kt = 0; kt < k_steps; ++kt) {
      const int buf = kt & 1;
      const bool more = kt + 1 < k_steps;
      if (more) {
        const int k1 = (kt + 1) * kFK;
        va = a_ok ? *reinterpret_cast<const float4*>(a_src + k1) : zero;
        vb = b_ok ? *reinterpret_cast<const float4*>(b_src + k1) : zero;
      }
#pragma unroll
      for (int k = 0; k < kFK; ++k) {
        float av[8], bv[8];
        const float4 a0 = *reinterpret_cast<const float4*>(&as[buf][k][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&as[buf][k][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&bs[buf][k][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&bs[buf][k][64 + tx * 4]);
        av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
        av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
        bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
        bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      if (more) stage(buf ^ 1);
      __syncthreads();
    }

    // epilogue: columns in increasing index (tx·4 + j, then 64 + tx·4 + j)
    float an_r[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + own_offset(i, ty);
      an_r[i] = row < n ? __ldg(an + row) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + own_offset(j, tx);
      const float bnv = __ldg(bn + col);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        push_top2(best1[i], idx1[i], best2[i], an_r[i] + bnv, acc[i][j], col);
    }
  }

  // the 16 lanes of a half-warp share their rows
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      const float od1 = __shfl_xor_sync(0xffffffffu, best1[i], off);
      const int oi1 = __shfl_xor_sync(0xffffffffu, idx1[i], off);
      const float od2 = __shfl_xor_sync(0xffffffffu, best2[i], off);
      merge_top2(best1[i], idx1[i], best2[i], od1, oi1, od2);
    }
    const int row = row0 + own_offset(i, ty);
    if (tx == 0 && row < n) {
      const long long at = static_cast<long long>(split) * n + row;
      part_i[at] = idx1[i];
      part_d1[at] = best1[i];
      part_d2[at] = best2[i];
    }
  }
}

// The operands as the product sees them, one warp a row: row r of x
// (f32, `dim` wide) rounded to T and zero-padded to `width` columns, and its
// squared norm from the rounded values (+inf where valid[r] is 0, and for
// the rows from `rows` up to `rows_padded`, which get no data row).
template <typename T>
__global__ void top2_prep_kernel(const float* __restrict__ x,
                                 const unsigned char* __restrict__ valid, int rows,
                                 int rows_padded, int dim, int width, T* __restrict__ out,
                                 float* __restrict__ norms) {
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows_padded) return;  // whole warps exit together
  if (r >= rows) {
    if (lane == 0) norms[r] = INFINITY;
    return;
  }
  float sq = 0.f;
  for (int k = lane; k < width; k += 32) {
    const float v = k < dim ? x[static_cast<long long>(r) * dim + k] : 0.f;
    T t;
    float rv;
    if constexpr (sizeof(T) == 2) {
      t = __float2bfloat16(v);
      rv = __bfloat162float(t);
    } else {
      t = v;
      rv = v;
    }
    out[static_cast<long long>(r) * width + k] = t;
    sq += rv * rv;
  }
  sq = warp_sum(sq);
  if (lane == 0) norms[r] = (valid == nullptr || valid[r]) ? sq : INFINITY;
}

// the splits' partials of each row, merged in split order
__global__ void top2_merge_kernel(const int* __restrict__ part_i,
                                  const float* __restrict__ part_d1,
                                  const float* __restrict__ part_d2, int n, int splits,
                                  long long* __restrict__ i1_out, float* __restrict__ d1_out,
                                  float* __restrict__ d2_out) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float d1 = INFINITY, d2 = INFINITY;
  int i1 = 0;
  for (int s = 0; s < splits; ++s) {
    const long long at = static_cast<long long>(s) * n + row;
    merge_top2(d1, i1, d2, part_d1[at], part_i[at], part_d2[at]);
  }
  i1_out[row] = i1;
  d1_out[row] = d1;
  d2_out[row] = d2;
}

// both operands through top2_prep_kernel: `ops` gets a's n rows, then b's
// m; `norms` b's, padded to whole tiles (so the epilogue's float2 loads are
// aligned), then a's
template <typename T>
T* prep_operands(const float* a, const float* b, const unsigned char* b_valid, void* ops,
                 float* norms, int n, int m, int dim, int width, cudaStream_t stream) {
  T* ac = static_cast<T*>(ops);
  const int m_padded = (m + kBN - 1) / kBN * kBN;
  if (m_padded > 0)
    top2_prep_kernel<<<(m_padded + 7) / 8, 256, 0, stream>>>(
        b, b_valid, m, m_padded, dim, width, ac + static_cast<long long>(n) * width, norms);
  top2_prep_kernel<<<(n + 7) / 8, 256, 0, stream>>>(a, nullptr, n, n, dim, width, ac,
                                                    norms + m_padded);
  return ac;
}

}  // namespace

// a (n, dim), b (m, dim): f32, rows contiguous; b_valid (m,) bytes.  The
// scratch holds the padded operands ((n + m) x width of bf16 (use_bf16) or
// f32, width a multiple of 64 or 8), the norms (ceil(m / 128) · 128 + n) and
// the splits' partials (splits x n each).
SHOT_EXPORT int top2_match(const float* a, const float* b, const unsigned char* b_valid,
                           void* ops, float* norms, int* part_i, float* part_d1,
                           float* part_d2, long long* i1, float* d1, float* d2, int n, int m,
                           int dim, int width, int splits, int use_bf16, cudaStream_t stream) {
  if (n <= 0) return 0;
  const dim3 grid((n + kBM - 1) / kBM, splits);
  const long long b_at = static_cast<long long>(n) * width;
  const float* bn = norms;
  const float* an = norms + (m + kBN - 1) / kBN * kBN;
  if (use_bf16) {
    const cudaError_t err = cudaFuncSetAttribute(
        top2_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const __nv_bfloat16* ac =
        prep_operands<__nv_bfloat16>(a, b, b_valid, ops, norms, n, m, dim, width, stream);
    top2_wgmma_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
        ac, ac + b_at, an, bn, part_i, part_d1, part_d2, n, m, width, splits);
  } else {
    const float* ac = prep_operands<float>(a, b, b_valid, ops, norms, n, m, dim, width, stream);
    top2_f32_kernel<<<grid, kThreads, 0, stream>>>(ac, ac + b_at, an, bn, part_i, part_d1,
                                                   part_d2, n, m, width, splits);
  }
  const int err = last_launch_error();
  if (err != 0) return err;
  top2_merge_kernel<<<(n + 255) / 256, 256, 0, stream>>>(part_i, part_d1, part_d2, n, splits,
                                                          i1, d1, d2);
  return last_launch_error();
}
