// The per-direction scan ladder shared by the port's openness kernels:
// openness_counts.cu (K1), openness_reduced.cu (K2),
// directional_extrema.cu (K3) and openness_counts_block.cu (K4).  Keeping
// it in one place means the kernels cannot drift apart; each inlines it,
// so the code is the same as if it were written out in every kernel.
//
// Replaces the TPU ladder neilpy_tpu/ops/pallas_scan.py:_extrema_ladder.
// For pixel p and direction d it keeps the running max mx and min mn over
// the ladder L_k of
//
//     ratio = (Z[p + d*L_k] - Z[p]) * scale[d][k],
//     scale[d][k] = f32(1 / (cellsize * w_d)) / f32(L_k)
//
// (a host table, ops/cuda_scan.py:_ladder_scales, so no division happens
// here and the product matches pallas_scan.py:166,173 bit for bit).  NaN
// reads (nodata holes) fail both compares and are skipped; the first step
// off the array ends the ladder, which skips the rest the way the TPU
// kernel's NaN pad does.  If the last ladder step p + d*Rmax leaves the
// raster, mx >= 0 and mn <= 0 are enforced (the reference's edge
// replication, pallas_scan.py:219-227).
//
// Two forms, chosen at compile time by the kernel: direction_extrema for a
// whole raster (K1, K2, K3), and direction_extrema_global for a shard block
// with its global origin (K4, K3's origin entry), where the array's edge
// and the raster's edge differ.
//
// Every multiply and add is written with __fmul_rn / __fadd_rn /
// __fsub_rn, which nvcc never fuses into an FMA; the build passes
// -fmad=false as well.

#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace neilpy_ladder {

// one thread per output pixel, in 32x8 blocks (the block shape moved the
// K1 time by under 1% on an H100: the ladder is instruction-issue bound)
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

// (row, col) offset per direction, as core/shift.py:OFFSETS
__host__ __device__ constexpr int dir_dr(int d) {
  return d <= 2 ? -1 : ((d == 3 || d == 7) ? 0 : 1);
}
__host__ __device__ constexpr int dir_dc(int d) {
  return (d == 0 || d == 6 || d == 7) ? -1 : ((d == 1 || d == 5) ? 0 : 1);
}

// The launch grid for an (H, W) raster; the wrappers keep H <= 8 * 65535.
inline dim3 grid_for(long long H, long long W) {
  return dim3((unsigned)((W + kBlockX - 1) / kBlockX),
              (unsigned)((H + kBlockY - 1) / kBlockY));
}

struct Pixel {
  int64_t p;         // r * W + c
  const float* zp;   // &Z[p]
  float core;        // Z[p]
  int up, down, left, right;  // steps left to each raster edge
};

__device__ __forceinline__ Pixel make_pixel(const float* __restrict__ Z,
                                            int64_t H, int64_t W, int64_t r,
                                            int64_t c) {
  Pixel px;
  px.p = r * W + c;
  px.zp = Z + px.p;
  px.core = __ldg(px.zp);
  // clamped so a huge raster cannot wrap
  px.up = (int)min(r, (int64_t)INT_MAX);
  px.down = (int)min(H - 1 - r, (int64_t)INT_MAX);
  px.left = (int)min(c, (int64_t)INT_MAX);
  px.right = (int)min(W - 1 - c, (int64_t)INT_MAX);
  return px;
}

// Steps from the pixel to the array's edge in direction d (a constant once
// the caller's direction loop is unrolled): the largest L whose read stays
// on the array.
__device__ __forceinline__ int edge_limit(const Pixel& px, int d) {
  const int dr = dir_dr(d);
  const int dc = dir_dc(d);
  return min(dr < 0 ? px.up : (dr > 0 ? px.down : INT_MAX),
             dc < 0 ? px.left : (dc > 0 ? px.right : INT_MAX));
}

// Running mx, mn of direction d over the ladder steps L <= lim.  One
// 32-bit step limit per direction replaces four 64-bit bounds tests per
// step: that cut K1's time by a third on an H100 (PERF.md, the K1 probe).
__device__ __forceinline__ void scan_ladder(
    const Pixel& px, int d, int64_t W, const int* __restrict__ ladder,
    const float* __restrict__ scales, int K, int lim, float& mx,
    float& mn) {
  const int64_t step = (int64_t)dir_dr(d) * W + dir_dc(d);
  mx = -CUDART_INF_F;
  mn = CUDART_INF_F;
  for (int k = 0; k < K; ++k) {
    const int L = __ldg(ladder + k);
    // the ladder increases, so the first step off the array ends it
    if (L > lim) break;
    const float src = __ldg(px.zp + step * L);
    const float ratio =
        __fmul_rn(__fsub_rn(src, px.core), __ldg(scales + d * K + k));
    if (ratio > mx) mx = ratio;
    if (ratio < mn) mn = ratio;
  }
}

// The edge-replication epilogue: an out-of-range last step contributes a
// ratio of exactly 0.
__device__ __forceinline__ void clamp_out_of_range(float& mx, float& mn) {
  mx = fmaxf(mx, 0.0f);
  mn = fminf(mn, 0.0f);
}

// mx, mn of direction d on a whole raster: the array is the raster, so one
// limit both ends the ladder and decides the epilogue (Rmax > lim means
// p + d*Rmax is off the raster).
__device__ __forceinline__ void direction_extrema(
    const Pixel& px, int d, int64_t W, const int* __restrict__ ladder,
    const float* __restrict__ scales, int K, int Rmax, float& mx,
    float& mn) {
  const int lim = edge_limit(px, d);
  scan_ladder(px, d, W, ladder, scales, K, lim, mx, mn);
  if (Rmax > lim) clamp_out_of_range(mx, mn);
}

// Where a pixel of a shard block lies in the global raster: its global
// (row, col) and the global shape (pallas_scan.py:429-432).
struct GlobalPos {
  int64_t r, c;
  int64_t H, W;
};

// mx, mn of direction d on a shard block: the ladder ends at the block's
// edge, so no read leaves the allocation (the block carries its neighbours'
// data in an R-wide halo, NaN beyond the raster, which the compares skip),
// and the epilogue tests p + d*Rmax against the GLOBAL raster, exactly as
// the XLA function's oob mask (neilpy_tpu/ops/visibility.py:140-144).
__device__ __forceinline__ void direction_extrema_global(
    const Pixel& px, const GlobalPos& g, int d, int64_t W,
    const int* __restrict__ ladder, const float* __restrict__ scales, int K,
    int Rmax, float& mx, float& mn) {
  scan_ladder(px, d, W, ladder, scales, K, edge_limit(px, d), mx, mn);
  const int64_t sr = g.r + (int64_t)dir_dr(d) * Rmax;
  const int64_t sc = g.c + (int64_t)dir_dc(d) * Rmax;
  if (sr < 0 || sr >= g.H || sc < 0 || sc >= g.W) clamp_out_of_range(mx, mn);
}

// The openness difference diff = atan(a) - atan(b), a = -mn, b = mx,
// against the threshold t, exactly in tangent space (T = tan t):
//   diff > t  <=>  (1 + ab > 0) ? (a - b) > T (1 + ab) : a > b
// as pallas_scan.py:449-475.  An unseen direction (mx = -inf) votes
// neither way.
__device__ __forceinline__ void classify(float mx, float mn, float T,
                                         bool& gt, bool& lt) {
  const float a = -mn;
  const float b = mx;
  const float denom = __fadd_rn(1.0f, __fmul_rn(a, b));
  const float s = __fsub_rn(a, b);
  const float td = __fmul_rn(T, denom);
  const bool wide = denom <= 0.0f;
  const bool narrow = denom > 0.0f;
  const bool seen = mx > -CUDART_INF_F;
  gt = ((wide && a > b) || (narrow && s > td)) && seen;
  lt = ((wide && a < b) || (narrow && s < -td)) && seen;
}

}  // namespace neilpy_ladder
