// The per-direction scan ladder shared by the port's openness kernels:
// openness_counts.cu (K1), openness_reduced.cu (K2),
// directional_extrema.cu (K3), openness_counts_block.cu (K4) and the
// static region plan (K5: openness_counts_plan.cu, openness_reduced_plan.cu).
// Keeping it in one place means the kernels cannot drift apart; each
// inlines it, so the code is the same as if it were written out in every
// kernel.
//
// Replaces the TPU ladder neilpy_tpu/ops/pallas_scan.py:_extrema_ladder.
// For pixel p and direction d it keeps the running max mx and min mn over
// the ladder L_k of
//
//     ratio = (Z[p + d*L_k] - Z[p]) * scale[d][k],
//     scale[d][k] = f32(1 / (cellsize * w_d)) / f32(L_k)
//
// (a host table, ops/cuda_scan.py:_ladder_scales, so no division happens
// here and the product matches pallas_scan.py:166,173 bit for bit).
//
// Two bodies, as _extrema_ladder(nan_safe=False / True):
//
// - the masked ladder (scan_ladder + an epilogue): NaN reads (nodata
//   holes) fail both compares and are skipped; the first step off the
//   array ends the ladder, which skips the rest the way the TPU kernel's
//   NaN pad does; if the last step p + d*Rmax leaves the raster, mx >= 0
//   and mn <= 0 are enforced (the reference's edge replication,
//   pallas_scan.py:219-227).  Valid everywhere.
// - the maskless ladder (scan_ladder_safe, pallas_scan.py:173-176): for a
//   (thread block, direction) pair whose every read lies on the array and
//   whose last step stays on the raster.  It has no step limit, no break
//   and no epilogue; on the dense exact ladder (L_k = k + 1) it loads no
//   ladder entry; and it keeps the extrema with fmaxf / fminf instead of
//   two compare-selects.  fmaxf / fminf return the other operand when one
//   is NaN, so a NaN read (a nodata hole) is skipped exactly as the
//   compare-selects skip it, and the running extrema never become NaN:
//   unlike the TPU kernel, whose maskless body uses a NaN-propagating
//   maximum and so needs a per-tile NaN grid (pallas_scan.py:258), this
//   one needs no NaN test at all.  fmaxf may return +0 where the
//   compare-select kept -0 (a ratio of -0 against +0), so K3's mx / mn
//   planes equal the masked body's by value, not always by bit; K1, K2
//   and K4 only compare or add the extrema and are bit-identical.
//
// Which body a pair takes is decided per 32x8 thread block, so it is
// uniform across the block and no warp diverges (the counterpart of
// _dir_is_safe, pallas_scan.py:231-255): window_on tests the block's read
// window in direction d up to Rmax against the array and, for a shard
// block, the global raster.  Routes: DynamicRoute carries the safe
// directions as a run-time bit mask (K1-K4), StaticRoute<kUnsafe> as a
// compile-time one (K5's regions), so its masked/maskless choice folds
// away.  A direction takes the maskless body wherever its route says it is
// safe, and the masked body everywhere else.
//
// Two forms of the masked body, chosen at compile time by the kernel:
// direction_extrema for a whole raster (K1, K2, K3, K5), and
// direction_extrema_global for a shard block with its global origin (K4,
// K3's origin entry), where the array's edge and the raster's edge differ.
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

// ----------------------------------------------------------------------
// the maskless ladder and its block-uniform routing
// ----------------------------------------------------------------------

// Running mx, mn of direction d over every ladder step, for a pair that
// window_on proved safe: every read lies on the array (a NaN read is
// skipped by fmaxf / fminf, as by the masked body's compares).  kDense:
// the ladder is 1..K, so L = k + 1 and no entry is loaded.
template <bool kDense>
__device__ __forceinline__ void scan_ladder_safe(
    const Pixel& px, int d, int64_t W, const int* __restrict__ ladder,
    const float* __restrict__ scales, int K, float& mx, float& mn) {
  const int64_t step = (int64_t)dir_dr(d) * W + dir_dc(d);
  mx = -CUDART_INF_F;
  mn = CUDART_INF_F;
  // pointers that advance by one entry, so no 64-bit index arithmetic per
  // step (the first build spent about half of the step's 12 SASS
  // instructions on the addresses of Z[p + d*L] and scale[d][k])
  const float* __restrict__ q = px.zp;
  const float* __restrict__ sc = scales + d * K;
  for (int k = 0; k < K; ++k, ++sc) {
    if constexpr (kDense) {
      q += step;
    } else {
      q = px.zp + step * __ldg(ladder + k);
    }
    const float src = __ldg(q);
    const float ratio = __fmul_rn(__fsub_rn(src, px.core), __ldg(sc));
    mx = fmaxf(mx, ratio);
    mn = fminf(mn, ratio);
  }
}

// Does the read window of the thread block whose first pixel is (r0, c0)
// stay inside [0, H) x [0, W) in direction d, for every step up to Rmax?
// The window is the whole 32x8 block shifted by d*1 .. d*Rmax, as
// _dir_is_safe takes the whole tile: a block that overhangs the array is
// unsafe in every direction.
__device__ __forceinline__ bool window_on(int64_t r0, int64_t c0, int d,
                                          int Rmax, int64_t H, int64_t W) {
  const int64_t dr = (int64_t)dir_dr(d) * Rmax;
  const int64_t dc = (int64_t)dir_dc(d) * Rmax;
  return r0 + (dr < 0 ? dr : 0) >= 0 &&
         r0 + kBlockY + (dr > 0 ? dr : 0) <= H &&
         c0 + (dc < 0 ? dc : 0) >= 0 &&
         c0 + kBlockX + (dc > 0 ? dc : 0) <= W;
}

// Bit d set: direction d is safe for the thread block whose first pixel is
// (r0, c0) on a whole raster (H, W).  Block-uniform.
__device__ __forceinline__ unsigned safe_directions_at(int Rmax, int64_t H,
                                                       int64_t W, int64_t r0,
                                                       int64_t c0) {
  unsigned safe = 0u;
#pragma unroll
  for (int d = 0; d < 8; ++d)
    safe |= window_on(r0, c0, d, Rmax, H, W) ? (1u << d) : 0u;
  return safe;
}

// The same for a shard block whose first pixel is (r0, c0) of the array:
// the window must lie on the (H, W) array and, shifted by the array's
// global origin (org_r, org_c) of its pixel (0, 0), inside the (GH, GW)
// raster, so the last step needs no epilogue.
__device__ __forceinline__ unsigned safe_directions_global_at(
    int Rmax, int64_t H, int64_t W, int64_t r0, int64_t c0, int64_t org_r,
    int64_t org_c, int64_t GH, int64_t GW) {
  unsigned safe = 0u;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    const bool ok = window_on(r0, c0, d, Rmax, H, W) &&
                    window_on(org_r + r0, org_c + c0, d, Rmax, GH, GW);
    safe |= ok ? (1u << d) : 0u;
  }
  return safe;
}

// A route says, per direction, which body runs.
struct DynamicRoute {
  unsigned safe;  // bit d: direction d takes the maskless body
  __device__ __forceinline__ bool operator()(int d) const {
    return (safe >> d) & 1u;
  }
};

template <unsigned kUnsafe>
struct StaticRoute {
  __device__ __forceinline__ constexpr bool operator()(int d) const {
    return !((kUnsafe >> d) & 1u);
  }
};

// mx, mn of direction d on a whole raster, by the route's body.
template <bool kDense, class Route>
__device__ __forceinline__ void direction_extrema_routed(
    const Pixel& px, int d, int64_t W, const int* __restrict__ ladder,
    const float* __restrict__ scales, int K, int Rmax, Route route,
    float& mx, float& mn) {
  if (route(d)) {
    scan_ladder_safe<kDense>(px, d, W, ladder, scales, K, mx, mn);
  } else {
    direction_extrema(px, d, W, ladder, scales, K, Rmax, mx, mn);
  }
}

// mx, mn of direction d on a shard block, by the route's body.
template <bool kDense, class Route>
__device__ __forceinline__ void direction_extrema_global_routed(
    const Pixel& px, const GlobalPos& g, int d, int64_t W,
    const int* __restrict__ ladder, const float* __restrict__ scales, int K,
    int Rmax, Route route, float& mx, float& mn) {
  if (route(d)) {
    scan_ladder_safe<kDense>(px, d, W, ladder, scales, K, mx, mn);
  } else {
    direction_extrema_global(px, g, d, W, ladder, scales, K, Rmax, mx, mn);
  }
}

// K5's region plan for one axis (ops/cuda_scan.py:region_plan): blocks
// starting before lo_end form the low strip, from hi_start on the high
// strip, the rest the interior; masks packs the three segments' unsafe
// directions, one byte each.
__device__ __forceinline__ unsigned segment_unsafe(int64_t start,
                                                   int64_t lo_end,
                                                   int64_t hi_start,
                                                   unsigned masks) {
  const int seg = start < lo_end ? 0 : (start < hi_start ? 1 : 2);
  return (masks >> (8 * seg)) & 0xFFu;
}

// Call body(StaticRoute<M>{}) for the block's unsafe set M, one of the
// ten the plan makes: the 3x3 regions (row strip {0,1,2} or {4,5,6},
// column strip {0,6,7} or {2,3,4}, their unions, none) and all eight.
// The switch is block-uniform; anything else takes the all-masked body.
template <class Body>
__device__ __forceinline__ void with_static_route(unsigned unsafe,
                                                  Body&& body) {
  switch (unsafe) {
    case 0x00u: body(StaticRoute<0x00u>{}); break;
    case 0x07u: body(StaticRoute<0x07u>{}); break;
    case 0x70u: body(StaticRoute<0x70u>{}); break;
    case 0xC1u: body(StaticRoute<0xC1u>{}); break;
    case 0x1Cu: body(StaticRoute<0x1Cu>{}); break;
    case 0xC7u: body(StaticRoute<0xC7u>{}); break;
    case 0x1Fu: body(StaticRoute<0x1Fu>{}); break;
    case 0xF1u: body(StaticRoute<0xF1u>{}); break;
    case 0x7Cu: body(StaticRoute<0x7Cu>{}); break;
    default: body(StaticRoute<0xFFu>{}); break;
  }
}

// The unsafe set of the thread block whose first pixel is (r0, c0) under
// K5's plan: the union of its row and column segments' sets.
__device__ __forceinline__ unsigned plan_unsafe_at(
    int64_t r0, int64_t c0, int64_t rlo, int64_t rhi, unsigned rmasks,
    int64_t clo, int64_t chi, unsigned cmasks) {
  return segment_unsafe(r0, rlo, rhi, rmasks) |
         segment_unsafe(c0, clo, chi, cmasks);
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
