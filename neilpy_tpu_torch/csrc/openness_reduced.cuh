// K2's fold, shared by its dynamic kernel (openness_reduced.cu), K5's
// region plan (openness_reduced_plan.cu) and their tile kernels
// (openness_reduced_tile.cu): the scan ladder of ladder.cuh for d = 0..7,
// each direction's (mx, mn) folded in that order into register
// accumulators, so only the reduced planes reach memory.  The mode is a
// template parameter, so no pixel branches on it:
//
//   openness  pos += seen ? pi/2 - atanf(mx)  : +inf   (two f32 planes)
//             neg += seen ? pi/2 - atanf(-mn) : +inf
//   svf       t = max(mx, 0);  acc += t / sqrt(1 + t*t)  (one f32 plane)
//   ternary   code += digit_d * 3^d with digit_d = 1 + (O_d > t) -
//             (O_d < -t) decided exactly in tangent space: the
//             cross-multiplied compare of K1 (neg_mode, O = pos - neg) or
//             mx against -tan t / tan t (O = pos - 90).  Written as
//             uint16: the code is at most 6560.
//
// fold_direction is the one definition of that arithmetic: the per-thread
// body (reduced_pixel) and the tile's epilogue (ReducedOut) both call it,
// in the same order, so the two cannot drift apart.
//
// The maskless body may give +0 where the masked one kept -0 (ladder.cuh);
// atanf(+-0) = +-0 and pi/2 - (+-0) = pi/2, and the other modes only
// compare, so every mode is bit-identical between the routes.

#pragma once

#include "ladder.cuh"
#include "ladder_tile.cuh"

namespace neilpy_ladder {

enum Mode : int { kOpenness = 0, kSvf = 1, kTernary = 2 };

__host__ __device__ constexpr unsigned pow3(int d) {
  return d == 0 ? 1u : 3u * pow3(d - 1);
}

// Direction d's (mx, mn) folded into one pixel's accumulators: the
// openness sums s0 (pos) and s1 (neg), the svf sum s0, or the ternary code
// tc, whose digit for d weighs w3 = 3^d.  Only the mode's accumulators are
// touched.
template <int kMode, bool kNegMode>
__device__ __forceinline__ void fold_direction(float mx, float mn, float T,
                                               unsigned w3, float& s0,
                                               float& s1, unsigned& tc) {
  const bool seen = mx > -CUDART_INF_F;
  if constexpr (kMode == kOpenness) {
    s0 = __fadd_rn(s0, seen ? __fsub_rn(CUDART_PIO2_F, atanf(mx))
                            : CUDART_INF_F);
    s1 = __fadd_rn(s1, seen ? __fsub_rn(CUDART_PIO2_F, atanf(-mn))
                            : CUDART_INF_F);
  } else if constexpr (kMode == kSvf) {
    // also absorbs unseen (mx = -inf)
    const float t = fmaxf(mx, 0.0f);
    s0 = __fadd_rn(
        s0, __fdiv_rn(t, __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(t, t)))));
  } else {
    bool gt, lt;
    if constexpr (kNegMode) {
      classify(mx, mn, T, gt, lt);
    } else {
      // O = pos - 90 = -atan(mx) deg: O > t <=> mx < -tan t; an unseen
      // direction has pos = +inf, digit 2 (as the XLA path)
      gt = (mx < -T) || !seen;
      lt = seen && (mx > T);
    }
    tc += (unsigned)(1 + (gt ? 1 : 0) - (lt ? 1 : 0)) * w3;
  }
}

template <int kMode, bool kNegMode, bool kDense, class Route>
__device__ __forceinline__ void reduced_pixel(
    const Pixel& px, int64_t W, const int* __restrict__ ladder,
    const float* __restrict__ scales, int K, int Rmax, float T, Route route,
    float* __restrict__ out0, float* __restrict__ out1,
    uint16_t* __restrict__ code) {
  float acc0 = 0.0f;
  float acc1 = 0.0f;
  unsigned tc = 0;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    float mx, mn;
    direction_extrema_routed<kDense>(px, d, W, ladder, scales, K, Rmax,
                                     route, mx, mn);
    fold_direction<kMode, kNegMode>(mx, mn, T, pow3(d), acc0, acc1, tc);
  }
  if constexpr (kMode == kTernary) {
    code[px.p] = (uint16_t)tc;
  } else {
    out0[px.p] = acc0;
    if constexpr (kMode == kOpenness) out1[px.p] = acc1;
  }
}

// The tile's third epilogue (ladder_tile.cuh, beside CountsOut and
// PlanesOut): each direction folded into the thread's kTileRows x
// kTileCols pixels as it ends, the reduced planes stored after the eighth
// at grid pixel (r, c) -> r * pitch + c, a warp writing 32 consecutive
// values.  The tile kernel's direction loop is not unrolled (one copy of
// this epilogue, not eight), so d is a run-time value there and the
// ternary digit's weight 3^d is carried as a running factor.
template <int kMode, bool kNegMode>
struct ReducedOut {
  float T;
  float* out0;
  float* out1;
  uint16_t* code;
  int64_t pitch;
  struct Acc {
    float s0[kTileRows][kTileCols];
    float s1[kTileRows][kTileCols];
    unsigned tc[kTileRows][kTileCols];
    unsigned w3 = 1;  // 3^d of the direction being folded
  };

  __device__ __forceinline__ void direction(
      Acc& acc, int, const float (&mx)[kTileRows][kTileCols],
      const float (&mn)[kTileRows][kTileCols], int64_t, int64_t) const {
#pragma unroll
    for (int i = 0; i < kTileRows; ++i)
#pragma unroll
      for (int j = 0; j < kTileCols; ++j)
        fold_direction<kMode, kNegMode>(mx[i][j], mn[i][j], T, acc.w3,
                                        acc.s0[i][j], acc.s1[i][j],
                                        acc.tc[i][j]);
    acc.w3 *= 3u;
  }

  __device__ __forceinline__ void finish(const Acc& acc, int64_t r,
                                         int64_t c) const {
#pragma unroll
    for (int i = 0; i < kTileRows; ++i)
#pragma unroll
      for (int j = 0; j < kTileCols; ++j) {
        const int64_t p = (r + i * kBlockY) * pitch + c + j * kBlockX;
        if constexpr (kMode == kTernary) {
          code[p] = (uint16_t)acc.tc[i][j];
        } else {
          out0[p] = acc.s0[i][j];
          if constexpr (kMode == kOpenness) out1[p] = acc.s1[i][j];
        }
      }
  }
};

// The tile kernels of K2 and K5/reduced (openness_reduced_tile.cu, which
// instantiates the four mode variants once for both): launch_tiles with
// ReducedOut<kMode, kNegMode> on the whole raster Z, over tiles
// [ty0, ty1) x [tx0, tx1) in halo bucket ``halo`` (0, or an empty
// rectangle: no tile); returns a CUDA error code.
template <int kMode, bool kNegMode>
int reduced_tiles(const float* Z, long long H, long long W, const int* ladder,
                  const float* scales, int K, int Rmax, int halo, int ty0,
                  int ty1, int tx0, int tx1, int tma, float T, float* out0,
                  float* out1, uint16_t* code, cudaStream_t stream);

// Call launch<kMode, kNegMode, kDense>(args...) for the run-time mode,
// neg_mode and dense flags of a C entry; an unknown mode is
// cudaErrorInvalidValue.
template <template <int, bool, bool> class Launch, class... Args>
int dispatch_mode(int mode, int neg_mode, int dense, Args... args) {
  switch (mode) {
    case kOpenness:
      return dense ? Launch<kOpenness, false, true>::run(args...)
                   : Launch<kOpenness, false, false>::run(args...);
    case kSvf:
      return dense ? Launch<kSvf, false, true>::run(args...)
                   : Launch<kSvf, false, false>::run(args...);
    case kTernary:
      if (neg_mode)
        return dense ? Launch<kTernary, true, true>::run(args...)
                     : Launch<kTernary, true, false>::run(args...);
      return dense ? Launch<kTernary, false, true>::run(args...)
                   : Launch<kTernary, false, false>::run(args...);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace neilpy_ladder
