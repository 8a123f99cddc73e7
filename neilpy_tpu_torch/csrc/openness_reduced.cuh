// K2's per-pixel body, shared by its dynamic kernel (openness_reduced.cu)
// and K5's region plan (openness_reduced_plan.cu): the scan ladder of
// ladder.cuh for d = 0..7, by the body the route picks, each direction's
// (mx, mn) folded in that order into register accumulators, so only the
// reduced planes reach memory.  The mode is a template parameter, so no
// pixel branches on it:
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
// The maskless body may give +0 where the masked one kept -0 (ladder.cuh);
// atanf(+-0) = +-0 and pi/2 - (+-0) = pi/2, and the other modes only
// compare, so every mode is bit-identical between the routes.

#pragma once

#include "ladder.cuh"

namespace neilpy_ladder {

enum Mode : int { kOpenness = 0, kSvf = 1, kTernary = 2 };

__host__ __device__ constexpr unsigned pow3(int d) {
  return d == 0 ? 1u : 3u * pow3(d - 1);
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
    const bool seen = mx > -CUDART_INF_F;
    if constexpr (kMode == kOpenness) {
      acc0 = __fadd_rn(acc0, seen ? __fsub_rn(CUDART_PIO2_F, atanf(mx))
                                  : CUDART_INF_F);
      acc1 = __fadd_rn(acc1, seen ? __fsub_rn(CUDART_PIO2_F, atanf(-mn))
                                  : CUDART_INF_F);
    } else if constexpr (kMode == kSvf) {
      // also absorbs unseen (mx = -inf)
      const float t = fmaxf(mx, 0.0f);
      acc0 = __fadd_rn(
          acc0, __fdiv_rn(t, __fsqrt_rn(__fadd_rn(1.0f, __fmul_rn(t, t)))));
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
      tc += (unsigned)(1 + (gt ? 1 : 0) - (lt ? 1 : 0)) * pow3(d);
    }
  }
  if constexpr (kMode == kTernary) {
    code[px.p] = (uint16_t)tc;
  } else {
    out0[px.p] = acc0;
    if constexpr (kMode == kOpenness) out1[px.p] = acc1;
  }
}

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
