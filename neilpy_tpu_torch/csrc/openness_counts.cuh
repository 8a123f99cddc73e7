// K1's per-pixel body, shared by its dynamic kernel (openness_counts.cu)
// and K5's region plan (openness_counts_plan.cu), so the two routes
// cannot drift apart: for each of the 8 directions the scan ladder of
// ladder.cuh, by the body the route picks, then the vote num_pos /
// num_neg on the openness difference atan(-mn) - atan(mx) against the
// threshold, exactly in tangent space (pallas_scan.py:449-475).

#pragma once

#include "ladder.cuh"

namespace neilpy_ladder {

template <bool kDense, class Route>
__device__ __forceinline__ void counts_pixel(
    const Pixel& px, int64_t W, const int* __restrict__ ladder,
    const float* __restrict__ scales, int K, int Rmax, float T, Route route,
    uint8_t* __restrict__ num_pos, uint8_t* __restrict__ num_neg) {
  int n_pos = 0;
  int n_neg = 0;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    float mx, mn;
    direction_extrema_routed<kDense>(px, d, W, ladder, scales, K, Rmax,
                                     route, mx, mn);
    bool gt, lt;
    classify(mx, mn, T, gt, lt);
    n_pos += gt ? 1 : 0;
    n_neg += lt ? 1 : 0;
  }
  num_pos[px.p] = (uint8_t)n_pos;
  num_neg[px.p] = (uint8_t)n_neg;
}

}  // namespace neilpy_ladder
