// Per-direction extrema planes for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel neilpy_tpu/ops/pallas_scan.py:_extrema_kernel
// (launched by directional_extrema_pallas).  For every pixel p and each of
// the 8 directions d it runs the scan ladder of ladder.cuh and writes the
// running max and min slope ratio to mx[d, p] and mn[d, p]: two (8, H, W)
// float32 planes.  It is the path behind openness(neighbors=...) and
// geomorphons2(use_negative_openness=False).
//
// Exactness: the ladder rounds like the Pallas kernel and like the plain
// PyTorch version (ops/cuda_scan.py:directional_extrema_torch), so mx and
// mn are equal to both bit for bit.
//
// What bounds it on this card: the ladder, as in K1 (openness_counts.cu),
// is instruction-issue bound: about R loads of Z, served by L1/L2, and 4
// flops per step, 8R steps per pixel.  The 16 plane writes add 64 B per
// pixel, 4.3 GB at 8192^2, which at the H100's 3.35 TB/s is about 1.3 ms
// against a ladder of tens of ms; so the design spends nothing on them
// beyond keeping them coalesced: one thread per pixel in 32x8 blocks, the
// directions unrolled, and each direction's two values stored as soon as
// its ladder ends, a warp writing 32 neighbouring floats of one plane row.
//
// A second entry takes a global origin (directional_extrema_global_launch):
// the input is then a shard block whose pixel (0, 0) lies at (org_r,
// org_c) of a (GH, GW) raster, and the edge-replication epilogue is decided
// in global coordinates (ladder.cuh:direction_extrema_global), for every
// pixel of the block, halo pixels too, as the XLA function
// neilpy_tpu/ops/visibility.py:directional_ratio_extrema(origin=) does.
// The origin is a template parameter, so the whole-raster entry compiles
// to the same code as before.

#include "ladder.cuh"

namespace {

using namespace neilpy_ladder;

template <bool kGlobal>
__global__ void __launch_bounds__(kBlockX * kBlockY)
directional_extrema_kernel(const float* __restrict__ Z, int64_t H,
                           int64_t W, const int* __restrict__ ladder,
                           const float* __restrict__ scales, int K, int Rmax,
                           int64_t org_r, int64_t org_c, int64_t GH,
                           int64_t GW, float* __restrict__ mx_out,
                           float* __restrict__ mn_out) {
  const int64_t c = (int64_t)blockIdx.x * kBlockX + threadIdx.x;
  const int64_t r = (int64_t)blockIdx.y * kBlockY + threadIdx.y;
  if (r >= H || c >= W) return;
  const Pixel px = make_pixel(Z, H, W, r, c);
  const int64_t plane = H * W;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    float mx, mn;
    if constexpr (kGlobal) {
      direction_extrema_global(px, GlobalPos{org_r + r, org_c + c, GH, GW},
                               d, W, ladder, scales, K, Rmax, mx, mn);
    } else {
      direction_extrema(px, d, W, ladder, scales, K, Rmax, mx, mn);
    }
    mx_out[d * plane + px.p] = mx;
    mn_out[d * plane + px.p] = mn;
  }
}

}  // namespace

// C entry, bound with ctypes (neilpy_tpu_torch/ops/cuda_scan.py).  All
// pointers are device pointers; mx and mn hold 8 * H * W floats each;
// ``stream`` is a cudaStream_t.  Launches on that stream, does not
// synchronise, and returns cudaGetLastError().
extern "C" int directional_extrema_launch(const float* Z, long long H,
                                          long long W, const int* ladder,
                                          const float* scales, int K,
                                          int Rmax, float* mx, float* mn,
                                          void* stream) {
  directional_extrema_kernel<false>
      <<<grid_for(H, W), dim3(kBlockX, kBlockY), 0, (cudaStream_t)stream>>>(
          Z, (int64_t)H, (int64_t)W, ladder, scales, K, Rmax, 0, 0, H, W,
          mx, mn);
  return (int)cudaGetLastError();
}

// The same with a global origin: pixel (0, 0) of Z lies at (org_r, org_c)
// of a (GH, GW) raster (origin may be negative: a halo row above the
// raster).
extern "C" int directional_extrema_global_launch(
    const float* Z, long long H, long long W, const int* ladder,
    const float* scales, int K, int Rmax, long long org_r, long long org_c,
    long long GH, long long GW, float* mx, float* mn, void* stream) {
  directional_extrema_kernel<true>
      <<<grid_for(H, W), dim3(kBlockX, kBlockY), 0, (cudaStream_t)stream>>>(
          Z, (int64_t)H, (int64_t)W, ladder, scales, K, Rmax,
          (int64_t)org_r, (int64_t)org_c, (int64_t)GH, (int64_t)GW, mx, mn);
  return (int)cudaGetLastError();
}
