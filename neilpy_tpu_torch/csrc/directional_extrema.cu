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
// pixel, 4.3 GB at 8192^2, which at the H100's 3.35 TB/s is about 1.3 ms;
// so the design spends nothing on them beyond keeping them coalesced: each
// direction's two values stored as soon as its ladder ends, a warp writing
// 32 neighbouring floats of one plane row.
//
// The all-safe interior runs K1's tiled body (ladder_tile.cuh, with the
// planes as its epilogue): tiles of 32x64 pixels with their Rmax halo in
// shared memory, 8 pixels per thread, each direction's 16 values stored
// after its ladder.  On a whole raster the tiles are K1's; for the origin
// entry a tile also needs its whole window inside the global raster
// (ops/cuda_scan.py:tile_route with the block's origin), so the halo
// rows and columns near the raster's edge, whose last step the global
// epilogue clamps, stay on the per-thread body.  That body runs every
// other 32x8 block: one thread per pixel, the directions unrolled, in a
// 1-D grid that leaves out the tiles' rectangle (ladder_tile.cuh:unit_at).
//
// A second entry takes a global origin (directional_extrema_global_launch):
// the input is then a shard block whose pixel (0, 0) lies at (org_r,
// org_c) of a (GH, GW) raster, and the edge-replication epilogue is decided
// in global coordinates (ladder.cuh:direction_extrema_global), for every
// pixel of the block, halo pixels too, as the XLA function
// neilpy_tpu/ops/visibility.py:directional_ratio_extrema(origin=) does.
// The origin is a template parameter, so the whole-raster entry carries
// no global test.
//
// Routing, as _extrema_kernel (pallas_scan.py:307-341): each 32x8 thread
// block runs the maskless ladder of ladder.cuh in the directions that are
// safe for it (read window on the array and, for the origin entry, inside
// the global raster) and the masked ladder in the others, a block-uniform
// choice.  K3 has no static form: the JAX package's region plan serves K1
// and K2 only.  The maskless body may write +0 where the masked one wrote
// -0 (ladder.cuh), so its planes equal the plain version's by value.

#include "ladder_tile.cuh"

namespace {

using namespace neilpy_ladder;

template <bool kGlobal, bool kDense>
__global__ void __launch_bounds__(kBlockX * kBlockY)
directional_extrema_kernel(const float* __restrict__ Z, int64_t H,
                           int64_t W, const int* __restrict__ ladder,
                           const float* __restrict__ scales, int K, int Rmax,
                           unsigned allow, int hy0, int hy1, int hx0,
                           int hx1, int64_t org_r, int64_t org_c, int64_t GH,
                           int64_t GW, float* __restrict__ mx_out,
                           float* __restrict__ mn_out) {
  const UnitPos u = unit_at((W + kBlockX - 1) / kBlockX, hy0, hy1, hx0, hx1);
  const DynamicRoute route{
      kGlobal ? safe_directions_global_at(allow, Rmax, H, W, u.r0, u.c0,
                                          org_r, org_c, GH, GW)
              : safe_directions_at(allow, Rmax, H, W, u.r0, u.c0)};
  const int64_t c = u.c0 + threadIdx.x;
  const int64_t r = u.r0 + threadIdx.y;
  if (r >= H || c >= W) return;
  const Pixel px = make_pixel(Z, H, W, r, c);
  const int64_t plane = H * W;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    float mx, mn;
    if constexpr (kGlobal) {
      direction_extrema_global_routed<kDense>(
          px, GlobalPos{org_r + r, org_c + c, GH, GW}, d, W, ladder, scales,
          K, Rmax, route, mx, mn);
    } else {
      direction_extrema_routed<kDense>(px, d, W, ladder, scales, K, Rmax,
                                       route, mx, mn);
    }
    mx_out[d * plane + px.p] = mx;
    mn_out[d * plane + px.p] = mn;
  }
}

template <bool kGlobal, bool kDense>
int launch(const float* Z, long long H, long long W, const int* ladder,
           const float* scales, int K, int Rmax, unsigned allow, int halo,
           int ty0, int ty1, int tx0, int tx1, int tma, long long org_r,
           long long org_c, long long GH, long long GW, float* mx, float* mn,
           cudaStream_t stream) {
  const int err = launch_tiles(
      Z, H, W, ladder, scales, K, Rmax, halo, ty0, ty1, tx0, tx1, tma, 0, 0,
      PlanesOut{mx, mn, (int64_t)W, (int64_t)(H * W)}, stream);
  if (err != 0) return err;
  const UnitHole hole = unit_hole(halo, ty0, ty1, tx0, tx1);
  const unsigned blocks = unit_blocks(H, W, hole);
  if (blocks == 0) return 0;
  directional_extrema_kernel<kGlobal, kDense>
      <<<blocks, dim3(kBlockX, kBlockY), 0, stream>>>(
          Z, (int64_t)H, (int64_t)W, ladder, scales, K, Rmax, allow, hole.y0,
          hole.y1, hole.x0, hole.x1, (int64_t)org_r, (int64_t)org_c,
          (int64_t)GH, (int64_t)GW, mx, mn);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes (neilpy_tpu_torch/ops/cuda_scan.py).  All
// pointers are device pointers; mx and mn hold 8 * H * W floats each;
// ``dense`` says the ladder is 1..K; ``allow``, ``halo``, [ty0, ty1) x
// [tx0, tx1) and ``tma`` as in openness_counts_launch; ``stream`` is a
// cudaStream_t.  Launches on that stream, does not synchronise, and
// returns cudaGetLastError() (or the tensor map's or the shared-memory
// attribute's error).
extern "C" int directional_extrema_launch(
    const float* Z, long long H, long long W, const int* ladder,
    const float* scales, int K, int Rmax, int dense, unsigned allow,
    int halo, int ty0, int ty1, int tx0, int tx1, int tma, float* mx,
    float* mn, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return dense ? launch<false, true>(Z, H, W, ladder, scales, K, Rmax, allow,
                                     halo, ty0, ty1, tx0, tx1, tma, 0, 0, H,
                                     W, mx, mn, s)
               : launch<false, false>(Z, H, W, ladder, scales, K, Rmax,
                                      allow, halo, ty0, ty1, tx0, tx1, tma, 0,
                                      0, H, W, mx, mn, s);
}

// The same with a global origin: pixel (0, 0) of Z lies at (org_r, org_c)
// of a (GH, GW) raster (origin may be negative: a halo row above the
// raster); the tiles are those whose window also lies inside that raster.
extern "C" int directional_extrema_global_launch(
    const float* Z, long long H, long long W, const int* ladder,
    const float* scales, int K, int Rmax, int dense, unsigned allow,
    int halo, int ty0, int ty1, int tx0, int tx1, int tma, long long org_r,
    long long org_c, long long GH, long long GW, float* mx, float* mn,
    void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return dense ? launch<true, true>(Z, H, W, ladder, scales, K, Rmax, allow,
                                    halo, ty0, ty1, tx0, tx1, tma, org_r,
                                    org_c, GH, GW, mx, mn, s)
               : launch<true, false>(Z, H, W, ladder, scales, K, Rmax, allow,
                                     halo, ty0, ty1, tx0, tx1, tma, org_r,
                                     org_c, GH, GW, mx, mn, s);
}
