// Geomorphon openness counts of one shard block, for NVIDIA Hopper
// (sm_90a): K4.
//
// Replaces the TPU kernel neilpy_tpu/ops/pallas_scan.py:_counts_kernel as
// launched by openness_counts_pallas_block (K1's body with a traced global
// origin).  The input is a contiguous (bh + 2R, bw + 2R) float32 block: the
// core of one device's share of the raster surrounded by an R-wide halo of
// its neighbours' data, NaN beyond the raster (dist/halo.py, mode 'nan').
// One thread per CORE pixel runs the scan ladder of ladder.cuh over the
// haloed block and votes num_pos / num_neg as K1 does (tangent-space
// classify); the outputs are core-shaped (bh, bw) uint8.
//
// What differs from K1 is where the ladder stops and where the
// edge-replication epilogue is decided (ladder.cuh:direction_extrema_global):
// the ladder ends at the edge of the haloed block, so no read leaves the
// allocation, and the epilogue tests p + d*Rmax against the GLOBAL raster,
// from the core's global origin and the global shape.  A core pixel's
// ladder never reaches past the R-wide halo, so every read it makes is a
// read the single-device kernel makes too (NaN beyond the raster is
// skipped by the compares, as K1's early exit skips it); the counts are
// those of K1 on the whole raster.
//
// Exactness: the ladder, the shared host scale table and the classify are
// K1's, so the counts equal the plain PyTorch version
// (ops/cuda_scan.py:openness_counts_block_torch) on the card.
//
// Routing, as K1's dynamic branch with a traced origin: each 32x8 thread
// block of the core runs the maskless ladder of ladder.cuh in the
// directions whose read window lies on the haloed block and, shifted to
// global coordinates, inside the raster (the global test of
// pallas_scan.py:_dir_is_safe, :252-255), and the masked ladder in the
// others; a block-uniform choice.  The halo's NaN beyond the raster lies
// off the global raster, so no maskless pair reads it.  K4 has no
// static form: the JAX package's region plan is single-device only.
//
// What bounds it on this card: K1's ladder, instruction-issue bound
// (openness_counts.cu), at about R loads and 4 flops per step; the
// epilogue's 64-bit global test runs once per direction, not per step.
//
// The all-safe interior of the core runs K1's tiled body
// (ladder_tile.cuh) on the haloed block: tiles of 32x64 core pixels on a
// grid that starts at array pixel (R, R), each with its Rmax halo in
// shared memory, and outputs at the core's pitch.  A tile takes it only
// where its whole window lies on the block AND, shifted by the block's
// origin, inside the global raster (ops/cuda_scan.py:tile_route with the
// block's geometry), so no step reads the halo's NaN beyond the raster and
// no last step needs the global epilogue.  The window starts R % 16
// columns further left than on a whole raster (ladder_tile.cuh:tile_shift),
// so the TMA box stays 64-B aligned in the block.  The per-thread kernel
// below runs every other 32x8 block of the core, enumerated by a 1-D grid
// over the core's blocks that leaves out the tiles' rectangle
// (ladder_tile.cuh:unit_at): one thread per output pixel, a row stride of
// the haloed width and 64-bit indexing.

#include "ladder_tile.cuh"

namespace {

using namespace neilpy_ladder;

template <bool kDense>
__global__ void __launch_bounds__(kBlockX * kBlockY)
openness_counts_block_kernel(const float* __restrict__ Z, int64_t Hh,
                             int64_t Wh, const int* __restrict__ ladder,
                             const float* __restrict__ scales, int K,
                             int Rmax, unsigned allow, int hy0, int hy1,
                             int hx0, int hx1, int R, int64_t org_r,
                             int64_t org_c, int64_t GH, int64_t GW, float T,
                             uint8_t* __restrict__ num_pos,
                             uint8_t* __restrict__ num_neg) {
  const int64_t bh = Hh - 2 * (int64_t)R;
  const int64_t bw = Wh - 2 * (int64_t)R;
  // the unit's first pixel in the core; the core's pixel (0, 0) is the
  // array's (R, R), and the array's pixel (0, 0) lies at (org_r - R,
  // org_c - R) of the raster
  const UnitPos u = unit_at((bw + kBlockX - 1) / kBlockX, hy0, hy1, hx0, hx1);
  const DynamicRoute route{safe_directions_global_at(
      allow, Rmax, Hh, Wh, R + u.r0, R + u.c0, org_r - R, org_c - R, GH, GW)};
  const int64_t c = u.c0 + threadIdx.x;
  const int64_t r = u.r0 + threadIdx.y;
  if (r >= bh || c >= bw) return;
  const Pixel px = make_pixel(Z, Hh, Wh, r + R, c + R);
  const GlobalPos g{org_r + r, org_c + c, GH, GW};
  int n_pos = 0;
  int n_neg = 0;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    float mx, mn;
    direction_extrema_global_routed<kDense>(px, g, d, Wh, ladder, scales, K,
                                            Rmax, route, mx, mn);
    bool gt, lt;
    classify(mx, mn, T, gt, lt);
    n_pos += gt ? 1 : 0;
    n_neg += lt ? 1 : 0;
  }
  num_pos[r * bw + c] = (uint8_t)n_pos;
  num_neg[r * bw + c] = (uint8_t)n_neg;
}

template <bool kDense>
int launch(const float* Z, long long Hh, long long Wh, const int* ladder,
           const float* scales, int K, int Rmax, unsigned allow, int halo,
           int ty0, int ty1, int tx0, int tx1, int tma, int R,
           long long org_r, long long org_c, long long GH, long long GW,
           float T, uint8_t* num_pos, uint8_t* num_neg, cudaStream_t stream) {
  const long long bh = Hh - 2LL * R;
  const long long bw = Wh - 2LL * R;
  const int err =
      launch_tiles(Z, Hh, Wh, ladder, scales, K, Rmax, halo, ty0, ty1, tx0,
                   tx1, tma, R, R, CountsOut{T, num_pos, num_neg, (int64_t)bw},
                   stream);
  if (err != 0) return err;
  const UnitHole hole = unit_hole(halo, ty0, ty1, tx0, tx1);
  const unsigned blocks = unit_blocks(bh, bw, hole);
  if (blocks == 0) return 0;
  openness_counts_block_kernel<kDense>
      <<<blocks, dim3(kBlockX, kBlockY), 0, stream>>>(
          Z, (int64_t)Hh, (int64_t)Wh, ladder, scales, K, Rmax, allow,
          hole.y0, hole.y1, hole.x0, hole.x1, R, (int64_t)org_r,
          (int64_t)org_c, (int64_t)GH, (int64_t)GW, T, num_pos, num_neg);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes (neilpy_tpu_torch/ops/cuda_scan.py).  Z is
// the (Hh, Wh) haloed block with halo R; (org_r, org_c) the global origin
// of its core and (GH, GW) the global shape; num_pos and num_neg hold
// (Hh - 2R) * (Wh - 2R) bytes each; ``dense`` says the ladder is 1..K;
// ``allow`` as in openness_counts_launch; ``halo``, [ty0, ty1) x [tx0,
// tx1) and ``tma`` the tile arguments as there, the tiles counted on the
// core's grid (cuda_scan.tile_route with the block's geometry).
// All pointers are device pointers; ``stream`` is a cudaStream_t.
// Launches on that stream, does not synchronise, and returns
// cudaGetLastError() (or the tensor map's or the shared-memory
// attribute's error).
extern "C" int openness_counts_block_launch(
    const float* Z, long long Hh, long long Wh, const int* ladder,
    const float* scales, int K, int Rmax, int dense, unsigned allow,
    int halo, int ty0, int ty1, int tx0, int tx1, int tma, int R,
    long long org_r, long long org_c, long long GH, long long GW, float T,
    unsigned char* num_pos, unsigned char* num_neg, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return dense ? launch<true>(Z, Hh, Wh, ladder, scales, K, Rmax, allow, halo,
                              ty0, ty1, tx0, tx1, tma, R, org_r, org_c, GH,
                              GW, T, num_pos, num_neg, s)
               : launch<false>(Z, Hh, Wh, ladder, scales, K, Rmax, allow,
                               halo, ty0, ty1, tx0, tx1, tma, R, org_r, org_c,
                               GH, GW, T, num_pos, num_neg, s);
}
