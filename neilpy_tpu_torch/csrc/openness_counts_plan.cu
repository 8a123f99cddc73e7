// K5 for the counts: the static boundary plan of K1, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU's 9-patch launch plan as openness_counts_pallas runs
// it with specialize=True (the default for the exact ladder):
// neilpy_tpu/ops/pallas_scan.py:_counts_call_9patch -> _region_calls,
// whose regions come from _axis_segments / _axis_bad and whose bodies are
// _counts_kernel's static branch (pallas_scan.py:488-504).  The host
// (ops/cuda_scan.py:region_plan, cached per shape and Rmax) splits each
// axis into a low strip (Rmax rounded up to the block), an interior and a
// high strip that also holds the alignment overhang, and gives each
// segment its unsafe directions.
//
// One launch covers the raster (design (b) of the plan): each 32x8 thread
// block finds its row and column segment from blockIdx and switches once,
// block-uniformly, to the body compiled for its region's unsafe set
// (ladder.cuh:with_static_route, 9 regions + the all-masked body), so
// every direction's masked / maskless choice is a compile-time constant
// and the body is straight-line.  The TPU plan sends a tile whose window
// holds a NaN down the all-masked body (pallas_scan.py:497-503), because
// its maskless maximum propagates NaN; here both bodies skip a NaN read
// (ladder.cuh), so no block needs that test.  One launch
// rather than one per region: a strip of 7 block rows across an 8192-wide
// raster is under two waves of the card, and eight such launches in a row
// would each pay a partial last wave.
//
// Exactness: the per-pixel body is K1's (openness_counts.cuh); the plan's
// unsafe sets are supersets of the dynamic predicate's, and both bodies
// agree wherever both are valid, so the counts equal K1's and the plain
// version's (ops/cuda_scan.py:openness_counts_torch).
//
// What bounds it on this card: K1's ladder, instruction-issue bound
// (openness_counts.cu); at 8192^2, lookup 50, the interior (about 97% of
// the blocks) is maskless in all 8 directions.  That interior runs the
// tiled body of ladder_tile.cuh, as K1's does: the 32x64 tiles that lie
// wholly in the plan's interior region (ops/cuda_scan.py:tile_route), each
// with its Rmax halo in shared memory.  The per-thread kernel below runs
// the rest, its 1-D grid leaving out the tiles' rectangle; the tile body is
// the one maskless route, not ten.

#include "openness_counts.cuh"
#include "ladder_tile.cuh"

namespace {

using namespace neilpy_ladder;

template <bool kDense>
__global__ void __launch_bounds__(kBlockX * kBlockY)
openness_counts_plan_kernel(const float* __restrict__ Z, int64_t H,
                            int64_t W, const int* __restrict__ ladder,
                            const float* __restrict__ scales, int K,
                            int Rmax, int hy0, int hy1, int hx0, int hx1,
                            int64_t rlo, int64_t rhi,
                            unsigned rmasks, int64_t clo, int64_t chi,
                            unsigned cmasks, float T,
                            uint8_t* __restrict__ num_pos,
                            uint8_t* __restrict__ num_neg) {
  const UnitPos u = unit_at((W + kBlockX - 1) / kBlockX, hy0, hy1, hx0, hx1);
  const unsigned unsafe =
      plan_unsafe_at(u.r0, u.c0, rlo, rhi, rmasks, clo, chi, cmasks);
  const int64_t c = u.c0 + threadIdx.x;
  const int64_t r = u.r0 + threadIdx.y;
  if (r >= H || c >= W) return;
  const Pixel px = make_pixel(Z, H, W, r, c);
  with_static_route(unsafe, [&](auto route) {
    counts_pixel<kDense>(px, W, ladder, scales, K, Rmax, T, route, num_pos,
                         num_neg);
  });
}

template <bool kDense>
int launch(const float* Z, long long H, long long W, const int* ladder,
           const float* scales, int K, int Rmax, int halo, int ty0,
           int ty1, int tx0, int tx1, int tma, long long rlo,
           long long rhi, unsigned rmasks, long long clo, long long chi,
           unsigned cmasks, float T, uint8_t* num_pos, uint8_t* num_neg,
           cudaStream_t stream) {
  const int err =
      launch_tiles(Z, H, W, ladder, scales, K, Rmax, halo, ty0, ty1, tx0, tx1,
                   tma, 0, 0, CountsOut{T, num_pos, num_neg, (int64_t)W},
                   stream);
  if (err != 0) return err;
  const UnitHole hole = unit_hole(halo, ty0, ty1, tx0, tx1);
  const unsigned blocks = unit_blocks(H, W, hole);
  if (blocks == 0) return 0;
  openness_counts_plan_kernel<kDense>
      <<<blocks, dim3(kBlockX, kBlockY), 0, stream>>>(
          Z, (int64_t)H, (int64_t)W, ladder, scales, K, Rmax, hole.y0,
          hole.y1, hole.x0, hole.x1, (int64_t)rlo, (int64_t)rhi, rmasks,
          (int64_t)clo, (int64_t)chi, cmasks, T, num_pos, num_neg);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes (neilpy_tpu_torch/ops/cuda_scan.py).  As
// openness_counts_launch (tiles included: here the tiles of the plan's
// interior), plus the plan: rows starting before ``rlo`` are the low
// strip, from ``rhi`` on the high strip; ``rmasks`` packs the three row
// segments' unsafe directions, one byte each (low, interior, high); the
// same for columns.  Launches on ``stream``, does not synchronise, and
// returns cudaGetLastError().
extern "C" int openness_counts_plan_launch(
    const float* Z, long long H, long long W, const int* ladder,
    const float* scales, int K, int Rmax, int dense, int halo, int ty0,
    int ty1, int tx0, int tx1, int tma, long long rlo, long long rhi,
    int rmasks, long long clo, long long chi, int cmasks, float T,
    unsigned char* num_pos, unsigned char* num_neg, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return dense ? launch<true>(Z, H, W, ladder, scales, K, Rmax, halo, ty0,
                              ty1, tx0, tx1, tma, rlo, rhi,
                              (unsigned)rmasks, clo, chi, (unsigned)cmasks, T,
                              num_pos, num_neg, s)
               : launch<false>(Z, H, W, ladder, scales, K, Rmax, halo, ty0,
                               ty1, tx0, tx1, tma, rlo, rhi,
                               (unsigned)rmasks, clo, chi, (unsigned)cmasks,
                               T, num_pos, num_neg, s);
}
