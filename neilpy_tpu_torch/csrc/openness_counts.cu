// Geomorphon openness counts for NVIDIA Hopper (sm_90a): K1, the dynamic
// route.
//
// Replaces the TPU kernel neilpy_tpu/ops/pallas_scan.py:_counts_kernel
// (with its ladder _extrema_ladder and launcher _counts_call).  For every
// pixel and each of the 8 directions it runs the scan ladder of
// ladder.cuh (running max mx and min mn of the slope ratio), then each
// direction votes num_pos / num_neg by comparing the openness difference
// atan(-mn) - atan(mx) with the threshold exactly in tangent space
// (openness_counts.cuh).
//
// Routing, as _counts_kernel's dynamic branch (pallas_scan.py:506-532):
// each 32x8 thread block works out, from blockIdx alone, which directions
// are safe for it (its whole read window up to Rmax on the raster) and
// runs the maskless ladder for those and the masked one for the rest; a
// NaN read is skipped by either body (ladder.cuh), so holes need no test.
// The choice is uniform across the block, so no warp diverges.  K5
// (openness_counts_plan.cu) is the same body with the choice fixed at
// compile time per boundary region.
//
// Exactness: no multiply-add is fused (ladder.cuh), and the kernel shares
// the host scale table with the plain PyTorch version
// (ops/cuda_scan.py:openness_counts_torch), so their counts are equal on
// the card; both bodies give the same votes wherever both are valid.
//
// What bounds it on this card: per pixel and direction, about R loads of
// Z and 4 flops (sub, mul, max, min) per ladder step, 8R steps per pixel.
// A warp reads 32 neighbouring floats of one row at every step, so the
// loads are coalesced and, with the ladder walking at most R rows away,
// served by L1/L2 rather than HBM.  Measured on an H100, instruction issue
// bounds it, not memory: the block shape moves the time by under 1%,
// while cutting the per-step bookkeeping does move it.  So the directions
// are unrolled (offsets become constants), the masked body has one 32-bit
// step limit per direction, and the maskless body has no limit, no
// epilogue and, on the dense exact ladder, no loaded ladder entry.
//
// The all-safe interior runs the tiled body of ladder_tile.cuh instead: a
// 32x64 core and its Rmax halo in shared memory, filled once by TMA (or
// cp.async), 8 pixels per thread, one shared load per pixel-step and the
// step's ladder offset and scale read once per thread.  Tiles whose window
// lies on the raster in every direction take it; the per-thread kernel
// below runs every other 32x8 block, enumerated by a 1-D grid that leaves
// out the tiles' rectangle (ladder_tile.cuh:unit_at).  With no tile (the
// host's switch off, the route mask not 0xFF, or a window too large) the
// per-thread kernel runs the whole raster.

#include "openness_counts.cuh"
#include "ladder_tile.cuh"

namespace {

using namespace neilpy_ladder;

template <bool kDense>
__global__ void __launch_bounds__(kBlockX * kBlockY)
openness_counts_kernel(const float* __restrict__ Z, int64_t H, int64_t W,
                       const int* __restrict__ ladder,
                       const float* __restrict__ scales, int K, int Rmax,
                       unsigned allow, int hy0, int hy1, int hx0, int hx1,
                       float T, uint8_t* __restrict__ num_pos,
                       uint8_t* __restrict__ num_neg) {
  const UnitPos u = unit_at((W + kBlockX - 1) / kBlockX, hy0, hy1, hx0, hx1);
  const DynamicRoute route{safe_directions_at(allow, Rmax, H, W, u.r0, u.c0)};
  const int64_t c = u.c0 + threadIdx.x;
  const int64_t r = u.r0 + threadIdx.y;
  if (r >= H || c >= W) return;
  const Pixel px = make_pixel(Z, H, W, r, c);
  counts_pixel<kDense>(px, W, ladder, scales, K, Rmax, T, route, num_pos,
                       num_neg);
}

template <bool kDense>
int launch(const float* Z, long long H, long long W, const int* ladder,
           const float* scales, int K, int Rmax, unsigned allow, int halo,
           int ty0, int ty1, int tx0, int tx1, int tma, float T,
           uint8_t* num_pos, uint8_t* num_neg, cudaStream_t stream) {
  const int err =
      launch_tiles(Z, H, W, ladder, scales, K, Rmax, halo, ty0, ty1, tx0, tx1,
                   tma, 0, 0, CountsOut{T, num_pos, num_neg, (int64_t)W},
                   stream);
  if (err != 0) return err;
  const UnitHole hole = unit_hole(halo, ty0, ty1, tx0, tx1);
  const unsigned blocks = unit_blocks(H, W, hole);
  if (blocks == 0) return 0;
  openness_counts_kernel<kDense>
      <<<blocks, dim3(kBlockX, kBlockY), 0, stream>>>(
          Z, (int64_t)H, (int64_t)W, ladder, scales, K, Rmax, allow, hole.y0,
          hole.y1, hole.x0, hole.x1, T, num_pos, num_neg);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes (neilpy_tpu_torch/ops/cuda_scan.py).  All
// pointers are device pointers; ``dense`` says the ladder is 1..K; bit d
// of ``allow`` lets direction d take the maskless ladder where it is safe
// (0xFF; 0 runs the masked ladder everywhere); ``halo`` (16, 32, 48, 64 or
// 96; 0 for none) is the tile kernel's halo bucket and [ty0, ty1) x [tx0, tx1)
// its tiles of 32x64 pixels, ``tma`` its load path (1 TMA, 0 cp.async), as
// cuda_scan.tile_route gives them; ``stream`` is a cudaStream_t.  Launches
// on that stream, does not synchronise, and returns cudaGetLastError() (or
// the tensor map's or the shared-memory attribute's error).
extern "C" int openness_counts_launch(const float* Z, long long H,
                                      long long W, const int* ladder,
                                      const float* scales, int K, int Rmax,
                                      int dense, unsigned allow, int halo,
                                      int ty0, int ty1, int tx0, int tx1,
                                      int tma, float T,
                                      unsigned char* num_pos,
                                      unsigned char* num_neg, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return dense ? launch<true>(Z, H, W, ladder, scales, K, Rmax, allow, halo,
                              ty0, ty1, tx0, tx1, tma, T, num_pos, num_neg, s)
               : launch<false>(Z, H, W, ladder, scales, K, Rmax, allow, halo,
                               ty0, ty1, tx0, tx1, tma, T, num_pos, num_neg,
                               s);
}

// C entry: the dynamic shared memory, in bytes, that one tile CTA of any
// kernel (K1-K5) is launched with in halo bucket ``halo``
// at ladder reach ``Rmax`` with ``K`` entries
// (ladder_tile.cuh:tile_smem_bytes, the value launch_tile_bucket passes).
extern "C" long long ladder_tile_smem_bytes(int halo, int Rmax, int K) {
  return tile_smem_bytes(halo, Rmax, K);
}
