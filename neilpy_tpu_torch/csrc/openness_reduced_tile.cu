// The tile kernels of K2 (openness_reduced.cu) and K5/reduced
// (openness_reduced_plan.cu), for NVIDIA Hopper (sm_90a): the tiled body
// of ladder_tile.cuh with K2's fold as its epilogue (ReducedOut,
// openness_reduced.cuh), for the all-safe interior of a whole raster.
//
// Replaces, for that interior, the TPU kernel's R-haloed window
// (neilpy_tpu/ops/pallas_scan.py:_reduced_kernel, its VMEM ``win`` filled by
// one DMA per tile) with the fold of reduce_dir (pallas_scan.py:911-942)
// applied to each direction's extrema as they end.  A 32x64 core and its
// Rmax halo are copied into shared memory once (TMA, or cp.async where
// W % 4 != 0), each thread runs the ladder of 8 pixels from there, and the
// direction's (mx, mn) are folded into 8 pixels' register accumulators: the
// openness sums, the svf sum or the ternary code.  Only the reduced planes
// are written.
//
// The tile kernel does not depend on the ladder's density (the step table
// holds the offsets) nor on the route (its tiles are maskless in every
// direction), so K2 and K5/reduced launch the same 20 kernels (5 halo
// buckets x 4 mode variants).  They are built here once, in a translation
// unit of their own that nvcc compiles beside the others, rather than once
// in each of the two sources.
//
// What bounds it on this card: instruction issue.  The step loop is the
// tile's (5.44 SASS instructions per pixel-step, tools/ladder_sass.py);
// the fold adds per pixel and direction two atanf (openness), a square
// root and a division (svf) or a tangent-space compare (ternary).  For
// openness that is at least 56 operations per pixel and direction, counted
// from reduce_dir with its multiply-adds fused (chip_smoke.py:FOLD_OPS),
// against the ladder's 200 at exact lookup 50 and 64 on the 16-step fast
// ladder.  The accumulators live in registers: shared memory is the tile's
// alone, tile_smem_bytes(halo, Rmax, K).
//
// Exactness: the extrema are the maskless body's (fmaxf / fminf over the
// same ratios in the same order) and each direction is folded by
// fold_direction in the order d = 0..7, as the per-thread body folds it, so
// every output equals the per-thread kernels' bit for bit.

#include "openness_reduced.cuh"

namespace neilpy_ladder {

template <int kMode, bool kNegMode>
int reduced_tiles(const float* Z, long long H, long long W, const int* ladder,
                  const float* scales, int K, int Rmax, int halo, int ty0,
                  int ty1, int tx0, int tx1, int tma, float T, float* out0,
                  float* out1, uint16_t* code, cudaStream_t stream) {
  return launch_tiles(Z, H, W, ladder, scales, K, Rmax, halo, ty0, ty1, tx0,
                      tx1, tma, 0, 0,
                      ReducedOut<kMode, kNegMode>{T, out0, out1, code,
                                                  (int64_t)W},
                      stream);
}

// the four mode variants dispatch_mode names, built here once
template int reduced_tiles<kOpenness, false>(
    const float*, long long, long long, const int*, const float*, int, int,
    int, int, int, int, int, int, float, float*, float*, uint16_t*,
    cudaStream_t);
template int reduced_tiles<kSvf, false>(
    const float*, long long, long long, const int*, const float*, int, int,
    int, int, int, int, int, int, float, float*, float*, uint16_t*,
    cudaStream_t);
template int reduced_tiles<kTernary, true>(
    const float*, long long, long long, const int*, const float*, int, int,
    int, int, int, int, int, int, float, float*, float*, uint16_t*,
    cudaStream_t);
template int reduced_tiles<kTernary, false>(
    const float*, long long, long long, const int*, const float*, int, int,
    int, int, int, int, int, int, float, float*, float*, uint16_t*,
    cudaStream_t);

}  // namespace neilpy_ladder
