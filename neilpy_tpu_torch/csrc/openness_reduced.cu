// Openness, skyview factor and ternary codes, folded over the 8
// directions inside one kernel, for NVIDIA Hopper (sm_90a): K2, the
// dynamic route.
//
// Replaces the TPU kernel neilpy_tpu/ops/pallas_scan.py:_reduced_kernel
// (launched by _reduced_call for openness_pallas, skyview_pallas and
// ternary_pallas).  For every pixel it runs the scan ladder of ladder.cuh
// for d = 0..7 and folds each direction's (mx, mn) into register
// accumulators (openness_reduced.cuh, which lists the three modes).
//
// Routing, as _reduced_kernel's dynamic branch (pallas_scan.py:980-995):
// each 32x8 thread block runs the maskless ladder in the directions that
// are safe for it (read window on the raster) and the masked ladder in
// the others, a block-uniform choice (K1's
// openness_counts.cu says more).  K5 (openness_reduced_plan.cu) is the
// same body with the choice fixed at compile time per boundary region.
//
// The wrappers (ops/cuda_scan.py) apply the Pallas wrappers' final scale:
// pos * f32(180/pi/8) and 1 - acc * 0.125.
//
// Exactness: the TPU kernel has its own polynomial atan (_atan_f32) only
// because Mosaic lacks one; this kernel calls CUDA's atanf, as the plain
// PyTorch version (ops/cuda_scan.py:openness_reduced_torch) calls
// torch.atan, never a __ fast intrinsic, and is built without
// --use_fast_math.  The adds, multiplies, divides and square roots are
// __fadd_rn / __fmul_rn / __fdiv_rn / __fsqrt_rn, so svf and ternary
// round like the plain version, and openness differs from it only by
// atanf's own rounding under -fmad=false.
//
// What bounds it on this card: instruction issue, as K1
// (openness_counts.cu): per pixel 8 ladders of R steps of 4 operations
// each, plus the fold (for openness two atanf per direction: at least 56
// operations per pixel and direction, against 200 for the ladder at exact
// lookup 50 and 64 on the fast one); the writes are 4 to 8 B per pixel.
// So the design is K1's.  The all-safe interior runs the tiled body of
// ladder_tile.cuh with the fold as its epilogue (ReducedOut, built in
// openness_reduced_tile.cu): a 32x64 core and its Rmax halo in shared
// memory, filled once by TMA (or cp.async), 8 pixels per thread, one shared
// load per pixel-step.  Tiles whose window lies on the raster in every
// direction take it; the per-thread kernel below runs every other 32x8
// block, enumerated by a 1-D grid that leaves out the tiles' rectangle
// (ladder_tile.cuh:unit_at), with the directions unrolled and the two
// bodies of ladder.cuh.  With no tile (the host's switch off, the route
// mask not 0xFF, or a window too large) the per-thread kernel runs the
// whole raster.

#include "openness_reduced.cuh"

namespace {

using namespace neilpy_ladder;

template <int kMode, bool kNegMode, bool kDense>
__global__ void __launch_bounds__(kBlockX * kBlockY)
openness_reduced_kernel(const float* __restrict__ Z, int64_t H, int64_t W,
                        const int* __restrict__ ladder,
                        const float* __restrict__ scales, int K, int Rmax,
                        unsigned allow, int hy0, int hy1, int hx0, int hx1,
                        float T, float* __restrict__ out0,
                        float* __restrict__ out1,
                        uint16_t* __restrict__ code) {
  const UnitPos u = unit_at((W + kBlockX - 1) / kBlockX, hy0, hy1, hx0, hx1);
  const DynamicRoute route{safe_directions_at(allow, Rmax, H, W, u.r0, u.c0)};
  const int64_t c = u.c0 + threadIdx.x;
  const int64_t r = u.r0 + threadIdx.y;
  if (r >= H || c >= W) return;
  const Pixel px = make_pixel(Z, H, W, r, c);
  reduced_pixel<kMode, kNegMode, kDense>(px, W, ladder, scales, K, Rmax, T,
                                         route, out0, out1, code);
}

template <int kMode, bool kNegMode, bool kDense>
struct Launch {
  static int run(const float* Z, long long H, long long W, const int* ladder,
                 const float* scales, int K, int Rmax, unsigned allow,
                 int halo, int ty0, int ty1, int tx0, int tx1, int tma,
                 float T, float* out0, float* out1, uint16_t* code,
                 cudaStream_t stream) {
    const int err = reduced_tiles<kMode, kNegMode>(
        Z, H, W, ladder, scales, K, Rmax, halo, ty0, ty1, tx0, tx1, tma, T,
        out0, out1, code, stream);
    if (err != 0) return err;
    const UnitHole hole = unit_hole(halo, ty0, ty1, tx0, tx1);
    const unsigned blocks = unit_blocks(H, W, hole);
    if (blocks == 0) return 0;
    openness_reduced_kernel<kMode, kNegMode, kDense>
        <<<blocks, dim3(kBlockX, kBlockY), 0, stream>>>(
            Z, (int64_t)H, (int64_t)W, ladder, scales, K, Rmax, allow,
            hole.y0, hole.y1, hole.x0, hole.x1, T, out0, out1, code);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// C entry, bound with ctypes (neilpy_tpu_torch/ops/cuda_scan.py).  ``mode``
// is 0 (openness: out0 = pos sum, out1 = neg sum), 1 (svf: out0) or 2
// (ternary: code, with ``neg_mode`` 0 or 1); the outputs a mode does not
// write may be null.  ``dense`` says the ladder is 1..K; ``allow`` and the
// tile arguments (``halo``, ``ty0``, ``ty1``, ``tx0``, ``tx1``, ``tma``)
// as in openness_counts_launch.  All pointers are device pointers;
// ``stream`` is a cudaStream_t.  Launches on that stream, does not
// synchronise, and returns cudaGetLastError() (or the tensor map's or the
// shared-memory attribute's error), or cudaErrorInvalidValue for an
// unknown mode.
extern "C" int openness_reduced_launch(const float* Z, long long H,
                                       long long W, const int* ladder,
                                       const float* scales, int K, int Rmax,
                                       int dense, unsigned allow, int halo,
                                       int ty0, int ty1, int tx0, int tx1,
                                       int tma, int mode, int neg_mode,
                                       float T, float* out0, float* out1,
                                       unsigned short* code, void* stream) {
  return dispatch_mode<Launch>(mode, neg_mode, dense, Z, H, W, ladder,
                               scales, K, Rmax, allow, halo, ty0, ty1, tx0,
                               tx1, tma, T, out0, out1, code,
                               (cudaStream_t)stream);
}
