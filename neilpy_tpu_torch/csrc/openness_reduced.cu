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
// What bounds it on this card: the ladder, as in K1 (openness_counts.cu):
// about R loads of Z, served by L1/L2, and 4 flops per step, 8R steps per
// pixel, instruction-issue bound.  The fold adds at most 16 atanf per
// pixel against 400 ladder steps at R = 50, and the writes are 4 to 8 B
// per pixel.  So the design is K1's: one thread per pixel in 32x8 blocks,
// the directions unrolled, the two bodies of ladder.cuh.

#include "openness_reduced.cuh"

namespace {

using namespace neilpy_ladder;

template <int kMode, bool kNegMode, bool kDense>
__global__ void __launch_bounds__(kBlockX * kBlockY)
openness_reduced_kernel(const float* __restrict__ Z, int64_t H, int64_t W,
                        const int* __restrict__ ladder,
                        const float* __restrict__ scales, int K, int Rmax,
                        unsigned allow, float T,
                        float* __restrict__ out0, float* __restrict__ out1,
                        uint16_t* __restrict__ code) {
  const DynamicRoute route{safe_directions(allow, Rmax, H, W)};
  const int64_t c = (int64_t)blockIdx.x * kBlockX + threadIdx.x;
  const int64_t r = (int64_t)blockIdx.y * kBlockY + threadIdx.y;
  if (r >= H || c >= W) return;
  const Pixel px = make_pixel(Z, H, W, r, c);
  reduced_pixel<kMode, kNegMode, kDense>(px, W, ladder, scales, K, Rmax, T,
                                         route, out0, out1, code);
}

template <int kMode, bool kNegMode, bool kDense>
struct Launch {
  static int run(const float* Z, long long H, long long W, const int* ladder,
                 const float* scales, int K, int Rmax, unsigned allow,
                 float T, float* out0, float* out1, uint16_t* code,
                 cudaStream_t stream) {
    openness_reduced_kernel<kMode, kNegMode, kDense>
        <<<grid_for(H, W), dim3(kBlockX, kBlockY), 0, stream>>>(
            Z, (int64_t)H, (int64_t)W, ladder, scales, K, Rmax, allow, T,
            out0, out1, code);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// C entry, bound with ctypes (neilpy_tpu_torch/ops/cuda_scan.py).  ``mode``
// is 0 (openness: out0 = pos sum, out1 = neg sum), 1 (svf: out0) or 2
// (ternary: code, with ``neg_mode`` 0 or 1); the outputs a mode does not
// write may be null.  ``dense`` says the ladder is 1..K; ``allow`` as in
// openness_counts_launch.  All pointers are device
// pointers; ``stream`` is a cudaStream_t.  Launches on that stream, does
// not synchronise, and returns cudaGetLastError(), or
// cudaErrorInvalidValue for an unknown mode.
extern "C" int openness_reduced_launch(const float* Z, long long H,
                                       long long W, const int* ladder,
                                       const float* scales, int K, int Rmax,
                                       int dense, unsigned allow,
                                       int mode, int neg_mode, float T,
                                       float* out0, float* out1,
                                       unsigned short* code, void* stream) {
  return dispatch_mode<Launch>(mode, neg_mode, dense, Z, H, W, ladder,
                               scales, K, Rmax, allow, T, out0, out1, code,
                               (cudaStream_t)stream);
}
