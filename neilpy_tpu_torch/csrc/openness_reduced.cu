// Openness, skyview factor and ternary codes, folded over the 8
// directions inside one kernel, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel neilpy_tpu/ops/pallas_scan.py:_reduced_kernel
// (launched by _reduced_call for openness_pallas, skyview_pallas and
// ternary_pallas).  For every pixel it runs the scan ladder of ladder.cuh
// for d = 0..7 and folds each direction's (mx, mn) into register
// accumulators, in that order, so only the reduced planes reach memory.
// The mode is a template parameter, so no pixel branches on it:
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
// the directions unrolled, each with one 32-bit step limit.

#include "ladder.cuh"

namespace {

using namespace neilpy_ladder;

enum Mode : int { kOpenness = 0, kSvf = 1, kTernary = 2 };

__host__ __device__ constexpr unsigned pow3(int d) {
  return d == 0 ? 1u : 3u * pow3(d - 1);
}

template <int kMode, bool kNegMode>
__global__ void __launch_bounds__(kBlockX * kBlockY)
openness_reduced_kernel(const float* __restrict__ Z, int64_t H, int64_t W,
                        const int* __restrict__ ladder,
                        const float* __restrict__ scales, int K, int Rmax,
                        float T, float* __restrict__ out0,
                        float* __restrict__ out1,
                        uint16_t* __restrict__ code) {
  const int64_t c = (int64_t)blockIdx.x * kBlockX + threadIdx.x;
  const int64_t r = (int64_t)blockIdx.y * kBlockY + threadIdx.y;
  if (r >= H || c >= W) return;
  const Pixel px = make_pixel(Z, H, W, r, c);
  float acc0 = 0.0f;
  float acc1 = 0.0f;
  unsigned tc = 0;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    float mx, mn;
    direction_extrema(px, d, W, ladder, scales, K, Rmax, mx, mn);
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

template <int kMode, bool kNegMode>
int launch(const float* Z, long long H, long long W, const int* ladder,
           const float* scales, int K, int Rmax, float T, float* out0,
           float* out1, uint16_t* code, cudaStream_t stream) {
  openness_reduced_kernel<kMode, kNegMode>
      <<<grid_for(H, W), dim3(kBlockX, kBlockY), 0, stream>>>(
          Z, (int64_t)H, (int64_t)W, ladder, scales, K, Rmax, T, out0, out1,
          code);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes (neilpy_tpu_torch/ops/cuda_scan.py).  ``mode``
// is 0 (openness: out0 = pos sum, out1 = neg sum), 1 (svf: out0) or 2
// (ternary: code, with ``neg_mode`` 0 or 1); the outputs a mode does not
// write may be null.  All pointers are device pointers; ``stream`` is a
// cudaStream_t.  Launches on that stream, does not synchronise, and
// returns cudaGetLastError(), or cudaErrorInvalidValue for an unknown
// mode.
extern "C" int openness_reduced_launch(const float* Z, long long H,
                                       long long W, const int* ladder,
                                       const float* scales, int K, int Rmax,
                                       int mode, int neg_mode, float T,
                                       float* out0, float* out1,
                                       unsigned short* code, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kOpenness:
      return launch<kOpenness, false>(Z, H, W, ladder, scales, K, Rmax, T,
                                      out0, out1, code, s);
    case kSvf:
      return launch<kSvf, false>(Z, H, W, ladder, scales, K, Rmax, T, out0,
                                 out1, code, s);
    case kTernary:
      return neg_mode ? launch<kTernary, true>(Z, H, W, ladder, scales, K,
                                               Rmax, T, out0, out1, code, s)
                      : launch<kTernary, false>(Z, H, W, ladder, scales, K,
                                                Rmax, T, out0, out1, code, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
