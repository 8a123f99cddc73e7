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
// epilogue and, on the dense exact ladder, no loaded ladder entry.  A
// shared-memory tile with an R halo and TMA loads are later work.

#include "openness_counts.cuh"

namespace {

using namespace neilpy_ladder;

template <bool kDense>
__global__ void __launch_bounds__(kBlockX * kBlockY)
openness_counts_kernel(const float* __restrict__ Z, int64_t H, int64_t W,
                       const int* __restrict__ ladder,
                       const float* __restrict__ scales, int K, int Rmax,
                       unsigned allow, float T,
                       uint8_t* __restrict__ num_pos,
                       uint8_t* __restrict__ num_neg) {
  const DynamicRoute route{safe_directions(allow, Rmax, H, W)};
  const int64_t c = (int64_t)blockIdx.x * kBlockX + threadIdx.x;
  const int64_t r = (int64_t)blockIdx.y * kBlockY + threadIdx.y;
  if (r >= H || c >= W) return;
  const Pixel px = make_pixel(Z, H, W, r, c);
  counts_pixel<kDense>(px, W, ladder, scales, K, Rmax, T, route, num_pos,
                       num_neg);
}

template <bool kDense>
int launch(const float* Z, long long H, long long W, const int* ladder,
           const float* scales, int K, int Rmax, unsigned allow, float T,
           uint8_t* num_pos, uint8_t* num_neg, cudaStream_t stream) {
  openness_counts_kernel<kDense>
      <<<grid_for(H, W), dim3(kBlockX, kBlockY), 0, stream>>>(
          Z, (int64_t)H, (int64_t)W, ladder, scales, K, Rmax, allow, T,
          num_pos, num_neg);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes (neilpy_tpu_torch/ops/cuda_scan.py).  All
// pointers are device pointers; ``dense`` says the ladder is 1..K; bit d
// of ``allow`` lets direction d take the maskless ladder where it is safe
// (0xFF; 0 runs the masked ladder everywhere); ``stream`` is a
// cudaStream_t.  Launches on that stream, does not synchronise, and
// returns cudaGetLastError().
extern "C" int openness_counts_launch(const float* Z, long long H,
                                      long long W, const int* ladder,
                                      const float* scales, int K, int Rmax,
                                      int dense, unsigned allow,
                                      float T, unsigned char* num_pos,
                                      unsigned char* num_neg, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return dense ? launch<true>(Z, H, W, ladder, scales, K, Rmax, allow, T,
                              num_pos, num_neg, s)
               : launch<false>(Z, H, W, ladder, scales, K, Rmax, allow, T,
                               num_pos, num_neg, s);
}
