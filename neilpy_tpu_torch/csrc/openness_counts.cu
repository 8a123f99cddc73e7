// Geomorphon openness counts for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel neilpy_tpu/ops/pallas_scan.py:_counts_kernel
// (with its ladder _extrema_ladder and launcher _counts_call).  For every
// pixel and each of the 8 directions it runs the scan ladder of
// ladder.cuh (running max mx and min mn of the slope ratio, NaN skipped,
// the edge-replication epilogue), then each direction votes num_pos /
// num_neg by comparing the openness difference atan(-mn) - atan(mx) with
// the threshold exactly in tangent space (pallas_scan.py:449-475).
//
// Exactness: no multiply-add is fused (ladder.cuh), and the kernel shares
// the host scale table with the plain PyTorch version
// (ops/cuda_scan.py:openness_counts_torch), so their counts are equal on
// the card.
//
// What bounds it on this card: per pixel and direction, about R loads of
// Z and 4 flops (sub, mul, two compare-selects) per ladder step.  A warp
// reads 32 neighbouring floats of one row at every step, so the loads are
// coalesced and, with the ladder walking at most R rows away, served by
// L1/L2 rather than HBM.  Measured on an H100, instruction issue bounds
// it, not memory: the block shape (32x8, 64x4, 128x2, 16x16) moves the
// time by under 1%, while cutting the per-step bookkeeping does move it.
// So the directions are unrolled (offsets become constants) and each
// direction gets one 32-bit step limit.  The simple design stays: one
// thread per output pixel in 32x8 blocks, reading Z through the read-only
// cache (__ldg).  A shared-memory tile with an R halo, TMA loads and a
// maskless interior path are later work.

#include "ladder.cuh"

namespace {

using namespace neilpy_ladder;

__global__ void __launch_bounds__(kBlockX * kBlockY)
openness_counts_kernel(const float* __restrict__ Z, int64_t H, int64_t W,
                       const int* __restrict__ ladder,
                       const float* __restrict__ scales, int K, int Rmax,
                       float T, uint8_t* __restrict__ num_pos,
                       uint8_t* __restrict__ num_neg) {
  const int64_t c = (int64_t)blockIdx.x * kBlockX + threadIdx.x;
  const int64_t r = (int64_t)blockIdx.y * kBlockY + threadIdx.y;
  if (r >= H || c >= W) return;
  const Pixel px = make_pixel(Z, H, W, r, c);
  int n_pos = 0;
  int n_neg = 0;
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    float mx, mn;
    direction_extrema(px, d, W, ladder, scales, K, Rmax, mx, mn);
    bool gt, lt;
    classify(mx, mn, T, gt, lt);
    n_pos += gt ? 1 : 0;
    n_neg += lt ? 1 : 0;
  }
  num_pos[px.p] = (uint8_t)n_pos;
  num_neg[px.p] = (uint8_t)n_neg;
}

}  // namespace

// C entry, bound with ctypes (neilpy_tpu_torch/ops/cuda_scan.py).  All
// pointers are device pointers; ``stream`` is a cudaStream_t.  Launches
// on that stream, does not synchronise, and returns cudaGetLastError().
extern "C" int openness_counts_launch(const float* Z, long long H,
                                      long long W, const int* ladder,
                                      const float* scales, int K, int Rmax,
                                      float T, unsigned char* num_pos,
                                      unsigned char* num_neg, void* stream) {
  openness_counts_kernel<<<grid_for(H, W), dim3(kBlockX, kBlockY), 0,
                           (cudaStream_t)stream>>>(
      Z, (int64_t)H, (int64_t)W, ladder, scales, K, Rmax, T, num_pos,
      num_neg);
  return (int)cudaGetLastError();
}
