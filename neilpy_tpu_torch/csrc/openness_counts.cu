// Geomorphon openness counts for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel neilpy_tpu/ops/pallas_scan.py:_counts_kernel
// (with its ladder _extrema_ladder and launcher _counts_call).  For every
// pixel p and each of the 8 directions d it keeps the running max mx and
// min mn over the ladder L_k of
//
//     ratio = (Z[p + d*L_k] - Z[p]) * scale[d][k],
//     scale[d][k] = f32(1 / (cellsize * w_d)) / f32(L_k)
//
// (the host builds the scale table, so no division happens here and the
// product matches pallas_scan.py:166,173 bit for bit).  NaN reads
// (nodata holes) fail both compares and are skipped; reads outside the
// raster are skipped the same way the TPU kernel skips its NaN pad.  If
// the last ladder step p + d*Rmax leaves the raster, mx >= 0 and mn <= 0
// are enforced (the reference's edge replication, pallas_scan.py:219-227).
// Each direction then votes num_pos / num_neg by comparing the openness
// difference atan(-mn) - atan(mx) with the threshold exactly in tangent
// space (pallas_scan.py:449-475).
//
// Exactness: every multiply and add of the ratio and of the classify step
// goes through __fmul_rn / __fadd_rn / __fsub_rn, which nvcc never fuses
// into an FMA, and the build passes -fmad=false as well.  With the shared
// scale table this gives counts equal to the plain PyTorch version
// (ops/cuda_scan.py:openness_counts_torch) on the card.
//
// What bounds it on this card: per pixel and direction, about R loads of
// Z and 4 flops (sub, mul, two compare-selects) per ladder step.  A warp
// reads 32 neighbouring floats of one row at every step, so the loads are
// coalesced and, with the ladder walking at most R rows away, served by
// L1/L2 rather than HBM.  Measured on an H100, instruction issue bounds
// it, not memory: the block shape (32x8, 64x4, 128x2, 16x16) moves the
// time by under 1%, while cutting the per-step bookkeeping does move it.
// So the directions are unrolled (offsets become constants) and each
// direction gets one 32-bit step limit, the largest L that stays on the
// raster, in place of four 64-bit bounds tests per step.  The simple
// design stays: one thread per output pixel in 32x8 blocks, reading Z
// through the read-only cache (__ldg).  A shared-memory tile with an R
// halo, TMA loads and a maskless interior path are later work.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__global__ void __launch_bounds__(kBlockX * kBlockY)
openness_counts_kernel(const float* __restrict__ Z, int64_t H, int64_t W,
                       const int* __restrict__ ladder,
                       const float* __restrict__ scales, int K, int Rmax,
                       float T, uint8_t* __restrict__ num_pos,
                       uint8_t* __restrict__ num_neg) {
  // (row, col) offset per direction, as core/shift.py:OFFSETS
  constexpr int kDR[8] = {-1, -1, -1, 0, 1, 1, 1, 0};
  constexpr int kDC[8] = {-1, 0, 1, 1, 1, 0, -1, -1};
  const int64_t c = (int64_t)blockIdx.x * kBlockX + threadIdx.x;
  const int64_t r = (int64_t)blockIdx.y * kBlockY + threadIdx.y;
  if (r >= H || c >= W) return;

  const int64_t p = r * W + c;
  const float* zp = Z + p;
  const float core = __ldg(zp);
  // steps left to each raster edge (clamped so a huge raster cannot wrap)
  const int up = (int)min(r, (int64_t)INT_MAX);
  const int down = (int)min(H - 1 - r, (int64_t)INT_MAX);
  const int left = (int)min(c, (int64_t)INT_MAX);
  const int right = (int)min(W - 1 - c, (int64_t)INT_MAX);
  int n_pos = 0;
  int n_neg = 0;

#pragma unroll
  for (int d = 0; d < 8; ++d) {
    const int dr = kDR[d];
    const int dc = kDC[d];
    // the largest L whose read p + d*L is still on the raster
    const int lim = min(dr < 0 ? up : (dr > 0 ? down : INT_MAX),
                        dc < 0 ? left : (dc > 0 ? right : INT_MAX));
    const int64_t step = (int64_t)dr * W + dc;
    float mx = -CUDART_INF_F;
    float mn = CUDART_INF_F;
    for (int k = 0; k < K; ++k) {
      const int L = __ldg(ladder + k);
      // the ladder increases, so the first step off the raster ends it
      if (L > lim) break;
      const float src = __ldg(zp + step * L);
      const float ratio =
          __fmul_rn(__fsub_rn(src, core), __ldg(scales + d * K + k));
      if (ratio > mx) mx = ratio;
      if (ratio < mn) mn = ratio;
    }
    if (Rmax > lim) {  // p + d*Rmax is off the raster
      mx = fmaxf(mx, 0.0f);
      mn = fminf(mn, 0.0f);
    }

    // diff = atan(a) - atan(b) with a = -mn, b = mx:
    //   diff > t  <=>  (1 + ab > 0) ? (a - b) > tan(t) (1 + ab) : a > b
    const float a = -mn;
    const float b = mx;
    const float denom = __fadd_rn(1.0f, __fmul_rn(a, b));
    const float s = __fsub_rn(a, b);
    const float td = __fmul_rn(T, denom);
    const bool wide = denom <= 0.0f;
    const bool narrow = denom > 0.0f;
    const bool seen = mx > -CUDART_INF_F;
    const bool gt = (wide && a > b) || (narrow && s > td);
    const bool lt = (wide && a < b) || (narrow && s < -td);
    n_pos += (gt && seen) ? 1 : 0;
    n_neg += (lt && seen) ? 1 : 0;
  }
  num_pos[p] = (uint8_t)n_pos;
  num_neg[p] = (uint8_t)n_neg;
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
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((unsigned)((W + kBlockX - 1) / kBlockX),
                  (unsigned)((H + kBlockY - 1) / kBlockY));
  openness_counts_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      Z, (int64_t)H, (int64_t)W, ladder, scales, K, Rmax, T, num_pos,
      num_neg);
  return (int)cudaGetLastError();
}
