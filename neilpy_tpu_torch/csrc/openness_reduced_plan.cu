// K5 for the fused reductions: the static boundary plan of K2, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU's 9-patch launch plan as _reduced_call runs it with
// specialize=True (the default for the exact ladder of openness_pallas,
// skyview_pallas and ternary_pallas): neilpy_tpu/ops/pallas_scan.py:1017-
// 1041 -> _region_calls, with _reduced_kernel's static branch
// (pallas_scan.py:963-978) as the region body.  The plan and the one-launch
// design are those of openness_counts_plan.cu; the per-pixel body is K2's
// (openness_reduced.cuh), so the outputs equal K2's bit for bit and the
// plain version's within K2's tolerances.
//
// What bounds it on this card: K2's ladder and fold, instruction-issue
// bound (openness_reduced.cu); at 8192^2, lookup 50, the interior (about
// 97% of the blocks) is maskless in all 8 directions.  That interior runs
// the tiled body of ladder_tile.cuh with K2's fold as its epilogue, the
// same tile kernels as K2's (openness_reduced_tile.cu): the 32x64 tiles
// that lie wholly in the plan's interior region (ops/cuda_scan.py:
// tile_route), each with its Rmax halo in shared memory.  The per-thread
// kernel below runs the rest, its 1-D grid leaving out the tiles'
// rectangle; the tile body is the one maskless route, not ten.

#include "openness_reduced.cuh"

namespace {

using namespace neilpy_ladder;

template <int kMode, bool kNegMode, bool kDense>
__global__ void __launch_bounds__(kBlockX * kBlockY)
openness_reduced_plan_kernel(const float* __restrict__ Z, int64_t H,
                             int64_t W, const int* __restrict__ ladder,
                             const float* __restrict__ scales, int K,
                             int Rmax, int hy0, int hy1, int hx0, int hx1,
                             int64_t rlo, int64_t rhi,
                             unsigned rmasks, int64_t clo, int64_t chi,
                             unsigned cmasks, float T,
                             float* __restrict__ out0,
                             float* __restrict__ out1,
                             uint16_t* __restrict__ code) {
  const UnitPos u = unit_at((W + kBlockX - 1) / kBlockX, hy0, hy1, hx0, hx1);
  const unsigned unsafe =
      plan_unsafe_at(u.r0, u.c0, rlo, rhi, rmasks, clo, chi, cmasks);
  const int64_t c = u.c0 + threadIdx.x;
  const int64_t r = u.r0 + threadIdx.y;
  if (r >= H || c >= W) return;
  const Pixel px = make_pixel(Z, H, W, r, c);
  with_static_route(unsafe, [&](auto route) {
    reduced_pixel<kMode, kNegMode, kDense>(px, W, ladder, scales, K, Rmax,
                                           T, route, out0, out1, code);
  });
}

template <int kMode, bool kNegMode, bool kDense>
struct Launch {
  static int run(const float* Z, long long H, long long W, const int* ladder,
                 const float* scales, int K, int Rmax, int halo, int ty0,
                 int ty1, int tx0, int tx1, int tma, long long rlo,
                 long long rhi, unsigned rmasks, long long clo, long long chi,
                 unsigned cmasks, float T, float* out0, float* out1,
                 uint16_t* code, cudaStream_t stream) {
    const int err = reduced_tiles<kMode, kNegMode>(
        Z, H, W, ladder, scales, K, Rmax, halo, ty0, ty1, tx0, tx1, tma, T,
        out0, out1, code, stream);
    if (err != 0) return err;
    const UnitHole hole = unit_hole(halo, ty0, ty1, tx0, tx1);
    const unsigned blocks = unit_blocks(H, W, hole);
    if (blocks == 0) return 0;
    openness_reduced_plan_kernel<kMode, kNegMode, kDense>
        <<<blocks, dim3(kBlockX, kBlockY), 0, stream>>>(
            Z, (int64_t)H, (int64_t)W, ladder, scales, K, Rmax, hole.y0,
            hole.y1, hole.x0, hole.x1, (int64_t)rlo, (int64_t)rhi, rmasks,
            (int64_t)clo, (int64_t)chi, cmasks, T, out0, out1, code);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// C entry, bound with ctypes (neilpy_tpu_torch/ops/cuda_scan.py).  As
// openness_reduced_launch (tiles included: here the tiles of the plan's
// interior), plus the plan of openness_counts_plan_launch (``rlo``,
// ``rhi``, ``rmasks``, ``clo``, ``chi``, ``cmasks``).  Launches on
// ``stream``, does not synchronise, and returns cudaGetLastError() (or the
// tensor map's or the shared-memory attribute's error), or
// cudaErrorInvalidValue for an unknown mode.
extern "C" int openness_reduced_plan_launch(
    const float* Z, long long H, long long W, const int* ladder,
    const float* scales, int K, int Rmax, int dense, int halo, int ty0,
    int ty1, int tx0, int tx1, int tma, long long rlo, long long rhi,
    int rmasks, long long clo, long long chi, int cmasks, int mode,
    int neg_mode, float T, float* out0, float* out1, unsigned short* code,
    void* stream) {
  return dispatch_mode<Launch>(mode, neg_mode, dense, Z, H, W, ladder,
                               scales, K, Rmax, halo, ty0, ty1, tx0, tx1, tma,
                               rlo, rhi, (unsigned)rmasks, clo, chi,
                               (unsigned)cmasks, T, out0, out1, code,
                               (cudaStream_t)stream);
}
