// The tiled interior body of the ladder kernels: K1 (openness_counts.cu),
// K5/counts (openness_counts_plan.cu), K4 (openness_counts_block.cu), K3,
// both entries (directional_extrema.cu), and K2 (openness_reduced.cu) and
// K5/reduced (openness_reduced_plan.cu), whose tile kernels are built once
// for both in openness_reduced_tile.cu.  A thread block (CTA) owns a core
// of kTileH x kTileW output pixels, copies the core with an Rmax-wide halo
// into shared memory once, and runs every ladder step of the core from
// there, kTileRows x kTileCols pixels per thread.
//
// Replaces, for the all-safe interior, the TPU kernels' R-haloed window
// (neilpy_tpu/ops/pallas_scan.py:_counts_kernel, _extrema_kernel and
// _reduced_kernel, their VMEM ``win`` filled by one DMA per tile), which
// the per-thread bodies of ladder.cuh leave to L1.
//
// Where it runs: only on tiles whose whole window, the core shifted by
// d*1 .. d*Rmax in all 8 directions, lies on the array and, for a shard
// block (K4, K3's origin entry), inside the global raster, so every
// direction takes the maskless step (ladder.cuh:scan_ladder_safe), no read
// needs a test and no last step needs the edge epilogue.  The host picks
// the tiles (ops/cuda_scan.py:tile_route): for K1, K2, K3 and K4 the tiles
// where the block predicate (window_on, safe_directions_global_at) holds in
// every direction, for K5 (both) the tiles that lie wholly in the plan's
// interior region.  They form a rectangle of tiles of a grid that starts at
// array pixel (row0, col0) (TileFrame: K4's grid is its core, at (R, R)),
// which the per-thread kernels leave out of their grid (unit_at below);
// every other pixel runs the per-thread bodies with their per-32x8-block
// routing, unchanged.  A window that does not fit in shared memory (Rmax
// plus the column shift above the largest halo bucket, or more than the
// 232,448 bytes one block may use: exact lookup 95 and up) gets no tile,
// and the whole grid runs the per-thread bodies.
//
// What a tile makes of the extrema is the kernel's template parameter, its
// epilogue: the counts (CountsOut: classify and two uint8 votes, at an
// output pitch of their own, so K4 writes its core-shaped outputs), the
// planes (PlanesOut: K3's mx and mn, stored per direction) or K2's fold
// (ReducedOut, openness_reduced.cuh: each direction folded into register
// accumulators, the openness sums, the svf sum or the ternary code stored
// after the last).  The step loop is one.
//
// The window: (kTileH + 2 Rmax) rows of a pitch of kTileW + 2 kHalo floats,
// kHalo a compile-time bucket >= Rmax + tile_shift(col0) (16, 32, 48, 64,
// 96), so every pixel's offset from the thread's first pixel is an
// immediate.  Each bucket is a multiple of 16 floats, so the TMA box starts
// 64-B aligned and its rows are a multiple of 128 B: on an H100 a bucket of 50 (a box of
// 164-float rows starting 8 B off a 16-B boundary) stopped the kernel with
// an illegal instruction, while the buckets 16, 32 and 96 ran.  That the
// alignment was the cause is a hypothesis, not established; every bucket
// runs on both load paths in chip_smoke.py (tile_reaches_vs_plain).  Two
// load paths, chosen by the host by one rule (ops/cuda_scan.py:_tile_load):
// - TMA (cp.async.bulk.tensor.2d with an mbarrier) when the row pitch is a
//   multiple of 16 B and Z is 16-B aligned, as TMA needs: one box of the
//   whole pitch, array columns c0 - s - kHalo .. c0 - s + kTileW + kHalo
//   for a core at array column c0, s = tile_shift(col0) (so the box starts
//   on a multiple of 16 floats, as on a whole raster, where s = 0; the
//   columns beyond Rmax may fall off the array: TMA fills them and no step
//   reads them).  The tensor map comes from cuTensorMapEncodeTiled through
//   cudaGetDriverEntryPoint, so the build links no driver library.
// - cp.async, 4 bytes a thread, for any other raster (W % 4 != 0): only
//   the columns c0 - Rmax .. c0 + kTileW + Rmax.  About 85 copies a
//   thread at lookup 50; forced onto an aligned 8192^2 raster it takes
//   10-23% longer than TMA's one copy a tile (tools/tile_ab.py).
//
// The step: each (direction, entry) pair has a precomputed window offset
// (dr*pitch + dc) * L_k and scale[d][k] in a shared table, read once per
// step per thread as one 8-byte broadcast load, so the dense and the sparse
// fast ladder run the same code.  Per pixel-step: one shared load, sub,
// mul, max, min.  The 32 lanes of a warp hold 32 consecutive columns, so
// each load reads 32 consecutive floats: no bank conflict.
//
// What bounds it on this card: instruction issue, as the per-thread
// bodies, but at about 5.4 SASS instructions per pixel-step against 8.9
// (tools/ladder_sass.py); the window is read from L2 once per tile.  K3's
// planes add 64 B of stores per pixel (4.3 GB at 8192^2, about 1.3 ms at
// the HBM rate), issued per direction while other CTAs run their ladders.
// K2's fold adds, per pixel and direction, two atanf (openness), a divide
// and a square root (svf) or a tangent-space compare (ternary), held in
// registers.  At exact lookup 50 a tile takes 104,712 bytes of shared
// memory, so two tiles (16 warps) share an SM.
//
// Exactness: the ratio is the maskless body's, __fmul_rn(__fsub_rn(src,
// core), scale) from the same host table, kept with fmaxf / fminf (a NaN
// read is skipped), and each direction votes through ladder.cuh:classify,
// so the counts equal the per-thread bodies' and the plain version's bit
// for bit, and the planes equal them by value (fmaxf may keep +0 for -0).
// The reductions fold each direction by the per-thread body's own
// function (openness_reduced.cuh:fold_direction) in the same order, so
// they equal the per-thread bodies' bit for bit.

#pragma once

#include <cuda.h>
#include <string.h>

#include "ladder.cuh"

namespace neilpy_ladder {

// The kernel and the host functions below are static: each source that
// includes this file gets its own copy of the kernels it instantiates, so
// no kernel is registered twice in the library.

// the core of one tile CTA and its thread layout: 32x8 threads, the
// routing unit of the per-thread bodies, each with kTileRows x kTileCols
// pixels, kBlockY rows and kBlockX columns apart
constexpr int kTileH = 32;
constexpr int kTileW = 64;
constexpr int kTileRows = kTileH / kBlockY;
constexpr int kTileCols = kTileW / kBlockX;

struct alignas(8) TileStep {
  int off;      // (dr * pitch + dc) * L_k, in floats
  float scale;  // scale[d][k]
};

// Bytes of dynamic shared memory of one tile CTA (ops/cuda_scan.py:
// tile_route mirrors this): 128 to align the window, the window, the step
// table and the mbarrier.
__host__ __device__ constexpr long long tile_smem_bytes(int halo, int Rmax,
                                                        int K) {
  return 128 + 4LL * (kTileH + 2 * Rmax) * (kTileW + 2 * halo) +
         8LL * 8 * K + 8;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void tma_load_window(float* dst,
                                                const CUtensorMap* map,
                                                int col, int row,
                                                uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(col),
      "r"(row), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbarrier_wait(uint64_t* bar, uint32_t phase) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(phase) : "memory");
  }
}

// Where a launch's tiles lie: tile (ty, tx), ty0 <= ty, tx0 <= tx, covers
// the pixels [ty * kTileH, +kTileH) x [tx * kTileW, +kTileW) of a grid
// whose pixel (0, 0) is the array's pixel (row0, col0): (0, 0) for a whole
// raster and K3's shard block, (R, R) for K4's core.
struct TileFrame {
  int ty0, tx0, row0, col0;
};

// The window's columns start kHalo + tile_shift(col0) columns left of the
// core, so that the TMA box starts where it does on a whole raster: on a
// multiple of 16 floats of the array, whatever col0 is.  The host takes a
// halo bucket >= Rmax + tile_shift(col0) (ops/cuda_scan.py:tile_route).
__host__ __device__ constexpr int tile_shift(int col0) { return col0 & 15; }

// What a tile does with each direction's extrema, as a template parameter
// of the kernel: ``direction`` after the ladder of direction d, ``finish``
// after all eight; (r, c) is the thread's first pixel in the grid, its
// others kBlockY rows and kBlockX columns apart.
//
// The counts (K1, K5/counts, K4): ladder.cuh:classify and the two uint8
// votes, written at grid pixel (r, c) -> r * pitch + c.
struct CountsOut {
  float T;
  uint8_t* num_pos;
  uint8_t* num_neg;
  int64_t pitch;
  struct Acc {
    int pos[kTileRows][kTileCols];
    int neg[kTileRows][kTileCols];
  };

  __device__ __forceinline__ void direction(
      Acc& acc, int, const float (&mx)[kTileRows][kTileCols],
      const float (&mn)[kTileRows][kTileCols], int64_t, int64_t) const {
#pragma unroll
    for (int i = 0; i < kTileRows; ++i)
#pragma unroll
      for (int j = 0; j < kTileCols; ++j) {
        bool gt, lt;
        classify(mx[i][j], mn[i][j], T, gt, lt);
        acc.pos[i][j] += gt ? 1 : 0;
        acc.neg[i][j] += lt ? 1 : 0;
      }
  }

  __device__ __forceinline__ void finish(const Acc& acc, int64_t r,
                                         int64_t c) const {
#pragma unroll
    for (int i = 0; i < kTileRows; ++i)
#pragma unroll
      for (int j = 0; j < kTileCols; ++j) {
        const int64_t p = (r + i * kBlockY) * pitch + c + j * kBlockX;
        num_pos[p] = (uint8_t)acc.pos[i][j];
        num_neg[p] = (uint8_t)acc.neg[i][j];
      }
  }
};

// The planes (K3): direction d's mx and mn stored as soon as its ladder
// ends, at d * plane + r * pitch + c (the grid is the array), a warp
// writing 32 consecutive floats of one plane row per pixel.
struct PlanesOut {
  float* mx_out;
  float* mn_out;
  int64_t pitch, plane;
  struct Acc {};

  __device__ __forceinline__ void direction(
      Acc&, int d, const float (&mx)[kTileRows][kTileCols],
      const float (&mn)[kTileRows][kTileCols], int64_t r, int64_t c) const {
#pragma unroll
    for (int i = 0; i < kTileRows; ++i)
#pragma unroll
      for (int j = 0; j < kTileCols; ++j) {
        const int64_t p = d * plane + (r + i * kBlockY) * pitch + c +
                          j * kBlockX;
        mx_out[p] = mx[i][j];
        mn_out[p] = mn[i][j];
      }
  }

  __device__ __forceinline__ void finish(const Acc&, int64_t, int64_t) const {
  }
};

// The tile (f.ty0 + blockIdx.y, f.tx0 + blockIdx.x) of the (., W) array Z;
// the host guarantees its window lies on the array (and, for a shard block,
// inside the global raster) and kHalo >= Rmax + tile_shift(f.col0).
template <int kHalo, class Out>
static __global__ void __launch_bounds__(kBlockX * kBlockY, 2)
ladder_tile_kernel(const __grid_constant__ CUtensorMap map, int tma,
                   const float* __restrict__ Z, int64_t W,
                   const int* __restrict__ ladder,
                   const float* __restrict__ scales, int K, int Rmax,
                   TileFrame f, Out out) {
  constexpr int kPitch = kTileW + 2 * kHalo;
  extern __shared__ unsigned char smem[];
  float* win = reinterpret_cast<float*>(
      smem + ((128u - (smem_addr(smem) & 127u)) & 127u));
  const int rows = kTileH + 2 * Rmax;
  TileStep* tab = reinterpret_cast<TileStep*>(win + rows * kPitch);
  uint64_t* bar = reinterpret_cast<uint64_t*>(tab + 8 * K);
  // the tile's first pixel in the grid, and in the array
  const int64_t r0 = (int64_t)(f.ty0 + (int)blockIdx.y) * kTileH;
  const int64_t c0 = (int64_t)(f.tx0 + (int)blockIdx.x) * kTileW;
  const int64_t ar0 = f.row0 + r0;
  const int64_t ac0 = f.col0 + c0;
  // the core's first column in the window
  const int left = kHalo + tile_shift(f.col0);
  const int tid = threadIdx.y * kBlockX + threadIdx.x;

  if (tma) {
    if (tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   ::"r"(smem_addr(bar)) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      tma_load_window(win, &map, (int)(ac0 - left), (int)(ar0 - Rmax), bar,
                      rows * kPitch * 4);
    }
  } else {
    const float* src = Z + (ar0 - Rmax) * W + (ac0 - Rmax);
    const int cols = kTileW + 2 * Rmax;
    for (int r = threadIdx.y; r < rows; r += kBlockY)
      for (int c = threadIdx.x; c < cols; c += kBlockX)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                     ::"r"(smem_addr(win + r * kPitch + left - Rmax + c)),
                     "l"(src + r * W + c) : "memory");
    asm volatile("cp.async.wait_all;" ::: "memory");
  }
  // the step table, while the window arrives
  for (int i = tid; i < 8 * K; i += kBlockX * kBlockY) {
    const int d = i / K;
    const int L = __ldg(ladder + i - d * K);
    tab[i] = TileStep{(dir_dr(d) * kPitch + dir_dc(d)) * L, __ldg(scales + i)};
  }
  __syncthreads();  // the table, the cp.async window and the mbarrier's init
  if (tma) mbarrier_wait(bar, 0);

  // the thread's first pixel in the window; its others are immediates away
  const float* base = win + (Rmax + threadIdx.y) * kPitch + left + threadIdx.x;
  float core[kTileRows][kTileCols];
#pragma unroll
  for (int i = 0; i < kTileRows; ++i)
#pragma unroll
    for (int j = 0; j < kTileCols; ++j)
      core[i][j] = base[i * kBlockY * kPitch + j * kBlockX];
  typename Out::Acc acc = {};

#pragma unroll 1
  for (int d = 0; d < 8; ++d) {
    float mx[kTileRows][kTileCols], mn[kTileRows][kTileCols];
#pragma unroll
    for (int i = 0; i < kTileRows; ++i)
#pragma unroll
      for (int j = 0; j < kTileCols; ++j) {
        mx[i][j] = -CUDART_INF_F;
        mn[i][j] = CUDART_INF_F;
      }
    const TileStep* t = tab + d * K;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const TileStep e = t[k];
      const float* q = base + e.off;
#pragma unroll
      for (int i = 0; i < kTileRows; ++i)
#pragma unroll
        for (int j = 0; j < kTileCols; ++j) {
          const float ratio = __fmul_rn(
              __fsub_rn(q[i * kBlockY * kPitch + j * kBlockX], core[i][j]),
              e.scale);
          mx[i][j] = fmaxf(mx[i][j], ratio);
          mn[i][j] = fminf(mn[i][j], ratio);
        }
    }
    // the thread's first pixel in the grid, computed where it is used
    // (held across the loop it costs the counts body 2 registers)
    out.direction(acc, d, mx, mn, r0 + threadIdx.y, c0 + threadIdx.x);
  }
  out.finish(acc, r0 + threadIdx.y, c0 + threadIdx.x);
}

// cuTensorMapEncodeTiled, from the driver the runtime has loaded.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found =
        cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// The tensor map of the (H, W) float array Z with a box of one window.
static int window_map(CUtensorMap* map, const float* Z, long long H,
                      long long W, int box_w, int box_h) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)W, (cuuint64_t)H};
  const cuuint64_t strides[1] = {(cuuint64_t)W * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_w, (cuuint32_t)box_h};
  const cuuint32_t one[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)Z, dims, strides, box,
      one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int kHalo, class Out>
static int launch_tile_bucket(const float* Z, long long H, long long W,
                              const int* ladder, const float* scales, int K,
                              int Rmax, TileFrame f, int ty1, int tx1,
                              int tma, Out out, cudaStream_t stream) {
  if (Rmax + tile_shift(f.col0) > kHalo) return (int)cudaErrorInvalidValue;
  const long long bytes = tile_smem_bytes(kHalo, Rmax, K);
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (tma) {
    const int err = window_map(&map, Z, H, W, kTileW + 2 * kHalo,
                               kTileH + 2 * Rmax);
    if (err != 0) return err;
  }
  // above 48 KB a kernel must opt in; a launch asking for more than the
  // attribute allows is refused, and cudaGetLastError reports it
  const cudaError_t attr = cudaFuncSetAttribute(
      ladder_tile_kernel<kHalo, Out>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr != cudaSuccess) return (int)attr;
  ladder_tile_kernel<kHalo, Out>
      <<<dim3(tx1 - f.tx0, ty1 - f.ty0), dim3(kBlockX, kBlockY), bytes,
         stream>>>(map, tma, Z, (int64_t)W, ladder, scales, K, Rmax, f, out);
  return (int)cudaGetLastError();
}

// Launch the tile kernel with the epilogue ``out`` over tiles [ty0, ty1) x
// [tx0, tx1) of the grid at (row0, col0) of the (H, W) array Z, in the halo
// bucket ``halo`` (0, or an empty rectangle: no tile), loaded by TMA
// (``tma`` 1) or cp.async (0).
template <class Out>
static int launch_tiles(const float* Z, long long H, long long W,
                        const int* ladder, const float* scales, int K,
                        int Rmax, int halo, int ty0, int ty1, int tx0,
                        int tx1, int tma, int row0, int col0, Out out,
                        cudaStream_t stream) {
  if (halo == 0 || ty1 <= ty0 || tx1 <= tx0) return 0;
  const TileFrame f{ty0, tx0, row0, col0};
#define NEILPY_TILES(h)                                                    \
  case h:                                                                  \
    return launch_tile_bucket<h>(Z, H, W, ladder, scales, K, Rmax, f, ty1, \
                                 tx1, tma, out, stream);
  switch (halo) {
    NEILPY_TILES(16)
    NEILPY_TILES(32)
    NEILPY_TILES(48)
    NEILPY_TILES(64)
    NEILPY_TILES(96)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NEILPY_TILES
}

// The first pixel of this thread block in a 1-D grid that enumerates, row
// by row, the 32x8 blocks of a grid nbx blocks wide minus the hole of
// blocks [hy0, hy1) x [hx0, hx1), which the tile kernel covers; an empty
// hole enumerates the whole grid.  Against a whole 2-D grid whose blocks
// inside the tiles return at once (about 97% of them at 8192^2), it saves
// 0.05-0.15 ms a launch on an H100 (tools/tile_ab.py on both versions).
struct UnitPos {
  int64_t r0, c0;
};

__device__ __forceinline__ UnitPos unit_at(int64_t nbx, int hy0, int hy1,
                                           int hx0, int hx1) {
  int64_t i = blockIdx.x;
  int64_t by, bx;
  const int64_t above = (int64_t)hy0 * nbx;
  const int64_t hw = hx1 - hx0;
  const int64_t beside = (int64_t)(hy1 - hy0) * (nbx - hw);
  if (i < above) {
    by = i / nbx;
    bx = i - by * nbx;
  } else if (i - above < beside) {
    i -= above;
    by = i / (nbx - hw);
    bx = i - by * (nbx - hw);
    by += hy0;
    if (bx >= hx0) bx += hw;
  } else {
    i -= above + beside;
    by = i / nbx;
    bx = i - by * nbx;
    by += hy1;
  }
  return {by * kBlockY, bx * kBlockX};
}

// The tiles' rectangle in 32x8 blocks (a tile is kTileRows x kTileCols
// of them), the hole the per-thread kernels' 1-D grid leaves out
// (unit_at); empty without tiles.
struct UnitHole {
  int y0, y1, x0, x1;
};

static UnitHole unit_hole(int halo, int ty0, int ty1, int tx0, int tx1) {
  if (halo == 0 || ty1 <= ty0 || tx1 <= tx0) return {0, 0, 0, 0};
  return {ty0 * kTileRows, ty1 * kTileRows, tx0 * kTileCols,
          tx1 * kTileCols};
}

// The per-thread kernels' 1-D grid: the 32x8 blocks of the raster minus
// the hole.
static unsigned unit_blocks(long long H, long long W, UnitHole h) {
  const long long nby = (H + kBlockY - 1) / kBlockY;
  const long long nbx = (W + kBlockX - 1) / kBlockX;
  return (unsigned)(nby * nbx - (long long)(h.y1 - h.y0) * (h.x1 - h.x0));
}

}  // namespace neilpy_ladder
