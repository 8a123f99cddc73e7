// Binary footprint sums and the Getis-Ord Gi / Gi* epilogue for NVIDIA
// Hopper (sm_90a): one launch computes ops/surface.py:binary_footprint_sum
// of a raster for any boolean footprint, or both sums rasterGi needs (the
// finite count and the sum of the finite values) from one read of the
// raster, with Gi's z, two-tailed p and significance bins formed in
// registers and written once.
//
// Replaces no TPU kernel: the JAX package's binary_footprint_sum
// (neilpy_tpu/ops/surface.py:65) and rasterGi (neilpy_tpu/ops/stats.py:54)
// are XLA ops.  Added because the plain version (_footprint_sum_torch,
// _raster_gi_torch) pads the raster, builds power-of-two column partials
// as whole planes, then adds one strided slice a run piece and one plane a
// run: about 110 launches for disk 13, each reading and writing a whole
// plane, two such sums a radius and some 25 whole-plane ops for the
// epilogue.  On an 8192^2 raster that moves about 50 times the bytes the
// work needs (one read of X, the outputs written once: 16 B a pixel for
// Gi, 8 for one sum).
//
// The footprint arrives as a table (the host's _footprint_plan): per
// footprint row its horizontal runs in ops/surface.py:_runs order, each run
// split into power-of-two pieces from the widest down, a piece its offset
// in the staged partials with a last-of-its-run flag.  The table travels
// by value as a __grid_constant__ parameter, read through the constant
// cache (the reads are uniform across a warp), so a launch needs no upload
// and no synchronise.  A footprint with more rows or pieces than one table
// holds runs in row bands, one launch each, in order, each band adding to
// the sums the one before stored.
//
// Design.  A block of 1024 threads owns a tile of 32 output rows by 128
// output columns: a thread one column and 4 neighbouring rows, their sums
// in registers.  The block stages the tile's input window (32 + rows - 1
// raster rows, its footprint halo included) in shared memory: the raw rows
// by cp.async, the padding folded into the load (a clamped index for
// 'nearest', a mirrored one for 'reflect'; neither the padded raster nor a
// partial plane is ever written to device memory), then its power-of-two
// partials level by level, column-major so that a thread's 4 rows are 4
// neighbouring words (one address, immediate offsets) and a warp's 32
// columns 32 banks (an odd column stride).  Each thread then adds, for
// each footprint row, that row's runs to its 4 rows: each piece one table
// read, 4 shared-memory loads and 4 adds, each run's sum added to its row's
// sum.  The whole window is one batch where it fits in shared memory (disk
// 13: 58 rows, 217 KB), so every warp has the same work between two
// barriers; a taller footprint is staged in batches, the next batch's raw
// rows arriving while this one is summed.  Gi's second channel, the finite
// count, is the band's cells less the footprint sum of a non-finite
// indicator, which a batch builds and sums in the same space only if it has
// a non-finite pixel, so a batch without voids reads one channel.  The sums
// are written at the end, or, for Gi, Z, P and bins.
//
// Exactness: the results equal the plain version's on the card bit for
// bit.  A partial is partial[2k][c] = partial[k][c] + partial[k][c + k],
// the plain version's tree; a run is its pieces from the widest down; a
// sum starts from +0 and adds the runs in _runs order.  Since a sum that
// starts from +0 is never -0, a run's sign of zero never shows, so a run
// starts as +0 + its first piece; counts are integers below 2^24, exact in
// any order.  The epilogue rounds as the torch ops do: each operation is
// one intrinsic (no FMA contraction; the build also passes -fmad=false),
// `x / math.sqrt(2.0)` is a multiply by the reciprocal the host rounds in
// float32 (PyTorch's CPU-scalar branch of div_true), 0.5 * erfc and 2.0 *
// that are two multiplies, erfcf is the one torch's erfc calls, and the
// comparisons read the float32 roundings of .1, .05 and .01.
//
// What bounds it: not the bytes (X once and the outputs once are 0.32 ms
// for Gi at 8192^2 at 3.35 TB/s) but the instructions the run pieces take:
// 78 pieces a pixel for disk 13 and 23 for disk 5, about five instructions
// a piece and row (about 3.5 ms for disk 13 on an H100, PERF.md section
// 6).  Three choices keep it there.  Shared memory is addressed through
// 32-bit shared-window addresses kept in registers (lds/sts below): with
// generic pointers the compiler rebuilt the window's base, a long-latency
// S2R, before every load once registers were short.  A footprint row's
// pieces serve a thread's 4 rows from one table read and one address.  And
// the whole window is one batch where it fits: staged in batches, the row
// groups whose rows a batch does not reach idle at its barriers, and the
// busiest group did about twice the average work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 128;       // output columns a block, one a thread
constexpr int kGroups = 8;       // row groups a block
constexpr int kPer = 4;          // output rows a thread keeps in registers
constexpr int kRows = kGroups * kPer;  // output rows a block
constexpr int kThreads = kCols * kGroups;
constexpr int kMaxRows = 256;    // footprint rows one table holds
constexpr int kMaxPieces = 768;  // run pieces one table holds
constexpr int kGuard = 4;        // words around the partials (see the reads)
constexpr uint32_t kLast = 1u << 31;  // a piece's flag: the last of its run

// One band of the footprint (ops/surface.py:_footprint_plan), by value.
// The staged partials lie column-major, [level][column][row], a column's
// rows cs apart (cs odd, so a warp's 32 columns hit 32 banks).
struct Table {
  int rows;    // footprint rows of the band
  int row0;    // X row of output row 0's first band row: band start - ph
  int col0;    // X column of output column 0's first footprint column: -pw
  int n;       // staged columns: kCols + span - 1
  int cs;      // words between two staged columns: odd, at least rb
  int levels;  // power-of-two partial levels, 1 (the values) and up
  int rb;      // input rows a shared-memory batch
  int cells;   // the band's footprint cells: a pixel's count if all finite
  uint16_t start[kMaxRows + 1];  // row dr's pieces: [start[dr], start[dr+1])
  // a piece: its word offset from a thread's column at level 0 (level * n
  // * cs + column offset * cs), | kLast on a run's last piece
  uint32_t piece[kMaxPieces];
};

// Gi's epilogue: outputs, the whole-map scalars on the device (star: nf,
// gm, gv; otherwise nf, nansum(X), nansum(X ** 2)), and whether P and the
// bins are wanted (not under apply_correction, whose tail is torch's).
struct GiArgs {
  float* Z;
  float* P;
  float* bins;
  const float* nf;
  const float* m0;
  const float* m1;
  int star;
  int with_p;
  float inv_sqrt2;
};

// The raster index a padded index c reads on an axis of n: clamped
// ('nearest', numpy 'edge') or mirrored with the edge repeated, period 2n
// ('reflect', numpy 'symmetric'), as core/shift.py:_pad_index.
__device__ __forceinline__ int source(int c, int n, int reflect) {
  if (reflect) {
    int k = c % (2 * n);
    if (k < 0) k += 2 * n;
    return k < n ? k : 2 * n - 1 - k;
  }
  return c < 0 ? 0 : (c >= n ? n - 1 : c);
}

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

// Gi's z, p and bin of one pixel from its sums, as ops/stats.py:
// _raster_gi_torch's torch ops round them.
__device__ __forceinline__ void gi_pixel(const GiArgs& g, float x, float sum,
                                         float count, float nf, float m0,
                                         float m1, int64_t k) {
  const bool fin = isfinite(x);
  const float w = fin ? rintf(count) : qnan();
  float gm, gv, den, rest;
  if (g.star) {
    gm = m0;
    gv = m1;
    den = __fsub_rn(nf, 1.0f);
    rest = __fsub_rn(nf, w);
  } else {
    const float nf1 = __fsub_rn(nf, 1.0f);
    gm = __fdiv_rn(__fsub_rn(m0, x), nf1);
    gv = __fsub_rn(__fdiv_rn(__fsub_rn(m1, __fmul_rn(x, x)), nf1),
                   __fmul_rn(gm, gm));
    if (!fin) gm = gv = qnan();
    den = __fsub_rn(nf, 2.0f);
    rest = __fsub_rn(nf1, w);
  }
  const float a = __fsub_rn(sum, __fmul_rn(w, gm));
  const float b = __fsqrt_rn(__fmul_rn(__fmul_rn(__fdiv_rn(w, den), rest), gv));
  const float z = fin ? __fdiv_rn(a, b) : qnan();
  g.Z[k] = z;
  if (!g.with_p) return;
  const float p = __fmul_rn(2.0f,
                            __fmul_rn(0.5f, erfcf(__fmul_rn(fabsf(z),
                                                            g.inv_sqrt2))));
  float sig = 0.0f;
  if (p < 0.1f) sig = 1.0f;
  if (p < 0.05f) sig = 2.0f;
  if (p < 0.01f) sig = 3.0f;
  if (z < 0.0f) sig = -sig;
  if (p >= 0.1f) sig = 0.0f;
  g.P[k] = p;
  g.bins[k] = fin ? sig : qnan();
}

// Shared memory is addressed by 32-bit shared-window addresses kept in
// registers, through these loads and stores: with generic pointers the
// compiler rebuilt the window's base (an S2R of the cluster rank, a long
// latency) before every load once registers were short.
__device__ __forceinline__ unsigned smem_base() {
  extern __shared__ __align__(16) float4 smem_f4[];
  return (unsigned)__cvta_generic_to_shared(smem_f4);
}

__device__ __forceinline__ void lds(unsigned a, float& v) {
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a) : "memory");
}
__device__ __forceinline__ void sts(unsigned a, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(a), "f"(v) : "memory");
}

// Issue the 4-byte cp.async copies of raw X rows [b0, b0 + rows) of the
// tile into the floats at shared address base (rows x n, stride n), each
// index padded by `source`.
__device__ __forceinline__ void fetch(unsigned base, const float* X, int H,
                                      int W, int reflect, int top, int b0,
                                      int rows, int j0, int col0, int n,
                                      int tx, int ty) {
  for (int r = ty; r < rows; r += kGroups) {
    const float* src = X + (int64_t)source(top + b0 + r, H, reflect) * W;
    for (int c = tx; c < n; c += kCols)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                   ::"r"(base + 4u * (unsigned)(r * n + c)),
                   "l"(src + source(j0 + c + col0, W, reflect))
                   : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// The power-of-two partials of `rows` staged rows from level 0 up, in the
// column-major planes at `val` (level l at val + 4 * l * plane bytes),
// partial[2k][c] = partial[k][c] + partial[k][c + k]; a barrier after each.
__device__ __forceinline__ void build(unsigned val, int plane, int levels,
                                      int n, int cs, int rows, int tx,
                                      int ty) {
  for (int l = 1; l < levels; ++l) {
    const unsigned half = 4u * (cs << (l - 1));
    const int cnt = n - (1 << l) + 1;
    for (int r = ty; r < rows; r += kGroups)
      for (int c = tx; c < cnt; c += kCols) {
        const unsigned at = val + 4u * ((l - 1) * plane + c * cs + r);
        float a, b;
        lds(at, a);
        lds(at + half, b);
        sts(at + 4u * plane, __fadd_rn(a, b));
      }
    __syncthreads();
  }
}

// One tile of kRows x kCols outputs: thread (tx, ty) keeps output rows
// ty * kPer + u of column tx.  CH 1 sums X; CH 2 sums X where finite and
// counts the finite pixels: the band's cells less the footprint sum of a
// non-finite indicator, taken in a second pass over the partials' space
// only in batches that have a non-finite pixel.  prev0/prev1 (nullable)
// hold the sums and counts the band before stored; out0/out1 take this
// band's unless GI, where the last band writes Gi's outputs instead.
// Shared memory: kGuard words, the partials (levels x n x cs words),
// kGuard words, then the raw rows as fetched (row-major, rb x n words):
// one buffer where the tile's whole window is one batch, else two, the
// next batch arriving while this one is summed.
template <int CH, bool GI>
__global__ void __launch_bounds__(kThreads, 1)
footprint_kernel(const float* __restrict__ X, int H, int W, int reflect,
                 const __grid_constant__ Table tab, const float* prev0,
                 const float* prev1, float* out0, float* out1,
                 const GiArgs gi) {
  const int cs = tab.cs;
  const int plane = tab.n * cs;  // words a level
  const unsigned val = smem_base() + 4u * kGuard;
  const unsigned raw = val + 4u * (tab.levels * plane + kGuard);
  const unsigned rawb = 4u * tab.rb * tab.n;  // bytes of a raw batch
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j0 = blockIdx.x * kCols;
  const int i0 = blockIdx.y * kRows + ty * kPer;  // this thread's first row
  const int j = j0 + tx;

  float acc[kPer], cnt[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const bool here = prev0 != nullptr && i0 + u < H && j < W;
    const int64_t k = (int64_t)(i0 + u) * W + j;
    acc[u] = here ? prev0[k] : 0.0f;
    if (CH == 2)
      cnt[u] = __fadd_rn(here ? prev1[k] : 0.0f, (float)tab.cells);
  }

  const int nr = tab.rows ? kRows + tab.rows - 1 : 0;  // input rows read
  const int top = blockIdx.y * kRows + tab.row0;       // X row of input 0
  if (nr > 0)
    fetch(raw, X, H, W, reflect, top, 0, min(tab.rb, nr), j0, tab.col0,
          tab.n, tx, ty);
  for (int b0 = 0, k = 0; b0 < nr; b0 += tab.rb, k ^= 1) {
    const int rows = min(tab.rb, nr - b0);
    const unsigned in = raw + k * rawb;
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();  // this batch's raw rows; the last batch's reads done
    int voids = 0;
    for (int r = ty; r < rows; r += kGroups)
      for (int c = tx; c < tab.n; c += kCols) {
        float x;
        lds(in + 4u * (r * tab.n + c), x);
        const bool f = isfinite(x);
        sts(val + 4u * (c * cs + r), CH == 2 && !f ? 0.0f : x);
        voids |= !f;
      }
    if (b0 + tab.rb < nr)  // the next batch's rows arrive meanwhile
      fetch(raw + (k ^ 1) * rawb, X, H, W, reflect, top, b0 + tab.rb,
            min(tab.rb, nr - b0 - tab.rb), j0, tab.col0, tab.n, tx, ty);
    if (CH == 2)
      voids = __syncthreads_or(voids);
    else
      __syncthreads();
    build(val, plane, tab.levels, tab.n, cs, rows, tx, ty);

    // Footprint row dr reaches output row u from batch row s + u, where
    // s = ty * kPer + dr - b0: each dr's pieces serve the thread's rows
    // whose batch rows are staged (ok); the others read a neighbouring
    // word (s + u may run kPer - 1 rows past either end of a column: the
    // guards) and keep their sums.
    const int base = ty * kPer - b0;
    const int d0 = max(0, -base - kPer + 1), d1 = min(tab.rows, rows - base);
    for (int dr = d0; dr < d1; ++dr) {
      const int s = base + dr;
      bool ok[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) ok[u] = s + u >= 0 && s + u < rows;
      const unsigned at = val + 4u * (tx * cs + s);
      const int p1 = tab.start[dr + 1];
      float run[kPer];
      bool fresh = true;
      for (int p = tab.start[dr]; p < p1; ++p) {
        const uint32_t e = tab.piece[p];
        const unsigned a = at + 4u * (e & ~kLast);
        float v[kPer];
#pragma unroll
        for (int u = 0; u < kPer; ++u) lds(a + 4u * u, v[u]);
#pragma unroll
        for (int u = 0; u < kPer; ++u)
          run[u] = __fadd_rn(fresh ? 0.0f : run[u], v[u]);
        fresh = (e & kLast) != 0;
        if (fresh) {
#pragma unroll
          for (int u = 0; u < kPer; ++u)
            if (ok[u]) acc[u] = __fadd_rn(acc[u], run[u]);
        }
      }
    }
    if (CH == 2 && voids) {
      // the counts: the same pieces over the partials of the non-finite
      // indicator, built in the same space once the sums have read it
      __syncthreads();
      for (int r = ty; r < rows; r += kGroups)
        for (int c = tx; c < tab.n; c += kCols) {
          float x;
          lds(in + 4u * (r * tab.n + c), x);
          sts(val + 4u * (c * cs + r), isfinite(x) ? 0.0f : 1.0f);
        }
      __syncthreads();
      build(val, plane, tab.levels, tab.n, cs, rows, tx, ty);
      for (int dr = d0; dr < d1; ++dr) {
        const int s = base + dr;
        const unsigned at = val + 4u * (tx * cs + s);
        for (int p = tab.start[dr]; p < tab.start[dr + 1]; ++p) {
          const unsigned a = at + 4u * (tab.piece[p] & ~kLast);
#pragma unroll
          for (int u = 0; u < kPer; ++u) {
            float v;
            lds(a + 4u * u, v);
            if (s + u >= 0 && s + u < rows) cnt[u] = __fsub_rn(cnt[u], v);
          }
        }
      }
    }
  }

  if (j >= W) return;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    if (i0 + u >= H) continue;
    const int64_t k = (int64_t)(i0 + u) * W + j;
    if constexpr (GI) {
      gi_pixel(gi, X[k], acc[u], cnt[u], *gi.nf, *gi.m0, *gi.m1, k);
    } else {
      out0[k] = acc[u];
      if (CH == 2) out1[k] = cnt[u];
    }
  }
}

// head: rows, row0, col0, n, cs, levels, rb, cells, pieces (ints), as
// ops/surface.py:_footprint_plan lays out a band.
int fill(Table& tab, const int* head, const uint16_t* start,
         const uint32_t* piece) {
  tab.rows = head[0];
  tab.row0 = head[1];
  tab.col0 = head[2];
  tab.n = head[3];
  tab.cs = head[4];
  tab.levels = head[5];
  tab.rb = head[6];
  tab.cells = head[7];
  const int pieces = head[8];
  if (tab.rows < 0 || tab.rows > kMaxRows || pieces < 0
      || pieces > kMaxPieces || tab.levels < 1 || tab.levels > 12
      || tab.rb < 1 || tab.n < kCols || tab.cs < tab.rb || tab.cells < 0)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i <= tab.rows; ++i) tab.start[i] = start[i];
  for (int i = 0; i < pieces; ++i) tab.piece[i] = piece[i];
  return 0;
}

template <int CH, bool GI>
int launch(const float* X, long long H, long long W, int reflect,
           const int* head, const uint16_t* start, const uint32_t* piece,
           const float* prev0, const float* prev1, float* out0, float* out1,
           const GiArgs& gi, long long smem, cudaStream_t stream) {
  if (H <= 0 || W <= 0) return 0;
  if (H > (1ll << 30) || W > (1ll << 30)) return (int)cudaErrorInvalidValue;
  Table tab;
  const int err = fill(tab, head, start, piece);
  if (err) return err;
  if (smem > 48 * 1024) {
    const int e = (int)cudaFuncSetAttribute(
        footprint_kernel<CH, GI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e) return e;
  }
  const dim3 grid((unsigned)((W + kCols - 1) / kCols),
                  (unsigned)((H + kRows - 1) / kRows));
  footprint_kernel<CH, GI><<<grid, dim3(kCols, kGroups), (size_t)smem,
                             stream>>>(X, (int)H, (int)W, reflect, tab, prev0,
                                       prev1, out0, out1, gi);
  return (int)cudaGetLastError();
}

}  // namespace

// C entries, bound with ctypes (ops/surface.py:_footprint_cuda, ops/stats.py:
// _footprint_gi_cuda).  X is a contiguous (H, W) float32 array on the
// device; head/start/piece one band of the host's table (host memory, read
// before the call returns); ``stream`` a cudaStream_t.  Each launches one
// kernel on that stream, does not synchronise, and returns
// cudaGetLastError().

// One band of binary_footprint_sum into out (H, W); with ``accumulate`` the
// band adds to the sums already in out (the band before's), else starts
// from +0.
extern "C" int footprint_sum_launch(const void* X, void* out, long long H,
                                    long long W, int reflect, const int* head,
                                    const uint16_t* start,
                                    const uint32_t* piece, int accumulate,
                                    long long smem, void* stream) {
  float* o = static_cast<float*>(out);
  return launch<1, false>(static_cast<const float*>(X), H, W, reflect, head,
                          start, piece, accumulate ? o : nullptr, nullptr, o,
                          nullptr, GiArgs{}, smem, (cudaStream_t)stream);
}

// One band of Gi's two footprint sums.  With ``accumulate`` it adds to the
// sums in (sum_v, sum_w), the band before's; a band that is not ``last``
// stores its sums there; the last writes Z and, with ``with_p``, P and the
// bins, from the whole-map scalars nf, m0, m1 (0-d float32 on the device).
extern "C" int footprint_gi_launch(
    const void* X, void* sum_v, void* sum_w, void* Z, void* P, void* bins,
    long long H, long long W, int reflect, const int* head,
    const uint16_t* start, const uint32_t* piece, int accumulate, int last,
    const void* nf, const void* m0, const void* m1, int star, int with_p,
    float inv_sqrt2, long long smem, void* stream) {
  const float* x = static_cast<const float*>(X);
  float* sv = static_cast<float*>(sum_v);
  float* sw = static_cast<float*>(sum_w);
  const float* pv = accumulate ? sv : nullptr;
  const float* pw = accumulate ? sw : nullptr;
  const cudaStream_t s = (cudaStream_t)stream;
  if (!last)
    return launch<2, false>(x, H, W, reflect, head, start, piece, pv, pw, sv,
                            sw, GiArgs{}, smem, s);
  const GiArgs g{static_cast<float*>(Z), static_cast<float*>(P),
                 static_cast<float*>(bins), static_cast<const float*>(nf),
                 static_cast<const float*>(m0), static_cast<const float*>(m1),
                 star, with_p, inv_sqrt2};
  return launch<2, true>(x, H, W, reflect, head, start, piece, pv, pw,
                         nullptr, nullptr, g, smem, s);
}
