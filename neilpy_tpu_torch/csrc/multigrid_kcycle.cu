// The springs fill's multigrid K-cycle for NVIDIA Hopper (sm_90a): the
// preconditioner of ops/inpaint.py:_kcycle as hand-written kernels, issued
// in the order of its recursion by mg_kcycle_launch (one C call an
// application).
//
// Replaces no TPU kernel: the JAX package runs the K-cycle as XLA ops
// (neilpy_tpu/ops/inpaint.py:_kcycle) inside its CG's while loop.  The
// port's plain version, ops/inpaint.py:_kcycle_torch, is about 14,700
// small torch ops an application on SMRF's 2001^2 hierarchy (2001^2 down
// to 4^2, ten levels): 97% of them on grids of 501^2 or less or on 0-d
// scalars, 5,454 in the 24-step coarse CG.  Replayed as a CUDA graph each
// of them still costs 1.6-2 us of node overhead and tail, so one CG
// iteration of the fill took about 24 ms against a bytes-once bound near
// 0.3 ms.  This file does the same arithmetic in about a hundred launches.
//
// Design, from the finest level down:
//   - Above the tail, a visit of level l is four kernels: the first two
//     damped-Jacobi sweeps from zero in one (the first sweep's values at the
//     four neighbours are recomputed inline), the residual with its 2x2
//     restriction times the coarse mask (fine grid to coarse grid), the
//     prolongation fused into the first post-sweep (the neighbours'
//     corrected values are local), and the last sweep.  invD = (omega /
//     diag) u is computed where it is read, not stored.
//   - The K-cycle's two flexible-CG steps at levels 1..kdepth: each dot
//     product is a fixed-order partial sum per block (a grid stride per
//     thread, then a butterfly in each warp and across the warps), which the
//     kernel that needs the scalar sums again in one fixed order, in every
//     block alike; alpha, beta and their _safe_div guards are computed on the
//     device inside those kernels.  No atomics, no host sync: a graph replay
//     gives the same bits as an eager run.
//   - The tail: one block of 1024 threads runs the whole V-recursion from
//     the first level whose working set fits in shared memory (8 arrays a
//     level, chosen by ops/inpaint.py:_kcycle_plan from the shapes, the
//     dtype and the shared memory a block may opt into on the device: on an
//     H100 63^2 in float32, 32^2 in float64 at 2001^2) down to the coarsest
//     level, with __syncthreads() between sweeps, and the fixed-iteration
//     coarse CG in its first warp (butterfly sums, __syncwarp()).  Where not
//     even the coarsest level fits, the same kernel works on a global
//     scratch copy.
//   - The second flexible-CG step's residual, K-cycle and direction are not
//     computed: nothing reads them (the step's xc update comes first).  The
//     result is the plain version's, which skips them too.
//
// Exactness: every elementwise stage rounds as the plain version's torch
// ops do on the card, each rounding spelled out with its intrinsic (the
// build passes -fmad=false besides): A(x) = _apply_level(x u) u with its
// four subtractions in torch's order (east, west, south, north), omega /
// diag as torch computes it (diag.reciprocal() * omega), x + invD (r -
// A(x)), x + prolong(xc) u.  So a sweep, the restriction and the
// prolongation equal their torch ops bit for bit on the same inputs, except
// the 2x2 block sum, which adds ((v00 + v01) + v10) + v11 (torch.sum's
// order over the reshaped block is its reduction kernel's).  Dot products
// and the coarse CG's sums round in another order than torch.sum, so an
// application equals the plain version only to rounding, and a fill to the
// CG's tolerance.  The tail and the level kernels share the arithmetic, so
// any choice of the tail's top level gives the same bits.
//
// What bounds it on this card: at 2001^2 and 1001^2 the bytes (each sweep
// reads diag, E, S, u, r and x of one grid, 16 MB each in float32 at
// 2001^2, and writes one); at 501^2 and below each launch is latency, a few
// microseconds, and the tail is a chain of block barriers.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;       // a block of the level kernels
constexpr int kTailThreads = 1024;  // the tail's one block
constexpr int kMaxParts = 256;      // partial sums (blocks) of a dot product
constexpr int kParts = 5;           // dot products of one flexible-CG level
constexpr int kMaxLevels = 40;

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}

// One Galerkin level (ops/inpaint.py:_build_levels): the diagonal, the
// couplings to the east and south neighbours and the unknown mask, H x W.
template <typename T>
struct Level {
  const T* d;
  const T* e;
  const T* s;
  const T* u;
  int64_t H, W;
};

// torch.where(diag > 0, omega / diag, 0.0) * u, where omega / diag is
// diag.reciprocal() * omega (Tensor.__rtruediv__).
template <typename T>
__device__ __forceinline__ T inv_diag(T d, T u, T omega) {
  const T w = d > T(0) ? mul_rn(div_rn(T(1), d), omega) : T(0);
  return mul_rn(w, u);
}

// _apply_level(x * u, diag, E, S) * u at cell (i, j) = c, x(i, j, c) giving
// the iterate at any cell: diag*xu, then minus E*xu east, E_west*xu west,
// S*xu south and S_north*xu north, in that order, each product rounded
// before its subtraction, as the in-place torch ops do.
template <typename T, typename X>
__device__ __forceinline__ T apply_at(const T* d, const T* e, const T* s,
                                      const T* u, int64_t H, int64_t W,
                                      int64_t i, int64_t j, int64_t c, X x) {
  T out = mul_rn(d[c], mul_rn(x(i, j, c), u[c]));
  if (j < W - 1)
    out = sub_rn(out, mul_rn(e[c], mul_rn(x(i, j + 1, c + 1), u[c + 1])));
  if (j > 0)
    out = sub_rn(out, mul_rn(e[c - 1], mul_rn(x(i, j - 1, c - 1), u[c - 1])));
  if (i < H - 1)
    out = sub_rn(out, mul_rn(s[c], mul_rn(x(i + 1, j, c + W), u[c + W])));
  if (i > 0)
    out = sub_rn(out, mul_rn(s[c - W], mul_rn(x(i - 1, j, c - W), u[c - W])));
  return mul_rn(out, u[c]);
}

// The sum of v over a warp by a butterfly: every lane gets the same bits.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int m = 16; m > 0; m >>= 1)
    v = add_rn(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

// The sum of v over the block in one fixed order, valid in the first warp.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T s = T(0);
  if (warp == 0) {
    s = lane < int(blockDim.x >> 5) ? red[lane] : T(0);
    s = warp_sum(s);
  }
  return s;
}

// The sum of a dot product's nb partials, in one order, in the first warp.
template <typename T>
__device__ __forceinline__ T sum_parts(const T* part, int nb) {
  T s = T(0);
  for (int k = threadIdx.x; k < nb; k += 32) s = add_rn(s, part[k]);
  return warp_sum(s);
}

// ops/inpaint.py:_safe_div
template <typename T>
__device__ __forceinline__ T safe_div(T num, T den) {
  return den != T(0) ? div_rn(num, den) : T(0);
}

#define GRID_STRIDE(c, n)                                               \
  for (int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;     \
       c < (n); c += (int64_t)gridDim.x * blockDim.x)

// What a smoothing kernel sweeps from: the first sweep's result from zero
// (0 + invD r, recomputed at each neighbour), the pre-smoothed iterate plus
// the prolonged correction (x + xc[i/2, j/2] u), or an iterate as stored.
enum Mode { kFirst = 0, kProlong = 1, kPlain = 2 };

// One damped-Jacobi sweep x + invD (r - A(x)) of level L from the iterate
// MODE gives, into out; without SWEEP, that iterate itself.
template <typename T, int MODE, bool SWEEP>
__global__ void __launch_bounds__(kThreads)
smooth_kernel(Level<T> L, const T* __restrict__ r, const T* __restrict__ x,
              const T* __restrict__ xc, int64_t Wc, T omega,
              T* __restrict__ out) {
  auto xin = [=](int64_t i, int64_t j, int64_t c) -> T {
    if constexpr (MODE == kFirst) {
      return add_rn(T(0), mul_rn(inv_diag(L.d[c], L.u[c], omega), r[c]));
    } else if constexpr (MODE == kProlong) {
      return add_rn(x[c], mul_rn(xc[(i >> 1) * Wc + (j >> 1)], L.u[c]));
    } else {
      return x[c];
    }
  };
  GRID_STRIDE(c, L.H * L.W) {
    const int64_t i = c / L.W, j = c - i * L.W;
    T v = xin(i, j, c);
    if constexpr (SWEEP) {
      const T a = apply_at(L.d, L.e, L.s, L.u, L.H, L.W, i, j, c, xin);
      v = add_rn(v, mul_rn(inv_diag(L.d[c], L.u[c], omega), sub_rn(r[c], a)));
    }
    out[c] = v;
  }
}

// _blocksum2(r - A(x)) * uc at a coarse cell: the four fine residuals
// (zero where the block passes the fine grid's edge), summed in one order.
template <typename T, typename X>
__device__ __forceinline__ T restrict_at(const T* d, const T* e, const T* s,
                                         const T* u, int64_t H, int64_t W,
                                         const T* r, X x, int64_t I,
                                         int64_t J) {
  T v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int64_t i = 2 * I + (k >> 1), j = 2 * J + (k & 1);
    v[k] = T(0);
    if (i < H && j < W) {
      const int64_t c = i * W + j;
      v[k] = sub_rn(r[c], apply_at(d, e, s, u, H, W, i, j, c, x));
    }
  }
  return add_rn(add_rn(add_rn(v[0], v[1]), v[2]), v[3]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
restrict_kernel(Level<T> L, const T* __restrict__ r,
                const T* __restrict__ x, const T* __restrict__ uc,
                int64_t Hc, int64_t Wc, T* __restrict__ rc) {
  auto xat = [=](int64_t, int64_t, int64_t c) -> T { return x[c]; };
  GRID_STRIDE(C, Hc * Wc) {
    const int64_t I = C / Wc, J = C - I * Wc;
    rc[C] = mul_rn(restrict_at(L.d, L.e, L.s, L.u, L.H, L.W, r, xat, I, J),
                   uc[C]);
  }
}

// Per-block partial sums of a0 * b (and of a1 * b), in a fixed order.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
dot_kernel(const T* __restrict__ a0, const T* __restrict__ a1,
           const T* __restrict__ b, int64_t n, T* __restrict__ p0,
           T* __restrict__ p1) {
  __shared__ T red[kThreads / 32];
  T s0 = T(0), s1 = T(0);
  GRID_STRIDE(c, n) {
    const T bc = b[c];
    s0 = add_rn(s0, mul_rn(a0[c], bc));
    if constexpr (N == 2) s1 = add_rn(s1, mul_rn(a1[c], bc));
  }
  s0 = block_sum(s0, red);
  if (threadIdx.x == 0) p0[blockIdx.x] = s0;
  if constexpr (N == 2) {
    __syncthreads();
    s1 = block_sum(s1, red);
    if (threadIdx.x == 0) p1[blockIdx.x] = s1;
  }
}

// ap = A(p) on level L, and the per-block partial sums of p * ap.
template <typename T>
__global__ void __launch_bounds__(kThreads)
matvec_dot_kernel(Level<T> L, const T* __restrict__ p, T* __restrict__ ap,
                  T* __restrict__ part) {
  __shared__ T red[kThreads / 32];
  auto pat = [=](int64_t, int64_t, int64_t c) -> T { return p[c]; };
  T s = T(0);
  GRID_STRIDE(c, L.H * L.W) {
    const int64_t i = c / L.W, j = c - i * L.W;
    const T a = apply_at(L.d, L.e, L.s, L.u, L.H, L.W, i, j, c, pat);
    ap[c] = a;
    s = add_rn(s, mul_rn(p[c], a));
  }
  s = block_sum(s, red);
  if (threadIdx.x == 0) part[blockIdx.x] = s;
}

// A flexible-CG step's update: alpha = _safe_div(sum num, sum den), then
// xc = xin + alpha p (xin zero where null) and, where rn is given,
// rn = rr - alpha ap.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fcg_update_kernel(const T* num, const T* den, int nb, const T* p,
                  const T* ap, const T* rr, const T* xin, T* xc, T* rn,
                  int64_t n) {
  __shared__ T alpha_s;
  if (threadIdx.x < 32) {
    const T a = safe_div(sum_parts(num, nb), sum_parts(den, nb));
    if (threadIdx.x == 0) alpha_s = a;
  }
  __syncthreads();
  const T alpha = alpha_s;
  GRID_STRIDE(c, n) {
    xc[c] = add_rn(xin ? xin[c] : T(0), mul_rn(alpha, p[c]));
    if (rn) rn[c] = sub_rn(rr[c], mul_rn(alpha, ap[c]));
  }
}

// The new direction: beta = _safe_div(sum rzn - sum rrz, sum rz), then
// p = z + beta p in place.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fcg_direction_kernel(const T* rz, const T* rzn, const T* rrz, int nb,
                     const T* __restrict__ z, T* __restrict__ p, int64_t n) {
  __shared__ T beta_s;
  if (threadIdx.x < 32) {
    const T num = sub_rn(sum_parts(rzn, nb), sum_parts(rrz, nb));
    const T b = safe_div(num, sum_parts(rz, nb));
    if (threadIdx.x == 0) beta_s = b;
  }
  __syncthreads();
  const T beta = beta_s;
  GRID_STRIDE(c, n) p[c] = add_rn(z[c], mul_rn(beta, p[c]));
}

// ---------------------------------------------------------------------
// the tail: one block, the V-recursion of the levels it holds
// ---------------------------------------------------------------------
template <typename T>
struct Tail {
  Level<T> lev[kMaxLevels];  // the tail's levels, the coarsest last
  int levels;
  int in_smem;  // its work arrays in shared memory, else in global scratch
};

// A tail level's eight arrays: d, e, s, u copied, invD, r, and the
// iterates x, y that the sweeps alternate between.
template <typename T>
struct Work {
  T *d, *e, *s, *u, *inv, *r, *x, *y;
  int64_t H, W;
};

template <typename T>
__device__ __forceinline__ Work<T> work_at(const Tail<T>& t, T* base,
                                           int k) {
  for (int q = 0; q < k; ++q) base += 8 * t.lev[q].H * t.lev[q].W;
  const int64_t n = t.lev[k].H * t.lev[k].W;
  return {base,         base + n,     base + 2 * n, base + 3 * n,
          base + 4 * n, base + 5 * n, base + 6 * n, base + 7 * n,
          t.lev[k].H,   t.lev[k].W};
}

template <typename T>
__device__ __forceinline__ T sweep_at(const Work<T>& w, const T* x,
                                      int64_t c) {
  const int64_t i = c / w.W, j = c - i * w.W;
  auto xat = [=](int64_t, int64_t, int64_t cc) -> T { return x[cc]; };
  const T a = apply_at<T>(w.d, w.e, w.s, w.u, w.H, w.W, i, j, c, xat);
  return add_rn(x[c], mul_rn(w.inv[c], sub_rn(w.r[c], a)));
}

// ops/inpaint.py:_coarse_cg on the coarsest level, by the first warp: x
// from zero, r in place as the residual, y the direction, ap = A(y).
template <typename T>
__device__ void coarse_cg(const Work<T>& w, T* ap, int iters) {
  const int lane = threadIdx.x;
  const int64_t n = w.H * w.W;
  auto yat = [=](int64_t, int64_t, int64_t c) -> T { return w.y[c]; };
  T rz = T(0);
  for (int64_t c = lane; c < n; c += 32) {
    const T v = w.r[c];
    w.x[c] = T(0);
    w.y[c] = v;
    rz = add_rn(rz, mul_rn(v, v));
  }
  rz = warp_sum(rz);
  __syncwarp();
  for (int it = 0; it < iters; ++it) {
    T pap = T(0);
    for (int64_t c = lane; c < n; c += 32) {
      const int64_t i = c / w.W, j = c - i * w.W;
      const T a = apply_at(w.d, w.e, w.s, w.u, w.H, w.W, i, j, c, yat);
      ap[c] = a;
      pap = add_rn(pap, mul_rn(w.y[c], a));
    }
    pap = warp_sum(pap);
    const T alpha = pap > T(0) ? div_rn(rz, pap) : T(0);
    T rzn = T(0);
    for (int64_t c = lane; c < n; c += 32) {
      w.x[c] = add_rn(w.x[c], mul_rn(alpha, w.y[c]));
      const T rn = sub_rn(w.r[c], mul_rn(alpha, ap[c]));
      w.r[c] = rn;
      rzn = add_rn(rzn, mul_rn(rn, rn));
    }
    rzn = warp_sum(rzn);
    const T beta = rz > T(0) ? div_rn(rzn, rz) : T(0);
    __syncwarp();
    for (int64_t c = lane; c < n; c += 32)
      w.y[c] = add_rn(w.r[c], mul_rn(beta, w.y[c]));
    rz = rzn;
    __syncwarp();
  }
}

template <typename T>
__global__ void __launch_bounds__(kTailThreads)
tail_kernel(const __grid_constant__ Tail<T> t, const T* __restrict__ r,
            T* __restrict__ out, T omega, int nsmooth, int iters,
            T* gwork) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* base = t.in_smem ? reinterpret_cast<T*>(smem_raw) : gwork;
  const int nt = t.levels;
  const int tid = threadIdx.x, nth = blockDim.x;

  for (int k = 0; k < nt; ++k) {
    const Work<T> w = work_at(t, base, k);
    const Level<T>& L = t.lev[k];
    for (int64_t c = tid; c < w.H * w.W; c += nth) {
      const T d = L.d[c], u = L.u[c];
      w.d[c] = d;
      w.e[c] = L.e[c];
      w.s[c] = L.s[c];
      w.u[c] = u;
      w.inv[c] = inv_diag(d, u, omega);
      if (k == 0) w.r[c] = r[c];
    }
  }
  __syncthreads();

  // down: pre-smoothing from zero, the restricted residual into the next
  // level's r; bit k of in_y says level k's iterate ended in y
  uint64_t in_y = 0;
  for (int k = 0; k + 1 < nt; ++k) {
    const Work<T> w = work_at(t, base, k), wc = work_at(t, base, k + 1);
    const int64_t n = w.H * w.W;
    T* cur = w.x;
    T* oth = w.y;
    for (int64_t c = tid; c < n; c += nth)
      cur[c] = nsmooth > 0 ? add_rn(T(0), mul_rn(w.inv[c], w.r[c])) : T(0);
    __syncthreads();
    for (int q = 1; q < nsmooth; ++q) {
      for (int64_t c = tid; c < n; c += nth) oth[c] = sweep_at(w, cur, c);
      __syncthreads();
      T* tmp = cur;
      cur = oth;
      oth = tmp;
    }
    if (cur == w.y) in_y |= 1ull << k;
    auto xat = [=](int64_t, int64_t, int64_t c) -> T { return cur[c]; };
    for (int64_t C = tid; C < wc.H * wc.W; C += nth) {
      const int64_t I = C / wc.W, J = C - I * wc.W;
      wc.r[C] = mul_rn(restrict_at(w.d, w.e, w.s, w.u, w.H, w.W, w.r, xat,
                                   I, J),
                       wc.u[C]);
    }
    __syncthreads();
  }

  const Work<T> wl = work_at(t, base, nt - 1);
  if (tid < 32) coarse_cg(wl, wl.d + 8 * wl.H * wl.W, iters);
  __syncthreads();

  // up: the prolonged correction, then the post-sweeps
  const T* below = wl.x;
  int64_t Wb = wl.W;
  for (int k = nt - 2; k >= 0; --k) {
    const Work<T> w = work_at(t, base, k);
    const int64_t n = w.H * w.W;
    T* cur = (in_y >> k) & 1 ? w.y : w.x;
    T* oth = cur == w.y ? w.x : w.y;
    for (int64_t c = tid; c < n; c += nth) {
      const int64_t i = c / w.W, j = c - i * w.W;
      cur[c] = add_rn(cur[c], mul_rn(below[(i >> 1) * Wb + (j >> 1)],
                                     w.u[c]));
    }
    __syncthreads();
    for (int q = 0; q < nsmooth; ++q) {
      for (int64_t c = tid; c < n; c += nth) oth[c] = sweep_at(w, cur, c);
      __syncthreads();
      T* tmp = cur;
      cur = oth;
      oth = tmp;
    }
    below = cur;
    Wb = w.W;
  }
  for (int64_t c = tid; c < t.lev[0].H * t.lev[0].W; c += nth)
    out[c] = below[c];
}

// ---------------------------------------------------------------------
// the host side: scratch, and the launches in the recursion's order
// ---------------------------------------------------------------------
int64_t blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return b < 1 ? 1 : (b > 0x7fffffff ? 0x7fffffff : b);
}

int parts_for(int64_t n) {
  const int64_t b = blocks_for(n);
  return int(b < kMaxParts ? b : kMaxParts);
}

// Elements of the tail's work arrays: 8 a level from `tail` down, and the
// coarse CG's A(p) on the coarsest.
int64_t tail_elems(const long long* hw, int L, int tail) {
  int64_t e = 0;
  for (int k = tail; k < L; ++k) e += 8 * hw[2 * k] * hw[2 * k + 1];
  return e + hw[2 * (L - 1)] * hw[2 * (L - 1) + 1];
}

template <typename T>
struct Run {
  int L = 0, tail = 0, nsmooth = 0, iters = 0, err = 0;
  long long smem = 0;
  T omega = T(0);
  Level<T> lev[kMaxLevels];
  // per level: A, B the sweeps' iterates (levels above the tail); R the
  // restricted residual, XC a V-visit's result (levels 1..tail); P, AP, RN,
  // Z and the partial sums of a flexible-CG level (1..kdepth)
  T *A[kMaxLevels] = {}, *B[kMaxLevels] = {}, *R[kMaxLevels] = {},
    *XC[kMaxLevels] = {}, *P[kMaxLevels] = {}, *AP[kMaxLevels] = {},
    *RN[kMaxLevels] = {}, *Z[kMaxLevels] = {}, *part[kMaxLevels] = {};
  T* gwork = nullptr;
  cudaStream_t stream = nullptr;
};

// The scratch layout (256-byte aligned pieces from `base`, or only its size
// when base is null); returns its bytes.
template <typename T>
int64_t layout(Run<T>& p, const long long* hw, int L, int tail, int kdepth,
               bool gwork, char* base) {
  int64_t off = 0;
  auto take = [&](int64_t elems) -> T* {
    off = (off + 255) / 256 * 256;
    T* ptr = base ? reinterpret_cast<T*>(base + off) : nullptr;
    off += elems * (int64_t)sizeof(T);
    return ptr;
  };
  auto n = [&](int l) { return (int64_t)hw[2 * l] * hw[2 * l + 1]; };
  for (int l = 0; l < tail; ++l) {
    p.A[l] = take(n(l));
    p.B[l] = take(n(l));
  }
  for (int l = 1; l <= tail; ++l) {
    p.R[l] = take(n(l));
    p.XC[l] = take(n(l));
  }
  const int fcg_top = kdepth < L - 2 ? kdepth : L - 2;
  for (int m = 1; m <= fcg_top; ++m) {
    p.P[m] = take(n(m));
    p.AP[m] = take(n(m));
    p.RN[m] = take(n(m));
    p.Z[m] = take(n(m));
    p.part[m] = take(kParts * kMaxParts);
  }
  if (gwork) p.gwork = take(tail_elems(hw, L, tail));
  return off;
}

template <typename T>
void check(Run<T>& p) {
  const int e = (int)cudaGetLastError();
  if (!p.err) p.err = e;
}

// One smoothing kernel on level l; xc, of width Wc, is the coarse
// correction MODE kProlong adds.
template <typename T, int MODE, bool SWEEP>
void smooth(Run<T>& p, int l, const T* r, const T* x, const T* xc,
            int64_t Wc, T* out) {
  const Level<T>& L = p.lev[l];
  smooth_kernel<T, MODE, SWEEP>
      <<<(unsigned)blocks_for(L.H * L.W), kThreads, 0, p.stream>>>(
          L, r, x, xc, Wc, p.omega, out);
  check(p);
}

template <typename T>
void launch_tail(Run<T>& p, const T* r, T* out) {
  static int attr_set[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (p.smem > 48 * 1024 && dev < 64 && !attr_set[dev]) {
    int most = 0;
    cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    const int e = (int)cudaFuncSetAttribute(
        tail_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e) {
      if (!p.err) p.err = e;
      return;
    }
    attr_set[dev] = 1;
  }
  Tail<T> t;
  t.levels = p.L - p.tail;
  for (int k = 0; k < t.levels; ++k) t.lev[k] = p.lev[p.tail + k];
  t.in_smem = p.smem > 0;
  tail_kernel<T><<<1, kTailThreads, (size_t)p.smem, p.stream>>>(
      t, r, out, p.omega, p.nsmooth, p.iters, p.gwork);
  check(p);
}

template <typename T>
void visit(Run<T>& p, int l, int kd, const T* r, T* out);

// The K-cycle's two flexible-CG steps on level m (ops/inpaint.py:_kcycle:
// rr = R[m], z = K(rr), p = z, ...), xc into XC[m]; the second step stops
// after its xc update, the rest of it being unused.
template <typename T>
void fcg(Run<T>& p, int m, int kd) {
  const Level<T>& L = p.lev[m];
  const int64_t n = L.H * L.W;
  const int nb = parts_for(n);
  const unsigned grid = (unsigned)blocks_for(n);
  T* rz = p.part[m];
  T* pap = rz + kMaxParts;
  T* rzn = rz + 2 * kMaxParts;
  T* rrz = rz + 3 * kMaxParts;
  T* pap2 = rz + 4 * kMaxParts;
  const T* rr = p.R[m];
  visit(p, m, kd, rr, p.P[m]);
  dot_kernel<T, 1><<<nb, kThreads, 0, p.stream>>>(rr, nullptr, p.P[m], n,
                                                  rz, nullptr);
  check(p);
  matvec_dot_kernel<T><<<nb, kThreads, 0, p.stream>>>(L, p.P[m], p.AP[m],
                                                      pap);
  check(p);
  fcg_update_kernel<T><<<grid, kThreads, 0, p.stream>>>(
      rz, pap, nb, p.P[m], p.AP[m], rr, nullptr, p.XC[m], p.RN[m], n);
  check(p);
  visit(p, m, kd, p.RN[m], p.Z[m]);
  dot_kernel<T, 2><<<nb, kThreads, 0, p.stream>>>(p.RN[m], rr, p.Z[m], n,
                                                  rzn, rrz);
  check(p);
  fcg_direction_kernel<T><<<grid, kThreads, 0, p.stream>>>(
      rz, rzn, rrz, nb, p.Z[m], p.P[m], n);
  check(p);
  matvec_dot_kernel<T><<<nb, kThreads, 0, p.stream>>>(L, p.P[m], p.AP[m],
                                                      pap2);
  check(p);
  fcg_update_kernel<T><<<grid, kThreads, 0, p.stream>>>(
      rzn, pap2, nb, p.P[m], p.AP[m], nullptr, p.XC[m], p.XC[m], nullptr, n);
  check(p);
}

// One visit of level l with right-hand side r, its result into out.
template <typename T>
void visit(Run<T>& p, int l, int kd, const T* r, T* out) {
  if (p.err) return;
  if (l >= p.tail) {
    launch_tail(p, r, out);
    return;
  }
  const Level<T>& L = p.lev[l];
  const Level<T>& Lc = p.lev[l + 1];
  const int ns = p.nsmooth;
  T* cur = p.A[l];
  T* oth = p.B[l];
  if (ns == 0) {
    if (!p.err)
      p.err = (int)cudaMemsetAsync(cur, 0, L.H * L.W * sizeof(T), p.stream);
  } else if (ns == 1) {
    smooth<T, kFirst, false>(p, l, r, nullptr, nullptr, 1, cur);
  } else {
    smooth<T, kFirst, true>(p, l, r, nullptr, nullptr, 1, cur);
    for (int q = 2; q < ns; ++q) {
      smooth<T, kPlain, true>(p, l, r, cur, nullptr, 1, oth);
      T* tmp = cur;
      cur = oth;
      oth = tmp;
    }
  }
  restrict_kernel<T><<<(unsigned)blocks_for(Lc.H * Lc.W), kThreads, 0,
                       p.stream>>>(L, r, cur, Lc.u, Lc.H, Lc.W, p.R[l + 1]);
  check(p);
  if (kd > 0 && l + 2 < p.L)
    fcg(p, l + 1, kd - 1);
  else
    visit(p, l + 1, 0, p.R[l + 1], p.XC[l + 1]);
  if (p.err) return;
  const T* xc = p.XC[l + 1];
  if (ns == 0) {
    smooth<T, kProlong, false>(p, l, r, cur, xc, Lc.W, out);
    return;
  }
  smooth<T, kProlong, true>(p, l, r, cur, xc, Lc.W, ns == 1 ? out : oth);
  T* last = oth;
  T* free = cur;
  for (int q = 1; q < ns; ++q) {
    T* dst = q + 1 == ns ? out : free;
    smooth<T, kPlain, true>(p, l, r, last, nullptr, 1, dst);
    free = last;
    last = dst;
  }
}

template <typename T>
void set_levels(Run<T>& p, const void* const* lev, const long long* hw,
                int L) {
  p.L = L;
  for (int l = 0; l < L; ++l)
    p.lev[l] = {static_cast<const T*>(lev[4 * l]),
                static_cast<const T*>(lev[4 * l + 1]),
                static_cast<const T*>(lev[4 * l + 2]),
                static_cast<const T*>(lev[4 * l + 3]), hw[2 * l],
                hw[2 * l + 1]};
}

bool plan_ok(const long long* hw, int L, int tail, int kdepth,
             long long smem, int itemsize) {
  if (L < 1 || L > kMaxLevels || tail < 0 || tail >= L) return false;
  const int first = kdepth < L - 2 ? (kdepth > 0 ? kdepth : 0)
                                   : (L - 2 > 0 ? L - 2 : 0);
  if (tail < first) return false;  // the tail runs no flexible CG
  return smem == 0 || smem == tail_elems(hw, L, tail) * itemsize;
}

template <typename T>
int kcycle(const void* const* lev, const long long* hw, int L, const void* r,
           void* z, void* scratch, long long scratch_bytes, double omega,
           int nsmooth, int kdepth, int iters, int tail, long long smem,
           cudaStream_t stream) {
  if (!plan_ok(hw, L, tail, kdepth, smem, sizeof(T)) || nsmooth < 0)
    return (int)cudaErrorInvalidValue;
  Run<T> p;
  set_levels(p, lev, hw, L);
  if (layout(p, hw, L, tail, kdepth, smem == 0,
             static_cast<char*>(scratch)) > scratch_bytes)
    return (int)cudaErrorInvalidValue;
  p.tail = tail;
  p.smem = smem;
  p.omega = T(omega);
  p.nsmooth = nsmooth;
  p.iters = iters;
  p.stream = stream;
  visit(p, 0, kdepth, static_cast<const T*>(r), static_cast<T*>(z));
  return p.err;
}

}  // namespace

// C entries, bound with ctypes (neilpy_tpu_torch/ops/inpaint.py:
// _kcycle_cuda).  ``lev`` holds 4 device pointers a level (diag, E, S, u),
// ``hw`` 2 extents a level, all arrays contiguous, float64 if f64 else
// float32; ``stream`` is a cudaStream_t.  The launches go on that stream,
// nothing synchronises, and each entry returns the first CUDA error.

// Bytes of scratch mg_kcycle_launch needs for this hierarchy and plan.
extern "C" long long mg_scratch_bytes(const long long* hw, int L, int tail,
                                      int kdepth, long long smem, int f64) {
  if (f64) {
    Run<double> p;
    return layout(p, hw, L, tail, kdepth, smem == 0, nullptr);
  }
  Run<float> p;
  return layout(p, hw, L, tail, kdepth, smem == 0, nullptr);
}

// One K-cycle application z = K(r) on the level-0 grid: the tail from level
// ``tail`` down in ``smem`` bytes of shared memory (0: in global scratch).
extern "C" int mg_kcycle_launch(const void* const* lev, const long long* hw,
                                int L, const void* r, void* z, void* scratch,
                                long long scratch_bytes, double omega,
                                int nsmooth, int kdepth, int iters, int tail,
                                long long smem, int f64, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return f64 ? kcycle<double>(lev, hw, L, r, z, scratch, scratch_bytes,
                              omega, nsmooth, kdepth, iters, tail, smem, s)
             : kcycle<float>(lev, hw, L, r, z, scratch, scratch_bytes, omega,
                             nsmooth, kdepth, iters, tail, smem, s);
}

// The stages alone, for their tests: one smoothing kernel (mode 0 from
// zero, 1 with the prolonged xc of width Wc, 2 plain; ``sweep`` 0 gives the
// iterate itself) and one restriction into the (Hc, Wc) grid.
extern "C" int mg_smooth_launch(const void* const* lev, const long long* hw,
                                const void* r, const void* x, const void* xc,
                                long long Wc, double omega, int mode,
                                int sweep, void* out, int f64, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  auto go = [&](auto zero) -> int {
    using T = decltype(zero);
    Run<T> p;
    set_levels(p, lev, hw, 1);
    p.omega = T(omega);
    p.stream = s;
    const T* rr = static_cast<const T*>(r);
    const T* xx = static_cast<const T*>(x);
    const T* cc = static_cast<const T*>(xc);
    T* o = static_cast<T*>(out);
    if (mode == kFirst && sweep)
      smooth<T, kFirst, true>(p, 0, rr, xx, cc, Wc, o);
    else if (mode == kFirst)
      smooth<T, kFirst, false>(p, 0, rr, xx, cc, Wc, o);
    else if (mode == kProlong && sweep)
      smooth<T, kProlong, true>(p, 0, rr, xx, cc, Wc, o);
    else if (mode == kProlong)
      smooth<T, kProlong, false>(p, 0, rr, xx, cc, Wc, o);
    else if (mode == kPlain && sweep)
      smooth<T, kPlain, true>(p, 0, rr, xx, cc, Wc, o);
    else
      return (int)cudaErrorInvalidValue;
    return p.err;
  };
  return f64 ? go(0.0) : go(0.0f);
}

extern "C" int mg_restrict_launch(const void* const* lev, const long long* hw,
                                  const void* r, const void* x,
                                  const void* uc, long long Hc, long long Wc,
                                  void* rc, int f64, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  auto go = [&](auto zero) -> int {
    using T = decltype(zero);
    Run<T> p;
    set_levels(p, lev, hw, 1);
    restrict_kernel<T><<<(unsigned)blocks_for(Hc * Wc), kThreads, 0, s>>>(
        p.lev[0], static_cast<const T*>(r), static_cast<const T*>(x),
        static_cast<const T*>(uc), Hc, Wc, static_cast<T*>(rc));
    check(p);
    return p.err;
  };
  return f64 ? go(0.0) : go(0.0f);
}
