// The not-a-knot Thomas solve of the spline moments for NVIDIA Hopper
// (sm_90a): one launch runs the forward sweep and the back substitution
// of ops/spline.py:_thomas for every column of an (m, W) right-hand side.
//
// Replaces no TPU kernel: the JAX package solves the system with a
// lax.scan over the rows (neilpy_tpu/ops/spline.py), which XLA compiles
// into one loop on the device.  The port's plain version,
// ops/spline.py:_thomas_eager, issues two small torch ops a row forward
// and one a row back, 3m - 2 launches a solve (5,995 at m = 1999), and on
// the card the host issues them more slowly than the card runs them.
// This kernel does the same arithmetic in one launch.
//
//     dp[i] = (a[i] ? rhs[i] - dp[i-1] : rhs[i]) * inv[i]
//     x[i]  = dp[i] - cp[i] * x[i+1]          (x[m] = 0)
//
// The factors are the host's (_thomas_factors), uploaded once per (m,
// dtype, device) as three rows [a, inv, cp] (ops/spline.py:
// _device_factors), with inv = 1 / denom rounded on the host in the
// working type.
//
// Exactness: the kernel rounds as the plain version's torch ops do on the
// card.  torch.div(t, python_float) multiplies by the reciprocal rounded
// on the host (the CPU-scalar branch of PyTorch's div_true_kernel_cuda),
// so dp is __fmul_rn(row, inv), never a division; torch.sub(a, b) is
// a - b, one rounding; torch.sub(a, b, alpha=s) computes a + (-s) * b,
// which PyTorch's CUDA build contracts to one FMA, so x is
// fma(-cp, x[i+1], dp).  Each rounding is spelled out with its intrinsic
// (the build also passes -fmad=false), in float32 or float64 as the input
// is: the results equal the plain version's bit for bit (the cuda tests
// of tests/test_torch_spline_cuda.py).
//
// What bounds it on this card: the recurrence is serial along the rows,
// so the parallelism is one thread per column (2001 at SMRF's 2001^2
// grid) and each thread walks 2m dependent steps; bytes once (rhs read,
// x written) are 32 MB at 1999 x 2001 in float32, about 10 us at
// 3.35 TB/s, but a step whose load is waited for costs a memory latency.
// The design keeps it plain: a block is one warp of 32 neighbouring
// columns (63 blocks on 63 SMs at W = 2001, where 128 threads a block
// would crowd them onto 16), so a warp reads and writes 32 neighbouring
// addresses of one row per step, and each loop is unrolled by 8, so the
// loads of rhs, which do not depend on the carry, issue ahead of the
// arithmetic.  The forward pass writes dp into x and the back
// substitution reads it back and overwrites it in place, so there is no
// scratch; x stays in the 50 MB L2 between the passes.  Measured on an
// H100 at 1999 x 2001 this takes 0.45 ms in float32 and 0.83 ms in
// float64; a ring of cp.async panels in shared memory took 0.25 / 0.26
// ms but moved nothing end to end (the SMRF cell's job is about 500 ms),
// so the plain body is kept (PERF.md section 6).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;  // columns a block: one warp

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
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// One block per 32 columns: the forward sweep of rows 0..m-1 into x, then
// the back substitution of rows m-1..0 over it.  f holds the factor rows
// a, inv and cp, m values each.
template <typename T>
__global__ void __launch_bounds__(kWarp)
thomas_sweep_kernel(const T* __restrict__ rhs, T* __restrict__ x,
                    const T* __restrict__ f, int64_t m, int64_t W) {
  const int64_t c = (int64_t)blockIdx.x * kWarp + threadIdx.x;
  if (c >= W) return;
  const T* a = f;
  const T* inv = f + m;
  const T* cp = f + 2 * m;
  T prev = T(0);
#pragma unroll 8
  for (int64_t i = 0; i < m; ++i) {
    const T v = rhs[i * W + c];
    prev = mul_rn(a[i] != T(0) ? sub_rn(v, prev) : v, inv[i]);
    x[i * W + c] = prev;
  }
  T next = T(0);
#pragma unroll 8
  for (int64_t i = m - 1; i >= 0; --i) {
    next = fma_rn(-cp[i], next, x[i * W + c]);
    x[i * W + c] = next;
  }
}

template <typename T>
int launch(const void* rhs, void* x, const void* factors, long long m,
           long long W, cudaStream_t stream) {
  const long long blocks = (W + kWarp - 1) / kWarp;
  if (m <= 0 || blocks == 0) return 0;
  thomas_sweep_kernel<T><<<(unsigned)blocks, kWarp, 0, stream>>>(
      static_cast<const T*>(rhs), static_cast<T*>(x),
      static_cast<const T*>(factors), (int64_t)m, (int64_t)W);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes (neilpy_tpu_torch/ops/spline.py:
// _thomas_cuda).  rhs and x are contiguous (m, W) arrays on the device,
// factors the (3, m) rows [a, inv, cp], all float64 if f64 else float32;
// ``stream`` is a cudaStream_t.  Launches on that stream, does not
// synchronise, and returns cudaGetLastError().
extern "C" int thomas_sweep_launch(const void* rhs, void* x,
                                   const void* factors, long long m,
                                   long long W, int f64, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return f64 ? launch<double>(rhs, x, factors, m, W, s)
             : launch<float>(rhs, x, factors, m, W, s);
}
