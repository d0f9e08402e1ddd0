// Batched cost reduction for NVIDIA Hopper, CUDA C++ with a plain C entry.
//
// Replaces the Pallas TPU kernel `_cost_reduce_kernel` / `cost_reduce_bet` of
// src/repro/kernels/cost_reduce.py (wrapper `cost_reduce` in
// src/repro/kernels/ops.py, called by the batched DSE backend,
// src/repro/core/batched.py, for its busy-group contraction).
//
// What it computes.  out[b, e] = sum_t x[b, t] * w[e, t] for x [B, T] (one row
// of per-slot durations per config of the batch), w [E, T] (static 0/1/k
// membership rows) and out [B, E], all row-major and contiguous, in float or
// double.  Each output accumulates in its own type with IEEE round-to-nearest
// fused multiply-adds: no TF32, no lower-precision products, so integer count
// rows stay exact and the double instance carries the batched backend's
// float64 parity budget (rel 1e-6 against the compiled backend).
//
// How it differs from the TPU kernel, and why.
//  * The TPU kernel tiles 128 x 128 for the MXU, zero-pads every operand to
//    tile multiples, runs the T axis as a sequential grid dimension with a
//    zero-init on its first step, and accumulates in fp32 whatever the input.
//    On the batched backend's path the product is skinny: B up to a few
//    hundred configs, E = 2..30 busy groups and T ~ 4 200 slot entries, i.e.
//    a few thousand outputs of ~4 200 terms each.  So here one block owns one
//    config row b and up to kRows = 8 outputs e; its 256 threads split T
//    (thread i takes t = i, i + 256, ...), each keeping kRows partial sums in
//    registers, and the block reduces them: a fixed shuffle tree in each warp,
//    then the eight warps' partials summed in warp order.  A [64, 4189] x
//    [2, 4189]^T product is 64 blocks of 256 threads with ~17 terms a thread,
//    not a handful of threads walking 4 189 terms each.
//  * Ragged edges are masked in the kernel (a block with fewer than kRows
//    outputs left reads only the rows that exist), so nothing is padded or
//    copied on the way in.
//  * No atomics and a fixed order of every sum: two runs give the same bits.
//
// What bounds it on an H100.  Bytes: x, w and out once each, (B T + E T + B E)
// words; at the path's shape [64, 4189] x [2, 4189]^T in double that is
// 2.21 MB, 0.66 us at 3.35 TB/s, against 1.07 MFLOP (0.016 us at the fp64
// tensor-core rate).  Every shape on the path is bound by bytes.  The kernel
// reads x once per block of 8 outputs (so ceil(E/8) times, from L2 after the
// first) and w once per config row (w is at most ~1 MB, L2-resident); at these
// sizes the launch itself (a few microseconds) is the floor, which is why the
// batched backend calls it twice per structure class and not per entry.
// wgmma / DMMA tiles and TMA are for a later, larger batch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;            // outputs e per block

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

template <typename Real>
__global__ void __launch_bounds__(kThreads)
cost_reduce_kernel(const Real* __restrict__ x, const Real* __restrict__ w,
                   Real* __restrict__ out, long long n_e, long long n_t) {
  const long long b = blockIdx.x;
  const long long e0 = static_cast<long long>(blockIdx.y) * kRows;
  const int ne = static_cast<int>(n_e - e0 < kRows ? n_e - e0 : kRows);
  const Real* xr = x + b * n_t;
  const Real* wr = w + e0 * n_t;

  Real acc[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) acc[j] = Real(0);
  for (long long t = threadIdx.x; t < n_t; t += kThreads) {
    const Real xv = xr[t];
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      if (j < ne) acc[j] = fma_rn(xv, wr[j * n_t + t], acc[j]);
  }

  // fixed-order block reduction: a shuffle tree per warp, then warps in order
#pragma unroll
  for (int j = 0; j < kRows; ++j)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[j] += __shfl_down_sync(0xffffffffu, acc[j], off);
  __shared__ Real part[kWarps][kRows];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) part[warp][j] = acc[j];
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < ne) {
    Real s = part[0][threadIdx.x];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) s += part[k][threadIdx.x];
    out[b * n_e + e0 + threadIdx.x] = s;
  }
}

template <typename Real>
int launch(const Real* x, const Real* w, Real* out, long long n_b,
           long long n_e, long long n_t, void* stream) {
  const long long blocks_e = (n_e + kRows - 1) / kRows;
  if (n_b <= 0 || n_e <= 0 || n_t < 0 || n_b > 2147483647LL ||
      blocks_e > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(n_b), static_cast<unsigned>(blocks_e));
  cost_reduce_kernel<Real><<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      x, w, out, n_e, n_t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int cost_reduce_f32(const float* x, const float* w, float* out,
                               long long n_b, long long n_e, long long n_t,
                               void* stream) {
  return launch<float>(x, w, out, n_b, n_e, n_t, stream);
}

extern "C" int cost_reduce_f64(const double* x, const double* w, double* out,
                               long long n_b, long long n_e, long long n_t,
                               void* stream) {
  return launch<double>(x, w, out, n_b, n_e, n_t, stream);
}
