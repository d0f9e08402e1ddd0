// Batched cost reduction for NVIDIA Hopper, CUDA C++ with a plain C entry.
//
// Replaces the Pallas TPU kernel `_cost_reduce_kernel` / `cost_reduce_bet` of
// src/repro/kernels/cost_reduce.py (wrapper `cost_reduce` in
// src/repro/kernels/ops.py, called by the batched DSE backend,
// src/repro/core/batched.py, for its busy-group contraction).
//
// What it computes.  out[b, e] = sum_t x[b, t] * w[e, t] for x [B, T] (one row
// of per-slot durations per config of the batch), w [E, T] (static 0/1/k
// membership rows) and out [B, E], x and w read by a row stride with
// contiguous rows, out contiguous, in float or double.  Each output
// accumulates in its own type with IEEE round-to-nearest fused multiply-adds:
// no TF32, no lower-precision products, so integer count rows stay exact and
// the double instance carries the batched backend's float64 parity budget
// (rel 1e-6 against the compiled backend).  No atomics on the sums and a
// fixed order of every addition: two runs give the same bits.
//
// How it differs from the TPU kernel, and why.  The TPU kernel tiles 128 x 128
// for the MXU, zero-pads every operand, runs T as a sequential grid dimension
// and accumulates in fp32.  On the batched backend's path the product is
// skinny: B = 1..18 configs of one structure class (mean 2.7), E = 2G busy
// groups (compute and comm rows of every group stacked, 4..48) and
// T ~ 4 200 slot entries.  That is a few dozen outputs of ~4 200 terms.
//
// What bounds it on an H100.  Bytes at every size: x, w and out once each,
// (B T + E T + B E) words.  At the sweep's [3, 12, 4191] in double that is
// 0.5 MB, 0.15 us at 3.35 TB/s, far below a launch (~2.5 us for an empty
// one); what bounds a launch there is latency: how many dependent memory
// round trips (~1 us each) its slowest warp makes.  At [1024, 12, 4191] it
// is 34 MB, 10.3 us, and the bytes of x rule.
//
// The design.
//  * T is split over the card.  A block owns a slice of T (a multiple of
//    128 terms), an e-tile of ET = 4 or 8 outputs and 4 config rows per
//    warp (16 or 32 sums a lane), with 1..4 warps on consecutive row groups.
//    A warp walks its slice in steps of 32 V terms (V = 16 bytes of the
//    type): per step each lane issues all its loads (4 rows of x, ET rows of
//    w, V terms each, one element per lane per load, so each load of the
//    warp is a coalesced 128- or 256-byte run), then its 4 x ET x V FMAs;
//    two steps are unrolled, so two rounds of loads are in flight.  (The V
//    terms as one 16-byte vector per lane measured slower at every fp64
//    size: 0.0239 against 0.0189 ms at [1024, 12, 4096].)  At the sweep's
//    sizes the wrapper's rule (`_split`) cuts T into 33 slices of 128
//    terms, and a lane makes one or two steps: one round trip, where a
//    thread walking T would wait on ~17 dependent loads.
//  * A warp reduces its 4 x ET sums across its 32 lanes with a
//    reduce-scatter butterfly: each of the first log2(4 ET) levels halves
//    the values a lane holds (31 shuffles for 32 sums, not 32 x 5), the rest
//    add the one left.  Warps own distinct rows, so no block-wide reduction.
//  * Slices meet in a second pass of the same launch: each block writes its
//    partial sums to scratch, and the last block of each (row group, e-tile)
//    to arrive (a ticket, counted with an integer atomic and reset by that
//    block, so calls queued on one stream can share it) adds the slices in
//    slice order.  With one slice the block writes out directly.
//  * At large B the rule cuts T into as few slices as keep the grid within
//    one wave (three blocks per SM: the 8-wide instance's registers allow
//    three), a block's 4 warps read the same w rows at the same steps (w, <=
//    ~1 MB, stays in L2 and is served to them from L1), and x is read once
//    per e-tile.  A 16-wide e-tile would read x once for E = 12, but at 2
//    rows a warp it holds only two blocks per SM and measured slower
//    (0.0221 against 0.0184 ms at [1024, 12, 4191]).
//  * Ragged edges: rows of x and w past B and E are clamped to the last row
//    (loaded, computed, never written), terms past the slice's end read as 0.
//    Nothing is padded or copied on the way in.
// No wgmma, DMMA or TMA: a latency-bound launch does not need them, and at
// large B the kernel is bound by the bytes of x, not by its FMAs.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 4;
constexpr int kGranule = 128;       // a slice is a multiple of this many terms
constexpr int kRows = 4;            // config rows per warp

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

__host__ __device__ constexpr int log2i(int n) {
  return n <= 1 ? 0 : 1 + log2i(n / 2);
}

struct Params {
  const void* x;
  const void* w;
  void* out;
  long long n_b, n_e, n_t;      // B, E, T
  long long sx, sw;             // row strides of x and w, in elements
  long long slices, slice_len;  // T cut into `slices` pieces of slice_len terms
  void* part;                   // slices > 1: the slices' partial sums
  unsigned* ticket;             // slices > 1: arrivals per (row group, e-tile)
};

// One level of the reduce-scatter butterfly, then the next: the lane with
// bit `off` set keeps the upper half of its H x 2 sums and adds its
// partner's copy of them (compile-time indices, so the sums stay in
// registers).
template <int N, int H, typename Real>
__device__ __forceinline__ void halve(Real (&a)[N], int lane) {
  if constexpr (H >= 1) {
    constexpr int off = kWarp * H / N;
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const Real keep = upper ? a[i + H] : a[i];
      const Real send = upper ? a[i] : a[i + H];
      a[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
    halve<N, H / 2>(a, lane);
  }
}

// The V terms of one row a lane reads in the warp step at `base`: element v
// at base + 32 v + lane, so each load of the warp is one coalesced run.
template <typename Real, int V>
__device__ __forceinline__ void load_terms(const Real* __restrict__ row,
                                           long long base, int lane,
                                           long long end, Real* v) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const long long t = base + k * kWarp + lane;
    v[k] = t < end ? __ldg(row + t) : Real(0);
  }
}

template <typename Real, int ET>
__global__ void __launch_bounds__(kWarp * kMaxWarps)
cost_reduce_kernel(const Params p) {
  constexpr int V = 16 / sizeof(Real);       // terms a lane per step
  constexpr int RB = kRows;
  constexpr int N = RB * ET;                 // sums of one lane: 16 or 32
  constexpr int kHalve = log2i(N);
  static_assert((1 << kHalve) == N && N <= kWarp,
                "RB x ET: a power of 2 up to 32");
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  const long long slice = blockIdx.x;
  const long long e0 = static_cast<long long>(blockIdx.y) * ET;
  const long long unit = static_cast<long long>(blockIdx.z) * gridDim.y +
                         blockIdx.y;
  const long long b0 =
      (static_cast<long long>(blockIdx.z) * warps + warp) * RB;
  const Real* __restrict__ x = static_cast<const Real*>(p.x);
  const Real* __restrict__ w = static_cast<const Real*>(p.w);
  Real* __restrict__ out = static_cast<Real*>(p.out);

  const long long t_begin = slice * p.slice_len;
  const long long t_end =
      p.n_t < t_begin + p.slice_len ? p.n_t : t_begin + p.slice_len;

  Real a[N];
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = Real(0);
#pragma unroll 2
  for (long long base = t_begin; base < t_end; base += kWarp * V) {
    Real xv[RB][V], wv[ET][V];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const long long b = b0 + r < p.n_b ? b0 + r : p.n_b - 1;
      load_terms<Real, V>(x + b * p.sx, base, lane, t_end, xv[r]);
    }
#pragma unroll
    for (int j = 0; j < ET; ++j) {
      const long long e = e0 + j < p.n_e ? e0 + j : p.n_e - 1;
      load_terms<Real, V>(w + e * p.sw, base, lane, t_end, wv[j]);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int j = 0; j < ET; ++j)
#pragma unroll
        for (int k = 0; k < V; ++k)
          a[r * ET + j] = fma_rn(xv[r][k], wv[j][k], a[r * ET + j]);
  }

  // reduce-scatter butterfly: each level halves the sums a lane holds, then
  // the one left is summed over the remaining lane bits.  Lane l ends with
  // sum l >> (5 - kHalve).
  halve<N, N / 2>(a, lane);
#pragma unroll
  for (int off = kWarp / (2 * N); off >= 1; off /= 2)
    a[0] += __shfl_xor_sync(0xffffffffu, a[0], off);
  const int idx = lane >> (5 - kHalve);
  const bool writer = (lane & ((kWarp / N) - 1)) == 0;
  const long long n_out = static_cast<long long>(warps) * N;   // per block

  if (p.slices == 1) {
    const long long b = b0 + idx / ET;
    const long long e = e0 + idx % ET;
    if (writer && b < p.n_b && e < p.n_e) out[b * p.n_e + e] = a[0];
    return;
  }
  Real* part = static_cast<Real*>(p.part);
  if (writer) part[(unit * p.slices + slice) * n_out + warp * N + idx] = a[0];
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(p.ticket + unit, 1u) ==
           static_cast<unsigned>(p.slices - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: every output of (row group, e-tile), slices in order
  const Real* all = part + unit * p.slices * n_out;
  for (long long o = threadIdx.x; o < n_out; o += blockDim.x) {
    const long long b =
        (static_cast<long long>(blockIdx.z) * warps + o / N) * RB +
        (o % N) / ET;
    const long long e = e0 + o % ET;
    if (b >= p.n_b || e >= p.n_e) continue;
    // loads eight slices ahead of their adds, which stay in slice order
    Real s = __ldcg(all + o);
    long long sl = 1;
    for (; sl + 8 <= p.slices; sl += 8) {
      Real v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = __ldcg(all + (sl + k) * n_out + o);
#pragma unroll
      for (int k = 0; k < 8; ++k) s += v[k];
    }
    for (; sl < p.slices; ++sl) s += __ldcg(all + sl * n_out + o);
    out[b * p.n_e + e] = s;
  }
  if (threadIdx.x == 0) p.ticket[unit] = 0u;   // ready for the next call
}

template <typename Real>
int launch(Params p, int e_tile, int warps, void* stream) {
  constexpr int V = 16 / sizeof(Real);
  if ((e_tile != 4 && e_tile != 8) || warps < 1 || warps > kMaxWarps ||
      p.n_b < 1 || p.n_e < 1 || p.n_t < 0 || p.slices < 1 ||
      p.slice_len < kGranule || p.slice_len % kGranule ||
      p.slices * p.slice_len < p.n_t ||
      (p.slices - 1) * p.slice_len >= (p.n_t > 0 ? p.n_t : 1) ||
      (p.slices > 1 && (p.part == nullptr || p.ticket == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  static_assert(kGranule % (kWarp * V) == 0, "a slice is whole warp steps");
  const long long tiles = (p.n_e + e_tile - 1) / e_tile;
  const long long groups = (p.n_b + kRows * warps - 1) / (kRows * warps);
  if (tiles > 65535 || groups > 65535 || p.slices > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(p.slices),
                  static_cast<unsigned>(tiles),
                  static_cast<unsigned>(groups));
  const auto s = static_cast<cudaStream_t>(stream);
  if (e_tile == 4)
    cost_reduce_kernel<Real, 4><<<grid, warps * kWarp, 0, s>>>(p);
  else
    cost_reduce_kernel<Real, 8><<<grid, warps * kWarp, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B, T] (row stride meta[3]), w [E, T] (row stride meta[4]), out [B, E]
// contiguous.  meta = {B, E, T, x row stride, w row stride, slices,
// slice_len}.  dtype 0 float, 1 double.  e_tile 4 or 8, warps 1..4 per
// block (4 config rows each).  part / ticket: scratch of slices > 1:
// ceil(E / e_tile) * row groups * slices * warps * 4 * e_tile partial sums
// of the type, and one zeroed unsigned per (row group, e-tile), left at
// zero.  Launches exactly the kernel these name, or returns a cudaError and
// launches nothing.
extern "C" int cost_reduce_launch(const void* x, const void* w, void* out,
                                  const long long* meta, int dtype,
                                  int e_tile, int warps, void* part,
                                  void* ticket, void* stream) {
  const Params p{x, w, out, meta[0], meta[1], meta[2], meta[3], meta[4],
                 meta[5], meta[6], part, static_cast<unsigned*>(ticket)};
  if (dtype == 0) return launch<float>(p, e_tile, warps, stream);
  if (dtype == 1) return launch<double>(p, e_tile, warps, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
