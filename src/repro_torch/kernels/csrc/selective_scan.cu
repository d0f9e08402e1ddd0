// Selective scan of the Mamba mixer for NVIDIA Hopper, CUDA C++ with a plain
// C entry.
//
// Replaces no Pallas kernel: the JAX package runs this scan as plain JAX
// (`_ssm_scan`, src/repro/models/layers.py, over `jax.lax.associative_scan`).
// It takes the place of the port's plain-PyTorch span `mamba.ssm` of
// `mamba_layer` (kernels/selective_scan.py:selective_scan_plain), which built
// dA = exp(dt A) and dBx = dt x B as [B, S, Din, P] fp32 tensors and moved
// each through device memory some fifty times.
//
// What it computes.  For every batch row b and channel i, in fp32:
//
//     A[i, p] = -exp(A_log[i, p])
//     h[p]    = exp(dt[t, i] A[i, p]) h[p] + (dt[t, i] x[t, i]) B[t, p]
//     y[t, i] = sum_p h[p] C[t, p]                 (rounded once to y's type)
//
// from h = h0[b, i, :] (zero where no h0 is given), and the last h in fp32.
// dt is fp32; x, B and C are read in one of fp32, bf16 or fp16 and widened on
// load, and y is written in that type.  B and C are read by their strides, so
// the layer hands over its strided views of `xdb` without a copy.
//
// The bound.  Per (b, t, i) the kernel has to read dt (4 bytes) and x, and
// write y (2 bytes each in bf16); B and C are 2 P values per (b, t), shared by
// every channel.  At the served prefill, Din 8192 and P 16, that is about
// 0.54 GB per 8192-token batch, 0.16 ms at 3.35 TB/s.  The work is P = 16
// accurate `expf` and about 6 fp32 operations per (b, t, i, p): 1.07e9 `expf`
// per batch, 0.26 ms at the SFU's 16 per clock per SM (132 SMs at 1.98 GHz),
// and the fp32 pipe's range reduction around each on top.  So the kernel is
// bound by `expf` and fp32 throughput, not by bytes, and its design keeps
// every intermediate out of device memory:
//
// * A thread owns one channel and keeps its P states in registers for the
//   whole walk; a block is 128 neighbouring channels of one batch row, so each
//   step's loads of dt and x and store of y are coalesced across the warp.
//   dt and x are loaded 8 steps ahead into registers (kAhead), so the loads of
//   the next 8 steps are in flight while these are computed.  The walk is
//   latency-bound (a warp's step is a few hundred dependent-ish instructions
//   around 16 expf), so its steps are straight-line code: the data type is a
//   template parameter, and only a chunk's last group of fewer than 8 steps
//   runs a step at a time (a branch on the type at each step made the walk
//   1.3-1.5x slower on the card).
// * B_t and C_t are read by every channel: a block stages 64 steps of both in
//   shared memory at once (kStage), and every thread reads them as broadcasts.
// * The y-contraction is fused: y_t is summed from the states in registers
//   and stored once.  No [B, S, Din, P] tensor exists.
// * The card has to be filled at every shape the layer sends: one thread a
//   channel gives only B x Din threads (8 192 at B = 1).  So where that
//   leaves SMs without a block the sequence is cut into n chunks of L steps
//   (kernels/selective_scan.py:split: about 512 threads a SM, 8 chunks at
//   B = 1 and 4 at B = 2 at Din 8192; one chunk at B >= 4 and for decode),
//   and one launch runs them as a chained scan.  A block of chunk c > 0 first
//   walks its chunk from a zero state, keeping that local state and the
//   product of its dA (pass 1); it then waits for chunk c - 1's end state,
//   makes its own end, h_end = prod * h_start + local (one fused
//   multiply-add per state), publishes it to chunk c + 1 and replays its
//   chunk from h_start, writing y (pass 2).  Chunk 0 starts from h0 and only
//   replays, publishing its end when done.  So dt, x and B are read twice
//   (chunk 0's once), C once, and y written once.  The blocks take their
//   chunk in the order of an arrival ticket, so every chunk a block waits for
//   belongs to a block that is already running: the wait cannot deadlock.  A
//   wait longer than about a second (which would be a fault of this code)
//   traps instead of hanging the card.  The last block to finish leaves the
//   tickets and flags at 0 for the next launch on the stream.
//
// Rounding.  Within a chunk the kernel runs the step-by-step recurrence of
// `kernels.ref.ref_ssm` (the JAX package's own oracle), as one fused
// multiply-add per state and step, in place of `jax.lax.associative_scan`'s
// odd/even pairing; dBx is (dt x) B, rounded after each product, as the plain
// path forms it.  Across chunks it carries prod * h_start + local, as the
// plain path's `_ssm_scan` does, with prod the running product of the chunk's
// dA.  y is summed over p = 0, 1, ..., P - 1 in order.  `expf` is the accurate
// one (2 ulp; no -use_fast_math, no __expf).  The last state is the last
// chunk's replay.  dt, dA, dBx, the state and y's sum stay fp32.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;   // channels a block
constexpr int kStates = 16;     // the most states a channel
constexpr int kStage = 64;      // steps of B and C staged in shared memory
constexpr int kAhead = 8;       // steps of dt and x loaded ahead
constexpr long long kWaitPolls = 1LL << 24;   // ~1 s of 64 ns sleeps

struct Params {
  const float* dt;
  const void* x;
  const void* bm;
  const void* cm;
  const float* a_log;   // [D, P], contiguous
  const float* h0;      // [B, D, P], contiguous; null: zero
  void* y;
  float* h_out;         // [B, D, P], contiguous; null: not written
  float* ends;          // n > 1: [B, n, D, P] end states of the chunks
  unsigned* sync;       // n > 1: ticket, finished, then [B, n, tiles] flags
  long long dt_sb, dt_ss, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, y_sb, y_ss;
  int B, S, D, P, n, L, tiles;
  bool vec;             // P == 16 and the state arrays on 16 bytes
};

// x, B and C are read, and y written, in one type T: a template parameter,
// so that every load and store of the walk is straight-line code
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

// P states of one channel from `src` (row of P floats); zero beyond P.
// `l2` reads around the L1 cache (states another block wrote in this launch).
__device__ __forceinline__ void load_states(const float* src, const Params& p,
                                            bool l2, float (&h)[kStates]) {
  if (p.vec) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
    for (int q = 0; q < kStates / 4; ++q) {
      const float4 v = l2 ? __ldcg(s4 + q) : __ldg(s4 + q);
      h[4 * q] = v.x; h[4 * q + 1] = v.y; h[4 * q + 2] = v.z;
      h[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kStates; ++k)
      h[k] = k < p.P ? (l2 ? __ldcg(src + k) : __ldg(src + k)) : 0.f;
  }
}

__device__ __forceinline__ void store_states(float* dst, const Params& p,
                                             const float (&h)[kStates]) {
  if (p.vec) {
    float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int q = 0; q < kStates / 4; ++q)
      d4[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < kStates; ++k)
      if (k < p.P) dst[k] = h[k];
  }
}

// One step of channel i: dA and dBx from dt (d) and x, the states advanced,
// and in the replay y summed from them.
template <bool kReplay>
__device__ __forceinline__ float step(float d, float x, const float* sb,
                                      const float* sc,
                                      const float (&A)[kStates],
                                      float (&h)[kStates],
                                      float (&prod)[kStates]) {
  const float dx = d * x;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < kStates; ++k) {
    const float da = expf(d * A[k]);
    if (!kReplay) prod[k] *= da;
    h[k] = fmaf(da, h[k], dx * sb[k]);
    if (kReplay) acc = fmaf(h[k], sc[k], acc);
  }
  return acc;
}

// Walks steps [t0, t1) of batch row b for channel i (live: i < D).  Pass 1
// (kReplay false) advances h and the product of dA; the replay advances h and
// writes y.  Every thread of the block calls it with the same range: the
// staging of B and C is the block's.  Whole groups of kAhead steps run
// unrolled and unguarded; a chunk's last, shorter group runs a step at a
// time (one copy of the step's code: the unrolled walk is large already).
template <bool kReplay, typename T>
__device__ void walk(const Params& p, int b, int i, bool live, int t0, int t1,
                     const float (&A)[kStates], float (&h)[kStates],
                     float (&prod)[kStates], float (*sB)[kStates],
                     float (*sC)[kStates]) {
  const float* dt = p.dt + b * p.dt_sb + i;
  const T* x = static_cast<const T*>(p.x) + b * p.x_sb + i;
  const T* bm = static_cast<const T*>(p.bm) + b * p.b_sb;
  const T* cm = static_cast<const T*>(p.cm) + b * p.c_sb;
  T* y = static_cast<T*>(p.y) + b * p.y_sb + i;
  float dt_now[kAhead], x_now[kAhead], dt_next[kAhead], x_next[kAhead];

  auto load_ahead = [&](int tg, float (&d)[kAhead], float (&xv)[kAhead]) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int t = tg + u;
      const bool ok = live && t < t1;
      d[u] = ok ? __ldg(dt + t * p.dt_ss) : 0.f;
      xv[u] = ok ? to_float(x[t * p.x_ss]) : 0.f;
    }
  };

  load_ahead(t0, dt_now, x_now);
  for (int ts = t0; ts < t1; ts += kStage) {
    const int steps = min(kStage, t1 - ts);
    __syncthreads();                       // the last stage has been read
    for (int e = threadIdx.x; e < kStage * kStates; e += kThreads) {
      const int s = e / kStates, k = e % kStates;
      const bool ok = s < steps && k < p.P;
      sB[s][k] = ok ? to_float(bm[(ts + s) * p.b_ss + k]) : 0.f;
      if (kReplay) sC[s][k] = ok ? to_float(cm[(ts + s) * p.c_ss + k]) : 0.f;
    }
    __syncthreads();
    int g = 0;
    for (; g + kAhead <= steps; g += kAhead) {
      load_ahead(ts + g + kAhead, dt_next, x_next);
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const float acc = step<kReplay>(dt_now[u], x_now[u], sB[g + u],
                                        sC[g + u], A, h, prod);
        if (kReplay && live) y[(ts + g + u) * p.y_ss] = from_float<T>(acc);
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        dt_now[u] = dt_next[u];
        x_now[u] = x_next[u];
      }
    }
#pragma unroll 1
    for (; g < steps; ++g) {               // the chunk's last steps, one a time
      const int t = ts + g;
      const float d = live ? __ldg(dt + t * p.dt_ss) : 0.f;
      const float xv = live ? to_float(x[t * p.x_ss]) : 0.f;
      const float acc = step<kReplay>(d, xv, sB[g], sC[g], A, h, prod);
      if (kReplay && live) y[t * p.y_ss] = from_float<T>(acc);
    }
  }
}

__device__ bool wait_for(unsigned* flag) {
  for (long long poll = 0; poll < kWaitPolls; ++poll) {
    if (atomicAdd(flag, 0u) != 0u) return true;
    __nanosleep(64);
  }
  return false;
}

// At most 128 registers a thread, so that 4 blocks share a SM: the 512
// threads a SM that kernels/selective_scan.py:split plans for where it cuts
// the sequence.
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
selective_scan_kernel(Params p) {
  __shared__ float sB[kStage][kStates];
  __shared__ float sC[kStage][kStates];
  __shared__ unsigned s_unit;
  __shared__ bool s_last;

  unsigned unit = blockIdx.x;
  if (p.n > 1) {                           // chunks in the order of arrival
    if (threadIdx.x == 0) s_unit = atomicAdd(p.sync, 1u);
    __syncthreads();
    unit = s_unit;
  }
  const int tile = unit % p.tiles;
  const int b = (unit / p.tiles) % p.B;
  const int c = unit / (p.tiles * p.B);
  const int i = tile * kThreads + threadIdx.x;
  const bool live = i < p.D;
  const int t0 = c * p.L, t1 = min(p.S, t0 + p.L);
  const long long row = (long long)b * p.D + i;       // of [B, D, P]
  unsigned* flags = p.sync + 2;
  const long long slot = ((long long)b * p.n + c) * p.tiles + tile;
  auto end_of = [&](int chunk) {                       // of [B, n, D, P]
    return p.ends + (((long long)b * p.n + chunk) * p.D + i) * p.P;
  };
  auto publish = [&](const float (&h)[kStates]) {
    if (live) store_states(end_of(c), p, h);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) atomicExch(flags + slot, 1u);
  };

  float A[kStates], h[kStates], prod[kStates];
#pragma unroll
  for (int k = 0; k < kStates; ++k)
    A[k] = live && k < p.P ? -expf(p.a_log[(long long)i * p.P + k]) : 0.f;

  if (c == 0) {
    if (live && p.h0 != nullptr) {
      load_states(p.h0 + row * p.P, p, false, h);
    } else {
#pragma unroll
      for (int k = 0; k < kStates; ++k) h[k] = 0.f;
    }
  } else {
    float local[kStates];
#pragma unroll
    for (int k = 0; k < kStates; ++k) { local[k] = 0.f; prod[k] = 1.f; }
    walk<false, T>(p, b, i, live, t0, t1, A, local, prod, sB, sC);
    if (threadIdx.x == 0) {
      if (!wait_for(flags + slot - p.tiles)) __trap();  // chunk c - 1's
      __threadfence();
    }
    __syncthreads();
    if (live) {
      load_states(end_of(c - 1), p, true, h);
    } else {
#pragma unroll
      for (int k = 0; k < kStates; ++k) h[k] = 0.f;
    }
    if (c < p.n - 1) {
      float end[kStates];
#pragma unroll
      for (int k = 0; k < kStates; ++k) end[k] = fmaf(prod[k], h[k], local[k]);
      publish(end);
    }
  }
  walk<true, T>(p, b, i, live, t0, t1, A, h, prod, sB, sC);
  if (c == 0 && p.n > 1) publish(h);
  if (c == p.n - 1 && live && p.h_out != nullptr)
    store_states(p.h_out + row * p.P, p, h);

  if (p.n > 1) {                           // the last block out resets
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      s_last = atomicAdd(p.sync + 1, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (s_last) {
      const long long n_flags = (long long)p.B * p.n * p.tiles;
      for (long long e = threadIdx.x; e < n_flags; e += kThreads) flags[e] = 0u;
      if (threadIdx.x == 0) { p.sync[0] = 0u; p.sync[1] = 0u; }
    }
  }
}

bool on16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// meta: B, S, D, P, n, L, then the (batch, step) strides of dt, x, B, C, y in
// elements (their last dims are contiguous).  dtype: of x, B, C and y, 0 fp32,
// 1 bf16, 2 fp16.  ends / sync: scratch of n > 1 (sync zeroed before the
// first launch; every launch leaves it zeroed).
extern "C" int selective_scan_launch(const float* dt, const void* x,
                                     const void* bm, const void* cm,
                                     const float* a_log, const float* h0,
                                     void* y, float* h_out, float* ends,
                                     unsigned* sync, const long long* meta,
                                     int dtype, void* stream) {
  Params p;
  p.dt = dt; p.x = x; p.bm = bm; p.cm = cm; p.a_log = a_log; p.h0 = h0;
  p.y = y; p.h_out = h_out; p.ends = ends; p.sync = sync;
  p.B = (int)meta[0]; p.S = (int)meta[1]; p.D = (int)meta[2];
  p.P = (int)meta[3]; p.n = (int)meta[4]; p.L = (int)meta[5];
  p.dt_sb = meta[6];  p.dt_ss = meta[7];
  p.x_sb = meta[8];   p.x_ss = meta[9];
  p.b_sb = meta[10];  p.b_ss = meta[11];
  p.c_sb = meta[12];  p.c_ss = meta[13];
  p.y_sb = meta[14];  p.y_ss = meta[15];
  p.tiles = (p.D + kThreads - 1) / kThreads;
  p.vec = p.P == kStates && on16(a_log) && (h0 == nullptr || on16(h0)) &&
          (h_out == nullptr || on16(h_out)) && (ends == nullptr || on16(ends));
  const long long blocks = (long long)p.tiles * p.B * p.n;
  if (p.B <= 0 || p.S <= 0 || p.D <= 0 || p.P <= 0 || p.P > kStates ||
      p.n <= 0 || p.L <= 0 || (long long)(p.n - 1) * p.L >= p.S ||
      (long long)p.n * p.L < p.S || blocks > 0x7fffffffLL ||
      (p.n > 1 && (ends == nullptr || sync == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)blocks;
  if (dtype == 0)
    selective_scan_kernel<float><<<grid, kThreads, 0, st>>>(p);
  else if (dtype == 1)
    selective_scan_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(p);
  else if (dtype == 2)
    selective_scan_kernel<__half><<<grid, kThreads, 0, st>>>(p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
