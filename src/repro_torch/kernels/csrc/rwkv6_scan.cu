// RWKV6 (Finch) WKV recurrence for NVIDIA Hopper, CUDA C++ with a plain C entry.
//
// Replaces the Pallas TPU kernel `_wkv_kernel` / `wkv6_bhsd` of
// src/repro/kernels/rwkv6_scan.py (model-layout wrapper `wkv6` in
// src/repro/kernels/ops.py).  The JAX model runs the same function as
// `_wkv_chunk` under `lax.scan` (src/repro/models/layers.py).
//
// What it computes.  For every batch b and head n, with a [D, D] fp32 state S
// (row d = key channel, column e = value channel), the sequence is cut into
// chunks of C steps (C divides S_len) and
//
//     out_t = r_t . (S_{t-1} + diag(u) k_t^T v_t)
//     S_t   = diag(w_t) S_{t-1} + k_t^T v_t
//
// except for one property of the TPU kernel that is part of its result: inside
// a chunk, the decay between two steps of the same chunk is factorised with
// the per-step log-decay floored at -80/C.  So the intra-chunk part of out_t
// uses wc = max(w, e^{-80/C}) where the state (carried across chunks) uses the
// true w.  For C = 1 (a decode step) there is no intra-chunk pair and the
// result is the exact recurrence.  Both use max(w, 1e-30), as the TPU kernel
// takes the log of that.
//
// Design: three [D, D] accumulators per (b, n), all in registers.
//   A  the chunk-start state, decayed by the true w:   A <- S_start, A_t = diag(w_t) A_{t-1}
//   B  the intra-chunk sum with the floored decay:     B <- 0,  B_t = diag(wc_t) B_{t-1} + k_t^T v_t
//   T  the same sum with the true decay:               T <- 0,  T_t = diag(w_t) T_{t-1} + k_t^T v_t
//   out_t = r_t (A_{t-1} + B_{t-1} + diag(u) k_t^T v_t)
// and at a chunk's end the carried state is A + T.  This is exact for any C,
// C = S_len included (a prompt whose length 32 does not divide is one chunk),
// and never builds the TPU kernel's [C, C] score matrix.
//
// How it differs from the TPU kernel, and why.
//  * The TPU grid carries the state in VMEM scratch across a sequential chunk
//    axis and phrases the chunk as [C,C] / [C,D] matmuls for the MXU.  Blocks
//    of a CUDA grid run in no order, so here one block owns (b, n, 16 state
//    columns) and walks the whole sequence itself; the state never leaves
//    registers.  Value columns e are independent, so splitting them over
//    blocks needs no communication: a [2, 2048, 64, 64] prefill is 512 blocks.
//  * Each of a block's 128 threads owns one column e and every eighth row d
//    (D/8 rows) of A, B and T; the eight threads of a column are neighbouring
//    lanes, so the row sum of out_t is three shuffles.  r, k, w, wc of 16
//    steps are staged in shared memory as one float4 per (step, row), read as
//    a broadcast; the next 16 steps are loaded into registers while these
//    are computed, and out is staged in shared memory and written 16 columns
//    at a time.
//  * It reads the model layout [B, S, N, D] (or [B, N, S, D]) by strides; no
//    transposes.  The new state may be written over the old one (a decode
//    step updates the cache in place): a thread reads its own state elements
//    before the loop and writes the same elements after it.
//  * All arithmetic is IEEE fp32 (no fast math), as in the TPU kernel.
//
// What bounds it on an H100.  Per (b, n, step): 4 D^2 operations (counting
// the multiply-add into out, A's decay, B's and T's updates), and the bytes
// of r, k, v, w and out (5 D floats) plus the state once in and once out.  At
// the main prefill shape [2, 2048, 64, 64] the bytes bound it (340 MB at
// 3.35 TB/s = 0.101 ms; 4.3 GFLOP at 67 TFLOP/s fp32 = 0.064 ms).  The kernel
// is a latency-bound sequential walk: per step each thread runs D/8
// dependent multiply-adds into out and three shuffles, with one barrier per
// 16 steps; the whole grid is only 2048 warps, ~16 per SM, to hide that
// latency with.  A decode step ([8, 1, 64, 64]) moves 16.8 MB of state (bound
// 0.005 ms) and sits at the launch floor.  Faster forms (a chunked
// tensor-core product inside the chunk) are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 16;                  // state columns per block
constexpr int kGroups = 8;                 // threads per column (row groups)
constexpr int kThreads = kCols * kGroups;  // 128
constexpr int kSteps = 16;                 // time steps staged at once

struct Params {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* u;    // [N, D]
  const float* s0;   // [B, N, D, D]
  float* out;
  float* sout;       // [B, N, D, D]; may equal s0
  int B, S, N, D, C;
  long long r_sb, r_ss, r_sn;   // element strides; D has stride 1
  long long k_sb, k_ss, k_sn;
  long long v_sb, v_ss, v_sn;
  long long w_sb, w_ss, w_sn;
  long long o_sb, o_ss, o_sn;
  float floor_w;                // e^{-80/C}
};

// One tile of kSteps steps of r, k, w (all D rows) and v (the block's
// columns), held in registers between its load and its store to shared
// memory.  Steps past S are zeros.
template <int D>
struct Tile {
  static constexpr int kLoads = kSteps * D / kThreads;
  static constexpr int kVLoads = kSteps * kCols / kThreads;
  float r[kLoads], k[kLoads], w[kLoads], v[kVLoads];

  __device__ void load(const Params& p, const float* rp, const float* kp,
                       const float* wp, const float* vp, int t0, int col0,
                       int tid) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads;
      const int t = t0 + i / D;
      const int d = i % D;
      const bool in = t < p.S;
      r[j] = in ? rp[(long long)t * p.r_ss + d] : 0.f;
      k[j] = in ? kp[(long long)t * p.k_ss + d] : 0.f;
      w[j] = in ? wp[(long long)t * p.w_ss + d] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kVLoads; ++j) {
      const int i = tid + j * kThreads;
      const int t = t0 + i / kCols;
      v[j] = t < p.S ? vp[(long long)t * p.v_ss + col0 + i % kCols] : 0.f;
    }
  }

  __device__ void store(float4 (*sX)[D], float (*sV)[kCols], float floor_w,
                        int tid) const {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads;
      const float wt = fmaxf(w[j], 1e-30f);
      sX[i / D][i % D] = make_float4(r[j], k[j], wt, fmaxf(wt, floor_w));
    }
#pragma unroll
    for (int j = 0; j < kVLoads; ++j) {
      const int i = tid + j * kThreads;
      sV[i / kCols][i % kCols] = v[j];
    }
  }
};

// At most 128 registers, so that 4 blocks (16 warps) share an SM and the main
// prefill shape's 512 blocks run in one wave (187 registers uncapped: two
// waves of 2 blocks per SM, 16 % slower).
template <int D>
__global__ void __launch_bounds__(kThreads, 4) wkv6_kernel(const Params p) {
  constexpr int R = D / kGroups;           // rows per thread
  __shared__ float4 sX[kSteps][D];         // {r, k, max(w,1e-30), max(w,1e-30,floor)}
  __shared__ float sV[kSteps][kCols];
  __shared__ float sO[kSteps][kCols];      // out of the tile, written coalesced

  const int tid = threadIdx.x;
  const int g = tid % kGroups;             // rows g, g + 8, g + 16, ...
  const int c = tid / kGroups;
  const int col0 = blockIdx.x * kCols;     // D is a multiple of kCols
  const int e = col0 + c;                  // state column
  const int n = blockIdx.y;
  const int b = blockIdx.z;

  const float* rp = p.r + b * p.r_sb + n * p.r_sn;
  const float* kp = p.k + b * p.k_sb + n * p.k_sn;
  const float* vp = p.v + b * p.v_sb + n * p.v_sn;
  const float* wp = p.w + b * p.w_sb + n * p.w_sn;
  float* op = p.out + b * p.o_sb + n * p.o_sn;
  const long long state_off = ((long long)b * p.N + n) * D * D;

  float A[R], Bs[R], T[R], u[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int d = g + kGroups * i;
    A[i] = p.s0[state_off + (long long)d * D + e];
    Bs[i] = 0.f;
    T[i] = 0.f;
    u[i] = p.u[(long long)n * D + d];
  }

  Tile<D> next;
  next.load(p, rp, kp, wp, vp, 0, col0, tid);
  int left = p.C;                          // steps left in the current chunk
  int prev_steps = 0;
  for (int t0 = 0; t0 < p.S; t0 += kSteps) {
    const int steps = min(kSteps, p.S - t0);
    __syncthreads();                       // the previous tile's readers are done
    for (int i = tid; i < prev_steps * kCols; i += kThreads)
      op[(long long)(t0 - kSteps + i / kCols) * p.o_ss + col0 + i % kCols] =
          sO[i / kCols][i % kCols];
    next.store(sX, sV, p.floor_w, tid);
    __syncthreads();
    if (t0 + kSteps < p.S)                 // in flight while this tile runs
      next.load(p, rp, kp, wp, vp, t0 + kSteps, col0, tid);

    for (int t = 0; t < steps; ++t) {
      if (left == 0) {                     // a new chunk starts from A + T
#pragma unroll
        for (int i = 0; i < R; ++i) {
          A[i] += T[i];
          T[i] = 0.f;
          Bs[i] = 0.f;
        }
        left = p.C;
      }
      --left;
      const float vv = sV[t][c];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 x = sX[t][g + kGroups * i];
        const float kv = x.y * vv;
        // r (A + B + u k v): inter-chunk, intra-chunk and the bonus
        acc = fmaf(x.x, fmaf(u[i], kv, A[i] + Bs[i]), acc);
        A[i] *= x.z;
        Bs[i] = fmaf(x.w, Bs[i], kv);
        T[i] = fmaf(x.z, T[i], kv);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      acc += __shfl_xor_sync(0xffffffffu, acc, 4);
      if (g == 0) sO[t][c] = acc;
    }
    prev_steps = steps;
  }
  __syncthreads();
  const int last0 = ((p.S - 1) / kSteps) * kSteps;
  for (int i = tid; i < prev_steps * kCols; i += kThreads)
    op[(long long)(last0 + i / kCols) * p.o_ss + col0 + i % kCols] =
        sO[i / kCols][i % kCols];

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int d = g + kGroups * i;
    p.sout[state_off + (long long)d * D + e] = A[i] + T[i];
  }
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  static_assert(D % kCols == 0 && D % kGroups == 0, "D: a multiple of 16");
  const dim3 grid(D / kCols, p.N, p.B);
  wkv6_kernel<D><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// meta, 20 integers: B S N D C | r strides b s n | k strides b s n |
// v strides b s n | w strides b s n | out strides b s n.  All tensors fp32;
// u [N, D], state_in / state_out [B, N, D, D] contiguous.  Returns the
// cudaError_t of the launch (0 on success), or cudaErrorInvalidValue for
// arguments it does not take.
extern "C" int wkv6_launch(const float* r, const float* k, const float* v,
                           const float* w, const float* u,
                           const float* state_in, float* out, float* state_out,
                           const long long* meta, float floor_w,
                           void* stream) {
  Params p;
  p.r = r; p.k = k; p.v = v; p.w = w; p.u = u;
  p.s0 = state_in; p.out = out; p.sout = state_out;
  p.B = (int)meta[0]; p.S = (int)meta[1]; p.N = (int)meta[2];
  p.D = (int)meta[3]; p.C = (int)meta[4];
  p.r_sb = meta[5];  p.r_ss = meta[6];  p.r_sn = meta[7];
  p.k_sb = meta[8];  p.k_ss = meta[9];  p.k_sn = meta[10];
  p.v_sb = meta[11]; p.v_ss = meta[12]; p.v_sn = meta[13];
  p.w_sb = meta[14]; p.w_ss = meta[15]; p.w_sn = meta[16];
  p.o_sb = meta[17]; p.o_ss = meta[18]; p.o_sn = meta[19];
  p.floor_w = floor_w;
  if (p.B <= 0 || p.S <= 0 || p.N <= 0 || p.C <= 0 || p.S % p.C != 0 ||
      p.B > 65535 || p.N > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p.D) {
    case 16: return (int)launch<16>(p, st);
    case 32: return (int)launch<32>(p, st);
    case 48: return (int)launch<48>(p, st);
    case 64: return (int)launch<64>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
