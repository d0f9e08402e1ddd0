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
// takes the log of that.  r, k and v are read as fp32 or bf16 and cast on
// load, as the TPU kernel does; w, u and the state are fp32.  Arithmetic is
// fp32 FMAs and, for the served chunk size, 3xTF32 tensor-core products
// (each operand split into two TF32 parts, fp32 accumulation: fp32 accuracy,
// never plain TF32); the one approximate operation is the reciprocal of the
// floored decay products (below).
//
// Two kernels; the wrapper (kernels/rwkv6_scan.py:_variant) names one per call
// and this entry launches it or fails.
//
// decode (S_len = 1, so C = 1): a streaming kernel for the byte bound.  One
//   block per (b, n) of D * D / 16 threads; each thread owns four float4
//   runs of state columns (at head dim 64 a warp covers two whole 256-byte
//   rows, at 128 one 512-byte row), reads each state element once and
//   writes it once, in place.  out_e = sum_d r_d S[d,e] + (r.(u*k)) v_e: the
//   row sum of the four rows a thread holds, then one shared-memory pass over
//   the D/4 row slots; the bonus scalar is one warp's shuffle reduction.  An
//   [8, 1, 64, 64] step moves 16.8 MB of state (5.0 us at 3.35 TB/s).
//
// tiled (S_len > 1): a walk over tiles of steps that never span a chunk
//   boundary.  A block owns (b, n, a slice of state columns) for the whole
//   sequence and keeps its state in registers.  Three accumulators carry the
//   function exactly for any C:
//     A  the chunk-start state, decayed by the true w
//     B  the intra-chunk sum under the floored decay wc
//     T  the same sum under the true w
//   and at a chunk's end A <- A + T, B, T <- 0.  Per tile, with P prefix and
//   Sfx suffix running products within the tile ("excl" = exclusive):
//     out   = (r*Pw_excl) A + (r*Pwc_excl) B
//             + mask_strict((r*Pwc_excl)(k/Pwc_incl)^T) V + (r.(u*k)) v
//     T <- diag(Pw_tot) T + (k*Sfx_w)^T V,  B <- diag(Pwc_tot) B + (k*Sfx_wc)^T V
//     A <- diag(Pw_tot) A
//   Each product is a small dense one that gives the card many independent
//   operations (the one-step walk this replaces ran an 8-deep dependent
//   chain and three shuffles per step).  Two instances:
//   * wkv6_chunk_kernel, for chunks of at most 32 steps (the served C = 32):
//     one tile per chunk, so B and T are zero at every tile's start and only
//     A is carried; one block per (b, n) with two warp roles.  State warps
//     hold A^T in mma.sync fragments and run the tile's three products on
//     the tensor cores in 3xTF32; input warps load tile t + 2 and compute
//     tile t + 1's factors (product scans across the 32 lanes of a warp,
//     lane = step) and [L, L] scores (fp32 FMAs), which depend on the inputs
//     only.  One block barrier per tile.
//   * wkv6_tiled_kernel, for longer chunks (a prompt of S steps that 32 does
//     not divide is one chunk of S): tiles of 16 steps, all three
//     accumulators as fp32 FMA register tiles, one block per (b, n, 32
//     columns), three barriers per tile.
//   Numerics: only the floored products are divided by (times their
//   approximate reciprocal, within 2 ulp), and over one chunk they stay above
//   e^{-80} (fp32's normal range), so k/Pwc_incl is finite; the true-decay
//   products may underflow and are only multiplied.  wkv6_tiled_plain in
//   kernels/rwkv6_scan.py is this arithmetic in fp32 PyTorch, held against
//   the float64 function.
//
//   Layout of the FMA tiles: thread (g = lane / 4 % 8, pair) owns two state
//   columns and the rows 4g + 32m + {0..3}, so the four lanes of a row group
//   share their factor reads and a warp's float4 read of a factor row is one
//   shared-memory wavefront (each quarter-warp two 16-byte pieces, all 32
//   banks once); a tile's outputs are reduce-scattered over the row groups
//   by shuffles.  Operand rows of the mma products are padded to D + 8
//   floats, so fragment reads hit 32 distinct banks.  Inputs stream in by
//   cp.async, in 16-byte pieces where every row starts on 16 bytes, else in
//   4-byte pieces (any stride with a contiguous head dim).
//
// It reads the model layout [B, S, N, D] (or [B, N, S, D]) by strides; no
// transposes.  The new state may be written over the old one: every state
// element is read and written by the same thread.
//
// What bounds it on an H100.  Per (b, n, step): 4 D^2 operations and the
// bytes of r, k, v, w and out (5 D floats) plus the state once in and once
// out.  At the main prefill shape [2, 2048, 64, 64] the bytes bound it (340 MB
// at 3.35 TB/s = 0.101 ms).  The kernel is not: with 128 blocks of 12 warps
// it loads its inputs at about that rate, and the input warps' scans and
// scores and the state warps' products add to it (PERF.md section 7).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Params {
  const void* r;     // fp32 or bf16, like k and v
  const void* k;
  const void* v;
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
  int vec16;                    // r, k, v, w rows on 16 bytes: 16-byte copies
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// two consecutive elements (8-byte aligned for fp32, 4-byte for bf16)
__device__ __forceinline__ float2 to_f2(const float* x) {
  return *reinterpret_cast<const float2*>(x);
}
__device__ __forceinline__ float2 to_f2(const __nv_bfloat16* x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x));
}

// four consecutive elements (16-byte aligned for fp32, 8-byte for bf16)
__device__ __forceinline__ float4 to_f4(const float* x) {
  return *reinterpret_cast<const float4*>(x);
}
__device__ __forceinline__ float4 to_f4(const __nv_bfloat16* x) {
  const uint2 u = *reinterpret_cast<const uint2*>(x);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// 1/x for the floored decay products (e^-80 <= x <= 1): the hardware's
// approximate reciprocal (within 2 ulp), with no slow path to branch to
__device__ __forceinline__ float recip(float x) { return __fdividef(1.f, x); }

__device__ __forceinline__ float comp(const float4& a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

// ---------------------------------------------------------------------------
// decode
// ---------------------------------------------------------------------------

template <int D, typename T>
__global__ void __launch_bounds__(D * D / 16) wkv6_decode_kernel(const Params p) {
  constexpr int kThreads = D * D / 16;
  constexpr int kQ = D / 4;                 // float4 runs of a state row
  constexpr int kSlots = kThreads / kQ;     // row slots (D / 4)
  constexpr int kRows = D / kSlots;         // rows per thread (4)
  constexpr int kWidth = kThreads < 32 ? kThreads : 32;
  constexpr unsigned kMask = kThreads < 32 ? (1u << kThreads) - 1u : 0xffffffffu;
  __shared__ float s_r[D], s_k[D], s_w[D], s_ruk[D];
  __shared__ __align__(16) float s_v[D];
  __shared__ __align__(16) float s_part[kSlots][D];
  __shared__ float s_bonus;

  const int tid = threadIdx.x;
  const int n = blockIdx.x;
  const int b = blockIdx.y;
  const long long soff = ((long long)b * p.N + n) * D * D;
  const float4* s_in = reinterpret_cast<const float4*>(p.s0 + soff);
  float4* s_out = reinterpret_cast<float4*>(p.sout + soff);
  const int q = tid % kQ;
  const int slot = tid / kQ;

  float4 st[kRows];
#pragma unroll
  for (int m = 0; m < kRows; ++m) st[m] = s_in[(slot + kSlots * m) * kQ + q];
  if (tid < D) {
    const T* rp = static_cast<const T*>(p.r);
    const T* kp = static_cast<const T*>(p.k);
    const T* vp = static_cast<const T*>(p.v);
    const float r = to_f(rp[b * p.r_sb + n * p.r_sn + tid]);
    const float k = to_f(kp[b * p.k_sb + n * p.k_sn + tid]);
    s_r[tid] = r;
    s_k[tid] = k;
    s_v[tid] = to_f(vp[b * p.v_sb + n * p.v_sn + tid]);
    s_w[tid] = fmaxf(p.w[b * p.w_sb + n * p.w_sn + tid], 1e-30f);
    s_ruk[tid] = r * p.u[(long long)n * D + tid] * k;
  }
  __syncthreads();

  const float4 vq = reinterpret_cast<const float4*>(s_v)[q];
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const int d = slot + kSlots * m;
    const float rd = s_r[d], kd = s_k[d], wd = s_w[d];
    acc.x = fmaf(rd, st[m].x, acc.x);
    acc.y = fmaf(rd, st[m].y, acc.y);
    acc.z = fmaf(rd, st[m].z, acc.z);
    acc.w = fmaf(rd, st[m].w, acc.w);
    s_out[d * kQ + q] = make_float4(fmaf(wd, st[m].x, kd * vq.x),
                                   fmaf(wd, st[m].y, kd * vq.y),
                                   fmaf(wd, st[m].z, kd * vq.z),
                                   fmaf(wd, st[m].w, kd * vq.w));
  }
  reinterpret_cast<float4*>(s_part[slot])[q] = acc;
  if (tid < kWidth) {
    float c = 0.f;
    for (int d = tid; d < D; d += kWidth) c += s_ruk[d];
#pragma unroll
    for (int off = kWidth / 2; off > 0; off >>= 1)
      c += __shfl_xor_sync(kMask, c, off);
    if (tid == 0) s_bonus = c;
  }
  __syncthreads();
  if (tid < D) {
    float o = 0.f;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) o += s_part[s][tid];
    p.out[b * p.o_sb + n * p.o_sn + tid] = fmaf(s_bonus, s_v[tid], o);
  }
}

template <int D, typename T>
cudaError_t launch_decode(const Params& p, cudaStream_t stream) {
  wkv6_decode_kernel<D, T><<<dim3(p.N, p.B), D * D / 16, 0, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tiled
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// One step of a reduce-scatter over the eight row groups (lane bits 2-4):
// the lanes with lane bit BIT keep the upper H of the 2H values, the others
// the lower H, each adding its partner's half.  Three steps (16/16, 8/8,
// 4/4) leave the lanes of row group g the fully summed values 4g .. 4g + 3.
template <int H, int BIT>
__device__ __forceinline__ void fold(float (&acc)[32], int lane) {
  const bool upper = (lane & BIT) != 0;
#pragma unroll
  for (int x = 0; x < H; ++x) {
    const float send = upper ? acc[x] : acc[x + H];
    const float keep = upper ? acc[x + H] : acc[x];
    acc[x] = keep + __shfl_xor_sync(0xffffffffu, send, BIT);
  }
}

template <int D, int E, int L, typename T>
struct Tiled {
  static constexpr int DP = (D + 31) / 32 * 32;  // rows, padded with zeros
  static constexpr int DPP = DP + 4;             // factor row stride (banks)
  static constexpr int LP = L + 4;               // score row stride
  static constexpr int kThreads = 4 * E;
  static constexpr int kRuns = DP / 32;          // float4 runs of a thread
  static constexpr int kRows = 4 * kRuns;
  static constexpr int kUnit = 4 / sizeof(T);    // elements per 4-byte copy
  // one stage of the ring: r, k [L][DP] and v [L][E] as read, w [L][DP] fp32
  // stage rows of r, k (RS elements) and w (RW floats) padded by 16 bytes,
  // so the 32 steps of a row group are read across lanes in few wavefronts
  static constexpr int RS = DP + 16 / sizeof(T);
  static constexpr int RW = DP + 4;
  static constexpr int kStageK = L * RS * sizeof(T);
  static constexpr int kStageV = 2 * L * RS * sizeof(T);
  static constexpr int kStageW = kStageV + L * E * sizeof(T);
  static constexpr int kStageBytes = kStageW + L * RW * 4;
  static constexpr int kFactor = L * DPP;        // floats of one factor array
  static constexpr int kSmemBytes =
      2 * kStageBytes + (6 * kFactor + L * LP + 3 * DP) * 4;
  static_assert(kStageV % 16 == 0 && kStageW % 16 == 0 && kStageBytes % 16 == 0,
                "stage arrays on 16 bytes");
  static_assert(L % 16 == 0 && (L * L) % kThreads == 0, "tile of 16 or 32");
  static_assert(D % E == 0 && E % 16 == 0, "column slice of 16 or 32");
};

// r, k, w of steps [t0, t0 + len) and v of a block's column slice into one
// stage of the ring, in 16-byte pieces where every row starts on 16 bytes
// (p.vec16), else in 4-byte pieces; steps past len are zero-filled (and read
// as w = 1 by the prefix pass).
template <int BYTES, class K, int D, int E, int L, int NT, typename T>
__device__ __forceinline__ void copy_tile(unsigned char* st, const Params& p,
                                          const T* rp, const T* kp,
                                          const float* wp, const T* vp,
                                          int t0, int len, int tid) {
  constexpr int RS = K::RS, RW = K::RW;
  constexpr int kRK = D * sizeof(T) / BYTES;   // pieces of an r or k row
  constexpr int kEl = BYTES / sizeof(T);       // elements per piece
  auto copy = [](void* dst, const void* src, bool ok) {
    if constexpr (BYTES == 16) cp_async16(dst, src, ok);
    else cp_async4(dst, src, ok);
  };
  for (int x = tid; x < L * kRK; x += NT) {
    const int i = x / kRK, c = (x % kRK) * kEl;
    const bool ok = i < len;
    const long long t = t0 + (ok ? i : 0);
    copy(st + (i * RS + c) * sizeof(T), rp + t * p.r_ss + c, ok);
    copy(st + K::kStageK + (i * RS + c) * sizeof(T), kp + t * p.k_ss + c, ok);
  }
  constexpr int kW = D * 4 / BYTES, kWEl = BYTES / 4;
  for (int x = tid; x < L * kW; x += NT) {
    const int i = x / kW, c = (x % kW) * kWEl;
    const bool ok = i < len;
    const long long t = t0 + (ok ? i : 0);
    copy(st + K::kStageW + (i * RW + c) * 4, wp + t * p.w_ss + c, ok);
  }
  constexpr int kV = E * sizeof(T) / BYTES;
  for (int x = tid; x < L * kV; x += NT) {
    const int i = x / kV, c = (x % kV) * kEl;
    const bool ok = i < len;
    const long long t = t0 + (ok ? i : 0);
    copy(st + K::kStageV + (i * E + c) * sizeof(T), vp + t * p.v_ss + c, ok);
  }
}

template <class K, int D, int E, int L, int NT, typename T>
__device__ __forceinline__ void prefetch_tile(unsigned char* st, const Params& p,
                                              const T* rp, const T* kp,
                                              const float* wp, const T* vp,
                                              int t0, int len, int tid) {
  if (p.vec16)
    copy_tile<16, K, D, E, L, NT>(st, p, rp, kp, wp, vp, t0, len, tid);
  else
    copy_tile<4, K, D, E, L, NT>(st, p, rp, kp, wp, vp, t0, len, tid);
  cp_async_commit();
}

template <int D, int E, int L, typename T>
__global__ void __launch_bounds__(4 * E) wkv6_tiled_kernel(const Params p) {
  using K = Tiled<D, E, L, T>;
  constexpr int DP = K::DP, DPP = K::DPP, LP = K::LP, NT = K::kThreads;
  constexpr int SJ = L * L / NT;          // scores per thread
  constexpr int JG = L / SJ;
  constexpr int G16 = L / 16;             // groups of 16 steps
  extern __shared__ __align__(16) unsigned char smem[];
  float* rA = reinterpret_cast<float*>(smem + 2 * K::kStageBytes);
  float* rB = rA + K::kFactor;
  float* kq = rB + K::kFactor;
  float* kd = kq + K::kFactor;
  float* kT = kd + K::kFactor;
  float* kB = kT + K::kFactor;
  float* sc = kB + K::kFactor;            // [L][LP]
  float* pw_tot = sc + L * LP;            // [DP]
  float* pwc_tot = pw_tot + DP;
  float* su = pwc_tot + DP;

  const int tid = threadIdx.x;
  // lanes 4g .. 4g + 3 of a warp share a row group, so a float4 read of a
  // factor row is one shared-memory wavefront: the eight groups of a warp
  // read eight distinct 16-byte pieces (all 32 banks once), each quarter-warp
  // two of them
  const int g = (tid >> 2) & 7;           // row group
  const int pair = (tid & 3) | ((tid >> 5) << 2);   // column pair
  const int col0 = blockIdx.x * E;
  const int e0 = col0 + 2 * pair;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const T* rp = static_cast<const T*>(p.r) + b * p.r_sb + n * p.r_sn;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + n * p.k_sn;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + n * p.v_sn + col0;
  const float* wp = p.w + b * p.w_sb + n * p.w_sn;
  float* op = p.out + b * p.o_sb + n * p.o_sn;
  const long long soff = ((long long)b * p.N + n) * D * D;
  const float floor_w = p.floor_w;

  for (int d = tid; d < DP; d += NT)
    su[d] = d < D ? p.u[(long long)n * D + d] : 0.f;

  float A[K::kRows][2], Bs[K::kRows][2], Tt[K::kRows][2];
#pragma unroll
  for (int m = 0; m < K::kRuns; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = 4 * g + 32 * m + q, x = 4 * m + q;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        A[x][c] = row < D ? p.s0[soff + (long long)row * D + e0 + c] : 0.f;
        Bs[x][c] = 0.f;
        Tt[x][c] = 0.f;
      }
    }

  int t0 = 0;
  int len = min(L, p.C);
  prefetch_tile<K, D, E, L, NT>(smem, p, rp, kp, wp, vp, 0, len, tid);
  for (int it = 0; t0 < p.S; ++it) {
    const int stage = it & 1;
    const int t1 = t0 + len;
    const bool chunk_done = t1 % p.C == 0;
    const int next_len = t1 < p.S ? min(L, (t1 / p.C + 1) * p.C - t1) : 0;
    cp_async_wait_all();
    __syncthreads();      // this stage landed; the last tile's readers are done
    if (next_len)
      prefetch_tile<K, D, E, L, NT>(smem + (stage ^ 1) * K::kStageBytes, p,
                                    rp, kp, wp, vp, t1, next_len, tid);

    // (2) prefix and suffix products, one thread per row for each
    const unsigned char* st = smem + stage * K::kStageBytes;
    const T* sr = reinterpret_cast<const T*>(st);
    const T* sk = reinterpret_cast<const T*>(st + K::kStageK);
    const T* sv = reinterpret_cast<const T*>(st + K::kStageV);
    const float* sw = reinterpret_cast<const float*>(st + K::kStageW);
    for (int job = tid; job < 2 * DP; job += NT) {
      // every read of the tile first, then the running products
      const int d = job % DP;
      float r_[L], k_[L], w_[L];
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const bool in = i < len && d < D;
        r_[i] = in ? to_f(sr[i * K::RS + d]) : 0.f;
        k_[i] = in ? to_f(sk[i * K::RS + d]) : 0.f;
        w_[i] = in ? fmaxf(sw[i * K::RW + d], 1e-30f) : 1.f;
      }
      if (job < DP) {
        const float ud = su[d];
        float pw = 1.f, pwc = 1.f, inv_excl = 1.f;
#pragma unroll
        for (int i = 0; i < L; ++i) {
          rA[i * DPP + d] = r_[i] * pw;
          rB[i * DPP + d] = r_[i] * pwc;
          pw *= w_[i];
          pwc *= fmaxf(w_[i], floor_w);
          const float inv = recip(pwc);
          kq[i * DPP + d] = k_[i] * inv;
          kd[i * DPP + d] = ud * k_[i] * inv_excl;
          inv_excl = inv;
        }
        pw_tot[d] = pw;
        pwc_tot[d] = pwc;
      } else {
        float sfx = 1.f, sfxc = 1.f;
#pragma unroll
        for (int i = L - 1; i >= 0; --i) {
          kT[i * DPP + d] = k_[i] * sfx;
          kB[i * DPP + d] = k_[i] * sfxc;
          sfx *= w_[i];
          sfxc *= fmaxf(w_[i], floor_w);
        }
      }
    }
    __syncthreads();

    // (3a) scores: row si, columns sj0 .. sj0 + SJ - 1; the diagonal is the
    // bonus r.(u*k), the strict upper triangle zero
    {
      // row si; columns sj0 + JG jj, so the lanes of a quarter-warp read
      // consecutive rows of kq (distinct banks)
      const int si = tid / JG, sj0 = tid % JG;
      float acc[SJ];
      int koff[SJ];
#pragma unroll
      for (int jj = 0; jj < SJ; ++jj) {
        acc[jj] = 0.f;
        const int j = sj0 + JG * jj;
        koff[jj] = (j == si ? 3 * K::kFactor : 2 * K::kFactor) + j * DPP;
      }
      const float* ri = rB + si * DPP;
      float acc2[SJ];                     // the odd float4s of d
#pragma unroll
      for (int jj = 0; jj < SJ; ++jj) acc2[jj] = 0.f;
#pragma unroll 2
      for (int d = 0; d < DP; d += 8) {
        const float4 a = *reinterpret_cast<const float4*>(ri + d);
        const float4 a2 = *reinterpret_cast<const float4*>(ri + d + 4);
#pragma unroll
        for (int jj = 0; jj < SJ; ++jj) {
          const float4 c = *reinterpret_cast<const float4*>(rA + koff[jj] + d);
          const float4 c2 =
              *reinterpret_cast<const float4*>(rA + koff[jj] + d + 4);
          acc[jj] = fmaf(a.x, c.x, acc[jj]);
          acc2[jj] = fmaf(a2.x, c2.x, acc2[jj]);
          acc[jj] = fmaf(a.y, c.y, acc[jj]);
          acc2[jj] = fmaf(a2.y, c2.y, acc2[jj]);
          acc[jj] = fmaf(a.z, c.z, acc[jj]);
          acc2[jj] = fmaf(a2.z, c2.z, acc2[jj]);
          acc[jj] = fmaf(a.w, c.w, acc[jj]);
          acc2[jj] = fmaf(a2.w, c2.w, acc2[jj]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < SJ; ++jj) acc[jj] += acc2[jj];
#pragma unroll
      for (int jj = 0; jj < SJ; ++jj) {
        const int j = sj0 + JG * jj;
        sc[si * LP + j] = j <= si ? acc[jj] : 0.f;
      }
    }

    // (3b) inter-chunk outputs from the state, reduce-scattered over the 8
    // row groups: lane g ends with steps 2g, 2g + 1 of each group of 16
    float part[G16][4];
#pragma unroll
    for (int grp = 0; grp < G16; ++grp) {
      float acc[32];
#pragma unroll
      for (int ii = 0; ii < 16; ii += 2) {
        // steps ii, ii + 1; the A and B parts in separate sums: 8 chains
        const int i = grp * 16 + ii;
        float pa[2][2] = {}, pb[2][2] = {};
#pragma unroll
        for (int m = 0; m < K::kRuns; ++m) {
          const int d = 4 * g + 32 * m;
          float4 ra[2], rb[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            ra[h] = *reinterpret_cast<const float4*>(rA + (i + h) * DPP + d);
            rb[h] = *reinterpret_cast<const float4*>(rB + (i + h) * DPP + d);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int x = 4 * m + q;
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                pa[h][c] = fmaf(comp(ra[h], q), A[x][c], pa[h][c]);
                pb[h][c] = fmaf(comp(rb[h], q), Bs[x][c], pb[h][c]);
              }
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 2; ++c) acc[2 * (ii + h) + c] = pa[h][c] + pb[h][c];
      }
      fold<16, 16>(acc, tid);
      fold<8, 8>(acc, tid);
      fold<4, 4>(acc, tid);
#pragma unroll
      for (int x = 0; x < 4; ++x) part[grp][x] = acc[x];
    }

    // (3c) the state: decay by the tile's totals, add k^T v of the tile
#pragma unroll
    for (int m = 0; m < K::kRuns; ++m) {
      const float4 pt = *reinterpret_cast<const float4*>(pw_tot + 4 * g + 32 * m);
      const float4 pc = *reinterpret_cast<const float4*>(pwc_tot + 4 * g + 32 * m);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int x = 4 * m + q;
          A[x][c] *= comp(pt, q);
          Tt[x][c] *= comp(pt, q);
          Bs[x][c] *= comp(pc, q);
        }
    }
#pragma unroll 4
    for (int j = 0; j < L; ++j) {
      const float2 vj = to_f2(sv + j * E + 2 * pair);
      const float v0 = vj.x, v1 = vj.y;
#pragma unroll
      for (int m = 0; m < K::kRuns; ++m) {
        const int d = 4 * g + 32 * m;
        const float4 ft = *reinterpret_cast<const float4*>(kT + j * DPP + d);
        const float4 fb = *reinterpret_cast<const float4*>(kB + j * DPP + d);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int x = 4 * m + q;
          Tt[x][0] = fmaf(comp(ft, q), v0, Tt[x][0]);
          Tt[x][1] = fmaf(comp(ft, q), v1, Tt[x][1]);
          Bs[x][0] = fmaf(comp(fb, q), v0, Bs[x][0]);
          Bs[x][1] = fmaf(comp(fb, q), v1, Bs[x][1]);
        }
      }
    }
    if (chunk_done) {
#pragma unroll
      for (int x = 0; x < K::kRows; ++x)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          A[x][c] += Tt[x][c];
          Tt[x][c] = 0.f;
          Bs[x][c] = 0.f;
        }
    }
    __syncthreads();      // the scores are complete

    // (4) out = inter + scores . V (the diagonal carries the bonus)
#pragma unroll
    for (int grp = 0; grp < G16; ++grp) {
      const int ia = grp * 16 + 2 * g, ib = ia + 1;
      float oa0 = part[grp][0], oa1 = part[grp][1];
      float ob0 = part[grp][2], ob1 = part[grp][3];
#pragma unroll 2
      for (int j4 = 0; j4 < L; j4 += 4) {
        const float4 sa = *reinterpret_cast<const float4*>(sc + ia * LP + j4);
        const float4 sb = *reinterpret_cast<const float4*>(sc + ib * LP + j4);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float2 vj = to_f2(sv + (j4 + jj) * E + 2 * pair);
          const float v0 = vj.x, v1 = vj.y;
          oa0 = fmaf(comp(sa, jj), v0, oa0);
          oa1 = fmaf(comp(sa, jj), v1, oa1);
          ob0 = fmaf(comp(sb, jj), v0, ob0);
          ob1 = fmaf(comp(sb, jj), v1, ob1);
        }
      }
      if (ia < len) {
        float* o = op + (long long)(t0 + ia) * p.o_ss + e0;
        o[0] = oa0;
        o[1] = oa1;
      }
      if (ib < len) {
        float* o = op + (long long)(t0 + ib) * p.o_ss + e0;
        o[0] = ob0;
        o[1] = ob1;
      }
    }
    t0 = t1;
    len = next_len;
  }

#pragma unroll
  for (int m = 0; m < K::kRuns; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = 4 * g + 32 * m + q;
      if (row < D) {
#pragma unroll
        for (int c = 0; c < 2; ++c)
          p.sout[soff + (long long)row * D + e0 + c] = A[4 * m + q][c];
      }
    }
}

// The tiled kernel when every chunk fits in one tile (C <= 32): a tile is a
// whole chunk, so B and T start every tile at zero and are never carried.
// One accumulator is left: A <- diag(Pw_tot) A + (k*Sfx_w)^T V at each tile's
// end, and out = (r*Pw_excl) A + mask((r*Pwc_excl)(k/Pwc_incl)^T) V + bonus.
// One block per (b, n), in two warp roles.  D/16 state warps hold A^T in
// mma.sync C fragments (16 value channels each) and run tile t's products on
// the tensor cores in 3xTF32 (hi*hi + hi*lo + lo*hi, fp32 accumulation):
// out^T = A^T (r*Pw_excl)^T + V^T scores^T, then A^T <- A^T diag(Pw_tot) +
// V^T (k*Sfx_w).  A^T's C fragments are the A operand of the first product
// as they are (its d order permuted within each 8, and the B operand read in
// the same order).  4D input threads meanwhile load tile t + 2 and compute
// tile t + 1's factors (product scans over the lanes, lane = step) and
// scores (fp32 FMAs): a three-stage input ring, two factor buffers.  One
// block barrier per tile, and one among the input threads.
template <int D, int E, typename T>
struct Chunked {
  using Stage = Tiled<D, E, 32, T>;       // the same stage layout
  static constexpr int L = 32;
  static constexpr int DP = Stage::DP, DPP = Stage::DPP, LP = L + 4;
  static constexpr int SA = D + 8;        // rows read as mma operands
  static constexpr int kState = 2 * D;    // state threads: 16 channels a warp
  static constexpr int kInput = 4 * DP;   // input threads: one walk each
  static constexpr int kThreads = kState + kInput;
  // one factor buffer (floats): rA, rB, kq, kd, kT, the scores, Pw_tot and
  // v in fp32
  static constexpr int oRB = L * SA;
  static constexpr int oKQ = oRB + L * DPP;
  static constexpr int oKD = oKQ + L * DPP;
  static constexpr int oKT = oKD + L * DPP;
  static constexpr int oSC = oKT + L * SA;
  static constexpr int oPW = oSC + L * LP;
  static constexpr int oVF = oPW + DP;
  static constexpr int kBufFloats = oVF + L * SA;
  static constexpr int kSmemBytes =
      3 * Stage::kStageBytes + (2 * kBufFloats + DP) * 4;
  static_assert(DP == D && D % 32 == 0 && E == D, "head dim 32 or 64");
};

// fp32 x = hi + lo, both TF32 (round to nearest): 3xTF32 keeps fp32 accuracy
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

template <int D, int E, typename T>
__global__ void __launch_bounds__(6 * D, 1) wkv6_chunk_kernel(const Params p) {
  using K = Chunked<D, E, T>;
  using S = typename K::Stage;
  constexpr int L = K::L, DP = K::DP, DPP = K::DPP, LP = K::LP, SA = K::SA;
  constexpr int NS = K::kState, NI = K::kInput;
  constexpr int IPW = L / (NI / 32);      // score rows per input warp
  extern __shared__ __align__(16) unsigned char smem[];
  float* const buf0 = reinterpret_cast<float*>(smem + 3 * S::kStageBytes);
  float* const su = buf0 + 2 * K::kBufFloats;

  const int tid = threadIdx.x;
  const bool input = tid >= NS;
  const int lane = tid & 31;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const T* rp = static_cast<const T*>(p.r) + b * p.r_sb + n * p.r_sn;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + n * p.k_sn;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + n * p.v_sn;
  const float* wp = p.w + b * p.w_sb + n * p.w_sn;
  const float floor_w = p.floor_w;
  const int C = p.C;
  const int tiles = p.S / C;

  auto stage_of = [&](int t) { return smem + (t % 3) * S::kStageBytes; };
  auto buf_of = [&](int t) { return buf0 + (t & 1) * K::kBufFloats; };
  auto input_sync = [] {
    asm volatile("bar.sync 1, %0;\n" :: "n"(K::kInput) : "memory");
  };

  if (input) {
    // ---- input threads: loads, the tile's factors, the scores ----
    const int it = tid - NS;
    for (int dd = it; dd < DP; dd += NI) su[dd] = p.u[(long long)n * D + dd];
    const int iwarp = it >> 5;
    auto load = [&](int t) {
      prefetch_tile<S, D, E, L, NI>(stage_of(t), p, rp, kp, wp, vp, t * C, C,
                                    it);
    };
    // the tile's factors, four rows d at a time per warp, lane = step:
    // product scans over the lanes give the true prefix (r*Pw_excl, Pw_tot),
    // the floored prefix (r*Pwc_excl, k/Pwc_incl, u*k/Pwc_excl) and the true
    // suffix (k*Sfx_w).  Steps past C read as r = k = 0, w = 1
    auto prefix = [&](int t) {
      const unsigned char* st = stage_of(t);
      const T* sr = reinterpret_cast<const T*>(st);
      const T* sk = reinterpret_cast<const T*>(st + S::kStageK);
      const float* sw = reinterpret_cast<const float*>(st + S::kStageW);
      float* f = buf_of(t);
      const int i = lane;
      const bool in = i < C;
      for (int q = iwarp; q < DP / 4; q += NI / 32) {
        const int d0 = 4 * q;
        const float4 wv = to_f4(sw + i * S::RW + d0);
        const float4 rv = to_f4(sr + i * S::RS + d0);
        const float4 kv = to_f4(sk + i * S::RS + d0);
        float w4[4], r4[4], k4[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          w4[c] = in ? fmaxf(comp(wv, c), 1e-30f) : 1.f;
          r4[c] = in ? comp(rv, c) : 0.f;
          k4[c] = in ? comp(kv, c) : 0.f;
        }
        float o_ra[4], o_rb[4], o_kq[4], o_kd[4], o_kt[4], tot[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float wc = fmaxf(w4[c], floor_w);
          float pw = w4[c], pc = wc, sx = w4[c];   // inclusive scans
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const float a = __shfl_up_sync(0xffffffffu, pw, o);
            const float b2 = __shfl_up_sync(0xffffffffu, pc, o);
            const float z = __shfl_down_sync(0xffffffffu, sx, o);
            if (lane >= o) {
              pw *= a;
              pc *= b2;
            }
            if (lane + o < 32) sx *= z;
          }
          float pw_ex = __shfl_up_sync(0xffffffffu, pw, 1);
          float pc_ex = __shfl_up_sync(0xffffffffu, pc, 1);
          float sx_ex = __shfl_down_sync(0xffffffffu, sx, 1);
          if (lane == 0) pw_ex = pc_ex = 1.f;
          if (lane == 31) sx_ex = 1.f;
          tot[c] = __shfl_sync(0xffffffffu, pw, 31);
          o_ra[c] = r4[c] * pw_ex;
          o_rb[c] = r4[c] * pc_ex;
          o_kq[c] = k4[c] * recip(pc);
          o_kd[c] = su[d0 + c] * k4[c] * recip(pc_ex);
          o_kt[c] = k4[c] * sx_ex;
        }
        auto put = [&](int off, int stride, const float (&x)[4]) {
          *reinterpret_cast<float4*>(f + off + i * stride + d0) =
              make_float4(x[0], x[1], x[2], x[3]);
        };
        put(0, SA, o_ra);
        put(K::oRB, DPP, o_rb);
        put(K::oKQ, DPP, o_kq);
        put(K::oKD, DPP, o_kd);
        put(K::oKT, SA, o_kt);
        if (lane == 0) put(K::oPW, 0, tot);
      }
      // v of the tile in fp32, in rows read as mma operands
      const T* sv = reinterpret_cast<const T*>(st + S::kStageV);
      for (int x = it; x < L * E; x += NI)
        f[K::oVF + (x / E) * SA + x % E] = to_f(sv[x]);
    };
    // scores: lane j, rows IPW iwarp .. + IPW - 1 (rB rows are the same for
    // the whole warp: broadcast reads); the diagonal (the bonus r.(u*k)) by
    // a warp reduction per row; zero above the diagonal
    auto scores = [&](int t) {
      const float* f = buf_of(t);
      const float* rB = f + K::oRB;
      const float* kq = f + K::oKQ;
      const float* kd = f + K::oKD;
      float* sc = buf_of(t) + K::oSC;
      float acc[IPW], acc2[IPW];          // the two halves of d
#pragma unroll
      for (int ii = 0; ii < IPW; ++ii) acc[ii] = acc2[ii] = 0.f;
      const float* kj = kq + lane * DPP;
      const float* ri = rB + IPW * iwarp * DPP;
#pragma unroll 2
      for (int dd = 0; dd < DP / 2; dd += 4) {
        const float4 c = *reinterpret_cast<const float4*>(kj + dd);
        const float4 c2 = *reinterpret_cast<const float4*>(kj + dd + DP / 2);
#pragma unroll
        for (int ii = 0; ii < IPW; ++ii) {
          const float4 a = *reinterpret_cast<const float4*>(ri + ii * DPP + dd);
          const float4 a2 =
              *reinterpret_cast<const float4*>(ri + ii * DPP + dd + DP / 2);
          acc[ii] = fmaf(a.x, c.x, acc[ii]);
          acc2[ii] = fmaf(a2.x, c2.x, acc2[ii]);
          acc[ii] = fmaf(a.y, c.y, acc[ii]);
          acc2[ii] = fmaf(a2.y, c2.y, acc2[ii]);
          acc[ii] = fmaf(a.z, c.z, acc[ii]);
          acc2[ii] = fmaf(a2.z, c2.z, acc2[ii]);
          acc[ii] = fmaf(a.w, c.w, acc[ii]);
          acc2[ii] = fmaf(a2.w, c2.w, acc2[ii]);
        }
      }
#pragma unroll
      for (int ii = 0; ii < IPW; ++ii) {
        const int i = IPW * iwarp + ii;
        float dg = 0.f;
#pragma unroll
        for (int dd = lane; dd < DP; dd += 32)
          dg = fmaf(rB[i * DPP + dd], kd[i * DPP + dd], dg);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          dg += __shfl_xor_sync(0xffffffffu, dg, off);
        sc[i * LP + lane] =
            lane < i ? acc[ii] + acc2[ii] : lane == i ? dg : 0.f;
      }
    };

    load(0);
    if (tiles > 1) load(1);
    if (tiles > 1)
      cp_async_wait_one();
    else
      cp_async_wait_all();
    input_sync();
    prefix(0);
    input_sync();
    scores(0);
    for (int t = 0; t < tiles; ++t) {
      cp_async_wait_all();                // tile t + 1 landed
      __syncthreads();                    // (A) tile t's factors and scores
      if (t + 2 < tiles) load(t + 2);     // into tile t - 1's stage
      if (t + 1 < tiles) {
        prefix(t + 1);
        input_sync();
        scores(t + 1);
      }
    }
    return;
  }

  // ---- state threads: the products of tile t on the tensor cores ----
  constexpr int ND = D / 8;               // 8-wide tiles of d
  const int warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int er = 16 * warp + gid;         // value channels er and er + 8
  float* op = p.out + b * p.o_sb + n * p.o_sn;
  const long long soff = ((long long)b * p.N + n) * D * D;
  // A^T [e][d] as C fragments: At[nd] = (er, 8nd + 2tig + {0, 1}) and
  // (er + 8, the same)
  float At[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const long long d0 = 8 * nd + 2 * tig;
    At[nd][0] = p.s0[soff + d0 * D + er];
    At[nd][1] = p.s0[soff + (d0 + 1) * D + er];
    At[nd][2] = p.s0[soff + d0 * D + er + 8];
    At[nd][3] = p.s0[soff + (d0 + 1) * D + er + 8];
  }

  for (int t = 0; t < tiles; ++t) {
    __syncthreads();                      // (A)
    const float* f = buf_of(t);
    const float* rA = f;
    const float* kT = f + K::oKT;
    const float* sc = f + K::oSC;
    const float* pw = f + K::oPW;
    const float* vf = f + K::oVF;

    // out^T [e][i] for i in 8ni .. 8ni + 7: (er, 8ni + 2tig + {0, 1}) and
    // (er + 8, the same)
    float o[4][4] = {};
    // inter-chunk: out^T += A^T (r*Pw_excl)^T; k slot tig is d = 8kb + 2tig,
    // slot tig + 4 is d = 8kb + 2tig + 1
#pragma unroll
    for (int kb = 0; kb < ND; ++kb) {
      uint32_t ah[4], al[4];
      split_tf32(At[kb][0], ah[0], al[0]);
      split_tf32(At[kb][2], ah[1], al[1]);
      split_tf32(At[kb][1], ah[2], al[2]);
      split_tf32(At[kb][3], ah[3], al[3]);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float2 x = *reinterpret_cast<const float2*>(
            rA + (8 * ni + gid) * SA + 8 * kb + 2 * tig);
        mma3(o[ni], ah, al, x.x, x.y);
      }
    }
    // V^T as A operands, k = j
    uint32_t vh[4][4], vl[4][4];
#pragma unroll
    for (int kj = 0; kj < 4; ++kj) {
      const float* v0 = vf + (8 * kj + tig) * SA + er;
      const float* v4 = v0 + 4 * SA;
      split_tf32(v0[0], vh[kj][0], vl[kj][0]);
      split_tf32(v0[8], vh[kj][1], vl[kj][1]);
      split_tf32(v4[0], vh[kj][2], vl[kj][2]);
      split_tf32(v4[8], vh[kj][3], vl[kj][3]);
    }
    // intra-chunk: out^T += V^T scores^T (scores are zero past the diagonal)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int kj = 0; kj <= ni; ++kj) {
        const float* srow = sc + (8 * ni + gid) * LP + 8 * kj + tig;
        mma3(o[ni], vh[kj], vl[kj], srow[0], srow[4]);
      }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int i = 8 * ni + 2 * tig;
      float* row = op + (long long)(t * C + i) * p.o_ss;
      if (i < C) {
        row[er] = o[ni][0];
        row[er + 8] = o[ni][2];
      }
      if (i + 1 < C) {
        row[p.o_ss + er] = o[ni][1];
        row[p.o_ss + er + 8] = o[ni][3];
      }
    }

    // the state at the chunk's end: A^T <- A^T diag(Pw_tot) + V^T (k*Sfx_w)
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const float2 x = *reinterpret_cast<const float2*>(pw + 8 * nd + 2 * tig);
      At[nd][0] *= x.x;
      At[nd][1] *= x.y;
      At[nd][2] *= x.x;
      At[nd][3] *= x.y;
#pragma unroll
      for (int kj = 0; kj < 4; ++kj) {
        const float* krow = kT + (8 * kj + tig) * SA + 8 * nd + gid;
        mma3(At[nd], vh[kj], vl[kj], krow[0], krow[4 * SA]);
      }
    }
  }

#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const long long d0 = 8 * nd + 2 * tig;
    p.sout[soff + d0 * D + er] = At[nd][0];
    p.sout[soff + (d0 + 1) * D + er] = At[nd][1];
    p.sout[soff + d0 * D + er + 8] = At[nd][2];
    p.sout[soff + (d0 + 1) * D + er + 8] = At[nd][3];
  }
}

template <int D, int E, typename T>
cudaError_t launch_chunk(const Params& p, cudaStream_t stream) {
  using K = Chunked<D, E, T>;
  auto kernel = wkv6_chunk_kernel<D, E, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K::kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(D / E, p.N, p.B), K::kThreads, K::kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

template <int D, int E, int L, typename T>
cudaError_t launch_tiled(const Params& p, cudaStream_t stream) {
  using K = Tiled<D, E, L, T>;
  auto kernel = wkv6_tiled_kernel<D, E, L, T>;
  // per device, so set on every launch (a host-side attribute write)
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K::kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(D / E, p.N, p.B), K::kThreads, K::kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

// The tile instances.  steps = 0: one tile per chunk (chunks of at most 32
// steps, head dims 32 and 64, all D columns), the one-accumulator kernel.
// Otherwise 16 steps x 32 columns at head dim 64 (the fastest of 16 x 16,
// 16 x 32, 32 x 16 and 32 x 32 on the card) and 16 x 16 at the others: at
// head dim 128 that is 8 column blocks per (b, n), each 64 threads holding a
// 128 x 16 slab of the three accumulators (96 floats a thread).
template <typename T>
cudaError_t dispatch_tiled(const Params& p, int steps, int cols,
                           cudaStream_t st) {
  if (steps == 0) {                       // a tile is a whole chunk
    if (p.C > 32) return cudaErrorInvalidValue;
    if (p.D == 64 && cols == 64) return launch_chunk<64, 64, T>(p, st);
    if (p.D == 32 && cols == 32) return launch_chunk<32, 32, T>(p, st);
    return cudaErrorInvalidValue;
  }
  const int key = p.D * 10000 + cols * 100 + steps;
  switch (key) {
    case 161616: return launch_tiled<16, 16, 16, T>(p, st);
    case 321616: return launch_tiled<32, 16, 16, T>(p, st);
    case 481616: return launch_tiled<48, 16, 16, T>(p, st);
    case 643216: return launch_tiled<64, 32, 16, T>(p, st);
    case 1281616: return launch_tiled<128, 16, 16, T>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_decode(const Params& p, cudaStream_t st) {
  switch (p.D) {
    case 16: return launch_decode<16, T>(p, st);
    case 32: return launch_decode<32, T>(p, st);
    case 48: return launch_decode<48, T>(p, st);
    case 64: return launch_decode<64, T>(p, st);
    case 128: return launch_decode<128, T>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// meta, 20 integers: B S N D C | r strides b s n | k strides b s n |
// v strides b s n | w strides b s n | out strides b s n.  r, k, v share a
// dtype (0 fp32, 1 bf16); w, out fp32; u [N, D], state_in / state_out
// [B, N, D, D] contiguous fp32.  variant 0 = decode (S = 1 only), 1 = tiled
// with `steps` steps and `cols` state columns per block.  Returns the
// cudaError_t of the launch (0 on success), or cudaErrorInvalidValue for
// arguments it does not take.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const float* w, const float* u,
                           const float* state_in, float* out, float* state_out,
                           const long long* meta, float floor_w, int dtype,
                           int variant, int steps, int cols, void* stream) {
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
  const int es = dtype ? 2 : 4;
  auto on16 = [](const void* ptr, const long long* st, int esize) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 &&
           (st[0] * esize) % 16 == 0 && (st[1] * esize) % 16 == 0 &&
           (st[2] * esize) % 16 == 0;
  };
  p.vec16 = on16(r, meta + 5, es) && on16(k, meta + 8, es) &&
            on16(v, meta + 11, es) && on16(w, meta + 14, 4);
  if (p.B <= 0 || p.S <= 0 || p.N <= 0 || p.C <= 0 || p.S % p.C != 0 ||
      p.B > 65535 || p.N > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 0) {
    if (p.S != 1) return (int)cudaErrorInvalidValue;
    return (int)(dtype ? dispatch_decode<__nv_bfloat16>(p, st)
                       : dispatch_decode<float>(p, st));
  }
  if (variant == 1)
    return (int)(dtype ? dispatch_tiled<__nv_bfloat16>(p, steps, cols, st)
                       : dispatch_tiled<float>(p, steps, cols, st));
  return (int)cudaErrorInvalidValue;
}
