// Flash attention (forward) for NVIDIA Hopper, CUDA C++ with a plain C entry.
//
// Replaces the Pallas TPU kernel `_attn_kernel` / `flash_attention_bhsd` of
// src/repro/kernels/flash_attention.py (model-layout wrapper
// `flash_attention` in src/repro/kernels/ops.py).
//
// What it computes.  For every batch b, kv head n, query head g of that kv
// head and query row s
//
//     score[k] = scale * <q[b,s,n,g,:], k[b,k,n,:]>            scale = 1/sqrt(D)
//     score[k] = softcap * tanh(score[k] / softcap)            if softcap > 0
//     visible  = k < Sk
//                and (not causal or k <= q_offset + s)
//                and (window <= 0 or k >  q_offset + s - window)
//     out[b,s,n,g,:] = sum_k softmax(score over visible k)[k] * v[b,k,n,:]
//
// as an online softmax: running maximum m, running sum l and an fp32
// accumulator per query row, rescaled as each block of keys arrives, and
// out = acc / l at the end.  A masked score adds exactly 0 to l and acc and a
// visible one at least 1 for the row's maximum, so l = 0 at the end marks a
// row with no visible key.  Such a row returns the mean of v over all Sk keys,
// as the oracle `ref_attention` does (every score -1e30, softmax uniform), on
// a slow path that reads V once more.  It does not occur in prefill or decode.
//
// All three kernels take the model layout by strides: q [B,S,N,G,D], k
// [B,Sk,N,D], v [B,Sk,N,Dv], out [B,S,N,G,Dv], any strides as long as the
// head dims are contiguous.  D (of q and k) is at most 192 and Dv (of v and
// out) at most min(D, 128): Dv = D <= 128 are the GQA instances; Dv < D the
// MLA one (deepseek-v2: D = nope 128 + rope 64 = 192, Dv = 128), where each
// kernel takes tiles of Q and K D wide and of V Dv wide (or V as wide as K,
// zero past Dv, up to D = 128) and writes Dv columns.  Its bounds are those
// below with D + Dv in place of 2 D: 2*B*H*(D + Dv)*(visible pairs) FLOPs
// for the prefill, the bytes of the visible K (D) and V (Dv) rows for the
// decode step.  The kv head of
// query head h is h / G, so k and v are never repeated G times and a decode
// step reads the cache in place.  q_offset, window, softcap and all lengths
// are runtime arguments; ragged Sq, Sk and D are masked or zero-filled where
// tiles are loaded, with no padded copies.  The TPU kernel's grid walks the kv
// axis in order and carries m/l/acc in scratch between grid steps; CUDA blocks
// run in no order, so each block loops over its keys itself.  The wrapper
// (kernels/flash_attention.py:_variant) picks one of them per call by an
// explicit rule and this entry launches exactly that one or fails:
//
//  * tc (`flash_attention_wg_kernel`): bf16, Sq > 1, D a multiple of 8, every
//    stride and base 16-byte aligned.  The prefill of the served models.
//    Bound: the two products, 4*B*H*D*(visible pairs) FLOPs at the bf16
//    tensor-core rate.  At D = 192, Dv = 128 a stage of K (48 KB) and V (32
//    KB) beside Q (48 KB) fits twice in the 227 KB a block may use, not three
//    times, so that instance runs a two-stage ring; S = QK^T takes 12 k-steps
//    of 16 over three 64-column boxes, O and the registers are as at 128.  Design: one block per (batch, query head, 128-row
//    q-tile), q-tiles launched last-first so the longest causal rows start
//    first; two warpgroups of 64 query rows each.  Thread 0 loads the Q
//    tile once and streams 128-key K and V tiles into a three-stage ring in
//    shared memory with TMA (tensor maps built per call from the strides,
//    64-column boxes with the 128-byte swizzle, zero fill past Sq, Sk and
//    D), each stage guarded by a full and an empty mbarrier; no warp is
//    given to loads alone, so each thread may hold S, O and P at once (up to
//    255 registers; a ninth warp caps them at 168 and ptxas spills).
//    S = Q K^T is wgmma m64n128k16 from shared memory (bf16 in, fp32
//    accumulate; a bf16 x bf16 product is exact in fp32); the online softmax
//    runs on the accumulator registers with exp2f and scale * log2(e) as one
//    multiply; the causal / window / Sk predicates run only on tiles that
//    cross an edge.  O += P V is wgmma with P as the register A operand and V
//    read MN-major through the descriptor's transpose bit; P goes in as two
//    bf16 parts, hi = bf16(p) and lo = bf16(p - hi), because P in one bf16
//    moves a row that averages few keys by several bf16 ulps of v (over the
//    output limit).  O / l is rounded once to bf16.  Thread 0 refills a
//    stage once both warpgroups have released it, which keeps them in step;
//    letting them drift apart, or issuing P_{t-1} V_{t-1} behind S_t inside
//    a warpgroup, was measured slower.
//  * fma (`flash_attention_kernel`): fp32, and any input the tc kernel does
//    not take (D not a multiple of 8, strides not 16-byte aligned).  IEEE
//    fp32 products and sums on the FMA units out of shared memory (not TF32):
//    a 64 x BN score tile per block, each thread a 4 x TN micro-tile.  Bound
//    by the fp32 FMA rate and shared-memory bandwidth.
//  * decode (Sq = 1, D a multiple of one 16-byte load, 16-byte aligned).
//    Bound: the bytes of the visible K and V rows.  One block per (batch, kv
//    head, chunk of its query heads, split of the kv range): every K and V
//    row is read once for all the heads of the chunk, not once per head.  The
//    host splits the visible range [lo, hi) over `splits` blocks
//    (kernels/flash_attention.py:decode_splits) so that a long cache fills
//    the card in one wave; with more than one split each block writes its
//    partial (m, l, acc) to a scratch buffer and the last block of each
//    (batch, kv head, chunk) to arrive (an atomic ticket, which it resets)
//    combines them.  A short range is one split and one block writes the
//    output directly.  bf16 (`flash_decode_tc_kernel`): the chunk's <= 16
//    heads are the rows of mma.sync m16n8k16 tiles; K and V tiles of 64 keys
//    stream through a two-stage cp.async ring and each of 4 warps takes 16
//    keys of a tile, so a key costs a few tensor-core instructions.  At D =
//    192, Dv = 128 (MLA, G = 1: one of the 16 rows of each tile holds a
//    head) the 88 KB of shared memory leave two resident blocks per SM, not
//    three; the wrapper sizes its split target by instance.  fp32
//    (`flash_decode_kernel`): IEEE fp32 dot products; a warp owns one key at
//    a time, each lane a 16-byte piece of the row (two of a K row past D =
//    128), several keys in flight.
//  * mla (`flash_mla_decode_kernel`): MLA's absorbed decode, which no TPU
//    kernel has (the JAX package recomputes k and v of every head from the
//    latent cache each step).  bf16, Sq = 1, one kv head of D = 576 whose v
//    is the first Dv = 512 columns of the same rows (DeepSeek-V2's latent
//    row [c_kv 512 | k_rope 64]), any G (blocks of 64 heads; the last
//    block's rows past G are zeros and write nothing).  Bound: the bytes of
//    the visible latent rows, 1152 a key, read once per block of 64 heads
//    (the tensor cores do 128 x 1088 x 2 operations a key for 128 heads, a
//    little under the bytes' time).  One block of 16 warps per (batch,
//    chunk of 64 heads, split of the kv range); Q (64 x 576) sits in shared
//    memory, the latent rows stream in tiles of 32 keys through a
//    three-stage cp.async ring and each tile is both K (576 columns) and V
//    (the first 512).  Per tile, S = Q K^T with warp w on heads 16 (w / 4)..
//    and keys 8 (w % 4).. (mma.sync over 36 k-steps), the scores to shared
//    memory; then warp w on heads 16 (w / 4).. and output columns
//    128 (w % 4)..: the online softmax of its 16 heads over the tile (the
//    four warps of a head group compute it alike, so no warp waits for
//    another's), O += P V with P as bf16 hi + lo parts.  The splits meet as
//    the decode kernels' do (finish_decode).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kTX = 16;            // threads along keys / head-dim columns
constexpr int kTY = 16;            // threads along query rows
constexpr int kTM = 4;             // query rows per thread: 64-row q-tiles
constexpr float kMasked = -1e30f;  // "minus infinity" of the fma kernel
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* part;        // decode, splits > 1: partial (m, l, acc) of every split
  unsigned* ticket;   // decode, splits > 1: arrivals per (b, kv head, chunk)
  int B, N, G, Sq, Sk, D;             // D: head dim of q and k
  int Dv;                             // head dim of v and out (<= D)
  long long q_sb, q_ss, q_sn, q_sg;   // element strides; D has stride 1
  long long k_sb, k_ss, k_sn;
  long long v_sb, v_ss, v_sn;
  long long o_sb, o_ss, o_sn, o_sg;
  int causal, window, q_offset;
  int splits, split_len, g_chunks;    // decode
  int q_ord[4], k_ord[3], v_ord[3];   // tc: coordinate slot of each dim in its map
  float scale, softcap;
  float scale_log2;                   // scale * log2(e): base-2 scores
  float cap_in, cap_out;              // softcap: cap_out * tanh(qk * cap_in)
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Four bf16 values as fp32: a bf16 is the upper half of an fp32.
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  float4 r;
  r.x = __uint_as_float(u.x << 16);
  r.y = __uint_as_float(u.x & 0xffff0000u);
  r.z = __uint_as_float(u.y << 16);
  r.w = __uint_as_float(u.y & 0xffff0000u);
  return r;
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Column `col` of v averaged over all Sk keys, in fp32: the output of a row
// that sees no key (0 when Sk = 0, as a softmax over no keys sums nothing).
template <typename T>
__device__ float mean_v(const T* vp, long long v_ss, int Sk, int col) {
  float sum = 0.f;
  for (int kk = 0; kk < Sk; ++kk) {
    float4 x = load4(vp + (long long)kk * v_ss + (col & ~3));
    const int j = col & 3;
    sum += j == 0 ? x.x : j == 1 ? x.y : j == 2 ? x.z : x.w;
  }
  return Sk > 0 ? sum / (float)Sk : 0.f;
}

// ---------------------------------------------------------------------------
// fma: the fp32 tile kernel (and any input the tc kernel does not take).
// ---------------------------------------------------------------------------

// Rows [row0, row0 + ROWS) of a [*, D] matrix with row stride `stride` into
// shared memory [ROWS][LD] as fp32; rows >= row_end and columns >= D are 0.
template <typename T, int ROWS, int DP, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int row0,
                                          int row_end, int D, int tid) {
  constexpr int kVecPerRow = DP / 4;
  for (int i = tid; i < ROWS * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < row_end && c < D)
      val = load4(src + (long long)(row0 + r) * stride + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = val;
  }
}

// T: element type of q/k/v/out.  DP: head dim of q and k rounded up to
// 16/32/64/128/192; V tiles are as wide, zero past Dv, and only the Dv
// columns of the output are written.
// The block's q-tile has BM = 16*TM = 64 rows, a kv tile BN = 16*TN keys.
// Thread (ty, tx) owns query rows ty*TM + i, score columns tx + 16*j and
// output columns tx + 16*c.  The 16 threads that share a ty are one half of
// a warp, so row reductions are shuffles inside that half.
template <typename T, int DP, int TN>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const Params p) {
  constexpr int TM = kTM;
  constexpr int BM = kTY * TM;
  constexpr int BN = kTX * TN;
  constexpr int KS = DP + 4;   // K row stride: float4 reads of 8 rows hit 32 banks
  constexpr int PS = BN + 4;
  constexpr int DC = DP / kTX;

  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;              // [BM][DP]
  float* sK = sQ + BM * DP;      // [BN][KS]
  float* sV = sK + BN * KS;      // [BN][DP]
  float* sP = sV + BN * DP;      // [BM][PS]

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const unsigned half_mask = 0xffffu << (tid & 16);

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n = h / p.G;
  const int g = h % p.G;
  const int q0 = qt * BM;
  const int rows = min(BM, p.Sq - q0);

  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + n * p.q_sn + g * p.q_sg;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + n * p.k_sn;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + n * p.v_sn;
  T* op = static_cast<T*>(p.o) + b * p.o_sb + n * p.o_sn + g * p.o_sg;

  load_tile<T, BM, DP, DP>(sQ, qp, p.q_ss, q0, p.Sq, p.D, tid);

  // keys any row of this q-tile can see: [kv_lo, kv_hi)
  const int qpos_lo = p.q_offset + q0;
  const int qpos_hi = p.q_offset + q0 + rows - 1;
  int kv_hi = p.Sk;
  if (p.causal) kv_hi = min(kv_hi, qpos_hi + 1);
  int kv_lo = 0;
  if (p.window > 0) kv_lo = max(0, qpos_lo - p.window + 1);
  kv_lo = (kv_lo / BN) * BN;

  const bool active = ty * TM < rows;   // uniform over a half-warp

  float m[TM], l[TM], acc[TM][DC];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int kv0 = kv_lo; kv0 < kv_hi; kv0 += BN) {
    __syncthreads();   // the previous tile's readers are done (first pass: sQ is written)
    load_tile<T, BN, DP, KS>(sK, kp, p.k_ss, kv0, p.Sk, p.D, tid);
    load_tile<T, BN, DP, DP>(sV, vp, p.v_ss, kv0, p.Sk, p.Dv, tid);
    __syncthreads();
    if (!active) continue;

    // scores of this thread's TM x TN micro-tile
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;

#pragma unroll 4
    for (int d = 0; d < p.D; d += 4) {
      float4 qv[TM], kv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sQ + (ty * TM + i) * DP + d);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        kv[j] = *reinterpret_cast<const float4*>(sK + (tx + kTX * j) * KS + d);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // scale, softcap, mask; online-softmax update of m, l and acc
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qpos = p.q_offset + q0 + ty * TM + i;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int kpos = kv0 + tx + kTX * j;
        bool vis = kpos < p.Sk;
        if (p.causal) vis = vis && (kpos <= qpos);
        if (p.window > 0) vis = vis && (kpos > qpos - p.window);
        float x = s[i][j] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        s[i][j] = vis ? x : kMasked;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(half_mask, mx, off));

      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float pr = (s[i][j] == kMasked) ? 0.f : expf(s[i][j] - m_new);
        row_sum += pr;
        sP[(ty * TM + i) * PS + tx + kTX * j] = pr;
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(half_mask, row_sum, off);

      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    // a row of sP is written and read by the same half-warp only
    __syncwarp(half_mask);

    // acc += P V
#pragma unroll 2
    for (int j0 = 0; j0 < BN; j0 += 4) {
      float pr[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 t =
            *reinterpret_cast<const float4*>(sP + (ty * TM + i) * PS + j0);
        pr[i][0] = t.x; pr[i][1] = t.y; pr[i][2] = t.z; pr[i][3] = t.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[DC];
#pragma unroll
        for (int c = 0; c < DC; ++c) vv[c] = sV[(j0 + jj) * DP + tx + kTX * c];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int c = 0; c < DC; ++c)
            acc[i][c] = fmaf(pr[i][jj], vv[c], acc[i][c]);
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    if (r >= rows) continue;
    T* orow = op + (long long)(q0 + r) * p.o_ss;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + kTX * c;
      if (col >= p.Dv) continue;
      store1(orow + col, l[i] > 0.f ? acc[i][c] / l[i]
                                    : mean_v(vp, p.v_ss, p.Sk, col));
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core pieces: cp.async, ldmatrix, mma.sync, bf16 packing, scores.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros where `full` is false.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(full ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

// c += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 fp32.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bf16, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// x0, x1 as two bf16 pairs: hi = bf16(x), lo = bf16(x - hi), so hi + lo
// holds x to about 2^-17 of itself.
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi,
                                             uint32_t& lo) {
  hi = pack_bf16x2(x0, x1);
  lo = pack_bf16x2(x0 - __uint_as_float(hi << 16),
                   x1 - __uint_as_float(hi & 0xffff0000u));
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a [rows][DP] bf16 tile
// whose chunks are XOR-swizzled by row % 8: the 8 rows an ldmatrix reads at
// one logical chunk land in 8 different bank groups.
template <int DP>
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return (uint32_t)(row * DP * 2 + ((chunk ^ (row & 7)) << 4));
}

// Rows [row0, row0 + ROWS) of a [*, D] bf16 matrix with row stride `stride`
// into a swizzled [ROWS][DP] tile; rows >= row_end and columns >= D are 0.
template <int ROWS, int DP, int THREADS>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const bf16* src,
                                                long long stride, int row0,
                                                int row_end, int D, int tid) {
  constexpr int kChunks = DP / 8;
  static_assert(ROWS * kChunks % THREADS == 0, "whole passes only");
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / THREADS; ++it) {
    const int i = tid + it * THREADS;
    const int r = i / kChunks;
    const int c = i % kChunks;
    const bool ok = row0 + r < row_end && c * 8 < D;
    const bf16* g = ok ? src + (long long)(row0 + r) * stride + c * 8 : src;
    cp_async_16(dst + swz<DP>(r, c), g, ok);
  }
}

// Scores of one warp's 16 x 64 tile into the base-2 domain (scale * log2 e
// folded into one multiply, or the softcap), and -inf where a key is not
// visible; MASK only on tiles that cross the causal diagonal, the window
// edge or Sk.  Element e of column tile j sits at row qpos0 + 8 * (e / 2),
// key key0 + 8 * j + e % 2.
template <int NS, bool MASK>
__device__ __forceinline__ void base2_scores(float (&s)[NS][4], const Params& p,
                                             int key0, int qpos0) {
  if (p.softcap > 0.f) {
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = p.cap_out * tanhf(s[j][e] * p.cap_in);
  } else {
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= p.scale_log2;
  }
  if (!MASK) return;
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kpos = key0 + 8 * j + (e & 1);
      const int qpos = qpos0 + 8 * (e >> 1);
      bool vis = kpos < p.Sk;
      if (p.causal) vis = vis && kpos <= qpos;
      if (p.window > 0) vis = vis && kpos > qpos - p.window;
      if (!vis) s[j][e] = -INFINITY;
    }
}

// One tile's online-softmax step on base-2 scores in the m16n8 layout (rows
// lane/4 and lane/4 + 8; a row's four threads share m through two
// shuffles): s becomes 2^(s - m_new), l this thread's part of the running
// sum, corr the factor O owes for the new maximum.
template <int NS>
__device__ __forceinline__ void online_softmax(float (&s)[NS][4], float (&m)[2],
                                               float (&l)[2], float (&corr)[2]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
  float base[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    base[i] = mx[i] == -INFINITY ? 0.f : mx[i];   // no visible key yet
    corr[i] = exp2f(m[i] - base[i]);
    m[i] = mx[i];
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    s[j][0] = exp2f(s[j][0] - base[0]);
    s[j][1] = exp2f(s[j][1] - base[0]);
    s[j][2] = exp2f(s[j][2] - base[1]);
    s[j][3] = exp2f(s[j][3] - base[1]);
    rs[0] += s[j][0] + s[j][1];
    rs[1] += s[j][2] + s[j][3];
  }
  l[0] = l[0] * corr[0] + rs[0];
  l[1] = l[1] * corr[1] + rs[1];
}

template <int NO>
__device__ __forceinline__ void rescale_o(float (&o)[NO][4], const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    o[j][0] *= corr[0];
    o[j][1] *= corr[0];
    o[j][2] *= corr[1];
    o[j][3] *= corr[1];
  }
}

// ---------------------------------------------------------------------------
// tc on wgmma: warp-specialised, TMA-fed.
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 256;   // 2 warpgroups, 64 query rows each
constexpr int kWgBM = 128;        // query rows per block, 64 per consumer
constexpr int kWgBN = 128;        // keys per kv tile

struct TcMaps {
  CUtensorMap q, k, v;            // bf16, 128-byte swizzle, 64-column boxes
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
// Until the phase of parity `parity` has completed.  A wait of seconds is a
// deadlock, not a wait: it traps, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (int spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spins == (1 << 16)) start = clock64();
    if (spins > (1 << 16) && clock64() - start > 8000000000LL) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, const int (&c)[5]) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]) : "memory");
}
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, const int (&c)[5]) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]), "r"(c[4]) : "memory");
}

// wgmma matrix descriptor of a 128-byte-swizzled tile in shared memory
// (rows of 128 bytes, 8-row groups of 1024 bytes, 1024-byte aligned).
// lbo / sbo in bytes: K-major, sbo = 1024 between 8-row groups (lbo unused);
// MN-major, lbo = between 64-element MN chunks, sbo = between 8-row K groups.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e]) :: "memory");
}

// d += A B, m64n128k16, bf16 in, fp32 out; A and B from shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[16][4], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, m64n128k16, bf16 in, fp32 out; A from registers (the m16n8k16
// A fragment of each warp's 16 rows), B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[16][4],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B, m64n64k16, bf16 in, fp32 out; A from registers (the m16n8k16
// A fragment of each warp's 16 rows), B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[8][4],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// O += P V for a 128-key tile: P (hi and lo bf16 parts) as the register A
// operand, V [128 keys][DV] from the stage at sV, MN-major: keys
// [16 kk, 16 kk + 16) are two 8-key groups of 1024 bytes; the two 64-column
// boxes of a DV = 128 row are kKVBox apart.
template <int NO>
__device__ __forceinline__ void pv_products(float (&o)[NO][4],
                                            const uint32_t (&ph)[kWgBN / 16][4],
                                            const uint32_t (&pl)[kWgBN / 16][4],
                                            uint32_t sV) {
#pragma unroll
  for (int kk = 0; kk < kWgBN / 16; ++kk) {
    const uint64_t dv = gmma_desc(sV + kk * 2048, kWgBN * 128, 1024);
    wgmma_rs_tb(o, ph[kk], dv);
    wgmma_rs_tb(o, pl[kk], dv);
  }
}

// DQ: head dim of q and k rounded up to 64, 128 or 192 (one, two or three
// 64-column boxes); DV: that of v and out, 64 or 128 (DV = DQ up to 128,
// V columns past Dv zero-filled by TMA; DV = 128 under DQ = 192, the MLA
// instance).  S: K/V ring depth (3; 2 at DQ = 192, whose 80 KB stages would
// not fit three times beside Q's 48 KB).
// Warpgroups 0 and 1 each own 64 query rows: S = Q K^T as wgmma m64n128k16
// from shared memory, the online softmax on the accumulator registers, O =
// O * corr + P V as wgmma with P (hi and lo bf16 parts) as the register A
// operand and V read MN-major.  Thread 0 issues every TMA load: Q once, then
// K and V tiles into a three-stage ring, each stage guarded by a "full" and
// an "empty" mbarrier; it refills a stage as soon as all 8 warps have
// released it.  There is no producer warp: a ninth warp puts three warps on
// one of the SM's four register-file quarters, which caps every thread at
// 168 registers, and S, O and P need about 200 (ptxas spilled at 168, with
// or without setmaxnreg).  256 threads may use up to 255.  In the
// accumulators a thread holds rows lane/4 and lane/4 + 8 of its warp's 16
// and columns 2*(lane%4), +1 of every 8-wide tile, as in an mma.sync m16n8
// fragment.
template <int DQ, int DV, int S>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_wg_kernel(const Params p, const __grid_constant__ TcMaps maps) {
  constexpr int BN = kWgBN;
  constexpr int H = DQ / 64;                     // 64-column boxes of a Q/K row
  constexpr int HV = DV / 64;                    // of a V row
  constexpr int NS = BN / 8;                     // 8-key column tiles of S
  constexpr int NO = DV / 8;                     // 8-wide column tiles of O
  constexpr uint32_t kQBox = 64 * 128;           // 64 rows x 128 bytes
  constexpr uint32_t kKVBox = BN * 128;          // 128 rows x 128 bytes
  constexpr uint32_t kQBytes = 2 * H * kQBox;
  constexpr uint32_t kStage = (H + HV) * kKVBox; // K boxes, then V boxes

  extern __shared__ unsigned char wg_smem[];
  const uint32_t sQ = (smem_addr(wg_smem) + 1023u) & ~1023u;
  const uint32_t sKV = sQ + kQBytes;
  const uint32_t full0 = sKV + S * kStage;       // full[S], empty[S], q
  const uint32_t empty0 = full0 + 8 * S;
  const uint32_t q_bar = empty0 + 8 * S;

  const int tid = threadIdx.x;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n = h / p.G;
  const int g = h % p.G;
  const int q0 = qt * kWgBM;
  const int rows = min(kWgBM, p.Sq - q0);

  const int qpos_lo = p.q_offset + q0;
  const int qpos_hi = p.q_offset + q0 + rows - 1;
  int kv_hi = p.Sk;
  if (p.causal) kv_hi = min(kv_hi, qpos_hi + 1);
  int kv_lo = 0;
  if (p.window > 0) kv_lo = max(0, qpos_lo - p.window + 1);
  kv_lo = (kv_lo / BN) * BN;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BN - 1) / BN : 0;

  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full0 + 8 * i, 1);         // thread 0's expect_tx
      mbar_init(empty0 + 8 * i, 8);        // one arrival per warp
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // K and V of tile t into its stage; thread 0 issues every TMA load.
  auto load_kv = [&](int t) {
    const int stage = t % S;
    const uint32_t full = full0 + 8 * stage;
    const uint32_t dst = sKV + stage * kStage;
    int c[5];
    mbar_expect_tx(full, kStage);
    for (int hh = 0; hh < H; ++hh) {
      c[0] = 64 * hh;
      c[p.k_ord[0]] = kv_lo + t * BN;
      c[p.k_ord[1]] = n;
      c[p.k_ord[2]] = b;
      tma_load_4d(dst + hh * kKVBox, &maps.k, full, c);
    }
    for (int hh = 0; hh < HV; ++hh) {
      c[0] = 64 * hh;
      c[p.v_ord[0]] = kv_lo + t * BN;
      c[p.v_ord[1]] = n;
      c[p.v_ord[2]] = b;
      tma_load_4d(dst + (H + hh) * kKVBox, &maps.v, full, c);
    }
  };
  // Tile u + S reuses tile u's stage once all 8 warps have released it.
  auto refill = [&](int u) {
    if (tid == 0 && u + S < n_tiles) {
      mbar_wait(empty0 + 8 * (u % S), (u / S) & 1);
      load_kv(u + S);
    }
    __syncwarp();        // warp 0 whole again before its next wgmma
  };
  if (tid == 0) {
    int c[5];
    mbar_expect_tx(q_bar, kQBytes);
    for (int w = 0; w < 2; ++w)
      for (int hh = 0; hh < H; ++hh) {
        c[0] = 64 * hh;
        c[p.q_ord[0]] = q0 + 64 * w;
        c[p.q_ord[1]] = g;
        c[p.q_ord[2]] = n;
        c[p.q_ord[3]] = b;
        tma_load_5d(sQ + (w * H + hh) * kQBox, &maps.q, q_bar, c);
      }
    for (int t = 0; t < min(S, n_tiles); ++t) load_kv(t);
  }
  const int cw = tid / 128;                    // rows [64 cw, 64 cw + 64)
  const int lane = tid & 31;
  const int r_lo = 64 * cw + 16 * ((tid >> 5) & 3) + (lane >> 2);
  const int c_in = (lane & 3) * 2;
  const int wq_lo = qpos_lo + 64 * cw;         // this warpgroup's positions
  const int wq_hi = wq_lo + 63;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + n * p.v_sn;
  bf16* op = static_cast<bf16*>(p.o) + b * p.o_sb + n * p.o_sn + g * p.o_sg;

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  mbar_wait(q_bar, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % S;
    const int kv0 = kv_lo + t * BN;
    const uint32_t sK = sKV + stage * kStage;
    mbar_wait(full0 + 8 * stage, (t / S) & 1);

    float s[NS][4];
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQ / 16; ++kk) {
      const uint32_t col = (kk & 3) * 32;      // 16 bf16 inside a 128-byte row
      wgmma_ss_n128(s,
                    gmma_desc(sQ + (cw * H + kk / 4) * kQBox + col, 16, 1024),
                    gmma_desc(sK + (kk / 4) * kKVBox + col, 16, 1024),
                    kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    const bool edge = kv0 + BN > p.Sk ||
                      (p.causal && kv0 + BN - 1 > wq_lo) ||
                      (p.window > 0 && kv0 <= wq_hi - p.window);
    if (edge)
      base2_scores<NS, true>(s, p, kv0 + c_in, p.q_offset + q0 + r_lo);
    else
      base2_scores<NS, false>(s, p, kv0 + c_in, p.q_offset + q0 + r_lo);
    float corr[2];
    online_softmax(s, m, l, corr);

    // P as bf16 hi + lo parts, the A operand of O = O * corr + P V
    uint32_t ph[BN / 16][4], pl[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      split_bf16x2(s[2 * kk][0], s[2 * kk][1], ph[kk][0], pl[kk][0]);
      split_bf16x2(s[2 * kk][2], s[2 * kk][3], ph[kk][1], pl[kk][1]);
      split_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[kk][2], pl[kk][2]);
      split_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[kk][3], pl[kk][3]);
    }
    rescale_o(o, corr);
    fence_regs(o);
    wgmma_fence();
    pv_products(o, ph, pl, sK + H * kKVBox);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    if (lane == 0) mbar_arrive(empty0 + 8 * stage);   // this warp is done with it
    refill(t);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r_lo + 8 * i;
    if (r >= rows) continue;
    bf16* orow = op + (long long)(q0 + r) * p.o_ss;
    const bool seen = l[i] > 0.f;
    const float inv = seen ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int col = j * 8 + c_in;
      if (col >= p.Dv) continue;
      float x0 = o[j][2 * i] * inv;
      float x1 = o[j][2 * i + 1] * inv;
      if (!seen) {
        x0 = mean_v(vp, p.v_ss, p.Sk, col);
        x1 = mean_v(vp, p.v_ss, p.Sk, col + 1);
      }
      *reinterpret_cast<__nv_bfloat162*>(orow + col) =
          __floats2bfloat162_rn(x0, x1);
    }
  }
}

// ---------------------------------------------------------------------------
// decode: one query row per head, the heads of a kv head together.
// ---------------------------------------------------------------------------

constexpr int kDecThreads = 128;
constexpr int kDtBN = 64;         // tensor-core decode: keys per tile, 16 a warp
constexpr int kDtRows = 16;       // tensor-core decode: query heads per block

// The visible keys [lo, hi) of the one query row, and this block's split of
// them [s_lo, s_hi).
struct DecodeRange {
  int s_lo, s_hi;
};
__device__ __forceinline__ DecodeRange decode_range(const Params& p, int split) {
  int hi = p.Sk;
  if (p.causal) hi = min(hi, p.q_offset + 1);
  int lo = 0;
  if (p.window > 0) lo = max(0, p.q_offset - p.window + 1);
  DecodeRange r;
  r.s_lo = lo + split * p.split_len;
  r.s_hi = min(hi, r.s_lo + p.split_len);
  return r;
}

// The end of both decode kernels.  NG partial softmaxes per head sit in
// shared memory (group grp, head g: m at sM[grp * gs + g], l at sL[...], acc
// at sA[(grp * gs + g) * as + d], d < Dv), m in the base-2 domain; the block has
// synchronised after writing them.  One split: out = sum w acc / sum w l,
// w = 2^(m - M).  Several: the block's merged (m, l, acc[D]) go to its slot
// of p.part, and the last split of this (batch, kv head, chunk) to arrive
// combines all of them (an atomic ticket, which it resets) and writes out.
template <typename T, int NG>
__device__ __forceinline__ void finish_decode(const Params& p, const float* sM,
                                              const float* sL, const float* sA,
                                              int gs, int as, int gn, int gc,
                                              int split, T* op, const T* vp,
                                              int* sLast) {
  const int tid = threadIdx.x;
  const bool single = p.splits == 1;
  const size_t ub = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const int row_len = p.Dv + 2;                // m, l, acc[Dv] of one head
  float* mine = single ? nullptr : p.part + (ub * p.splits + split) * gc * row_len;
  for (int i = tid; i < gn * p.Dv; i += blockDim.x) {
    const int g = i / p.Dv;
    const int d = i % p.Dv;
    float mx = -INFINITY;
#pragma unroll
    for (int grp = 0; grp < NG; ++grp) mx = fmaxf(mx, sM[grp * gs + g]);
    const float base = mx == -INFINITY ? 0.f : mx;
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int grp = 0; grp < NG; ++grp) {
      const float w = exp2f(sM[grp * gs + g] - base);
      L = fmaf(w, sL[grp * gs + g], L);
      A = fmaf(w, sA[(grp * gs + g) * as + d], A);
    }
    if (single) {
      // L = 0: no visible key
      store1(op + g * p.o_sg + d, L > 0.f ? A / L : mean_v(vp, p.v_ss, p.Sk, d));
    } else {
      float* row = mine + g * row_len;
      if (d == 0) {
        row[0] = mx;
        row[1] = L;
      }
      row[2 + d] = A;
    }
  }
  if (single) return;

  __threadfence();
  __syncthreads();
  if (tid == 0)
    *sLast = atomicAdd(p.ticket + ub, 1u) == (unsigned)(p.splits - 1);
  __syncthreads();
  if (!*sLast) return;
  __threadfence();
  const float* all = p.part + ub * p.splits * gc * row_len;
  for (int i = tid; i < gn * p.Dv; i += blockDim.x) {
    const int g = i / p.Dv;
    const int d = i % p.Dv;
    float mx = -INFINITY;
    for (int sp = 0; sp < p.splits; ++sp)
      mx = fmaxf(mx, __ldcg(all + ((size_t)sp * gc + g) * row_len));
    const float base = mx == -INFINITY ? 0.f : mx;
    float L = 0.f, A = 0.f;
    for (int sp = 0; sp < p.splits; ++sp) {
      const float* row = all + ((size_t)sp * gc + g) * row_len;
      const float w = exp2f(__ldcg(row) - base);
      L = fmaf(w, __ldcg(row + 1), L);
      A = fmaf(w, __ldcg(row + 2 + d), A);
    }
    store1(op + g * p.o_sg + d, L > 0.f ? A / L : mean_v(vp, p.v_ss, p.Sk, d));
  }
  if (tid == 0) p.ticket[ub] = 0u;   // ready for the next call on this stream
}

// --- bf16: the heads of a chunk as the 16 rows of mma.sync tiles ----------
//
// One block of 4 warps per (batch, kv head, chunk of <= 16 query heads,
// split).  Q (the chunk's heads as rows, zero rows past G) is read once into
// registers; K and V tiles of 64 keys stream through a two-stage cp.async
// ring, and warp w takes keys [16w, 16w + 16) of each tile: S = Q K^T and
// O += P V (P as bf16 hi + lo parts) are mma.sync m16n8k16, so a key costs a
// few instructions instead of a lane group's dot products and shuffles.  The
// four warps' softmaxes are merged once at the end.  DQ: head dim of q and
// k rounded up to 64, 128 or 192; DV: that of v (DV = DQ up to 128, V
// columns past Dv zero; DV = 128 under DQ = 192, the MLA instance, whose
// 88 KB of shared memory leave room for two resident blocks, not three).
template <int DQ, int DV>
__global__ void __launch_bounds__(kDecThreads, DQ > 128 ? 2 : 3)
flash_decode_tc_kernel(const Params p) {
  constexpr int KS = DQ / 16;
  constexpr int NO = DV / 8;
  constexpr uint32_t kKTile = kDtBN * DQ * 2;
  constexpr uint32_t kStage = kKTile + kDtBN * DV * 2;
  extern __shared__ __align__(128) unsigned char dt_smem[];
  __shared__ int sLast;
  const uint32_t sQ = smem_addr(dt_smem);            // [16][DQ]
  const uint32_t sKV = sQ + kDtRows * DQ * 2;        // 2 stages of K [64][DQ], V [64][DV]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int split = blockIdx.x;
  const int unit = blockIdx.y;                       // (kv head, chunk of heads)
  const int b = blockIdx.z;
  const int n = unit / p.g_chunks;
  const int gc = (p.G + p.g_chunks - 1) / p.g_chunks;
  const int g0 = (unit % p.g_chunks) * gc;
  const int gn = min(gc, p.G - g0);
  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.q_sb + n * p.q_sn + g0 * p.q_sg;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + n * p.k_sn;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + n * p.v_sn;
  bf16* op = static_cast<bf16*>(p.o) + b * p.o_sb + n * p.o_sn + g0 * p.o_sg;
  const DecodeRange r = decode_range(p, split);
  const int n_tiles = r.s_hi > r.s_lo ? (r.s_hi - r.s_lo + kDtBN - 1) / kDtBN : 0;

  load_tile_async<kDtRows, DQ, kDecThreads>(sQ, qp, p.q_sg, 0, gn, p.D, tid);
  if (n_tiles > 0) {
    load_tile_async<kDtBN, DQ, kDecThreads>(sKV, kp, p.k_ss, r.s_lo, r.s_hi, p.D, tid);
    load_tile_async<kDtBN, DV, kDecThreads>(sKV + kKTile, vp, p.v_ss, r.s_lo, r.s_hi, p.Dv, tid);
  }
  cp_async_commit();

  const int c_in = (lane & 3) * 2;
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  uint32_t qf[KS][4];

  for (int t = 0; t < n_tiles; ++t) {
    const int kv0 = r.s_lo + t * kDtBN;
    if (t + 1 < n_tiles) {
      const uint32_t nxt = sKV + ((t + 1) & 1) * kStage;
      load_tile_async<kDtBN, DQ, kDecThreads>(nxt, kp, p.k_ss, kv0 + kDtBN, r.s_hi, p.D, tid);
      load_tile_async<kDtBN, DV, kDecThreads>(nxt + kKTile, vp, p.v_ss, kv0 + kDtBN, r.s_hi, p.Dv, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(qf[kk], sQ + swz<DQ>((lane & 7) + ((lane >> 3) & 1) * 8,
                                     kk * 2 + (lane >> 4)));
    }
    const uint32_t sK = sKV + (t & 1) * kStage;
    const uint32_t sV = sK + kKTile;

    // S = Q K^T: 16 heads x this warp's 16 keys
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t bk[4];
      ldsm_x4(bk, sK + swz<DQ>(warp * 16 + (lane & 7) + (lane >> 4) * 8,
                               kk * 2 + ((lane >> 3) & 1)));
      mma_16816(s[0], qf[kk], bk[0], bk[1]);
      mma_16816(s[1], qf[kk], bk[2], bk[3]);
    }
    // base-2 scores; keys past the split's end (last tile only) are masked
    const int key0 = kv0 + warp * 16 + c_in;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = p.softcap > 0.f ? p.cap_out * tanhf(s[j][e] * p.cap_in)
                                  : s[j][e] * p.scale_log2;
        s[j][e] = key0 + 8 * j + (e & 1) < r.s_hi ? x : -INFINITY;
      }
    float corr[2];
    online_softmax(s, m, l, corr);
    rescale_o(o, corr);
    // O += P V over this warp's 16 keys
    uint32_t ah[4], al[4];
    split_bf16x2(s[0][0], s[0][1], ah[0], al[0]);
    split_bf16x2(s[0][2], s[0][3], ah[1], al[1]);
    split_bf16x2(s[1][0], s[1][1], ah[2], al[2]);
    split_bf16x2(s[1][2], s[1][3], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NO / 2; ++j) {
      uint32_t bv[4];
      ldsm_x4_t(bv, sV + swz<DV>(warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                 j * 2 + (lane >> 4)));
      mma_16816(o[2 * j], ah, bv[0], bv[1]);
      mma_16816(o[2 * j + 1], ah, bv[2], bv[3]);
      mma_16816(o[2 * j], al, bv[0], bv[1]);
      mma_16816(o[2 * j + 1], al, bv[2], bv[3]);
    }
    __syncthreads();   // this stage is free for the tile after next
  }

  // the four warps' (m, l, acc) per head, into the (now free) K/V stages
  cp_async_wait<0>();
  __syncthreads();
  float* sA = reinterpret_cast<float*>(dt_smem + kDtRows * DQ * 2);  // [4][16][DV]
  float* sM = sA + 4 * kDtRows * DV;                                  // [4][16]
  float* sL = sM + 4 * kDtRows;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = (lane >> 2) + 8 * i;
    if ((lane & 3) == 0) {
      sM[warp * kDtRows + row] = m[i];
      sL[warp * kDtRows + row] = l[i];
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      sA[(warp * kDtRows + row) * DV + 8 * j + c_in] = o[j][2 * i];
      sA[(warp * kDtRows + row) * DV + 8 * j + c_in + 1] = o[j][2 * i + 1];
    }
  }
  __syncthreads();
  finish_decode<bf16, 4>(p, sM, sL, sA, kDtRows, DV, gn, gc, split, op, vp, &sLast);
}

// --- fp32: lane groups with IEEE fp32 dot products -------------------------

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
// 16 bytes as 4 fp32 values
__device__ __forceinline__ void unpack16(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

// GC: query heads per block (a chunk of the G heads of one kv head).  A
// group of 32 lanes (a warp) owns one key at a time, lane j the 16-byte
// pieces [4j + 128 i, 4j + 128 i + 4), i < KP, of its K row (D <= 128 KP)
// and the piece [4j, 4j + 4) of its V row (Dv <= 128), so the warp reads a
// row as contiguous runs; the block's 4 warps take U consecutive keys each
// per step.  Every warp runs its own online softmax for the GC heads; the
// warps are merged once at the end.
template <int GC, int KP>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_kernel(const Params p) {
  constexpr int EPL = 4;                       // elements per lane and piece
  constexpr int NG = kDecThreads / 32;         // key groups (warps)
  constexpr int U = GC * KP > 5 ? 2 : 4;       // keys per group and step
  __shared__ __align__(16) float sAcc[NG][GC][128];
  __shared__ float sM[NG][GC], sL[NG][GC];
  __shared__ int sLast;

  const int tid = threadIdx.x;
  const int group = tid / 32;
  const int d0 = (tid % 32) * EPL;
  bool has_k[KP];                              // D, Dv are multiples of EPL
#pragma unroll
  for (int i = 0; i < KP; ++i) has_k[i] = d0 + 128 * i < p.D;
  const bool has_v = d0 < p.Dv;

  const int split = blockIdx.x;
  const int unit = blockIdx.y;                 // (kv head, chunk of heads)
  const int b = blockIdx.z;
  const int n = unit / p.g_chunks;
  const int g0 = (unit % p.g_chunks) * GC;
  const int gn = min(GC, p.G - g0);
  const float* qp = static_cast<const float*>(p.q) + b * p.q_sb + n * p.q_sn + g0 * p.q_sg;
  const float* kp = static_cast<const float*>(p.k) + b * p.k_sb + n * p.k_sn;
  const float* vp = static_cast<const float*>(p.v) + b * p.v_sb + n * p.v_sn;
  float* op = static_cast<float*>(p.o) + b * p.o_sb + n * p.o_sn + g0 * p.o_sg;
  const DecodeRange r = decode_range(p, split);

  // q pre-scaled so that a score is <q, k> in the base-2 domain (softcap:
  // the argument of its tanh)
  const float qs = p.softcap > 0.f ? p.cap_in : p.scale_log2;
  const uint4 zero16 = make_uint4(0u, 0u, 0u, 0u);
  float q[GC][KP][EPL];
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int i = 0; i < KP; ++i) {
      float f[EPL];
      unpack16(g < gn && has_k[i] ? load16(qp + g * p.q_sg + d0 + 128 * i)
                                  : zero16, f);
#pragma unroll
      for (int e = 0; e < EPL; ++e) q[g][i][e] = f[e] * qs;
    }

  float m[GC], l[GC], acc[GC][EPL];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  for (int k0 = r.s_lo + group * U; k0 < r.s_hi; k0 += NG * U) {
    // a key past s_hi reads row s_hi - 1 again and is masked below
    uint4 kr[U][KP], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long row = min(k0 + u, r.s_hi - 1);
#pragma unroll
      for (int i = 0; i < KP; ++i)
        kr[u][i] = has_k[i] ? load16(kp + row * p.k_ss + d0 + 128 * i) : zero16;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long row = min(k0 + u, r.s_hi - 1);
      vr[u] = has_v ? load16(vp + row * p.v_ss + d0) : zero16;
    }
    float s[U][GC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int g = 0; g < GC; ++g) s[u][g] = 0.f;
#pragma unroll
      for (int i = 0; i < KP; ++i) {
        float kf[EPL];
        unpack16(kr[u][i], kf);
#pragma unroll
        for (int g = 0; g < GC; ++g)
#pragma unroll
          for (int e = 0; e < EPL; ++e) s[u][g] = fmaf(q[g][i][e], kf[e], s[u][g]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < GC; ++g)
          s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);

#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float x = p.softcap > 0.f ? p.cap_out * tanhf(s[u][g]) : s[u][g];
        x = k0 + u < r.s_hi ? x : -INFINITY;
        s[u][g] = x;
        mx = fmaxf(mx, x);
      }
      const float base = mx == -INFINITY ? 0.f : mx;
      const float corr = exp2f(m[g] - base);
      m[g] = mx;
      float rs = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u][g] = exp2f(s[u][g] - base);
        rs += s[u][g];
      }
      l[g] = l[g] * corr + rs;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[EPL];
      unpack16(vr[u], vf);
#pragma unroll
      for (int g = 0; g < GC; ++g)
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(s[u][g], vf[e], acc[g][e]);
    }
  }

  if (tid % 32 == 0) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      sM[group][g] = m[g];
      sL[group][g] = l[g];
    }
  }
  if (has_v) {
#pragma unroll
    for (int g = 0; g < GC; ++g)
      *reinterpret_cast<float4*>(&sAcc[group][g][d0]) =
          make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  }
  __syncthreads();
  finish_decode<float, NG>(p, &sM[0][0], &sL[0][0], &sAcc[0][0][0], GC, 128,
                           gn, GC, split, op, vp, &sLast);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename T, int DP>
cudaError_t launch_fma(const Params& p, cudaStream_t stream) {
  constexpr int TN = (DP >= 128) ? 2 : 4;
  constexpr int BM = kTY * kTM;
  constexpr int BN = kTX * TN;
  constexpr size_t kSmem =
      sizeof(float) * (BM * DP + BN * (DP + 4) + BN * DP + BM * (BN + 4));
  auto kernel = flash_attention_kernel<T, DP, TN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BM - 1) / BM, p.N * p.G, p.B);
  kernel<<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fma_dtype(const Params& p, cudaStream_t stream) {
  if (p.D <= 16) return launch_fma<T, 16>(p, stream);
  if (p.D <= 32) return launch_fma<T, 32>(p, stream);
  if (p.D <= 64) return launch_fma<T, 64>(p, stream);
  if (p.D <= 128) return launch_fma<T, 128>(p, stream);
  return launch_fma<T, 192>(p, stream);
}

// cuTensorMapEncodeTiled through the runtime, so the library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &status) != cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiledFn>(ptr);
  }();
  return fn;
}

// Tensor map of a bf16 tensor with a contiguous head dim D and n more dims
// (sizes and element strides in role order; role 0 is the dim a box spans
// box_rows of, the others one).  The encoder gets the dims in increasing
// stride; ord[r] is the coordinate slot of role r.  Boxes are 64 columns
// (128 bytes, the 128-byte swizzle's span); columns >= D and rows past the
// end are filled with zeros.
bool tensor_map(CUtensorMap* map, const void* base, int D, int n,
                const long long* size, const long long* stride, int box_rows,
                int* ord) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  int idx[4] = {0, 1, 2, 3};
  for (int i = 1; i < n; ++i)
    for (int j = i; j > 0 && stride[idx[j]] < stride[idx[j - 1]]; --j) {
      const int t = idx[j];
      idx[j] = idx[j - 1];
      idx[j - 1] = t;
    }
  cuuint64_t dims[5], strides[4];
  cuuint32_t box[5], elem[5];
  dims[0] = (cuuint64_t)D;
  box[0] = 64;
  elem[0] = 1;
  for (int i = 0; i < n; ++i) {
    const int r = idx[i];
    dims[i + 1] = (cuuint64_t)(size[r] > 0 ? size[r] : 1);
    strides[i] = (cuuint64_t)stride[r] * 2;
    box[i + 1] = r == 0 ? (cuuint32_t)box_rows : 1u;
    elem[i + 1] = 1;
    ord[r] = i + 1;
  }
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)(n + 1),
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DQ, int DV, int S>
cudaError_t launch_wg(const Params& p0, cudaStream_t stream) {
  Params p = p0;
  TcMaps maps;
  const long long q_size[4] = {p.Sq, p.G, p.N, p.B};
  const long long q_stride[4] = {p.q_ss, p.q_sg, p.q_sn, p.q_sb};
  const long long kv_size[3] = {p.Sk, p.N, p.B};
  const long long k_stride[3] = {p.k_ss, p.k_sn, p.k_sb};
  const long long v_stride[3] = {p.v_ss, p.v_sn, p.v_sb};
  if (!tensor_map(&maps.q, p.q, p.D, 4, q_size, q_stride, 64, p.q_ord) ||
      !tensor_map(&maps.k, p.k, p.D, 3, kv_size, k_stride, kWgBN, p.k_ord) ||
      !tensor_map(&maps.v, p.v, p.Dv, 3, kv_size, v_stride, kWgBN, p.v_ord))
    return cudaErrorInvalidValue;
  constexpr int H = DQ / 64;
  constexpr int HV = DV / 64;
  // 1024 for alignment, Q, the stages of K and V, their mbarriers and Q's
  constexpr int kSmem = 1024 + 2 * H * 64 * 128 + S * (H + HV) * kWgBN * 128 +
                        8 * (2 * S + 1);
  static_assert(kSmem <= 232448, "over the 227 KB a block may use");
  auto kernel = flash_attention_wg_kernel<DQ, DV, S>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kWgBM - 1) / kWgBM, p.N * p.G, p.B);
  kernel<<<grid, kWgThreads, kSmem, stream>>>(p, maps);
  return cudaGetLastError();
}

template <int GC, int KP>
cudaError_t launch_decode(const Params& p, cudaStream_t stream) {
  const dim3 grid(p.splits, p.N * p.g_chunks, p.B);
  flash_decode_kernel<GC, KP><<<grid, kDecThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// KP: 16-byte pieces of a q/k row per lane (D <= 128 KP)
template <int KP>
cudaError_t launch_decode_fp32(const Params& p, cudaStream_t stream) {
  switch ((p.G + p.g_chunks - 1) / p.g_chunks) {
    case 1: return launch_decode<1, KP>(p, stream);
    case 2: return launch_decode<2, KP>(p, stream);
    case 3: return launch_decode<3, KP>(p, stream);
    case 4: return launch_decode<4, KP>(p, stream);
    case 5: return launch_decode<5, KP>(p, stream);
    case 6: return launch_decode<6, KP>(p, stream);
    case 7: return launch_decode<7, KP>(p, stream);
    case 8: return launch_decode<8, KP>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int DQ, int DV>
cudaError_t launch_decode_tc(const Params& p, cudaStream_t stream) {
  // Q + 2 x (K, V)
  constexpr int kSmem = kDtRows * DQ * 2 + 2 * kDtBN * (DQ + DV) * 2;
  auto kernel = flash_decode_tc_kernel<DQ, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.splits, p.N * p.g_chunks, p.B);
  kernel<<<grid, kDecThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

// --- bf16 MLA decode: 64 heads a block over one 576-wide latent row ------

constexpr int kMlaThreads = 512;     // 16 warps: 4 head tiles x 4
constexpr int kMlaD = 576;           // q / k head dim: c_kv 512 | k_rope 64
constexpr int kMlaDV = 512;          // v / out head dim: the first 512 of k
constexpr int kMlaHeads = 64;        // query heads a block
constexpr int kMlaBN = 32;           // keys a tile
constexpr int kMlaStages = 3;
constexpr int kMlaSLd = kMlaBN + 8;  // floats a row of the score tile
constexpr int kMlaQBytes = kMlaHeads * kMlaD * 2;
constexpr int kMlaTile = kMlaBN * kMlaD * 2;
constexpr int kMlaSmem = kMlaQBytes + kMlaStages * kMlaTile + kMlaHeads * kMlaSLd * 4;
static_assert(kMlaHeads * kMlaDV * 4 + 2 * kMlaHeads * 4 <= kMlaQBytes + kMlaStages * kMlaTile,
              "the partial results fit where Q and the ring were");

// Rows [row0, row0 + ROWS) of a [*, 576] bf16 matrix with row stride
// `stride` into a swizzled [ROWS][576] tile; rows >= row_end are 0.
template <int ROWS>
__device__ __forceinline__ void mla_load(uint32_t dst, const bf16* src,
                                         long long stride, int row0,
                                         int row_end, int tid) {
  constexpr int kChunks = kMlaD / 8;
  for (int i = tid; i < ROWS * kChunks; i += kMlaThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const bool ok = row0 + r < row_end;
    const bf16* g = ok ? src + (long long)(row0 + r) * stride + c * 8 : src;
    cp_async_16(dst + swz<kMlaD>(r, c), g, ok);
  }
}

__global__ void __launch_bounds__(kMlaThreads, 1)
flash_mla_decode_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char ml_smem[];
  __shared__ int sLast;
  const uint32_t sQ = smem_addr(ml_smem);                 // [64][576]
  const uint32_t sKV = sQ + kMlaQBytes;                   // stages of [32][576]
  float* sS = reinterpret_cast<float*>(ml_smem + kMlaQBytes + kMlaStages * kMlaTile);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int split = blockIdx.x;
  const int unit = blockIdx.y;                            // (kv head, chunk of 64 heads)
  const int b = blockIdx.z;
  const int n = unit / p.g_chunks;
  const int g0 = (unit % p.g_chunks) * kMlaHeads;
  const int gn = min(kMlaHeads, p.G - g0);                // heads of this chunk
  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.q_sb + n * p.q_sn + g0 * p.q_sg;
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_sb + n * p.k_sn;
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_sb + n * p.v_sn;
  bf16* op = static_cast<bf16*>(p.o) + b * p.o_sb + n * p.o_sn + g0 * p.o_sg;
  const DecodeRange r = decode_range(p, split);
  const int n_tiles = r.s_hi > r.s_lo ? (r.s_hi - r.s_lo + kMlaBN - 1) / kMlaBN : 0;

  mla_load<kMlaHeads>(sQ, qp, p.q_sg, 0, gn, tid);     // rows past gn: 0
#pragma unroll
  for (int st = 0; st < kMlaStages - 1; ++st) {
    if (st < n_tiles)
      mla_load<kMlaBN>(sKV + st * kMlaTile, kp, p.k_ss, r.s_lo + st * kMlaBN, r.s_hi, tid);
    cp_async_commit();
  }

  const int ht = warp >> 2;          // heads [16 ht, 16 ht + 16)
  const int part = warp & 3;         // S: keys [8 part, +8); PV: columns [128 part, +128)
  const int row = lane >> 2;
  const int c_in = (lane & 3) * 2;
  float o[kMlaDV / 4 / 8][4];
#pragma unroll
  for (int j = 0; j < kMlaDV / 4 / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kMlaStages - 2>();
    __syncthreads();                 // tile t is in; the stage of t - 1 and the scores are free
    const int nt = t + kMlaStages - 1;
    if (nt < n_tiles)
      mla_load<kMlaBN>(sKV + (nt % kMlaStages) * kMlaTile, kp, p.k_ss,
                       r.s_lo + nt * kMlaBN, r.s_hi, tid);
    cp_async_commit();
    const uint32_t sT = sKV + (t % kMlaStages) * kMlaTile;
    const int kv0 = r.s_lo + t * kMlaBN;

    // S = Q K^T for heads [16 ht, +16) x keys [8 part, +8), two k-steps a pass
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 6
    for (int kp2 = 0; kp2 < kMlaD / 32; ++kp2) {
      uint32_t bk[4], qa[4];
      ldsm_x4(bk, sT + swz<kMlaD>(part * 8 + (lane & 7), kp2 * 4 + (lane >> 3)));
      ldsm_x4(qa, sQ + swz<kMlaD>(ht * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                  kp2 * 4 + (lane >> 4)));
      mma_16816(sc, qa, bk[0], bk[1]);
      ldsm_x4(qa, sQ + swz<kMlaD>(ht * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                  kp2 * 4 + 2 + (lane >> 4)));
      mma_16816(sc, qa, bk[2], bk[3]);
    }
    // base-2 scores, keys past the split's end masked, into the score tile
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = p.softcap > 0.f ? p.cap_out * tanhf(sc[e] * p.cap_in)
                                      : sc[e] * p.scale_log2;
      sc[e] = kv0 + part * 8 + c_in + (e & 1) < r.s_hi ? x : -INFINITY;
    }
    float* srow = sS + (ht * 16 + row) * kMlaSLd + part * 8 + c_in;
    *reinterpret_cast<float2*>(srow) = make_float2(sc[0], sc[1]);
    *reinterpret_cast<float2*>(srow + 8 * kMlaSLd) = make_float2(sc[2], sc[3]);
    __syncthreads();                 // the tile's scores are in

    // this warp's 16 heads over the tile's 32 keys: the online softmax,
    // then O[:, 128 part, +128) += P V
    float s[4][4];
    const float* mine = sS + (ht * 16 + row) * kMlaSLd + c_in;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 a = *reinterpret_cast<const float2*>(mine + 8 * j);
      const float2 c = *reinterpret_cast<const float2*>(mine + 8 * kMlaSLd + 8 * j);
      s[j][0] = a.x; s[j][1] = a.y; s[j][2] = c.x; s[j][3] = c.y;
    }
    float corr[2];
    online_softmax(s, m, l, corr);
    rescale_o(o, corr);
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t ah[4], al[4];
      split_bf16x2(s[2 * ks][0], s[2 * ks][1], ah[0], al[0]);
      split_bf16x2(s[2 * ks][2], s[2 * ks][3], ah[1], al[1]);
      split_bf16x2(s[2 * ks + 1][0], s[2 * ks + 1][1], ah[2], al[2]);
      split_bf16x2(s[2 * ks + 1][2], s[2 * ks + 1][3], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < kMlaDV / 4 / 16; ++j) {
        uint32_t bv[4];
        ldsm_x4_t(bv, sT + swz<kMlaD>(ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                      part * 16 + j * 2 + (lane >> 4)));
        mma_16816(o[2 * j], ah, bv[0], bv[1]);
        mma_16816(o[2 * j + 1], ah, bv[2], bv[3]);
        mma_16816(o[2 * j], al, bv[0], bv[1]);
        mma_16816(o[2 * j + 1], al, bv[2], bv[3]);
      }
    }
  }

  // each head's (m, l, acc) into the (now free) Q and ring space
  cp_async_wait<0>();
  __syncthreads();
  float* sA = reinterpret_cast<float*>(ml_smem);          // [64][512]
  float* sM = sA + kMlaHeads * kMlaDV;                    // [64]
  float* sL = sM + kMlaHeads;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int h = ht * 16 + row + 8 * i;
    if (part == 0 && (lane & 3) == 0) {
      sM[h] = m[i];
      sL[h] = l[i];
    }
#pragma unroll
    for (int j = 0; j < kMlaDV / 4 / 8; ++j) {
      const int col = part * (kMlaDV / 4) + 8 * j + c_in;
      sA[h * kMlaDV + col] = o[j][2 * i];
      sA[h * kMlaDV + col + 1] = o[j][2 * i + 1];
    }
  }
  __syncthreads();
  finish_decode<bf16, 1>(p, sM, sL, sA, kMlaHeads, kMlaDV, gn, kMlaHeads,
                         split, op, vp, &sLast);
}

cudaError_t launch_mla_decode(const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_mla_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMlaSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.splits, p.N * p.g_chunks, p.B);
  flash_mla_decode_kernel<<<grid, kMlaThreads, kMlaSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// meta, 27 integers: B N G Sq Sk D | q strides b s n g | k strides b s n |
// v strides b s n | out strides b s n g | causal window q_offset |
// splits split_len g_chunks (decode) | Dv.  D is the head dim of q and k (at
// most 192), Dv that of v and out (at most min(D, 128)), both multiples of 4.
// dtype: 0 = float32, 1 = bfloat16.  variant: 0 = fma, 1 = tc, 2 = decode,
// 3 = mla (bf16, Sq 1, N 1, D 576, Dv 512, v the leading columns of k,
// g_chunks = ceil(G / 64) chunks of up to 64 heads, part holding 64 heads a
// chunk);
// the chosen kernel is launched or the call fails, never another one.
// part / ticket: decode scratch, needed when splits > 1 (part: B * N *
// g_chunks * splits * ceil(G / g_chunks) * (Dv + 2) floats; ticket:
// B * N * g_chunks zeroed unsigned ints, left zeroed by the kernel).
// Returns the cudaError_t of the launch (0 on success), or
// cudaErrorInvalidValue for arguments the chosen kernel does not take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out,
                                      const long long* meta, float scale,
                                      float softcap, int dtype, int variant,
                                      void* part, void* ticket, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = out;
  p.part = static_cast<float*>(part);
  p.ticket = static_cast<unsigned*>(ticket);
  p.B = (int)meta[0]; p.N = (int)meta[1]; p.G = (int)meta[2];
  p.Sq = (int)meta[3]; p.Sk = (int)meta[4]; p.D = (int)meta[5];
  p.q_sb = meta[6]; p.q_ss = meta[7]; p.q_sn = meta[8]; p.q_sg = meta[9];
  p.k_sb = meta[10]; p.k_ss = meta[11]; p.k_sn = meta[12];
  p.v_sb = meta[13]; p.v_ss = meta[14]; p.v_sn = meta[15];
  p.o_sb = meta[16]; p.o_ss = meta[17]; p.o_sn = meta[18]; p.o_sg = meta[19];
  p.causal = (int)meta[20]; p.window = (int)meta[21]; p.q_offset = (int)meta[22];
  p.splits = (int)meta[23]; p.split_len = (int)meta[24]; p.g_chunks = (int)meta[25];
  p.Dv = (int)meta[26];
  p.scale = scale; p.softcap = softcap;
  p.scale_log2 = scale * kLog2e;
  p.cap_in = softcap > 0.f ? scale / softcap : 0.f;
  p.cap_out = softcap * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 3) {
    if (dtype != 1 || p.B <= 0 || p.B > 65535 || p.Sq != 1 || p.N != 1 ||
        p.Sk < 0 || p.D != kMlaD || p.Dv != kMlaDV || p.G <= 0 ||
        p.g_chunks != (p.G + kMlaHeads - 1) / kMlaHeads ||
        p.splits < 1 || p.split_len < 1 || p.v != p.k ||
        (p.splits > 1 && (part == nullptr || ticket == nullptr)))
      return (int)cudaErrorInvalidValue;
    return (int)launch_mla_decode(p, st);
  }
  if (p.B <= 0 || p.N <= 0 || p.G <= 0 || p.Sq <= 0 || p.Sk < 0 ||
      p.D <= 0 || p.D > 192 || p.D % 4 != 0 || p.Dv <= 0 ||
      p.Dv > (p.D < 128 ? p.D : 128) || p.Dv % 4 != 0 || p.B > 65535 ||
      p.N * p.G > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (variant == 0)
    return (int)(dtype == 0 ? launch_fma_dtype<float>(p, st)
                            : launch_fma_dtype<bf16>(p, st));
  if (variant == 1) {
    if (dtype != 1 || p.D % 8 != 0 || p.Dv % 8 != 0)
      return (int)cudaErrorInvalidValue;
    if (p.D <= 64) return (int)launch_wg<64, 64, 3>(p, st);
    if (p.D <= 128) return (int)launch_wg<128, 128, 3>(p, st);
    return (int)launch_wg<192, 128, 2>(p, st);
  }
  if (variant == 2) {
    const int gc = p.g_chunks > 0 ? (p.G + p.g_chunks - 1) / p.g_chunks : 0;
    if (p.Sq != 1 || p.D % (dtype == 0 ? 4 : 8) != 0 ||
        p.Dv % (dtype == 0 ? 4 : 8) != 0 || p.splits < 1 ||
        p.split_len < 1 || p.g_chunks < 1 || gc > (dtype == 0 ? 8 : kDtRows) ||
        p.N * p.g_chunks > 65535 ||
        (p.splits > 1 && (part == nullptr || ticket == nullptr)))
      return (int)cudaErrorInvalidValue;
    if (dtype == 0)
      return (int)(p.D <= 128 ? launch_decode_fp32<1>(p, st)
                              : launch_decode_fp32<2>(p, st));
    if (p.D <= 64) return (int)launch_decode_tc<64, 64>(p, st);
    if (p.D <= 128) return (int)launch_decode_tc<128, 128>(p, st);
    return (int)launch_decode_tc<192, 128>(p, st);
  }
  return (int)cudaErrorInvalidValue;
}
