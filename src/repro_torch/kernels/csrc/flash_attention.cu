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
// accumulator per query row, rescaled as each kv tile arrives, and
// out = acc / l at the end.  Inputs are fp32 or bf16; every product and sum
// is fp32 (the TPU kernel casts q, k and v to fp32 as well).  A masked score
// adds exactly 0 to l and acc, and a visible one at least exp(0) = 1 for the
// row's maximum, so l = 0 at the end marks a row with no visible key.  Such a
// row returns the mean of v over all Sk keys, as the oracle `ref_attention`
// does (every score -1e30, softmax uniform), on a slow path that reads V once
// more.  It does not occur in prefill or decode.
//
// How it differs from the TPU kernel, and why.
//  * The TPU grid is (B, H, q-tiles, kv-tiles) with the kv axis sequential and
//    m/l/acc carried in scratch between grid steps.  Blocks of a CUDA grid run
//    in no order and share nothing, so here one block owns one
//    (batch, query head, q-tile) and loops over the kv tiles itself; m, l and
//    acc stay in registers for the whole loop (`flash_attention_kernel`).
//  * A decode step (Sq = 1) has no tile of queries to amortise K and V over,
//    so it has a kernel of its own (`flash_decode_kernel`): the block's warps
//    split the visible keys, every group of lanes keeps its own m/l/acc, and
//    one combine through shared memory ends the block.
//  * It takes the model layout by strides: q/out [B,S,N,G,D], k/v [B,Sk,N,D],
//    any strides as long as D is contiguous.  The kv head of query head h is
//    h / G, so k and v are never repeated G times and a decode step reads the
//    cache in place.
//  * q_offset, window, softcap and all lengths are runtime arguments.
//  * Ragged edges (Sq, Sk not multiples of the tile, D in {16..128} not a power
//    of two) are masked when tiles are loaded; no padded copies are made.
//  * kv tiles wholly above the causal diagonal, below the window or past Sk are
//    never visited (the TPU kernel visits all of them).  q-tiles are launched
//    last-first so the longest causal rows start first.
//
// What bounds it on an H100.
//  * Prefill (Sq = Sk = S, causal): 4*B*H*D*S*(S+1)/2 FLOPs.  The card's bound
//    for that is its bf16 tensor-core rate; this kernel does the two products
//    on the fp32 FMA units out of shared memory (a 64 x BN score tile, each
//    thread a 4 x TN micro-tile with 128-bit shared-memory reads), so it is
//    bound by the fp32 FMA rate and shared-memory bandwidth, well below that
//    bound.  Tensor-core products (wgmma) and asynchronous tile copies (TMA)
//    are the next step and change nothing outside this file.
//  * Decode (Sq = 1): the bytes of the visible K and V rows.  The decode
//    kernel streams them straight from global memory into registers, a row's
//    bytes contiguous across the lanes of a group, four keys in flight per
//    group and 32 groups per block, with no block-wide barrier until the end.
//    The G query heads of one kv head are G blocks, so K and V come G times
//    through L2 (once from device memory); and one block walks a head's whole
//    cache, so with few (batch x head) pairs the card is not full.  Sharing
//    K and V between the heads of a group and splitting the kv range over
//    blocks are later steps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTX = 16;            // threads along keys / head-dim columns
constexpr int kTY = 16;            // threads along query rows
constexpr int kTM = 4;             // query rows per thread: 64-row q-tiles
constexpr float kMasked = -1e30f;  // "minus infinity" of the running maximum

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, N, G, Sq, Sk, D;
  long long q_sb, q_ss, q_sn, q_sg;   // element strides; D has stride 1
  long long k_sb, k_ss, k_sn;
  long long v_sb, v_ss, v_sn;
  long long o_sb, o_ss, o_sn, o_sg;
  int causal, window, q_offset;
  float scale, softcap;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Four bf16 values as fp32: a bf16 is the upper half of an fp32.
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  float4 r;
  r.x = __uint_as_float(u.x << 16);
  r.y = __uint_as_float(u.x & 0xffff0000u);
  r.z = __uint_as_float(u.y << 16);
  r.w = __uint_as_float(u.y & 0xffff0000u);
  return r;
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
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

// T: element type of q/k/v/out.  DP: head dim rounded up to 16/32/64/128.
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
    load_tile<T, BN, DP, DP>(sV, vp, p.v_ss, kv0, p.Sk, p.D, tid);
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
      if (col >= p.D) continue;
      store1(orow + col, l[i] > 0.f ? acc[i][c] / l[i]
                                    : mean_v(vp, p.v_ss, p.Sk, col));
    }
  }
}

// ---------------------------------------------------------------------------
// Decode: one query row per (batch, head).
//
// A group of LPK lanes owns one key at a time: lane j of the group holds head-dim
// elements [16j, 16j+16), so the group reads a K or V row as one contiguous run.
// The block's kThreads/LPK groups take U consecutive keys each per iteration.
// Every group runs its own online softmax; the groups' (m, l, acc) are merged
// once at the end.  The visible keys of a single row are the interval [lo, hi).
template <typename T, int LPK>
__global__ void __launch_bounds__(kThreads, 2)
flash_decode_kernel(const Params p) {
  constexpr int EPL = 16;                // head-dim elements per lane
  constexpr int VPL = EPL / 4;           // 4-element loads per lane and row
  constexpr int U = 4;                   // keys per group and iteration
  constexpr int NG = kThreads / LPK;     // key groups in the block
  constexpr int DW = LPK * EPL;          // head-dim columns a group covers
  __shared__ __align__(16) float sAcc[NG * DW];
  __shared__ float sM[NG], sL[NG], sW[NG];

  const int tid = threadIdx.x;
  const int group = tid / LPK;
  const int d0 = (tid % LPK) * EPL;
  const unsigned lane = tid & 31u;
  const unsigned group_mask =
      (LPK == 32 ? 0xffffffffu : ((1u << LPK) - 1u)) << (lane & ~(LPK - 1u));

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n = h / p.G;
  const int g = h % p.G;
  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + n * p.q_sn + g * p.q_sg;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + n * p.k_sn;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + n * p.v_sn;
  T* op = static_cast<T*>(p.o) + b * p.o_sb + n * p.o_sn + g * p.o_sg;

  int hi = p.Sk;
  if (p.causal) hi = min(hi, p.q_offset + 1);
  int lo = 0;
  if (p.window > 0) lo = max(0, p.q_offset - p.window + 1);

  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 q[VPL];
#pragma unroll
  for (int c = 0; c < VPL; ++c)
    q[c] = (d0 + 4 * c < p.D) ? load4(qp + d0 + 4 * c) : zero4;

  float m = kMasked, l = 0.f;
  float4 acc[VPL];
#pragma unroll
  for (int c = 0; c < VPL; ++c) acc[c] = zero4;

  for (int k0 = lo + group * U; k0 < hi; k0 += NG * U) {
    // a key past hi reads row hi-1 again and is masked below
    float4 kv[U][VPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const T* row = kp + (long long)min(k0 + u, hi - 1) * p.k_ss + d0;
#pragma unroll
      for (int c = 0; c < VPL; ++c)
        kv[u][c] = (d0 + 4 * c < p.D) ? load4(row + 4 * c) : zero4;
    }
    float s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < VPL; ++c) {
        dot = fmaf(q[c].x, kv[u][c].x, dot);
        dot = fmaf(q[c].y, kv[u][c].y, dot);
        dot = fmaf(q[c].z, kv[u][c].z, dot);
        dot = fmaf(q[c].w, kv[u][c].w, dot);
      }
      s[u] = dot;
    }
#pragma unroll
    for (int off = LPK / 2; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
        s[u] += __shfl_xor_sync(group_mask, s[u], off);

    // V rows on their way while the softmax terms are computed
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const T* row = vp + (long long)min(k0 + u, hi - 1) * p.v_ss + d0;
#pragma unroll
      for (int c = 0; c < VPL; ++c)
        kv[u][c] = (d0 + 4 * c < p.D) ? load4(row + 4 * c) : zero4;
    }

    float mx = kMasked;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float x = s[u] * p.scale;
      if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
      s[u] = (k0 + u < hi) ? x : kMasked;
      mx = fmaxf(mx, s[u]);
    }
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float pr[U];
    float row_sum = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      pr[u] = (s[u] == kMasked) ? 0.f : expf(s[u] - m_new);
      row_sum += pr[u];
    }
    l = l * corr + row_sum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < VPL; ++c) {
      float4 a = acc[c];
      a.x *= corr; a.y *= corr; a.z *= corr; a.w *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        a.x = fmaf(pr[u], kv[u][c].x, a.x);
        a.y = fmaf(pr[u], kv[u][c].y, a.y);
        a.z = fmaf(pr[u], kv[u][c].z, a.z);
        a.w = fmaf(pr[u], kv[u][c].w, a.w);
      }
      acc[c] = a;
    }
  }

  // merge the groups: out = sum_g w_g acc_g / sum_g w_g l_g, w_g = exp(m_g - M)
  if (tid % LPK == 0) {
    sM[group] = m;
    sL[group] = l;
  }
#pragma unroll
  for (int c = 0; c < VPL; ++c)
    *reinterpret_cast<float4*>(sAcc + group * DW + d0 + 4 * c) = acc[c];
  __syncthreads();
  float m_all = kMasked;
  for (int i = 0; i < NG; ++i) m_all = fmaxf(m_all, sM[i]);
  if (tid < NG) sW[tid] = expf(sM[tid] - m_all);
  __syncthreads();
  if (tid < p.D) {
    float l_all = 0.f, a_all = 0.f;
    for (int i = 0; i < NG; ++i) {
      l_all = fmaf(sW[i], sL[i], l_all);
      a_all = fmaf(sW[i], sAcc[i * DW + tid], a_all);
    }
    // l_all = 0: no visible key (lo >= hi among them)
    store1(op + tid, l_all > 0.f ? a_all / l_all
                                 : mean_v(vp, p.v_ss, p.Sk, tid));
  }
}

template <typename T, int DP>
cudaError_t launch_tiles(const Params& p, cudaStream_t stream) {
  constexpr int TN = (DP == 128) ? 2 : 4;
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

template <typename T, int LPK>
cudaError_t launch_decode(const Params& p, cudaStream_t stream) {
  const dim3 grid(1, p.N * p.G, p.B);
  flash_decode_kernel<T, LPK><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const Params& p, cudaStream_t stream) {
  if (p.Sq == 1) {
    if (p.D <= 16) return launch_decode<T, 1>(p, stream);
    if (p.D <= 32) return launch_decode<T, 2>(p, stream);
    if (p.D <= 64) return launch_decode<T, 4>(p, stream);
    return launch_decode<T, 8>(p, stream);
  }
  if (p.D <= 16) return launch_tiles<T, 16>(p, stream);
  if (p.D <= 32) return launch_tiles<T, 32>(p, stream);
  if (p.D <= 64) return launch_tiles<T, 64>(p, stream);
  return launch_tiles<T, 128>(p, stream);
}

}  // namespace

// meta, 23 integers: B N G Sq Sk D | q strides b s n g | k strides b s n |
// v strides b s n | out strides b s n g | causal window q_offset.
// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch
// (0 on success), or cudaErrorInvalidValue for arguments it does not take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out,
                                      const long long* meta, float scale,
                                      float softcap, int dtype, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = out;
  p.B = (int)meta[0]; p.N = (int)meta[1]; p.G = (int)meta[2];
  p.Sq = (int)meta[3]; p.Sk = (int)meta[4]; p.D = (int)meta[5];
  p.q_sb = meta[6]; p.q_ss = meta[7]; p.q_sn = meta[8]; p.q_sg = meta[9];
  p.k_sb = meta[10]; p.k_ss = meta[11]; p.k_sn = meta[12];
  p.v_sb = meta[13]; p.v_ss = meta[14]; p.v_sn = meta[15];
  p.o_sb = meta[16]; p.o_ss = meta[17]; p.o_sn = meta[18]; p.o_sg = meta[19];
  p.causal = (int)meta[20]; p.window = (int)meta[21]; p.q_offset = (int)meta[22];
  p.scale = scale; p.softcap = softcap;
  if (p.B <= 0 || p.N <= 0 || p.G <= 0 || p.Sq <= 0 || p.Sk < 0 ||
      p.D <= 0 || p.D > 128 || p.D % 4 != 0 || p.B > 65535 ||
      p.N * p.G > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_dtype<float>(p, st);
  if (dtype == 1) return (int)launch_dtype<__nv_bfloat16>(p, st);
  return (int)cudaErrorInvalidValue;
}
