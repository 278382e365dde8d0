// Flash attention backward for Hopper (sm_90a): the gradients dQ, dK and
// dV of flash_attention_fwd's function (causal, prefix-LM or full softmax
// attention with an optional sliding window, grouped-query heads), for f32
// or bf16 inputs, f32 arithmetic throughout, gradients written in the
// inputs' type.
//
// It replaces no Pallas kernel: the reference trains through
// blockwise_attention (src/repro/models/attention.py:99), which XLA
// differentiates; its Pallas forward (flash_attention_pallas,
// src/repro/kernels/flash_attention.py:77) has no backward.  The port's
// attention_block runs the flash kernel, so its training path needs this
// one (entry flash_attention_bwd, bound by kernels/flash_attention.py's
// FlashAttention autograd Function).
//
// Layout: q, out, dout, dq (B, S, H, HD); k, v, dk, dv (B, S, KV, HD), all
// contiguous; lse and delta (B, H, S) f32.  lse is the forward's row
// log-sum-exp of the scaled scores (flash_attention_fwd_lse), so P = exp(S
// * scale - lse) is recomputed exactly, with masked entries set to 0.  The
// mask is the forward's: keep key kp for query qp iff kp <= key_limit(qp)
// (qp, or P - 1 inside a prefix of P) under the causal mask, and kp > qp -
// window when a window is given.
//
// The standard two-pass backward, deterministic and without atomics (the
// repo's convention, as dual_matmul's fixed-order partials):
//   * flash_bwd_dq: one block per (64 query rows (32 at head dim 256),
//     head, batch).  It first computes its rows' delta = rowsum(dO * O) in
//     f32 and writes it for the second kernel, then walks the key tiles its
//     rows can see (the forward's key_limit and window bounds) and sums dQ
//     += dS K in registers, dS = P * (dP - delta) * scale, dP = dO V^T;
//   * flash_bwd_dkdv: one block per (64 keys (32 at head dim 256), KV
//     head, batch).  It loads its K and V tile once, then walks the g = H /
//     KV query heads of its group and, for each, the query tiles that can
//     see one of its keys: from the block's first key (or from 0 when the
//     tile starts inside the prefix, which every query sees, or without
//     the causal mask) up to its last key + window.  Per query tile it
//     recomputes S and dP, then sums dV += P^T dO and dK += dS^T Q in
//     registers: the GQA sum over the group happens inside the block.
// Each block recomputes S = Q K^T (and dP): seven products of 2 B H HD
// (kept pairs) FLOPs against the five the gradients need.
//
// Bound on the card: 10 B H HD (kept pairs) FLOPs (the five products),
// and the bytes of q, k, v, out, dout and lse read once and dq, dk, dv
// written once: at danube's training shape (B = 4, S = 4096, H = 32, KV =
// 8, HD = 80) FLOP-bound by far.  This first kernel runs on the fp32 FMA
// pipes for both types (67 TFLOP/s at most; no tensor cores), with tiles
// in shared memory converted to f32 at load, 16 x 16 threads each holding
// a register tile: the S and dP tiles as 4 (or 2) rows x 4 (or 2) strided
// keys, summed over the head dim in 16-byte shared loads, and the
// gradient tiles as 4 (or 2) rows x HD / 16 strided columns.  Loads are
// synchronous (no ring); two blocks an SM hide them where shared memory
// allows.  Making it fast (bf16 on mma.sync or wgmma) is later work.

#include <math.h>

#include "attention_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;   // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ int key_limit(int qp, int prefix) {
  return qp < prefix ? prefix - 1 : qp;
}

// The forward's keep predicate, with both positions inside the sequence.
__device__ __forceinline__ bool kept(int qp, int kp, int s, int causal,
                                     int window, int prefix) {
  return qp < s && kp < s && (!causal || kp <= key_limit(qp, prefix)) &&
         (window <= 0 || kp > qp - window);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes of T from global memory, as f32 into shared memory at dst.
template <typename T>
struct Io;
template <>
struct Io<float> {
  static constexpr int V = 4;   // elements in 16 bytes
  __device__ static void load(const float* src, float* dst) {
    *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
  }
  __device__ static float to_f32(float x) { return x; }
};
template <>
struct Io<bf16> {
  static constexpr int V = 8;
  __device__ static void load(const bf16* src, float* dst) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]),
                 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
    reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
    reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
  }
  __device__ static float to_f32(bf16 x) { return __bfloat162float(x); }
};

// Rows pos0 .. pos0 + ROWS - 1 of a (rows x HD) matrix of T whose rows lie
// `row_stride` elements apart, as f32 into dst[row * LD + d]; rows at or
// past `limit` are zeros.
template <typename T, int HD, int ROWS, int LD>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          int64_t row_stride, int pos0,
                                          int limit, float* dst) {
  constexpr int V = Io<T>::V;
  constexpr int CPR = HD / V;   // 16-byte chunks a row
  for (int e = threadIdx.x; e < ROWS * CPR; e += THREADS) {
    const int row = e / CPR;
    const int col = (e % CPR) * V;
    const int pos = pos0 + row;
    float* d = dst + row * LD + col;
    if (pos < limit) {
      Io<T>::load(src + pos * row_stride + col, d);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) d[i] = 0.f;
    }
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float c) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, c))));
}

// s[i][j] = A[r_i] . K[c_j] and dp[i][j] = dO[r_i] . V[c_j] over the head
// dim, for rows r_i = ty * RM + i of the query tiles (qs, dos) and keys
// c_j = tx + 16 j of the key tiles (ks, vs), all rows LD floats apart.
template <int HD, int RM, int CN, int LD>
__device__ __forceinline__ void scores(const float* qs, const float* dos,
                                       const float* ks, const float* vs,
                                       int ty, int tx, float (&s)[RM][CN],
                                       float (&dp)[RM][CN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 qa[RM], da[RM], kb[CN], vb[CN];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      qa[i] = *reinterpret_cast<const float4*>(qs + (ty * RM + i) * LD + d);
      da[i] = *reinterpret_cast<const float4*>(dos + (ty * RM + i) * LD + d);
    }
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      kb[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * LD + d);
      vb[j] = *reinterpret_cast<const float4*>(vs + (tx + 16 * j) * LD + d);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        s[i][j] = dot4(qa[i], kb[j], s[i][j]);
        dp[i][j] = dot4(da[i], vb[j], dp[i][j]);
      }
  }
}

// P and dS of the register tile: p = exp(S scale - lse) on kept pairs (0
// elsewhere), ds = p (dP - delta) scale; lse2 is lse in log2 units (+inf
// for rows past S).
template <int RM, int CN>
__device__ __forceinline__ void softmax_grads(
    float (&s)[RM][CN], float (&dp)[RM][CN], const float* lse2_s,
    const float* delta_s, int ty, int tx, int q0, int k0, int s_len,
    int causal, int window, int prefix, float scale, float scale_log2) {
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty * RM + i;
    const float l2 = lse2_s[r], dl = delta_s[r];
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const bool keep =
          kept(q0 + r, k0 + tx + 16 * j, s_len, causal, window, prefix);
      const float p = keep ? exp2_approx(fmaf(s[i][j], scale_log2, -l2))
                           : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - dl) * scale;
    }
  }
}

// Query rows a block's tiles hold and keys a key tile holds, by head dim.
template <int HD>
struct DqTile {
  static constexpr int BQ = HD <= 128 ? 64 : 32;
  static constexpr int BK = HD <= 80 ? 64 : 32;
  static constexpr int LD = HD + 4;   // f32 rows: 16-byte aligned, and the
                                      // 8 rows of a 16-byte phase on
                                      // distinct banks
  static constexpr int LDS = BQ + 4;  // dS^T rows
  static constexpr int RM = BQ / 16, CN = BK / 16, NJ = HD / 16;
  static constexpr size_t SMEM =
      sizeof(float) * ((2 * BQ + 2 * BK) * LD + BK * LDS + 2 * BQ);
};

template <int HD>
struct DkvTile {
  static constexpr int BQ = 32;
  static constexpr int BK = HD <= 128 ? 64 : 32;
  static constexpr int LD = HD + 4;
  static constexpr int LDP = BK + 4;  // P and dS rows
  static constexpr int RM = BQ / 16, CN = BK / 16, RK = BK / 16,
                       NJ = HD / 16;
  static constexpr size_t SMEM =
      sizeof(float) * ((2 * BQ + 2 * BK) * LD + 2 * BQ * LDP + 2 * BQ);
};

// Each of the tile's rows r < rows: lse2_s[r] = lse in log2 units (+inf
// past S or for a row that keeps no key, so that its p is 0).
__device__ __forceinline__ void load_lse(const float* __restrict__ lse_row,
                                         int q0, int rows, int s,
                                         float* lse2_s) {
  for (int r = threadIdx.x; r < rows; r += THREADS) {
    const float l = q0 + r < s ? lse_row[q0 + r] : INFINITY;
    lse2_s[r] = isinf(l) ? INFINITY : l * LOG2E;
  }
}

// dQ, and delta for flash_bwd_dkdv.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ out,
             const T* __restrict__ dout, const float* __restrict__ lse,
             float* __restrict__ delta, T* __restrict__ dq, int s, int h,
             int kvh, int causal, int window, int prefix, float scale) {
  using G = DqTile<HD>;
  constexpr int BQ = G::BQ, BK = G::BK, LD = G::LD, LDS = G::LDS;
  constexpr int RM = G::RM, CN = G::CN, NJ = G::NJ;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [BQ][LD]
  float* dos = qs + BQ * LD;         // [BQ][LD]
  float* ks = dos + BQ * LD;         // [BK][LD]
  float* vs = ks + BK * LD;          // [BK][LD]
  float* dst = vs + BK * LD;         // [BK][LDS]: dS^T
  float* lse2_s = dst + BK * LDS;    // [BQ]
  float* delta_s = lse2_s + BQ;      // [BQ]

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int head = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // long rows first
  const int kv_head = head / (h / kvh);
  const int64_t q_row = (int64_t)h * HD, kv_row = (int64_t)kvh * HD;
  const int64_t qoff = ((int64_t)b * s * h + head) * HD;
  const int64_t kvoff = ((int64_t)b * s * kvh + kv_head) * HD;
  const int64_t rowstat = ((int64_t)b * h + head) * s;   // lse, delta
  const float scale_log2 = scale * LOG2E;

  load_tile<T, HD, BQ, LD>(q + qoff, q_row, q0, s, qs);
  load_tile<T, HD, BQ, LD>(dout + qoff, q_row, q0, s, dos);
  load_lse(lse + rowstat, q0, BQ, s, lse2_s);
  __syncthreads();
  // delta = rowsum(dO * O): a warp a row at a time, in f32
  for (int r = warp; r < BQ; r += THREADS / 32) {
    float acc = 0.f;
    if (q0 + r < s) {
      const T* orow = out + qoff + (q0 + r) * q_row;
      for (int d = lane; d < HD; d += 32)
        acc = fmaf(dos[r * LD + d], Io<T>::to_f32(orow[d]), acc);
    }
    acc = attn::group_sum<32>(acc);
    if (lane == 0) {
      delta_s[r] = acc;
      if (q0 + r < s) delta[rowstat + q0 + r] = acc;
    }
  }

  // the live key tiles: the forward's
  const int q_last = min(q0 + BQ, s) - 1;
  int kt_end = (s + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, key_limit(q_last, prefix) / BK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;

  float acc[RM][NJ];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the last tile's K and dS^T are read
    load_tile<T, HD, BK, LD>(k + kvoff, kv_row, k0, s, ks);
    load_tile<T, HD, BK, LD>(v + kvoff, kv_row, k0, s, vs);
    __syncthreads();
    float sc[RM][CN], dp[RM][CN];
    scores<HD, RM, CN, LD>(qs, dos, ks, vs, ty, tx, sc, dp);
    softmax_grads<RM, CN>(sc, dp, lse2_s, delta_s, ty, tx, q0, k0, s,
                          causal, window, prefix, scale, scale_log2);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j)
        dst[(tx + 16 * j) * LDS + ty * RM + i] = dp[i][j];
    __syncthreads();
    // dQ += dS K: rows ty * RM + i, columns tx + 16 j
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float a[RM], kc[NJ];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = dst[c * LDS + ty * RM + i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kc[j] = ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], kc[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int pos = q0 + ty * RM + i;
    if (pos >= s) continue;
    T* row = dq + qoff + pos * q_row;
#pragma unroll
    for (int j = 0; j < NJ; ++j) row[tx + 16 * j] = attn::from_f32<T>(acc[i][j]);
  }
}

// dK and dV of one key tile, summed over the group's query heads.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk,
               T* __restrict__ dv, int s, int h, int kvh, int causal,
               int window, int prefix, float scale) {
  using G = DkvTile<HD>;
  constexpr int BQ = G::BQ, BK = G::BK, LD = G::LD, LDP = G::LDP;
  constexpr int RM = G::RM, CN = G::CN, RK = G::RK, NJ = G::NJ;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                  // [BK][LD]
  float* vs = ks + BK * LD;          // [BK][LD]
  float* qs = vs + BK * LD;          // [BQ][LD]
  float* dos = qs + BQ * LD;         // [BQ][LD]
  float* ps = dos + BQ * LD;         // [BQ][LDP]: P
  float* dss = ps + BQ * LDP;        // [BQ][LDP]: dS
  float* lse2_s = dss + BQ * LDP;    // [BQ]
  float* delta_s = lse2_s + BQ;      // [BQ]

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int kv_head = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BK;    // early keys, seen by most rows, first
  const int g = h / kvh;
  const int64_t q_row = (int64_t)h * HD, kv_row = (int64_t)kvh * HD;
  const int64_t kvoff = ((int64_t)b * s * kvh + kv_head) * HD;
  const float scale_log2 = scale * LOG2E;

  // the query rows that keep one of the tile's keys
  const int k_last = min(k0 + BK, s) - 1;
  const int q_begin = causal && k0 >= prefix ? k0 : 0;
  const int q_end = window > 0 ? min(s, k_last + window) : s;

  load_tile<T, HD, BK, LD>(k + kvoff, kv_row, k0, s, ks);
  load_tile<T, HD, BK, LD>(v + kvoff, kv_row, k0, s, vs);

  float dka[RK][NJ], dva[RK][NJ];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int hh = 0; hh < g; ++hh) {
    const int head = kv_head * g + hh;
    const int64_t qoff = ((int64_t)b * s * h + head) * HD;
    const int64_t rowstat = ((int64_t)b * h + head) * s;
    for (int q0 = q_begin / BQ * BQ; q0 < q_end; q0 += BQ) {
      __syncthreads();   // the last tile's Q, dO, P and dS are read
      load_tile<T, HD, BQ, LD>(q + qoff, q_row, q0, s, qs);
      load_tile<T, HD, BQ, LD>(dout + qoff, q_row, q0, s, dos);
      load_lse(lse + rowstat, q0, BQ, s, lse2_s);
      for (int r = threadIdx.x; r < BQ; r += THREADS)
        delta_s[r] = q0 + r < s ? delta[rowstat + q0 + r] : 0.f;
      __syncthreads();
      float sc[RM][CN], dp[RM][CN];
      scores<HD, RM, CN, LD>(qs, dos, ks, vs, ty, tx, sc, dp);
      softmax_grads<RM, CN>(sc, dp, lse2_s, delta_s, ty, tx, q0, k0, s,
                            causal, window, prefix, scale, scale_log2);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          ps[(ty * RM + i) * LDP + tx + 16 * j] = sc[i][j];
          dss[(ty * RM + i) * LDP + tx + 16 * j] = dp[i][j];
        }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: keys ty * RK + i, columns tx + 16 j
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pa[RK], da[RK], dor[NJ], qr[NJ];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          pa[i] = ps[r * LDP + ty * RK + i];
          da[i] = dss[r * LDP + ty * RK + i];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          dor[j] = dos[r * LD + tx + 16 * j];
          qr[j] = qs[r * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            dva[i][j] = fmaf(pa[i], dor[j], dva[i][j]);
            dka[i][j] = fmaf(da[i], qr[j], dka[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int pos = k0 + ty * RK + i;
    if (pos >= s) continue;
    T* krow = dk + kvoff + pos * kv_row;
    T* vrow = dv + kvoff + pos * kv_row;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      krow[tx + 16 * j] = attn::from_f32<T>(dka[i][j]);
      vrow[tx + 16 * j] = attn::from_f32<T>(dva[i][j]);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int b, int s, int h, int kvh, int causal,
           int window, int prefix, float scale, cudaStream_t stream) {
  using Q = DqTile<HD>;
  using KV = DkvTile<HD>;
  auto kq = flash_bwd_dq<T, HD>;
  auto kkv = flash_bwd_dkdv<T, HD>;
  cudaError_t err = allow_smem(kq, Q::SMEM);
  if (err == cudaSuccess) err = allow_smem(kkv, KV::SMEM);
  if (err != cudaSuccess) return (int)err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  kq<<<dim3(h, b, (s + Q::BQ - 1) / Q::BQ), THREADS, Q::SMEM, stream>>>(
      qt, kt, vt, static_cast<const T*>(out), dot, lse, delta,
      static_cast<T*>(dq), s, h, kvh, causal, window, prefix, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kkv<<<dim3(kvh, b, (s + KV::BK - 1) / KV::BK), THREADS, KV::SMEM,
        stream>>>(qt, kt, vt, dot, lse, delta, static_cast<T*>(dk),
                  static_cast<T*>(dv), s, h, kvh, causal, window, prefix,
                  scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v,
             const void* out, const void* dout, const float* lse,
             float* delta, void* dq, void* dk, void* dv, int b, int s, int h,
             int kvh, int causal, int window, int prefix, float scale,
             cudaStream_t stream) {
#define BWD_LAUNCH(D)                                                      \
  launch<T, D>(q, k, v, out, dout, lse, delta, dq, dk, dv, b, s, h, kvh,   \
               causal, window, prefix, scale, stream)
  switch (hd) {
    case 32: return BWD_LAUNCH(32);
    case 64: return BWD_LAUNCH(64);
    case 80: return BWD_LAUNCH(80);
    case 96: return BWD_LAUNCH(96);
    case 128: return BWD_LAUNCH(128);
    case 256: return BWD_LAUNCH(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef BWD_LAUNCH
}

}  // namespace

// dq, dk, dv of out = softmax(q k^T * scale, masked) v, given dout and the
// forward's out and lse (flash_attention_fwd_lse); delta (b, h, s) f32 is
// scratch the entry writes and reads.  causal 0/1, window <= 0 for none,
// prefix the prefix-LM length (read only when causal), is_bf16 1 for
// bfloat16 tensors (0: float32); head_dim one of 32, 64, 80, 96, 128,
// 256.  Two launches on `stream` (dQ with delta, then dK and dV); returns
// the first failing launch's cudaError_t (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk,
                                   void* dv, int b, int s, int h, int kvh,
                                   int hd, int causal, int window,
                                   int prefix, int is_bf16, float scale,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (prefix < 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return dispatch<bf16>(hd, q, k, v, out, dout, lse, delta, dq, dk, dv, b,
                          s, h, kvh, causal, window, prefix, scale, st);
  return dispatch<float>(hd, q, k, v, out, dout, lse, delta, dq, dk, dv, b,
                         s, h, kvh, causal, window, prefix, scale, st);
}
