// Flash attention forward (prefill and full-sequence forward) for Hopper
// (sm_90a): causal or full softmax attention with an optional sliding
// window, grouped-query heads read natively, f32 inputs or bf16 inputs, f32
// online softmax and accumulation, output in the input type.
//
// Replaces the Pallas TPU kernel of the reference package:
//   * flash_attention_pallas  (src/repro/kernels/flash_attention.py:77)
//     -> entry flash_attention_fwd.  The reference model computes the same
//     function with blockwise_attention (src/repro/models/attention.py:99),
//     which this kernel serves in the port's attention_block.
//
// Layout: q (B, S, H, HD), k and v (B, S, KV, HD), out (B, S, H, HD), all
// contiguous; query head h reads KV head h / (H / KV) in place (no repeat).
// Keep key kp for query qp iff kp <= qp (causal) and kp > qp - window (when
// a window is given) -- the predicate of _mask_block (attention.py:83).
//
// Bound on the card: 4 * B * H * HD * (kept query-key pairs) FLOPs (two
// products) against reading q, k, v once and writing out once.  At S = 4096
// it is FLOP-bound by far (~0.69 TFLOP per danube layer at B = 8), so the
// bound is the tensor-core rate; this kernel runs on the fp32 FMA pipes.
//
// Design, kept simple on purpose (no tensor cores, no TMA):
//   * one block of 128 threads per (query tile of 64 rows, head, batch);
//     tiles are launched last-first, so the long causal rows start first;
//   * the Q tile is staged once, transposed, in f32 shared memory; each
//     64-key K tile (transposed) and V tile (row-major) is staged in turn;
//   * thread (r, c) = (tid / 8, tid % 8) owns rows 4r..4r+3 of the tile and
//     score columns 4c..4c+3 and 32+4c..32+4c+3, read as float4s, so one
//     shared load feeds 4-8 FMAs;
//   * the online softmax (running max m, sum l, rescale alpha) is reduced
//     over the 8 lanes of a row with shuffles; a row with no kept key yet
//     keeps m = -inf and adds nothing (no exp(-inf - -inf));
//   * P goes through shared memory, transposed, into O += P V; each thread
//     owns the same 4 rows of O and HD / 8 of its columns, so alpha never
//     leaves the thread.  p stays f32 (the reference rounds it to the input
//     type before P V);
//   * K tiles wholly above the diagonal or wholly outside the window are
//     never loaded; rows and keys past S are masked (any S is taken).

#include <math.h>

#include "attention_common.cuh"

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per staged tile
constexpr int THREADS = 128;
constexpr int TS = BQ + 4;     // row stride of the transposed Q, K, P tiles
static_assert(BQ == BK, "Q and K tiles share the transposed row stride");

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* out);
template <>
__device__ __forceinline__ void load_vec<2>(const float* p, float* out) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  out[0] = x.x; out[1] = x.y;
}
template <>
__device__ __forceinline__ void load_vec<4>(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * HD * TS + BK * HD + BK * TS);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int s,
                       int h, int kvh, int causal, int window, float scale) {
  // columns of O per thread: NJ groups of VW neighbours, 8 * VW apart
  constexpr int VW = (HD % 32 == 0) ? 4 : 2;
  constexpr int NJ = HD / (8 * VW);
  static_assert(NJ * 8 * VW == HD, "head_dim must be a multiple of 16");

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;            // [HD][TS]  Q tile, transposed
  float* ks = qs + HD * TS;    // [HD][TS]  K tile, transposed
  float* vs = ks + HD * TS;    // [BK][HD]  V tile
  float* pt = vs + BK * HD;    // [BK][TS]  P tile, transposed

  const int tid = threadIdx.x;
  const int r = tid >> 3;
  const int c = tid & 7;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_head = head / (h / kvh);
  const int64_t q_row = (int64_t)h * HD;     // elements between positions
  const int64_t kv_row = (int64_t)kvh * HD;
  const T* qb = q + ((int64_t)b * s * h + head) * HD;
  const T* kb = k + ((int64_t)b * s * kvh + kv_head) * HD;
  const T* vb = v + ((int64_t)b * s * kvh + kv_head) * HD;
  T* ob = out + ((int64_t)b * s * h + head) * HD;

  attn::load_tile_transposed<T, HD, THREADS>(qb, q_row, q0, s, BQ, qs, TS);

  float o[4][NJ * VW];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < NJ * VW; ++e) o[i][e] = 0.f;
  }

  // live key tiles: not wholly above the diagonal, not wholly before the
  // window of the tile's first row
  const int q_last = min(q0 + BQ, s) - 1;
  int kt_end = (s + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, q_last / BK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // the previous tile's K, V and P are consumed
    attn::load_tile_transposed<T, HD, THREADS>(kb, kv_row, k0, s, BK, ks, TS);
    attn::load_tile_rows<T, HD, THREADS>(vb, kv_row, k0, s, BK, vs);
    __syncthreads();

    // S = Q K^T on this thread's 4 x 8 scores
    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[4], bk[8];
      load_vec<4>(qs + d * TS + 4 * r, a);
      load_vec<4>(ks + d * TS + 4 * c, bk);
      load_vec<4>(ks + d * TS + 32 + 4 * c, bk + 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
    }

    // mask, online softmax, rescale O
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * r + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kp = k0 + 4 * c + (j & 3) + 32 * (j >> 2);
        const bool keep = kp < s && (!causal || kp <= qp) &&
                          (window <= 0 || kp > qp - window);
        sc[i][j] = keep ? sc[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = attn::group_max<8>(mx);
      const float m_new = fmaxf(m[i], mx);
      float alpha = 1.f;
      float sum = 0.f;
      if (m_new != -INFINITY) {
        alpha = expf(m[i] - m_new);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sc[i][j] = expf(sc[i][j] - m_new);
          sum += sc[i][j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
      }
      sum = attn::group_sum<8>(sum);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < NJ * VW; ++e) o[i][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 4 * c + (j & 3) + 32 * (j >> 2);
      *reinterpret_cast<float4*>(pt + col * TS + 4 * r) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    }
    __syncthreads();

    // O += P V
#pragma unroll 2
    for (int kc = 0; kc < BK; ++kc) {
      float p[4];
      load_vec<4>(pt + kc * TS + 4 * r, p);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        float vv[VW];
        load_vec<VW>(vs + kc * HD + jj * 8 * VW + c * VW, vv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < VW; ++e)
            o[i][jj * VW + e] = fmaf(p[i], vv[e], o[i][jj * VW + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pos = q0 + 4 * r + i;
    if (pos >= s) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < VW; ++e)
        ob[pos * q_row + jj * 8 * VW + c * VW + e] =
            attn::from_f32<T>(o[i][jj * VW + e] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int s, int h, int kvh, int causal, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kern = flash_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s + BQ - 1) / BQ, h, b);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s, h, kvh, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* out,
             int b, int s, int h, int kvh, int causal, int window,
             float scale, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, out, b, s, h, kvh, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, b, s, h, kvh, causal, window, scale, stream);
    case 80: return launch<T, 80>(q, k, v, out, b, s, h, kvh, causal, window, scale, stream);
    case 96: return launch<T, 96>(q, k, v, out, b, s, h, kvh, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, b, s, h, kvh, causal, window, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// out = softmax(q k^T * scale, masked) v for q (b, s, h, hd), k and v
// (b, s, kvh, hd); causal 0/1, window <= 0 for none, bf16 1 for bfloat16
// tensors (0: float32).  head_dim is one of 32, 64, 80, 96, 128.  Launched
// on `stream`; returns the launch's cudaError_t (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int b, int s,
                                   int h, int kvh, int hd, int causal,
                                   int window, int bf16, float scale,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return dispatch<__nv_bfloat16>(hd, q, k, v, out, b, s, h, kvh, causal,
                                   window, scale, st);
  return dispatch<float>(hd, q, k, v, out, b, s, h, kvh, causal, window,
                         scale, st);
}
