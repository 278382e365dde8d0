// Flash decoding for Hopper (sm_90a): one query token per sequence attends
// over the first n_valid slots of a KV cache, each group of H / KV query
// heads over its shared KV head; f32 or bf16 cache, f32 softmax and
// accumulation, output in the input type.
//
// Replaces the Pallas TPU kernel of the reference package:
//   * flash_decode_pallas  (src/repro/kernels/flash_decode.py:69)
//     -> entry flash_decode_fwd.  The reference model computes the same
//     function with a masked grouped einsum in decode_attention
//     (src/repro/models/attention.py:260), which this kernel serves.
//
// Layout: q (B, H, HD), caches (B, L, KV, HD), out (B, H, HD), contiguous.
// Slots 0 .. n_valid-1 are valid (a sliding-window ring is full once it has
// wrapped); attention does not depend on slot order, since rope is applied
// before a key is written.
//
// Bound on the card: memory.  Each step reads 2 * B * n_valid * KV * HD
// cache elements once for 4 * B * H * n_valid * HD FLOPs (about 2 FLOPs per
// cache byte in bf16 at H / KV = 4), far below the card's ratio.
//
// Design: split-K flash decoding in two launches.
//   * Pass 1: one block of 128 threads per (split, KV head, batch); a split
//     is `chunk` consecutive slots, and the wrapper sizes the splits so that
//     every one holds at least one valid slot and the grid covers the SMs
//     about four times (B * KV = 64 blocks alone would fill 64 of 132).  The
//     block stages its query group once and each 64-slot K tile (transposed)
//     and V tile in f32 shared memory, with 16-byte global loads; scores,
//     a per-query online softmax (one warp per query, shuffles) and P V
//     follow.  It writes its partial (acc, m, l) -- the TPU kernel's own
//     running state -- to a workspace.
//   * Pass 2: one block per (batch, head) merges the splits in a fixed
//     order: out = sum_i e^(m_i - M) acc_i / sum_i e^(m_i - M) l_i.  A split
//     with l = 0 would carry m = -inf and is given weight 0.
//   * p stays f32 (the reference rounds it to the cache type before P V).

#include <math.h>

#include "attention_common.cuh"

namespace {

constexpr int BKD = 64;        // cache slots per staged tile
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int KT = BKD + 4;    // row stride of the transposed K tile
constexpr int MAX_GROUP = 16;  // query heads per KV head

template <int HD>
size_t split_smem_bytes(int g) {
  return sizeof(float) * (g * HD + HD * KT + BKD * HD + g * BKD + 3 * g);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_decode_split(const T* __restrict__ q, const T* __restrict__ kc,
                   const T* __restrict__ vc, float* __restrict__ acc_ws,
                   float* __restrict__ ml_ws, int L, int h, int kvh,
                   int n_valid, int chunk, float scale) {
  constexpr int NOUT = (MAX_GROUP * HD + THREADS - 1) / THREADS;
  const int g = h / kvh;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;               // [g][HD]   the query group
  float* ks = qs + g * HD;        // [HD][KT]  K tile, transposed
  float* vs = ks + HD * KT;       // [BKD][HD] V tile
  float* ps = vs + BKD * HD;      // [g][BKD]  scores, then p
  float* m_run = ps + g * BKD;    // [g] running max
  float* l_run = m_run + g;       // [g] running sum
  float* alpha = l_run + g;       // [g] this tile's rescale

  const int split = blockIdx.x;
  const int kv_head = blockIdx.y;
  const int b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int start = split * chunk;
  const int end = min(start + chunk, n_valid);
  const int64_t slot_row = (int64_t)kvh * HD;   // elements between slots
  const T* kb = kc + ((int64_t)b * L * kvh + kv_head) * HD;
  const T* vb = vc + ((int64_t)b * L * kvh + kv_head) * HD;
  const T* qb = q + ((int64_t)b * h + (int64_t)kv_head * g) * HD;

  for (int e = tid; e < g * HD; e += THREADS) qs[e] = attn::to_f32(qb[e]);
  for (int gi = tid; gi < g; gi += THREADS) {
    m_run[gi] = -INFINITY;
    l_run[gi] = 0.f;
  }
  float acc[NOUT];
#pragma unroll
  for (int j = 0; j < NOUT; ++j) acc[j] = 0.f;

  for (int k0 = start; k0 < end; k0 += BKD) {
    __syncthreads();   // the previous tile is consumed; qs/m/l are set
    attn::load_tile_transposed<T, HD, THREADS>(kb, slot_row, k0, end, BKD,
                                               ks, KT);
    attn::load_tile_rows<T, HD, THREADS>(vb, slot_row, k0, end, BKD, vs);
    __syncthreads();

    for (int idx = tid; idx < g * BKD; idx += THREADS) {
      const int gi = idx / BKD;
      const int key = idx % BKD;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d)
        dot = fmaf(qs[gi * HD + d], ks[d * KT + key], dot);
      ps[idx] = (k0 + key < end) ? dot * scale : -INFINITY;
    }
    __syncthreads();

    for (int gi = warp; gi < g; gi += WARPS) {
      float s0 = ps[gi * BKD + lane];
      float s1 = ps[gi * BKD + lane + 32];
      const float mx = attn::group_max<32>(fmaxf(s0, s1));
      const float m_old = m_run[gi];
      const float m_new = fmaxf(m_old, mx);
      float a = 1.f;
      if (m_new != -INFINITY) {
        a = expf(m_old - m_new);
        s0 = expf(s0 - m_new);
        s1 = expf(s1 - m_new);
      } else {
        s0 = s1 = 0.f;
      }
      const float sum = attn::group_sum<32>(s0 + s1);
      ps[gi * BKD + lane] = s0;
      ps[gi * BKD + lane + 32] = s1;
      __syncwarp();
      if (lane == 0) {
        m_run[gi] = m_new;
        l_run[gi] = l_run[gi] * a + sum;
        alpha[gi] = a;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < NOUT; ++j) {
      const int idx = tid + THREADS * j;
      if (idx < g * HD) {
        const int gi = idx / HD;
        const int d = idx % HD;
        float x = acc[j] * alpha[gi];
        const float* pg = ps + gi * BKD;
#pragma unroll 8
        for (int key = 0; key < BKD; ++key)
          x = fmaf(pg[key], vs[key * HD + d], x);
        acc[j] = x;
      }
    }
  }
  __syncthreads();

  const int64_t part = ((int64_t)b * kvh + kv_head) * nsplit + split;
  float* accb = acc_ws + part * g * HD;
#pragma unroll
  for (int j = 0; j < NOUT; ++j) {
    const int idx = tid + THREADS * j;
    if (idx < g * HD) accb[idx] = acc[j];
  }
  for (int gi = tid; gi < g; gi += THREADS) {
    ml_ws[(part * g + gi) * 2] = m_run[gi];
    ml_ws[(part * g + gi) * 2 + 1] = l_run[gi];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_decode_merge(const float* __restrict__ acc_ws,
                   const float* __restrict__ ml_ws, T* __restrict__ out,
                   int h, int kvh, int hd, int nsplit) {
  const int b = blockIdx.x / h;
  const int head = blockIdx.x % h;
  const int g = h / kvh;
  const int kv_head = head / g;
  const int gi = head % g;
  const int64_t base = ((int64_t)b * kvh + kv_head) * nsplit;
  float mx = -INFINITY;
  for (int sp = 0; sp < nsplit; ++sp)
    mx = fmaxf(mx, ml_ws[((base + sp) * g + gi) * 2]);
  for (int d = threadIdx.x; d < hd; d += THREADS) {
    float num = 0.f;
    float den = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) {
      const int64_t part = (base + sp) * g + gi;
      const float l = ml_ws[part * 2 + 1];
      if (l > 0.f) {
        const float w = expf(ml_ws[part * 2] - mx);
        num = fmaf(w, acc_ws[part * hd + d], num);
        den = fmaf(w, l, den);
      }
    }
    out[((int64_t)b * h + head) * hd + d] =
        attn::from_f32<T>(den > 0.f ? num / den : 0.f);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           float* acc_ws, float* ml_ws, int b, int L, int h, int kvh,
           int n_valid, int chunk, int nsplit, float scale,
           cudaStream_t stream) {
  auto kern = flash_decode_split<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)split_smem_bytes<HD>(MAX_GROUP));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nsplit, kvh, b);
  kern<<<grid, THREADS, split_smem_bytes<HD>(h / kvh), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), acc_ws, ml_ws, L, h, kvh, n_valid, chunk,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_decode_merge<T><<<b * h, THREADS, 0, stream>>>(
      acc_ws, ml_ws, static_cast<T*>(out), h, kvh, HD, nsplit);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* out,
             float* acc_ws, float* ml_ws, int b, int L, int h, int kvh,
             int n_valid, int chunk, int nsplit, float scale,
             cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, out, acc_ws, ml_ws, b, L, h, kvh, n_valid, chunk, nsplit, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, acc_ws, ml_ws, b, L, h, kvh, n_valid, chunk, nsplit, scale, stream);
    case 80: return launch<T, 80>(q, k, v, out, acc_ws, ml_ws, b, L, h, kvh, n_valid, chunk, nsplit, scale, stream);
    case 96: return launch<T, 96>(q, k, v, out, acc_ws, ml_ws, b, L, h, kvh, n_valid, chunk, nsplit, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, acc_ws, ml_ws, b, L, h, kvh, n_valid, chunk, nsplit, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// out (b, h, hd) = attention of q (b, h, hd) over slots 0 .. n_valid-1 of
// the caches k, v (b, L, kvh, hd).  Splits of `chunk` slots, `nsplit` of
// them, each holding at least one valid slot; acc_ws (b, kvh, nsplit, g,
// hd) and ml_ws (b, kvh, nsplit, g, 2) are f32 workspaces.  h / kvh <= 16;
// head_dim one of 32, 64, 80, 96, 128; bf16 1 for bfloat16 tensors.
// Launched on `stream`; returns the first launch error (0 on success).
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v,
                                void* out, float* acc_ws, float* ml_ws,
                                int b, int L, int h, int kvh, int hd,
                                int n_valid, int chunk, int nsplit, int bf16,
                                float scale, void* stream) {
  if (h % kvh != 0 || h / kvh > MAX_GROUP || n_valid < 1 || chunk < 1 ||
      (int64_t)(nsplit - 1) * chunk >= n_valid)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return dispatch<__nv_bfloat16>(hd, q, k, v, out, acc_ws, ml_ws, b, L, h,
                                   kvh, n_valid, chunk, nsplit, scale, st);
  return dispatch<float>(hd, q, k, v, out, acc_ws, ml_ws, b, L, h, kvh,
                         n_valid, chunk, nsplit, scale, st);
}
