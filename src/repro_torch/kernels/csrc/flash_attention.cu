// Flash attention forward (prefill and full-sequence forward) for Hopper
// (sm_90a): causal, prefix-LM or full softmax attention with an optional
// sliding window, grouped-query heads read natively, f32 inputs or bf16
// inputs, f32 online softmax and accumulation, output in the input type.
//
// Replaces the Pallas TPU kernel of the reference package:
//   * flash_attention_pallas  (src/repro/kernels/flash_attention.py:77)
//     -> entry flash_attention_fwd.  The reference model computes the same
//     function with blockwise_attention (src/repro/models/attention.py:99),
//     which this kernel serves in the port's attention_block.
//
// Layout: q (B, S, H, HD), k and v (B, S, KV, HD), out (B, S, H, HD), all
// contiguous; query head h reads KV head h / (H / KV) in place (no repeat).
// Keep key kp for query qp iff kp <= qp or both lie in the prefix, qp < P
// and kp < P (causal; P = 0 for none), and kp > qp - window (when a window
// is given) -- the predicate of _mask_block (attention.py:83).  Under the
// causal mask a query keeps every key up to key_limit(qp): qp, or P - 1
// inside the prefix.  That limit never falls as qp grows, so the live key
// tiles of a block, the tiles a warp skips and the tiles it masks all
// follow from the limits of its first and last rows, as they follow from
// the diagonal without a prefix; a query tile inside the prefix visits
// every key tile of the prefix.
//
// Head dims 32, 64, 80, 96, 128 and 256.
//
// Bound on the card: 4 * B * H * HD * (kept query-key pairs, the prefix's
// square included) FLOPs (two products) against reading q, k, v once and
// writing out once.  At S = 4096
// it is FLOP-bound by far (~0.69 TFLOP per danube layer at B = 8).  The
// entry takes one of two kernels by the input type:
//
// bf16 -> flash_attention_bf16_mma, on the bf16 tensor cores
// (mma.sync.m16n8k16, the FlashAttention-2 design):
//   * one block of 8 warps per (query tile of 128 rows, head, batch); each
//     warp owns one m16 strip of 16 query rows.  The grid puts the query
//     tile in its slowest dimension, last tile first, so the long causal
//     rows of every head start first;
//   * the Q tile is copied once by cp.async into bf16 shared memory and
//     brought into registers by ldmatrix.x4 as A fragments (HD / 16 k16
//     steps), held for the whole key loop -- up to head dim 128.  At 256
//     the O accumulators alone take 128 registers a thread and the 64 of
//     Q's fragments would spill, so each k16 step re-reads its fragment
//     from the Q tile by ldmatrix (Q_IN_REGS);
//   * 64-key K and V tiles live in bf16 shared memory in a double-buffered
//     ring filled by cp.async.cg (16 bytes a thread, rows past S zero-filled
//     by src-size 0): the copies of tile j + 1 are issued before the math on
//     tile j, behind one __syncthreads per tile.  Rows lie HD + 8 elements
//     apart, so the eight 16-byte row addresses of an ldmatrix phase fall
//     on distinct bank groups for every head dim;
//   * S = Q K^T: K's B fragments by ldmatrix (K is [key][hd], which is the
//     col-major B the instruction takes), 8 n8 tiles per 64 keys;
//   * the online softmax runs on the accumulator registers: thread t holds
//     rows t/4 and t/4 + 8 of its strip and columns 2 (t%4), 2 (t%4) + 1 of
//     each n8 tile; row maxima are reduced over the quad by shuffles, p =
//     exp2(s * scale * log2 e - m) with m in the same units; a row with no
//     kept key so far keeps m = -inf and adds nothing.  l is summed from
//     the f32 p, as the reference does (attention.py:154);
//   * P V with P in registers: the accumulators of two neighbouring m16n8
//     tiles are the A fragment of one m16k16 tile, so p is packed to bf16
//     in place and fed to the second mma.sync; V's B fragments by
//     ldmatrix.trans from the same [key][hd] tile; O (HD / 8 n8 tiles) is
//     rescaled by alpha in registers.  p goes in as two bf16 terms, hi =
//     bf16(p) and lo = bf16(p - hi), two products per V fragment, so P
//     keeps about 16 bits: one bf16 rounding of p (the reference's
//     p.astype(v.dtype), attention.py:155) moves an output by up to
//     2^-8 (p / l) |v|, past the bf16 tolerance (1e-3 + 1e-2 |x|) against
//     the f32 softmax wherever a few keys carry the row;
//   * the mask predicate is evaluated only on the tiles a warp's rows cut
//     (the diagonal or the prefix's edge, the window's lower edge, keys
//     past S); a warp skips
//     the math of tiles wholly masked for its rows, and key tiles wholly
//     above the block's diagonal or before its window are never loaded;
//   * O / l is rounded to bf16, staged through the warp's rows of the Q
//     tile and written with coalesced 16-byte stores; rows past S are not
//     written.
//
// f32 -> flash_attention_kernel, on the fp32 FMA pipes (tensor cores with
// bf16 or TF32 operands would not keep the f32 path's 1e-4 exactness):
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
//     leaves the thread.  p stays f32;
//   * K tiles wholly above the diagonal (past key_limit of the tile's last
//     row) or wholly outside the window are never loaded; rows and keys
//     past S are masked (any S is taken).

#include <math.h>

#include "attention_common.cuh"

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per staged tile
constexpr int THREADS = 128;
constexpr int TS = BQ + 4;     // row stride of the transposed Q, K, P tiles
static_assert(BQ == BK, "Q and K tiles share the transposed row stride");

// The last key query qp keeps under the causal mask, before the window:
// qp, or the prefix's last key P - 1 for a query inside the prefix.
__device__ __forceinline__ int key_limit(int qp, int prefix) {
  return qp < prefix ? prefix - 1 : qp;
}

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
                       int h, int kvh, int causal, int window, int prefix,
                       float scale) {
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

  // live key tiles: not wholly past the key limit of the tile's last row,
  // not wholly before the window of its first row
  const int q_last = min(q0 + BQ, s) - 1;
  int kt_end = (s + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, key_limit(q_last, prefix) / BK + 1);
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
        const bool keep = kp < s && (!causal || kp <= key_limit(qp, prefix)) &&
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
           int s, int h, int kvh, int causal, int window, int prefix,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kern = flash_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s + BQ - 1) / BQ, h, b);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), s, h, kvh, causal,
      window, prefix, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* out,
             int b, int s, int h, int kvh, int causal, int window, int prefix,
             float scale, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, out, b, s, h, kvh, causal, window, prefix, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, b, s, h, kvh, causal, window, prefix, scale, stream);
    case 80: return launch<T, 80>(q, k, v, out, b, s, h, kvh, causal, window, prefix, scale, stream);
    case 96: return launch<T, 96>(q, k, v, out, b, s, h, kvh, causal, window, prefix, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, b, s, h, kvh, causal, window, prefix, scale, stream);
    case 256: return launch<T, 256>(q, k, v, out, b, s, h, kvh, causal, window, prefix, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;   // query rows per block, 16 per warp
constexpr int BK = 64;           // keys per K / V tile

// Shared memory of one block: the Q tile and two K and two V tiles, rows
// HD + 8 elements apart.
template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * (BQ + 4 * BK) * (HD + 8);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zeros when !valid
// (src-size 0: nothing is read from src).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a b for a 16x16 bf16 A fragment, a 16x8 bf16 B fragment (b0, b1)
// and a 16x8 f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the special-function unit (relative error about 2^-22; results
// below 2^-126 flush to 0, and 2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to bf16 in one register, x0 in the low half (the
// lower column of a fragment).
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// Two floats as two bf16 terms each, x = hi + lo to about 2^-17 |x|: hi
// is x rounded to bf16, lo the remainder (exact in f32) rounded to bf16.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// Start copying rows pos0 .. pos0 + ROWS - 1 of a (rows x HD) matrix whose
// rows lie `row_stride` elements apart into dst[row * (HD + 8) + d]; rows
// at or past `limit` are zero-filled.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile_async(const bf16* __restrict__ src,
                                                int64_t row_stride, int pos0,
                                                int limit, bf16* dst) {
  constexpr int CPR = HD / 8;   // 16-byte chunks per row
#pragma unroll
  for (int e = threadIdx.x; e < ROWS * CPR; e += THREADS) {
    const int row = e / CPR;
    const int col = (e % CPR) * 8;
    const int pos = pos0 + row;
    const bool valid = pos < limit;
    cp_async16(smem_addr(dst + row * (HD + 8) + col),
               src + (valid ? pos * row_stride + col : 0), valid);
  }
}

template <int HD, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_attention_bf16_mma(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ out,
                         int s, int h, int kvh, int causal, int window,
                         int prefix, float scale_log2) {
  constexpr int LD = HD + 8;     // row stride of every shared tile
  constexpr int KSTEPS = HD / 16;
  constexpr int NT = HD / 8;     // n8 tiles of O
  // Q's A fragments held in registers for the whole key loop, or re-read
  // from the Q tile at each k16 step (where they and O would not fit)
  constexpr bool Q_IN_REGS = HD <= 128;
  static_assert(KSTEPS * 16 == HD, "head_dim must be a multiple of 16");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][LD]
  bf16* ks = qs + BQ * LD;                         // [2][BK][LD]
  bf16* vs = ks + 2 * BK * LD;                     // [2][BK][LD]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;       // fragment row (and row + 8)
  const int t = lane & 3;        // fragment column pair
  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int qw = q0 + 16 * warp;   // the warp's first query row
  const int kv_head = head / (h / kvh);
  const int64_t q_row = (int64_t)h * HD;
  const int64_t kv_row = (int64_t)kvh * HD;
  const bf16* qb = q + ((int64_t)b * s * h + head) * HD;
  const bf16* kb = k + ((int64_t)b * s * kvh + kv_head) * HD;
  const bf16* vb = v + ((int64_t)b * s * kvh + kv_head) * HD;
  bf16* ob = out + ((int64_t)b * s * h + head) * HD;

  // live key tiles: not wholly past the key limit of the block's last row,
  // not wholly before the window of its first row
  const int q_last = min(q0 + BQ, s) - 1;
  int kt_end = (s + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, key_limit(q_last, prefix) / BK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;

  load_tile_async<HD, BQ>(qb, q_row, q0, s, qs);
  cp_async_commit();
  load_tile_async<HD, BK>(kb, kv_row, kt_begin * BK, s, ks);
  load_tile_async<HD, BK>(vb, kv_row, kt_begin * BK, s, vs);
  cp_async_commit();
  cp_async_wait<1>();   // the Q tile is in
  __syncthreads();

  // Q's A fragments: ldmatrix.x4 matrices (rows 0-7, 8-15) x (cols 0-7,
  // 8-15) of each k16 step; lane l gives the address of row l % 16,
  // column 8 (l / 16)
  const uint32_t qbase =
      smem_addr(qs + (16 * warp + (lane & 15)) * LD + (lane >> 4) * 8);
  uint32_t qf[Q_IN_REGS ? KSTEPS : 1][4];
  if constexpr (Q_IN_REGS) {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) ldmatrix_x4(qf[kk], qbase + kk * 32);
  }

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // rows g and g + 8, log2 units
  float l[2] = {0.f, 0.f};               // this thread's columns only

  // ldmatrix addresses within a tile.  K (non-transposed): matrices
  // (keys 0-7, hd 0-7), (keys 0-7, hd 8-15), (keys 8-15, hd 0-7), (keys
  // 8-15, hd 8-15) give b0, b1 of two n8 key tiles.  V (transposed):
  // (keys 0-7, hd 0-7), (keys 8-15, hd 0-7), (keys 0-7, hd 8-15), (keys
  // 8-15, hd 8-15) give b0, b1 of two n8 hd tiles.
  const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * LD +
                    ((lane >> 3) & 1) * 8;
  const int v_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD +
                    (lane >> 4) * 8;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    cp_async_wait<0>();   // tile kt is in
    __syncthreads();      // ... for every thread; the other buffer is free
    if (kt + 1 < kt_end) {
      load_tile_async<HD, BK>(kb, kv_row, (kt + 1) * BK, s,
                              ks + (buf ^ 1) * BK * LD);
      load_tile_async<HD, BK>(vb, kv_row, (kt + 1) * BK, s,
                              vs + (buf ^ 1) * BK * LD);
    }
    cp_async_commit();

    const int k0 = kt * BK;
    // tiles wholly masked for this warp's rows (or a warp past S)
    if (qw >= s || (causal && k0 > key_limit(qw + 15, prefix)) ||
        (window > 0 && k0 + BK - 1 <= qw - window))
      continue;

    // S = Q K^T: 8 n8 tiles of 64 keys
    float sc[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    const uint32_t kaddr = smem_addr(ks + buf * BK * LD + k_off);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t qa[4];
      if constexpr (Q_IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      } else {
        ldmatrix_x4(qa, qbase + kk * 32);
      }
#pragma unroll
      for (int jp = 0; jp < BK / 16; ++jp) {
        uint32_t bf[4];
        ldmatrix_x4(bf, kaddr + (jp * 16 * LD + kk * 16) * 2);
        mma_bf16(sc[2 * jp], qa, bf[0], bf[1]);
        mma_bf16(sc[2 * jp + 1], qa, bf[2], bf[3]);
      }
    }

    // the mask, on tiles the warp's rows cut only
    const bool interior = k0 + BK <= s &&
                          (!causal || k0 + BK - 1 <= key_limit(qw, prefix)) &&
                          (window <= 0 || k0 > qw + 15 - window);
    if (!interior) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * j + 2 * t + (e & 1);
          const int qp = qw + g + 8 * (e >> 1);
          const bool keep = kp < s &&
                            (!causal || kp <= key_limit(qp, prefix)) &&
                            (window <= 0 || kp > qp - window);
          if (!keep) sc[j][e] = -INFINITY;
        }
    }

    // online softmax on the accumulators: rows g (e = 0, 1), g + 8 (2, 3)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[j][0], sc[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[j][2], sc[j][3]));
    }
    float alpha[2], neg_m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = attn::group_max<4>(mx[r]);
      const float m_new = fmaxf(m[r], mx[r] * scale_log2);
      // a row with no kept key yet keeps m = -inf: its p = exp2(-inf) = 0
      // and alpha = 0 leave its zero state as it is
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = exp2_approx(m[r] - m_use);
      m[r] = m_new;
      neg_m[r] = -m_use;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = exp2_approx(fmaf(sc[j][e], scale_log2, neg_m[e >> 1]));
        rs[e >> 1] += sc[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V with P from the accumulators, in registers, as two bf16
    // terms (hi + lo): two products a V fragment
    const uint32_t vaddr = smem_addr(vs + buf * BK * LD + v_off);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(sc[2 * kk][0], sc[2 * kk][1], hi[0], lo[0]);
      split_bf16(sc[2 * kk][2], sc[2 * kk][3], hi[1], lo[1]);
      split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vaddr + (kk * 16 * LD + np * 16) * 2);
        mma_bf16(o[2 * np], lo, bf[0], bf[1]);
        mma_bf16(o[2 * np], hi, bf[0], bf[1]);
        mma_bf16(o[2 * np + 1], lo, bf[2], bf[3]);
        mma_bf16(o[2 * np + 1], hi, bf[2], bf[3]);
      }
    }
  }

  // epilogue: O / l in bf16 through the warp's own rows of the Q tile
  // (read only by this warp, before the loop), then 16-byte stores
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    inv[r] = 1.f / fmaxf(attn::group_sum<4>(l[r]), 1e-30f);
  bf16* os = qs + 16 * warp * LD;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<uint32_t*>(os + g * LD + 8 * n + 2 * t) =
        pack_bf16(o[n][0] * inv[0], o[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(os + (g + 8) * LD + 8 * n + 2 * t) =
        pack_bf16(o[n][2] * inv[1], o[n][3] * inv[1]);
  }
  __syncwarp();
#pragma unroll
  for (int e = lane; e < 16 * NT; e += 32) {
    const int row = e / NT;
    const int col = (e % NT) * 8;
    if (qw + row < s)
      *reinterpret_cast<uint4*>(ob + (qw + row) * q_row + col) =
          *reinterpret_cast<const uint4*>(os + row * LD + col);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int s, int h, int kvh, int causal, int window, int prefix,
           float scale, cudaStream_t stream) {
  // two blocks an SM (at most 128 registers a thread) where the Q, S and
  // O fragments fit; one above (at head dim 256 shared memory holds one)
  constexpr int MIN_BLOCKS = HD <= 80 ? 2 : 1;
  constexpr size_t smem = smem_bytes<HD>();
  auto kern = flash_attention_bf16_mma<HD, MIN_BLOCKS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(h, b, (s + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), s, h, kvh,
      causal, window, prefix, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

int dispatch(int hd, const void* q, const void* k, const void* v, void* out,
             int b, int s, int h, int kvh, int causal, int window, int prefix,
             float scale, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<32>(q, k, v, out, b, s, h, kvh, causal, window, prefix, scale, stream);
    case 64: return launch<64>(q, k, v, out, b, s, h, kvh, causal, window, prefix, scale, stream);
    case 80: return launch<80>(q, k, v, out, b, s, h, kvh, causal, window, prefix, scale, stream);
    case 96: return launch<96>(q, k, v, out, b, s, h, kvh, causal, window, prefix, scale, stream);
    case 128: return launch<128>(q, k, v, out, b, s, h, kvh, causal, window, prefix, scale, stream);
    case 256: return launch<256>(q, k, v, out, b, s, h, kvh, causal, window, prefix, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// out = softmax(q k^T * scale, masked) v for q (b, s, h, hd), k and v
// (b, s, kvh, hd); causal 0/1, window <= 0 for none, prefix the prefix-LM
// length P (0 for none; read only when causal), bf16 1 for bfloat16
// tensors (0: float32).  head_dim is one of 32, 64, 80, 96, 128, 256.
// Launched on `stream`; returns the launch's cudaError_t (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int b, int s,
                                   int h, int kvh, int hd, int causal,
                                   int window, int prefix, int bf16,
                                   float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (prefix < 0) return (int)cudaErrorInvalidValue;
  if (bf16)
    return tc::dispatch(hd, q, k, v, out, b, s, h, kvh, causal, window,
                        prefix, scale, st);
  return dispatch<float>(hd, q, k, v, out, b, s, h, kvh, causal, window,
                         prefix, scale, st);
}
