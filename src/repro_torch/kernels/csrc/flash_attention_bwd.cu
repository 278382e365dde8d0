// Flash attention backward for Hopper (sm_90a): the gradients dQ, dK and
// dV of flash_attention_fwd's function (causal, prefix-LM or full softmax
// attention with an optional sliding window, grouped-query heads), for f32
// or bf16 inputs, gradients written in the inputs' type.
//
// It replaces no Pallas kernel: the reference trains through
// blockwise_attention (src/repro/models/attention.py:99), which XLA
// differentiates; its Pallas forward (flash_attention_pallas,
// src/repro/kernels/flash_attention.py:77) has no backward.  The port's
// attention_block runs the flash kernel, so its training path needs this
// one (entries flash_attention_bwd and flash_attention_bwd_split, bound
// by kernels/flash_attention.py's FlashAttention autograd Function).
//
// Layout: q, out, dout, dq (B, S, H, HD); k, v, dk, dv (B, S, KV, HD), all
// contiguous; lse and delta (B, H, S) f32.  lse is the forward's row
// log-sum-exp of the scaled scores (flash_attention_fwd_lse), so P = exp(S
// * scale - lse) is recomputed exactly, with masked entries set to 0 (and
// every entry of a row that keeps no key, whose lse is infinite).  The
// mask is the forward's: keep key kp for query qp iff kp <= key_limit(qp)
// (qp, or P - 1 inside a prefix of P) under the causal mask, and kp > qp -
// window when a window is given.
//
// The standard two-pass backward, deterministic and without atomics (the
// repo's convention, as dual_matmul's fixed-order partials): a dQ kernel
// that first writes each row's delta = rowsum(dO * O) in f32, then walks
// the key tiles its rows see and sums dQ += dS K, dS = P (dP - delta)
// scale, dP = dO V^T; then a dK / dV kernel, one block per key tile, KV
// head and batch, that walks the g = H / KV query heads of its group and,
// for each, the query tiles that see one of its keys -- from the tile's
// first key (or from 0 when it starts inside the prefix, which every query
// sees, or without the causal mask) up to its last key + window -- and
// sums dV += P^T dO and dK += dS^T Q: the GQA sum happens inside the
// block.  Each kernel recomputes S (and dP) itself.
//
// Bound on the card: 10 B H HD (kept pairs) FLOPs (the five products the
// gradients need), and the bytes of q, k, v, out, dout and lse read once
// and dq, dk, dv written once: at danube's training shape (B = 4, S =
// 4096, H = 32, KV = 8, HD = 80) FLOP-bound by far.
//
// bf16 -> flash_bwd_dq_mma, flash_bwd_dkdv_mma (namespace tc), a
// FlashAttention-2 backward on the bf16 tensor cores (mma.sync.m16n8k16,
// f32 accumulators), built on the forward's helpers (attention_common.cuh):
//   * operands stay bf16 in shared memory, rows HD + 8 elements apart (the
//     eight 16-byte rows of an ldmatrix phase on distinct bank groups),
//     filled by cp.async.cg in double-buffered rings (rows past S zero-
//     filled by src-size 0): the copies of the next K / V tile (dQ) or of
//     the next query tile's Q, dO, lse and delta (dK / dV) are issued
//     before the math on the current one, behind one __syncthreads a tile;
//   * dQ kernel: 4 warps, each on an m16 strip of 16 query rows (64 rows a
//     block; query tiles launched last-first, so long causal rows start
//     first).  Q and dO are A fragments, re-read by ldmatrix at each k16
//     step (held in registers they cost more in occupancy than they
//     save); S = Q K^T and dP = dO V^T take K and V as B fragments by
//     ldmatrix; P and dS stay in the accumulator registers, each lane
//     holding rows g, g + 8 of its strip (their lse and delta in
//     registers); two neighbouring m16n8 accumulators make one m16k16 A
//     fragment, and dQ += dS K takes K as B fragments by ldmatrix.trans
//     from the same [key][hd] tile;
//   * dK / dV kernel: each warp owns an m16 strip of 16 keys (64 keys a
//     block).  S^T = K Q^T and dP^T = V dO^T take K and V as A fragments
//     (in registers up to head dim 80, else re-read by ldmatrix) and Q and
//     dO as B fragments by ldmatrix; P^T = exp2(S^T scale log2 e - lse2)
//     and dS^T = P^T (dP^T - delta) scale stay in the accumulators, each
//     lane reading lse and delta of its query columns from the ring's
//     small arrays; dV += P^T dO and dK += dS^T Q take dO and Q by
//     ldmatrix.trans.  dK and dV sum in f32 registers over the group's
//     heads and query tiles and are rounded to bf16 once.  (Both kernels
//     carry dS / scale and scale dQ and dK once at the end: one multiply
//     fewer an element.)  At head dim
//     256 their accumulators (256 registers a thread for a 16-key strip)
//     do not fit, so two warps share a strip, each holding half its head
//     dim columns, and both compute its S^T and dP^T;
//   * P and dS go into the products as two bf16 terms, hi = bf16(x) and
//     lo = bf16(x - hi) (about 17 bits), two products each, as the
//     forward's P: one bf16 rounding would move dV and dK by up to 2^-8
//     sum |P| |dO| (and |dS| |Q|), which the bound the card holds K1 to
//     (tests/flash_bounds.py: f32 arithmetic on the same bf16 values) does
//     not admit.  dO, Q, K and V are exact bf16 and go in as they are;
//     products of bf16 values are exact in the f32 accumulators;
//   * the mask predicate is evaluated only on tiles a warp's strip cuts;
//     a warp skips the math of tiles wholly masked for its strip, and key
//     tiles wholly outside a dQ block's rows are never loaded;
//   * small grids: where a plan is given (flash_attention_bwd_split; the
//     binding makes one when KV x B x key tiles is under two blocks an SM,
//     kernels/flash_attention.py's bwd_split_plan), each dK / dV block
//     takes a contiguous share of its key tile's (head, query tile) walk,
//     shares balanced by kept pairs and longest first, writes f32 partial
//     dK / dV to a workspace, and flash_bwd_dkdv_sum, a programmatic
//     dependent launch, sums each key tile's partials in split order and
//     rounds them to bf16: the same bits from call to call.
//   Work issued: S and dP in both kernels and two products for each of
//   dV, dK and dQ, 10 bf16 product units against the 5 of the bound.
//
// f32 -> flash_bwd_dq_3xtf32, flash_bwd_dkdv_3xtf32 (namespace tf32x3),
// the same backward on the TF32 tensor cores with split operands, as the
// forward's flash_attention_3xtf32: every operand x goes into
// mma.sync.m16n8k8 as big = x rounded to TF32 and small = x - big, three
// products small.big + big.small + big.big (attention_common.cuh's
// split_tf32 and mma_split), about 21 bits of each operand; one TF32
// product moves dq, dk or dv past the f32 path's 2e-4:
//   * the five products: S = Q K^T and dP = dO V^T (recomputed in both
//     kernels), dQ += dS K, dV += P^T dO and dK += dS^T Q; P and dS are
//     split in the accumulators' registers, as the forward splits P.  Runs
//     of k8 steps are summed from zero in the accumulator, then added into
//     S and dP (half the head dim, at most 8 steps) or dQ, dK and dV (2
//     steps) by FADD: the accumulator's own sums are less exact;
//   * operands stay f32 in shared memory, rows HD + 4 floats apart, read
//     by scalar loads: a strip's A fragments (rows g, g + 8, columns t, t
//     + 4), the first products' B pairs (row g, columns t, t + 4) and the
//     second products' B pairs across rows (rows 2t, 2t + 1, column g;
//     TF32 has no ldmatrix.trans) all fall on distinct banks at every head
//     dim.  The second products take the first's accumulators as their A
//     fragments in place, the k index a permutation of the columns (k = t
//     <-> 2t, k = t + 4 <-> 2t + 1), and read B at the same rows;
//   * each lane splits the fragments it reads, in registers (3
//     instructions an element: the splits are most of what is issued);
//   * blocks of 8 warps, 4 strips of 16 rows, two warps a strip.  dQ
//     kernel: query strips, each warp on one half of the keys of every K /
//     V tile (a double-buffered cp.async ring), the halves' dQ summed at
//     the end through shared memory.  dK / dV kernel: key strips, each
//     warp on one half of the rows of every query tile (Q, dO, lse and
//     delta in a double-buffered ring), the halves' dK and dV summed at the
//     end; at head dim 256 each warp on all the rows and one half of the
//     strip's dK and dV columns (their 256 registers a thread would not
//     fit), both computing its S^T and dP^T.  Tiles by head dim (DqPlan,
//     DkvPlan) fit one block an SM in shared memory;
//   * small grids split as for bf16 (the same plans, made for f32's
//     tiles), the partials summed in f32 by tf32x3::flash_bwd_dkdv_sum.
//   Work issued: S and dP in both kernels and dV, dK and dQ, three TF32
//   products each, 21 product units against the 5 of the bound (f32 at
//   495 / 3 TFLOP/s).

#include <math.h>

#include "attention_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

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

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// 4 bytes from global to shared memory, asynchronously; zero when !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// Start copying src[pos0 .. pos0 + N - 1] (f32 row statistics) into dst;
// entries at or past `limit` are zero-filled.
template <int N, int THREADS>
__device__ __forceinline__ void load_rows_async(const float* __restrict__ src,
                                                int pos0, int limit,
                                                float* dst) {
  for (int r = threadIdx.x; r < N; r += THREADS) {
    const bool valid = pos0 + r < limit;
    cp_async4(attn::smem_addr(dst + r), src + (valid ? pos0 + r : 0), valid);
  }
}

// A K1 call: operands of type T, the shape and mask, and a split plan
// (flash_attention_bwd_split) or none.
template <typename T>
struct Args {
  const T *q, *k, *v, *out, *dout;
  const float* lse;
  float* delta;
  T *dq, *dk, *dv;
  int b, s, h, kvh, causal, window, prefix;
  float scale;
  const int* plan;   // null: no split
  int nplan;
  float* ws;
  cudaStream_t stream;
};

// K1's launches on a.stream: the dQ kernel kq (grid H x B x query tiles of
// Q::BQ rows), the dK / dV kernel kkv (KV x B x key tiles of KV::BK keys,
// or x plan entries) and, with a plan, ksum (KV x B x SUM_PARTS blocks of
// SUM_THREADS threads a key tile), which sums the partials, as a
// programmatic dependent launch.  Returns the first failing launch's
// cudaError_t.
template <typename Q, typename KV, int SUM_THREADS, int SUM_PARTS,
          typename T, typename KQ, typename KKV, typename KSUM>
int launch_k1(const Args<T>& a, KQ kq, KKV kkv, KSUM ksum) {
  cudaError_t err = allow_smem(kq, Q::SMEM);
  if (err == cudaSuccess) err = allow_smem(kkv, KV::SMEM);
  if (err != cudaSuccess) return (int)err;
  kq<<<dim3(a.h, a.b, (a.s + Q::BQ - 1) / Q::BQ), Q::THREADS, Q::SMEM,
       a.stream>>>(a.q, a.k, a.v, a.out, a.dout, a.lse, a.delta, a.dq, a.s,
                   a.h, a.kvh, a.causal, a.window, a.prefix, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.s + KV::BK - 1) / KV::BK;
  kkv<<<dim3(a.kvh, a.b, a.plan ? a.nplan : tiles), KV::THREADS, KV::SMEM,
        a.stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dk, a.dv,
                    reinterpret_cast<const int4*>(a.plan), a.ws, a.s, a.h,
                    a.kvh, a.causal, a.window, a.prefix, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.plan == nullptr) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.kvh, a.b, tiles * SUM_PARTS);
  cfg.blockDim = dim3(SUM_THREADS);
  cfg.stream = a.stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, ksum, (const float*)a.ws,
                                 a.plan + 4 * a.nplan, a.dk, a.dv, a.s,
                                 a.kvh);
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels

namespace tc {

using attn::cp_async16;
using attn::cp_async_commit;
using attn::cp_async_wait;
using attn::exp2_approx;
using attn::ldmatrix_x4;
using attn::ldmatrix_x4_trans;
using attn::mma_bf16;
using attn::pack_bf16;
using attn::smem_addr;
using attn::split_bf16;

// The dQ kernel's geometry: WARPS strips of 16 query rows, key tiles of BK.
template <int HD>
struct DqPlan {
  static constexpr int WARPS = 4;
  static constexpr int THREADS = 32 * WARPS;
  // blocks an SM ptxas must fit where shared memory holds them: 3 at
  // head dim 80 (168 registers, no spill; on an H100 8 % faster at
  // danube's training shape than 2), 4 below (128; 6 % faster at
  // zamba2's hd 64 than 3)
  static constexpr int MIN_BLOCKS = HD <= 64 ? 4 : HD <= 80 ? 3 : 1;
  static constexpr int BQ = 16 * WARPS;
  static constexpr int BK = HD <= 128 ? 64 : 32;
  static constexpr int LD = HD + 8;
  // the Q and dO tiles, two K and two V tiles
  static constexpr size_t SMEM = sizeof(bf16) * (2 * BQ + 4 * BK) * LD;
};

// The dK / dV kernel's geometry: STRIPS strips of 16 keys, HSPLIT warps a
// strip (each holding HD / HSPLIT columns of its dK and dV), query tiles
// of BQ rows in the walk.  kernels/flash_attention.py's BWD_TILES mirrors
// (BK, BQ); flash_attention_bwd_split refuses a plan made for others.
template <int HD>
struct DkvPlan {
  static constexpr int STRIPS = 4;
  static constexpr int HSPLIT = HD <= 128 ? 1 : 2;
  static constexpr int WARPS = STRIPS * HSPLIT;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BK = 16 * STRIPS;
  static constexpr int BQ = HD <= 80 ? 64 : 32;
  static constexpr int HDW = HD / HSPLIT;
  static constexpr int LD = HD + 8;
  // K's and V's A fragments held in registers for the whole walk
  static constexpr bool IN_REGS = HD <= 80;
  // the K and V tiles, two Q and two dO tiles, two lse and two delta rows
  static constexpr size_t SMEM =
      sizeof(bf16) * (2 * BK + 4 * BQ) * LD + sizeof(float) * 4 * BQ;
};

// Start copying rows pos0 .. pos0 + ROWS - 1 of a (rows x HD) matrix whose
// rows lie `row_stride` elements apart into dst[row * (HD + 8) + d]; rows
// at or past `limit` are zero-filled.
template <int HD, int ROWS, int THREADS>
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

// ldmatrix offsets (elements) of lane `lane` in a tile whose rows lie LD
// apart.  A fragments of a strip: rows (lane % 16), column 8 (lane / 16);
// B fragments of an [n][k] tile (non-transposed): matrices (n 0-7, k 0-7),
// (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15) give b0, b1 of two
// n8 tiles; of a [k][n] tile (transposed): (k 0-7, n 0-7), (k 8-15, n
// 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15).
template <int LD>
__device__ __forceinline__ int a_off(int lane) {
  return (lane & 15) * LD + (lane >> 4) * 8;
}
template <int LD>
__device__ __forceinline__ int b_off(int lane) {
  return ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
}
template <int LD>
__device__ __forceinline__ int bt_off(int lane) {
  return ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + (lane >> 4) * 8;
}

// The A fragments of two neighbouring m16n8 accumulators (k = 16 columns)
// as two bf16 terms, hi + lo.
__device__ __forceinline__ void split_frag(const float (&c0)[4],
                                           const float (&c1)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split_bf16(c0[0], c0[1], hi[0], lo[0]);
  split_bf16(c0[2], c0[3], hi[1], lo[1]);
  split_bf16(c1[0], c1[1], hi[2], lo[2]);
  split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

// c0 += a b0, c1 += a b1 for a split A (hi + lo) and the B fragments of two
// n8 tiles (bf[0], bf[1]) and (bf[2], bf[3]): the small term first.
__device__ __forceinline__ void mma_split(float (&c0)[4], float (&c1)[4],
                                          const uint32_t (&hi)[4],
                                          const uint32_t (&lo)[4],
                                          const uint32_t (&bf)[4]) {
  mma_bf16(c0, lo, bf[0], bf[1]);
  mma_bf16(c0, hi, bf[0], bf[1]);
  mma_bf16(c1, lo, bf[2], bf[3]);
  mma_bf16(c1, hi, bf[2], bf[3]);
}

// dQ, and delta for the dK / dV kernel.  Grid (H, B, query tiles).
template <int HD>
__global__ void __launch_bounds__(DqPlan<HD>::THREADS,
                                  DqPlan<HD>::MIN_BLOCKS)
flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ out,
                 const bf16* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ delta,
                 bf16* __restrict__ dq, int s, int h, int kvh, int causal,
                 int window, int prefix, float scale) {
  using P = DqPlan<HD>;
  constexpr int BQ = P::BQ, BK = P::BK, LD = P::LD, THREADS = P::THREADS;
  constexpr int KSTEPS = HD / 16;   // k16 steps of S and dP
  constexpr int NT = HD / 8;        // n8 tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][LD]
  bf16* dos = qs + BQ * LD;                        // [BQ][LD]
  bf16* ks = dos + BQ * LD;                        // [2][BK][LD]
  bf16* vs = ks + 2 * BK * LD;                     // [2][BK][LD]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int head = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // long rows first
  const int qw = q0 + 16 * warp;                      // the warp's strip
  const int kv_head = head / (h / kvh);
  const int64_t q_row = (int64_t)h * HD, kv_row = (int64_t)kvh * HD;
  const int64_t qoff = ((int64_t)b * s * h + head) * HD;
  const bf16* kb = k + ((int64_t)b * s * kvh + kv_head) * HD;
  const bf16* vb = v + ((int64_t)b * s * kvh + kv_head) * HD;
  const int64_t rowstat = ((int64_t)b * h + head) * s;   // lse, delta
  const float scale_log2 = scale * LOG2E;

  // the live key tiles: the forward's
  const int q_last = min(q0 + BQ, s) - 1;
  int kt_end = (s + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, key_limit(q_last, prefix) / BK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;

  load_tile_async<HD, BQ, THREADS>(q + qoff, q_row, q0, s, qs);
  load_tile_async<HD, BQ, THREADS>(dout + qoff, q_row, q0, s, dos);
  cp_async_commit();
  load_tile_async<HD, BK, THREADS>(kb, kv_row, kt_begin * BK, s, ks);
  load_tile_async<HD, BK, THREADS>(vb, kv_row, kt_begin * BK, s, vs);
  cp_async_commit();
  cp_async_wait<1>();   // Q and dO are in
  __syncthreads();

  // delta = rowsum(dO * O) of the warp's rows in f32; lane keeps rows g
  // and g + 8's, with their lse in log2 units (+inf past S, so that p =
  // 0 there; a row inside S keeps its own key, so its lse is finite)
  float dl[2] = {0.f, 0.f}, l2[2];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int pos = qw + r;
    float acc = 0.f;
    if (pos < s) {
      const __nv_bfloat162* orow =
          reinterpret_cast<const __nv_bfloat162*>(out + qoff + pos * q_row);
      const __nv_bfloat162* drow = reinterpret_cast<const __nv_bfloat162*>(
          dos + (16 * warp + r) * LD);
      for (int c = lane; c < HD / 2; c += 32) {
        const float2 o2 = __bfloat1622float2(orow[c]);
        const float2 d2 = __bfloat1622float2(drow[c]);
        acc = fmaf(d2.y, o2.y, fmaf(d2.x, o2.x, acc));
      }
    }
    acc = attn::group_sum<32>(acc);
    if (lane == 0 && pos < s) delta[rowstat + pos] = acc;
    if (r == g) dl[0] = acc;
    if (r == g + 8) dl[1] = acc;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pos = qw + g + 8 * i;
    l2[i] = pos < s ? lse[rowstat + pos] * LOG2E : INFINITY;
  }

  // Q's and dO's A fragments, re-read by ldmatrix at each k16 step (held
  // in registers they cost more in occupancy than they save)
  const uint32_t qbase = smem_addr(qs + 16 * warp * LD + a_off<LD>(lane));
  const uint32_t dbase = smem_addr(dos + 16 * warp * LD + a_off<LD>(lane));

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    cp_async_wait<0>();   // tile kt is in
    __syncthreads();      // ... for every thread; the other buffer is free
    if (kt + 1 < kt_end) {
      load_tile_async<HD, BK, THREADS>(kb, kv_row, (kt + 1) * BK, s,
                                       ks + (buf ^ 1) * BK * LD);
      load_tile_async<HD, BK, THREADS>(vb, kv_row, (kt + 1) * BK, s,
                                       vs + (buf ^ 1) * BK * LD);
    }
    cp_async_commit();

    const int k0 = kt * BK;
    // tiles wholly masked for this warp's rows (or a warp past S)
    if (qw >= s || (causal && k0 > key_limit(qw + 15, prefix)) ||
        (window > 0 && k0 + BK - 1 <= qw - window))
      continue;

    // S = Q K^T and dP = dO V^T
    float sc[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    const uint32_t kaddr = smem_addr(ks + buf * BK * LD + b_off<LD>(lane));
    const uint32_t vaddr = smem_addr(vs + buf * BK * LD + b_off<LD>(lane));
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t qa[4], da[4];
      ldmatrix_x4(qa, qbase + kk * 32);
      ldmatrix_x4(da, dbase + kk * 32);
#pragma unroll
      for (int jp = 0; jp < BK / 16; ++jp) {
        uint32_t bf[4];
        ldmatrix_x4(bf, kaddr + (jp * 16 * LD + kk * 16) * 2);
        mma_bf16(sc[2 * jp], qa, bf[0], bf[1]);
        mma_bf16(sc[2 * jp + 1], qa, bf[2], bf[3]);
        ldmatrix_x4(bf, vaddr + (jp * 16 * LD + kk * 16) * 2);
        mma_bf16(dp[2 * jp], da, bf[0], bf[1]);
        mma_bf16(dp[2 * jp + 1], da, bf[2], bf[3]);
      }
    }

    // P and dS / scale on the accumulators: rows g (e = 0, 1), g + 8 (2,
    // 3); the mask on tiles the warp's rows cut only (a select, so that a
    // masked entry's exp never reaches dS)
    const bool interior = k0 + BK <= s &&
                          (!causal || k0 + BK - 1 <= key_limit(qw, prefix)) &&
                          (window <= 0 || k0 > qw + 15 - window);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_approx(fmaf(sc[j][e], scale_log2, -l2[e >> 1]));
        if (!interior &&
            !kept(qw + g + 8 * (e >> 1), k0 + 8 * j + 2 * t + (e & 1), s,
                  causal, window, prefix))
          p = 0.f;
        sc[j][e] = p * (dp[j][e] - dl[e >> 1]);
      }

    // dQ / scale += (dS / scale) K, dS as two bf16 terms, K by
    // ldmatrix.trans
    const uint32_t ktaddr = smem_addr(ks + buf * BK * LD + bt_off<LD>(lane));
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_frag(sc[2 * kk], sc[2 * kk + 1], hi, lo);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, ktaddr + (kk * 16 * LD + np * 16) * 2);
        mma_split(acc[2 * np], acc[2 * np + 1], hi, lo, bf);
      }
    }
  }

  // epilogue: dQ in bf16 through the warp's own rows of the Q tile (read
  // only by this warp), then 16-byte stores; rows past S are not written
  bf16* os = qs + 16 * warp * LD;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<uint32_t*>(os + g * LD + 8 * n + 2 * t) =
        pack_bf16(acc[n][0] * scale, acc[n][1] * scale);
    *reinterpret_cast<uint32_t*>(os + (g + 8) * LD + 8 * n + 2 * t) =
        pack_bf16(acc[n][2] * scale, acc[n][3] * scale);
  }
  __syncwarp();
#pragma unroll
  for (int e = lane; e < 16 * NT; e += 32) {
    const int row = e / NT;
    const int col = (e % NT) * 8;
    if (qw + row < s)
      *reinterpret_cast<uint4*>(dq + qoff + (qw + row) * q_row + col) =
          *reinterpret_cast<const uint4*>(os + row * LD + col);
  }
}

// dK and dV of one key tile, summed over the group's query heads.  Grid
// (KV, B, key tiles), or (KV, B, plan entries) with a plan: entry z =
// {key tile, first item, end item, workspace slot} of the tile's walk
// (item i = head i / nq of the group, query tile i % nq), and then the
// block writes f32 partials to ws[(slot, b, kv head)][dK, dV][BK][HD].
template <int HD>
__global__ void __launch_bounds__(DkvPlan<HD>::THREADS)
flash_bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, const int4* __restrict__ plan,
                   float* __restrict__ ws, int s, int h, int kvh, int causal,
                   int window, int prefix, float scale) {
  using P = DkvPlan<HD>;
  constexpr int BQ = P::BQ, BK = P::BK, LD = P::LD, THREADS = P::THREADS;
  constexpr int HDW = P::HDW;
  constexpr int KSTEPS = HD / 16;   // k16 steps of S^T and dP^T
  constexpr int NT = HDW / 8;       // n8 tiles of the warp's dK and dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // [BK][LD]
  bf16* vs = ks + BK * LD;                         // [BK][LD]
  bf16* qs = vs + BK * LD;                         // [2][BQ][LD]
  bf16* dos = qs + 2 * BQ * LD;                    // [2][BQ][LD]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BQ * LD);   // [2][BQ]
  float* dl_s = lse_s + 2 * BQ;                                  // [2][BQ]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int strip = warp % P::STRIPS;
  const int hc0 = (warp / P::STRIPS) * HDW;   // the warp's first column
  const int kv_head = blockIdx.x, b = blockIdx.y;
  const int group = h / kvh;
  int kt = blockIdx.z, i_begin = 0, i_end = -1, slot = 0;
  if (plan != nullptr) {
    const int4 e = plan[blockIdx.z];
    kt = e.x;
    i_begin = e.y;
    i_end = e.z;
    slot = e.w;
  }
  const int k0 = kt * BK;
  const int kw = k0 + 16 * strip;   // the warp's first key
  const int64_t q_row = (int64_t)h * HD, kv_row = (int64_t)kvh * HD;
  const int64_t kvoff = ((int64_t)b * s * kvh + kv_head) * HD;
  const float scale_log2 = scale * LOG2E;

  // the query rows that keep one of the tile's keys, in query tiles
  const int k_last = min(k0 + BK, s) - 1;
  const int q_begin = causal && k0 >= prefix ? k0 : 0;
  const int q_end = window > 0 ? min(s, k_last + window) : s;
  const int qt0 = q_begin / BQ;
  const int nq = (q_end + BQ - 1) / BQ - qt0;
  if (plan == nullptr) i_end = group * nq;

  // start copying item i's Q, dO, lse and delta into stage st
  auto issue = [&](int i, int st) {
    const int head = kv_head * group + i / nq;
    const int q0 = (qt0 + i % nq) * BQ;
    const int64_t qoff = ((int64_t)b * s * h + head) * HD;
    const int64_t rowstat = ((int64_t)b * h + head) * s;
    load_tile_async<HD, BQ, THREADS>(q + qoff, q_row, q0, s,
                                     qs + st * BQ * LD);
    load_tile_async<HD, BQ, THREADS>(dout + qoff, q_row, q0, s,
                                     dos + st * BQ * LD);
    load_rows_async<BQ, THREADS>(lse + rowstat, q0, s, lse_s + st * BQ);
    load_rows_async<BQ, THREADS>(delta + rowstat, q0, s, dl_s + st * BQ);
  };

  load_tile_async<HD, BK, THREADS>(k + kvoff, kv_row, k0, s, ks);
  load_tile_async<HD, BK, THREADS>(v + kvoff, kv_row, k0, s, vs);
  cp_async_commit();
  if (i_begin < i_end) issue(i_begin, 0);
  cp_async_commit();
  cp_async_wait<1>();   // K and V are in
  __syncthreads();

  const uint32_t kbase = smem_addr(ks + 16 * strip * LD + a_off<LD>(lane));
  const uint32_t vbase = smem_addr(vs + 16 * strip * LD + a_off<LD>(lane));
  uint32_t kf[P::IN_REGS ? KSTEPS : 1][4], vf[P::IN_REGS ? KSTEPS : 1][4];
  if constexpr (P::IN_REGS) {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      ldmatrix_x4(kf[kk], kbase + kk * 32);
      ldmatrix_x4(vf[kk], vbase + kk * 32);
    }
  }

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int i = i_begin; i < i_end; ++i) {
    const int st = (i - i_begin) & 1;
    cp_async_wait<0>();   // item i is in
    __syncthreads();      // ... for every thread; the other stage is free
    if (i + 1 < i_end) issue(i + 1, st ^ 1);
    cp_async_commit();

    const int q0 = (qt0 + i % nq) * BQ;
    // query tiles wholly masked for this warp's keys (or a strip past S)
    if (kw >= s ||
        (causal && kw > key_limit(min(q0 + BQ, s) - 1, prefix)) ||
        (window > 0 && kw + 15 <= q0 - window))
      continue;

    // S^T = K Q^T and dP^T = V dO^T
    float sT[BQ / 8][4], dpT[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
    const uint32_t qaddr = smem_addr(qs + st * BQ * LD + b_off<LD>(lane));
    const uint32_t daddr = smem_addr(dos + st * BQ * LD + b_off<LD>(lane));
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t ka[4], va[4];
      if constexpr (P::IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ka[e] = kf[kk][e];
          va[e] = vf[kk][e];
        }
      } else {
        ldmatrix_x4(ka, kbase + kk * 32);
        ldmatrix_x4(va, vbase + kk * 32);
      }
#pragma unroll
      for (int jp = 0; jp < BQ / 16; ++jp) {
        uint32_t bf[4];
        ldmatrix_x4(bf, qaddr + (jp * 16 * LD + kk * 16) * 2);
        mma_bf16(sT[2 * jp], ka, bf[0], bf[1]);
        mma_bf16(sT[2 * jp + 1], ka, bf[2], bf[3]);
        ldmatrix_x4(bf, daddr + (jp * 16 * LD + kk * 16) * 2);
        mma_bf16(dpT[2 * jp], va, bf[0], bf[1]);
        mma_bf16(dpT[2 * jp + 1], va, bf[2], bf[3]);
      }
    }

    // P^T and dS^T / scale on the accumulators: keys g (e = 0, 1), g + 8
    // (2, 3), query columns 8 j + 2 t + (e & 1); the mask on tiles the
    // strip cuts (a select; columns past S, zero-filled, are masked there)
    const bool interior =
        kw + 15 < s && q0 + BQ <= s &&
        (!causal || kw + 15 <= key_limit(q0, prefix)) &&
        (window <= 0 || kw > q0 + BQ - 1 - window);
    const float* ls = lse_s + st * BQ;
    const float* dls = dl_s + st * BQ;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 lr = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
      const float2 dr = *reinterpret_cast<const float2*>(dls + 8 * j + 2 * t);
      const float l2[2] = {lr.x * LOG2E, lr.y * LOG2E};
      const float dl[2] = {dr.x, dr.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_approx(fmaf(sT[j][e], scale_log2, -l2[e & 1]));
        if (!interior &&
            !kept(q0 + 8 * j + 2 * t + (e & 1), kw + g + 8 * (e >> 1), s,
                  causal, window, prefix))
          p = 0.f;
        dpT[j][e] = p * (dpT[j][e] - dl[e & 1]);
        sT[j][e] = p;
      }
    }

    // dV += P^T dO and dK / scale += (dS^T / scale) Q, P^T and dS^T as
    // two bf16 terms, dO and Q by ldmatrix.trans (the warp's columns hc0
    // .. hc0 + HDW - 1)
    const uint32_t dtaddr =
        smem_addr(dos + st * BQ * LD + bt_off<LD>(lane) + hc0);
    const uint32_t qtaddr =
        smem_addr(qs + st * BQ * LD + bt_off<LD>(lane) + hc0);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      split_frag(sT[2 * kk], sT[2 * kk + 1], ph, pl);
      split_frag(dpT[2 * kk], dpT[2 * kk + 1], sh, sl);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, dtaddr + (kk * 16 * LD + np * 16) * 2);
        mma_split(dva[2 * np], dva[2 * np + 1], ph, pl, bf);
        ldmatrix_x4_trans(bf, qtaddr + (kk * 16 * LD + np * 16) * 2);
        mma_split(dka[2 * np], dka[2 * np + 1], sh, sl, bf);
      }
    }
  }

  const int r0 = 16 * strip + g;   // the lane's rows r0, r0 + 8 of the tile
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] *= scale;
  if (ws != nullptr) {
    // f32 partials, summed by flash_bwd_dkdv_sum
    float* part =
        ws + (((int64_t)slot * gridDim.y + b) * kvh + kv_head) * 2 * BK * HD;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = hc0 + 8 * n + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        *reinterpret_cast<float2*>(part + (r0 + 8 * r) * HD + col) =
            make_float2(dka[n][2 * r], dka[n][2 * r + 1]);
        *reinterpret_cast<float2*>(part + BK * HD + (r0 + 8 * r) * HD + col) =
            make_float2(dva[n][2 * r], dva[n][2 * r + 1]);
      }
    }
    return;
  }
  // bf16 through the K and V tiles (every warp is done with them), then
  // 16-byte stores; rows past S are not written
  __syncthreads();
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = hc0 + 8 * n + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      *reinterpret_cast<uint32_t*>(ks + (r0 + 8 * r) * LD + col) =
          pack_bf16(dka[n][2 * r], dka[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(vs + (r0 + 8 * r) * LD + col) =
          pack_bf16(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < BK * (HD / 8); e += THREADS) {
    const int row = e / (HD / 8);
    const int col = (e % (HD / 8)) * 8;
    const int pos = k0 + row;
    if (pos < s) {
      *reinterpret_cast<uint4*>(dk + kvoff + pos * kv_row + col) =
          *reinterpret_cast<const uint4*>(ks + row * LD + col);
      *reinterpret_cast<uint4*>(dv + kvoff + pos * kv_row + col) =
          *reinterpret_cast<const uint4*>(vs + row * LD + col);
    }
  }
}

constexpr int SUM_THREADS = 256;

// dK and dV of key tile z from its splits' f32 partials, summed in split
// order (the same bits at every call) and rounded to bf16.  Grid (KV, B,
// key tiles); tiles[2 z] is the tile's first workspace slot, tiles[2 z +
// 1] its number of slots.  Launched as a programmatic dependent of the
// dK / dV kernel: it waits here for that grid's writes.
template <int HD>
__global__ void __launch_bounds__(SUM_THREADS)
flash_bwd_dkdv_sum(const float* __restrict__ ws, const int* __restrict__ tiles,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int s,
                   int kvh) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  constexpr int BK = DkvPlan<HD>::BK;
  constexpr int Q4 = HD / 4;   // float4 columns a row
  const int kv_head = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;
  const int first = tiles[2 * kt], count = tiles[2 * kt + 1];
  const int64_t slot_stride = (int64_t)gridDim.y * kvh * 2 * BK * HD;
  const float* part =
      ws + (((int64_t)first * gridDim.y + b) * kvh + kv_head) * 2 * BK * HD;
  const int64_t kv_row = (int64_t)kvh * HD;
  const int64_t kvoff = ((int64_t)b * s * kvh + kv_head) * HD;
  for (int e = threadIdx.x; e < 2 * BK * Q4; e += SUM_THREADS) {
    const int which = e / (BK * Q4);   // 0: dK, 1: dV
    const int row = (e / Q4) % BK;
    const int col = (e % Q4) * 4;
    const int pos = kt * BK + row;
    if (pos >= s) continue;
    const float* src = part + which * BK * HD + row * HD + col;
    float4 acc = *reinterpret_cast<const float4*>(src);
    for (int sp = 1; sp < count; ++sp) {
      const float4 x =
          *reinterpret_cast<const float4*>(src + sp * slot_stride);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    uint2 packed;
    packed.x = pack_bf16(acc.x, acc.y);
    packed.y = pack_bf16(acc.z, acc.w);
    *reinterpret_cast<uint2*>((which ? dv : dk) + kvoff + pos * kv_row +
                              col) = packed;
  }
}

template <int HD>
int launch(const Args<bf16>& a) {
  return launch_k1<DqPlan<HD>, DkvPlan<HD>, SUM_THREADS, 1>(
      a, flash_bwd_dq_mma<HD>, flash_bwd_dkdv_mma<HD>, flash_bwd_dkdv_sum<HD>);
}

template <int HD>
bool takes_tiles(int bk, int bq) {
  return bk == DkvPlan<HD>::BK && bq == DkvPlan<HD>::BQ;
}

// The head dim's launch, or cudaErrorInvalidValue for a head dim the
// kernels do not take (or, with bk > 0, for dK / dV tiles (bk, bq) that
// are not its own).
int dispatch(int hd, const Args<bf16>& a, int bk, int bq) {
#define TC_CASE(D) \
  case D: return bk > 0 && !takes_tiles<D>(bk, bq) ? (int)cudaErrorInvalidValue : launch<D>(a);
  switch (hd) {
    TC_CASE(32)
    TC_CASE(64)
    TC_CASE(80)
    TC_CASE(96)
    TC_CASE(128)
    TC_CASE(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef TC_CASE
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32: the split-TF32 tensor-core kernels

namespace tf32x3 {

using attn::add4;
using attn::cp_async16;
using attn::cp_async_commit;
using attn::cp_async_wait;
using attn::exp2_approx;
using attn::mma_split;
using attn::smem_addr;
using attn::split_tf32;

constexpr int THREADS = 256;   // 8 warps: 4 strips of 16 rows, 2 warps a strip
// k8 steps over key or query rows (dQ, dK, dV) whose products a run sums
// from zero in the mma's accumulator before an FADD takes it into the
// gradient
constexpr int ROW_RUN = 2;

// The dQ kernel's geometry: 4 strips of 16 query rows, the two warps of a
// strip each on one half (BKW keys) of every K / V tile, their dQ summed at
// the end.  Tiles of BK keys; rows LD floats apart.
template <int HD>
struct DqPlan {
  static constexpr int THREADS = tf32x3::THREADS;
  static constexpr int BQ = 64;
  static constexpr int BK = HD <= 128 ? 64 : 16;
  static constexpr int BKW = BK / 2;
  static constexpr int LD = HD + 4;
  // the Q and dO tiles, two K and two V tiles, the rows' delta
  static constexpr size_t SMEM =
      sizeof(float) * ((2 * BQ + 4 * BK) * LD + BQ);
};

// The dK / dV kernel's geometry: 4 strips of 16 keys (BK = 64), two warps a
// strip, each on one half (BQW rows) of every query tile of BQ rows, their
// dK and dV summed at the end -- or, at head dim 256 (HSPLIT), each on all
// BQ rows and one half (HDW columns) of the strip's dK and dV, whose 256
// registers a thread would not fit.  kernels/flash_attention.py's
// BWD_TILES mirrors (BK, BQ); flash_attention_bwd_split refuses a plan
// made for others.
template <int HD>
struct DkvPlan {
  static constexpr int THREADS = tf32x3::THREADS;
  static constexpr int STRIPS = 4;
  static constexpr bool HSPLIT = HD > 128;
  static constexpr int BK = 16 * STRIPS;
  static constexpr int BQ = HSPLIT ? 16 : 64;
  static constexpr int BQW = HSPLIT ? BQ : BQ / 2;
  static constexpr int HDW = HSPLIT ? HD / 2 : HD;
  static constexpr int LD = HD + 4;
  // the K and V tiles, two Q and two dO tiles, two lse and two delta rows
  static constexpr size_t SMEM =
      sizeof(float) * ((2 * BK + 4 * BQ) * LD + 4 * BQ);
  static_assert(HSPLIT || 2 * BK * (HD + 8) <= 4 * BQ * LD,
                "the halves' merge fits in the ring");
};

// Start copying rows pos0 .. pos0 + ROWS - 1 of a (rows x HD) f32 matrix
// whose rows lie `row_stride` elements apart into dst[row * (HD + 4) + d];
// rows at or past `limit` are zero-filled.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile_async(const float* __restrict__ src,
                                                int64_t row_stride, int pos0,
                                                int limit, float* dst) {
  constexpr int CPR = HD / 4;   // 16-byte chunks per row
#pragma unroll
  for (int e = threadIdx.x; e < ROWS * CPR; e += THREADS) {
    const int row = e / CPR;
    const int col = (e % CPR) * 4;
    const int pos = pos0 + row;
    const bool valid = pos < limit;
    cp_async16(smem_addr(dst + row * (HD + 4) + col),
               src + (valid ? pos * row_stride + col : 0), valid);
  }
}

// The split A fragment of a strip's k8 step at p = &A[row g][column t]
// (rows LD floats apart): a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4),
// a3 = (g + 8, t + 4).
template <int LD>
__device__ __forceinline__ void load_split(const float* p, uint32_t (&big)[4],
                                           uint32_t (&small)[4]) {
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[8 * LD], big[1], small[1]);
  split_tf32(p[4], big[2], small[2]);
  split_tf32(p[8 * LD + 4], big[3], small[3]);
}

// c[j] = A B_j^T over the head dim: A a strip of 16 rows (a = &A[row
// g][column t]), B_j rows 8 j .. 8 j + 7 of a tile (b = &B[row g][column
// t]), both rows LD floats apart.  A's split fragments are read a k8 step
// at a time, B's pairs (row g, columns t and t + 4) split by mma_split;
// runs of half the head dim (at most 8 k8 steps) are summed from zero in
// the accumulator and added into c by FADD.
template <int HD, int LD, int NJ>
__device__ __forceinline__ void row_products(const float* a, const float* b,
                                             float (&c)[NJ][4]) {
  constexpr int RUN = HD / 16 < 8 ? HD / 16 : 8;
  static_assert(HD / 8 % RUN == 0, "runs must cut the k8 steps evenly");
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
  for (int kr = 0; kr < HD / 8; kr += RUN) {
    float part[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
    for (int kk = kr; kk < kr + RUN; ++kk) {
      uint32_t ab[4], as[4];
      load_split<LD>(a + 8 * kk, ab, as);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mma_split(part[j], ab, as, b[8 * j * LD + 8 * kk],
                  b[8 * j * LD + 8 * kk + 4]);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) add4(c[j], part[j]);
  }
}

// acc[n] += X B_n: X the accumulators of NK n8 tiles (16 rows x 8 NK
// columns; lane holds columns 2t, 2t + 1 of each) taken as NK k8 steps in
// place, k = t <-> column 2t and k = t + 4 <-> 2t + 1, split here; B rows
// 8 kk .. 8 kk + 7 of k8 step kk and columns 8 n .. 8 n + 7 of n8 tile n (b
// = &B[row 2t][column g], rows LD floats apart): b0 = B[2t][g], b1 =
// B[2t + 1][g].  Runs of ROW_RUN k8 steps summed from zero, then added.
template <int LD, int NK, int NT>
__device__ __forceinline__ void col_products(const float (&x)[NK][4],
                                             const float* b,
                                             float (&acc)[NT][4]) {
  constexpr int RUN = NK < ROW_RUN ? NK : ROW_RUN;
  static_assert(NK % RUN == 0, "runs must cut the k8 steps evenly");
#pragma unroll
  for (int kr = 0; kr < NK; kr += RUN) {
    uint32_t xb[RUN][4], xs[RUN][4];
#pragma unroll
    for (int r = 0; r < RUN; ++r) {
      split_tf32(x[kr + r][0], xb[r][0], xs[r][0]);
      split_tf32(x[kr + r][2], xb[r][1], xs[r][1]);
      split_tf32(x[kr + r][1], xb[r][2], xs[r][2]);
      split_tf32(x[kr + r][3], xb[r][3], xs[r][3]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < RUN; ++r) {
        const float* bp = b + 8 * (kr + r) * LD + 8 * n;
        mma_split(part, xb[r], xs[r], bp[0], bp[LD]);
      }
      add4(acc[n], part);
    }
  }
}

// dQ, and delta for the dK / dV kernel.  Grid (H, B, query tiles).
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_3xtf32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ out,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    float* __restrict__ dq, int s, int h, int kvh,
                    int causal, int window, int prefix, float scale) {
  using P = DqPlan<HD>;
  constexpr int BQ = P::BQ, BK = P::BK, BKW = P::BKW, LD = P::LD;
  constexpr int NJ = BKW / 8;   // n8 tiles of S and dP: the warp's keys
  constexpr int NT = HD / 8;    // n8 tiles of dQ
  constexpr int MLD = HD + 8;   // rows of the halves' merge
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [BQ][LD]
  float* dos = qs + BQ * LD;         // [BQ][LD]
  float* ks = dos + BQ * LD;         // [2][BK][LD]
  float* vs = ks + 2 * BK * LD;      // [2][BK][LD]
  float* dl_s = vs + 2 * BK * LD;    // [BQ]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int strip = warp & 3, half = warp >> 2;
  const int head = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // long rows first
  const int qw = q0 + 16 * strip;                     // the warp's strip
  const int kv_head = head / (h / kvh);
  const int64_t q_row = (int64_t)h * HD, kv_row = (int64_t)kvh * HD;
  const int64_t qoff = ((int64_t)b * s * h + head) * HD;
  const float* kb = k + ((int64_t)b * s * kvh + kv_head) * HD;
  const float* vb = v + ((int64_t)b * s * kvh + kv_head) * HD;
  const int64_t rowstat = ((int64_t)b * h + head) * s;   // lse, delta
  const float scale_log2 = scale * LOG2E;

  // the live key tiles: the forward's
  const int q_last = min(q0 + BQ, s) - 1;
  int kt_end = (s + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, key_limit(q_last, prefix) / BK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;

  load_tile_async<HD, BQ>(q + qoff, q_row, q0, s, qs);
  load_tile_async<HD, BQ>(dout + qoff, q_row, q0, s, dos);
  cp_async_commit();
  load_tile_async<HD, BK>(kb, kv_row, kt_begin * BK, s, ks);
  load_tile_async<HD, BK>(vb, kv_row, kt_begin * BK, s, vs);
  cp_async_commit();
  cp_async_wait<1>();   // Q and dO are in
  __syncthreads();

  // delta = rowsum(dO * O) in f32, a warp on BQ / 8 rows
  for (int r = warp * (BQ / 8); r < (warp + 1) * (BQ / 8); ++r) {
    const int pos = q0 + r;
    float acc = 0.f;
    if (pos < s) {
      const float* orow = out + qoff + pos * q_row;
      for (int d = lane; d < HD; d += 32)
        acc = fmaf(dos[r * LD + d], orow[d], acc);
    }
    acc = attn::group_sum<32>(acc);
    if (lane == 0) {
      dl_s[r] = acc;
      if (pos < s) delta[rowstat + pos] = acc;
    }
  }
  // rows g and g + 8 of the strip: lse in log2 units (+inf past S, so that
  // p = 0 there; a row inside S keeps its own key, so its lse is finite)
  // and delta
  float l2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pos = qw + g + 8 * i;
    l2[i] = pos < s ? lse[rowstat + pos] * LOG2E : INFINITY;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) dl[i] = dl_s[16 * strip + g + 8 * i];

  const float* qa = qs + (16 * strip + g) * LD + t;
  const float* da = dos + (16 * strip + g) * LD + t;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

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

    const int k0 = kt * BK + half * BKW;   // the warp's first key
    // keys wholly masked for this warp's rows (or a warp past S)
    if (qw >= s || k0 >= s || (causal && k0 > key_limit(qw + 15, prefix)) ||
        (window > 0 && k0 + BKW - 1 <= qw - window))
      continue;

    // S = Q K^T and dP = dO V^T over the warp's keys
    const float* ktile = ks + (buf * BK + half * BKW) * LD;
    const float* vtile = vs + (buf * BK + half * BKW) * LD;
    float sc[NJ][4], dp[NJ][4];
    row_products<HD, LD, NJ>(qa, ktile + g * LD + t, sc);
    row_products<HD, LD, NJ>(da, vtile + g * LD + t, dp);

    // P and dS / scale on the accumulators: rows g (e = 0, 1), g + 8 (2,
    // 3), keys 8 j + 2 t + (e & 1); the mask on keys the warp's rows cut
    // only (a select, so that a masked entry's exp never reaches dS)
    const bool interior = k0 + BKW <= s &&
                          (!causal || k0 + BKW - 1 <= key_limit(qw, prefix)) &&
                          (window <= 0 || k0 > qw + 15 - window);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_approx(fmaf(sc[j][e], scale_log2, -l2[e >> 1]));
        if (!interior &&
            !kept(qw + g + 8 * (e >> 1), k0 + 8 * j + 2 * t + (e & 1), s,
                  causal, window, prefix))
          p = 0.f;
        sc[j][e] = p * (dp[j][e] - dl[e >> 1]);
      }

    // dQ / scale += (dS / scale) K: K[key 2t, 2t + 1][column g]
    col_products<LD, NJ, NT>(sc, ktile + 2 * t * LD + g, acc);
  }

  // the halves' dQ summed by the first (the second's through shared
  // memory, free once every warp is past the loop), scaled and written as
  // float2 stores; rows past S are not written
  float* mo = smem;   // [BQ][MLD]
  const int row0 = 16 * strip + g;
  cp_async_wait<0>();
  __syncthreads();
  if (half == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<float2*>(mo + (row0 + 8 * r) * MLD + 8 * n + 2 * t) =
            make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
  __syncthreads();
  if (half == 1) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = qw + g + 8 * r;
    if (pos >= s) continue;
    float* row = dq + qoff + pos * q_row + 2 * t;
    const float* other = mo + (row0 + 8 * r) * MLD + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 x = *reinterpret_cast<const float2*>(other + 8 * n);
      *reinterpret_cast<float2*>(row + 8 * n) =
          make_float2((acc[n][2 * r] + x.x) * scale,
                      (acc[n][2 * r + 1] + x.y) * scale);
    }
  }
}

// dK and dV of one key tile, summed over the group's query heads.  Grid
// (KV, B, key tiles), or (KV, B, plan entries) with a plan: entry z =
// {key tile, first item, end item, workspace slot} of the tile's walk
// (item i = head i / nq of the group, query tile i % nq), and then the
// block writes f32 partials to ws[(slot, b, kv head)][dK, dV][BK][HD].
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_3xtf32(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv,
                      const int4* __restrict__ plan, float* __restrict__ ws,
                      int s, int h, int kvh, int causal, int window,
                      int prefix, float scale) {
  using P = DkvPlan<HD>;
  constexpr int BQ = P::BQ, BK = P::BK, BQW = P::BQW, HDW = P::HDW;
  constexpr int LD = P::LD;
  constexpr int NJ = BQW / 8;   // n8 tiles of S^T and dP^T: the warp's rows
  constexpr int NT = HDW / 8;   // n8 tiles of the warp's dK and dV
  constexpr int MLD = HD + 8;   // rows of the halves' merge
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                   // [BK][LD]
  float* vs = ks + BK * LD;           // [BK][LD]
  float* qs = vs + BK * LD;           // [2][BQ][LD]
  float* dos = qs + 2 * BQ * LD;      // [2][BQ][LD]
  float* lse_s = dos + 2 * BQ * LD;   // [2][BQ]
  float* dl_s = lse_s + 2 * BQ;       // [2][BQ]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int strip = warp % P::STRIPS, half = warp / P::STRIPS;
  const int qh = P::HSPLIT ? 0 : half * BQW;    // the warp's first row
  const int hc0 = P::HSPLIT ? half * HDW : 0;   // the warp's first column
  const int kv_head = blockIdx.x, b = blockIdx.y;
  const int group = h / kvh;
  int kt = blockIdx.z, i_begin = 0, i_end = -1, slot = 0;
  if (plan != nullptr) {
    const int4 e = plan[blockIdx.z];
    kt = e.x;
    i_begin = e.y;
    i_end = e.z;
    slot = e.w;
  }
  const int k0 = kt * BK;
  const int kw = k0 + 16 * strip;   // the warp's first key
  const int64_t q_row = (int64_t)h * HD, kv_row = (int64_t)kvh * HD;
  const int64_t kvoff = ((int64_t)b * s * kvh + kv_head) * HD;
  const float scale_log2 = scale * LOG2E;

  // the query rows that keep one of the tile's keys, in query tiles
  const int k_last = min(k0 + BK, s) - 1;
  const int q_begin = causal && k0 >= prefix ? k0 : 0;
  const int q_end = window > 0 ? min(s, k_last + window) : s;
  const int qt0 = q_begin / BQ;
  const int nq = (q_end + BQ - 1) / BQ - qt0;
  if (plan == nullptr) i_end = group * nq;

  // start copying item i's Q, dO, lse and delta into stage st
  auto issue = [&](int i, int st) {
    const int head = kv_head * group + i / nq;
    const int q0 = (qt0 + i % nq) * BQ;
    const int64_t qoff = ((int64_t)b * s * h + head) * HD;
    const int64_t rowstat = ((int64_t)b * h + head) * s;
    load_tile_async<HD, BQ>(q + qoff, q_row, q0, s, qs + st * BQ * LD);
    load_tile_async<HD, BQ>(dout + qoff, q_row, q0, s, dos + st * BQ * LD);
    load_rows_async<BQ, THREADS>(lse + rowstat, q0, s, lse_s + st * BQ);
    load_rows_async<BQ, THREADS>(delta + rowstat, q0, s, dl_s + st * BQ);
  };

  load_tile_async<HD, BK>(k + kvoff, kv_row, k0, s, ks);
  load_tile_async<HD, BK>(v + kvoff, kv_row, k0, s, vs);
  cp_async_commit();
  if (i_begin < i_end) issue(i_begin, 0);
  cp_async_commit();
  cp_async_wait<1>();   // K and V are in
  __syncthreads();

  const float* ka = ks + (16 * strip + g) * LD + t;
  const float* va = vs + (16 * strip + g) * LD + t;
  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int i = i_begin; i < i_end; ++i) {
    const int st = (i - i_begin) & 1;
    cp_async_wait<0>();   // item i is in
    __syncthreads();      // ... for every thread; the other stage is free
    if (i + 1 < i_end) issue(i + 1, st ^ 1);
    cp_async_commit();

    const int qa = (qt0 + i % nq) * BQ + qh;   // the warp's first query
    // rows wholly masked for this warp's keys (or a strip or rows past S)
    if (kw >= s || qa >= s ||
        (causal && kw > key_limit(min(qa + BQW, s) - 1, prefix)) ||
        (window > 0 && kw + 15 <= qa - window))
      continue;

    // S^T = K Q^T over the warp's query rows
    const float* qtile = qs + (st * BQ + qh) * LD;
    const float* dtile = dos + (st * BQ + qh) * LD;
    float sT[NJ][4], dpT[NJ][4];
    row_products<HD, LD, NJ>(ka, qtile + g * LD + t, sT);

    // P^T on the accumulators: keys g (e = 0, 1), g + 8 (2, 3), query
    // rows 8 j + 2 t + (e & 1); the mask on tiles the strip cuts (a
    // select; rows past S, zero-filled, are masked there)
    const bool interior =
        kw + 15 < s && qa + BQW <= s &&
        (!causal || kw + 15 <= key_limit(qa, prefix)) &&
        (window <= 0 || kw > qa + BQW - 1 - window);
    const float* ls = lse_s + st * BQ + qh;
    const float* dls = dl_s + st * BQ + qh;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float2 lr = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
      const float l2[2] = {lr.x * LOG2E, lr.y * LOG2E};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_approx(fmaf(sT[j][e], scale_log2, -l2[e & 1]));
        if (!interior &&
            !kept(qa + 8 * j + 2 * t + (e & 1), kw + g + 8 * (e >> 1), s,
                  causal, window, prefix))
          p = 0.f;
        sT[j][e] = p;
      }
    }

    // dP^T = V dO^T, then dS^T / scale = P^T (dP^T - delta)
    row_products<HD, LD, NJ>(va, dtile + g * LD + t, dpT);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float2 dr = *reinterpret_cast<const float2*>(dls + 8 * j + 2 * t);
      const float dl[2] = {dr.x, dr.y};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpT[j][e] = sT[j][e] * (dpT[j][e] - dl[e & 1]);
    }

    // dV += P^T dO and dK / scale += (dS^T / scale) Q over the warp's
    // columns: dO and Q at rows 2t, 2t + 1, column g
    col_products<LD, NJ, NT>(sT, dtile + 2 * t * LD + hc0 + g, dva);
    col_products<LD, NJ, NT>(dpT, qtile + 2 * t * LD + hc0 + g, dka);
  }

  const int r0 = 16 * strip + g;   // the lane's rows r0, r0 + 8 of the tile
  if constexpr (!P::HSPLIT) {
    // the halves' dK and dV summed by the first, the second's through the
    // ring (free once every warp is past the loop)
    float* mk = qs;              // [BK][MLD]: dK
    float* mv = mk + BK * MLD;   // [BK][MLD]: dV
    cp_async_wait<0>();
    __syncthreads();
    if (half == 1) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int at = (r0 + 8 * r) * MLD + 8 * n + 2 * t;
          *reinterpret_cast<float2*>(mk + at) =
              make_float2(dka[n][2 * r], dka[n][2 * r + 1]);
          *reinterpret_cast<float2*>(mv + at) =
              make_float2(dva[n][2 * r], dva[n][2 * r + 1]);
        }
    }
    __syncthreads();
    if (half == 1) return;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int at = (r0 + 8 * r) * MLD + 8 * n + 2 * t;
        const float2 xk = *reinterpret_cast<const float2*>(mk + at);
        const float2 xv = *reinterpret_cast<const float2*>(mv + at);
        dka[n][2 * r] += xk.x;
        dka[n][2 * r + 1] += xk.y;
        dva[n][2 * r] += xv.x;
        dva[n][2 * r + 1] += xv.y;
      }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] *= scale;
  // f32 partials for flash_bwd_dkdv_sum, or dK and dV as float2 stores
  // (rows past S not written)
  float* kdst = dk + kvoff + k0 * kv_row;
  float* vdst = dv + kvoff + k0 * kv_row;
  int64_t stride = kv_row;
  if (ws != nullptr) {
    kdst = ws + (((int64_t)slot * gridDim.y + b) * kvh + kv_head) * 2 * BK * HD;
    vdst = kdst + BK * HD;
    stride = HD;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (ws == nullptr && k0 + row >= s) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int64_t at = row * stride + hc0 + 8 * n + 2 * t;
      *reinterpret_cast<float2*>(kdst + at) =
          make_float2(dka[n][2 * r], dka[n][2 * r + 1]);
      *reinterpret_cast<float2*>(vdst + at) =
          make_float2(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

// Blocks a key tile's partials are summed by: its rows split SUM_PARTS
// ways, so that a small grid's sum runs on more SMs than it has key tiles
// (paligemma's f32 cut: KV x B x key tiles = 16, 17 slots a tile).
constexpr int SUM_PARTS = 8;

// dK and dV of rows of key tile z / SUM_PARTS (the part z % SUM_PARTS of
// its BK rows) from its splits' f32 partials, summed in split order (the
// same bits at every call).  Grid (KV, B, key tiles x SUM_PARTS); tiles[2
// kt] is key tile kt's first workspace slot, tiles[2 kt + 1] its number of
// slots.  Launched as a programmatic dependent of the dK / dV kernel: it
// waits here for that grid's writes.
template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_sum(const float* __restrict__ ws, const int* __restrict__ tiles,
                   float* __restrict__ dk, float* __restrict__ dv, int s,
                   int kvh) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  constexpr int BK = DkvPlan<HD>::BK;
  constexpr int ROWS = BK / SUM_PARTS;   // rows a block sums
  constexpr int Q4 = HD / 4;             // float4 columns a row
  const int kv_head = blockIdx.x, b = blockIdx.y;
  const int kt = blockIdx.z / SUM_PARTS;
  const int row0 = blockIdx.z % SUM_PARTS * ROWS;
  const int first = tiles[2 * kt], count = tiles[2 * kt + 1];
  const int64_t slot_stride = (int64_t)gridDim.y * kvh * 2 * BK * HD;
  const float* part =
      ws + (((int64_t)first * gridDim.y + b) * kvh + kv_head) * 2 * BK * HD;
  const int64_t kv_row = (int64_t)kvh * HD;
  const int64_t kvoff = ((int64_t)b * s * kvh + kv_head) * HD;
  for (int e = threadIdx.x; e < 2 * ROWS * Q4; e += THREADS) {
    const int which = e / (ROWS * Q4);   // 0: dK, 1: dV
    const int row = row0 + (e / Q4) % ROWS;
    const int col = (e % Q4) * 4;
    const int pos = kt * BK + row;
    if (pos >= s) continue;
    const float* src = part + which * BK * HD + row * HD + col;
    float4 acc = *reinterpret_cast<const float4*>(src);
#pragma unroll 4
    for (int sp = 1; sp < count; ++sp) {
      const float4 x =
          *reinterpret_cast<const float4*>(src + sp * slot_stride);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    *reinterpret_cast<float4*>((which ? dv : dk) + kvoff + pos * kv_row +
                               col) = acc;
  }
}

template <int HD>
int launch(const Args<float>& a) {
  return launch_k1<DqPlan<HD>, DkvPlan<HD>, THREADS, SUM_PARTS>(
      a, flash_bwd_dq_3xtf32<HD>, flash_bwd_dkdv_3xtf32<HD>,
      flash_bwd_dkdv_sum<HD>);
}

template <int HD>
bool takes_tiles(int bk, int bq) {
  return bk == DkvPlan<HD>::BK && bq == DkvPlan<HD>::BQ;
}

// The head dim's launch, or cudaErrorInvalidValue for a head dim the
// kernels do not take (or, with bk > 0, for dK / dV tiles (bk, bq) that
// are not its own).
int dispatch(int hd, const Args<float>& a, int bk, int bq) {
#define F32_CASE(D) \
  case D: return bk > 0 && !takes_tiles<D>(bk, bq) ? (int)cudaErrorInvalidValue : launch<D>(a);
  switch (hd) {
    F32_CASE(32)
    F32_CASE(64)
    F32_CASE(80)
    F32_CASE(96)
    F32_CASE(128)
    F32_CASE(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef F32_CASE
}

}  // namespace tf32x3

template <typename T>
Args<T> args(const void* q, const void* k, const void* v, const void* out,
             const void* dout, const float* lse, float* delta, void* dq,
             void* dk, void* dv, int b, int s, int h, int kvh, int causal,
             int window, int prefix, float scale, const int* plan,
             int nplan, float* ws, void* stream) {
  return Args<T>{static_cast<const T*>(q), static_cast<const T*>(k),
                 static_cast<const T*>(v), static_cast<const T*>(out),
                 static_cast<const T*>(dout), lse, delta,
                 static_cast<T*>(dq), static_cast<T*>(dk),
                 static_cast<T*>(dv), b, s, h, kvh, causal, window, prefix,
                 scale, plan, nplan, ws, (cudaStream_t)stream};
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
  if (prefix < 0) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return tc::dispatch(hd, args<bf16>(q, k, v, out, dout, lse, delta, dq,
                                       dk, dv, b, s, h, kvh, causal, window,
                                       prefix, scale, nullptr, 0, nullptr,
                                       stream), 0, 0);
  return tf32x3::dispatch(hd, args<float>(q, k, v, out, dout, lse, delta,
                                          dq, dk, dv, b, s, h, kvh, causal,
                                          window, prefix, scale, nullptr, 0,
                                          nullptr, stream), 0, 0);
}

// flash_attention_bwd with the dK / dV kernel's query walk split by a plan
// (kernels/flash_attention.py's bwd_split_plan, made for dK / dV tiles of
// bk keys and bq query rows, which must be the kernel's own for this type
// and head dim): plan holds nplan entries {key tile, first item, end item,
// workspace slot}, then {first slot, slots} for each key tile; ws holds
// (slots) x b x kvh x 2 x bk x hd floats.  Three launches on `stream` (dQ
// with delta, the splits, their sum).
extern "C" int flash_attention_bwd_split(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int b, int s, int h, int kvh, int hd, int causal, int window,
    int prefix, int is_bf16, float scale, int bk, int bq, const int* plan,
    int nplan, float* ws, void* stream) {
  if (prefix < 0 || plan == nullptr || nplan < 1 || nplan > 65535 ||
      ws == nullptr || bk < 1)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return tc::dispatch(hd, args<bf16>(q, k, v, out, dout, lse, delta, dq,
                                       dk, dv, b, s, h, kvh, causal, window,
                                       prefix, scale, plan, nplan, ws,
                                       stream), bk, bq);
  return tf32x3::dispatch(hd, args<float>(q, k, v, out, dout, lse, delta,
                                          dq, dk, dv, b, s, h, kvh, causal,
                                          window, prefix, scale, plan, nplan,
                                          ws, stream), bk, bq);
}
