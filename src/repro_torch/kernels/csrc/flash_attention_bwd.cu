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
// bf16, head dims 80 and 128 -> flash_bwd_dq_wgmma, flash_bwd_dkdv_wgmma
// (namespace wg), the same backward on Hopper's wgmma fed by TMA, built
// on the forward's building blocks (wgmma_common.cuh).  The templates
// take head dim 64 too, but there they ran slower than tc's kernels at
// zamba2's shapes (group 1, short walks), so 64 stays on mma.sync:
//   * blocks of 3 warpgroups: warpgroup 0 the producer (one thread issues
//     every cp.async.bulk.tensor copy through full / empty mbarrier rings;
//     setmaxnreg 24), warpgroups 1 and 2 the consumers (setmaxnreg 240),
//     each on 64 rows of the block's tile, issuing its products as soon
//     as their operands are in (the forward's turns between the consumers
//     ran slower here);
//   * shared tiles are TMA's swizzled boxes: 64 columns with the 128-byte
//     swizzle and, at head dim 80, the last 16 columns as a box of their
//     own with the 32-byte swizzle (a fifth k16 step of the products over
//     the head dim, an n16 product beside the n64 one for those that
//     produce it; no padding); rows past S arrive as zeros;
//   * dQ kernel: 128 query rows a block (query tiles launched last-first);
//     Q and dO once, then K and V tiles of 64 keys through a ring of 3
//     stages, key tiles wholly masked for the block never loaded.  A
//     consumer first writes delta = rowsum(dO * O) of its rows in f32
//     (from global memory, while the copies land); then for each key
//     tile S = Q K^T and dP = dO V^T (wgmma m64n64k16 from shared memory,
//     both operands K-major), P and dS / scale on the accumulators, and
//     dQ / scale += dS K register-sourced, dS as two bf16 terms, K read
//     MN-major from the same tile by a second descriptor.  Tile i's dQ
//     product and tile i + 1's S and dP go out back to back (the
//     forward's order);
//   * dK / dV kernel: 128 keys a block (64 a consumer); K and V once, then
//     the walk's Q and dO tiles (64 query rows a step, 32 at head dim 128)
//     through a ring of 3 stages, the next step's lse and delta read from
//     global memory into registers while a step's last products run (a
//     TMA box of them would start off 16 bytes where S is no multiple of
//     4, which the copy refuses).  For each step S^T = K Q^T and dP^T = V
//     dO^T from shared memory, P^T and dS^T / scale on the accumulators,
//     then dV += P^T dO and dK / scale += dS^T Q register-sourced, two
//     bf16 terms each, dO and Q MN-major (dV's products issued before dS^T
//     is split).  dK and dV sum in f32 registers (64 + 64 a
//     thread at head dim 128) and are rounded to bf16 once, or written as
//     f32 partials for flash_bwd_dkdv_sum under a plan (the same split on
//     this kernel's tiles);
//   * every consumer computes every tile its block loads (a tile wholly
//     masked for its rows adds P = 0); the mask predicate only on tiles
//     its rows cut.
//   A launch the kernels refuse (a tensor map the driver will not encode,
//   too much shared memory) returns its error; nothing falls back.
//
// bf16, head dims 32, 64, 96 and 256 -> flash_bwd_dq_mma, flash_bwd_dkdv_mma
// (namespace tc), a FlashAttention-2 backward on the bf16 tensor cores
// (mma.sync.m16n8k16, f32 accumulators), built on the forward's helpers
// (attention_common.cuh):
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
//   Work issued, on either route: S and dP in both kernels and two
//   products for each of dV, dK and dQ, 10 bf16 product units against the
//   5 of the bound.
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
#include <string.h>

#include "attention_common.cuh"
#include "wgmma_common.cuh"

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

// The split's sums run SUM_THREADS threads a block on every route.
constexpr int SUM_THREADS = 256;

// The sum of a split's partials, ksum (KV x B x SUM_PARTS blocks of
// SUM_THREADS threads for each of `tiles` key tiles), as a programmatic
// dependent launch on a.stream; returns its cudaError_t.
template <int SUM_PARTS, typename T, typename KSUM>
int launch_sum(const Args<T>& a, int tiles, KSUM ksum) {
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

// Four sums of dK or dV stored as the output type: bf16 rounded once, f32
// as they are.
__device__ __forceinline__ void store4(bf16* dst, float4 v) {
  uint2 packed;
  packed.x = attn::pack_bf16(v.x, v.y);
  packed.y = attn::pack_bf16(v.z, v.w);
  *reinterpret_cast<uint2*>(dst) = packed;
}
__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}

__device__ __forceinline__ void add_slot(float4& acc, const float* src) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  acc.x += x.x;
  acc.y += x.y;
  acc.z += x.z;
  acc.w += x.w;
}

// The body of every route's flash_bwd_dkdv_sum: dK and dV of rows of key
// tile z / PARTS (the part z % PARTS of its BK rows) from its splits' f32
// partials, summed in split order (the same bits at every call) and
// stored as T.  Grid (KV, B, key tiles x PARTS) of SUM_THREADS threads;
// tiles[2 kt] is key tile kt's first workspace slot, tiles[2 kt + 1] its
// number of slots.  Launched as a programmatic dependent of the dK / dV
// kernel: it waits here for that grid's writes.  UNROLL4 unrolls the walk
// over the slots by 4; without it the compiler chooses.
template <int BK, int HD, int PARTS, bool UNROLL4, typename T>
__device__ __forceinline__ void dkdv_sum(const float* __restrict__ ws,
                                         const int* __restrict__ tiles,
                                         T* __restrict__ dk,
                                         T* __restrict__ dv, int s, int kvh) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  constexpr int ROWS = BK / PARTS;   // rows a block sums
  constexpr int Q4 = HD / 4;         // float4 columns a row
  const int kv_head = blockIdx.x, b = blockIdx.y;
  const int kt = blockIdx.z / PARTS;
  const int row0 = blockIdx.z % PARTS * ROWS;
  const int first = tiles[2 * kt], count = tiles[2 * kt + 1];
  const int64_t slot_stride = (int64_t)gridDim.y * kvh * 2 * BK * HD;
  const float* part =
      ws + (((int64_t)first * gridDim.y + b) * kvh + kv_head) * 2 * BK * HD;
  const int64_t kv_row = (int64_t)kvh * HD;
  const int64_t kvoff = ((int64_t)b * s * kvh + kv_head) * HD;
  for (int e = threadIdx.x; e < 2 * ROWS * Q4; e += SUM_THREADS) {
    const int which = e / (ROWS * Q4);   // 0: dK, 1: dV
    const int row = row0 + (e / Q4) % ROWS;
    const int col = (e % Q4) * 4;
    const int pos = kt * BK + row;
    if (pos >= s) continue;
    const float* src = part + which * BK * HD + row * HD + col;
    float4 acc = *reinterpret_cast<const float4*>(src);
    if constexpr (UNROLL4) {
#pragma unroll 4
      for (int sp = 1; sp < count; ++sp) add_slot(acc, src + sp * slot_stride);
    } else {
      for (int sp = 1; sp < count; ++sp) add_slot(acc, src + sp * slot_stride);
    }
    store4((which ? dv : dk) + kvoff + pos * kv_row + col, acc);
  }
}

// K1's launches on a.stream: the dQ kernel kq (grid H x B x query tiles of
// Q::BQ rows), the dK / dV kernel kkv (KV x B x key tiles of KV::BK keys,
// or x plan entries) and, with a plan, ksum (KV x B x SUM_PARTS blocks of
// SUM_THREADS threads a key tile), which sums the partials, as a
// programmatic dependent launch.  Returns the first failing launch's
// cudaError_t.
template <typename Q, typename KV, int SUM_PARTS, typename T, typename KQ,
          typename KKV, typename KSUM>
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
  return launch_sum<SUM_PARTS>(a, tiles, ksum);
}

// ---------------------------------------------------------------------------
// bf16 at head dims 80 and 128: the Hopper kernels (TMA + wgmma)

namespace wg {

using namespace hopper;
using attn::exp2_approx;
using attn::pack_bf16;
using attn::smem_addr;

constexpr int THREADS = 384;   // the producer warpgroup, then two consumers
// registers a thread after setmaxnreg, as the forward's: 128 * 24 + 256 *
// 240 = 384 * 168, the launch's whole register file
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

// The dQ kernel's tiles: BQ query rows a block (64 a consumer warpgroup),
// K and V tiles of BK keys through a ring of STAGES.  Shared memory: the
// Q and dO tiles, the ring's K tiles, its V tiles, then the barriers (Q
// and dO full; K full, V full and empty for each stage); every tile
// starts on a 1024-byte boundary.
template <int HD>
struct DqGeo {
  static constexpr int BQ = 128;
  static constexpr int BK = 64;
  static constexpr int STAGES = 3;
  static constexpr int Q_BYTES = BQ * HD * 2;    // the Q or the dO tile
  static constexpr int KV_BYTES = BK * HD * 2;   // one K or V tile
  static constexpr int DO_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;
};

// The dK / dV kernel's tiles: BK keys a block (64 a consumer warpgroup),
// the walk's Q and dO tiles of BQ query rows through a ring of STAGES.
// At head dim 128 the steps take 32 rows: dK and dV hold 128 registers a
// thread, and S^T, dP^T and their two bf16 terms at 64 rows would spill.
// kernels/flash_attention.py's BWD_TILES[torch.bfloat16] mirrors (BK, BQ)
// at head dims 80 and 128; flash_attention_bwd_split refuses a plan made
// for others.  Shared memory: the K and V tiles, the ring's Q tiles,
// its dO tiles, then the barriers (K and V full; full and empty for each
// stage).
template <int HD>
struct DkvGeo {
  static constexpr int BK = 128;
  static constexpr int BQ = HD <= 80 ? 64 : 32;
  static constexpr int STAGES = 3;
  static constexpr int KV_BYTES = BK * HD * 2;   // the K or the V tile
  static constexpr int Q_BYTES = BQ * HD * 2;    // one Q or dO tile
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;
  static constexpr int DO_OFF = Q_OFF + STAGES * Q_BYTES;
  static constexpr int BAR_OFF = DO_OFF + STAGES * Q_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

// The tensor maps of the dQ launch (q and dout in boxes of its BQ rows, k
// and v of its BK) and of the dK / dV launch (k and v in boxes of its
// BK, q and dout of its BQ): boxes of 64 columns (128-byte swizzle) and,
// at head dim 80, of the 16 columns past them (32-byte swizzle); passed
// by value as __grid_constant__s.
struct DqMaps {
  CUtensorMap q, dout, k, v;
  CUtensorMap q_tail, dout_tail, k_tail, v_tail;
};
struct DkvMaps {
  CUtensorMap k, v, q, dout;
  CUtensorMap k_tail, v_tail, q_tail, dout_tail;
};

// Issue X Y^T for the warpgroup's 64 rows of a tile of R rows (from row
// row0) against the 2 N rows of a tile of 2 N rows: m64 n(2 N) k16 steps
// over the head dim, both operands K-major in shared memory.  S = Q K^T
// and dP = dO V^T in the dQ kernel, S^T = K Q^T and dP^T = V dO^T in the
// dK / dV kernel.
template <int HD, int R, int N>
__device__ __forceinline__ void issue_xyt(float (&d)[N], uint32_t x_tile,
                                          int row0, uint32_t y_tile) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    mma_ss(d, k_major<HD, R>(x_tile, row0, kk),
           k_major<HD, 2 * N>(y_tile, 0, kk), kk > 0);
}

// Issue d += A B over NK k16 steps: A from registers as its two bf16 terms
// (lo, then hi, on each step), B a tile of 16 NK rows x HD columns whose
// rows are the contraction (MN-major: the transposed B that bf16 wgmma
// takes), n(64 parts) into d and, at head dim 80, n16 into dt.  dQ += dS
// K, dV += P^T dO and dK += dS^T Q.
template <int HD, int NK, int W, int TW>
__device__ __forceinline__ void issue_rs(float (&d)[W], float (&dt)[TW],
                                         const uint32_t (&hi)[NK][4],
                                         const uint32_t (&lo)[NK][4],
                                         uint32_t tile) {
  constexpr int R = 16 * NK;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const uint64_t db = desc(tile + kk * 16 * 128, R * 128, 1024, 1);
    mma_rs(d, lo[kk], db);
    mma_rs(d, hi[kk], db);
    if constexpr (tail_cols(HD) > 0) {
      const uint64_t dbt =
          desc(tile + parts(HD) * R * 128 + kk * 16 * 32, 256, 256, 3);
      mma_rs(dt, lo[kk], dbt);
      mma_rs(dt, hi[kk], dbt);
    }
  }
}

// P and dS / scale of one key tile on the dQ kernel's accumulators, in
// place in sc: rows r0 (e = 0, 1) and r0 + 8 (e = 2, 3) with lse (log2
// units) l2 and delta dl, columns k0 + 8 j + 2 t + (e & 1); the mask on
// tiles the warpgroup's rows qw .. qw + 63 cut only (a select, so that a
// masked entry's exp never reaches dS).
template <int N>
__device__ __forceinline__ void dq_grads(float (&sc)[N], const float (&dp)[N],
                                         const float (&l2)[2],
                                         const float (&dl)[2], int k0,
                                         int qw, int r0, int t, int s,
                                         int causal, int window, int prefix,
                                         float scale_log2) {
  constexpr int BK = 2 * N;
  const bool interior = k0 + BK <= s &&
                        (!causal || k0 + BK - 1 <= key_limit(qw, prefix)) &&
                        (window <= 0 || k0 > qw + 63 - window);
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2_approx(fmaf(sc[4 * j + e], scale_log2, -l2[e >> 1]));
      if (!interior && !kept(r0 + 8 * (e >> 1), k0 + 8 * j + 2 * t + (e & 1),
                             s, causal, window, prefix))
        p = 0.f;
      sc[4 * j + e] = p * (dp[4 * j + e] - dl[e >> 1]);
    }
}

// The lse (log2 units) and delta of query columns q0 + 8 j + 2 t + c
// (index 2 j + c) of head row `row` (its (b, h) row of S) into l2 and dl
// from global memory; columns past S read as 0 (they are masked).
template <int NC>
__device__ __forceinline__ void load_stats(float (&l2)[NC], float (&dl)[NC],
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           int64_t row, int q0, int t,
                                           int s) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int col = q0 + 8 * (c / 2) + 2 * t + (c & 1);
    l2[c] = col < s ? __ldg(lse + row + col) * LOG2E : 0.f;
    dl[c] = col < s ? __ldg(delta + row + col) : 0.f;
  }
}

// P^T and dS^T / scale of one query tile on the dK / dV kernel's
// accumulators, in place (sT becomes P^T, dpT dS^T): keys kr (e = 0, 1)
// and kr + 8 (e = 2, 3), query columns q0 + 8 j + 2 t + (e & 1), whose
// lse (log2 units) and delta are l2 and dl at 2 j + (e & 1); the mask on
// tiles the warpgroup's keys kw .. kw + 63 cut only (columns past S are
// masked there).
template <int N>
__device__ __forceinline__ void dkv_grads(float (&sT)[N], float (&dpT)[N],
                                          const float (&l2)[N / 2],
                                          const float (&dl)[N / 2], int q0,
                                          int kw, int kr, int t, int s,
                                          int causal, int window, int prefix,
                                          float scale_log2) {
  constexpr int BQ = 2 * N;
  const bool interior =
      kw + 63 < s && q0 + BQ <= s &&
      (!causal || kw + 63 <= key_limit(q0, prefix)) &&
      (window <= 0 || kw > q0 + BQ - 1 - window);
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 2 * j + (e & 1);
      float p = exp2_approx(fmaf(sT[4 * j + e], scale_log2, -l2[c]));
      if (!interior && !kept(q0 + 8 * j + 2 * t + (e & 1), kr + 8 * (e >> 1),
                             s, causal, window, prefix))
        p = 0.f;
      dpT[4 * j + e] = p * (dpT[4 * j + e] - dl[c]);
      sT[4 * j + e] = p;
    }
}

// An accumulator tile (the warp's rows r and r + 8 of a warpgroup's 64,
// n8 tiles of W / 4 columns, then the tail's) times `scale`, rounded to
// bf16 and stored at rows row and row + 8 of dst (rows ld elements
// apart); rows at or past `limit` are not written.
template <int W, int TW, int TAIL>
__device__ __forceinline__ void store_bf16(bf16* dst, int64_t ld, int row,
                                           int limit, int t,
                                           const float (&d)[W],
                                           const float (&dt)[TW],
                                           float scale) {
  constexpr int OW = 2 * W;   // the wide products' columns
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= limit) continue;
    bf16* out = dst + (row + 8 * r) * ld + 2 * t;
#pragma unroll
    for (int j = 0; j < OW / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) = pack_bf16(
          d[4 * j + 2 * r] * scale, d[4 * j + 2 * r + 1] * scale);
#pragma unroll
    for (int j = 0; j < TAIL / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + OW + 8 * j) = pack_bf16(
          dt[4 * j + 2 * r] * scale, dt[4 * j + 2 * r + 1] * scale);
  }
}

// dQ, and delta for the dK / dV kernel.  Grid (H, B, query tiles of BQ
// rows), query tiles launched last-first.
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma(const __grid_constant__ DqMaps maps,
                   const bf16* __restrict__ out,
                   const bf16* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ delta,
                   bf16* __restrict__ dq, int s, int h, int kvh, int causal,
                   int window, int prefix, float scale) {
  using G = DqGeo<HD>;
  constexpr int BQ = G::BQ, BK = G::BK, ST = G::STAGES;
  constexpr int TAIL = tail_cols(HD);
  constexpr int OW = 64 * parts(HD);   // dQ's columns, wide products
  constexpr int TW = TAIL ? TAIL / 2 : 1;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_tile = base, do_tile = base + G::DO_OFF;
  const uint32_t k_tiles = base + G::K_OFF, v_tiles = base + G::V_OFF;
  const uint32_t qd_full = base + G::BAR_OFF;
  const uint32_t k_full = qd_full + 8;   // + 8 * stage
  const uint32_t v_full = k_full + 8 * ST;
  const uint32_t empty = v_full + 8 * ST;

  const int head = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // long rows first
  const int kv_head = head / (h / kvh);

  // the live key tiles: the forward's
  const int q_last = min(q0 + BQ, s) - 1;
  int kt_end = (s + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, key_limit(q_last, prefix) / BK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;
  const int tiles = kt_end - kt_begin;

  if (threadIdx.x == 0) {
    bar_init(qd_full, 1);
    for (int i = 0; i < ST; ++i) {
      bar_init(k_full + 8 * i, 1);
      bar_init(v_full + 8 * i, 1);
      bar_init(empty + 8 * i, 2 * 128);   // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup's role, read from lane 0 so that the compiler sees a
  // warp-uniform branch (and gives each side its setmaxnreg budget)
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    // the producer: one thread issues every copy; a stage is refilled
    // once both consumer warpgroups have released it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      bar_expect(qd_full, 2 * G::Q_BYTES);
      load_tile<HD, BQ>(maps.q, maps.q_tail, q_tile, qd_full, head, q0, b);
      load_tile<HD, BQ>(maps.dout, maps.dout_tail, do_tile, qd_full, head,
                        q0, b);
      for (int i = 0; i < tiles; ++i) {
        const int st = i % ST;
        if (i >= ST) bar_wait(empty + 8 * st, (i / ST - 1) & 1);
        const int pos = (kt_begin + i) * BK;
        bar_expect(k_full + 8 * st, G::KV_BYTES);
        load_tile<HD, BK>(maps.k, maps.k_tail, k_tiles + st * G::KV_BYTES,
                          k_full + 8 * st, kv_head, pos, b);
        bar_expect(v_full + 8 * st, G::KV_BYTES);
        load_tile<HD, BK>(maps.v, maps.v_tail, v_tiles + st * G::KV_BYTES,
                          v_full + 8 * st, kv_head, pos, b);
      }
    }
    return;
  }
  // a consumer warpgroup: 64 query rows over every key tile the producer
  // loads.  Tile i's dQ product and tile i + 1's S and dP go out back to
  // back; the gradients of that S and dP run while the other warpgroup's
  // products do.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(CONSUMER_REGS));
  const int tid = threadIdx.x - 128;
  const int wgi = role - 1;            // consumer warpgroup 0 or 1
  const int warp = (tid >> 5) & 3;     // its warps own 16 rows each
  const int lane = tid & 31;
  const int t = lane & 3;              // accumulator column pair
  const int qw = q0 + 64 * wgi;        // the warpgroup's first row
  const int r0 = qw + 16 * warp + (lane >> 2);   // rows r0, r0 + 8
  const int64_t q_row = (int64_t)h * HD;
  const int64_t qoff = ((int64_t)b * s * h + head) * HD;
  const int64_t rowstat = ((int64_t)b * h + head) * s;   // lse, delta
  const float scale_log2 = scale * LOG2E;

  // delta = rowsum(dO * O) of the warp's 16 rows in f32 (from global
  // memory, while the producer's copies land); the lane keeps rows r0 and
  // r0 + 8's, with their lse in log2 units (+inf past S, so that p = 0
  // there; a row inside S keeps its own key, so its lse is finite)
  float dl[2] = {0.f, 0.f}, l2[2];
#pragma unroll 4
  for (int r = 0; r < 16; ++r) {
    const int pos = qw + 16 * warp + r;
    float acc = 0.f;
    if (pos < s) {
      const __nv_bfloat162* orow = reinterpret_cast<const __nv_bfloat162*>(
          out + qoff + pos * q_row);
      const __nv_bfloat162* drow = reinterpret_cast<const __nv_bfloat162*>(
          dout + qoff + pos * q_row);
      for (int c = lane; c < HD / 2; c += 32) {
        const float2 o2 = __bfloat1622float2(orow[c]);
        const float2 d2 = __bfloat1622float2(drow[c]);
        acc = fmaf(d2.y, o2.y, fmaf(d2.x, o2.x, acc));
      }
    }
    acc = attn::group_sum<32>(acc);
    if (lane == 0 && pos < s) delta[rowstat + pos] = acc;
    if (r == (lane >> 2)) dl[0] = acc;
    if (r == (lane >> 2) + 8) dl[1] = acc;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pos = r0 + 8 * i;
    l2[i] = pos < s ? lse[rowstat + pos] * LOG2E : INFINITY;
  }

  float acc[OW / 2];   // dQ / scale, columns 0 .. OW - 1
  float acct[TW];      // dQ / scale, the tail's 16 columns
#pragma unroll
  for (int i = 0; i < OW / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < TW; ++i) acct[i] = 0.f;
  float sc[BK / 2], dp[BK / 2];   // S, then dS / scale; dP
  uint32_t hi[BK / 16][4], lo[BK / 16][4];   // dS's A fragments
  // S = Q K^T and dP = dO V^T against the key tile of stage st
  auto issue_sdp = [&](int st) {
    issue_xyt<HD, BQ>(sc, q_tile, 64 * wgi, k_tiles + st * G::KV_BYTES);
    issue_xyt<HD, BQ>(dp, do_tile, 64 * wgi, v_tiles + st * G::KV_BYTES);
  };

  bar_wait(qd_full, 0);
  bar_wait(k_full, 0);
  bar_wait(v_full, 0);
  fence_regs(sc);
  fence_regs(dp);
  mma_fence();
  issue_sdp(0);
  mma_commit();
  mma_wait<0>();
  fence_regs(sc);
  fence_regs(dp);
  dq_grads(sc, dp, l2, dl, kt_begin * BK, qw, r0, t, s, causal, window,
           prefix, scale_log2);
  split_p(sc, hi, lo);

  for (int i = 0; i < tiles; ++i) {
    const int st = i % ST, next = (i + 1) % ST;
    const bool more = i + 1 < tiles;
    fence_regs(acc);
    fence_regs(acct);
    fence_regs(sc);
    fence_regs(dp);
    mma_fence();
    issue_rs<HD>(acc, acct, hi, lo, k_tiles + st * G::KV_BYTES);
    mma_commit();
    if (more) {
      const int parity = ((i + 1) / ST) & 1;
      bar_wait(k_full + 8 * next, parity);
      bar_wait(v_full + 8 * next, parity);
      issue_sdp(next);
      mma_commit();
    }
    if (more) {
      mma_wait<1>();   // tile i's dQ product is done; i + 1's S may run on
    } else {
      mma_wait<0>();
    }
    fence_regs(acc);
    fence_regs(acct);
    bar_arrive(empty + 8 * st);
    if (more) {
      mma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      dq_grads(sc, dp, l2, dl, (kt_begin + i + 1) * BK, qw, r0, t, s, causal,
               window, prefix, scale_log2);
      split_p(sc, hi, lo);
    }
  }

  // dQ in bf16 from the accumulators; rows past S are not written
  store_bf16<OW / 2, TW, TAIL>(dq + qoff, q_row, r0, s, t, acc, acct, scale);
}

// dK and dV of one key tile, summed over the group's query heads.  Grid
// (KV, B, key tiles of BK keys), or (KV, B, plan entries) with a plan:
// entry z = {key tile, first item, end item, workspace slot} of the
// tile's walk (item i = head i / nq of the group, query tile i % nq), and
// then the block writes f32 partials to ws[(slot, b, kv head)][dK,
// dV][BK][HD].
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ DkvMaps maps,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, const int4* __restrict__ plan,
                     float* __restrict__ ws, int s, int h, int kvh,
                     int causal, int window, int prefix, float scale) {
  using G = DkvGeo<HD>;
  constexpr int BK = G::BK, BQ = G::BQ, ST = G::STAGES;
  constexpr int TAIL = tail_cols(HD);
  constexpr int OW = 64 * parts(HD);   // dK's and dV's wide columns
  constexpr int TW = TAIL ? TAIL / 2 : 1;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t k_tile = base, v_tile = base + G::V_OFF;
  const uint32_t q_tiles = base + G::Q_OFF, do_tiles = base + G::DO_OFF;
  const uint32_t kv_full = base + G::BAR_OFF;
  const uint32_t full = kv_full + 8;   // + 8 * stage
  const uint32_t empty = full + 8 * ST;

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

  // the query rows that keep one of the tile's keys, in query tiles
  const int k_last = min(k0 + BK, s) - 1;
  const int q_begin = causal && k0 >= prefix ? k0 : 0;
  const int q_end = window > 0 ? min(s, k_last + window) : s;
  const int qt0 = q_begin / BQ;
  const int nq = (q_end + BQ - 1) / BQ - qt0;
  if (plan == nullptr) i_end = group * nq;
  const int items = i_end - i_begin;

  if (threadIdx.x == 0) {
    bar_init(kv_full, 1);
    for (int i = 0; i < ST; ++i) {
      bar_init(full + 8 * i, 1);
      bar_init(empty + 8 * i, 2 * 128);   // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    // the producer: K and V once, then each item's Q and dO
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      bar_expect(kv_full, 2 * G::KV_BYTES);
      load_tile<HD, BK>(maps.k, maps.k_tail, k_tile, kv_full, kv_head, k0,
                        b);
      load_tile<HD, BK>(maps.v, maps.v_tail, v_tile, kv_full, kv_head, k0,
                        b);
      for (int n = 0; n < items; ++n) {
        const int st = n % ST, i = i_begin + n;
        if (n >= ST) bar_wait(empty + 8 * st, (n / ST - 1) & 1);
        const int head = kv_head * group + i / nq;
        const int q0 = (qt0 + i % nq) * BQ;
        const uint32_t bar = full + 8 * st;
        bar_expect(bar, 2 * G::Q_BYTES);
        load_tile<HD, BQ>(maps.q, maps.q_tail, q_tiles + st * G::Q_BYTES,
                          bar, head, q0, b);
        load_tile<HD, BQ>(maps.dout, maps.dout_tail,
                          do_tiles + st * G::Q_BYTES, bar, head, q0, b);
      }
    }
    return;
  }
  // a consumer warpgroup: 64 keys over every item of the walk.  Each
  // item's S^T and dP^T, then its dV and dK products; its gradients run
  // while the other warpgroup's products do.  The next item's lse and
  // delta are read from global memory while this item's dV and dK
  // products run (issued before them, the loads would hold up the
  // products' wgmma.fence).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(CONSUMER_REGS));
  const int tid = threadIdx.x - 128;
  const int wgi = role - 1;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int t = lane & 3;
  const int kw = k0 + 64 * wgi;                 // the warpgroup's first key
  const int kr = kw + 16 * warp + (lane >> 2);   // keys kr, kr + 8
  const float scale_log2 = scale * LOG2E;

  float dka[OW / 2], dkt[TW], dva[OW / 2], dvt[TW];   // dK / scale, dV
#pragma unroll
  for (int i = 0; i < OW / 2; ++i) dka[i] = dva[i] = 0.f;
#pragma unroll
  for (int i = 0; i < TW; ++i) dkt[i] = dvt[i] = 0.f;
  float sT[BQ / 2], dpT[BQ / 2];   // S^T, then P^T; dP^T, then dS^T
  float l2[BQ / 4], dl[BQ / 4];    // the item's columns' lse, delta
  uint32_t ph[BQ / 16][4], pl[BQ / 16][4];   // P^T's A fragments
  uint32_t sh[BQ / 16][4], sl[BQ / 16][4];   // dS^T's

  // the lse and delta of item i's query columns
  auto stats = [&](int i) {
    load_stats(l2, dl, lse, delta,
               ((int64_t)b * h + kv_head * group + i / nq) * s,
               (qt0 + i % nq) * BQ, t, s);
  };
  if (items > 0) stats(i_begin);
  bar_wait(kv_full, 0);
  for (int n = 0; n < items; ++n) {
    const int st = n % ST, i = i_begin + n;
    const int q0 = (qt0 + i % nq) * BQ;
    const uint32_t q_st = q_tiles + st * G::Q_BYTES;
    const uint32_t do_st = do_tiles + st * G::Q_BYTES;
    bar_wait(full + 8 * st, (n / ST) & 1);
    fence_regs(sT);
    fence_regs(dpT);
    mma_fence();
    issue_xyt<HD, BK>(sT, k_tile, 64 * wgi, q_st);
    issue_xyt<HD, BK>(dpT, v_tile, 64 * wgi, do_st);
    mma_commit();
    mma_wait<0>();
    fence_regs(sT);
    fence_regs(dpT);
    dkv_grads(sT, dpT, l2, dl, q0, kw, kr, t, s, causal, window, prefix,
              scale_log2);
    // dV's products go out before dS^T is split, which runs beside them
    split_p(sT, ph, pl);
    fence_regs(dva);
    fence_regs(dvt);
    mma_fence();
    issue_rs<HD>(dva, dvt, ph, pl, do_st);
    mma_commit();
    split_p(dpT, sh, sl);
    fence_regs(dka);
    fence_regs(dkt);
    mma_fence();
    issue_rs<HD>(dka, dkt, sh, sl, q_st);
    mma_commit();
    if (n + 1 < items) stats(i + 1);
    mma_wait<0>();
    fence_regs(dka);
    fence_regs(dkt);
    fence_regs(dva);
    fence_regs(dvt);
    bar_arrive(empty + 8 * st);
  }

  const int64_t kv_row = (int64_t)kvh * HD;
  const int64_t kvoff = ((int64_t)b * s * kvh + kv_head) * HD;
  if (ws == nullptr) {
    // bf16 from the accumulators; keys past S are not written
    store_bf16<OW / 2, TW, TAIL>(dk + kvoff, kv_row, kr, s, t, dka, dkt,
                                 scale);
    store_bf16<OW / 2, TW, TAIL>(dv + kvoff, kv_row, kr, s, t, dva, dvt,
                                 1.f);
    return;
  }
  // f32 partials, summed by flash_bwd_dkdv_sum
  float* part =
      ws + (((int64_t)slot * gridDim.y + b) * kvh + kv_head) * 2 * BK * HD;
  const int row = kr - k0;   // the lane's rows row, row + 8 of the tile
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* pk = part + (row + 8 * r) * HD + 2 * t;
    float* pv = pk + BK * HD;
#pragma unroll
    for (int j = 0; j < OW / 8; ++j) {
      *reinterpret_cast<float2*>(pk + 8 * j) = make_float2(
          dka[4 * j + 2 * r] * scale, dka[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<float2*>(pv + 8 * j) =
          make_float2(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
    }
#pragma unroll
    for (int j = 0; j < TAIL / 8; ++j) {
      *reinterpret_cast<float2*>(pk + OW + 8 * j) = make_float2(
          dkt[4 * j + 2 * r] * scale, dkt[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<float2*>(pv + OW + 8 * j) =
          make_float2(dvt[4 * j + 2 * r], dvt[4 * j + 2 * r + 1]);
    }
  }
}

// Blocks a key tile's partials are summed by: its 128 rows split
// SUM_PARTS ways, as the f32 kernels' sum, so that a small grid's sum
// runs on more SMs than it has key tiles.
constexpr int SUM_PARTS = 8;

// dK and dV of a split from its f32 partials, rounded to bf16 (dkdv_sum).
template <int HD>
__global__ void __launch_bounds__(SUM_THREADS)
flash_bwd_dkdv_sum(const float* __restrict__ ws, const int* __restrict__ tiles,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int s,
                   int kvh) {
  dkdv_sum<DkvGeo<HD>::BK, HD, SUM_PARTS, true>(ws, tiles, dk, dv, s, kvh);
}

// Both launches' tensor maps for a call at head dim HD, or false if the
// driver will not encode one (or q is no device memory).
template <int HD>
bool encode_maps(const Args<bf16>& a, DqMaps* dm, DkvMaps* km) {
  using Q = DqGeo<HD>;
  using KV = DkvGeo<HD>;
  constexpr int TAIL = tail_cols(HD);
  const CUtensorMapSwizzle wide = CU_TENSOR_MAP_SWIZZLE_128B;
  const CUtensorMapSwizzle narrow = CU_TENSOR_MAP_SWIZZLE_32B;
  memset(dm, 0, sizeof(*dm));
  memset(km, 0, sizeof(*km));
  if (!bind_device(a.q)) return false;
  // (map, tail, tensor, heads, box rows) of every tiled map
  struct Tiled {
    CUtensorMap *map, *tail;
    const void* ptr;
    int heads, rows;
  } tiled[8] = {{&dm->q, &dm->q_tail, a.q, a.h, Q::BQ},
                {&dm->dout, &dm->dout_tail, a.dout, a.h, Q::BQ},
                {&dm->k, &dm->k_tail, a.k, a.kvh, Q::BK},
                {&dm->v, &dm->v_tail, a.v, a.kvh, Q::BK},
                {&km->q, &km->q_tail, a.q, a.h, KV::BQ},
                {&km->dout, &km->dout_tail, a.dout, a.h, KV::BQ},
                {&km->k, &km->k_tail, a.k, a.kvh, KV::BK},
                {&km->v, &km->v_tail, a.v, a.kvh, KV::BK}};
  for (const Tiled& m : tiled) {
    if (!encode(m.map, m.ptr, HD, m.heads, a.s, a.b, 64, m.rows, wide))
      return false;
    if (TAIL > 0 && !encode(m.tail, m.ptr, HD, m.heads, a.s, a.b, TAIL,
                            m.rows, narrow))
      return false;
  }
  return true;
}

// K1's launches on a.stream: the dQ kernel (grid H x B x query tiles), the
// dK / dV kernel (KV x B x key tiles, or x plan entries) and, with a plan,
// the sum of its partials.  A tensor map the driver will not encode
// returns cudaErrorInvalidValue; otherwise the first failing launch's
// cudaError_t.
template <int HD>
int launch(const Args<bf16>& a) {
  using Q = DqGeo<HD>;
  using KV = DkvGeo<HD>;
  DqMaps dm;
  DkvMaps km;
  if (!encode_maps<HD>(a, &dm, &km)) return (int)cudaErrorInvalidValue;
  auto kq = flash_bwd_dq_wgmma<HD>;
  auto kkv = flash_bwd_dkdv_wgmma<HD>;
  cudaError_t err = allow_smem(kq, Q::SMEM);
  if (err == cudaSuccess) err = allow_smem(kkv, KV::SMEM);
  if (err != cudaSuccess) return (int)err;
  kq<<<dim3(a.h, a.b, (a.s + Q::BQ - 1) / Q::BQ), THREADS, Q::SMEM,
       a.stream>>>(dm, a.out, a.dout, a.lse, a.delta, a.dq, a.s, a.h, a.kvh,
                   a.causal, a.window, a.prefix, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.s + KV::BK - 1) / KV::BK;
  kkv<<<dim3(a.kvh, a.b, a.plan ? a.nplan : tiles), THREADS, KV::SMEM,
        a.stream>>>(km, a.lse, a.delta, a.dk, a.dv,
                    reinterpret_cast<const int4*>(a.plan), a.ws, a.s, a.h,
                    a.kvh, a.causal, a.window, a.prefix, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.plan == nullptr) return (int)err;
  return launch_sum<SUM_PARTS>(a, tiles, flash_bwd_dkdv_sum<HD>);
}

// The head dim's launch, or cudaErrorInvalidValue for a head dim the
// kernels do not take (or, with bk > 0, for dK / dV tiles (bk, bq) that
// are not its own).
int dispatch(int hd, const Args<bf16>& a, int bk, int bq) {
#define WG_CASE(D)                                                         \
  case D:                                                                  \
    return bk > 0 && (bk != DkvGeo<D>::BK || bq != DkvGeo<D>::BQ)          \
               ? (int)cudaErrorInvalidValue                                \
               : launch<D>(a);
  switch (hd) {
    WG_CASE(80)
    WG_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef WG_CASE
}

}  // namespace wg

// ---------------------------------------------------------------------------
// bf16 at head dims 32, 64, 96 and 256: the mma.sync kernels

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

// dK and dV of a split from its f32 partials, rounded to bf16: one block
// a key tile (dkdv_sum).
template <int HD>
__global__ void __launch_bounds__(SUM_THREADS)
flash_bwd_dkdv_sum(const float* __restrict__ ws, const int* __restrict__ tiles,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int s,
                   int kvh) {
  dkdv_sum<DkvPlan<HD>::BK, HD, 1, false>(ws, tiles, dk, dv, s, kvh);
}

template <int HD>
int launch(const Args<bf16>& a) {
  return launch_k1<DqPlan<HD>, DkvPlan<HD>, 1>(
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
    TC_CASE(96)
    TC_CASE(256)
    default: return (int)cudaErrorInvalidValue;
  }
#undef TC_CASE
}

}  // namespace tc

// bf16 by head dim: 80 and 128 to the Hopper kernels (wg::), 32, 64, 96
// and 256 to the mma.sync ones (tc::; at head dim 64 the wgmma kernels
// ran slower than these at zamba2's shapes).
int dispatch_bf16(int hd, const Args<bf16>& a, int bk, int bq) {
  if (hd == 80 || hd == 128) return wg::dispatch(hd, a, bk, bq);
  return tc::dispatch(hd, a, bk, bq);
}

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

// dK and dV of a split from its f32 partials (dkdv_sum).
template <int HD>
__global__ void __launch_bounds__(SUM_THREADS)
flash_bwd_dkdv_sum(const float* __restrict__ ws, const int* __restrict__ tiles,
                   float* __restrict__ dk, float* __restrict__ dv, int s,
                   int kvh) {
  dkdv_sum<DkvPlan<HD>::BK, HD, SUM_PARTS, true>(ws, tiles, dk, dv, s, kvh);
}

template <int HD>
int launch(const Args<float>& a) {
  return launch_k1<DqPlan<HD>, DkvPlan<HD>, SUM_PARTS>(
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
    return dispatch_bf16(hd, args<bf16>(q, k, v, out, dout, lse, delta, dq,
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
    return dispatch_bf16(hd, args<bf16>(q, k, v, out, dout, lse, delta, dq,
                                        dk, dv, b, s, h, kvh, causal, window,
                                        prefix, scale, plan, nplan, ws,
                                        stream), bk, bq);
  return tf32x3::dispatch(hd, args<float>(q, k, v, out, dout, lse, delta,
                                          dq, dk, dv, b, s, h, kvh, causal,
                                          window, prefix, scale, plan, nplan,
                                          ws, stream), bk, bq);
}
