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
// entry takes one of three kernels by the input type and, for bf16, by
// the head dim (tc::dispatch's switch):
//
// bf16, head dims 64, 80 and 128 -> wg::flash_attention_bf16_wgmma, on
// the bf16 tensor cores by Hopper's wgmma, fed by TMA:
//   * one block of 3 warpgroups per (query tile of 128 rows, head, batch),
//     query tiles launched last-first.  Warpgroup 0 is the producer: one
//     thread issues every copy (cp.async.bulk.tensor, 4-d tensor maps over
//     (hd, heads, S, B), so positions past S arrive as zeros), and the
//     warpgroup hands its registers to the consumers (setmaxnreg 24 /
//     240).  Warpgroups 1 and 2 are the consumers, 64 query rows each;
//   * the Q tile once, then K and V tiles of 128 keys (64 at head dim 64
//     up to S = 256, SHORT_S) through a ring of 3 stages (2 at head dim
//     128) with full (K, V apart) and empty mbarriers: a stage is
//     refilled once both consumers have released it; key tiles wholly
//     past the block's last key limit or before its window are never
//     loaded;
//   * shared tiles are TMA's swizzled boxes, the layouts wgmma reads: 64
//     columns at a time with 128-byte rows and the 128-byte swizzle, and
//     at head dim 80 the last 16 columns as a box of their own with
//     32-byte rows and the 32-byte swizzle (no padding: Q K^T takes it as
//     a fifth k16 step, P V as an n16 product beside the n64 one);
//   * S = Q K^T: wgmma m64n128k16 (n64 on 64-key tiles), Q and K both
//     K-major from shared memory by descriptor (a k16 step moves the
//     start address 32 bytes inside a swizzle atom), f32 accumulators;
//   * the online softmax on the accumulators, as in the mma.sync kernel
//     below (each warp's 16 rows hold the m16n8 layout): exp2 with m in
//     the same units, m = -inf for a row with nothing kept so far, l
//     summed from the f32 p;
//   * O += P V with P in registers as two bf16 terms (hi, lo): the
//     accumulators of n8 tiles 2 kk and 2 kk + 1 are the A fragment of k16
//     step kk; two register-sourced wgmmas a step on one V descriptor (V
//     is [key][hd], MN-major: the transposed B that bf16 wgmma takes);
//     wgmma.fence before each product group, whose accumulator and P
//     registers the softmax wrote, commit and wait before they are read;
//   * each consumer issues tile i's P V and tile i + 1's S back to back,
//     waits for the P V (its stage is released), then for the S and runs
//     its softmax; on 128-key tiles the two consumers take turns to
//     issue (named barriers 1 and 2), so one's softmax runs beside the
//     other's products.  S, P (both terms) and O are live at
//     once: up to 216 registers a thread at head dim 128.  (FA3's order,
//     tile i + 1's S issued with tile i's P V and its softmax run under
//     that P V, was tried: no faster);
//   * the mask only on tiles a warpgroup's rows cut; a warpgroup computes
//     every tile the block loads (one wholly masked for its rows adds p =
//     0 and alpha = 1);
//   * O / l rounded to bf16 and written from the accumulators (4 bytes a
//     thread, a quad covers 16 bytes of a row); rows past S are not
//     written; LSE under WRITE_LSE.
//   A launch the kernel refuses (a tensor map the driver will not encode,
//   too much shared memory) returns its error; nothing falls back.
//   cuTensorMapEncodeTiled is found through
//   cudaGetDriverEntryPointByVersion, so the library links no libcuda.
//
// bf16, head dims 32, 96 and 256 -> tc::flash_attention_bf16_mma, on the
// bf16 tensor cores (mma.sync.m16n8k16, the FlashAttention-2 design):
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
// f32 -> flash_attention_3xtf32, on the TF32 tensor cores with split
// operands (the same FlashAttention-2 design).  One TF32 product rounds
// each operand to 10 mantissa bits and moves an output by about 5e-4 |v|,
// past the f32 path's 2e-4; so every operand x goes in as two TF32 terms,
// big = x rounded to TF32 and small = x - big (exact in f32), and each
// product is the three products small.big + big.small + big.big,
// small.small (2^-22 |ab|) dropped: about 21 bits of each operand, each
// product of two TF32 values exact in f32.  Three products at 495 TFLOP/s
// make 165 TFLOP/s of f32-exact work, 2.5x the fp32 FMA pipes:
//   * mma.sync.m16n8k8 (tf32); blocks of 8 warps, each warp on an m16
//     strip of query rows.  Two geometries: 128-row blocks, a strip a warp,
//     where their grid covers the SMs 1.5 times (WIDE); else 64-row blocks
//     whose two warps of a strip take one half of every key tile each,
//     their softmax states merged at the end through shared memory: twice
//     the blocks and half the keys a warp on a small grid, whose warps
//     otherwise run alone on their schedulers.  Head dim 256 takes the
//     64-row blocks always (its tiles fill shared memory).  Query tiles
//     are launched last-first;
//   * the split: big = (bits + 0x1000) & ~0x1fff, cvt.rna.tf32.f32's
//     rounding for a finite x in 2 instructions (cvt.rna takes 4, with its
//     guard for inf and NaN), and small goes in unrounded: the mma reads
//     its top 19 bits, leaving out less than 2^-21 |x|.  Each warp splits
//     the K and V fragments it reads, in registers (3 instructions an
//     element); Q is split once.  The products of a run of k8 steps are
//     summed from zero in the mma's accumulator and then added into S or
//     O by FADD (QK_RUN, PV_RUN): the accumulator's own sums over a whole
//     head dim and key range were 5-10x less exact;
//   * Q K^T: within each k8 step the contraction index is permuted, k = t
//     <-> head dim 2t and k = t + 4 <-> 2t + 1, for Q and K alike, so a
//     lane reads each fragment pair as one 64-bit load.  Q's split
//     fragments are read from global memory once and held in registers up
//     to head dim 128; at 256 they and O would not fit, and each k8 step
//     re-reads Q from a tile in shared memory and splits it;
//   * K and V tiles (64 keys; 32 at head dim 256) live in f32 shared
//     memory, row-major [key][hd], in a double-buffered ring filled by
//     cp.async.cg (16 bytes a thread, rows past S zero-filled): tile j + 1
//     is requested before the math on tile j, behind one __syncthreads a
//     tile.  K rows lie HD + 8 floats apart, V rows HD + 4, so the 64-bit
//     K reads (row g, columns 2t, 2t + 1) and the 32-bit V reads (rows 2t
//     and 2t + 1, column g) are free of bank conflicts at every head dim;
//   * the online softmax is the bf16 kernel's (exp2 in log2 units on the
//     accumulators, a row with no kept key keeping m = -inf);
//   * P V without shuffles or shared memory: the S accumulator of keys
//     8j .. 8j + 7 (lane holds columns 2t, 2t + 1 of rows g, g + 8) is
//     P's A fragment in place when the k index of the product is taken as
//     a permutation of those keys, k = t <-> key 2t and k = t + 4 <-> key
//     2t + 1; V's B fragment is read at the same keys (b0 = V[2t][g], b1 =
//     V[2t + 1][g]).  p is split in registers; l sums the f32 p;
//   * masks as in the bf16 kernel: the predicate only on tiles a warp's
//     rows cut, key tiles wholly past the block's last key limit or
//     before its window never loaded, rows and keys past S masked;
//   * O / l is written from the accumulators as float2 stores (each row's
//     32-byte runs whole); rows past S are not written.

#include <cuda.h>
#include <math.h>
#include <string.h>

#include "attention_common.cuh"
#include "wgmma_common.cuh"

namespace {

// The last key query qp keeps under the causal mask, before the window:
// qp, or the prefix's last key P - 1 for a query inside the prefix.
__device__ __forceinline__ int key_limit(int qp, int prefix) {
  return qp < prefix ? prefix - 1 : qp;
}

// Row pos's log-sum-exp in the scaled-score domain, from its running max
// m (log2 units) and its whole sum l = sum 2^(s * scale_log2 - m): (m +
// log2 l) ln 2, -inf for a row with no kept key (m = -inf, l = 0).  One
// lane of the row's quad (t == 0) writes it; rows past s are not written.
__device__ __forceinline__ void store_lse(float* lse, int64_t row0, int s,
                                          int pos, int t, float m, float l) {
  if (t == 0 && pos < s)
    lse[row0 * s + pos] = (m + log2f(l)) * 0.6931471805599453f;
}

// ---------------------------------------------------------------------------
// bf16 at head dims 64, 80 and 128: the Hopper kernel (TMA + wgmma)

namespace wg {

using bf16 = __nv_bfloat16;
using attn::exp2_approx;
using attn::pack_bf16;
using attn::smem_addr;
using attn::split_bf16;

constexpr int BQ = 128;        // query rows a block, 64 a consumer warpgroup
constexpr int THREADS = 384;   // the producer warpgroup, then two consumers
// registers a thread after setmaxnreg: the launch gives each of the 384
// threads 168 (65536 / 384, rounded down to a multiple of 8); the
// producer, which only issues copies, hands all but 24 to the consumers,
// 128 * 24 + 256 * 240 = 128 * 3 * 168 (their S, P and O take up to 216
// at head dim 128)
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

// Shared memory of one block.  A tile of R rows x HD columns is stored as
// HD / 64 parts of R rows x 64 columns (128-byte rows, TMA's 128-byte
// swizzle) and, at head dim 80, a tail of R rows x 16 columns (32-byte
// rows, its 32-byte swizzle): the swizzle atoms wgmma reads, each part
// one TMA box.  Every part starts on a 1024-byte boundary.  K and V
// tiles hold BK keys.
template <int HD, int BK_ = 128>
struct Geo {
  static constexpr int PARTS = HD / 64;    // 64-column parts
  static constexpr int TAIL = HD % 64;     // 0, or 16 columns
  static_assert(TAIL == 0 || TAIL == 16, "head dims 64, 80 and 128");
  static constexpr int BK = BK_;
  static constexpr int KSTEPS = HD / 16;   // k16 steps of Q K^T
  static constexpr int STAGES = HD <= 80 ? 3 : 2;   // the K / V ring
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;      // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // barriers: Q full, then K full, V full and empty for each stage
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;
};

// The tensor maps of one launch: q, k and v over (hd, heads, S, B), boxes
// of 64 columns (128-byte swizzle) and, at head dim 80, of the 16 columns
// past them (32-byte swizzle); passed by value as a __grid_constant__.
struct Maps {
  CUtensorMap q, k, v;
  CUtensorMap q_tail, k_tail, v_tail;
};

using namespace hopper;

// -- the consumers' steps ---------------------------------------------------

// Named barriers 1 and 2: consumer warpgroup w issues its products only
// after the other has issued its own and arrived on barrier 1 + w, so
// that one's products run on the tensor cores while the other's softmax
// runs on the other pipes.
__device__ __forceinline__ void turn_wait(int wgi) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(1 + wgi) : "memory");
}
__device__ __forceinline__ void turn_pass(int wgi) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(2 - wgi) : "memory");
}

// Issue S = Q K^T for the warpgroup's 64 rows (the Q tile's rows from
// row0) against a tile of 2 NS keys: m64 n(2 NS) k16 steps, both
// operands K-major in shared memory.
template <int HD, int NS>
__device__ __forceinline__ void issue_s(float (&sc)[NS], uint32_t q_tile,
                                        int row0, uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < Geo<HD>::KSTEPS; ++kk)
    mma_ss(sc, k_major<HD, BQ>(q_tile, row0, kk),
           k_major<HD, 2 * NS>(k_tile, 0, kk), kk > 0);
}

// Issue O += P V: P from registers as its two bf16 terms, V ([key][hd],
// MN-major) by descriptor; lo then hi on each of the tile's NK k16
// steps.
template <int HD, int OW, int TW, int NK>
__device__ __forceinline__ void issue_pv(float (&o)[OW / 2], float (&ot)[TW],
                                         const uint32_t (&hi)[NK][4],
                                         const uint32_t (&lo)[NK][4],
                                         uint32_t v_tile) {
  using G = Geo<HD>;
  constexpr int BK = 16 * NK;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv = desc(v_tile + kk * 16 * 128, BK * 128, 1024, 1);
    mma_rs(o, lo[kk], dv);
    mma_rs(o, hi[kk], dv);
    if constexpr (G::TAIL > 0) {
      const uint64_t dt =
          desc(v_tile + G::PARTS * BK * 128 + kk * 16 * 32, 256, 256, 3);
      mma_rs(ot, lo[kk], dt);
      mma_rs(ot, hi[kk], dt);
    }
  }
}

// The softmax of one tile of S on the accumulators, in place: the mask
// (on tiles the warpgroup's rows qw .. qw + 63 cut only), the running
// max m (log2 units) and sum l of rows r0 and r0 + 8 updated, sc turned
// into p; returns in alpha each row's rescale of O.
template <int NS, int BK = 2 * NS>
__device__ __forceinline__ void softmax(float (&sc)[NS], float (&m)[2],
                                        float (&l)[2], float (&alpha)[2],
                                        int k0, int qw, int r0, int t, int s,
                                        int causal, int window, int prefix,
                                        float scale_log2) {
  const bool interior = k0 + BK <= s &&
                        (!causal || k0 + BK - 1 <= key_limit(qw, prefix)) &&
                        (window <= 0 || k0 > qw + 63 - window);
  if (!interior) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * j + 2 * t + (e & 1);
        const int qp = r0 + 8 * (e >> 1);
        const bool keep = kp < s &&
                          (!causal || kp <= key_limit(qp, prefix)) &&
                          (window <= 0 || kp > qp - window);
        if (!keep) sc[4 * j + e] = -INFINITY;
      }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  float neg_m[2];
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
      sc[4 * j + e] =
          exp2_approx(fmaf(sc[4 * j + e], scale_log2, neg_m[e >> 1]));
      rs[e >> 1] += sc[4 * j + e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
}

// O's accumulator rows r0 (e = 0, 1) and r0 + 8 (e = 2, 3) times alpha.
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// -- the kernel -------------------------------------------------------------

template <int HD, int BK, bool WRITE_LSE>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_bf16_wgmma(const __grid_constant__ Maps maps,
                           bf16* __restrict__ out, int s, int h, int kvh,
                           int causal, int window, int prefix,
                           float scale_log2, float* __restrict__ lse) {
  using G = Geo<HD, BK>;
  constexpr int OW = 64 * G::PARTS;          // O's columns, wide products
  constexpr int TW = G::TAIL ? G::TAIL / 2 : 1;   // the tail's accumulators
  constexpr int ST = G::STAGES;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_tile = base;
  const uint32_t k_tiles = base + G::K_OFF;
  const uint32_t v_tiles = base + G::V_OFF;
  const uint32_t q_full = base + G::BAR_OFF;
  const uint32_t k_full = q_full + 8;             // + 8 * stage
  const uint32_t v_full = k_full + 8 * ST;
  const uint32_t empty = v_full + 8 * ST;

  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int kv_head = head / (h / kvh);

  // live key tiles: not wholly past the key limit of the block's last row,
  // not wholly before the window of its first row
  const int q_last = min(q0 + BQ, s) - 1;
  int kt_end = (s + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, key_limit(q_last, prefix) / BK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;
  const int tiles = kt_end - kt_begin;

  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
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
      bar_expect(q_full, G::Q_BYTES);
      load_tile<HD, BQ>(maps.q, maps.q_tail, q_tile, q_full, head, q0, b);
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
  } else {
    // a consumer warpgroup: 64 query rows over every tile the producer
    // loads.  Tile i's P V and tile i + 1's S go out back to back, in
    // turns with the other consumer's products, and the softmax of that S
    // runs while the other warpgroup's products do.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(CONSUMER_REGS));
    const int tid = threadIdx.x - 128;
    const int wgi = role - 1;            // consumer warpgroup 0 or 1
    const int warp = (tid >> 5) & 3;     // its warps own 16 rows each
    const int lane = tid & 31;
    const int t = lane & 3;              // accumulator column pair
    const int qw = q0 + 64 * wgi;        // the warpgroup's first row
    const int r0 = qw + 16 * warp + (lane >> 2);   // rows r0, r0 + 8

    float o[OW / 2];                     // O, columns 0 .. OW - 1
    float ot[TW];                        // O, the tail's 16 columns
#pragma unroll
    for (int i = 0; i < OW / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < TW; ++i) ot[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};   // rows r0 and r0 + 8, log2 units
    float l[2] = {0.f, 0.f};               // this thread's columns only
    float alpha[2];
    float sc[BK / 2];                      // S, then P: n8 tile j, e = 0..3
    uint32_t hi[BK / 16][4], lo[BK / 16][4];   // P's A fragments

    // the turns pay on 128-key tiles; in the short calls' blocks of
    // 64-key tiles they only delay the second warpgroup
    constexpr bool turns = BK == 128;
    if (turns && wgi == 1) turn_pass(wgi);   // warpgroup 0 issues first
    bar_wait(q_full, 0);
    bar_wait(k_full, 0);
    if (turns) turn_wait(wgi);
    fence_regs(sc);
    mma_fence();
    issue_s<HD>(sc, q_tile, 64 * wgi, k_tiles);
    mma_commit();
    if (turns) turn_pass(wgi);
    mma_wait<0>();
    fence_regs(sc);
    softmax(sc, m, l, alpha, kt_begin * BK, qw, r0, t, s, causal, window,
            prefix, scale_log2);
    split_p(sc, hi, lo);

    for (int i = 0; i < tiles; ++i) {
      const int st = i % ST, next = (i + 1) % ST;
      const bool more = i + 1 < tiles;
      bar_wait(v_full + 8 * st, (i / ST) & 1);
      if (turns) turn_wait(wgi);
      fence_regs(o);
      fence_regs(ot);
      fence_regs(sc);
      mma_fence();
      issue_pv<HD, OW, TW>(o, ot, hi, lo, v_tiles + st * G::KV_BYTES);
      mma_commit();
      if (more) {
        bar_wait(k_full + 8 * next, ((i + 1) / ST) & 1);
        issue_s<HD>(sc, q_tile, 64 * wgi, k_tiles + next * G::KV_BYTES);
        mma_commit();
      }
      // every turn_wait of both warpgroups is matched: warpgroup 1 passed
      // once before its first
      if (turns && (more || wgi == 0)) turn_pass(wgi);
      if (more) {
        mma_wait<1>();   // tile i's P V is done; tile i + 1's S may run on
      } else {
        mma_wait<0>();
      }
      fence_regs(o);
      fence_regs(ot);
      bar_arrive(empty + 8 * st);
      if (more) {
        mma_wait<0>();
        fence_regs(sc);
        softmax(sc, m, l, alpha, (kt_begin + i + 1) * BK, qw, r0, t, s,
                causal, window, prefix, scale_log2);
        rescale(o, alpha);
        rescale(ot, alpha);
        split_p(sc, hi, lo);
      }
    }

    // epilogue: O / l in bf16 from the accumulators; rows past S are not
    // written
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lr = attn::group_sum<4>(l[r]);
      inv[r] = 1.f / fmaxf(lr, 1e-30f);
      if constexpr (WRITE_LSE) store_lse(lse, (int64_t)b * h + head, s,
                                         r0 + 8 * r, t, m[r], lr);
    }
    const int64_t q_row = (int64_t)h * HD;
    bf16* ob = out + ((int64_t)b * s * h + head) * HD + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r0 + 8 * r >= s) continue;
      bf16* row = ob + (r0 + 8 * r) * q_row;
#pragma unroll
      for (int j = 0; j < OW / 8; ++j)
        *reinterpret_cast<uint32_t*>(row + 8 * j) =
            pack_bf16(o[4 * j + 2 * r] * inv[r],
                      o[4 * j + 2 * r + 1] * inv[r]);
#pragma unroll
      for (int j = 0; j < G::TAIL / 8; ++j)
        *reinterpret_cast<uint32_t*>(row + OW + 8 * j) = pack_bf16(
            ot[4 * j + 2 * r] * inv[r], ot[4 * j + 2 * r + 1] * inv[r]);
    }
  }
}

// -- the launch -------------------------------------------------------------

template <int HD, int BK, bool WRITE_LSE>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int b, int s, int h, int kvh, int causal, int window,
           int prefix, float scale, cudaStream_t stream) {
  using G = Geo<HD, BK>;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  const CUtensorMapSwizzle wide = CU_TENSOR_MAP_SWIZZLE_128B;
  bool ok = bind_device(q) &&
            encode(&maps.q, q, HD, h, s, b, 64, BQ, wide) &&
            encode(&maps.k, k, HD, kvh, s, b, 64, G::BK, wide) &&
            encode(&maps.v, v, HD, kvh, s, b, 64, G::BK, wide);
  if (G::TAIL > 0) {
    const CUtensorMapSwizzle narrow = CU_TENSOR_MAP_SWIZZLE_32B;
    ok = ok && encode(&maps.q_tail, q, HD, h, s, b, G::TAIL, BQ, narrow) &&
         encode(&maps.k_tail, k, HD, kvh, s, b, G::TAIL, G::BK, narrow) &&
         encode(&maps.v_tail, v, HD, kvh, s, b, G::TAIL, G::BK, narrow);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  auto kern = flash_attention_bf16_wgmma<HD, BK, WRITE_LSE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(h, b, (s + BQ - 1) / BQ);
  kern<<<grid, THREADS, G::SMEM, stream>>>(
      maps, static_cast<bf16*>(out), s, h, kvh, causal, window, prefix,
      scale * 1.4426950408889634f, lse);
  return (int)cudaGetLastError();
}

// Head dim 64 up to this S takes 64-key tiles: its blocks hold few tiles,
// and smaller ones start the math sooner.  Every other call, 128 keys.
constexpr int SHORT_S = 256;

int dispatch(int hd, const void* q, const void* k, const void* v, void* out,
             float* lse, int b, int s, int h, int kvh, int causal,
             int window, int prefix, float scale, cudaStream_t stream) {
#define FA_LAUNCH(D, K)                                                     \
  (lse ? launch<D, K, true>(q, k, v, out, lse, b, s, h, kvh, causal,       \
                            window, prefix, scale, stream)                 \
       : launch<D, K, false>(q, k, v, out, lse, b, s, h, kvh, causal,      \
                             window, prefix, scale, stream))
  switch (hd) {
    case 64: return s <= SHORT_S ? FA_LAUNCH(64, 64) : FA_LAUNCH(64, 128);
    case 80: return FA_LAUNCH(80, 128);
    case 128: return FA_LAUNCH(128, 128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FA_LAUNCH
}

}  // namespace wg

// ---------------------------------------------------------------------------
// bf16 at head dims 32, 96 and 256: the mma.sync kernel

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

template <int HD, int MIN_BLOCKS, bool WRITE_LSE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_attention_bf16_mma(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ out,
                         int s, int h, int kvh, int causal, int window,
                         int prefix, float scale_log2,
                         float* __restrict__ lse) {
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
  for (int r = 0; r < 2; ++r) {
    const float lr = attn::group_sum<4>(l[r]);
    inv[r] = 1.f / fmaxf(lr, 1e-30f);
    if constexpr (WRITE_LSE) store_lse(lse, (int64_t)b * h + head, s,
                                       qw + g + 8 * r, t, m[r], lr);
  }
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

template <int HD, bool WRITE_LSE>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int b, int s, int h, int kvh, int causal, int window,
           int prefix, float scale, cudaStream_t stream) {
  // two blocks an SM (at most 128 registers a thread) where the Q, S and
  // O fragments fit; one above (at head dim 256 shared memory holds one)
  constexpr int MIN_BLOCKS = HD <= 80 ? 2 : 1;
  constexpr size_t smem = smem_bytes<HD>();
  auto kern = flash_attention_bf16_mma<HD, MIN_BLOCKS, WRITE_LSE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(h, b, (s + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), s, h, kvh,
      causal, window, prefix, scale * 1.4426950408889634f, lse);
  return (int)cudaGetLastError();
}

int dispatch(int hd, const void* q, const void* k, const void* v, void* out,
             float* lse, int b, int s, int h, int kvh, int causal,
             int window, int prefix, float scale, cudaStream_t stream) {
#define FA_LAUNCH(D)                                                        \
  (lse ? launch<D, true>(q, k, v, out, lse, b, s, h, kvh, causal, window,  \
                         prefix, scale, stream)                            \
       : launch<D, false>(q, k, v, out, lse, b, s, h, kvh, causal, window, \
                          prefix, scale, stream))
  // the route by head dim: 64, 80 and 128 to the Hopper kernel (wg::),
  // 32, 96 and 256 to flash_attention_bf16_mma
  switch (hd) {
    case 32: return FA_LAUNCH(32);
    case 64:
    case 80:
    case 128:
      return wg::dispatch(hd, q, k, v, out, lse, b, s, h, kvh, causal,
                          window, prefix, scale, stream);
    case 96: return FA_LAUNCH(96);
    case 256: return FA_LAUNCH(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FA_LAUNCH
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32: the split-TF32 tensor-core kernel

namespace tf32x3 {

using attn::add4;
using attn::cp_async16;
using attn::cp_async_commit;
using attn::cp_async_wait;
using attn::exp2_approx;
using attn::mma_split;
using attn::smem_addr;
using attn::split_tf32;

// Geometry of a block: 8 warps, each on a strip of 16 query rows and BKW
// keys of each BK-key K / V tile.  Without KSPLIT the 8 warps take 8
// strips (128 rows) and whole tiles; with it, 4 strips (64 rows), and the
// warps of a strip's pair each take one half of every tile, their partial
// softmax sums merged at the end.
template <int HD, bool KSPLIT>
struct Tile {
  static constexpr int THREADS = 256;
  static constexpr int STRIPS = KSPLIT ? 4 : 8;
  static constexpr int BQ = 16 * STRIPS;
  static constexpr int BK = HD <= 128 ? 64 : 32;
  static constexpr int BKW = KSPLIT ? BK / 2 : BK;
  static constexpr int LDK = HD + 8;   // row stride of K and Q tiles
  static constexpr int LDV = HD + 4;   // row stride of V tiles
  // Q's split fragments held in registers for the whole key loop, or
  // re-read from a Q tile at each k8 step (where they and O would not fit)
  static constexpr bool Q_IN_REGS = HD <= 128;
  static constexpr size_t SMEM =
      sizeof(float) * (2 * BK * (LDK + LDV) + (Q_IN_REGS ? 0 : BQ * LDK));
  // k8 steps whose products a run sums from zero in the mma's accumulator
  // before an f32 add takes the run into S or O.  On an H100 a running
  // sum kept in the accumulator over a whole head dim and key range came
  // out 5-10x further from the plain version than the FMA kernel's sums,
  // and moved a 4-layer f32 forward's logits by 2e-4 (phase 11's limit is
  // 1e-4): the accumulator's adds are not the FADD's round-to-nearest.  Q K^T runs
  // half a head dim where Q's fragments are in registers (2 k8 steps at
  // 256, whose run's fragments are read from the Q tile), P V 16 keys.
  static constexpr int QK_RUN = Q_IN_REGS ? HD / 16 : 2;
  static constexpr int PV_RUN = 2;
  static_assert(sizeof(float) * BQ * (HD + 2) <= SMEM,
                "the halves' merge fits in the ring");
};

// Start copying rows pos0 .. pos0 + ROWS - 1 of a (rows x HD) f32 matrix
// whose rows lie `row_stride` elements apart into dst[row * LD + d]; rows
// at or past `limit` are zero-filled.
template <int HD, int ROWS, int LD, int THREADS>
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
    cp_async16(smem_addr(dst + row * LD + col),
               src + (valid ? pos * row_stride + col : 0), valid);
  }
}

template <int HD, bool KSPLIT, bool WRITE_LSE>
__global__ void __launch_bounds__(256, 1)
flash_attention_3xtf32(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int s, int h, int kvh, int causal, int window,
                       int prefix, float scale_log2,
                       float* __restrict__ lse) {
  using G = Tile<HD, KSPLIT>;
  constexpr int THREADS = G::THREADS, BQ = G::BQ, BK = G::BK, BKW = G::BKW;
  constexpr int LDK = G::LDK, LDV = G::LDV;
  constexpr int QK_RUN = G::QK_RUN, PV_RUN = G::PV_RUN;
  constexpr int KSTEPS = HD / 8;   // k8 steps of Q K^T
  constexpr int NT = HD / 8;       // n8 tiles of O
  static_assert(KSTEPS * 8 == HD, "head_dim must be a multiple of 8");
  static_assert(KSTEPS % QK_RUN == 0 && BKW / 8 % PV_RUN == 0,
                "runs must cut the k8 steps evenly");

  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                  // [2][BK][LDK]
  float* vs = ks + 2 * BK * LDK;     // [2][BK][LDV]
  float* qs = vs + 2 * BK * LDV;     // [BQ][LDK], unless Q_IN_REGS

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;       // fragment row (and row + 8)
  const int t = lane & 3;        // fragment column pair
  const int strip = warp % G::STRIPS;
  const int half = warp / G::STRIPS;   // the warp's keys of each tile
  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int qw = q0 + 16 * strip;   // the warp's first query row
  const int kv_head = head / (h / kvh);
  const int64_t q_row = (int64_t)h * HD;
  const int64_t kv_row = (int64_t)kvh * HD;
  const float* qb = q + ((int64_t)b * s * h + head) * HD;
  const float* kb = k + ((int64_t)b * s * kvh + kv_head) * HD;
  const float* vb = v + ((int64_t)b * s * kvh + kv_head) * HD;
  float* ob = out + ((int64_t)b * s * h + head) * HD;

  // live key tiles: not wholly past the key limit of the block's last row,
  // not wholly before the window of its first row
  const int q_last = min(q0 + BQ, s) - 1;
  int kt_end = (s + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, key_limit(q_last, prefix) / BK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;

  if constexpr (!G::Q_IN_REGS) {
    load_tile_async<HD, BQ, LDK, THREADS>(qb, q_row, q0, s, qs);
  }
  load_tile_async<HD, BK, LDK, THREADS>(kb, kv_row, kt_begin * BK, s, ks);
  load_tile_async<HD, BK, LDV, THREADS>(vb, kv_row, kt_begin * BK, s, vs);
  cp_async_commit();

  // Q's A fragment of k8 step kk: a0 = (row g, hd 2t), a1 = (g + 8, 2t),
  // a2 = (g, 2t + 1), a3 = (g + 8, 2t + 1), split once
  uint32_t qbf[G::Q_IN_REGS ? KSTEPS : 1][4];
  uint32_t qsf[G::Q_IN_REGS ? KSTEPS : 1][4];
  if constexpr (G::Q_IN_REGS) {
    const float2 zero = make_float2(0.f, 0.f);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const int col = 8 * kk + 2 * t;
      const float2 x0 = qw + g < s ? *reinterpret_cast<const float2*>(
                                         qb + (qw + g) * q_row + col)
                                   : zero;
      const float2 x1 = qw + g + 8 < s ? *reinterpret_cast<const float2*>(
                                             qb + (qw + g + 8) * q_row + col)
                                       : zero;
      split_tf32(x0.x, qbf[kk][0], qsf[kk][0]);
      split_tf32(x1.x, qbf[kk][1], qsf[kk][1]);
      split_tf32(x0.y, qbf[kk][2], qsf[kk][2]);
      split_tf32(x1.y, qbf[kk][3], qsf[kk][3]);
    }
  }
  const float* qrow = qs + (16 * strip + g) * LDK + 2 * t;

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // rows g and g + 8, log2 units
  float l[2] = {0.f, 0.f};               // this thread's columns only

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int buf = (kt - kt_begin) & 1;
    cp_async_wait<0>();   // tile kt (and the Q tile) is in
    __syncthreads();      // ... for every thread; the other buffer is free
    if (kt + 1 < kt_end) {
      load_tile_async<HD, BK, LDK, THREADS>(kb, kv_row, (kt + 1) * BK, s,
                                            ks + (buf ^ 1) * BK * LDK);
      load_tile_async<HD, BK, LDV, THREADS>(vb, kv_row, (kt + 1) * BK, s,
                                            vs + (buf ^ 1) * BK * LDV);
    }
    cp_async_commit();

    const int k0 = kt * BK + half * BKW;   // the warp's first key
    // keys wholly masked for this warp's rows (or a warp past S)
    if (qw >= s || k0 >= s || (causal && k0 > key_limit(qw + 15, prefix)) ||
        (window > 0 && k0 + BKW - 1 <= qw - window))
      continue;

    // S = Q K^T: BKW / 8 n8 tiles, runs of QK_RUN k8 steps; K's pair (b0,
    // b1) = K[key g][hd 2t, 2t + 1] of each k8 step, one 64-bit read
    float sc[BKW / 8][4];
#pragma unroll
    for (int j = 0; j < BKW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    const float* krow =
        ks + buf * BK * LDK + (half * BKW + g) * LDK + 2 * t;
#pragma unroll
    for (int kr = 0; kr < KSTEPS; kr += QK_RUN) {
      uint32_t qbig[QK_RUN][4], qsmall[QK_RUN][4];
#pragma unroll
      for (int r = 0; r < QK_RUN; ++r) {
        const int kk = kr + r;
        if constexpr (G::Q_IN_REGS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            qbig[r][e] = qbf[kk][e];
            qsmall[r][e] = qsf[kk][e];
          }
        } else {
          const float2 x0 = *reinterpret_cast<const float2*>(qrow + 8 * kk);
          const float2 x1 =
              *reinterpret_cast<const float2*>(qrow + 8 * LDK + 8 * kk);
          split_tf32(x0.x, qbig[r][0], qsmall[r][0]);
          split_tf32(x1.x, qbig[r][1], qsmall[r][1]);
          split_tf32(x0.y, qbig[r][2], qsmall[r][2]);
          split_tf32(x1.y, qbig[r][3], qsmall[r][3]);
        }
      }
#pragma unroll
      for (int j = 0; j < BKW / 8; ++j) {
        float ds[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int r = 0; r < QK_RUN; ++r) {
          const float2 kp = *reinterpret_cast<const float2*>(
              krow + 8 * j * LDK + 8 * (kr + r));
          mma_split(ds, qbig[r], qsmall[r], kp.x, kp.y);
        }
        add4(sc[j], ds);
      }
    }

    // the mask, on keys the warp's rows cut only
    const bool interior = k0 + BKW <= s &&
                          (!causal || k0 + BKW - 1 <= key_limit(qw, prefix)) &&
                          (window <= 0 || k0 > qw + 15 - window);
    if (!interior) {
#pragma unroll
      for (int j = 0; j < BKW / 8; ++j)
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
    for (int j = 0; j < BKW / 8; ++j) {
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
    for (int j = 0; j < BKW / 8; ++j)
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

    // O += P V: keys 8kk .. 8kk + 7 are k8 step kk, k = t <-> key 2t and
    // k = t + 4 <-> key 2t + 1, so P's A fragment is S's accumulator
    // (a0, a1, a2, a3) = (sc[0], sc[2], sc[1], sc[3]); V's pair (b0, b1) =
    // V[key 2t, 2t + 1][hd g] of each n8 tile; runs of PV_RUN k8 steps
    const float* vrow =
        vs + buf * BK * LDV + (half * BKW + 2 * t) * LDV + g;
#pragma unroll
    for (int kr = 0; kr < BKW / 8; kr += PV_RUN) {
      uint32_t pbig[PV_RUN][4], psmall[PV_RUN][4];
#pragma unroll
      for (int r = 0; r < PV_RUN; ++r) {
        split_tf32(sc[kr + r][0], pbig[r][0], psmall[r][0]);
        split_tf32(sc[kr + r][2], pbig[r][1], psmall[r][1]);
        split_tf32(sc[kr + r][1], pbig[r][2], psmall[r][2]);
        split_tf32(sc[kr + r][3], pbig[r][3], psmall[r][3]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int r = 0; r < PV_RUN; ++r) {
          const float* vk = vrow + 8 * (kr + r) * LDV + 8 * n;
          mma_split(dp, pbig[r], psmall[r], vk[0], vk[LDV]);
        }
        add4(o[n], dp);
      }
    }
  }

  // rows g and g + 8: the whole row's l and, with KSPLIT, the two halves
  // merged by the first: the second's m, l and O through shared memory
  // (the ring's, free once every warp is past the loop)
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = attn::group_sum<4>(l[r]);
  if constexpr (KSPLIT) {
    float* mo = smem;                     // [BQ][HD]: the second half's O
    float* ml = smem + BQ * HD;           // [BQ][2]: its m and l
    const int row0 = 16 * strip + g;
    cp_async_wait<0>();
    __syncthreads();
    if (half == 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float* orow = mo + (row0 + 8 * r) * HD + 2 * t;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          *reinterpret_cast<float2*>(orow + 8 * n) =
              make_float2(o[n][2 * r], o[n][2 * r + 1]);
        if (t == 0)
          *reinterpret_cast<float2*>(ml + 2 * (row0 + 8 * r)) =
              make_float2(m[r], l[r]);
      }
    }
    __syncthreads();
    if (half == 1) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 other = *reinterpret_cast<const float2*>(
          ml + 2 * (row0 + 8 * r));
      const float m_new = fmaxf(m[r], other.x);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float a0 = exp2_approx(m[r] - m_use);
      const float a1 = exp2_approx(other.x - m_use);
      l[r] = l[r] * a0 + other.y * a1;
      if constexpr (WRITE_LSE) m[r] = m_new;
      const float* orow = mo + (row0 + 8 * r) * HD + 2 * t;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 x = *reinterpret_cast<const float2*>(orow + 8 * n);
        o[n][2 * r] = o[n][2 * r] * a0 + x.x * a1;
        o[n][2 * r + 1] = o[n][2 * r + 1] * a0 + x.y * a1;
      }
    }
  }

  // epilogue: O / l, rows g and g + 8, columns 2t, 2t + 1 of each n8 tile
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = qw + g + 8 * r;
    if constexpr (WRITE_LSE) store_lse(lse, (int64_t)b * h + head, s, pos,
                                       t, m[r], l[r]);
    if (pos >= s) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    float* orow = ob + pos * q_row + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

template <int HD, bool KSPLIT, bool WRITE_LSE>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int b, int s, int h, int kvh, int causal, int window,
           int prefix, float scale, cudaStream_t stream) {
  using G = Tile<HD, KSPLIT>;
  auto kern = flash_attention_3xtf32<HD, KSPLIT, WRITE_LSE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(h, b, (s + G::BQ - 1) / G::BQ);
  kern<<<grid, G::THREADS, G::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), s, h, kvh,
      causal, window, prefix, scale * 1.4426950408889634f, lse);
  return (int)cudaGetLastError();
}

// The device's SM count, read once a device.
int sm_count() {
  static int counts[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 64) return 0;
  if (counts[dev] == 0)
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
}

// 128-row blocks where their grid covers the SMs WIDE / 2 times, else
// 64-row blocks whose warps split the keys (twice the blocks, each warp
// half the keys, where the grid is small).
constexpr int WIDE = 3;

int dispatch(int hd, const void* q, const void* k, const void* v, void* out,
             float* lse, int b, int s, int h, int kvh, int causal,
             int window, int prefix, float scale, cudaStream_t stream) {
  const bool wide =
      2 * (int64_t)((s + 127) / 128) * h * b >= WIDE * sm_count();
#define FA_LAUNCH(D, KSPLIT)                                               \
  (lse ? launch<D, KSPLIT, true>(q, k, v, out, lse, b, s, h, kvh, causal,  \
                                 window, prefix, scale, stream)            \
       : launch<D, KSPLIT, false>(q, k, v, out, lse, b, s, h, kvh, causal, \
                                  window, prefix, scale, stream))
  switch (hd) {
    case 32: return wide ? FA_LAUNCH(32, false) : FA_LAUNCH(32, true);
    case 64: return wide ? FA_LAUNCH(64, false) : FA_LAUNCH(64, true);
    case 80: return wide ? FA_LAUNCH(80, false) : FA_LAUNCH(80, true);
    case 96: return wide ? FA_LAUNCH(96, false) : FA_LAUNCH(96, true);
    case 128: return wide ? FA_LAUNCH(128, false) : FA_LAUNCH(128, true);
    case 256: return FA_LAUNCH(256, true);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FA_LAUNCH
}

}  // namespace tf32x3

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
    return tc::dispatch(hd, q, k, v, out, nullptr, b, s, h, kvh, causal,
                        window, prefix, scale, st);
  return tf32x3::dispatch(hd, q, k, v, out, nullptr, b, s, h, kvh, causal,
                          window, prefix, scale, st);
}

// flash_attention_fwd that also writes each row's log-sum-exp, lse (b, h,
// s) f32: log sum_k exp(q.k * scale) over the row's kept keys, in the
// scaled-score domain (-inf for a row that keeps none), which the
// backward (flash_attention_bwd.cu) reads to recompute P.  The same
// kernels, instantiated with WRITE_LSE; flash_attention_fwd's instances
// are unchanged.
extern "C" int flash_attention_fwd_lse(const void* q, const void* k,
                                       const void* v, void* out, float* lse,
                                       int b, int s, int h, int kvh, int hd,
                                       int causal, int window, int prefix,
                                       int bf16, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (prefix < 0 || lse == nullptr) return (int)cudaErrorInvalidValue;
  if (bf16)
    return tc::dispatch(hd, q, k, v, out, lse, b, s, h, kvh, causal, window,
                        prefix, scale, st);
  return tf32x3::dispatch(hd, q, k, v, out, lse, b, s, h, kvh, causal,
                          window, prefix, scale, st);
}
