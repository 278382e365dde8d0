// Flash decoding for Hopper (sm_90a): one query token per sequence attends
// over the first n_valid slots of a KV cache, each group of H / KV query
// heads over its shared KV head; bf16 or f32 cache, f32 scores, softmax
// and accumulation, output in the input type.
//
// Replaces the Pallas TPU kernel of the reference package:
//   * flash_decode_pallas  (src/repro/kernels/flash_decode.py:69)
//     -> entry flash_decode_fwd.  The reference model computes the same
//     function with a masked grouped einsum in decode_attention
//     (src/repro/models/attention.py:260), which this kernel serves.
//   * the same kernel's row statistics, which flash_decode_pallas returns
//     as (acc, m, l) and its wrapper drops (src/repro/kernels/ops.py:214)
//     -> entry flash_decode_fwd_lse: the output unrounded in f32 and the
//     row log-sum-exp, for a cache split by slots over ranks (the
//     reference's "cache_seq" rule, where GSPMD splits the softmax over
//     the shards: src/repro/models/attention.py:251), whose partials the
//     caller merges by their LSE.  Only the merge differs (WRITE_LSE).
//
// Layout: q (B, H, HD), caches (B, L, KV, HD), out (B, H, HD), contiguous.
// Slots 0 .. n_valid-1 are valid (a sliding-window ring is full once it has
// wrapped); attention does not depend on slot order, since rope is applied
// before a key is written.
//
// Bound on the card: memory.  Each step reads 2 * B * n_valid * KV * HD
// cache elements once for 4 * B * H * n_valid * HD FLOPs (about 2 FLOPs per
// cache byte in bf16 at H / KV = 4), far below the card's ratio.  So the
// design streams the cache and keeps every other cost off that stream.
//
// n_valid is read on the card (from a device int, or a host int passed by
// value), and the launches are fixed by the cache's shape: grid (nsplit,
// KV / heads a block, B), nsplit chosen by the host from B, KV, L and the
// SM count.  Each block reads n_valid and takes every nsplit-th tile of the
// valid slots (at each step the blocks of a batch row read neighbouring
// tiles, so the grid sweeps the cache together); a split with no tile loads
// nothing and reports m = -inf, l = 0.  So the same launches
// serve every step and can be captured in a CUDA graph.
//
// bf16 caches (flash_decode_bf16_mma, the serving path): one block of
// TC_WARPS warps covers KVB = gcd(KV, TC_HEADS) neighbouring KV heads and
// streams whole runs of KVB * HD elements of each cache row.  A block of
// one head would read rows of HD elements scattered KV * HD apart (160 of
// every 1280 bytes at danube's 8 x 80), which the card streams at about 2
// TB/s where runs of 640 bytes and more reach its 2.7.
//   * Stream: tiles of K and V in a ring of TC_STAGES buffers filled by
//     cp.async (16 bytes a copy, slots past n_valid zero-filled), one
//     barrier per tile; in shared memory each head's keys are rows of
//     HD + 8 elements, so ldmatrix reads them without bank conflicts.
//   * Each warp owns one head of the block and 16 * TC_UNITS slots of each
//     tile (a head has TC_WARPS / KVB warps).  Its query group -- up to 16
//     heads, the m16 rows of an mma tile, rows past H / KV zero -- sits in
//     registers as bf16 A fragments.  S = Q K^T by mma.sync m16n8k16 (bf16
//     products, exact in f32, summed in f32), an online softmax on the
//     accumulators in log2 units, and O += P V by mma.sync with P taken
//     from the accumulators as three bf16 terms hi + mid + lo, which hold
//     the f32 p to about 2^-24: p stays f32 to its own rounding.  So each
//     K and V element is read from shared memory once, by ldmatrix.
// Head dim 256 (paligemma): one warp's O accumulators alone take 128
// registers a thread, so the query group's fragments do not stay in
// registers beside them: the block stages its heads' query groups in
// shared memory once and each k16 step reads its fragment by ldmatrix, the
// copies' offsets are computed per tile rather than held, and the ring has
// two stages, so that ring and query groups fit the block's shared memory
// (TcPlan::Q_SMEM).
// f32 caches (flash_decode_f32, the exact path) stay on the fp32 FMA
// pipes: one block of THREADS threads per (split, KV head, batch), a ring
// of STAGES tiles of BK slots; LPK lanes a key read each K chunk once and
// multiply it into all G query heads of the group (float4 broadcasts of the
// queries); a lane owns 4 output dims of all G heads for P V, 8 above head
// dim 128 (a warp's 32 lanes then cover a row of 256).
//
// Each split writes the partial (acc, m, l) of each of its heads -- the TPU
// kernel's own running state -- to a workspace: a warp that owns its head
// alone straight from its accumulators, else after merging the head's
// warps in shared memory.  A second launch (flash_decode_merge, one thread
// an output, a programmatic dependent of the first: its blocks are placed
// while the split pass drains) merges the splits in a fixed order: out =
// sum_i 2^(m_i - M) acc_i / sum_i 2^(m_i - M) l_i, a split with l = 0
// weighed 0.  The output is the same, bit for bit, from run to run.
// (Merging in the last block to finish, by an atomic counter, or in a
// thread-block cluster's shared memory measured slower, and so did runs of
// consecutive tiles and a merge launched after the split pass has ended:
// tools/torch_flash_decode_variants.py, PERF.md.)
//
// tools/torch_flash_decode_variants.py rebuilds this file with other
// values of the constants below, or other text, and times them side by
// side.

#include <math.h>

#include <type_traits>

#include "attention_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_SPLITS = 64;
constexpr int MAX_GROUP = 16;      // query heads per KV head

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

// 2^x by the special-function unit (relative error about 2^-22; 2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The split pass's blocks let the merge's blocks be placed once each has
// done its loads (the merge waits for the whole pass at griddepcontrol.wait).
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// A block's partial from its warps' partials, merged in a fixed order: row
// r = head * g + gi of bacc [nheads * g][hd] and bml [nheads * g][2] (m, l)
// takes warps w = head, head + nheads, ... below warps, whose row gi is
// pacc [w * wrows + gi][hd] and wml [w * wrows + gi][2]; a warp with
// m = -inf (no valid key) weighs 0.
__device__ void merge_warps(const float* pacc, const float* wml, int warps,
                            int wrows, int nheads, int g, int hd,
                            float* bacc, float* bml) {
  for (int idx = threadIdx.x; idx < nheads * g * hd; idx += blockDim.x) {
    const int r = idx / hd;
    const int d = idx - r * hd;
    const int head = r / g;
    const int gi = r - head * g;
    float mx = -INFINITY;
    for (int w = head; w < warps; w += nheads)
      mx = fmaxf(mx, wml[(w * wrows + gi) * 2]);
    float num = 0.f, den = 0.f;
    for (int w = head; w < warps; w += nheads) {
      const float mw = wml[(w * wrows + gi) * 2];
      if (mw != -INFINITY) {
        const float wt = exp2_approx(mw - mx);
        num = fmaf(wt, pacc[(w * wrows + gi) * hd + d], num);
        den = fmaf(wt, wml[(w * wrows + gi) * 2 + 1], den);
      }
    }
    bacc[idx] = num;
    if (d == 0) {
      bml[r * 2] = mx;
      bml[r * 2 + 1] = den;
    }
  }
}

// The end of a split: its block's partial for KV heads kv0 ..
// kv0+nheads-1 -- bacc [nheads * g][hd] and bml [nheads * g][2] (m, l) in
// shared memory -- goes to the workspace for flash_decode_merge.
__device__ void write_partial(const float* bacc, const float* bml,
                              float* __restrict__ ws, int b, int kv0,
                              int nheads, int h, int kvh, int hd, int split,
                              int nsplit) {
  const int g = h / kvh;
  const int64_t parts = (int64_t)gridDim.z * kvh * nsplit;
  float* acc_ws = ws;
  float* ml_ws = ws + parts * g * hd;
  for (int idx = threadIdx.x; idx < nheads * g * hd; idx += blockDim.x) {
    const int r = idx / hd;
    const int d = idx - r * hd;
    const int head = r / g;
    const int64_t row =
        (((int64_t)b * kvh + kv0 + head) * nsplit + split) * g + r - head * g;
    acc_ws[row * hd + d] = bacc[idx];
    if (d < 2) ml_ws[row * 2 + d] = bml[r * 2 + d];
  }
}

// The merge: one thread an output element of out (b, h, hd), over the
// nsplit partials of its query head in split order: M = max m_i, then
// out = sum_i w_i acc_i / sum_i w_i l_i with w_i = 2^(m_i - M) (0 where
// l_i = 0).  Launched as a programmatic dependent of the split pass: its
// blocks are placed while the split pass drains and wait here for its
// results.  With WRITE_LSE (T = float) the thread of dimension 0 also
// writes its row's log-sum-exp of the scaled scores, lse (b, h) =
// (M + log2 den) ln 2 (M is in log2 units), and -inf for a row with no
// valid slot, whose out is 0.  lse is the last parameter, so the serving
// instances (WRITE_LSE false) keep their code.
constexpr int MERGE_THREADS = 256;

template <typename T, bool WRITE_LSE>
__global__ void __launch_bounds__(MERGE_THREADS)
flash_decode_merge(const float* __restrict__ ws, T* __restrict__ out, int b,
                   int h, int kvh, int hd, int nsplit,
                   float* __restrict__ lse) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int64_t idx = (int64_t)blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (idx >= (int64_t)b * h * hd) return;
  const int g = h / kvh;
  const int64_t row = idx / hd;          // b * h + head
  const int d = (int)(idx - row * hd);
  const int bi = (int)(row / h);
  const int head = (int)(row - (int64_t)bi * h);
  const int kv = head / g;
  // partial row of split sp: ((bi kvh + kv) nsplit + sp) g + head % g
  const int64_t r0 = ((int64_t)bi * kvh + kv) * nsplit * g + head - kv * g;
  const float* acc = ws + r0 * hd + d;
  const float* ml = ws + (int64_t)b * h * nsplit * hd + r0 * 2;
  float mx = -INFINITY;
#pragma unroll 8
  for (int sp = 0; sp < nsplit; ++sp) mx = fmaxf(mx, ml[sp * g * 2]);
  float num = 0.f, den = 0.f;
#pragma unroll 8
  for (int sp = 0; sp < nsplit; ++sp) {
    const float l = ml[sp * g * 2 + 1];
    const float w = l > 0.f ? exp2_approx(ml[sp * g * 2] - mx) : 0.f;
    num = fmaf(w, acc[(int64_t)sp * g * hd], num);
    den = fmaf(w, l, den);
  }
  out[idx] = attn::from_f32<T>(den > 0.f ? num / den : 0.f);
  if constexpr (WRITE_LSE) {
    if (d == 0)
      lse[row] = den > 0.f ? (mx + log2f(den)) * 0.69314718055994531f
                           : -INFINITY;
  }
}

// This block's tiles of the valid slots: split s takes tiles s,
// s + nsplit, ... (at each step the blocks read neighbouring tiles, so the
// whole grid sweeps the cache together).
struct Run {
  int n;       // valid slots
  int nt;      // tiles of this split
  int first;   // its first tile
  int stride;  // tiles between its tiles
};

__device__ __forceinline__ Run split_run(const int* n_valid_dev,
                                         int n_valid_host, int L, int bks,
                                         int split, int nsplit) {
  Run r;
  r.n = n_valid_dev ? min(max(*n_valid_dev, 0), L) : n_valid_host;
  const int tiles = (r.n + bks - 1) / bks;
  r.nt = split < tiles ? (tiles - split + nsplit - 1) / nsplit : 0;
  r.first = split;
  r.stride = nsplit;
  return r;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;    // warps a block
constexpr int TC_HEADS = 4;    // KV heads a block, at most: gcd(KV, TC_HEADS)
constexpr int TC_UNITS = 1;    // 16-slot units a warp takes of each tile
constexpr int TC_STAGES = 3;   // tiles in the cp.async ring
constexpr int TC_THREADS = 32 * TC_WARPS;

template <int HD>
struct TcPlan {
  static constexpr int LD = HD + 8;          // shared row stride (elements)
  static constexpr int KSTEPS = HD / 16;     // k16 steps of Q K^T
  static constexpr int NT = HD / 8;          // n8 tiles of O
  static constexpr int NCH = HD / 8;         // 16-byte chunks a head row
  static constexpr int ROWS = 16 * TC_UNITS * TC_WARPS;  // (head, slot) rows
  static constexpr int COPIES = ROWS * NCH / TC_THREADS; // a thread, K or V
  static constexpr int STAGE = 2 * ROWS * LD;            // elements, K and V
  // the query groups in shared memory, not registers, above head dim 128
  static constexpr bool Q_SMEM = HD > 128;
  static constexpr int STAGES = Q_SMEM ? 2 : TC_STAGES;
  static constexpr int RING = STAGES * STAGE * 2;
  // after the loop: the warps' partials and the block's, [16 rows][HD + 2]
  // a warp and at most as many for the block's kvb * g <= 16 TC_WARPS rows
  static constexpr int EPI = 8 * TC_WARPS * 16 * (HD + 2);
  static constexpr int BIG = RING > EPI ? RING : EPI;
  // the block's query groups, [TC_HEADS][16][LD] bf16, past ring and EPI
  static constexpr int QS = Q_SMEM ? TC_HEADS * 16 * LD * 2 : 0;
  static constexpr int SMEM = BIG + QS;
  static_assert(KSTEPS * 16 == HD && COPIES * TC_THREADS == ROWS * NCH,
                "head dim");
  static_assert(TC_WARPS % TC_HEADS == 0 && (TC_HEADS & (TC_HEADS - 1)) == 0,
                "a block's heads are a power of two dividing its warps");
};

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

__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// Two floats as three bf16 terms each, x = hi + mid + lo: each term is the
// remainder so far (exact in f32) rounded to bf16, so together they keep
// about 24 bits of x.  x0 goes to the low halves.
__device__ __forceinline__ void split3_bf16(float x0, float x1, uint32_t& hi,
                                            uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = pack_bf16(r0 - mf.x, r1 - mf.y);
}

template <int HD>
__global__ void __launch_bounds__(TC_THREADS)
flash_decode_bf16_mma(const bf16* __restrict__ q, const bf16* __restrict__ kc,
                      const bf16* __restrict__ vc, bf16* __restrict__ out,
                      float* __restrict__ ws,
                      const int* __restrict__ n_valid_dev, int n_valid_host,
                      int L, int h, int kvh, int kvb, int nsplit,
                      float scale_log2) {
  using P = TcPlan<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);

  const int split = blockIdx.x;
  const int group = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / kvh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int fr = lane >> 2;          // fragment row (and row + 8)
  const int fc = lane & 3;           // fragment column pair
  const int wph = TC_WARPS / kvb;    // warps a head
  const int bks = 16 * TC_UNITS * wph;   // slots a tile
  const int hw = warp % kvb;         // this warp's head in the block
  const int slot_w = (warp / kvb) * 16 * TC_UNITS;   // its slots in a tile
  const int kv0 = group * kvb;
  const int kv = kv0 + hw;
  const Run run = split_run(n_valid_dev, n_valid_host, L, bks, split,
                            nsplit);
  const int64_t slot_row = (int64_t)kvh * HD;   // elements between slots
  const bf16* kb = kc + ((int64_t)b * L * kvh + kv0) * HD;
  const bf16* vb = vc + ((int64_t)b * L * kvh + kv0) * HD;

  // this thread's copies of a tile, the same in every tile: (slot, source
  // offset from the tile's first slot, shared offset); neighbouring threads
  // take neighbouring 16 bytes of a slot's run of kvb * HD elements.  Held
  // in registers up to head dim 128, computed per tile above.
  struct Copy {
    int slot, src, dst;
  };
  auto copy_of = [&](int i) {
    const int e = tid + i * TC_THREADS;
    const int slot = e / (kvb * P::NCH);
    const int rem = e - slot * kvb * P::NCH;
    const int head = rem / P::NCH;
    const int c = rem - head * P::NCH;
    return Copy{slot, head * HD + c * 8, (head * bks + slot) * P::LD + c * 8};
  };
  Copy held[P::Q_SMEM ? 1 : P::COPIES];
  if constexpr (!P::Q_SMEM) {
#pragma unroll
    for (int i = 0; i < P::COPIES; ++i) held[i] = copy_of(i);
  }
  auto load_tile = [&](int t) {
    bf16* kd = ring + (t % P::STAGES) * P::STAGE;
    bf16* vd = kd + P::ROWS * P::LD;
    const int pos0 = (run.first + t * run.stride) * bks;
#pragma unroll
    for (int i = 0; i < P::COPIES; ++i) {
      Copy cp;
      if constexpr (P::Q_SMEM) {
        cp = copy_of(i);
      } else {
        cp = held[i];
      }
      const int pos = pos0 + cp.slot;
      const bool valid = pos < run.n;
      const int64_t off = valid ? pos * slot_row + cp.src : 0;
      cp_async16(smem_addr(kd + cp.dst), kb + off, valid);
      cp_async16(smem_addr(vd + cp.dst), vb + off, valid);
    }
  };

#pragma unroll
  for (int s = 0; s < P::STAGES - 1; ++s) {
    if (s < run.nt) load_tile(s);
    cp_async_commit();
  }

  // the query group's A fragments: a0 row fr, a1 row fr + 8, columns 2 fc
  // of each k16 step; a2, a3 columns 8 + 2 fc.  Straight from global
  // memory into registers, or (Q_SMEM) the block's kvb groups into shared
  // memory, rows past g zero, read by ldmatrix at each step: lane l gives
  // the address of row l % 16, column 8 (l / 16)
  uint32_t qf[P::Q_SMEM ? 1 : P::KSTEPS][4];
  bf16* qsm = reinterpret_cast<bf16*>(smem + P::BIG);   // [kvb][16][LD]
  const uint32_t qbase =
      smem_addr(qsm + (hw * 16 + (lane & 15)) * P::LD + (lane >> 4) * 8);
  if constexpr (P::Q_SMEM) {
    const bf16* qb = q + ((int64_t)b * h + (int64_t)kv0 * g) * HD;
    for (int e = tid; e < kvb * 16 * P::NCH; e += TC_THREADS) {
      const int row = e / P::NCH;          // head * 16 + query of its group
      const int c = e - row * P::NCH;
      const int head = row >> 4, gi = row & 15;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (gi < g)
        x = *reinterpret_cast<const uint4*>(qb + (head * g + gi) * HD + c * 8);
      *reinterpret_cast<uint4*>(qsm + row * P::LD + c * 8) = x;
    }
    // visible to every warp at the loop's first barrier
  } else {
    const bf16* qb = q + ((int64_t)b * h + (int64_t)kv * g) * HD + 2 * fc;
#pragma unroll
    for (int kk = 0; kk < P::KSTEPS; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = fr + 8 * (e & 1);
        qf[kk][e] = row < g ? *reinterpret_cast<const uint32_t*>(
                                  qb + row * HD + kk * 16 + 8 * (e >> 1))
                            : 0u;
      }
  }

  float o[P::NT][4];
#pragma unroll
  for (int n = 0; n < P::NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // rows fr and fr + 8, log2 units
  float l[2] = {0.f, 0.f};               // this thread's columns only

  // ldmatrix addresses within the warp's 16 rows.  K (non-transposed):
  // matrices (keys 0-7, hd 0-7), (keys 0-7, hd 8-15), (keys 8-15, hd 0-7),
  // (keys 8-15, hd 8-15) give b0, b1 of two n8 key tiles.  V (transposed):
  // (keys 0-7, hd 0-7), (keys 8-15, hd 0-7), (keys 0-7, hd 8-15), (keys
  // 8-15, hd 8-15) give b0, b1 of two n8 hd tiles.
  const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * P::LD +
                    ((lane >> 3) & 1) * 8;
  const int v_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * P::LD +
                    (lane >> 4) * 8;
  const int row_w = (hw * bks + slot_w) * P::LD;   // the warp's first row

  for (int t = 0; t < run.nt; ++t) {
    cp_async_wait<P::STAGES - 2>();
    __syncthreads();   // tile t is in; every warp is done with tile t - 1
    if (t + P::STAGES - 1 < run.nt) load_tile(t + P::STAGES - 1);
    cp_async_commit();
    const bf16* ks = ring + (t % P::STAGES) * P::STAGE + row_w;
    const bf16* vs = ks + P::ROWS * P::LD;
    const uint32_t kaddr = smem_addr(ks + k_off);
    const uint32_t vaddr = smem_addr(vs + v_off);
#pragma unroll
    for (int u = 0; u < TC_UNITS; ++u) {
      const int pos0 = (run.first + t * run.stride) * bks + slot_w + 16 * u;
      // S = Q K^T over 16 keys: two n8 tiles
      float sc[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
      // all k16 steps unrolled, but four at a time at head dim 256, where
      // the full unroll spills
#pragma unroll (P::Q_SMEM ? 4 : P::KSTEPS)
      for (int kk = 0; kk < P::KSTEPS; ++kk) {
        uint32_t qa[4], bf[4];
        if constexpr (P::Q_SMEM) {
          ldmatrix_x4(qa, qbase + kk * 32);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
        }
        ldmatrix_x4(bf, kaddr + (u * 16 * P::LD + kk * 16) * 2);
        mma_bf16(sc[0], qa, bf[0], bf[1]);
        mma_bf16(sc[1], qa, bf[2], bf[3]);
      }
      if (pos0 + 16 > run.n) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (pos0 + 8 * j + 2 * fc + (e & 1) >= run.n)
              sc[j][e] = -INFINITY;
      }

      // online softmax on the accumulators: rows fr (e = 0, 1), fr + 8
      float alpha[2], neg_m[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mx = attn::group_max<4>(fmaxf(
            fmaxf(sc[0][2 * r], sc[0][2 * r + 1]),
            fmaxf(sc[1][2 * r], sc[1][2 * r + 1])));
        const float m_new = fmaxf(m[r], mx * scale_log2);
        // a row with no kept key yet keeps m = -inf: its p = 2^-inf = 0
        // and alpha = 0 leave its zero state as it is
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = exp2_approx(m[r] - m_use);
        m[r] = m_new;
        neg_m[r] = -m_use;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = exp2_approx(fmaf(sc[j][e], scale_log2, neg_m[e >> 1]));
          rs[e >> 1] += sc[j][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = fmaf(l[r], alpha[r], rs[r]);
#pragma unroll
      for (int n = 0; n < P::NT; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }

      // O += P V, P from the accumulators as three bf16 A fragments
      uint32_t hi[4], mid[4], lo[4];
      split3_bf16(sc[0][0], sc[0][1], hi[0], mid[0], lo[0]);
      split3_bf16(sc[0][2], sc[0][3], hi[1], mid[1], lo[1]);
      split3_bf16(sc[1][0], sc[1][1], hi[2], mid[2], lo[2]);
      split3_bf16(sc[1][2], sc[1][3], hi[3], mid[3], lo[3]);
#pragma unroll
      for (int np = 0; np < P::NT / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vaddr + (u * 16 * P::LD + np * 16) * 2);
        mma_bf16(o[2 * np], lo, bf[0], bf[1]);
        mma_bf16(o[2 * np], mid, bf[0], bf[1]);
        mma_bf16(o[2 * np], hi, bf[0], bf[1]);
        mma_bf16(o[2 * np + 1], lo, bf[2], bf[3]);
        mma_bf16(o[2 * np + 1], mid, bf[2], bf[3]);
        mma_bf16(o[2 * np + 1], hi, bf[2], bf[3]);
      }
    }
  }
  launch_dependents();
  if (wph == 1) {
    // the warp holds its head's whole partial: rows fr, fr + 8 below g
    const int64_t row0 =
        (((int64_t)b * kvh + kv) * nsplit + split) * g;   // row of gi = 0
    float* acc_ws = ws;
    float* ml_ws = ws + (int64_t)gridDim.z * h * nsplit * HD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int gi = fr + 8 * r;
      const float lr = attn::group_sum<4>(l[r]);
      if (gi < g) {
        float* dst = acc_ws + (row0 + gi) * HD + 2 * fc;
#pragma unroll
        for (int n = 0; n < P::NT; ++n)
          *reinterpret_cast<float2*>(dst + 8 * n) =
              make_float2(o[n][2 * r], o[n][2 * r + 1]);
        if (fc == 0)
          *reinterpret_cast<float2*>(ml_ws + (row0 + gi) * 2) =
              make_float2(m[r], lr);
      }
    }
    return;
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: reuse it for the warps' partials

  // each warp's (acc, m, l) for its 16 rows
  float* pacc = reinterpret_cast<float*>(smem);    // [TC_WARPS][16][HD]
  float* wml = pacc + TC_WARPS * 16 * HD;          // [TC_WARPS][16][2]
  {
    float* pw = pacc + warp * 16 * HD;
#pragma unroll
    for (int n = 0; n < P::NT; ++n) {
      *reinterpret_cast<float2*>(pw + fr * HD + 8 * n + 2 * fc) =
          make_float2(o[n][0], o[n][1]);
      *reinterpret_cast<float2*>(pw + (fr + 8) * HD + 8 * n + 2 * fc) =
          make_float2(o[n][2], o[n][3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lr = attn::group_sum<4>(l[r]);
      if (fc == 0) {
        wml[(warp * 16 + fr + 8 * r) * 2] = m[r];
        wml[(warp * 16 + fr + 8 * r) * 2 + 1] = lr;
      }
    }
  }
  __syncthreads();

  // each head's partial: its warps (w = hw, hw + kvb, ...) merged in order
  float* bacc = wml + TC_WARPS * 16 * 2;           // [kvb * g][HD]
  float* bml = bacc + kvb * g * HD;                // [kvb * g][2]
  merge_warps(pacc, wml, TC_WARPS, 16, kvb, g, HD, bacc, bml);
  __syncthreads();
  write_partial(bacc, bml, ws, b, kv0, kvb, h, kvh, HD, split, nsplit);
}

// ---------------------------------------------------------------------------
// f32 on the FMA pipes
// ---------------------------------------------------------------------------

constexpr int BK = 32;            // cache slots per staged tile
constexpr int THREADS = 128;
constexpr int STAGES = 3;         // tiles in the cp.async ring
constexpr int WARPS = THREADS / 32;

// Compile-time layout of one instance: head dim HD and G >= H / KV query
// heads per KV head (4, 8 or 16; heads past H / KV are zero queries whose
// results are dropped).
template <int HD, int G>
struct Plan {
  static constexpr int NCH = HD / 4;             // 16-byte chunks a row
  static constexpr int KPW = BK / WARPS;         // keys per warp per tile
  static constexpr int LPK = KPW >= 16 ? 2 : 32 / KPW;  // lanes per key
  static constexpr int KB = 32 / LPK;            // keys per warp batch
  static constexpr int NB = KPW / KB;            // batches per warp per tile
  static constexpr int STEPS = (NCH + LPK - 1) / LPK;
  // Shared row stride: an odd multiple of the LPK * 16 bytes that the LPK
  // lanes of a key read at once, so the rows of a quarter warp fall on
  // distinct banks.
  static constexpr int SPAN = 4 * LPK;                      // words
  static constexpr int SPANS = (HD + SPAN - 1) / SPAN;
  static constexpr int LD = (SPANS % 2 ? SPANS : SPANS + 1) * SPAN;
  // P V: VD output dims a lane (4, or 8 above head dim 128), D lanes a
  // row, KS key subsets a warp
  static constexpr int VD = HD > 128 ? 8 : 4;
  static constexpr int D = HD / VD;
  static constexpr int KS = 32 / D;
  static constexpr int PV_STEPS = (KB + KS - 1) / KS;
  // shared memory (bytes): the ring, reused after the loop for the warps'
  // partials and the merge's weights; then the queries and the p buffers
  static constexpr int RING = STAGES * 2 * BK * LD * 4;
  static constexpr int EPI = 4 * (WARPS + 1) * G * (HD + 2);
  static constexpr int BIG = ((RING > EPI ? RING : EPI) + 15) / 16 * 16;
  static constexpr int QS = 4 * G * HD;
  static constexpr int PS = 4 * WARPS * KB * G;
  static constexpr int SMEM = BIG + QS + PS;
  static_assert(NCH * 4 == HD && D * VD == HD && D <= 32, "head dim");
  static_assert(KPW * WARPS == BK && (KPW >= 16 ? KPW % 16 == 0 : 32 % KPW == 0),
                "tile");
  static_assert(G % 4 == 0, "group");
};

template <int HD, int G>
__global__ void __launch_bounds__(THREADS)
flash_decode_f32(const float* __restrict__ q, const float* __restrict__ kc,
                 const float* __restrict__ vc, float* __restrict__ out,
                 float* __restrict__ ws,
                 const int* __restrict__ n_valid_dev, int n_valid_host,
                 int L, int h, int kvh, int nsplit, float qscale) {
  using P = Plan<HD, G>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* qs = reinterpret_cast<float*>(smem + P::BIG);   // [G][HD]
  float* ps = qs + G * HD;                               // [WARPS][KB][G]

  const int split = blockIdx.x;
  const int kv = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / kvh;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const Run run = split_run(n_valid_dev, n_valid_host, L, BK, split, nsplit);
  const int n = run.n;
  const int nt = run.nt;
  const int64_t slot_row = (int64_t)kvh * HD;   // elements between slots
  const float* kb = kc + ((int64_t)b * L * kvh + kv) * HD;
  const float* vb = vc + ((int64_t)b * L * kvh + kv) * HD;

  auto load_tile = [&](int t) {
    float* kd = ring + (t % STAGES) * 2 * BK * P::LD;
    float* vd = kd + BK * P::LD;
    const int pos0 = (run.first + t * run.stride) * BK;
    constexpr int COPIES = BK * P::NCH;
#pragma unroll
    for (int i = 0; i < (COPIES + THREADS - 1) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      if (COPIES % THREADS != 0 && e >= COPIES) break;
      const int r = e / P::NCH;
      const int c = e - r * P::NCH;
      const int pos = pos0 + r;
      const bool valid = pos < n;
      const int64_t off = valid ? pos * slot_row + c * 4 : 0;
      cp_async16(smem_addr(kd + r * P::LD + c * 4), kb + off, valid);
      cp_async16(smem_addr(vd + r * P::LD + c * 4), vb + off, valid);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nt) load_tile(s);
    cp_async_commit();
  }
  {
    const float* qb = q + ((int64_t)b * h + (int64_t)kv * g) * HD;
    for (int e = tid; e < G * HD; e += THREADS)
      qs[e] = e < g * HD ? qb[e] * qscale : 0.f;
  }

  // per-warp online softmax state: m warp-uniform, l per lane (each key
  // counted by its first lane), acc per lane for its dims and key subset
  float m[G], lp[G], acc[G][P::VD];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = -INFINITY;
    lp[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < P::VD; ++e) acc[gi][e] = 0.f;
  }
  const int kl = lane / P::LPK;    // key of this lane in a batch (scores)
  const int sub = lane % P::LPK;
  const int pc = lane % P::D;      // P V: dims pc * VD .. +VD
  const int pk = lane / P::D;      // P V: key subset
  float* pw = ps + warp * P::KB * G;

  for (int t = 0; t < nt; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile t is in; every warp is done with tile t - 1
    if (t + STAGES - 1 < nt) load_tile(t + STAGES - 1);
    cp_async_commit();
    const float* ks = ring + (t % STAGES) * 2 * BK * P::LD;
    const float* vs = ks + BK * P::LD;
    const int pos0 = (run.first + t * run.stride) * BK;
#pragma unroll
    for (int nb = 0; nb < P::NB; ++nb) {
      const int key0 = warp * P::KPW + nb * P::KB;
      const float* krow = ks + (key0 + kl) * P::LD;
      float s[G];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) s[gi] = 0.f;
#pragma unroll
      for (int st = 0; st < P::STEPS; ++st) {
        const int c = st * P::LPK + sub;
        if (P::NCH % P::LPK == 0 || c < P::NCH) {
          const float4 k4 = *reinterpret_cast<const float4*>(krow + c * 4);
#pragma unroll
          for (int gi = 0; gi < G; ++gi) {
            const float4 x = *reinterpret_cast<const float4*>(
                qs + gi * HD + c * 4);
            s[gi] = fmaf(x.x, k4.x, s[gi]);
            s[gi] = fmaf(x.y, k4.y, s[gi]);
            s[gi] = fmaf(x.z, k4.z, s[gi]);
            s[gi] = fmaf(x.w, k4.w, s[gi]);
          }
        }
      }
      const bool valid = pos0 + key0 + kl < n;
      float alpha[G], p[G];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
#pragma unroll
        for (int o = 1; o < P::LPK; o *= 2)
          s[gi] += __shfl_xor_sync(0xffffffffu, s[gi], o);
        const float sv = valid ? s[gi] : -INFINITY;
        float mx = sv;
#pragma unroll
        for (int o = P::LPK; o < 32; o *= 2)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[gi], mx);
        if (m_new == -INFINITY) {
          alpha[gi] = 1.f;
          p[gi] = 0.f;
        } else {
          alpha[gi] = exp2_approx(m[gi] - m_new);
          p[gi] = exp2_approx(sv - m_new);
        }
        m[gi] = m_new;
        lp[gi] = fmaf(lp[gi], alpha[gi], sub == 0 ? p[gi] : 0.f);
      }
      __syncwarp();   // the previous batch's p is consumed
      if (sub == 0) {
#pragma unroll
        for (int gi = 0; gi < G; gi += 4)
          *reinterpret_cast<float4*>(pw + kl * G + gi) =
              make_float4(p[gi], p[gi + 1], p[gi + 2], p[gi + 3]);
      }
      __syncwarp();
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
#pragma unroll
        for (int e = 0; e < P::VD; ++e) acc[gi][e] *= alpha[gi];
      if (pk < P::KS) {
#pragma unroll
        for (int jj = 0; jj < P::PV_STEPS; ++jj) {
          const int j = pk + jj * P::KS;
          if (P::KB % P::KS == 0 || j < P::KB) {
            float vf[P::VD];
#pragma unroll
            for (int c4 = 0; c4 < P::VD / 4; ++c4) {
              const float4 v4 = *reinterpret_cast<const float4*>(
                  vs + (key0 + j) * P::LD + pc * P::VD + 4 * c4);
              vf[4 * c4] = v4.x;
              vf[4 * c4 + 1] = v4.y;
              vf[4 * c4 + 2] = v4.z;
              vf[4 * c4 + 3] = v4.w;
            }
            const float4* pv = reinterpret_cast<const float4*>(pw + j * G);
#pragma unroll
            for (int g4 = 0; g4 < G / 4; ++g4) {
              const float4 x = pv[g4];
              const float pj[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
              for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int e = 0; e < P::VD; ++e)
                  acc[4 * g4 + i][e] = fmaf(pj[i], vf[e], acc[4 * g4 + i][e]);
            }
          }
        }
      }
    }
  }
  launch_dependents();
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: reuse it for the warps' partials

  // each warp's acc (its key subsets summed in order) and (m, l)
  float* pacc = reinterpret_cast<float*>(smem);    // [WARPS][G][HD]
  float* wml = pacc + WARPS * G * HD;              // [WARPS][G][2]
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const float lw = attn::group_sum<32>(lp[gi]);
#pragma unroll
    for (int e = 0; e < P::VD; ++e) {
      float x = acc[gi][e];
#pragma unroll
      for (int k = 1; k < P::KS; ++k)
        x += __shfl_sync(0xffffffffu, acc[gi][e], (lane + k * P::D) & 31);
      if (lane < P::D) pacc[(warp * G + gi) * HD + lane * P::VD + e] = x;
    }
    if (lane == 0) {
      wml[(warp * G + gi) * 2] = m[gi];
      wml[(warp * G + gi) * 2 + 1] = lw;
    }
  }
  __syncthreads();

  // the block's partial, warps merged in order
  float* bacc = wml + WARPS * G * 2;               // [g][HD]
  float* bml = bacc + g * HD;                      // [g][2]
  merge_warps(pacc, wml, WARPS, G, 1, g, HD, bacc, bml);
  __syncthreads();
  write_partial(bacc, bml, ws, b, kv, 1, h, kvh, HD, split, nsplit);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;    // null: the serving entry
  float* ws;
  const int* n_valid_dev;
  int n_valid;
  int b, L, h, kvh, nsplit;
  float scale_log2;
  cudaStream_t stream;
};

// Launch kern over grid (nsplit, groups, b), then the merge into out of
// type T, writing the row LSE too when WRITE_LSE; raise kern's dynamic
// shared-memory limit once per device first.
template <typename T, bool WRITE_LSE, typename... KArgs, typename... Ps>
int launch(void (*kern)(KArgs...), int threads, int smem, int groups,
           int hd, unsigned long long& raised, const Args& a, Ps... args) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !((raised >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) raised |= 1ull << dev;
  }
  kern<<<dim3(a.nsplit, groups, a.b), threads, smem, a.stream>>>(args...);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  const int64_t outputs = (int64_t)a.b * a.h * hd;
  cfg.gridDim = dim3((unsigned)((outputs + MERGE_THREADS - 1) / MERGE_THREADS));
  cfg.blockDim = dim3(MERGE_THREADS);
  cfg.stream = a.stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, flash_decode_merge<T, WRITE_LSE>,
                                 (const float*)a.ws, static_cast<T*>(a.out),
                                 a.b, a.h, a.kvh, hd, a.nsplit, a.lse);
}

// The split pass's out argument is never written (its partials go to the
// workspace), so the LSE entry's f32 out passes through it untyped.
template <int HD, bool LSE>
int launch_bf16(const Args& a) {
  static unsigned long long raised = 0;
  int kvb = TC_HEADS;
  while (a.kvh % kvb) kvb /= 2;   // gcd(KV, TC_HEADS): TC_HEADS is 2^k
  return launch<std::conditional_t<LSE, float, bf16>, LSE>(
      flash_decode_bf16_mma<HD>, TC_THREADS, TcPlan<HD>::SMEM, a.kvh / kvb,
      HD, raised, a, static_cast<const bf16*>(a.q),
      static_cast<const bf16*>(a.k), static_cast<const bf16*>(a.v),
      static_cast<bf16*>(a.out), a.ws, a.n_valid_dev, a.n_valid, a.L, a.h,
      a.kvh, kvb, a.nsplit, a.scale_log2);
}

template <int HD, int G, bool LSE>
int launch_f32(const Args& a) {
  static unsigned long long raised = 0;
  return launch<float, LSE>(
      flash_decode_f32<HD, G>, THREADS, Plan<HD, G>::SMEM, a.kvh, HD, raised,
      a, static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.ws,
      a.n_valid_dev, a.n_valid, a.L, a.h, a.kvh, a.nsplit, a.scale_log2);
}

template <int G, bool LSE>
int f32_by_head_dim(int hd, const Args& a) {
  switch (hd) {
    case 32: return launch_f32<32, G, LSE>(a);
    case 64: return launch_f32<64, G, LSE>(a);
    case 80: return launch_f32<80, G, LSE>(a);
    case 96: return launch_f32<96, G, LSE>(a);
    case 128: return launch_f32<128, G, LSE>(a);
    case 256: return launch_f32<256, G, LSE>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool LSE>
int bf16_by_head_dim(int hd, const Args& a) {
  switch (hd) {
    case 32: return launch_bf16<32, LSE>(a);
    case 64: return launch_bf16<64, LSE>(a);
    case 80: return launch_bf16<80, LSE>(a);
    case 96: return launch_bf16<96, LSE>(a);
    case 128: return launch_bf16<128, LSE>(a);
    case 256: return launch_bf16<256, LSE>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool bad_args(int h, int kvh, int nsplit, int L, const float* ws,
              const int* n_valid_dev, int n_valid) {
  return kvh < 1 || h % kvh != 0 || h / kvh > MAX_GROUP || nsplit < 1 ||
         nsplit > MAX_SPLITS || L < 1 || ws == nullptr ||
         (n_valid_dev == nullptr && (n_valid < 1 || n_valid > L));
}

template <bool LSE>
int dispatch(const Args& a, int hd, int bf16) {
  if (bf16) return bf16_by_head_dim<LSE>(hd, a);
  const int g = a.h / a.kvh;
  if (g <= 4) return f32_by_head_dim<4, LSE>(hd, a);
  if (g <= 8) return f32_by_head_dim<8, LSE>(hd, a);
  return f32_by_head_dim<16, LSE>(hd, a);
}

}  // namespace

// out (b, h, hd) = attention of q (b, h, hd) over slots 0 .. n-1 of the
// caches k, v (b, L, kvh, hd), where n = *n_valid_dev clamped to [0, L]
// when n_valid_dev is not null (read on the card), else n_valid (1 <= n_valid
// <= L).  nsplit (1 .. 64) splits per (batch, block of KV heads); ws
// holds b * h * nsplit * (hd + 2) floats.  h / kvh <= 16; head_dim one of
// 32, 64, 80, 96, 128, 256; bf16 1
// for bfloat16 tensors.  Launched on `stream`; returns the first launch
// error (0 on success).
extern "C" int flash_decode_fwd(const void* q, const void* k, const void* v,
                                void* out, float* ws,
                                const int* n_valid_dev, int n_valid, int b,
                                int L, int h, int kvh, int hd, int nsplit,
                                int bf16, float scale, void* stream) {
  if (bad_args(h, kvh, nsplit, L, ws, n_valid_dev, n_valid))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, nullptr, ws, n_valid_dev, n_valid, b, L, h,
               kvh, nsplit, scale * 1.4426950408889634f,
               (cudaStream_t)stream};
  return dispatch<false>(a, hd, bf16);
}

// flash_decode_fwd's attention with its row statistics: out (b, h, hd) in
// f32 (the merge's quotient unrounded, whatever the cache's type) and lse
// (b, h) f32, the natural-log log-sum-exp of each query row's scaled
// scores over its valid slots.  A device n_valid may be 0 (a rank that
// holds none of the valid slots): every row then gives out 0 and lse
// -inf.  The other arguments as flash_decode_fwd's.
extern "C" int flash_decode_fwd_lse(const void* q, const void* k,
                                    const void* v, float* out, float* lse,
                                    float* ws, const int* n_valid_dev,
                                    int n_valid, int b, int L, int h,
                                    int kvh, int hd, int nsplit, int bf16,
                                    float scale, void* stream) {
  if (bad_args(h, kvh, nsplit, L, ws, n_valid_dev, n_valid) ||
      lse == nullptr)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, lse, ws, n_valid_dev, n_valid, b, L, h, kvh,
               nsplit, scale * 1.4426950408889634f, (cudaStream_t)stream};
  return dispatch<true>(a, hd, bf16);
}
