// The tiles of the rank-k view updates for Hopper (sm_90a): f32 in, f32 FMA
// accumulation, in place on M or out of place.
//
//   M[row(i), :] += sum_t U_t[i, :] V_t^T     for the n rows i of the panel
//
// Two entries are built on them, each with its own row map:
//   * rank_update.cu (DenseRows): row i of U updates M's row i;
//   * rank_update_rows.cu (ListedRows): row i of the compact block (r, k)
//     updates M's row rows[i]; the block is U with n := r and T := 1.
// Only M's addresses go through the map: the factor panels, the arithmetic
// and its order are the same for both.
//
// Where M is read and stored is a second parameter, Io.  InPlace reads and
// writes M itself (every in-place entry).  OutOfPlace reads a source and
// stores  dst = src + sum U V^T  to a distinct destination, with the same
// arithmetic in the same order, so its values are bitwise those of the
// in-place entry; its epilogue also raises a flag when any value it stores
// is not finite (a warp ballot, then one atomicOr per warp that saw one).
// The guarded engine's transactional firings take it: the pre-firing view
// stays untouched for a rollback, and the flag is the output check.
//
// Layout: M is (rows of M, p) row-major; U is the stack (T, n, k) and V the
// stack (T, p, k), both contiguous.  The tiles walk the stack through
// strides (U_t starts at u + t*n*k), so no wrapper reshapes or copies the
// factors.  Plain fp32 FMA throughout (no TF32, no tensor cores); the sum is
// M + (sum U V^T): the products are accumulated from zero and M is added
// once at the end.
//
// Design.  One launch per call; the entry picks one of three tiles from
// p, from K = T*k and from M's alignment.
//   * One flat contraction.  The stack is walked as one inner dimension of
//     K = T*k columns, flat column kk being column kk % k of U_(kk / k); a
//     staged chunk may cross a boundary of t.  T = 16 rank-1 pairs cost
//     what one rank-16 pair costs (a loop that restarted its chunks at
//     every t ran 16 chunks with one useful column each, behind 32
//     barriers).
//   * Factor staging is coalesced and asynchronous.  For a fixed t a tile's
//     row panel of U_t (its rows x all k columns) is one contiguous run of
//     floats, and so is V_t's.  Loaders give neighbouring threads
//     neighbouring addresses of that run and store each element with a
//     4-byte cp.async (zero-filled past every edge) into a k-major shared
//     layout [kk][rows + 4], so the inner loops read float4s without bank
//     conflicts.  (A loader that gave neighbouring threads neighbouring
//     rows read one 4-byte word of a 32-byte sector per thread at k >= 8.)
//   * Compute tile, K > KSTREAM (the FLOP-bound regime): 128 x 128 outputs
//     per block of 256 threads, an 8 x 8 register tile per thread laid out
//     as 2 x 2 sub-tiles of 4 x 4, so each step of kk takes 4 LDS.128 for
//     64 FMAs (a 4 x 4 tile fed by scalar loads took 8 for 16 and was bound
//     by shared-memory issue).  A warp is 4 x 8 threads: its A loads touch
//     4 distinct float4s and its B loads 8.  Chunks of 16 flat columns go
//     through a 2-stage cp.async ring, one barrier a stage, so the copy of
//     chunk c + 1 overlaps the FMAs of chunk c (one buffer and two barriers
//     a chunk waited on global latency every 16 columns).  M's tile is
//     prefetched into L2 once the ring is filled (before it, the first chunk
//     queues behind the prefetches) and read as float4 in the epilogue,
//     added to the sums and written once.  __launch_bounds__(256,
//     2) holds it to 128 registers, with no spill.
//   * Streaming tile, K <= KSTREAM (the byte-bound regime): 8 SROWS x 128
//     outputs per block of 256 threads; each thread owns SROWS rows x 4
//     columns of M as float4s (SROWS = 8 for the dense entries; fewer rows
//     a block give a small row-local update more blocks to spread over the
//     SMs).  The whole K panel of U and V fits in shared memory and is
//     staged once; then each step of kk takes SROWS / 4 broadcast LDS.128
//     of U and 1 of V for 4 SROWS FMAs.  At K <= KM_FIRST the thread
//     issues M's loads before the staging, so M's latency overlaps the
//     factor work; above it the factors go first, so the FMAs start
//     without waiting for them behind M's loads.  A warp covers 512
//     contiguous bytes of a row of M (a half-warp of 4-byte accesses
//     covered 64).
//   * Row maps.  A map names the block index of a tile's rows and columns
//     and turns tile row i into M's row.  DenseRows is the identity and
//     costs nothing.  ListedRows stages the tile's ids in shared memory
//     once, behind one barrier, before M's first load; M's rows are then
//     read and written exactly as the dense entries read theirs, one row
//     id a row, so a warp still moves 512 contiguous bytes of one row.
//   * Edges and alignment.  Rows, columns and flat columns past the edge
//     are masked or zero-filled, so any n, p, T, k is taken.  M moves as
//     float4 only where p % 4 == 0 and M's pointer is 16-byte aligned;
//     otherwise (p = 1 views, a view at an odd storage offset) the same
//     tiles move it as masked scalars.
//   * Skinny tile, p < PSKINNY at every K (vector views: OLS's p = 1
//     program, PageRank's rank vector, the learning views' 2^20 x 1 Y and
//     W; and views of 2 or 3 columns).  Narrow views waste the two tiles
//     above: a warp owns 128 columns, 4 a lane, so at p = 1 only 8 of 256
//     threads do work, the 128-wide V panel is zero-fill, and M moves as
//     masked scalars.  The op does 2 p K FLOPs for each 4 K bytes of a row
//     of U, p / 2 FLOP/byte, far below the card's ~20, so one streaming
//     pass of U and M is the bound at every K.  The tile:
//       - each thread owns ROWS whole rows of M (all p columns; rows
//         tid + 256 i of the tile), so every thread works at any p;
//       - a persistent grid: gridDim.x fills the SMs (blocks an SM from
//         the occupancy API) and a block walks the row tiles tile0,
//         tile0 + gridDim.x, ...; each tile's K is cut into chunks of BK
//         flat columns, and the block's (tile, chunk) items go through a
//         STAGES cp.async ring, one barrier an item, so the next tiles'
//         loads are in flight while a chunk is summed;
//       - two geometries (SkinnyGeom) picked at launch: through K =
//         SK_KTINY, where its tiles fill the SMs, the whole K is one chunk
//         and a thread owns 8 rows (tiles of 2048 rows keep many rows'
//         loads in flight); else a thread owns 1 row and a chunk is 32
//         columns, so each row of U is read in 128-byte runs (chunks of 8
//         read 32-byte pieces of rows 4 KB apart: 1.9 TB/s on an H100 at
//         K = 1024).  A thread sums PSKINNY - 1 columns a row at most, so
//         the vectors keep few registers;
//       - U's chunk lands as [row][column] with a row stride ULD chosen
//         for conflict-free reads (ULD / 4 odd for LDS.128, ULD odd for
//         LDS.32).  For each t the tile's rows of U_t are one contiguous
//         run of floats, so neighbouring threads copy neighbouring
//         addresses: 16-byte cp.async where k % 4 == 0 and U is 16-byte
//         aligned, 4-byte otherwise (k = 1-3; those stacks are short).  A
//         chunk crosses t slices like the other tiles' (a T = 16, k = 1
//         stack's chunk is 16 runs of rows, one a slice, as a k = 16
//         pair's is one run of rows x 16 columns), and K in the
//         thousands streams chunk by chunk; ring slots are sized at
//         launch from min(K, BK), so a K = 1 tile takes few bytes of
//         shared memory and more blocks fit an SM;
//       - V's p x chunk columns sit in shared memory beside U's, read as
//         broadcasts;
//       - M is read once and written once.  Under DenseRows a tile's rows
//         of M are one contiguous run of rows * p floats: it is staged
//         with the tile's first chunk by 16-byte cp.async, with 4-byte
//         copies at a head and a tail where the run is not 16-byte
//         aligned (a p = 1 view at an odd storage offset), kept at the
//         run's own offset mod 16 in shared memory; the sums are added in
//         place there and the run is stored back as float4s (scalar head
//         and tail at the destination's alignment) after the next
//         barrier.  Run buffers rotate over STAGES + 1 tiles, so a
//         run waiting to be stored is never the one being refilled.
//         Under ListedRows each listed row is read and written by its
//         owner thread alone; the tile's ids are staged into the same
//         buffer with its first chunk.
//     Arithmetic as the other tiles: each sum starts at zero and takes
//     fmaf in flat-kk order, and M is added once at the end, so this tile
//     gives their bits, and out of place the in-place entry's.
//
// KSTREAM, KM_FIRST, SROWS and PSKINNY are template parameters of each
// entry, and SK_KTINY and the skinny geometries constants here, chosen
// from measurement on the card
// (tools/torch_rank_update_variants.py times the choices side by side at
// the main path's shapes; PERF.md).

#pragma once

#include <atomic>
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// compute tile: 128 x 128 outputs, 16 flat columns a stage, 2 stages
constexpr int CBM = 128, CBN = 128, CBK = 16, STAGES = 2;
constexpr int CLD = CBM + 4;  // shared row: 528 bytes, 16-byte aligned
constexpr size_t CSMEM = 2 * STAGES * CBK * CLD * sizeof(float);
static_assert(CBM == CBN, "one loader fills the U and V panels together");
static_assert(THREADS % CBK == 0 && CBM % (THREADS / CBK) == 0,
              "each thread stages one flat column of CBM / (THREADS / CBK) "
              "rows");

// streaming tile: 8 SROWS x 128 outputs, SROWS rows x 4 columns a thread
// (SROWS, a parameter of each entry, is 8 or 4: 64 or 32 rows a tile)
constexpr int SBN = 128, SLDV = SBN + 4;
static_assert(SBN == 4 * 32, "a warp owns 128 columns of SROWS rows");
static_assert(SBN == CBN, "both tiles cut M's columns alike");
__host__ __device__ constexpr int stream_rows(int srows) {
  return srows * (THREADS / 32);
}

// skinny tile geometry: ROWS rows of M a thread, BK flat columns a chunk,
// STAGES chunks in a block's ring, at least MINB blocks an SM (the
// register cap)
template <int ROWS_, int BK_, int STAGES_, int MINB_>
struct SkinnyGeom {
  static constexpr int ROWS = ROWS_, BK = BK_, STAGES = STAGES_;
  static constexpr int MINB = MINB_;
  static constexpr int BM = ROWS * THREADS;   // rows a tile
  static_assert(BK % 8 == 0 && STAGES >= 2,
                "a full chunk's 16-byte row stride BK + 4 is 4 mod 8");
  static_assert((BM & (BM - 1)) == 0, "rows of a tile by shifts");
};
// K <= SK_KTINY (where its tiles fill the SMs): the whole K is one chunk,
// and big tiles keep many rows' loads in flight (SkTiny); else long runs
// of each row (128 bytes a chunk) keep the reads of U in whole lines
// (SkLarge)
constexpr int SK_KTINY = 4;
using SkTiny = SkinnyGeom<8, 8, 2, 2>;
using SkLarge = SkinnyGeom<1, 32, 2, 4>;
// a skinny launch takes n <= INT_MAX - SK_MARGIN (row offsets in int)
constexpr int SK_MARGIN = 4096;
static_assert(SkTiny::BM + SkLarge::BM <= SK_MARGIN,
              "a tile's first row past n stays an int");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4-byte asynchronous copy global -> shared; writes 0 when !ok (src is then
// not read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

// 16-byte asynchronous copy global -> shared, both addresses 16-byte
// aligned; writes 0 when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// loads of M kept in program order (asm volatile), so the streaming tile's
// loads are in flight before the factors are staged
__device__ __forceinline__ float4 ld_m4(const float* p) {
  float4 x;
  asm volatile("ld.global.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "l"(p));
  return x;
}

__device__ __forceinline__ float ld_m1(const float* p) {
  float x;
  asm volatile("ld.global.f32 %0, [%1];\n" : "=f"(x) : "l"(p));
  return x;
}

// -- row maps ----------------------------------------------------------------

// M's row i0 + i: the dense entries.  Row tiles on gridDim.y, column tiles
// on gridDim.x; nothing is staged.
struct DenseRows {
  static constexpr size_t ID_BYTES = 0;   // shared bytes a tile row takes
  // a tile's rows of M are one run of floats (the skinny tile stages it)
  static constexpr bool CONTIGUOUS = true;
  static dim3 grid(int row_tiles, int col_tiles) {
    return dim3(col_tiles, row_tiles);
  }
  __device__ __forceinline__ int row_tile() const { return blockIdx.y; }
  __device__ __forceinline__ int col_tile() const { return blockIdx.x; }
  template <int ROWS>
  __device__ __forceinline__ void stage(int*, int, int, int) const {}
  template <int BM>
  __device__ __forceinline__ void stage_async(int*, int, int, int) const {}
  __device__ __forceinline__ int row(const int*, int i0, int i) const {
    return i0 + i;
  }
};

// M's row rows[i0 + i]: the row entry.  One flat grid.x of row tiles x
// column tiles, column tiles fastest (as the dense grid runs), so a row
// panel of the block is staged by neighbouring blocks while it is in L2 and
// the listed rows are not held to gridDim.y's 65535 tiles.
struct ListedRows {
  const int* rows;
  int col_tiles;
  static constexpr size_t ID_BYTES = sizeof(int);
  static constexpr bool CONTIGUOUS = false;
  static dim3 grid(int row_tiles, int col_tiles) {
    return dim3(row_tiles * col_tiles);
  }
  __device__ __forceinline__ int row_tile() const {
    return blockIdx.x / col_tiles;
  }
  __device__ __forceinline__ int col_tile() const {
    return blockIdx.x % col_tiles;
  }
  // the tile's ROWS ids into shared memory, once, before M's first load
  // (ids past the last listed row are 0 and never dereferenced)
  template <int ROWS>
  __device__ __forceinline__ void stage(int* ids, int i0, int n,
                                        int tid) const {
    static_assert(ROWS <= THREADS, "one thread stages one id");
    if (tid < ROWS) ids[tid] = i0 + tid < n ? rows[i0 + tid] : 0;
    __syncthreads();
  }
  // the skinny tile's ids of listed rows [i0, i0 + BM), by cp.async in
  // the caller's group (0 past the last listed row)
  template <int BM>
  __device__ __forceinline__ void stage_async(int* ids, int i0, int n,
                                              int tid) const {
    for (int r = tid; r < BM; r += THREADS)
      cp_async4(ids + r, i0 + r < n ? rows + i0 + r : rows, i0 + r < n);
  }
  __device__ __forceinline__ int row(const int* ids, int, int i) const {
    return ids[i];
  }
};

// -- where M is read and stored ----------------------------------------------

// M read from and stored to m: the in-place entries.  Empty, so their code
// is what it was before the out-of-place entry existed.
struct InPlace {
  static constexpr bool FLAG = false;
  __device__ __forceinline__ const float* src(const float* m) const {
    return m;
  }
  bool aligned16() const { return true; }
  __device__ __forceinline__ void report(bool) const {}
};

// M read from `from`, the sums stored to the kernel's m (a distinct tensor
// of the same shape); *nonfinite (when not null) is set to 1 by any warp
// that stored a value that is not finite.
struct OutOfPlace {
  const float* from;
  int* nonfinite;
  static constexpr bool FLAG = true;
  __device__ __forceinline__ const float* src(const float*) const {
    return from;
  }
  bool aligned16() const {
    return reinterpret_cast<uintptr_t>(from) % 16 == 0;
  }
  __device__ __forceinline__ void report(bool bad) const {
    if (__ballot_sync(0xffffffffu, bad) != 0u && threadIdx.x % 32 == 0 &&
        nonfinite != nullptr)
      atomicOr(nonfinite, 1);
  }
};

// not inf and not nan: the exponent is not all ones
__device__ __forceinline__ bool not_finite(float x) {
  return (__float_as_uint(x) & 0x7f800000u) == 0x7f800000u;
}

// -- compute tile -------------------------------------------------------------

template <bool VEC, class Map, class Io>
__global__ void __launch_bounds__(THREADS, 2)
rank_update_compute(float* __restrict__ m, const float* __restrict__ u,
                    const float* __restrict__ v, int n, int p, int t, int k,
                    Map map, Io io) {
  extern __shared__ __align__(16) float csmem[];
  float(*us)[CBK][CLD] = reinterpret_cast<float(*)[CBK][CLD]>(csmem);
  float(*vs)[CBK][CLD] =
      reinterpret_cast<float(*)[CBK][CLD]>(csmem + STAGES * CBK * CLD);
  int* ids = reinterpret_cast<int*>(csmem + 2 * STAGES * CBK * CLD);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  // rows 4*ty + i and 64 + 4*ty + i, columns 4*tx + j and 64 + 4*tx + j
  const int ty = (warp / 2) * 4 + lane / 8;
  const int tx = (warp % 2) * 8 + lane % 8;
  const int row0 = map.row_tile() * CBM;
  const int col0 = map.col_tile() * CBN;

  // The loader stages flat column kk0 + lc of rows lr + 16 j (j < 8) of
  // both panels; (ft, fc) is that flat column as (t, column of U_t).  The
  // CBK threads of a row read 4 * CBK contiguous bytes of it when k >= CBK.
  const int lc = tid % CBK, lr = tid / CBK;
  int ft = lc / k, fc = lc % k;
  auto load_stage = [&](int buf) {
    const bool kin = ft < t;
    const float* ub = u + ((int64_t)ft * n + row0 + lr) * k + fc;
    const float* vb = v + ((int64_t)ft * p + col0 + lr) * k + fc;
#pragma unroll
    for (int j = 0; j < CBM / (THREADS / CBK); ++j) {
      const int r = lr + (THREADS / CBK) * j;
      const int64_t off = (int64_t)(THREADS / CBK) * j * k;
      const bool oku = kin && row0 + r < n;
      const bool okv = kin && col0 + r < p;
      cp_async4(&us[buf][lc][r], oku ? ub + off : u, oku);
      cp_async4(&vs[buf][lc][r], okv ? vb + off : v, okv);
    }
    fc += CBK;
    if (fc >= k) {
      ft += fc / k;
      fc %= k;
    }
  };

  map.template stage<CBM>(ids, row0, n, tid);
  const int nch = (t * k + CBK - 1) / CBK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nch) load_stage(s);
    cp_async_commit();
  }

  // warm M's tile (128 rows x 4 lines of 128 bytes) in L2 for the
  // epilogue, once the ring's first chunks are requested: prefetches issued
  // before them delay the first chunk behind M's traffic
  for (int q = tid; q < CBM * 4; q += THREADS) {
    const int i = q / 4, c = col0 + (q % 4) * 32;
    if (row0 + i < n && c < p)
      prefetch_l2(io.src(m) + (int64_t)map.row(ids, row0, i) * p + c);
  }

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int ch = 0; ch < nch; ++ch) {
    // chunk ch has landed; every thread is past chunk ch - 1, whose
    // buffer the next load reuses
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (ch + STAGES - 1 < nch) load_stage((ch + STAGES - 1) % STAGES);
    cp_async_commit();
    const int buf = ch % STAGES;
#pragma unroll
    for (int kk = 0; kk < CBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&us[buf][kk][4 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&us[buf][kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&vs[buf][kk][4 * tx]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&vs[buf][kk][64 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  // epilogue: M read once, M + sums written once; a warp covers 4 rows x
  // 128 contiguous bytes per access
  bool bad = false;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int li = (i / 4) * 64 + 4 * ty + i % 4;
    if (row0 + li >= n) continue;
    const int64_t off = (int64_t)map.row(ids, row0, li) * p;
    const float* srow = io.src(m) + off;
    float* row = m + off;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = col0 + 64 * h + 4 * tx;
      if (VEC) {
        if (c < p) {
          float4 x = *reinterpret_cast<const float4*>(srow + c);
          x.x += acc[i][4 * h];
          x.y += acc[i][4 * h + 1];
          x.z += acc[i][4 * h + 2];
          x.w += acc[i][4 * h + 3];
          *reinterpret_cast<float4*>(row + c) = x;
          if (Io::FLAG)
            bad |= not_finite(x.x) | not_finite(x.y) | not_finite(x.z) |
                   not_finite(x.w);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < p) {
            const float x = srow[c + j] + acc[i][4 * h + j];
            row[c + j] = x;
            if (Io::FLAG) bad |= not_finite(x);
          }
      }
    }
  }
  io.report(bad);
}

// -- streaming tile -----------------------------------------------------------

// Stage rows [row0, row0 + ROWS) of every factor of the stack (rows of
// length k, row stride k, factor stride rows_total * k) into dst[kk][ld].
// The block walks the stack in memory order, element e = (s * ROWS + r) * k
// + c: each t's panel is one contiguous run of ROWS * k floats, read by
// neighbouring threads at neighbouring addresses, and no thread idles when
// a panel is shorter than the block (k = 1).
template <int ROWS>
__device__ __forceinline__ void stage_panel(float* dst, int ld,
                                            const float* __restrict__ src,
                                            int rows_total, int row0, int t,
                                            int k, int tid) {
  static_assert((ROWS & (ROWS - 1)) == 0, "q splits into (s, r) by shifts");
  const int q_step = THREADS / k, c_step = THREADS % k;
  int q = tid / k, c = tid % k;   // e = q * k + c with q = s * ROWS + r
  for (int e = tid; e < t * ROWS * k; e += THREADS) {
    const int s = q / ROWS, r = q % ROWS;
    const bool ok = row0 + r < rows_total;
    cp_async4(dst + (s * k + c) * ld + r,
              ok ? src + ((int64_t)s * rows_total + row0 + r) * k + c : src,
              ok);
    q += q_step;
    c += c_step;
    if (c >= k) {
      c -= k;
      ++q;
    }
  }
}

template <bool VEC, int KM_FIRST, int SROWS, class Map, class Io>
__global__ void __launch_bounds__(THREADS, 16 / SROWS)
rank_update_stream(float* __restrict__ m, const float* __restrict__ u,
                   const float* __restrict__ v, int n, int p, int t, int k,
                   Map map, Io io) {
  static_assert(SROWS % 4 == 0, "a thread's rows are read as float4s");
  constexpr int SBM = stream_rows(SROWS), SLDU = SBM + 4;
  extern __shared__ __align__(16) float smem[];
  const int kdim = t * k;
  float* us = smem;                 // [K][SLDU]
  float* vs = smem + kdim * SLDU;   // [K][SLDV]
  int* ids = reinterpret_cast<int*>(vs + kdim * SLDV);   // [SBM]

  const int tid = threadIdx.x;
  const int cx = tid % 32, ry = tid / 32;
  const int i0 = map.row_tile() * SBM;   // the tile's first panel row
  const int li0 = SROWS * ry;            // this thread's first, in the tile
  const int row0 = i0 + li0;
  const int c = map.col_tile() * SBN + 4 * cx;

  // 1. this thread's 8 x 4 elements of M, and 2. the whole K panel of U
  // and V, staged once.  At K <= KM_FIRST M's loads go first (they are the
  // critical path); above it the factors go first, so that the FMAs do not
  // wait for the factors behind M's loads.
  float mv[SROWS][4];
  auto load_m = [&]() {
#pragma unroll
    for (int i = 0; i < SROWS; ++i) {
      const int r = row0 + i;
      const float* src =
          io.src(m) + (int64_t)map.row(ids, i0, li0 + i) * p + c;
      if (VEC) {
        const float4 x = (r < n && c < p) ? ld_m4(src)
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
        mv[i][0] = x.x;
        mv[i][1] = x.y;
        mv[i][2] = x.z;
        mv[i][3] = x.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mv[i][j] = (r < n && c + j < p) ? ld_m1(src + j) : 0.f;
      }
    }
  };
  auto stage = [&]() {
    stage_panel<SBM>(us, SLDU, u, n, i0, t, k, tid);
    stage_panel<SBN>(vs, SLDV, v, p, map.col_tile() * SBN, t, k, tid);
    cp_async_commit();
  };
  if (kdim <= KM_FIRST) {
    map.template stage<SBM>(ids, i0, n, tid);
    load_m();
    stage();
  } else {
    stage();
    map.template stage<SBM>(ids, i0, n, tid);
    load_m();
  }
  cp_async_wait<0>();
  __syncthreads();

  // 3. the sums: SROWS / 4 broadcast LDS.128 of U and 1 LDS.128 of V for
  // 4 SROWS FMAs
  float acc[SROWS][4];
#pragma unroll
  for (int i = 0; i < SROWS; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < kdim; ++kk) {
    float a[SROWS];
#pragma unroll
    for (int h = 0; h < SROWS / 4; ++h) {
      const float4 x = *reinterpret_cast<const float4*>(us + kk * SLDU +
                                                        SROWS * ry + 4 * h);
      a[4 * h] = x.x;
      a[4 * h + 1] = x.y;
      a[4 * h + 2] = x.z;
      a[4 * h + 3] = x.w;
    }
    const float4 b0 = *reinterpret_cast<const float4*>(vs + kk * SLDV + 4 * cx);
    const float b[4] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
    for (int i = 0; i < SROWS; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }

  // 4. M + sums, written once
  bool bad = false;
#pragma unroll
  for (int i = 0; i < SROWS; ++i) {
    const int r = row0 + i;
    if (r >= n) continue;
    float* dst = m + (int64_t)map.row(ids, i0, li0 + i) * p + c;
    if (VEC) {
      if (c < p) {
        const float4 x =
            make_float4(mv[i][0] + acc[i][0], mv[i][1] + acc[i][1],
                        mv[i][2] + acc[i][2], mv[i][3] + acc[i][3]);
        *reinterpret_cast<float4*>(dst) = x;
        if (Io::FLAG)
          bad |= not_finite(x.x) | not_finite(x.y) | not_finite(x.z) |
                 not_finite(x.w);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < p) {
          dst[j] = mv[i][j] + acc[i][j];
          if (Io::FLAG) bad |= not_finite(mv[i][j] + acc[i][j]);
        }
    }
  }
  io.report(bad);
}

// -- skinny tile ----------------------------------------------------------------

// The ring's shared layout for a launch, in floats: each of G::STAGES slots
// holds U's chunk [G::BM][uld] and V's [p][vld]; each of G::STAGES + 1 tile
// buffers holds a tile's run of M (rows * p floats at its offset mod 16) or
// its row ids.  Every region starts 16-byte aligned.
template <class G>
struct SkinnyLayout {
  int uld;   // U's row stride: odd for 4-byte reads, 4 x odd for float4s
  int vld;   // V's row stride: a full chunk's columns rounded up to 4
  int usz, vsz, tsz;
  __host__ __device__ SkinnyLayout(int kdim, int p, bool u16) {
    const int cw = kdim < G::BK ? kdim : G::BK;   // a full chunk's columns
    uld = u16 ? ((cw / 4) % 2 ? cw : cw + 4) : (cw | 1);
    vld = (cw + 3) & ~3;
    usz = (G::BM * uld + 3) & ~3;
    vsz = p * vld;
    tsz = G::BM * p + 4;
  }
  __host__ __device__ size_t bytes() const {
    return ((size_t)G::STAGES * (usz + vsz) + (size_t)(G::STAGES + 1) * tsz) *
           sizeof(float);
  }
};

// Stage the run src[0, len) into dst[h + e] by cp.async, h = src's offset
// in floats mod 4, so that dst and src agree mod 16 bytes: 16-byte copies
// of the aligned body, 4-byte copies of at most 3 floats at each end.
__device__ __forceinline__ void stage_run(float* dst, const float* src,
                                          int len, int tid) {
  const int h = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const int head = min(len, (4 - h) & 3);
  const int quads = (len - head) >> 2, tail = head + 4 * quads;
  if (tid < head)
    cp_async4(dst + h + tid, src + tid, true);
  else if (tid >= 4 && tid - 4 < len - tail)
    cp_async4(dst + h + tail + tid - 4, src + tail + tid - 4, true);
  for (int q = tid; q < quads; q += THREADS)
    cp_async16(dst + h + head + 4 * q, src + head + 4 * q, true);
}

// Store buf[0, len) (shared) to the run dst[0, len): float4 stores where dst
// is 16-byte aligned, scalar stores of at most 3 floats at each end.
__device__ __forceinline__ void store_run(float* dst, const float* buf,
                                          int len, int tid) {
  const int h = (int)((reinterpret_cast<uintptr_t>(dst) >> 2) & 3);
  const int head = min(len, (4 - h) & 3);
  const int quads = (len - head) >> 2, tail = head + 4 * quads;
  if (tid < head)
    dst[tid] = buf[tid];
  else if (tid >= 4 && tid - 4 < len - tail)
    dst[tail + tid - 4] = buf[tail + tid - 4];
  for (int q = tid; q < quads; q += THREADS) {
    const float* b = buf + head + 4 * q;
    *reinterpret_cast<float4*>(dst + head + 4 * q) =
        make_float4(b[0], b[1], b[2], b[3]);
  }
}

// p <= PMAX columns; U16: U's chunks by 16-byte copies (k % 4 == 0, U
// 16-byte aligned).  A persistent grid over row tiles of G::BM rows.
template <int PMAX, bool U16, class G, class Map, class Io>
__global__ void __launch_bounds__(THREADS, G::MINB)
rank_update_skinny(float* __restrict__ m, const float* __restrict__ u,
                   const float* __restrict__ v, int n, int p, int t, int k,
                   Map map, Io io) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int kdim = t * k;
  const SkinnyLayout<G> lay(kdim, p, U16);
  float* us = smem;                              // [G::STAGES][usz]
  float* vs = us + G::STAGES * lay.usz;          // [G::STAGES][vsz]
  float* ts = vs + G::STAGES * lay.vsz;          // [G::STAGES + 1][tsz]
  const float* src = io.src(m);

  const int nch = (kdim + G::BK - 1) / G::BK;
  const int tiles = (n + G::BM - 1) / G::BM;
  const int ntile = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                    (int)gridDim.x;
  const int64_t items = (int64_t)ntile * nch;
  auto tile_row0 = [&](int j) {
    return ((int)blockIdx.x + j * (int)gridDim.x) * G::BM;
  };

  // item g = (tile j, chunk ch) into ring slot g % G::STAGES; a tile's
  // first chunk also brings its run of M or its row ids
  auto issue = [&](int64_t g) {
    const int j = (int)(g / nch), ch = (int)(g % nch);
    const int i0 = tile_row0(j), rows = min(G::BM, n - i0);
    float* ub = us + (int)(g % G::STAGES) * lay.usz;
    float* vb = vs + (int)(g % G::STAGES) * lay.vsz;
    if (ch == 0) {
      float* tb = ts + (j % (G::STAGES + 1)) * lay.tsz;
      if (Map::CONTIGUOUS)
        stage_run(tb, src + (int64_t)i0 * p, rows * p, tid);
      else
        map.template stage_async<G::BM>(reinterpret_cast<int*>(tb), i0, n,
                                          tid);
    }
    // the chunk's flat columns [kk0, kk1), one piece of U_tt and V_tt for
    // each t slice they cross: columns [c, c + w) of U_tt's tile rows
    const int kk0 = ch * G::BK, kk1 = min(kdim, kk0 + G::BK);
    if (!U16 && k == 1) {
      // a stack of rank-1 pairs: the chunk is kk1 - kk0 slices, each a
      // run of the tile's rows of U_kk (and p floats of V_kk)
      const int w = kk1 - kk0;
      const float* ubase = u + (int64_t)kk0 * n + i0;
      for (int e = tid; e < G::BM * w; e += THREADS) {
        const int sl = e / G::BM, r = e % G::BM;
        const bool ok = r < rows;
        cp_async4(ub + r * lay.uld + sl,
                  ok ? ubase + (int64_t)sl * n + r : u, ok);
      }
      for (int e = tid; e < p * w; e += THREADS) {
        const int sl = e / p, jj = e - sl * p;
        cp_async4(vb + jj * lay.vld + sl, v + (int64_t)(kk0 + sl) * p + jj,
                  true);
      }
      return;
    }
    for (int kk = kk0; kk < kk1;) {
      const int tt = kk / k, c = kk - tt * k, w = min(k - c, kk1 - kk);
      const int col = kk - kk0;
      const float* ubase = u + ((int64_t)tt * n + i0) * k + c;
      // the piece's units (16 or 4 bytes) in memory order: unit q of row
      // r, stepped without a division per unit
      const int ur = U16 ? w / 4 : w;
      const int dr = THREADS / ur, dq = THREADS - dr * ur;
      int r = tid / ur, q = tid - r * ur;
      for (int e = tid; e < G::BM * ur; e += THREADS) {
        const bool ok = r < rows;
        if (U16)
          cp_async16(ub + r * lay.uld + col + 4 * q,
                     ok ? ubase + (int64_t)r * k + 4 * q : u, ok);
        else
          cp_async4(ub + r * lay.uld + col + q,
                    ok ? ubase + (int64_t)r * k + q : u, ok);
        r += dr;
        q += dq;
        if (q >= ur) {
          q -= ur;
          ++r;
        }
      }
      const float* vbase = v + (int64_t)tt * p * k + c;
      for (int e = tid; e < p * w; e += THREADS) {
        const int jj = e / w, q = e - jj * w;
        cp_async4(vb + jj * lay.vld + col + q, vbase + (int64_t)jj * k + q,
                  true);
      }
      kk += w;
    }
  };

  for (int s = 0; s < G::STAGES - 1; ++s) {
    if (s < items) issue(s);
    cp_async_commit();
  }

  float acc[G::ROWS][PMAX], mv[G::ROWS][PMAX];
  bool bad = false;
  int pending = -1;   // tile whose run of M waits to be stored (DenseRows)
  auto store_pending = [&]() {
    const int i0 = tile_row0(pending), rows = min(G::BM, n - i0);
    const float* run = src + (int64_t)i0 * p;
    store_run(m + (int64_t)i0 * p,
              ts + (pending % (G::STAGES + 1)) * lay.tsz +
                  ((reinterpret_cast<uintptr_t>(run) >> 2) & 3),
              rows * p, tid);
  };

  for (int64_t g = 0; g < items; ++g) {
    // item g has landed; every thread is past item g - 1, whose slot the
    // next issue reuses, and has added its sums into the pending run
    cp_async_wait<G::STAGES - 2>();
    __syncthreads();
    if (Map::CONTIGUOUS && pending >= 0) {
      store_pending();
      pending = -1;
    }
    if (g + G::STAGES - 1 < items) issue(g + G::STAGES - 1);
    cp_async_commit();

    const int j = (int)(g / nch), ch = (int)(g % nch);
    const int i0 = tile_row0(j), rows = min(G::BM, n - i0);
    float* tb = ts + (j % (G::STAGES + 1)) * lay.tsz;
    const float* ub = us + (int)(g % G::STAGES) * lay.usz;
    const float* vb = vs + (int)(g % G::STAGES) * lay.vsz;
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < G::ROWS; ++i)
#pragma unroll
        for (int jj = 0; jj < PMAX; ++jj) acc[i][jj] = 0.f;
      if (!Map::CONTIGUOUS) {   // the owner's listed rows, read once
        const int* ids = reinterpret_cast<const int*>(tb);
#pragma unroll
        for (int i = 0; i < G::ROWS; ++i) {
          const int r = tid + THREADS * i;
#pragma unroll
          for (int jj = 0; jj < PMAX; ++jj)
            if (r < rows && jj < p)
              mv[i][jj] = ld_m1(src + (int64_t)ids[r] * p + jj);
        }
      }
    }

    // the chunk's columns in flat-kk order
    const int cw = min(G::BK, kdim - ch * G::BK);
    if (U16) {
#pragma unroll
      for (int q = 0; q < G::BK / 4; ++q) {
        if (4 * q >= cw) break;
        float4 a[G::ROWS];
#pragma unroll
        for (int i = 0; i < G::ROWS; ++i)
          a[i] = *reinterpret_cast<const float4*>(
              ub + (tid + THREADS * i) * lay.uld + 4 * q);
        // one column of V at a time: four flat columns, in order, into
        // each of its sums
#pragma unroll
        for (int jj = 0; jj < PMAX; ++jj) {
          if (jj >= p) break;
          const float4 b =
              *reinterpret_cast<const float4*>(vb + jj * lay.vld + 4 * q);
#pragma unroll
          for (int i = 0; i < G::ROWS; ++i) {
            acc[i][jj] = fmaf(a[i].x, b.x, acc[i][jj]);
            acc[i][jj] = fmaf(a[i].y, b.y, acc[i][jj]);
            acc[i][jj] = fmaf(a[i].z, b.z, acc[i][jj]);
            acc[i][jj] = fmaf(a[i].w, b.w, acc[i][jj]);
          }
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < G::BK; ++c) {
        if (c >= cw) break;
        float a[G::ROWS];
#pragma unroll
        for (int i = 0; i < G::ROWS; ++i)
          a[i] = ub[(tid + THREADS * i) * lay.uld + c];
#pragma unroll
        for (int jj = 0; jj < PMAX; ++jj) {
          if (jj >= p) break;
          const float b = vb[jj * lay.vld + c];
#pragma unroll
          for (int i = 0; i < G::ROWS; ++i)
            acc[i][jj] = fmaf(a[i], b, acc[i][jj]);
        }
      }
    }

    if (ch == nch - 1) {   // M + sums, once
      const int h =
          (int)((reinterpret_cast<uintptr_t>(src + (int64_t)i0 * p) >> 2) &
                3);
#pragma unroll
      for (int i = 0; i < G::ROWS; ++i) {
        const int r = tid + THREADS * i;
        if (r >= rows) continue;
        if (Map::CONTIGUOUS) {
          float* mr = tb + h + r * p;
#pragma unroll
          for (int jj = 0; jj < PMAX; ++jj)
            if (jj < p) {
              const float x = mr[jj] + acc[i][jj];
              mr[jj] = x;
              if (Io::FLAG) bad |= not_finite(x);
            }
        } else {
          float* dst = m + (int64_t)reinterpret_cast<const int*>(tb)[r] * p;
#pragma unroll
          for (int jj = 0; jj < PMAX; ++jj)
            if (jj < p) {
              const float x = mv[i][jj] + acc[i][jj];
              dst[jj] = x;
              if (Io::FLAG) bad |= not_finite(x);
            }
        }
      }
      if (Map::CONTIGUOUS) pending = j;
    }
  }
  if (Map::CONTIGUOUS) {
    __syncthreads();
    if (pending >= 0) store_pending();
  }
  io.report(bad);
}

// A block asks for more than 48 KB of dynamic shared memory only by opting
// in (a streaming tile at K > 61, a deeper compute ring).
template <typename Kernel, class Map, class Io>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                   float* m, const float* u, const float* v, int n, int p,
                   int t, int k, Map map, Io io) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, THREADS, smem, stream>>>(m, u, v, n, p, t, k, map, io);
  return cudaGetLastError();
}

// The skinny tile for p <= PMAX: as many blocks as the SMs of device `dev`
// hold at once (at most one a row tile), each walking its row tiles.
template <int PMAX, bool U16, class G, class Map, class Io>
cudaError_t launch_skinny(float* m, const float* u, const float* v, int n,
                          int p, int t, int k, Map map, cudaStream_t stream,
                          Io io, int dev, int sms) {
  const auto kernel = rank_update_skinny<PMAX, U16, G, Map, Io>;
  const size_t smem = SkinnyLayout<G>(t * k, p, U16).bytes();
  // blocks an SM holds, by device and KB of shared memory, from the
  // occupancy API once; host threads that launch side by side may both
  // fill an entry, with the same value (relaxed atomics); devices past
  // SK_DEVICES ask at every launch
  constexpr int SK_DEVICES = 16, SK_KB = 240;
  static std::atomic<int> per_sm[SK_DEVICES][SK_KB];
  const size_t kb = (smem + 1023) / 1024;
  if (kb >= SK_KB) return cudaErrorInvalidValue;
  if (kb > 48) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kb * 1024);
    if (err != cudaSuccess) return err;
  }
  std::atomic<int>* cached = dev < SK_DEVICES ? &per_sm[dev][kb] : nullptr;
  int blocks = cached ? cached->load(std::memory_order_relaxed) : 0;
  if (blocks == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, THREADS, kb * 1024);
    if (err != cudaSuccess) return err;
    if (blocks < 1) return cudaErrorInvalidConfiguration;
    if (cached) cached->store(blocks, std::memory_order_relaxed);
  }
  const int tiles = (n + G::BM - 1) / G::BM;
  const int grid = tiles < sms * blocks ? tiles : sms * blocks;
  kernel<<<grid, THREADS, smem, stream>>>(m, u, v, n, p, t, k, map, io);
  return cudaGetLastError();
}

template <int PMAX, class G, class Map, class Io>
cudaError_t launch_skinny_u(float* m, const float* u, const float* v, int n,
                            int p, int t, int k, Map map, cudaStream_t s,
                            Io io, int dev, int sms) {
  const bool u16 = k % 4 == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0;
  return u16 ? launch_skinny<PMAX, true, G>(m, u, v, n, p, t, k, map, s, io,
                                            dev, sms)
             : launch_skinny<PMAX, false, G>(m, u, v, n, p, t, k, map, s, io,
                                             dev, sms);
}

// The skinny tile for p <= PMAX on the current device: SkTiny through K =
// SK_KTINY where its tiles fill the SMs at least once, else SkLarge.  U's
// chunks by 16-byte copies where k % 4 == 0 and U is aligned.
template <int PMAX, class Map, class Io>
cudaError_t launch_skinny_k(float* m, const float* u, const float* v, int n,
                            int p, int t, int k, Map map, cudaStream_t s,
                            Io io) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if ((int64_t)t * k <= SK_KTINY && n >= (int64_t)SkTiny::BM * sms)
    return launch_skinny_u<PMAX, SkTiny>(m, u, v, n, p, t, k, map, s, io,
                                         dev, sms);
  return launch_skinny_u<PMAX, SkLarge>(m, u, v, n, p, t, k, map, s, io, dev,
                                        sms);
}

// M[map(i)] (i < n) += sum_t U[t] (n, k) V[t]^T, one launch on `stream`:
// the skinny tile for p < PSKINNY; else the streaming tile (SROWS rows a
// thread) through K = T*k = KSTREAM, the compute tile above it; out of
// place (dst m, source in io) under Io = OutOfPlace.  Returns the launch's
// cudaGetLastError() (0 on success; cudaErrorInvalidValue for sizes past
// the tile's grid).
template <int KSTREAM, int KM_FIRST, int SROWS, int PSKINNY, class Map,
          class Io = InPlace>
int rank_update_tiles(float* m, const float* u, const float* v, int n, int p,
                      int t, int k, Map map, void* stream, Io io = Io{}) {
  static_assert(PSKINNY >= 4, "p = 1, 2 and 3 take the skinny tile");
  const int64_t kdim = (int64_t)t * k;
  if (kdim > INT_MAX - CBK) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (p < PSKINNY) {
    if (n > INT_MAX - SK_MARGIN) return (int)cudaErrorInvalidValue;
    return (int)launch_skinny_k<PSKINNY - 1>(m, u, v, n, p, t, k, map, s, io);
  }
  const bool vec = p % 4 == 0 && reinterpret_cast<uintptr_t>(m) % 16 == 0 &&
                   io.aligned16();
  if (kdim <= KSTREAM) {
    constexpr int SBM = stream_rows(SROWS);
    const dim3 grid = Map::grid((n + SBM - 1) / SBM, (p + SBN - 1) / SBN);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)kdim * (SBM + 4 + SLDV) * sizeof(float) +
                        SBM * Map::ID_BYTES;
    return (int)(vec ? launch(rank_update_stream<true, KM_FIRST, SROWS, Map,
                                                 Io>,
                              grid, smem, s, m, u, v, n, p, t, k, map, io)
                     : launch(rank_update_stream<false, KM_FIRST, SROWS, Map,
                                                 Io>,
                              grid, smem, s, m, u, v, n, p, t, k, map, io));
  }
  const dim3 grid = Map::grid((n + CBM - 1) / CBM, (p + CBN - 1) / CBN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = CSMEM + CBM * Map::ID_BYTES;
  return (int)(vec ? launch(rank_update_compute<true, Map, Io>, grid, smem, s,
                            m, u, v, n, p, t, k, map, io)
                   : launch(rank_update_compute<false, Map, Io>, grid, smem,
                            s, m, u, v, n, p, t, k, map, io));
}

}  // namespace
