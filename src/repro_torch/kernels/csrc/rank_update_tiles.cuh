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
// Design.  One launch per call; the entry picks one of two tiles from
// K = T*k and from M's alignment.
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
//
// KSTREAM, KM_FIRST and SROWS are template parameters of each entry, chosen
// from measurement on the card (tools/torch_rank_update_variants.py times
// the choices side by side at the main path's shapes; PERF.md).

#pragma once

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4-byte asynchronous copy global -> shared; writes 0 when !ok (src is then
// not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
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
  static dim3 grid(int row_tiles, int col_tiles) {
    return dim3(col_tiles, row_tiles);
  }
  __device__ __forceinline__ int row_tile() const { return blockIdx.y; }
  __device__ __forceinline__ int col_tile() const { return blockIdx.x; }
  template <int ROWS>
  __device__ __forceinline__ void stage(int*, int, int, int) const {}
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

// M[map(i)] (i < n) += sum_t U[t] (n, k) V[t]^T, one launch on `stream`:
// the streaming tile (SROWS rows a thread) through K = T*k = KSTREAM, the
// compute tile above it; out of place (dst m, source in io) under
// Io = OutOfPlace.  Returns the launch's cudaGetLastError() (0 on success).
template <int KSTREAM, int KM_FIRST, int SROWS, class Map, class Io = InPlace>
int rank_update_tiles(float* m, const float* u, const float* v, int n, int p,
                      int t, int k, Map map, void* stream, Io io = Io{}) {
  const int64_t kdim = (int64_t)t * k;
  if (kdim > INT_MAX - CBK) return (int)cudaErrorInvalidValue;
  const bool vec = p % 4 == 0 && reinterpret_cast<uintptr_t>(m) % 16 == 0 &&
                   io.aligned16();
  const cudaStream_t s = (cudaStream_t)stream;
  if (kdim <= KSTREAM) {
    constexpr int SBM = stream_rows(SROWS);
    const dim3 grid = Map::grid((n + SBM - 1) / SBM, (p + SBN - 1) / SBN);
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
  const size_t smem = CSMEM + CBM * Map::ID_BYTES;
  return (int)(vec ? launch(rank_update_compute<true, Map, Io>, grid, smem, s,
                            m, u, v, n, p, t, k, map, io)
                   : launch(rank_update_compute<false, Map, Io>, grid, smem,
                            s, m, u, v, n, p, t, k, map, io));
}

}  // namespace
