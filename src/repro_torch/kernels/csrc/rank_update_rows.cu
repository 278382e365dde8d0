// Row-local rank-k view update  M[rows[i], :] += block[i, :] V^T  for Hopper
// (sm_90a), f32 in, f32 FMA accumulation, in place on M.
//
// Replaces the Pallas TPU kernel of the reference package:
//   * rank_update_rows_pallas  (src/repro/kernels/rank_update_rows.py:50)
//     -> entry rank_update_rows_f32, the apply of every view the compiler
//        proved row-local under a row-local delta carrier.
//
// The TPU kernel sweeps whole row slabs named by scalar-prefetched slab ids
// and needs a dense (n, k) left factor that is zero outside them.  Here the
// kernel takes the r affected row indices and the compact (r, k) block
// directly: no slab plan, no padding ids, no dense factor.
//
// Layout: M is (n, p) row-major; rows is (r,) int32, strictly increasing and
// in [0, n) (the wrapper checks this on the host before upload, so no two
// tiles ever write the same row); block is (r, k); V is (p, k); all
// contiguous.
//
// Bound on the card: the op moves 8*r*p + 4*k*(r + p) + 4*r bytes (the r
// listed rows of M read once and written once, each factor and the index
// read once) and does 2*r*p*k FLOPs.  At 3.35 TB/s and 67 TFLOP/s fp32 (H100
// SXM data sheet, 700 W) it is memory-bound below k ~ 80.  The main path's
// k runs from 1 to 16 for one carrier and to 128 for a stacked batch of 16
// rank-8 carriers, so both regimes occur.
//
// Design: the dense kernel's problem with one change, M's row of listed row
// i is rows[i].  So it is the tiles of rank_update_tiles.cuh with the
// ListedRows map: the compact block is the factor panel with n := r and
// T := 1, staged coalesced as the dense U is, and only M's addresses go
// through the tile's row ids, staged in shared memory once.  Only the
// listed rows of M are read or written.  Views of p < PSKINNY columns take
// the skinny tile, where each thread reads and writes its listed rows.

#include "rank_update_tiles.cuh"

namespace {

// Measured at the row shapes (tools/torch_rank_update_variants.py;
// PERF.md): the dense entry's crossovers hold, but a streaming tile of 32
// rows (4 a thread, 64 registers, four blocks an SM) beats one of 64 at
// k <= 16, where a 1 %-row carrier's few hundred tiles of 64 rows filled
// the card's two block slots an SM less than twice.
constexpr int KSTREAM = 40;   // largest k that takes the streaming tile
constexpr int KM_FIRST = 16;  // largest k whose M loads precede the staging
constexpr int SROWS = 4;      // rows of M a thread of the streaming tile owns
constexpr int PSKINNY = 4;    // p below it takes the skinny tile, at any K
                              // (the row tiles were not measured wider)

}  // namespace

// M[rows[i], :] += block[i, :] V^T for i < r, launched on `stream`.  Returns
// the launch's cudaGetLastError() (0 on success, cudaErrorInvalidValue for a
// grid past 2^31 - 1 blocks); the caller checks shapes and that rows
// strictly increase within [0, n).
extern "C" int rank_update_rows_f32(float* m, const int* rows,
                                    const float* block, const float* v, int r,
                                    int p, int k, void* stream) {
  const int64_t col_tiles = ((int64_t)p + SBN - 1) / SBN;
  const int64_t row_tiles = ((int64_t)r + stream_rows(SROWS) - 1) /
                            stream_rows(SROWS);
  if (r > INT_MAX - CBM || row_tiles * col_tiles > INT_MAX)
    return (int)cudaErrorInvalidValue;
  return rank_update_tiles<KSTREAM, KM_FIRST, SROWS, PSKINNY>(
      m, block, v, r, p, 1, k, ListedRows{rows, (int)col_tiles}, stream);
}
