// Rank-K view update  M += sum_t U_t V_t^T  for Hopper (sm_90a), f32 in, f32
// FMA accumulation, in place on M.
//
// Replaces the Pallas TPU kernels of the reference package:
//   * rank_update_batched_pallas  (src/repro/kernels/rank_update.py:84)
//     -> entry rank_update_batched_f32, the engine's every low-rank apply;
//   * rank_update_pallas          (src/repro/kernels/rank_update.py:40)
//     -> entry rank_update_f32, the T = 1 case of the same kernel;
//   * both, out of place: entry rank_update_batched_out_f32,
//     dst = src + sum_t U_t V_t^T with a flag set when a stored value is
//     not finite, every low-rank apply of a guarded (transactional) firing.
//     The reference needs no such entry: its arrays are immutable, so the
//     pre-firing view survives every apply (src/repro/guard/txn.py:55).
//
// Layout: M is (n, p) row-major; U is the stack (T, n, k) and V the stack
// (T, p, k), both contiguous; a 2-D (n, K) factor pair is the T = 1 stack
// with k = K.  Row i of U updates row i of M (the DenseRows map).
//
// Bound on the card: with K = T*k the op moves 8*n*p + 4*K*(n + p) bytes
// (M read once and written once, each factor read once; out of place: src
// read once and dst written once, the same bytes) and does 2*n*p*K
// FLOPs.  At 3.35 TB/s and 67 TFLOP/s fp32 (H100 SXM data sheet, 700 W) a
// square view is memory-bound below K ~ 80 and FLOP-bound above; a view
// of p columns does at most p / 2 FLOPs a byte of U, so a narrow one
// (p < ~40) is memory-bound at every K.  The main path's K
// runs from 1 (a rank-1 update to the input) to 256 (the top view of
// matrix powers under a T = 16 batch), so both regimes occur.
//
// Design: the three tiles of rank_update_tiles.cuh (a streaming tile for
// the byte-bound regime, a 128 x 128 FMA tile with a cp.async ring for the
// FLOP-bound one, and a skinny tile for views of p < PSKINNY columns, which
// are byte-bound at every K); the header describes them.
//
// KSTREAM and KM_FIRST were chosen from measurement on the card
// (tools/torch_rank_update_variants.py; PERF.md): the streaming tile is
// faster through K = 40 and the compute tile from K = 48, below the
// roofline crossover (K ~ 80), because neither tile overlaps its FMAs with
// M's traffic fully.  PSKINNY = 4 gives the skinny tile p = 1, 2 and 3,
// where it beat the other two by 3-19x at 2^20 rows.  It also beat them at
// p = 4-16 from 65536 rows (by 1.2-3.9x; PERF.md), but no path launches
// such views, so they keep the other tiles.

#include "rank_update_tiles.cuh"

namespace {

constexpr int KSTREAM = 40;   // largest K that takes the streaming tile
constexpr int KM_FIRST = 16;  // largest K whose M loads precede the staging
constexpr int SROWS = 8;      // rows of M a thread of the streaming tile owns
constexpr int PSKINNY = 4;    // p below it takes the skinny tile, at any K

}  // namespace

// M (n, p) += sum_t U[t] (n, k) V[t]^T, launched on `stream`.  Returns the
// launch's cudaGetLastError() (0 on success); the caller checks shapes.
extern "C" int rank_update_batched_f32(float* m, const float* u,
                                       const float* v, int n, int p, int t,
                                       int k, void* stream) {
  return rank_update_tiles<KSTREAM, KM_FIRST, SROWS, PSKINNY>(
      m, u, v, n, p, t, k, DenseRows{}, stream);
}

// M (n, p) += U (n, k) V (p, k)^T: the T = 1 entry.
extern "C" int rank_update_f32(float* m, const float* u, const float* v,
                               int n, int p, int k, void* stream) {
  return rank_update_batched_f32(m, u, v, n, p, 1, k, stream);
}

// dst (n, p) = src (n, p) + sum_t U[t] (n, k) V[t]^T, launched on `stream`:
// the in-place entry's tiles and arithmetic with the source and the
// destination apart, so dst is bitwise what the in-place entry leaves in M.
// *nonfinite (when not null) is set to 1 if any value stored to dst is not
// finite; it is never cleared.  The caller checks shapes and that src, dst
// and the factors do not overlap.
extern "C" int rank_update_batched_out_f32(const float* src, float* dst,
                                           const float* u, const float* v,
                                           int* nonfinite, int n, int p,
                                           int t, int k, void* stream) {
  return rank_update_tiles<KSTREAM, KM_FIRST, SROWS, PSKINNY>(
      dst, u, v, n, p, t, k, DenseRows{}, stream,
      OutOfPlace{src, nonfinite});
}
