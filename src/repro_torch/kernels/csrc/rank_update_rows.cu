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
// blocks ever write the same row); block is (r, k); V is (p, k); all
// contiguous.
//
// Bound on the card: the op moves 8*r*p + 4*k*(r + p) + 4*r bytes (the r
// listed rows of M read once and written once, each factor and the index
// read once) and does 2*r*p*k FLOPs.  At 3.35 TB/s and 67 TFLOP/s fp32 (H100
// SXM data sheet, 700 W) it is memory-bound below k ~ 80; the main path's
// k runs from 1 to 16 (rank-8 carriers in a bucket of 16 when stacked).
//
// Design: the 64x64 output tile of rank_update.cu with a row map.
//   * one block of 256 threads per (64 listed rows) x (64 columns) tile;
//     the tile's 64 row ids are staged in shared memory once;
//   * each thread owns a 4x4 register tile at listed rows ty + 16*i and
//     columns tx + 16*j, so a half-warp reads 16 neighbouring columns of one
//     row of M (64-byte segments), and reads M before the factor loop;
//   * block and V panels are staged through shared memory in chunks of 16
//     columns of k; each staged element feeds 64 FMAs;
//   * only the listed rows of M are read or written; listed rows past r and
//     columns past p are masked, so any r, p, k is taken.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // listed rows per tile
constexpr int BN = 64;       // columns of M per tile
constexpr int BK = 16;       // factor columns staged per step
constexpr int THREADS = 256;
constexpr int TM = 4;
constexpr int TN = 4;
static_assert(BM == BN, "the staging loop fills both panels together");
static_assert(THREADS == (BM / TM) * (BN / TN), "one thread per 4x4 tile");

__global__ void __launch_bounds__(THREADS)
rank_update_rows_kernel(float* __restrict__ m, const int* __restrict__ rows,
                        const float* __restrict__ block,
                        const float* __restrict__ v, int r, int p, int k) {
  __shared__ float us[BK][BM];
  __shared__ float vs[BK][BN];
  __shared__ int rs[BM];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int i0 = blockIdx.y * BM;   // first listed row of the tile
  const int col0 = blockIdx.x * BN;

  if (tid < BM) rs[tid] = (i0 + tid < r) ? rows[i0 + tid] : -1;
  __syncthreads();

  float mv[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = rs[ty + 16 * i];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + 16 * j;
      mv[i][j] = (row >= 0 && c < p) ? m[(int64_t)row * p + c] : 0.f;
    }
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < k; c0 += BK) {
    const int kc = min(BK, k - c0);
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int t = e % BM;
      const int c = e / BM;
      const int gi = i0 + t;
      const int gc = col0 + t;
      us[c][t] = (gi < r && c < kc) ? block[(int64_t)gi * k + c0 + c] : 0.f;
      vs[c][t] = (gc < p && c < kc) ? v[(int64_t)gc * k + c0 + c] : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < kc; ++c) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = us[c][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = vs[c][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = rs[ty + 16 * i];
    if (row < 0) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < p) m[(int64_t)row * p + c] = mv[i][j] + acc[i][j];
    }
  }
}

}  // namespace

// M[rows[i], :] += block[i, :] V^T for i < r, launched on `stream`.  Returns
// the launch's cudaGetLastError() (0 on success); the caller checks shapes
// and that rows strictly increase within [0, n).
extern "C" int rank_update_rows_f32(float* m, const int* rows,
                                    const float* block, const float* v, int r,
                                    int p, int k, void* stream) {
  const dim3 grid((p + BN - 1) / BN, (r + BM - 1) / BM);
  rank_update_rows_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      m, rows, block, v, r, p, k);
  return (int)cudaGetLastError();
}
