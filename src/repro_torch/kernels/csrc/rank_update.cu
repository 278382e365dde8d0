// Rank-k view update  M += sum_t U_t V_t^T  for Hopper (sm_90a), f32 in, f32
// FMA accumulation, in place on M.
//
// Replaces the Pallas TPU kernels of the reference package:
//   * rank_update_batched_pallas  (src/repro/kernels/rank_update.py:84)
//     -> entry rank_update_batched_f32, the engine's every low-rank apply;
//   * rank_update_pallas          (src/repro/kernels/rank_update.py:40)
//     -> entry rank_update_f32, the T = 1 case of the same kernel.
//
// Layout: M is (n, p) row-major; U is the stack (T, n, k) and V the stack
// (T, p, k), both contiguous.  The kernel walks the stack through strides
// (U_t starts at u + t*n*k), so the wrapper never reshapes or copies the
// factors; a 2-D (n, K) factor pair is the T = 1 stack with k = K.
//
// Bound on the card: with K = T*k the op moves 8*n*p + 4*K*(n + p) bytes
// (M read once and written once, each factor read once) and does 2*n*p*K
// FLOPs.  At 3.35 TB/s and 67 TFLOP/s fp32 (H100 SXM data sheet, 700 W) it
// is memory-bound below K ~ 80 and FLOP-bound above.  The main path's K
// runs from 1 (a rank-1 update to the input) to 256 (the top view of
// matrix powers under a T = 16 batch), so both regimes occur.
//
// Design, kept simple on purpose (no tensor cores, no TMA):
//   * one block of 256 threads per 64x64 output tile; each thread owns a
//     4x4 register tile at rows ty + 16*i and columns tx + 16*j, so a
//     half-warp touches 16 neighbouring columns of M;
//   * the thread reads its 16 elements of M first, so M's latency overlaps
//     the factor loop, and writes them back once at the end: M is read once
//     and written once, the memory-bound optimum;
//   * U and V panels are staged through shared memory in chunks of 16
//     columns of k; each staged element feeds 64 FMAs;
//   * plain fp32 FMA (no TF32), so results match the reference's
//     preferred_element_type=f32 path to rounding;
//   * rows, columns and k chunks past the edge are masked, so any n, p, k
//     is taken (n = 10000 is not a multiple of 64).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // tile rows of M
constexpr int BN = 64;       // tile columns of M
constexpr int BK = 16;       // factor columns staged per step
constexpr int THREADS = 256;
constexpr int TM = 4;        // rows of M per thread
constexpr int TN = 4;        // columns of M per thread
static_assert(BM == BN, "the staging loop fills U and V panels together");
static_assert(THREADS == (BM / TM) * (BN / TN), "one thread per 4x4 tile");

__global__ void __launch_bounds__(THREADS)
rank_update_kernel(float* __restrict__ m, const float* __restrict__ u,
                   const float* __restrict__ v, int n, int p, int t, int k) {
  __shared__ float us[BK][BM];
  __shared__ float vs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float mv[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + 16 * j;
      mv[i][j] = (r < n && c < p) ? m[(int64_t)r * p + c] : 0.f;
    }
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < t; ++s) {
    const float* us_src = u + (int64_t)s * n * k;
    const float* vs_src = v + (int64_t)s * p * k;
    for (int c0 = 0; c0 < k; c0 += BK) {
      const int kc = min(BK, k - c0);
      // stage a (BM x kc) panel of U_s and a (BN x kc) panel of V_s;
      // consecutive threads take consecutive rows, so shared stores are
      // conflict-free and a k = 1 factor is read fully coalesced
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int r = e % BM;
        const int c = e / BM;
        const int gr = row0 + r;
        const int gc = col0 + r;
        us[c][r] = (gr < n && c < kc) ? us_src[(int64_t)gr * k + c0 + c] : 0.f;
        vs[c][r] = (gc < p && c < kc) ? vs_src[(int64_t)gc * k + c0 + c] : 0.f;
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
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < p) m[(int64_t)r * p + c] = mv[i][j] + acc[i][j];
    }
  }
}

}  // namespace

// M (n, p) += sum_t U[t] (n, k) V[t]^T, launched on `stream`.  Returns the
// launch's cudaGetLastError() (0 on success); the caller checks shapes.
extern "C" int rank_update_batched_f32(float* m, const float* u,
                                       const float* v, int n, int p, int t,
                                       int k, void* stream) {
  const dim3 grid((p + BN - 1) / BN, (n + BM - 1) / BM);
  rank_update_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      m, u, v, n, p, t, k);
  return (int)cudaGetLastError();
}

// M (n, p) += U (n, k) V (p, k)^T: the T = 1 entry.
extern "C" int rank_update_f32(float* m, const float* u, const float* v,
                               int n, int p, int k, void* stream) {
  return rank_update_batched_f32(m, u, v, n, p, 1, k, stream);
}
