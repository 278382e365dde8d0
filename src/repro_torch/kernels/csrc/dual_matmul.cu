// Dual tall-skinny product  P = A U,  Q = A^T V  with one read of A, for
// Hopper (sm_90a), f32 in, f32 FMA accumulation.
//
// Replaces the Pallas TPU kernel of the reference package:
//   * dual_matmul_pallas  (src/repro/kernels/dual_matmul.py:45)
//     -> entry dual_matmul_f32, behind ops.dual_matmul and
//        ops.sherman_morrison_delta (k = 1: W u and W^T v of one inverse).
//
// Layout: A is (n, m) row-major; U is (m, k), V is (n, k), P is (n, k), Q is
// (m, k), all contiguous.  ws is a caller-allocated workspace of
// (ceil(m / 32), n, k) floats.
//
// Bound on the card: the op moves 4*n*m + 4*k*(2n + 2m) bytes (A, U and V
// read once, P and Q written once) and does 4*n*m*k FLOPs, so at small k it
// is memory-bound: 3.35 TB/s against 67 TFLOP/s fp32 (H100 SXM data sheet,
// 700 W) puts the crossover near k ~ 20.
//
// Reduction across panels.  The TPU kernel walks A's column panels in order
// and carries P in its output block.  Blocks on the card run in parallel in
// no order, so this kernel writes each panel's partial P into the workspace
// and a second pass sums the partials in a fixed order: the result is
// deterministic from run to run (no atomics).  The workspace costs
// 8*n*k*ceil(m/32) bytes of extra traffic, 6 % of A at n = m = 8192, k = 1.
//
// Design, kept simple (no tensor cores, no TMA):
//   * pass 1: one block of 8 warps per 32-column panel of A; each warp
//     walks 32x32 tiles down the panel (warp w takes rows 32w, 32w + 256,
//     ...), loading each tile row as one coalesced 128-byte read into
//     shared memory (padded to 33 columns: conflict-free both ways);
//   * from that tile the warp forms P's partial with a lane per row (written
//     to the workspace, coalesced for k = 1) and Q's partial with a lane per
//     column (kept in registers down the whole panel);
//   * k is taken KC columns at a time (KC = 1 when k = 1, else 8), so A is
//     read once for k <= KC and once per KC columns above that;
//   * after the panel, the 8 warps' Q partials are summed in shared memory
//     in warp order and Q is written once;
//   * pass 2: each warp sums one slice of the panels for 32 entries of P,
//     and the slices are added in warp order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;      // rows and columns of A in a warp's tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

template <int KC>
__global__ void __launch_bounds__(THREADS)
dual_matmul_kernel(const float* __restrict__ a, const float* __restrict__ u,
                   const float* __restrict__ v, float* __restrict__ ws,
                   float* __restrict__ q, int n, int m, int k) {
  __shared__ float tile[WARPS][TILE][TILE + 1];
  __shared__ float vs[WARPS][TILE][KC];
  __shared__ float us[TILE][KC];
  static_assert(WARPS * TILE * KC <= WARPS * TILE * (TILE + 1),
                "the Q reduction reuses the tile buffer");

  const int lane = threadIdx.x % 32;
  const int w = threadIdx.x / 32;
  const int panel = blockIdx.x;
  const int c0 = panel * TILE;
  const int col = c0 + lane;

  for (int j0 = 0; j0 < k; j0 += KC) {
    const int kc = min(KC, k - j0);
    for (int e = threadIdx.x; e < TILE * KC; e += THREADS) {
      const int c = e / KC, j = e % KC;
      us[c][j] = (c0 + c < m && j < kc) ? u[(int64_t)(c0 + c) * k + j0 + j]
                                        : 0.f;
    }
    __syncthreads();

    float qa[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) qa[j] = 0.f;

    for (int r0 = w * TILE; r0 < n; r0 += WARPS * TILE) {
#pragma unroll 8
      for (int i = 0; i < TILE; ++i) {
        const int row = r0 + i;
        tile[w][i][lane] =
            (row < n && col < m) ? a[(int64_t)row * m + col] : 0.f;
      }
      for (int e = lane; e < TILE * KC; e += 32) {
        const int i = e / KC, j = e % KC;
        vs[w][i][j] = (r0 + i < n && j < kc)
                          ? v[(int64_t)(r0 + i) * k + j0 + j] : 0.f;
      }
      __syncwarp();

      // P's partial over this panel: lane = row r0 + lane
      float pa[KC];
#pragma unroll
      for (int j = 0; j < KC; ++j) pa[j] = 0.f;
#pragma unroll 8
      for (int c = 0; c < TILE; ++c) {
        const float t = tile[w][lane][c];
#pragma unroll
        for (int j = 0; j < KC; ++j) pa[j] = fmaf(t, us[c][j], pa[j]);
      }
      if (r0 + lane < n) {
        float* dst = ws + ((int64_t)panel * n + r0 + lane) * k + j0;
#pragma unroll
        for (int j = 0; j < KC; ++j)
          if (j < kc) dst[j] = pa[j];
      }

      // Q's partial: lane = column c0 + lane
#pragma unroll 8
      for (int i = 0; i < TILE; ++i) {
        const float t = tile[w][i][lane];
#pragma unroll
        for (int j = 0; j < KC; ++j) qa[j] = fmaf(t, vs[w][i][j], qa[j]);
      }
      __syncwarp();
    }

    __syncthreads();   // every warp is done with its tiles
    float* red = &tile[0][0][0];
#pragma unroll
    for (int j = 0; j < KC; ++j) red[(w * TILE + lane) * KC + j] = qa[j];
    __syncthreads();
    if (w == 0 && col < m) {
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        if (j >= kc) break;
        float s = 0.f;
        for (int ww = 0; ww < WARPS; ++ww) s += red[(ww * TILE + lane) * KC + j];
        q[(int64_t)col * k + j0 + j] = s;
      }
    }
    __syncthreads();
  }
}

// P[e] = sum over panels of ws[panel][e], e < n*k, in panel order within a
// warp's slice and warp order across slices.
__global__ void __launch_bounds__(THREADS)
reduce_panels_kernel(const float* __restrict__ ws, float* __restrict__ p,
                     int64_t count, int panels) {
  __shared__ float part[WARPS][32];
  const int lane = threadIdx.x % 32;
  const int w = threadIdx.x / 32;
  const int64_t e = (int64_t)blockIdx.x * 32 + lane;
  float s = 0.f;
  if (e < count)
    for (int j = w; j < panels; j += WARPS) s += ws[(int64_t)j * count + e];
  part[w][lane] = s;
  __syncthreads();
  if (w == 0 && e < count) {
    float t = 0.f;
    for (int ww = 0; ww < WARPS; ++ww) t += part[ww][lane];
    p[e] = t;
  }
}

}  // namespace

// P (n, k) = A (n, m) U (m, k) and Q (m, k) = A^T V (n, k), launched on
// `stream`; ws holds ceil(m / 32) * n * k floats.  Returns the first
// failing launch's cudaGetLastError() (0 on success); the caller checks
// shapes.
extern "C" int dual_matmul_f32(const float* a, const float* u, const float* v,
                               float* p, float* q, float* ws, int n, int m,
                               int k, void* stream) {
  const int panels = (m + TILE - 1) / TILE;
  cudaStream_t s = (cudaStream_t)stream;
  if (k == 1)
    dual_matmul_kernel<1><<<panels, THREADS, 0, s>>>(a, u, v, ws, q, n, m, k);
  else
    dual_matmul_kernel<8><<<panels, THREADS, 0, s>>>(a, u, v, ws, q, n, m, k);
  int code = (int)cudaGetLastError();
  if (code != 0) return code;
  const int64_t count = (int64_t)n * k;
  reduce_panels_kernel<<<(unsigned)((count + 31) / 32), THREADS, 0, s>>>(
      ws, p, count, panels);
  return (int)cudaGetLastError();
}
