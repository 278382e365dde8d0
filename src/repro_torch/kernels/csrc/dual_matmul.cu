// Dual tall-skinny product  P = A U,  Q = A^T V  with one read of A, for
// Hopper (sm_90a), f32 in, f32 FMA accumulation.
//
// Replaces the Pallas TPU kernel of the reference package:
//   * dual_matmul_pallas  (src/repro/kernels/dual_matmul.py:45)
//     -> entry dual_matmul_f32, behind ops.dual_matmul and
//        ops.sherman_morrison_delta (k = 1: W u and W^T v of one inverse).
//
// Layout: A is (n, m) row-major; U is (m, k), V is (n, k), P is (n, k), Q is
// (m, k), all contiguous.  ws is a caller-allocated workspace of the floats
// that dual_matmul_workspace reports for the same n, m, k on the current
// device (0 when one block covers the whole of A).
//
// Bound on the card: the op moves 4*n*m + 4*k*(2n + 2m) bytes (A, U and V
// read once, P and Q written once) and does 4*n*m*k FLOPs, so at small k it
// is bound by A's bytes: 268 MB at n = m = 8192 is 0.080 ms at 3.35 TB/s,
// against 67 TFLOP/s fp32 (H100 SXM data sheet, 700 W) the crossover is
// near k ~ 20.  Everything below is about streaming A at the card's rate.
//
// Design.
//   * Tiles.  A block of 8 warps takes a strip of 1024 columns of A (each
//     warp 128 of them) and a band of rows; the grid is strips x bands,
//     sized by the plan below to one wave of OCC blocks an SM.
//   * One read of A, 16-byte loads, a per-thread ring.  A thread owns 4
//     columns of its warp's 128 and walks the band's rows: each row of the
//     warp's part is one contiguous 512-byte run (float4 a lane).  Rows go
//     through a STAGES-deep cp.async ring of ROWS rows a stage in shared
//     memory, where each thread reads back exactly the 16 bytes it copied:
//     no barrier guards the ring, and STAGES - 1 stages stay in flight
//     while the thread does the FMAs of the current one.  V's rows for a
//     stage (ROWS x KC floats) ride in the same ring, copied once a warp.
//   * Both products from the same registers.  For each row the thread adds
//     a * V[row] into its Q columns (kept in registers down the band) and
//     forms its 4-column share of the row's P dot product with U's values
//     for its columns (loaded once).  The warp sums the shares of a stage's
//     ROWS x KC dot products with a transposing butterfly (each step halves
//     the values a lane holds: 6 shuffles for 4 rows at k = 1, where a plain
//     butterfly per row takes 20), and every GROUP rows the block adds its 8
//     warps' sums in warp order through shared memory behind one barrier.
//   * k is taken KC columns at a time (KC = 1 when k = 1, else 8), so A is
//     read once for k <= 8 and once per 8 columns above that.
//   * Deterministic reductions, small workspace.  With more than one strip
//     each strip writes its P partial to the workspace, with more than one
//     band each band its Q partial; a second kernel adds them in strip and
//     band order (no atomics).  It is launched as a programmatic dependent
//     (griddepcontrol), so its launch overlaps the stream pass's tail and
//     it waits on the card for the pass's writes.  At n = m = 8192, k = 1:
//     8 strips x 16 bands, 0.79 MB of partials written and read back, 0.6 %
//     of A's bytes.  One block (strips = bands = 1) writes P and Q directly.
//   * Alignment.  A moves as 16-byte cp.async only where m % 4 == 0 and A's
//     pointer is 16-byte aligned; otherwise (m % 4 != 0, a view at a
//     storage offset) the same kernel copies 4-byte words, lane l owning
//     columns l, l + 32, l + 64, l + 96 of its warp's 128, still one
//     128-byte run a warp per copy.  Rows, columns and U/V columns past the
//     edge are zero-filled, so any n, m, k >= 1 is taken.
//
// ROWS, STAGES, OCC, GROUP and MIN_BAND were chosen on the card with
// tools/torch_dual_matmul_variants.py (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int WCOLS = 128;              // columns of A a warp owns
constexpr int STRIP = WARPS * WCOLS;    // columns of A a block owns
constexpr int GROUP = 32;               // rows a block's P sums cover
constexpr int MIN_BAND = 8;             // fewest rows in a band
constexpr int SMEM_LIMIT = 227 * 1024;  // a block's shared memory, sm_90

// per KC: rows a stage, stages of the ring, blocks an SM the plan fills
template <int KC> struct Cfg;
template <> struct Cfg<1> {
  static constexpr int ROWS = 4, STAGES = 3, OCC = 1;
};
template <> struct Cfg<8> {
  static constexpr int ROWS = 4, STAGES = 4, OCC = 1;
};

template <int KC>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)Cfg<KC>::STAGES * Cfg<KC>::ROWS * THREADS * 16     // A
         + (size_t)WARPS * Cfg<KC>::STAGES * Cfg<KC>::ROWS * KC * 4  // V
         + (size_t)2 * WARPS * GROUP * KC * 4;                       // P sums
}

__host__ __device__ constexpr int ilog2(int x) {
  return x <= 1 ? 0 : 1 + ilog2(x / 2);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// asynchronous copies global -> shared; 0 bytes read (zero-filled) when !ok
__device__ __forceinline__ void cp_async16(void* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The warp's sums of N values (N a power of 2, at most 32): lane l returns
// the sum over all 32 lanes of value l >> (5 - log2 N).  Each transposing
// step (partner lane l ^ O) swaps half of a lane's values with its partner's
// and adds, so it halves what the lane holds; a plain butterfly finishes.
// The order of every addition is fixed.
template <int N, int O = 16>
__device__ __forceinline__ float warp_sums(float* x, int lane) {
  static_assert(N >= 1 && N <= 32 && (N & (N - 1)) == 0, "N = 2^p <= 32");
  if constexpr (N == 1) {
    float s = x[0];
#pragma unroll
    for (int o = O; o >= 1; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
    return s;
  } else {
    constexpr int H = N / 2;
    const bool hi = lane & O;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = hi ? x[i] : x[i + H];
      const float keep = hi ? x[i + H] : x[i];
      x[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    return warp_sums<H, O / 2>(x, lane);
  }
}

// One pass over A for U/V columns j0 .. j0 + KC - 1 of every chunk.  Block
// b takes strip b % strips and band b / strips of band_rows rows.  P's sums
// go to p when strips == 1, else to wsp[strip]; Q's to q when bands == 1,
// else to wsq[band].
template <int KC, bool VEC>
__global__ void __launch_bounds__(THREADS, Cfg<KC>::OCC)
dual_stream(const float* __restrict__ a, const float* __restrict__ u,
            const float* __restrict__ v, float* __restrict__ p,
            float* __restrict__ q, float* __restrict__ wsp,
            float* __restrict__ wsq, int n, int m, int k, int strips,
            int bands, int band_rows) {
  constexpr int ROWS = Cfg<KC>::ROWS, STAGES = Cfg<KC>::STAGES;
  constexpr int NV = ROWS * KC;            // dot products a stage
  constexpr int LOGNV = ilog2(NV);
  static_assert(NV <= 32 && (NV & (NV - 1)) == 0,
                "a stage's dot products fill at most one warp_sums");
  static_assert(GROUP % ROWS == 0, "a group is whole stages");
  static_assert(smem_bytes<KC>() * Cfg<KC>::OCC <= 228 * 1024 -
                    1024 * Cfg<KC>::OCC,
                "OCC blocks fit an SM's shared memory");

  // the sums' grid may start once every block of this one has: its blocks
  // take free slots and wait on the card for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  extern __shared__ float4 smem[];
  float4* ring = smem;                                        // [S][R][T]
  float* vring = reinterpret_cast<float*>(ring + STAGES * ROWS * THREADS);
  float* psum = vring + WARPS * STAGES * NV;                  // [2][W][G*KC]

  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int strip = blockIdx.x % strips, band = blockIdx.x / strips;
  const int r0 = band * band_rows;
  const int r1 = min(n, r0 + band_rows);
  const int nst = (r1 - r0 + ROWS - 1) / ROWS;
  const int cw = strip * STRIP + w * WCOLS;
  int col[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    col[c] = VEC ? cw + 4 * lane + c : cw + lane + 32 * c;
  float* vw = vring + w * STAGES * NV;
  float* pdst = strips == 1 ? p : wsp + (int64_t)strip * n * k;
  float* qdst = bands == 1 ? q : wsq + (int64_t)band * m * k;
  int buf = 0;

  for (int j0 = 0; j0 < k; j0 += KC) {
    const int kc = min(KC, k - j0);

    // stage s of this band into ring slot s % STAGES: the thread's 16 bytes
    // of each of ROWS rows, and (lanes < NV) one value of V's rows
    auto issue = [&](int s) {
      const int slot = s % STAGES;
      const int row0 = r0 + s * ROWS;
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int row = row0 + i;
        const bool rok = row < r1;
        const float* src = a + (int64_t)(rok ? row : r0) * m;
        float4* dst = ring + (slot * ROWS + i) * THREADS + tid;
        if constexpr (VEC) {
          const bool ok = rok && col[0] < m;
          cp_async16(dst, ok ? src + col[0] : a, ok);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const bool ok = rok && col[c] < m;
            cp_async4(reinterpret_cast<float*>(dst) + c,
                      ok ? src + col[c] : a, ok);
          }
        }
      }
      if (lane < NV) {
        const int row = row0 + lane / KC, j = lane % KC;
        const bool ok = row < r1 && j < kc;
        cp_async4(vw + slot * NV + lane,
                  ok ? v + (int64_t)row * k + j0 + j : v, ok);
      }
    };

    float ur[4][KC], qa[4][KC];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        ur[c][j] = (col[c] < m && j < kc) ? u[(int64_t)col[c] * k + j0 + j]
                                         : 0.f;
        qa[c][j] = 0.f;
      }

    __syncwarp();   // the warp is done with V's slots of the last chunk
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nst) issue(s);
      cp_async_commit();
    }

    for (int t = 0; t < nst; ++t) {
      __syncwarp();   // every lane is done with slot (t - 1) % STAGES
      if (t + STAGES - 1 < nst) issue(t + STAGES - 1);
      cp_async_commit();
      cp_async_wait<STAGES - 1>();
      __syncwarp();   // V's values of stage t, copied by lanes < NV

      const int slot = t % STAGES;
      float x[NV];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float4 t4 = ring[(slot * ROWS + i) * THREADS + tid];
        const float av[4] = {t4.x, t4.y, t4.z, t4.w};
        const float* vr = vw + slot * NV + i * KC;
        float vv[KC];
        if constexpr (KC % 4 == 0) {
#pragma unroll
          for (int j = 0; j < KC; j += 4) {
            const float4 v4 = *reinterpret_cast<const float4*>(vr + j);
            vv[j] = v4.x;
            vv[j + 1] = v4.y;
            vv[j + 2] = v4.z;
            vv[j + 3] = v4.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < KC; ++j) vv[j] = vr[j];
        }
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          float d = av[0] * ur[0][j];
#pragma unroll
          for (int c = 1; c < 4; ++c) d = fmaf(av[c], ur[c][j], d);
          x[i * KC + j] = d;
#pragma unroll
          for (int c = 0; c < 4; ++c) qa[c][j] = fmaf(av[c], vv[j], qa[c][j]);
        }
      }

      // the warp's sums of this stage's dot products, into the group
      const float s = warp_sums<NV>(x, lane);
      const int pos = (t * ROWS) % GROUP;
      float* pw = psum + (buf * WARPS + w) * GROUP * KC;
      if ((lane & ((32 >> LOGNV) - 1)) == 0)
        pw[pos * KC + (lane >> (5 - LOGNV))] = s;

      // a whole group (or the band's last rows): add the warps' sums in
      // warp order and write P's partial for these rows
      if (pos + ROWS == GROUP || t == nst - 1) {
        __syncthreads();
        const int g0 = r0 + t * ROWS - pos;
        const int cnt = min(GROUP, r1 - g0) * KC;
        const float* pb = psum + buf * WARPS * GROUP * KC;
        for (int e = tid; e < cnt; e += THREADS) {
          const int j = e % KC;
          if (j >= kc) continue;
          float sum = pb[e];
#pragma unroll
          for (int ww = 1; ww < WARPS; ++ww) sum += pb[ww * GROUP * KC + e];
          pdst[(int64_t)(g0 + e / KC) * k + j0 + j] = sum;
        }
        buf ^= 1;
      }
    }
    cp_async_wait<0>();

#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (col[c] < m)
#pragma unroll
        for (int j = 0; j < KC; ++j)
          if (j < kc) qdst[(int64_t)col[c] * k + j0 + j] = qa[c][j];
  }
}

// P[e] = sum over strips of wsp[s][e] (e < np = n*k), Q[e] = sum over bands
// of wsq[b][e] (e < nq = m*k).  A block takes 32 outputs: warp w adds the
// partials w, w + 8, ... in order, and the warps' sums are added in warp
// order.  Blocks of P come first (none when strips == 1), then Q's.
__global__ void __launch_bounds__(THREADS)
dual_sums(const float* __restrict__ wsp, const float* __restrict__ wsq,
          float* __restrict__ p, float* __restrict__ q, int64_t np,
          int64_t nq, int strips, int bands, int pblocks) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __shared__ float part[WARPS][32];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const bool isp = (int)blockIdx.x < pblocks;
  const int64_t e = (int64_t)(isp ? blockIdx.x : blockIdx.x - pblocks) * 32
                    + lane;
  const int64_t count = isp ? np : nq;
  const int parts = isp ? strips : bands;
  const float* src = isp ? wsp : wsq;
  float s = 0.f;
  if (e < count)
#pragma unroll 4
    for (int j = w; j < parts; j += WARPS) s += src[(int64_t)j * count + e];
  part[w][lane] = s;
  __syncthreads();
  if (w == 0 && e < count) {
    float t = part[0][lane];
#pragma unroll
    for (int ww = 1; ww < WARPS; ++ww) t += part[ww][lane];
    (isp ? p : q)[e] = t;
  }
}

struct Plan {
  int strips, bands, band_rows;
  int64_t wsp, wsq;   // floats of each workspace part
};

// strips x bands blocks, one wave of OCC blocks an SM where the strips
// allow it, bands of at least MIN_BAND rows (a multiple of ROWS).
template <int KC>
Plan make_plan(int n, int m, int k, int sms) {
  constexpr int ROWS = Cfg<KC>::ROWS;
  Plan pl;
  pl.strips = (m + STRIP - 1) / STRIP;
  const int slots = sms * Cfg<KC>::OCC;
  int bands = slots / pl.strips;
  bands = max(1, min(bands, (n + MIN_BAND - 1) / MIN_BAND));
  int rows = (n + bands - 1) / bands;
  rows = (rows + ROWS - 1) / ROWS * ROWS;
  pl.band_rows = rows;
  pl.bands = (n + rows - 1) / rows;
  pl.wsp = pl.strips > 1 ? (int64_t)pl.strips * n * k : 0;
  pl.wsq = pl.bands > 1 ? (int64_t)pl.bands * m * k : 0;
  return pl;
}

int sm_count(int* sms) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && cached[dev]) {
    *sms = cached[dev];
    return 0;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64) cached[dev] = *sms;
  return 0;
}

template <int KC, bool VEC>
int launch(const float* a, const float* u, const float* v, float* p,
           float* q, float* ws, int n, int m, int k, int sms,
           cudaStream_t s) {
  static unsigned long long raised = 0;   // devices with the smem limit set
  constexpr size_t smem = smem_bytes<KC>();
  static_assert(smem <= SMEM_LIMIT, "the ring fits a block");
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !((raised >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(dual_stream<KC, VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) raised |= 1ull << dev;
  }
  const Plan pl = make_plan<KC>(n, m, k, sms);
  float* wsp = ws;
  float* wsq = ws + pl.wsp;
  dual_stream<KC, VEC><<<(unsigned)pl.strips * pl.bands, THREADS, smem, s>>>(
      a, u, v, p, q, wsp, wsq, n, m, k, pl.strips, pl.bands, pl.band_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess || (pl.strips == 1 && pl.bands == 1))
    return (int)err;
  const int64_t np = (int64_t)n * k, nq = (int64_t)m * k;
  const int pblocks = pl.strips > 1 ? (int)((np + 31) / 32) : 0;
  const int qblocks = pl.bands > 1 ? (int)((nq + 31) / 32) : 0;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(pblocks + qblocks));
  cfg.blockDim = dim3(THREADS);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, dual_sums, (const float*)wsp,
                                 (const float*)wsq, p, q, np, nq, pl.strips,
                                 pl.bands, pblocks);
}

}  // namespace

// Floats of workspace that dual_matmul_f32 needs for (n, m, k) on the
// current device, into *floats.  Returns a cudaError_t (0 on success).
extern "C" int dual_matmul_workspace(int n, int m, int k, long long* floats) {
  int sms = 0;
  const int err = sm_count(&sms);
  if (err) return err;
  const Plan pl = k == 1 ? make_plan<1>(n, m, k, sms)
                         : make_plan<8>(n, m, k, sms);
  *floats = pl.wsp + pl.wsq;
  return 0;
}

// P (n, k) = A (n, m) U (m, k) and Q (m, k) = A^T V (n, k), launched on
// `stream`; ws holds dual_matmul_workspace's floats.  n, m, k >= 1.
// Returns the first failing launch's cudaError_t (0 on success); the caller
// checks shapes.
extern "C" int dual_matmul_f32(const float* a, const float* u, const float* v,
                               float* p, float* q, float* ws, int n, int m,
                               int k, void* stream) {
  int sms = 0;
  const int err = sm_count(&sms);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = m % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  if (k == 1)
    return vec ? launch<1, true>(a, u, v, p, q, ws, n, m, k, sms, s)
               : launch<1, false>(a, u, v, p, q, ws, n, m, k, sms, s);
  return vec ? launch<8, true>(a, u, v, p, q, ws, n, m, k, sms, s)
             : launch<8, false>(a, u, v, p, q, ws, n, m, k, sms, s);
}
