// Select-commit of a guarded firing for Hopper (sm_90a):
//
//   new = any(flags) ? old : new        (in place on new, f32)
//
// The commit of the guarded engine's fused fast path (repro_torch.guard).
// A transactional firing writes every view out of place
// (rank_update_batched_out_f32), so the pre-firing view `old` is intact
// beside the firing's `new`; the firing's checks leave their verdict in a
// few int flags on the card.  This kernel keeps the store finite without a
// host sync: when any flag is set, it copies old over new.
//
// Replaces no Pallas kernel.  The reference fuses the same select into its
// jitted firing as jnp.where(ok, new, old) (src/repro/guard/__init__.py:316),
// which XLA folds into the trigger's own update loops.  On this card a
// where() would read old and new and write the result: 12 bytes an element
// on every firing, clean or not.  Here every block reads the flags first
// and returns when they are clear, so a clean firing costs one launch and
// no bytes of the view; a failed one costs the copy, 8 bytes an element
// (old read once, new written once), bound by the memory rate.
//
// Layout: old and new are contiguous float32 of `numel` elements; flags is
// `nflags` int32.  The copy moves float4s when both pointers are 16-byte
// aligned and numel % 4 == 0, else scalars; a grid-stride loop covers any
// size.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;   // 8 blocks for each of the 132 SMs

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
select_commit(const int* __restrict__ flags, int nflags,
              const float* __restrict__ old, float* __restrict__ out,
              int64_t numel) {
  int fail = 0;
  for (int i = 0; i < nflags; ++i) fail |= flags[i];
  if (!fail) return;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (VEC) {
    const float4* src = reinterpret_cast<const float4*>(old);
    float4* dst = reinterpret_cast<float4*>(out);
    for (const int64_t n4 = numel / 4; i < n4; i += stride) dst[i] = src[i];
  } else {
    for (; i < numel; i += stride) out[i] = old[i];
  }
}

}  // namespace

// new (numel f32) := old when any of flags[0 .. nflags) is nonzero, else
// left as it is; launched on `stream`.  Returns the launch's
// cudaGetLastError() (0 on success); the caller checks that old and new do
// not overlap.
extern "C" int select_commit_f32(const int* flags, int nflags,
                                 const float* old, float* out, int64_t numel,
                                 void* stream) {
  if (numel <= 0) return 0;
  const bool vec = numel % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(old) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t items = vec ? numel / 4 : numel;
  const int64_t want = (items + THREADS - 1) / THREADS;
  const int blocks = (int)(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    select_commit<true><<<blocks, THREADS, 0, s>>>(flags, nflags, old, out,
                                                    numel);
  else
    select_commit<false><<<blocks, THREADS, 0, s>>>(flags, nflags, old, out,
                                                     numel);
  return (int)cudaGetLastError();
}
