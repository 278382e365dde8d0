// Helpers shared by flash_attention.cu and flash_decode.cu: element types,
// 16-byte tile loads converted to f32, and warp reductions over lane groups.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

// Elements of T in one 16-byte load.
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Load 16 bytes at `src` (16-byte aligned) as Vec<T>::N floats.
__device__ __forceinline__ void load16(const float* src, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Stage rows pos0 .. pos0+nrows-1 of a (rows x HD) tile whose rows lie
// `row_stride` elements apart, rows at or past `limit` as zeros, into f32
// shared memory TRANSPOSED: dst[d * dst_stride + row].  Neighbouring lanes
// take neighbouring rows, so the shared stores do not conflict.
template <typename T, int HD, int THREADS>
__device__ __forceinline__ void load_tile_transposed(
    const T* __restrict__ src, int64_t row_stride, int pos0, int limit,
    int nrows, float* dst, int dst_stride) {
  constexpr int EPV = Vec<T>::N;
  constexpr int VPR = HD / EPV;
  static_assert(VPR * EPV == HD, "head_dim must fill whole 16-byte loads");
  for (int e = threadIdx.x; e < nrows * VPR; e += THREADS) {
    const int row = e % nrows;
    const int col = (e / nrows) * EPV;
    const int pos = pos0 + row;
    float x[EPV];
    if (pos < limit) {
      load16(src + pos * row_stride + col, x);
    } else {
#pragma unroll
      for (int t = 0; t < EPV; ++t) x[t] = 0.f;
    }
#pragma unroll
    for (int t = 0; t < EPV; ++t) dst[(col + t) * dst_stride + row] = x[t];
  }
}

// The same tile stored row-major, dst[row * HD + d] (16-byte stores).
template <typename T, int HD, int THREADS>
__device__ __forceinline__ void load_tile_rows(
    const T* __restrict__ src, int64_t row_stride, int pos0, int limit,
    int nrows, float* dst) {
  constexpr int EPV = Vec<T>::N;
  constexpr int VPR = HD / EPV;
  static_assert(VPR * EPV == HD, "head_dim must fill whole 16-byte loads");
  for (int e = threadIdx.x; e < nrows * VPR; e += THREADS) {
    const int row = e / VPR;
    const int col = (e % VPR) * EPV;
    const int pos = pos0 + row;
    float x[EPV];
    if (pos < limit) {
      load16(src + pos * row_stride + col, x);
    } else {
#pragma unroll
      for (int t = 0; t < EPV; ++t) x[t] = 0.f;
    }
#pragma unroll
    for (int t = 0; t < EPV; t += 4)
      *reinterpret_cast<float4*>(dst + row * HD + col + t) =
          make_float4(x[t], x[t + 1], x[t + 2], x[t + 3]);
  }
}

// Max and sum over aligned groups of `W` neighbouring lanes (W <= 32).
template <int W>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = W / 2; o > 0; o /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
template <int W>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = W / 2; o > 0; o /= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace attn
