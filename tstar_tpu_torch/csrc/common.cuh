// Shared helpers of the port's CUDA kernels: paired loads/stores for bf16 and
// f32, rounding to the storage type, and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tstar {

// Two adjacent elements moved as one 4-byte (bf16) or 8-byte (f32) access.
template <typename T> struct Pair;

template <> struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ float2 to_float2(type v) { return __bfloat1622float2(v); }
  static __device__ __forceinline__ type from_float2(float2 f) {
    return __floats2bfloat162_rn(f.x, f.y);
  }
};

template <> struct Pair<float> {
  using type = float2;
  static __device__ __forceinline__ float2 to_float2(type v) { return v; }
  static __device__ __forceinline__ type from_float2(float2 f) { return f; }
};

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }

// x rounded to T and read back as f32 (identity for f32).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace tstar
