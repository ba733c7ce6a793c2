// K3: one-pass row LayerNorm.
//
// Replaces tstar_tpu/kernels/layernorm.py:_ln_kernel (the pallas_call at
// :126, entry fused_layernorm).  For x (R, D) in bf16, f16 or f32 and scale,
// bias (D,) in x's dtype:
//   mean = sum(x) / D,  var = sum(x^2) / D - mean^2      (f32; flax's
//                                                         use_fast_variance)
//   y    = (x - mean) * (rsqrt(var + eps) * scale) + bias, rounded once (RNE)
// to x's dtype; scale and bias are widened from x's dtype to f32.
//
// What bounds it on the H100: it reads each element once and writes it once
// and does ~8 flops per element, so bytes: a (16 x 577, 768) bf16 tensor moves
// 28.4 MB, 8.5 us at 3.35 TB/s; at 577 rows (0.9 MB) the launch itself.  The
// earlier Triton kernel's device work was a few us a call, but its Python
// launch path cost 0.05-0.08 ms of host time per call, on the critical path
// of a search whose card is idle 85% of the time.  So this kernel is plain
// CUDA in the ctypes library: one C call, no device queries per launch.
//
// Design.  One warp per row, 8 rows per 256-thread CTA.  The row stays in
// registers: lane l loads 16-byte vectors l, l + 32, ... (at D = 768: three in
// bf16, six in f32), so each element is read once; sum(x) and sum(x^2) in f32
// by warp shuffles; the output is written from the same registers.  That
// takes D a multiple of 32 vectors and at most 8 vectors a lane (bf16 / f16:
// D in 256 .. 2048 step 256; f32: 128 .. 1024 step 128).  Every other D that
// the reference's kernel takes (a multiple of 128: SigLIP's 1152, an LLM's
// 3584) goes to a second version that reads the row twice through 8-byte
// vectors (128 bf16 or 64 f32 values a warp), once for the statistics and
// once to normalize it; the second read finds the row in L1 (a CTA's 8 rows
// are 18 KB at 1152 bf16).  The wrapper raises on a D not a multiple of 128.
#include <cuda_fp16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int ROWS_PER_CTA = 8;
constexpr int MAX_VPL = 8;  // 16-byte vectors per lane

// A 16-byte vector of T <-> float[N]; an 8-byte one <-> float[N / 2].
template <typename T> struct Pack;
template <> struct Pack<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float* v) {
    v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
  static __device__ __forceinline__ void unpack(const uint2& u, float* v) {
    v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
  }
  static __device__ __forceinline__ uint2 pack2(const float* v) {
    return make_uint2(__float_as_uint(v[0]), __float_as_uint(v[1]));
  }
};
template <> struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float* v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return u;
  }
  static __device__ __forceinline__ void unpack(const uint2& u, float* v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
  static __device__ __forceinline__ uint2 pack2(const float* v) {
    uint2 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
    h[0] = __floats2bfloat162_rn(v[0], v[1]);
    h[1] = __floats2bfloat162_rn(v[2], v[3]);
    return u;
  }
};
template <> struct Pack<__half> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float* v) {
    const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    uint4 u;
    __half2* h = reinterpret_cast<__half2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
    return u;
  }
  static __device__ __forceinline__ void unpack(const uint2& u, float* v) {
    const __half2* h = reinterpret_cast<const __half2*>(&u);
    const float2 a = __half22float2(h[0]), b = __half22float2(h[1]);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
  static __device__ __forceinline__ uint2 pack2(const float* v) {
    uint2 u;
    __half2* h = reinterpret_cast<__half2*>(&u);
    h[0] = __floats2half2_rn(v[0], v[1]);
    h[1] = __floats2half2_rn(v[2], v[3]);
    return u;
  }
};

template <typename T, int VPL>
__global__ void __launch_bounds__(ROWS_PER_CTA * 32)
layernorm_kernel(const T* __restrict__ x, const T* __restrict__ scale, const T* __restrict__ bias,
                 T* __restrict__ out, int R, float eps) {
  constexpr int N = Pack<T>::N;
  constexpr int D = VPL * 32 * N;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS_PER_CTA + threadIdx.x / 32;
  if (row >= R) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * D);
  float v[VPL][N];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    Pack<T>::unpack(__ldg(xr + lane + 32 * i), v[i]);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      s1 += v[i][j];
      s2 += v[i][j] * v[i][j];
    }
  }
  s1 = tstar::warp_sum(s1);
  s2 = tstar::warp_sum(s2);
  const float mean = s1 / (float)D;
  const float var = s2 / (float)D - mean * mean;
  const float inv = rsqrtf(var + eps);
  const uint4* sv = reinterpret_cast<const uint4*>(scale);
  const uint4* bv = reinterpret_cast<const uint4*>(bias);
  uint4* orow = reinterpret_cast<uint4*>(out + (size_t)row * D);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    float s[N], b[N], y[N];
    Pack<T>::unpack(__ldg(sv + lane + 32 * i), s);
    Pack<T>::unpack(__ldg(bv + lane + 32 * i), b);
#pragma unroll
    for (int j = 0; j < N; ++j) y[j] = (v[i][j] - mean) * (inv * s[j]) + b[j];
    orow[lane + 32 * i] = Pack<T>::pack(y);
  }
}

// The widths the register version does not hold: the row read twice, lane l
// taking 8-byte vectors l, l + 32, ... (D a multiple of 32 of them).
template <typename T>
__global__ void __launch_bounds__(ROWS_PER_CTA * 32)
layernorm_wide_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                      const T* __restrict__ bias, T* __restrict__ out, int R, int D, float eps) {
  constexpr int N = Pack<T>::N / 2;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS_PER_CTA + threadIdx.x / 32;
  if (row >= R) return;
  const int vecs = D / N;
  const uint2* xr = reinterpret_cast<const uint2*>(x + (size_t)row * D);
  float s1 = 0.f, s2 = 0.f;
  for (int i = lane; i < vecs; i += 32) {
    float v[N];
    Pack<T>::unpack(__ldg(xr + i), v);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      s1 += v[j];
      s2 += v[j] * v[j];
    }
  }
  s1 = tstar::warp_sum(s1);
  s2 = tstar::warp_sum(s2);
  const float mean = s1 / (float)D;
  const float var = s2 / (float)D - mean * mean;
  const float inv = rsqrtf(var + eps);
  const uint2* sv = reinterpret_cast<const uint2*>(scale);
  const uint2* bv = reinterpret_cast<const uint2*>(bias);
  uint2* orow = reinterpret_cast<uint2*>(out + (size_t)row * D);
  for (int i = lane; i < vecs; i += 32) {
    float v[N], s[N], b[N], y[N];
    Pack<T>::unpack(__ldg(xr + i), v);
    Pack<T>::unpack(__ldg(sv + i), s);
    Pack<T>::unpack(__ldg(bv + i), b);
#pragma unroll
    for (int j = 0; j < N; ++j) y[j] = (v[j] - mean) * (inv * s[j]) + b[j];
    orow[i] = Pack<T>::pack2(y);
  }
}

template <typename T>
int launch(const void* x, const void* scale, const void* bias, void* out, int R, int D, float eps,
           cudaStream_t stream) {
  constexpr int N = Pack<T>::N;
  if (R < 1 || D < 128 || D % 128) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((R + ROWS_PER_CTA - 1) / ROWS_PER_CTA);
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(scale);
  const T* bp = static_cast<const T*>(bias);
  T* op = static_cast<T*>(out);
  const int vpl = D % (32 * N) ? 0 : D / (32 * N);
  if (vpl < 1 || vpl > MAX_VPL) {
    layernorm_wide_kernel<T><<<grid, ROWS_PER_CTA * 32, 0, stream>>>(xp, sp, bp, op, R, D, eps);
    return (int)cudaGetLastError();
  }
#define TSTAR_LN_CASE(V)                                                                    \
  case V:                                                                                   \
    layernorm_kernel<T, V><<<grid, ROWS_PER_CTA * 32, 0, stream>>>(xp, sp, bp, op, R, eps); \
    break;
  switch (vpl) {
    TSTAR_LN_CASE(1)
    TSTAR_LN_CASE(2)
    TSTAR_LN_CASE(3)
    TSTAR_LN_CASE(4)
    TSTAR_LN_CASE(5)
    TSTAR_LN_CASE(6)
    TSTAR_LN_CASE(7)
    TSTAR_LN_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TSTAR_LN_CASE
  static_assert(MAX_VPL == 8, "the switch above lists 1 .. MAX_VPL");
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16, 2 = f16; D a multiple of 128.  x, scale, bias and
// out 16-byte aligned.
extern "C" int tstar_layernorm(const void* x, const void* scale, const void* bias, void* out,
                               int R, int D, int dtype, float eps, void* stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(scale) |
                         reinterpret_cast<uintptr_t>(bias) | reinterpret_cast<uintptr_t>(out);
  if (ptrs % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, scale, bias, out, R, D, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, scale, bias, out, R, D, eps, s);
  if (dtype == 2) return launch<__half>(x, scale, bias, out, R, D, eps, s);
  return (int)cudaErrorInvalidValue;
}
