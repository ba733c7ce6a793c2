// K4: per-row dynamic int8 quantization fused into an int8 GEMM (W8A8).
//
// Replaces tstar_tpu/kernels/quant_matmul.py:_w8a8_kernel (via _w8a8_pallas
// and w8a8_matmul), i.e. ops/quant.py dense_w8a8.  For x (R, K) in f32 or
// bf16, W (K, N) int8, ws and b (N,) f32:
//   xs[r] = max(max_k |x[r,k]|, 1e-12) / 127
//   q     = clip(rint(x / xs), -127, 127)                 (int8)
//   acc   = sum_k q[r,k] * W[k,n]                         (int32)
//   out   = ((float)acc * xs[r]) * ws[n] + b[n]           (f32, then out type)
// bit for bit as the plain version: IEEE divisions (__fdiv_rn), round half
// to even (__float2int_rn), an exact integer product, and an epilogue of
// separately rounded __fmul_rn / __fadd_rn that nvcc cannot contract into an
// FMA.  The library is built without --use_fast_math.
//
// What bounds it on the H100: at the main path's shapes (R = 577 .. 9232
// rows, K x N = 768 x 2304 / 768 x 768 / 768 x 3072 / 3072 x 768) the int8
// product is 0.7-44 GOP, 0.4-22 us at 1,979 TOP/s, and the bytes (x in f32
// or bf16, W, the output) take 0.7-50 us at 3.35 TB/s, so it is bound by
// bytes at one image and nearly balanced at 16.  The TPU kernel quantized
// each row block in VMEM and fed the int8 MXU; here one block owns 64 rows:
// it quantizes its whole 64 x K slab once into shared memory as int8 (64 x
// 3072 = 192 KB at fc2, dynamic shared memory), so x is read from device
// memory once per block and never written back quantized, then walks its
// share of the N tiles (128 wide), streaming W through shared memory in 64-
// deep chunks into the int8 tensor cores (WMMA m16n16k16 s8 -> s32).  The
// slab is stored k-group-major ([K/16][64][16] bytes) and each W chunk
// n-group-major ([128/16][64][16]) so every WMMA tile starts on a 256-byte
// boundary.  Blocks split N so that small R still fills the SMs.  wgmma,
// TMA and a pipelined ring of W tiles are later work.
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BM = 64;       // rows per block (the slab)
constexpr int BN = 128;      // output columns per N tile
constexpr int BK = 64;       // depth of one W chunk
constexpr int THREADS = 256; // 8 warps: 2 (rows) x 4 (columns) of 32 x 32

template <typename T> struct Vec;  // 16-byte vector of T, widened to float
template <> struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename TI, typename TO>
__global__ void __launch_bounds__(THREADS)
w8a8_kernel(const TI* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ ws, const float* __restrict__ bias,
            TO* __restrict__ out, int R, int K, int N, int tiles_per_block) {
  using namespace nvcuda;
  extern __shared__ __align__(256) unsigned char smem[];
  int8_t* slab = reinterpret_cast<int8_t*>(smem);                 // [K/16][BM][16]
  int8_t* wt = slab + (size_t)K * BM;                              // [BN/16][BK][16]
  int* stage = reinterpret_cast<int*>(wt + BK * BN);               // [8 warps][16*16]
  float* xs_s = reinterpret_cast<float*>(stage + (THREADS / 32) * 256);  // [BM]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * BM;
  constexpr int V = Vec<TI>::N;

  // 1. Quantize the slab: warp w owns rows w, w+8, ...; row absmax, then
  //    q = clip(rint(x / xs)) written k-group-major.
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int row = m0 + r;
    if (row >= R) {  // rows past the end quantize to zero
      for (int k = lane * 16; k < K; k += 32 * 16) {
        *reinterpret_cast<uint4*>(slab + (size_t)(k / 16) * BM * 16 + r * 16) = make_uint4(0, 0, 0, 0);
      }
      if (lane == 0) xs_s[r] = 1.f;
      continue;
    }
    const TI* xr = x + (size_t)row * K;
    float amax = 0.f;
    for (int k = lane * V; k < K; k += 32 * V) {
      float v[V];
      Vec<TI>::load(xr + k, v);
#pragma unroll
      for (int i = 0; i < V; ++i) amax = fmaxf(amax, fabsf(v[i]));
    }
    amax = tstar::warp_max(amax);
    const float xs = __fdiv_rn(fmaxf(amax, 1e-12f), 127.f);
    if (lane == 0) xs_s[r] = xs;
    for (int k = lane * V; k < K; k += 32 * V) {
      float v[V];
      Vec<TI>::load(xr + k, v);
      uint32_t packed[V / 4];  // four int8 per word, lowest k in the low byte
#pragma unroll
      for (int i = 0; i < V / 4; ++i) packed[i] = 0u;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int qi = min(127, max(-127, __float2int_rn(__fdiv_rn(v[i], xs))));
        packed[i / 4] |= ((uint32_t)qi & 0xffu) << (8 * (i % 4));
      }
      int8_t* dst = slab + (size_t)(k / 16) * BM * 16 + r * 16 + (k % 16);
#pragma unroll
      for (int i = 0; i < V / 4; ++i) reinterpret_cast<uint32_t*>(dst)[i] = packed[i];
    }
  }
  __syncthreads();

  // 2. This block's N tiles: int8 tensor-core product against W chunks.
  const int wm = (warp / 4) * 32, wn = (warp % 4) * 32;
  const int n_tiles = (N + BN - 1) / BN;
  const int t0 = blockIdx.x * tiles_per_block;
  const int t1 = min(n_tiles, t0 + tiles_per_block);
  int* st = stage + warp * 256;
  for (int t = t0; t < t1; ++t) {
    const int n0 = t * BN;
    wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

    for (int k0 = 0; k0 < K; k0 += BK) {
      // W chunk [k0, k0+64) x [n0, n0+128): 512 16-byte vectors, 2 a thread.
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int v = tid + i * THREADS;
        const int kk = v / (BN / 16), g = v % (BN / 16);
        const int k = k0 + kk, n = n0 + g * 16;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (k < K && n < N) val = *reinterpret_cast<const uint4*>(w + (size_t)k * N + n);
        *reinterpret_cast<uint4*>(wt + g * BK * 16 + kk * 16) = val;
      }
      __syncthreads();
      const int kmax = min(BK, K - k0);
      for (int kk = 0; kk < kmax; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> fb[2];
        const int8_t* ag = slab + (size_t)((k0 + kk) / 16) * BM * 16;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], reinterpret_cast<const signed char*>(ag + (wm + i * 16) * 16), 16);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], reinterpret_cast<const signed char*>(wt + ((wn / 16) + j) * BK * 16 + kk * 16), 16);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }

    // Epilogue: each 16x16 int32 tile through this warp's stage; a lane
    // dequantizes 8 columns of one row.
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        const int r = lane / 2, c0 = (lane % 2) * 8;
        const int row = m0 + wm + i * 16 + r, col = n0 + wn + j * 16 + c0;
        if (row < R && col < N) {
          const float xs = xs_s[wm + i * 16 + r];
          TO* o = out + (size_t)row * N + col;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const float a = __int2float_rn(st[r * 16 + c0 + c]);
            store_out(o + c, __fadd_rn(__fmul_rn(__fmul_rn(a, xs), ws[col + c]), bias[col + c]));
          }
        }
        __syncwarp();
      }
  }
}

template <typename TI, typename TO>
int launch_w8a8(const void* x, const void* w, const void* ws, const void* b, void* out,
                int R, int K, int N, void* stream) {
  if (R < 1 || K < 16 || N < 16 || K % 16 || N % 16) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)K * BM + BK * BN + (THREADS / 32) * 256 * sizeof(int) + BM * sizeof(float);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(w8a8_kernel<TI, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  // Split the N tiles over enough blocks to give every SM about two.
  const int row_tiles = (R + BM - 1) / BM;
  const int n_tiles = (N + BN - 1) / BN;
  int groups = (2 * sms + row_tiles - 1) / row_tiles;
  groups = max(1, min(groups, n_tiles));
  const int per = (n_tiles + groups - 1) / groups;
  groups = (n_tiles + per - 1) / per;
  if (row_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(groups, row_tiles);
  w8a8_kernel<TI, TO><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const TI*>(x), static_cast<const int8_t*>(w), static_cast<const float*>(ws),
      static_cast<const float*>(b), static_cast<TO*>(out), R, K, N, per);
  return (int)cudaGetLastError();
}

}  // namespace

// x_dtype / out_dtype: 0 = f32, 1 = bf16.
extern "C" int tstar_w8a8(const void* x, const void* w, const void* ws, const void* b, void* out,
                          int R, int K, int N, int x_dtype, int out_dtype, void* stream) {
  if (x_dtype == 0 && out_dtype == 0) return launch_w8a8<float, float>(x, w, ws, b, out, R, K, N, stream);
  if (x_dtype == 0 && out_dtype == 1) return launch_w8a8<float, __nv_bfloat16>(x, w, ws, b, out, R, K, N, stream);
  if (x_dtype == 1 && out_dtype == 0) return launch_w8a8<__nv_bfloat16, float>(x, w, ws, b, out, R, K, N, stream);
  if (x_dtype == 1 && out_dtype == 1) return launch_w8a8<__nv_bfloat16, __nv_bfloat16>(x, w, ws, b, out, R, K, N, stream);
  return (int)cudaErrorInvalidValue;
}
