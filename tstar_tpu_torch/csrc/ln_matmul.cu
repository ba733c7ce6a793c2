// K5: a pre-norm LayerNorm folded into the bf16 matmul it feeds.
//
// Replaces tstar_tpu/kernels/ln_matmul.py:_ln_matmul_kernel (via
// _ln_matmul_pallas and ln_matmul).  For x (R, D) bf16, scale32 / bias32 (D,)
// f32 (already cast f32 -> bf16 -> f32 by the wrapper), W (D, N) bf16 and
// b (N,) bf16:
//   mean = sum(x) / D,  var = sum(x^2) / D - mean^2          (f32)
//   mul  = rsqrt(var + eps) * scale32
//   h    = bf16((x - mean) * mul + bias32)
//   out  = bf16(bf16(h @ W  accumulated in f32) + b)
// as the TPU kernel computes it.  The row statistics and the product sum in
// another order than the plain version's, so a normalized value or the
// product can round to a neighbouring bf16 value (the bound is
// kernels/ln_matmul.py bf16_error_bound).
//
// What bounds it on the H100: ln1 -> qkv (D = 768, N = 2304) and ln2 -> fc1
// (N = 3072) at R = 577 rows are 2.0 and 2.7 GFLOP (2.1 / 2.7 us at 989
// TFLOP/s) against 7.1 and 9.2 MB (2.1 / 2.8 us at 3.35 TB/s): nearly
// balanced, so the normalized rows must not make a round trip through
// device memory.  One block owns 64 rows: it computes their statistics and
// writes the normalized rows as bf16 into shared memory (64 x 768 x 2 B =
// 96 KB, dynamic shared memory, rows padded by 8 elements), then walks its
// share of the 128-wide N tiles, streaming W through shared memory in
// 32-deep chunks into the bf16 tensor cores (WMMA m16n16k16, f32
// accumulators).  Blocks split N so that small R still fills the SMs.
// wgmma, TMA and a pipelined ring of W tiles are later work.
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BM = 64;        // rows per block
constexpr int BN = 128;       // output columns per N tile
constexpr int BK = 32;        // depth of one W chunk
constexpr int THREADS = 256;  // 8 warps: 2 (rows) x 4 (columns) of 32 x 32
constexpr int LDB = BN + 8;   // padded W-chunk row, in elements

__global__ void __launch_bounds__(THREADS)
ln_matmul_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale32,
                 const float* __restrict__ bias32, const __nv_bfloat16* __restrict__ w,
                 const __nv_bfloat16* __restrict__ b, __nv_bfloat16* __restrict__ out,
                 int R, int D, int N, float eps, int tiles_per_block) {
  using namespace nvcuda;
  extern __shared__ __align__(256) unsigned char smem[];
  const int ldh = D + 8;  // padded normalized row, in elements
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(smem);          // [BM][ldh]
  __nv_bfloat16* wt = hs + (size_t)BM * ldh;                          // [BK][LDB]
  float* stage = reinterpret_cast<float*>(wt + BK * LDB);              // [8 warps][16*16]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * BM;

  // 1. Normalize this block's rows into shared memory; warp w owns rows
  //    w, w+8, ...; 8 elements (16 bytes) a lane at a time.
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int row = m0 + r;
    __nv_bfloat16* hr = hs + (size_t)r * ldh;
    if (row >= R) {
      for (int k = lane * 8; k < D; k += 32 * 8)
        *reinterpret_cast<uint4*>(hr + k) = make_uint4(0, 0, 0, 0);
      continue;
    }
    const __nv_bfloat16* xr = x + (size_t)row * D;
    float s = 0.f, ss = 0.f;
    for (int k = lane * 8; k < D; k += 32 * 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(xr + k);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(p[i]);
        s += f.x + f.y;
        ss += f.x * f.x + f.y * f.y;
      }
    }
    s = tstar::warp_sum(s);
    ss = tstar::warp_sum(ss);
    const float mean = __fdiv_rn(s, (float)D);
    const float var = __fsub_rn(__fdiv_rn(ss, (float)D), __fmul_rn(mean, mean));
    const float inv = rsqrtf(__fadd_rn(var, eps));
    for (int k = lane * 8; k < D; k += 32 * 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(xr + k);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
      uint4 o;
      __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(p[i]);
        const int c = k + 2 * i;
        const float y0 = __fadd_rn(__fmul_rn(__fsub_rn(f.x, mean), __fmul_rn(inv, scale32[c])), bias32[c]);
        const float y1 = __fadd_rn(__fmul_rn(__fsub_rn(f.y, mean), __fmul_rn(inv, scale32[c + 1])), bias32[c + 1]);
        q[i] = __floats2bfloat162_rn(y0, y1);
      }
      *reinterpret_cast<uint4*>(hr + k) = o;
    }
  }
  __syncthreads();

  // 2. This block's N tiles on the bf16 tensor cores.
  const int wm = (warp / 4) * 32, wn = (warp % 4) * 32;
  const int n_tiles = (N + BN - 1) / BN;
  const int t0 = blockIdx.x * tiles_per_block;
  const int t1 = min(n_tiles, t0 + tiles_per_block);
  float* st = stage + warp * 256;
  for (int t = t0; t < t1; ++t) {
    const int n0 = t * BN;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int k0 = 0; k0 < D; k0 += BK) {
      // W chunk [k0, k0+32) x [n0, n0+128): 512 vectors of 8, 2 a thread.
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int v = tid + i * THREADS;
        const int kk = v / (BN / 8), c = (v % (BN / 8)) * 8;
        const int n = n0 + c;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (n < N) val = *reinterpret_cast<const uint4*>(w + (size_t)(k0 + kk) * N + n);
        *reinterpret_cast<uint4*>(wt + kk * LDB + c) = val;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], hs + (size_t)(wm + i * 16) * ldh + k0 + kk, ldh);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(fb[j], wt + kk * LDB + wn + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }

    // Epilogue: round the f32 sum to bf16, then add b in bf16 (rounds again).
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        const int r = lane / 2, c0 = (lane % 2) * 8;
        const int row = m0 + wm + i * 16 + r, col = n0 + wn + j * 16 + c0;
        if (row < R && col < N) {
          const uint4 bu = *reinterpret_cast<const uint4*>(b + col);
          const __nv_bfloat16* bv = reinterpret_cast<const __nv_bfloat16*>(&bu);
          uint4 o;
          __nv_bfloat16* ov = reinterpret_cast<__nv_bfloat16*>(&o);
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const float prod = __bfloat162float(__float2bfloat16(st[r * 16 + c0 + c]));
            ov[c] = __float2bfloat16(__fadd_rn(prod, __bfloat162float(bv[c])));
          }
          *reinterpret_cast<uint4*>(out + (size_t)row * N + col) = o;
        }
        __syncwarp();
      }
  }
}

}  // namespace

extern "C" int tstar_ln_matmul_bf16(const void* x, const void* scale32, const void* bias32,
                                    const void* w, const void* b, void* out, int R, int D,
                                    int N, float eps, void* stream) {
  if (R < 1 || D < 32 || N < 16 || D % 32 || N % 16) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(b) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)BM * (D + 8) * 2 + (size_t)BK * LDB * 2 + (THREADS / 32) * 256 * sizeof(float);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(ln_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int row_tiles = (R + BM - 1) / BM;
  const int n_tiles = (N + BN - 1) / BN;
  int groups = (2 * sms + row_tiles - 1) / row_tiles;
  groups = max(1, min(groups, n_tiles));
  const int per = (n_tiles + groups - 1) / groups;
  groups = (n_tiles + per - 1) / per;
  if (row_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(groups, row_tiles);
  ln_matmul_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale32),
      static_cast<const float*>(bias32), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(out), R, D, N, eps, per);
  return (int)cudaGetLastError();
}
