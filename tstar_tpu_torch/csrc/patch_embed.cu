// K2: stride-p patchify fused into the patch-embedding GEMM.
//
// Replaces tstar_tpu/kernels/patch_matmul.py:_patch_kernel (via _patch_pallas
// and patch_embed_matmul).  Computes
//   out[b, i*npw + j, d] = sum_{ph, pw, c} px[b, p*i+ph, p*j+pw, c] * W[ph, pw, c, d]
// from NHWC pixels and an HWIO kernel, with f32 accumulation, and never
// materializes the patchified (B*P, p*p*C) matrix.  (The TPU kernel padded C
// to 4 only to fill its 128 lanes; nothing here needs that.)
//
// It is an implicit GEMM with M = B*P, N = D, K = p*p*C.  The A operand's
// address splits into a row part and a column part: for row m = (b, i, j)
//   base(m) = ((b*H + i*p) * W + j*p) * C
// and for column k = (ph, pw, c) in the HWIO flattening order
//   off(k)  = ph * W * C + (k mod p*C)
// because (pw, c) is one contiguous run of p*C elements in an NHWC row.  So
// A[m, k] = px[base(m) + off(k)] and a tile loader needs one multiply per
// element.
//
// What bounds it on the H100: at the main path's shape (M = 576 per image,
// K = 3072, N = 768) it is a compute-bound GEMM (~2.7 GFLOP per image), so
// it belongs on the tensor cores.  bf16 runs there through WMMA (16x16x16
// mma.sync tiles, f32 accumulators; 128x128 outputs per block, 16-byte
// vector loads of the implicit A operand).  f32, and bf16 shapes whose
// k-runs are not 8-aligned, take a CUDA-core version (64x64 outputs per
// block, 4x4 per thread, FMA through shared-memory tiles of depth 16),
// correct for any p, C and D.  Double-buffered TMA/wgmma tiles are later
// work.
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
patch_embed_kernel(const T* __restrict__ px, const T* __restrict__ w, T* __restrict__ out,
                   int H, int W, int C, int p, int D, int M, int K, int npw, int P) {
  __shared__ __align__(16) float as[BK][BM + 4];
  __shared__ __align__(16) float bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int pc = p * C;
  const size_t row_elems = (size_t)W * C;

  // This thread loads A elements idx = tid + i*THREADS: row idx / BK, column idx % BK.
  size_t a_base[4];
  bool a_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = tid + i * THREADS;
    const int m = m0 + idx / BK;
    a_ok[i] = m < M;
    const int mm = a_ok[i] ? m : 0;
    const int bi = mm / P, pi = mm % P;
    const int pr = pi / npw, pcol = pi % npw;
    a_base[i] = (((size_t)bi * H + (size_t)pr * p) * W + (size_t)pcol * p) * C;
  }

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * THREADS;
      const int kk = idx % BK, r = idx / BK;
      const int k = k0 + kk;
      float v = 0.f;
      if (a_ok[i] && k < K) {
        const int ph = k / pc;
        v = tstar::to_float(px[a_base[i] + (size_t)ph * row_elems + (k - ph * pc)]);
      }
      as[kk][r] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * THREADS;
      const int kk = idx / BN, n = idx % BN;
      const int k = k0 + kk;
      float v = 0.f;
      if (k < K && n0 + n < D) v = tstar::to_float(w[(size_t)k * D + n0 + n]);
      bs[kk][n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + ty * 4 + r;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx * 4 + c;
      if (n < D) out[(size_t)m * D + n] = tstar::from_float<T>(acc[r][c]);
    }
  }
}

// bf16 on the tensor cores (WMMA 16x16x16, f32 accumulators): 128x128
// outputs per 256-thread block, each warp 32x64; K in steps of 32 through
// shared memory.  Tiles move as 16-byte vectors of 8 elements, so the
// launcher takes this path only when every 8-run of k is contiguous and
// aligned in the pixels (p*C % 8 == 0, W*C % 8 == 0) and D % 8 == 0.
constexpr int TM = 128, TN = 128, TK = 32;
constexpr int LDA = TK + 8, LDB = TN + 8;  // padded rows (elements), 16-byte multiples

__global__ void __launch_bounds__(THREADS)
patch_embed_wmma_kernel(const __nv_bfloat16* __restrict__ px, const __nv_bfloat16* __restrict__ w,
                        __nv_bfloat16* __restrict__ out, int H, int W, int C, int p, int D,
                        int M, int K, int npw, int P) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 as[TM * LDA];
  __shared__ __align__(128) __nv_bfloat16 bs[TK * LDB];
  __shared__ __align__(128) float stage[THREADS / 32][16 * 16];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int pc = p * C;
  const size_t row_elems = (size_t)W * C;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  // A vectors: q = tid + i*THREADS -> row q / 4, k offset (q % 4) * 8.
  size_t a_base[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + (tid + i * THREADS) / 4;
    a_ok[i] = m < M;
    const int mm = a_ok[i] ? m : 0;
    const int bi = mm / P, pi = mm % P;
    a_base[i] = (((size_t)bi * H + (size_t)(pi / npw) * p) * W + (size_t)(pi % npw) * p) * C;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 64;

  for (int k0 = 0; k0 < K; k0 += TK) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + i * THREADS;
      const int r = q / 4, kc = (q % 4) * 8, k = k0 + kc;
      uint4 v = zero;
      if (a_ok[i] && k < K) {
        const int ph = k / pc;
        v = *reinterpret_cast<const uint4*>(px + a_base[i] + (size_t)ph * row_elems + (k - ph * pc));
      }
      *reinterpret_cast<uint4*>(as + r * LDA + kc) = v;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + i * THREADS;
      const int kk = q / (TN / 8), nc = (q % (TN / 8)) * 8;
      const int k = k0 + kk, n = n0 + nc;
      uint4 v = zero;
      if (k < K && n < D) v = *reinterpret_cast<const uint4*>(w + (size_t)k * D + n);
      *reinterpret_cast<uint4*>(bs + kk * LDB + nc) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], as + (wm + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::load_matrix_sync(fb, bs + kk * LDB + wn + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
    __syncthreads();
  }

  // Epilogue: each 16x16 f32 fragment goes through this warp's stage tile,
  // is rounded to bf16 and written 8 columns per lane.
  float* st = stage[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r = lane / 2, c0 = (lane % 2) * 8;
      const int m = m0 + wm + i * 16 + r, n = n0 + wn + j * 16 + c0;
      if (m < M && n < D) {
        __align__(16) __nv_bfloat16 o[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) o[c] = __float2bfloat16(st[r * 16 + c0 + c]);
        *reinterpret_cast<uint4*>(out + (size_t)m * D + n) = *reinterpret_cast<const uint4*>(o);
      }
      __syncwarp();
    }
}

template <typename T>
int launch_patch_embed(const void* px, const void* w, void* out, int B, int H, int W,
                       int C, int p, int D, void* stream) {
  if (B < 1 || p < 1 || H % p || W % p || C < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const int npw = W / p, P = (H / p) * npw;
  const long long M = (long long)B * P;
  const int K = p * p * C;
  if (M > (long long)65535 * BM) return (int)cudaErrorInvalidValue;
  const bool vec16 = ((p * C) % 8 == 0) && (((long long)W * C) % 8 == 0) && (D % 8 == 0) &&
                     (reinterpret_cast<uintptr_t>(px) % 16 == 0) &&
                     (reinterpret_cast<uintptr_t>(w) % 16 == 0) &&
                     (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (std::is_same<T, __nv_bfloat16>::value && vec16) {
    const dim3 grid((D + TN - 1) / TN, (unsigned)((M + TM - 1) / TM));
    patch_embed_wmma_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        static_cast<const __nv_bfloat16*>(px), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), H, W, C, p, D, (int)M, K, npw, P);
    return (int)cudaGetLastError();
  }
  const dim3 grid((D + BN - 1) / BN, (unsigned)((M + BM - 1) / BM));
  patch_embed_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(px), static_cast<const T*>(w), static_cast<T*>(out),
      H, W, C, p, D, (int)M, K, npw, P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tstar_patch_embed_bf16(const void* px, const void* w, void* out, int B, int H,
                                      int W, int C, int p, int D, void* stream) {
  return launch_patch_embed<__nv_bfloat16>(px, w, out, B, H, W, C, p, D, stream);
}

extern "C" int tstar_patch_embed_f32(const void* px, const void* w, void* out, int B, int H,
                                     int W, int C, int p, int D, void* stream) {
  return launch_patch_embed<float>(px, w, out, B, H, W, C, p, D, stream);
}
