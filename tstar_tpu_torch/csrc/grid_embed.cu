// K6: uint8 frame cache -> detector patch embeddings in one pass.
//
// Replaces tstar_tpu/kernels/grid_embed.py:_embed_kernel (via
// _grid_embed_pallas and grid_cell_embed).  For video b with sampled seconds
// secs[b, :] (row-major cells of a rows x cols grid) it computes the bf16
// patch embeddings of the grid canvas, (B, rows*nph*cols*npw, D), in canvas
// patch order: cell (r, c), in-cell patch (i, j) -> patch
// (r*nph + i)*(cols*npw) + c*npw + j.  The canvas never reaches device memory.
//
// Rounding points, as the reference's (each bilinear column has at most two
// nonzero taps, and a uint8 or bf16 value times a bf16 weight is exact in
// f32, so reading the two taps gives the dense matmul's f32 sum):
//   uint8 -> bf16 (exact);
//   when the height resize is not the identity: ah(bf16) taps, f32 sum,
//     rounded to bf16;
//   awk(bf16: interpolation weight x 1/(255 std)) taps, f32 sum, + bias (f32),
//     rounded to bf16: the canvas value;
//   canvas(bf16) x W(bf16) with an f32 sum, rounded to bf16 (the output is
//     bf16 whatever the model dtype, as the reference's).
// The tap positions come from the host (the nonzero entries of
// _interp_matrix, `wtap`/`htap`), the tap weights are read from the bf16
// matrices themselves.  The TPU kernel's 4-lane channel pad existed only for
// its 128-lane layout and is dropped: W is the (p*p*3, D) HWIO kernel.
//
// What bounds it on the H100: the patch GEMM, (B*576, 3072) x (3072, 768) at
// the main geometry, 2.7 GFLOP per image: compute-bound, so it runs on the
// tensor cores, through the WMMA loop of patch_embed.cu (K2): 128x128
// outputs per 256-thread block, f32 accumulators.  Its A operand is built on
// the fly into shared memory from the uint8 frame rows: each k-chunk is 16
// pixels x 3 channels of one patch row, and each thread builds whole pixels
// (the tap lookups are shared by the 3 channels).  The resize work (<= 4
// byte loads and 2-4 products per value) is recomputed by each of the 6
// column blocks; cp.async/TMA staging and wgmma are later work.
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TM = 128, TN = 128, TK = 48;  // TK: 16 pixels x 3 channels
constexpr int PX = TK / 3;                   // pixels per k-chunk
constexpr int TASKS = TM * PX / THREADS;     // pixels one thread builds per chunk
constexpr int LDA = TK + 8, LDB = TN + 8;    // padded rows (elements), 16-byte multiples

struct Geometry {
  int B, N, ch, cw, rows, cols, cell_h, cell_w, p, D;
  int nph, npw, P, M, K;
};

__device__ __forceinline__ float bf(const __nv_bfloat16 x) { return __bfloat162float(x); }

// One value of the height pass: taps (a0, u0) and, when `two`, (a1, u1);
// exact products, one f32 rounding of the sum, then bf16.
__device__ __forceinline__ float height_tap(float a0, float u0, float a1, float u1, bool two) {
  float acc = __fmul_rn(a0, u0);
  if (two) acc = __fadd_rn(acc, __fmul_rn(a1, u1));
  return bf(__float2bfloat16(acc));
}

__global__ void __launch_bounds__(THREADS)
grid_embed_kernel(const uint8_t* __restrict__ cache, const int* __restrict__ secs,
                  const __nv_bfloat16* __restrict__ awk, const float* __restrict__ bias,
                  const __nv_bfloat16* __restrict__ ah, const int* __restrict__ wtap,
                  const int* __restrict__ htap, const __nv_bfloat16* __restrict__ w,
                  __nv_bfloat16* __restrict__ out, const Geometry g) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 as[TM * LDA];
  __shared__ __align__(128) __nv_bfloat16 bs[TK * LDB];
  __shared__ __align__(128) float stage[THREADS / 32][16 * 16];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int row3 = g.cw * 3, awk_cols = g.cell_w * 3;
  const size_t frame_elems = (size_t)g.ch * row3;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  // Task t = tid + i*THREADS builds pixel t % PX of tile row t / PX.  The row
  // fixes the frame and the patch's top-left corner inside its cell.
  const uint8_t* frame[TASKS];
  int y0[TASKS], x0[TASKS];
  bool ok[TASKS];
#pragma unroll
  for (int i = 0; i < TASKS; ++i) {
    const int m = m0 + (tid + i * THREADS) / PX;
    ok[i] = m < g.M;
    const int mm = ok[i] ? m : 0;
    const int b = mm / g.P, pi = mm % g.P;
    const int pr = pi / (g.cols * g.npw), pc = pi % (g.cols * g.npw);
    const int cell = (pr / g.nph) * g.cols + pc / g.npw;
    const int sec = min(max(secs[b * g.rows * g.cols + cell], 0), g.N - 1);
    frame[i] = cache + ((size_t)b * g.N + sec) * frame_elems;
    y0[i] = (pr % g.nph) * g.p;
    x0[i] = (pc % g.npw) * g.p;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 64;

  for (int k0 = 0; k0 < g.K; k0 += TK) {
    // A: the canvas values of 16 pixels (in HWIO order ph*p + pw) per row.
    const int kp0 = k0 / 3;
#pragma unroll
    for (int i = 0; i < TASKS; ++i) {
      const int t = tid + i * THREADS;
      const int r = t / PX, px = t % PX;
      __nv_bfloat16 v[3] = {__float2bfloat16(0.f), __float2bfloat16(0.f), __float2bfloat16(0.f)};
      if (ok[i]) {
        const int kp = kp0 + px;
        const int y = y0[i] + kp / g.p, x = x0[i] + kp % g.p;
        const int lo = wtap[2 * x], hi = wtap[2 * x + 1];
        float s0[3], s1[3];  // the source row's values at columns lo and hi
        if (ah == nullptr) {
          const uint8_t* src = frame[i] + (size_t)y * row3;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            s0[c] = (float)src[lo * 3 + c];
            s1[c] = (float)src[hi * 3 + c];
          }
        } else {
          const int r0 = htap[2 * y], r1 = htap[2 * y + 1];
          const bool two = r1 != r0;
          const float a0 = bf(ah[(size_t)y * g.ch + r0]);
          const float a1 = two ? bf(ah[(size_t)y * g.ch + r1]) : 0.f;
          const uint8_t* f0 = frame[i] + (size_t)r0 * row3;
          const uint8_t* f1 = frame[i] + (size_t)r1 * row3;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            s0[c] = height_tap(a0, (float)f0[lo * 3 + c], a1, (float)f1[lo * 3 + c], two);
            s1[c] = height_tap(a0, (float)f0[hi * 3 + c], a1, (float)f1[hi * 3 + c], two);
          }
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int col = x * 3 + c;
          float sum = __fmul_rn(s0[c], bf(awk[(size_t)(lo * 3 + c) * awk_cols + col]));
          if (hi != lo) sum = __fadd_rn(sum, __fmul_rn(s1[c], bf(awk[(size_t)(hi * 3 + c) * awk_cols + col])));
          v[c] = __float2bfloat16(__fadd_rn(sum, bias[col]));
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) as[r * LDA + px * 3 + c] = v[c];
    }
    // B: rows k0 .. k0+TK of W, 16-byte vectors.
#pragma unroll
    for (int i = 0; i < TK * TN / 8 / THREADS; ++i) {
      const int q = tid + i * THREADS;
      const int kk = q / (TN / 8), nc = (q % (TN / 8)) * 8;
      const int n = n0 + nc;
      uint4 val = zero;
      if (n < g.D) val = *reinterpret_cast<const uint4*>(w + (size_t)(k0 + kk) * g.D + n);
      *reinterpret_cast<uint4*>(bs + kk * LDB + nc) = val;
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

  // Epilogue (as K2's): each 16x16 f32 fragment goes through this warp's
  // stage tile, is rounded to bf16 and written 8 columns per lane.
  float* st = stage[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r = lane / 2, c0 = (lane % 2) * 8;
      const int m = m0 + wm + i * 16 + r, n = n0 + wn + j * 16 + c0;
      if (m < g.M && n < g.D) {
        __align__(16) __nv_bfloat16 o[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) o[c] = __float2bfloat16(st[r * 16 + c0 + c]);
        *reinterpret_cast<uint4*>(out + (size_t)m * g.D + n) = *reinterpret_cast<const uint4*>(o);
      }
      __syncwarp();
    }
}

}  // namespace

// cache (B, N, ch, cw, 3) uint8; secs (B, rows*cols) int32; awk (cw*3,
// cell_w*3) bf16; bias (cell_w*3,) f32; ah (cell_h, ch) bf16 or null (identity
// height); wtap (cell_w, 2) / htap (cell_h, 2) int32 tap columns; w (p*p*3, D)
// bf16; out (B, rows*nph*cols*npw, D) bf16.
extern "C" int tstar_grid_embed(const void* cache, const void* secs, const void* awk,
                                const void* bias, const void* ah, const void* wtap,
                                const void* htap, const void* w, void* out, int B, int N,
                                int ch, int cw, int rows, int cols, int cell_h, int cell_w,
                                int p, int D, void* stream) {
  if (B < 1 || N < 1 || p < 1 || rows < 1 || cols < 1 || cell_h % p || cell_w % p ||
      (p * p) % PX || D < 8 || D % 8 || (ah != nullptr && htap == nullptr) ||
      reinterpret_cast<uintptr_t>(w) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  Geometry g{B, N, ch, cw, rows, cols, cell_h, cell_w, p, D, 0, 0, 0, 0, 0};
  g.nph = cell_h / p;
  g.npw = cell_w / p;
  g.P = rows * g.nph * cols * g.npw;
  const long long M = (long long)B * g.P;
  if (M > (long long)65535 * TM) return (int)cudaErrorInvalidValue;
  g.M = (int)M;
  g.K = p * p * 3;
  const dim3 grid((D + TN - 1) / TN, (unsigned)((M + TM - 1) / TM));
  grid_embed_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(cache), static_cast<const int*>(secs),
      static_cast<const __nv_bfloat16*>(awk), static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(ah), static_cast<const int*>(wtap),
      static_cast<const int*>(htap), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), g);
  return (int)cudaGetLastError();
}
