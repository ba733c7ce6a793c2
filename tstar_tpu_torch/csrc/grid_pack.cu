// K7: frame gather -> bilinear resize -> CLIP normalize -> grid pack.
//
// Replaces tstar_tpu/kernels/pallas_grid.py:build_detector_grid_pallas (the
// pallas_call at :141, kernel body _make_grid_kernel :62).  Canvas row Y of
// the (rows*cell_h, cols*cell_w, 3) detector canvas holds row y = Y % cell_h
// of the cells (Y / cell_h, C), C < cols, each resized from its frame
// cache[secs[(Y / cell_h) * cols + C]] (seconds clamped into the cache).
// For output column x of a cell and channel c, with the nonzero entries of
// _interp_matrix as taps (r0, r1; a0, a1) along the height and (lo, hi; w0,
// w1) along the width (host tables, f32 weights):
//   h(col) = a0 u[r0][col] + a1 u[r1][col]   (f32; u[y][col] when the height
//                                             resize is the identity)
//   v      = w0 h(3 lo + c) + w1 h(3 hi + c) (f32)
//   out    = v * scale[c] + bias[c]          (two roundings: __fmul_rn, then
//                                             __fadd_rn, as the plain
//                                             version's two ops), then bf16
//                                             (RNE) or f32.
// Up to the order of the two-term sums this is the plain version's
// arithmetic (build_detector_grid_pallas_plain: two f32 matmuls, then
// `* scale + bias`).
//
// What bounds it on the H100: bytes.  At the main geometry it reads 16
// gathered 192x384x3 frames (3.54 MB of uint8) and writes the 768^2x3
// canvas (3.54 MB bf16, 7.08 MB f32): 2.1 / 3.2 us at 3.35 TB/s; 2-6
// multiply-adds a value are nothing beside that.  The Triton kernel it
// replaces spent 12 us of device time in 1024-value programs (a div/mod
// chain, two byte loads a tap and a 2-byte store per value) and ~0.14 ms of
// host time a call in Triton's launch path, on the critical path of a search
// whose card is mostly idle.  So this kernel is one C call in the ctypes
// library.
//
// Design.  One CTA per two canvas rows (384 CTAs at 768^2: one wave).  In one
// load phase it copies the width tap table and the source rows its canvas
// rows need (one per cell, two where the height is resized: <= 4 x cols rows
// of cw*3 bytes) into shared memory, with 16-byte loads where a row's bytes
// allow it; no load waits on another but for the frames on their seconds.
// Then each thread computes 8 consecutive values of a canvas row from
// shared memory alone (one division for the first value, then counters) and
// writes them as one 16-byte vector (two in f32) where the row's start is
// 16-byte aligned, else value by value (e.g. a 772-pixel canvas: 2316
// values a row).
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int VALUES = 8;  // canvas values a thread computes at a time
constexpr int ROWS = 2;    // canvas rows a CTA

struct PackGeometry {
  int N, ch, cw, rows, cols, cell_h, cell_w;
  int identity;  // the height resize is the identity: one source row a cell
  int secs64;    // seconds are int64 (else int32)
  int vec_in;    // source rows load as 16-byte vectors
  int vec_out;   // every canvas row starts 16-byte aligned
};

template <typename T>
__device__ __forceinline__ void store_values(T* dst, const float* v, int n, bool vec);

template <>
__device__ __forceinline__ void store_values<__nv_bfloat16>(__nv_bfloat16* dst, const float* v,
                                                            int n, bool vec) {
  if (vec && n == VALUES) {
    const uint4 o = make_uint4(tstar::sm90::pack_bf16(v[0], v[1]), tstar::sm90::pack_bf16(v[2], v[3]),
                               tstar::sm90::pack_bf16(v[4], v[5]), tstar::sm90::pack_bf16(v[6], v[7]));
    *reinterpret_cast<uint4*>(dst) = o;
    return;
  }
  for (int i = 0; i < n; ++i) dst[i] = __float2bfloat16(v[i]);
}

template <>
__device__ __forceinline__ void store_values<float>(float* dst, const float* v, int n, bool vec) {
  if (vec && n == VALUES) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
    return;
  }
  for (int i = 0; i < n; ++i) dst[i] = v[i];
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
grid_pack_kernel(const uint8_t* __restrict__ cache, const void* __restrict__ secs,
                 const int* __restrict__ htap, const float* __restrict__ hwt,
                 const int* __restrict__ wtap, const float* __restrict__ wwt,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 T* __restrict__ out, const PackGeometry g) {
  // [cell_w] width taps (lo, hi, w0, w1), then [ROWS][cols][taps][pitch]
  // source bytes: slot (j, C, t) holds source row r_t of canvas row Y0 + j's
  // cell C.
  extern __shared__ __align__(16) uint8_t smem[];
  int4* const wtab = reinterpret_cast<int4*>(smem);
  uint8_t* const src_rows = smem + 16 * g.cell_w;
  const int tid = threadIdx.x, Y0 = blockIdx.x * ROWS;
  const int taps = g.identity ? 1 : 2;
  const int row_bytes = g.cw * 3, pitch = (row_bytes + 15) & ~15;
  const int nrows = min(ROWS, g.rows * g.cell_h - Y0);

  // One load phase: the width taps and every source row the CTA's canvas
  // rows read (each row's seconds and height taps read on the way).
  for (int x = tid; x < g.cell_w; x += blockDim.x)
    wtab[x] = make_int4(wtap[2 * x], wtap[2 * x + 1], __float_as_int(wwt[2 * x]),
                        __float_as_int(wwt[2 * x + 1]));
  const size_t frame_bytes = (size_t)g.ch * row_bytes;
  const int unit = g.vec_in ? 16 : 1, per_row = row_bytes / unit;
  for (int i = tid; i < nrows * g.cols * taps * per_row; i += blockDim.x) {
    const int slot = i / per_row, j = i - slot * per_row;
    const int t = slot % taps, C = (slot / taps) % g.cols, Y = Y0 + slot / (taps * g.cols);
    const int R = Y / g.cell_h, y = Y - R * g.cell_h, k = R * g.cols + C;
    long long sec = g.secs64 ? static_cast<const long long*>(secs)[k]
                             : (long long)static_cast<const int*>(secs)[k];
    sec = sec < 0 ? 0 : (sec >= g.N ? g.N - 1 : sec);
    const int r = g.identity ? y : htap[2 * y + t];
    const uint8_t* src = cache + (size_t)sec * frame_bytes + (size_t)r * row_bytes;
    uint8_t* dst = src_rows + slot * pitch;
    if (g.vec_in)
      reinterpret_cast<uint4*>(dst)[j] = __ldg(reinterpret_cast<const uint4*>(src) + j);
    else
      dst[j] = __ldg(src + j);
  }
  __syncthreads();

  const float sc0 = scale[0], sc1 = scale[1], sc2 = scale[2];
  const float bi0 = bias[0], bi1 = bias[1], bi2 = bias[2];
  const int L = g.cols * g.cell_w * 3;  // values in a canvas row
  for (int jr = 0; jr < nrows; ++jr) {
    const int Y = Y0 + jr, y = Y % g.cell_h;
    float a0 = 1.f, a1 = 0.f;
    if (!g.identity) {
      a0 = hwt[2 * y];
      a1 = hwt[2 * y + 1];
    }
    const uint8_t* const rows_j = src_rows + jr * g.cols * taps * pitch;
    T* const orow = out + (size_t)Y * L;
    for (int e0 = tid * VALUES; e0 < L; e0 += blockDim.x * VALUES) {
      int px = e0 / 3, c = e0 - 3 * px;
      int C = px / g.cell_w, x = px - C * g.cell_w;
      const int n = L - e0 < VALUES ? L - e0 : VALUES;
      float v[VALUES];
      int4 tap = wtab[x];
#pragma unroll
      for (int i = 0; i < VALUES; ++i) {
        v[i] = 0.f;
        if (i < n) {
          const uint8_t* s0 = rows_j + (C * taps) * pitch;
          const int lo = 3 * tap.x + c, hi = 3 * tap.y + c;
          float h0, h1;
          if (g.identity) {
            h0 = (float)s0[lo];
            h1 = (float)s0[hi];
          } else {
            const uint8_t* s1 = s0 + pitch;
            h0 = a0 * (float)s0[lo] + a1 * (float)s1[lo];
            h1 = a0 * (float)s0[hi] + a1 * (float)s1[hi];
          }
          const float val = __int_as_float(tap.z) * h0 + __int_as_float(tap.w) * h1;
          const float sc = c == 0 ? sc0 : (c == 1 ? sc1 : sc2);
          const float bi = c == 0 ? bi0 : (c == 1 ? bi1 : bi2);
          v[i] = __fadd_rn(__fmul_rn(val, sc), bi);
          if (++c == 3 && i + 1 < n) {  // the next pixel: its taps, maybe its cell
            c = 0;
            if (++x == g.cell_w) {
              x = 0;
              ++C;
            }
            tap = wtab[x];
          }
        }
      }
      store_values<T>(orow + e0, v, n, g.vec_out);
    }
  }
}

}  // namespace

// cache (N, ch, cw, 3) uint8; secs (rows*cols,) int32 or int64 (secs64);
// htap / wtap (cell_h, 2) / (cell_w, 2) int32 tap rows / columns and hwt / wwt
// their f32 weights; scale / bias (3,) f32; out (rows*cell_h, cols*cell_w, 3)
// f32 (dtype 0) or bf16 (dtype 1).  identity: the height resize is the
// identity (ch == cell_h; htap / hwt unread).
extern "C" int tstar_grid_pack(const void* cache, const void* secs, int secs64, const void* htap,
                               const void* hwt, const void* wtap, const void* wwt,
                               const void* scale, const void* bias, void* out, int N, int ch,
                               int cw, int rows, int cols, int cell_h, int cell_w, int identity,
                               int dtype, void* stream) {
  if (N < 1 || ch < 1 || cw < 1 || rows < 1 || cols < 1 || cell_h < 1 || cell_w < 1 ||
      (identity && ch != cell_h) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long L = (long long)cols * cell_w * 3;
  const long long Y = (long long)rows * cell_h;
  if (Y > 0x7fffffff || L > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int taps = identity ? 1 : 2;
  const int pitch = (cw * 3 + 15) & ~15;
  const size_t smem = 16 * (size_t)cell_w + (size_t)ROWS * cols * taps * pitch;
  const int es = dtype == 0 ? 4 : 2;
  PackGeometry g{N, ch, cw, rows, cols, cell_h, cell_w, identity, secs64 != 0,
                 (cw * 3) % 16 == 0 && reinterpret_cast<uintptr_t>(cache) % 16 == 0,
                 (L * es) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0};
  const long long vectors = (L + VALUES - 1) / VALUES;
  const int threads = (int)(vectors >= MAX_THREADS ? MAX_THREADS : (vectors + 31) / 32 * 32);
  using namespace tstar::sm90;
  DeviceInfo d;
  int dev = 0;
  int e = device_info(&d, &dev);
  if (e) return e;
  if (smem > (size_t)d.optin) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* c8 = static_cast<const uint8_t*>(cache);
  const auto* ht = static_cast<const int*>(htap);
  const auto* wt = static_cast<const int*>(wtap);
  const auto* hw = static_cast<const float*>(hwt);
  const auto* ww = static_cast<const float*>(wwt);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  static bool opted[2][MAX_DEVICES];
  if (dtype == 1) {
    if (smem > 48 * 1024 &&
        (e = opt_in(reinterpret_cast<const void*>(grid_pack_kernel<__nv_bfloat16>), dev, d.optin,
                    opted[1])))
      return e;
    grid_pack_kernel<__nv_bfloat16><<<(unsigned)((Y + ROWS - 1) / ROWS), threads, smem, s>>>(
        c8, secs, ht, hw, wt, ww, sc, bi, static_cast<__nv_bfloat16*>(out), g);
  } else {
    if (smem > 48 * 1024 &&
        (e = opt_in(reinterpret_cast<const void*>(grid_pack_kernel<float>), dev, d.optin,
                    opted[0])))
      return e;
    grid_pack_kernel<float><<<(unsigned)((Y + ROWS - 1) / ROWS), threads, smem, s>>>(
        c8, secs, ht, hw, wt, ww, sc, bi, static_cast<float*>(out), g);
  }
  return (int)cudaGetLastError();
}
