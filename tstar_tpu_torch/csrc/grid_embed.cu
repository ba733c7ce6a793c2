// K6: uint8 frame cache -> detector patch embeddings in one pass.
//
// Replaces tstar_tpu/kernels/grid_embed.py:_embed_kernel (via
// _grid_embed_pallas, the pallas_call at :181, and grid_cell_embed).  For
// video b with sampled seconds secs[b, :] (row-major cells of a rows x cols
// grid; clamped into the cache) it computes the bf16 patch embeddings of the
// grid canvas, (B, rows*nph*cols*npw, D), in canvas patch order: cell (r, c),
// in-cell patch (i, j) -> patch (r*nph + i)*(cols*npw) + c*npw + j.  The
// canvas never reaches device memory.
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
// the main geometry, 2.7 GFLOP per image (2.7 us at 989 TFLOP/s) against
// 3.5 MB of frames, 4.7 MB of W and 0.9 MB out per image: compute-bound on
// paper.  In practice two streams a CTA feeds itself set the pace: W through
// TMA (~40 GB/s an SM measured for K2, patch_embed.cu) and the A tile, which
// the CTA builds from the frames in shared memory.
//
// Design (grid_embed_sm90_kernel; p*3 a multiple of 16).  K2's operand
// layouts and wgmma, with the canvas tile built in shared memory in place of
// K2's TMA box of pixels.  A CTA owns 128 patches (M rows, in canvas patch
// order over the batch) x 256 output columns.  A K chunk is PK values of one
// patch row's (pw, c) run (PK = 32 where the run is a multiple of 32, as the
// main path's 96; else 16, e.g. patch 16's 48): 128 lines of 2 PK bytes in
// wgmma's K-major layout, swizzled as wide as the line (64 / 32 bytes: K2's
// descriptors), and the matching PK rows of W (K, D), read as stored by TMA
// in 64-column boxes with the 128-byte swizzle (wgmma's MN-major B, as K2);
// a stage holds 64 K values.  Both warpgroups build and multiply: each
// issues its wgmma.m64n256k16 for stage u (64 rows, f32 accumulators)
// asynchronously, builds stage u + 1's A tile while they run, waits for
// them, and a CTA barrier then frees stage u's buffers; one thread keeps a
// ring of up to 4 W stages in flight (its mbarriers count TMA's bytes).
// The build: a warp owns 16 A rows.  Two lanes a row copy each chunk's
// source window (the bytes the row's PK values read, from a 16-byte aligned
// start: <= 112 bytes at the main geometry) into shared memory by cp.async,
// two chunks ahead of its use.  Then a lane computes one value of the chunk
// for the warp's rows, 4 rows at a time with every load before any
// arithmetic: the row's column-table entry (the value's two source offsets
// in the window, bf16 tap weights and bias, made once per CTA, with the
// windows and the height taps, from wtap / htap / awk / ah), two (four with
// the height taps) staged bytes, exact products and one rounding of each sum
// (bytes to floats and f32 to bf16 by full-rate integer ops), one 2-byte
// store at its swizzled place.  These are generic-proxy stores and wgmma
// reads through the async proxy: each thread fences
// (fence.proxy.async.shared::cta) before the barrier that precedes the
// products.  The height taps are a template parameter, so each instance
// runs straight-line code.
//
// Building A once per N tile resizes each pixel 3 times over D = 768, and at
// one image the 5 M x 3 N tiles would fill 15 of 132 SMs.  So at small batch
// K is split across a thread-block cluster along ph: CTA k of a cluster of
// S (8, 4 or 2; the largest whose CTAs fit one wave) owns ph in
// [k p/S, (k+1) p/S), so no value is built twice along K.  The cluster's
// partial sums meet in distributed shared memory: each CTA stores its f32
// accumulators (128 x 256, over its drained buffers), and after a cluster
// barrier CTA k sums rows [k 128/S, (k+1) 128/S) of all S partials in rank
// order (ld.shared::cluster; a fixed order, so the result does not depend on
// timing), rounds once to bf16 and stores them.  Without a split (B >= 8)
// the bf16 tile is staged in shared memory and stored in whole rows.
//
// Reckoning and measurement (H100 80GB HBM3, 700 W; tools/kernel_bench.py):
// at B=1 from the 192x384 cache, 5 M x 3 N tiles x S = 8 = 120 CTAs, each
// building 49,152 A values (128 patches x 4 ph x 96) and streaming 196 KB of
// W; predicted 10-20 us, measured ~32 us: per CTA ~2.5 us of tables, ~7 us
// to the first products (the first windows' latency and stage 0's build),
// the loop, ~7 us for the cluster's sum.  At B=16 (72 x 3 = 216 CTAs, no
// split, two waves) ~314 us, predicted 80-100: the W stream alone is ~55 us
// a wave (as K2), and the build adds ~100 us a CTA.  The build's cost is
// latency and shared-memory instruction issue, not bytes: with one producer
// warpgroup and the products on the other two (K2's warp specialization) it
// ran at ~0.1-0.2 instructions a cycle whatever its instruction mix, and
// took 584 us at B=16; both warpgroups building in straight-line batches
// halved that.
//
// Shapes outside that (p*3 not a multiple of 16, e.g. patch 8; source rows
// not whole 16-byte units; tables and windows that leave no room for two W
// stages) take PR 3's WMMA kernel (grid_embed_kernel: 128x128 outputs per
// 256-thread block, each thread building whole pixels of a 48-value k-chunk),
// chosen by shape in the C entry point, as is a cache not 16-byte aligned.
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TM = 128, TN = 128, TK = 48;  // TK: 16 pixels x 3 channels
constexpr int PX = TK / 3;                   // pixels per k-chunk
constexpr int TASKS = TM * PX / THREADS;     // pixels one thread builds per chunk
constexpr int LDA = TK + 8, LDB = TN + 8;    // padded rows (elements), 16-byte multiples

struct Geometry {
  int B, N, ch, cw, rows, cols, cell_h, cell_w, p, D;
  int nph, npw, P, M, K;
  int secs64;  // seconds are int64 (else int32)
};

__device__ __forceinline__ float bf(const __nv_bfloat16 x) { return __bfloat162float(x); }

// Second k of the int32 or int64 seconds, clamped into the cache's N frames.
__device__ __forceinline__ int clamp_sec(const void* secs, int secs64, int k, int N) {
  const long long s = secs64 ? static_cast<const long long*>(secs)[k]
                             : (long long)static_cast<const int*>(secs)[k];
  return (int)(s < 0 ? 0 : (s >= N ? N - 1 : s));
}

// One value of the height pass: taps (a0, u0) and, when `two`, (a1, u1);
// exact products, one f32 rounding of the sum, then bf16.
__device__ __forceinline__ float height_tap(float a0, float u0, float a1, float u1, bool two) {
  float acc = __fmul_rn(a0, u0);
  if (two) acc = __fadd_rn(acc, __fmul_rn(a1, u1));
  return bf(__float2bfloat16(acc));
}

__global__ void __launch_bounds__(THREADS)
grid_embed_kernel(const uint8_t* __restrict__ cache, const void* __restrict__ secs,
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
    const int sec = clamp_sec(secs, g.secs64, b * g.rows * g.cols + cell, g.N);
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

// ---------------------------------------------------------------------------
// The wgmma kernel.
// ---------------------------------------------------------------------------

constexpr int BM = 128, NB = 256;       // patches x output columns a CTA
constexpr int SM90_THREADS = 256;       // two warpgroups, each building and multiplying
constexpr int MAX_WSTAGES = 4, MAX_SPLIT = 8;
constexpr int NBUF = 3;                 // staged chunks: copies run 2 chunks ahead
constexpr int PART_LD = NB + 8;         // f32 row pitch of the partial sums
constexpr int PART_BYTES = BM * PART_LD * 4;
constexpr int A_STAGE = 64 * BM * 2;              // A tile of a stage: 64 K values
constexpr int W_STAGE = (NB / 64) * 64 * 128;     // W of a stage: 64 K rows x NB columns
constexpr int BARRIER_BYTES = 64;                 // the W ring's mbarriers, 16-byte aligned
constexpr int OUT_LD = NB * 2 + 16;               // byte pitch of the staged bf16 output tile

template <int PK>
struct Tile {
  static constexpr int KC = 64 / PK;           // chunks a stage
  static constexpr int A_BYTES = BM * PK * 2;  // one A chunk
  static constexpr int ATOM = KC * PK * 128;   // one 64-column W box of a stage
};

struct __align__(16) ColTap {  // value u = 3 x + c of a cell row, in segment s of patch column k
  uint32_t off;                // 3 lo + c | (3 hi + c) << 16, from the start of (k, s)'s window
  float w0, w1, bias;          // bf16 tap weights (w1 = 0 for one tap), f32 bias
};
struct __align__(16) RowTap {  // row y of a cell, when the height is resized
  int off0, off1;              // source byte offsets of rows r0, r1 in a frame
  float a0, a1;                // bf16 weights (a1 = 0 for one tap)
};

struct Sm90Params {
  int N, M, P, cols, npw, nph, rows_cols, p, D, ch, cw, cell_w, cell_h;
  int segs;         // PK-value segments of a (pw, c) run
  int part_chunks;  // K chunks a CTA of the cluster owns
  int nk;           // stages a CTA runs
  int wstages;      // W ring depth
  int split;        // CTAs of a cluster, splitting K along ph
  int secs64;
  int wpitch;       // bytes of a staged source window, a multiple of 16
};

// The source bytes a PK-value segment of a patch row reads, in 16-byte
// units from a 16-byte aligned start: at most PK/3 + 2 output pixels, whose
// bilinear taps span <= (pixels - 1) * cw / cell_w + 3 source pixels, plus
// the alignment and a unit of margin.
int window_pitch(int pk, int cw, int cell_w) {
  const double px = pk / 3 + 2;
  const int bytes = (int)ceil(3.0 * ((px - 1.0) * cw / cell_w + 3.0)) + 15;
  return (bytes + 15) / 16 * 16 + 16;
}

// Shared memory besides the A and W buffers: the staged windows and the
// tables.
int staging_bytes(int taps, int wpitch) { return NBUF * BM * taps * wpitch; }
int table_bytes(int pk, int p, int cell_w, int cell_h, bool height) {
  return cell_w * 3 * 16 + ((cell_w / p) * (p * 3 / pk) + 1) / 2 * 16 + (height ? cell_h * 16 : 0);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}

// A store to shared memory that the compiler does not order against other
// shared-memory accesses (no memory clobber): the A chunks it writes are read
// by nothing in this thread, and the stage's fence and barrier order them.
__device__ __forceinline__ void st_shared_u16(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b16 [%0], %1;" ::"r"(addr), "h"((unsigned short)v));
}

// The bf16 bits of a finite f32, rounded to nearest even, by integer ops
// (full rate, as __float2bfloat16 on finite values).
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  const uint32_t b = __float_as_uint(x);
  return (b + 0x7fffu + ((b >> 16) & 1u)) >> 16;
}

// A byte as an exact float: its bits under 2^23's exponent, less 2^23 (two
// full-rate instructions in place of a conversion).
__device__ __forceinline__ float u8f(uint32_t b) {
  return __uint_as_float(0x4b000000u | b) - 8388608.f;
}

// f32 -> bf16 (round to nearest even) -> f32, for finite values.
__device__ __forceinline__ float bfr(float x) { return __uint_as_float(bf16_bits(x) << 16); }

template <int PK, bool HEIGHT>
__global__ void __launch_bounds__(SM90_THREADS, 1)
grid_embed_sm90_kernel(const __grid_constant__ CUtensorMap wmap,
                       const uint8_t* __restrict__ cache, const void* __restrict__ secs,
                       const __nv_bfloat16* __restrict__ awk, const float* __restrict__ bias,
                       const __nv_bfloat16* __restrict__ ah, const int* __restrict__ wtap,
                       const int* __restrict__ htap, __nv_bfloat16* __restrict__ out,
                       const Sm90Params p) {
  using namespace tstar::sm90;
  using T = Tile<PK>;
  constexpr int KC = T::KC, A_BYTES = T::A_BYTES, ATOM = T::ATOM;
  constexpr int STEPS = PK / 16;                   // wgmma k-steps a chunk
  constexpr Swizzle ASW = PK == 32 ? SW64 : SW32;  // an A line is PK values
  constexpr uint32_t SWZ = PK == 32 ? 3 : 1;       // its 16-byte units XORed by address bits 7..
  constexpr int RPI = 32 / PK;                     // A rows a warp builds at once
  constexpr int BATCH = 4;                         // A rows a lane builds at once
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023u) & ~1023u) - raw;
  uint8_t* const base_ptr = smem_raw + pad;
  const uint32_t abuf = raw + pad;                            // [2] A stages
  const uint32_t wbuf = abuf + 2 * A_STAGE;                   // [wstages] W stages
  const int taps = HEIGHT ? 2 : 1, row_bytes = taps * p.wpitch;
  uint8_t* const staging = base_ptr + 2 * A_STAGE + p.wstages * W_STAGE;  // [NBUF][BM][taps][wpitch]
  const int sbytes = NBUF * BM * row_bytes;
  const uint32_t wfull = smem_u32(staging) + sbytes;          // [wstages] mbarriers
  ColTap* const coltab = reinterpret_cast<ColTap*>(staging + sbytes + BARRIER_BYTES);
  int2* const wintab = reinterpret_cast<int2*>(coltab + p.cell_w * 3);  // [npw][segs]
  RowTap* const rowtab = reinterpret_cast<RowTap*>(wintab + (p.npw * p.segs + 1) / 2 * 2);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int part = blockIdx.x, n0 = blockIdx.y * NB, m0 = blockIdx.z * BM;
  const int row3 = p.cw * 3;

  if (tid == 0) {
    for (int st = 0; st < p.wstages; ++st) mbar_init(wfull + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    prefetch_map(&wmap);
  }
  // Segment s of patch column k: output pixels x_f .. x_l of the cell row
  // read source bytes from 3 lo(x_f) to 3 hi(x_l) + 2 (the taps do not
  // decrease along x): the window staged for it, from a 16-byte aligned start.
  for (int i = tid; i < p.npw * p.segs; i += SM90_THREADS) {
    const int k = i / p.segs, s = i - k * p.segs;
    const int xf = k * p.p + (s * PK) / 3, xl = k * p.p + (s * PK + PK - 1) / 3;
    const int start = (3 * wtap[2 * xf]) & ~15, end = 3 * wtap[2 * xl + 1] + 2;
    const int units = (end - start) / 16 + 1;
    if (16 * units > p.wpitch) __trap();  // the host's bound (window_pitch) failed
    wintab[i] = make_int2(start, units);
  }
  const int awk_cols = p.cell_w * 3;
  for (int u = tid; u < awk_cols; u += SM90_THREADS) {
    const int x = u / 3, c = u - 3 * x;
    const int k = x / p.p, s = (u - k * p.p * 3) / PK;
    const int start = (3 * wtap[2 * (k * p.p + (s * PK) / 3)]) & ~15;
    const int lo = wtap[2 * x], hi = wtap[2 * x + 1];
    ColTap t;
    t.off = (uint32_t)(3 * lo + c - start) | ((uint32_t)(3 * (hi != lo ? hi : lo) + c - start) << 16);
    t.w0 = bf(awk[(size_t)(3 * lo + c) * awk_cols + u]);
    t.w1 = hi != lo ? bf(awk[(size_t)(3 * hi + c) * awk_cols + u]) : 0.f;
    t.bias = bias[u];
    coltab[u] = t;
  }
  if (HEIGHT)
    for (int y = tid; y < p.cell_h; y += SM90_THREADS) {
      const int r0 = htap[2 * y], r1 = htap[2 * y + 1];
      RowTap t;
      t.off0 = r0 * row3;
      t.off1 = (r1 != r0 ? r1 : r0) * row3;
      t.a0 = bf(ah[(size_t)y * p.ch + r0]);
      t.a1 = r1 != r0 ? bf(ah[(size_t)y * p.ch + r1]) : 0.f;
      rowtab[y] = t;
    }
  __syncthreads();

  // Warp w builds A rows 16 w .. 16 w + 15 and stages their windows.  For the
  // copies, lanes 2 i and 2 i + 1 own row 16 w + i: they hold its patch's
  // frame, first cell row y0 and patch column k (k = m mod npw, as P and
  // cols * npw are multiples of npw).  Rows past the batch read frame 0 and
  // build values that only reach output rows that are never stored.
  const int q0 = part * p.part_chunks;  // this CTA's first K chunk
  const int crow = 16 * warp + lane / 2, half = lane % 2;
  const uint8_t* frame = cache;
  int y0 = 0, k = (m0 + crow) % p.npw;
  if (m0 + crow < p.M) {
    const int m = m0 + crow, b = m / p.P, pi = m - b * p.P;
    const int pr = pi / (p.cols * p.npw), pc = pi - pr * (p.cols * p.npw);
    const int cell = (pr / p.nph) * p.cols + pc / p.npw;
    const int sec = clamp_sec(secs, p.secs64, b * p.rows_cols + cell, p.N);
    frame = cache + ((size_t)b * p.N + sec) * ((size_t)p.ch * row3);
    y0 = (pr % p.nph) * p.p;
  }
  const uint32_t stage_smem = smem_u32(staging);
  // Chunk ql (q = q0 + ql = ph * segs + s: values s PK .. s PK + PK - 1 of
  // the (pw, c) run at patch row ph) of this lane's row: its window into
  // buffer ql % NBUF by cp.async (two lanes a row), one commit group a chunk
  // (empty past the part).
  auto copy = [&](int ql) {
    if (ql < p.part_chunks) {
      const int q = q0 + ql, ph = q / p.segs, s = q - ph * p.segs;
      const int2 win = wintab[k * p.segs + s];
      const int y = y0 + ph;
      const uint32_t dst = stage_smem + ((ql % NBUF) * BM + crow) * row_bytes;
      for (int t = 0; t < taps; ++t) {
        const int roff = HEIGHT ? (t ? rowtab[y].off1 : rowtab[y].off0) : y * row3;
        const uint8_t* src = frame + roff + win.x;
        for (int j = half; j < win.y; j += 2) cp_async16(dst + t * p.wpitch + 16 * j, src + 16 * j);
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  // Stage v's A tile into A buffer v % 2, chunk by chunk: lane value `val`
  // of the chunk in rows `sub` mod RPI; chunks past the part are zeros (the
  // W rows beside them, the next part's or TMA's zero fill, add nothing).
  const int val_i = lane % PK, sub = lane / PK;
  const int kc0 = (m0 + 16 * warp + sub) % p.npw;  // the first built row's patch column
  auto build = [&](int v) {
    for (int c = 0; c < KC; ++c) {
      const int ql = v * KC + c, q = q0 + ql;
      const int ph = q / p.segs, s = q - ph * p.segs;
      const uint32_t a = abuf + (v % 2) * A_STAGE + c * A_BYTES;
      copy(ql + NBUF - 1);
      asm volatile("cp.async.wait_group %0;" ::"n"(NBUF - 1) : "memory");  // chunk ql landed
      __syncwarp();
      const bool live = ql < p.part_chunks;
      const uint8_t* const buf = staging + (ql % NBUF) * BM * row_bytes;
      const ColTap* const cs = coltab + s * PK + val_i;
      // Rows 16 warp + i + sub in batches of BATCH, every load of a batch
      // issued before its arithmetic; a row's patch column kc counts along
      // (m0 + row) mod npw.
      int kc = kc0;
#pragma unroll
      for (int i0 = 0; i0 < 16; i0 += BATCH * RPI) {
        ColTap tp[BATCH];
        float b0[BATCH], b1[BATCH], c0[BATCH], c1[BATCH];
        RowTap ht[BATCH];
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          tp[j] = cs[kc * p.p * 3];
          kc += RPI;
          if (kc >= p.npw) kc -= p.npw;
          if (RPI > 1 && kc >= p.npw) kc -= p.npw;
        }
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          const uint8_t* src = buf + (16 * warp + i0 + j * RPI + sub) * row_bytes;
          const int lo = tp[j].off & 0xffff, hi = tp[j].off >> 16;
          b0[j] = u8f(src[lo]);
          b1[j] = u8f(src[hi]);
          if (HEIGHT) {
            const int ry = __shfl_sync(0xffffffffu, y0, 2 * (i0 + j * RPI + sub));
            ht[j] = rowtab[live ? ry + ph : 0];
            c0[j] = u8f(src[p.wpitch + lo]);
            c1[j] = u8f(src[p.wpitch + hi]);
          }
        }
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
          float s0 = b0[j], s1 = b1[j];
          if (HEIGHT) {
            // exact products (bf16 x uint8), one rounding of the sum, bf16
            s0 = bfr(fmaf(ht[j].a0, s0, __fmul_rn(ht[j].a1, c0[j])));
            s1 = bfr(fmaf(ht[j].a0, s1, __fmul_rn(ht[j].a1, c1[j])));
          }
          // exact products (bf16 x bf16), one rounding of their sum, + bias
          const float value = __fadd_rn(fmaf(s0, tp[j].w0, __fmul_rn(s1, tp[j].w1)), tp[j].bias);
          const uint32_t off = (16 * warp + i0 + j * RPI + sub) * (2 * PK) + 2 * val_i;
          st_shared_u16(a + (off ^ (((off >> 7) & SWZ) << 4)), live ? bf16_bits(value) : 0u);
        }
      }
      __syncwarp();  // every lane is done with the buffer before it is refilled
    }
    // written through the generic proxy; wgmma reads through the async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  };
  auto load_w = [&](int v) {  // stage v's W boxes into its ring slot
    const uint32_t bar = wfull + 8 * (v % p.wstages), dst = wbuf + (v % p.wstages) * W_STAGE;
    mbar_expect_tx(bar, W_STAGE);
#pragma unroll
    for (int h = 0; h < NB / 64; ++h)
      tma_load_2d(dst + h * ATOM, &wmap, bar, n0 + 64 * h, (q0 + v * KC) * PK);
  };

  if (tid == 0)
    for (int v = 0; v < p.wstages && v < p.nk; ++v) load_w(v);
  for (int ql = 0; ql < NBUF - 1; ++ql) copy(ql);
  build(0);
  __syncthreads();

  // Each stage: warpgroup wg's products on A rows 64 wg .. 64 wg + 63 (k-step
  // kk reads the 32-byte part kk % STEPS of chunk kk / STEPS), issued
  // asynchronously; the next stage's A tile built meanwhile; then the
  // products awaited, and the W slot refilled once both warpgroups are past.
  const int wg = warp / 4, t = tid % 128;
  float acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
  for (int u = 0; u < p.nk; ++u) {
    mbar_wait(wfull + 8 * (u % p.wstages), (u / p.wstages) & 1);
    fence_regs(acc);
    wg_fence();
    const uint32_t a = abuf + (u % 2) * A_STAGE + wg * (A_BYTES / 2);
    const uint32_t bw = wbuf + (u % p.wstages) * W_STAGE;
#pragma unroll
    for (int kk = 0; kk < KC * STEPS; ++kk)
      wgmma_bf16(acc, desc(a + (kk / STEPS) * A_BYTES + 32 * (kk % STEPS), 16, 16 * PK, ASW),
                 desc(bw + 2048 * kk, ATOM, 1024, SW128), u | kk);
    wg_commit();
    if (u + 1 < p.nk) build(u + 1);
    wg_wait<0>();
    fence_regs(acc);
    __syncthreads();
    if (tid == 0 && u + p.wstages < p.nk) load_w(u + p.wstages);
  }

  // Register 4k + 2i + e holds row 16(t/32) + (t%32)/4 + 8i of the
  // warpgroup, column 8k + 2(t%4) + e of the tile.
  const int rr = 64 * wg + 16 * (t / 32) + (t % 32) / 4;
  const int cc = 2 * (t % 4);
  if (p.split == 1) {  // the whole K: round, stage the tile, store whole rows
    uint8_t* const tile = base_ptr;  // [BM][OUT_LD] bytes, over the drained buffers
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int kc = 0; kc < NB / 8; ++kc)
        *reinterpret_cast<uint32_t*>(tile + (rr + 8 * i) * OUT_LD + 2 * (8 * kc + cc)) =
            pack_bf16(acc[4 * kc + 2 * i], acc[4 * kc + 2 * i + 1]);
    __syncthreads();
    for (int i = tid; i < BM * (NB / 8); i += SM90_THREADS) {
      const int r = i / (NB / 8), n = n0 + 8 * (i % (NB / 8));
      if (m0 + r < p.M && n < p.D)
        *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * p.D + n) =
            *reinterpret_cast<const uint4*>(tile + r * OUT_LD + 2 * (n - n0));
    }
    return;
  }
  // This CTA's part of K: its partial sums over the drained buffers (every
  // product and copy is done: the loop ended on a barrier).
  float* part_sums = reinterpret_cast<float*>(base_ptr);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int kc = 0; kc < NB / 8; ++kc)
      *reinterpret_cast<float2*>(part_sums + (rr + 8 * i) * PART_LD + 8 * kc + cc) =
          make_float2(acc[4 * kc + 2 * i], acc[4 * kc + 2 * i + 1]);

  // The cluster's sum: CTA `rank` adds rows rank * rows_each .. of every
  // CTA's partial sums in rank order, rounds once and stores them.
  cluster_arrive();
  cluster_wait();
  const int rank = (int)cluster_rank(), rows_each = BM / p.split;
  for (int i = tid; i < rows_each * (NB / 4); i += SM90_THREADS) {
    const int r = rank * rows_each + i / (NB / 4), c4 = 4 * (i % (NB / 4));
    const uint32_t addr = abuf + (uint32_t)(r * PART_LD + c4) * 4;
    float4 v[MAX_SPLIT];
#pragma unroll
    for (int kc = 0; kc < MAX_SPLIT; ++kc)
      if (kc < p.split) v[kc] = ld_cluster_f4(map_rank(addr, kc));
    float4 s = v[0];
#pragma unroll
    for (int kc = 1; kc < MAX_SPLIT; ++kc)
      if (kc < p.split) {
        s.x += v[kc].x;
        s.y += v[kc].y;
        s.z += v[kc].z;
        s.w += v[kc].w;
      }
    const int m = m0 + r, n = n0 + c4;
    if (m < p.M && n < p.D)
      *reinterpret_cast<uint2*>(out + (size_t)m * p.D + n) =
          make_uint2(pack_bf16(s.x, s.y), pack_bf16(s.z, s.w));
  }
  // no CTA leaves while another may still read its partial sums
  cluster_arrive();
  cluster_wait();
}

struct Sm90Config {
  int pk, split, wstages, smem, wpitch;
  dim3 grid;
};

// The wgmma kernel takes a (pw, c) run of whole 16-value segments, D in whole
// 16-byte W rows, source rows of whole 16-byte units (cp.async), addressable
// by 16-bit offsets, and tables and staged windows that leave room for two W
// stages; every other shape takes the WMMA kernel.
int sm90_configure(const Geometry& g, bool height, Sm90Config* c) {
  using namespace tstar::sm90;
  DeviceInfo d;
  int dev = 0;
  const int e = device_info(&d, &dev);
  if (e) return e;
  c->smem = 0;
  if ((g.p * 3) % 16 || g.D % 8 || (g.cw * 3) % 16 || g.cw * 3 > 0xffff) return 0;
  const long long mt = ((long long)g.M + BM - 1) / BM, nt = (g.D + NB - 1) / NB;
  if (mt > 65535) return 0;
  const int pk = (g.p * 3) % 32 == 0 ? 32 : 16, taps = height ? 2 : 1;
  const int wpitch = window_pitch(pk, g.cw, g.cell_w);
  const int staging = staging_bytes(taps, wpitch);
  const int fixed = 1024 + 2 * A_STAGE + staging + BARRIER_BYTES +
                    table_bytes(pk, g.p, g.cell_w, g.cell_h, height);
  int wst = 0;
  while (wst < MAX_WSTAGES && fixed + (wst + 1) * W_STAGE <= d.optin) ++wst;
  if (wst < 2) return 0;
  c->pk = pk;
  c->wpitch = wpitch;
  c->wstages = wst;
  c->smem = fixed + wst * W_STAGE;
  // K split along ph: the largest S dividing p whose CTAs fit one wave (and
  // whose partial sums fit the buffers they overwrite).
  c->split = 1;
  for (int s = MAX_SPLIT; s > 1; s /= 2)
    if (g.p % s == 0 && mt * nt * s <= d.sms &&
        2 * A_STAGE + wst * W_STAGE + staging >= PART_BYTES) {
      c->split = s;
      break;
    }
  c->grid = dim3(c->split, (unsigned)nt, (unsigned)mt);
  return 0;
}

bool sm90_opted_in[2][2][tstar::sm90::MAX_DEVICES];

template <int PK>
int launch_sm90(const Sm90Config& c, const Geometry& g, const void* cache, const void* secs,
                const void* awk, const void* bias, const void* ah, const void* wtap,
                const void* htap, const void* w, void* out, void* stream) {
  using namespace tstar::sm90;
  static_assert(Tile<PK>::KC * Tile<PK>::A_BYTES == A_STAGE, "one A stage size");
  static_assert((NB / 64) * Tile<PK>::ATOM == W_STAGE, "one W stage size");
  DeviceInfo d;
  int dev = 0;
  int e = device_info(&d, &dev);
  if (e) return e;
  const bool height = ah != nullptr;
  const auto kernel = height ? grid_embed_sm90_kernel<PK, true> : grid_embed_sm90_kernel<PK, false>;
  e = opt_in(reinterpret_cast<const void*>(kernel), dev, d.optin, sm90_opted_in[PK / 32][height]);
  if (e) return e;
  CUtensorMap wmap;  // W (K, D): boxes of one stage's 64 K rows x 64 columns
  e = map_bf16_2d(&wmap, w, g.K, g.D, 64);
  if (e) return e;
  const int segs = g.p * 3 / PK, part = g.p / c.split * segs;
  const Sm90Params prm{g.N, g.M, g.P, g.cols, g.npw, g.nph, g.rows * g.cols, g.p, g.D, g.ch,
                       g.cw, g.cell_w, g.cell_h, segs, part,
                       (part + Tile<PK>::KC - 1) / Tile<PK>::KC, c.wstages, c.split,
                       g.secs64, c.wpitch};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = c.grid;
  cfg.blockDim = dim3(SM90_THREADS);
  cfg.dynamicSmemBytes = c.smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = c.split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t ce = cudaLaunchKernelEx(
      &cfg, kernel, wmap, static_cast<const uint8_t*>(cache), secs,
      static_cast<const __nv_bfloat16*>(awk), static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(ah), static_cast<const int*>(wtap),
      static_cast<const int*>(htap), static_cast<__nv_bfloat16*>(out), prm);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}

// The geometry of a call, checked; 0 or a CUDA error code.
int make_geometry(int B, int N, int ch, int cw, int rows, int cols, int cell_h, int cell_w, int p,
                  int D, bool height, int secs64, Geometry* g) {
  if (B < 1 || N < 1 || p < 1 || rows < 1 || cols < 1 || cell_h % p || cell_w % p ||
      (p * p) % PX || D < 8 || D % 8 || (!height && ch != cell_h))
    return (int)cudaErrorInvalidValue;
  *g = Geometry{B, N, ch, cw, rows, cols, cell_h, cell_w, p, D, 0, 0, 0, 0, 0, secs64 != 0};
  g->nph = cell_h / p;
  g->npw = cell_w / p;
  g->P = rows * g->nph * cols * g->npw;
  const long long M = (long long)B * g->P;
  if (M > (long long)65535 * TM) return (int)cudaErrorInvalidValue;
  g->M = (int)M;
  g->K = p * p * 3;
  return 0;
}

}  // namespace

// cache (B, N, ch, cw, 3) uint8; secs (B, rows*cols) int32, or int64 when
// secs64; awk (cw*3, cell_w*3) bf16; bias (cell_w*3,) f32; ah (cell_h, ch)
// bf16 or null (identity height: ch == cell_h); wtap (cell_w, 2) / htap
// (cell_h, 2) int32 tap columns / rows; w (p*p*3, D) bf16; out (B,
// rows*nph*cols*npw, D) bf16.
extern "C" int tstar_grid_embed(const void* cache, const void* secs, int secs64, const void* awk,
                                const void* bias, const void* ah, const void* wtap,
                                const void* htap, const void* w, void* out, int B, int N,
                                int ch, int cw, int rows, int cols, int cell_h, int cell_w,
                                int p, int D, void* stream) {
  if ((ah != nullptr && htap == nullptr) || reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  Geometry g;
  int e = make_geometry(B, N, ch, cw, rows, cols, cell_h, cell_w, p, D, ah != nullptr, secs64, &g);
  if (e) return e;
  Sm90Config c;
  e = sm90_configure(g, ah != nullptr, &c);
  if (e) return e;
  if (c.smem && reinterpret_cast<uintptr_t>(cache) % 16 == 0)  // cp.async reads 16-byte units
    return c.pk == 32 ? launch_sm90<32>(c, g, cache, secs, awk, bias, ah, wtap, htap, w, out, stream)
                      : launch_sm90<16>(c, g, cache, secs, awk, bias, ah, wtap, htap, w, out, stream);
  const dim3 grid((D + TN - 1) / TN, (unsigned)((g.M + TM - 1) / TM));
  grid_embed_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(cache), secs, static_cast<const __nv_bfloat16*>(awk),
      static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(ah),
      static_cast<const int*>(wtap), static_cast<const int*>(htap),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out), g);
  return (int)cudaGetLastError();
}

// The launch configuration of a call's shape (height: the height taps apply):
// cfg = {CTAs, output columns per CTA, CTAs per cluster splitting K, stages,
// dynamic shared memory bytes, values per K chunk}; all 0 when the shape
// takes the WMMA kernel.
extern "C" int tstar_grid_embed_config(int B, int N, int ch, int cw, int rows, int cols,
                                       int cell_h, int cell_w, int p, int D, int height,
                                       int* cfg) {
  for (int i = 0; i < 6; ++i) cfg[i] = 0;
  Geometry g;
  int e = make_geometry(B, N, ch, cw, rows, cols, cell_h, cell_w, p, D, height != 0, 0, &g);
  if (e) return e;
  Sm90Config c;
  e = sm90_configure(g, height != 0, &c);
  if (e || !c.smem) return e;
  cfg[0] = (int)(c.grid.x * c.grid.y * c.grid.z);
  cfg[1] = NB;
  cfg[2] = c.split;
  cfg[3] = c.wstages;
  cfg[4] = c.smem;
  cfg[5] = c.pk;
  return 0;
}
