// K4: per-row dynamic int8 quantization fused into an int8 GEMM (W8A8), on
// Hopper's integer warpgroup MMA fed by TMA.
//
// Replaces tstar_tpu/kernels/quant_matmul.py:_w8a8_kernel (via _w8a8_pallas,
// the pallas_call at :64, and w8a8_matmul), i.e. ops/quant.py dense_w8a8.
// For x (R, K) in f32 or bf16, W^T (N, K) int8 (the (K, N) kernel transposed
// once per scorer), ws and b (N,) f32:
//   xs[r] = max(max_k |x[r,k]|, 1e-12) / 127
//   q     = clip(rint(x / xs), -127, 127)                 (int8)
//   acc   = sum_k q[r,k] * W[k,n]                         (int32)
//   out   = ((float)acc * xs[r]) * ws[n] + b[n]           (f32, then out type)
// bit for bit as the plain version: IEEE division for xs, q as the IEEE
// quotient rounded half to even (a multiply by 1 / xs wherever that provably
// rounds alike, quantize8_fast()), an exact integer product (any order),
// and an epilogue of separately rounded __fmul_rn / __fadd_rn that nvcc
// cannot contract into an FMA.  The library is built without --use_fast_math.
//
// What bounds it on the H100: at the main path's shapes (R = 577 .. 9232
// rows, K x N = 768 x 2304 / 768 x 768 / 768 x 3072 / 3072 x 768) the int8
// product is 0.7-44 GOP, 0.4-22 us at 1,979 TOP/s, and the bytes (x in f32
// or bf16, W, the output) take 0.7-50 us at 3.35 TB/s: bound by bytes at one
// image and nearly balanced at 16.  Besides, every CTA quantizes its own row
// slab, which the bound does not count.
//
// Design.  A CTA owns a slab of x rows and a run of 128-column N tiles.  It
// has two consumer warpgroups and one producer warp (288 threads, which caps
// a thread at 168 registers):
//   1. The producer's lane 0 starts TMA loads of the first W^T tiles (128 N
//      rows x 128 K bytes, 16 KB, 128-byte swizzle) into a ring of stages,
//      each completing on a "full" mbarrier.  Meanwhile all nine warps
//      quantize the slab, a
//      half-warp a row (at K = 768 held in registers, so x is read once): the
//      row's absmax, then q as int8 in the layout the wgmma descriptor reads: K-major, one tile of rows x 128 bytes per K chunk, with the same
//      128-byte swizzle as the TMA tiles (16-byte group g of row r at
//      g ^ (r & 7)).  The CTAs that split one slab's N tiles form a
//      thread-block cluster (up to 8): each quantizes every n-th row and
//      stores it into every CTA's slab through distributed shared memory, so
//      a slab's x is read and quantized once, not once per CTA.  The slabs
//      are written through the generic proxy, so every thread fences
//      (fence.proxy.async) before the cluster barrier that precedes the
//      first wgmma.  Rows past R quantize to zero and are never stored.
//   2. At K <= 1536 the slab has 128 rows and warpgroup w takes rows 64w ..
//      64w + 63 and all 128 columns of each N tile: per K chunk four
//      wgmma.m64n128k32.s32.s8.s8, so each W^T tile feeds 128 rows (the
//      W^T stream from L2, re-read by every slab, bounds the product loop).
//      Deeper K (fc2's 3072) leaves room for a 64-row slab only (192 KB):
//      warpgroup w takes its columns 64w .. 64w + 63 (m64n64k32).  Both
//      operands are K-major in shared memory, 32 bytes a k-step; one commit
//      group per chunk; after the next chunk is issued, the previous one is
//      waited for and its stage released on an "empty" mbarrier (one
//      arrival per warpgroup).  The producer refills a stage once both have
//      released it (a consumer thread that refilled instead made fc2's
//      two-stage ring stall: 0.047 against 0.035 ms at R = 577).
//   3. The epilogue dequantizes straight from the accumulator registers
//      (thread t of a warpgroup holds rows 16(t/32) + (t%32)/4 (+8), column
//      pairs 8k + 2(t%4)) and stores pairs of outputs, with no shared stage.
// Integer wgmma reads A and B only K-major (the transpose flags exist for
// f16 / bf16 alone), hence W^T.  Shared memory: the slab (96 KB at K = 768,
// 192 KB at K = 3072) plus up to 8 stages (two at K = 3072); one CTA an SM.
// The grid splits each slab's N tiles into runs so that the clusters fill
// the card in few waves (choose(), with the device's count of clusters it
// holds at once).  Device attributes, that count and the shared-memory
// opt-in are read once per device.  Every mbarrier wait traps after ~2^26
// polls instead of hanging the card.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace tstar::sm90;

constexpr int BN = 128;                // columns per N tile: one W^T stage
constexpr int BK = 128;                // K bytes per chunk: one swizzled line
constexpr int CONSUMERS = 2;           // warpgroups
constexpr int THREADS = CONSUMERS * 128 + 32;  // + the producer warp
constexpr int WARPS = THREADS / 32;
constexpr int STAGE_B = BN * BK;       // 16 KB of W^T per stage
constexpr int MAX_STAGES = 8;
#ifndef TSTAR_W8A8_MAX_CLUSTER
#define TSTAR_W8A8_MAX_CLUSTER 8
#endif
// CTAs sharing a slab (8: the portable cluster size; a build may lower it,
// tools/kernel_bench.py compares)
constexpr int MAX_CLUSTER = TSTAR_W8A8_MAX_CLUSTER;

// MW, the consumer warpgroups stacked along M: 2 takes a 128-row slab, each
// warpgroup 64 rows x 128 columns (wgmma n = 128); 1 a 64-row slab, each
// warpgroup 64 rows x 64 columns (n = 64), for K too deep for two 64-row
// slabs in shared memory.
template <int MW>
struct Tile {
  static constexpr int BM = 64 * MW;             // rows of the slab
  static constexpr int WN = BN * MW / CONSUMERS; // columns per warpgroup
  static constexpr int ACC = WN / 2;             // s32 accumulators a thread
  static constexpr int CHUNK_A = BM * BK;        // bytes of the slab per K chunk
};

struct Params {
  int R, K, N, per, stages;            // per: N tiles of this CTA's run
};

// A build with -DTSTAR_W8A8_TRACE records, for each CTA of the last launch,
// thread 0's clock at the kernel's phase boundaries (tools/kernel_bench.py
// reads them through tstar_w8a8_trace): 0 entry, 1 cluster barrier passed,
// 2 own rows quantized, 3 every slab complete, 4 first W^T tile arrived,
// 5 last product done, 6 epilogue done; 7 and 8 the global timer (ns) at
// entry and at the end; 9 its first rows read, 10 its cluster wait passed,
// 11 its first rows stored.
#ifdef TSTAR_W8A8_TRACE
constexpr int TRACE_CTAS = 8192, TRACE_POINTS = 12;
__device__ long long g_trace[TRACE_CTAS][TRACE_POINTS];
#define TSTAR_TRACE(i)                                                                   \
  do {                                                                                   \
    const int cta = blockIdx.y * gridDim.x + blockIdx.x;                                 \
    if (threadIdx.x == 0 && cta < TRACE_CTAS) g_trace[cta][i] = clock64();               \
  } while (0)
#define TSTAR_TRACE_NS(i)                                                                \
  do {                                                                                   \
    const int cta = blockIdx.y * gridDim.x + blockIdx.x;                                 \
    long long ns;                                                                        \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));                               \
    if (threadIdx.x == 0 && cta < TRACE_CTAS) g_trace[cta][i] = ns;                      \
  } while (0)
#else
#define TSTAR_TRACE(i) do {} while (0)
#define TSTAR_TRACE_NS(i) do {} while (0)
#endif

__device__ __forceinline__ void st_cluster(uint32_t addr, uint2 v) {
  asm volatile("st.shared::cluster.v2.u32 [%0], {%1, %2};" ::"r"(addr), "r"(v.x), "r"(v.y)
               : "memory");
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}

// W^T rows n .. n + 127, K bytes k .. k + 127 into one stage.
__device__ __forceinline__ void tma_load_b(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                           int k, int n) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(STAGE_B)
               : "memory");
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k), "r"(n)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled K-major tile: start
// address, leading byte offset 1 (unused with this swizzle), stride byte
// offset 1024 B (8 rows of 128 B), in 16-byte units; layout type 1 (128B).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)64 << 32) |
         ((uint64_t)1 << 62);
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous instructions.
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 64 s32) (+)= A (64 x 32 s8, shared, K-major) B (32 x 64 s8, shared,
// K-major: B[k][n] at row n); d is overwritten when `acc` is 0.
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 128 s32) (+)= A (64 x 32 s8, shared, K-major) B (32 x 128 s8, shared,
// K-major: B[k][n] at row n); d is overwritten when `acc` is 0.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// Eight consecutive inputs, widened to float.
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// clip(rint(v / xs), -127, 127) with the IEEE quotient v / xs, computed as
// v times r = 1 / xs (rounded): |v r - v / xs| < 2^-16 at |v / xs| <= 127,
// so where v r lies further than 2^-15 from every half-integer, the rounded
// quotient rounds to the same integer.  The fast form flags a value closer
// than that (about one in 2^14), and its group is redone with the quotient;
// the fast path has no branch within a group of eight.
__device__ __forceinline__ uint32_t clip_byte(float n) {
  return (uint32_t)min(127, max(-127, (int)n)) & 0xffu;
}

__device__ __forceinline__ uint2 quantize8_fast(const float* v, float r, bool& near) {
  uint32_t b[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float y = __fmul_rn(v[j], r);
    const float n = rintf(y);
    near |= fabsf(fabsf(__fsub_rn(y, n)) - 0.5f) <= 0x1p-15f;
    b[j] = clip_byte(n);
  }
  return make_uint2(b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24,
                    b[4] | b[5] << 8 | b[6] << 16 | b[7] << 24);
}

__device__ __forceinline__ uint2 quantize8_exact(const float* v, float xs) {
  uint32_t b[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) b[j] = clip_byte(rintf(__fdiv_rn(v[j], xs)));
  return make_uint2(b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24,
                    b[4] | b[5] << 8 | b[6] << 16 | b[7] << 24);
}

// One group of 8 values by the fast form, redone (rarely) by the quotient.
__device__ __forceinline__ uint2 quantize8(const float* v, float xs, float r) {
  bool near = false;
  const uint2 q = quantize8_fast(v, r, near);
  return near ? quantize8_exact(v, xs) : q;
}

// Where 8-value group g of slab row r lies, from the slab's start: K chunk
// g / 16, the row's 128-byte line, 16-byte group (g % 16) / 2 swizzled by the
// row, half g % 2.
template <int MW>
__device__ __forceinline__ uint32_t slab_offset(int r, int g) {
  return (g / 16) * Tile<MW>::CHUNK_A + r * BK + ((((g % 16) / 2) ^ (r & 7)) * 16) + (g % 2) * 8;
}

// The slabs of the cluster's CTAs (the same rows, other N tiles): each CTA
// quantizes a share of the rows and writes them into every CTA's slab (the
// address in CTA t is mapped per store: an array of them would cost the
// registers the 168 cap leaves none of).
struct Slabs {
  uint32_t slab;    // this CTA's slab (shared::cta address)
  int n;            // CTAs in the cluster
  uint32_t xs_off;  // the row scales, from the slab's start

  template <typename T>
  __device__ __forceinline__ void put(uint32_t off, T v) const {
#pragma unroll
    for (int t = 0; t < MAX_CLUSTER; ++t)
      if (t < n) st_cluster(map_rank(slab + off, t), v);
  }
};

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Quantizes slab row r into every slab of the cluster, a half-warp a row
// (two rows a warp at once, to keep two rows' loads in flight): lane hl of
// the half takes 8-value groups hl, hl + 16, ...  With G > 0 the row has 16 G
// groups and stays in registers between its absmax and its quantization (x
// is read once); G = 0 (deep K) reads it twice, four groups a lane at a
// time.  `mine`: whether this half has a row at all; rows past R quantize to
// zero.  `waited`: whether this warp has passed the cluster barrier that
// lets it write to the other CTAs (it waits once its first rows are read).
template <int G, int MW, typename TI>
__device__ __forceinline__ void quantize_half(const TI* __restrict__ x, int R, int K, int m0,
                                              int r, bool mine, const Slabs& dst, int hl,
                                              bool& waited) {
  constexpr int V = G > 0 ? G : 4;  // groups a lane holds at once
  const int groups = K / 8;
  const bool real = mine && m0 + r < R;
  const TI* xr = x + (size_t)(real ? m0 + r : 0) * K;
  float v[V][8];
  float amax = 0.f;
  if (real)
    for (int g0 = hl; g0 < groups; g0 += 16 * V) {
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (G > 0 || g0 + 16 * i < groups) load8(xr + (g0 + 16 * i) * 8, v[i]);
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (G > 0 || g0 + 16 * i < groups)
#pragma unroll
          for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[i][j]));
    }
  amax = half_warp_max(amax);
  if (!waited) {
    TSTAR_TRACE(9);
    cluster_wait();
    TSTAR_TRACE(10);
    waited = true;
  }
  if (!mine) return;
  if (!real) {
    for (int g = hl; g < groups; g += 16) dst.put(slab_offset<MW>(r, g), make_uint2(0, 0));
    if (hl == 0) dst.put(dst.xs_off + 4 * r, 1.f);
    return;
  }
  const float xs = __fdiv_rn(fmaxf(amax, 1e-12f), 127.f);
  const float rcp = __frcp_rn(xs);
  if (hl == 0) dst.put(dst.xs_off + 4 * r, xs);
  if (G > 0) {
#pragma unroll
    for (int i = 0; i < V; ++i) dst.put(slab_offset<MW>(r, hl + 16 * i), quantize8(v[i], xs, rcp));
  } else {
    for (int g0 = hl; g0 < groups; g0 += 16 * V) {
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (g0 + 16 * i < groups) load8(xr + (g0 + 16 * i) * 8, v[i]);
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (g0 + 16 * i < groups)
          dst.put(slab_offset<MW>(r, g0 + 16 * i), quantize8(v[i], xs, rcp));
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename TI, typename TO, int MW>
__global__ void __launch_bounds__(THREADS, 1)
w8a8_kernel(const __grid_constant__ CUtensorMap wmap, const TI* __restrict__ x,
            const float* __restrict__ ws, const float* __restrict__ bias, TO* __restrict__ out,
            const Params p) {
  using T = Tile<MW>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the 128B swizzle wants 1024-byte tiles
  const uint8_t* base_ptr = smem_raw + (base - raw);
  const int nk = p.K / BK, stages = p.stages;
  const uint32_t slab = base;                               // [nk][BM rows][128 B]
  const uint32_t ring = slab + nk * T::CHUNK_A;             // [stages][128 rows][128 B]
  const uint32_t full = ring + stages * STAGE_B;            // [stages] mbarriers
  const uint32_t empty = full + 8 * stages;                 // [stages]
  const uint32_t xs_off = nk * T::CHUNK_A + stages * STAGE_B + 16 * stages;
  const float* xs_s = reinterpret_cast<const float*>(base_ptr + xs_off);

  TSTAR_TRACE_NS(7);
  TSTAR_TRACE(0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * T::BM;
  const int t0 = blockIdx.x * p.per;
  const int t1 = min(p.N / BN, t0 + p.per);
  const int loads = (t1 - t0) * nk;  // load u: N tile t0 + u / nk, K chunk u % nk
  const bool producer = warp == WARPS - 1;

  auto load = [&](int u) {
    const int st = u % stages;
    tma_load_b(ring + st * STAGE_B, &wmap, full + 8 * st, (u % nk) * BK, (t0 + u / nk) * BN);
  };
  if (producer && lane == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int u = 0; u < stages && u < loads; ++u) load(u);
  }
  // A CTA writes into the others' shared memory only once all have started:
  // each warp arrives now and waits before its first such write.
  cluster_arrive();
  TSTAR_TRACE(1);

  // 1. Quantize the slab: this CTA takes rows rank, rank + n, ... of the
  //    cluster's n CTAs, a warp a row, and writes each into every CTA's slab;
  //    rows past R quantize to zero.
  Slabs dst;
  dst.slab = slab;
  dst.n = (int)cluster_size();
  dst.xs_off = xs_off;
  bool waited = false;
  const int rank = (int)cluster_rank();
  const int share = (T::BM - rank + dst.n - 1) / dst.n;  // rows rank + n j, j < share
  for (int j0 = 2 * warp; j0 < share; j0 += 2 * WARPS) {
    const int j = j0 + lane / 16;
    const int r = rank + dst.n * j;
    if (p.K == 768)  // the towers' K = 768 stays in registers
      quantize_half<6, MW>(x, p.R, p.K, m0, r, j < share, dst, lane % 16, waited);
    else
      quantize_half<0, MW>(x, p.R, p.K, m0, r, j < share, dst, lane % 16, waited);
    if (j0 == 2 * warp) TSTAR_TRACE(11);
  }
  if (!waited) cluster_wait();
  // The slabs were written through the generic proxy, partly by other CTAs;
  // wgmma reads them through the async proxy.
  TSTAR_TRACE(2);
  asm volatile("fence.proxy.async.shared::cluster;" ::: "memory");
  cluster_arrive();
  cluster_wait();
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  TSTAR_TRACE(3);

  if (producer) {  // refill each stage once both warpgroups have released it
    if (lane == 0)
      for (int u = stages; u < loads; ++u) {
        mbar_wait(empty + 8 * (u % stages), ((u / stages) + 1) & 1);
        load(u);
      }
    return;
  }
  auto release = [&](int v) {
    if (tid % 128 == 0) mbar_arrive(empty + 8 * (v % stages));
  };

  // 2. The consumer warpgroups: warpgroup wg takes rows 64 wg (MW = 2) or
  //    columns 64 wg (MW = 1) of the CTA's 128-row or 64-row tile.
  const int wg = warp / 4, t = tid % 128;
  const uint32_t a_off = MW == 2 ? wg * 64 * BK : 0;  // its rows of a slab chunk
  const uint32_t b_off = MW == 1 ? wg * 64 * BK : 0;  // its rows of a stage
  const int row_a = (MW == 2 ? 64 * wg : 0) + 16 * (t / 32) + (t % 32) / 4;  // + 8i
  const int col_a = (MW == 1 ? 64 * wg : 0) + 2 * (t % 4);                   // + 8k + e
  int acc[T::ACC];
#pragma unroll
  for (int i = 0; i < T::ACC; ++i) acc[i] = 0;
  int u = 0;
  for (int tile = t0; tile < t1; ++tile) {
    for (int kc = 0; kc < nk; ++kc, ++u) {
      const int st = u % stages;
      mbar_wait(full + 8 * st, (u / stages) & 1);
      if (u == 0) TSTAR_TRACE(4);
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_s8(acc, desc_sw128(slab + kc * T::CHUNK_A + a_off + 32 * kk),
                 desc_sw128(ring + st * STAGE_B + b_off + 32 * kk), kc | kk);
      wg_commit();
      if (kc > 0) {
        wg_wait<1>();  // chunk kc - 1 done: release its stage
        release(u - 1);
      }
    }
    wg_wait<0>();
    fence_regs(acc);
    release(u - 1);
    if (tile == t1 - 1) TSTAR_TRACE(5);

    // 3. Epilogue from the accumulators: register 4k + 2i + e holds row
    //    row_a + 8i, column col_a + 8k + e.
    const int n0 = tile * BN;
    const float xs0 = xs_s[row_a], xs1 = xs_s[row_a + 8];
    TO* orow = out + (size_t)(m0 + row_a) * p.N + n0;
#pragma unroll
    for (int k = 0; k < T::WN / 8; ++k) {
      const int col = col_a + 8 * k;
      const float2 s = __ldg(reinterpret_cast<const float2*>(ws + n0 + col));
      const float2 b = __ldg(reinterpret_cast<const float2*>(bias + n0 + col));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (m0 + row_a + 8 * i >= p.R) continue;
        const float xs = i ? xs1 : xs0;
        const float lo = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[4 * k + 2 * i]), xs), s.x), b.x);
        const float hi = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc[4 * k + 2 * i + 1]), xs), s.y), b.y);
        store2(orow + (size_t)8 * i * p.N + col, lo, hi);
      }
      // one column pair's scale and bias live at a time (the 168-register cap)
      asm volatile("" ::: "memory");
    }
  }
  TSTAR_TRACE(6);
  TSTAR_TRACE_NS(8);
}

struct Config {
  int mw, groups, row_tiles, per, stages, smem, cluster;
};

// How many clusters of `cluster` CTAs of `kernel` with `smem` bytes the
// device holds at once (the GPCs' sizes leave some SMs out), once per
// (device, kernel, cluster size, shared memory); the kernel's shared-memory
// opt-in is set with the first query.
template <typename TI, typename TO, int MW>
int active_clusters(int dev, int cluster, int smem, int* out) {
  struct Entry {
    int dev, cluster, smem, clusters;
  };
  static Entry cache[64];
  static int used = 0;
  static bool opted_in[MAX_DEVICES];
  for (int i = 0; i < used; ++i)
    if (cache[i].dev == dev && cache[i].cluster == cluster && cache[i].smem == smem) {
      *out = cache[i].clusters;
      return 0;
    }
  auto kernel = w8a8_kernel<TI, TO, MW>;
  cudaError_t e = cudaSuccess;
  if (!opted_in[dev]) {
    int optin = 0;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (used < 64) cache[used++] = Entry{dev, cluster, smem, clusters};
  *out = clusters;
  return 0;
}

// The largest cluster size (CTAs sharing a slab's quantization) that
// divides a slab's `groups` CTAs.
int cluster_for(long long groups) {
  int c = MAX_CLUSTER;
  while (groups % c) --c;
  return c;
}

// A CTA's time, from the phases tools/kernel_bench.py traced on an H100
// (us): a fixed part (cluster start, first x reads, the barrier after the
// slabs, the epilogue), a round of quantization (each half-warp of the nine
// warps one row) per 768 of K, and a K chunk of products.
constexpr double CTA_FIXED_US = 6.0, QUANT_ROUND_US = 3.0, CHUNK_US = 0.7;

// The tile (two 64-row warpgroups on one 128-row slab where it and two
// stages fit in shared memory, else one 64-row slab), as many stages as fit
// (up to 8), then the run of N tiles per CTA: the one whose clusters finish
// first, in waves of as many clusters as the device holds at once; ties go
// to the shorter run.
template <typename TI, typename TO>
int choose(int R, int K, int N, int dev, const DeviceInfo& d, Config* c) {
  const int nk = K / BK;
  auto bytes = [&](int bm, int st) { return 1024 + nk * bm * BK + st * (STAGE_B + 16) + bm * 4; };
  c->mw = bytes(128, 2) <= d.optin ? 2 : 1;
  const int bm = 64 * c->mw;
  c->stages = 0;
  while (c->stages < MAX_STAGES && bytes(bm, c->stages + 1) <= d.optin) ++c->stages;
  if (c->stages < 2) return (int)cudaErrorInvalidValue;
  c->smem = bytes(bm, c->stages);
  const long long row_tiles = (R + bm - 1) / bm, n_tiles = N / BN;
  if (row_tiles > 65535) return (int)cudaErrorInvalidValue;
  c->row_tiles = (int)row_tiles;
  double best = -1;
  for (int per = 1; per <= n_tiles; ++per) {
    const long long groups = (n_tiles + per - 1) / per;
    const int cluster = cluster_for(groups);
    int held = 0;
    const int e = c->mw == 2 ? active_clusters<TI, TO, 2>(dev, cluster, c->smem, &held)
                             : active_clusters<TI, TO, 1>(dev, cluster, c->smem, &held);
    if (e) return e;
    if (held < 1) continue;
    const long long waves = (groups / cluster * row_tiles + held - 1) / held;
    const int rows = (bm + cluster - 1) / cluster;               // quantized by each CTA
    const int rounds = (rows + 2 * WARPS - 1) / (2 * WARPS);
    const double cta = CTA_FIXED_US + rounds * QUANT_ROUND_US * K / 768.0 + per * nk * CHUNK_US;
    const double cost = (double)waves * cta;
    if (best < 0 || cost < best) {
      best = cost;
      c->per = per;
      c->groups = (int)groups;
      c->cluster = cluster;
    }
  }
  return best < 0 ? (int)cudaErrorInvalidConfiguration : 0;
}

bool shape_ok(int R, int K, int N) {
  return R >= 1 && K >= 256 && N >= BN && K % 256 == 0 && N % BN == 0;
}

template <typename TI, typename TO, int MW>
int launch_mw(const CUtensorMap& map, const void* x, const void* ws, const void* b, void* out,
              const Config& c, const Params& p, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c.groups, c.row_tiles);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = c.smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = c.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, w8a8_kernel<TI, TO, MW>, map, static_cast<const TI*>(x),
      static_cast<const float*>(ws), static_cast<const float*>(b), static_cast<TO*>(out), p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename TI, typename TO>
int launch_w8a8(const void* x, const void* wt, const void* ws, const void* b, void* out, int R,
                int K, int N, void* stream) {
  if (!shape_ok(R, K, N)) return (int)cudaErrorInvalidValue;
  DeviceInfo d;
  int dev = 0;
  int e = device_info(&d, &dev);
  if (e) return e;
  Config c;
  e = choose<TI, TO>(R, K, N, dev, d, &c);
  if (e) return e;
  // W^T as a 2-D map: K bytes innermost, N rows; box 128 x 128, 128B swizzle.
  CUtensorMap map;
  cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  cuuint64_t strides[1] = {(cuuint64_t)K};
  cuuint32_t box[2] = {BK, BN};
  cuuint32_t elem[2] = {1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      &map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(wt), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  const Params p{R, K, N, c.per, c.stages};
  return c.mw == 2 ? launch_mw<TI, TO, 2>(map, x, ws, b, out, c, p, stream)
                   : launch_mw<TI, TO, 1>(map, x, ws, b, out, c, p, stream);
}

}  // namespace

// x (R, K), wt = W^T (N, K) int8, both 16-byte aligned and contiguous;
// x_dtype / out_dtype: 0 = f32, 1 = bf16.  K a multiple of 256 (a warp's
// 8-value groups cover a row), N of 128.
extern "C" int tstar_w8a8(const void* x, const void* wt, const void* ws, const void* b, void* out,
                          int R, int K, int N, int x_dtype, int out_dtype, void* stream) {
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wt)) % 16)
    return (int)cudaErrorInvalidValue;
  if (x_dtype == 0 && out_dtype == 0) return launch_w8a8<float, float>(x, wt, ws, b, out, R, K, N, stream);
  if (x_dtype == 0 && out_dtype == 1) return launch_w8a8<float, __nv_bfloat16>(x, wt, ws, b, out, R, K, N, stream);
  if (x_dtype == 1 && out_dtype == 0) return launch_w8a8<__nv_bfloat16, float>(x, wt, ws, b, out, R, K, N, stream);
  if (x_dtype == 1 && out_dtype == 1) return launch_w8a8<__nv_bfloat16, __nv_bfloat16>(x, wt, ws, b, out, R, K, N, stream);
  return (int)cudaErrorInvalidValue;
}

// The launch configuration the kernel takes for (R, K, N) on this device
// (that of an f32 -> bf16 launch): cfg = {CTAs, N tiles per CTA, W^T stages,
// rows per CTA, dynamic shared memory bytes, CTAs per cluster}.
extern "C" int tstar_w8a8_config(int R, int K, int N, int* cfg) {
  if (!shape_ok(R, K, N)) return (int)cudaErrorInvalidValue;
  DeviceInfo d;
  int dev = 0;
  int e = device_info(&d, &dev);
  if (e) return e;
  Config c;
  e = choose<float, __nv_bfloat16>(R, K, N, dev, d, &c);
  if (e) return e;
  cfg[0] = c.groups * c.row_tiles;
  cfg[1] = c.per;
  cfg[2] = c.stages;
  cfg[3] = 64 * c.mw;
  cfg[4] = c.smem;
  cfg[5] = c.cluster;
  return 0;
}

#ifdef TSTAR_W8A8_TRACE
// Copies the trace of the last launch's first `ctas` CTAs (TRACE_POINTS each).
extern "C" int tstar_w8a8_trace(long long* host, int ctas) {
  if (ctas < 0 || ctas > TRACE_CTAS) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(host, g_trace, sizeof(long long) * TRACE_POINTS * ctas);
}
#endif
