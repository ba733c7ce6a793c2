// Kimi-VL's latent attention (MLA) for one decode token, in its absorbed
// form, from the q|kv_a projection's output to the input of o_proj: three
// launches a layer.
//
// Replaces no Pallas kernel: the reference has no MLA model.  It was added
// for the decode step of Kimi-VL-A3B (models/kimi_vl.py, MLAttention), whose
// plain absorbed attention took ~20 launches a layer (rope, norm, cache
// write, two batched products, the scores, softmax, casts and copies): 44 us
// a layer at 3,500 slots on the H100, inside a CUDA graph.
//
// What bounds it on the H100: bytes.  A layer reads W_UK (16 x 128 x 512)
// and W_UV (16 x 512 x 128), 2.1 MB each, and the live latent slots, 1,152 B
// each (~4 MB at 3,500 slots), against ~0.1 GFLOP; ~8 MB is 2.5 us at
// 3.35 TB/s.  One SM, though, takes in only ~30-50 GB/s (measured alike with
// cp.async, bulk copies and 16-byte loads), so the bytes have to be spread
// over ~128 SMs, and the phases that need every head's q or every slot's
// probabilities meet at launch boundaries:
//
//  1. mla_q_kernel, a CTA a (head, 64 columns of q_lat): q_nope times its
//     W_UK columns (16 KB, f32 on CUDA cores, rounded to bf16) for every
//     batch row; the head's first CTA also turns its rope part of q; CTA
//     (8, b) norms row b's c_kv (kv_a_layernorm), turns its k_pe and writes
//     the new latent slot into the cache at the step's index.  Out: the
//     rows [q_lat | q_pe] (B, 16, 576) of the scores.
//  2. mla_attend_kernel, S CTAs a batch row (about one 64-slot tile each
//     when the cache is full; 128 CTAs at most over all rows), the live
//     slots 0 .. index split over them (flash-decoding).  A CTA's tiles land
//     by TMA (9 boxes of 64 slots x 64 values, 128-byte swizzle) in a ring
//     of 2; the 16 heads are one m16 tile of mma.sync, so the scores are a
//     (16 x 576) . (576 x 64) product whose q operand stays in registers (4
//     warps of 16 slots each times 2 halves of k, the halves then trading
//     sums so that each warp holds 8 heads' softmax rows), and P . c_kv a
//     (16 x 64) . (64 x 512) product over the same tile (a warp 64 columns
//     of c): each slot is read from memory once for both.  The softmax runs
//     online in f32.  Out: each CTA's max, sum and o_lat (relative to that
//     max) of every head.
//  3. mla_out_kernel, a cluster of 8 CTAs a head: CTA j combines the S
//     partials over o_lat's columns 64 j .. + 63, the cluster gathers the
//     head's whole o_lat into every CTA (distributed shared memory), and CTA
//     j multiplies it by 16 columns of the head's W_UV slice (f32 on CUDA
//     cores) into the output.
// Measured at B = 1, 3,500 live slots of 3,584 (phase 3 of chip_smoke.py,
// weights and cache cold in L2): one cluster of 16 CTAs a row doing every
// phase, 26-27 us (each CTA took in ~500 KB); two launches, q then 8
// clusters a row meeting at a ticket for W_UV, 32 us (the clusters of 16
// ran in two waves); these three, 15.4 us (q 2.3, attention 5.2, combine
// 5.5 us in a profile with the cache warm).
//
// Rounding (kernels/mla.py, mla_decode_plain, repeats it): the rope in f32
// (each product rounded, then their sum) rounded to bf16; the norm's sum of
// squares in a fixed order (a thread's 8 values in turn, then halving
// pairwise over the 64 threads' sums), rsqrt(sum / 512 + eps), (x * r) *
// scale rounded to bf16; so the cache slot is exact.  q_lat is rounded to
// bf16, the scores stay f32 (times qk_head_dim^-0.5, plus the f32 mask), and
// o_lat and the output's sums stay f32 until the output's rounding.  The one
// rounding the plain version places elsewhere: the unnormalised
// probabilities are rounded to bf16 as the tensor cores' operand, relative
// to the running max (the plain version rounds the normalised ones), and
// the sum divides by the sum of those rounded values.
//
// bf16 only, 16 heads, kv_lora_rank 512, rope 64, nope 128, v 128, 1 to 4
// batch rows, at most 16,384 cache slots.  Slots after the index are not
// read: the mask must hide them (the decode step's does).  The wrapper
// raises on anything else.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using tstar::sm90::cluster_arrive;
using tstar::sm90::cluster_rank;
using tstar::sm90::cluster_wait;
using tstar::sm90::map_rank;
using tstar::sm90::smem_u32;

constexpr int H = 16;                               // heads
constexpr int NOPE = 128;                           // q / k width without position
constexpr int ROPE = 64;                            // the roped width
constexpr int R = 512;                              // kv_lora_rank
constexpr int VD = 128;                             // v head width
constexpr int LAT = R + ROPE;                       // a latent slot: c_kv | k_pe
constexpr int QPE_OFF = H * NOPE + R;               // q_pe's columns in the projection
constexpr int KPE_OFF = QPE_OFF + H * ROPE;         // k_pe's
constexpr int YCOLS = KPE_OFF + ROPE;               // 3,648 values a projection row
constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int QCOLS = 64;                           // q_lat columns a CTA of the first kernel
constexpr int TILE = 64;                            // slots a ring stage
constexpr int STAGES = 2;
constexpr int ROW_VALS = LAT * 2;                   // 1,152 bytes of a slot
constexpr int RS = ROW_VALS + 16;                   // a q row's stride in shared memory: 16 B
                                                    // apart in the banks, so ldmatrix's
                                                    // eight rows never collide
constexpr int BOX_BYTES = TILE * 128;               // a TMA box: 64 slots x 64 values
constexpr int BOXES = LAT / 64;                     // 9 boxes a tile
constexpr int STAGE_BYTES = BOXES * BOX_BYTES;
constexpr int KSTEPS = LAT / 16;                    // 36 mma k-steps of the scores
constexpr int KHALF = KSTEPS / 2;                   // a warp's k-steps
constexpr int P_STRIDE = TILE + 8;                  // bf16 a probability row (16 B apart)
constexpr int MAX_B = 4;
constexpr int CTAS = 128;                           // the attention kernel's CTAs, all rows
constexpr int MAX_S = CTAS;                         // its CTAs a batch row
constexpr int PART = R + 4;                         // a (CTA, head) partial: o_lat, max, sum
constexpr int OUT_CTAS = 8;                         // the combining kernel's cluster a head
constexpr int OUT_COLS = VD / OUT_CTAS;             // output columns a CTA of it
constexpr int MAX_SLOTS = 16384;
constexpr float NEG_INF = -INFINITY;
static_assert(WARPS == 8 && TILE == 64 && R == 64 * WARPS, "a warp's share of the tile products");
static_assert(KSTEPS % 2 == 0 && KHALF % 2 == 0, "k-steps in pairs");
static_assert(R % QCOLS == 0 && NOPE * QCOLS / 8 == 4 * THREADS, "4 W_UK loads a thread");
static_assert(OUT_COLS == 16 && R * OUT_COLS / 8 == 4 * THREADS && R / OUT_CTAS == 64,
              "4 W_UV loads a thread, 4 threads an o_lat column");

// The attention kernel's shared memory, in bytes from the start.
constexpr int OFF_RING = 0;
constexpr int OFF_Q = OFF_RING + STAGES * STAGE_BYTES;     // H rows of [q_lat | q_pe]; then
                                                           // the partial o_lat's staging
constexpr int OFF_P = OFF_Q + H * RS;                      // the tile's bf16 probabilities
constexpr int OFF_SRED = OFF_P + H * P_STRIDE * 2;         // the scores' traded k halves
constexpr int OFF_BAR = OFF_SRED + 4 * 2 * 32 * 4 * 4;     // the stages' mbarriers
constexpr int OFF_STAT = OFF_BAR + STAGES * 8;
constexpr int STAT_FLOATS = 4 * H + H + 4 * H;
constexpr int SMEM_BYTES = OFF_STAT + STAT_FLOATS * 4;

struct MlaParams {
  const bf16* y;           // (B, 3648): [q_nope | c_kv | q_pe | k_pe] before rope and norm
  const float* cos;        // (B, 64) rotate-half cos
  const float* sin;        // (B, 64) signed sin
  const bf16* norm;        // (512,) kv_a_layernorm's scale
  const float* mask;       // (B, M) additive, or null
  bf16* cache;             // (B, M, 576) latent slots
  const long long* index;  // this step's slot
  const bf16* w_uk;        // (16, 128, 512)
  const bf16* w_uv;        // (16, 512, 128)
  bf16* q;                 // (B, 16, 576) scratch: [q_lat | q_pe] a head
  float* part;             // (B, S, 16, PART) scratch: each attention CTA's partials
  bf16* out;               // (B, 16 * 128)
  int B, M, S;             // S: the attention kernel's CTAs a row
  float eps, scale;
};

__device__ __forceinline__ void unpack8(const uint4& u, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return u;
}

// Orders this thread's generic-proxy shared-memory accesses before the TMA
// unit's later ones (a stage rewritten by threads, then refilled).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void st_cluster_f32(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16 x 16) . b (16 x 8): bf16 products summed in f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Value d of DeepSeek's rope of the 64 values at x: the interleaved pairs
// gathered as [evens, odds], then turned as rotate-half halves; f32, each
// product rounded, then their sum.
__device__ __forceinline__ float roped(const bf16* x, int d, const float* cs, const float* sn) {
  const int half = ROPE / 2;
  const float a = __bfloat162float(x[d < half ? 2 * d : 2 * (d - half) + 1]);
  const float s = __bfloat162float(x[d < half ? 2 * d + 1 : 2 * (d - half)]);
  return __fadd_rn(__fmul_rn(a, cs[d]), __fmul_rn(s, sn[d]));
}

// ---------------------------------------------------------------------------
// 1. q and the new slot
// ---------------------------------------------------------------------------

// Row b's new latent slot: c_kv normed (a thread's 8 values in turn, then
// pairwise halving over the 64 threads' sums), k_pe roped, into the cache.
__device__ __forceinline__ void new_slot(const MlaParams& p, int b, long long idx, float* nsum) {
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const bf16* yrow = p.y + (size_t)b * YCOLS;
  bf16* slot = p.cache + ((size_t)b * p.M + idx) * LAT;
  float v[8], ss = 0.f;
  if (t < R / 8) {
    unpack8(*reinterpret_cast<const uint4*>(yrow + H * NOPE + 8 * t), v);
#pragma unroll
    for (int j = 0; j < 8; ++j) ss = __fadd_rn(ss, __fmul_rn(v[j], v[j]));
    if (warp == 1) nsum[lane] = ss;
  }
  __syncthreads();
  if (warp == 0) {
    ss = __fadd_rn(ss, nsum[lane]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
    if (lane == 0) nsum[32] = ss;
  }
  __syncthreads();
  if (t < R / 8) {
    // torch: rsqrt(sum / 512 + eps); (x * r) * scale
    const float r = rsqrtf(__fadd_rn(__fmul_rn(nsum[32], 1.0f / R), p.eps));
    float s[8];
    unpack8(__ldg(reinterpret_cast<const uint4*>(p.norm) + t), s);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __fmul_rn(__fmul_rn(v[j], r), s[j]);
    *reinterpret_cast<uint4*>(slot + 8 * t) = pack8(v);
  } else if (t >= 64 && t < 64 + ROPE) {
    slot[R + t - 64] = __float2bfloat16_rn(
        roped(yrow + KPE_OFF, t - 64, p.cos + (size_t)b * ROPE, p.sin + (size_t)b * ROPE));
  }
}

// Grid (R / QCOLS + 1, H): CTA (x, h), x < R / QCOLS, computes columns
// QCOLS x .. of head h's q_lat for every batch row (a thread 8 columns over
// every 32nd row of the W_UK slice, then the 32 row groups summed: 4 a warp
// by shuffles, 8 warps through shared memory), and CTA (0, h) also turns
// head h's rope part; CTA (R / QCOLS, b) writes row b's new slot.
__global__ void __launch_bounds__(THREADS) mla_q_kernel(const MlaParams p) {
  __shared__ float qn[MAX_B][NOPE];
  __shared__ float red[WARPS][MAX_B][QCOLS];
  __shared__ float nsum[33];
  const int t = threadIdx.x, lane = t % 32, warp = t / 32, h = blockIdx.y;
  if (blockIdx.x == R / QCOLS) {
    if (h < p.B) {
      const long long idx = *p.index;
      if (idx < 0 || idx >= p.M) __trap();
      new_slot(p, h, idx, nsum);
    }
    return;
  }
  const int c0 = QCOLS * blockIdx.x, cc = t % (QCOLS / 8), g = t / (QCOLS / 8);
  const uint4* w = reinterpret_cast<const uint4*>(p.w_uk + (size_t)h * NOPE * R + c0);
  uint4 wv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wv[j] = __ldg(w + (size_t)(g + 32 * j) * (R / 8) + cc);
  for (int e = t; e < p.B * NOPE; e += THREADS)
    qn[e / NOPE][e % NOPE] =
        __bfloat162float(p.y[(size_t)(e / NOPE) * YCOLS + h * NOPE + e % NOPE]);
  if (blockIdx.x == 0)
    for (int e = t; e < p.B * ROPE; e += THREADS) {
      const int b = e / ROPE, d = e % ROPE;
      p.q[((size_t)b * H + h) * LAT + R + d] = __float2bfloat16_rn(
          roped(p.y + (size_t)b * YCOLS + QPE_OFF + h * ROPE, d, p.cos + (size_t)b * ROPE,
                p.sin + (size_t)b * ROPE));
    }
  __syncthreads();
  float acc[MAX_B][8];
#pragma unroll
  for (int b = 0; b < MAX_B; ++b)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[b][e] = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float f[8];
    unpack8(wv[j], f);
#pragma unroll
    for (int b = 0; b < MAX_B; ++b) {
      if (b < p.B) {
        const float q = qn[b][g + 32 * j];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[b][e] = fmaf(q, f[e], acc[b][e]);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < MAX_B; ++b) {
    if (b < p.B) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float v = acc[b][e];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < 8) red[warp][b][8 * cc + e] = v;
      }
    }
  }
  __syncthreads();
  for (int e = t; e < p.B * QCOLS; e += THREADS) {
    const int b = e / QCOLS, col = e % QCOLS;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) s += red[k][b][col];
    p.q[((size_t)b * H + h) * LAT + c0 + col] = __float2bfloat16_rn(s);
  }
}

// ---------------------------------------------------------------------------
// 2. attention over the slots
// ---------------------------------------------------------------------------

// Byte offset in a ring stage of 16-byte chunk k (of the 72 in a latent
// row) of slot row r: the tile lands as 9 TMA boxes of 64 rows x 128 bytes
// with the 128-byte swizzle, so chunk c of a box's row r sits at c ^ (r % 8)
// and ldmatrix's eight rows fall in distinct banks.
__device__ __forceinline__ int tile_off(int r, int k) {
  return (k >> 3) * BOX_BYTES + r * 128 + (((k & 7) ^ (r & 7)) << 4);
}

// Tile i of the CTA's slots lo + TILE * i .. into ring stage i % STAGES:
// thread 0 asks the TMA unit for its 9 boxes (rows of the (B M, 576) cache;
// rows past the tensor read as zeros, rows past `hi` are real slots whose
// probabilities are 0), completing on the stage's mbarrier.
__device__ __forceinline__ void issue_tile(const CUtensorMap* slots, unsigned char* ring,
                                           uint32_t bars, int row0, int i, int T, int lo) {
  if (i >= T || threadIdx.x != 0) return;
  const uint32_t bar = bars + 8 * (i % STAGES);
  const uint32_t dst = smem_u32(ring + (i % STAGES) * STAGE_BYTES);
  fence_proxy_async();  // the threads' reads of this stage came first
  tstar::sm90::mbar_expect_tx(bar, STAGE_BYTES);
#pragma unroll
  for (int j = 0; j < BOXES; ++j)
    tstar::sm90::tma_load_2d(dst + j * BOX_BYTES, slots, bar, 64 * j, row0 + lo + TILE * i);
}

// Grid (S, B): CTA s of row b takes slots s per .. (s + 1) per - 1 of the
// live 0 .. index and writes its partial of every head: the max, the sum
// and o_lat relative to that max.
__global__ void __launch_bounds__(THREADS, 1)
mla_attend_kernel(const MlaParams p, const __grid_constant__ CUtensorMap slots) {
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* ring = smem + OFF_RING;
  unsigned char* qs = smem + OFF_Q;
  bf16* pt = reinterpret_cast<bf16*>(smem + OFF_P);
  float* sred = reinterpret_cast<float*>(smem + OFF_SRED);
  const uint32_t bars = smem_u32(smem + OFF_BAR);
  float* wmax = reinterpret_cast<float*>(smem + OFF_STAT);  // 4 x H: the tile's max a warp
  float* alpha = wmax + 4 * H;                               // H: the tile's rescale
  float* wl = alpha + H;                                     // 4 x H: the sums a warp

  const int t = threadIdx.x, lane = t % 32, warp = t / 32, gq = lane / 4, tq = lane % 4;
  const int s_cta = blockIdx.x, b = blockIdx.y;

  const long long idx = *p.index;
  if (idx < 0 || idx >= p.M) __trap();
  const int n = (int)idx + 1, per = (n + p.S - 1) / p.S;
  const int lo = min(n, s_cta * per), hi = min(n, lo + per);
  const int T = (hi - lo + TILE - 1) / TILE;

  // every head's q row, read while the first tiles are asked for
  constexpr int QV = (H * ROW_VALS / 16 + THREADS - 1) / THREADS;
  const uint4* qrow = reinterpret_cast<const uint4*>(p.q + (size_t)b * H * LAT);
  uint4 qv[QV];
#pragma unroll
  for (int u = 0; u < QV; ++u)
    if (t + THREADS * u < H * (ROW_VALS / 16)) qv[u] = __ldcg(qrow + t + THREADS * u);
  if (t == 0) tstar::sm90::prefetch_map(&slots);
  if (t < STAGES) tstar::sm90::mbar_init(bars + 8 * t, 1);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();
  const int row0 = b * p.M;  // row b's first slot in the tensor map's rows
  for (int i = 0; i < STAGES; ++i) issue_tile(&slots, ring, bars, row0, i, T, lo);
#pragma unroll
  for (int u = 0; u < QV; ++u) {
    const int e = t + THREADS * u;
    if (e < H * (ROW_VALS / 16))
      *reinterpret_cast<uint4*>(qs + e / (ROW_VALS / 16) * RS + 16 * (e % (ROW_VALS / 16))) =
          qv[u];
  }
  __syncthreads();

  // Scores: warp w takes slots 16 (w % 4) .. + 15 of a tile over k-steps
  // 18 (w / 4) .. + 17, its q fragments in registers, then the two k halves
  // trade sums so that warp w holds heads 8 (w / 4) .. + 7 of its slots
  // (its softmax rows); P . c: warp w takes columns 64 w .. + 63 of c over
  // the tile's 64 slots.
  const int np = warp % 4, kh = warp / 4, head = gq + 8 * kh;
  const int qr = lane % 8 + 8 * (lane / 8 % 2);  // ldmatrix's row for an m16 A operand
  uint32_t qa[KHALF][4];
#pragma unroll
  for (int j = 0; j < KHALF; ++j)
    ldmatrix_x4(smem_u32(qs + qr * RS + 16 * (2 * (KHALF * kh + j) + lane / 16)), qa[j]);
  const float* mrow = p.mask != nullptr ? p.mask + (size_t)b * p.M : nullptr;
  float o[8][4];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
  float m_run = NEG_INF, l_run = 0.f;  // head `head`, this lane's slots
  for (int i = 0; i < T; ++i) {
    const int s0 = lo + TILE * i, live = min(TILE, hi - s0);
    unsigned char* stage = ring + (i % STAGES) * STAGE_BYTES;
    // the mask of the lane's 4 slots, read while the tile lands
    float mk[2][2];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int s = s0 + 16 * np + 8 * nb + 2 * tq + e;
        mk[nb][e] = s < hi && mrow != nullptr ? mrow[s] : 0.f;
      }
    tstar::sm90::mbar_wait(bars + 8 * (i % STAGES), (i / STAGES) & 1);
    __syncthreads();
    // two chains a slot block (even and odd k-steps), four in flight
    float acc[2][4], acc2[2][4];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nb][e] = acc2[nb][e] = 0.f;
#pragma unroll
    for (int j = 0; j < KHALF; j += 2) {
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const int rr = 16 * np + 8 * nb + lane % 8;
        uint32_t kb[4];
        ldmatrix_x4(smem_u32(stage + tile_off(rr, 2 * (KHALF * kh + j) + lane / 8)), kb);
        mma_bf16(acc[nb], qa[j], kb[0], kb[1]);
        mma_bf16(acc2[nb], qa[j + 1], kb[2], kb[3]);
      }
    }
    // trade: the other half's heads out, this half's in
    const int mine = 2 * kh, theirs = 2 * (1 - kh);
    *reinterpret_cast<float4*>(sred + ((np * 2 + 1 - kh) * 32 + lane) * 4) =
        make_float4(acc[0][theirs] + acc2[0][theirs], acc[0][theirs + 1] + acc2[0][theirs + 1],
                    acc[1][theirs] + acc2[1][theirs], acc[1][theirs + 1] + acc2[1][theirs + 1]);
    __syncthreads();
    const float4 other = *reinterpret_cast<const float4*>(sred + ((np * 2 + kh) * 32 + lane) * 4);
    const float part[4] = {other.x, other.y, other.z, other.w};
    float sc[4], mx = NEG_INF;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dot = acc[nb][mine + e] + acc2[nb][mine + e] + part[2 * nb + e];
        const bool in = 16 * np + 8 * nb + 2 * tq + e < live;
        sc[2 * nb + e] = in ? __fadd_rn(__fmul_rn(dot, p.scale), mk[nb][e]) : NEG_INF;
        mx = fmaxf(mx, sc[2 * nb + e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    if (tq == 0) wmax[np * H + head] = mx;
    __syncthreads();
    const float m_new = fmaxf(fmaxf(m_run, fmaxf(wmax[head], wmax[H + head])),
                              fmaxf(wmax[2 * H + head], wmax[3 * H + head]));
    const float al = expf(m_run - m_new);
    m_run = m_new;
    l_run *= al;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      const __nv_bfloat16 p0 = __float2bfloat16_rn(expf(sc[2 * nb] - m_new));
      const __nv_bfloat16 p1 = __float2bfloat16_rn(expf(sc[2 * nb + 1] - m_new));
      l_run += __bfloat162float(p0) + __bfloat162float(p1);
      __nv_bfloat162 pp;
      pp.x = p0;
      pp.y = p1;
      *reinterpret_cast<__nv_bfloat162*>(pt + head * P_STRIDE + 16 * np + 8 * nb + 2 * tq) = pp;
    }
    if (np == 0 && tq == 0) alpha[head] = al;
    __syncthreads();
    const float a0 = alpha[gq], a1 = alpha[gq + 8];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      o[nb][0] *= a0;
      o[nb][1] *= a0;
      o[nb][2] *= a1;
      o[nb][3] *= a1;
    }
#pragma unroll
    for (int ks = 0; ks < TILE / 16; ++ks) {
      uint32_t pa[4];
      ldmatrix_x4(smem_u32(pt + qr * P_STRIDE + 16 * ks + 8 * (lane / 16)), pa);
      const int r = 16 * ks + lane % 16;
#pragma unroll
      for (int pair = 0; pair < 4; ++pair) {
        uint32_t vb[4];
        ldmatrix_x4_trans(smem_u32(stage + tile_off(r, 8 * warp + 2 * pair + lane / 16)), vb);
        mma_bf16(o[2 * pair], pa, vb[0], vb[1]);
        mma_bf16(o[2 * pair + 1], pa, vb[2], vb[3]);
      }
    }
    fence_proxy_async();  // the stage's reads and writes before its refill
    __syncthreads();      // the stage, the probabilities and the stats are reused
    issue_tile(&slots, ring, bars, row0, i + STAGES, T, lo);
  }

  // the partial: each head's max and sum, and o_lat through the free ring
  // into whole 16-byte stores
  float* dst = p.part + ((size_t)b * p.S + s_cta) * H * PART;
  constexpr int OS = R + 8;  // a staged row's stride: rows 8 banks apart
  float* stage_o = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
      *reinterpret_cast<float2*>(stage_o + (gq + 8 * hr) * OS + 64 * warp + 8 * nb + 2 * tq) =
          make_float2(o[nb][2 * hr], o[nb][2 * hr + 1]);
  {
    float l = l_run;
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (tq == 0) wl[np * H + head] = l;
  }
  __syncthreads();
  if (np == 0 && tq == 0) {
    dst[head * PART + R] = m_run;
    dst[head * PART + R + 1] = wl[head] + wl[H + head] + wl[2 * H + head] + wl[3 * H + head];
  }
  for (int e = t; e < H * R / 4; e += THREADS)
    *reinterpret_cast<float4*>(dst + e / (R / 4) * PART + 4 * (e % (R / 4))) =
        *reinterpret_cast<const float4*>(stage_o + e / (R / 4) * OS + 4 * (e % (R / 4)));
}

// ---------------------------------------------------------------------------
// 3. the partials combined, then W_UV
// ---------------------------------------------------------------------------

// Grid (OUT_CTAS, H), clusters of OUT_CTAS along x: the cluster of head h
// combines its S partials, CTA j taking o_lat's columns 64 j .. + 63 (the
// S weights computed once, then 4 threads a column over a quarter of the
// partials each), gathers the whole o_lat of each row into every CTA
// (distributed shared memory), and CTA j writes the output columns 16 j ..
// + 15 of each row: o_lat . its 16 columns of the head's W_UV slice.
__global__ void __launch_bounds__(THREADS) mla_out_kernel(const MlaParams p) {
  __shared__ float wts[MAX_B][MAX_S];
  __shared__ float lsum[MAX_B];
  __shared__ __align__(16) float olat[MAX_B][R];
  __shared__ float quarter[MAX_B][4][64];
  __shared__ float red[THREADS / 32][MAX_B][OUT_COLS];
  const int t = threadIdx.x, lane = t % 32, warp = t / 32, h = blockIdx.y;
  const int j = (int)cluster_rank(), c0 = (R / OUT_CTAS) * j;
  // this CTA's 16 output columns of W_UV: rows r = t / 2 + 128 k, 8 columns a thread
  const uint4* wsrc = reinterpret_cast<const uint4*>(p.w_uv + (size_t)h * R * VD + OUT_COLS * j);
  uint4 wv[R * OUT_COLS / 8 / THREADS];
#pragma unroll
  for (int k = 0; k < R * OUT_COLS / 8 / THREADS; ++k)
    wv[k] = __ldg(wsrc + (size_t)(t / 2 + (THREADS / 2) * k) * (VD / 8) + t % 2);
  // the weights of the partials, a warp a row, a lane partials lane + 32 i
  if (warp < p.B) {
    const int b = warp;
    const float* src = p.part + (size_t)b * p.S * H * PART + h * PART;
    float mv[MAX_S / 32], lv[MAX_S / 32], mm = NEG_INF;
#pragma unroll
    for (int i = 0; i < MAX_S / 32; ++i) {
      const int s = lane + 32 * i;
      mv[i] = s < p.S ? __ldcg(src + (size_t)s * H * PART + R) : NEG_INF;
      lv[i] = s < p.S ? __ldcg(src + (size_t)s * H * PART + R + 1) : 0.f;
      mm = fmaxf(mm, mv[i]);
    }
    mm = tstar::warp_max(mm);
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < MAX_S / 32; ++i) {
      const float w = mv[i] == NEG_INF ? 0.f : expf(mv[i] - mm);
      if (lane + 32 * i < p.S) wts[b][lane + 32 * i] = w;
      total += w * lv[i];
    }
    total = tstar::warp_sum(total);
    if (lane == 0) lsum[b] = total;
  }
  __syncthreads();
  // o_lat's 64 columns of this CTA: thread (column, quarter of the
  // partials), 8 partials' loads in flight, the quarters then summed in order
  const int col = t % 64, q4 = t / 64;
  for (int b = 0; b < p.B; ++b) {
    const float* src = p.part + (size_t)b * p.S * H * PART + h * PART + c0 + col;
    float s = 0.f;
    for (int k0 = q4; k0 < p.S; k0 += 32) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = k0 + 4 * u < p.S ? __ldcg(src + (size_t)(k0 + 4 * u) * H * PART) : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (k0 + 4 * u < p.S) s += wts[b][k0 + 4 * u] * v[u];
    }
    quarter[b][q4][col] = s;
  }
  __syncthreads();
  for (int e = t; e < p.B * 64; e += THREADS) {
    const int b = e / 64, c = e % 64;
    olat[b][c0 + c] =
        (quarter[b][0][c] + quarter[b][1][c] + quarter[b][2][c] + quarter[b][3][c]) / lsum[b];
  }
  __syncthreads();
  // every CTA of the cluster gets every row's 512 columns
  cluster_arrive();
  cluster_wait();
  for (int e = t; e < p.B * (R / OUT_CTAS); e += THREADS) {
    const int b = e / (R / OUT_CTAS), col = c0 + e % (R / OUT_CTAS);
    const float v = olat[b][col];
    for (int c = 0; c < OUT_CTAS; ++c)
      if (c != j) st_cluster_f32(map_rank(smem_u32(&olat[b][col]), c), v);
  }
  cluster_arrive();
  cluster_wait();
  // out columns 16 j .. + 15: thread t takes 8 of them (t % 2) over rows t / 2 + 128 k
#pragma unroll
  for (int b = 0; b < MAX_B; ++b) {
    if (b < p.B) {
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < R * OUT_COLS / 8 / THREADS; ++k) {
        float f[8];
        unpack8(wv[k], f);
        const float ov = olat[b][t / 2 + (THREADS / 2) * k];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = fmaf(ov, f[e], acc[e]);
      }
      // sum over the 16 threads of a warp with the same t % 2, then the warps
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float v = acc[e];
#pragma unroll
        for (int off = 2; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane < 2) red[warp][b][8 * lane + e] = v;
      }
    }
  }
  __syncthreads();
  for (int e = t; e < p.B * OUT_COLS; e += THREADS) {
    const int b = e / OUT_COLS, col = e % OUT_COLS;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < THREADS / 32; ++k) s += red[k][b][col];
    p.out[(size_t)b * H * VD + h * VD + OUT_COLS * j + col] = __float2bfloat16_rn(s);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int launch(MlaParams p, cudaStream_t stream) {
  namespace sm90 = tstar::sm90;
  sm90::DeviceInfo info;
  int dev = 0;
  int e = sm90::device_info(&info, &dev);
  if (e) return e;
  if (SMEM_BYTES > info.optin) return (int)cudaErrorInvalidValue;
  static bool opted[sm90::MAX_DEVICES];
  e = sm90::opt_in(reinterpret_cast<const void*>(mla_attend_kernel), dev, info.optin, opted);
  if (e) return e;
  mla_q_kernel<<<dim3(R / QCOLS + 1, H), THREADS, 0, stream>>>(p);
  cudaError_t ce = cudaGetLastError();
  if (ce != cudaSuccess) return (int)ce;
  CUtensorMap slots;
  e = sm90::map_bf16_2d(&slots, p.cache, (long long)p.B * p.M, LAT, TILE);
  if (e) return e;
  mla_attend_kernel<<<dim3(p.S, p.B), THREADS, SMEM_BYTES, stream>>>(p, slots);
  ce = cudaGetLastError();
  if (ce != cudaSuccess) return (int)ce;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = OUT_CTAS;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(OUT_CTAS, H);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  ce = cudaLaunchKernelEx(&cfg, mla_out_kernel, p);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}

}  // namespace

// y (B, 3648) bf16, cos / sin (B, 64) f32, norm (512,) bf16, mask (B, M) f32
// or null, cache (B, M, 576) bf16, index (int64, on the device), w_uk (16,
// 128, 512), w_uv (16, 512, 128), scratch q (B, 16, 576) bf16 and part (B
// S, 16, 516) f32, out (B, 2048) bf16; 1 <= B <= 4, M <= 16,384, S the
// attention kernel's CTAs a row (B S <= 128); eps the norm's, scale
// qk_head_dim^-0.5.  Three launches.
extern "C" int tstar_mla_decode(const void* y, const void* cos, const void* sin, const void* norm,
                                const void* mask, void* cache, const void* index, const void* w_uk,
                                const void* w_uv, void* q, void* part, void* out, int B, int M,
                                int S, float eps, float scale, void* stream) {
  if (B < 1 || B > MAX_B || M < 1 || M > MAX_SLOTS || S < 1 || B * S > CTAS ||
      index == nullptr)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(y) || !aligned16(norm) || !aligned16(cache) || !aligned16(w_uk) ||
      !aligned16(w_uv) || !aligned16(q) || !aligned16(part) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  MlaParams p{static_cast<const bf16*>(y),     static_cast<const float*>(cos),
              static_cast<const float*>(sin),  static_cast<const bf16*>(norm),
              static_cast<const float*>(mask), static_cast<bf16*>(cache),
              static_cast<const long long*>(index), static_cast<const bf16*>(w_uk),
              static_cast<const bf16*>(w_uv),  static_cast<bf16*>(q),
              static_cast<float*>(part),       static_cast<bf16*>(out),
              B, M, S, eps, scale};
  return launch(p, (cudaStream_t)stream);
}
