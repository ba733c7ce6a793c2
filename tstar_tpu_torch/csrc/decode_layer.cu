// The single-token Qwen2 decoder layer's work between its matrix products:
// residual add + RMSNorm, decode attention with its prologue, and SiLU * up.
//
// Replaces no Pallas kernel: the reference runs this as XLA code
// (tstar_tpu/models/qwen2vl.py, Qwen2DecoderLayer), and the port ran it as
// ~53 plain torch launches a layer.  It was added for the decode step of the
// VLM requests (models/generate.py), where one new token meets its KV cache.
//
// What bounds it on the H100: at M = 1 every piece moves a few KB (a 3,584
// row, 7 query heads of 128) except the attention's cache read (~5 MB a layer
// at ~2,400 slots of Qwen2-7B's 4 kv heads, 1.5 us at 3.35 TB/s).  So the
// launches and their tails bound it, not the arithmetic: the plain layer paid
// ~20 launches where one does.  Each kernel here replaces a run of them:
//
//  1. add_rms_norm: x + delta rounded to bf16 (the new residual), then
//     h = x_f32 * rsqrt(mean(x_f32^2) + eps) * scale_f32, rounded once.  One
//     CTA a row, D / 8 threads, each holding one 16-byte vector in registers.
//     The first layer's input norm has no delta; the final norm takes one.
//  2. decode_attention: from the q/k/v projections before their bias: the
//     bias add (rounded as Dense rounds it), mRoPE in f32 rounded back, this
//     token's K/V written into the cache at `index`, q scaled by
//     head_dim^-0.5 in bf16, logits in f32 rounded to bf16, the additive mask
//     added in bf16, an f32 softmax rounded to bf16, and P.V with f32
//     accumulation rounded to bf16: the plain path's rounding points
//     (kernels/decode.py, decode_attention_plain).  Because the normalised
//     probabilities are rounded before P.V, a one-pass online softmax cannot
//     match; the kernel holds every logit of its slots instead.  A cluster of
//     16 CTAs per (batch row, kv head) (8 where the card cannot hold every
//     cluster of 16 at once) splits slots [0, index] (slots after it are
//     masked and add exact zeros, so they are not read); the CTAs exchange
//     each head's max and sum through distributed shared memory, round their
//     probabilities, and sum their partial P.V through the cluster.  The G
//     query heads of a kv group share every K/V tile a CTA streams into
//     shared memory (cp.async, a ring of stages), so each cache byte is read
//     once a step; the V tiles' loads start while the logits finish.  Both
//     products run on mma.sync tensor-core tiles, bf16 operands summed in
//     f32 as the plain path's cuBLAS products are: on CUDA cores a CTA's
//     8 warps spent ~0.6 us a 32-slot tile on their dot products alone.
//  3. silu_mul: silu(gate) in f32 rounded to bf16, times up, rounded.  One
//     16-byte vector a thread.
//
// bf16 only, head_dim 128, G = heads / kv heads in 1..8, at most 16,384
// cache slots, the hidden width a multiple of 256 up to 8192.  The wrappers
// raise on anything else, and the layer routes any other shape to the plain
// path.  Each f32 operation that
// torch rounds on its own is written with an _rn intrinsic, so nvcc does not
// contract it into an FMA; only the sums run in the kernels' own order.
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
using tstar::sm90::cluster_size;
using tstar::sm90::cluster_wait;
using tstar::sm90::map_rank;
using tstar::sm90::smem_u32;

constexpr int HD = 128;          // head_dim
constexpr int MAX_G = 8;         // query heads a kv head
constexpr int THREADS = 256;     // attention CTA
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;         // cache slots a ring stage
constexpr int STAGES = 6;        // ring depth
constexpr int CLUSTER = 8;       // CTAs a (batch row, kv head), portable
constexpr int WIDE = 16;         // ... where the card holds them all at once
constexpr int MAX_SLOTS = 16384; // cache length the attention takes
constexpr int ROW_BYTES = HD * 2;
constexpr int TILE_BYTES = TILE * ROW_BYTES;
constexpr int RING_BYTES = STAGES * TILE_BYTES;
static_assert(THREADS == 2 * HD, "the prologue gives each K and V value a thread");
static_assert(TILE == 8 * WARPS && HD == 16 * WARPS, "a warp's share of Q K^T and of P V");
static_assert(HD % WIDE == 0, "a CTA's share of the outputs: G x 128 / C values");

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

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

__device__ __forceinline__ void unpack4(const uint2& u, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// 16 bytes from `src` (the first `bytes` of them; the rest zero) into `dst`.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// A store into cluster CTA shared memory (an address from map_rank).
__device__ __forceinline__ void st_cluster_f32(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}
// Arrives at the cluster barrier with no memory ordering: the wait that
// follows says only that every CTA of the cluster has started.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

// ---------------------------------------------------------------------------
// 1. residual add + RMSNorm
// ---------------------------------------------------------------------------

__global__ void add_rms_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ delta,
                                    const bf16* __restrict__ scale, bf16* __restrict__ res,
                                    bf16* __restrict__ out, int D, float inv_d, float eps) {
  __shared__ float warp_sums[32];
  __shared__ float total;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const size_t off = (size_t)blockIdx.x * D + 8 * t;
  float v[8];
  unpack8(__ldg(reinterpret_cast<const uint4*>(x + off)), v);
  if (delta != nullptr) {
    float d[8];
    unpack8(__ldg(reinterpret_cast<const uint4*>(delta + off)), d);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = round_bf16(__fadd_rn(v[j], d[j]));
    *reinterpret_cast<uint4*>(res + off) = pack8(v);
  }
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) ss = __fadd_rn(ss, __fmul_rn(v[j], v[j]));
  ss = tstar::warp_sum(ss);
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float s = lane < (int)blockDim.x / 32 ? warp_sums[lane] : 0.f;
    s = tstar::warp_sum(s);
    if (lane == 0) total = s;
  }
  __syncthreads();
  // torch: mean = sum * (1 / D); rsqrt(mean + eps); (x * r) * scale
  const float r = rsqrtf(__fadd_rn(__fmul_rn(total, inv_d), eps));
  float s[8];
  unpack8(__ldg(reinterpret_cast<const uint4*>(scale + 8 * t)), s);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __fmul_rn(__fmul_rn(v[j], r), s[j]);
  *reinterpret_cast<uint4*>(out + off) = pack8(v);
}

// ---------------------------------------------------------------------------
// 3. SiLU * up
// ---------------------------------------------------------------------------

__global__ void silu_mul_kernel(const bf16* __restrict__ gate, const bf16* __restrict__ up,
                                bf16* __restrict__ out, long long vecs) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= vecs) return;
  float g[8], u[8];
  unpack8(__ldg(reinterpret_cast<const uint4*>(gate) + i), g);
  unpack8(__ldg(reinterpret_cast<const uint4*>(up) + i), u);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    // torch: x / (1 + exp(-x)) in f32, rounded; then the bf16 product
    const float s = round_bf16(__fdiv_rn(g[j], __fadd_rn(1.0f, expf(-g[j]))));
    g[j] = __fmul_rn(s, u[j]);
  }
  reinterpret_cast<uint4*>(out)[i] = pack8(g);
}

// ---------------------------------------------------------------------------
// 2. decode attention
// ---------------------------------------------------------------------------

struct AttnParams {
  const bf16* q;          // (B, H * 128) projections before their bias
  const bf16* k;          // (B, KV * 128)
  const bf16* v;
  const bf16* bq;         // biases, or null
  const bf16* bk;
  const bf16* bv;
  const float* cos;       // (B, 128)
  const float* sin;
  const float* mask;      // (B, M) additive, or null
  bf16* kc;               // caches (B, M, KV, 128)
  bf16* vc;
  const long long* index; // this token's slot
  bf16* out;              // (B, H * 128)
  int M, kv, cap;         // slots, kv heads, slots a CTA holds logits for
  float scale;
};

// x[d] plus its bias, rounded as a bf16 add rounds.
__device__ __forceinline__ float biased(const bf16* x, const bf16* bias, int d) {
  const float a = __bfloat162float(x[d]);
  return bias == nullptr ? a : round_bf16(__fadd_rn(a, __bfloat162float(bias[d])));
}

// The biased row's value d under RoPE: x * cos + rotate_half(x) * sin in f32,
// rounded to bf16.
__device__ __forceinline__ float roped(const bf16* x, const bf16* bias, int d, const float* cs,
                                       const float* sn) {
  const float a = biased(x, bias, d);
  const float r = d < HD / 2 ? -biased(x, bias, d + HD / 2) : biased(x, bias, d - HD / 2);
  return round_bf16(__fadd_rn(__fmul_rn(a, cs[d]), __fmul_rn(r, sn[d])));
}

// Stream tile i of the CTA's sequence (tiles 0 .. T-1: K, T .. 2T-1: V, of
// slots lo + TILE * (i mod T) ..) into ring stage i % STAGES, 16-byte chunk c
// of a slot's row at chunk c ^ (row & 7) (so that ldmatrix's eight rows fall
// in distinct banks); one commit group a tile, empty past the end.  Rows past
// `hi` are zero-filled (their probabilities are 0, and 0 * a stale NaN is
// not); the row of the slot being written (`idx`) is left to the caller.
__device__ __forceinline__ void issue_tile(const AttnParams& p, unsigned char* ring, int i, int T,
                                           int lo, int hi, long long idx, size_t head_off) {
  if (i < 2 * T) {
    const bf16* base = (i < T ? p.kc : p.vc) + head_off;
    const int s0 = lo + TILE * (i % T);
    const uint32_t dst = smem_u32(ring + (i % STAGES) * TILE_BYTES);
    for (int c = threadIdx.x; c < TILE * 16; c += THREADS) {
      const int r = c / 16, s = s0 + r;
      if (s == idx && s < hi) continue;
      const bf16* src = s < hi ? base + (size_t)s * p.kv * HD + (c % 16) * 8 : base;
      cp_async16(dst + r * ROW_BYTES + ((c % 16) ^ (r & 7)) * 16, src, s < hi ? 16 : 0);
    }
  }
  cp_async_commit();
}

// Writes the row of slot `idx` (its bf16 values in `vals`) into its tile's
// ring stage, swizzled as issue_tile lays rows out, when the tile holds it.
__device__ __forceinline__ void put_new_row(unsigned char* stage, int s0, long long idx, int hi,
                                            const float* vals) {
  const int r = (int)(idx - s0);
  if (idx < hi && r >= 0 && r < TILE && threadIdx.x < 16) {
    const int c = threadIdx.x;
    *reinterpret_cast<uint4*>(stage + r * ROW_BYTES + (c ^ (r & 7)) * 16) = pack8(vals + 8 * c);
  }
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

// d += a (16 x 16, rows 8 .. 15 zero) . b (16 x 8): bf16 products summed in
// f32 on the tensor cores.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// The products run on mma.sync tiles of 16 rows: the group's G <= 8 query
// heads are rows 0 .. G-1 (the rest zero), so lane (g = lane / 4, t = lane %
// 4) of a warp holds head g's sums for columns 2t and 2t + 1 of each 8-column
// block.  Q K^T: warp w takes the 8 slots 8w .. 8w+7 of a tile, 16 steps of
// 8 dims (K rows as mma's column operand by ldmatrix); P V: warp w takes dims
// 16w .. 16w+15 over the tile's 64 slots (V by ldmatrix.trans), so each warp
// ends with its own output columns and no cross-warp sum.
template <int G>
__global__ void __launch_bounds__(THREADS, 1) decode_attn_kernel(const AttnParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  bf16* qs = reinterpret_cast<bf16*>(smem + RING_BYTES);     // MAX_G x 128 scaled q
  float* kn = reinterpret_cast<float*>(qs + MAX_G * HD);     // this token's K, V
  float* vn = kn + HD;
  float* part = vn + HD;            // C x share: every CTA's partial P.V of this CTA's share
  float* wstat = part + MAX_G * HD;                          // WARPS x MAX_G
  float* cmax = wstat + WARPS * MAX_G;                       // C x MAX_G: every CTA's max
  float* csum = cmax + WIDE * MAX_G;                         // C x MAX_G: every CTA's sum
  float* logit = csum + WIDE * MAX_G;                        // G x cap: logits, exp
  bf16* prob = reinterpret_cast<bf16*>(logit + G * p.cap);   // G x cap: bf16 probabilities

  const int C = (int)cluster_size(), rank = (int)cluster_rank();
  const int t = threadIdx.x, lane = t % 32, warp = t / 32, gq = lane / 4, tq = lane % 4;
  // each CTA pushes what the others need into their shared memory, so the
  // cluster's CTAs must all have started before the first push
  cluster_arrive_relaxed();
  const int b = blockIdx.y / p.kv, g = blockIdx.y % p.kv, H = G * p.kv;

  // prologue: q of the group's G heads (bias, RoPE, scale), which needs no
  // slot, while the slot's index is read
  const float* cs = p.cos + (size_t)b * HD;
  const float* sn = p.sin + (size_t)b * HD;
#pragma unroll
  for (int k = 0; k < (G * HD + THREADS - 1) / THREADS; ++k) {
    const int e = t + k * THREADS;
    if (e < G * HD) {
      const int col = (g * G + e / HD) * HD;
      const float r = roped(p.q + (size_t)b * H * HD + col, p.bq ? p.bq + col : nullptr, e % HD,
                            cs, sn);
      qs[e] = __float2bfloat16_rn(__fmul_rn(r, p.scale));
    }
  }
  const long long idx = *p.index;
  if (idx < 0 || idx >= p.M) __trap();
  const int n = (int)idx + 1;
  const int per = (n + C - 1) / C;
  const int lo = min(n, rank * per), hi = min(n, lo + per);
  const int T = (hi - lo + TILE - 1) / TILE;
  const size_t head_off = ((size_t)b * p.M * p.kv + g) * HD;  // slot s at + s * kv * 128

  // the ring's first stages go out before this token's K / V
  for (int i = 0; i < STAGES - 1; ++i) issue_tile(p, ring, i, T, lo, hi, idx, head_off);
  {
    const int d = t % HD;
    const size_t row = (size_t)b * p.kv * HD + g * HD;
    const size_t slot = head_off + (size_t)idx * p.kv * HD + d;
    if (t < HD) {
      kn[d] = roped(p.k + row, p.bk ? p.bk + g * HD : nullptr, d, cs, sn);
      if (rank == 0) p.kc[slot] = __float2bfloat16_rn(kn[d]);
    } else {
      vn[d] = biased(p.v + row, p.bv ? p.bv + g * HD : nullptr, d);
      if (rank == 0) p.vc[slot] = __float2bfloat16_rn(vn[d]);
    }
  }
  __syncthreads();

  // q as mma's row operand, all 8 steps of 16 dims
  uint32_t qa[8][2];
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const uint32_t* row = reinterpret_cast<const uint32_t*>(qs + gq * HD + 16 * ks + 2 * tq);
    qa[ks][0] = gq < G ? row[0] : 0u;
    qa[ks][1] = gq < G ? row[4] : 0u;
  }
  // logits: lane (gq, tq) of warp w has head gq at slots 8w + 2tq, + 1 of a
  // tile, whose mask it reads a tile ahead
  const float* mrow = p.mask != nullptr ? p.mask + (size_t)b * p.M : nullptr;
  const int my = 8 * warp + 2 * tq;
  float mk[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) mk[e] = mrow != nullptr && lo + my + e < hi ? mrow[lo + my + e] : 0.f;
  float mx = -INFINITY;  // head gq's max over the lane's slots
  for (int i = 0; i < T; ++i) {
    const int s0 = lo + TILE * i;
    float mk_here[2] = {mk[0], mk[1]};
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (mrow != nullptr && s0 + TILE + my + e < hi) mk[e] = mrow[s0 + TILE + my + e];
    issue_tile(p, ring, i + STAGES - 1, T, lo, hi, idx, head_off);
    cp_async_wait<STAGES - 1>();
    unsigned char* stage = ring + (i % STAGES) * TILE_BYTES;
    put_new_row(stage, s0, idx, hi, kn);
    __syncthreads();
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const int r = 8 * warp + lane % 8;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t kb[4];
      ldmatrix_x4(smem_u32(stage + r * ROW_BYTES + ((4 * kk + lane / 8) ^ (r & 7)) * 16), kb);
      mma_bf16(acc, qa[2 * kk][0], qa[2 * kk][1], kb[0], kb[1]);
      mma_bf16(acc, qa[2 * kk + 1][0], qa[2 * kk + 1][1], kb[2], kb[3]);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int s = s0 + my + e;
      if (s < hi && gq < G) {
        float l = round_bf16(acc[e]);
        if (mrow != nullptr) l = round_bf16(__fadd_rn(l, round_bf16(mk_here[e])));
        logit[gq * p.cap + (s - lo)] = l;
        mx = fmaxf(mx, l);
      }
    }
    __syncthreads();  // the stage is refilled next iteration
  }

  // each head's max: lanes, warps, then every CTA's pushed to every CTA
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  if (tq == 0) wstat[warp * MAX_G + gq] = mx;
  __syncthreads();
  cluster_wait();  // every CTA has started
  if (t < C * G) {
    const int h = t % G;
    float m = -INFINITY;
    for (int w = 0; w < WARPS; ++w) m = fmaxf(m, wstat[w * MAX_G + h]);
    st_cluster_f32(map_rank(smem_u32(cmax + rank * MAX_G + h), t / G), m);
  }
  cluster_arrive();
  cluster_wait();
  // warp h: exp(l - max) over the CTA's slots, kept in place, and their sum
  if (warp < G) {
    const int h = warp;
    float m = -INFINITY;
    for (int r = 0; r < C; ++r) m = fmaxf(m, cmax[r * MAX_G + h]);
    float sum = 0.f;
    for (int s = lane; s < hi - lo; s += 32) {
      const float e = expf(__fsub_rn(logit[h * p.cap + s], m));
      logit[h * p.cap + s] = e;
      sum += e;
    }
    sum = tstar::warp_sum(sum);
    if (lane < C) st_cluster_f32(map_rank(smem_u32(csum + rank * MAX_G + h), lane), sum);
  }
  cluster_arrive();
  cluster_wait();
  // the probabilities in bf16 (0 past the CTA's slots, to its last tile's end)
  if (warp < G) {
    const int h = warp;
    float total = 0.f;
    for (int r = 0; r < C; ++r) total += csum[r * MAX_G + h];
    for (int s = lane; s < T * TILE; s += 32)
      prob[h * p.cap + s] = __float2bfloat16_rn(
          s < hi - lo ? __fdiv_rn(logit[h * p.cap + s], total) : 0.f);
  }
  __syncthreads();

  // P.V: warp w's output columns 16w .. 16w+15, two 8-column blocks
  float o[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int i = T; i < 2 * T; ++i) {
    const int s0 = lo + TILE * (i - T);
    issue_tile(p, ring, i + STAGES - 1, T, lo, hi, idx, head_off);
    cp_async_wait<STAGES - 1>();
    unsigned char* stage = ring + (i % STAGES) * TILE_BYTES;
    put_new_row(stage, s0, idx, hi, vn);
    __syncthreads();
    const bf16* pr = prob + gq * p.cap + TILE * (i - T);
#pragma unroll
    for (int ks = 0; ks < TILE / 16; ++ks) {
      const uint32_t a0 = gq < G ? *reinterpret_cast<const uint32_t*>(pr + 16 * ks + 2 * tq) : 0u;
      const uint32_t a2 =
          gq < G ? *reinterpret_cast<const uint32_t*>(pr + 16 * ks + 8 + 2 * tq) : 0u;
      const int r = 16 * ks + lane % 16;
      uint32_t vb[4];
      ldmatrix_x4_trans(smem_u32(stage + r * ROW_BYTES + ((2 * warp + lane / 16) ^ (r & 7)) * 16),
                        vb);
      mma_bf16(o[0], a0, a2, vb[0], vb[1]);
      mma_bf16(o[1], a0, a2, vb[2], vb[3]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  // CTA r sums outputs r * share .. of the group's G x 128: each CTA pushes
  // its partials there, and the owner adds them in rank order
  const int share = G * HD / C;
  if (gq < G) {
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = gq * HD + 16 * warp + 8 * nb + 2 * tq + e;
        st_cluster_f32(map_rank(smem_u32(part + rank * share + col % share), col / share),
                       o[nb][e]);
      }
  }
  cluster_arrive();
  cluster_wait();
  bf16* out = p.out + (size_t)b * H * HD + (size_t)g * G * HD + rank * share;
  for (int e = t; e < share; e += THREADS) {
    float s = 0.f;
    for (int r = 0; r < C; ++r) s += part[r * share + e];
    out[e] = __float2bfloat16_rn(s);
  }
}

// Shared memory of a CTA holding `cap` slots' logits (cap a multiple of 64,
// plus 8: rows of bf16 probabilities then start 16 bytes apart in the banks).
size_t attn_smem_bytes(int G, int cap) {
  return RING_BYTES + 2 * MAX_G * HD +
         sizeof(float) * ((size_t)MAX_G * HD + 2 * HD + WARPS * MAX_G + 2 * WIDE * MAX_G) +
         (sizeof(float) + 2) * (size_t)G * cap;
}

int logit_room(int M, int C) { return (M + C - 1) / C / TILE * TILE + TILE + 8; }

// Launches clusters of WIDE CTAs a (batch row, kv head) where they all fit
// on the card at once (B = 1 at Qwen2-7B's 4 kv heads: 64 SMs), else of
// CLUSTER; the logits' room follows from the CTAs a cluster splits M over.
template <int G>
int launch_attn(AttnParams p, int B, cudaStream_t stream) {
  namespace sm90 = tstar::sm90;
  sm90::DeviceInfo info;
  int dev = 0;
  int e = sm90::device_info(&info, &dev);
  if (e) return e;
  static bool opted[sm90::MAX_DEVICES];
  e = sm90::opt_in(reinterpret_cast<const void*>(decode_attn_kernel<G>), dev, info.optin, opted);
  if (e) return e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  static int wide_clusters[sm90::MAX_DEVICES];  // clusters of WIDE held at once, + 1
  if (wide_clusters[dev] == 0) {
    int n = 0;
    if (cudaFuncSetAttribute(decode_attn_kernel<G>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1) == cudaSuccess) {
      attr.val.clusterDim.x = WIDE;
      cfg.gridDim = dim3(WIDE, 1);
      cfg.dynamicSmemBytes = attn_smem_bytes(G, logit_room(MAX_SLOTS, WIDE));
      if (cudaOccupancyMaxActiveClusters(&n, decode_attn_kernel<G>, &cfg) != cudaSuccess) n = 0;
    }
    cudaGetLastError();  // a refused query leaves no error behind
    wide_clusters[dev] = n + 1;
  }
  const int C = B * p.kv <= wide_clusters[dev] - 1 ? WIDE : CLUSTER;
  p.cap = logit_room(p.M, C);
  const size_t smem = attn_smem_bytes(G, p.cap);
  if (smem > (size_t)info.optin) return (int)cudaErrorInvalidValue;
  attr.val.clusterDim.x = C;
  cfg.gridDim = dim3(C, (unsigned)(B * p.kv));
  cfg.dynamicSmemBytes = smem;
  const cudaError_t ce = cudaLaunchKernelEx(&cfg, decode_attn_kernel<G>, p);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x, delta (or null), scale, res (written when delta is given), out: bf16,
// R rows of D (a multiple of 256, at most 8192: whole warps of 8 values a
// thread), 16-byte aligned.
extern "C" int tstar_add_rms_norm(const void* x, const void* delta, const void* scale, void* res,
                                  void* out, int R, int D, float eps, void* stream) {
  if (R < 1 || D < 256 || D % 256 || D > 8192) return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(delta) || !aligned16(scale) || !aligned16(res) ||
      !aligned16(out))
    return (int)cudaErrorInvalidValue;
  add_rms_norm_kernel<<<R, D / 8, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(delta),
      static_cast<const bf16*>(scale), static_cast<bf16*>(res), static_cast<bf16*>(out), D,
      1.0f / (float)D, eps);
  return (int)cudaGetLastError();
}

// gate, up, out: bf16, n values (a multiple of 8), 16-byte aligned.
extern "C" int tstar_silu_mul(const void* gate, const void* up, void* out, long long n,
                              void* stream) {
  if (n < 8 || n % 8 || !aligned16(gate) || !aligned16(up) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  const long long vecs = n / 8;
  silu_mul_kernel<<<(unsigned)((vecs + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(gate), static_cast<const bf16*>(up), static_cast<bf16*>(out),
      vecs);
  return (int)cudaGetLastError();
}

// q (B, H*128), k, v (B, KV*128), biases (or null), cos, sin (B, 128) f32,
// mask (B, M) f32 (or null), caches (B, M, KV, 128), index (int64, on the
// device), out (B, H*128).  H a multiple of KV, H / KV in 1 .. 8, M <= 16384.
extern "C" int tstar_decode_attention(const void* q, const void* k, const void* v, const void* bq,
                                      const void* bk, const void* bv, const void* cos,
                                      const void* sin, const void* mask, void* kc, void* vc,
                                      const void* index, void* out, int B, int M, int H, int KV,
                                      float scale, void* stream) {
  if (B < 1 || M < 1 || M > MAX_SLOTS || KV < 1 || H % KV || H / KV < 1 || H / KV > MAX_G)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(kc) || !aligned16(vc)) return (int)cudaErrorInvalidValue;
  AttnParams p{static_cast<const bf16*>(q),   static_cast<const bf16*>(k),
               static_cast<const bf16*>(v),   static_cast<const bf16*>(bq),
               static_cast<const bf16*>(bk),  static_cast<const bf16*>(bv),
               static_cast<const float*>(cos), static_cast<const float*>(sin),
               static_cast<const float*>(mask), static_cast<bf16*>(kc),
               static_cast<bf16*>(vc),        static_cast<const long long*>(index),
               static_cast<bf16*>(out),       M, KV, 0, scale};
  cudaStream_t s = (cudaStream_t)stream;
  switch (H / KV) {
    case 1: return launch_attn<1>(p, B, s);
    case 2: return launch_attn<2>(p, B, s);
    case 3: return launch_attn<3>(p, B, s);
    case 4: return launch_attn<4>(p, B, s);
    case 5: return launch_attn<5>(p, B, s);
    case 6: return launch_attn<6>(p, B, s);
    case 7: return launch_attn<7>(p, B, s);
    case 8: return launch_attn<8>(p, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
