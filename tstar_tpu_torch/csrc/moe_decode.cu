// The mixture-of-experts block of a single-token decode step (DeepSeek-V3's
// layout, as Kimi-VL's language model has it): the chosen routed experts and
// the shared experts, each a SwiGLU MLP, weighted and summed.
//
// Replaces no Pallas kernel: the reference has no MoE model.  It was added
// for the decode step of Kimi-VL-A3B (models/kimi_vl.py), where 1 to 4
// tokens each pick 6 of 64 experts.  Plain PyTorch either gathers the
// chosen experts' weights (a copy of every byte it then reads again) or
// loops over the experts with a host read of who chose what, which a CUDA
// graph cannot capture.
//
// What bounds it on the H100: bytes.  At one token a layer reads 6 routed
// experts and the 2 shared ones, 8 x 3 x 2,048 x 1,408 bf16 = 138.4 MB, about
// 41 us at 3.35 TB/s, against ~0.2 MFLOP of arithmetic a token and expert.
// So each byte of the chosen experts is read once, streamed past L1, by
// enough warps to keep the memory busy, and the tokens (at most 4) share it:
//
//  0. moe_route_kernel: the router before them: the sigmoid scores of the E
//     experts in f32 (a warp a row of the (E, D) gate, 8 CTAs a token at
//     E = 64), then, in the token's last CTA to finish, the top K by score
//     plus the correction bias (one warp, K rounds of a warp argmax; a tie
//     goes to the lower id) and their scores over their sum (+1e-20) times
//     the scaling factor (kernels/moe.py, route): one launch where the plain
//     router takes eleven.  (A first version, one CTA a token, took ~19 us:
//     one SM reading the 256 KB gate.)
//  1. moe_decode_up_kernel: grid (I / 8, B * K + NS): a CTA takes 8 rows j of
//     one candidate's expert, a warp one row: the gate row and the up row
//     (2 x D values) against every token held in shared memory, warp sums in
//     f32, each rounded to bf16 as the plain path's product is, then
//     silu(gate) in f32 rounded, times up, rounded (kernels/moe.py,
//     moe_decode_plain).  A candidate (token b, slot k) whose expert an
//     earlier candidate already chose leaves: that CTA computes the rows for
//     every token that chose the expert, so each expert is read once a step.
//     Candidates B * K .. B * K + NS - 1 are the shared experts' NS slices of
//     I rows.  CTA (0, c) also counts its pair into `counts` and records its
//     expert id into the route log at the step's slot (both optional).
//  2. moe_decode_down_kernel: a CTA per 4 output columns d (2 for several
//     tokens), a warp per task (a distinct chosen expert, or a shared slice
//     of I values): the task's 4 down rows streamed together against the
//     activations of the tokens that chose it, each routed sum rounded to
//     bf16; then, per token and column, the weighted sum of its K experts in
//     f32 (slot order) rounded to bf16, plus the shared experts' sum over
//     NS * I rounded to bf16, rounded once more.  (A first version, a warp a
//     column walking the experts one after another, ran at 55 us a layer
//     against the up kernel's 39 us for twice the bytes: too few loads in
//     flight; 8 columns a CTA, 33.8 us; 4, 23.4 us.)
//
// Weights: w13 (E, 2I, D) = each expert's gate rows then up rows, w2 (E, D, I),
// the shared ones sw13 (2 NS I, D) and sw2 (D, NS I): rows along the reduced
// dimension, so a warp reads a row in 16-byte vectors, lanes on neighbouring
// addresses.  bf16 only, 1 <= B <= 4, 1 <= K <= 8, D and I multiples of 8,
// D <= 4096.  The wrapper raises on anything else.  Each f32 operation that
// torch rounds on its own is written with an _rn intrinsic; only the sums
// run in the kernels' own order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using tstar::warp_sum;

constexpr int MAX_B = 4;
constexpr int MAX_K = 8;
constexpr int MAX_D = 4096;
constexpr int MAX_NS = 4;
constexpr int WARPS = 8;

// Output columns a CTA of the down kernel: 4 for one token, 2 for more (a
// sweep of 2 / 4 / 8 / 16 on the H100: the down launch 26.9 / 23.4 / 33.4 /
// 57.9 us at one token; the pair 207 / 238 / 211 / 300 us at four).
template <int NB>
__host__ __device__ constexpr int rows_for() { return NB == 1 ? 4 : 2; }

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

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

struct MoeParams {
  const bf16* x;              // (B, D) the normed hidden states
  const long long* ids;       // (B, K) chosen experts
  const float* wts;           // (B, K) their weights
  const bf16* w13;            // (E, 2I, D)
  const bf16* w2;             // (E, D, I)
  const bf16* sw13;           // (2 NS I, D)
  const bf16* sw2;            // (D, NS I)
  bf16* act;                  // (B, K + NS, I) scratch
  bf16* out;                  // (B, D)
  int* counts;                // (E,) or null
  long long* route;           // (B, M, K) or null
  const long long* index;     // the step's slot (device), with route
  int B, K, NS, D, I, M;
};

// The slot at which token b chose expert e, or -1.
__device__ __forceinline__ int slot_of(const long long* ids, int b, int K, long long e) {
  int slot = -1;
  for (int k = 0; k < K; ++k)
    if (ids[b * K + k] == e) slot = k;
  return slot;
}

// Whether a candidate before c chose expert e.
__device__ __forceinline__ bool seen_before(const long long* ids, int c, long long e) {
  for (int c2 = 0; c2 < c; ++c2)
    if (ids[c2] == e) return true;
  return false;
}

template <int NB>
__global__ void __launch_bounds__(WARPS * 32) moe_decode_up_kernel(MoeParams p) {
  extern __shared__ uint4 xs[];         // B x D / 8 vectors
  const int c = blockIdx.y, BK = NB * p.K;
  long long e = -1;
  if (c < BK) {
    e = p.ids[c];
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      if (p.counts != nullptr) atomicAdd(p.counts + e, 1);
      if (p.route != nullptr)
        p.route[((long long)(c / p.K) * p.M + *p.index) * p.K + c % p.K] = e;
    }
    if (seen_before(p.ids, c, e)) return;    // uniform over the CTA
  }
  const int d8 = p.D >> 3;
  for (int i = threadIdx.x; i < NB * d8; i += blockDim.x)
    xs[i] = __ldg(reinterpret_cast<const uint4*>(p.x) + i);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * WARPS + warp;
  if (j >= p.I) return;
  const bf16* g_row;
  const bf16* u_row;
  if (c < BK) {
    g_row = p.w13 + ((size_t)e * 2 * p.I + j) * p.D;
    u_row = g_row + (size_t)p.I * p.D;
  } else {
    const size_t js = (size_t)(c - BK) * p.I + j;
    g_row = p.sw13 + js * p.D;
    u_row = p.sw13 + ((size_t)p.NS * p.I + js) * p.D;
  }
  const uint4* gv = reinterpret_cast<const uint4*>(g_row);
  const uint4* uv = reinterpret_cast<const uint4*>(u_row);
  float ag[NB], au[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) ag[b] = au[b] = 0.0f;
#pragma unroll 8
  for (int v = lane; v < d8; v += 32) {
    float g[8], u[8];
    unpack8(__ldcs(gv + v), g);
    unpack8(__ldcs(uv + v), u);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      float xv[8];
      unpack8(xs[b * d8 + v], xv);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        ag[b] = fmaf(g[t], xv[t], ag[b]);
        au[b] = fmaf(u[t], xv[t], au[b]);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    ag[b] = warp_sum(ag[b]);
    au[b] = warp_sum(au[b]);
  }
  if (lane != 0) return;
  const int slots = p.K + p.NS;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int slot = c < BK ? slot_of(p.ids, b, p.K, e) : p.K + (c - BK);
    if (slot < 0) continue;
    // torch: the products rounded to bf16, x / (1 + exp(-x)) in f32 rounded,
    // then the bf16 product
    const float g = round_bf16(ag[b]), u = round_bf16(au[b]);
    const float s = round_bf16(__fdiv_rn(g, __fadd_rn(1.0f, expf(-g))));
    p.act[((size_t)b * slots + slot) * p.I + j] = __float2bfloat16_rn(__fmul_rn(s, u));
  }
}

// A CTA takes ROWS output columns d; its warps take the tasks: each distinct
// chosen expert, then each shared slice of I values.  A warp streams the
// task's ROWS down rows together (ROWS independent 16-byte loads a lane an
// iteration, the tokens' activations loaded once for all of them), sums each
// (token, row) in f32 and leaves it in shared memory: rounded to bf16 for a
// routed expert (its own product), in f32 for a shared slice (the shared
// experts' product runs over all NS * I values, rounded once).
template <int NB>
__global__ void __launch_bounds__(WARPS * 32) moe_decode_down_kernel(MoeParams p) {
  constexpr int ROWS = rows_for<NB>();
  __shared__ float part[NB][MAX_K + MAX_NS][ROWS];
  __shared__ long long task_e[NB * MAX_K];
  __shared__ int n_unique;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int d0 = blockIdx.x * ROWS, BK = NB * p.K, slots = p.K + p.NS, i8 = p.I >> 3;
  if (threadIdx.x == 0) {
    int n = 0;
    for (int c = 0; c < BK; ++c)
      if (!seen_before(p.ids, c, p.ids[c])) task_e[n++] = p.ids[c];
    n_unique = n;
  }
  __syncthreads();
  const int rows = min(ROWS, p.D - d0);
  for (int task = warp; task < n_unique + p.NS; task += WARPS) {
    const bool routed = task < n_unique;
    int slot[NB];
    const bf16* base;
    size_t stride;
    if (routed) {
      const long long e = task_e[task];
#pragma unroll
      for (int b = 0; b < NB; ++b) slot[b] = slot_of(p.ids, b, p.K, e);
      base = p.w2 + ((size_t)e * p.D + d0) * p.I;
      stride = p.I;
    } else {
      const int h = task - n_unique;
#pragma unroll
      for (int b = 0; b < NB; ++b) slot[b] = p.K + h;
      base = p.sw2 + (size_t)d0 * p.NS * p.I + (size_t)h * p.I;
      stride = (size_t)p.NS * p.I;
    }
    float acc[NB][ROWS];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[b][r] = 0.0f;
#pragma unroll 2
    for (int v = lane; v < i8; v += 32) {
      float a[NB][8];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (slot[b] >= 0)
          unpack8(__ldg(reinterpret_cast<const uint4*>(
                            p.act + ((size_t)b * slots + slot[b]) * p.I) + v), a[b]);
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < rows) {
          float w[8];
          unpack8(__ldcs(reinterpret_cast<const uint4*>(base + r * stride) + v), w);
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            if (slot[b] >= 0) {
#pragma unroll
              for (int t = 0; t < 8; ++t) acc[b][r] = fmaf(w[t], a[b][t], acc[b][r]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (slot[b] < 0) continue;        // uniform over the warp
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float sum = warp_sum(acc[b][r]);
        if (lane == 0) part[b][slot[b]][r] = routed ? round_bf16(sum) : sum;
      }
    }
  }
  __syncthreads();
  const int b = threadIdx.x / ROWS, r = threadIdx.x % ROWS;
  if (b >= NB || r >= rows) return;
  // torch: (y.float() * w).sum(slots) rounded to bf16, plus the shared
  // experts' output rounded to bf16, rounded
  float routed = 0.0f, shared = 0.0f;
  for (int k = 0; k < p.K; ++k)
    routed = __fadd_rn(routed, __fmul_rn(part[b][k][r], p.wts[b * p.K + k]));
  for (int h = 0; h < p.NS; ++h) shared += part[b][p.K + h][r];
  p.out[(size_t)b * p.D + d0 + r] =
      __float2bfloat16_rn(__fadd_rn(round_bf16(routed), round_bf16(shared)));
}

constexpr int MAX_E = 256;

// Grid (E / 8, B): a warp a gate row (expert), its sigmoid score and biased
// score left in `scratch`; the token's last CTA to finish (a ticket counter,
// reset by that CTA for the next launch) chooses its top K.
__global__ void __launch_bounds__(WARPS * 32)
    moe_route_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gate,
                     const bf16* __restrict__ bias, long long* __restrict__ ids,
                     float* __restrict__ wts, float* scratch, int* tickets, int D, int E, int K,
                     float scale) {
  __shared__ uint4 xs[MAX_D / 8];
  __shared__ bool last;
  const int b = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31, d8 = D >> 3;
  float* score = scratch + (size_t)b * 2 * E;
  float* biased = score + E;
  for (int i = threadIdx.x; i < d8; i += blockDim.x)
    xs[i] = __ldg(reinterpret_cast<const uint4*>(x + (size_t)b * D) + i);
  __syncthreads();
  const int e = blockIdx.x * WARPS + warp;
  if (e < E) {
    const uint4* row = reinterpret_cast<const uint4*>(gate + (size_t)e * D);
    float acc = 0.0f;
#pragma unroll 8
    for (int v = lane; v < d8; v += 32) {
      float w[8], xv[8];
      unpack8(__ldg(row + v), w);
      unpack8(xs[v], xv);
#pragma unroll
      for (int t = 0; t < 8; ++t) acc = fmaf(w[t], xv[t], acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      const float sc = 1.0f / (1.0f + expf(-acc));
      score[e] = sc;
      biased[e] = sc + __bfloat162float(bias[e]);
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + b, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last || warp != 0) return;
  if (lane == 0) tickets[b] = 0;
  // each lane holds its E / 32 biased scores in registers for the K rounds
  constexpr int PER_LANE = MAX_E / 32;
  float mine[PER_LANE];
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int i = lane + 32 * j;
    mine[j] = i < E ? __ldcg(biased + i) : -INFINITY;
  }
  long long idx[MAX_K];
  for (int k = 0; k < K; ++k) {
    float best = -INFINITY;
    int at = E;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      if (mine[j] > best) best = mine[j], at = lane + 32 * j;    // ascending ids: a tie keeps the lower
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oa = __shfl_xor_sync(0xffffffffu, at, o);
      if (ob > best || (ob == best && oa < at)) best = ob, at = oa;
    }
    idx[k] = at;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j)
      if (lane + 32 * j == at) mine[j] = -INFINITY;
  }
  if (lane != 0) return;
  float sum = 0.0f, chosen[MAX_K];
  for (int k = 0; k < K; ++k) {
    chosen[k] = __ldcg(score + idx[k]);
    sum += chosen[k];
  }
  const float denom = sum + 1e-20f;
  for (int k = 0; k < K; ++k) {
    ids[(size_t)b * K + k] = idx[k];
    wts[(size_t)b * K + k] = chosen[k] / denom * scale;
  }
}

template <int NB>
int launch(const MoeParams& p, cudaStream_t s) {
  const size_t smem = (size_t)NB * p.D * sizeof(bf16);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_decode_up_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  moe_decode_up_kernel<NB>
      <<<dim3((p.I + WARPS - 1) / WARPS, NB * p.K + p.NS), WARPS * 32, smem, s>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moe_decode_down_kernel<NB><<<(p.D + rows_for<NB>() - 1) / rows_for<NB>(), WARPS * 32, 0, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, D), ids (B, K) int64, wts (B, K) f32, w13 (E, 2I, D), w2 (E, D, I),
// sw13 (2 NS I, D), sw2 (D, NS I), act scratch (B, K + NS, I), out (B, D);
// counts (E,) int32 or null; route (B, M, K) int64 and index (int64, on the
// device) or null.  Two launches: the gate|up rows, then the down rows.
extern "C" int tstar_moe_decode(const void* x, const void* ids, const void* wts, const void* w13,
                                const void* w2, const void* sw13, const void* sw2, void* act,
                                void* out, void* counts, void* route, const void* index, int B,
                                int K, int NS, int D, int I, int M, void* stream) {
  if (B < 1 || B > MAX_B || K < 1 || K > MAX_K || NS < 1 || NS > MAX_NS || D < 8 || D % 8 ||
      D > MAX_D ||
      I < 8 || I % 8 || (route != nullptr && (index == nullptr || M < 1)))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w13) || !aligned16(w2) || !aligned16(sw13) ||
      !aligned16(sw2) || !aligned16(act) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  MoeParams p{static_cast<const bf16*>(x),      static_cast<const long long*>(ids),
              static_cast<const float*>(wts),   static_cast<const bf16*>(w13),
              static_cast<const bf16*>(w2),     static_cast<const bf16*>(sw13),
              static_cast<const bf16*>(sw2),    static_cast<bf16*>(act),
              static_cast<bf16*>(out),          static_cast<int*>(counts),
              static_cast<long long*>(route),   static_cast<const long long*>(index),
              B, K, NS, D, I, M};
  switch (B) {
    case 1: return launch<1>(p, (cudaStream_t)stream);
    case 2: return launch<2>(p, (cudaStream_t)stream);
    case 3: return launch<3>(p, (cudaStream_t)stream);
    default: return launch<4>(p, (cudaStream_t)stream);
  }
}

// x (B, D), gate (E, D), bias (E,) bf16 -> ids (B, K) int64, wts (B, K) f32;
// scratch (B, 2E) f32; tickets (B,) int32, zero before the first launch and
// left zero by every launch.
extern "C" int tstar_moe_route(const void* x, const void* gate, const void* bias, void* ids,
                               void* wts, void* scratch, void* tickets, int B, int D, int E,
                               int K, float scale, void* stream) {
  if (B < 1 || D < 8 || D % 8 || D > MAX_D || E < 1 || E > MAX_E || K < 1 || K > MAX_K ||
      K > E || !aligned16(x) || !aligned16(gate))
    return (int)cudaErrorInvalidValue;
  moe_route_kernel<<<dim3((E + WARPS - 1) / WARPS, B), WARPS * 32, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(gate),
      static_cast<const bf16*>(bias), static_cast<long long*>(ids), static_cast<float*>(wts),
      static_cast<float*>(scratch), static_cast<int*>(tickets), D, E, K, scale);
  return (int)cudaGetLastError();
}
