// K8 in f32: flash attention on (B, S, H, 64) q, k, v read through their
// strides.  (bf16, the tower's type on the card, runs in attn_sm90.cu.)
//
// Replaces tstar_tpu/kernels/attention.py:flash_mha, which reaches
// pl.pallas_call through JAX's stock TPU flash_attention.  Per query row:
// f32 logits q.k times sm_scale; keys beyond S masked out; the softmax's exp
// in the natural base; the PV product summed in f32.  In f32 this online
// softmax differs from the reference's single key block by summation order
// only.
//
// The TPU kernel padded S to a multiple of 128 (masking the pads by segment
// ids) and transposed to (B, H, S, D): both were its layout needs.  Here the
// ragged last tile is masked in the kernel, and q/k/v are read through their
// (batch, sequence, head) strides, so the port's views into the fused
// (B, S, 3D) q|k|v projection (row stride 3D) need no copy.  The output is a
// contiguous (B, S, H, 64).
//
// What bounds it on the H100: 4*B*H*S^2*64 f32 operations on the CUDA cores
// (wgmma has no full-f32 form, and TF32 would break the f32 tolerances).  One
// 128-thread block owns (batch, head, 64 query rows); Q stays in shared
// memory, each K/V tile of 64 keys is staged through shared memory, and each
// thread computes a 4x8 block of each tile product.  The logits and PV tiles
// pass through shared memory, where two threads per query row run the online
// softmax; each thread keeps its 32 output columns in registers.  The (S, S)
// matrix never exists.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int DH = 64, BQ = 64, BKV = 64, THREADS = 128;
constexpr int LDT = DH + 8;   // q/k/v/p rows in shared memory (elements); BKV == DH
constexpr int LDS = BKV + 4;  // logits / PV rows

struct Tiles {
  float q[BQ * LDT];
  float k[BKV * LDT];
  float v[BKV * LDT];
  float p[BQ * LDT];
  float s[BQ * LDS];
};

// Rows [r0, r0 + 64) of one head's (S, 64) slice, row stride `stride`
// elements, into a shared tile; rows at or past `n_valid` become zeros.
__device__ void load_rows(float* dst, const float* src, long long stride, int r0, int n_valid) {
  constexpr int V = 4;  // elements per 16-byte vector
  constexpr int VPR = DH / V;
  for (int idx = threadIdx.x; idx < 64 * VPR; idx += THREADS) {
    const int r = idx / VPR, c = (idx % VPR) * V;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < n_valid) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LDT + c) = val;
  }
}

// out (64 x 64, row stride LDS) = a (64 x 64) @ B, where B[k][n] is bm[n][k]
// (TRANS_B, keys as rows: Q K^T) or bm[k][n] (P V).
template <bool TRANS_B>
__device__ void tile_product(const float* a, const float* bm, float* out) {
  const int tr = threadIdx.x / 8, tc = threadIdx.x % 8;  // rows 4*tr.., columns tc + 8*jj
  float acc[4][8] = {};
  for (int k = 0; k < 64; ++k) {
    float av[4], bv[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(tr * 4 + i) * LDT + k];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      bv[jj] = TRANS_B ? bm[(tc + 8 * jj) * LDT + k] : bm[k * LDT + tc + 8 * jj];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) out[(tr * 4 + i) * LDS + tc + 8 * jj] = acc[i][jj];
}

struct Strides {
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh;
};

__global__ void __launch_bounds__(THREADS)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int S, int H,
             const Strides st, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Tiles& sm = *reinterpret_cast<Tiles*>(smem_raw);
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const float* qp = q + b * st.qb + h * st.qh;
  const float* kp = k + b * st.kb + h * st.kh;
  const float* vp = v + b * st.vb + h * st.vh;
  load_rows(sm.q, qp, st.qs, q0, min(BQ, S - q0));

  // Two threads (lanes 2r, 2r+1 of a warp) share query row r of the tile;
  // each owns the columns half + 2i of the logits and of the output.
  const int r = threadIdx.x / 2, half = threadIdx.x % 2;
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int j0 = 0; j0 < S; j0 += BKV) {
    const int n = min(BKV, S - j0);
    __syncthreads();  // the previous tile's readers of k, v, p and s are done
    load_rows(sm.k, kp, st.ks, j0, n);
    load_rows(sm.v, vp, st.vs, j0, n);
    __syncthreads();
    tile_product<true>(sm.q, sm.k, sm.s);
    __syncthreads();

    float sv[BKV / 2];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      const int c = half + 2 * i;
      sv[i] = c < n ? sm.s[r * LDS + c] * scale : -INFINITY;
      mx = fmaxf(mx, sv[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);  // finite: every tile holds a valid key
    const float alpha = expf(m - m_new);
    float rs = 0.f;
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      const float p = expf(sv[i] - m_new);
      rs += p;
      sm.p[r * LDT + half + 2 * i] = p;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    l = rs + alpha * l;
    m = m_new;
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] *= alpha;
    __syncthreads();
    tile_product<false>(sm.p, sm.v, sm.s);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] += sm.s[r * LDS + half + 2 * i];
  }

  if (q0 + r < S) {
    float* op = out + (((size_t)b * S + q0 + r) * H + h) * DH;
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) op[half + 2 * i] = o[i] / l;
  }
}

int launch_flash(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
                 int D, const Strides& st, float scale, void* stream) {
  constexpr int V = 4;  // elements per 16-byte vector
  const long long all[9] = {st.qb, st.qs, st.qh, st.kb, st.ks, st.kh, st.vb, st.vs, st.vh};
  if (D != DH || B < 1 || S < 1 || H < 1 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 9; ++i)
    if (all[i] % V) return (int)cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (ptrs % 16) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Tiles);
  cudaError_t e = cudaFuncSetAttribute(flash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), S, H, st, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v (B, S, H, 64) f32 with element strides (batch, sequence, head) each
// and a unit stride on the last axis; out a contiguous (B, S, H, 64).
extern "C" int tstar_flash_f32(const void* q, const void* k, const void* v, void* out, int B,
                               int S, int H, int D, long long qb, long long qs, long long qh,
                               long long kb, long long ks, long long kh, long long vb,
                               long long vs, long long vh, float scale, void* stream) {
  return launch_flash(q, k, v, out, B, S, H, D,
                      Strides{qb, qs, qh, kb, ks, kh, vb, vs, vh}, scale, stream);
}
