// K1 in f32: multi-head self-attention read straight from the fused q|k|v
// projection.  (bf16, the tower's type on the card, runs in attn_sm90.cu.)
//
// Replaces tstar_tpu/kernels/attention.py:_mha_kernel (via _mha_pallas and
// fused_mha_from_qkv).  Input (B, S, 3D): head h's q/k/v are the 64-wide
// column slices at h*64, D + h*64 and 2D + h*64 (row stride 3D).  Output
// (B, S, D) head-major, ready for out_proj.
//
// Math, as the TPU kernel does it: logits in f32, scaled by scale*log2(e);
// exact two-pass softmax (row max, exp2, f32 row sum); the AV product
// accumulates in f32; the divide by the row sum comes after AV.
//
// What bounds it on the H100: 4*B*H*S^2*64 f32 operations on the CUDA cores
// (wgmma has no full-f32 form and TF32 would break the f32 tolerances).  One
// block owns (batch, head, 64 q rows); the head's K and V stay resident in
// dynamic shared memory when they fit (rows padded to 66 elements so lanes
// reading different rows hit different banks), else they stream through it
// in 32-row tiles; each warp owns one q row at a time with its logits row (S
// floats) in shared memory, so the S x S tile never exists anywhere.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int DH = 64;              // head width
constexpr int NWARPS = 8;
constexpr int LDK = DH + 2;         // padded shared-memory row, in elements
constexpr int ROWS_PER_BLOCK = 64;  // q rows per block

// Stage rows [j0, j0 + n) of one head's K or V columns into shared memory.
__device__ void stage_rows(float* dst, const float* col0, int row_stride, int j0, int n) {
  for (int idx = threadIdx.x; idx < n * (DH / 2); idx += blockDim.x) {
    const int r = idx / (DH / 2), c = idx % (DH / 2);
    *reinterpret_cast<float2*>(dst + r * LDK + 2 * c) =
        *reinterpret_cast<const float2*>(col0 + (size_t)(j0 + r) * row_stride + 2 * c);
  }
}

__global__ void __launch_bounds__(NWARPS * 32)
mha_kernel(const float* __restrict__ qkv, float* __restrict__ out, int S, int D,
           float scale_log2e, int tk) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + (size_t)tk * LDK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* logits = reinterpret_cast<float*>(vs + (size_t)tk * LDK) + (size_t)warp * S;

  const int h = blockIdx.y, b = blockIdx.z;
  const int row_stride = 3 * D;
  const float* base = qkv + (size_t)b * S * row_stride;
  const float* qcol = base + h * DH;
  const float* kcol = base + D + h * DH;
  const float* vcol = base + 2 * D + h * DH;
  const int q0 = blockIdx.x * ROWS_PER_BLOCK;
  const int q_end = min(q0 + ROWS_PER_BLOCK, S);
  const bool resident = tk >= S;

  if (resident) {
    stage_rows(ks, kcol, row_stride, 0, S);
    stage_rows(vs, vcol, row_stride, 0, S);
    __syncthreads();
  }

  for (int r0 = q0; r0 < q_end; r0 += NWARPS) {
    const int row = r0 + warp;
    const bool active = row < q_end;
    float q[DH];
    if (active) {
#pragma unroll
      for (int c = 0; c < DH / 2; ++c) {
        const float2 f = *reinterpret_cast<const float2*>(qcol + (size_t)row * row_stride + 2 * c);
        q[2 * c] = f.x;
        q[2 * c + 1] = f.y;
      }
    }

    // Pass 1: logits (log2 domain) into this warp's row buffer, and the max.
    float m = -INFINITY;
    for (int j0 = 0; j0 < S; j0 += tk) {
      const int n = min(tk, S - j0);
      if (!resident) {
        __syncthreads();
        stage_rows(ks, kcol, row_stride, j0, n);
        __syncthreads();
      }
      if (active) {
        for (int j = lane; j < n; j += 32) {
          const float2* krow = reinterpret_cast<const float2*>(ks + j * LDK);
          float s = 0.f;
#pragma unroll
          for (int c = 0; c < DH / 2; ++c) {
            const float2 kf = krow[c];
            s = fmaf(q[2 * c], kf.x, s);
            s = fmaf(q[2 * c + 1], kf.y, s);
          }
          s *= scale_log2e;
          logits[j0 + j] = s;
          m = fmaxf(m, s);
        }
      }
    }
    m = tstar::warp_max(m);
    __syncwarp();

    // Pass 2: unnormalized probs and their f32 sum.
    float ssum = 0.f;
    if (active) {
      for (int j = lane; j < S; j += 32) {
        const float p = exp2f(logits[j] - m);
        ssum += p;
        logits[j] = p;
      }
    }
    ssum = tstar::warp_sum(ssum);
    __syncwarp();

    // Pass 3: AV with f32 accumulation; lane owns output columns 2*lane, +1.
    float acc0 = 0.f, acc1 = 0.f;
    for (int j0 = 0; j0 < S; j0 += tk) {
      const int n = min(tk, S - j0);
      if (!resident) {
        __syncthreads();
        stage_rows(vs, vcol, row_stride, j0, n);
        __syncthreads();
      }
      if (active) {
        const float* pr = logits + j0;
        for (int j = 0; j < n; ++j) {
          const float2 vf = *reinterpret_cast<const float2*>(vs + j * LDK + 2 * lane);
          acc0 = fmaf(pr[j], vf.x, acc0);
          acc1 = fmaf(pr[j], vf.y, acc1);
        }
      }
    }
    if (active) {
      *reinterpret_cast<float2*>(out + ((size_t)b * S + row) * D + h * DH + 2 * lane) =
          make_float2(acc0 / ssum, acc1 / ssum);
    }
  }
}

int launch_mha(const void* qkv, void* out, int B, int S, int D, int H,
               float scale_log2e, void* stream) {
  if (D != H * DH || S < 1 || B < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const size_t logits_bytes = (size_t)NWARPS * S * sizeof(float);
  const size_t row_bytes = 2 * LDK * sizeof(float);  // one K row + one V row
  if (logits_bytes + 32 * row_bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  int tk = (int)(((size_t)optin - logits_bytes) / row_bytes);
  tk = tk >= S ? S : (tk / 32) * 32;  // whole head resident, else 32-row tiles
  const size_t smem = (size_t)tk * row_bytes + logits_bytes;
  e = cudaFuncSetAttribute(mha_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, H, B);
  mha_kernel<<<grid, NWARPS * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), S, D, scale_log2e, tk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tstar_mha_f32(const void* qkv, void* out, int B, int S, int D, int H,
                             float scale_log2e, void* stream) {
  return launch_mha(qkv, out, B, S, D, H, scale_log2e, stream);
}

extern "C" const char* tstar_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
