// Greedy NMS over score-sorted boxes, a batch of images at once.
//
// Replaces tstar_tpu/ops/nms.py:nms (:33), which is no Pallas kernel: a
// lax.fori_loop over all N candidates that suppresses through a dense (N, N)
// f32 IoU matrix, which XLA keeps on the TPU.  Its function, for one image:
// with the boxes in a stable descending score order (`order`, made by the
// caller), candidate i stays alive unless an earlier alive candidate j < i
// has IoU(j, i) > thr; the first `max_out` alive candidates, in order, fill
// the output slots (keep = their original index, valid = 1), the rest of the
// slots hold index 0 and valid = 0.
//
// Design.  Two launches on the caller's stream.
//  (a) nms_mask_kernel: one CTA of 64 threads per (64-row block, 64-column
//      block) of the upper triangle of an image's sorted boxes; thread r
//      writes the 64-bit word of row r: bit c set when column c lies after r
//      and IoU(r, c) > thr.  At N = 8,400 that is 132 words a row, 8.9 MB an
//      image instead of the reference's 282 MB f32 matrix.  Blocks below the
//      diagonal exit at once and their words are never read.
//  (b) nms_scan_kernel: one warp per image walks the rows in score order
//      with the removed set as a bitmask in shared memory, jumping over whole
//      64-row words that are removed.  Each row still alive is a survivor:
//      it takes the next slot and ORs its mask words (from its own word on)
//      into the removed set.  Suppression only reaches later rows, so once
//      `max_out` survivors have their slots no later row can change the
//      output, and the scan stops there.
//
// Exactness.  The kept set changes discontinuously at the threshold, so the
// IoU rounds as the plain version's f32 tensor ops do, one operation at a
// time: every product, sum, difference and the division are __fmul_rn /
// __fadd_rn / __fsub_rn / __fdiv_rn, which the compiler may not contract into
// fused multiply-adds.
//
// What bounds it on the H100: not the bytes (an image's 134 KB of boxes and
// its 8.9 MB of mask words: ~3 us at 3.35 TB/s) nor the IoUs (35 M at N =
// 8,400, a few f32 operations each), but the scan's chain: each survivor
// waits for its mask words to come from L2 before the next row can be
// tested, ~1 us a survivor, and the images of a batch scan side by side.
#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 64;  // rows (and columns) a mask word covers

struct Box {
  float x0, y0, x1, y1, area;
};

__device__ __forceinline__ Box load_box(const float* boxes, long long idx) {
  const float4 v = reinterpret_cast<const float4*>(boxes)[idx];
  Box b{v.x, v.y, v.z, v.w, 0.f};
  // area = clip(x1 - x0, 0) * clip(y1 - y0, 0)
  b.area = __fmul_rn(fmaxf(__fsub_rn(v.z, v.x), 0.f), fmaxf(__fsub_rn(v.w, v.y), 0.f));
  return b;
}

// The plain version's f32 IoU, operation for operation.
__device__ __forceinline__ float iou(const Box& a, const Box& b) {
  const float w = fmaxf(__fsub_rn(fminf(a.x1, b.x1), fmaxf(a.x0, b.x0)), 0.f);
  const float h = fmaxf(__fsub_rn(fminf(a.y1, b.y1), fmaxf(a.y0, b.y0)), 0.f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(a.area, b.area), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-9f));
}

__global__ void __launch_bounds__(BLOCK)
nms_mask_kernel(const float* __restrict__ boxes, const int64_t* __restrict__ order, float thr,
                int n, int words, unsigned long long* __restrict__ mask) {
  const int col_block = blockIdx.x, row_block = blockIdx.y, b = blockIdx.z;
  if (col_block < row_block) return;
  __shared__ Box cols[BLOCK];
  const long long base = (long long)b * n;
  const int t = threadIdx.x;
  const int c = col_block * BLOCK + t;
  if (c < n) cols[t] = load_box(boxes, base + order[base + c]);
  __syncthreads();
  const int r = row_block * BLOCK + t;
  if (r >= n) return;
  const Box me = load_box(boxes, base + order[base + r]);
  const int n_cols = min(BLOCK, n - col_block * BLOCK);
  const int first = col_block == row_block ? t + 1 : 0;   // only columns after r
  unsigned long long bits = 0;
  for (int j = first; j < n_cols; ++j)
    if (iou(me, cols[j]) > thr) bits |= 1ull << j;
  mask[(base + r) * words + col_block] = bits;
}

__global__ void __launch_bounds__(32)
nms_scan_kernel(const int64_t* __restrict__ order, const unsigned long long* __restrict__ mask,
                int n, int words, int max_out, int32_t* __restrict__ keep,
                uint8_t* __restrict__ valid) {
  extern __shared__ unsigned long long removed[];
  const int b = blockIdx.x, lane = threadIdx.x;
  const long long base = (long long)b * n;
  for (int w = lane; w < words; w += 32) {
    const int tail = n - w * BLOCK;   // rows past n count as removed
    removed[w] = tail >= BLOCK ? 0ull : ~0ull << tail;
  }
  __syncwarp();
  int32_t* out = keep + (long long)b * max_out;
  int count = 0, i = 0;
  while (count < max_out) {
    const int w = i >> 6;
    if (w >= words) break;
    const unsigned long long alive = ~removed[w] & (~0ull << (i & 63));
    if (!alive) {
      i = (w + 1) * BLOCK;
      continue;
    }
    i = w * BLOCK + __ffsll((long long)alive) - 1;
    if (lane == 0) out[count] = (int32_t)order[base + i];
    ++count;
    const unsigned long long* row = mask + (base + i) * words;
    for (int v0 = w; v0 < words; v0 += 32 * 4) {
      unsigned long long m[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int v = v0 + u * 32 + lane;
        m[u] = v < words ? row[v] : 0ull;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int v = v0 + u * 32 + lane;
        if (v < words) removed[v] |= m[u];
      }
    }
    __syncwarp();
    ++i;
  }
  for (int s = lane; s < max_out; s += 32) {
    if (s >= count) out[s] = 0;
    valid[(long long)b * max_out + s] = s < count;
  }
}

}  // namespace

// boxes (B, N, 4) f32 xyxy in original order; order (B, N) int64, each row a
// stable descending score order; mask: scratch of B * N * ceil(N / 64)
// 64-bit words; keep (B, max_out) int32, valid (B, max_out) bool.
extern "C" int tstar_nms(const void* boxes, const void* order, float thr, int B, int N,
                         int max_out, void* mask, void* keep, void* valid, void* stream) {
  if (B < 1 || N < 1 || max_out < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(boxes) % 16) return (int)cudaErrorInvalidValue;
  const int words = (N + BLOCK - 1) / BLOCK;
  if (words > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)words * sizeof(unsigned long long);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* bx = static_cast<const float*>(boxes);
  const auto* ord = static_cast<const int64_t*>(order);
  auto* m = static_cast<unsigned long long*>(mask);
  nms_mask_kernel<<<dim3(words, words, B), BLOCK, 0, s>>>(bx, ord, thr, N, words, m);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  nms_scan_kernel<<<B, 32, smem, s>>>(ord, m, N, words, max_out, static_cast<int32_t*>(keep),
                                      static_cast<uint8_t*>(valid));
  return (int)cudaGetLastError();
}
