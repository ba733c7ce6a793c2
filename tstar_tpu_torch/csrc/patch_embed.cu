// K2: stride-p patchify fused into the patch-embedding GEMM.
//
// Replaces tstar_tpu/kernels/patch_matmul.py:_patch_kernel (via _patch_pallas,
// the pallas_call at :76, and patch_embed_matmul).  Computes
//   out[b, i*npw + j, d] = sum_{ph, pw, c} px[b, p*i+ph, p*j+pw, c] * W[ph, pw, c, d]
// from NHWC pixels and an HWIO kernel, with f32 accumulation rounded once,
// and never materializes the patchified (B*P, p*p*C) matrix.  (The TPU
// kernel padded C to 4 only to fill its 128 lanes; nothing here needs that.)
//
// It is an implicit GEMM with M = B*P, N = D, K = p*p*C.  For row m = (b, i, j)
// and column k = (ph, pw, c) in the HWIO flattening order, A[m, k] lies at
//   ((b*H + i*p + ph) * W + j*p) * C + (pw*C + c)
// because (pw, c) is one contiguous run of p*C elements in an NHWC row.
//
// What bounds it on the H100: at the main path's shapes (M = 576 per 768^2
// image, 256 per 512^2 image, K = 3072, N = 768) it is a GEMM of 2.7 GFLOP
// per 768^2 image (2.7 us at 989 TFLOP/s) against 8.3 MB of pixels, weights
// and output at one image (2.5 us at 3.35 TB/s): compute-bound from one
// image up.  In practice the operand tiles each CTA streams from L2 set the
// pace (measured ~40 GB/s an SM through TMA, ~5 TB/s over the card), so the
// design keeps the tiles wide and the stages deep.
//
// Design (bf16, p*C a multiple of 16).  Seen as the 4-d tensor
// (B*H/p, p, W/p, p*C) -- patch rows, ph, patch columns, the (pw, c) run --
// the pixels of 16 patch rows x 8 patch columns at one ph and PK values of
// the run are one TMA box: 128 lines of 2 PK bytes, the K-major layout of a
// 128-row A tile (swizzled as wide as its line: 64 bytes at PK = 32, the
// main path's 96-value runs; 32 bytes at PK = 16, runs such as patch-16
// RGB's 48; its rows ordered patch row, then patch column).  A K chunk is
// such a box and the matching PK rows of W (K, N), read as stored through
// 64-column boxes with the 128-byte swizzle: the MN-major B operand, with
// wgmma's transpose flag, so no W^T copy exists.  A CTA owns 16 x 8 patches
// and NB output columns, a stage KC chunks; one producer warp keeps up to 12
// stages in flight in a ring (one "full" mbarrier each, TMA's byte count),
// two consumer warpgroups of 64 rows each run KC PK / 16 wgmma.m64n{NB}k16
// per stage with f32 accumulators and release the stage on its "empty"
// mbarrier once the next stage's products are issued.  NB is the widest of
// 256 / 128 whose CTAs cover two thirds of the SMs, else 64 (one 768^2
// image: 72 CTAs of 64 columns); a stage holds 64 K values at 256 columns,
// else 128 (sm90_configure, from device times on an H100).  The epilogue
// rounds the accumulators to bf16 and stores them from registers; patches
// outside the image batch (the box's zero-filled edges) are not stored.
// Every mbarrier wait traps after ~2^26 polls.
//
// f32, and bf16 shapes outside that layout (p*C not a multiple of 16),
// take a CUDA-core version (64x64 outputs per block, 4x4 per thread, FMA
// through shared-memory tiles of depth 16), correct for any p, C and D.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
patch_embed_kernel(const T* __restrict__ px, const T* __restrict__ w, T* __restrict__ out,
                   int H, int W, int C, int p, int D, int M, int K, int npw, int P) {
  __shared__ __align__(16) float as[BK][BM + 4];
  __shared__ __align__(16) float bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int pc = p * C;
  const size_t row_elems = (size_t)W * C;

  // This thread loads A elements idx = tid + i*THREADS: row idx / BK, column idx % BK.
  size_t a_base[4];
  bool a_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = tid + i * THREADS;
    const int m = m0 + idx / BK;
    a_ok[i] = m < M;
    const int mm = a_ok[i] ? m : 0;
    const int bi = mm / P, pi = mm % P;
    const int pr = pi / npw, pcol = pi % npw;
    a_base[i] = (((size_t)bi * H + (size_t)pr * p) * W + (size_t)pcol * p) * C;
  }

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * THREADS;
      const int kk = idx % BK, r = idx / BK;
      const int k = k0 + kk;
      float v = 0.f;
      if (a_ok[i] && k < K) {
        const int ph = k / pc;
        v = tstar::to_float(px[a_base[i] + (size_t)ph * row_elems + (k - ph * pc)]);
      }
      as[kk][r] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * THREADS;
      const int kk = idx / BN, n = idx % BN;
      const int k = k0 + kk;
      float v = 0.f;
      if (k < K && n0 + n < D) v = tstar::to_float(w[(size_t)k * D + n0 + n]);
      bs[kk][n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + ty * 4 + r;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx * 4 + c;
      if (n < D) out[(size_t)m * D + n] = tstar::from_float<T>(acc[r][c]);
    }
  }
}

// The wgmma kernel's tile: 16 patch rows x 8 patch columns (128 A rows, two
// warpgroups of 64) x NB output columns.  A K chunk is one A box of PK values
// of a (pw, c) run (32: one 64-byte line; 16: one 32-byte line, for runs such
// as patch-16 RGB's 48) and the matching PK rows of W; a stage holds KC
// chunks, 64 K values at 256 columns and 128 at 64 or 128, so a stage's bytes
// do not depend on PK.
constexpr int TI = 16, TJ = 8;
constexpr int CONSUMERS = 2;
constexpr int SM90_THREADS = CONSUMERS * 128 + 32;  // + the producer warp
constexpr int MAX_STAGES = 12;

template <int NB, int PK>
struct Tile {
  static constexpr int KC = (NB == 256 ? 64 : 128) / PK;  // chunks a stage
  static constexpr int A_BYTES = TI * TJ * PK * 2;          // one A box
  static constexpr int ATOM = KC * PK * 64 * 2;             // one 64-column W box of a stage
  static constexpr int STAGE = KC * A_BYTES + (NB / 64) * ATOM;
};

constexpr int stage_bytes(int nb, int pk) {
  return (nb == 256 ? 64 : 128) / pk * (TI * TJ * pk * 2 + (nb / 64) * pk * 128);
}

struct Sm90Params {
  int I, npw, D;     // I = B * H / p patch rows over the batch
  int segs, nk;      // PK-value segments of a (pw, c) run; stages of KC chunks
  int stages;
};

template <int NB, int PK>
__global__ void __launch_bounds__(SM90_THREADS, 1)
patch_embed_sm90_kernel(const __grid_constant__ CUtensorMap amap,
                        const __grid_constant__ CUtensorMap bmap,
                        __nv_bfloat16* __restrict__ out, const Sm90Params p) {
  using namespace tstar::sm90;
  using T = Tile<NB, PK>;
  constexpr int KC = T::KC, A_BYTES = T::A_BYTES, ATOM = T::ATOM, STAGE = T::STAGE;
  constexpr int STEPS = PK / 16;                  // wgmma k-steps a chunk
  constexpr Swizzle ASW = PK == 32 ? SW64 : SW32;  // an A line is PK values
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles on 1024-byte lines
  const uint32_t ring = base;                    // [stages][KC A boxes | NB/64 W boxes]
  const uint32_t full = ring + p.stages * STAGE; // [stages] mbarriers
  const uint32_t empty = full + 8 * p.stages;    // [stages]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * NB, j0 = blockIdx.y * TJ, i0 = blockIdx.z * TI;

  if (warp == 2 * 4) {  // the producer warp
    if (lane == 0) {
      for (int st = 0; st < p.stages; ++st) {
        mbar_init(full + 8 * st, 1);
        mbar_init(empty + 8 * st, CONSUMERS);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      prefetch_map(&amap);
      prefetch_map(&bmap);
    }
  }
  __syncthreads();
  if (warp == 2 * 4) {
    // Chunk q = u KC + c: ph = q / segs, segment q % segs.  Chunks past the
    // last (when KC does not divide p * segs) lie past ph = p - 1 and past
    // W's last row: TMA fills both with zeros, which add nothing.
    if (lane == 0)
      for (int u = 0; u < p.nk; ++u) {
        const int st = u % p.stages;
        if (u >= p.stages) mbar_wait(empty + 8 * st, ((u / p.stages) + 1) & 1);
        const uint32_t bar = full + 8 * st, dst = ring + st * STAGE;
        mbar_expect_tx(bar, STAGE);
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const int q = u * KC + c;
          tma_load_4d(dst + c * A_BYTES, &amap, bar, (q % p.segs) * PK, j0, q / p.segs, i0);
        }
#pragma unroll
        for (int h = 0; h < NB / 64; ++h)
          tma_load_2d(dst + KC * A_BYTES + h * ATOM, &bmap, bar, n0 + 64 * h, u * KC * PK);
      }
    return;
  }

  // Warpgroup wg: A rows 64 wg .. 64 wg + 63 (patch rows 8 wg .. 8 wg + 7 of
  // the tile), all NB columns; k-step kk reads the 32-byte part kk % STEPS
  // of box kk / STEPS.
  const int wg = warp / 4, t = tid % 128;
  float acc[NB / 2];
#pragma unroll
  for (int i = 0; i < NB / 2; ++i) acc[i] = 0.f;
  for (int u = 0; u < p.nk; ++u) {
    const int st = u % p.stages;
    mbar_wait(full + 8 * st, (u / p.stages) & 1);
    fence_regs(acc);
    wg_fence();
    const uint32_t a = ring + st * STAGE + wg * (A_BYTES / 2), bw = ring + st * STAGE + KC * A_BYTES;
#pragma unroll
    for (int kk = 0; kk < KC * STEPS; ++kk)
      wgmma_bf16(acc, desc(a + (kk / STEPS) * A_BYTES + 32 * (kk % STEPS), 16, 16 * PK, ASW),
                 desc(bw + 2048 * kk, ATOM, 1024, SW128), u | kk);
    wg_commit();
    if (u > 0) {
      wg_wait<1>();  // stage u - 1's products done: release it
      if (t == 0) mbar_arrive(empty + 8 * ((u - 1) % p.stages));
    }
  }
  wg_wait<0>();
  fence_regs(acc);

  // Epilogue: register 4k + 2i + e holds A row 16(t/32) + (t%32)/4 + 8i of
  // the warpgroup (patch row 8 wg + that / 8, patch column that % 8 of the
  // tile), column n0 + 8k + 2(t%4) + e.
  const int r = 16 * (t / 32) + (t % 32) / 4;
  const int jj = j0 + r % 8;
  const int col = n0 + 2 * (t % 4);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int ii = i0 + 8 * wg + r / 8 + i;
    if (ii >= p.I || jj >= p.npw) continue;
    __nv_bfloat16* orow = out + ((size_t)ii * p.npw + jj) * p.D;
#pragma unroll
    for (int k = 0; k < NB / 8; ++k)
      if (col + 8 * k < p.D)
        *reinterpret_cast<uint32_t*>(orow + col + 8 * k) =
            pack_bf16(acc[4 * k + 2 * i], acc[4 * k + 2 * i + 1]);
  }
}

struct Sm90Config {
  int nb, pk, kc, stages, smem;
  dim3 grid;
};

bool sm90_shape_ok(int H, int W, int C, int p, int D) {
  return (p * C) % 16 == 0 && ((long long)W * C) % 8 == 0 && D % 8 == 0 && H / p >= 1;
}

// The tile, from device times at the main path's shapes on an H100
// (tools/kernel_bench.py): the kernel is bound by the operand bytes its CTAs
// stream from L2 (~40 GB/s an SM), so the widest N tile whose CTAs still
// cover two thirds of the SMs, else 64 columns (one 768^2 image: 72 CTAs);
// 128 K values a stage, 64 at 256 columns (whose stages are twice as large);
// segments of 32 values where the (pw, c) run is a multiple of 32, else 16;
// as many stages as fit, up to 12.
int sm90_configure(int B, int H, int W, int C, int p, int D, Sm90Config* c) {
  using namespace tstar::sm90;
  DeviceInfo d;
  int dev = 0;
  const int e = device_info(&d, &dev);
  if (e) return e;
  const long long I = (long long)B * (H / p);
  const int npw = W / p;
  const long long ti = (I + TI - 1) / TI, tj = (npw + TJ - 1) / TJ;
  if (ti > 65535 || tj > 65535) return (int)cudaErrorInvalidValue;
  c->nb = 64;
  const int widths[2] = {256, 128};
  for (int nb : widths)
    if (3 * ti * tj * ((D + nb - 1) / nb) >= 2 * d.sms) {
      c->nb = nb;
      break;
    }
  c->pk = (p * C) % 32 == 0 ? 32 : 16;
  c->kc = (c->nb == 256 ? 64 : 128) / c->pk;
  const int stage = stage_bytes(c->nb, c->pk);
  c->stages = 0;
  while (c->stages < MAX_STAGES && 1024 + (c->stages + 1) * (stage + 16) <= d.optin) ++c->stages;
  if (c->stages < 2) return (int)cudaErrorInvalidValue;
  c->smem = 1024 + c->stages * (stage + 16);
  c->grid = dim3((D + c->nb - 1) / c->nb, (unsigned)tj, (unsigned)ti);
  return 0;
}

bool sm90_opted_in[3][2][tstar::sm90::MAX_DEVICES];

template <int NB, int PK>
int launch_tile(const CUtensorMap& amap, const CUtensorMap& bmap, void* out,
                const Sm90Config& c, const Sm90Params& p, void* stream) {
  using namespace tstar::sm90;
  static_assert(stage_bytes(NB, PK) == Tile<NB, PK>::STAGE, "one stage size on both sides");
  DeviceInfo d;
  int dev = 0;
  int e = device_info(&d, &dev);
  if (e) return e;
  e = opt_in(reinterpret_cast<const void*>(patch_embed_sm90_kernel<NB, PK>), dev, d.optin,
             sm90_opted_in[NB / 128][PK / 32]);
  if (e) return e;
  patch_embed_sm90_kernel<NB, PK><<<c.grid, SM90_THREADS, c.smem, (cudaStream_t)stream>>>(
      amap, bmap, static_cast<__nv_bfloat16*>(out), p);
  return (int)cudaGetLastError();
}

template <int PK>
int launch_pk(const CUtensorMap& amap, const CUtensorMap& bmap, void* out,
              const Sm90Config& c, const Sm90Params& p, void* stream) {
  switch (c.nb) {
    case 64: return launch_tile<64, PK>(amap, bmap, out, c, p, stream);
    case 128: return launch_tile<128, PK>(amap, bmap, out, c, p, stream);
    case 256: return launch_tile<256, PK>(amap, bmap, out, c, p, stream);
  }
  return (int)cudaErrorInvalidValue;
}

int launch_sm90(const void* px, const void* w, void* out, int B, int H, int W, int C, int p,
                int D, void* stream) {
  Sm90Config c;
  int e = sm90_configure(B, H, W, C, p, D, &c);
  if (e) return e;
  const int npw = W / p, pc = p * C;
  // The pixels as (I, p, npw, p*C), innermost first; box {PK, TJ, 1, TI},
  // one PK-value line a row, swizzled as wide as the line.
  CUtensorMap amap, bmap;
  cuuint64_t dims[4] = {(cuuint64_t)pc, (cuuint64_t)npw, (cuuint64_t)p,
                        (cuuint64_t)B * (H / p)};
  cuuint64_t strides[3] = {(cuuint64_t)pc * 2, (cuuint64_t)W * C * 2, (cuuint64_t)p * W * C * 2};
  cuuint32_t box[4] = {(cuuint32_t)c.pk, TJ, 1, TI};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      &amap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(px), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      c.pk == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  // W (K, D): boxes of one stage's K rows x 64 columns
  e = tstar::sm90::map_bf16_2d(&bmap, w, (long long)p * pc, D, c.kc * c.pk);
  if (e) return e;
  const int segs = pc / c.pk, chunks = p * segs;
  const Sm90Params prm{B * (H / p), npw, D, segs, (chunks + c.kc - 1) / c.kc, c.stages};
  return c.pk == 32 ? launch_pk<32>(amap, bmap, out, c, prm, stream)
                    : launch_pk<16>(amap, bmap, out, c, prm, stream);
}

template <typename T>
int launch_patch_embed(const void* px, const void* w, void* out, int B, int H, int W,
                       int C, int p, int D, void* stream) {
  if (B < 1 || p < 1 || H % p || W % p || C < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const int npw = W / p, P = (H / p) * npw;
  const long long M = (long long)B * P;
  const int K = p * p * C;
  const bool aligned = (reinterpret_cast<uintptr_t>(px) | reinterpret_cast<uintptr_t>(w) |
                        reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (std::is_same<T, __nv_bfloat16>::value && aligned && sm90_shape_ok(H, W, C, p, D))
    return launch_sm90(px, w, out, B, H, W, C, p, D, stream);
  if (M > (long long)65535 * BM) return (int)cudaErrorInvalidValue;
  const dim3 grid((D + BN - 1) / BN, (unsigned)((M + BM - 1) / BM));
  patch_embed_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(px), static_cast<const T*>(w), static_cast<T*>(out),
      H, W, C, p, D, (int)M, K, npw, P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tstar_patch_embed_bf16(const void* px, const void* w, void* out, int B, int H,
                                      int W, int C, int p, int D, void* stream) {
  return launch_patch_embed<__nv_bfloat16>(px, w, out, B, H, W, C, p, D, stream);
}

extern "C" int tstar_patch_embed_f32(const void* px, const void* w, void* out, int B, int H,
                                     int W, int C, int p, int D, void* stream) {
  return launch_patch_embed<float>(px, w, out, B, H, W, C, p, D, stream);
}

// The bf16 launch configuration for a (B, H, W, C) image batch and a
// (p, p, C, D) kernel: cfg = {CTAs, output columns per CTA, stages, dynamic
// shared memory bytes, K chunks per stage, values per chunk}; all 0 when the
// shape takes the CUDA-core kernel.
extern "C" int tstar_patch_embed_config(int B, int H, int W, int C, int p, int D, int* cfg) {
  cfg[0] = cfg[1] = cfg[2] = cfg[3] = cfg[4] = cfg[5] = 0;
  if (B < 1 || p < 1 || H % p || W % p || C < 1 || D < 1) return (int)cudaErrorInvalidValue;
  if (!sm90_shape_ok(H, W, C, p, D)) return 0;
  Sm90Config c;
  const int e = sm90_configure(B, H, W, C, p, D, &c);
  if (e) return e;
  cfg[0] = (int)(c.grid.x * c.grid.y * c.grid.z);
  cfg[1] = c.nb;
  cfg[2] = c.stages;
  cfg[3] = c.smem;
  cfg[4] = c.kc;
  cfg[5] = c.pk;
  return 0;
}
