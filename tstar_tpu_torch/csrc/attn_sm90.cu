// K1 and K8 in bf16: one Hopper attention kernel, wgmma + TMA, two exact passes.
//
// Replaces, for bf16, tstar_tpu/kernels/attention.py:_mha_pallas (the
// pallas_call at :298; K1, entry fused_mha_from_qkv) and the TPU flash kernel
// that attention.py:flash_mha reaches (:621; K8).  Both compute softmax(q k^T
// * scale) v per (batch, head) with head width 64; they differ only in where
// the probabilities are rounded to bf16 for the product with v:
//   K1      p = exp2(s * scale * log2(e) - m), rounded; f32 row sum of the
//           unrounded p; output = (P V in f32) / sum (deferred normalisation);
//   K1 P16  (TSTAR_MHA_P16) the same p rounded, row sum of the ROUNDED values;
//   K8      p = exp(s * scale - m) / l, the normalised probability, rounded
//           (the reference's single key block at S_pad <= 1024), taken as
//           exp(s * scale - m) times 1 / l; output P V.
// f32 inputs keep their CUDA-core kernels (mha.cu, flash_attn.cu): wgmma has
// no full-f32 form.
//
// What bounds it on the H100: at B=1, S=577 the bytes (q, k, v read once and
// the output written once: 3.5 MB, ~1.1 us at 3.35 TB/s); from B ~ 8 the
// operations.  The function needs 4*B*H*S^2*64; this design does 6*B*H*S^2*64
// (Q K^T twice) to keep the reference's rounding points without online
// rescaling: 25 us at B=16, S=577 against 989 TFLOP/s.
//
// Design.  One CTA owns (batch, head, NWG x 64 query rows): one or two
// warpgroups of 64 rows each.  Thread 0 starts TMA loads (128-byte swizzle: a
// 64-wide bf16 head row is one 128-byte line) of the warpgroups' Q tiles and
// of 64-key K and V tiles, each completing on an mbarrier.  Where the head's
// K and V fit in a CTA's shared memory (S <= 832; at S=577 2 x 10 tiles x 8
// KB), every tile is loaded once and pass 2 re-reads it.  Otherwise a ring of
// four stages streams K for pass 1 and K + V for pass 2 from L2: each
// warpgroup releases a stage on an "empty" barrier, and thread 0 refills it
// once both have.  There is no separate producer warp, so a CTA of two
// warpgroups keeps 128 registers a thread and two such CTAs fit an SM where
// their shared memory does (S=257: 97 KB each; S=577: 177 KB, one a SM).
// Rows past S are zero-filled by the tensor map and their logits set to -inf.
//   Pass 1: S = Q K^T by wgmma.m64n64k16 (both operands K-major in shared
//           memory, f32 accumulators in registers), mask, row max m; for K8
//           also the f32 row sum l = sum exp(s - m) with a running max whose
//           sum is rescaled (each exp as exp2 of x log2(e), which moves l by
//           ~1e-7 relative).  Q K_{j+1}^T is started before tile j is reduced.
//   Pass 2: S again tile by tile (bit-identical), p formed and rounded to
//           bf16 in registers, where the accumulator layout of Q K^T is the
//           register A-operand layout of P V: wgmma with A from registers and
//           V as the transposed (MN-major) shared-memory B operand.  Q K_{j+1}^T
//           and P_j V are started together, so P_j V runs while the
//           probabilities of tile j + 1 are formed.
// The 64 x 64 f32 output per warpgroup (32 registers a thread) is rounded to
// bf16, written swizzled into the warpgroup's Q buffer and stored by TMA,
// which clips rows past S.  Two warpgroups per CTA, which halve the K/V loads
// per query row, once the grid would still fill the card twice over; else
// one (B=1, S=577: 120 CTAs).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace tstar::sm90;

constexpr int DH = 64;                     // head width: one 128-byte bf16 line
constexpr int TILE = 64;                   // query rows per warpgroup, keys per tile
constexpr int TILE_BYTES = TILE * DH * 2;  // 8 KB
constexpr int STREAM_STAGES = 4;           // K/V ring depth when the head does not fit
constexpr float LOG2E = 1.4426950408889634f;

enum Mode { MHA = 0, MHA_P16 = 1, FLASH = 2 };

// Coordinate slot (1..3; slot 0 is the head-width axis) of the head, sequence
// and batch axes in a tensor map, whose axes are ordered by stride.
struct Slots {
  int h, s, b;
};

struct Params {
  Slots sq, sk, sv, so;
  int hq, hk, hv;  // head offset of q, k, v in their maps (K1: 0, H, 2H)
  int S, n_tiles, stages, resident;
  float scale;     // K1: 1/sqrt(64) * log2(e); K8: 1/sqrt(64)
};

__device__ __forceinline__ void place(const Slots& sl, int h, int s, int b, int& c1, int& c2,
                                      int& c3) {
  c1 = sl.h == 1 ? h : (sl.s == 1 ? s : b);
  c2 = sl.h == 2 ? h : (sl.s == 2 ? s : b);
  c3 = sl.h == 3 ? h : (sl.s == 3 ? s : b);
}

// One 64-row x 64-column tile (rows s.., head h, batch b) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, const Slots& sl,
                                         uint32_t bar, int h, int s, int b) {
  int c1, c2, c3;
  place(sl, h, s, b, c1, c2, c3);
  mbar_expect_tx(bar, TILE_BYTES);
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, const Slots& sl, uint32_t src,
                                          int h, int s, int b) {
  int c1, c2, c3;
  place(sl, h, s, b, c1, c2, c3);
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start address,
// leading byte offset `lbo` and stride byte offset 1024 B (8 rows of 128 B)
// in 16-byte units, layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)lbo << 16) | ((uint64_t)64 << 32) |
         ((uint64_t)1 << 62);
}

// Keeps the compiler from moving reads or writes of wgmma registers across
// the asynchronous instructions.
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define TSTAR_D32                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define TSTAR_D32_ARGS(d)                                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (64 x 64 f32) (+)= A (64 x 16, shared memory, K-major) B (16 x 64, shared
// memory, K-major: B[k][n] at row n).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TSTAR_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : TSTAR_D32_ARGS(d)
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 64 f32) += A (64 x 16 bf16, registers) B (16 x 64, shared memory,
// MN-major: B[k][n] at row k, the transpose flag set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TSTAR_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TSTAR_D32_ARGS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Starts s = Q K^T for one 64-key tile (one commit group): four k-steps of 16
// over the head width, each advancing 32 bytes inside the swizzled lines.
__device__ __forceinline__ void qk_start(float (&s)[32], uint32_t q, uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss(s, desc_sw128(q + 32 * kk, 1), desc_sw128(k + 32 * kk, 1), kk);
  wg_commit();
}

// Starts o += P V for one tile (one commit group): k-step kk takes keys 16kk ..
// 16kk + 15 of P from registers and two 8-row groups (2048 B) of V.
__device__ __forceinline__ void pv_start(float (&o)[32], const uint32_t (&a)[4][4], uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(o, a[kk], desc_sw128(v + 2048 * kk, 64));
  wg_commit();
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Accumulator layout of a 64 x 64 f32 wgmma tile: thread t of the warpgroup
// (warp w = t / 32, lane l) holds rows 16w + l/4 (i = 0) and 16w + l/4 + 8
// (i = 1) at columns 8k + 2(l%4) + e, e = 0, 1, in register 4k + 2i + e.
template <int MODE, int NWG>
// Two CTAs of two warpgroups fit an SM's registers (<= 128 a thread).
__global__ void __launch_bounds__(NWG * 128, 2)
attn_sm90_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mo,
                 const Params p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // 128B swizzle wants 1024-byte tiles
  const uint32_t q_smem = base;                  // NWG Q tiles, then K and V stages
  const uint32_t k_smem = q_smem + NWG * TILE_BYTES;
  const uint32_t v_smem = k_smem + p.stages * TILE_BYTES;
  const uint32_t bars = v_smem + p.stages * TILE_BYTES;
  const uint32_t qbar = bars;                    // [NWG]
  const uint32_t kbar = qbar + 8 * NWG;          // [stages] each
  const uint32_t vbar = kbar + 8 * p.stages;
  const uint32_t ebar = vbar + 8 * p.stages;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * NWG * TILE;
  const int n = p.n_tiles, stages = p.stages;
  const int wg = threadIdx.x / 128;  // this thread's warpgroup: query rows row0 ..
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32, c = lane % 4;
  const int row0 = q0 + wg * TILE;
  const bool active = row0 < p.S;  // uniform over the warpgroup
  const uint32_t my_q = q_smem + wg * TILE_BYTES;

  // Load u of the K/V schedule: u < n is K_u for pass 1, u = n + j is K_j
  // and V_j for pass 2; when streaming it goes to stage u % stages.
  auto load = [&](int u) {
    const int st = u % stages, j = u < n ? u : u - n;
    tma_load(k_smem + st * TILE_BYTES, &mk, p.sk, kbar + 8 * st, p.hk + h, j * TILE, b);
    if (u >= n)
      tma_load(v_smem + st * TILE_BYTES, &mv, p.sv, vbar + 8 * st, p.hv + h, j * TILE, b);
  };
  if (threadIdx.x == 0) {  // thread 0 also starts every load
    for (int w = 0; w < NWG; ++w) mbar_init(qbar + 8 * w, 1);
    for (int st = 0; st < stages; ++st) {
      mbar_init(kbar + 8 * st, 1);
      mbar_init(vbar + 8 * st, 1);
      mbar_init(ebar + 8 * st, NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int w = 0; w < NWG; ++w) {
      const int row = q0 + w * TILE < p.S ? q0 + w * TILE : 0;  // an idle warpgroup reads row 0
      tma_load(q_smem + w * TILE_BYTES, &mq, p.sq, qbar + 8 * w, p.hq + h, row, b);
    }
    if (p.resident) {
      for (int j = 0; j < n; ++j)
        tma_load(k_smem + j * TILE_BYTES, &mk, p.sk, kbar + 8 * j, p.hk + h, j * TILE, b);
      for (int j = 0; j < n; ++j)
        tma_load(v_smem + j * TILE_BYTES, &mv, p.sv, vbar + 8 * j, p.hv + h, j * TILE, b);
    } else {
      for (int u = 0; u < stages; ++u) load(u);
    }
  }
  __syncthreads();
  // Streaming: each warpgroup releases load u's stage when done with it; once
  // both have, thread 0 refills the stage with load u + stages.
  auto release = [&](int u) {
    if (p.resident || tid != 0) return;
    const int st = u % stages;
    mbar_arrive(ebar + 8 * st);
    if (wg == 0 && u + stages < 2 * n) {
      mbar_wait(ebar + 8 * st, (u / stages) & 1);
      load(u + stages);
    }
  };
  mbar_wait(qbar + 8 * wg, 0);

  float s0[32], s1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s0[i] = s1[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // row max (scaled logits)
  float l[2] = {0.f, 0.f};              // K8: this thread's part of the row sum

  // Pass 1: the row max (K8: and the row sum).  Load j of the pass is tile
  // j; Q K_{j+1}^T is started before tile j is reduced.
  auto stage1 = [&](int j) { return p.resident ? j : j % stages; };
  auto wait_k1 = [&](int j) {
    mbar_wait(kbar + 8 * stage1(j), p.resident ? 0 : (j / stages) & 1);
  };
  auto pass1 = [&](float(&cur)[32], float(&nxt)[32], int j) {
    if (j + 1 < n) {
      wait_k1(j + 1);
      if (active) {
        fence_regs(nxt);
        wg_fence();
        qk_start(nxt, my_q, k_smem + stage1(j + 1) * TILE_BYTES);
        wg_wait<1>();
      }
    } else if (active) {
      wg_wait<0>();
    }
    release(j);
    if (!active) return;
    fence_regs(cur);
    const int valid = p.S - j * TILE;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i / 4) + 2 * c + (i % 2);
      cur[i] = col < valid ? cur[i] * p.scale : -INFINITY;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], cur[i]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mx[r]));
      if (MODE == FLASH) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if ((i / 2) % 2 == r) part += exp2f((cur[i] - mn) * LOG2E);
        l[r] = l[r] * exp2f((m[r] - mn) * LOG2E) + part;
      }
      m[r] = mn;
    }
  };
  wait_k1(0);
  if (active) {
    wg_fence();
    qk_start(s0, my_q, k_smem + stage1(0) * TILE_BYTES);
  }
  for (int j = 0; j < n; j += 2) {
    pass1(s0, s1, j);
    if (j + 1 < n) pass1(s1, s0, j + 1);
  }
  if (MODE == FLASH) {  // l becomes 1 / (row sum)
    l[0] = 1.f / quad_sum(l[0]);
    l[1] = 1.f / quad_sum(l[1]);
  }

  // Pass 2: probabilities, rounded to bf16 in registers, times V.  Load j of
  // the pass is tile j again (K and V); while P_j V runs on the tensor cores,
  // the probabilities of tile j + 1 are formed.
  auto stage2 = [&](int j) { return p.resident ? j : (n + j) % stages; };
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float rs[2] = {0.f, 0.f};  // K1: this thread's part of the row sum
  uint32_t a[4][4];
  if (!p.resident) mbar_wait(kbar + 8 * stage2(0), (n / stages) & 1);
  if (active) {
    fence_regs(s0);
    wg_fence();
    qk_start(s0, my_q, k_smem + stage2(0) * TILE_BYTES);
    wg_wait<0>();
    fence_regs(s0);
  }
  for (int j = 0; j < n; ++j) {
    if (active) {
      const int valid = p.S - j * TILE;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i / 4) + 2 * c + (i % 2);
        const int r = (i / 2) % 2;
        const float x = col < valid ? s0[i] * p.scale : -INFINITY;
        if (MODE == MHA) {
          s0[i] = exp2f(x - m[r]);
          rs[r] += s0[i];  // the f32 sum uses the probabilities before rounding
        } else if (MODE == MHA_P16) {
          s0[i] = __bfloat162float(__float2bfloat16(exp2f(x - m[r])));
          rs[r] += s0[i];  // the sum of the rounded values
        } else {
          s0[i] = expf(x - m[r]) * l[r];  // normalised, then rounded
        }
      }
      wg_wait<0>();  // P_{j-1} V done: a is free
      fence_regs(a);
    }
    if (j > 0) release(n + j - 1);
    if (active) {
      // Registers 8kk .. 8kk + 7 (keys 16kk .. 16kk + 15) are the A fragment
      // of k-step kk: {row i, keys 2c, 2c+1}, {row i + 8, ...}, then keys + 8.
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          a[kk][q] = pack_bf16(s0[8 * kk + 2 * q], s0[8 * kk + 2 * q + 1]);
    }
    if (j + 1 < n && !p.resident)
      mbar_wait(kbar + 8 * stage2(j + 1), ((n + j + 1) / stages) & 1);
    mbar_wait(vbar + 8 * stage2(j), p.resident ? 0 : (j / stages) & 1);
    if (active) {
      fence_regs(s0);
      fence_regs(a);
      fence_regs(o);
      wg_fence();
      if (j + 1 < n) qk_start(s0, my_q, k_smem + stage2(j + 1) * TILE_BYTES);
      pv_start(o, a, v_smem + stage2(j) * TILE_BYTES);
      if (j + 1 < n) {
        wg_wait<1>();  // Q K_{j+1}^T done; P_j V may still run
      } else {
        wg_wait<0>();
        fence_regs(o);
        fence_regs(a);
      }
      fence_regs(s0);
    }
  }
  release(2 * n - 1);
  if (!active) return;

  float inv[2] = {1.f, 1.f};
  const bool divide = MODE != FLASH;
  if (divide) {
    inv[0] = quad_sum(rs[0]);
    inv[1] = quad_sum(rs[1]);
  }
  // Round to bf16 into this warpgroup's Q buffer (free now) in the 128B
  // swizzle the output map expects, then one TMA store of the tile.
  const int warp_in = tid / 32;
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * warp_in + lane / 4 + 8 * i;
      float lo = o[4 * k + 2 * i], hi = o[4 * k + 2 * i + 1];
      if (divide) {
        lo = lo / inv[i];
        hi = hi / inv[i];
      }
      const uint32_t addr = my_q + r * 128 + ((k ^ (r & 7)) * 16) + 4 * c;
      asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(pack_bf16(lo, hi)) : "memory");
    }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
  if (tid == 0) tma_store(&mo, p.so, my_q, h, row0, b);
}

struct Config {
  int nwg, stages, resident, smem;
};

// Warpgroups per CTA; then every K/V tile resident when the head fits in a
// CTA's shared memory, else a ring of STREAM_STAGES.
Config choose(int B, int S, int H, int sms, int smem_block) {
  Config c;
#ifdef TSTAR_ATTN_WGS
  c.nwg = TSTAR_ATTN_WGS;  // a build that pins the choice, for measuring the two
#else
  const long long ctas2 = (long long)((S + 2 * TILE - 1) / (2 * TILE)) * H * B;
  c.nwg = ctas2 >= 2LL * sms ? 2 : 1;
#endif
  const int n = (S + TILE - 1) / TILE;
  auto bytes = [&](int stages) {
    return 1024 + c.nwg * TILE_BYTES + 2 * stages * TILE_BYTES + 8 * (c.nwg + 3 * stages);
  };
  c.resident = bytes(n) <= smem_block;
  c.stages = c.resident ? n : STREAM_STAGES;
  c.smem = bytes(c.stages);
  return c;
}

// A 4-D map over a (B, S, H, 64) bf16 tensor with element strides sb, ss, sh
// and a unit last stride; box 64 (sequence) x 64 (head width).  The three
// outer axes go in order of stride (axes of size 1 last), as the hardware
// wants; `sl` receives their slots.
int encode(CUtensorMap* map, Slots* sl, const void* ptr, int B, int S, int H, long long sb,
           long long ss, long long sh) {
  struct Axis {
    uint64_t size;
    long long stride;
    int role;  // 0 head, 1 sequence, 2 batch
  } ax[3] = {{(uint64_t)H, sh, 0}, {(uint64_t)S, ss, 1}, {(uint64_t)B, sb, 2}};
  auto before = [](const Axis& x, const Axis& y) {
    if ((x.size == 1) != (y.size == 1)) return y.size == 1;
    return x.stride < y.stride;
  };
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && before(ax[j], ax[j - 1]); --j) {
      const Axis t = ax[j];
      ax[j] = ax[j - 1];
      ax[j - 1] = t;
    }
  cuuint64_t dims[4] = {DH, 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {DH, 1, 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  uint64_t span = DH * 2;  // bytes spanned by the axes so far
  int slot[3];
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = ax[i].size;
    strides[i] = ax[i].size > 1 ? (uint64_t)ax[i].stride * 2 : span;
    span = strides[i] * ax[i].size;
    if (ax[i].role == 1) box[i + 1] = TILE;
    slot[ax[i].role] = i + 1;
  }
  *sl = Slots{slot[0], slot[1], slot[2]};
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The device's SM count and opt-in shared memory per block.
int device(int* sms, int* smem_block) {
  DeviceInfo d{};
  int dev = 0;
  const int e = device_info(&d, &dev);
  *sms = d.sms;
  *smem_block = d.optin;
  return e;
}

template <int MODE, int NWG>
int launch_nwg(const CUtensorMap (&maps)[4], const Params& p, int B, int H, int smem,
               cudaStream_t stream) {
  auto kernel = attn_sm90_kernel<MODE, NWG>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.S + NWG * TILE - 1) / (NWG * TILE), H, B);
  kernel<<<grid, NWG * 128, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return (int)cudaGetLastError();
}

// maps: q, k, v, out; p.s* and p.h* filled in.
template <int MODE>
int launch(const CUtensorMap (&maps)[4], Params p, int B, int S, int H, void* stream) {
  int sms = 0, smem_block = 0;
  const int e = device(&sms, &smem_block);
  if (e) return e;
  const Config c = choose(B, S, H, sms, smem_block);
  p.S = S;
  p.n_tiles = (S + TILE - 1) / TILE;
  p.stages = c.stages;
  p.resident = c.resident;
  return c.nwg == 2 ? launch_nwg<MODE, 2>(maps, p, B, H, c.smem, (cudaStream_t)stream)
                    : launch_nwg<MODE, 1>(maps, p, B, H, c.smem, (cudaStream_t)stream);
}

bool dims_ok(int B, int S, int H) {
  return B >= 1 && S >= 1 && H >= 1 && B <= 65535 && H <= 65535;
}

template <int MODE>
int mha(const void* qkv, void* out, int B, int S, int D, int H, float scale_log2e, void* stream) {
  if (D != H * DH || !dims_ok(B, S, H) || reinterpret_cast<uintptr_t>(qkv) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  Params p{};
  // The fused projection as (B, S, 3H, 64): q heads 0.., k heads H.., v heads 2H..
  int e = encode(&maps[0], &p.sq, qkv, B, S, 3 * H, (long long)S * 3 * D, 3 * D, DH);
  if (!e) e = encode(&maps[3], &p.so, out, B, S, H, (long long)S * D, D, DH);
  if (e) return e;
  maps[1] = maps[2] = maps[0];
  p.sk = p.sv = p.sq;
  p.hq = 0;
  p.hk = H;
  p.hv = 2 * H;
  p.scale = scale_log2e;
  return launch<MODE>(maps, p, B, S, H, stream);
}

}  // namespace

extern "C" int tstar_mha_bf16(const void* qkv, void* out, int B, int S, int D, int H,
                              float scale_log2e, void* stream) {
  return mha<MHA>(qkv, out, B, S, D, H, scale_log2e, stream);
}

extern "C" int tstar_mha_p16_bf16(const void* qkv, void* out, int B, int S, int D, int H,
                                  float scale_log2e, void* stream) {
  return mha<MHA_P16>(qkv, out, B, S, D, H, scale_log2e, stream);
}

// q, k, v (B, S, H, 64) with element strides (batch, sequence, head) each and
// a unit stride on the last axis; out a contiguous (B, S, H, 64).
extern "C" int tstar_flash_bf16(const void* q, const void* k, const void* v, void* out, int B,
                                int S, int H, int D, long long qb, long long qs, long long qh,
                                long long kb, long long ks, long long kh, long long vb,
                                long long vs, long long vh, float scale, void* stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (D != DH || !dims_ok(B, S, H) || ptrs % 16) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  Params p{};
  int e = encode(&maps[0], &p.sq, q, B, S, H, qb, qs, qh);
  if (!e) e = encode(&maps[1], &p.sk, k, B, S, H, kb, ks, kh);
  if (!e) e = encode(&maps[2], &p.sv, v, B, S, H, vb, vs, vh);
  if (!e) e = encode(&maps[3], &p.so, out, B, S, H, (long long)S * H * DH, (long long)H * DH, DH);
  if (e) return e;
  p.scale = scale;
  return launch<FLASH>(maps, p, B, S, H, stream);
}

// The launch configuration the kernel takes for (B, S, H) on this device:
// cfg = {warpgroups per CTA, K/V stages, all of K/V resident, dynamic shared
// memory bytes}.
extern "C" int tstar_attn_config(int B, int S, int H, int* cfg) {
  int sms = 0, smem_block = 0;
  const int e = device(&sms, &smem_block);
  if (e) return e;
  const Config c = choose(B, S, H, sms, smem_block);
  cfg[0] = c.nwg;
  cfg[1] = c.stages;
  cfg[2] = c.resident;
  cfg[3] = c.smem;
  return 0;
}
