// K5: a pre-norm LayerNorm folded into the bf16 matmul it feeds, on Hopper's
// warpgroup MMA fed by TMA.
//
// Replaces tstar_tpu/kernels/ln_matmul.py:_ln_matmul_kernel (via
// _ln_matmul_pallas, the pallas_call at :86, and ln_matmul).  For x (R, D)
// bf16, the LayerNorm's scale / bias (D,) in bf16 (the reference casts its
// f32 parameters to the compute dtype; widened here to f32, scale32 /
// bias32), W (D, N) bf16 row-major and b (N,) bf16:
//   mean = sum(x) / D,  var = sum(x^2) / D - mean^2          (f32)
//   h    = bf16((x - mean) * (rsqrt(var + eps) * scale32) + bias32)
//   out  = bf16(bf16(h @ W  accumulated in f32) + b)
// as the TPU kernel computes it.  The row statistics and the product sum in
// another order than the plain version's, so a normalized value or the
// product can round to a neighbouring bf16 value (the bound is
// kernels/ln_matmul.py bf16_error_bound).
//
// What bounds it on the H100: ln1 -> qkv (D = 768, N = 2304) and ln2 -> fc1
// (N = 3072) at R = 577 rows are 2.0 and 2.7 GFLOP (2.1 / 2.7 us at 989
// TFLOP/s) against 7.1 and 9.2 MB (2.1 / 2.8 us at 3.35 TB/s): nearly
// balanced, so the normalized rows must not make a round trip through
// device memory, and no CTA may normalize a row another CTA normalizes too.
//
// Design (csrc/w8a8.cu's, K4, in bf16).  A CTA owns a 64-row slab of x and a
// run of 256-column N tiles (128 where N is not a multiple of 256); two
// consumer warpgroups and one producer warp (288 threads):
//   1. The producer's lane 0 starts TMA loads of the first W tiles: a stage
//      is 64 K rows x the N tile as 64 x 64 boxes (8 KB each, 128-byte
//      swizzle), each completing on the stage's "full" mbarrier.  Meanwhile
//      all nine warps normalize the slab, a half-warp a row (at D = 768 the
//      row stays in registers between its statistics and its normalization,
//      so x is read once), and store each bf16 row in the K-major layout the
//      wgmma descriptor reads: one tile of 64 rows x 128 bytes per 64-deep K
//      chunk, 16-byte group g of row r at g ^ (r & 7).  The CTAs that split
//      one slab's N tiles form a thread-block cluster (up to 8): each
//      normalizes every n-th row once and stores it into every CTA's slab
//      (st.shared::cluster at mapa addresses), so a row is read and
//      normalized once, not once per N tile.  Every thread fences for the
//      async proxy before the cluster barrier that precedes the first wgmma.
//      Rows past R are stored as zeros.
//   2. Warpgroup w takes half the columns of each N tile: per K chunk four
//      wgmma.m64n128k16 (A: the slab chunk, advanced 32 bytes a k-step; B:
//      its two W boxes, MN-major with the transpose flag, advanced 16 lines
//      a k-step), so W is read as stored, with no transposed copy (128
//      columns a warpgroup took 15-25% less device time than 64 on an H100,
//      tools/kernel_bench.py).  One commit group per chunk; once the next
//      is issued, the previous one is waited for and its stage released on
//      an "empty" mbarrier (one arrival per warpgroup); the producer refills
//      a stage once both have.
//   3. The epilogue runs from the accumulators (thread t of a warpgroup holds
//      rows 16(t/32) + (t%32)/4 (+8), column pairs 8k + 2(t%4)): round to
//      bf16, add b, round again, store pairs.
// Shared memory: the slab (96 KB at D = 768) plus W stages of 32 KB (16 KB
// at 128-column tiles) up to 227 KB (4 at D = 768); one CTA an SM.  The grid
// splits each slab's N tiles into runs and picks the cluster size so that
// the clusters fill the card in few waves (choose(), with the device's count
// of clusters it holds at once).  Measured on an H100, the kernel is bound by
// the W bytes each CTA streams through its ring (~40 GB/s an SM, every
// 64-row slab re-reading W from L2) and by a fixed ~15 us per CTA, not by
// the products or the normalization.  Every mbarrier wait traps after ~2^26
// polls.
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace tstar::sm90;

constexpr int BM = 64;                          // rows of a slab
constexpr int BK = 64;                          // K per chunk: one 128-byte bf16 line
constexpr int CONSUMERS = 2;                    // warpgroups
constexpr int THREADS = CONSUMERS * 128 + 32;   // + the producer warp
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK_A = BM * BK * 2;            // 8 KB of slab per K chunk
constexpr int BOX_B = BK * 64 * 2;              // 8 KB: 64 K rows x 64 columns of W
constexpr int MAX_STAGES = 8;
constexpr int MAX_CLUSTER = 8;                  // the portable cluster size

struct Params {
  int R, D, N, per, stages;                     // per: N tiles of this CTA's run
  float eps;
};

// Where 8-value group g of slab row r lies, from the slab's start: K chunk
// g / 8, the row's 128-byte line, 16-byte group g % 8 swizzled by the row.
__device__ __forceinline__ uint32_t slab_offset(int r, int g) {
  return (g / 8) * CHUNK_A + r * 128 + (((g % 8) ^ (r & 7)) * 16);
}

// The slabs of the cluster's CTAs (the same rows, other N tiles).
struct Slabs {
  uint32_t slab;  // this CTA's slab (shared::cta address)
  int n;          // CTAs in the cluster

  __device__ __forceinline__ void put(uint32_t off, uint4 v) const {
#pragma unroll
    for (int t = 0; t < MAX_CLUSTER; ++t)
      if (t < n) st_cluster(map_rank(slab + off, t), v);
  }
};

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

// Eight normalized values of columns c .. c + 7, rounded to bf16.
__device__ __forceinline__ uint4 norm8(const float* v, float mean, float inv,
                                       const __nv_bfloat16* __restrict__ scale,
                                       const __nv_bfloat16* __restrict__ bias, int c) {
  float s[8], b[8], y[8];
  load8(scale + c, s);
  load8(bias + c, b);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    y[j] = __fadd_rn(__fmul_rn(__fsub_rn(v[j], mean), __fmul_rn(inv, s[j])), b[j]);
  return make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]),
                    pack_bf16(y[6], y[7]));
}

// Normalizes slab row r into every slab of the cluster, a half-warp a row:
// lane hl of the half takes 8-value groups hl, hl + 16, ...  With G > 0 the
// row has 16 G groups and stays in registers (x is read once); G = 0 (other
// widths) reads it twice, four groups a lane at a time.  `mine`: whether
// this half has a row at all; rows past R are stored as zeros.  `waited`:
// whether this warp has passed the cluster barrier that lets it write to the
// other CTAs (it waits once its first row's statistics are taken).
template <int G>
__device__ __forceinline__ void normalize_half(const __nv_bfloat16* __restrict__ x,
                                               const __nv_bfloat16* __restrict__ scale,
                                               const __nv_bfloat16* __restrict__ bias,
                                               const Params& p,
                                               int m0, int r, bool mine, const Slabs& dst, int hl,
                                               bool& waited) {
  constexpr int V = G > 0 ? G : 4;  // groups a lane holds at once
  const int groups = p.D / 8;
  const bool real = mine && m0 + r < p.R;
  const __nv_bfloat16* xr = x + (size_t)(real ? m0 + r : 0) * p.D;
  float v[V][8];
  float s = 0.f, ss = 0.f;
  if (real)
    for (int g0 = hl; g0 < groups; g0 += 16 * V) {
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (G > 0 || g0 + 16 * i < groups) load8(xr + (g0 + 16 * i) * 8, v[i]);
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (G > 0 || g0 + 16 * i < groups)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            s += v[i][j];
            ss += v[i][j] * v[i][j];
          }
    }
  s = half_warp_sum(s);
  ss = half_warp_sum(ss);
  if (!waited) {
    cluster_wait();
    waited = true;
  }
  if (!mine) return;
  if (!real) {
    for (int g = hl; g < groups; g += 16) dst.put(slab_offset(r, g), make_uint4(0, 0, 0, 0));
    return;
  }
  const float mean = __fdiv_rn(s, (float)p.D);
  const float var = __fsub_rn(__fdiv_rn(ss, (float)p.D), __fmul_rn(mean, mean));
  const float inv = rsqrtf(__fadd_rn(var, p.eps));
  if (G > 0) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int g = hl + 16 * i;
      dst.put(slab_offset(r, g), norm8(v[i], mean, inv, scale, bias, 8 * g));
    }
  } else {
    for (int g0 = hl; g0 < groups; g0 += 16 * V) {
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (g0 + 16 * i < groups) load8(xr + (g0 + 16 * i) * 8, v[i]);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int g = g0 + 16 * i;
        if (g < groups) dst.put(slab_offset(r, g), norm8(v[i], mean, inv, scale, bias, 8 * g));
      }
    }
  }
}

template <int G, int WN>
__global__ void __launch_bounds__(THREADS, 1)
ln_matmul_kernel(const __grid_constant__ CUtensorMap wmap, const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ scale, const __nv_bfloat16* __restrict__ bias,
                 const __nv_bfloat16* __restrict__ b, __nv_bfloat16* __restrict__ out,
                 const Params p) {
  constexpr int BN = CONSUMERS * WN;             // columns per N tile
  constexpr int STAGE_B = BN / 64 * BOX_B;       // W per stage
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the 128B swizzle wants 1024-byte tiles
  const int nk = p.D / BK, stages = p.stages;
  const uint32_t slab = base;                    // [nk][64 rows][128 B]
  const uint32_t ring = slab + nk * CHUNK_A;     // [stages][BN/64 boxes][64 K rows][128 B]
  const uint32_t full = ring + stages * STAGE_B; // [stages] mbarriers
  const uint32_t empty = full + 8 * stages;      // [stages]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * BM;
  const int t0 = blockIdx.x * p.per;
  const int t1 = min(p.N / BN, t0 + p.per);
  const int loads = (t1 - t0) * nk;  // load u: N tile t0 + u / nk, K chunk u % nk
  const bool producer = warp == WARPS - 1;

  auto load = [&](int u) {
    const int st = u % stages;
    const uint32_t bar = full + 8 * st, dst = ring + st * STAGE_B;
    const int k = (u % nk) * BK, n = (t0 + u / nk) * BN;
    mbar_expect_tx(bar, STAGE_B);
#pragma unroll
    for (int h = 0; h < BN / 64; ++h) tma_load_2d(dst + h * BOX_B, &wmap, bar, n + 64 * h, k);
  };
  if (producer && lane == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    prefetch_map(&wmap);
    for (int u = 0; u < stages && u < loads; ++u) load(u);
  }
  // A CTA writes into the others' shared memory only once all have started:
  // each warp arrives now and waits before its first such write.
  cluster_arrive();

  // 1. Normalize the slab: this CTA takes rows rank, rank + n, ... of the
  //    cluster's n CTAs, a half-warp a row, into every CTA's slab.
  Slabs dst;
  dst.slab = slab;
  dst.n = (int)cluster_size();
  bool waited = false;
  const int rank = (int)cluster_rank();
  const int share = (BM - rank + dst.n - 1) / dst.n;  // rows rank + n j, j < share
  for (int j0 = 2 * warp; j0 < share; j0 += 2 * WARPS) {
    const int j = j0 + lane / 16;
    normalize_half<G>(x, scale, bias, p, m0, rank + dst.n * j, j < share, dst, lane % 16,
                      waited);
  }
  if (!waited) cluster_wait();
  // The slabs were written through the generic proxy, partly by other CTAs;
  // wgmma reads them through the async proxy.
  asm volatile("fence.proxy.async.shared::cluster;" ::: "memory");
  cluster_arrive();
  cluster_wait();
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");

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

  // 2. Warpgroup wg: columns WN wg .. WN wg + WN - 1 of each N tile.
  const int wg = warp / 4, t = tid % 128;
  const int row_a = 16 * (t / 32) + (t % 32) / 4;  // + 8i
  const int col_a = WN * wg + 2 * (t % 4);         // + 8k + e
  float acc[WN / 2];
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = 0.f;
  int u = 0;
  for (int tile = t0; tile < t1; ++tile) {
    for (int kc = 0; kc < nk; ++kc, ++u) {
      const int st = u % stages;
      mbar_wait(full + 8 * st, (u / stages) & 1);
      fence_regs(acc);
      wg_fence();
      const uint32_t a = slab + kc * CHUNK_A, bw = ring + st * STAGE_B + wg * (WN / 64) * BOX_B;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_bf16(acc, desc(a + 32 * kk, 16, 1024, SW128),
                   desc(bw + 2048 * kk, BOX_B, 1024, SW128), kc | kk);
      wg_commit();
      if (kc > 0) {
        wg_wait<1>();  // chunk kc - 1 done: release its stage
        release(u - 1);
      }
    }
    wg_wait<0>();
    fence_regs(acc);
    release(u - 1);

    // 3. Epilogue from the accumulators: register 4k + 2i + e holds row
    //    row_a + 8i, column col_a + 8k + e.
    const int n0 = tile * BN;
    __nv_bfloat16* orow = out + (size_t)(m0 + row_a) * p.N + n0;
#pragma unroll
    for (int k = 0; k < WN / 8; ++k) {
      const int col = col_a + 8 * k;
      const float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b + n0 + col));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (m0 + row_a + 8 * i >= p.R) continue;
        const float lo = __fadd_rn(__bfloat162float(__float2bfloat16(acc[4 * k + 2 * i])), bb.x);
        const float hi = __fadd_rn(__bfloat162float(__float2bfloat16(acc[4 * k + 2 * i + 1])), bb.y);
        *reinterpret_cast<uint32_t*>(orow + (size_t)8 * i * p.N + col) = pack_bf16(lo, hi);
      }
    }
  }
}

struct Config {
  int wn, groups, row_tiles, per, stages, smem, cluster;
};

bool opted_in[2][2][MAX_DEVICES];

// How many clusters of `cluster` CTAs with `smem` bytes the device holds at
// once (the GPCs' sizes leave some SMs out), once per (device, kernel,
// cluster size, shared memory).
template <int G, int WN>
int active_clusters(int dev, int optin, int cluster, int smem, int* out) {
  struct Entry {
    int dev, cluster, smem, clusters;
  };
  static Entry cache[64];
  static int used = 0;
  for (int i = 0; i < used; ++i)
    if (cache[i].dev == dev && cache[i].cluster == cluster && cache[i].smem == smem) {
      *out = cache[i].clusters;
      return 0;
    }
  const void* kernel = reinterpret_cast<const void*>(ln_matmul_kernel<G, WN>);
  int e = opt_in(kernel, dev, optin, opted_in[G > 0][WN / 128]);
  if (e) return e;
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
  const cudaError_t ce = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (ce != cudaSuccess) return (int)ce;
  if (used < 64) cache[used++] = Entry{dev, cluster, smem, clusters};
  *out = clusters;
  return 0;
}

// A CTA's time (us), fitted to device times on an H100 at R = 577
// (tools/kernel_bench.py, with variants that skip the normalization, the
// products or the cluster): a fixed part (launch, the first W stages, the
// cluster barriers, the epilogue), a round of normalization (each
// half-warp of the nine warps one row) per 768 of D, and 16 KB of W
// streamed through the ring (~40 GB/s an SM).
constexpr double CTA_FIXED_US = 15.0, NORM_ROUND_US = 1.5, KB16_US = 0.34;

// As many W stages as fit (up to 8), then the run of N tiles per CTA and
// the cluster (CTAs sharing a slab's normalization, a divisor of the slab's
// CTAs up to 8): the pair whose clusters finish first, in waves of as many
// clusters as the device holds at once; ties go to the shorter run and the
// smaller cluster.
template <int G, int WN>
int choose(int R, int D, int N, int dev, const DeviceInfo& d, Config* c) {
  constexpr int BN = CONSUMERS * WN, STAGE_B = BN / 64 * BOX_B;
  const int nk = D / BK;
  c->wn = WN;
  auto bytes = [&](int st) { return 1024 + nk * CHUNK_A + st * (STAGE_B + 16); };
  c->stages = 0;
  while (c->stages < MAX_STAGES && bytes(c->stages + 1) <= d.optin) ++c->stages;
  if (c->stages < 2) return (int)cudaErrorInvalidValue;
  c->smem = bytes(c->stages);
  const long long row_tiles = (R + BM - 1) / BM, n_tiles = N / BN;
  if (row_tiles > 65535) return (int)cudaErrorInvalidValue;
  c->row_tiles = (int)row_tiles;
  double best = -1;
  for (int per = 1; per <= n_tiles; ++per) {
    const long long groups = (n_tiles + per - 1) / per;
    for (int cluster = 1; cluster <= MAX_CLUSTER; ++cluster) {
      if (groups % cluster) continue;
      int held = 0;
      const int e = active_clusters<G, WN>(dev, d.optin, cluster, c->smem, &held);
      if (e) return e;
      if (held < 1) continue;
      const long long waves = (groups / cluster * row_tiles + held - 1) / held;
      const int rows = (BM + cluster - 1) / cluster;  // normalized by each CTA
      const int rounds = (rows + 2 * WARPS - 1) / (2 * WARPS);
      const double cta = CTA_FIXED_US + rounds * NORM_ROUND_US * D / 768.0 +
                         per * nk * KB16_US * STAGE_B / 16384;
      const double cost = (double)waves * cta;
      if (best < 0 || cost < best) {
        best = cost;
        c->per = per;
        c->groups = (int)groups;
        c->cluster = cluster;
      }
    }
  }
  return best < 0 ? (int)cudaErrorInvalidConfiguration : 0;
}

// D: whole 128-value runs for the half-warps; N: whole 128-column tiles.
bool shape_ok(int R, int D, int N) {
  return R >= 1 && D >= 128 && N >= 128 && D % 128 == 0 && N % 128 == 0;
}

template <int G, int WN>
int launch_g(const CUtensorMap& map, const void* x, const void* scale, const void* bias,
             const void* b, void* out, const Config& c, const Params& p, void* stream) {
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
      &cfg, ln_matmul_kernel<G, WN>, map, static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(scale), static_cast<const __nv_bfloat16*>(bias),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(out), p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The towers' D = 768 keeps a row in registers (6 groups a lane); 128
// columns a warpgroup where N is a whole number of 256-column tiles.  The
// choice is kept per (device, R, D, N): a search launches K5 at few shapes,
// and the launch's host path lies on its critical path.
int configure(int R, int D, int N, int* dev, Config* c) {
  if (!shape_ok(R, D, N)) return (int)cudaErrorInvalidValue;
  DeviceInfo d;
  int e = device_info(&d, dev);
  if (e) return e;
  struct Entry {
    int dev, R, D, N;
    Config c;
  };
  static Entry cache[64];
  static int used = 0, next = 0;
  for (int i = 0; i < used; ++i)
    if (cache[i].dev == *dev && cache[i].R == R && cache[i].D == D && cache[i].N == N) {
      *c = cache[i].c;
      return 0;
    }
  if (N % 256 == 0)
    e = D == 768 ? choose<6, 128>(R, D, N, *dev, d, c) : choose<0, 128>(R, D, N, *dev, d, c);
  else
    e = D == 768 ? choose<6, 64>(R, D, N, *dev, d, c) : choose<0, 64>(R, D, N, *dev, d, c);
  if (e) return e;
  cache[next] = Entry{*dev, R, D, N, *c};
  next = (next + 1) % 64;
  used = used < 64 ? used + 1 : 64;
  return 0;
}

}  // namespace

// x (R, D) bf16, w (D, N) bf16 row-major, b (N,) bf16, all 16-byte aligned;
// scale / bias (D,) bf16.  D a multiple of 128, N of 128.
extern "C" int tstar_ln_matmul_bf16(const void* x, const void* scale, const void* bias,
                                    const void* w, const void* b, void* out, int R, int D,
                                    int N, float eps, void* stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(out) |
                         reinterpret_cast<uintptr_t>(scale) | reinterpret_cast<uintptr_t>(bias);
  if (ptrs % 16) return (int)cudaErrorInvalidValue;
  int dev = 0;
  Config c;
  int e = configure(R, D, N, &dev, &c);
  if (e) return e;
  CUtensorMap map;  // W (D, N): boxes of 64 K rows x 64 columns
  e = map_bf16_2d(&map, w, D, N, BK);
  if (e) return e;
  const Params p{R, D, N, c.per, c.stages, eps};
  if (c.wn == 128)
    return D == 768 ? launch_g<6, 128>(map, x, scale, bias, b, out, c, p, stream)
                    : launch_g<0, 128>(map, x, scale, bias, b, out, c, p, stream);
  return D == 768 ? launch_g<6, 64>(map, x, scale, bias, b, out, c, p, stream)
                  : launch_g<0, 64>(map, x, scale, bias, b, out, c, p, stream);
}

// The launch configuration for (R, D, N) on this device: cfg = {CTAs, N
// tiles per CTA, W stages, CTAs per cluster, dynamic shared memory bytes,
// columns per warpgroup}.
extern "C" int tstar_ln_matmul_config(int R, int D, int N, int* cfg) {
  int dev = 0;
  Config c;
  const int e = configure(R, D, N, &dev, &c);
  if (e) return e;
  cfg[0] = c.groups * c.row_tiles;
  cfg[1] = c.per;
  cfg[2] = c.stages;
  cfg[3] = c.cluster;
  cfg[4] = c.smem;
  cfg[5] = c.wn;
  return 0;
}
