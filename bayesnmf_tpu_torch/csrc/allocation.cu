// Latent-count multinomial allocation of the conjugate Poisson-Gibbs path
// on Hopper (sm_90a): every count M[k, g] split over the N components by a
// binary tree of conditional binomials, keeping only the marginal sums
// Zsum_g (K, N) and Zsum_k (N, G).
//
// (a) Replaces bayesnmf_tpu/ops/pallas_allocation.py::allocate_counts_fused
//     (_alloc_kernel, _binomial_tile, _lgamma_pos): bottom-up node weights
//     over n2 = next_pow2(N) leaves, the total > 0 cell guard, top-down
//     Binomial(count, w_left / w) splits by CDF inversion when n p <= 10 and
//     by BTRS rejection above (the mode when every round rejects). Two
//     sources of uniforms: pre-drawn planes (C, 17, n2-1, K, G) with 8 BTRS
//     rounds, as the JAX kernel's interpret mode takes them; or an in-kernel
//     Philox4x32-10 stream (csrc/philox.cuh) keyed by (seed, iteration,
//     site) (ops/rng.py ChainStreams.subkey), with its counter (cell, node,
//     block of four, chain uid), and 8 + 4 rounds, as the TPU core PRNG mode
//     runs.
// (b) What bounds it: the latency of the splits. Each cell runs N-1
//     dependent binomial draws (a few inversion steps, or BTRS with two
//     Stirling lgammas a round); the bytes (M, E, the outputs) are a few per
//     cell, the operations a few hundred.
// (c) The design against that latency. One thread per cell: a grid of
//     (G / 32, K / 8, C) blocks of 32 x 8 threads (lane = g, warp = row k),
//     ~K G C / 256 blocks, so even 96 x 100 fills a third of the SMs and
//     96 x 2780 several waves. The tree sits in registers: the kernel is
//     built for each n2 of 1..16 with its loops unrolled, so every slot
//     index is a constant, and one array serves as weights and counts (slot
//     h holds node h's weight until its parent is split, then its count);
//     n2 = 32 and 64 keep the array in local memory, which costs less than
//     the resident warps its 64 registers would take. Registers are capped
//     so that 3 blocks (4 with the tree in local memory) fit an SM. The
//     inversion stops at the first step whose CDF reaches u, or once x
//     reaches the count: the pmf
//     is never negative, so the CDF never falls and no later step adds, and
//     past the count the pmf is 0 (the counts are integers); the 40-step
//     cap stays. The draw's code (binomial) is one function called from
//     every unrolled node rather than copied into each.
//     The regime is picked per lane: a warp whose lanes take both runs both
//     branches, but the kernel is bound by latency more than by instruction
//     throughput. On an H100, cells whose regimes alternate along every
//     warp took 1.25x the time of the same cells with the regimes kept
//     apart (chip_smoke.py, phase 3d), and at (96,20,10000) 18% of
//     warp-splits mix: keeping the regimes apart could save ~5%.
//     What is left: the splits of a cell stay one dependent chain of IEEE
//     divisions, logs and exps on one thread, and lanes whose draws take
//     different numbers of steps wait for each other; the kernel runs at
//     ~60x its bound at (96,20,10000) and ~85x at (96,8,2780).
//
// Sums: Zsum_g[k, n] adds a tile's 32 columns in double (xor shuffle) into
// one partial per (tile, k); Zsum_k[n, g] adds a block's 8 rows in order
// into one double partial per (k-block, g); a second kernel (reduce_zg) adds
// the tiles' partials of Zsum_g (a warp each) and the k-blocks' partials of
// Zsum_k (a thread each), each in a fixed order. No atomics: two launches
// on the same inputs give the same bits, and the integer counts are summed
// exactly (the JAX kernel's float32 tile sums round past 2^24).
//
// Numerics: built without --use_fast_math and with -fmad=false; every
// expression in the order and with the roundings of the plain PyTorch
// version (ops/allocation.py), whose divisions are all true divisions.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

// Occupancy: the largest tree kept in registers, and the blocks an SM must
// hold, which caps the registers a thread may take, for a tree in registers
// and for one in local memory. At (96,20,10000) the 150 registers of a
// 32-leaf tree in registers left one block (8 warps) an SM, 1.21 ms; in
// local memory at 4 blocks an SM, 0.62 ms.
constexpr int kTileG = 32;   // lanes of a block: columns g
constexpr int kRows = 8;     // warps of a block: rows k (ops/allocation.py)
constexpr int kThreads = kTileG * kRows;
constexpr int kMaxN2 = 64;
constexpr int kRegN2 = 16;         // the largest tree kept in registers
constexpr int kMinBlocks = 3;      // blocks an SM, the tree in registers
constexpr int kMinBlocksLocal = 4; // blocks an SM, the tree in local memory
constexpr int kReduceLoads = 8;  // partials a lane has in flight
constexpr int kPlanes = 17;      // 1 + 2 * 8 BTRS rounds (planes mode)
constexpr int kPlaneRounds = 8;
constexpr int kPhiloxRounds = 12;  // 8 + 4 fresh rounds (Philox mode)
constexpr int kInvSteps = 40;
constexpr float kTiny = (float)1.2e-38;
constexpr float kHalfLog2Pi = (float)0.9189385332046727;

// a Python float constant as JAX rounds it to float32
#define F(x) ((float)(x))

// jnp.maximum / jnp.minimum and torch.maximum / torch.minimum: NaN wins
__device__ __forceinline__ float jmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fminf(a, b);
}

// The uniforms of one node's draw: planes[i * stride] in planes mode, else
// the i-th uniform of the node's Philox stream, four per counter block.
// 24 random bits in [tiny, 1) (philox_uniform), as the TPU kernel's
// fresh_uniform.
struct Uniforms {
  const float* plane;
  size_t stride;
  uint32_t k0, k1, cell, node, chain;
  int blk;
  U4 bits;

  __device__ float get(int i) {
    if (plane != nullptr) return plane[(size_t)i * stride];
    if ((i >> 2) != blk) {
      blk = i >> 2;
      bits = philox4x32_10(U4{{cell, node, (uint32_t)blk, chain}}, k0, k1);
    }
    return philox_uniform(bits.x[i & 3]);
  }
};

// ---- pallas_allocation.py::_lgamma_pos and _binomial_tile -----------------

__device__ float lgamma_pos(float x) {
  float shift = 0.0f, z = x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (z < 5.0f) {
      shift = shift + logf(jmax(z, kTiny));
      z = z + 1.0f;
    } else {
      shift = shift + 0.0f;
    }
  }
  const float zi = 1.0f / z;
  const float zi2 = zi * zi;
  const float series =
      zi * (F(8.3333333333e-2)
            - zi2 * (F(2.7777777778e-3) - zi2 * F(7.9365079365e-4)));
  return (z - 0.5f) * logf(z) - z + kHalfLog2Pi + series - shift;
}

// CDF inversion of Binomial(n, pp): the reference's 40 steps, stopped at
// the first step that adds nothing (cdf never falls, so none after it
// would) or once x reaches n (the pmf is 0 from there; min(x, n) = n).
__device__ float inversion(float n, float pp, float u) {
  const float ratio = pp / jmax(1.0f - pp, F(1e-12));
  float pmf = expf(n * log1pf(-pp));
  float cdf = pmf, x = 0.0f;
  for (int j = 0; j < kInvSteps; ++j) {
    if (!(u > cdf)) break;
    x = x + 1.0f;
    if (x >= n) break;
    pmf = pmf * (n - (float)j) / ((float)j + 1.0f) * ratio;
    cdf = cdf + pmf;
  }
  return jmin(x, n);
}

// BTRS (Hörmann 1993), the mode when every round rejects
__device__ float btrs(float n, float pp, Uniforms& U, int rounds) {
  const float spq = sqrtf(n * pp * (1.0f - pp));
  const float b = F(1.15) + F(2.53) * spq;
  const float a = F(-0.0873) + F(0.0248) * b + F(0.01) * pp;
  const float c = n * pp + 0.5f;
  const float vr = F(0.92) - F(4.2) / b;
  const float alpha = (F(2.83) + F(5.1) / b) * spq;
  const float lpq = logf(pp / jmax(1.0f - pp, F(1e-12)));
  const float m = floorf((n + 1.0f) * pp);
  const float h = lgamma_pos(m + 1.0f) + lgamma_pos(n - m + 1.0f);
  for (int r = 0; r < rounds; ++r) {
    const float uu = U.get(1 + 2 * r) - 0.5f;
    const float vv = U.get(2 + 2 * r);
    const float us = 0.5f - fabsf(uu);
    const float k = floorf((2.0f * a / jmax(us, F(1e-8)) + b) * uu + c);
    if (!(k >= 0.0f && k <= n)) continue;
    bool ok = us >= F(0.07) && vv <= vr;
    if (!ok) {
      const float v2 = logf(jmax(vv, kTiny) * alpha
                            / (a / jmax(us * us, F(1e-12)) + b));
      const float t = h - lgamma_pos(k + 1.0f) - lgamma_pos(n - k + 1.0f)
                      + (k - m) * lpq;
      ok = v2 <= t;
    }
    if (ok) return k;
  }
  return m;
}

// Binomial(n, p) for 0 < p < 1, n > 0; the regime is decided before the
// draw. Not inlined: the unrolled tree calls it from every node.
__device__ __noinline__ float binomial(float n, float p, Uniforms U,
                                       int rounds) {
  const bool flip = p > 0.5f;
  const float pp = flip ? 1.0f - p : p;
  const float y = n * pp <= 10.0f ? inversion(n, pp, U.get(0))
                                  : btrs(n, pp, U, rounds);
  return flip ? n - y : y;
}

// node h of the heap-ordered tree (root 1, children 2h and 2h+1, leaves
// n2 + n) holds only padding leaves
__device__ __forceinline__ bool padding(int h, int n2, int N) {
  const int depth = 31 - __clz(h);
  return (h - (1 << depth)) * (n2 >> depth) >= N;
}

struct Args {
  const float *M, *P, *A, *E, *u;
  const long long* uids;   // the chains' uids (Philox mode)
  uint32_t k0, k1;         // the Philox key (Philox mode)
  float *zg, *zk;
  // partials: Zsum_g (C, tiles, K, N), then Zsum_k (C, kblocks, N, G)
  double *part_g, *part_k;
  int C, K, N, G, n_nodes, tiles, kblocks;
  // a G shard's place in the whole matrix: its first column and the whole
  // G (the Philox counter counts the cells of the whole)
  int g0, G_total;
};

// One cell (k, g) per thread, the tree of N2 leaves in v[1 .. 2 N2): unrolled
// for N2 <= kRegN2, so that v sits in registers; larger trees in local
// memory (L1), which leaves the registers for more resident warps.
template <int N2>
__global__ void __launch_bounds__(kThreads,
                                  N2 <= kRegN2 ? kMinBlocks : kMinBlocksLocal)
alloc_kernel(Args a) {
  constexpr int kUnrollTree = N2 <= kRegN2 ? N2 : 1;
  constexpr int kChunk = N2 < kRows ? N2 : kRows;  // Zsum_k columns a pass
  __shared__ float s_cnt[kRows][kChunk][kTileG];
  const int lane = threadIdx.x & 31, row = threadIdx.x >> 5;
  const int tile = blockIdx.x, kb = blockIdx.y, c = blockIdx.z;
  const int K = a.K, N = a.N, G = a.G;
  const int g = tile * kTileG + lane, k = kb * kRows + row;
  const bool live = g < G && k < K;
  const float* P = a.P + ((size_t)c * K + k) * N;
  const float* A = a.A + (size_t)c * N;
  const float* E = a.E + (size_t)c * N * G;

  // bottom-up weights; a cell outside the grid has weight 0 and count 0
  float v[2 * N2];
#pragma unroll
  for (int n = 0; n < N2; ++n) {
    v[N2 + n] = live && n < N ? P[n] * A[n] * E[(size_t)n * G + g] : 0.0f;
  }
#pragma unroll (kUnrollTree)
  for (int h = N2 - 1; h >= 1; --h) v[h] = v[2 * h] + v[2 * h + 1];
  v[1] = live && v[1] > 0.0f ? a.M[(size_t)k * G + g] : 0.0f;

  // top-down splits; node counts the splits made, as the planes' node axis
  const bool prng = a.u == nullptr;
  const uint32_t chain = prng ? (uint32_t)a.uids[c] : 0u;
  int node = 0;
#pragma unroll (kUnrollTree)
  for (int h = 1; h < N2; ++h) {
    if (padding(h, N2, N)) continue;
    const float ch = v[h];
    if (padding(2 * h + 1, N2, N)) {
      v[2 * h] = ch;
      continue;
    }
    const float wl = v[2 * h];
    const float q = jmin(jmax(wl / jmax(wl + v[2 * h + 1], F(1e-30)), 0.0f),
                         1.0f);
    float left;
    if (q <= 0.0f || ch <= 0.0f) {
      left = 0.0f;
    } else if (q >= 1.0f) {
      left = ch;
    } else {
      Uniforms U;
      if (prng) {
        U = Uniforms{nullptr, 0, a.k0, a.k1,
                     (uint32_t)((size_t)k * a.G_total + a.g0 + g),
                     (uint32_t)node, chain, -1,
                     U4{{0u, 0u, 0u, 0u}}};
      } else {
        const size_t plane = (size_t)a.n_nodes * K * G;
        U = Uniforms{a.u + (size_t)c * kPlanes * plane
                         + ((size_t)node * K + k) * G + g,
                     plane, 0u, 0u, 0u, 0u, 0u, -1, U4{{0u, 0u, 0u, 0u}}};
      }
      left = jmin(binomial(ch, q, U, prng ? kPhiloxRounds : kPlaneRounds),
                  ch);
    }
    v[2 * h] = left;
    v[2 * h + 1] = ch - left;
    ++node;
  }

  // Zsum_g partial of this tile: row k's counts summed over its columns
  double* pg = a.part_g + (((size_t)c * a.tiles + tile) * K + k) * N;
#pragma unroll
  for (int n = 0; n < N2; ++n) {
    if (n < N) {
      double s = (double)v[N2 + n];
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
      if (lane == 0 && k < K) pg[n] = s;
    }
  }
  // Zsum_k partial of this k-block: the 8 rows of each column added in
  // order, kChunk columns a pass through shared memory
  double* pk = a.part_k + ((size_t)c * a.kblocks + kb) * N * G;
#pragma unroll
  for (int n0 = 0; n0 < N2; n0 += kChunk) {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) s_cnt[row][j][lane] = v[N2 + n0 + j];
    __syncthreads();
    if (row < kChunk && n0 + row < N && g < G) {
      double s = 0.0;
#pragma unroll
      for (int r = 0; r < kRows; ++r) s += (double)s_cnt[r][row][lane];
      pk[(size_t)(n0 + row) * G + g] = s;
    }
    __syncthreads();
  }
}

// Zsum_g: a warp per (c, k, n), the tiles' partials in a fixed order (lanes
// strided with loads in flight, then an xor butterfly); Zsum_k: a thread per
// (c, n, g), the k-blocks' partials in order. Blocks below zg_blocks do the
// first, kRows outputs each.
__global__ void __launch_bounds__(kThreads)
reduce_zg(Args a, int zg_blocks) {
  const int K = a.K, N = a.N, G = a.G;
  if ((int)blockIdx.x < zg_blocks) {
    const size_t i = (size_t)blockIdx.x * kRows + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    const size_t KN = (size_t)K * N;
    if (i >= (size_t)a.C * KN) return;
    const size_t c = i / KN, kn = i % KN;
    const double* p = a.part_g + c * a.tiles * KN + kn;
    double s = 0.0;
    for (int t0 = 0; t0 < a.tiles; t0 += 32 * kReduceLoads) {
      double x[kReduceLoads];
#pragma unroll
      for (int u = 0; u < kReduceLoads; ++u) {
        const int t = t0 + 32 * u + lane;
        x[u] = t < a.tiles ? p[(size_t)t * KN] : 0.0;
      }
#pragma unroll
      for (int u = 0; u < kReduceLoads; ++u) s += x[u];
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
    if (lane == 0) a.zg[i] = (float)s;
    return;
  }
  const size_t i = (size_t)(blockIdx.x - zg_blocks) * kThreads + threadIdx.x;
  const size_t NG = (size_t)N * G;
  if (i >= (size_t)a.C * NG) return;
  const size_t c = i / NG, ng = i % NG;
  const double* p = a.part_k + c * a.kblocks * NG + ng;
  double s = 0.0;
  for (int b = 0; b < a.kblocks; ++b) s += p[(size_t)b * NG];
  a.zk[i] = (float)s;
}

template <int N2>
cudaError_t launch_alloc(const Args& a, cudaStream_t s) {
  alloc_kernel<N2><<<dim3(a.tiles, a.kblocks, a.C), kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// scratch: C * (tiles * K * N + kblocks * N * G) doubles, tiles =
// ceil(G / 32), kblocks = ceil(K / 8). On a G shard, M, E and the planes
// hold columns [g0, g0 + G) of G_total; an unsharded call passes g0 = 0,
// G_total = G. Philox mode (u == nullptr): uids (C,) int64, the key (k0, k1).
extern "C" int allocate_counts_launch(
    const float* M, const float* P, const float* A, const float* E,
    const float* u, const long long* uids, uint32_t k0, uint32_t k1,
    float* zg, float* zk, double* scratch, int C, int K, int N, int G,
    int g0, int G_total, void* stream) {
  if (N < 1 || N > kMaxN2 || g0 < 0 || g0 + G > G_total ||
      (u == nullptr && uids == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.M = M; a.P = P; a.A = A; a.E = E; a.u = u; a.uids = uids;
  a.k0 = k0; a.k1 = k1;
  a.zg = zg; a.zk = zk;
  a.C = C; a.K = K; a.N = N; a.G = G;
  a.g0 = g0; a.G_total = G_total;
  int n2 = 1;
  while (n2 < N) n2 <<= 1;
  a.n_nodes = n2 > 1 ? n2 - 1 : 1;
  a.tiles = (G + kTileG - 1) / kTileG;
  a.kblocks = (K + kRows - 1) / kRows;
  a.part_g = scratch;
  a.part_k = scratch + (size_t)C * a.tiles * K * N;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  switch (n2) {
    case 1: e = launch_alloc<1>(a, s); break;
    case 2: e = launch_alloc<2>(a, s); break;
    case 4: e = launch_alloc<4>(a, s); break;
    case 8: e = launch_alloc<8>(a, s); break;
    case 16: e = launch_alloc<16>(a, s); break;
    case 32: e = launch_alloc<32>(a, s); break;
    default: e = launch_alloc<64>(a, s); break;
  }
  if (e != cudaSuccess) return (int)e;
  const int zg_blocks = (int)(((size_t)C * K * N + kRows - 1) / kRows);
  const int zk_blocks = (int)(((size_t)C * N * G + kThreads - 1) / kThreads);
  reduce_zg<<<zg_blocks + zk_blocks, kThreads, 0, s>>>(a, zg_blocks);
  return (int)cudaGetLastError();
}
