// Latent-count multinomial allocation of the conjugate Poisson-Gibbs path
// on Hopper (sm_90a): every count M[k, g] split over the N components by a
// binary tree of conditional binomials, keeping only the marginal sums
// Zsum_g (K, N) and Zsum_k (N, G).
//
// (a) Replaces bayesnmf_tpu/ops/pallas_allocation.py::allocate_counts_fused
//     (_alloc_kernel, _binomial_tile, _lgamma_pos): bottom-up node weights
//     over n2 = next_pow2(N) leaves, the total > 0 cell guard, top-down
//     Binomial(count, w_left / w) splits by 40-step CDF inversion when
//     n p <= 10 and by BTRS rejection above (the mode when every round
//     rejects). Two sources of uniforms: pre-drawn planes (C, 17, n2-1, K, G)
//     with 8 BTRS rounds, as the JAX kernel's interpret mode takes them; or
//     an in-kernel Philox4x32-10 stream keyed by a device int64 seed, with
//     its counter (cell, node, block of four, chain), and 8 + 4 rounds, as
//     the TPU core PRNG mode runs.
// (b) What bounds it: operations, and the latency of the splits. Each cell
//     runs N-1 dependent binomial draws (40 inversion steps, or BTRS with
//     two Stirling lgammas a round) on one thread; the bytes (M, E, the
//     outputs) are a few per cell. The tree (2 n2 weights and counts) sits
//     in the thread's local memory.
// (c) What a later PR does about it: keep the tree in registers for a
//     fixed N, split the inversion and BTRS regimes across warps so they do
//     not diverge, and skip the inversion's steps past the count.
//
// Grid: (G tiles of 32 columns, C chains); a block of 8 warps, lane = g
// within the tile, warp = a stride of rows k. Zsum_k[n, g] sums the block's
// rows in double and the 8 warps' partials in order; Zsum_g[k, n] sums the
// tile's 32 columns in double (xor shuffle), writes one partial per tile,
// and a second kernel adds the tiles in order. No atomics: two launches on
// the same inputs give the same bits, and the integer counts are summed
// exactly (the JAX kernel's float32 tile sums round past 2^24).
//
// Numerics: built without --use_fast_math and with -fmad=false; every
// expression in the order and with the roundings of the plain PyTorch
// version (ops/allocation.py), whose divisions are all true divisions.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileG = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kTileG * kWarps;
constexpr int kMaxN2 = 64;
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

// ---- Philox4x32-10 (Salmon et al., SC'11) ----------------------------------

struct U4 {
  uint32_t x[4];
};

__device__ __forceinline__ U4 philox4x32_10(U4 ctr, uint32_t k0,
                                            uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t lo0 = 0xD2511F53u * ctr.x[0];
    const uint32_t hi0 = __umulhi(0xD2511F53u, ctr.x[0]);
    const uint32_t lo1 = 0xCD9E8D57u * ctr.x[2];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, ctr.x[2]);
    ctr = U4{{hi1 ^ ctr.x[1] ^ k0, lo1, hi0 ^ ctr.x[3] ^ k1, lo0}};
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return ctr;
}

// The uniforms of one node's draw: planes[i * stride] in planes mode, else
// the i-th uniform of the node's Philox stream, four per counter block.
// 24 random bits in (0, 1), as the TPU kernel's fresh_uniform.
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
    return (float)(bits.x[i & 3] & 0xFFFFFFu) * F(5.9604644775390625e-8)
           + F(2.98023223876953125e-8);
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

__device__ float binomial(float n, float p, Uniforms& U, int rounds) {
  const bool flip = p > 0.5f;
  const float pp = flip ? 1.0f - p : p;
  float y;
  if (n * pp <= 10.0f) {
    // CDF inversion, 40 steps
    const float u = U.get(0);
    const float ratio = pp / jmax(1.0f - pp, F(1e-12));
    float pmf = expf(n * log1pf(-pp));
    float cdf = pmf, x = 0.0f;
    for (int j = 0; j < kInvSteps; ++j) {
      x = x + (u > cdf ? 1.0f : 0.0f);
      pmf = pmf * (n - (float)j) / ((float)j + 1.0f) * ratio;
      cdf = cdf + pmf;
    }
    y = jmin(x, n);
  } else {
    // BTRS (Hörmann 1993)
    const float spq = sqrtf(n * pp * (1.0f - pp));
    const float b = F(1.15) + F(2.53) * spq;
    const float a = F(-0.0873) + F(0.0248) * b + F(0.01) * pp;
    const float c = n * pp + 0.5f;
    const float vr = F(0.92) - F(4.2) / b;
    const float alpha = (F(2.83) + F(5.1) / b) * spq;
    const float lpq = logf(pp / jmax(1.0f - pp, F(1e-12)));
    const float m = floorf((n + 1.0f) * pp);
    const float h = lgamma_pos(m + 1.0f) + lgamma_pos(n - m + 1.0f);
    y = m;  // every round rejected: the mode
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
      if (ok) {
        y = k;
        break;
      }
    }
  }
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
  const long long* seed;
  float *zg, *zk;
  double* scratch;
  int K, N, G, n2, n_nodes, tiles;
};

__global__ void __launch_bounds__(kThreads)
alloc_kernel(Args a) {
  __shared__ double s_zk[kWarps][kTileG];
  const int tile = blockIdx.x, c = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int K = a.K, N = a.N, G = a.G, n2 = a.n2;
  const int g = tile * kTileG + lane;
  const bool gin = g < G;
  const float* P = a.P + (size_t)c * K * N;
  const float* A = a.A + (size_t)c * N;
  const float* E = a.E + (size_t)c * N * G;
  const bool prng = a.u == nullptr;
  uint32_t k0 = 0, k1 = 0;
  if (prng) {
    const unsigned long long s = (unsigned long long)a.seed[0];
    k0 = (uint32_t)s;
    k1 = (uint32_t)(s >> 32);
  }

  float w[2 * kMaxN2], cnt[2 * kMaxN2];
  double zk[kMaxN2];
  for (int n = 0; n < N; ++n) zk[n] = 0.0;

  for (int k = warp; k < K; k += kWarps) {
    if (gin) {
      for (int n = 0; n < n2; ++n) {
        w[n2 + n] = n < N ? P[k * N + n] * A[n] * E[(size_t)n * G + g] : 0.0f;
      }
      for (int h = n2 - 1; h >= 1; --h) w[h] = w[2 * h] + w[2 * h + 1];
      cnt[1] = w[1] > 0.0f ? a.M[(size_t)k * G + g] : 0.0f;
      int node = 0;
      for (int h = 1; h < n2; ++h) {
        if (padding(h, n2, N)) continue;
        const float ch = cnt[h];
        if (padding(2 * h + 1, n2, N)) {
          cnt[2 * h] = ch;
          continue;
        }
        const float wl = w[2 * h];
        const float q = jmin(jmax(wl / jmax(wl + w[2 * h + 1], F(1e-30)),
                                  0.0f), 1.0f);
        float left;
        if (q <= 0.0f || cnt[h] <= 0.0f) {
          left = 0.0f;
        } else if (q >= 1.0f) {
          left = ch;
        } else {
          Uniforms U;
          if (prng) {
            U = Uniforms{nullptr, 0, k0, k1,
                         (uint32_t)((size_t)k * G + g), (uint32_t)node,
                         (uint32_t)c, -1, U4{{0u, 0u, 0u, 0u}}};
          } else {
            const size_t plane = (size_t)a.n_nodes * K * G;
            U = Uniforms{a.u + (size_t)c * kPlanes * plane
                             + ((size_t)node * K + k) * G + g,
                         plane, 0u, 0u, 0u, 0u, 0u, -1,
                         U4{{0u, 0u, 0u, 0u}}};
          }
          left = jmin(binomial(ch, q, U, prng ? kPhiloxRounds : kPlaneRounds),
                      ch);
        }
        cnt[2 * h] = left;
        cnt[2 * h + 1] = ch - left;
        ++node;
      }
    }
    // Zsum_g partial of this tile: row k's counts summed over its columns
    for (int n = 0; n < N; ++n) {
      double v = gin ? (double)cnt[n2 + n] : 0.0;
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
      if (lane == 0) {
        a.scratch[(((size_t)c * a.tiles + tile) * K + k) * N + n] = v;
      }
      if (gin) zk[n] += (double)cnt[n2 + n];
    }
  }

  // Zsum_k: the 8 warps' partials of each column, added in order
  for (int n = 0; n < N; ++n) {
    s_zk[warp][lane] = zk[n];
    __syncthreads();
    if (warp == 0 && gin) {
      double t = 0.0;
      for (int i = 0; i < kWarps; ++i) t += s_zk[i][lane];
      a.zk[((size_t)c * N + n) * G + g] = (float)t;
    }
    __syncthreads();
  }
}

// Zsum_g: the tiles' partials of each (k, n), added in order
__global__ void reduce_zg(const double* scratch, float* zg, int tiles,
                          int KN) {
  const int c = blockIdx.x;
  for (int i = threadIdx.x; i < KN; i += blockDim.x) {
    double t = 0.0;
    for (int j = 0; j < tiles; ++j) {
      t += scratch[((size_t)c * tiles + j) * KN + i];
    }
    zg[(size_t)c * KN + i] = (float)t;
  }
}

}  // namespace

extern "C" int allocate_counts_launch(
    const float* M, const float* P, const float* A, const float* E,
    const float* u, const long long* seed, float* zg, float* zk,
    double* scratch, int C, int K, int N, int G, void* stream) {
  if (N < 1 || N > kMaxN2) return (int)cudaErrorInvalidValue;
  Args a;
  a.M = M; a.P = P; a.A = A; a.E = E; a.u = u; a.seed = seed;
  a.zg = zg; a.zk = zk; a.scratch = scratch;
  a.K = K; a.N = N; a.G = G;
  int n2 = 1;
  while (n2 < N) n2 <<= 1;
  a.n2 = n2;
  a.n_nodes = n2 > 1 ? n2 - 1 : 1;
  a.tiles = (G + kTileG - 1) / kTileG;
  cudaStream_t s = (cudaStream_t)stream;
  alloc_kernel<<<dim3(a.tiles, C), kThreads, 0, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_zg<<<C, 256, 0, s>>>(scratch, zg, a.tiles, K * N);
  return (int)cudaGetLastError();
}
