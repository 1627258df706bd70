// The chains' counter-based random streams on Hopper (sm_90a): uniforms or
// normals of C chains, each element a pure function of (key, chain uid,
// iteration, site and round, element index), as ops/rng.py lays them out.
//
// (a) Replaces the threefry draws of the JAX package's per-chain keys
//     (jax.random.split / uniform / normal, which XLA runs; no Pallas
//     kernel): the counter of element e of chain c is (e / 4, word1, it,
//     uid[c]) under the key (k0, k1), and the uniform is word e % 4's low
//     24 bits j as max(j / 2^24, tiny). A normal takes block e / 2 and the
//     words (2 (e % 2), 2 (e % 2) + 1) as (u1, u2) of Box-Muller,
//     sqrt(-2 log u1) cos(2 pi u2), in double, rounded to float.
// (b) What bounds it: the bytes written, 4 per element; Philox costs ~25
//     integer operations an element, well under the float rate's share.
// (c) The design: one thread per Philox block, which writes its four
//     uniforms (two normals) as one vector store where the row allows it;
//     under an index map (a mesh rank's block of a one-process draw, or
//     the parts of a flat draw) one thread per element, which computes its
//     own block and keeps one word, so a rank computes only its elements.
//
// Numerics: built without --use_fast_math and with -fmad=false; the
// uniforms are exact and equal the plain version's bit for bit; the
// normals' log, sqrt and cos in double round to float as the plain
// version's almost always do (chip_smoke.py phase 14 states the bound).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float box_muller(uint32_t a, uint32_t b) {
  const double u1 = (double)philox_uniform(a);
  const double u2 = (double)philox_uniform(b);
  const double r = sqrt(-2.0 * log(u1));
  return (float)(r * cos(6.283185307179586 * u2));
}

// out (C, n); thread t of C * blocks: chain t / blocks, Philox block
// t % blocks, its elements [per * block, per * block + per) of the row
template <bool kNormal>
__global__ void __launch_bounds__(kThreads)
fill_kernel(float* out, const long long* uids, long long n, long long blocks,
            long long total, uint32_t k0, uint32_t k1, uint32_t word1,
            uint32_t it) {
  constexpr int kPer = kNormal ? 2 : 4;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const long long c = t / blocks, b = t % blocks;
  const U4 w = philox4x32_10(
      U4{{(uint32_t)b, word1, it, (uint32_t)uids[c]}}, k0, k1);
  float v[4];
  if (kNormal) {
    v[0] = box_muller(w.x[0], w.x[1]);
    v[1] = box_muller(w.x[2], w.x[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = philox_uniform(w.x[i]);
  }
  const long long e = b * kPer;
  float* row = out + c * n;
  if (e + kPer <= n && (n % kPer) == 0) {
    if (kNormal) {
      *reinterpret_cast<float2*>(row + e) = make_float2(v[0], v[1]);
    } else {
      *reinterpret_cast<float4*>(row + e) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (e + i < n) row[e + i] = v[i];
    }
  }
}

// out (C, n); thread t of C * n: chain t / n, element index[t % n] of the
// one-process layout
template <bool kNormal>
__global__ void __launch_bounds__(kThreads)
fill_index_kernel(float* out, const long long* uids, const long long* index,
                  long long n, long long total, uint32_t k0, uint32_t k1,
                  uint32_t word1, uint32_t it) {
  constexpr int kPer = kNormal ? 2 : 4;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const long long c = t / n, i = t % n;
  const long long e = index[i];
  const U4 w = philox4x32_10(
      U4{{(uint32_t)(e / kPer), word1, it, (uint32_t)uids[c]}}, k0, k1);
  const int j = (int)(e % kPer);
  out[t] = kNormal ? box_muller(w.x[2 * j], w.x[2 * j + 1])
                   : philox_uniform(w.x[j]);
}

}  // namespace

// out: (C, n) float32; uids: (C,) int64; index: nullptr or (n,) int64 of
// the elements to draw. normal: 0 uniforms, 1 normals.
extern "C" int philox_fill_launch(float* out, const long long* uids,
                                  const long long* index, long long n, int C,
                                  uint32_t k0, uint32_t k1, uint32_t word1,
                                  uint32_t it, int normal, void* stream) {
  if (n < 0 || C < 0) return (int)cudaErrorInvalidValue;
  if (n == 0 || C == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int per = normal ? 2 : 4;
  const long long total =
      index != nullptr ? (long long)C * n : (long long)C * ((n + per - 1) / per);
  const long long grid = (total + kThreads - 1) / kThreads;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  if (index != nullptr) {
    if (normal) {
      fill_index_kernel<true><<<(unsigned)grid, kThreads, 0, s>>>(
          out, uids, index, n, total, k0, k1, word1, it);
    } else {
      fill_index_kernel<false><<<(unsigned)grid, kThreads, 0, s>>>(
          out, uids, index, n, total, k0, k1, word1, it);
    }
  } else {
    const long long blocks = (n + per - 1) / per;
    if (normal) {
      fill_kernel<true><<<(unsigned)grid, kThreads, 0, s>>>(
          out, uids, n, blocks, total, k0, k1, word1, it);
    } else {
      fill_kernel<false><<<(unsigned)grid, kThreads, 0, s>>>(
          out, uids, n, blocks, total, k0, k1, word1, it);
    }
  }
  return (int)cudaGetLastError();
}
