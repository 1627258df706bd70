// Streaming reductions of the large-G MH sweeps on Hopper (sm_90a): the
// P-column and E-row conditional and acceptance sums, the inclusion-odds
// delta of one A column, and the four sums of the metrics row. No (C, K, G)
// tensor exists: every kernel recomputes its Mhat tile from P*A and an E
// tile and emits only reductions.
//
// (a) Replaces bayesnmf_tpu/ops/pallas_stream_sweeps.py: `_run` (its four
//     bodies _pcol_stats_kernel, _pcol_accept_kernel, _erow_stats_kernel,
//     _erow_accept_kernel), `acol_delta` (_acol_delta_kernel) and
//     `chain_metrics` (_chain_metrics_kernel), with a leading chain axis C
//     on every per-chain operand.
// (b) What bounds it: operations. Per (c, k, g) element a kernel does 2N
//     flops to rebuild Mhat, a division or two and (accept, A, metrics) a
//     log1p or log; it reads data (shared by the chains) and the E tile
//     once. At (K,N,G,C) = (96,20,10000,8) that is ~0.6 GFLOP against
//     ~10 MB of reads per call: far above the card's float32 ridge, so the
//     float32 pipes and the special-function unit bound it, not HBM.
// (c) What a later PR does about it: fuse a column's two passes and its
//     host logic into one kernel per column (the launch rate, not the card,
//     bounds the loop at small C), keep the Mhat tile in registers across
//     the stats and accept passes, and use tensor cores for the Mhat rebuild
//     only if the precision budget allows (TF32 does not: ROADMAP).
//
// Translation of the TPU design. The Pallas kernels carry their sums from
// one G tile to the next in VMEM over a sequential grid (_acc_guard). Hopper
// blocks run in no order, so the grid is (G tiles, C): each block writes
// its tile's partial sums to a scratch buffer that the wrapper allocates,
// and a second small kernel (reduce_tiles) adds the tiles in a fixed order.
// There are no atomics: two launches give the same bits.
//
// Work split inside a block. PA (K x N) and the E tile (N x Gt) are staged
// in shared memory. P-column, A-column and metrics kernels: one warp per row
// k, lanes stride over the tile's g, xor-shuffle sums in double. E-row
// kernels: one thread per g, a loop over k, the (C, G) outputs written
// directly. Every Mhat entry is an explicit loop over n in a fixed order in
// float32 (no tensor cores: TF32 would lose the precision the acceptance
// ratio needs).
//
// Numerics: built with -fmad=false and without --use_fast_math
// (ops/_build.py). Each per-element term is evaluated in the order, and with
// the roundings, of the plain PyTorch version (ops/stream_sweeps.py), and
// the sums accumulate in double and are rounded to float32 once, as the
// plain version sums; the two then agree to a few ulps at any G.
//
// Layout: float32, contiguous. data (K, G) is shared by the chains; E
// (C, N, G); PA (C, K, N); en (C, G); pn (C, K); prop (C, K) for a P column
// or (C, G) for an E row; an (C,). Outputs: P column (n_out, C, K), E row
// (n_out, C, G), A column (C,), metrics (4, C).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kFloor = 1e-6f;

// jnp.maximum: NaN in either operand gives NaN (fmaxf would drop it)
__device__ __forceinline__ float jmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}

__device__ __forceinline__ double warp_allsum(double v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Stage PA[c] (K x N) and the E tile E[c, :, g0:g0+Gt] (N x Gt, zero past
// G) in shared memory.
__device__ void stage(const float* PA, const float* E, float* sPA, float* sE,
                      int c, int K, int N, int G, int Gt, int g0) {
  const float* pa = PA + (size_t)c * K * N;
  for (int i = threadIdx.x; i < K * N; i += blockDim.x) sPA[i] = pa[i];
  const float* e = E + (size_t)c * N * G;
  for (int i = threadIdx.x; i < N * Gt; i += blockDim.x) {
    const int n = i / Gt, g = g0 + i % Gt;
    sE[i] = g < G ? e[(size_t)n * G + g] : 0.0f;
  }
  __syncthreads();
}

// Mhat[k, g0 + gl] = sum_n PA[k, n] * E[n, g0 + gl], n in order, float32
__device__ __forceinline__ float mhat(const float* sPA, const float* sE,
                                      int k, int gl, int N, int Gt) {
  const float* pa = sPA + k * N;
  float mh = pa[0] * sE[gl];
  for (int n = 1; n < N; ++n) mh = mh + pa[n] * sE[n * Gt + gl];
  return mh;
}

// ---- P column: reductions over g, one warp per row k ----------------------
// stats:  mu1 = sum (data - (Mh - pn*en)) / max(Mh, floor) * en,
//         den = sum 1/max(Mh, floor) * en^2
// accept: lp = sum data*log1p(d/lam) - d, mu1_r, den_r at lam_new
// Partial sums per tile go to scratch[((c*T + t)*n_out + j)*K + k].
template <bool kAccept>
__global__ void __launch_bounds__(kThreads)
pcol_kernel(const float* __restrict__ data, const float* __restrict__ E,
            const float* __restrict__ PA, const float* __restrict__ en,
            const float* __restrict__ pn, const float* __restrict__ prop,
            double* __restrict__ scratch, int K, int N, int G, int Gt) {
  extern __shared__ float smem[];
  float* sPA = smem;
  float* sE = smem + K * N;
  const int t = blockIdx.x, c = blockIdx.y, T = gridDim.x;
  const int g0 = t * Gt;
  stage(PA, E, sPA, sE, c, K, N, G, Gt, g0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_out = kAccept ? 3 : 2;
  const float* en_c = en + (size_t)c * G;
  double* out = scratch + ((size_t)c * T + t) * n_out * K;
  for (int k = warp; k < K; k += kWarps) {
    const float pk = pn[(size_t)c * K + k];
    const float qk = kAccept ? prop[(size_t)c * K + k] : 0.0f;
    const float* mk = data + (size_t)k * G;
    double s0 = 0.0, s1 = 0.0, s2 = 0.0;
    for (int gl = lane; gl < Gt; gl += 32) {
      const int g = g0 + gl;
      if (g >= G) break;
      const float e = en_c[g], m = mk[g];
      const float mh = mhat(sPA, sE, k, gl, N, Gt);
      if (!kAccept) {
        const float inv = 1.0f / jmax(mh, kFloor);
        const float resid = m - (mh - pk * e);
        s0 += (double)((resid * inv) * e);
        s1 += (double)(inv * (e * e));
      } else {
        const float mh_no = mh - pk * e;
        const float lam = jmax(mh, kFloor);
        const float lam_new = jmax(mh_no + qk * e, kFloor);
        const float d = lam_new - lam;
        const float invr = 1.0f / lam_new;
        const float resid = m - mh_no;
        s0 += (double)(m * log1pf(d / lam) - d);
        s1 += (double)((resid * invr) * e);
        s2 += (double)(invr * (e * e));
      }
    }
    s0 = warp_allsum(s0);
    s1 = warp_allsum(s1);
    if (kAccept) s2 = warp_allsum(s2);
    if (lane == 0) {
      out[k] = s0;
      out[K + k] = s1;
      if (kAccept) out[2 * K + k] = s2;
    }
  }
}

// ---- E row: reductions over k, one thread per g ----------------------------
// stats:  mu1 = sum_k (data - (Mh - pn*en)) / max(Mh, floor) * pn,
//         den = sum_k 1/max(Mh, floor) * pn^2   (en = A_n * E_n)
// accept: lp, mu1_r, den_r at lam_new = max(Mh_no + pn*prop, floor)
// Writes out[(j*C + c)*G + g] directly.
template <bool kAccept>
__global__ void erow_kernel(const float* __restrict__ data,
                            const float* __restrict__ E,
                            const float* __restrict__ PA,
                            const float* __restrict__ en,
                            const float* __restrict__ pn,
                            const float* __restrict__ prop,
                            float* __restrict__ out, int C, int K, int N,
                            int G, int Gt) {
  extern __shared__ float smem[];
  float* sPA = smem;
  float* sE = smem + K * N;
  const int t = blockIdx.x, c = blockIdx.y;
  const int g0 = t * Gt;
  stage(PA, E, sPA, sE, c, K, N, G, Gt, g0);
  const int gl = threadIdx.x, g = g0 + gl;
  if (g >= G) return;
  const float e = en[(size_t)c * G + g];
  const float q = kAccept ? prop[(size_t)c * G + g] : 0.0f;
  const float* pn_c = pn + (size_t)c * K;
  double s0 = 0.0, s1 = 0.0, s2 = 0.0;
  for (int k = 0; k < K; ++k) {
    const float p = pn_c[k], m = data[(size_t)k * G + g];
    const float mh = mhat(sPA, sE, k, gl, N, Gt);
    if (!kAccept) {
      const float inv = 1.0f / jmax(mh, kFloor);
      const float resid = m - (mh - p * e);
      s0 += (double)((resid * inv) * p);
      s1 += (double)(inv * (p * p));
    } else {
      const float mh_no = mh - p * e;
      const float lam = jmax(mh, kFloor);
      const float lam_new = jmax(mh_no + p * q, kFloor);
      const float d = lam_new - lam;
      const float invr = 1.0f / lam_new;
      const float resid = m - mh_no;
      s0 += (double)(m * log1pf(d / lam) - d);
      s1 += (double)((resid * invr) * p);
      s2 += (double)(invr * (p * p));
    }
  }
  const size_t CG = (size_t)C * G, at = (size_t)c * G + g;
  out[at] = (float)s0;
  out[CG + at] = (float)s1;
  if (kAccept) out[2 * CG + at] = (float)s2;
}

// Block-wide sum of one double per thread, in a fixed order: warp shuffles,
// then warp 0 adds the warps' partials in order. Valid in thread 0.
__device__ double block_sum(double v, double* sred) {
  v = warp_allsum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) sred[warp] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) s += sred[w];
  }
  return s;
}

// ---- A column: sum over k and g of data*log1p(d/lam_off) - d --------------
// with contrib = pn*en, Mh_off = Mh - an*contrib, lam_off = max(Mh_off,
// floor), lam_on = max(Mh_off + contrib, floor), d = lam_on - lam_off.
// Partial per tile to scratch[c*T + t].
__global__ void __launch_bounds__(kThreads)
acol_kernel(const float* __restrict__ data, const float* __restrict__ E,
            const float* __restrict__ PA, const float* __restrict__ en,
            const float* __restrict__ pn, const float* __restrict__ an,
            double* __restrict__ scratch, int K, int N, int G, int Gt) {
  extern __shared__ float smem[];
  __shared__ double sred[kWarps];
  float* sPA = smem;
  float* sE = smem + K * N;
  const int t = blockIdx.x, c = blockIdx.y, T = gridDim.x;
  const int g0 = t * Gt;
  stage(PA, E, sPA, sE, c, K, N, G, Gt, g0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float a = an[c];
  const float* en_c = en + (size_t)c * G;
  double s = 0.0;
  for (int k = warp; k < K; k += kWarps) {
    const float pk = pn[(size_t)c * K + k];
    const float* mk = data + (size_t)k * G;
    for (int gl = lane; gl < Gt; gl += 32) {
      const int g = g0 + gl;
      if (g >= G) break;
      const float mh = mhat(sPA, sE, k, gl, N, Gt);
      const float contrib = pk * en_c[g];
      const float mh_off = mh - a * contrib;
      const float lam_off = jmax(mh_off, kFloor);
      const float lam_on = jmax(mh_off + contrib, kFloor);
      const float d = lam_on - lam_off;
      s += (double)(mk[g] * log1pf(d / lam_off) - d);
    }
  }
  s = block_sum(s, sred);
  if (threadIdx.x == 0) scratch[(size_t)c * T + t] = s;
}

// ---- the metrics row's four sums -------------------------------------------
// sum data*log(lam), sum lam, sum max(data, 1e-6)*log(lam), sum (Mh-data)^2
// with lam = max(Mh, floor). Partials to scratch[(c*T + t)*4 + j].
__global__ void __launch_bounds__(kThreads)
metrics_kernel(const float* __restrict__ data, const float* __restrict__ E,
               const float* __restrict__ PA, double* __restrict__ scratch,
               int K, int N, int G, int Gt) {
  extern __shared__ float smem[];
  __shared__ double sred[kWarps];
  float* sPA = smem;
  float* sE = smem + K * N;
  const int t = blockIdx.x, c = blockIdx.y, T = gridDim.x;
  const int g0 = t * Gt;
  stage(PA, E, sPA, sE, c, K, N, G, Gt, g0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double s0 = 0.0, s1 = 0.0, s2 = 0.0, s3 = 0.0;
  for (int k = warp; k < K; k += kWarps) {
    const float* mk = data + (size_t)k * G;
    for (int gl = lane; gl < Gt; gl += 32) {
      const int g = g0 + gl;
      if (g >= G) break;
      const float m = mk[g];
      const float mh = mhat(sPA, sE, k, gl, N, Gt);
      const float lam = jmax(mh, kFloor);
      const float L = logf(lam);
      const float d = mh - m;
      s0 += (double)(m * L);
      s1 += (double)lam;
      s2 += (double)(jmax(m, 1e-6f) * L);
      s3 += (double)(d * d);
    }
  }
  double* out = scratch + ((size_t)c * T + t) * 4;
  s0 = block_sum(s0, sred);
  if (threadIdx.x == 0) out[0] = s0;
  s1 = block_sum(s1, sred);
  if (threadIdx.x == 0) out[1] = s1;
  s2 = block_sum(s2, sred);
  if (threadIdx.x == 0) out[2] = s2;
  s3 = block_sum(s3, sred);
  if (threadIdx.x == 0) out[3] = s3;
}

// ---- second pass: add the tiles in order, round once -----------------------
// scratch[(c*T + t)*W + w] -> out[((w / inner)*C + c)*inner + w % inner]
__global__ void reduce_tiles(const double* __restrict__ scratch,
                             float* __restrict__ out, int C, int T, int W,
                             int inner) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C * W) return;
  const int c = i / W, w = i % W;
  const double* s = scratch + (size_t)c * T * W + w;
  double acc = 0.0;
  for (int t = 0; t < T; ++t) acc += s[(size_t)t * W];
  out[((size_t)(w / inner) * C + c) * inner + w % inner] = (float)acc;
}

size_t smem_bytes(int K, int N, int Gt) {
  return (size_t)(K * N + N * Gt) * sizeof(float);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

cudaError_t reduce(const double* scratch, float* out, int C, int T, int W,
                   int inner, cudaStream_t s) {
  const int n = C * W, threads = 256;
  reduce_tiles<<<(n + threads - 1) / threads, threads, 0, s>>>(
      scratch, out, C, T, W, inner);
  return cudaGetLastError();
}

int n_tiles(int G, int Gt) { return (G + Gt - 1) / Gt; }

}  // namespace

// P column. prop == nullptr: pcol_stats (2 outputs); else pcol_accept (3).
// scratch: C * n_tiles * n_out * K doubles; out: n_out * C * K floats.
extern "C" int stream_pcol_launch(const float* data, const float* E,
                                  const float* PA, const float* en,
                                  const float* pn, const float* prop,
                                  double* scratch, float* out, int C, int K,
                                  int N, int G, int Gt, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = smem_bytes(K, N, Gt);
  const int T = n_tiles(G, Gt);
  const dim3 grid(T, C);
  cudaError_t e;
  int n_out;
  if (prop == nullptr) {
    n_out = 2;
    if ((e = allow_smem(pcol_kernel<false>, smem)) != cudaSuccess) return e;
    pcol_kernel<false><<<grid, kThreads, smem, s>>>(data, E, PA, en, pn,
                                                    prop, scratch, K, N, G,
                                                    Gt);
  } else {
    n_out = 3;
    if ((e = allow_smem(pcol_kernel<true>, smem)) != cudaSuccess) return e;
    pcol_kernel<true><<<grid, kThreads, smem, s>>>(data, E, PA, en, pn, prop,
                                                   scratch, K, N, G, Gt);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return reduce(scratch, out, C, T, n_out * K, K, s);
}

// E row. prop == nullptr: erow_stats (2 outputs); else erow_accept (3).
// Gt threads per block; out: n_out * C * G floats.
extern "C" int stream_erow_launch(const float* data, const float* E,
                                  const float* PA, const float* en,
                                  const float* pn, const float* prop,
                                  float* out, int C, int K, int N, int G,
                                  int Gt, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = smem_bytes(K, N, Gt);
  const dim3 grid(n_tiles(G, Gt), C);
  cudaError_t e;
  if (prop == nullptr) {
    if ((e = allow_smem(erow_kernel<false>, smem)) != cudaSuccess) return e;
    erow_kernel<false><<<grid, Gt, smem, s>>>(data, E, PA, en, pn, prop, out,
                                              C, K, N, G, Gt);
  } else {
    if ((e = allow_smem(erow_kernel<true>, smem)) != cudaSuccess) return e;
    erow_kernel<true><<<grid, Gt, smem, s>>>(data, E, PA, en, pn, prop, out,
                                             C, K, N, G, Gt);
  }
  return (int)cudaGetLastError();
}

// A column: scratch C * n_tiles doubles; out C floats.
extern "C" int stream_acol_launch(const float* data, const float* E,
                                  const float* PA, const float* en,
                                  const float* pn, const float* an,
                                  double* scratch, float* out, int C, int K,
                                  int N, int G, int Gt, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = smem_bytes(K, N, Gt);
  const int T = n_tiles(G, Gt);
  cudaError_t e;
  if ((e = allow_smem(acol_kernel, smem)) != cudaSuccess) return e;
  acol_kernel<<<dim3(T, C), kThreads, smem, s>>>(data, E, PA, en, pn, an,
                                                 scratch, K, N, G, Gt);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return reduce(scratch, out, C, T, 1, 1, s);
}

// Metrics: scratch C * n_tiles * 4 doubles; out 4 * C floats.
extern "C" int stream_metrics_launch(const float* data, const float* E,
                                     const float* PA, double* scratch,
                                     float* out, int C, int K, int N, int G,
                                     int Gt, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = smem_bytes(K, N, Gt);
  const int T = n_tiles(G, Gt);
  cudaError_t e;
  if ((e = allow_smem(metrics_kernel, smem)) != cudaSuccess) return e;
  metrics_kernel<<<dim3(T, C), kThreads, smem, s>>>(data, E, PA, scratch, K,
                                                    N, G, Gt);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return reduce(scratch, out, C, T, 4, 1, s);
}
