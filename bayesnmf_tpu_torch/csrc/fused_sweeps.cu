// One Gibbs iteration core of the Poisson + MH sampler on Hopper (sm_90a):
// the exact Mu/Sigmasq hyper-sweep, N sequential P-column and N sequential
// E-row Metropolis-Hastings updates, and with rank learning the rank draw R
// and the N sequential inclusion updates of A.
//
// (a) Replaces bayesnmf_tpu/ops/pallas_sweeps.py::_sweep_kernel in full:
//     the TruncNormal or the exponential prior, the exact or the
//     reference-parity (exact_mh=False) Hastings ratio, a fixed rank or the
//     SBFI/BFI R/A branch, with the accept-all warmup flag and the
//     temperature as data (rank_pack[c, 0, 1] and rank_pack[c, 0, 0]).
// (b) What bounds it: latency. The 2N column updates and the N inclusion
//     updates are a chain of 3N dependent steps, each two reductions (or
//     one), a proposal, a decision and a rank-1 update over K*G entries; the
//     work of a step is small (K*G*~40 operations), so what counts is how
//     many threads share it and how far its operands are.
// (c) What the design does about it: one thread-block cluster per chain, the
//     G axis split across its S blocks (S = 1..16 by G, ops/fused_sweeps.py::
//     cluster_config), each block's slices of data and Mhat resident in
//     shared memory (2 x K x G/S floats), loaded once, Mhat written back once
//     at the end -- the analogue of the TPU kernel keeping every (K, G)
//     operand in VMEM. Where the slices do not fit the SM's 227 KB the same
//     code reads them in global memory (row stride G instead of G/S).
//     P, the P-side prior pair, A and the block's slice of E live in shared
//     memory too; every block holds the same bits of P and A.
//     Large K (above 96 rows where a cluster's block cannot hold P, its
//     prior pair and the pushed partials, 3 K N floats and S K 5 doubles:
//     K = 192 at N >= 40, 288 at N >= 8, 1536 at any N; ops/fused_sweeps.py
//     ::grid_form): the grid form (fused_grid_kernel, below). A cluster of
//     at most 16 blocks left 116 of 132 SMs idle, and its blocks re-read
//     their 1 MB data and Mhat slices and their own copies of P from L2 on
//     every pass (29.4 ms at (1536,20,2780) with the rank branch). The grid
//     form spreads a chain over up to one block per SM (127 blocks of 22
//     columns there), so a block's Mhat slice fits its shared memory again;
//     P and its pair live once, each row's decision made by one owner
//     block, and the partials cross the blocks through L2 at a barrier of
//     the chain's own on a device counter (four a P column, one an A
//     column): 2.2 ms there. What bounds it: those ~100 barriers a sweep at
//     N = 20, each a round trip through L2, and the exchange, then a
//     block's passes over its K x 22 entries with the data slice read from
//     L2. Several chains take the card in turns, as many a launch as keep
//     their Mhat slices resident (grid_config): 8 chains at 1536 x 2780 run
//     one after another, 18.3 ms, where 16 blocks each with its slices in
//     global memory took 48 ms.
//
// Work split inside a block of 512 threads:
//   hyper-sweep  (K,N): every block computes all of it for its own copy
//                (block 0 writes it out); (N,G): a block does its slice;
//   P column n   one warp per row k, lanes stride over the block's g, double
//                sums, xor-shuffle; lanes 0..S-1 push the row's partials into
//                every block's shared memory (distributed shared memory);
//                after a cluster barrier every block adds the S partials in
//                rank order, draws the same proposal, and after the second
//                reduction takes the same decision; each block applies the
//                rank-1 update to its own Mhat slice. Two cluster barriers
//                per column;
//   E row n      no step crosses blocks: a block updates its own g. The K
//                rows are split over up to 8 threads per g (by warp, so that
//                lanes stay on consecutive g), whose partials meet in shared
//                memory in a fixed order;
//   R draw       every thread evaluates the (N+1)-entry ladder;
//   A column n   one warp per row k over the block's g, a block-wide sum in a
//                fixed order, pushed to every block; after one cluster
//                barrier every thread adds the S partials in rank order; the
//                rank-1 rewrite is local.
// Sums accumulate in double, in a fixed order, with no atomics, so two
// launches on the same inputs give the same bits.
//
// What is left: the P-side hyper-sweep and each column's proposal and
// decision are computed by every block (K values on K threads, the rest of
// the block idle); a cluster barrier costs about as much as a column's
// arithmetic at the 32 columns of G a block owns; chains in a batch run as
// separate clusters, of which the card keeps only a few resident at 16
// blocks each. The grid form's P sweep needs its four barriers a column
// only because a block owns columns of G: blocks owning rows of K, with
// Mhat passed between the two ownerships once before the E sweep, would
// need none (not built).
//
// Layout: every operand is float32 and contiguous. State and uniforms carry
// a leading chain axis C; data (K,G) and the hyperprior planes are shared.
// The kernel reads the inputs and writes the outputs, which the caller
// allocated. With the exponential prior hp0 holds Lambda and hp1 is not
// read.
//
// Numerics: built without --use_fast_math and with -fmad=false (ops/_build.py).
// The special functions are the JAX package's own formulas
// (pallas_special.py). Every expression is evaluated in the order, and with
// the roundings, of the plain PyTorch version on the card (which divides by
// a constant as a multiplication by its reciprocal), so the two agree to
// rounding; a 1-ulp change in a proposal moves the log acceptance ratio by
// ~1e-4 at G = 2780.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kFloor = 1e-6f;
constexpr float kEps = 1e-30f;
constexpr float kTiny = 1.2e-38f;
// PyTorch's CUDA division by a scalar multiplies by its float reciprocal
constexpr float kInvSqrt2Pi = 1.0f / 2.5066282746310002f;
constexpr float kInvThree = 1.0f / 3.0f;
constexpr float kLogSqrt2Pi = 0.9189385332046727f;

enum Prior { kTruncNormal = 0, kExponential = 1 };
enum RankMethod { kFixedRank = 0, kSBFI = 1, kBFI = 2 };

struct Args {
  const float* data;
  const float *P, *E, *A, *Mh, *accP, *accE;
  const float *UprP, *UprE, *UpP, *UaP, *UpE, *UaE;
  const float *hp0p, *hp1p, *hp0e, *hp1e;
  const float* rank_pack;
  const float *Hup, *Hue, *Hhpp, *Hhpe;
  int hyper, prior, exact, rank;
  float sbfi_pen;
  float *P_o, *E_o, *Mh_o, *accP_o, *accE_o, *A_o, *R_o, *nan_o;
  float *hp0p_o, *hp1p_o, *hp0e_o, *hp1e_o;
  int K, N, G;
  // what sits in shared memory: bit 0 the data slice, bit 1 the E slice,
  // bit 2 the Mhat slice (the cluster form keeps data and Mhat together)
  int resident;
  // the grid form: its first chain, and its per-chain scratch
  // (grid_scratch): the pushed partials, the columns' conditionals and
  // proposals, the exponential prior's flags, the NaN counts, and the
  // barrier counters
  int c0;
  double* xg;
  float* wg;
  unsigned* bar;
};

// jnp.maximum / jnp.minimum: NaN in either operand gives NaN (fmaxf and
// fminf would return the other operand), so a NaN reaches the acceptance
// ratio and its clamp counter exactly as in the reference.
__device__ __forceinline__ float jmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fminf(a, b);
}

// ---- pallas_special.py formulas -------------------------------------------

__device__ __forceinline__ float acklam_tail(float q) {
  return (((((-7.784894002430293e-03f * q - 3.223964580411365e-01f) * q
             - 2.400758277161838e00f) * q - 2.549732539343734e00f) * q
           + 4.374664141464968e00f) * q + 2.938163982698783e00f) /
         ((((7.784695709041462e-03f * q + 3.224671290700398e-01f) * q
            + 2.445134137142996e00f) * q + 3.754408661907416e00f) * q + 1.0f);
}

// ps.ndtri: Acklam, p clamped to [1.2e-38, 1 - 1.2e-7]
__device__ float ps_ndtri(float p) {
  p = jmin(jmax(p, kTiny), (float)(1.0 - 1.2e-7));
  if (p < 0.02425f) return acklam_tail(sqrtf(-2.0f * logf(jmax(p, kTiny))));
  if (p > (float)(1.0 - 0.02425)) {
    return -acklam_tail(sqrtf(-2.0f * logf(jmax(1.0f - p, kTiny))));
  }
  const float q = p - 0.5f;
  const float r = q * q;
  return (((((-3.969683028665376e01f * r + 2.209460984245205e02f) * r
             - 2.759285104469687e02f) * r + 1.383577518672690e02f) * r
           - 3.066479806614716e01f) * r + 2.506628277459239e00f) * q /
         (((((-5.447609879822406e01f * r + 1.615858368580409e02f) * r
             - 1.556989798598866e02f) * r + 6.680131188771972e01f) * r
           - 1.328068155288572e01f) * r + 1.0f);
}

// ps.ndtr: Abramowitz-Stegun 7.1.26
__device__ float ps_ndtr(float x) {
  const float z = fabsf(x);
  const float t = 1.0f / (1.0f + 0.2316419f * z);
  const float poly = t * (0.319381530f + t * (-0.356563782f + t * (
      1.781477937f + t * (-1.821255978f + t * 1.330274429f))));
  const float pdf = expf(-0.5f * z * z) * kInvSqrt2Pi;
  const float upper = 1.0f - pdf * poly;
  return x >= 0.0f ? upper : 1.0f - upper;
}

// ops/distributions.py::_ndtr: erfc in both tails, each op rounded alone;
// the truncated-normal proposal's tail mass (ps_ndtr(-alpha) cancels to 0
// from alpha ~ 5.5)
__device__ float port_ndtr(float x) {
  const float z = x * 0.7071067811865476f;
  const float a = fabsf(z);
  float y;
  if (a < 0.7071067811865476f) {
    y = 1.0f + erff(z);
  } else {
    y = z > 0.0f ? 2.0f - erfcf(a) : erfcf(a);
  }
  return 0.5f * y;
}

// ps.log_ndtr: asymptotic series below -4
__device__ float ps_log_ndtr(float x) {
  if (x < -4.0f) {
    const float ix2 = 1.0f / (x * x);
    return -0.5f * x * x - logf(-x) - kLogSqrt2Pi
           + log1pf(-ix2 * (1.0f - 3.0f * ix2));
  }
  return logf(jmax(ps_ndtr(x), 1e-38f));
}

// ---- pallas_sweeps.py helpers ----------------------------------------------

// _ndtri: erfinv in the centre, Acklam in the tails
__device__ float ndtri(float p) {
  if (p < 0.02425f || p > 0.97575f) return ps_ndtri(p);
  return 1.4142135623730951f * erfinvf(2.0f * p - 1.0f);
}

// _truncnorm_icdf: TruncNormal[0, inf) by inverse CDF; beyond alpha = 8 the
// Exp(1)/alpha deep-tail limit reuses the same uniform; the tail mass is
// erfc's (port_ndtr)
__device__ float truncnorm_icdf(float u, float mu, float sd) {
  const float alpha = -mu / sd;
  float z;
  if (alpha > 8.0f) {
    const float a_safe = jmax(alpha, 1.0f);
    z = a_safe - logf(jmax(u, kTiny)) / a_safe;
  } else {
    const float tail = port_ndtr(-alpha);
    const float v = jmax(u * tail, kTiny);
    z = jmax(-ndtri(v), alpha);
  }
  return jmax(mu + sd * z, 0.0f);
}

__device__ float tn_logpdf(float x, float mu, float var) {
  const float sd = sqrtf(var);
  const float z = (x - mu) / sd;
  return -0.5f * z * z - logf(sd) - kLogSqrt2Pi - ps_log_ndtr(mu / sd);
}

// prior_draw_of: the prior draw of an excluded column, or of the
// exponential prior's inactive one (pallas_sweeps.py:174-177)
__device__ __forceinline__ float prior_draw(int prior, float u, float hp0,
                                            float hp1) {
  if (prior == kExponential) return -logf(u) / hp0;
  return truncnorm_icdf(u, hp0, sqrtf(hp1));
}

// _hyper_sweep_side for one element. hhp: the 4 hyperprior planes at this
// element (stride `plane`); hu: the 4 uniform planes.
__device__ void hyper_elem(float x, float mu_old, float sq_old,
                           const float* hhp, const float* hu, int plane,
                           float* mu_out, float* sq_out) {
  const float m0 = hhp[0], s0 = hhp[plane];
  const float a0 = hhp[2 * plane], b0 = hhp[3 * plane];
  const float z_mu = ndtri(hu[0]);
  const float lu_mu = logf(hu[plane]);
  const float z_sq = ndtri(hu[2 * plane]);
  const float lu_sq = logf(hu[3 * plane]);

  const float den = 1.0f / s0 + 1.0f / sq_old;
  const float prop = (m0 / s0 + x / sq_old) / den + sqrtf(1.0f / den) * z_mu;
  const float sd = sqrtf(sq_old);
  const float la = ps_log_ndtr(mu_old / sd) - ps_log_ndtr(prop / sd);
  const float mu_new = lu_mu < la ? prop : mu_old;

  const float a = a0 + 0.5f;
  const float b = b0 + 0.5f * (x - mu_new) * (x - mu_new);
  const float c = 1.0f - 1.0f / (9.0f * a);
  const float sqa3 = 3.0f * sqrtf(a);
  const float t_new = c + z_sq / sqa3;
  const float g_new = a * t_new * t_new * t_new;
  const bool ok = g_new > 1e-30f;
  const float g_new_s = jmax(g_new, 1e-30f);
  const float sq_new = b / g_new_s;
  const float g_old = b / jmax(sq_old, 1e-30f);
  const float t_old = expf(logf(jmax(g_old / a, 1e-38f)) * kInvThree);
  const float z_old = sqa3 * (t_old - c);
  float la2 = -INFINITY;
  if (ok) {
    const float w_new = (a - 1.0f) * logf(g_new_s) - g_new_s
                        + 0.5f * z_sq * z_sq
                        + 2.0f * logf(jmax(t_new, 1e-30f))
                        - ps_log_ndtr(mu_new / sqrtf(sq_new));
    const float w_old = (a - 1.0f) * logf(g_old) - g_old
                        + 0.5f * z_old * z_old
                        + 2.0f * logf(jmax(t_old, 1e-30f))
                        - ps_log_ndtr(mu_new / sqrtf(sq_old));
    la2 = w_new - w_old;
  }
  *mu_out = mu_new;
  *sq_out = lu_sq < la2 ? sq_new : sq_old;
}

// ---- the per-element terms of the column reductions ------------------------
// Summed in double. Built with -fmad=false, each product and sum is rounded
// on its own, as the plain PyTorch version rounds it; the two versions then
// agree to the rounding of the final float at any G (in float32 with FMAs
// the acceptance probability at G = 2780 differs by ~4e-4).

struct Terms {
  float mu1, den, lp;
};

// reductions for the conditional at the current value:
// mu1 += ((M - (Mh - old*o)) / max(Mh, floor)) * o,  den += o*o / max(...)
__device__ __forceinline__ Terms pass1_terms(float m, float h, float old,
                                             float o) {
  const float sig = jmax(h, kFloor);
  return {((m - (h - old * o)) / sig) * o, o * o / sig, 0.0f};
}

// the same reductions at the proposal, plus the Poisson log-likelihood
// change M*log1p(d/lam_o) - d (exact Hastings ratio); with exact = 0 only
// lp, which then also carries the reference's normal-model terms
// (pallas_sweeps.py:241-250)
__device__ __forceinline__ Terms pass2_terms(float m, float h, float old,
                                             float dp, float o, int exact) {
  const float hp = h + dp * o;
  const float lam_o = jmax(h, kFloor);
  const float lam_n = jmax(hp, kFloor);
  const float d = lam_n - lam_o;
  const float lp = m * log1pf(d / lam_o) - d;
  if (exact) return {((m - (h - old * o)) / lam_n) * o, o * o / lam_n, lp};
  const float vs_o = jmax(hp, 1.0f), vs_n = jmax(h, 1.0f);
  const float r_o = m - h, r_n = m - hp;
  return {0.0f, 0.0f,
          lp + (-0.5f * r_o * r_o / vs_o - 0.5f * logf(vs_o))
             - (-0.5f * r_n * r_n / vs_n - 0.5f * logf(vs_n))};
}

__device__ __forceinline__ double warp_allsum(double v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Sum over the block: warp sums, then the kWarps partials in order by every
// thread, so every thread holds the same bits.
__device__ double block_allsum(double v, double* s_red) {
  v = warp_allsum(v);
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  double t = 0.0;
  for (int w = 0; w < kWarps; ++w) t += s_red[w];
  __syncthreads();
  return t;
}

// The conditional of one column entry: its mean and variance from the two
// reductions (pallas_sweeps.py:196-203).
__device__ __forceinline__ void conditional(int prior, float mu1, float den,
                                            float hp0, float hp1, float* mu,
                                            float* var) {
  if (prior == kExponential) {
    const float den_s = jmax(den, kEps);
    *mu = (mu1 - hp0) / den_s;
    *var = 1.0f / den_s;
  } else {
    const float den2 = den + 1.0f / hp1;
    *mu = (mu1 + hp0 / hp1) / den2;
    *var = 1.0f / den2;
  }
}

// The acceptance step shared by both sweeps (pallas_sweeps.py:220-260):
// returns the new value and writes the recorded acceptance; counts a NaN
// ratio (clamped to 0) into *n_nan. ``lp_sum`` is the whole log ratio when
// exact = 0; ``inactive`` marks the exponential prior's prior-draw proposal.
__device__ float mh_decide(int prior, int exact, bool inactive, float old,
                           float prop, float mu, float var, float mu1_r,
                           float den_r, float lp_sum, float hp0, float hp1,
                           float u_acc, bool acc_on, float* rec,
                           float* n_nan) {
  float log_ratio = lp_sum;
  if (exact) {
    float mu_r, var_r, lprior;
    conditional(prior, mu1_r, den_r, hp0, hp1, &mu_r, &var_r);
    if (prior == kExponential) {
      lprior = -hp0 * (prop - old);
    } else {
      lprior = tn_logpdf(prop, hp0, hp1) - tn_logpdf(old, hp0, hp1);
    }
    log_ratio = lp_sum + lprior + tn_logpdf(old, mu_r, var_r)
                - tn_logpdf(prop, mu, var);
    if (inactive) log_ratio = 0.0f;
  }
  const float e = expf(log_ratio);
  float ratio;
  if (isnan(e)) {
    ratio = 0.0f;
    *n_nan += 1.0f;
  } else {
    ratio = jmin(e, 1.0f);
  }
  *rec = acc_on ? 1.0f : ratio;
  return (acc_on || u_acc < ratio) ? prop : old;
}

// The rank draw R by Gumbel-max over the ladder r = 0..N, the index by
// sum-select, from A and the rank pack (its temperature and noise), and the
// logit of R's inclusion probability (pallas_sweeps.py:316-340).
__device__ void rank_draw(const float* rp, const float* sA, int N, float* R,
                          float* logit_p1) {
  const float temp = rp[0];
  const float fN = (float)N;
  const float lo = 0.4f / fN, hi = 1.0f - 0.4f / fN;
  float sumA = 0.0f;
  for (int n = 0; n < N; ++n) sumA += sA[n];
  float mx = -INFINITY;
  for (int r = 0; r <= N; ++r) {
    const float p1r = jmin(jmax((float)r / fN, lo), hi);
    const float s = temp * (sumA * logf(p1r) + (fN - sumA) * logf(1.0f - p1r))
                    + rp[N + 1 + r];
    mx = jmax(mx, s);
  }
  float r_sel = 0.0f;
  for (int r = 0; r <= N; ++r) {
    const float p1r = jmin(jmax((float)r / fN, lo), hi);
    const float s = temp * (sumA * logf(p1r) + (fN - sumA) * logf(1.0f - p1r))
                    + rp[N + 1 + r];
    r_sel += s >= mx ? (float)r : 0.0f;
  }
  const float p1 = jmin(jmax(r_sel / fN, lo), hi);
  *R = r_sel;
  *logit_p1 = logf(p1) - log1pf(-p1);
}

// Threads per g of an E-row update: the largest power of two up to 8 that
// keeps tpg * roundup32(Gq) within the block.
__host__ __device__ inline int threads_per_g(int Gq) {
  const int g32 = (Gq + 31) / 32 * 32;
  int tpg = 8;
  while (tpg > 1 && tpg * g32 > kThreads) tpg >>= 1;
  return tpg;
}

// Shared memory of a block beside the two slices, in bytes: as doubles the
// pushed partials of a P column's two reductions (S x K x 2, S x K x 3), of
// an A column (2 x S), the block-sum scratch (kWarps) and the E row's
// partials (kThreads x 3); as floats P and its prior pair (3 x K x N), the E
// slice (N x Gq, when resident), a column's mu, var, proposal and new value
// (4 x K), an E row's proposal step, value step and flag (3 x kThreads), A
// (N), the NaN counts (kThreads + S) and the inactive flags (S).
__host__ __device__ inline size_t fixed_smem_bytes(int K, int N, int Gq,
                                                  int S, bool e_resident) {
  const size_t doubles = (size_t)S * K * 5 + 2 * S + kWarps + kThreads * 3;
  const size_t floats = (size_t)3 * K * N + (e_resident ? (size_t)N * Gq : 0)
                        + 4 * K + 3 * kThreads + N + kThreads + 2 * S;
  return doubles * sizeof(double) + floats * sizeof(float);
}

// A pushed partial: into every block's shared memory (lanes 0..S-1 of the
// row's warp). xb: this block's array.
__device__ __forceinline__ void push_partials(
    cg::cluster_group& cluster, double* xb, int S, int lane, size_t at,
    const double* v, int nv) {
  if (lane < S) {
    double* x = cluster.map_shared_rank(xb, lane) + at;
    for (int j = 0; j < nv; ++j) x[j] = v[j];
  }
}

// The cluster form: one thread-block cluster per chain.
__global__ void __launch_bounds__(kThreads)
fused_sweeps_kernel(Args a) {
  extern __shared__ double smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int K = a.K, N = a.N, G = a.G;
  const int KN = K * N, NG = N * G, KG = K * G;
  const int prior = a.prior, exact = a.exact;
  const bool expo = prior == kExponential;
  // this block's columns [gb, gb + Gs) of the chain's G
  const int Gq = (G + S - 1) / S;
  const int gb = rank * Gq < G ? rank * Gq : G;
  const int Gs = G - gb < Gq ? G - gb : Gq;

  double* xb1 = smem;                          // [S][K][2]
  double* xb2 = xb1 + (size_t)S * K * 2;       // [S][K][3]
  double* xa = xb2 + (size_t)S * K * 3;        // [2][S]
  double* s_red = xa + 2 * S;                  // [kWarps]
  double* s_ep = s_red + kWarps;               // [kThreads][3]
  float* sP = reinterpret_cast<float*>(s_ep + kThreads * 3);  // [K][N]
  float* sHp0 = sP + KN;
  float* sHp1 = sHp0 + KN;
  float* sE = sHp1 + KN;                       // [N][Gq] when resident
  const bool e_resident = (a.resident & 2) != 0;
  float* s_mu = sE + (e_resident ? (size_t)N * Gq : 0);  // [K] each
  float* s_var = s_mu + K;
  float* s_prp = s_var + K;
  float* s_new = s_prp + K;
  float* s_dp = s_new + K;                     // [kThreads] each
  float* s_dv = s_dp + kThreads;
  float* s_do = s_dv + kThreads;
  float* sA = s_do + kThreads;                 // [N]
  float* s_nan = sA + N;                       // [kThreads]
  float* x_nan = s_nan + kThreads;             // [S], summed by block 0
  int* x_flag = reinterpret_cast<int*>(x_nan + S);  // [S]
  float* slices = reinterpret_cast<float*>(x_flag + S);

  const float* A = a.A + (size_t)c * N;
  const float* rp = a.rank_pack + (size_t)c * 3 * (N + 1);
  const bool acc_on = rp[1] > 0.0f;
  const size_t okn = (size_t)c * KN, ong = (size_t)c * NG;
  float* P_o = a.P_o + okn;
  float* accP = a.accP_o + okn;
  float* E_o = a.E_o + ong;
  float* accE = a.accE_o + ong;
  float* hp0e = a.hp0e_o + ong;
  float* hp1e = a.hp1e_o + ong;
  float n_nan = 0.0f;

  // the E, data and Mhat slices: in shared memory (row stride Gq), or in
  // global memory (row stride G) where they do not fit
  float* Ep = e_resident ? sE : E_o + gb;
  const int lde = e_resident ? Gq : G;
  const float* Mp;
  float* Hp;
  int ld;
  if (a.resident & 1) {
    ld = Gq;
    float* sM = slices;
    float* sH = slices + (size_t)K * Gq;
    for (int i = tid; i < K * Gs; i += kThreads) {
      const int k = i / Gs, gl = i % Gs;
      sM[k * ld + gl] = a.data[(size_t)k * G + gb + gl];
      sH[k * ld + gl] = a.Mh[(size_t)c * KG + (size_t)k * G + gb + gl];
    }
    Mp = sM;
    Hp = sH;
  } else {
    ld = G;
    Mp = a.data + gb;
    Hp = a.Mh_o + (size_t)c * KG + gb;
    for (int i = tid; i < K * Gs; i += kThreads) {
      const int k = i / Gs, gl = i % Gs;
      Hp[(size_t)k * ld + gl] = a.Mh[(size_t)c * KG + (size_t)k * G + gb + gl];
    }
  }

  // ---- copy state in; the hyper-sweep reads the pre-sweep P and E --------
  for (int i = tid; i < KN; i += kThreads) {
    sP[i] = a.P[okn + i];
    if (a.hyper) {
      hyper_elem(a.P[okn + i], a.hp0p[okn + i], a.hp1p[okn + i], a.Hhpp + i,
                 a.Hup + (size_t)c * 4 * KN + i, KN, &sHp0[i], &sHp1[i]);
    } else {
      sHp0[i] = a.hp0p[okn + i];
      sHp1[i] = a.hp1p[okn + i];
    }
    if (rank == 0) {
      accP[i] = a.accP[okn + i];
      a.hp0p_o[okn + i] = sHp0[i];
      a.hp1p_o[okn + i] = sHp1[i];
    }
  }
  for (int i = tid; i < N * Gs; i += kThreads) {
    const int n = i / Gs, gl = i % Gs;
    const int ng = n * G + gb + gl;
    Ep[(size_t)n * lde + gl] = a.E[ong + ng];
    accE[ng] = a.accE[ong + ng];
    if (a.hyper) {
      hyper_elem(a.E[ong + ng], a.hp0e[ong + ng], a.hp1e[ong + ng],
                 a.Hhpe + ng, a.Hue + (size_t)c * 4 * NG + ng, NG, &hp0e[ng],
                 &hp1e[ng]);
    } else {
      hp0e[ng] = a.hp0e[ong + ng];
      hp1e[ng] = a.hp1e[ong + ng];
    }
  }
  for (int i = tid; i < N; i += kThreads) sA[i] = A[i];
  // every block of the cluster runs before any pushes into its shared memory
  cluster.sync();

  // ---- P sweep: column n, one warp per row k, reductions over g ----------
  const float* UprP = a.UprP + okn;
  const float* UpP = a.UpP + okn;
  const float* UaP = a.UaP + okn;
  for (int n = 0; n < N; ++n) {
    const bool active = A[n] != 0.0f;
    const float* En = Ep + (size_t)n * lde;
    if (!active) {
      for (int k = tid; k < K; k += kThreads) {
        const int kn = k * N + n;
        const float v = prior_draw(prior, UprP[kn], sHp0[kn], sHp1[kn]);
        sP[kn] = v;
        if (rank == 0) P_o[kn] = v;
      }
      __syncthreads();
      continue;
    }
    bool nz = false;  // some E_n[g]^2 != 0: the column is not inactive
    for (int k = warp; k < K; k += kWarps) {
      const float old = sP[k * N + n];
      const float* Mk = Mp + (size_t)k * ld;
      const float* Hk = Hp + (size_t)k * ld;
      double mu1 = 0.0, den = 0.0;
#pragma unroll 4
      for (int gl = lane; gl < Gs; gl += 32) {
        const float o = En[gl];
        const Terms t = pass1_terms(Mk[gl], Hk[gl], old, o);
        mu1 += t.mu1;
        den += t.den;
        nz |= o * o != 0.0f;
      }
      const double v[2] = {warp_allsum(mu1), warp_allsum(den)};
      push_partials(cluster, xb1, S, lane, ((size_t)rank * K + k) * 2, v, 2);
    }
    if (expo) {
      const int any = __syncthreads_or(nz);
      if (tid < S) cluster.map_shared_rank(x_flag, tid)[rank] = any;
    }
    cluster.sync();
    bool inactive = false;
    if (expo) {
      inactive = true;
      for (int r = 0; r < S; ++r) inactive &= x_flag[r] == 0;
    }
    for (int k = tid; k < K; k += kThreads) {
      const int kn = k * N + n;
      double mu1 = 0.0, den = 0.0;
      for (int r = 0; r < S; ++r) {
        mu1 += xb1[((size_t)r * K + k) * 2];
        den += xb1[((size_t)r * K + k) * 2 + 1];
      }
      const float hp0 = sHp0[kn], hp1 = sHp1[kn];
      float mu, var;
      conditional(prior, (float)mu1, (float)den, hp0, hp1, &mu, &var);
      float prop = truncnorm_icdf(UpP[kn], mu, sqrtf(var));
      if (inactive) prop = prior_draw(prior, UprP[kn], hp0, hp1);
      s_mu[k] = mu;
      s_var[k] = var;
      s_prp[k] = prop;
    }
    __syncthreads();
    for (int k = warp; k < K; k += kWarps) {
      const float old = sP[k * N + n];
      const float dp = s_prp[k] - old;
      const float* Mk = Mp + (size_t)k * ld;
      const float* Hk = Hp + (size_t)k * ld;
      double lp = 0.0, mu1_r = 0.0, den_r = 0.0;
#pragma unroll 4
      for (int gl = lane; gl < Gs; gl += 32) {
        const Terms t = pass2_terms(Mk[gl], Hk[gl], old, dp, En[gl], exact);
        lp += t.lp;
        mu1_r += t.mu1;
        den_r += t.den;
      }
      const double v[3] = {warp_allsum(lp), warp_allsum(mu1_r),
                           warp_allsum(den_r)};
      push_partials(cluster, xb2, S, lane, ((size_t)rank * K + k) * 3, v, 3);
    }
    cluster.sync();
    for (int k = tid; k < K; k += kThreads) {
      const int kn = k * N + n;
      double lp = 0.0, mu1_r = 0.0, den_r = 0.0;
      for (int r = 0; r < S; ++r) {
        const double* x = xb2 + ((size_t)r * K + k) * 3;
        lp += x[0];
        mu1_r += x[1];
        den_r += x[2];
      }
      float rec, nan_here = 0.0f;
      const float nv = mh_decide(prior, exact, inactive, sP[kn], s_prp[k],
                                 s_mu[k], s_var[k], (float)mu1_r,
                                 (float)den_r, (float)lp, sHp0[kn], sHp1[kn],
                                 UaP[kn], acc_on, &rec, &nan_here);
      s_new[k] = nv;
      if (rank == 0) {
        P_o[kn] = nv;
        accP[kn] = rec;
        n_nan += nan_here;
      }
    }
    __syncthreads();
    for (int k = warp; k < K; k += kWarps) {
      const float old = sP[k * N + n], nv = s_new[k];
      if (nv != old) {
        const float dv = nv - old;
        float* Hk = Hp + (size_t)k * ld;
        for (int gl = lane; gl < Gs; gl += 32) Hk[gl] += dv * En[gl];
      }
      __syncwarp();
      if (lane == 0) sP[k * N + n] = nv;
    }
    __syncthreads();
  }

  // ---- E sweep: row n, the block's own g; tpg threads share a g's K rows --
  const float* UprE = a.UprE + ong;
  const float* UpE = a.UpE + ong;
  const float* UaE = a.UaE + ong;
  const int tpg = threads_per_g(Gq);
  const int GB = kThreads / tpg;       // g per round of the block
  const int gi = tid % GB, q = tid / GB;
  for (int n = 0; n < N; ++n) {
    const bool active = A[n] != 0.0f;
    float* En = Ep + (size_t)n * lde;
    for (int g0 = 0; g0 < Gs; g0 += GB) {
      const int gl = g0 + gi;
      const bool live = gl < Gs;
      const int ng = n * G + gb + gl;
      if (!active) {
        if (live && q == 0) {
          const float v = prior_draw(prior, UprE[ng], hp0e[ng], hp1e[ng]);
          En[gl] = v;
          E_o[ng] = v;
        }
        continue;
      }
      const float old = live ? En[gl] : 0.0f;
      double* part = s_ep + (size_t)(q * GB + gi) * 3;
      double mu1 = 0.0, den = 0.0;
      bool nz = false;
      for (int k = q; k < K; k += tpg) {
        const float o = sP[k * N + n];
        nz |= o * o != 0.0f;
        if (live) {
          const Terms t = pass1_terms(Mp[(size_t)k * ld + gl],
                                      Hp[(size_t)k * ld + gl], old, o);
          mu1 += t.mu1;
          den += t.den;
        }
      }
      part[0] = mu1;
      part[1] = den;
      const bool inactive = expo && !__syncthreads_or(nz);
      if (!expo) __syncthreads();
      float hp0 = 0.0f, hp1 = 0.0f, mu = 0.0f, var = 0.0f, prop = 0.0f;
      if (live && q == 0) {
        mu1 = den = 0.0;
        for (int j = 0; j < tpg; ++j) {
          mu1 += s_ep[(size_t)(j * GB + gi) * 3];
          den += s_ep[(size_t)(j * GB + gi) * 3 + 1];
        }
        hp0 = hp0e[ng];
        hp1 = hp1e[ng];
        conditional(prior, (float)mu1, (float)den, hp0, hp1, &mu, &var);
        prop = truncnorm_icdf(UpE[ng], mu, sqrtf(var));
        if (inactive) prop = prior_draw(prior, UprE[ng], hp0, hp1);
        s_dp[gi] = prop - old;
      }
      __syncthreads();
      const float dp = s_dp[gi];
      double lp = 0.0, mu1_r = 0.0, den_r = 0.0;
      if (live) {
        for (int k = q; k < K; k += tpg) {
          const Terms t = pass2_terms(Mp[(size_t)k * ld + gl],
                                      Hp[(size_t)k * ld + gl], old, dp,
                                      sP[k * N + n], exact);
          lp += t.lp;
          mu1_r += t.mu1;
          den_r += t.den;
        }
      }
      part[0] = lp;
      part[1] = mu1_r;
      part[2] = den_r;
      __syncthreads();
      if (live && q == 0) {
        lp = mu1_r = den_r = 0.0;
        for (int j = 0; j < tpg; ++j) {
          const double* x = s_ep + (size_t)(j * GB + gi) * 3;
          lp += x[0];
          mu1_r += x[1];
          den_r += x[2];
        }
        float rec;
        const float nv = mh_decide(prior, exact, inactive, old, prop, mu, var,
                                   (float)mu1_r, (float)den_r, (float)lp, hp0,
                                   hp1, UaE[ng], acc_on, &rec, &n_nan);
        En[gl] = nv;
        E_o[ng] = nv;
        accE[ng] = rec;
        s_do[gi] = nv != old ? 1.0f : 0.0f;
        s_dv[gi] = nv - old;
      }
      __syncthreads();
      if (live && s_do[gi] != 0.0f) {
        const float dv = s_dv[gi];
        for (int k = q; k < K; k += tpg) {
          Hp[(size_t)k * ld + gl] += dv * sP[k * N + n];
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();

  // ---- rank draw R and the inclusion sweep over A (pallas_sweeps.py:316-364)
  if (a.rank != kFixedRank) {
    const float temp = rp[0];
    float R, logit_p1;
    rank_draw(rp, sA, N, &R, &logit_p1);
    if (rank == 0 && tid == 0) a.R_o[c] = R;

    for (int n = 0; n < N; ++n) {
      const float A_n = sA[n];
      const float* En = Ep + (size_t)n * lde;
      double part = 0.0;
      for (int k = warp; k < K; k += kWarps) {
        const float Pkn = sP[k * N + n];
        const float* Mk = Mp + (size_t)k * ld;
        const float* Hk = Hp + (size_t)k * ld;
        for (int gl = lane; gl < Gs; gl += 32) {
          const float con = Pkn * En[gl];
          const float off = Hk[gl] - A_n * con;
          const float lam_off = jmax(off, kFloor);
          const float lam_on = jmax(off + con, kFloor);
          const float d = lam_on - lam_off;
          part += Mk[gl] * log1pf(d / lam_off) - d;
        }
      }
      part = block_allsum(part, s_red);
      double* mine = xa + (n & 1) * S;
      if (tid < S) cluster.map_shared_rank(mine, tid)[rank] = part;
      cluster.sync();
      double total = 0.0;
      for (int r = 0; r < S; ++r) total += mine[r];
      float delta = (float)total;
      if (a.rank == kSBFI) delta = delta - a.sbfi_pen;
      const float log_odds = logit_p1 + temp * delta;
      float p = 1.0f / (1.0f + expf(-log_odds));
      if (isnan(p)) {
        p = 0.5f;
        if (rank == 0 && tid == 0) n_nan += 1.0f;
      }
      const float a_new = rp[2 * (N + 1) + n] < p ? 1.0f : 0.0f;
      for (int k = warp; k < K; k += kWarps) {
        const float Pkn = sP[k * N + n];
        float* Hk = Hp + (size_t)k * ld;
        for (int gl = lane; gl < Gs; gl += 32) {
          const float con = Pkn * En[gl];
          const float off = Hk[gl] - A_n * con;
          Hk[gl] = off + a_new * con;
        }
      }
      __syncthreads();  // every thread has read sA[n]
      if (tid == 0) sA[n] = a_new;
    }
    __syncthreads();
  } else if (rank == 0 && tid == 0) {
    a.R_o[c] = rp[0];
  }
  if (rank == 0) {
    for (int i = tid; i < N; i += kThreads) a.A_o[(size_t)c * N + i] = sA[i];
  }

  // ---- Mhat back out, once ------------------------------------------------
  if (a.resident & 1) {
    float* out = a.Mh_o + (size_t)c * KG + gb;
    for (int i = tid; i < K * Gs; i += kThreads) {
      const int k = i / Gs, gl = i % Gs;
      out[(size_t)k * G + gl] = Hp[k * ld + gl];
    }
  }

  // ---- NaN-clamp count: integer-valued, so the sum order is immaterial ---
  s_nan[tid] = n_nan;
  __syncthreads();
  if (tid == 0) {
    float total = 0.0f;
    for (int i = 0; i < kThreads; ++i) total += s_nan[i];
    cluster.map_shared_rank(x_nan, 0)[rank] = total;
  }
  cluster.sync();
  if (rank == 0 && tid == 0) {
    float total = 0.0f;
    for (int r = 0; r < S; ++r) total += x_nan[r];
    a.nan_o[c] = total;
  }
}


// ---- the grid form: one chain over up to one block per SM ------------------
// For the shapes whose P, prior pair and pushed partials do not fit the
// cluster form's blocks (K >= 192: ops/fused_sweeps.py::grid_form). A chain
// is S blocks of one cooperative launch (S * chains <= the blocks the card
// holds at once, so every block is resident and the barriers cannot
// deadlock); they meet at a barrier of their own on a device counter
// (chain_sync), and exchange through L2 (stores and loads past L1):
//   P column n  every block stages the column, sums its g for every row k
//               (a thread a row) and stores the double partials; block b
//               owns rows [b Kq, (b + 1) Kq): after a barrier its warps add
//               each owned row's S partials in a fixed order and make the
//               proposal; after a second every block reads the K proposals
//               and sums the second pass; after a third the owners decide
//               and write P; after a fourth every block reads the new column
//               and updates its Mhat slice. P and its prior pair live once,
//               in the outputs: no block holds all of them.
//   E row n     a block's own g; each g's K rows split over kThreads /
//               min(Gq, 32) threads (23 at Gq = 22), partials met in shared
//               memory in a fixed order.
//   A column n  a block sum, stored per block; after a barrier every block
//               adds the S sums in the same fixed order.
// The Mhat slice (K x Gq, a padded odd row stride so that a thread a row and
// a warp over g both read conflict-free) sits in shared memory where it fits,
// then the data slice; the E slice too. Sums are in double, added in fixed
// orders with no atomics: two launches give the same bits.

// The E sweep's g per round of a grid block: its g, up to a warp's worth
__host__ __device__ inline int grid_g_round(int Gq) {
  return Gq < 32 ? Gq : 32;
}

// Row stride of a resident slice: Gq padded to an odd count
__host__ __device__ inline int grid_ld(int Gq) { return Gq | 1; }

// Shared memory of a grid block, in bytes: as doubles the block sums
// (kWarps) and the E row's partials (kThreads x 3); as floats a column's
// old value, proposal and new value (3 x K), an E row's proposal step, value
// step and flag (3 x kThreads), A (N), the NaN counts (kThreads), then the
// resident slices: E (N x Gq, bit 1), data (bit 0) and Mhat (bit 2), each
// K x grid_ld(Gq).
__host__ __device__ inline size_t grid_smem_bytes(int K, int N, int Gq,
                                                 int resident) {
  const size_t doubles = kWarps + (size_t)kThreads * 3;
  const size_t slice = (size_t)K * grid_ld(Gq);
  const size_t floats = (size_t)3 * K + 4 * kThreads + N
                        + (resident & 2 ? (size_t)N * Gq : 0)
                        + (resident & 1 ? slice : 0)
                        + (resident & 4 ? slice : 0);
  return doubles * sizeof(double) + floats * sizeof(float);
}

// Words of the grid form's scratch a chain: the partials of a P column's two
// passes ([K][S][2], [K][S][3]) and of an A column ([2][S]) as doubles; the
// owners' mu, var and proposal ([3][K]), the flags and the NaN counts ([S]
// each) as floats; then, after every chain's, one barrier counter a chain.
__host__ __device__ inline size_t grid_chain_doubles(int K, int S) {
  return (size_t)5 * K * S + 2 * S;
}
__host__ __device__ inline size_t grid_chain_floats(int K, int S) {
  return (size_t)3 * K + 2 * S;
}

// Cycles a block waits at a chain barrier before it traps (~40 s): the
// launch rule keeps every block resident, so a wait this long is a fault,
// reported as a launch failure rather than left to hang the card.
constexpr long long kBarrierCycles = 1LL << 36;

// The chain's barrier: every block's writes before it are seen by every
// block after it. The counter only grows, `epoch` barriers a launch.
__device__ __forceinline__ void chain_sync(unsigned* bar, unsigned* epoch,
                                           int S) {
  __syncthreads();
  const unsigned target = ++*epoch * (unsigned)S;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    const long long t0 = clock64();
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(v) : "l"(bar) : "memory");
      if (v < target && clock64() - t0 > kBarrierCycles) __trap();
    } while (v < target);
    __threadfence();
  }
  __syncthreads();
}

// The same fixed order in every block: lanes over r, then the xor tree
__device__ __forceinline__ double grid_sum(const double* x, int S,
                                           size_t stride, int lane) {
  double t = 0.0;
  for (int r = lane; r < S; r += 32) t += __ldcg(x + r * stride);
  return warp_allsum(t);
}

// The grid form's walk over a block's K x Gs slice: a thread a row where
// the slice is narrow (Gq < 32, where a warp's lanes over g would idle), a
// warp a row with its lanes over g where it is wide (a row's loads then
// coalesce, which counts where the slices sit in global memory). f(k, gl)
// for every entry; grid_rows adds NV terms an entry, term(k, gl, acc), into
// each row's sums, handed once to done(k, acc): a row's g in order on its
// thread, or lanes over g then the xor tree.
template <class F>
__device__ __forceinline__ void grid_walk(int K, int Gs, bool wide, F f) {
  const int tid = threadIdx.x;
  if (wide) {
    for (int k = tid >> 5; k < K; k += kWarps) {
      for (int gl = tid & 31; gl < Gs; gl += 32) f(k, gl);
    }
  } else {
    for (int k = tid; k < K; k += kThreads) {
      for (int gl = 0; gl < Gs; ++gl) f(k, gl);
    }
  }
}

template <int NV, class Term, class Done>
__device__ __forceinline__ void grid_rows(int K, int Gs, bool wide,
                                          Term term, Done done) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (wide) {
    for (int k = tid >> 5; k < K; k += kWarps) {
      double acc[NV] = {};
      for (int gl = lane; gl < Gs; gl += 32) term(k, gl, acc);
#pragma unroll
      for (int j = 0; j < NV; ++j) acc[j] = warp_allsum(acc[j]);
      if (lane == 0) done(k, acc);
    }
  } else {
    for (int k = tid; k < K; k += kThreads) {
      double acc[NV] = {};
      for (int gl = 0; gl < Gs; ++gl) term(k, gl, acc);
      done(k, acc);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fused_grid_kernel(Args a) {
  extern __shared__ double smem[];
  const int S = gridDim.x, rank = blockIdx.x;
  const int c = a.c0 + blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int K = a.K, N = a.N, G = a.G;
  const int KN = K * N, NG = N * G, KG = K * G;
  const int prior = a.prior, exact = a.exact;
  const bool expo = prior == kExponential;
  // this block's columns [gb, gb + Gs) of the chain's G, and the rows
  // [kb0, kb1) whose decisions it owns
  const int Gq = (G + S - 1) / S;
  const int gb = rank * Gq < G ? rank * Gq : G;
  const int Gs = G - gb < Gq ? G - gb : Gq;
  const int Kq = (K + S - 1) / S;
  const int kb0 = rank * Kq < K ? rank * Kq : K;
  const int kb1 = K - kb0 < Kq ? K : kb0 + Kq;

  unsigned* bar = a.bar + c;
  unsigned epoch = 0;
  double* x1 = a.xg + (size_t)c * grid_chain_doubles(K, S);  // [K][S][2]
  double* x2 = x1 + (size_t)2 * K * S;                       // [K][S][3]
  double* xa = x2 + (size_t)3 * K * S;                       // [2][S]
  float* wk = a.wg + (size_t)c * grid_chain_floats(K, S);    // [3][K]
  int* flags = reinterpret_cast<int*>(wk + 3 * K);           // [S]
  float* nanb = wk + 3 * K + S;                              // [S]

  double* s_red = smem;                        // [kWarps]
  double* s_ep = s_red + kWarps;               // [kThreads][3]
  float* s_col = reinterpret_cast<float*>(s_ep + kThreads * 3);  // [K] each
  float* s_prp = s_col + K;
  float* s_new = s_prp + K;
  float* s_dp = s_new + K;                     // [kThreads] each
  float* s_dv = s_dp + kThreads;
  float* s_do = s_dv + kThreads;
  float* s_nan = s_do + kThreads;
  float* sA = s_nan + kThreads;                // [N]
  float* slices = sA + N;

  const float* A = a.A + (size_t)c * N;
  const float* rp = a.rank_pack + (size_t)c * 3 * (N + 1);
  const bool acc_on = rp[1] > 0.0f;
  const size_t okn = (size_t)c * KN, ong = (size_t)c * NG;
  float* P_o = a.P_o + okn;
  float* accP = a.accP_o + okn;
  float* hp0p = a.hp0p_o + okn;
  float* hp1p = a.hp1p_o + okn;
  float* E_o = a.E_o + ong;
  float* accE = a.accE_o + ong;
  float* hp0e = a.hp0e_o + ong;
  float* hp1e = a.hp1e_o + ong;
  float n_nan = 0.0f;

  // the E, data and Mhat slices: in shared memory, or in global memory
  // (row stride G)
  const int ldq = grid_ld(Gq);
  const bool wide = Gq >= 32;
  float* sf = slices;
  float* Ep = E_o + gb;
  int lde = G;
  if (a.resident & 2) {
    Ep = sf;
    lde = Gq;
    sf += (size_t)N * Gq;
  }
  const float* Mp = a.data + gb;
  int ldm = G;
  if (a.resident & 1) {
    float* sM = sf;
    sf += (size_t)K * ldq;
    for (int i = tid; i < K * Gs; i += kThreads) {
      const int k = i / Gs, gl = i % Gs;
      sM[k * ldq + gl] = a.data[(size_t)k * G + gb + gl];
    }
    Mp = sM;
    ldm = ldq;
  }
  float* Hp = a.Mh_o + (size_t)c * KG + gb;
  int ldh = G;
  if (a.resident & 4) {
    Hp = sf;
    ldh = ldq;
  }
  for (int i = tid; i < K * Gs; i += kThreads) {
    const int k = i / Gs, gl = i % Gs;
    Hp[(size_t)k * ldh + gl] = a.Mh[(size_t)c * KG + (size_t)k * G + gb + gl];
  }

  // ---- copy state in; the hyper-sweep reads the pre-sweep P and E --------
  // P side: the rows this block owns
  for (int i = kb0 * N + tid; i < kb1 * N; i += kThreads) {
    if (a.hyper) {
      hyper_elem(a.P[okn + i], a.hp0p[okn + i], a.hp1p[okn + i], a.Hhpp + i,
                 a.Hup + (size_t)c * 4 * KN + i, KN, &hp0p[i], &hp1p[i]);
    } else {
      hp0p[i] = a.hp0p[okn + i];
      hp1p[i] = a.hp1p[okn + i];
    }
    accP[i] = a.accP[okn + i];
  }
  for (int i = tid; i < N * Gs; i += kThreads) {
    const int n = i / Gs, gl = i % Gs;
    const int ng = n * G + gb + gl;
    Ep[(size_t)n * lde + gl] = a.E[ong + ng];
    accE[ng] = a.accE[ong + ng];
    if (a.hyper) {
      hyper_elem(a.E[ong + ng], a.hp0e[ong + ng], a.hp1e[ong + ng],
                 a.Hhpe + ng, a.Hue + (size_t)c * 4 * NG + ng, NG, &hp0e[ng],
                 &hp1e[ng]);
    } else {
      hp0e[ng] = a.hp0e[ong + ng];
      hp1e[ng] = a.hp1e[ong + ng];
    }
  }
  for (int i = tid; i < N; i += kThreads) sA[i] = A[i];
  __syncthreads();

  // ---- P sweep: column n, a thread a row over the block's g; owners decide
  const float* UprP = a.UprP + okn;
  const float* UpP = a.UpP + okn;
  const float* UaP = a.UaP + okn;
  for (int n = 0; n < N; ++n) {
    const float* En = Ep + (size_t)n * lde;
    if (A[n] == 0.0f) {
      for (int kn = kb0 * N + n + tid * N; kn < kb1 * N; kn += kThreads * N) {
        P_o[kn] = prior_draw(prior, UprP[kn], __ldcg(hp0p + kn),
                             __ldcg(hp1p + kn));
      }
      continue;
    }
    // the column before the update: no block has changed it yet
    for (int k = tid; k < K; k += kThreads) s_col[k] = a.P[okn + k * N + n];
    if (expo) {
      bool nz = false;  // some E_n[g]^2 != 0 in this block
      for (int gl = tid; gl < Gs; gl += kThreads) nz |= En[gl] * En[gl] != 0.0f;
      const int any = __syncthreads_or(nz);
      if (tid == 0) __stcg(flags + rank, any);
    } else {
      __syncthreads();
    }
    grid_rows<2>(
        K, Gs, wide,
        [&](int k, int gl, double* acc) {
          const Terms t = pass1_terms(Mp[(size_t)k * ldm + gl],
                                      Hp[(size_t)k * ldh + gl], s_col[k],
                                      En[gl]);
          acc[0] += t.mu1;
          acc[1] += t.den;
        },
        [&](int k, const double* acc) {
          double* x = x1 + ((size_t)k * S + rank) * 2;
          __stcg(x, acc[0]);
          __stcg(x + 1, acc[1]);
        });
    chain_sync(bar, &epoch, S);
    // the exponential prior's inactive column: E_n zero on every block
    bool inactive = false;
    if (expo) {
      int any = 0;
      for (int r = lane; r < S; r += 32) any |= __ldcg(flags + r);
      inactive = !__any_sync(0xffffffffu, any != 0);
    }
    for (int k = kb0 + warp; k < kb1; k += kWarps) {
      const double mu1 = grid_sum(x1 + (size_t)k * S * 2, S, 2, lane);
      const double den = grid_sum(x1 + (size_t)k * S * 2 + 1, S, 2, lane);
      if (lane == 0) {
        const int kn = k * N + n;
        const float hp0 = __ldcg(hp0p + kn), hp1 = __ldcg(hp1p + kn);
        float mu, var;
        conditional(prior, (float)mu1, (float)den, hp0, hp1, &mu, &var);
        float prop = truncnorm_icdf(UpP[kn], mu, sqrtf(var));
        if (inactive) prop = prior_draw(prior, UprP[kn], hp0, hp1);
        __stcg(wk + k, mu);
        __stcg(wk + K + k, var);
        __stcg(wk + 2 * K + k, prop);
      }
    }
    chain_sync(bar, &epoch, S);
    for (int k = tid; k < K; k += kThreads) s_prp[k] = __ldcg(wk + 2 * K + k);
    __syncthreads();
    grid_rows<3>(
        K, Gs, wide,
        [&](int k, int gl, double* acc) {
          const float old = s_col[k];
          const Terms t = pass2_terms(Mp[(size_t)k * ldm + gl],
                                      Hp[(size_t)k * ldh + gl], old,
                                      s_prp[k] - old, En[gl], exact);
          acc[0] += t.lp;
          acc[1] += t.mu1;
          acc[2] += t.den;
        },
        [&](int k, const double* acc) {
          double* x = x2 + ((size_t)k * S + rank) * 3;
          __stcg(x, acc[0]);
          __stcg(x + 1, acc[1]);
          __stcg(x + 2, acc[2]);
        });
    chain_sync(bar, &epoch, S);
    for (int k = kb0 + warp; k < kb1; k += kWarps) {
      const double* x = x2 + (size_t)k * S * 3;
      const double lp = grid_sum(x, S, 3, lane);
      const double mu1_r = grid_sum(x + 1, S, 3, lane);
      const double den_r = grid_sum(x + 2, S, 3, lane);
      if (lane == 0) {
        const int kn = k * N + n;
        float rec;
        const float nv = mh_decide(
            prior, exact, inactive, s_col[k], s_prp[k], __ldcg(wk + k),
            __ldcg(wk + K + k), (float)mu1_r, (float)den_r, (float)lp,
            __ldcg(hp0p + kn), __ldcg(hp1p + kn), UaP[kn], acc_on, &rec,
            &n_nan);
        __stcg(P_o + kn, nv);
        accP[kn] = rec;
      }
    }
    chain_sync(bar, &epoch, S);
    for (int k = tid; k < K; k += kThreads) s_new[k] = __ldcg(P_o + k * N + n);
    __syncthreads();
    grid_walk(K, Gs, wide, [&](int k, int gl) {
      const float old = s_col[k], nv = s_new[k];
      if (nv != old) Hp[(size_t)k * ldh + gl] += (nv - old) * En[gl];
    });
    __syncthreads();
  }
  // every column of P written, by whichever block owns its rows
  chain_sync(bar, &epoch, S);

  // ---- E sweep: row n, the block's own g; tpg threads share a g's K rows --
  const float* UprE = a.UprE + ong;
  const float* UpE = a.UpE + ong;
  const float* UaE = a.UaE + ong;
  const int GB = grid_g_round(Gq);     // g per round of the block
  const int tpg = kThreads / GB;
  const int gi = tid % GB, q = tid / GB;
  const bool in_round = q < tpg;
  for (int n = 0; n < N; ++n) {
    const bool active = A[n] != 0.0f;
    float* En = Ep + (size_t)n * lde;
    if (active) {
      for (int k = tid; k < K; k += kThreads) s_col[k] = __ldcg(P_o + k * N + n);
      __syncthreads();
    }
    for (int g0 = 0; g0 < Gs; g0 += GB) {
      const int gl = g0 + gi;
      const bool live = in_round && gl < Gs;
      const int ng = n * G + gb + gl;
      if (!active) {
        if (live && q == 0) {
          const float v = prior_draw(prior, UprE[ng], hp0e[ng], hp1e[ng]);
          En[gl] = v;
          E_o[ng] = v;
        }
        continue;
      }
      const float old = live ? En[gl] : 0.0f;
      double* part = s_ep + (size_t)(q * GB + gi) * 3;
      double mu1 = 0.0, den = 0.0;
      bool nz = false;
      if (in_round) {
        for (int k = q; k < K; k += tpg) {
          const float o = s_col[k];
          nz |= o * o != 0.0f;
          if (live) {
            const Terms t = pass1_terms(Mp[(size_t)k * ldm + gl],
                                        Hp[(size_t)k * ldh + gl], old, o);
            mu1 += t.mu1;
            den += t.den;
          }
        }
        part[0] = mu1;
        part[1] = den;
      }
      const bool inactive = expo && !__syncthreads_or(nz);
      if (!expo) __syncthreads();
      float hp0 = 0.0f, hp1 = 0.0f, mu = 0.0f, var = 0.0f, prop = 0.0f;
      if (live && q == 0) {
        mu1 = den = 0.0;
        for (int j = 0; j < tpg; ++j) {
          mu1 += s_ep[(size_t)(j * GB + gi) * 3];
          den += s_ep[(size_t)(j * GB + gi) * 3 + 1];
        }
        hp0 = hp0e[ng];
        hp1 = hp1e[ng];
        conditional(prior, (float)mu1, (float)den, hp0, hp1, &mu, &var);
        prop = truncnorm_icdf(UpE[ng], mu, sqrtf(var));
        if (inactive) prop = prior_draw(prior, UprE[ng], hp0, hp1);
        s_dp[gi] = prop - old;
      }
      __syncthreads();
      double lp = 0.0, mu1_r = 0.0, den_r = 0.0;
      if (live) {
        const float dp = s_dp[gi];
        for (int k = q; k < K; k += tpg) {
          const Terms t = pass2_terms(Mp[(size_t)k * ldm + gl],
                                      Hp[(size_t)k * ldh + gl], old, dp,
                                      s_col[k], exact);
          lp += t.lp;
          mu1_r += t.mu1;
          den_r += t.den;
        }
      }
      if (in_round) {
        part[0] = lp;
        part[1] = mu1_r;
        part[2] = den_r;
      }
      __syncthreads();
      if (live && q == 0) {
        lp = mu1_r = den_r = 0.0;
        for (int j = 0; j < tpg; ++j) {
          const double* x = s_ep + (size_t)(j * GB + gi) * 3;
          lp += x[0];
          mu1_r += x[1];
          den_r += x[2];
        }
        float rec;
        const float nv = mh_decide(prior, exact, inactive, old, prop, mu, var,
                                   (float)mu1_r, (float)den_r, (float)lp, hp0,
                                   hp1, UaE[ng], acc_on, &rec, &n_nan);
        En[gl] = nv;
        E_o[ng] = nv;
        accE[ng] = rec;
        s_do[gi] = nv != old ? 1.0f : 0.0f;
        s_dv[gi] = nv - old;
      }
      __syncthreads();
      if (live && s_do[gi] != 0.0f) {
        const float dv = s_dv[gi];
        for (int k = q; k < K; k += tpg) {
          Hp[(size_t)k * ldh + gl] += dv * s_col[k];
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();

  // ---- rank draw R and the inclusion sweep over A (pallas_sweeps.py:316-364)
  if (a.rank != kFixedRank) {
    const float temp = rp[0];
    float R, logit_p1;
    rank_draw(rp, sA, N, &R, &logit_p1);
    if (rank == 0 && tid == 0) a.R_o[c] = R;

    for (int n = 0; n < N; ++n) {
      const float A_n = sA[n];
      const float* En = Ep + (size_t)n * lde;
      for (int k = tid; k < K; k += kThreads) s_col[k] = __ldcg(P_o + k * N + n);
      __syncthreads();
      double part = 0.0;
      grid_walk(K, Gs, wide, [&](int k, int gl) {
        const float con = s_col[k] * En[gl];
        const float off = Hp[(size_t)k * ldh + gl] - A_n * con;
        const float lam_off = jmax(off, kFloor);
        const float lam_on = jmax(off + con, kFloor);
        const float d = lam_on - lam_off;
        part += Mp[(size_t)k * ldm + gl] * log1pf(d / lam_off) - d;
      });
      part = block_allsum(part, s_red);
      double* mine = xa + (n & 1) * S;
      if (tid == 0) __stcg(mine + rank, part);
      chain_sync(bar, &epoch, S);
      const double total = grid_sum(mine, S, 1, lane);
      float delta = (float)total;
      if (a.rank == kSBFI) delta = delta - a.sbfi_pen;
      const float log_odds = logit_p1 + temp * delta;
      float p = 1.0f / (1.0f + expf(-log_odds));
      if (isnan(p)) {
        p = 0.5f;
        if (rank == 0 && tid == 0) n_nan += 1.0f;
      }
      const float a_new = rp[2 * (N + 1) + n] < p ? 1.0f : 0.0f;
      grid_walk(K, Gs, wide, [&](int k, int gl) {
        float* h = Hp + (size_t)k * ldh + gl;
        const float con = s_col[k] * En[gl];
        const float off = *h - A_n * con;
        *h = off + a_new * con;
      });
      __syncthreads();  // every thread has read sA[n] and s_col
      if (tid == 0) sA[n] = a_new;
    }
    __syncthreads();
  } else if (rank == 0 && tid == 0) {
    a.R_o[c] = rp[0];
  }
  if (rank == 0) {
    for (int i = tid; i < N; i += kThreads) a.A_o[(size_t)c * N + i] = sA[i];
  }

  // ---- Mhat back out, once ------------------------------------------------
  if (a.resident & 4) {
    float* out = a.Mh_o + (size_t)c * KG + gb;
    for (int i = tid; i < K * Gs; i += kThreads) {
      const int k = i / Gs, gl = i % Gs;
      out[(size_t)k * G + gl] = Hp[k * ldh + gl];
    }
  }

  // ---- NaN-clamp count: integer-valued, so the sum order is immaterial ---
  s_nan[tid] = n_nan;
  __syncthreads();
  if (tid == 0) {
    float total = 0.0f;
    for (int i = 0; i < kThreads; ++i) total += s_nan[i];
    __stcg(nanb + rank, total);
  }
  chain_sync(bar, &epoch, S);
  if (rank == 0 && tid == 0) {
    float total = 0.0f;
    for (int r = 0; r < S; ++r) total += __ldcg(nanb + r);
    a.nan_o[c] = total;
  }
}
}  // namespace

// Blocks a multiprocessor holds at once of the grid form's kernel with a
// slice of Gq columns and the given residency (0 where it cannot run).
extern "C" int fused_grid_blocks_per_sm(int K, int N, int Gq, int resident) {
  const size_t smem = grid_smem_bytes(K, N, Gq, resident);
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(fused_grid_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess) {
    return 0;
  }
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, fused_grid_kernel, kThreads, smem) != cudaSuccess) {
    return 0;
  }
  return blocks;
}

// `form` 0: the cluster form, one cluster of `blocks` blocks per chain
// (`resident`: bit 0 the data and Mhat slices, bit 1 the E slice; the
// caller checked that they fit). `form` 1: the grid form, `blocks` blocks a
// chain, chains launched `group` at a time (blocks * group must be
// resident at once: the launch is cooperative, and refused otherwise);
// `resident` bit 0 the data slice, bit 1 the E slice, bit 2 the Mhat slice;
// `scratch` C * grid_chain_doubles doubles, C * grid_chain_floats floats,
// then C barrier counters (zeroed here).
extern "C" int fused_gibbs_sweeps_launch(
    const float* data, const float* P, const float* E, const float* A,
    const float* Mh, const float* accP, const float* accE,
    const float* UprP, const float* UprE, const float* UpP, const float* UaP,
    const float* UpE, const float* UaE,
    const float* hp0p, const float* hp1p, const float* hp0e,
    const float* hp1e, const float* rank_pack,
    const float* Hup, const float* Hue, const float* Hhpp, const float* Hhpe,
    int hyper, int prior, int exact, int rank, float sbfi_pen,
    float* P_o, float* E_o, float* Mh_o, float* accP_o, float* accE_o,
    float* A_o, float* R_o, float* nan_o, float* hp0p_o, float* hp1p_o,
    float* hp0e_o, float* hp1e_o, int C, int K, int N, int G, int form,
    int blocks, int group, int resident, void* scratch, void* stream) {
  Args a = {};
  a.data = data;
  a.P = P; a.E = E; a.A = A; a.Mh = Mh; a.accP = accP; a.accE = accE;
  a.UprP = UprP; a.UprE = UprE; a.UpP = UpP; a.UaP = UaP;
  a.UpE = UpE; a.UaE = UaE;
  a.hp0p = hp0p; a.hp1p = hp1p; a.hp0e = hp0e; a.hp1e = hp1e;
  a.rank_pack = rank_pack;
  a.Hup = Hup; a.Hue = Hue; a.Hhpp = Hhpp; a.Hhpe = Hhpe;
  a.hyper = hyper; a.prior = prior; a.exact = exact; a.rank = rank;
  a.sbfi_pen = sbfi_pen;
  a.P_o = P_o; a.E_o = E_o; a.Mh_o = Mh_o; a.accP_o = accP_o;
  a.accE_o = accE_o; a.A_o = A_o; a.R_o = R_o; a.nan_o = nan_o;
  a.hp0p_o = hp0p_o; a.hp1p_o = hp1p_o; a.hp0e_o = hp0e_o; a.hp1e_o = hp1e_o;
  a.K = K; a.N = N; a.G = G;
  a.resident = resident;
  const cudaStream_t s = (cudaStream_t)stream;
  const int Gq = (G + blocks - 1) / blocks;
  cudaError_t e;
  if (form == 1) {
    if (blocks < 1 || group < 1 || scratch == nullptr) {
      return (int)cudaErrorInvalidValue;
    }
    a.xg = static_cast<double*>(scratch);
    a.wg = reinterpret_cast<float*>(a.xg + (size_t)C * grid_chain_doubles(K, blocks));
    a.bar = reinterpret_cast<unsigned*>(a.wg + (size_t)C * grid_chain_floats(K, blocks));
    const size_t smem = grid_smem_bytes(K, N, Gq, resident);
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(fused_grid_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    if ((e = cudaMemsetAsync(a.bar, 0, (size_t)C * sizeof(unsigned), s)) !=
        cudaSuccess) {
      return (int)e;
    }
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    for (int c0 = 0; c0 < C; c0 += group) {
      a.c0 = c0;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(blocks, C - c0 < group ? C - c0 : group);
      cfg.blockDim = dim3(kThreads);
      cfg.dynamicSmemBytes = smem;
      cfg.stream = s;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      if ((e = cudaLaunchKernelEx(&cfg, fused_grid_kernel, a)) !=
          cudaSuccess) {
        return (int)e;
      }
    }
    return 0;
  }
  const int cluster = blocks;
  if (cluster < 1 || cluster > 16) return (int)cudaErrorInvalidValue;
  const size_t smem = fixed_smem_bytes(K, N, Gq, cluster, (resident & 2) != 0)
                      + (resident & 1 ? (size_t)2 * K * Gq * sizeof(float) : 0);
  void (*kernel)(Args) = fused_sweeps_kernel;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (cluster > 8) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, a);
}
