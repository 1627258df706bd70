// The large-G MH sweeps on Hopper (sm_90a) without a (C, K, G) tensor: whole
// P-column, E-row and A-column (inclusion) updates in kernels (sums,
// conditional or inclusion odds, draw, decision and write-back; a sweep's
// launches enqueued by one C call), the metrics row of every chain in two
// launches, and the same tile code in a sums-only form for the four
// reduction functions, the inclusion-odds delta and the metrics row's four
// data sums. Every kernel rebuilds its Mhat tile from P*A and an E tile.
// Beside them, the exact truncated-normal Mu/Sigmasq update of a step in
// one elementwise launch (hyper_kernel, with the sums-only entry points).
//
// (a) Replaces bayesnmf_tpu/ops/pallas_stream_sweeps.py: `_run` (its four
//     bodies _pcol_stats_kernel, _pcol_accept_kernel, _erow_stats_kernel,
//     _erow_accept_kernel) together with the host logic around them in
//     models/updates.py::stream_sweep_P/E of the JAX package, `acol_delta`
//     (_acol_delta_kernel) together with the host logic of
//     models/updates.py::stream_sweep_A, and `chain_metrics`
//     (_chain_metrics_kernel) together with the host arithmetic of
//     models/gibbs.py::_metrics_row on its sums (`pois_red`) and the prior
//     term it adds, with a leading chain axis C on every per-chain operand.
//     The prior is a runtime argument (`expo`) of the P-column, E-row and
//     metrics-row kernels: the truncated normal takes (Mu, Sigmasq) a
//     entry, the exponential its Lambda in Mu's place (the conditional
//     (mu1 - Lambda) / max(den, 1e-30), the ratio's prior part
//     -Lambda (proposal - old), the log-prior log(Lambda) - Lambda x), as
//     the JAX package's stream sweeps compute them around `_run`'s sums
//     (models/updates.py:573-600, :660-690).
// (b) What bounds it: operations. Per (c, k, g) element a column update
//     rebuilds Mhat (2N flops, as separate multiplies and adds) once or twice
//     and adds a few divisions and a log1p; it reads data (shared by the
//     chains) and the E tile once per pass. At (K,N,G,C) = (96,20,10000,8)
//     that is ~0.3-1.2 GFLOP against ~10 MB of reads per column: far above
//     the card's float32 ridge, so the float32 pipes and the special-function
//     unit bound it, not HBM.
// (c) Work split of a column update.
//     The register tile (dot_ordered): one operand of the Mhat product sits
//     in a thread's registers, the other is read from shared memory as
//     float4 broadcasts, and four products are built at once as independent
//     chains, so a thread issues an add every cycle where one chain would
//     wait four.
//     E row (erow_kernel, below 192 rows): no sum crosses g, so one thread
//     owns one g and holds E[c, :, g] in registers; both passes, the
//     conditional, the draw, the ratio and the decision run in that thread:
//     one launch per row, a grid of (G / 128, C) blocks. The second pass rebuilds Mhat: keeping
//     the K values of a column in shared memory cost more in resident warps
//     than the rebuild costs in operations (0.101 against 0.087 ms a row at
//     (96,20,10000,8)).
//     P column (below 192 rows; from 192 on, the row form below): the
//     sums run over all G of a chain. A tile kernel
//     (pcol_tile_kernel) on a grid of (G / 64, C) blocks gives a thread one
//     row k (its P*A row in registers) and a group of such rows every
//     `groups`-th g of the tile; a row's sums stay in its thread, the groups
//     are added in order, and the tile's partials go to a scratch buffer in
//     double. A finishing kernel (pcol_finish_kernel), one block per chain,
//     adds the tiles in a fixed order and makes the proposal (after the
//     first pass) or takes the decision and writes the column back (after the
//     second): four launches per column with no host work between them.
//     One thread-block cluster per chain with the partials exchanged through
//     distributed shared memory, one launch per column, was built and timed
//     first: a chain cannot have more than 16 blocks, of which the card keeps
//     7 clusters resident at 640 threads a block, so 8 chains ran in two
//     waves (or on half the SMs at 8 blocks): 0.22-0.25 ms a column at
//     (96,20,10000,8) against 0.14 ms for the tiles.
//     A column (below 192 rows, as the P column): one sum over all K and
//     G of a chain. The same tile as a P
//     column (acol_tile_kernel), its P*A row formed in registers from P and
//     the device A, so the column before it is already in; the tile's rows
//     are added in a fixed order into one double partial. The decision
//     (the ordered sum of the tiles, the float32 delta, the SBFI penalty, the
//     tempered log-odds, the sigmoid, the NaN fallback, the Bernoulli draw
//     and the write of A[c, n]) is the last step of the column, taken by a
//     finishing kernel with one warp per chain (acol_finish_kernel). The
//     last tile block of a chain to finish taking it instead (a counter and
//     a fence, one launch a column) measured slower, 0.060 against 0.057 ms
//     a column at (96,20,10000,8): that block's serial tail then ends every
//     column, while a second launch overlaps the grid's tail.
//     The metrics row: the A column's tile with the four data sums
//     (metrics_tile_kernel), the block's threads then taking the tile's
//     (n, g) entries of E for the prior term and acc_E * A_n; a finishing
//     kernel, one block per chain, adds the tiles in a fixed order, sums
//     the P side over (K, N) and writes the 12 floats of the row, so the
//     host builds no P*A and runs no arithmetic on the state. Unlike a
//     column, it reads E's prior pair and acceptance record (four C*N*G
//     planes) once, so at (96,20,10000,8) its bound is bytes (~29 MB).
//     Large K and N (the envelope, ops/__init__.py: K <= 1536, N <= 128):
//     the register tile is built for N up to 128 (NP = 128); below 192
//     rows the column tiles' G width is 64 (col_tile, which narrows it to
//     32 or 16 where a K x (width + 1) data tile would not fit; the
//     metrics row keeps those narrow tiles at large K).
//     The P and A columns from 192 rows on (the row form, pcol_rows_kernel
//     and acol_rows_kernel): the G-tile form narrowed to 16 g at K = 1536
//     reloaded each row's P*A for 16 g, wrote 51 MB of partials a pass and
//     summed them on 8 SMs (1.03 ms a P column, 0.33 an A column at
//     (1536,20,2780,8)). In the row form a block owns 32 rows of a chain,
//     a lane one row with its P*A row in registers for the whole column,
//     and its 8 warps stream G tiles of 64 g (32 for NP >= 64) through a
//     3-slot cp.async ring (E tile, data tile, E row), so a row's sums
//     never leave the block; a cluster of 1-8 blocks along G fills the
//     card at small K or C, its sums meeting in block order through
//     distributed shared memory. A P column is one launch: the cluster
//     proposes after the first pass and decides after the second (no
//     scratch, no finishing kernel). An A column's blocks each write one
//     double, which acol_finish_kernel adds in order. What bounds it: the
//     instruction issue, ~120 an entry a pass for the A column and ~200
//     over both passes for the P column (the Mhat rebuild, divisions, a
//     log1p, the double sums' conversions and adds, all kept for kernel =
//     plain); the ring's copies are unrolled from bases computed once (in
//     a first version, address arithmetic recomputed for every copy took a
//     large share of the loop's instructions; PERF.md section 6).
//     The E row from 192 rows on (erow_split_kernel): one thread walking
//     all K rows twice, P*A staged whole (123 KB at K = 1536, N = 20, so
//     one 4-warp block an SM), took 1.79 ms at (1536,20,2780,8). The split
//     form gives 32 g to a cluster of 1, 2 or 4 blocks along K (at most
//     384 rows a block), each with 8 warps on contiguous slices of its
//     rows, so a thread walks 48 rows at K = 1536, not 1536; each warp
//     streams its rows of P*A through its own 3-slot ring filled by
//     cp.async (no block barrier in the passes) and keeps its rows' Mhat
//     values in shared memory for the second pass, which then rebuilds
//     nothing; the blocks' sums meet in block 0 through distributed shared
//     memory. What bounds it: its instruction count, an estimated ~150 an
//     entry over both passes (one Mhat rebuild as separate multiplies and
//     adds, -fmad=false, two or three divisions, a log1p, and the
//     conversions and adds of the double sums). One block of 32 g with
//     its 8 warps over all K, Mhat rebuilt in the second pass, measured
//     ~20% slower at K = 1536 (PERF.md section 6).
//     What is left: the G-tile kernels below 192 rows and the metrics
//     row run at a tenth of the float32 peak (staging and compute of a
//     tile do not overlap; 2 blocks an SM); a P column's second pass
//     rebuilds Mhat (32 rows across all G do not fit shared memory);
//     tensor cores for the Mhat rebuild are ruled out by the precision the
//     acceptance ratio needs (TF32 does not do: ROADMAP).
//
// There are no atomics on floating-point sums: two launches give the same
// bits. The NaN-clamp count is an integer and is added atomically.
//
// Numerics: built with -fmad=false and without --use_fast_math
// (ops/_build.py). Each per-element term is evaluated in the order, and with
// the roundings, of the plain PyTorch version (ops/stream_sweeps.py), and
// the sums accumulate in double and are rounded to float32 once, as the
// plain version sums; the two then agree to a few ulps at any G. The
// epilogue's special functions reproduce the ones the plain version calls on
// the card: erff/erfcf/logf/expf/log1pf are the CUDA library's, which ATen
// calls too; at_ndtri writes out ATen's jiterated Cephes ndtri, which is
// compiled with FMA contraction, hence the explicit fmaf in it, and equals
// it bit for bit; at_sigmoid is ATen's float sigmoid, 1 / (1 + exp(-x)) in
// float, which no FMA can contract; at_log_ndtr is ATen's jiterated
// log_ndtr, whose erfcx is the CUDA library's erfcxf, with the FMA its
// compiler contracts: equal to torch.special.log_ndtr at all 4,194,304
// arguments that chip_smoke.py checks (on an H100, torch 2.11).
//
// Layout: float32, contiguous. data (K, G) is shared by the chains; E
// (C, N, G); PA and P (C, K, N); A (C, N); en (C, G); pn (C, K); prop (C, K)
// for a P column or (C, G) for an E row; an (C,). Sums-only outputs: P
// column (n_out, C, K), E row (n_out, C, G); A column (C,), metrics (4, C).
// The metrics row: (C, 12) with a row stride (a slice of a chunk buffer).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kFloor = 1e-6f;
// what a block can opt in to on an H100
constexpr size_t kSmemMax = 227 * 1024;

// jnp.maximum: NaN in either operand gives NaN (fmaxf would drop it)
__device__ __forceinline__ float jmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fminf(a, b);
}

__device__ __forceinline__ double warp_allsum(double v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// ---- the special functions of a column update's epilogue -------------------

// ATen's polevl of the jiterated ndtri: Horner with contracted FMAs
template <int L>
__device__ __forceinline__ float polevl(float x, const float (&A)[L]) {
  float r = 0.0f;
#pragma unroll
  for (int i = 0; i < L; ++i) r = __fmaf_rn(r, x, A[i]);
  return r;
}

// torch.special.ndtri on the card (ATen's Cephes ndtri, float)
__device__ float at_ndtri(float y0) {
  if (y0 == 0.0f) return -INFINITY;
  if (y0 == 1.0f) return INFINITY;
  if (y0 < 0.0f || y0 > 1.0f) return NAN;
  constexpr float kExpM2 = 0.13533528323661269189f;
  bool code = true;
  float y = y0;
  if (y > 1.0f - kExpM2) {
    y = 1.0f - y;
    code = false;
  }
  if (y > kExpM2) {
    const float P0[5] = {-5.99633501014107895267E1f, 9.80010754185999661536E1f,
                         -5.66762857469070293439E1f, 1.39312609387279679503E1f,
                         -1.23916583867381258016E0f};
    const float Q0[9] = {1.00000000000000000000E0f, 1.95448858338141759834E0f,
                         4.67627912898881538453E0f, 8.63602421390890590575E1f,
                         -2.25462687854119370527E2f, 2.00260212380060660359E2f,
                         -8.20372256168333339912E1f, 1.59056225126211695515E1f,
                         -1.18331621121330003142E0f};
    constexpr float s2pi = 2.50662827463100050242E0f;
    y = y - 0.5f;
    const float y2 = y * y;
    const float x = __fmaf_rn(y, y2 * polevl(y2, P0) / polevl(y2, Q0), y);
    return x * s2pi;
  }
  float x = sqrtf(-2.0f * logf(y));
  const float x0 = x - logf(x) / x;
  const float z = 1.0f / x;
  float x1;
  if (x < 8.0f) {
    const float P1[9] = {4.05544892305962419923E0f, 3.15251094599893866154E1f,
                         5.71628192246421288162E1f, 4.40805073893200834700E1f,
                         1.46849561928858024014E1f, 2.18663306850790267539E0f,
                         -1.40256079171354495875E-1f,
                         -3.50424626827848203418E-2f,
                         -8.57456785154685413611E-4f};
    const float Q1[9] = {1.00000000000000000000E0f, 1.57799883256466749731E1f,
                         4.53907635128879210584E1f, 4.13172038254672030440E1f,
                         1.50425385692907503408E1f, 2.50464946208309415979E0f,
                         -1.42182922854787788574E-1f,
                         -3.80806407691578277194E-2f,
                         -9.33259480895457427372E-4f};
    x1 = z * polevl(z, P1) / polevl(z, Q1);
  } else {
    const float P2[9] = {3.23774891776946035970E0f, 6.91522889068984211695E0f,
                         3.93881025292474443415E0f, 1.33303460815807542389E0f,
                         2.01485389549179081538E-1f,
                         1.23716634817820021358E-2f,
                         3.01581553508235416007E-4f,
                         2.65806974686737550832E-6f,
                         6.23974539184983293730E-9f};
    const float Q2[9] = {1.00000000000000000000E0f, 6.02427039364742014255E0f,
                         3.67983563856160859403E0f, 1.37702099489081330271E0f,
                         2.16236993594496635890E-1f,
                         1.34204006088543189037E-2f,
                         3.28014464682127739104E-4f,
                         2.89247864745380683936E-6f,
                         6.79019408009981274425E-9f};
    x1 = z * polevl(z, P2) / polevl(z, Q2);
  }
  x = x0 - x1;
  return code ? -x : x;
}

// torch.special.log_ndtr on the card. ATen jiterates log_ndtr by itself,
// so its erfcx of a float is the CUDA library's erfcxf (not ATen's
// Chebyshev erfcx, which torch.special.erfcx runs), and NVRTC contracts the
// difference below -1 to an FMA. Both branches are evaluated and one is
// selected, so that a thread's log_ndtr chains of several entries can
// interleave (prior_sums).
__device__ __forceinline__ float at_log_ndtr(float x) {
  constexpr float c = 0.707106781186547524400844362104849039f;
  const float t = x * c;
  const float below = __fmaf_rn(-t, t, logf(erfcxf(-t) / 2.0f));
  const float above = log1pf(-erfcf(t) / 2.0f);
  return x < -1.0f ? below : above;
}

// ops/distributions.py::_ndtr: erfc in both tails, each op rounded alone
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

// torch.sigmoid on the card for float (ATen's sigmoid_kernel_cuda, not
// jiterated for real types): one / (one + exp(-a)) in float
__device__ float at_sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

constexpr float kTiny = 1.1754944e-38f;
constexpr float kHalfLog2Pi = 0.9189385332046727f;

// ops/distributions.py::truncnorm_nonneg_from_u
__device__ float tn_draw(float u1, float u2, float mu, float var) {
  const float sd = sqrtf(var);
  const float alpha = -mu / sd;
  const float tail = port_ndtr(-alpha);
  const float v = jmax(u1 * tail, kTiny);
  const float z_icdf = jmax(-at_ndtri(v), alpha);
  const float a_safe = jmax(alpha, 1.0f);
  const float z_tail = a_safe - logf(jmax(u2, kTiny)) / a_safe;
  const float z = alpha > 8.0f ? z_tail : z_icdf;
  return jmax(mu + sd * z, 0.0f);
}

// ops/math.py::truncnorm_logpdf
__device__ __forceinline__ float tn_logpdf(float x, float mu, float var) {
  const float sd = sqrtf(var);
  const float z = (x - mu) / sd;
  const float log_norm = (-0.5f * z) * z - logf(sd) - kHalfLog2Pi;
  const float log_tail = at_log_ndtr(mu / sd);
  return x >= 0.0f ? log_norm - log_tail : -INFINITY;
}

// ops/math.py::exponential_logpdf
__device__ __forceinline__ float exp_logpdf(float x, float rate) {
  return x >= 0.0f ? logf(rate) - rate * x : -INFINITY;
}

constexpr float kEps = 1e-30f;  // floor of an exponential conditional's
                                // precision

// What one entry of a column brings to its update: the current value, its
// prior pair (mu0, sq0 = Mu, Sigmasq; or mu0 = Lambda of the exponential
// prior) and prior draw, the three uniforms, A_n, and the three flags.
struct Entry {
  float old, mu0, sq0, prior_draw, u1, u2, u3, a_n;
  bool inactive, accept_all, expo;
};

// ops/stream_sweeps.py::_conditional: mean and variance of the column's
// conditional at the sums (mu1, a_n * den_raw). The exponential prior moves
// the mean by -Lambda with the precision floored at 1e-30; the truncated
// normal adds its own precision and mean.
__device__ __forceinline__ void conditional(const Entry& in, float mu1,
                                            float den_raw, float* mu,
                                            float* var) {
  if (in.expo) {
    const float den_s = jmax(in.a_n * den_raw, kEps);
    *mu = (mu1 - in.mu0) / den_s;
    *var = 1.0f / den_s;
  } else {
    const float den2 = in.a_n * den_raw + 1.0f / in.sq0;
    *mu = (mu1 + in.mu0 / in.sq0) / den2;
    *var = 1.0f / den2;
  }
}

// The conditional at the sums of the first pass, and the proposal: the
// conditional draw, or the prior draw of an inactive column
__device__ void propose(const Entry& in, float mu1, float den_raw, float* mu,
                        float* var, float* proposal) {
  conditional(in, mu1, den_raw, mu, var);
  const float cond = tn_draw(in.u1, in.u2, *mu, *var);
  *proposal = in.inactive ? in.prior_draw : cond;
}

// The Hastings ratio from the sums of the second pass and _mh_accept, then
// the excluded-column rule. Returns the entry's new value; *rec is what the
// acceptance record takes (the old record for an excluded column), *nan
// whether the ratio was a NaN (clamped to 0 and counted).
__device__ float decide(const Entry& in, float mu, float var, float proposal,
                        float lp, float mu1_r, float den_raw_r, float rec_old,
                        float* rec, bool* nan) {
  float mu_r, var_r;
  conditional(in, mu1_r, den_raw_r, &mu_r, &var_r);
  float delta;  // the prior's part of the log ratio
  if (in.expo) {
    delta = -in.mu0 * (proposal - in.old);
  } else {
    const float zn = proposal - in.mu0, zo = in.old - in.mu0;
    delta = (-0.5f * (zn * zn - zo * zo)) / in.sq0;
  }
  float log_ratio = lp + delta + tn_logpdf(in.old, mu_r, var_r)
                    - tn_logpdf(proposal, mu, var);
  if (in.inactive) log_ratio = 0.0f;
  const float ratio_raw = jmin(expf(log_ratio), 1.0f);
  *nan = isnan(ratio_raw);
  const float ratio = *nan ? 0.0f : ratio_raw;
  const bool take = in.accept_all || in.u3 < ratio;
  const bool excluded = in.a_n == 0.0f;
  *rec = excluded ? rec_old : (in.accept_all ? 1.0f : ratio);
  return excluded ? in.prior_draw : (take ? proposal : in.old);
}

// ---- the register tile -----------------------------------------------------
// mh[u] = sum_n x[n] * y[u][n] for kUnroll rows y[u] at once, n in order,
// float32, each product and sum rounded alone: x in registers, each row 16-byte
// aligned in shared memory, both zero from N to NP (a padded term adds
// 0 * 0). The kUnroll sums are independent chains of
// dependent adds, interleaved so that one thread keeps the pipe busy.
constexpr int kUnroll = 4;

template <int NP>
__device__ __forceinline__ void dot_ordered(const float (&x)[NP],
                                            const float* const (&y)[kUnroll],
                                            float (&mh)[kUnroll]) {
#pragma unroll
  for (int j = 0; j < NP / 4; ++j) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float4 v = reinterpret_cast<const float4*>(y[u])[j];
      mh[u] = j == 0 ? x[0] * v.x : mh[u] + x[4 * j] * v.x;
      mh[u] = mh[u] + x[4 * j + 1] * v.y;
      mh[u] = mh[u] + x[4 * j + 2] * v.z;
      mh[u] = mh[u] + x[4 * j + 3] * v.w;
    }
  }
}

// The per-element terms of the two passes, summed in double.
// stats (P column: other = en, own = pn*en; E row: other = pn):
//   mu1 += (data - (Mh - own)) / max(Mh, floor) * other
//   den += 1 / max(Mh, floor) * other^2
// accept, at lam_new = max(Mh - own + own_new, floor):
//   lp += data * log1p(d / lam) - d, and mu1_r, den_r at lam_new
__device__ __forceinline__ void stats_terms(float m, float mh, float own,
                                            float other, double* s0,
                                            double* s1) {
  const float inv = 1.0f / jmax(mh, kFloor);
  const float resid = m - (mh - own);
  *s0 += (double)((resid * inv) * other);
  *s1 += (double)(inv * (other * other));
}

__device__ __forceinline__ void accept_terms(float m, float mh, float own,
                                             float own_new, float other,
                                             double* s0, double* s1,
                                             double* s2) {
  const float mh_no = mh - own;
  const float lam = jmax(mh, kFloor);
  const float lam_new = jmax(mh_no + own_new, kFloor);
  const float d = lam_new - lam;
  const float invr = 1.0f / lam_new;
  const float resid = m - mh_no;
  *s0 += (double)(m * log1pf(d / lam) - d);
  *s1 += (double)((resid * invr) * other);
  *s2 += (double)(invr * (other * other));
}

enum Mode { kStats = 0, kAccept = 1, kUpdate = 2 };

// ---- E row ------------------------------------------------------------------
// Two forms, by K: below kSplitMinK one thread owns one g and walks all K
// rows (erow_kernel, P*A staged whole); from it on a cluster of blocks owns
// 32 g and their warps split the K rows (erow_split_kernel, P*A streamed
// through the warps' rings, Mhat kept between the passes).
constexpr int kRowThreads = 128;

struct ErowArgs {
  const float* data;
  float* E;          // read; row n written by an update
  const float* PA;
  // sums only: en (C, G) = A_n*E_n, pn (C, K) raw, prop (C, G) = A_n*proposal
  const float *en, *pn, *prop;
  float* out;        // sums only: (n_out, C, G)
  // update: P (C, K, N), A (C, N), the acceptance record (C, N, G), the
  // prior pair and prior draw (C, N, G), uniforms (C, 3, N, G), the warmup
  // flags (C,) as floats, the NaN-clamp counts (C,); expo: the prior is the
  // exponential one, Lambda in mu0 (sq0 is not read)
  const float *P, *A;
  float* acc;
  const float *mu0, *sq0, *prior_draw, *U, *accept_all;
  int* nan;
  int n, expo;
  int C, K, N, G;
};

__host__ __device__ inline int pad_rows(int K) {
  return (K + kUnroll - 1) / kUnroll * kUnroll;
}

// Stage rows k0 .. k0 + rows of PA[c] as rows of NP floats, zero from N on
// and past K.
template <int NP>
__device__ void stage_pa(const float* PA, float* sPA, int c, int K, int N,
                         int k0, int rows) {
  const float* pa = PA + (size_t)c * K * N;
  for (int i = threadIdx.x; i < rows * NP; i += blockDim.x) {
    const int k = k0 + i / NP, n = i % NP;
    sPA[i] = (k < K && n < N) ? pa[(size_t)k * N + n] : 0.0f;
  }
}

// E[c, :, g] in registers, zero from N on and for a thread past G.
template <int NP>
__device__ __forceinline__ void load_column(const float* e_c, int N, int G,
                                            int g, bool live,
                                            float (&e)[NP]) {
#pragma unroll
  for (int n = 0; n < NP; ++n) {
    e[n] = (live && n < N) ? e_c[(size_t)n * G + g] : 0.0f;
  }
}

// The sums of one pass over the rows of PA staged at sPA, rows k0 .. k1 of
// which sPA holds from row kbase on: stats (pass 1) or accept (pass 2)
// terms, added in order into s0, s1 (and s2).
template <int NP, bool kSecond>
__device__ __forceinline__ void erow_pass(const float* sPA, const float* sP,
                                          const float* data,
                                          const float (&e)[NP], int K, int G,
                                          int g, int kbase, int k1, float es,
                                          float q, double* s0, double* s1,
                                          double* s2) {
  for (int k0 = kbase; k0 < k1; k0 += kUnroll) {
    float mh[kUnroll];
    const float* rows[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) rows[u] = sPA + (k0 - kbase + u) * NP;
    dot_ordered<NP>(e, rows, mh);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u;
      if (k < K) {
        const float p = sP[k];
        if (kSecond) {
          accept_terms(data[(size_t)k * G + g], mh[u], p * es, p * q, p, s0,
                       s1, s2);
        } else {
          stats_terms(data[(size_t)k * G + g], mh[u], p * es, p, s0, s1);
        }
      }
    }
  }
}

// Whole form: P*A staged whole (K < kSplitMinK), one thread a g.
template <int NP, int MODE>
__global__ void __launch_bounds__(kRowThreads) erow_kernel(ErowArgs a) {
  extern __shared__ float4 smem4[];
  const int K = a.K, N = a.N, G = a.G;
  const int KC = pad_rows(K);                     // rows staged
  float* sPA = reinterpret_cast<float*>(smem4);   // KC x NP
  float* sP = sPA + KC * NP;                      // K: the raw P column
  const int c = blockIdx.y, tid = threadIdx.x;
  const int g = blockIdx.x * kRowThreads + tid;
  const bool live = g < G;

  stage_pa<NP>(a.PA, sPA, c, K, N, 0, KC);
  bool nz = false;  // some P_n[k]^2 != 0: the row is not inactive
  for (int k = tid; k < K; k += kRowThreads) {
    const float p = MODE == kUpdate ? a.P[((size_t)c * K + k) * N + a.n]
                                    : a.pn[(size_t)c * K + k];
    sP[k] = p;
    nz |= p * p != 0.0f;
  }
  const bool inactive = !__syncthreads_or(nz);

  const float* e_c = a.E + (size_t)c * N * G;
  float e[NP];
  load_column<NP>(e_c, N, G, g, live, e);
  const size_t cg_at = (size_t)c * G + g;
  const size_t row_at = ((size_t)c * N + a.n) * G + g;  // update only
  Entry in;
  float es = 0.0f;  // A_n * E_n[g]
  if (live) {
    if (MODE == kUpdate) {
      in.a_n = a.A[(size_t)c * N + a.n];
      in.old = e_c[(size_t)a.n * G + g];
      es = in.a_n * in.old;
    } else {
      es = a.en[cg_at];
    }
  }

  double s0 = 0.0, s1 = 0.0, s2 = 0.0;
  if (live && MODE != kAccept) {
    erow_pass<NP, false>(sPA, sP, a.data, e, K, G, g, 0, K, es, 0.0f, &s0,
                         &s1, &s2);
  }
  const size_t CG = (size_t)a.C * G;
  if (MODE == kStats) {
    if (live) {
      a.out[cg_at] = (float)s0;
      a.out[CG + cg_at] = (float)s1;
    }
    return;
  }

  float mu = 0.0f, var = 0.0f, proposal = 0.0f, q = 0.0f;
  if (live) {
    if (MODE == kUpdate) {
      in.mu0 = a.mu0[row_at];
      in.sq0 = a.sq0[row_at];
      in.prior_draw = a.prior_draw[row_at];
      const float* u = a.U + ((size_t)c * 3 * N + a.n) * G + g;
      in.u1 = u[0];
      in.u2 = u[(size_t)N * G];
      in.u3 = u[(size_t)2 * N * G];
      in.inactive = inactive;
      in.accept_all = a.accept_all[c] != 0.0f;
      in.expo = a.expo != 0;
      propose(in, (float)s0, (float)s1, &mu, &var, &proposal);
      q = in.a_n * proposal;
    } else {
      q = a.prop[cg_at];
    }
    s0 = s1 = 0.0;
  }
  // the Mhat column is rebuilt: keeping its K values in shared memory
  // costs more in resident warps than the rebuild does in operations
  if (live) {
    erow_pass<NP, true>(sPA, sP, a.data, e, K, G, g, 0, K, es, q, &s0, &s1,
                        &s2);
  }
  if (MODE == kAccept) {
    if (live) {
      a.out[cg_at] = (float)s0;
      a.out[CG + cg_at] = (float)s1;
      a.out[2 * CG + cg_at] = (float)s2;
    }
    return;
  }
  bool nan = false;
  if (live) {
    float rec;
    a.E[row_at] = decide(in, mu, var, proposal, (float)s0, (float)s1,
                         (float)s2, a.acc[row_at], &rec, &nan);
    a.acc[row_at] = rec;
  }
  const int n_nan = __syncthreads_count(nan);
  if (tid == 0 && n_nan) atomicAdd(a.nan + c, n_nan);
}

// Split form (K >= kSplitMinK): 32 consecutive g, a lane one g, so that each
// data row is one coalesced load of a warp, taken by a thread-block cluster
// of kc blocks along K (split_blocks: kc = 1, 2 or 4, a block at most
// kSplitMaxRows rows) whose kSplitWarps warps each take a contiguous slice
// of the block's rows. Each warp streams its rows of P*A through its own
// ring of kSplitStages slots of kSplitRows rows in shared memory, filled
// by cp.async ahead of the slot in use and waited on by the warp alone (no
// block barrier in the passes), and keeps the Mhat values of its rows
// (first pass) in shared memory for the second pass, which then rebuilds
// nothing. Each lane's double partials meet in shared memory in warp
// order; the blocks' sums go to block 0 of the cluster through distributed
// shared memory and are added there in block order; block 0's warp 0
// makes the proposal for its 32 g (sent back to every block's shared
// memory) and takes the decision.
constexpr int kSplitMinK = 192;
constexpr int kSplitMaxRows = 384;
constexpr int kSplitWarps = 8;
constexpr int kSplitThreads = 32 * kSplitWarps;
constexpr int kSplitRows = 2 * kUnroll;
constexpr int kSplitChunk = kSplitWarps * kSplitRows;
constexpr int kSplitStages = 3;

namespace cgr = cooperative_groups;

// Blocks of a split-form cluster, and the rows of a block and of a warp
__host__ __device__ inline int split_blocks(int K) {
  int kc = 1;
  while ((K + kc - 1) / kc > kSplitMaxRows) kc *= 2;
  return kc;
}
__host__ __device__ inline int split_block_rows(int K) {
  const int kc = split_blocks(K);
  return (K + kc - 1) / kc;
}
__host__ __device__ inline int split_warp_rows(int K) {
  return (split_block_rows(K) + kSplitWarps - 1) / kSplitWarps;
}

// Shared memory of a split-form block, in bytes: as doubles the warps'
// partials (3 a thread) and block 0's partials of the cluster (kc x 3 x
// 32); as floats the rings (kSplitStages x kSplitChunk rows of NP), the
// block's rows of the P column, the warps' Mhat values (kSplitWarps x
// split_warp_rows x 32), the 32 scaled proposals and block 0's flags (kc).
__host__ __device__ inline size_t split_smem_bytes(int K, int NP) {
  const int kc = split_blocks(K);
  return ((size_t)3 * kSplitThreads + (size_t)kc * 3 * 32) * sizeof(double)
         + ((size_t)kSplitStages * kSplitChunk * NP + split_block_rows(K)
            + (size_t)kSplitWarps * split_warp_rows(K) * 32 + 32 + kc)
               * sizeof(float);
}

// 4 bytes global -> shared, asynchronously; zero-filled where !in
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Rows k0 .. k0 + kSplitRows of pa (K x N), up to k1, into dst as rows of
// NP floats, zero from N on and from k1 on: by the lanes of one warp.
template <int NP>
__device__ __forceinline__ void stage_rows(const float* pa, float* dst,
                                           int k1, int N, int k0) {
  for (int i = threadIdx.x & 31; i < kSplitRows * NP; i += 32) {
    const int k = k0 + i / NP, n = i % NP;
    const bool in = k < k1 && n < N;
    cp_async4(dst + i, in ? pa + (size_t)k * N + n : pa, in);
  }
}

// One pass of the split form over this warp's rows [kw0, kw1), in order,
// into the lane's s0, s1 (and s2); sP holds the block's rows from kb0.
// kRebuild: Mhat rebuilt through the warp's ring (and kept in wcache where
// it is not null), else read from wcache.
template <int NP, bool kSecond, bool kRebuild>
__device__ void split_pass(const float* pa, float* ring, const float* sP,
                           int kb0, float* wcache, const float* data,
                           const float (&e)[NP], int kw0, int kw1, int N,
                           int G, int g, bool live, float es, float q,
                           double* s0, double* s1, double* s2) {
  const int lane = threadIdx.x & 31;
  if (!kRebuild) {
    if (!live) return;
#pragma unroll 4
    for (int k = kw0; k < kw1; ++k) {
      const float p = sP[k - kb0];
      accept_terms(data[(size_t)k * G + g], wcache[(k - kw0) * 32 + lane],
                   p * es, p * q, p, s0, s1, s2);
    }
    return;
  }
  constexpr int kSlot = kSplitRows * NP;
  const int chunks = (kw1 - kw0 + kSplitRows - 1) / kSplitRows;
  for (int j = 0; j < kSplitStages - 1; ++j) {
    if (j < chunks) {
      stage_rows<NP>(pa, ring + j * kSlot, kw1, N, kw0 + j * kSplitRows);
    }
    cp_async_commit();
  }
  for (int j = 0; j < chunks; ++j) {
    const int jn = j + kSplitStages - 1;
    if (jn < chunks) {
      stage_rows<NP>(pa, ring + (jn % kSplitStages) * kSlot, kw1, N,
                     kw0 + jn * kSplitRows);
    }
    cp_async_commit();
    cp_async_wait<kSplitStages - 1>();  // chunk j has landed
    __syncwarp();
    const float* slot = ring + (j % kSplitStages) * kSlot;
    const int kb = kw0 + j * kSplitRows;
    if (live) {
#pragma unroll
      for (int h = 0; h < kSplitRows; h += kUnroll) {
        float m[kUnroll], mh[kUnroll];
        const float* rows[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int k = kb + h + u;
          m[u] = k < kw1 ? data[(size_t)k * G + g] : 0.0f;
          rows[u] = slot + (h + u) * NP;
        }
        dot_ordered<NP>(e, rows, mh);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int k = kb + h + u;
          if (k < kw1) {
            const float p = sP[k - kb0];
            if (wcache != nullptr) wcache[(k - kw0) * 32 + lane] = mh[u];
            if (kSecond) {
              accept_terms(m[u], mh[u], p * es, p * q, p, s0, s1, s2);
            } else {
              stats_terms(m[u], mh[u], p * es, p, s0, s1);
            }
          }
        }
      }
    }
    __syncwarp();  // the slot is free for the chunk after next
  }
}

// The warps' partials of the block's 32 g in warp order, into warp 0's
// s[0..nv), then into block 0's xpart (its row of the cluster's blocks).
__device__ __forceinline__ void split_meet(cgr::cluster_group& cluster,
                                           double* part, double* xpart,
                                           double* s, int nv) {
  const int tid = threadIdx.x, lane = tid & 31;
  for (int j = 0; j < nv; ++j) part[j * kSplitThreads + tid] = s[j];
  __syncthreads();
  if (tid >= 32) return;
  double* x = cluster.map_shared_rank(xpart, 0)
              + cluster.block_rank() * 3 * 32 + lane;
  for (int j = 0; j < nv; ++j) {
    double t = 0.0;
    for (int w = 0; w < kSplitWarps; ++w) {
      t += part[j * kSplitThreads + w * 32 + lane];
    }
    x[j * 32] = t;
  }
}

// Block 0's sums of the cluster's blocks, in block order
__device__ __forceinline__ double split_total(const double* xpart, int kc,
                                              int j) {
  double t = 0.0;
  for (int r = 0; r < kc; ++r) t += xpart[(r * 3 + j) * 32 + (threadIdx.x & 31)];
  return t;
}

// Three blocks an SM up to a 32-wide register tile (at most 85 registers a
// thread); the 64- and 128-wide tiles keep the registers they need (held to
// 85, the 128-wide one spills and runs slower).
template <int NP, int MODE>
__global__ void __launch_bounds__(kSplitThreads, NP <= 32 ? 3 : 1)
erow_split_kernel(ErowArgs a) {
  extern __shared__ float4 smem4[];
  cgr::cluster_group cluster = cgr::this_cluster();
  const int kc = (int)cluster.num_blocks(), crank = (int)cluster.block_rank();
  const int K = a.K, N = a.N, G = a.G;
  const int Kb = split_block_rows(K), Kw = split_warp_rows(K);
  double* part = reinterpret_cast<double*>(smem4);  // [3][kSplitThreads]
  double* xpart = part + 3 * kSplitThreads;         // [kc][3][32], block 0's
  float* ring = reinterpret_cast<float*>(xpart + kc * 3 * 32);
  float* sP = ring + kSplitStages * kSplitChunk * NP;  // the block's rows
  float* cache = sP + Kb;                              // [warps][Kw][32]
  float* sQ = cache + kSplitWarps * Kw * 32;           // 32
  int* flags = reinterpret_cast<int*>(sQ + 32);        // [kc], block 0's
  const int c = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.x / kc * 32 + lane;
  const bool live = g < G;
  const float* pa = a.PA + (size_t)c * K * N;
  // this block's rows and this warp's
  const int kb0 = crank * Kb < K ? crank * Kb : K;
  const int kb1 = K - kb0 < Kb ? K : kb0 + Kb;
  const int kw0 = kb0 + warp * Kw < kb1 ? kb0 + warp * Kw : kb1;
  const int kw1 = kb1 - kw0 < Kw ? kb1 : kw0 + Kw;
  ring += warp * kSplitStages * kSplitRows * NP;
  float* wcache = cache + warp * Kw * 32;

  bool nz = false;  // some P_n[k]^2 != 0: the row is not inactive
  for (int k = kb0 + tid; k < kb1; k += kSplitThreads) {
    const float p = MODE == kUpdate ? a.P[((size_t)c * K + k) * N + a.n]
                                    : a.pn[(size_t)c * K + k];
    sP[k - kb0] = p;
    nz |= p * p != 0.0f;
  }
  const int any = __syncthreads_or(nz);
  if (tid == 0) *cluster.map_shared_rank(flags + crank, 0) = any;

  const float* e_c = a.E + (size_t)c * N * G;
  float e[NP];
  load_column<NP>(e_c, N, G, g, live, e);
  const size_t cg_at = (size_t)c * G + g;
  const size_t row_at = ((size_t)c * N + a.n) * G + g;  // update only
  Entry in;
  float es = 0.0f;  // A_n * E_n[g]
  if (live) {
    if (MODE == kUpdate) {
      in.a_n = a.A[(size_t)c * N + a.n];
      in.old = e_c[(size_t)a.n * G + g];
      es = in.a_n * in.old;
    } else {
      es = a.en[cg_at];
    }
  }

  const size_t CG = (size_t)a.C * G;
  const bool lead = crank == 0 && warp == 0;  // makes the decisions
  double s[3] = {0.0, 0.0, 0.0};
  if (MODE != kAccept) {
    split_pass<NP, false, true>(pa, ring, sP, kb0,
                                MODE == kUpdate ? wcache : nullptr, a.data,
                                e, kw0, kw1, N, G, g, live, es, 0.0f, &s[0],
                                &s[1], &s[2]);
    split_meet(cluster, part, xpart, s, 2);
  }
  cluster.sync();  // the blocks' sums and flags are in block 0
  if (MODE == kStats) {
    if (lead && live) {
      a.out[cg_at] = (float)split_total(xpart, kc, 0);
      a.out[CG + cg_at] = (float)split_total(xpart, kc, 1);
    }
    return;
  }

  float mu = 0.0f, var = 0.0f, proposal = 0.0f;
  if (MODE == kUpdate) {
    if (lead) {
      bool inactive = true;
      for (int r = 0; r < kc; ++r) inactive &= flags[r] == 0;
      float q = 0.0f;
      if (live) {
        in.mu0 = a.mu0[row_at];
        in.sq0 = a.sq0[row_at];
        in.prior_draw = a.prior_draw[row_at];
        const float* u = a.U + ((size_t)c * 3 * N + a.n) * G + g;
        in.u1 = u[0];
        in.u2 = u[(size_t)N * G];
        in.u3 = u[(size_t)2 * N * G];
        in.inactive = inactive;
        in.accept_all = a.accept_all[c] != 0.0f;
        in.expo = a.expo != 0;
        propose(in, (float)split_total(xpart, kc, 0),
                (float)split_total(xpart, kc, 1), &mu, &var, &proposal);
        q = in.a_n * proposal;
      }
      for (int r = 0; r < kc; ++r) *cluster.map_shared_rank(sQ + lane, r) = q;
    }
    cluster.sync();  // every block has the proposals
  } else {
    if (warp == 0) sQ[lane] = live ? a.prop[cg_at] : 0.0f;
    __syncthreads();
  }
  s[0] = s[1] = s[2] = 0.0;
  if (MODE == kUpdate) {
    split_pass<NP, true, false>(pa, ring, sP, kb0, wcache, a.data, e, kw0,
                                kw1, N, G, g, live, es, sQ[lane], &s[0],
                                &s[1], &s[2]);
  } else {
    split_pass<NP, true, true>(pa, ring, sP, kb0, nullptr, a.data, e, kw0,
                               kw1, N, G, g, live, es, sQ[lane], &s[0],
                               &s[1], &s[2]);
  }
  split_meet(cluster, part, xpart, s, 3);
  cluster.sync();
  if (!lead) return;
  const float lp = (float)split_total(xpart, kc, 0);
  const float mu1_r = (float)split_total(xpart, kc, 1);
  const float den_r = (float)split_total(xpart, kc, 2);
  if (MODE == kAccept) {
    if (live) {
      a.out[cg_at] = lp;
      a.out[CG + cg_at] = mu1_r;
      a.out[2 * CG + cg_at] = den_r;
    }
    return;
  }
  bool nan = false;
  if (live) {
    float rec;
    a.E[row_at] = decide(in, mu, var, proposal, lp, mu1_r, den_r,
                         a.acc[row_at], &rec, &nan);
    a.acc[row_at] = rec;
  }
  const int n_nan = __popc(__ballot_sync(0xffffffffu, nan));
  if (lane == 0 && n_nan) atomicAdd(a.nan + c, n_nan);
}

// ---- P column: tiles of G, then an ordered sum and the epilogue --------------
// The sums of a row k run over all G of a chain. A tile kernel on a grid of
// (G tiles, C) writes each tile's partial sums in double; a finishing kernel
// with one block per chain adds the tiles in a fixed order and does what
// follows the sums: it writes them out (the sums-only functions), or makes
// the proposal (after the first pass), or takes the decision and writes the
// column back (after the second).
//
// Inside a tile block a thread owns one row k, its P*A row in registers, and
// a group of such rows owns every `groups`-th g of the tile; the E tile,
// transposed, is read from shared memory as float4 broadcasts and the data
// tile is staged with a padded stride. The sums of a row stay in its
// thread's registers; the groups are added in order.
constexpr int kColThreads = 384;
constexpr int kColTile = 64;      // G width of a tile where it fits
constexpr int kFinishThreads = 1024;
constexpr int kFinishLoads = 8;   // tile partials a lane has in flight

struct PcolArgs {
  const float* data;
  const float* E;
  float* PA;         // read; column n written by an update
  // sums only: en (C, G) raw, pn (C, K) = A_n*P_n, prop (C, K) = A_n*proposal
  const float *en, *pn, *prop;
  float* out;        // sums only: (n_out, C, K)
  // update: P and the acceptance record (C, K, N), A (C, N), the prior pair
  // and prior draw (C, K, N), uniforms (C, 3, N, K), warmup flags, counts;
  // expo as in ErowArgs
  float* P;
  const float* A;
  float* acc;
  const float *mu0, *sq0, *prior_draw, *U, *accept_all;
  int* nan;
  // the tiles' partial sums (C, K, 3, tiles) and, between an update's two
  // passes, the scaled proposal, mu, var and the proposal (C, 4, K)
  double* scratch;
  float* work;
  int n, expo;
  int C, K, N, G;
  int lg_gt;         // log2 of the tile's G width (col_tile)
};

__host__ __device__ inline int col_rows(int K) {
  const int r = (K + 31) / 32 * 32;
  return r < kColThreads ? r : kColThreads;
}

// Shared memory of a tile block of G width gt, in floats: the E tile
// transposed (gt x NP), the group partials as doubles (groups x K x 3), the
// data tile (K x (gt + 1)), en (gt), pn and the scaled proposal (K each).
__host__ __device__ inline size_t col_smem_floats(int K, int NP, int gt) {
  const int groups = kColThreads / col_rows(K);
  return (size_t)gt * NP + 2 * (size_t)groups * K * 3
         + (size_t)K * (gt + 1) + gt + (size_t)2 * K;
}

// kWide: the tile is kColTile wide, a compile-time width (kWideBuilt);
// else 1 << a.lg_gt wide (col_tile: 64, or 32 or 16 at large K)
template <int NP, int MODE, bool kSecond, bool kWide>
__global__ void __launch_bounds__(kColThreads) pcol_tile_kernel(PcolArgs a) {
  extern __shared__ float4 smem4[];
  const int K = a.K, N = a.N, G = a.G;
  const int lg = kWide ? 6 : a.lg_gt;
  const int Gt = kWide ? kColTile : 1 << lg, ld = Gt + 1;
  constexpr int n_out = kSecond ? 3 : 2;
  const int rows = col_rows(K), groups = kColThreads / rows;
  float* sE = reinterpret_cast<float*>(smem4);
  double* part = reinterpret_cast<double*>(sE + Gt * NP);
  float* sData = reinterpret_cast<float*>(part + (size_t)groups * K * 3);
  float* sEn = sData + (size_t)K * ld;
  float* sPn = sEn + Gt;
  float* sQ = sPn + K;
  const int t = blockIdx.x, c = blockIdx.y, tid = threadIdx.x;
  const int grp = tid / rows, kk = tid % rows;
  const int g0 = t * Gt;
  const int gcount = G - g0 < Gt ? G - g0 : Gt;

  const float a_n = MODE == kUpdate ? a.A[(size_t)c * N + a.n] : 0.0f;
  const float* en_c = MODE == kUpdate ? a.E + ((size_t)c * N + a.n) * G
                                      : a.en + (size_t)c * G;
  const float* e_c = a.E + (size_t)c * N * G;
  const float* pa_c = a.PA + (size_t)c * K * N;
  for (int i = tid; i < Gt * NP; i += kColThreads) {
    const int n = kWide ? i / kColTile : i >> lg;
    const int gl = kWide ? i % kColTile : i & (Gt - 1), g = g0 + gl;
    sE[gl * NP + n] = (n < N && g < G) ? e_c[(size_t)n * G + g] : 0.0f;
  }
  for (int i = tid; i < K * Gt; i += kColThreads) {
    const int k = kWide ? i / kColTile : i >> lg;
    const int gl = kWide ? i % kColTile : i & (Gt - 1), g = g0 + gl;
    sData[k * ld + gl] = g < G ? a.data[(size_t)k * G + g] : 0.0f;
  }
  for (int gl = tid; gl < Gt; gl += kColThreads) {
    sEn[gl] = g0 + gl < G ? en_c[g0 + gl] : 0.0f;
  }
  for (int k = tid; k < K; k += kColThreads) {
    if (MODE == kUpdate) {
      sPn[k] = a_n * a.P[((size_t)c * K + k) * N + a.n];
      if (kSecond) sQ[k] = a.work[(size_t)c * 4 * K + k];
    } else {
      sPn[k] = a.pn[(size_t)c * K + k];
      if (kSecond) sQ[k] = a.prop[(size_t)c * K + k];
    }
  }
  __syncthreads();

  if (grp < groups) {
    for (int k = kk; k < K; k += rows) {
      float pa[NP];
#pragma unroll
      for (int n = 0; n < NP; ++n) pa[n] = n < N ? pa_c[k * N + n] : 0.0f;
      const float pk = sPn[k];
      const float qk = kSecond ? sQ[k] : 0.0f;
      const float* dk = sData + k * ld;
      double s0 = 0.0, s1 = 0.0, s2 = 0.0;
      for (int gl0 = grp; gl0 < gcount; gl0 += kUnroll * groups) {
        float mh[kUnroll];
        const float* cols[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int gl = gl0 + u * groups;
          cols[u] = sE + (gl < gcount ? gl : gl0) * NP;
        }
        dot_ordered<NP>(pa, cols, mh);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int gl = gl0 + u * groups;
          if (gl < gcount) {
            const float e = sEn[gl];
            if (kSecond) {
              accept_terms(dk[gl], mh[u], pk * e, qk * e, e, &s0, &s1, &s2);
            } else {
              stats_terms(dk[gl], mh[u], pk * e, e, &s0, &s1);
            }
          }
        }
      }
      double* p = part + ((size_t)grp * K + k) * 3;
      p[0] = s0;
      p[1] = s1;
      p[2] = s2;
    }
  }
  __syncthreads();
  // scratch[c][k * 3 + j][t]: the finishing kernel reads along t
  double* out = a.scratch + (size_t)c * K * 3 * gridDim.x + t;
  for (int i = tid; i < K * n_out; i += kColThreads) {
    const int k = i / n_out, j = i % n_out;
    double v = 0.0;
    for (int gr = 0; gr < groups; ++gr) {
      v += part[((size_t)gr * K + k) * 3 + j];
    }
    out[(size_t)(k * 3 + j) * gridDim.x] = v;
  }
}

// What the finishing kernel does with the sums.
enum Finish { kWriteSums = 0, kPropose = 1, kDecide = 2 };

// A warp's sum of row[0..n) in a fixed order: the lanes stride along the row
// with kFinishLoads loads in flight (L2 loads: the row was written by other
// blocks), each lane adds its own in order, then an xor butterfly. Every
// lane returns the sum.
__device__ __forceinline__ double warp_ordered_sum(const double* row, int n,
                                                   int lane) {
  double v = 0.0;
  for (int t0 = 0; t0 < n; t0 += 32 * kFinishLoads) {
    double x[kFinishLoads];  // the loads first, then the adds in order
#pragma unroll
    for (int u = 0; u < kFinishLoads; ++u) {
      const int t = t0 + 32 * u + lane;
      x[u] = t < n ? __ldcg(row + t) : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kFinishLoads; ++u) v += x[u];
  }
  return warp_allsum(v);
}

// One block per chain: the tiles' partials added in a fixed order (a warp
// per sum), then the epilogue. n_out = 2 after a first pass, 3 after a
// second.
template <int FINISH>
__global__ void __launch_bounds__(kFinishThreads)
pcol_finish_kernel(PcolArgs a, int tiles, int n_out) {
  extern __shared__ double tot[];  // K x 3
  const int K = a.K, N = a.N, G = a.G;
  const int c = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const double* sc = a.scratch + (size_t)c * K * 3 * tiles;
  for (int i = warp; i < K * n_out; i += kFinishThreads / 32) {
    const int k = i / n_out, j = i % n_out;
    const double v = warp_ordered_sum(sc + (size_t)(k * 3 + j) * tiles,
                                      tiles, lane);
    if (lane == 0) tot[k * 3 + j] = v;
  }
  if (FINISH == kWriteSums) {
    __syncthreads();
    for (int i = tid; i < K * n_out; i += kFinishThreads) {
      const int k = i / n_out, j = i % n_out;
      a.out[((size_t)j * a.C + c) * K + k] = (float)tot[k * 3 + j];
    }
    return;
  }
  // the column is inactive when its E row is all zero
  const float* en_c = a.E + ((size_t)c * N + a.n) * G;
  bool nz = false;
#pragma unroll 4
  for (int g = tid; g < G; g += kFinishThreads) {
    const float v = en_c[g];
    nz |= v * v != 0.0f;
  }
  const bool inactive = !__syncthreads_or(nz);
  const float a_n = a.A[(size_t)c * N + a.n];
  const bool accept_all = a.accept_all[c] != 0.0f;
  float* work = a.work + (size_t)c * 4 * K;
  int n_nan = 0;
  for (int k = tid; k < K; k += kFinishThreads) {
    const size_t at = ((size_t)c * K + k) * N + a.n;
    const float* u = a.U + ((size_t)c * 3 * N + a.n) * K + k;
    Entry in = {a.P[at], a.mu0[at], a.sq0[at], a.prior_draw[at], u[0],
                u[(size_t)N * K], u[(size_t)2 * N * K], a_n, inactive,
                accept_all, a.expo != 0};
    if (FINISH == kPropose) {
      float mu, var, proposal;
      propose(in, (float)tot[3 * k], (float)tot[3 * k + 1], &mu, &var,
              &proposal);
      work[k] = a_n * proposal;
      work[K + k] = mu;
      work[2 * K + k] = var;
      work[3 * K + k] = proposal;
    } else {
      float rec;
      bool nan;
      const float nv = decide(in, work[K + k], work[2 * K + k],
                              work[3 * K + k], (float)tot[3 * k],
                              (float)tot[3 * k + 1], (float)tot[3 * k + 2],
                              a.acc[at], &rec, &nan);
      a.P[at] = nv;
      a.PA[at] = nv * a_n;
      a.acc[at] = rec;
      n_nan += nan;
    }
  }
  if (n_nan) atomicAdd(a.nan + c, n_nan);
}

// ---- A column: tiles of G, then an ordered sum and the decision -------------
// delta = sum over k and g of data*log1p(d/lam_off) - d with contrib =
// pn*en, Mh_off = Mh - an*contrib, lam_off = max(Mh_off, floor), lam_on =
// max(Mh_off + contrib, floor), d = lam_on - lam_off: loglik(A_n = 1) -
// loglik(A_n = 0). The tile kernel is the P column's (a thread owns a row
// k, its P*A row in registers, a group of rows every `groups`-th g of a
// G tile, 64 wide where it fits) with one sum instead of three; the block
// adds its rows' partials in a fixed order into one double per tile.
struct AcolArgs {
  const float* data;
  const float* E;
  // sums only: PA (C, K, N), en (C, G) raw, pn (C, K) raw, an (C,); out (C,)
  const float *PA, *en, *pn, *an;
  float* out;
  // update: P (C, K, N); A (C, N), column n written; logit (C,) the prior
  // log-odds; temp (1,) the temperature; u (C, N) the Bernoulli uniforms;
  // n_nan (C,) the NaN-fallback counts, as floats; delta (C, N) the
  // column's float32 delta, written
  const float* P;
  float* A;
  const float *logit, *temp, *u;
  float *n_nan, *delta;
  float penalty;  // subtracted from delta when sbfi
  int sbfi;
  double* scratch;   // (C, tiles) partials
  int n;
  int C, K, N, G;
  int lg_gt;         // log2 of the tile's G width (col_tile)
};

// Shared memory of an A-column tile block of G width gt, in floats: the E
// tile transposed (gt x NP), the row partials as doubles (groups x K), the
// data tile (K x (gt + 1)), en (gt), pn (K), A[c, :] (NP).
__host__ __device__ inline size_t acol_smem_floats(int K, int NP, int gt) {
  const int groups = kColThreads / col_rows(K);
  return (size_t)gt * NP + 2 * (size_t)groups * K
         + (size_t)K * (gt + 1) + gt + K + NP;
}

__device__ __forceinline__ void acol_term(float m, float mh, float contrib,
                                          float an, double* s) {
  const float mh_off = mh - an * contrib;
  const float lam_off = jmax(mh_off, kFloor);
  const float lam_on = jmax(mh_off + contrib, kFloor);
  const float d = lam_on - lam_off;
  *s += (double)(m * log1pf(d / lam_off) - d);
}

// What follows the ordered sum of chain c's tiles: the sum (sums only), or
// models/updates.py::stream_sweep_A's step for column n: round once, the
// SBFI penalty, the tempered log-odds, the sigmoid, NaN -> 1/2 counted, the
// draw u < p.
template <bool kUpdate>
__device__ void acol_decide(const AcolArgs& a, int c, double sum) {
  const float d = (float)sum;
  if (!kUpdate) {
    a.out[c] = d;
    return;
  }
  const size_t at = (size_t)c * a.N + a.n;
  a.delta[at] = d;
  const float x = a.sbfi ? d - a.penalty : d;
  float p = at_sigmoid(a.logit[c] + a.temp[0] * x);
  if (isnan(p)) {
    a.n_nan[c] = a.n_nan[c] + 1.0f;
    p = 0.5f;
  }
  a.A[at] = a.u[at] < p ? 1.0f : 0.0f;
}

template <int NP, bool kUpdate, bool kWide>
__global__ void __launch_bounds__(kColThreads) acol_tile_kernel(AcolArgs a) {
  extern __shared__ float4 smem4[];
  const int K = a.K, N = a.N, G = a.G;
  const int lg = kWide ? 6 : a.lg_gt;
  const int Gt = kWide ? kColTile : 1 << lg, ld = Gt + 1;
  const int rows = col_rows(K), groups = kColThreads / rows;
  float* sE = reinterpret_cast<float*>(smem4);
  double* part = reinterpret_cast<double*>(sE + Gt * NP);
  float* sData = reinterpret_cast<float*>(part + (size_t)groups * K);
  float* sEn = sData + (size_t)K * ld;
  float* sPn = sEn + Gt;
  float* sA = sPn + K;
  const int t = blockIdx.x, c = blockIdx.y, tid = threadIdx.x;
  const int grp = tid / rows, kk = tid % rows;
  const int g0 = t * Gt;
  const int gcount = G - g0 < Gt ? G - g0 : Gt;

  const float* e_c = a.E + (size_t)c * N * G;
  const float* en_c = kUpdate ? e_c + (size_t)a.n * G : a.en + (size_t)c * G;
  const float* x_c = (kUpdate ? a.P : a.PA) + (size_t)c * K * N;
  for (int i = tid; i < Gt * NP; i += kColThreads) {
    const int n = kWide ? i / kColTile : i >> lg;
    const int gl = kWide ? i % kColTile : i & (Gt - 1), g = g0 + gl;
    sE[gl * NP + n] = (n < N && g < G) ? e_c[(size_t)n * G + g] : 0.0f;
  }
  for (int i = tid; i < K * Gt; i += kColThreads) {
    const int k = kWide ? i / kColTile : i >> lg;
    const int gl = kWide ? i % kColTile : i & (Gt - 1), g = g0 + gl;
    sData[k * ld + gl] = g < G ? a.data[(size_t)k * G + g] : 0.0f;
  }
  for (int gl = tid; gl < Gt; gl += kColThreads) {
    sEn[gl] = g0 + gl < G ? en_c[g0 + gl] : 0.0f;
  }
  for (int k = tid; k < K; k += kColThreads) {
    sPn[k] = kUpdate ? x_c[(size_t)k * N + a.n] : a.pn[(size_t)c * K + k];
  }
  for (int n = tid; n < NP; n += kColThreads) {
    sA[n] = kUpdate && n < N ? a.A[(size_t)c * N + n] : 0.0f;
  }
  __syncthreads();

  const float an = kUpdate ? sA[a.n] : a.an[c];
  if (grp < groups) {
    for (int k = kk; k < K; k += rows) {
      // the P*A row: P * A as the plain version's P * A.unsqueeze(1)
      float pa[NP];
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        pa[n] = n < N ? (kUpdate ? x_c[k * N + n] * sA[n] : x_c[k * N + n])
                      : 0.0f;
      }
      const float pk = sPn[k];
      const float* dk = sData + k * ld;
      double s = 0.0;
      for (int gl0 = grp; gl0 < gcount; gl0 += kUnroll * groups) {
        float mh[kUnroll];
        const float* cols[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int gl = gl0 + u * groups;
          cols[u] = sE + (gl < gcount ? gl : gl0) * NP;
        }
        dot_ordered<NP>(pa, cols, mh);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int gl = gl0 + u * groups;
          if (gl < gcount) acol_term(dk[gl], mh[u], pk * sEn[gl], an, &s);
        }
      }
      part[(size_t)grp * K + k] = s;
    }
  }
  __syncthreads();
  // the tile's partial: warp 0 along the rows' partials in order
  const int T = gridDim.x;
  double* sc = a.scratch + (size_t)c * T;
  if (tid < 32) {
    const int total = groups * K;
    double v = 0.0;
    for (int i = tid; i < total; i += 32) v += part[i];
    v = warp_allsum(v);
    if (tid == 0) sc[t] = v;
  }
}

// One warp per chain: the tiles' partials added in a fixed order, then the
// decision.
template <bool kUpdate>
__global__ void __launch_bounds__(32) acol_finish_kernel(AcolArgs a,
                                                         int tiles) {
  const int c = blockIdx.x;
  const double sum = warp_ordered_sum(a.scratch + (size_t)c * tiles, tiles,
                                      threadIdx.x);
  if (threadIdx.x == 0) acol_decide<kUpdate>(a, c, sum);
}

// ---- P and A columns from 192 rows on: a block's rows across G --------------
// The row form (the entry points of stream_rows.cu and stream_rows_sums.cu;
// ops/stream_sweeps.py picks it by K, col_rows_form). A block owns kRowsRows rows of one chain, a lane one
// row with its P*A row in registers, and streams G tiles through a ring of
// kRowsStages slots filled by cp.async (the E tile transposed, the data
// tile of its rows with a padded stride, the column's E row); its 8 warps
// take each an eighth of a tile's g, and a row's sums stay in its lanes'
// registers across the block's whole stretch of G. A cluster of rows_parts
// blocks along G (1, 2, 4 or 8, so that the grid fills the card's 132 SMs
// twice where the shape allows) splits the stretch; the warps' sums of a
// row meet in warp order, the blocks' in block order through distributed
// shared memory. Rows are independent in a P-column update, so the
// cluster takes the proposal after the first pass and the decision after
// the second itself (propose and decide, as the finishing kernel takes
// them): one launch a column. An A column sums over its rows too: each
// block adds its rows in a fixed order into one double partial, and
// acol_finish_kernel adds the blocks' partials in order and decides.
constexpr int kRowsRows = 32;
constexpr int kRowsWarps = 8;
constexpr int kRowsThreads = 32 * kRowsWarps;
constexpr int kRowsStages = 3;
// blocks that fill an H100's 132 SMs twice (ops/stream_sweeps.py)
constexpr int kRowsFill = 2 * 132;

// G width of a ring slot: 64, or 32 for the 64- and 128-wide register tiles
template <int NP>
__host__ __device__ constexpr int rows_tile() {
  return NP <= 32 ? 64 : 32;
}
// floats of a ring slot: the E tile (gt x NP), the data tile (kRowsRows x
// (gt + 1)) and the column's E row (gt)
template <int NP>
__host__ __device__ constexpr int rows_slot() {
  return rows_tile<NP>() * NP + kRowsRows * (rows_tile<NP>() + 1)
         + rows_tile<NP>();
}
__host__ __device__ inline int rows_blocks(int K) {
  return (K + kRowsRows - 1) / kRowsRows;
}
__host__ __device__ inline int rows_parts(int K, int C) {
  int kc = 1;
  while (kc < 8 && (long long)C * rows_blocks(K) * kc < kRowsFill) kc *= 2;
  return kc;
}
// Shared memory of a row-form block, in bytes: as doubles the warps' sums
// (3 a thread) and, P column only, the cluster's sums of each pass (kc x 2
// x 32 in every block, kc x 3 x 32 in block 0); as floats the ring and, P
// column only, the 32 scaled proposals and the cluster's flags (kc)
template <int NP>
__host__ __device__ constexpr size_t pcol_rows_smem_bytes(int kc) {
  return ((size_t)3 * kRowsThreads + (size_t)kc * 5 * kRowsRows)
             * sizeof(double)
         + ((size_t)kRowsStages * rows_slot<NP>() + kRowsRows + kc)
               * sizeof(float);
}
template <int NP>
__host__ __device__ constexpr size_t acol_rows_smem_bytes() {
  return (size_t)kRowsThreads * sizeof(double)
         + (size_t)kRowsStages * rows_slot<NP>() * sizeof(float);
}

// A block's copies of G tile g0 .. g0 + gt into a ring slot, all
// unrolled, each thread's sources found from bases it computes once: the
// E tile (thread t copies n = t / gt + (threads / gt) j, g = t % gt,
// transposed into the slot), the data tile (warp w copies rows w + 8 q,
// its lanes consecutive g), the column's E row (t < gt). A copy past N, K
// or G fills zeros and reads nothing.
template <int NP>
struct RowsStage {
  static constexpr int gt = rows_tile<NP>();
  static constexpr int kEJ = NP * gt / kRowsThreads;  // E copies a thread
  static constexpr int kEStep = kRowsThreads / gt;    // n between them
  static constexpr int kDQ = kRowsRows / kRowsWarps;  // data rows a warp
  const float *e, *d, *en;
  unsigned e_in, d_in;  // bit j: its n < N; bit q: its row < K
  int G;

  __device__ RowsStage(const float* data, const float* e_c,
                       const float* en_c, int K, int N, int G_, int k0)
      : G(G_) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    e = e_c + (size_t)(tid / gt) * G + tid % gt;
    d = data + (size_t)(k0 + warp) * G + lane;
    en = en_c + tid;
    e_in = d_in = 0u;
#pragma unroll
    for (int j = 0; j < kEJ; ++j) {
      e_in |= (unsigned)(tid / gt + kEStep * j < N) << j;
    }
#pragma unroll
    for (int q = 0; q < kDQ; ++q) {
      d_in |= (unsigned)(k0 + warp + kRowsWarps * q < K) << q;
    }
  }

  __device__ __forceinline__ void operator()(float* slot, int g0) const {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    float* sE = slot + (tid % gt) * NP + tid / gt;
    float* sD = slot + gt * NP + warp * (gt + 1) + lane;
    const bool ge = g0 + tid % gt < G;
#pragma unroll
    for (int j = 0; j < kEJ; ++j) {
      cp_async4(sE + kEStep * j, e + (size_t)kEStep * j * G + g0,
                ge && (e_in >> j & 1u));
    }
#pragma unroll
    for (int h = 0; h < gt; h += 32) {
      const bool gin = g0 + h + lane < G;
#pragma unroll
      for (int q = 0; q < kDQ; ++q) {
        cp_async4(sD + kRowsWarps * q * (gt + 1) + h,
                  d + (size_t)kRowsWarps * q * G + g0 + h,
                  gin && (d_in >> q & 1u));
      }
    }
    if (tid < gt) {
      cp_async4(slot + gt * NP + kRowsRows * (gt + 1) + tid, en + g0,
                g0 + tid < G);
    }
  }
};

// What a row-form pass adds a term: the P column's stats (s0, s1) or accept
// (s0, s1, s2) terms, or the A column's (s0)
enum RowsTerms { kStatsTerms = 0, kAcceptTerms = 1, kAcolTerms = 2 };

// The terms of one ring slot: this warp's eighth of the tile, 4 g at a
// time, added in g order into s. kFull: every g of the tile is below G;
// else a g from gcount on is skipped (its zero entries would add zeros
// only while pk, qk and an are finite).
template <int NP, int TERMS, bool kFull>
__device__ __forceinline__ void rows_terms(const float* sE,
                                           const float (&pa)[NP], float pk,
                                           float qk, float an, int gcount,
                                           double* s, bool* nz) {
  constexpr int gt = rows_tile<NP>(), gw = gt / kRowsWarps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* dk = sE + gt * NP + lane * (gt + 1);
  const float* sEn = sE + gt * NP + kRowsRows * (gt + 1);
#pragma unroll
  for (int h = 0; h < gw; h += kUnroll) {
    float mh[kUnroll];
    const float* cols[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      cols[u] = sE + (warp * gw + h + u) * NP;
    }
    dot_ordered<NP>(pa, cols, mh);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int gl = warp * gw + h + u;
      if (!kFull && gl >= gcount) continue;
      const float e = sEn[gl];
      if constexpr (TERMS == kStatsTerms) {
        stats_terms(dk[gl], mh[u], pk * e, e, &s[0], &s[1]);
        *nz |= e * e != 0.0f;
      } else if constexpr (TERMS == kAcceptTerms) {
        accept_terms(dk[gl], mh[u], pk * e, qk * e, e, &s[0], &s[1], &s[2]);
      } else {
        acol_term(dk[gl], mh[u], pk * e, an, &s[0]);
      }
    }
  }
}

// One pass over G tiles t0 .. t1 of the ring: this lane's row (P*A in pa,
// pk = its own factor, qk the scaled proposal, an the A column's A_n), the
// terms added in g order into s; *nz gains whether some E-row entry of the
// stretch has a nonzero square.
template <int NP, int TERMS>
__device__ void rows_pass(const float* data, const float* e_c,
                          const float* en_c, float* ring, int K, int N,
                          int G, int k0, int t0, int t1,
                          const float (&pa)[NP], float pk, float qk,
                          float an, double* s, bool* nz) {
  constexpr int gt = rows_tile<NP>(), slot = rows_slot<NP>();
  const int count = t1 - t0;
  const RowsStage<NP> stage(data, e_c, en_c, K, N, G, k0);
  for (int j = 0; j < kRowsStages - 1; ++j) {
    if (j < count) stage(ring + j * slot, (t0 + j) * gt);
    cp_async_commit();
  }
  for (int j = 0; j < count; ++j) {
    const int jn = j + kRowsStages - 1;
    if (jn < count) stage(ring + (jn % kRowsStages) * slot, (t0 + jn) * gt);
    cp_async_commit();
    cp_async_wait<kRowsStages - 1>();  // tile j has landed
    __syncthreads();
    const float* sE = ring + (j % kRowsStages) * slot;
    const int gcount = G - (t0 + j) * gt;
    if (gcount >= gt) {
      rows_terms<NP, TERMS, true>(sE, pa, pk, qk, an, gcount, s, nz);
    } else {
      rows_terms<NP, TERMS, false>(sE, pa, pk, qk, an, gcount, s, nz);
    }
    __syncthreads();  // the slot is free for the tile after next
  }
}

// The two halves of cluster.sync(): arrive early, wait where the cluster
// must have started
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// G tiles of block part r of kc: an even split of the tiles, in order
__device__ __forceinline__ void rows_stretch(int G, int gt, int r, int kc,
                                             int* t0, int* t1) {
  const int tiles = (G + gt - 1) / gt;
  *t0 = tiles * r / kc;
  *t1 = tiles * (r + 1) / kc;
}

// The warps' sums of each lane's row in warp order, into warp 0's tot;
// returns whether any thread's nz is set (every thread must call it).
__device__ __forceinline__ int rows_meet(double* part, const double* s,
                                         int nv, bool nz, double* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = 0; j < nv; ++j) part[(j * kRowsWarps + warp) * 32 + lane] = s[j];
  const int any = __syncthreads_or(nz);
  if (warp == 0) {
    for (int j = 0; j < nv; ++j) {
      double t = part[j * kRowsWarps * 32 + lane];
      for (int w = 1; w < kRowsWarps; ++w) {
        t += part[(j * kRowsWarps + w) * 32 + lane];
      }
      tot[j] = t;
    }
  }
  return any;
}

// The cluster's sums of lane's row from xp ([kc][nv][32]), in block order
__device__ __forceinline__ double rows_total(const double* xp, int kc,
                                             int nv, int j) {
  const int lane = threadIdx.x & 31;
  double t = xp[j * 32 + lane];
  for (int r = 1; r < kc; ++r) t += xp[(r * nv + j) * 32 + lane];
  return t;
}

// The P column's row form: MODE kStats / kAccept write the sums (out), an
// update (kUpdate) takes the whole column. Three blocks an SM up to a
// 32-wide register tile (at most 85 registers a thread).
template <int NP, int MODE>
__global__ void __launch_bounds__(kRowsThreads, NP <= 32 ? 3 : 1)
pcol_rows_kernel(PcolArgs a) {
  extern __shared__ float4 smem4[];
  cgr::cluster_group cluster = cgr::this_cluster();
  const int kc = (int)cluster.num_blocks(), crank = (int)cluster.block_rank();
  const int K = a.K, N = a.N, G = a.G;
  double* part = reinterpret_cast<double*>(smem4);  // [3][warps][32]
  double* xp1 = part + 3 * kRowsThreads;            // [kc][2][32], each's
  double* xp2 = xp1 + kc * 2 * kRowsRows;           // [kc][3][32], block 0's
  float* ring = reinterpret_cast<float*>(xp2 + kc * 3 * kRowsRows);
  float* sQ = ring + kRowsStages * rows_slot<NP>();  // 32
  int* flags = reinterpret_cast<int*>(sQ + kRowsRows);  // [kc], each's
  const int c = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x / kc * kRowsRows, k = k0 + lane;
  const bool live = k < K;
  // every block of the cluster has started before one writes into another
  // (the wait comes before the first such write)
  cluster_arrive();
  int t0, t1;
  rows_stretch(G, rows_tile<NP>(), crank, kc, &t0, &t1);
  const float* e_c = a.E + (size_t)c * N * G;
  const float* en_c = MODE == kUpdate ? e_c + (size_t)a.n * G
                                      : a.en + (size_t)c * G;
  const size_t at = ((size_t)c * K + k) * N + a.n;  // update only
  const float a_n = MODE == kUpdate ? a.A[(size_t)c * N + a.n] : 0.0f;
  float pa[NP];
#pragma unroll
  for (int n = 0; n < NP; ++n) {
    pa[n] = live && n < N ? a.PA[((size_t)c * K + k) * N + n] : 0.0f;
  }
  const float pk = !live ? 0.0f
                   : MODE == kUpdate ? a_n * a.P[at]
                                     : a.pn[(size_t)c * K + k];
  const size_t CK = (size_t)a.C * K;
  const bool lead = crank == 0 && warp == 0;  // writes the column
  double s[3] = {0.0, 0.0, 0.0}, tot[3];
  Entry in;
  float mu = 0.0f, var = 0.0f, proposal = 0.0f;
  if (MODE != kAccept) {
    bool nz = false;
    rows_pass<NP, kStatsTerms>(a.data, e_c, en_c, ring, K, N, G, k0, t0, t1,
                               pa, pk, 0.0f, 0.0f, s, &nz);
    const int any = rows_meet(part, s, 2, nz, tot);
    cluster_wait();
    if (warp == 0) {
      // the block's sums to every block of the cluster (a kStats sum to
      // block 0 alone, which writes it)
      for (int r = 0; r < (MODE == kUpdate ? kc : 1); ++r) {
        double* x = cluster.map_shared_rank(xp1, r) + crank * 2 * kRowsRows;
        x[lane] = tot[0];
        x[kRowsRows + lane] = tot[1];
        if (lane == 0) *cluster.map_shared_rank(flags + crank, r) = any;
      }
    }
    cluster.sync();  // the cluster's first-pass sums and flags are here
    if (MODE == kStats) {
      if (lead && live) {
        a.out[(size_t)c * K + k] = (float)rows_total(xp1, kc, 2, 0);
        a.out[CK + (size_t)c * K + k] = (float)rows_total(xp1, kc, 2, 1);
      }
      return;
    }
    // every block of the cluster makes the same proposals for its rows
    if (warp == 0) {
      bool inactive = true;
      for (int r = 0; r < kc; ++r) inactive &= flags[r] == 0;
      float q = 0.0f;
      if (live) {
        const float* u = a.U + ((size_t)c * 3 * N + a.n) * K + k;
        in = {a.P[at], a.mu0[at], a.sq0[at], a.prior_draw[at], u[0],
              u[(size_t)N * K], u[(size_t)2 * N * K], a_n, inactive,
              a.accept_all[c] != 0.0f, a.expo != 0};
        propose(in, (float)rows_total(xp1, kc, 2, 0),
                (float)rows_total(xp1, kc, 2, 1), &mu, &var, &proposal);
        q = a_n * proposal;
      }
      sQ[lane] = q;
    }
  } else {
    cluster_wait();
    if (warp == 0) sQ[lane] = live ? a.prop[(size_t)c * K + k] : 0.0f;
  }
  __syncthreads();  // the scaled proposals
  s[0] = s[1] = s[2] = 0.0;
  bool unused = false;
  rows_pass<NP, kAcceptTerms>(a.data, e_c, en_c, ring, K, N, G, k0, t0, t1,
                              pa, pk, sQ[lane], 0.0f, s, &unused);
  rows_meet(part, s, 3, false, tot);
  if (warp == 0) {
    double* x = cluster.map_shared_rank(xp2, 0) + crank * 3 * kRowsRows;
    for (int j = 0; j < 3; ++j) x[j * kRowsRows + lane] = tot[j];
  }
  cluster.sync();  // the cluster's second-pass sums are in block 0
  if (!lead) return;
  const float lp = (float)rows_total(xp2, kc, 3, 0);
  const float mu1_r = (float)rows_total(xp2, kc, 3, 1);
  const float den_r = (float)rows_total(xp2, kc, 3, 2);
  if (MODE == kAccept) {
    if (live) {
      a.out[(size_t)c * K + k] = lp;
      a.out[CK + (size_t)c * K + k] = mu1_r;
      a.out[2 * CK + (size_t)c * K + k] = den_r;
    }
    return;
  }
  bool nan = false;
  if (live) {
    float rec;
    const float nv = decide(in, mu, var, proposal, lp, mu1_r, den_r,
                            a.acc[at], &rec, &nan);
    a.P[at] = nv;
    a.PA[at] = nv * a_n;
    a.acc[at] = rec;
  }
  const int n_nan = __popc(__ballot_sync(0xffffffffu, nan));
  if (lane == 0 && n_nan) atomicAdd(a.nan + c, n_nan);
}

// The A column's row form: each block's rows over its stretch of G, added
// in a fixed order (a row's warps in order, then the rows by a butterfly)
// into scratch[c][blockIdx.x], which acol_finish_kernel adds in order. No
// cluster: the blocks of a chain's rows and parts are the grid's x.
template <int NP, bool kUpdate>
__global__ void __launch_bounds__(kRowsThreads, NP <= 32 ? 3 : 1)
acol_rows_kernel(AcolArgs a, int kc) {
  extern __shared__ float4 smem4[];
  const int K = a.K, N = a.N, G = a.G;
  double* part = reinterpret_cast<double*>(smem4);  // [warps][32]
  float* ring = reinterpret_cast<float*>(part + kRowsThreads);
  const int c = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x / kc * kRowsRows, k = k0 + lane;
  const bool live = k < K;
  int t0, t1;
  rows_stretch(G, rows_tile<NP>(), blockIdx.x % kc, kc, &t0, &t1);
  const float* e_c = a.E + (size_t)c * N * G;
  const float* en_c = kUpdate ? e_c + (size_t)a.n * G : a.en + (size_t)c * G;
  const float* x_c = (kUpdate ? a.P : a.PA) + ((size_t)c * K + k) * N;
  // the P*A row: P * A as the plain version's P * A.unsqueeze(1)
  float pa[NP];
#pragma unroll
  for (int n = 0; n < NP; ++n) {
    pa[n] = live && n < N
                ? (kUpdate ? x_c[n] * a.A[(size_t)c * N + n] : x_c[n])
                : 0.0f;
  }
  const float pk = !live ? 0.0f
                   : kUpdate ? x_c[a.n] : a.pn[(size_t)c * K + k];
  const float an = kUpdate ? a.A[(size_t)c * N + a.n] : a.an[c];
  double s[3] = {0.0, 0.0, 0.0};
  bool unused = false;
  rows_pass<NP, kAcolTerms>(a.data, e_c, en_c, ring, K, N, G, k0, t0, t1, pa,
                            pk, 0.0f, an, s, &unused);
  double tot[1];
  rows_meet(part, s, 1, false, tot);
  if (warp == 0) {
    const double v = warp_allsum(tot[0]);
    if (lane == 0) a.scratch[(size_t)c * gridDim.x + blockIdx.x] = v;
  }
}

// ---- the metrics row: tiles of G, then one block per chain ------------------
// models/gibbs.py::METRIC_NAMES' row of every chain from the state: the four
// data sums of a streamed Mhat (sum M log lam, sum lam, sum max(M, 1e-6) log
// lam, sum (Mhat - M)^2, lam = max(Mhat, floor)), the truncated-normal prior
// log-density of E and P and the A-weighted acceptance sums, then
// loglik, KL, RMSE, logpost, n_params, BIC and the acceptance means. The
// tile kernel is the A column's (a thread owns a row k, its P*A row in
// registers, a group of rows every `groups`-th g of a G tile) with
// the four data sums; the block's threads then take the tile's (n, g)
// entries of E for the prior term and acc_E * A_n. Each tile writes one
// double per sum. The finishing kernel, one block per chain, adds the tiles
// in a fixed order, sums the P side over (K, N) and writes the row. The
// sums-only form (chain_metrics) runs the same tile on a P*A operand and
// writes the four data sums.
constexpr int kDataSums = 4;
constexpr int kRowSums = 6;       // the data sums, E's prior, sum acc_E * A
constexpr int kMetricsFinish = 1024;

struct MetricsArgs {
  const float* data;
  const float* E;
  // sums only: PA (C, K, N); out (4, C)
  const float* PA;
  float* out;
  // the row: P (C, K, N), A (C, N); E's prior pair and acceptance record
  // (C, N, G), P's (C, K, N); the chunk constants sum lgamma(M + 1) and
  // sum Mp log Mp (0-d); na (C,) the NaN events; temp (1,) the temperature,
  // or null and temp_val; it the iteration; log_g log(G) rounded to float;
  // row (C, row_stride), 12 floats a chain written; expo: the prior is the
  // exponential one, Lambda in mu_e and mu_p (sq_e and sq_p are not read)
  const float *P, *A, *mu_e, *sq_e, *acc_e, *mu_p, *sq_p, *acc_p;
  const float *lgamma_sum, *mlogm_sum, *na, *temp;
  float* row;
  float it, temp_val, log_g;
  int row_stride, expo;
  double* scratch;   // (C, sums, tiles) partials
  int C, K, N, G;
  int lg_gt;         // log2 of the tile's G width (col_tile)
};

// Shared memory of a metrics tile block of G width gt, in floats: the E
// tile transposed (gt x NP), the row partials as doubles (groups x K x 4),
// the data tile (K x (gt + 1)), A[c, :] (NP).
__host__ __device__ inline size_t metrics_smem_floats(int K, int NP, int gt) {
  const int groups = kColThreads / col_rows(K);
  return (size_t)gt * NP + 2 * (size_t)groups * K * kDataSums
         + (size_t)K * (gt + 1) + NP;
}

// log2 of the G width of the P-column, A-column and metrics tiles: 64, or
// 32 or 16 where the widest of the three blocks would not fit
// (ops/stream_sweeps.py::col_tile)
inline int col_tile_lg(int K, int NP) {
  for (int lg = 6; lg > 4; --lg) {
    const int gt = 1 << lg;
    size_t f = col_smem_floats(K, NP, gt);
    const size_t fa = acol_smem_floats(K, NP, gt);
    const size_t fm = metrics_smem_floats(K, NP, gt);
    f = f > fa ? f : fa;
    f = f > fm ? f : fm;
    if (f * sizeof(float) <= kSmemMax) return lg;
  }
  return 4;
}

__device__ __forceinline__ void data_terms(float m, float mh, double* s) {
  const float lam = jmax(mh, kFloor);
  const float L = logf(lam);
  const float d = mh - m;
  s[0] += (double)(m * L);
  s[1] += (double)lam;
  s[2] += (double)(jmax(m, 1e-6f) * L);
  s[3] += (double)(d * d);
}

// The prior term (tn_logpdf, or exp_logpdf with ``expo``, mu then holding
// Lambda) and acc * w of entries first, first + step, ... below count, added
// in that order into *lp and *ac; entry(j, &off, &w) gives entry j's offset
// in x, mu, sq and acc and its weight A_n. The loads of kPriorUnroll entries
// are issued before their terms, which then run as independent chains (a
// padded entry's term is computed and not added).
constexpr int kPriorUnroll = 4;

template <typename Entry>
__device__ __forceinline__ void prior_sums(const float* x, const float* mu,
                                           const float* sq, const float* acc,
                                           bool expo, Entry entry, int first,
                                           int step, int count, double* lp,
                                           double* ac) {
  for (int j0 = first; j0 < count; j0 += kPriorUnroll * step) {
    float xv[kPriorUnroll], mv[kPriorUnroll], sv[kPriorUnroll];
    float av[kPriorUnroll], wv[kPriorUnroll];
#pragma unroll
    for (int u = 0; u < kPriorUnroll; ++u) {
      const int j = j0 + u * step;
      size_t off = 0;
      float w = 0.0f;
      const bool live = j < count;
      if (live) entry(j, &off, &w);
      xv[u] = live ? x[off] : 0.0f;
      mv[u] = live ? mu[off] : 0.0f;
      sv[u] = live && !expo ? sq[off] : 1.0f;
      av[u] = live ? acc[off] : 0.0f;
      wv[u] = w;
    }
    float term[kPriorUnroll];
#pragma unroll
    for (int u = 0; u < kPriorUnroll; ++u) {
      term[u] = expo ? exp_logpdf(xv[u], mv[u])
                     : tn_logpdf(xv[u], mv[u], sv[u]);
    }
#pragma unroll
    for (int u = 0; u < kPriorUnroll; ++u) {
      if (j0 + u * step < count) {
        *lp += (double)term[u];
        *ac += (double)(av[u] * wv[u]);
      }
    }
  }
}

template <int NP, bool kRow, bool kWide>
__global__ void __launch_bounds__(kColThreads)
metrics_tile_kernel(MetricsArgs a) {
  extern __shared__ float4 smem4[];
  __shared__ double sred[2][kColThreads / 32];
  const int K = a.K, N = a.N, G = a.G;
  const int lg = kWide ? 6 : a.lg_gt;
  const int Gt = kWide ? kColTile : 1 << lg, ld = Gt + 1;
  constexpr int sums = kRow ? kRowSums : kDataSums;
  const int rows = col_rows(K), groups = kColThreads / rows;
  float* sE = reinterpret_cast<float*>(smem4);
  double* part = reinterpret_cast<double*>(sE + Gt * NP);
  float* sData = reinterpret_cast<float*>(part + (size_t)groups * K
                                                     * kDataSums);
  float* sA = sData + (size_t)K * ld;
  const int t = blockIdx.x, c = blockIdx.y, tid = threadIdx.x;
  const int grp = tid / rows, kk = tid % rows;
  const int lane = tid & 31, warp = tid >> 5;
  const int g0 = t * Gt;
  const int gcount = G - g0 < Gt ? G - g0 : Gt;

  const float* e_c = a.E + (size_t)c * N * G;
  const float* x_c = (kRow ? a.P : a.PA) + (size_t)c * K * N;
  for (int i = tid; i < Gt * NP; i += kColThreads) {
    const int n = kWide ? i / kColTile : i >> lg;
    const int gl = kWide ? i % kColTile : i & (Gt - 1), g = g0 + gl;
    sE[gl * NP + n] = (n < N && g < G) ? e_c[(size_t)n * G + g] : 0.0f;
  }
  for (int i = tid; i < K * Gt; i += kColThreads) {
    const int k = kWide ? i / kColTile : i >> lg;
    const int gl = kWide ? i % kColTile : i & (Gt - 1), g = g0 + gl;
    sData[k * ld + gl] = g < G ? a.data[(size_t)k * G + g] : 0.0f;
  }
  for (int n = tid; n < NP; n += kColThreads) {
    sA[n] = kRow && n < N ? a.A[(size_t)c * N + n] : 0.0f;
  }
  __syncthreads();

  if (grp < groups) {
    for (int k = kk; k < K; k += rows) {
      // the P*A row: P * A as the plain version's P * A.unsqueeze(1)
      float pa[NP];
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        pa[n] = n < N ? (kRow ? x_c[k * N + n] * sA[n] : x_c[k * N + n])
                      : 0.0f;
      }
      const float* dk = sData + k * ld;
      double s[kDataSums] = {0.0, 0.0, 0.0, 0.0};
      for (int gl0 = grp; gl0 < gcount; gl0 += kUnroll * groups) {
        float mh[kUnroll];
        const float* cols[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int gl = gl0 + u * groups;
          cols[u] = sE + (gl < gcount ? gl : gl0) * NP;
        }
        dot_ordered<NP>(pa, cols, mh);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int gl = gl0 + u * groups;
          if (gl < gcount) data_terms(dk[gl], mh[u], s);
        }
      }
      double* p = part + ((size_t)grp * K + k) * kDataSums;
#pragma unroll
      for (int j = 0; j < kDataSums; ++j) p[j] = s[j];
    }
  }
  if (kRow) {
    // the tile's entries of E, thread tid taking tid, tid + kColThreads, ...
    // in order: the prior term (ops/math.py::truncnorm_logpdf, or
    // exponential_logpdf) and acc_E * A
    double lp = 0.0, ac = 0.0;
    const size_t tile_at = (size_t)c * N * G + g0;
    prior_sums(a.E, a.mu_e, a.sq_e, a.acc_e, a.expo != 0,
               [&](int j, size_t* off, float* w) {
                 const int n = j / gcount;
                 *off = tile_at + (size_t)n * G + j % gcount;
                 *w = sA[n];
               },
               tid, kColThreads, N * gcount, &lp, &ac);
    lp = warp_allsum(lp);
    ac = warp_allsum(ac);
    if (lane == 0) {
      sred[0][warp] = lp;
      sred[1][warp] = ac;
    }
  }
  __syncthreads();
  // the tile's partials: warp j < 4 adds the rows' partials of data sum j,
  // lane-strided in order, then a butterfly; warps 4 and 5 the E side's
  // warp partials
  const int T = gridDim.x;
  double* sc = a.scratch + (size_t)c * sums * T + t;
  if (warp < kDataSums) {
    const int total = groups * K;
    double v = 0.0;
    for (int i = lane; i < total; i += 32) v += part[(size_t)i * kDataSums
                                                     + warp];
    v = warp_allsum(v);
    if (lane == 0) sc[(size_t)warp * T] = v;
  } else if (kRow && warp < kRowSums) {
    double v = lane < kColThreads / 32 ? sred[warp - kDataSums][lane] : 0.0;
    v = warp_allsum(v);
    if (lane == 0) sc[(size_t)warp * T] = v;
  }
}

// One block per chain: each sum's tiles added in a fixed order (a warp per
// sum), then the four sums (sums only), or the P side and the row.
template <bool kRow>
__global__ void __launch_bounds__(kMetricsFinish)
metrics_finish_kernel(MetricsArgs a, int tiles) {
  __shared__ double tot[kRowSums];
  __shared__ double sred[2][kMetricsFinish / 32];
  constexpr int sums = kRow ? kRowSums : kDataSums;
  const int c = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (warp < sums) {
    const double v = warp_ordered_sum(
        a.scratch + ((size_t)c * sums + warp) * tiles, tiles, lane);
    if (lane == 0) tot[warp] = v;
  }
  if (!kRow) {
    __syncthreads();
    if (tid < kDataSums) a.out[(size_t)tid * a.C + c] = (float)tot[tid];
    return;
  }
  // the P side over (K, N): the prior term and acc_P * A, each thread its
  // entries in order, then the warps' partials in order
  const int K = a.K, N = a.N, G = a.G;
  const float* A_c = a.A + (size_t)c * N;
  const size_t base = (size_t)c * K * N;
  double lp = 0.0, ac = 0.0;
  prior_sums(a.P, a.mu_p, a.sq_p, a.acc_p, a.expo != 0,
             [&](int j, size_t* off, float* w) {
               *off = base + j;
               *w = A_c[j % N];
             },
             tid, kMetricsFinish, K * N, &lp, &ac);
  lp = warp_allsum(lp);
  ac = warp_allsum(ac);
  if (lane == 0) {
    sred[0][warp] = lp;
    sred[1][warp] = ac;
  }
  __syncthreads();
  if (tid != 0) return;
  double lp_p = 0.0, ac_p = 0.0;
  for (int w = 0; w < kMetricsFinish / 32; ++w) {
    lp_p += sred[0][w];
    ac_p += sred[1][w];
  }
  float sum_a = 0.0f;
  for (int n = 0; n < N; ++n) sum_a = sum_a + A_c[n];
  // the row, each operation rounded as the plain version's
  const float m_loglam = (float)tot[0], lam_sum = (float)tot[1];
  const float mp_loglam = (float)tot[2], sq_err = (float)tot[3];
  const float loglik = (m_loglam - lam_sum) - a.lgamma_sum[0];
  const float n_par = sum_a * (float)(G + K);
  float* row = a.row + (size_t)c * a.row_stride;
  row[0] = a.it;
  row[1] = sqrtf(sq_err / (float)(K * G));
  row[2] = a.mlogm_sum[0] - mp_loglam;
  row[3] = loglik;
  row[4] = loglik + ((float)lp_p + (float)tot[4]);
  row[5] = n_par;
  row[6] = -2.0f * loglik + n_par * a.log_g;
  row[7] = sum_a;
  row[8] = a.temp != nullptr ? a.temp[0] : a.temp_val;
  row[9] = (float)ac_p / jmax(sum_a * (float)K, 1.0f);
  row[10] = (float)tot[5] / jmax(sum_a * (float)G, 1.0f);
  row[11] = a.na[c];
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

int n_tiles(int G, int Gt) { return (G + Gt - 1) / Gt; }

// ---- launching ---------------------------------------------------------------

// The widths the register tile is built for: N rounded up to a multiple of
// 4 up to 24, then 32, 64 and 128 (ops.MAX_N).
constexpr int kMaxN = 128;

// The tile kernels come in a kColTile-wide form (the width a compile-time
// constant, as every benchmark cell and earlier shape runs them) and a
// runtime-width form (col_tile). NP >= 64 is built in the runtime form
// only: those kernels take most of the library's build time.
template <int NP>
constexpr bool kWideBuilt = NP <= 32;

// The whole form below kSplitMinK rows, the split form from it on
template <int NP, int MODE>
cudaError_t launch_erow(const ErowArgs& a, cudaStream_t s) {
  cudaError_t e;
  if (a.K >= kSplitMinK) {
    const size_t smem = split_smem_bytes(a.K, NP);
    if ((e = allow_smem(erow_split_kernel<NP, MODE>, smem)) != cudaSuccess) {
      return e;
    }
    const int kc = split_blocks(a.K);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_tiles(a.G, 32) * kc, a.C);
    cfg.blockDim = dim3(kSplitThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kc;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, erow_split_kernel<NP, MODE>, a);
  }
  const size_t smem = ((size_t)pad_rows(a.K) * NP + a.K) * sizeof(float);
  if ((e = allow_smem(erow_kernel<NP, MODE>, smem)) != cudaSuccess) return e;
  const dim3 grid(n_tiles(a.G, kRowThreads), a.C);
  erow_kernel<NP, MODE><<<grid, kRowThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// One pass over the tiles and its finishing kernel.
template <int NP, int MODE, bool kSecond>
cudaError_t launch_pcol_pass(PcolArgs a, cudaStream_t s) {
  a.lg_gt = col_tile_lg(a.K, NP);
  const size_t smem = col_smem_floats(a.K, NP, 1 << a.lg_gt) * sizeof(float);
  void (*kernel)(PcolArgs) = pcol_tile_kernel<NP, MODE, kSecond, false>;
  if constexpr (kWideBuilt<NP>) {
    if (a.lg_gt == 6) kernel = pcol_tile_kernel<NP, MODE, kSecond, true>;
  }
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const int tiles = n_tiles(a.G, 1 << a.lg_gt);
  kernel<<<dim3(tiles, a.C), kColThreads, smem, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  constexpr int FINISH = MODE != kUpdate ? kWriteSums
                         : kSecond       ? kDecide
                                         : kPropose;
  const size_t fsmem = (size_t)a.K * 3 * sizeof(double);
  if ((e = allow_smem(pcol_finish_kernel<FINISH>, fsmem)) != cudaSuccess) {
    return e;
  }
  pcol_finish_kernel<FINISH><<<a.C, kFinishThreads, fsmem, s>>>(
      a, tiles, kSecond ? 3 : 2);
  return cudaGetLastError();
}

template <int NP, int MODE>
cudaError_t launch_pcol(const PcolArgs& a, cudaStream_t s) {
  if (MODE == kStats) return launch_pcol_pass<NP, kStats, false>(a, s);
  if (MODE == kAccept) return launch_pcol_pass<NP, kAccept, true>(a, s);
  const cudaError_t e = launch_pcol_pass<NP, kUpdate, false>(a, s);
  if (e != cudaSuccess) return e;
  return launch_pcol_pass<NP, kUpdate, true>(a, s);
}

// One A column: the tile kernel, then the finishing kernel.
template <int NP, bool kUpdate>
cudaError_t launch_acol(AcolArgs a, cudaStream_t s) {
  a.lg_gt = col_tile_lg(a.K, NP);
  const size_t smem = acol_smem_floats(a.K, NP, 1 << a.lg_gt) * sizeof(float);
  void (*kernel)(AcolArgs) = acol_tile_kernel<NP, kUpdate, false>;
  if constexpr (kWideBuilt<NP>) {
    if (a.lg_gt == 6) kernel = acol_tile_kernel<NP, kUpdate, true>;
  }
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const int tiles = n_tiles(a.G, 1 << a.lg_gt);
  kernel<<<dim3(tiles, a.C), kColThreads, smem, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  acol_finish_kernel<kUpdate><<<a.C, 32, 0, s>>>(a, tiles);
  return cudaGetLastError();
}

// The metrics tile kernel, then the finishing kernel.
template <int NP, bool kRow>
cudaError_t launch_metrics(MetricsArgs a, cudaStream_t s) {
  a.lg_gt = col_tile_lg(a.K, NP);
  const size_t smem =
      metrics_smem_floats(a.K, NP, 1 << a.lg_gt) * sizeof(float);
  void (*kernel)(MetricsArgs) = metrics_tile_kernel<NP, kRow, false>;
  if constexpr (kWideBuilt<NP>) {
    if (a.lg_gt == 6) kernel = metrics_tile_kernel<NP, kRow, true>;
  }
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const int tiles = n_tiles(a.G, 1 << a.lg_gt);
  kernel<<<dim3(tiles, a.C), kColThreads, smem, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  metrics_finish_kernel<kRow><<<a.C, kMetricsFinish, 0, s>>>(a, tiles);
  return cudaGetLastError();
}

// The row form (K >= 192, ops/stream_sweeps.py::col_rows_form): a P column
// or a sums pass one launch on a grid of (rows_blocks * kc, C) blocks in
// clusters of kc along G.
template <int NP, int MODE>
cudaError_t launch_pcol_rows(const PcolArgs& a, cudaStream_t s) {
  const int kc = rows_parts(a.K, a.C);
  const size_t smem = pcol_rows_smem_bytes<NP>(kc);
  cudaError_t e = allow_smem(pcol_rows_kernel<NP, MODE>, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows_blocks(a.K) * kc, a.C);
  cfg.blockDim = dim3(kRowsThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, pcol_rows_kernel<NP, MODE>, a);
}

template <int NP, int MODE>
cudaError_t launch_pcol_rows_columns(PcolArgs a, int n0, int n1,
                                     cudaStream_t s) {
  for (int n = n0; n < n1; ++n) {
    a.n = n;
    const cudaError_t e = launch_pcol_rows<NP, MODE>(a, s);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// An A column in the row form: the row blocks' partials, then the finishing
// warp of each chain.
template <int NP, bool kUpdate>
cudaError_t launch_acol_rows(const AcolArgs& a, int n0, int n1,
                             cudaStream_t s) {
  const int kc = rows_parts(a.K, a.C), blocks = rows_blocks(a.K) * kc;
  const size_t smem = acol_rows_smem_bytes<NP>();
  void (*kernel)(AcolArgs, int) = acol_rows_kernel<NP, kUpdate>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  AcolArgs b = a;
  for (int n = n0; n < n1; ++n) {
    b.n = n;
    kernel<<<dim3(blocks, a.C), kRowsThreads, smem, s>>>(b, kc);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    acol_finish_kernel<kUpdate><<<a.C, 32, 0, s>>>(b, blocks);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// Pick the register tile's width for N and call launch_<which><NP, MODE>.
#define DISPATCH_NP(N, CALL)                                              \
  ((N) <= 4 ? CALL(4) : (N) <= 8 ? CALL(8) : (N) <= 12 ? CALL(12)         \
   : (N) <= 16 ? CALL(16) : (N) <= 20 ? CALL(20) : (N) <= 24 ? CALL(24)   \
   : (N) <= 32 ? CALL(32) : (N) <= 64 ? CALL(64)                          \
   : (N) <= kMaxN ? CALL(128) : cudaErrorInvalidValue)

__global__ void special_kernel(const float* __restrict__ x,
                               float* __restrict__ out, int n, int which) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = x[i];
  out[i] = which == 0 ? at_ndtri(v) : which == 1 ? at_log_ndtr(v)
           : which == 2 ? port_ndtr(v) : at_sigmoid(v);
}

}  // namespace
// The entry points come in seven translation units, so that nvcc builds
// them in parallel (ops/_build.py: one nvcc a source): the P-column and
// A-column updates below 192 rows here, their sums-only forms, the
// special functions and the exact hyper-update in stream_sums.cu, which
// includes this file with STREAM_SUMS_ONLY defined, the E row's updates in
// stream_erow.cu
// (STREAM_EROW_ONLY) and its sums in stream_erow_sums.cu
// (STREAM_EROW_SUMS_ONLY), the metrics row's in stream_metrics.cu
// (STREAM_METRICS_ONLY), and the P and A columns' row form in
// stream_rows.cu (updates, STREAM_ROWS_ONLY) and stream_rows_sums.cu (sums
// only, STREAM_ROWS_SUMS_ONLY).
#if defined(STREAM_ROWS_ONLY)

// The row form's column updates (stream_rows.cu).
// Columns n0 .. n1-1 of P, one launch each, enqueued in order: P, PA (=
// P*A on entry), the acceptance record and the NaN-clamp counts are
// updated in place.
extern "C" int stream_pcol_rows_update_launch(
    const float* data, const float* E, float* P, float* PA, const float* A,
    float* acc, const float* mu0, const float* sq0, const float* prior_draw,
    const float* U, const float* accept_all, int* nan, int C, int K, int N,
    int G, int n0, int n1, int expo, void* stream) {
  PcolArgs a = {};
  a.expo = expo;
  a.data = data; a.E = E; a.PA = PA; a.P = P; a.A = A; a.acc = acc;
  a.mu0 = mu0; a.sq0 = sq0; a.prior_draw = prior_draw; a.U = U;
  a.accept_all = accept_all; a.nan = nan;
  a.C = C; a.K = K; a.N = N; a.G = G;
  const cudaStream_t s = (cudaStream_t)stream;
#define CALL_UPDATE(NP) launch_pcol_rows_columns<NP, kUpdate>(a, n0, n1, s)
  const cudaError_t e = DISPATCH_NP(N, CALL_UPDATE);
#undef CALL_UPDATE
  return (int)e;
}

// Columns n0 .. n1-1 of A, enqueued in order, as
// stream_acol_update_launch; scratch C * rows_blocks(K) * rows_parts(K, C)
// doubles.
extern "C" int stream_acol_rows_update_launch(
    const float* data, const float* E, const float* P, float* A,
    const float* logit, const float* temp, const float* u, float* n_nan,
    float* delta, float penalty, int sbfi, double* scratch, int C, int K,
    int N, int G, int n0, int n1, void* stream) {
  AcolArgs a = {};
  a.data = data; a.E = E; a.P = P; a.A = A; a.logit = logit; a.temp = temp;
  a.u = u; a.n_nan = n_nan; a.delta = delta;
  a.penalty = penalty; a.sbfi = sbfi; a.scratch = scratch;
  a.C = C; a.K = K; a.N = N; a.G = G;
  const cudaStream_t s = (cudaStream_t)stream;
#define CALL_UPDATE(NP) launch_acol_rows<NP, true>(a, n0, n1, s)
  const cudaError_t e = DISPATCH_NP(N, CALL_UPDATE);
#undef CALL_UPDATE
  return (int)e;
}

#elif defined(STREAM_ROWS_SUMS_ONLY)

// The row form's sums-only entry points (stream_rows_sums.cu): prop ==
// nullptr gives the stats (2 outputs), else the accept sums (3); out
// (n_out, C, K).
extern "C" int stream_pcol_rows_launch(const float* data, const float* E,
                                       const float* PA, const float* en,
                                       const float* pn, const float* prop,
                                       float* out, int C, int K, int N,
                                       int G, void* stream) {
  PcolArgs a = {};
  a.data = data; a.E = E; a.PA = const_cast<float*>(PA);
  a.en = en; a.pn = pn; a.prop = prop; a.out = out;
  a.C = C; a.K = K; a.N = N; a.G = G;
  const cudaStream_t s = (cudaStream_t)stream;
#define CALL_STATS(NP) launch_pcol_rows<NP, kStats>(a, s)
#define CALL_ACCEPT(NP) launch_pcol_rows<NP, kAccept>(a, s)
  return (int)(prop == nullptr ? DISPATCH_NP(N, CALL_STATS)
                               : DISPATCH_NP(N, CALL_ACCEPT));
#undef CALL_STATS
#undef CALL_ACCEPT
}

// The A column's delta, sums only: scratch C * rows_blocks(K) *
// rows_parts(K, C) doubles; out C floats.
extern "C" int stream_acol_rows_launch(const float* data, const float* E,
                                       const float* PA, const float* en,
                                       const float* pn, const float* an,
                                       double* scratch, float* out, int C,
                                       int K, int N, int G, void* stream) {
  AcolArgs a = {};
  a.data = data; a.E = E; a.PA = PA; a.en = en; a.pn = pn; a.an = an;
  a.out = out; a.scratch = scratch;
  a.C = C; a.K = K; a.N = N; a.G = G;
  const cudaStream_t s = (cudaStream_t)stream;
#define CALL_SUMS(NP) launch_acol_rows<NP, false>(a, 0, 1, s)
  const cudaError_t e = DISPATCH_NP(N, CALL_SUMS);
#undef CALL_SUMS
  return (int)e;
}

#elif defined(STREAM_EROW_ONLY)

// The E row's updates (stream_erow.cu).
// Rows n0 .. n1-1 of E, one launch each, enqueued in order: E, the
// acceptance record and the NaN-clamp counts are updated in place.
extern "C" int stream_erow_update_launch(
    const float* data, float* E, const float* P, const float* PA,
    const float* A, float* acc, const float* mu0, const float* sq0,
    const float* prior_draw, const float* U, const float* accept_all,
    int* nan, int C, int K, int N, int G, int n0, int n1, int expo,
    void* stream) {
  ErowArgs a = {};
  a.expo = expo;
  a.data = data; a.E = E; a.PA = PA; a.P = P; a.A = A; a.acc = acc;
  a.mu0 = mu0; a.sq0 = sq0; a.prior_draw = prior_draw; a.U = U;
  a.accept_all = accept_all; a.nan = nan;
  a.C = C; a.K = K; a.N = N; a.G = G;
  const cudaStream_t s = (cudaStream_t)stream;
#define CALL_UPDATE(NP) launch_erow<NP, kUpdate>(a, s)
  for (int n = n0; n < n1; ++n) {
    a.n = n;
    const cudaError_t e = DISPATCH_NP(N, CALL_UPDATE);
    if (e != cudaSuccess) return (int)e;
  }
#undef CALL_UPDATE
  return 0;
}

#elif defined(STREAM_EROW_SUMS_ONLY)

// The E row's sums-only entry point (stream_erow_sums.cu): prop == nullptr
// gives the stats (2 outputs), else the accept sums (3); out (n_out, C, G).
extern "C" int stream_erow_launch(const float* data, const float* E,
                                  const float* PA, const float* en,
                                  const float* pn, const float* prop,
                                  float* out, int C, int K, int N, int G,
                                  void* stream) {
  ErowArgs a = {};
  a.data = data; a.E = const_cast<float*>(E); a.PA = PA;
  a.en = en; a.pn = pn; a.prop = prop; a.out = out;
  a.C = C; a.K = K; a.N = N; a.G = G;
  const cudaStream_t s = (cudaStream_t)stream;
#define CALL_STATS(NP) launch_erow<NP, kStats>(a, s)
#define CALL_ACCEPT(NP) launch_erow<NP, kAccept>(a, s)
  return (int)(prop == nullptr ? DISPATCH_NP(N, CALL_STATS)
                               : DISPATCH_NP(N, CALL_ACCEPT));
#undef CALL_STATS
#undef CALL_ACCEPT
}

#elif defined(STREAM_METRICS_ONLY)

// The metrics row's entry points (stream_metrics.cu).
// The four sums of the metrics row, sums only: scratch C * 4 *
// n_tiles(G, col_tile) doubles; out (4, C) floats.
extern "C" int stream_metrics_launch(const float* data, const float* E,
                                     const float* PA, double* scratch,
                                     float* out, int C, int K, int N, int G,
                                     void* stream) {
  MetricsArgs a = {};
  a.data = data; a.E = E; a.PA = PA; a.out = out; a.scratch = scratch;
  a.C = C; a.K = K; a.N = N; a.G = G;
  const cudaStream_t s = (cudaStream_t)stream;
#define CALL_SUMS(NP) launch_metrics<NP, false>(a, s)
  const cudaError_t e = DISPATCH_NP(N, CALL_SUMS);
#undef CALL_SUMS
  return (int)e;
}

// The metrics row of every chain, written to row + c * row_stride (12
// floats): scratch C * 6 * n_tiles(G, col_tile) doubles; temp null for a
// temperature passed as temp_val.
extern "C" int stream_metrics_row_launch(
    const float* data, const float* E, const float* P, const float* A,
    const float* mu_e, const float* sq_e, const float* acc_e,
    const float* mu_p, const float* sq_p, const float* acc_p,
    const float* lgamma_sum, const float* mlogm_sum, const float* na,
    const float* temp, float* row, double* scratch, float it,
    float temp_val, float log_g, int row_stride, int C, int K, int N, int G,
    int expo, void* stream) {
  MetricsArgs a = {};
  a.expo = expo;
  a.data = data; a.E = E; a.P = P; a.A = A;
  a.mu_e = mu_e; a.sq_e = sq_e; a.acc_e = acc_e;
  a.mu_p = mu_p; a.sq_p = sq_p; a.acc_p = acc_p;
  a.lgamma_sum = lgamma_sum; a.mlogm_sum = mlogm_sum; a.na = na;
  a.temp = temp; a.row = row; a.scratch = scratch;
  a.it = it; a.temp_val = temp_val; a.log_g = log_g;
  a.row_stride = row_stride;
  a.C = C; a.K = K; a.N = N; a.G = G;
  const cudaStream_t s = (cudaStream_t)stream;
#define CALL_ROW(NP) launch_metrics<NP, true>(a, s)
  const cudaError_t e = DISPATCH_NP(N, CALL_ROW);
#undef CALL_ROW
  return (int)e;
}

#elif defined(STREAM_SUMS_ONLY)

namespace {

// ---- the exact truncated-normal hyper-update --------------------------------
//
// (a) Replaces no TPU kernel: the JAX package leaves its exact Mu/Sigmasq
//     update (bayesnmf_tpu/models/updates.py::sample_prior_params,
//     :119-173) to XLA. In the port it ran as ~80 PyTorch ops on the
//     (C, K, N) and (C, N, G) planes (ops/stream_sweeps.py::
//     hyper_update_reference, models/updates.py before), whose eight 0-d
//     hyperparameter tensors each made the host wait for the card.
// (b) What bounds it: bytes. Per entry it reads x (P or E), Mu, Sigmasq,
//     two normals and two uniforms and writes Mu and Sigmasq (36 bytes)
//     against ~60 operations with three log_ndtr, a powf and four logs: at
//     (96,20,10000,8) 58 MB, ~17 us at 3.35 TB/s.
// (c) One launch for every chain and both sides, a block row per chain
//     (grid (tiles, C)): a thread takes kHyperVec neighbouring entries of
//     one side, loaded and stored 16 bytes at a time where K*N and N*G are
//     multiples of 4 and the planes are 16-byte aligned (the noise rows
//     too where their strides allow it), else one entry. The eight
//     hyperparameters are launch arguments, so the update copies nothing
//     to the card and reads nothing back.
//
// Numerics: every operation in the order and rounding of the PyTorch ops
// on the card, so that the kernel equals them bit for bit: `1.0 / t` is
// torch's reciprocal (1/t), a Python number times a tensor one multiply,
// `t ** 2` and `t ** 3` products, `t ** (1/3)` powf at the exponent rounded
// to float, clamp_min keeps a NaN, log_ndtr is at_log_ndtr.

constexpr int kHyperThreads = 256;
constexpr int kHyperVec = 4;
constexpr float kHyperFloor = 1e-30f;
// the exponent 1.0 / 3.0 as torch.pow rounds a Python number to float
constexpr float kThird = (float)(1.0 / 3.0);

struct HyperArgs {
  // index 0 the P side (C, K, N), 1 the E side (C, N, G)
  const float* x[2];
  const float* mu[2];
  const float* sq[2];
  float* mu_out[2];
  float* sq_out[2];
  // (C, stride) rows of 2 (K*N + N*G): [Mu_p | Mu_e | Sigmasq_p |
  // Sigmasq_e], the normals z and the uniforms u
  const float* z;
  const float* u;
  long long z_stride, u_stride;
  float m[2], s[2], a[2], b[2];
  int n[2];  // K*N, N*G
};

// torch.clamp_min(v, 1e-30) on the card: NaN stays NaN
__device__ __forceinline__ float clamp_floor(float v) {
  return isnan(v) ? v : fmaxf(v, kHyperFloor);
}

// logw of models/updates.py's _sq_step (ops/stream_sweeps.py): the
// Metropolis weight of g = b / sigma^2 under the Wilson-Hilferty proposal
__device__ __forceinline__ float hyper_logw(float a, float mu, float g,
                                           float t, float zz, float sq) {
  float w = (a - 1.0f) * logf(g);
  w = w - g;
  w = w + (zz * 0.5f) * zz;
  w = w + logf(clamp_floor(t)) * 2.0f;
  return w - at_log_ndtr(mu / sqrtf(sq));
}

// One entry: _mu_step, then _sq_step at the new Mu
// (ops/stream_sweeps.py).
__device__ __forceinline__ void hyper_entry(float x, float mu_old,
                                            float sq_old, float z, float zg,
                                            float u1, float u2, float m0,
                                            float s0, float a0, float b0,
                                            float& mu_new, float& sq_new) {
  const float den = 1.0f / s0 + 1.0f / sq_old;
  const float prop = (m0 / s0 + x / sq_old) / den + sqrtf(1.0f / den) * z;
  const float sd = sqrtf(sq_old);
  const float la_mu = at_log_ndtr(mu_old / sd) - at_log_ndtr(prop / sd);
  const float mu = logf(u1) < la_mu ? prop : mu_old;

  const float a = a0 + 0.5f;
  const float d = x - mu;
  const float b = b0 + (d * d) * 0.5f;
  const float c = 1.0f - 1.0f / (a * 9.0f);
  const float sqa3 = sqrtf(a) * 3.0f;
  const float t_new = c + zg / sqa3;
  const float g_new = a * (t_new * t_new * t_new);
  const float g_new_s = clamp_floor(g_new);
  const float sq_prop = b / g_new_s;
  const float g_old = b / clamp_floor(sq_old);
  const float t_old = powf(g_old / a, kThird);
  const float z_old = sqa3 * (t_old - c);
  const float la_sq =
      g_new > kHyperFloor
          ? hyper_logw(a, mu, g_new_s, t_new, zg, sq_prop) -
                hyper_logw(a, mu, g_old, t_old, z_old, sq_old)
          : -INFINITY;
  mu_new = mu;
  sq_new = logf(u2) < la_sq ? sq_prop : sq_old;
}

template <int V, bool kVec>
__device__ __forceinline__ void load_run(const float* p, float (&r)[V]) {
  if constexpr (V == 4 && kVec) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    r[0] = q.x; r[1] = q.y; r[2] = q.z; r[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) r[i] = __ldg(p + i);
  }
}

template <int V>
__device__ __forceinline__ void store_run(float* p, const float (&r)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = r[i];
  }
}

// V entries a thread (V = 4: 16-byte plane loads and stores, and noise
// loads with kVecNoise); blockIdx.y the chain.
template <int V, bool kVecNoise>
__global__ void __launch_bounds__(kHyperThreads)
    hyper_kernel(HyperArgs a) {
  const long long c = blockIdx.y;
  const long long j0 =
      ((long long)blockIdx.x * kHyperThreads + threadIdx.x) * V;
  const int side = j0 < a.n[0] ? 0 : 1;
  const long long j = side == 0 ? j0 : j0 - a.n[0];
  if (j >= a.n[side]) return;
  // the entry's place in its plane and in the noise row's two halves
  const long long at = c * a.n[side] + j;
  const long long first = side == 0 ? j : a.n[0] + j;
  const long long second = (long long)a.n[0] + a.n[1] + first;
  const float* z = a.z + c * a.z_stride;
  const float* u = a.u + c * a.u_stride;
  float x[V], mu[V], sq[V], zm[V], zs[V], u1[V], u2[V];
  load_run<V, true>(a.x[side] + at, x);
  load_run<V, true>(a.mu[side] + at, mu);
  load_run<V, true>(a.sq[side] + at, sq);
  load_run<V, kVecNoise>(z + first, zm);
  load_run<V, kVecNoise>(z + second, zs);
  load_run<V, kVecNoise>(u + first, u1);
  load_run<V, kVecNoise>(u + second, u2);
  float mu_new[V], sq_new[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    hyper_entry(x[i], mu[i], sq[i], zm[i], zs[i], u1[i], u2[i], a.m[side],
                a.s[side], a.a[side], a.b[side], mu_new[i], sq_new[i]);
  }
  store_run<V>(a.mu_out[side] + at, mu_new);
  store_run<V>(a.sq_out[side] + at, sq_new);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

}  // namespace

// The exact hyper-update of C chains (ops/stream_sweeps.py::hyper_update):
// P (C, K, N), E (C, N, G) and their prior pairs in; the new pairs to the
// four outputs; z and u rows of 2 (K*N + N*G) floats every z_stride and
// u_stride floats; n_p = K*N, n_e = N*G.
extern "C" int stream_hyper_launch(
    const float* P, const float* E, const float* mu_p, const float* sq_p,
    const float* mu_e, const float* sq_e, const float* z, const float* u,
    float* mu_p_out, float* sq_p_out, float* mu_e_out, float* sq_e_out,
    float m_p, float s_p, float a_p, float b_p, float m_e, float s_e,
    float a_e, float b_e, int z_stride, int u_stride, int C, int n_p,
    int n_e, void* stream) {
  if (C < 1 || C > 65535 || n_p < 1 || n_e < 1) return cudaErrorInvalidValue;
  HyperArgs a = {};
  a.x[0] = P; a.x[1] = E;
  a.mu[0] = mu_p; a.mu[1] = mu_e;
  a.sq[0] = sq_p; a.sq[1] = sq_e;
  a.mu_out[0] = mu_p_out; a.mu_out[1] = mu_e_out;
  a.sq_out[0] = sq_p_out; a.sq_out[1] = sq_e_out;
  a.z = z; a.u = u;
  a.z_stride = z_stride; a.u_stride = u_stride;
  a.m[0] = m_p; a.s[0] = s_p; a.a[0] = a_p; a.b[0] = b_p;
  a.m[1] = m_e; a.s[1] = s_e; a.a[1] = a_e; a.b[1] = b_e;
  a.n[0] = n_p; a.n[1] = n_e;
  const void* planes[] = {P, E, mu_p, sq_p, mu_e, sq_e,
                          mu_p_out, sq_p_out, mu_e_out, sq_e_out};
  bool vec = n_p % kHyperVec == 0 && n_e % kHyperVec == 0;
  for (const void* p : planes) vec = vec && aligned16(p);
  const bool vec_noise = vec && z_stride % kHyperVec == 0 &&
                         u_stride % kHyperVec == 0 && aligned16(z) &&
                         aligned16(u);
  const long long row = (long long)n_p + n_e;
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    const dim3 grid(
        (unsigned)((row / kHyperVec + kHyperThreads - 1) / kHyperThreads), C);
    if (vec_noise) {
      hyper_kernel<kHyperVec, true><<<grid, kHyperThreads, 0, s>>>(a);
    } else {
      hyper_kernel<kHyperVec, false><<<grid, kHyperThreads, 0, s>>>(a);
    }
  } else {
    const dim3 grid((unsigned)((row + kHyperThreads - 1) / kHyperThreads), C);
    hyper_kernel<1, false><<<grid, kHyperThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// The P column's sums-only bodies. prop == nullptr: stats (2 outputs);
// else accept (3). out (n_out, C, K), scratch C * n_tiles(G, col_tile) * K
// * 3 doubles.
extern "C" int stream_pcol_launch(const float* data, const float* E,
                                  const float* PA, const float* en,
                                  const float* pn, const float* prop,
                                  double* scratch, float* out, int C, int K,
                                  int N, int G, void* stream) {
  PcolArgs a = {};
  a.data = data; a.E = E; a.PA = const_cast<float*>(PA);
  a.en = en; a.pn = pn; a.prop = prop; a.scratch = scratch; a.out = out;
  a.C = C; a.K = K; a.N = N; a.G = G;
  const cudaStream_t s = (cudaStream_t)stream;
#define CALL_STATS(NP) launch_pcol<NP, kStats>(a, s)
#define CALL_ACCEPT(NP) launch_pcol<NP, kAccept>(a, s)
  return (int)(prop == nullptr ? DISPATCH_NP(N, CALL_STATS)
                               : DISPATCH_NP(N, CALL_ACCEPT));
#undef CALL_STATS
#undef CALL_ACCEPT
}

// The epilogue's special functions on n floats, for checking them against
// the PyTorch calls they reproduce: which = 0 torch.special.ndtri, 1
// torch.special.log_ndtr, 2 ops/distributions.py::_ndtr, 3 torch.sigmoid.
extern "C" int stream_special_launch(const float* x, float* out, int n,
                                     int which, void* stream) {
  special_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      x, out, n, which);
  return (int)cudaGetLastError();
}

// The A column's delta, sums only: scratch C * n_tiles(G, col_tile)
// doubles; out C floats.
extern "C" int stream_acol_launch(const float* data, const float* E,
                                  const float* PA, const float* en,
                                  const float* pn, const float* an,
                                  double* scratch, float* out, int C, int K,
                                  int N, int G, void* stream) {
  AcolArgs a = {};
  a.data = data; a.E = E; a.PA = PA; a.en = en; a.pn = pn; a.an = an;
  a.out = out; a.scratch = scratch;
  a.C = C; a.K = K; a.N = N; a.G = G;
  const cudaStream_t s = (cudaStream_t)stream;
#define CALL_SUMS(NP) launch_acol<NP, false>(a, s)
  const cudaError_t e = DISPATCH_NP(N, CALL_SUMS);
#undef CALL_SUMS
  return (int)e;
}

#else

// Columns n0 .. n1-1 of P, enqueued in order, each a pass over the tiles,
// the proposal, a second pass and the decision: P, PA (= P*A on entry), the
// acceptance record and the NaN-clamp counts are updated in place. scratch:
// C * n_tiles(G, col_tile) * K * 3 doubles; work: C * 4 * K floats.
extern "C" int stream_pcol_update_launch(
    const float* data, const float* E, float* P, float* PA, const float* A,
    float* acc, const float* mu0, const float* sq0, const float* prior_draw,
    const float* U, const float* accept_all, int* nan, double* scratch,
    float* work, int C, int K, int N, int G, int n0, int n1, int expo,
    void* stream) {
  PcolArgs a = {};
  a.scratch = scratch; a.work = work; a.expo = expo;
  a.data = data; a.E = E; a.PA = PA; a.P = P; a.A = A; a.acc = acc;
  a.mu0 = mu0; a.sq0 = sq0; a.prior_draw = prior_draw; a.U = U;
  a.accept_all = accept_all; a.nan = nan;
  a.C = C; a.K = K; a.N = N; a.G = G;
  const cudaStream_t s = (cudaStream_t)stream;
#define CALL_UPDATE(NP) launch_pcol<NP, kUpdate>(a, s)
  for (int n = n0; n < n1; ++n) {
    a.n = n;
    const cudaError_t e = DISPATCH_NP(N, CALL_UPDATE);
    if (e != cudaSuccess) return (int)e;
  }
#undef CALL_UPDATE
  return 0;
}

// Columns n0 .. n1-1 of A, enqueued in order, each a pass over the tiles
// and the decision: A, n_nan and delta are updated in place. logit (C,),
// temp (1,), u (C, N); penalty subtracted from every delta when sbfi.
// scratch: C * n_tiles(G, col_tile) doubles.
extern "C" int stream_acol_update_launch(
    const float* data, const float* E, const float* P, float* A,
    const float* logit, const float* temp, const float* u, float* n_nan,
    float* delta, float penalty, int sbfi, double* scratch, int C, int K,
    int N, int G, int n0, int n1, void* stream) {
  AcolArgs a = {};
  a.data = data; a.E = E; a.P = P; a.A = A; a.logit = logit; a.temp = temp;
  a.u = u; a.n_nan = n_nan; a.delta = delta;
  a.penalty = penalty; a.sbfi = sbfi; a.scratch = scratch;
  a.C = C; a.K = K; a.N = N; a.G = G;
  const cudaStream_t s = (cudaStream_t)stream;
#define CALL_UPDATE(NP) launch_acol<NP, true>(a, s)
  for (int n = n0; n < n1; ++n) {
    a.n = n;
    const cudaError_t e = DISPATCH_NP(N, CALL_UPDATE);
    if (e != cudaSuccess) return (int)e;
  }
#undef CALL_UPDATE
  return 0;
}

#endif
