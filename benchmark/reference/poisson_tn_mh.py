"""Plain PyTorch reference of the Gibbs step of the Poisson likelihood with
the truncated-normal prior and exact Metropolis-Hastings column updates
(Bayesian NMF of mutational signatures, arXiv:2502.18674; the JAX package's
``models/gibbs.py`` and ``models/updates.py``), for C chains at once, on
the streaming path's draw layout and on the fused path's.

Frozen copies, made when this benchmark was written, of the port's plain
arithmetic (each block names the file it came from); it imports nothing of
the program. Every random number is derived again here: the port's draws
are Philox4x32-10 keyed by (seed, chain uid, iteration, site) (the
program's ``ops/rng.py``), so the same seed gives the same uniforms and
normals without the program.

``stream_step`` and ``fused_step`` take a step's input state (the chains'
tensors, their iteration, the temperature and the warm-up flags) and return
the output state and the metrics row; ``init_draws`` gives the initial
state's prior draws. ``rounding`` (a dtype) holds the state and the draws in
that precision before the step computes, for the control of ``check.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F32 = torch.float32
MHAT_FLOOR = 1e-6
_EPS = 1e-30
_TINY32 = 1.1754944e-38       # the uniforms' floor (ops/rng.py TINY)
_U_MIN = 1.2e-38              # the steps' clamp of their uniforms
_HALF_LOG_2PI = 0.9189385332046727
_TWO_PI = 6.283185307179586

# ---------------------------------------------------------------------------
# Philox4x32-10 streams (copied from bayesnmf_tpu_torch/ops/rng.py)
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
SITES = {name: i for i, name in enumerate((
    "mu_p", "sq_p", "mu_e", "sq_e", "lambda_p", "lambda_e", "beta_p",
    "alpha_p", "beta_e", "alpha_e", "prior_P", "prior_E", "R", "A",
    "sigmasq", "fused", "eager_u", "eager_z", "stream_u", "stream_z",
    "hyper_u", "hyper_z", "slice", "gamma_P", "gamma_E", "sweep_P",
    "sweep_E", "alloc"))}


def _mulhilo(m: int, x):
    p_lo = x * (m & 0xFFFF)
    p_hi = x * (m >> 16)
    mid = ((p_hi & 0xFFFF) << 16) + p_lo
    return (p_hi >> 16) + (mid >> 32), mid & _MASK32


def _philox(ctr, k0, k1):
    x0, x1, x2, x3 = ctr
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], x0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], x2)
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return x0, x1, x2, x3


def _uniform_of(word):
    return ((word & 0xFFFFFF).to(F32) * 2.0 ** -24).clamp_min_(_TINY32)


def draw(seed: int, uids, it: int, site: str, n: int, normal=False,
         device="cpu"):
    """(C, n) float32: element e of chain c is the uniform (``normal``: the
    Box-Muller normal) of counter (e // 4 (// 2), site, it, uids[c]) under
    the seed's key."""
    s = int(seed) % 2 ** 64
    key = (s & _MASK32, s >> 32)
    uids = torch.as_tensor(np.asarray(uids, np.int64), device=device)
    per = 2 if normal else 4
    blk = torch.arange(-(-n // per), dtype=torch.int64, device=device)
    C = uids.numel()
    words = _philox((blk.view(1, -1), SITES[site], int(it) & _MASK32,
                     uids.view(C, 1)), *key)
    words = [w.expand(C, blk.numel()) for w in words]
    if normal:
        zs = []
        for a, b in ((words[0], words[1]), (words[2], words[3])):
            u1, u2 = _uniform_of(a).double(), _uniform_of(b).double()
            zs.append((torch.sqrt(-2.0 * torch.log(u1))
                       * torch.cos(_TWO_PI * u2)).to(F32))
        vals = torch.stack(zs, -1)
    else:
        vals = torch.stack([_uniform_of(w) for w in words], -1)
    return vals.reshape(C, -1)[:, :n].contiguous()


# ---------------------------------------------------------------------------
# special functions and densities (copied from bayesnmf_tpu_torch/ops/
# special.py, distributions.py and math.py)
# ---------------------------------------------------------------------------

_A = (-3.969683028665376e01, 2.209460984245205e02, -2.759285104469687e02,
      1.383577518672690e02, -3.066479806614716e01, 2.506628277459239e00)
_B = (-5.447609879822406e01, 1.615858368580409e02, -1.556989798598866e02,
      6.680131188771972e01, -1.328068155288572e01)
_C = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e00,
      -2.549732539343734e00, 4.374664141464968e00, 2.938163982698783e00)
_D = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e00,
      3.754408661907416e00)
_SQRT2PI = 2.5066282746310002


def _acklam_tail(q):
    c1, c2, c3, c4, c5, c6 = _C
    d1, d2, d3, d4 = _D
    return (((((c1 * q + c2) * q + c3) * q + c4) * q + c5) * q + c6) / (
        (((d1 * q + d2) * q + d3) * q + d4) * q + 1.0)


def acklam_ndtri(p):
    a1, a2, a3, a4, a5, a6 = _A
    b1, b2, b3, b4, b5 = _B
    p = p.clamp(1.2e-38, 1.0 - 1.2e-7)
    x_low = _acklam_tail(torch.sqrt(-2.0 * torch.log(p.clamp_min(1.2e-38))))
    x_up = -_acklam_tail(torch.sqrt(-2.0 * torch.log(
        (1.0 - p).clamp_min(1.2e-38))))
    q = p - 0.5
    r = q * q
    x_mid = (((((a1 * r + a2) * r + a3) * r + a4) * r + a5) * r + a6) * q / (
        ((((b1 * r + b2) * r + b3) * r + b4) * r + b5) * r + 1.0)
    return torch.where(p < 0.02425, x_low,
                       torch.where(p > 1.0 - 0.02425, x_up, x_mid))


def as_ndtr(x):
    z = x.abs()
    t = 1.0 / (1.0 + 0.2316419 * z)
    poly = t * (0.319381530 + t * (-0.356563782 + t * (1.781477937 + t * (
        -1.821255978 + t * 1.330274429))))
    pdf = torch.exp(-0.5 * z * z) / _SQRT2PI
    upper = 1.0 - pdf * poly
    return torch.where(x >= 0, upper, 1.0 - upper)


def series_log_ndtr(x):
    safe = x.clamp_max(-4.0)
    ix2 = 1.0 / (safe * safe)
    tail = (-0.5 * safe * safe - torch.log(-safe) - _HALF_LOG_2PI
            + torch.log1p(-ix2 * (1.0 - 3.0 * ix2)))
    direct = torch.log(as_ndtr(x.clamp_min(-4.0)).clamp_min(1e-38))
    return torch.where(x < -4.0, tail, direct)


def erfc_ndtr(x):
    """The normal CDF with erfc in both tails."""
    z = x * 0.7071067811865476
    a = z.abs()
    y = torch.where(a < 0.7071067811865476, 1.0 + torch.erf(z),
                    torch.where(z > 0, 2.0 - torch.erfc(a), torch.erfc(a)))
    return 0.5 * y


def truncnorm_from_u(u1, u2, mu, sigmasq):
    """Normal(mu, sigmasq) truncated to [0, inf) from two uniforms."""
    sd = torch.sqrt(sigmasq)
    alpha = -mu / sd
    tail = erfc_ndtr(-alpha)
    v = (u1 * tail).clamp_min(_TINY32)
    z_icdf = torch.maximum(-torch.special.ndtri(v), alpha)
    a_safe = alpha.clamp_min(1.0)
    z_tail = a_safe - torch.log(u2.clamp_min(_TINY32)) / a_safe
    z = torch.where(alpha > 8.0, z_tail, z_icdf)
    return (mu + sd * z).clamp_min(0.0)


def truncnorm_logpdf(x, mu, sigmasq):
    sd = torch.sqrt(sigmasq)
    z = (x - mu) / sd
    log_norm = -0.5 * z * z - torch.log(sd) - _HALF_LOG_2PI
    return torch.where(x >= 0, log_norm - torch.special.log_ndtr(mu / sd),
                       torch.full_like(log_norm, -math.inf))


def truncnorm_logpdf_delta(x_new, x_old, mu, sigmasq):
    zn = x_new - mu
    zo = x_old - mu
    return -0.5 * (zn * zn - zo * zo) / sigmasq


def const(x: float, like):
    return torch.full((), x, dtype=F32, device=like.device)


def prior_prob_1(R, N, clip_val=0.4):
    return torch.clamp(R / N, clip_val / N, 1.0 - clip_val / N)


def rank_draw(A, temperature, gumbel, N):
    """R by Gumbel-max over the tempered likelihood of ranks 0..N (the
    program's models/updates.py sample_R)."""
    sumA = A.sum(-1, keepdim=True)
    r = torch.arange(N + 1, dtype=F32, device=A.device)
    p1 = prior_prob_1(r, N)
    loglik = sumA * torch.log(p1) + (N - sumA) * torch.log(1.0 - p1)
    return torch.argmax(temperature * loglik + gumbel, dim=-1).to(torch.int32)


def hyperpriors(N: int, data_mean: float) -> dict:
    """The truncated-normal prior's default hyperpriors (setup.R:123-181 of
    the reference; the program's config.default_hyperprior_params)."""
    s = math.sqrt(max(data_mean, 1e-12) / N)
    return {"m_p": 0.0, "s_p": s, "a_p": float(N + 1), "b_p": math.sqrt(N),
            "m_e": 0.0, "s_e": s, "a_e": float(N + 1), "b_e": math.sqrt(N)}


# ---------------------------------------------------------------------------
# the exact hyper-update, host form (copied from bayesnmf_tpu_torch/models/
# updates.py _mu_step, _sq_step)
# ---------------------------------------------------------------------------


def _mu_step(mu_old, m0, s0, x, sq, z, lu):
    den = 1.0 / s0 + 1.0 / sq
    prop = (m0 / s0 + x / sq) / den + torch.sqrt(1.0 / den) * z
    sd = torch.sqrt(sq)
    la = (torch.special.log_ndtr(mu_old / sd)
          - torch.special.log_ndtr(prop / sd))
    return torch.where(lu < la, prop, mu_old)


def _sq_step(sq_old, a0, b0, x, mu, z, lu):
    a = a0 + 0.5
    b = b0 + 0.5 * (x - mu) ** 2
    c = 1.0 - 1.0 / (9.0 * a)
    sqa3 = 3.0 * torch.sqrt(a)
    t_new = c + z / sqa3
    g_new = a * t_new ** 3
    ok = g_new > 1e-30
    g_new_s = g_new.clamp_min(1e-30)
    sq_new = b / g_new_s
    g_old = b / sq_old.clamp_min(1e-30)
    t_old = torch.pow(g_old / a, 1.0 / 3.0)
    z_old = sqa3 * (t_old - c)

    def logw(g, t, zz, sq):
        return ((a - 1.0) * torch.log(g) - g + 0.5 * zz * zz
                + 2.0 * torch.log(t.clamp_min(1e-30))
                - torch.special.log_ndtr(mu / torch.sqrt(sq)))

    la = torch.where(
        ok, logw(g_new_s, t_new, z, sq_new) - logw(g_old, t_old, z_old,
                                                    sq_old),
        torch.full_like(g_new, -math.inf))
    return torch.where(lu < la, sq_new, sq_old)


# ---------------------------------------------------------------------------
# the streaming step's column updates (copied from bayesnmf_tpu_torch/ops/
# stream_sweeps.py's plain versions; Mhat built whole over G, n in order)
# ---------------------------------------------------------------------------


def _mhat(PA, E):
    Mh = PA[:, :, 0:1] * E[:, 0:1, :]
    for n in range(1, PA.shape[2]):
        Mh = Mh + PA[:, :, n:n + 1] * E[:, n:n + 1, :]
    return Mh


def _sum64(x, dims):
    return x.sum(dims, dtype=torch.float64)


def _terms(data, Mh, en, pn, prop, col):
    """The per-entry terms of a P column (``col``) or an E row: without a
    proposal the conditional's two sums, with one the ratio's three."""
    other = en if col else pn
    if prop is None:
        inv = torch.reciprocal(Mh.clamp_min(MHAT_FLOOR))
        resid = data - (Mh - pn * en)
        return (resid * inv) * other, inv * (other * other)
    Mh_no = Mh - pn * en
    lam = Mh.clamp_min(MHAT_FLOOR)
    lam_new = (Mh_no + (prop * en if col else pn * prop)).clamp_min(
        MHAT_FLOOR)
    d = lam_new - lam
    invr = torch.reciprocal(lam_new)
    resid = data - Mh_no
    return (data * torch.log1p(d / lam) - d, (resid * invr) * other,
            invr * (other * other))


def _sums(data, Mh, en, pn, prop, col):
    if col:
        q = None if prop is None else prop.unsqueeze(-1)
        terms = _terms(data, Mh, en[:, None, :], pn.unsqueeze(-1), q, True)
        return tuple(_sum64(x, -1).to(F32) for x in terms)
    q = None if prop is None else prop[:, None, :]
    terms = _terms(data, Mh, en[:, None, :], pn.unsqueeze(-1), q, False)
    return tuple(_sum64(x, -2).to(F32) for x in terms)


def _conditional(mu1, den, hp0, hp1):
    den2 = den + 1.0 / hp1
    return (mu1 + hp0 / hp1) / den2, 1.0 / den2


def _mh_accept(log_ratio, u_acc, accept_all, inactive):
    log_ratio = torch.where(inactive, 0.0, log_ratio)
    ratio_raw = torch.exp(log_ratio).clamp_max(1.0)
    nan_mask = torch.isnan(ratio_raw)
    n_nan = nan_mask.to(F32).sum(-1)
    ratio = torch.where(nan_mask, 0.0, ratio_raw)
    acc = accept_all.view(-1, 1)
    take = acc | (u_acc < ratio)
    return take, torch.where(acc, 1.0, ratio), n_nan


def _column_update(sums, old, A_n, other_sq, hp0, hp1, prior_n, u, rec_old,
                   accept_all):
    mu1, den_raw = sums(None)
    mu, var = _conditional(mu1, A_n * den_raw, hp0, hp1)
    cond = truncnorm_from_u(u[:, 0], u[:, 1], mu, var)
    inactive = other_sq <= 0.0
    proposal = torch.where(inactive, prior_n, cond)
    lp, mu1_r, den_raw_r = sums(A_n * proposal)
    mu_r, var_r = _conditional(mu1_r, A_n * den_raw_r, hp0, hp1)
    log_ratio = (lp + truncnorm_logpdf_delta(proposal, old, hp0, hp1)
                 + truncnorm_logpdf(old, mu_r, var_r)
                 - truncnorm_logpdf(proposal, mu, var))
    take, rec, nn = _mh_accept(log_ratio, u[:, 2], accept_all, inactive)
    excluded = A_n == 0
    new = torch.where(excluded, prior_n, torch.where(take, proposal, old))
    return new, torch.where(excluded, rec_old, rec), nn


def _pcol(data, E, P, A, acc_P, Mu, Sq, P_prior, U, accept_all, n_nan, n):
    A_n = A[:, n:n + 1]
    E_n = E[:, n, :].contiguous()
    P_n = P[:, :, n].clone()
    Mh = _mhat(P * A.unsqueeze(1), E)
    new, rec, nn = _column_update(
        lambda q: _sums(data, Mh, E_n, A_n * P_n, q, True), P_n, A_n,
        (E_n * E_n).sum(-1, keepdim=True), Mu[:, :, n], Sq[:, :, n],
        P_prior[:, :, n], U[:, :, n], acc_P[:, :, n], accept_all)
    P[:, :, n] = new
    acc_P[:, :, n] = rec
    n_nan += nn


def _erow(data, E, P, A, acc_E, Mu, Sq, E_prior, U, accept_all, n_nan, n):
    A_n = A[:, n:n + 1]
    P_n = P[:, :, n].contiguous()
    E_n = E[:, n, :].clone()
    Mh = _mhat(P * A.unsqueeze(1), E)
    new, rec, nn = _column_update(
        lambda q: _sums(data, Mh, A_n * E_n, P_n, q, False), E_n, A_n,
        (P_n * P_n).sum(-1, keepdim=True), Mu[:, n, :], Sq[:, n, :],
        E_prior[:, n, :], U[:, :, n], acc_E[:, n, :], accept_all)
    E[:, n, :] = new
    acc_E[:, n, :] = rec
    n_nan += nn


def _acol(data, E, P, A, logit_p1, temperature, u, n_nan, penalty, n):
    Mh = _mhat(P * A.unsqueeze(1), E)
    contrib = P[:, :, n].unsqueeze(-1) * E[:, n, :].unsqueeze(1)
    Mh_off = Mh - A[:, n].view(-1, 1, 1) * contrib
    lam_off = Mh_off.clamp_min(MHAT_FLOOR)
    lam_on = (Mh_off + contrib).clamp_min(MHAT_FLOOR)
    d = lam_on - lam_off
    delta = _sum64(data * torch.log1p(d / lam_off) - d, (-2, -1)).to(F32)
    x = delta if penalty is None else delta - penalty
    p = torch.sigmoid(logit_p1 + temperature * x)
    is_nan = torch.isnan(p)
    n_nan += is_nan.to(F32)
    p = torch.where(is_nan, 0.5, p)
    A[:, n] = (u[:, n] < p).to(F32)


def _tile_sums(x, gt):
    C, R, W = x.shape
    pad = -W % gt
    if pad:
        x = torch.cat([x, x.new_zeros(C, R, pad)], -1)
    return x.view(C, R, -1, gt).sum((1, 3), dtype=torch.float64)


def stream_row(data, P, E, A, acc_P, acc_E, Mu_p, Sq_p, Mu_e, Sq_e,
               lgamma_sum, mlogm_sum, na_events, it, temperature):
    """The (C, 12) metrics rows of the streaming step (copied from
    stream_sweeps.py stream_metrics_row_reference: float64 sums over G
    tiles 32 wide, rounded once)."""
    C, K, N = P.shape
    G = E.shape[2]
    Mh = _mhat(P * A.unsqueeze(1), E)
    lam = Mh.clamp_min(MHAT_FLOOR)
    L = torch.log(lam)
    d = Mh - data
    terms = (data * L, lam, data.clamp_min(1e-6) * L, d * d,
             truncnorm_logpdf(E, Mu_e, Sq_e), acc_E * A.unsqueeze(-1))
    gt = 32
    (m_loglam, lam_sum, mp_loglam, sq_err, lp_e, acc_e) = torch.stack(
        [_tile_sums(x, gt).sum(-1) for x in terms], 1).to(F32).unbind(1)
    lp_p = _sum64(truncnorm_logpdf(P, Mu_p, Sq_p), (1, 2)).to(F32)
    acc_p = _sum64(acc_P * A.unsqueeze(1), (1, 2)).to(F32)
    loglik = (m_loglam - lam_sum) - lgamma_sum
    sum_a = A.sum(-1)
    n_par = sum_a * (G + K)
    temp = torch.as_tensor(temperature, dtype=F32,
                           device=P.device).reshape(1).expand(C)
    return torch.stack([
        torch.full_like(sum_a, float(it)),
        torch.sqrt(sq_err / const(float(K * G), sq_err)),
        mlogm_sum - mp_loglam, loglik, loglik + (lp_p + lp_e), n_par,
        -2.0 * loglik + n_par * float(np.float32(math.log(G))), sum_a, temp,
        acc_p / torch.clamp_min(sum_a * K, 1.0),
        acc_e / torch.clamp_min(sum_a * G, 1.0), na_events], -1)


def data_constants(data):
    """The row's data-only sums, as the program takes them once a chunk:
    sum(lgamma(M + 1)) and sum(max(M, 1e-6) log max(M, 1e-6))."""
    Mp = data.clamp_min(1e-6)
    return torch.sum(torch.lgamma(data + 1.0)), torch.sum(Mp * torch.log(Mp))


def _rounded(t, rounding):
    return t if rounding is None else t.to(rounding).to(F32)


def _inputs(s, dev, rounding):
    """Copies of a step's input state on ``dev``, the floats held in
    ``rounding``."""
    out = {}
    for k in ("P", "E", "A", "R", "Mu_p", "Sigmasq_p", "Mu_e", "Sigmasq_e",
              "acc_P", "acc_E"):
        t = s[k].to(dev).clone()
        out[k] = _rounded(t, rounding) if t.is_floating_point() else t
    return out


def stream_step(data, hp, s, N, sbfi: bool, learning: bool, rounding=None):
    """One streaming step of every chain (the order of the program's
    models/gibbs.py stream_step, its draws laid out as draw_stream_noise
    lays them): the exact hyper-update, the P columns, the E rows, with
    rank learning R and the inclusion columns, then the metrics row. ``s``:
    {"P", "E", "A", "R", "Mu_p", "Sigmasq_p", "Mu_e", "Sigmasq_e", "acc_P",
    "acc_E"} (C-leading), "seed", "uids", "it", "temperature" (a float),
    "accept_all" ((C,) bool)."""
    dev = data.device
    st = _inputs(s, dev, rounding)
    P, E, A = st["P"], st["E"], st["A"]
    C, K, _ = P.shape
    G = E.shape[2]
    kn, ng = K * N, N * G
    nh = 2 * (kn + ng)
    sizes = {"prior": nh, "P_prior": 2 * kn, "P": 3 * kn, "E_prior": 2 * ng,
             "E": 3 * ng}
    if learning:
        sizes |= {"R": N + 1, "A": N}
    u = draw(s["seed"], s["uids"], s["it"], "stream_u", sum(sizes.values()),
             device=dev).clamp_min_(_U_MIN)
    u = _rounded(u, rounding)
    views, off = {}, 0
    for k, n in sizes.items():
        views[k] = u[:, off:off + n]
        off += n
    z = _rounded(draw(s["seed"], s["uids"], s["it"], "stream_z", nh,
                      normal=True, device=dev), rounding)
    lu = torch.log(views["prior"])

    def h(name):
        return torch.tensor(float(hp[name]), dtype=F32, device=dev)

    def parts(x):
        return (x[:, :kn].view(C, K, N), x[:, kn:kn + ng].view(C, N, G),
                x[:, kn + ng:2 * kn + ng].view(C, K, N),
                x[:, 2 * kn + ng:].view(C, N, G))

    z_p, z_e, zg_p, zg_e = parts(z)
    lu_p1, lu_e1, lu_p2, lu_e2 = parts(lu)
    Mu_p = _mu_step(st["Mu_p"], h("m_p"), h("s_p"), P, st["Sigmasq_p"], z_p,
                    lu_p1)
    Mu_e = _mu_step(st["Mu_e"], h("m_e"), h("s_e"), E, st["Sigmasq_e"], z_e,
                    lu_e1)
    Sq_p = _sq_step(st["Sigmasq_p"], h("a_p"), h("b_p"), P, Mu_p, zg_p, lu_p2)
    Sq_e = _sq_step(st["Sigmasq_e"], h("a_e"), h("b_e"), E, Mu_e, zg_e, lu_e2)

    accept_all = s["accept_all"].to(dev)
    n_nan = torch.zeros(C, dtype=F32, device=dev)
    pu = views["P_prior"].view(C, 2, K, N)
    P_prior = truncnorm_from_u(pu[:, 0], pu[:, 1], Mu_p, Sq_p)
    U_P = views["P"].view(C, 3, N, K)
    acc_P = st["acc_P"]
    for n in range(N):
        _pcol(data, E, P, A, acc_P, Mu_p, Sq_p, P_prior, U_P, accept_all,
              n_nan, n)
    eu = views["E_prior"].view(C, 2, N, G)
    E_prior = truncnorm_from_u(eu[:, 0], eu[:, 1], Mu_e, Sq_e)
    U_E = views["E"].view(C, 3, N, G)
    acc_E = st["acc_E"]
    for n in range(N):
        _erow(data, E, P, A, acc_E, Mu_e, Sq_e, E_prior, U_E, accept_all,
              n_nan, n)
    temperature = torch.tensor(float(s["temperature"]), dtype=F32, device=dev)
    R = st["R"]
    if learning:
        R = rank_draw(A, temperature, -torch.log(-torch.log(views["R"])), N)
        p1 = prior_prob_1(R.to(F32), N)
        logit_p1 = torch.log(p1) - torch.log1p(-p1)
        pen = (float(torch.tensor(float(G + K)) * torch.log(
            torch.tensor(float(G))) / 2.0) if sbfi else None)
        for n in range(N):
            _acol(data, E, P, A, logit_p1, temperature, views["A"], n_nan,
                  pen, n)
    lgamma_sum, mlogm_sum = data_constants(data)
    row = stream_row(data, P, E, A, acc_P, acc_E, Mu_p, Sq_p, Mu_e, Sq_e,
                     lgamma_sum, mlogm_sum, n_nan, s["it"] + 1, temperature)
    return {"P": P, "E": E, "A": A, "R": R, "Mu_p": Mu_p, "Sigmasq_p": Sq_p,
            "Mu_e": Mu_e, "Sigmasq_e": Sq_e, "acc_P": acc_P, "acc_E": acc_E,
            "row": row}


# ---------------------------------------------------------------------------
# the fused step (copied from bayesnmf_tpu_torch/ops/fused_sweeps.py's plain
# version, and the uniform layout and metrics row of models/gibbs.py)
# ---------------------------------------------------------------------------


def _f_ndtri(p):
    central = 1.4142135623730951 * torch.erfinv(2.0 * p - 1.0)
    return torch.where((p < 0.02425) | (p > 0.97575), acklam_ndtri(p), central)


def _f_truncnorm_icdf(u, mu, sd):
    alpha = -mu / sd
    tail = erfc_ndtr(-alpha)
    v = (u * tail).clamp_min(_U_MIN)
    z_icdf = torch.maximum(-_f_ndtri(v), alpha)
    a_safe = alpha.clamp_min(1.0)
    z_tail = a_safe - torch.log(u.clamp_min(_U_MIN)) / a_safe
    z = torch.where(alpha > 8.0, z_tail, z_icdf)
    return (mu + sd * z).clamp_min(0.0)


def _f_tn_logpdf(x, mu, var):
    sd = torch.sqrt(var)
    z = (x - mu) / sd
    return (-0.5 * z * z - torch.log(sd) - _HALF_LOG_2PI
            - series_log_ndtr(mu / sd))


def _f_hyper_side(x, mu_old, sq_old, hhp, hu):
    m0, s0, a0, b0 = hhp.unbind(-3)
    z_mu = _f_ndtri(hu[..., 0, :, :])
    lu_mu = torch.log(hu[..., 1, :, :])
    z_sq = _f_ndtri(hu[..., 2, :, :])
    lu_sq = torch.log(hu[..., 3, :, :])
    den = 1.0 / s0 + 1.0 / sq_old
    prop = (m0 / s0 + x / sq_old) / den + torch.sqrt(1.0 / den) * z_mu
    sd = torch.sqrt(sq_old)
    la = series_log_ndtr(mu_old / sd) - series_log_ndtr(prop / sd)
    mu_new = torch.where(lu_mu < la, prop, mu_old)
    a = a0 + 0.5
    b = b0 + 0.5 * (x - mu_new) * (x - mu_new)
    c = 1.0 - 1.0 / (9.0 * a)
    sqa3 = 3.0 * torch.sqrt(a)
    t_new = c + z_sq / sqa3
    g_new = a * t_new * t_new * t_new
    ok = g_new > 1e-30
    g_new_s = g_new.clamp_min(1e-30)
    sq_new = b / g_new_s
    g_old = b / sq_old.clamp_min(1e-30)
    t_old = torch.exp(torch.log((g_old / a).clamp_min(1e-38)) / 3.0)
    z_old = sqa3 * (t_old - c)

    def logw(g, t, zz, sq):
        return ((a - 1.0) * torch.log(g) - g + 0.5 * zz * zz
                + 2.0 * torch.log(t.clamp_min(1e-30))
                - series_log_ndtr(mu_new / torch.sqrt(sq)))

    la2 = torch.where(ok, logw(g_new_s, t_new, z_sq, sq_new)
                      - logw(g_old, t_old, z_old, sq_old),
                      torch.full_like(g_new, -float("inf")))
    return mu_new, torch.where(lu_sq < la2, sq_new, sq_old)


def _f_sum(x, dim):
    return x.sum(dim, keepdim=True, dtype=torch.float64).to(F32)


def _f_conditional(mu1, den, hp0, hp1):
    den2 = den + 1.0 / hp1
    return (mu1 + hp0 / hp1) / den2, 1.0 / den2


def _f_mh_column(M, Mh, old, other, hp0, hp1, u_prop, u_acc, acc_on, dim):
    sig = Mh.clamp_min(MHAT_FLOOR)
    Mno = Mh - old * other
    o2 = other * other
    mu1 = _f_sum(((M - Mno) / sig) * other, dim)
    den = _f_sum(o2 / sig, dim)
    mu, var = _f_conditional(mu1, den, hp0, hp1)
    proposal = _f_truncnorm_icdf(u_prop, mu, torch.sqrt(var))
    Mh_prop = Mh + (proposal - old) * other
    lam_o = Mh.clamp_min(MHAT_FLOOR)
    lam_n = Mh_prop.clamp_min(MHAT_FLOOR)
    d_lam = lam_n - lam_o
    lp_core = M * torch.log1p(d_lam / lam_o) - d_lam
    sig_r = Mh_prop.clamp_min(MHAT_FLOOR)
    mu1_r = _f_sum(((M - Mno) / sig_r) * other, dim)
    den_r = _f_sum(o2 / sig_r, dim)
    mu_r, var_r = _f_conditional(mu1_r, den_r, hp0, hp1)
    lprior = _f_tn_logpdf(proposal, hp0, hp1) - _f_tn_logpdf(old, hp0, hp1)
    log_ratio = (_f_sum(lp_core, dim) + lprior + _f_tn_logpdf(old, mu_r, var_r)
                 - _f_tn_logpdf(proposal, mu, var))
    ratio_raw = torch.exp(log_ratio).clamp_max(1.0)
    nan_mask = torch.isnan(ratio_raw)
    n_nan = nan_mask.flatten(1).sum(1).to(F32)
    ratio = torch.where(nan_mask, 0.0, ratio_raw)
    take = acc_on | (u_acc < ratio)
    rec = torch.where(acc_on, torch.ones_like(ratio), ratio)
    new_val = torch.where(take, proposal, old)
    return new_val, Mh + (new_val - old) * other, rec, n_nan


def _f_rank_branch(M, P, E, A, Mh, temp, gumbel, u_A, sbfi, nan):
    C, K, N = P.shape
    G = E.shape[2]
    fN = const(float(N), P)
    lo = const(0.4, P) / fN
    hi = 1.0 - const(0.4, P) / fN
    sumA = A.sum(-1, keepdim=True)
    r = torch.arange(N + 1, dtype=F32, device=P.device)
    p1_r = torch.minimum(torch.maximum(r / fN, lo), hi)
    scores = (temp * (sumA * torch.log(p1_r)
                      + (fN - sumA) * torch.log(1.0 - p1_r)) + gumbel)
    mx = scores.max(-1, keepdim=True).values
    R = torch.where(scores >= mx, r, 0.0).sum(-1)
    p1 = torch.minimum(torch.maximum(R / fN, lo), hi)
    logit_p1 = torch.log(p1) - torch.log1p(-p1)
    pen = float(np.float32((G + K) * math.log(G) / 2.0))
    temp = temp.view(C)
    A = A.clone()
    for n in range(N):
        A_n = A[:, n].view(C, 1, 1)
        con = P[:, :, n:n + 1] * E[:, n:n + 1, :]
        off = Mh - A_n * con
        lam_off = off.clamp_min(MHAT_FLOOR)
        d = (off + con).clamp_min(MHAT_FLOOR) - lam_off
        delta = _f_sum(M * torch.log1p(d / lam_off) - d, (1, 2)).view(C)
        if sbfi:
            delta = delta - pen
        p = 1.0 / (1.0 + torch.exp(-(logit_p1 + temp * delta)))
        is_nan = torch.isnan(p)
        nan = nan + is_nan.to(F32)
        p = torch.where(is_nan, 0.5, p)
        a_new = (u_A[:, n] < p).to(F32)
        Mh = off + a_new.view(C, 1, 1) * con
        A[:, n] = a_new
    return A, R, Mh, nan


def fused_row(data, P, E, A, Mu_p, Sq_p, Mu_e, Sq_e, Mh, it, temperature,
              acc_P, acc_E, na_events, consts):
    """The fused step's metrics rows (copied from models/gibbs.py
    _metrics_row, the Poisson likelihood)."""
    s2 = (-2, -1)
    lam = Mh.clamp_min(MHAT_FLOOR)
    L = torch.log(lam)
    ll_sum = torch.sum(data * L, s2) - torch.sum(lam, s2)
    kl_sum = torch.sum(data.clamp_min(1e-6) * L, s2)
    lp = torch.sum(truncnorm_logpdf(P, Mu_p, Sq_p), s2)
    le = torch.sum(truncnorm_logpdf(E, Mu_e, Sq_e), s2)
    C, K, _ = P.shape
    G = E.shape[2]
    d = Mh - data
    acc_e = torch.sum(acc_E * A.unsqueeze(-1), s2)
    rmse = torch.sqrt(torch.mean(d * d, s2))
    loglik = ll_sum - consts[0]
    kl = consts[1] - kl_sum
    logpost = loglik + (lp + le)
    sum_a = torch.sum(A, -1)
    n_par = sum_a * (G + K)
    bic = -2.0 * loglik + n_par * math.log(G)
    row = torch.empty(C, 12, dtype=F32, device=data.device)
    row[:, 0] = float(it)
    row[:, 1:8] = torch.stack([rmse, kl, loglik, logpost, n_par, bic, sum_a],
                              -1)
    row[:, 8] = float(temperature)
    row[:, 9:11] = torch.stack([
        torch.sum(acc_P * A.unsqueeze(-2), s2) / (sum_a * K).clamp_min(1),
        acc_e / (sum_a * G).clamp_min(1)], -1)
    row[:, 11] = na_events
    return row


def fused_step(data, hp, s, N, sbfi: bool, learning: bool, rounding=None):
    """One fused step of every chain (the order of the program's
    models/gibbs.py gibbs_step: one uniform draw at site "fused", Mhat by
    one product, the exact hyper-update, the P sweep, the E sweep, with rank
    learning R and the inclusion updates, then the metrics row). ``s`` as
    for stream_step."""
    dev = data.device
    st = _inputs(s, dev, rounding)
    P, E, A = st["P"], st["E"], st["A"]
    C, K, _ = P.shape
    G = E.shape[2]
    n_p, n_e = K * N, N * G
    n_u = 3 * (n_p + n_e) + (2 * (N + 1) if learning else 0) + 4 * (n_p + n_e)
    u = _rounded(draw(s["seed"], s["uids"], s["it"], "fused", n_u,
                      device=dev).clamp_min_(_U_MIN), rounding)
    torch.backends.cuda.matmul.allow_tf32 = False
    Mh = torch.matmul(P * A.unsqueeze(-2), E)

    def cut(off, shape):
        n = int(np.prod(shape))
        return u[:, off:off + n].reshape((C,) + shape).contiguous()

    Upr_P, Up_P, Ua_P = (cut(i * n_p, (K, N)) for i in range(3))
    Upr_E, Up_E, Ua_E = (cut(3 * n_p + i * n_e, (N, G)) for i in range(3))
    off = 3 * (n_p + n_e)
    temp = torch.full((C, 1), float(s["temperature"]), dtype=F32, device=dev)
    if learning:
        gumbel = -torch.log(-torch.log(u[:, off:off + N + 1]))
        u_A = u[:, off + N + 1:off + 2 * N + 1]
        off += 2 * (N + 1)
    hyper_u = (cut(off, (4, K, N)), cut(off + 4 * n_p, (4, N, G)))

    def planes(side, shape):
        return torch.stack([torch.full(shape, float(hp[f"{k}_{side}"]),
                                       dtype=F32, device=dev)
                            for k in ("m", "s", "a", "b")])

    Mu_p, Sq_p = _f_hyper_side(P, st["Mu_p"], st["Sigmasq_p"],
                               planes("p", (K, N)), hyper_u[0])
    Mu_e, Sq_e = _f_hyper_side(E, st["Mu_e"], st["Sigmasq_e"],
                               planes("e", (N, G)), hyper_u[1])
    acc_on = s["accept_all"].to(dev).view(-1, 1, 1)
    acc_P, acc_E = st["acc_P"], st["acc_E"]
    nan = torch.zeros(C, dtype=F32, device=dev)

    def sweep(X, acc, Upr, Up, Ua, hp0, hp1, other_of, sl, dim):
        nonlocal Mh, nan
        for n in range(N):
            s_ = sl(n)
            active = (A[:, n] != 0.0).view(-1, 1, 1)
            new, Mh_new, rec, n_nan = _f_mh_column(
                data, Mh, X[s_], other_of(n), hp0[s_], hp1[s_], Up[s_],
                Ua[s_], acc_on, dim)
            prior = _f_truncnorm_icdf(Upr[s_], hp0[s_], torch.sqrt(hp1[s_]))
            X[s_] = torch.where(active, new, prior)
            acc[s_] = torch.where(active, rec, acc[s_])
            Mh = torch.where(active, Mh_new, Mh)
            nan = nan + torch.where(active.view(-1), n_nan, 0.0)

    sweep(P, acc_P, Upr_P, Up_P, Ua_P, Mu_p, Sq_p,
          lambda n: E[:, n:n + 1, :],
          lambda n: (slice(None), slice(None), slice(n, n + 1)), 2)
    sweep(E, acc_E, Upr_E, Up_E, Ua_E, Mu_e, Sq_e,
          lambda n: P[:, :, n:n + 1],
          lambda n: (slice(None), slice(n, n + 1), slice(None)), 1)
    R = st["R"]
    if learning:
        A, R_f, Mh, nan = _f_rank_branch(data, P, E, A, Mh, temp, gumbel, u_A,
                                         sbfi, nan)
        R = R_f.to(torch.int32)
    row = fused_row(data, P, E, A, Mu_p, Sq_p, Mu_e, Sq_e, Mh, s["it"] + 1,
                    s["temperature"], acc_P, acc_E, nan, data_constants(data))
    return {"P": P, "E": E, "A": A, "R": R, "Mu_p": Mu_p, "Sigmasq_p": Sq_p,
            "Mu_e": Mu_e, "Sigmasq_e": Sq_e, "acc_P": acc_P, "acc_E": acc_E,
            "row": row}


def init_draws(hp, s, N, G, learning: bool, rounding=None):
    """The initial state's draws of every chain at iteration 0 (the
    program's models/gibbs.py init_state): Mu_p and Mu_e from their normal
    hyperpriors, P and E from the truncated-normal prior given Mu and the
    given Sigmasq (``s``'s, drawn by an exact gamma rejection loop that is
    not derived again here), and with rank learning R ~ Uniform{0..N} and
    A_n ~ Bernoulli(p1(R))."""
    dev = s["Sigmasq_p"].device
    C, K, _ = s["Sigmasq_p"].shape

    def d(site, n, normal=False):
        return _rounded(draw(s["seed"], s["uids"], 0, site, n, normal,
                             device=dev), rounding)

    def full(name, shape):
        return torch.full(shape, float(hp[name]), dtype=F32, device=dev)

    Mu_p = full("m_p", (C, K, N)) + torch.sqrt(full("s_p", (C, K, N))) * d(
        "mu_p", K * N, True).view(C, K, N)
    Mu_e = full("m_e", (C, N, G)) + torch.sqrt(full("s_e", (C, N, G))) * d(
        "mu_e", N * G, True).view(C, N, G)
    sq_p = _rounded(s["Sigmasq_p"], rounding)
    sq_e = _rounded(s["Sigmasq_e"], rounding)
    up = d("prior_P", 2 * K * N).view(C, 2, K, N)
    ue = d("prior_E", 2 * N * G).view(C, 2, N, G)
    out = {"Mu_p": Mu_p, "Mu_e": Mu_e,
           "P": truncnorm_from_u(up[:, 0], up[:, 1], Mu_p, sq_p),
           "E": truncnorm_from_u(ue[:, 0], ue[:, 1], Mu_e, sq_e)}
    if learning:
        u = d("R", 1)[:, 0]
        R = torch.floor(u * (N + 1)).clamp_max_(N).to(torch.int32)
        p1 = prior_prob_1(R.to(F32), N)
        out["R"] = R
        out["A"] = (d("A", N) < p1.unsqueeze(-1)).to(F32)
    return out


# ---------------------------------------------------------------------------
# What this reference checks (read by benchmark/harness.py and check.py)
# ---------------------------------------------------------------------------

#: the state tensors a replayed step compares, each with where it sits in
#: the program's state: under "params", under "prior" or at the top ("")
STATE = {"P": "params", "E": "params", "A": "params", "R": "params",
         "Mu_p": "prior", "Sigmasq_p": "prior", "Mu_e": "prior",
         "Sigmasq_e": "prior", "acc_P": "", "acc_E": ""}
#: the tensors of a fit's start that the harness keeps (init_draws reads
#: Sigmasq_p and Sigmasq_e and derives the others again)
START = ("P", "E", "A", "R", "Mu_p", "Mu_e", "Sigmasq_p", "Sigmasq_e")
#: the program's path name -> the step that replays it
STEPS = {"stream": stream_step, "fused": fused_step}
#: the program's path name -> {timing name: the calls a traced run times
#: together}, each "<module under bayesnmf_tpu_torch>:<attribute>" where
#: the program looks the attribute up
TIMED = {
    "stream": {
        "stream_pcol_update": ("ops.stream_sweeps:stream_pcol_update",),
        "stream_erow_update": ("ops.stream_sweeps:stream_erow_update",),
        "stream_acol_update": ("ops.stream_sweeps:stream_acol_update",),
        "prior_update": ("models.updates:sample_prior_params",
                         "models.updates:sample_R")},
    "fused": {"fused_gibbs_sweeps": ("models.gibbs:fused_gibbs_sweeps",)}}
