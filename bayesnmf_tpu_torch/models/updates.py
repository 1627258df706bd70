"""Gibbs conditional updates of the port.

Port of the truncnormal and exponential subset of
bayesnmf_tpu/models/updates.py:

- initial draws: ``init_prior_params`` (:62-77), ``_prior_draw_P/E``
  (:244-258);
- ``sample_prior_params`` (:91-203): the exact TruncNormal hyper-update,
  which on the streaming path runs as host-issued tensor ops (the fused
  kernel carries its own copy), and the exponential prior's
  Lambda ~ Gamma(a + 1, b + x);
- the conjugate Poisson-Gibbs draws ``sample_P_poisson_gibbs`` /
  ``sample_E_poisson_gibbs`` (:733-762) and ``sample_Z_sums`` (:894-905),
  whose allocation is the kernel of ops/allocation.py;
- rank learning: ``prior_prob_1`` and ``sample_R`` (:770-783), the
  Mhat-based ``sweep_A`` (:786-835) of the conjugate path, and
  ``stream_sweep_A`` (:838-872);
- the streaming sweeps ``stream_sweep_P``/``stream_sweep_E`` (:539-725),
  whose column updates are the kernels of ops/stream_sweeps.py.

On the streaming path every tensor carries a leading chain axis C and one
call updates the whole ensemble; ``accept_all`` is a (C,) bool tensor, and
every branch on device data is a ``torch.where``, so no call waits for the
device. Each function takes its random numbers as optional ``noise``
operands laid out as the JAX function draws them from its key (the tests
feed it the JAX draws); when ``noise`` is None they come from ``gen``.
"""

from __future__ import annotations

import math

import torch

from ..config import ModelSpec
from ..ops import distributions as dist
from ..ops import math as m
from ..ops import stream_sweeps as S
from ..ops.allocation import allocate_counts

_U_MIN = 1.2e-38   # minval of the JAX package's sweep uniforms


def _full(hp, name, shape, device):
    """Hyperprior entry broadcast to ``shape`` as float32."""
    return torch.full(shape, float(hp[name]), dtype=torch.float32,
                      device=device)


def _require_ported_prior(spec: ModelSpec):
    if spec.prior not in ("truncnormal", "exponential"):
        raise NotImplementedError(
            f"the {spec.prior!r} prior is not ported yet (ROADMAP.md queue 1 "
            "item 8)")


def _rand(gen, shape, device, low=_U_MIN):
    return torch.rand(shape, generator=gen, device=device).clamp_min_(low)


# ---------------------------------------------------------------------------
# initial draws
# ---------------------------------------------------------------------------


def init_prior_params(spec: ModelSpec, hp: dict, gen: torch.Generator,
                      device, chains=None) -> dict:
    """Draw the prior parameters of P and E from their hyperpriors
    (init_prior_params_, sample_priors.R:15-141): Mu/Sigmasq for the
    truncnormal prior, Lambda ~ Gamma(a, b) for the exponential one; with
    ``chains`` = C, one draw per chain on a leading axis."""
    _require_ported_prior(spec)
    lead = () if chains is None else (chains,)
    kn, ng = lead + (spec.K, spec.N), lead + (spec.N, spec.G)
    if spec.prior == "exponential":
        return {
            "Lambda_p": dist.gamma(gen, _full(hp, "a_p", kn, device),
                                   _full(hp, "b_p", kn, device)),
            "Lambda_e": dist.gamma(gen, _full(hp, "a_e", ng, device),
                                   _full(hp, "b_e", ng, device)),
        }
    return {
        "Mu_p": dist.normal(gen, _full(hp, "m_p", kn, device),
                            _full(hp, "s_p", kn, device)),
        "Sigmasq_p": dist.inv_gamma(gen, _full(hp, "a_p", kn, device),
                                    _full(hp, "b_p", kn, device)),
        "Mu_e": dist.normal(gen, _full(hp, "m_e", ng, device),
                            _full(hp, "s_e", ng, device)),
        "Sigmasq_e": dist.inv_gamma(gen, _full(hp, "a_e", ng, device),
                                    _full(hp, "b_e", ng, device)),
    }


def _prior_draw_P(spec: ModelSpec, prior: dict, gen: torch.Generator,
                  u=None):
    """A full P from the prior (sample_Pn.R:12-29); ``u``: the two uniform
    planes on dim -3 (the JAX draw's (2, K, N), with the chain axis
    first; truncnormal prior only)."""
    _require_ported_prior(spec)
    if spec.prior == "exponential":
        return dist.exponential(gen, prior["Lambda_p"])
    if u is None:
        return dist.truncnorm_nonneg(gen, prior["Mu_p"], prior["Sigmasq_p"])
    return dist.truncnorm_nonneg_from_u(u.select(-3, 0), u.select(-3, 1),
                                        prior["Mu_p"], prior["Sigmasq_p"])


def _prior_draw_E(spec: ModelSpec, prior: dict, gen: torch.Generator,
                  u=None):
    _require_ported_prior(spec)
    if spec.prior == "exponential":
        return dist.exponential(gen, prior["Lambda_e"])
    if u is None:
        return dist.truncnorm_nonneg(gen, prior["Mu_e"], prior["Sigmasq_e"])
    return dist.truncnorm_nonneg_from_u(u.select(-3, 0), u.select(-3, 1),
                                        prior["Mu_e"], prior["Sigmasq_e"])


# ---------------------------------------------------------------------------
# the exact TruncNormal hyper-update (truncnormal + exact_truncnorm_hypers)
# ---------------------------------------------------------------------------


def _mu_step(mu_old, m0, s0, x, sq, z, lu):
    """Metropolised conjugate-proposal step of Mu (updates.py:124-129)."""
    den = 1.0 / s0 + 1.0 / sq
    prop = (m0 / s0 + x / sq) / den + torch.sqrt(1.0 / den) * z
    sd = torch.sqrt(sq)
    la = (torch.special.log_ndtr(mu_old / sd)
          - torch.special.log_ndtr(prop / sd))
    return torch.where(lu < la, prop, mu_old)


def _sq_step(sq_old, a0, b0, x, mu, z, lu):
    """Wilson-Hilferty InvGamma proposal, Metropolised in g = b/sigma^2
    (updates.py:131-165)."""
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
    # g_old / a > 0, where the real cube root is the float power
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


def n_hyper_noise(spec: ModelSpec) -> int:
    """Length of one chain's normal (and uniform) draw for the hyper-update:
    two per element of (K, N) and of (N, G)."""
    return 2 * (spec.K * spec.N + spec.N * spec.G)


def _sample_lambda(spec: ModelSpec, hp: dict, params: dict, prior: dict,
                   gen, noise) -> dict:
    """Lambda | x ~ Gamma(a + 1, b + x) for both sides (sample_priors.R:
    284-308, updates.py:196-203). ``noise``: {"p": ..., "e": ...}, the
    gamma draws' uniform planes (9,) + shape as the JAX function draws them
    from split(key, 4)[0] and [1]."""
    P, E = params["P"], params["E"]
    noise = noise or {}
    new = dict(prior)
    for side, x in (("p", P), ("e", E)):
        new[f"Lambda_{side}"] = dist.gamma(
            gen, torch.full_like(x, float(hp[f"a_{side}"])) + 1.0,
            torch.full_like(x, float(hp[f"b_{side}"])) + x,
            u=noise.get(side))
    return new


def sample_prior_params(spec: ModelSpec, hp: dict, params: dict, prior: dict,
                        gen=None, noise=None) -> dict:
    """One Gibbs sweep over the prior parameters (updates.py:91-203).

    Exponential prior: Lambda ~ Gamma(a + 1, b + x) (``_sample_lambda``).
    Truncnormal prior: the exact sweep over Mu/Sigmasq of P and E,
    chain-batched: P (C, K, N), E (C, N, G) and the prior dict alike;
    ``noise``: {"z": normals, "u": uniforms}, each (C, n_hyper_noise(spec))
    in the JAX layout [Mu_p, Mu_e, Sigmasq_p, Sigmasq_e] (updates.py:119-173).
    """
    _require_ported_prior(spec)
    if spec.prior == "exponential":
        return _sample_lambda(spec, hp, params, prior, gen, noise)
    if not spec.exact_truncnorm_hypers:
        raise NotImplementedError(
            "exact_truncnorm_hypers=False is not ported yet (ROADMAP.md "
            "queue 1 item 12)")
    P, E = params["P"], params["E"]
    C = P.shape[0]
    K, N, G = spec.K, spec.N, spec.G
    n_p, n_e = K * N, N * G
    n_t = n_p + n_e
    if noise is None:
        noise = {"z": torch.randn((C, 2 * n_t), generator=gen,
                                  device=P.device),
                 "u": _rand(gen, (C, 2 * n_t), P.device)}
    z, lu = noise["z"], torch.log(noise["u"])

    def parts(x):
        return (x[:, :n_p].view(C, K, N), x[:, n_p:n_t].view(C, N, G),
                x[:, n_t:n_t + n_p].view(C, K, N),
                x[:, n_t + n_p:].view(C, N, G))

    z_p, z_e, zg_p, zg_e = parts(z)
    lu_p1, lu_e1, lu_p2, lu_e2 = parts(lu)

    def h(name):  # float32 operands, as the JAX package broadcasts them
        return torch.tensor(float(hp[name]), dtype=torch.float32,
                            device=P.device)

    new = dict(prior)
    new["Mu_p"] = _mu_step(prior["Mu_p"], h("m_p"), h("s_p"), P,
                           prior["Sigmasq_p"], z_p, lu_p1)
    new["Mu_e"] = _mu_step(prior["Mu_e"], h("m_e"), h("s_e"), E,
                           prior["Sigmasq_e"], z_e, lu_e1)
    new["Sigmasq_p"] = _sq_step(prior["Sigmasq_p"], h("a_p"), h("b_p"), P,
                                new["Mu_p"], zg_p, lu_p2)
    new["Sigmasq_e"] = _sq_step(prior["Sigmasq_e"], h("a_e"), h("b_e"), E,
                                new["Mu_e"], zg_e, lu_e2)
    return new


# ---------------------------------------------------------------------------
# rank learning
# ---------------------------------------------------------------------------


def prior_prob_1(R, N, clip_val=0.4):
    """clip(R/N, 0.4/N, 1-0.4/N) (compute_prior_prob_1,
    sample_params.R:178-187)."""
    return torch.clamp(R / N, clip_val / N, 1.0 - clip_val / N)


def sample_R(spec: ModelSpec, A, temperature, gen=None, gumbel=None):
    """The expected rank 0..N from its tempered discrete posterior
    (sample_R, sample_params.R:217-241), by Gumbel-max. A (C, N); ``gumbel``
    (C, N+1). Returns (C,) int32."""
    N = spec.N
    sumA = A.sum(-1, keepdim=True)
    r = torch.arange(N + 1, dtype=torch.float32, device=A.device)
    p1 = prior_prob_1(r, N)
    loglik = sumA * torch.log(p1) + (N - sumA) * torch.log(1.0 - p1)
    if gumbel is None:
        gumbel = dist.gumbel_from_u(_rand(gen, loglik.shape, A.device))
    return dist.categorical_from_gumbel(gumbel, temperature * loglik)


def sbfi_penalty(spec: ModelSpec) -> float:
    """The BIC-penalty delta (G+K) log(G) / 2 of one inclusion, in float32
    with log(G) rounded to float32 first (sample_params.R:118-126,
    updates.py:801). The fused kernel takes the form computed in double
    (ops/fused_sweeps.sbfi_penalty)."""
    return float(torch.tensor(float(spec.G + spec.K))
                 * torch.log(torch.tensor(float(spec.G))) / 2.0)


def sweep_A(spec: ModelSpec, data, params: dict, R, Mhat, temperature,
            gen=None, u=None):
    """Sequential tempered Bernoulli updates of the inclusion vector A on
    one chain, from Mhat (sample_An, sample_params.R:101-166;
    updates.py:786-835): column n's loglik(A_n=1) - loglik(A_n=0) is one
    reduction over K*G, SBFI subtracts the BIC-penalty delta, BFI does not,
    and Mhat is rewritten by a rank-1 term. ``u``: (N,) uniforms, column
    n's Bernoulli draw in u[n] (the JAX draw from split(key, N)[n]).
    Returns (A, Mhat, n_nan), n_nan counting posteriors clamped NaN -> 1/2.
    """
    P, E = params["P"], params["E"]
    A = params["A"].clone()
    N = spec.N
    if u is None:
        u = _rand(gen, (N,), P.device)
    p1 = prior_prob_1(R.to(torch.float32), N)
    logit_p1 = torch.log(p1) - torch.log1p(-p1)
    pen = sbfi_penalty(spec)
    n_nan = torch.zeros((), dtype=torch.float32, device=P.device)
    for n in range(N):
        contrib = P[:, n:n + 1] * E[n:n + 1, :]
        Mhat_off = Mhat - A[n] * contrib
        lam_on = (Mhat_off + contrib).clamp_min(m.MHAT_FLOOR)
        lam_off = Mhat_off.clamp_min(m.MHAT_FLOOR)
        d_lam = lam_on - lam_off
        delta = torch.sum(data * torch.log1p(d_lam / lam_off) - d_lam)
        if spec.rank_method == "SBFI":
            delta = delta - pen
        p = torch.sigmoid(logit_p1 + temperature * delta)
        is_nan = torch.isnan(p)
        n_nan = n_nan + is_nan.to(torch.float32)
        p = torch.where(is_nan, 0.5, p)
        a_new = dist.bernoulli_from_u(u[n], p)
        Mhat = Mhat_off + a_new * contrib
        A[n] = a_new
    return A, Mhat, n_nan


def stream_sweep_A(spec: ModelSpec, data, params: dict, R, temperature,
                   gen=None, u=None):
    """Sequential tempered Bernoulli updates of the inclusion vector A
    (sample_An, sample_params.R:101-166), the whole sweep one call of
    ops/stream_sweeps.stream_acol_update, whose kernels take each column's
    loglik delta, the SBFI penalty (BFI: none), the tempered sigmoid, the
    NaN fallback and the draw in turn. ``u``: (C, N) uniforms, column n's
    Bernoulli draw in u[:, n]. Returns (A, n_nan), n_nan (C,) counting
    posteriors clamped NaN -> 1/2.
    """
    P, E = params["P"], params["E"]
    A = params["A"].clone()
    C, K, N = P.shape
    if u is None:
        u = _rand(gen, (C, N), P.device)
    p1 = prior_prob_1(R.to(torch.float32), N)
    logit_p1 = torch.log(p1) - torch.log1p(-p1)
    pen = sbfi_penalty(spec) if spec.rank_method == "SBFI" else None
    n_nan = torch.zeros(C, dtype=torch.float32, device=P.device)
    S.stream_acol_update(data, E, P, A, logit_p1, temperature,
                         u.contiguous(), n_nan, pen)
    return A, n_nan


# ---------------------------------------------------------------------------
# conjugate Poisson-Gibbs: P and E given the latent counts, and the counts
# ---------------------------------------------------------------------------


def sample_P_poisson_gibbs(spec: ModelSpec, prior: dict, params: dict,
                           gen=None, u=None):
    """All of P in one conjugate draw given the latent-count sums
    (sample_Pn_poisson, sample_Pn.R:98-120; updates.py:733-749):
    P ~ Gamma(1 + Zsum_g, Lambda_p + A * rowsum(E)). An excluded column has
    Zsum 0 and draws from the prior. ``u``: the gamma draw's uniform planes
    (9, K, N)."""
    A, E = params["A"], params["E"]
    rate_add = (A * E.sum(-1)).unsqueeze(-2)                  # (1, N)
    return dist.gamma(gen, 1.0 + params["Zsum_g"],
                      prior["Lambda_p"] + rate_add, u=u)


def sample_E_poisson_gibbs(spec: ModelSpec, prior: dict, params: dict, P_new,
                           gen=None, u=None):
    """The mirror for E with the freshly drawn P (sample_En.R:97-119;
    updates.py:752-762): E ~ Gamma(1 + Zsum_k, Lambda_e + A * colsum(P))."""
    rate_add = (params["A"] * P_new.sum(-2)).unsqueeze(-1)    # (N, 1)
    return dist.gamma(gen, 1.0 + params["Zsum_k"],
                      prior["Lambda_e"] + rate_add, u=u)


def sample_Z_sums(spec: ModelSpec, data, params: dict, gen=None, u=None):
    """The latent counts' marginal sums (Zsum_g (K, N), Zsum_k (N, G)) of
    Z[k, :, g] ~ Multinomial(M[k, g], p ∝ P[k, :] A E[:, g])
    (sample_params.R:253-265; updates.py:894-905), through
    ops/allocation.allocate_counts; ``u``: its uniform planes, else drawn
    from ``gen``."""
    return allocate_counts(data, params["P"], params["A"], params["E"], u=u,
                           gen=gen)


# ---------------------------------------------------------------------------
# streaming P and E sweeps
# ---------------------------------------------------------------------------


def stream_sweep_P(spec: ModelSpec, data, params: dict, prior: dict, acc_P,
                   accept_all, gen=None, noise=None):
    """Sequential exact-MH updates of the N columns of P with streamed
    reductions (updates.py:539-636), each column one call of
    ops/stream_sweeps.stream_pcol_update's kernel; on the card nothing runs
    between the column launches. ``noise``: {"prior_u": (C, 2, K, N),
    "u": (C, 3, N, K)}, the JAX draws of _prior_draw_P and of the sweep's
    uniforms. Returns (P, acc_P, n_nan (C,)); the inputs are not modified.
    """
    P = params["P"].clone()
    acc_P = acc_P.clone()
    C, K, N = P.shape
    if noise is None:
        noise = {"prior_u": _rand(gen, (C, 2, K, N), P.device,
                                  low=dist._TINY),
                 "u": _rand(gen, (C, 3, N, K), P.device)}
    P_prior = _prior_draw_P(spec, prior, gen, noise["prior_u"])
    n_nan = torch.zeros(C, dtype=torch.float32, device=P.device)
    S.stream_pcol_update(data, params["E"], P, params["A"], acc_P,
                         prior["Mu_p"], prior["Sigmasq_p"], P_prior,
                         noise["u"].contiguous(), accept_all, n_nan)
    return P, acc_P, n_nan


def stream_sweep_E(spec: ModelSpec, data, params: dict, prior: dict, acc_E,
                   accept_all, gen=None, noise=None):
    """Streaming mirror of stream_sweep_P over the rows of E
    (updates.py:639-725). ``noise``: {"prior_u": (C, 2, N, G),
    "u": (C, 3, N, G)}. Returns (E, acc_E, n_nan (C,))."""
    E = params["E"].clone()
    acc_E = acc_E.clone()
    C, N, G = E.shape
    if noise is None:
        noise = {"prior_u": _rand(gen, (C, 2, N, G), E.device,
                                  low=dist._TINY),
                 "u": _rand(gen, (C, 3, N, G), E.device)}
    E_prior = _prior_draw_E(spec, prior, gen, noise["prior_u"])
    n_nan = torch.zeros(C, dtype=torch.float32, device=E.device)
    S.stream_erow_update(data, E, params["P"], params["A"], acc_E,
                         prior["Mu_e"], prior["Sigmasq_e"], E_prior,
                         noise["u"].contiguous(), accept_all, n_nan)
    return E, acc_E, n_nan
