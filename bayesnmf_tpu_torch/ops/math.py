"""Model math: expected data matrix, likelihood, priors, metrics.

Port of bayesnmf_tpu/ops/math.py for both likelihoods and the three priors
(TruncNormal, exponential, gamma). Conventions
as in the reference: data M is (K, G); P is (K, N) signatures; E is (N, G)
exposures; A is (N,) binary inclusion; sigmasq is (G,), the Normal
likelihood's per-sample noise variance. Everything is float32.
"""

from __future__ import annotations

import math

import torch

# Clip floor applied to Mhat under the Poisson likelihood to avoid log(0)
# (utils.R:100)
MHAT_FLOOR = 1e-6
_HALF_LOG_2PI = 0.9189385332046727


def const(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant on ``like``'s device. Dividing by it, or into it,
    is a true division on every device, as in JAX: PyTorch multiplies by a
    reciprocal when the divisor (on CUDA) or the dividend (everywhere) is a
    Python number, which can round differently."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def mhat(P: torch.Tensor, A: torch.Tensor, E: torch.Tensor) -> torch.Tensor:
    """Expected data matrix ``P @ diag(A) @ E`` -> (K, G), at full float32.

    The reference forces ``Precision.HIGHEST`` (math.py:23-32): the product
    feeds log-densities and acceptance ratios, so TF32 is not acceptable.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.matmul(P * A.unsqueeze(-2), E)


def poisson_loglik_mat(M: torch.Tensor, Mh: torch.Tensor) -> torch.Tensor:
    """Elementwise log dPois(M | max(Mh, 1e-6)) -> (K, G) (utils.R:98-106)."""
    lam = Mh.clamp_min(MHAT_FLOOR)
    return M * torch.log(lam) - lam - torch.lgamma(M + 1.0)


def normal_loglik_mat(M: torch.Tensor, Mh: torch.Tensor,
                      sigmasq: torch.Tensor) -> torch.Tensor:
    """Elementwise log dNorm(M | Mh, sigmasq) -> (K, G) (math.py:54-65);
    ``sigmasq`` is (G,), broadcast over the rows (utils.R:79-86), or a full
    (K, G) matrix."""
    if sigmasq.dim() == 1:
        sigmasq = sigmasq.unsqueeze(0)
    resid = M - Mh
    return (-0.5 * resid * resid / sigmasq - 0.5 * torch.log(sigmasq)
            - _HALF_LOG_2PI)


def loglik_mat(M: torch.Tensor, Mh: torch.Tensor, likelihood: str,
               sigmasq=None) -> torch.Tensor:
    """The elementwise log-likelihood of either family (get_loglik_,
    utils.R:62-112; math.py:68-77)."""
    if likelihood == "poisson":
        return poisson_loglik_mat(M, Mh)
    return normal_loglik_mat(M, Mh, sigmasq)


def truncnorm_logpdf(x, mu, sigmasq):
    """log pdf of Normal(mu, sigmasq) truncated to [0, inf) (utils.R:134-145),
    with the accurate library log_ndtr for the normaliser, as the reference's
    jax.scipy.special.log_ndtr."""
    sd = torch.sqrt(sigmasq)
    z = (x - mu) / sd
    log_norm = -0.5 * z * z - torch.log(sd) - _HALF_LOG_2PI
    log_tail = torch.special.log_ndtr(mu / sd)
    return torch.where(x >= 0, log_norm - log_tail,
                       torch.full_like(log_norm, -math.inf))


def truncnorm_logpdf_delta(x_new, x_old, mu, sigmasq):
    """truncnorm_logpdf(x_new, ...) - truncnorm_logpdf(x_old, ...) for
    x_new, x_old >= 0 (math.py:101-110): the normalisers cancel, leaving
    the quadratic."""
    zn = x_new - mu
    zo = x_old - mu
    return -0.5 * (zn * zn - zo * zo) / sigmasq


def exponential_logpdf(x, rate):
    """log pdf of Exponential(rate) (math.py:113-114)."""
    return torch.where(x >= 0, torch.log(rate) - rate * x,
                       torch.full_like(x, -math.inf))


def gamma_logpdf(x, shape, rate):
    """log pdf of Gamma(shape, rate) (math.py:117-126)."""
    return (shape * torch.log(rate) - torch.lgamma(shape)
            + (shape - 1.0) * torch.log(x) - rate * x)


def logprior_parts(P, E, prior: str, prior_params: dict):
    """The prior log-pdfs of P and of E, each summed (per chain with a
    leading chain axis): (P's, E's)."""
    if prior == "truncnormal":
        lp = truncnorm_logpdf(P, prior_params["Mu_p"],
                              prior_params["Sigmasq_p"])
        le = truncnorm_logpdf(E, prior_params["Mu_e"],
                              prior_params["Sigmasq_e"])
    elif prior == "exponential":
        lp = exponential_logpdf(P, prior_params["Lambda_p"])
        le = exponential_logpdf(E, prior_params["Lambda_e"])
    else:  # gamma
        lp = gamma_logpdf(P, prior_params["Alpha_p"], prior_params["Beta_p"])
        le = gamma_logpdf(E, prior_params["Alpha_e"], prior_params["Beta_e"])
    return lp.sum((-2, -1)), le.sum((-2, -1))


def logprior_PE(P, E, prior: str, prior_params: dict,
                mesh=None) -> torch.Tensor:
    """Sum of the prior log-pdfs of P and E (utils.R:131-175; math.py:
    129-140). With a leading chain axis on every operand, one sum per
    chain. On a mesh (parallel/mesh.py) E and its prior parameters are
    this rank's block of G, and E's sum is all-reduced over the g group."""
    lp, le = logprior_parts(P, E, prior, prior_params)
    if mesh is not None:
        from ..parallel.mesh import g_all_reduce

        le = g_all_reduce(le, mesh)
    return lp + le


def rmse(M: torch.Tensor, Mh: torch.Tensor) -> torch.Tensor:
    """Root mean squared error (utils.R:437)."""
    d = Mh - M
    return torch.sqrt(torch.mean(d * d))


def padded_kl(Mh: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """sum(M log(M/Mhat)) with both padded to >= 1e-6 (utils.R:467-471)."""
    Mh = Mh.clamp_min(1e-6)
    Mp = M.clamp_min(1e-6)
    return torch.sum(Mp * (torch.log(Mp) - torch.log(Mh)))


def metric_constants(likelihood: str, M: torch.Tensor, mesh=None) -> dict:
    """Data-only terms of the per-iteration metrics, computed once per chunk
    (math.py:157-172): the padded-KL entropy sum(Mp log Mp), and for the
    Poisson likelihood the log-factorial sum(lgamma(M+1)). On a mesh ``M``
    is this rank's block of G, and the sums are all-reduced over the g
    group (one all-reduce)."""
    Mp = M.clamp_min(1e-6)
    consts = {"mlogm_sum": torch.sum(Mp * torch.log(Mp))}
    if likelihood == "poisson":
        consts["lgamma_sum"] = torch.sum(torch.lgamma(M + 1.0))
    if mesh is not None and mesh.n_g > 1:
        from ..parallel.mesh import g_all_reduce

        both = g_all_reduce(torch.stack(list(consts.values())), mesh)
        consts = dict(zip(consts, both.unbind()))
    return consts


def bic(loglik, n_params, G: int):
    """BIC = -2 loglik + n_params log(G) (utils.R:432)."""
    return -2.0 * loglik + n_params * math.log(G)


def n_params_of(A: torch.Tensor, K: int, G: int) -> torch.Tensor:
    """Effective parameter count sum(A) * (G + K) (utils.R:424), per chain
    when A has a chain axis."""
    return torch.sum(A, -1) * (G + K)


def renormalize(P: torch.Tensor, E: torch.Tensor):
    """Rescale so columns of P sum to 1, preserving P @ E (helpers.R:35-49)."""
    s = torch.sum(P, dim=-2)
    safe = torch.where(s > 0, s, torch.ones_like(s))
    return P / safe.unsqueeze(-2), E * safe.unsqueeze(-1)


def logsumexp2(a, b):
    """log(exp(a) + exp(b)), stable (sumLog, sample_params.R:199-206;
    math.py:192-197)."""
    hi = torch.maximum(a, b)
    lo = torch.minimum(a, b)
    return hi + torch.log1p(torch.exp(lo - hi))
