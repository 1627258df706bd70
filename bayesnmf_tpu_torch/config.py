"""Model specification, convergence control and run options of the port.

The port's own copy of the JAX package's configuration module: the model
validity rules follow the reference's check_model
(bayesNMF_sampler.R:623-645), the convergence defaults
new_convergence_control() (convergence.R:16-45) and the hyperprior defaults
get_default_*_hyperprior_params_ (setup.R:123-181). Everything here is plain
Python: hashable, frozen dataclasses that a checkpoint pickles.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

LIKELIHOODS = ("poisson", "normal")
PRIORS = ("truncnormal", "exponential", "gamma")
RANK_METHODS = ("SBFI", "BFI", "BIC")


class ModelError(ValueError):
    """Invalid model specification."""


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Model family and rank-learning configuration.

    Mirrors the (likelihood, prior, MH, rank_method, learning_rank) spec of
    the reference sampler (bayesNMF_sampler.R:146-165). ``N`` is the maximum
    rank; when ``learning_rank`` the effective rank is learned through the
    binary inclusion vector A.
    """

    K: int
    N: int
    G: int
    likelihood: str = "poisson"
    prior: str = "truncnormal"
    MH: bool = True
    learning_rank: bool = False
    rank_method: str = "SBFI"
    # True: exact non-conjugate Mu/Sigmasq conditionals, including the
    # TruncNormal normaliser Phi(mu/sigma) that the reference's conjugate
    # updates drop (sample_priors.R:214-270). False: the reference's
    # approximate updates.
    exact_truncnorm_hypers: bool = True
    # True: the exact Hastings ratio with the truncated-normal proposal
    # densities. False: the reference's ratio (MH_Pn_poisson,
    # sample_Pn.R:209-239), which substitutes the normal-model likelihood.
    exact_mh: bool = True
    # Run the P and E MH sweeps as one fused kernel per Gibbs iteration
    # (csrc/fused_sweeps.cu). Poisson + MH only.
    fused_sweeps: bool = False
    # Run the latent-count allocation as one kernel (conjugate Poisson
    # Gibbs, MH=False, only).
    fused_allocation: bool = False
    # Run the MH sweeps through the streaming reductions
    # (csrc/stream_sweeps.cu): Mhat is recomputed per G tile inside each
    # kernel and never held as a (chains, K, G) tensor. Poisson + exact MH
    # only; mutually exclusive with fused_sweeps.
    stream_sweeps: bool = False

    def __post_init__(self):
        if self.likelihood not in LIKELIHOODS:
            raise ModelError(f"likelihood must be one of {LIKELIHOODS}")
        if self.prior not in PRIORS:
            raise ModelError(f"prior must be one of {PRIORS}")
        if self.likelihood == "normal":
            if self.prior not in ("truncnormal", "exponential"):
                raise ModelError(
                    "prior must be 'truncnormal' or 'exponential' with "
                    "likelihood='normal'")
            if self.MH:
                raise ModelError(
                    "MH updates only apply to likelihood='poisson'")
        else:  # poisson
            if self.prior == "gamma" and self.MH:
                raise ModelError(
                    "gamma prior cannot be used in a MH-within-Gibbs sampler")
            if self.prior == "truncnormal" and not self.MH:
                raise ModelError(
                    "truncnormal prior can only be used in a MH-within-Gibbs "
                    "sampler (with likelihood='poisson')")
        if self.learning_rank and self.rank_method not in RANK_METHODS:
            raise ModelError(f"rank_method must be one of {RANK_METHODS}")
        if self.fused_sweeps and not (self.likelihood == "poisson"
                                      and self.MH):
            raise ModelError(
                "fused_sweeps applies to the poisson+MH sampler only")
        if self.fused_allocation and not (
                self.likelihood == "poisson" and not self.MH):
            raise ModelError(
                "fused_allocation applies to the conjugate poisson Gibbs "
                "sampler (MH=False) only")
        if self.stream_sweeps:
            if not (self.likelihood == "poisson" and self.MH
                    and self.exact_mh):
                raise ModelError(
                    "stream_sweeps applies to the poisson + exact-MH "
                    "sampler only")
            if self.fused_sweeps:
                raise ModelError(
                    "stream_sweeps and fused_sweeps are mutually exclusive "
                    "(resident vs streaming kernels)")
        if min(self.K, self.N, self.G) < 1:
            raise ModelError("K, N, G must be positive")

    @property
    def needs_Z(self) -> bool:
        """Latent Poisson counts: the conjugate Poisson path only."""
        return self.likelihood == "poisson" and not self.MH

    @property
    def needs_sigmasq(self) -> bool:
        return self.likelihood == "normal"


def default_MH(likelihood: str, prior: str) -> bool:
    """Reference default: MH on iff poisson with a truncnormal or
    exponential prior (bayesNMF.R:29)."""
    return likelihood == "poisson" and prior in ("truncnormal", "exponential")


@dataclasses.dataclass(frozen=True)
class ConvergenceControl:
    """Convergence criteria; defaults match new_convergence_control()
    (convergence.R:16-45).

    ``metric`` is one of 'loglikelihood', 'logposterior', 'RMSE', 'KL'.
    ``minA`` is accepted for API parity; the reference stores but never
    enforces it (convergence.R:24).
    """

    MAP_over: int = 1000
    MAP_every: int = 100
    tol: float = 0.001
    Ninarow_nochange: int = 5
    Ninarow_nobest: int = 10
    miniters: int = 1000
    maxiters: int = 5000
    minA: int = 0
    metric: str = "logposterior"

    def __post_init__(self):
        if self.metric not in ("loglikelihood", "logposterior", "RMSE",
                               "KL"):
            raise ModelError(
                "metric must be one of loglikelihood/logposterior/RMSE/KL")
        if self.miniters >= self.maxiters:
            object.__setattr__(self, "miniters", 0)


def default_hyperprior_params(spec: ModelSpec, data_mean: float) -> dict:
    """Scalar hyperprior defaults per prior family
    (get_default_*_hyperprior_params_, setup.R:123-181)."""
    N = spec.N
    if spec.prior == "truncnormal":
        s = math.sqrt(max(data_mean, 1e-12) / N)
        return {
            "m_p": 0.0, "s_p": s, "a_p": float(N + 1), "b_p": math.sqrt(N),
            "m_e": 0.0, "s_e": s, "a_e": float(N + 1), "b_e": math.sqrt(N),
        }
    if spec.prior == "exponential":
        a = 10.0 * math.sqrt(N)
        b = 10.0 * math.sqrt(max(data_mean, 1e-12))
        return {"a_p": a, "b_p": b, "a_e": a, "b_e": b}
    # gamma
    a = 10.0 * math.sqrt(N)
    c = 10.0 * math.sqrt(max(data_mean, 1e-12))
    return {
        "a_p": a, "b_p": 10.0, "c_p": c, "d_p": 10.0,
        "a_e": a, "b_e": 10.0, "c_e": c, "d_e": 10.0,
    }


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Run-level options mirroring bayesNMF()'s non-model arguments
    (bayesNMF.R:24-40)."""

    prop_temp: float = 0.2
    post_warmup: Optional[int] = None  # default 2*MAP_over, resolved at run
    output_dir: Optional[str] = None
    overwrite: bool = False
    verbosity: int = 1
    periodic_save: bool = True
    save_all_samples: bool = True
    seed: int = 0

    def resolved_post_warmup(self, cc: ConvergenceControl) -> int:
        return (self.post_warmup if self.post_warmup is not None
                else 2 * cc.MAP_over)
