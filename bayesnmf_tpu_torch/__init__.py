"""bayesnmf_tpu_torch: the PyTorch/CUDA port of bayesnmf_tpu.

Bayesian NMF (M ~ Poisson or Normal around P diag(A) E) by Gibbs and
MH-within-Gibbs sampling, with the kernels hand-written for NVIDIA Hopper. The JAX package ``bayesnmf_tpu``
stays the reference; this package imports torch and never jax, and nothing
of the JAX package: it keeps its own copies of the configuration, logging
and postprocessing modules.

Everything the JAX package runs on one device is ported (ROADMAP.md): the
six model families (Poisson with the TruncNormal or exponential prior by
MH, through the fused sweep kernel or the eager sweeps, or with the
exponential or gamma prior by conjugate Gibbs through the allocation
kernel; the Normal likelihood with either of the first two priors on the
eager sweeps, which run as tensor ops as the JAX package runs them in XLA),
at a fixed rank or learning it by SBFI/BFI/BIC; ``ChainEnsemble``, C chains
of any of these models at once (at large G through the streaming sweep
kernels), with fixed per-chain inclusion masks, cross-chain diagnostics and
each chain's view with the single sampler's surface; ``fit(rank_method=
'BIC')`` over a rank list, as one masked ensemble or one sampler per rank;
``record_history='full'``, ``save_all_samples``, ``samples`` and
``posterior_summary`` on both; the postprocessing and the reference's
example data. Distributed runs (``mesh``) are not ported yet.
"""

from .config import (  # noqa: F401
    ConvergenceControl,
    ModelError,
    ModelSpec,
    RunConfig,
    default_hyperprior_params,
    default_MH,
)

__version__ = "0.2.0"

__all__ = [
    "ConvergenceControl", "ModelError", "ModelSpec", "RunConfig",
    "default_hyperprior_params", "default_MH", "new_convergence_control",
    "fit", "bayesNMF", "GibbsSampler", "ChainEnsemble", "get_cosmic",
    "download_cosmic", "get_cosmic_colors", "hungarian_assignment",
    "pairwise_sim", "summarize_samplers",
]


def new_convergence_control(**kw):
    """R-compatible alias of ConvergenceControl (convergence.R:16-45)."""
    return ConvergenceControl(**kw)


def __getattr__(name):
    # everything below is imported on first use, so `import
    # bayesnmf_tpu_torch` stays cheap and loads no CUDA code
    if name in ("fit", "GibbsSampler", "bayesNMF"):
        from .models import sampler

        return getattr(sampler, "fit" if name == "bayesNMF" else name)
    if name == "ChainEnsemble":
        from .parallel.ensemble import ChainEnsemble

        return ChainEnsemble
    if name in ("get_cosmic", "download_cosmic", "get_cosmic_colors"):
        from .utils import cosmic

        return getattr(cosmic, name)
    if name in ("hungarian_assignment", "pairwise_sim"):
        from .utils import assignment

        return (assignment.hungarian_assignment
                if name == "hungarian_assignment"
                else assignment.pairwise_cosine)
    if name == "summarize_samplers":
        from .utils.postprocessing import summarize_samplers

        return summarize_samplers
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
