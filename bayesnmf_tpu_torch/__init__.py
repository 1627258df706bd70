"""bayesnmf_tpu_torch: the PyTorch/CUDA port of bayesnmf_tpu.

Bayesian NMF (M ~ Poisson or Normal around P diag(A) E) by Gibbs and
MH-within-Gibbs sampling, with the kernels hand-written for NVIDIA Hopper. The JAX package ``bayesnmf_tpu``
stays the reference; this package imports torch and never jax, and nothing
of the JAX package: it keeps its own copies of the configuration, logging
and postprocessing modules.

Ported so far (ROADMAP.md): one chain of the Poisson sampler with the
TruncNormal or exponential prior, MH at a fixed rank or with SBFI/BFI rank
learning, through the fused sweep kernel (or, with ``fused_sweeps=False``,
the eager sweeps); one chain of the Normal likelihood with either prior
through the eager sweeps, which run as tensor ops as the JAX package runs
them in XLA; conjugate Poisson-Gibbs (MH=False, exponential prior) through
the allocation kernel; and ``ChainEnsemble``, C chains of the TruncNormal
model with SBFI/BFI rank learning, through the streaming sweep kernels.
"""

from .config import (  # noqa: F401
    ConvergenceControl,
    ModelError,
    ModelSpec,
    RunConfig,
    default_hyperprior_params,
    default_MH,
)

__all__ = [
    "ConvergenceControl", "ModelError", "ModelSpec", "RunConfig",
    "default_hyperprior_params", "default_MH", "fit", "GibbsSampler",
    "ChainEnsemble",
]


def __getattr__(name):
    # the samplers are imported on first use, so `import bayesnmf_tpu_torch`
    # stays cheap and loads no CUDA code
    if name in ("fit", "GibbsSampler"):
        from .models import sampler

        return getattr(sampler, name)
    if name == "ChainEnsemble":
        from .parallel.ensemble import ChainEnsemble

        return ChainEnsemble
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
