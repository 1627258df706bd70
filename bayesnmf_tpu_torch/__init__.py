"""bayesnmf_tpu_torch: the PyTorch/CUDA port of bayesnmf_tpu.

Bayesian NMF (M ~ Poisson(P diag(A) E)) by MH-within-Gibbs sampling, with the
sweep kernel hand-written for NVIDIA Hopper. The JAX package ``bayesnmf_tpu``
stays the reference; this package imports torch and never jax. Its jax-free
configuration module is shared, not copied.

Ported so far (ROADMAP.md): one chain of the default model at a fixed rank —
Poisson likelihood, TruncNormal prior, exact MH, exact TruncNormal hypers.
"""

from bayesnmf_tpu.config import (  # noqa: F401
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
]


def __getattr__(name):
    # the sampler is imported on first use, so `import bayesnmf_tpu_torch`
    # stays cheap and loads no CUDA code
    if name in ("fit", "GibbsSampler"):
        from .models import sampler

        return getattr(sampler, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
