"""Initial draws of the prior parameters and of P and E.

Port of the truncnormal subset of bayesnmf_tpu/models/updates.py
(init_prior_params :62-74, _prior_draw_P/_prior_draw_E :244-258). The
per-iteration updates live in the fused sweep (ops/fused_sweeps.py).
"""

from __future__ import annotations

import torch

from bayesnmf_tpu.config import ModelSpec

from ..ops import distributions as dist


def _full(hp, name, shape, device):
    """Hyperprior entry broadcast to ``shape`` as float32."""
    return torch.full(shape, float(hp[name]), dtype=torch.float32,
                      device=device)


def _require_truncnormal(spec: ModelSpec):
    if spec.prior != "truncnormal":
        raise NotImplementedError(
            f"the {spec.prior!r} prior is not ported yet (ROADMAP.md queue 1)")


def init_prior_params(spec: ModelSpec, hp: dict, gen: torch.Generator,
                      device) -> dict:
    """Draw Mu/Sigmasq for P and E from their hyperpriors
    (init_prior_params_, sample_priors.R:15-141)."""
    _require_truncnormal(spec)
    kn, ng = (spec.K, spec.N), (spec.N, spec.G)
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


def _prior_draw_P(spec: ModelSpec, prior: dict, gen: torch.Generator):
    """A full (K, N) P from the prior (sample_Pn.R:12-29)."""
    _require_truncnormal(spec)
    return dist.truncnorm_nonneg(gen, prior["Mu_p"], prior["Sigmasq_p"])


def _prior_draw_E(spec: ModelSpec, prior: dict, gen: torch.Generator):
    _require_truncnormal(spec)
    return dist.truncnorm_nonneg(gen, prior["Mu_e"], prior["Sigmasq_e"])
