"""Chain ensembles as one batched program: the chain axis is the leading
dimension of every state tensor.

Port of bayesnmf_tpu/parallel/chains.py:19-60. Where the JAX package vmaps
one chain's step, every call here updates all chains at once
(models/gibbs.py ``stream_step``); the chains share one ``torch.Generator``
and draw independent noise from it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ModelSpec
from ..models import gibbs
from ..ops import math as m


def init_chain_states(spec: ModelSpec, hp: dict, data, gen: torch.Generator,
                      n_chains: int, init_params=None,
                      init_prior_params=None) -> dict:
    """Independent initial states of ``n_chains`` chains."""
    return gibbs.init_state(spec, hp, data, gen, init_params,
                            init_prior_params, chains=n_chains)


def run_chunk_chains(spec: ModelSpec, data, hp: dict, states: dict, temps,
                     accept_all, store_E: bool = True):
    """Run ``len(temps)`` iterations of every chain.

    ``accept_all`` is a (C,) bool tensor on the device: chains leave the
    accept-all warmup at different iterations. Returns (states, samples)
    with samples['metrics'] (C, steps, N_METRICS) and the per-iteration
    P (C, steps, K, N), A (C, steps, N) and, with ``store_E``, E
    (C, steps, N, G), in buffers allocated once on the device.
    """
    steps = len(temps)
    C = states["params"]["P"].shape[0]
    f32 = dict(dtype=torch.float32, device=data.device)
    consts = m.metric_constants(spec.likelihood, data)
    out = {"metrics": torch.empty(C, steps, gibbs.N_METRICS, **f32),
           "P": torch.empty(C, steps, spec.K, spec.N, **f32),
           "A": torch.empty(C, steps, spec.N, **f32)}
    if store_E:
        out["E"] = torch.empty(C, steps, spec.N, spec.G, **f32)
    for i, temp in enumerate(np.asarray(temps, np.float32).tolist()):
        # the metrics row is written into its slot of the buffer directly
        states, sample = gibbs.stream_step(spec, data, hp, states, temp,
                                           accept_all, consts,
                                           metrics_out=out["metrics"][:, i])
        for k, buf in out.items():
            if k != "metrics":
                buf[:, i] = sample[k]
    return states, out
