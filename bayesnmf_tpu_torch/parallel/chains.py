"""Chain ensembles as one batched program: the chain axis is the leading
dimension of every state tensor.

Port of bayesnmf_tpu/parallel/chains.py:19-60. Where the JAX package vmaps
one chain's step, every call here updates all chains at once: the step of
the spec's path (models/gibbs.py ``stream_step``, the fused ``gibbs_step``,
``eager_step`` or ``conjugate_step``) with a leading chain axis C. The
chains share one ``torch.Generator``; each step's noise is one chain-major
draw, chain c's its own slice.
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
    """Run ``len(temps)`` iterations of every chain on the spec's path.

    ``accept_all`` is a (C,) bool tensor on the device: chains leave the
    accept-all warmup at different iterations. Returns (states, samples)
    with samples['metrics'] (C, steps, N_METRICS) and the per-iteration
    P (C, steps, K, N), A (C, steps, N) and, with ``store_E``, E
    (C, steps, N, G), in buffers allocated once on the device; each step
    writes its metrics rows into its slot of the buffer.
    """
    steps = len(temps)
    C = states["params"]["P"].shape[0]
    dev = data.device
    f32 = dict(dtype=torch.float32, device=dev)
    consts = m.metric_constants(spec.likelihood, data)
    step_consts = (gibbs.step_constants(spec, hp, dev, C)
                   if spec.fused_sweeps else None)
    out = {"metrics": torch.empty(C, steps, gibbs.N_METRICS, **f32),
           "P": torch.empty(C, steps, spec.K, spec.N, **f32),
           "A": torch.empty(C, steps, spec.N, **f32)}
    if store_E:
        out["E"] = torch.empty(C, steps, spec.N, spec.G, **f32)
    # the chunk's temperatures go to the device once; each step indexes them
    temps = torch.as_tensor(np.asarray(temps, np.float32), device=dev)
    for i in range(steps):
        states, sample = gibbs.gibbs_step(
            spec, data, hp, states, temps[i], accept_all, consts,
            consts=step_consts, metrics_out=out["metrics"][:, i])
        for k, buf in out.items():
            if k != "metrics":
                buf[:, i] = sample[k]
    return states, out
