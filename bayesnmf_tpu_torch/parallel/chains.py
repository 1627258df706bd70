"""Chain ensembles as one batched program: the chain axis is the leading
dimension of every state tensor.

Port of bayesnmf_tpu/parallel/chains.py:19-60. Where the JAX package vmaps
one chain's step, every call here updates all chains at once: the step of
the spec's path (models/gibbs.py ``stream_step``, the fused ``gibbs_step``,
``eager_step`` or ``conjugate_step``) with a leading chain axis C. Each
chain draws from its own counter-based stream (ops/rng.ChainStreams, keyed
by the run's seed and the chain's uid, as the JAX package's per-chain
keys); each step's noise is one chain-major draw, chain c's its own slice.
``make_sharded_chain_runner`` runs them on a (chain, g) mesh
(parallel/mesh.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ModelSpec
from ..models import gibbs
from ..ops import math as m
from ..ops.rng import ChainStreams
from ..utils import tracing
from . import mesh as M


def init_chain_states(spec: ModelSpec, hp: dict, data, gen, n_chains: int,
                      init_params=None, init_prior_params=None) -> dict:
    """Independent initial states of ``n_chains`` chains; ``gen`` their
    streams (ops/rng.ChainStreams of ``n_chains`` uids)."""
    return gibbs.init_state(spec, hp, data, gen, init_params,
                            init_prior_params, chains=n_chains)


def run_chunk_chains(spec: ModelSpec, data, hp: dict, states: dict, temps,
                     accept_all, store_E: bool = True, record: str = "basic"):
    """Run ``len(temps)`` iterations of every chain on the spec's path.

    ``accept_all`` is a (C,) bool tensor on the device: chains leave the
    accept-all warmup at different iterations. Returns (states, samples)
    with samples['metrics'] (C, steps, N_METRICS) and the per-iteration
    P (C, steps, K, N), A (C, steps, N) and, with ``store_E``, E
    (C, steps, N, G); with ``record='full'`` also the prior parameters (a
    dict under "prior"), sigmasq and acc_P/acc_E, each (C, steps, ...). The
    buffers are allocated once a chunk on the device; each step writes its
    metrics rows into its slot of the buffer.
    """
    steps = len(temps)
    C = states["params"]["P"].shape[0]
    dev = data.device
    consts = m.metric_constants(spec.likelihood, data,
                                M.mesh_of(states["gen"]))
    step_consts = (gibbs.step_constants(spec, hp, dev, C)
                   if spec.fused_sweeps else None)
    metrics = torch.empty(C, steps, gibbs.N_METRICS, dtype=torch.float32,
                          device=dev)
    out = None
    # the chunk's temperatures go to the device once; each step indexes them
    temps = torch.as_tensor(np.asarray(temps, np.float32), device=dev)
    for i in range(steps):
        # the span encloses the module attribute's call, so that a wrapper
        # put around gibbs.gibbs_step runs inside it
        with tracing.span("chains.step"):
            states, sample = gibbs.gibbs_step(
                spec, data, hp, states, temps[i], accept_all, consts,
                consts=step_consts, metrics_out=metrics[:, i], record=record)
        with tracing.span("chains.record"):
            sample = {k: v for k, v in sample.items()
                      if k != "metrics" and (store_E or k != "E")}
            if out is None:
                out = gibbs.record_buffers(sample, steps, 1)
            gibbs.write_record(out, sample, i, 1)
    return states, out | {"metrics": metrics}


def make_sharded_chain_runner(spec: ModelSpec, mesh, n_chains: int,
                              record: str = "basic", store_E: bool = True):
    """A chunk runner whose chains and G columns are split over ``mesh``
    (the counterpart of the JAX package's chains.py:63-93). Returns
    (init_fn, run_fn):

      init_fn(hp, data, seed) -> this rank's block of the initial states of
        ``n_chains`` chains (``data`` the full (K, G) matrix; every rank
        builds the one-process states and keeps its block) with its block
        of the chains' streams;
      run_fn(data, hp, states, temps, accept_all) -> (states, samples),
        ``data`` this rank's columns (multihost.shard_data), ``accept_all``
        the (n_chains,) flags of every chain; the records are this rank's
        block (mesh.sample_out_layout).

    Only the eager and conjugate paths partition over G: the spec must not
    select the fused or streaming kernels."""
    from ..models.gibbs import FUSED_MESH_ERROR, STREAM_MESH_ERROR

    if spec.fused_sweeps:
        raise ValueError(FUSED_MESH_ERROR)
    if spec.stream_sweeps:
        raise ValueError(STREAM_MESH_ERROR)
    layout = M.state_layout(spec, chains=True)

    def init_fn(hp, data, seed: int = 0):
        full = torch.as_tensor(np.asarray(data, np.float32),
                               device=mesh.device)
        gen = ChainStreams(seed, np.arange(n_chains), device=mesh.device)
        states = init_chain_states(spec, hp, full, gen, n_chains)
        out = M.local(states, layout, mesh, spec.G)
        out["gen"] = states["gen"].block(mesh, spec.G)
        return out

    def run_fn(data, hp, states, temps, accept_all):
        gen = states["gen"]
        acc = torch.as_tensor(accept_all, device=mesh.device)[gen.c0:gen.c1]
        return run_chunk_chains(spec, data, hp, states, temps, acc,
                                store_E=store_E, record=record)

    return init_fn, run_fn
