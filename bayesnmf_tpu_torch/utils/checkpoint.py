"""Checkpoint and resume of the port's sampler and chain ensemble.

Port of bayesnmf_tpu/utils/checkpoint.py:23-168. A checkpoint holds the
state (for one chain in the JAX package's layout, models/state.py), the
chains' streams (ops/rng.ChainStreams.state: the seed, the iteration and
the chains' uids), the convergence tracker, the metric history, the
recording flag, the sample window and the archive (save_all_samples), all
as host numpy, so the chains continue bit-exactly from where they
stopped. A checkpoint pickles this package's classes
(``bayesnmf_tpu_torch.config.ModelSpec`` among them).

A checkpoint does not record a mesh (parallel/mesh.py): on a mesh every
rank takes part in gathering the state and the root rank writes the
one-process format; ``load_*(path, mesh=...)`` has every rank read the
file and keep its block, streams included. The streams are the same
function of (seed, uid, iteration, site, element) on the CPU and on a
card, so a checkpoint resumes the same draws on either device type
(``device=``). A checkpoint written before the streams, which holds a
``torch.Generator`` state (``gen_state``) instead, loads with the state,
records and trackers exact and the streams restarted from
``restart_seed(seed, iteration)``, and the log says so.
"""

from __future__ import annotations

import collections
import pickle

import numpy as np
import torch

from . import tracing
from .logging import RunLogger

from ..models.convergence import ConvergenceTracker
from ..models.sampler import host_tree
from ..models.state import state_from_numpy, state_to_numpy
from ..ops.rng import ChainStreams
from ..parallel import mesh as Mesh


def _device_chunk(chunk: dict, device) -> dict:
    """A saved window chunk back on ``device``: every array (the prior
    parameters' nested dict too) but its start iteration and chain ids."""
    def to(v):
        if isinstance(v, dict):
            return {k: to(x) for k, x in v.items()}
        return torch.as_tensor(np.asarray(v), device=device)

    return {k: (v if k in ("start_iter", "chain_ids") else to(v))
            for k, v in chunk.items()}


def restart_seed(seed: int, it: int) -> int:
    """The seed of the streams restarted at iteration ``it`` of a run
    seeded ``seed`` (a checkpoint written before the streams)."""
    return (int(seed) * 1_000_003 + int(it)) % (2 ** 63)


def _streams(p: dict, device: torch.device, seed: int, uids,
             logger: RunLogger) -> ChainStreams:
    """The run's streams on ``device``: the saved ones; from a checkpoint
    written before the streams (``gen_state``), streams of ``uids``
    restarted from (seed, iteration)."""
    if "streams" in p:
        return ChainStreams.from_state(p["streams"], device)
    it = p["iter"]
    logger.log(f"resumed on {device} from a checkpoint that holds a "
               f"generator state, not the chains' streams: the state "
               f"carries over exactly; the streams restart at iteration "
               f"{it} with seed {restart_seed(seed, it)}", 0)
    return ChainStreams(restart_seed(seed, it), uids, it, device)


def _target_device(saved: str, device, mesh) -> torch.device:
    from ..models.sampler import resolve_device

    if mesh is not None:
        return resolve_device(device or mesh.device.type, mesh)
    return resolve_device(device or saved)


def save_sampler(sampler, path: str):
    """Checkpoint a GibbsSampler; on a mesh every rank calls it (the state
    is gathered) and the root rank writes."""
    mesh = getattr(sampler, "mesh", None)
    state = sampler.state
    if mesh is not None:
        state = Mesh.gather(state, Mesh.state_layout(sampler.spec,
                                                     chains=False),
                            mesh, sampler.spec.G)
        if not mesh.is_root:
            return
    payload = {
        "version": 1,
        "spec": sampler.spec,
        "cc": sampler.cc,
        "run_cfg": sampler.run_cfg,
        "rank": sampler.rank,
        "post_warmup": sampler.post_warmup,
        "temp_sched": sampler.temp_sched,
        "hyperprior_params": dict(sampler.hyperprior_params),
        "data": sampler._data_np,
        "device": str(sampler.device),
        "state": state_to_numpy(state),
        "streams": sampler.state["gen"].state(),
        "iter": sampler.iter,
        "tracker": sampler.tracker.to_dict(),
        "time": sampler.time,
        "MAP_metrics": sampler.MAP_metrics,
        "metric_rows": sampler._metric_rows,
        "record": sampler.record,
        "window": [host_tree(c) for c in sampler._window],
        "archive": sampler._archive,
        "MAP": sampler.MAP,
        "output_dir": sampler.output_dir,
        "row_names": sampler.row_names,
        "col_names": sampler.col_names,
    }
    with open(path, "wb") as fh:
        pickle.dump(payload, fh, protocol=4)


def load_sampler(cls, path: str, mesh=None, device=None):
    """Rebuild a sampler from ``path`` on the device it was saved from, on
    ``device``, or split over ``mesh`` (see the module's docstring). Load
    only checkpoints this program wrote: unpickling runs code."""
    with open(path, "rb") as fh:
        p = pickle.load(fh)
    obj = cls.__new__(cls)
    obj.device = _target_device(p["device"], device, mesh)
    obj.mesh = mesh
    obj.spec = p["spec"]
    obj.cc = p["cc"]
    obj.run_cfg = p["run_cfg"]
    obj.rank = p["rank"]
    obj.post_warmup = p["post_warmup"]
    obj.temp_sched = p["temp_sched"]
    obj.hyperprior_params = p["hyperprior_params"]
    obj._data_np = p["data"]
    obj.data = torch.as_tensor(p["data"], device=obj.device)
    obj.state = state_from_numpy(p["state"], obj.device)
    obj.output_dir = p["output_dir"]
    # resumed runs keep logging to the original output dir (append)
    obj.logger = RunLogger(obj.output_dir, obj.run_cfg.verbosity, mode="a",
                           mesh=mesh)
    gen = _streams(p, obj.device, obj.run_cfg.seed, [0], obj.logger)
    if mesh is not None:
        G = obj.spec.G
        obj.data = Mesh.local(obj.data, (None, Mesh.G_AXIS), mesh, G)
        obj.state = Mesh.local(obj.state, Mesh.state_layout(
            obj.spec, chains=False), mesh, G)
        gen = gen.block(mesh, G, split_chains=False)
    obj.state["gen"] = gen
    obj.iter = p["iter"]
    obj.tracker = ConvergenceTracker(obj.cc)
    obj.tracker.restore(p["tracker"])
    obj.time = p["time"]
    obj.MAP_metrics = p["MAP_metrics"]
    obj._metric_rows = p["metric_rows"]
    window_chunks = -(-obj.cc.MAP_over // obj.cc.MAP_every) + 1
    obj.record = p.get("record", "basic")
    obj._window = collections.deque(
        (_device_chunk(c, obj.device) for c in p["window"]),
        maxlen=window_chunks)
    obj._archive = p["archive"]
    obj.MAP = p["MAP"]
    obj.credible_intervals = (
        obj.MAP.get("credible_intervals") if obj.MAP else None)
    obj.reference_comparison = {}
    obj.row_names = p["row_names"]
    obj.col_names = p["col_names"]
    return obj


def _chain_state_to_numpy(states: dict) -> dict:
    """The chain-batched state without its streams, as host numpy: every
    tensor (the acceptance records only with MH), and the iteration."""
    n = lambda x: x.detach().cpu().numpy()  # noqa: E731
    out = {"params": {k: n(v) for k, v in states["params"].items()},
           "prior": {k: n(v) for k, v in states["prior"].items()},
           "iter": states["iter"]}
    return out | {k: n(states[k]) for k in ("acc_P", "acc_E") if k in states}


def save_ensemble(ens, path: str):
    """Checkpoint a ChainEnsemble (checkpoint.py:55-102): the chain-batched
    device state and the chains' streams, the trackers, the retained
    sample window, the archive, the recording flag, the metric history, the
    finalised chains and the per-chain inclusion masks, all as host numpy
    (checkpoint.py:55-102); the spec names the path
    (fused, eager, conjugate or streaming). Every chain continues
    bit-exactly. On a mesh every rank calls it (the state is gathered) and
    the root rank writes."""
    mesh = getattr(ens, "mesh", None)
    states = ens.states
    if mesh is not None:
        states = Mesh.gather(states, Mesh.state_layout(ens.spec, chains=True),
                             mesh, ens.spec.G)
        if not mesh.is_root:
            return
    payload = {
        "version": 1,
        "kind": "ensemble",
        "spec": ens.spec,
        "cc": ens.cc,
        "n_chains": ens.n_chains,
        "post_warmup": ens.post_warmup,
        "store_E": ens.store_E,
        "seed": ens.seed,
        "periodic_save": ens.periodic_save,
        "want_ci": ens.want_ci,
        "compact": ens.compact,
        "temp_sched": ens.temp_sched,
        "hp": dict(ens.hp),
        "data": ens._data_np,
        "device": str(ens.device),
        "states": _chain_state_to_numpy(states),
        "streams": ens.states["gen"].state(),
        "iter": ens.iter,
        "tracker_vec": ens.tracker.to_dict(),
        "end_iter": ens._end_iter,
        "slots": ens._slots,
        "record": ens.record,
        "window": [host_tree(c) for c in ens._window],
        "archive": ens._archive,
        "metric_rows": ens._metric_rows,
        "final_windows": ens._final_windows,
        "final_metrics": ens._final_metrics,
        "MAP_per_chain": ens.MAP_per_chain,
        "MAP_metrics_per_chain": ens._MAP_metrics_per_chain,
        "chain_iters": ens._chain_iters,
        "time": ens.time,
        "output_dir": ens.output_dir,
        "row_names": ens.row_names,
        "col_names": ens.col_names,
        "A_masks": ens.A_masks,
    }
    with tracing.span("checkpoint.write"), open(path, "wb") as fh:
        pickle.dump(payload, fh, protocol=4)


def load_ensemble(cls, path: str, mesh=None, device=None):
    """Rebuild a ChainEnsemble from ``path`` on the device it was saved
    from, on ``device``, or split over ``mesh`` (see the module's
    docstring). Load only checkpoints this program wrote: unpickling runs
    code."""
    from ..models.convergence import VectorConvergenceTracker

    with open(path, "rb") as fh:
        p = pickle.load(fh)
    obj = cls.__new__(cls)
    obj.device = dev = _target_device(p["device"], device, mesh)
    obj.mesh = mesh
    for k in ("spec", "cc", "n_chains", "post_warmup", "store_E", "seed",
              "periodic_save", "want_ci", "compact", "temp_sched", "hp",
              "iter", "time", "output_dir", "row_names", "col_names",
              "MAP_per_chain", "A_masks"):
        setattr(obj, k, p[k])
    obj.record = p.get("record", "basic")
    obj._archive = p.get("archive")
    obj._data_np = p["data"]
    obj._full_data = None
    obj.data = torch.as_tensor(p["data"], device=dev)
    st = p["states"]
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    # resumed runs keep logging to the original output dir (append)
    obj.logger = RunLogger(obj.output_dir, 1, mode="a", mesh=mesh)
    gen = _streams(p, dev, obj.seed, p["slots"], obj.logger)
    obj.states = {"params": {k: t(v) for k, v in st["params"].items()},
                  "prior": {k: t(v) for k, v in st["prior"].items()},
                  "iter": st["iter"]}
    obj.states |= {k: t(st[k]) for k in ("acc_P", "acc_E") if k in st}
    if mesh is not None:
        G = obj.spec.G
        obj.data = Mesh.local(obj.data, (None, Mesh.G_AXIS), mesh, G)
        obj.states = Mesh.local(obj.states, Mesh.state_layout(
            obj.spec, chains=True), mesh, G)
        gen = gen.block(mesh, G)
    obj.states["gen"] = gen
    obj.tracker = VectorConvergenceTracker(obj.cc, obj.n_chains)
    obj.tracker.restore(p["tracker_vec"])
    obj._end_iter = p["end_iter"]
    obj._slots = p["slots"]
    obj._window = [_device_chunk(c, dev) for c in p["window"]]
    obj._metric_rows = p["metric_rows"]
    obj._final_windows = p["final_windows"]
    obj._final_metrics = p["final_metrics"]
    obj._MAP_metrics_per_chain = p["MAP_metrics_per_chain"]
    obj._chain_iters = p["chain_iters"]
    obj._reference_comparisons = {}
    return obj
