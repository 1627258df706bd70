"""Checkpoint and resume of the port's sampler and chain ensemble.

Port of bayesnmf_tpu/utils/checkpoint.py:23-168. A checkpoint holds the
state (for one chain in the JAX package's layout, models/state.py), the
generator's state, the convergence tracker, the metric history and the
sample window, all as host numpy, so the chains continue bit-exactly from
where they stopped. A checkpoint pickles this package's classes
(``bayesnmf_tpu_torch.config.ModelSpec`` among them).
"""

from __future__ import annotations

import collections
import pickle

import numpy as np
import torch

from .logging import RunLogger

from ..models.convergence import ConvergenceTracker
from ..models.state import state_from_numpy, state_to_numpy


def _host_chunk(chunk: dict) -> dict:
    return {k: (v if k == "start_iter" else
                (v.cpu().numpy() if isinstance(v, torch.Tensor) else v))
            for k, v in chunk.items()}


def save_sampler(sampler, path: str):
    payload = {
        "version": 1,
        "spec": sampler.spec,
        "cc": sampler.cc,
        "run_cfg": sampler.run_cfg,
        "rank": sampler.rank,
        "post_warmup": sampler.post_warmup,
        "temp_sched": sampler.temp_sched,
        "hyperprior_params": dict(sampler.hyperprior_params),
        "data": sampler.data.cpu().numpy(),
        "device": str(sampler.device),
        "state": state_to_numpy(sampler.state),
        "gen_state": sampler.state["gen"].get_state().numpy(),
        "iter": sampler.iter,
        "tracker": sampler.tracker.to_dict(),
        "time": sampler.time,
        "MAP_metrics": sampler.MAP_metrics,
        "metric_rows": sampler._metric_rows,
        "window": [_host_chunk(c) for c in sampler._window],
        "archive": sampler._archive,
        "MAP": sampler.MAP,
        "output_dir": sampler.output_dir,
        "row_names": sampler.row_names,
        "col_names": sampler.col_names,
    }
    with open(path, "wb") as fh:
        pickle.dump(payload, fh, protocol=4)


def load_sampler(cls, path: str):
    """Rebuild a sampler from ``path`` on the device it was saved from (the
    generator state belongs to that device). Load only checkpoints this
    program wrote: unpickling runs code."""
    from ..models.sampler import resolve_device

    with open(path, "rb") as fh:
        p = pickle.load(fh)
    obj = cls.__new__(cls)
    obj.device = resolve_device(p["device"])
    obj.spec = p["spec"]
    obj.cc = p["cc"]
    obj.run_cfg = p["run_cfg"]
    obj.rank = p["rank"]
    obj.post_warmup = p["post_warmup"]
    obj.temp_sched = p["temp_sched"]
    obj.hyperprior_params = p["hyperprior_params"]
    obj.data = torch.as_tensor(p["data"], device=obj.device)
    obj.state = state_from_numpy(p["state"], obj.device)
    obj.state["gen"].set_state(torch.from_numpy(p["gen_state"]))
    obj.iter = p["iter"]
    obj.tracker = ConvergenceTracker(obj.cc)
    obj.tracker.restore(p["tracker"])
    obj.time = p["time"]
    obj.MAP_metrics = p["MAP_metrics"]
    obj._metric_rows = p["metric_rows"]
    window_chunks = -(-obj.cc.MAP_over // obj.cc.MAP_every) + 1
    obj._window = collections.deque(
        ({k: (v if k == "start_iter" else
              torch.as_tensor(np.asarray(v), device=obj.device))
          for k, v in c.items()} for c in p["window"]),
        maxlen=window_chunks)
    obj._archive = p["archive"]
    obj.MAP = p["MAP"]
    obj.credible_intervals = (
        obj.MAP.get("credible_intervals") if obj.MAP else None)
    obj.output_dir = p["output_dir"]
    # resumed runs keep logging to the original output dir (append)
    obj.logger = RunLogger(obj.output_dir, obj.run_cfg.verbosity, mode="a")
    obj.reference_comparison = {}
    obj.row_names = p["row_names"]
    obj.col_names = p["col_names"]
    return obj


def _chain_state_to_numpy(states: dict) -> dict:
    """The chain-batched state without its generator, as host numpy: every
    tensor (the acceptance records only with MH), and the iteration."""
    n = lambda x: x.detach().cpu().numpy()  # noqa: E731
    out = {"params": {k: n(v) for k, v in states["params"].items()},
           "prior": {k: n(v) for k, v in states["prior"].items()},
           "iter": states["iter"]}
    return out | {k: n(states[k]) for k in ("acc_P", "acc_E") if k in states}


def save_ensemble(ens, path: str):
    """Checkpoint a ChainEnsemble (checkpoint.py:55-102): the chain-batched
    device state and the generator's state, the trackers, the retained
    sample window, the metric history, the finalised chains and the
    per-chain inclusion masks, all as host numpy; the spec names the path
    (fused, eager, conjugate or streaming). Every chain continues
    bit-exactly."""
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
        "states": _chain_state_to_numpy(ens.states),
        "gen_state": ens.states["gen"].get_state().numpy(),
        "iter": ens.iter,
        "tracker_vec": ens.tracker.to_dict(),
        "end_iter": ens._end_iter,
        "slots": ens._slots,
        "window": [_host_chunk(c) for c in ens._window],
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
    with open(path, "wb") as fh:
        pickle.dump(payload, fh, protocol=4)


def load_ensemble(cls, path: str):
    """Rebuild a ChainEnsemble from ``path`` on the device it was saved
    from. Load only checkpoints this program wrote: unpickling runs code."""
    from ..models.convergence import VectorConvergenceTracker
    from ..models.sampler import resolve_device

    with open(path, "rb") as fh:
        p = pickle.load(fh)
    obj = cls.__new__(cls)
    obj.device = dev = resolve_device(p["device"])
    for k in ("spec", "cc", "n_chains", "post_warmup", "store_E", "seed",
              "periodic_save", "want_ci", "compact", "temp_sched", "hp",
              "iter", "time", "output_dir", "row_names", "col_names",
              "MAP_per_chain", "A_masks"):
        setattr(obj, k, p[k])
    obj._data_np = p["data"]
    obj.data = torch.as_tensor(p["data"], device=dev)
    st = p["states"]
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    gen = torch.Generator(device=dev)
    gen.set_state(torch.from_numpy(p["gen_state"]))
    obj.states = {"params": {k: t(v) for k, v in st["params"].items()},
                  "prior": {k: t(v) for k, v in st["prior"].items()},
                  "iter": st["iter"], "gen": gen}
    obj.states |= {k: t(st[k]) for k in ("acc_P", "acc_E") if k in st}
    obj.tracker = VectorConvergenceTracker(obj.cc, obj.n_chains)
    obj.tracker.restore(p["tracker_vec"])
    obj._end_iter = p["end_iter"]
    obj._slots = p["slots"]
    obj._window = [{k: (v if k in ("start_iter", "chain_ids") else t(v))
                    for k, v in c.items()} for c in p["window"]]
    obj._metric_rows = p["metric_rows"]
    obj._final_windows = p["final_windows"]
    obj._final_metrics = p["final_metrics"]
    obj._MAP_metrics_per_chain = p["MAP_metrics_per_chain"]
    obj._chain_iters = p["chain_iters"]
    obj._reference_comparisons = {}
    # resumed runs keep logging to the original output dir (append)
    obj.logger = RunLogger(obj.output_dir, 1, mode="a")
    return obj
