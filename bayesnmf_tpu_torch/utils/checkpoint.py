"""Checkpoint and resume of the port's sampler.

Port of save_sampler/load_sampler from bayesnmf_tpu/utils/checkpoint.py. A
checkpoint holds the state in the JAX package's layout (models/state.py),
the generator's state, the convergence tracker, the metric history and the
sample window, all as host numpy, so the chain continues bit-exactly from
where it stopped.
"""

from __future__ import annotations

import collections
import pickle

import numpy as np
import torch

from bayesnmf_tpu.utils.logging import RunLogger

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
