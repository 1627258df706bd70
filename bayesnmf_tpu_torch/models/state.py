"""Carry sampler state between the JAX package and the port.

The JAX state is a dict ``{params: {P, E, A, R}, prior: {Mu_p, Sigmasq_p,
Mu_e, Sigmasq_e}, acc_P, acc_E, iter, key}`` of device arrays; read each
with ``np.asarray``. The port's state has the same keys, with tensors on one
device, ``iter`` as a Python int, and a ``torch.Generator`` under ``gen`` in
place of the threefry key (the two generators never give the same numbers,
so the key is not carried over).
"""

from __future__ import annotations

import numpy as np
import torch

PARAM_KEYS = ("P", "E", "A", "R")
PRIOR_KEYS = ("Mu_p", "Sigmasq_p", "Mu_e", "Sigmasq_e")


def state_from_numpy(d: dict, device, seed: int = 0) -> dict:
    """The port's state from a JAX-layout state dict (numpy or jax arrays).
    The new generator on ``device`` is seeded with ``seed``."""
    def t(x, dtype=np.float32):
        return torch.as_tensor(np.array(x, dtype), device=device)

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return {
        "params": {k: t(d["params"][k], np.int32 if k == "R" else np.float32)
                   for k in PARAM_KEYS},
        "prior": {k: t(d["prior"][k]) for k in PRIOR_KEYS},
        "acc_P": t(d["acc_P"]),
        "acc_E": t(d["acc_E"]),
        "iter": int(np.asarray(d["iter"])),
        "gen": gen,
    }


def state_to_numpy(state: dict) -> dict:
    """The JAX layout (without the key) as numpy arrays on the host."""
    n = lambda x: x.detach().cpu().numpy()  # noqa: E731
    return {
        "params": {k: n(state["params"][k]) for k in PARAM_KEYS},
        "prior": {k: n(state["prior"][k]) for k in PRIOR_KEYS},
        "acc_P": n(state["acc_P"]),
        "acc_E": n(state["acc_E"]),
        "iter": np.int32(state["iter"]),
    }
