"""Carry sampler state between the JAX package and the port.

The JAX state is a dict ``{params: {P, E, A, R[, Zsum_g, Zsum_k][,
sigmasq]}, prior: {Mu_p, Sigmasq_p, Mu_e, Sigmasq_e}, {Lambda_p,
Lambda_e} or {Alpha_p, Beta_p, Alpha_e, Beta_e}[, Alpha_sig,
Beta_sig][, acc_P, acc_E], iter, key}`` of device
arrays (the latent-count sums on the conjugate path, sigmasq and its prior
with the Normal likelihood, the acceptance records with MH); read each with
``np.asarray``. The port's
state has the same keys, with tensors on one device, ``iter`` as a Python
int, and a ``torch.Generator`` under ``gen`` in place of the threefry key
(the two generators never give the same numbers, so the key is not carried
over).
"""

from __future__ import annotations

import numpy as np
import torch

PARAM_KEYS = ("P", "E", "A", "R", "Zsum_g", "Zsum_k", "sigmasq")
PRIOR_KEYS = ("Mu_p", "Sigmasq_p", "Mu_e", "Sigmasq_e", "Lambda_p",
              "Lambda_e", "Alpha_p", "Beta_p", "Alpha_e", "Beta_e",
              "Alpha_sig", "Beta_sig")
ACC_KEYS = ("acc_P", "acc_E")


def state_from_numpy(d: dict, device, seed: int = 0) -> dict:
    """The port's state from a JAX-layout state dict (numpy or jax arrays);
    the entries present among PARAM_KEYS, PRIOR_KEYS and ACC_KEYS are
    carried over. The new generator on ``device`` is seeded with ``seed``."""
    def t(x, dtype=np.float32):
        return torch.as_tensor(np.array(x, dtype), device=device)

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    state = {
        "params": {k: t(d["params"][k], np.int32 if k == "R" else np.float32)
                   for k in PARAM_KEYS if k in d["params"]},
        "prior": {k: t(d["prior"][k]) for k in PRIOR_KEYS if k in d["prior"]},
        "iter": int(np.asarray(d["iter"])),
        "gen": gen,
    }
    state |= {k: t(d[k]) for k in ACC_KEYS if k in d}
    return state


def state_to_numpy(state: dict) -> dict:
    """The JAX layout (without the key) as numpy arrays on the host."""
    n = lambda x: x.detach().cpu().numpy()  # noqa: E731
    out = {
        "params": {k: n(v) for k, v in state["params"].items()},
        "prior": {k: n(v) for k, v in state["prior"].items()},
        "iter": np.int32(state["iter"]),
    }
    out |= {k: n(state[k]) for k in ACC_KEYS if k in state}
    return out
