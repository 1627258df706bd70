"""The synthetic catalogue every cell runs on, made from the seed.

Frozen copy of ``bayesnmf_tpu_torch/utils/measure.py::synthetic`` (the
recipe of chip_smoke.py's phase 4; phase 15 takes scale 8000 at 1536 rows):
P ~ Dirichlet(0.3) over the K mutation classes for each of ``rank`` true
signatures, E ~ Gamma(2, scale) exposures, M ~ Poisson(P E). The program
receives only M.
"""

from __future__ import annotations

import numpy as np


def synthetic(K: int, G: int, rank: int, seed: int, scale: float):
    """(M (K, G) float32 counts, P_true (K, rank)) of ``seed``."""
    rng = np.random.default_rng(seed)
    P_true = rng.dirichlet(np.ones(K) * 0.3, rank).T
    E_true = rng.gamma(2.0, scale, (rank, G))
    return rng.poisson(P_true @ E_true).astype(np.float32), P_true
