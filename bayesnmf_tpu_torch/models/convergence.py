"""Host-side convergence trackers.

Port of bayesnmf_tpu/models/convergence.py (parity: check_convergence_,
convergence.R:60-154): ``ConvergenceTracker`` for one chain and
``VectorConvergenceTracker`` for an ensemble, with one numpy slot per chain.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from ..config import ConvergenceControl


@dataclasses.dataclass
class ConvergenceTracker:
    cc: ConvergenceControl
    prev_metric: Optional[float] = None
    best_metric: float = math.inf
    best_iter: int = 0
    inarow_no_change: int = 0
    inarow_no_best: int = 0
    inarow_na: int = 0
    converged: bool = False
    converged_iter: Optional[int] = None
    why: Optional[str] = None
    prev_percent_change: float = math.nan

    def update(self, map_metric: float, iteration: int,
               temps_all_one: bool) -> str:
        """Feed one MAP-check metric value; returns the status message.

        ``map_metric`` must already be sign-flipped for maximization metrics
        (loglikelihood/logposterior), i.e. lower is better
        (convergence.R:74-79).
        """
        cc = self.cc
        if self.prev_metric is None:
            # force % change < 0 on the first check (convergence.R:82-88)
            self.prev_metric = map_metric + 1.0
            self.best_metric = map_metric + 1.0

        denom = self.prev_metric if self.prev_metric != 0 else math.nan
        percent_change = (map_metric - self.prev_metric) / denom
        self.prev_percent_change = percent_change
        self.prev_metric = map_metric

        if math.isnan(percent_change):
            self.inarow_no_change = 0
            self.inarow_no_best = 0
            self.inarow_na += 1
        elif abs(percent_change) < cc.tol:
            self.inarow_no_change += 1
            self.inarow_na = 0
        else:
            self.inarow_no_change = 0
            self.inarow_na = 0

        # eligibility gate: whole MAP window at temperature 1 AND >= miniters
        # (convergence.R:112-118)
        if temps_all_one and iteration >= cc.miniters:
            if map_metric < self.best_metric:
                self.best_metric = map_metric
                self.best_iter = iteration
                self.inarow_no_best = 0
            else:
                self.inarow_no_best += 1

            if self.inarow_no_change >= cc.Ninarow_nochange:
                self._converge(iteration, "no change")
            elif self.inarow_no_best >= cc.Ninarow_nobest:
                self._converge(iteration, "no best")
            elif iteration >= cc.maxiters:
                self._converge(iteration, "max iters")
        elif iteration >= cc.maxiters:
            # the reference's outer loop also stops at maxiters even if the
            # gate never opened (bayesNMF_sampler.R:268-271)
            self._converge(iteration, "max iters")

        flip = -1.0 if cc.metric in ("loglikelihood", "logposterior") else 1.0
        return (
            f"{cc.metric} = {round(map_metric, 2)} | "
            f"{round(flip * percent_change * 100, 2)}% change | "
            f"{self.inarow_no_change} no change | "
            f"{self.inarow_no_best} no best | "
            f"{self.inarow_na} NA"
        )

    def _converge(self, iteration: int, why: str):
        if not self.converged:
            self.converged = True
            self.converged_iter = iteration
            self.why = why

    def to_dict(self):
        return dataclasses.asdict(self) | {"cc": None}

    def restore(self, d: dict):
        for k, v in d.items():
            if k != "cc" and hasattr(self, k):
                setattr(self, k, v)


class VectorConvergenceTracker:
    """Convergence tracking vectorised over an ensemble's chain axis
    (convergence.py:105-229): the gates and counters of
    ``ConvergenceTracker``, each per-chain scalar one slot of a (C,) numpy
    array.

    ``why`` is encoded per chain: 0 = not converged, 1 = "no change",
    2 = "no best", 3 = "max iters".
    """

    WHY = {0: None, 1: "no change", 2: "no best", 3: "max iters"}

    def __init__(self, cc: ConvergenceControl, n_chains: int):
        self.cc = cc
        self.n_chains = n_chains
        # explicit first-check flag: a NaN metric must reach the NA branch,
        # so NaN cannot be the sentinel
        self.seen = np.zeros(n_chains, bool)
        self.prev_metric = np.full(n_chains, np.nan)
        self.best_metric = np.full(n_chains, np.inf)
        self.best_iter = np.zeros(n_chains, np.int64)
        self.inarow_no_change = np.zeros(n_chains, np.int64)
        self.inarow_no_best = np.zeros(n_chains, np.int64)
        self.inarow_na = np.zeros(n_chains, np.int64)
        self.converged = np.zeros(n_chains, bool)
        self.converged_iter = np.full(n_chains, -1, np.int64)
        self.why_code = np.zeros(n_chains, np.int64)

    def why(self, c: int):
        return self.WHY[int(self.why_code[c])]

    def update(self, map_metric, iteration: int, temps_all_one: bool):
        """Feed one (C,) vector of MAP-check metrics (sign-flipped so lower
        is better); returns the mask of newly converged chains. Converged
        chains are frozen."""
        cc = self.cc
        m = np.asarray(map_metric, np.float64).reshape(self.n_chains)
        first = ~self.seen
        prev = np.where(first, m + 1.0, self.prev_metric)
        self.best_metric = np.where(
            first, np.minimum(self.best_metric, m + 1.0), self.best_metric)
        self.seen = self.seen | ~self.converged

        with np.errstate(divide="ignore", invalid="ignore"):
            pct = (m - prev) / np.where(prev == 0, np.nan, prev)
        live = ~self.converged

        def upd(cur, new):
            return np.where(live, new, cur)

        self.prev_metric = upd(self.prev_metric, m)
        is_na = np.isnan(pct)
        no_change = ~is_na & (np.abs(pct) < cc.tol)
        self.inarow_no_change = upd(
            self.inarow_no_change,
            np.where(no_change, self.inarow_no_change + 1, 0))
        # NA also resets the no-best streak (convergence.R:94-107)
        self.inarow_no_best = upd(
            self.inarow_no_best, np.where(is_na, 0, self.inarow_no_best))
        self.inarow_na = upd(
            self.inarow_na, np.where(is_na, self.inarow_na + 1, 0))

        if temps_all_one and iteration >= cc.miniters:
            is_best = m < self.best_metric
            self.best_metric = upd(self.best_metric,
                                   np.where(is_best, m, self.best_metric))
            self.best_iter = upd(self.best_iter,
                                 np.where(is_best, iteration, self.best_iter))
            self.inarow_no_best = upd(
                self.inarow_no_best,
                np.where(is_best, 0, self.inarow_no_best + 1))
            hit_nc = self.inarow_no_change >= cc.Ninarow_nochange
            hit_nb = self.inarow_no_best >= cc.Ninarow_nobest
            hit_mx = iteration >= cc.maxiters
            code = np.select([hit_nc, hit_nb, hit_mx], [1, 2, 3], 0)
        else:
            code = np.where(iteration >= cc.maxiters, 3, 0)
        newly = live & (code > 0)
        self.converged |= newly
        self.converged_iter = np.where(newly, iteration, self.converged_iter)
        self.why_code = np.where(newly, code, self.why_code)
        return newly

    def to_dict(self):
        return {k: getattr(self, k) for k in (
            "n_chains", "seen", "prev_metric", "best_metric", "best_iter",
            "inarow_no_change", "inarow_no_best", "inarow_na",
            "converged", "converged_iter", "why_code")}

    def restore(self, d: dict):
        for k, v in d.items():
            setattr(self, k, v)
