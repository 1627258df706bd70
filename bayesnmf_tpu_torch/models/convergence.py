"""Host-side convergence tracker.

Port of ConvergenceTracker from bayesnmf_tpu/models/convergence.py (parity:
check_convergence_, convergence.R:60-154). The module is pure Python, but
importing it from the JAX package runs bayesnmf_tpu/models/__init__.py,
which imports jax. The ensemble's VectorConvergenceTracker comes with the
chain-ensemble slice (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from bayesnmf_tpu.config import ConvergenceControl


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
