"""Host side of the sampler: phases, convergence checks, MAP windows, I/O.

Port of bayesnmf_tpu/models/sampler.py for one chain: the Poisson
likelihood with MH (truncnormal or exponential prior, through the fused
kernel, or with ``fused_sweeps=False`` the eager sweeps) or conjugate Gibbs
(MH=False, exponential or gamma prior, through the allocation kernel), and
the Normal likelihood (truncnormal or exponential prior, the eager sweeps),
at
a fixed rank or learning it over a rank list by SBFI/BFI/BIC (the last
without the SBFI penalty, as the JAX step runs it). ``fit`` with
``rank_method='BIC'`` over a rank list fits one model per rank and keeps
the one of least BIC: by default all at once, one chain per rank in a
``ChainEnsemble`` with a fixed inclusion mask per chain, else one sampler
per rank in turn. The hot loop
runs on the device in chunks of MAP_every iterations (models/gibbs.py);
this class owns everything at chunk granularity: sample
windows (with ``record_history='full'`` also the prior parameters, sigmasq
and the acceptance records, ``samples`` and ``posterior_summary``),
metrics history, convergence, logging, checkpointing and the
postprocessing entry points, which read numpy arrays.

The device is explicit: ``device="cuda"`` (the default) runs the CUDA
kernel, ``device="cpu"`` the kernel's plain PyTorch version. Nothing falls
back from one to the other; the eager sweeps run only where the caller
asks for them (``fused_sweeps=False``) or for the Normal likelihood, which
no kernel covers.

``mesh`` (parallel/mesh.py, one process per rank) splits one chain's G
axis over the mesh's g axis: each rank holds its columns of the data, E,
Mhat and the G-sized prior parameters and runs the eager or conjugate
step on them (the fused kernel is refused, as the JAX package refuses
it), with the chain of the one-process run of the same seed. At each
chunk boundary the chunk's records are gathered, so the sample window,
MAP, ``samples`` and the metrics are whole and alike on every rank; only
the mesh's root rank writes the log, the plots and the checkpoints.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import shutil
import time
from typing import Optional

import numpy as np
import torch

from ..config import (
    ConvergenceControl,
    ModelSpec,
    RunConfig,
    default_hyperprior_params,
    default_MH,
)
from ..parallel import mesh as Mesh
from ..utils import tracing
from ..utils.logging import RunLogger, format_counts_table

from . import gibbs
from .convergence import ConvergenceTracker
from .map_estimate import compute_map, map_quality_metrics
from .updates import lift
from ..ops.rng import ChainStreams

def _resolve_output_dir(output_dir: Optional[str], overwrite: bool,
                        mesh=None) -> Optional[str]:
    """Collision-suffixing `_1,_2,...` or wipe-on-overwrite
    (bayesNMF_sampler.R:111-121); on a mesh resolved by the root rank and
    broadcast, so that every rank names the same directory."""
    if mesh is not None:
        out = (_resolve_output_dir(output_dir, overwrite) if mesh.is_root
               else None)
        return Mesh.broadcast_object(out, mesh)
    if output_dir is None:
        return None
    final = output_dir
    tail = 0
    while not overwrite and os.path.isdir(final):
        tail += 1
        final = f"{output_dir}_{tail}"
    if overwrite and os.path.isdir(final):
        shutil.rmtree(final)
    os.makedirs(final, exist_ok=True)
    return final


def resolve_device(device, mesh=None) -> torch.device:
    """The device to run on, as given; on a mesh the rank's own device,
    which must be of the type given. CUDA without a card is an error, not
    a quiet run on the CPU."""
    if mesh is not None:
        if torch.device(device).type != mesh.device.type:
            raise ValueError(f"device={device!r} but the mesh's ranks are "
                             f"on {mesh.device.type}")
        return mesh.device
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch.cuda.is_available() is False; pass "
            "device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def host_tree(tree):
    """Every tensor of ``tree`` (nested dicts) as host numpy; anything else
    (a chunk's start iteration, its chain ids) as it is."""
    if isinstance(tree, dict):
        return {k: host_tree(v) for k, v in tree.items()}
    return _host(tree) if isinstance(tree, torch.Tensor) else tree


def stack_history(chunks: list) -> dict:
    """The recorded histories of ``chunks`` (one chain's, each {name:
    (steps, ...)} with the prior parameters under "prior") stacked along
    the step axis as numpy, the prior parameters under their own names
    (the reference's ``samples$Lambda_p``, bayesNMF_sampler.R:651-672)."""
    out: dict = {}
    for ch in chunks:
        for k, v in ch.items():
            if k in ("start_iter", "chain_ids", "metrics"):
                continue
            for name, x in (v.items() if isinstance(v, dict) else [(k, v)]):
                out.setdefault(name, []).append(_host(x))
    return {k: np.concatenate(v) for k, v in out.items()}


def summarize_history(hist: dict, name: str, q) -> dict:
    """Posterior mean and quantiles of one recorded history (``hist`` as
    ``samples`` gives it); KeyError naming what was recorded otherwise."""
    if name not in hist:
        raise KeyError(
            f"{name!r} not recorded; run with record_history='full' "
            f"(available: {sorted(k for k in hist if k != 'start_iter')})")
    x = np.asarray(hist[name])
    return {"mean": x.mean(axis=0),
            "quantiles": {qi: np.quantile(x, qi, axis=0) for qi in q},
            "n_samples": x.shape[0]}


def check_counts(spec: ModelSpec, data: np.ndarray):
    """Raise ValueError when the conjugate path (MH=False) gets data that
    are not non-negative integer counts: the allocation's inversion stops
    once x reaches the count, which returns the reference's draw for
    integer counts only."""
    if spec.needs_Z and not (np.all(data >= 0.0)
                             and np.array_equal(data, np.round(data))):
        raise ValueError("the conjugate Poisson-Gibbs sampler (MH=False) "
                         "takes non-negative integer counts")


class GibbsSampler:
    """Single-chain Bayesian NMF Gibbs sampler. ``rank`` is an int (a fixed
    rank) or a list of ranks, which learns the rank over 0..max(rank) by
    ``rank_method`` 'SBFI', 'BFI' or 'BIC' (bayesNMF_sampler.R:118-125;
    'BIC' here runs the inclusion sweep without the SBFI penalty, as the
    JAX sampler does; ``fit`` runs 'BIC' one rank at a time).

    ``fused_allocation`` is the JAX sampler's switch between its Pallas
    allocation kernel and its XLA allocation; None resolves as there off a
    TPU (False). It selects nothing here: the conjugate path has one
    allocation, the kernel of ops/allocation.py on the card and its plain
    version on the CPU. True with MH or with the Normal likelihood raises
    the JAX package's error (config.ModelSpec)."""

    def __init__(
        self,
        data,
        rank,
        likelihood: str = "poisson",
        prior: str = "truncnormal",
        rank_method: str = "SBFI",
        MH: Optional[bool] = None,
        convergence_control: Optional[ConvergenceControl] = None,
        prop_temp: float = 0.2,
        post_warmup: Optional[int] = None,
        output_dir: Optional[str] = None,
        overwrite: bool = False,
        hyperprior_params: Optional[dict] = None,
        init_prior_params: Optional[dict] = None,
        init_params: Optional[dict] = None,
        verbosity: int = 1,
        periodic_save: bool = True,
        save_all_samples: bool = True,
        record_history: str = "basic",
        mesh=None,
        fused_sweeps: Optional[bool] = None,
        fused_allocation: Optional[bool] = None,
        exact_mh: bool = True,
        exact_truncnorm_hypers: bool = True,
        seed: int = 0,
        device="cuda",
    ):
        if record_history not in ("basic", "full"):
            raise ValueError("record_history must be 'basic' or 'full'")
        # "full" records the prior parameters, sigmasq and the MH acceptance
        # records every iteration, like the reference's record_sample
        # (bayesNMF_sampler.R:651-672); "basic" P, E, A and the metrics
        self.record = record_history
        if isinstance(rank, (int, np.integer)):
            ranks = [int(rank)]
        else:
            ranks = sorted(int(r) for r in rank)
        learning_rank = len(ranks) > 1
        if learning_rank and min(ranks) != 0:
            ranks = list(range(0, max(ranks) + 1))  # bayesNMF_sampler.R:125
        if mesh is not None and fused_sweeps:
            raise ValueError(gibbs.FUSED_MESH_ERROR)
        self.mesh = mesh
        self.device = resolve_device(device, mesh)
        self.row_names = None
        self.col_names = None
        if hasattr(data, "index") and hasattr(data, "columns"):
            self.row_names = [str(r) for r in data.index]
            self.col_names = [str(c) for c in data.columns]
            data = data.to_numpy()
        # row-major: the kernel takes contiguous tensors (R data arrive
        # column-major)
        data = np.ascontiguousarray(data, np.float32)
        if MH is None:
            MH = default_MH(likelihood, prior)
        # the JAX sampler's auto value off a TPU; it selects nothing here
        # (see the class docstring) but is validated as there
        fused_allocation = bool(fused_allocation)
        spec = ModelSpec(
            K=data.shape[0], N=max(ranks), G=data.shape[1],
            likelihood=likelihood, prior=prior, MH=MH,
            learning_rank=learning_rank, rank_method=rank_method,
            exact_mh=exact_mh, exact_truncnorm_hypers=exact_truncnorm_hypers,
            fused_allocation=fused_allocation)
        if fused_sweeps is None:
            # the fused kernel for Poisson MH off a mesh; the Normal
            # likelihood, fused_sweeps=False and a mesh take the eager sweeps
            fused_sweeps = (spec.likelihood == "poisson" and spec.MH
                            and mesh is None)
        spec = dataclasses.replace(spec, fused_sweeps=fused_sweeps)
        check_counts(spec, data)
        self.spec = spec
        self.cc = convergence_control or ConvergenceControl()
        self.run_cfg = RunConfig(
            prop_temp=prop_temp, post_warmup=post_warmup,
            output_dir=output_dir, overwrite=overwrite, verbosity=verbosity,
            periodic_save=periodic_save, save_all_samples=save_all_samples,
            seed=seed)
        self.rank = ranks if learning_rank else ranks[0]
        self.post_warmup = self.run_cfg.resolved_post_warmup(self.cc)
        self.output_dir = _resolve_output_dir(output_dir, overwrite, mesh)
        self.logger = RunLogger(self.output_dir, verbosity, mesh=mesh)

        # tempering schedule, 1-indexed by iteration; all 1 at a fixed rank
        # (utils.R:307-332; bayesNMF_sampler.R:128-137)
        n_iters = self.cc.maxiters + (self.post_warmup if MH else 0)
        if learning_rank:
            sched = gibbs.temp_schedule(
                n_iters, int(round(prop_temp * self.cc.maxiters)),
                np.random.default_rng(seed))
        else:
            sched = np.ones(n_iters, np.float32)
        self.temp_sched = np.concatenate([[np.float32(0)], sched]).astype(
            np.float32)

        self._data_np = data
        full = torch.as_tensor(data, device=self.device)
        self.data = (full if mesh is None
                     else Mesh.local(full, (None, Mesh.G_AXIS), mesh,
                                     spec.G))
        self.hyperprior_params = dict(
            default_hyperprior_params(spec, float(data.mean())))
        if hyperprior_params:
            self.hyperprior_params.update(hyperprior_params)
        if spec.likelihood == "normal":
            # the InvGamma(alpha, beta) prior of sigmasq, default 3/3,
            # settable through either dict (bayesNMF_sampler.R:222-230)
            ipp = dict(init_prior_params or {})
            for k in ("alpha", "beta"):
                self.hyperprior_params.setdefault(k, ipp.pop(k, 3.0))
            init_prior_params = ipp

        self.logger.log("Initialized sampler", 1)
        self.logger.indent = 1
        self.logger.log(
            f"likelihood = {likelihood}, prior = {prior}, MH = {MH}", 1)
        disp = (f"{min(ranks)}:{max(ranks)}" if learning_rank
                else str(self.rank))
        self.logger.log(f"learning_rank = {learning_rank}, rank = {disp}", 1)
        self.logger.log(f"device = {self.device}", 1)
        if mesh is not None:
            self.logger.log(f"mesh = {mesh.n_chain}x{mesh.n_g} (chain x g), "
                            "G split over the g axis", 1)
        self.logger.log(f"maxiters = {self.cc.maxiters}", 1)
        self.logger.log(f"MAP_over = {self.cc.MAP_over}", 1)
        self.logger.log(f"MAP_every = {self.cc.MAP_every}", 1)
        self.logger.indent = 0

        # the chain's stream has uid 0; on a mesh every rank builds the
        # one-process initial state and keeps its block
        self.state = gibbs.init_state(
            spec, self.hyperprior_params, full,
            ChainStreams(seed, [0], device=self.device),
            init_params=init_params, init_prior_params=init_prior_params)
        del full
        if mesh is not None:
            gen = self.state["gen"]
            self.state = Mesh.local(self.state,
                                    Mesh.state_layout(spec, chains=False),
                                    mesh, spec.G)
            self.state["gen"] = gen.block(mesh, spec.G, split_chains=False)
        self.tracker = ConvergenceTracker(self.cc)
        self.iter = 1
        self.time = {}
        self.MAP: Optional[dict] = None
        self.credible_intervals: Optional[dict] = None
        self.MAP_metrics: list[dict] = []
        self.reference_comparison: dict = {}

        # the retained window holds device chunks; the archive holds every
        # sample on the host
        window_chunks = -(-self.cc.MAP_over // self.cc.MAP_every) + 1
        self._window = collections.deque(maxlen=window_chunks)
        self._archive = [] if save_all_samples else None
        self._metric_rows: list[np.ndarray] = []

        # record the initial sample (iteration 1), bayesNMF_sampler.R:240-257
        snap = gibbs.snapshot_sample(spec, self.data, self.state,
                                     float(self.temp_sched[1]), self.record)
        self._append_chunk(lift(snap), start_iter=1)

    # ------------------------------------------------------------------
    # sample storage
    # ------------------------------------------------------------------

    def _append_chunk(self, samples: dict, start_iter: int):
        """Keep a chunk's records (every name but the metrics) in the
        device window and, with save_all_samples, a host copy in the
        archive (sampler.py:245-268); on a mesh gathered whole first (the
        metrics rows are alike on every rank already)."""
        chunk = {k: v for k, v in samples.items() if k != "metrics"}
        if self.mesh is not None:
            chunk = Mesh.gather(chunk, Mesh.sample_out_layout(
                self.spec, chains=False, record=self.record), self.mesh,
                self.spec.G)
        chunk["start_iter"] = start_iter
        self._window.append(chunk)
        self._metric_rows.append(_host(samples["metrics"]))
        if self._archive is not None:
            self._archive.append(host_tree(chunk))

    def _gather_window(self, end_iter: int, n_samples: int, device=None):
        """Stack the last ``n_samples`` recorded samples ending at end_iter.
        Returns numpy arrays, or tensors on ``device`` when it is given
        (A always as numpy)."""
        lo = end_iter - n_samples + 1
        sources = list(self._window)
        if not sources or lo < sources[0]["start_iter"]:
            if self._archive is None:
                raise ValueError(
                    "requested window precedes the retained sample window; "
                    "rerun with save_all_samples=True")
            sources = self._archive
        Ps, Es, As = [], [], []
        for ch in sources:
            c = ch["P"].shape[0]
            s, e = ch["start_iter"], ch["start_iter"] + c - 1
            if e < lo or s > end_iter:
                continue
            i0, i1 = max(lo - s, 0), min(end_iter - s, c - 1) + 1
            Ps.append(ch["P"][i0:i1])
            Es.append(ch["E"][i0:i1])
            As.append(_host(ch["A"][i0:i1]))
        if not Ps:
            raise ValueError("no samples in requested window")
        if device is None:
            return (np.concatenate([_host(p) for p in Ps]),
                    np.concatenate([_host(e) for e in Es]),
                    np.concatenate(As))
        cat = lambda xs: torch.cat(  # noqa: E731
            [torch.as_tensor(x, device=device) for x in xs])
        return cat(Ps), cat(Es), np.concatenate(As)

    @property
    def sample_metrics(self):
        """Per-iteration metrics as a pandas DataFrame (sample_metrics,
        bayesNMF_sampler.R:190-207)."""
        import pandas as pd

        rows = np.concatenate(self._metric_rows, axis=0)
        return pd.DataFrame(rows, columns=list(gibbs.METRIC_NAMES))

    @property
    def samples(self):
        """The recorded histories, stacked: of the whole run with
        save_all_samples, else of the retained window (sampler.py:304-330).
        P, E, A always; with ``record_history='full'`` also the prior
        parameters under their names (``samples['Lambda_p']``,
        ``samples['Alpha_e']``, ...), ``samples['sigmasq']`` and the MH
        acceptance records ``samples['acc_P']``/``['acc_E']``, as the
        reference's ``sampler$samples`` (bayesNMF_sampler.R:651-672);
        ``start_iter`` the iteration of the first."""
        src = (self._archive if self._archive is not None
               else list(self._window))
        return stack_history(src) | {"start_iter": src[0]["start_iter"]}

    def posterior_summary(self, name: str, q=(0.025, 0.5, 0.975)):
        """Posterior mean and quantiles of a recorded history (e.g.
        'sigmasq', 'Lambda_p', 'acc_P'; sampler.py:332-352) over the
        samples ``samples`` holds; the prior parameters, sigmasq and the
        acceptance records need ``record_history='full'``."""
        return summarize_history(self.samples, name, q)

    # ------------------------------------------------------------------
    # model math on the current state or given parameters (the reference's
    # public get_Mhat / get_loglik / get_logpost; sampler.py:354-384)
    # ------------------------------------------------------------------

    def _param(self, name, value):
        if value is None:
            return self.state["params"][name]
        t = torch.as_tensor(np.asarray(_host(value), np.float32),
                            device=self.device)
        if self.mesh is not None and name in ("E", "sigmasq"):
            t = self._local(t)
        return t

    def _local(self, x):
        """This rank's columns of a whole (.., G) tensor."""
        return Mesh.local(x, (None,) * (x.dim() - 1) + (Mesh.G_AXIS,),
                          self.mesh, self.spec.G)

    def _whole(self, x):
        """The whole (.., G) tensor from every rank's columns."""
        if self.mesh is None:
            return x
        return Mesh.gather(x, (None,) * (x.dim() - 1) + (Mesh.G_AXIS,),
                           self.mesh, self.spec.G)

    def _mhat_local(self, P, A, E):
        from ..ops import math as m

        return m.mhat(self._param("P", P), self._param("A", A),
                      self._param("E", E))

    def get_Mhat(self, P=None, A=None, E=None):
        """P diag(A) E of the current state, or of the given P, A, E (the
        whole matrix on every rank of a mesh)."""
        return self._whole(self._mhat_local(P, A, E))

    def get_loglik(self, P=None, A=None, E=None, sigmasq=None,
                   likelihood=None, return_matrix=False):
        """The log-likelihood of the data (get_loglik_, utils.R:62-112), as
        a 0-d tensor or with ``return_matrix`` the (K, G) matrix; the
        Normal likelihood takes the state's sigmasq unless one is given."""
        from ..ops import math as m

        lik = likelihood or self.spec.likelihood
        sq = (self._param("sigmasq", sigmasq)
              if sigmasq is not None or "sigmasq" in self.state["params"]
              else None)
        mat = m.loglik_mat(self.data, self._mhat_local(P, A, E), lik, sq)
        if return_matrix:
            return self._whole(mat)
        return Mesh.g_all_reduce(torch.sum(mat), self.mesh)

    def get_logpost(self, P=None, A=None, E=None, sigmasq=None):
        """The log-likelihood plus the prior log-density of P and E under
        the state's prior parameters (get_logpost_, utils.R:131-175)."""
        from ..ops import math as m

        return self.get_loglik(P, A, E, sigmasq) + m.logprior_PE(
            self._param("P", P), self._param("E", E), self.spec.prior,
            self.state["prior"], self.mesh)

    # ------------------------------------------------------------------
    # MAP
    # ------------------------------------------------------------------

    def get_MAP(self, end_iter=None, n_samples=None, final=False,
                credible_interval=0.95):
        """MAP estimate over a sample window (get_MAP_, utils.R:194-288);
        updates self.MAP / self.credible_intervals."""
        end_iter = self.iter if end_iter is None else end_iter
        n_samples = min(n_samples or self.cc.MAP_over, end_iter)
        if end_iter != self.iter and self._archive is None:
            raise ValueError(
                "end_iter requires save_all_samples=True (utils.R:210-212)")
        P_h, E_h, A_h = self._gather_window(end_iter, n_samples,
                                            device=self.device)
        res = compute_map(P_h, E_h, A_h, final=final,
                          credible_interval=credible_interval)
        res["idx"] = np.arange(end_iter - A_h.shape[0] + 1, end_iter + 1)[
            res["idx_mask"]]
        res["sig_idx"] = np.arange(len(res["keep_sigs"]))
        self.MAP = res
        self.credible_intervals = res.get("credible_intervals")
        return res

    # ------------------------------------------------------------------
    # the run loop
    # ------------------------------------------------------------------

    def _run_chunk(self, steps: int, accept_all: bool):
        temps = self.temp_sched[self.iter + 1: self.iter + steps + 1]
        self.state, samples = gibbs.run_chunk(
            self.spec, self.data, self.hyperprior_params, self.state, temps,
            accept_all, self.record)
        self._append_chunk(samples, start_iter=self.iter + 1)
        self.iter += steps

    def _map_check(self, final: bool = False):
        """MAP + convergence bookkeeping at a chunk boundary
        (bayesNMF_sampler.R:288-329 / update_MAP_metrics_,
        utils.R:356-397)."""
        self.logger.log(f"iter = {self.iter}", 1)
        self.logger.indent = 2
        self.logger.log("Computing MAP", 1)
        self.get_MAP(final=final)
        if self.spec.learning_rank:
            self.logger.log(format_counts_table(self.MAP["A_counts"]), 1)

        # MAP metrics: loglik/logpost averaged over the window's sample
        # metrics (renormalized P/E invalidate the prior), BIC recomputed
        rows = np.concatenate(self._metric_rows, axis=0)
        win = rows[-self.cc.MAP_over:]
        mean_ll = float(np.nanmean(win[:, 3]))
        mean_lp = float(np.nanmean(win[:, 4]))
        q = map_quality_metrics(self.data, self.MAP, self.spec.G, self.spec.K,
                                self.mesh)
        row = {
            "iter": self.iter,
            "RMSE": q["RMSE"], "KL": q["KL"],
            "loglikelihood": mean_ll, "logposterior": mean_lp,
            "n_params": q["n_params"],
            "BIC": -2.0 * mean_ll + q["n_params"] * np.log(self.spec.G),
            "rank": q["rank"],
            "MAP_A_counts": self.MAP["A_counts"][0][1],
            "mean_temp": float(np.mean(self.temp_sched[
                max(self.iter - self.cc.MAP_over + 1, 1): self.iter + 1])),
        }
        if self.spec.MH:
            row["P_mean_acceptance_rate"] = float(win[-1, 9])
            row["E_mean_acceptance_rate"] = float(win[-1, 10])
        self.MAP_metrics.append(row)

        # surface numeric-overflow fallbacks (the reference logs its
        # NA-overflow ladder state, sample_params.R:136-162)
        na_col = gibbs.METRIC_NAMES.index("NA_events")
        na_events = float(np.nansum(self._metric_rows[-1][:, na_col]))
        if na_events > 0:
            self.logger.log(
                f"{int(na_events)} numeric-overflow fallbacks in the last "
                "chunk (MH ratios clamped NaN→0 / inclusion odds NaN→1/2)", 1)

        metric = row[self.cc.metric]
        if self.cc.metric in ("loglikelihood", "logposterior"):
            metric = -metric
        temps_all_one = bool(np.all(self.temp_sched[
            max(self.iter - self.cc.MAP_over, 1): self.iter + 1] == 1.0))
        msg = self.tracker.update(metric, self.iter, temps_all_one)
        # every rank decides from the same all-reduced rows
        Mesh.check_same(self.tracker.converged, self.mesh,
                        "the convergence decision")
        self.logger.log("Checking convergence", 1)
        self.logger.log(msg, 1)
        self.logger.indent = 1
        if self.tracker.converged and self.tracker.converged_iter == self.iter:
            self.logger.log(
                f"Converged at {self.iter} due to {self.tracker.why}", 1)
        if self.run_cfg.periodic_save and self.output_dir:
            self.logger.log("Saving object", 1)
            self.save_object()
            # live-updating trace plots at every check, as the reference
            # does (utils.R:344-347, 394-396); the mesh's root draws them
            if self.mesh is not None and not self.mesh.is_root:
                return
            try:
                from ..utils import plotting

                plotting.trace_plot(self, save=True)
                plotting.trace_plot(self, MAP_means=True, save=True)
                import matplotlib.pyplot as plt

                plt.close("all")
            except Exception as e:  # plotting must never kill a run
                self.logger.log(f"trace plot failed: {e}", 1)

    def run_gibbs_sampler(self):
        """Warmup until convergence or maxiters, then post_warmup MH
        inference samples (run_gibbs_sampler, bayesNMF_sampler.R:265-408)."""
        self.logger.log("Starting Gibbs sampler", 1)
        self.logger.indent = 1
        t0 = time.time()
        cc = self.cc

        # ---- warmup: accept-all MH proposals, convergence checked every
        # MAP_every iterations (bayesNMF_sampler.R:288-296)
        while not self.tracker.converged and self.iter < cc.maxiters:
            boundary = min(
                ((self.iter // cc.MAP_every) + 1) * cc.MAP_every, cc.maxiters)
            self._run_chunk(boundary - self.iter, accept_all=self.spec.MH)
            if self.iter % cc.MAP_every == 0 or self.iter >= cc.maxiters:
                self._map_check()

        if self.spec.MH:
            # ---- post-warmup MH inference phase
            t1 = time.time()
            self.time["warmup"] = (t1 - t0) / 60.0
            self.logger.log(
                f"Warmup done, sampling {self.post_warmup} with MH for "
                "inference", 1)
            done = 0
            while done < self.post_warmup:
                nxt = min(((self.iter // cc.MAP_every) + 1) * cc.MAP_every,
                          self.iter + (self.post_warmup - done))
                steps = nxt - self.iter
                self._run_chunk(steps, accept_all=False)
                done += steps
                final = done >= self.post_warmup
                if self.iter % cc.MAP_every == 0 or final:
                    self._map_check(final=final)
            self.logger.log(f"Additional {self.post_warmup} MH samples done",
                            1)
            self.time["MH"] = (time.time() - t1) / 60.0
        else:
            self.get_MAP(final=True)
            if self.spec.learning_rank:
                self.logger.log(format_counts_table(self.MAP["A_counts"]), 1)
            self.logger.log("Final MAP computed", 1)

        self.logger.log("Sampler done", 1)
        self.time["total"] = (time.time() - t0) / 60.0
        self.time["per_iter"] = self.time["total"] / self.iter
        self.time["iters_per_sec"] = self.iter / max(
            self.time["total"] * 60.0, 1e-9)
        self.logger.log(f"Total time: {round(self.time['total'], 2)} minutes "
                        f"({self.time['iters_per_sec']:.1f} it/s)", 1)
        if self.output_dir:
            self.logger.log("Saving final object", 1)
            self.save_object()
        return self

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------

    def save_object(self, path: Optional[str] = None):
        from ..utils.checkpoint import save_sampler

        path = path or (os.path.join(self.output_dir, "sampler.ckpt")
                        if self.output_dir else "sampler.ckpt")
        save_sampler(self, path)
        return path

    @classmethod
    def load(cls, path: str, mesh=None, device=None):
        """Resume from a checkpoint: on the device it was saved from, or on
        ``device``, or split over ``mesh`` (a checkpoint does not record a
        mesh: one written on a mesh loads in one process and the other way
        round, and the chain continues). The chain's stream continues on
        either device type (utils/checkpoint.py)."""
        from ..utils.checkpoint import load_sampler

        return load_sampler(cls, path, mesh=mesh, device=device)

    # ------------------------------------------------------------------
    # postprocessing entry points (utils/postprocessing.py, utils/plotting.py)
    # ------------------------------------------------------------------

    def assign_signatures_ensemble(self, reference_P="cosmic", idxs=None,
                                   credible_interval=0.95):
        from ..utils.postprocessing import assign_signatures_ensemble

        return assign_signatures_ensemble(
            self, reference_P=reference_P, idxs=idxs,
            credible_interval=credible_interval)

    def summary(self, reference_P="cosmic"):
        from ..utils.postprocessing import sampler_summary

        return sampler_summary(self, reference_P=reference_P)

    def plot(self, **kw):
        from ..utils.plotting import plot_sampler

        return plot_sampler(self, **kw)


@tracing.traced("fit")
def fit(data, rank, likelihood: str = "poisson", prior: str = "truncnormal",
        rank_method: str = "SBFI", MH: Optional[bool] = None,
        convergence_control: Optional[ConvergenceControl] = None,
        output_dir: Optional[str] = "default", parallel_bic: bool = True,
        **kw):
    """Fit Bayesian NMF; the port of ``bayesnmf_tpu.fit`` (bayesNMF,
    bayesNMF.R:24-138). With a scalar rank, or a rank list and rank_method
    SBFI/BFI, this runs one sampler and returns it. With a rank list and
    rank_method='BIC' it fits one model per candidate rank and returns
    {results, best_rank, sampler} for the least final BIC
    (bayesNMF.R:66-126; sampler.py:612-711 of the JAX package):

    - ``parallel_bic=True`` (the default) runs every rank at once as one
      ``ChainEnsemble`` of the max-rank model, chain c's inclusion vector
      fixed to the first ranks[c] columns (``A_masks``), so its excluded
      columns draw from the prior as a dedicated rank-k fit's would; the
      dict adds the ``ensemble``, and ``sampler`` is the winning chain's
      view, with the single sampler's surface (``samples``, ``summary``,
      ``save_object``, ``get_Mhat``, ``get_loglik``, ``get_logpost``,
      ...). ``save_all_samples`` and ``record_history`` go to the
      ensemble; a keyword it does not take (``exact_mh``,
      ``exact_truncnorm_hypers``, ...) sends the search to the serial loop
      with a warning;
    - ``parallel_bic=False`` runs one ``GibbsSampler`` per rank in turn,
      each logging to ``output_dir/rank_<k>``, and saves the winner's
      checkpoint at ``output_dir/sampler.ckpt``.

    ``output_dir`` defaults to ``nmf_<likelihood>_<prior>``; None disables
    logging and checkpoints. Other keyword arguments go to GibbsSampler or
    ChainEnsemble (``device`` and ``mesh`` among them: on a mesh the BIC
    ensemble splits its chains over the chain axis, as the JAX ``fit``
    passes ``mesh`` to its ensemble)."""
    if output_dir == "default":
        output_dir = f"nmf_{likelihood}_{prior}"
    learning = (not isinstance(rank, (int, np.integer))
                and len(list(rank)) > 1)
    if learning and rank_method == "BIC" and parallel_bic:
        import inspect
        import warnings

        from ..parallel.ensemble import ChainEnsemble

        supported = set(inspect.signature(ChainEnsemble.__init__).parameters)
        unsupported = sorted(k for k in kw if k not in supported)
        if unsupported:
            warnings.warn(
                "fit(rank_method='BIC'): kwargs not supported by the "
                f"parallel-BIC ensemble ({', '.join(unsupported)}); falling "
                "back to the serial per-rank loop (one fit per rank, "
                "substantially slower). Drop them or pass parallel_bic=False "
                "to silence this.", stacklevel=2)
        else:
            ranks = sorted(int(r) for r in rank)
            N = max(ranks)
            masks = np.zeros((len(ranks), N), np.float32)
            for c, k in enumerate(ranks):
                masks[c, :k] = 1.0
            ens = ChainEnsemble(
                data, N, n_chains=len(ranks), likelihood=likelihood,
                prior=prior, MH=MH, convergence_control=convergence_control,
                output_dir=output_dir, A_masks=masks, **kw)
            ens.run()
            with tracing.span("fit.bic_table"):
                table = ens.bic_table()
            results = [{"rank": int(r["rank"]), "chain": int(r["chain"]),
                        "dir": ens.output_dir, "BIC": float(r["BIC"]),
                        "time": ens.time["total"]}
                       for _, r in table.iterrows()]
            best_chain = int(table.iloc[0]["chain"])
            return {"results": results,
                    "best_rank": int(table.iloc[0]["rank"]),
                    "sampler": ens.chain(best_chain), "ensemble": ens}
    if learning and rank_method == "BIC":
        results = []
        best = None
        for k in sorted(int(r) for r in rank):
            od_k = (os.path.join(output_dir, f"rank_{k}") if output_dir
                    else None)
            s = GibbsSampler(
                data, k, likelihood=likelihood, prior=prior,
                rank_method=rank_method, MH=MH,
                convergence_control=convergence_control, output_dir=od_k,
                **kw)
            s.run_gibbs_sampler()
            bic_k = s.MAP_metrics[-1]["BIC"]
            results.append({"rank": k, "dir": od_k, "BIC": bic_k,
                            "time": s.time["total"]})
            if best is None or bic_k < best[0]:
                best = (bic_k, k, s)
        results.sort(key=lambda r: r["BIC"])
        if output_dir:
            # the winning sampler saved at the parent level (bayesNMF.R:125)
            best[2].save_object(os.path.join(output_dir, "sampler.ckpt"))
        return {"results": results, "best_rank": best[1], "sampler": best[2]}

    sampler = GibbsSampler(
        data, rank, likelihood=likelihood, prior=prior,
        rank_method=rank_method, MH=MH,
        convergence_control=convergence_control, output_dir=output_dir, **kw)
    return sampler.run_gibbs_sampler()
