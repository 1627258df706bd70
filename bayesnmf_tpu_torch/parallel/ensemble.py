"""Multi-chain ensembles: C independent chains in one batched program.

Port of bayesnmf_tpu/parallel/ensemble.py:58-1015: C chains of any model
the single-chain sampler runs (Poisson with MH through the fused kernel,
the eager sweeps or the streaming kernels; conjugate Poisson-Gibbs with the
exponential or the gamma prior through the allocation kernel; the Normal
likelihood on the eager sweeps), at a
fixed rank, learning it by SBFI/BFI/BIC, or with a fixed inclusion mask per
chain (``A_masks``, the parallel-BIC rank search of ``fit``), on one device.
Each chain keeps the reference's semantics on its own: accept-all warmup
until its own convergence, then ``post_warmup`` MH samples (none without
MH); convergence is tracked on the host from the per-chain metrics
(models/convergence.VectorConvergenceTracker).

The chains are the leading axis of every state tensor (parallel/chains.py).
Once a chain has finished its inference window, its MAP and sample window
are taken to the host and the device ensemble shrinks to the chains still
running (``_maybe_compact``, an index-select on the chain axis), so
finished chains stop costing device time. ``record_history='full'``
records the prior parameters, sigmasq and the acceptance records of every
chain and iteration beside P, E and A; ``save_all_samples=True`` keeps a
host copy of every chunk (the archive), which a chain's view reads for
windows older than the retained ones and for the label-switching plot.
Each chain's view (``chain(c)``) has the single-chain sampler's surface.

Not ported yet (raises NotImplementedError; ROADMAP.md queue 1 item 9):
``mesh``.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Optional

import numpy as np
import torch

from ..config import ConvergenceControl, ModelSpec, default_hyperprior_params
from ..config import default_MH
from ..models import gibbs
from ..models.convergence import VectorConvergenceTracker
from ..models.map_estimate import compute_map
from ..models.sampler import _resolve_output_dir, check_counts
from ..models.sampler import host_tree, resolve_device, stack_history
from ..models.sampler import summarize_history
from ..utils.logging import RunLogger
from . import chains as chains_mod

#: Smallest G at which ``stream_sweeps=None`` picks the streaming kernels on
#: CUDA. Copied from the JAX package (ensemble.py:58-62), where it was
#: measured on a TPU at C = 64 (XLA won at G = 1000, streaming at 2000); the
#: H100 crossover against the port's other paths is not measured yet
#: (ROADMAP.md queue 1 item 1).
_STREAM_SWEEPS_MIN_G = 2000

_ROADMAP = "not ported yet (see ROADMAP.md queue 1 item 9)"


def _auto_stream_sweeps(likelihood, prior, MH, mesh, fused_sweeps, G,
                        device: torch.device) -> bool:
    """Streaming kernels for large-G poisson+MH ensembles on CUDA; every
    other ensemble runs the fused kernel or the eager sweeps."""
    return (likelihood == "poisson" and bool(MH)
            and prior in ("truncnormal", "exponential")
            and mesh is None and not fused_sweeps
            and device.type == "cuda"
            and G >= _STREAM_SWEEPS_MIN_G)


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _chain_part(chunk: dict, c: int):
    """Chain ``c``'s records of a chunk (tensors or numpy, the prior
    parameters in a nested dict), each (steps, ...), with the chunk's
    start_iter; None when the chunk ran without chain ``c``."""
    pos = np.nonzero(chunk["chain_ids"] == c)[0]
    if pos.size == 0:
        return None
    s = int(pos[0])

    def pick(v):
        return {k: pick(x) for k, x in v.items()} if isinstance(v, dict) \
            else v[s]

    return {k: (v if k == "start_iter" else pick(v))
            for k, v in chunk.items() if k != "chain_ids"}


def _steps(tree: dict, i0: int, i1: int) -> dict:
    """Steps i0:i1 of every record of a chain's chunk."""
    return {k: (_steps(v, i0, i1) if isinstance(v, dict) else v[i0:i1])
            for k, v in tree.items() if k != "start_iter"}


def _select(tree, idx):
    """index_select on the chain axis of every tensor of a state (nested
    dicts); anything else (the generator, the iteration) as it is."""
    if isinstance(tree, dict):
        return {k: _select(v, idx) for k, v in tree.items()}
    return tree.index_select(0, idx) if isinstance(tree, torch.Tensor) \
        else tree


class _ViewTracker:
    """Per-chain convergence facts for a _ChainView."""

    def __init__(self, ens: "ChainEnsemble", chain: int):
        self._ens = ens
        self._c = chain

    @property
    def converged(self):
        return bool(self._ens.tracker.converged[self._c])

    @property
    def converged_iter(self):
        it = int(self._ens.tracker.converged_iter[self._c])
        return it if it >= 0 else None

    @property
    def why(self):
        return self._ens.tracker.why(self._c)


class _ChainView:
    """One chain of an ensemble with the single-chain sampler's surface
    (JAX ensemble.py:110-397): what MAP, postprocessing and plotting read
    (spec, data, MAP, credible_intervals, sample_metrics, _gather_window,
    _archive, reference_comparison), ``samples``, ``posterior_summary``,
    ``summary``, ``save_object`` and the model math ``get_Mhat``,
    ``get_loglik`` and ``get_logpost``, as the reference returns the
    winner's whole sampler (bayesNMF.R:117-126)."""

    def __init__(self, ensemble: "ChainEnsemble", chain: int):
        self._ens = ensemble
        self.chain = chain
        self.spec = ensemble.spec
        self.cc = ensemble.cc
        self.row_names = ensemble.row_names
        self.col_names = ensemble.col_names
        self.temp_sched = ensemble.temp_sched
        self.tracker = _ViewTracker(ensemble, chain)

    @property
    def _archive(self):
        """This chain's part of every archived chunk (save_all_samples),
        in the single-chain archive's layout; None without an archive."""
        if self._ens._archive is None:
            return None
        return [p for p in (_chain_part(ch, self.chain)
                            for ch in self._ens._archive) if p is not None]

    def _window_parts(self):
        """This chain's part of each retained device chunk."""
        return [p for p in (_chain_part(ch, self.chain)
                            for ch in self._ens._window) if p is not None]

    @property
    def MAP_metrics(self):
        return self._ens._MAP_metrics_per_chain[self.chain]

    @property
    def MAP(self):
        return self._ens.MAP_per_chain[self.chain]

    @MAP.setter
    def MAP(self, value):
        self._ens.MAP_per_chain[self.chain] = value

    @property
    def credible_intervals(self):
        m = self.MAP
        return m.get("credible_intervals") if m else None

    def get_MAP(self, end_iter=None, n_samples=None, final=True,
                credible_interval=0.95):
        """This chain's MAP over a window (get_MAP, utils.R:194-212); with
        no arguments, the finalised MAP."""
        if end_iter is None and n_samples is None and self.MAP is not None:
            return self.MAP
        end = self._end_default() if end_iter is None else int(end_iter)
        n = min(n_samples or self.cc.MAP_over, end)
        P_h, E_h, A_h = self._gather_window(end, n, device=self._ens.device)
        res = compute_map(P_h, E_h, A_h, final=final,
                          credible_interval=credible_interval,
                          want_ci=self._ens.want_ci)
        res["idx"] = np.arange(end - A_h.shape[0] + 1, end + 1)[
            res["idx_mask"]]
        res["sig_idx"] = np.arange(len(res["keep_sigs"]))
        self.MAP = res
        return res

    def _end_default(self):
        e = int(self._ens._end_iter[self.chain])
        return e if 0 < e <= self._ens.iter else self._ens.iter

    @property
    def iter(self):
        return self._end_default()

    @property
    def reference_comparison(self):
        return self._ens._reference_comparisons.setdefault(self.chain, {})

    @reference_comparison.setter
    def reference_comparison(self, value):
        self._ens._reference_comparisons[self.chain] = value

    @property
    def data(self):
        return self._ens.data

    @property
    def output_dir(self):
        return self._ens.output_dir

    @property
    def time(self):
        return self._ens.time

    @property
    def sample_metrics(self):
        """This chain's per-iteration metrics as a DataFrame; iterations run
        after the chain left the device are absent."""
        import pandas as pd

        rows = self._ens._metrics_all()[self.chain]
        rows = rows[~np.isnan(rows[:, 0])]
        return pd.DataFrame(rows, columns=list(gibbs.METRIC_NAMES))

    @property
    def samples(self):
        """This chain's retained sample window as {name: (S, ...)} numpy:
        its finalised window once it has one, else the retained chunks. P,
        E (with store_E) and A; with ``record_history='full'`` also the
        prior parameters under their names, sigmasq and acc_P/acc_E
        (bayesNMF_sampler.R:651-672; JAX ensemble.py:228-252)."""
        fin = self._ens._final_windows.get(self.chain)
        if fin is not None:
            return {k: v for k, v in fin.items() if k != "end_iter"}
        parts = self._window_parts()
        if not parts:
            raise ValueError("no retained samples for this chain")
        return stack_history(parts)

    def posterior_summary(self, name: str, q=(0.025, 0.5, 0.975)):
        """Posterior mean and quantiles of one of ``samples``' histories
        (models/sampler.GibbsSampler.posterior_summary)."""
        return summarize_history(self.samples, name, q)

    def _gather_window(self, end_iter: int, n_samples: int, device=None):
        """This chain's last ``n_samples`` samples ending at ``end_iter``:
        (P, E or None, A), from its finalised host window when that covers
        the request (or there is no archive), else from the retained device
        chunks, and from the archive (save_all_samples) for a window that
        starts before them (JAX ensemble.py:342-397). numpy arrays, or
        tensors on ``device`` (A always numpy)."""
        lo = end_iter - n_samples + 1
        chunks = None
        fin = self._ens._final_windows.get(self.chain)
        if fin is not None:
            S = fin["A"].shape[0]
            start = fin["end_iter"] - S + 1
            if (lo >= start and end_iter <= fin["end_iter"]) \
                    or self._ens._archive is None:
                chunks = [fin | {"start_iter": start}]
        if chunks is None:
            chunks = self._window_parts()
            if (not chunks or lo < chunks[0]["start_iter"]) \
                    and self._ens._archive is not None:
                chunks = self._archive
        Ps, Es, As = [], [], []
        for ch in chunks:
            n = ch["P"].shape[0]
            s, e = ch["start_iter"], ch["start_iter"] + n - 1
            if e < lo or s > end_iter:
                continue
            i0, i1 = max(lo - s, 0), min(end_iter - s, n - 1) + 1
            Ps.append(ch["P"][i0:i1])
            As.append(_host(ch["A"][i0:i1]))
            if ch.get("E") is not None:
                Es.append(ch["E"][i0:i1])
        if not Ps:
            raise ValueError("no samples in requested window")
        if device is None:
            cat = lambda xs: np.concatenate([_host(x) for x in xs])  # noqa
        else:
            cat = lambda xs: torch.cat(  # noqa: E731
                [torch.as_tensor(x, device=device) for x in xs])
        return cat(Ps), (cat(Es) if Es else None), np.concatenate(As)

    def assign_signatures_ensemble(self, reference_P="cosmic", idxs=None,
                                   credible_interval=0.95):
        from ..utils.postprocessing import assign_signatures_ensemble

        return assign_signatures_ensemble(
            self, reference_P=reference_P, idxs=idxs,
            credible_interval=credible_interval)

    def summary(self, reference_P="cosmic"):
        from ..utils.postprocessing import sampler_summary

        return sampler_summary(self, reference_P=reference_P)

    def save_object(self, path: Optional[str] = None):
        """Checkpoint the whole ensemble (a chain has no state of its own)."""
        return self._ens.save_object(path)

    # -- model math (the single sampler's get_Mhat / get_loglik /
    #    get_logpost, bayesNMF_sampler.R:8-541) -------------------------

    def _live_slot(self):
        pos = np.nonzero(self._ens._slots == self.chain)[0]
        return int(pos[0]) if pos.size else None

    def _current(self, group: str = "params") -> dict:
        """This chain's latest values of ``group`` ("params" or "prior") as
        numpy: the device state while the chain is resident, else the last
        draw of its finalised window (the prior parameters are there only
        under ``record_history='full'``)."""
        s = self._live_slot()
        if s is not None:
            return {k: _host(v[s])
                    for k, v in self._ens.states[group].items()}
        fin = self._ens._final_windows.get(self.chain)
        if fin is None:
            raise ValueError(
                f"chain {self.chain} has no live state or finalised window")
        if group == "params":
            return {k: fin[k][-1] for k in ("P", "A", "E", "sigmasq")
                    if k in fin}
        names = list(self._ens.states[group])
        if all(k in fin for k in names):
            return {k: fin[k][-1] for k in names}
        raise ValueError(
            "the prior parameters of a compacted chain are recorded only "
            "under record_history='full'")

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(_host(x), np.float32),
                               device=self._ens.device)

    def get_Mhat(self, P=None, A=None, E=None):
        """P diag(A) E of this chain's latest state, or of the given P, A,
        E."""
        from ..ops import math as m

        p = self._current()
        if E is None and "E" not in p:
            raise ValueError(
                "exposures not retained for this chain: rerun with "
                "store_E=True or pass E explicitly")
        return m.mhat(*(self._tensor(x if x is not None else p[k])
                        for k, x in (("P", P), ("A", A), ("E", E))))

    def get_loglik(self, P=None, A=None, E=None, sigmasq=None,
                   likelihood=None, return_matrix=False):
        """The log-likelihood of the data (get_loglik_, utils.R:62-112) at
        this chain's latest state or the given parameters."""
        from ..ops import math as m

        Mh = self.get_Mhat(P, A, E)
        if sigmasq is None and self.spec.needs_sigmasq:
            sigmasq = self._current().get("sigmasq")
        mat = m.loglik_mat(self.data, Mh, likelihood or self.spec.likelihood,
                           None if sigmasq is None else self._tensor(sigmasq))
        return mat if return_matrix else torch.sum(mat)

    def get_logpost(self, P=None, A=None, E=None, sigmasq=None):
        """The log-likelihood plus the prior log-density of P and E under
        this chain's latest prior parameters (get_logpost_,
        utils.R:131-175)."""
        from ..ops import math as m

        p = self._current()
        prior = {k: self._tensor(v) for k, v in self._current("prior").items()}
        return self.get_loglik(P, A, E, sigmasq) + m.logprior_PE(
            self._tensor(P if P is not None else p["P"]),
            self._tensor(E if E is not None else p["E"]),
            self.spec.prior, prior)


class ChainEnsemble:
    """Run ``n_chains`` independent Gibbs chains of the same model on one
    device. ``device="cuda"`` (the default) runs the CUDA kernels,
    ``device="cpu"`` their plain PyTorch versions; nothing falls back from
    one to the other. The path: ``stream_sweeps`` (None: the streaming
    kernels for Poisson MH on CUDA at G >= 2000), else ``fused_sweeps``
    (None: the fused kernel for Poisson MH, as the single-chain sampler
    resolves it; False: the chain-batched eager sweeps); conjugate Gibbs
    for MH=False, the eager sweeps for the Normal likelihood."""

    def __init__(
        self,
        data,
        rank,
        n_chains: int = 8,
        likelihood: str = "poisson",
        prior: str = "truncnormal",
        rank_method: str = "SBFI",
        MH: Optional[bool] = None,
        convergence_control: Optional[ConvergenceControl] = None,
        prop_temp: float = 0.2,
        post_warmup: Optional[int] = None,
        mesh=None,
        seed: int = 0,
        store_E: bool = True,
        output_dir: Optional[str] = None,
        overwrite: bool = False,
        hyperprior_params: Optional[dict] = None,
        init_prior_params: Optional[dict] = None,
        init_params: Optional[dict] = None,
        record_history: str = "basic",
        fused_sweeps: Optional[bool] = None,
        stream_sweeps: Optional[bool] = None,
        want_ci: bool = True,
        compact: bool = True,
        verbosity: int = 1,
        periodic_save: bool = True,
        save_all_samples: bool = False,
        A_masks=None,
        device="cuda",
    ):
        if record_history not in ("basic", "full"):
            raise ValueError("record_history must be 'basic' or 'full'")
        if mesh is not None:
            raise NotImplementedError(f"mesh-sharded ensembles are {_ROADMAP}")
        self.record = record_history
        self.device = resolve_device(device)
        self.row_names = None
        self.col_names = None
        if hasattr(data, "index") and hasattr(data, "columns"):
            self.row_names = [str(r) for r in data.index]
            self.col_names = [str(c) for c in data.columns]
            data = data.to_numpy()
        data = np.ascontiguousarray(data, np.float32)
        if isinstance(rank, (int, np.integer)):
            ranks = [int(rank)]
        else:
            ranks = sorted(int(r) for r in rank)
        learning_rank = len(ranks) > 1
        N = max(ranks)
        if MH is None:
            MH = default_MH(likelihood, prior)
        if stream_sweeps is None:
            stream_sweeps = _auto_stream_sweeps(
                likelihood, prior, MH, mesh, fused_sweeps, data.shape[1],
                self.device)
        if fused_sweeps is None:
            # the fused kernel for Poisson MH when not streaming, as the
            # single-chain sampler resolves it (models/sampler.py); the JAX
            # package's default (the XLA path) was measured on a TPU
            fused_sweeps = (likelihood == "poisson" and bool(MH)
                            and not stream_sweeps)
        self.spec = ModelSpec(
            K=data.shape[0], N=N, G=data.shape[1], likelihood=likelihood,
            prior=prior, MH=MH, learning_rank=learning_rank,
            rank_method=rank_method, fused_sweeps=bool(fused_sweeps),
            stream_sweeps=bool(stream_sweeps))
        check_counts(self.spec, data)
        # per-chain FIXED inclusion masks (n_chains, N): chain c samples a
        # rank-sum(A_masks[c]) model whose excluded columns draw from the
        # prior (the reference's A_n = 0 dispatch, sample_Pn.R:12-13), the
        # engine of fit(rank_method='BIC') (JAX ensemble.py:468-486)
        self.A_masks = None
        if A_masks is not None:
            if learning_rank:
                raise ValueError(
                    "A_masks fixes per-chain ranks; incompatible with a "
                    "learned rank (pass a scalar rank = max candidate rank)")
            self.A_masks = np.asarray(A_masks, np.float32)
            if self.A_masks.shape != (n_chains, N):
                raise ValueError(
                    f"A_masks must have shape ({n_chains}, {N}), got "
                    f"{self.A_masks.shape}")
        self.cc = convergence_control or ConvergenceControl()
        self.n_chains = n_chains
        self.post_warmup = (post_warmup if post_warmup is not None
                            else 2 * self.cc.MAP_over) if MH else 0
        self.store_E = store_E
        self.seed = seed
        self.periodic_save = periodic_save
        self.want_ci = want_ci
        self.compact = compact

        self.output_dir = _resolve_output_dir(output_dir, overwrite)
        self.logger = RunLogger(self.output_dir, verbosity)
        path = ("stream" if self.spec.stream_sweeps else "fused"
                if self.spec.fused_sweeps else "conjugate"
                if self.spec.needs_Z else "eager")
        self.logger.log(
            f"Initialized ensemble: {n_chains} chains, likelihood = "
            f"{likelihood}, prior = {prior}, MH = {MH}, rank "
            f"{'learned (' + rank_method + ')' if learning_rank else N}"
            f"{', per-chain masks' if A_masks is not None else ''}, "
            f"path = {path}, device = {self.device}", 1)

        n_iters = self.cc.maxiters + self.post_warmup
        rng = np.random.default_rng(seed)
        if learning_rank:
            sched = gibbs.temp_schedule(
                n_iters, int(round(prop_temp * self.cc.maxiters)), rng)
        else:
            sched = np.ones(n_iters, np.float32)
        self.temp_sched = np.concatenate([[np.float32(0)], sched])

        self.hp = dict(default_hyperprior_params(self.spec,
                                                 float(data.mean())))
        if hyperprior_params:
            self.hp.update(hyperprior_params)
        if self.spec.likelihood == "normal":
            # the InvGamma(alpha, beta) prior of sigmasq, default 3/3,
            # settable through either dict (JAX ensemble.py:518-522)
            ipp = dict(init_prior_params or {})
            for k in ("alpha", "beta"):
                self.hp.setdefault(k, ipp.pop(k, 3.0))
            init_prior_params = ipp
        self._data_np = data
        self.data = torch.as_tensor(data, device=self.device)
        self._slots = np.arange(n_chains)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.states = chains_mod.init_chain_states(
            self.spec, self.hp, self.data, gen, n_chains, init_params,
            init_prior_params)
        if self.A_masks is not None:
            # A never updates at a fixed rank: setting it once pins each
            # chain's rank for the run (JAX ensemble.py:588-599)
            masks = torch.as_tensor(self.A_masks, device=self.device)
            self.states["params"]["A"] = masks
            self.states["params"]["R"] = masks.sum(1).to(torch.int32)

        self.tracker = VectorConvergenceTracker(self.cc, n_chains)
        self.iter = 1
        # per-chain iteration at which the inference phase ends
        self._end_iter = np.full(n_chains, -1, np.int64)
        self._window: list = []        # recent device chunks + chain_ids
        self._metric_rows: list = []   # (n_chains, steps, m), NaN off-device
        self._final_windows: dict = {}  # chain -> host sample window
        self._final_metrics: dict = {}  # chain -> host metric rows
        # every chunk's host copy with its chain ids (save_all_samples): a
        # chain's whole history for the label-switching plot and windows
        # older than the retained chunks (JAX ensemble.py:545-551)
        self._archive: Optional[list] = [] if save_all_samples else None
        self.MAP_per_chain: list = [None] * n_chains
        self._MAP_metrics_per_chain: list = [[] for _ in range(n_chains)]
        self._reference_comparisons: dict = {}
        # chain-iterations of resident chains inside their own runs
        self._chain_iters = 0
        self.time = {}

    # ------------------------------------------------------------------

    def _accept_all_vec(self):
        return torch.as_tensor(
            (self.spec.MH & ~self.tracker.converged)[self._slots],
            device=self.device)

    def _run_chunk(self, steps: int):
        temps = self.temp_sched[self.iter + 1: self.iter + steps + 1]
        self.states, samples = chains_mod.run_chunk_chains(
            self.spec, self.data, self.hp, self.states, temps,
            self._accept_all_vec(), store_E=self.store_E, record=self.record)
        chunk = {k: v for k, v in samples.items() if k != "metrics"}
        chunk["start_iter"] = self.iter + 1
        chunk["chain_ids"] = self._slots.copy()
        self._window.append(chunk)
        if self._archive is not None:
            self._archive.append(host_tree(chunk))
        max_chunks = -(-self.cc.MAP_over // self.cc.MAP_every) + 1
        if len(self._window) > max_chunks:
            self._window.pop(0)
        rows = np.full((self.n_chains, steps, gibbs.N_METRICS), np.nan,
                       np.float32)
        rows[self._slots] = _host(samples["metrics"])
        self._metric_rows.append(rows)
        end = self._end_iter[self._slots]
        self._chain_iters += int(np.sum(np.where(
            end > 0, np.clip(end - self.iter, 0, steps), steps)))
        self.iter += steps

    def _metrics_all(self):
        return np.concatenate(self._metric_rows, axis=1)  # (C, iters, m)

    def _metrics_tail(self, n: int):
        return self._metrics_all()[:, -n:, :]

    def _check_convergence(self):
        win = self._metrics_tail(self.cc.MAP_over)
        # per-chain MAP metric: the window mean of the metric, as the
        # reference does (update_MAP_metrics_, utils.R:369-379)
        col = {"loglikelihood": 3, "logposterior": 4, "RMSE": 1, "KL": 2}[
            self.cc.metric]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN rows
            vals = np.nanmean(win[:, :, col], axis=1)
        if self.cc.metric in ("loglikelihood", "logposterior"):
            vals = -vals
        self._append_map_metric_rows(win)
        temps_all_one = bool(np.all(
            self.temp_sched[max(self.iter - self.cc.MAP_over, 1):
                            self.iter + 1] == 1.0))
        newly = self.tracker.update(vals, self.iter, temps_all_one)
        self._end_iter[newly] = self.iter + self.post_warmup
        for c in np.nonzero(newly)[0]:
            self.logger.log(
                f"chain {c} converged at {self.iter} due to "
                f"{self.tracker.why(c)}", 1)
        self.logger.log(
            f"iter = {self.iter}: {int(self.tracker.converged.sum())}/"
            f"{self.n_chains} chains converged", 1)
        if self.periodic_save and self.output_dir:
            self.save_object()

    def _append_map_metric_rows(self, win):
        """Per-chain MAP-metric rows at this check (update_MAP_metrics_,
        utils.R:356-397): window means of the per-sample metrics; rows stop
        once a chain's run has ended."""
        G, K = self.spec.G, self.spec.K
        mean_temp = float(np.mean(
            self.temp_sched[max(self.iter - self.cc.MAP_over + 1, 1):
                            self.iter + 1]))
        for c in range(self.n_chains):
            if 0 < self._end_iter[c] < self.iter:
                continue
            w = win[c]
            w = w[~np.isnan(w[:, 0])]
            if w.shape[0] == 0:
                continue
            mean_ll = float(w[:, 3].mean())
            rank = float(w[-1, 7])
            n_par = rank * (G + K)
            self._MAP_metrics_per_chain[c].append({
                "iter": self.iter,
                "RMSE": float(w[:, 1].mean()),
                "KL": float(w[:, 2].mean()),
                "loglikelihood": mean_ll,
                "logposterior": float(w[:, 4].mean()),
                "n_params": n_par,
                "BIC": -2.0 * mean_ll + n_par * np.log(G),
                "rank": rank,
                "mean_temp": mean_temp,
            } | ({"P_mean_acceptance_rate": float(w[-1, 9]),
                  "E_mean_acceptance_rate": float(w[-1, 10])}
                 if self.spec.MH else {}))

    # ------------------------------------------------------------------
    # finalisation + compaction
    # ------------------------------------------------------------------

    def _finished_mask(self):
        return self.tracker.converged & (self._end_iter > 0) & (
            self._end_iter <= self.iter)

    def _finalize_chain(self, c: int):
        """Take chain ``c``'s inference window (ending at its own
        ``_end_iter``, bayesNMF.R:95-97) to the host, every recorded name
        (under ``record_history='full'`` the prior parameters, sigmasq and
        the acceptance records too, so the chain's view still answers
        ``samples`` and ``_current('prior')`` once it has left the device;
        JAX ensemble.py:718-776), and compute its MAP and credible
        intervals."""
        end = int(self._end_iter[c])
        end = end if 0 < end <= self.iter else self.iter
        lo = max(end - self.cc.MAP_over + 1, 2)
        parts = []
        for ch in _ChainView(self, c)._window_parts():
            n = ch["A"].shape[0]
            s, e = ch["start_iter"], ch["start_iter"] + n - 1
            if e >= lo and s <= end:
                parts.append(_steps(ch, max(lo - s, 0),
                                    min(end - s, n - 1) + 1))
        if not parts:
            raise ValueError("no samples in requested window")
        fin = stack_history(parts) | {"end_iter": end}
        A_h = fin["A"]
        P_h = torch.as_tensor(fin["P"], device=self.device)
        E_h = (torch.as_tensor(fin["E"], device=self.device) if "E" in fin
               else None)
        rows = self._metrics_all()[c]
        j1 = rows.shape[0] - (self.iter - end)
        self._final_metrics[c] = rows[max(j1 - self.cc.MAP_over, 0):j1]
        res = compute_map(P_h, E_h, A_h, final=True, want_ci=self.want_ci)
        res["idx"] = np.arange(end - A_h.shape[0] + 1, end + 1)[
            res["idx_mask"]]
        res["sig_idx"] = np.arange(len(res["keep_sigs"]))
        self._final_windows[c] = fin
        self.MAP_per_chain[c] = res

    def _maybe_compact(self):
        """Shrink the resident ensemble to the chains still running: one
        index-select on the chain axis of every state tensor."""
        finished = self._finished_mask()
        keep = np.nonzero(~finished[self._slots])[0]
        if keep.size == 0 or keep.size == self._slots.size:
            return
        # every tensor of the state: P, E, A, R, the latent counts' sums,
        # sigmasq, the prior's parameters and the acceptance records
        self.states = _select(self.states,
                              torch.as_tensor(keep, device=self.device))
        self._slots = self._slots[keep]
        self.logger.log(
            f"compacted ensemble to {self._slots.size} resident chains", 1)

    def run(self):
        """Run all chains to completion (resumable: continues from the
        current iteration after ``ChainEnsemble.load``); returns self."""
        t0 = time.time()
        cc = self.cc
        self.logger.log("Starting ensemble Gibbs sampler", 1)
        hard_stop = cc.maxiters + self.post_warmup
        while self.iter < hard_stop and not np.all(self._finished_mask()):
            boundary = min(((self.iter // cc.MAP_every) + 1) * cc.MAP_every,
                           hard_stop)
            self._run_chunk(boundary - self.iter)
            if self.iter % cc.MAP_every == 0 or self.iter >= hard_stop:
                self._check_convergence()
                for c in np.nonzero(self._finished_mask())[0]:
                    if self.MAP_per_chain[c] is None:
                        self._finalize_chain(c)
                if self.compact:
                    self._maybe_compact()
        self.time["total"] = self.time.get("total", 0.0) + (
            time.time() - t0) / 60.0
        self.time["iters"] = self.iter
        self._compute_maps()
        self.logger.log(
            f"Ensemble done: {self.iter} iterations, "
            f"{self.throughput():.1f} chain-it/s", 1)
        if self.output_dir:
            self.save_object()
        return self

    def _compute_maps(self):
        """Finalise every chain that still lacks a MAP (chains that never
        converged get the global tail window)."""
        for c in range(self.n_chains):
            if self.MAP_per_chain[c] is None:
                if self._end_iter[c] <= 0:
                    self._end_iter[c] = self.iter
                self._finalize_chain(c)

    # ------------------------------------------------------------------
    # persistence (checkpoint + bit-exact resume)
    # ------------------------------------------------------------------

    def save_object(self, path: Optional[str] = None):
        from ..utils.checkpoint import save_ensemble

        path = path or (os.path.join(self.output_dir, "ensemble.ckpt")
                        if self.output_dir else "ensemble.ckpt")
        save_ensemble(self, path)
        return path

    @classmethod
    def load(cls, path: str):
        """Resume from a checkpoint, on the device it was saved from."""
        from ..utils.checkpoint import load_ensemble

        return load_ensemble(cls, path)

    # ------------------------------------------------------------------
    # results
    # ------------------------------------------------------------------

    def chain(self, c: int) -> _ChainView:
        """Single-chain view for MAP, postprocessing and plotting."""
        if self.MAP_per_chain[c] is None:
            self._compute_maps()
        return _ChainView(self, c)

    def assign_signatures(self, reference_P="cosmic", credible_interval=0.95):
        """Per-chain posterior-ensemble reference assignment
        (assign_signatures_ensemble_, postprocessing.R:175-341, run per
        chain). Returns {chain: {'assignments', 'votes'}}."""
        from ..utils.postprocessing import assign_signatures_ensemble

        return {
            c: assign_signatures_ensemble(
                self.chain(c), reference_P=reference_P,
                credible_interval=credible_interval)
            for c in range(self.n_chains)
        }

    def summary(self, reference_P="cosmic"):
        """Pooled cross-chain summary: one row per (chain, signature) with
        the per-chain reference assignment and cosine (summarize_samplers,
        postprocessing.R:114-152, over chains instead of samplers)."""
        import pandas as pd

        from ..utils.postprocessing import sampler_summary

        if not self.store_E:
            raise ValueError(
                "summary() needs exposure medians; rerun with store_E=True "
                "(assign_signatures() works without E)")
        frames = []
        for c in range(self.n_chains):
            df = sampler_summary(self.chain(c), reference_P).copy()
            df.insert(0, "Chain", c)
            frames.append(df)
        return pd.concat(frames, ignore_index=True)

    def pooled_assignment(self, reference_P="cosmic"):
        """Majority assignment across chains: for each reference signature,
        the fraction of chains whose MAP includes a signature assigned to
        it (the cross-chain analogue of the reference's within-chain vote
        pooling)."""
        import pandas as pd

        rows = []
        for c, res in self.assign_signatures(reference_P).items():
            for _, r in res["assignments"].iterrows():
                rows.append({"Chain": c, "sig_ref": r.sig_ref,
                             "MAP_cosine": r.MAP_cosine})
        agg = pd.DataFrame(rows).groupby("sig_ref").agg(
            n_chains=("Chain", "nunique"),
            mean_cosine=("MAP_cosine", "mean"),
        ).reset_index()
        agg["prop_chains"] = agg["n_chains"] / self.n_chains
        return agg.sort_values("prop_chains", ascending=False).reset_index(
            drop=True)

    def diagnostics(self, metrics=("logposterior", "loglikelihood", "RMSE",
                                   "rank"), n_draws: Optional[int] = None):
        """Cross-chain convergence report: rank-normalised split-R-hat and
        bulk/tail ESS per metric (parallel/diagnostics.py), over each
        chain's own retained inference window (``n_draws`` = MAP_over by
        default). A large R-hat on ``rank`` flags chains that learned
        different ranks."""
        from .diagnostics import ensemble_diagnostics

        if n_draws is None:
            n_draws = self.cc.MAP_over
        return ensemble_diagnostics(self, metrics=metrics, n_draws=n_draws)

    def metrics_stack(self, n_draws: int):
        """(C, n_draws, m) stack of per-chain metric windows, each chain's
        own inference window when finalised (NaN-padded if shorter)."""
        out = np.full((self.n_chains, n_draws, gibbs.N_METRICS), np.nan,
                      np.float32)
        for c in range(self.n_chains):
            w = self._chain_metrics_window(c)[-n_draws:]
            if w.shape[0]:
                out[c, -w.shape[0]:] = w
        return out

    def _chain_metrics_window(self, c: int):
        fin = self._final_metrics.get(c)
        if fin is not None:
            return fin
        return self._metrics_tail(self.cc.MAP_over)[c]

    def bic_table(self):
        """Per-chain BIC over each chain's own final MAP_over window:
        BIC = -2*mean(loglik) + n_params*log(G), sorted by BIC."""
        import pandas as pd

        rows = []
        for c in range(self.n_chains):
            win = self._chain_metrics_window(c)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                mean_ll = float(np.nanmean(win[:, 3]))
            ok = ~np.isnan(win[:, 0])
            last = np.nonzero(ok)[0][-1] if ok.any() else -1
            rows.append({
                "chain": c, "rank": int(win[last, 7]),
                "BIC": -2.0 * mean_ll + float(win[last, 5])
                * np.log(self.spec.G),
                "loglik": mean_ll,
            })
        return pd.DataFrame(rows).sort_values("BIC").reset_index(drop=True)

    @property
    def learned_ranks(self):
        return np.array([
            int(np.asarray(m_["A_full"]).sum()) if m_ is not None else -1
            for m_ in self.MAP_per_chain])

    def throughput(self):
        """Chain-iterations per second over the whole run, counting only
        the iterations each resident chain ran inside its own run (a chain
        kept on the device past its end does not count)."""
        secs = self.time.get("total", 0.0) * 60.0
        return self._chain_iters / max(secs, 1e-9)
