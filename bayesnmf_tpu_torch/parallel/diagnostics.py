"""Cross-chain MCMC convergence diagnostics: split-R-hat and effective
sample size.

Port of bayesnmf_tpu/parallel/diagnostics.py:35-206 (Vehtari, Gelman,
Simpson, Carpenter & Buerkner 2021, "Rank-normalization, folding, and
localization: an improved R-hat for assessing convergence of MCMC"). The
reference R package runs one chain; the ensembles make these diagnostics
possible. Every function takes a (n_chains, n_draws[, ...]) stack as a
numpy array or a CPU tensor, batches over the trailing axes, and returns a
float32 CPU tensor, computed as the JAX functions compute it: in float32,
the autocovariance by FFT (``torch.fft``), the rank normalisation through
``torch.special.ndtri``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "split_rhat",
    "rank_normalize",
    "ess",
    "ess_bulk",
    "ess_tail",
    "rhat",
    "ensemble_diagnostics",
]


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32))


def _split_chains(x):
    """(C, T, ...) -> (2C, T//2, ...), dropping a trailing odd draw."""
    half = x.shape[1] // 2
    return torch.cat([x[:, :half], x[:, half:2 * half]], 0)


def split_rhat(x):
    """Split-R-hat over a (n_chains, n_draws[, ...]) stack (no rank
    normalisation): the potential scale reduction factor per trailing
    element. Values below ~1.01 indicate mixing."""
    z = _split_chains(_f32(x))
    t = z.shape[1]
    chain_mean = z.mean(1)
    chain_var = z.var(1, correction=1)
    B = t * chain_mean.var(0, correction=1)                # between
    W = chain_var.mean(0)                                  # within
    var_plus = (t - 1) / t * W + B / t
    return torch.sqrt(var_plus / W.clamp_min(1e-300))


def rank_normalize(x):
    """Rank-normalise the draws across all chains jointly: fractional ranks
    (r - 3/8) / (S + 1/4) mapped to normal quantiles, batched over the
    trailing axes (ties ordered as they come, as a stable sort does)."""
    x = _f32(x)
    C, T = x.shape[0], x.shape[1]
    flat = x.reshape((C * T,) + tuple(x.shape[2:]))
    order = torch.argsort(flat, dim=0, stable=True)
    ranks = torch.argsort(order, dim=0, stable=True).to(torch.float32)
    frac = (ranks + 1.0 - 0.375) / (C * T + 0.25)
    return torch.special.ndtri(frac).reshape(x.shape)


def _autocov_fft(z):
    """Per-chain autocovariance via FFT, biased (divided by T), over
    (C, T, ...) along axis 1."""
    T = z.shape[1]
    zc = z - z.mean(1, keepdim=True)
    nfft = 2 ** int(math.ceil(math.log2(2 * T)))
    f = torch.fft.rfft(zc, n=nfft, dim=1)
    acov = torch.fft.irfft(f * torch.conj(f), n=nfft, dim=1)[:, :T]
    return acov / T


def ess(x):
    """Effective sample size of a (n_chains, n_draws[, ...]) stack by the
    multi-chain autocorrelation estimator with Geyer's initial monotone
    positive sequence (Vehtari et al. 2021, eq. 10)."""
    z = _split_chains(_f32(x))
    m, t = z.shape[0], z.shape[1]
    acov = _autocov_fft(z)                                 # (m, t, ...)
    chain_var = acov[:, 0] * t / (t - 1.0)
    mean_var = chain_var.mean(0)                           # W
    var_plus = mean_var * (t - 1.0) / t + z.mean(1).var(0, correction=1)
    # combined autocorrelation rho_t = 1 - (W - mean acov_t) / var_plus
    rho = 1.0 - (mean_var[None] - acov.mean(0)) / var_plus[None].clamp_min(
        1e-300)
    # Geyer pair sums P_k = rho_2k + rho_2k+1, kept while positive, then
    # made monotone non-increasing
    n_pairs = t // 2
    pair = rho[0:2 * n_pairs:2] + rho[1:2 * n_pairs:2]
    keep = torch.cumprod((pair > 0.0).to(torch.int32), 0).bool()
    pair = torch.where(keep, pair, 0.0)
    pair = torch.cummin(pair, 0).values.clamp_min(0.0)
    tau = -1.0 + 2.0 * pair.sum(0)
    floor = 1.0 / torch.log10(torch.tensor(float(m * t), dtype=torch.float32))
    return m * t / torch.maximum(tau, floor)


def ess_bulk(x):
    """Bulk-ESS: the ESS of the rank-normalised draws."""
    return ess(rank_normalize(x))


def _pooled(x):
    """(C * T, ...): every draw of every chain, for the pooled quantiles."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def ess_tail(x):
    """Tail-ESS: the smaller ESS of the 5% and 95% quantile indicators,
    used as they are (rank-normalising a binary variable would order its
    ties arbitrarily)."""
    x = _f32(x)
    q05 = torch.quantile(_pooled(x), 0.05, dim=0)
    q95 = torch.quantile(_pooled(x), 0.95, dim=0)
    return torch.minimum(ess((x <= q05).to(torch.float32)),
                         ess((x <= q95).to(torch.float32)))


def rhat(x):
    """Rank-normalised split-R-hat: the larger of the bulk and the folded
    (absolute deviation from the pooled median) variants."""
    x = _f32(x)
    bulk = split_rhat(rank_normalize(x))
    med = torch.quantile(_pooled(x), 0.5, dim=0)  # the mean of the middle two
    folded = split_rhat(rank_normalize(torch.abs(x - med)))
    return torch.maximum(bulk, folded)


# ---------------------------------------------------------------------------
# ensemble-level report
# ---------------------------------------------------------------------------


def ensemble_diagnostics(ensemble, metrics=("logposterior", "loglikelihood",
                                            "RMSE", "rank"),
                         n_draws: int | None = None):
    """Convergence report for a ChainEnsemble: per metric the rank-normalised
    split-R-hat and bulk/tail ESS over each chain's own retained inference
    window (``ensemble.metrics_stack``), as a pandas DataFrame with one row
    per metric. A metric that takes one value in every draw of every chain
    (the rank at a fixed rank) has R-hat 1 and ESS the draw count, flagged
    ``constant``; a large R-hat on ``rank`` flags chains that learned
    different ranks. (The JAX function flags a metric constant when each
    chain's trace is, whatever value each keeps, which hides exactly those
    chains: not copied.)"""
    import pandas as pd

    from ..models.gibbs import METRIC_NAMES

    if n_draws is not None and hasattr(ensemble, "metrics_stack"):
        rows_all = ensemble.metrics_stack(n_draws)         # (C, n_draws, m)
        keep = ~np.all(np.isnan(rows_all[:, :, 0]), axis=0)
        rows_all = rows_all[:, keep, :]
    else:
        rows_all = np.concatenate(ensemble._metric_rows, axis=1)
        if n_draws is not None:
            rows_all = rows_all[:, -n_draws:, :]
    out = []
    col_of = {n: i for i, n in enumerate(METRIC_NAMES)}
    for name in metrics:
        trace = rows_all[:, :, col_of[name]]
        if np.all(trace == trace.flat[0]):
            out.append({"metric": name, "rhat": 1.0,
                        "ess_bulk": float(trace.size),
                        "ess_tail": float(trace.size), "constant": True})
            continue
        out.append({"metric": name, "rhat": float(rhat(trace)),
                    "ess_bulk": float(ess_bulk(trace)),
                    "ess_tail": float(ess_tail(trace)), "constant": False})
    return pd.DataFrame(out)
