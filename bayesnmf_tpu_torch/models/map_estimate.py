"""MAP estimate over the posterior sample window: the mode of A, the
renormalised means of P and E over the samples that match it, and
elementwise credible intervals.

Port of bayesnmf_tpu/models/map_estimate.py (get_MAP_, utils.R:194-288).
The averaging and quantiles run on the samples' device; the results are
handed back as numpy arrays, which is what postprocessing and plotting read.
The MAP and the credible intervals are elementwise over G; on a mesh the
samplers compute them on the gathered window, alike on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import math as m


def a_mode(A_hist: np.ndarray):
    """Mode of the binary inclusion samples.

    Args:
      A_hist: (S, N) 0/1 array (host numpy).
    Returns: (mode_vector (N,), match_mask (S,), top_counts list[(pattern,
    count)])
    """
    Ab = np.asarray(A_hist).astype(np.int8)
    uniq, inverse, counts = np.unique(
        Ab, axis=0, return_inverse=True, return_counts=True)
    order = np.argsort(-counts)
    mode_row = uniq[order[0]]
    mask = inverse.reshape(-1) == order[0]
    top = [("".join(str(int(v)) for v in uniq[i]), int(counts[i]))
           for i in order[:5]]
    return mode_row.astype(np.float32), mask, top


def _masked_renorm_mean(P_hist, E_hist, mask):
    """Mask-weighted mean of the per-sample renormalised (P, E); returns the
    means and the renormalised stacks. ``E_hist`` None (a run that kept no
    E history) gives None for E."""
    w = mask.to(torch.float32)
    w = w / w.sum().clamp_min(1.0)
    s = P_hist.sum(dim=1, keepdim=True)                   # (S, 1, N)
    safe = torch.where(s > 0, s, torch.ones_like(s))
    P_rn = P_hist / safe
    P_map = torch.einsum("s,skn->kn", w, P_rn)
    if E_hist is None:
        return P_map, None, P_rn, None
    E_rn = E_hist * safe.transpose(1, 2)
    return P_map, torch.einsum("s,sng->ng", w, E_rn), P_rn, E_rn


def _masked_quantiles(X, mask: np.ndarray, lo: float):
    """Elementwise (lo, 1-lo) quantiles over the masked leading axis, with
    linear interpolation (R's default type 7). Masked-out samples sort to
    +inf, past the n valid ones."""
    S = X.shape[0]
    keep = torch.as_tensor(mask, device=X.device).view(
        (S,) + (1,) * (X.dim() - 1))
    srt = torch.sort(torch.where(keep, X, torch.full_like(X, np.inf)),
                     dim=0).values
    n = int(np.sum(mask))

    def q_at(q):
        pos = q * (n - 1.0)
        i0 = min(max(int(np.floor(pos)), 0), S - 1)
        i1 = min(i0 + 1, S - 1, n - 1)
        frac = pos - i0
        return srt[i0] * (1.0 - frac) + srt[i1] * frac

    return q_at(lo), q_at(1.0 - lo)


def compute_map(P_hist, E_hist, A_hist, final: bool,
                credible_interval=0.95, want_ci: bool = True) -> dict:
    """MAP estimate (and credible intervals) from a window of samples.

    Steps (get_MAP_, utils.R:200-288): the mode of A; the samples matching
    it; each renormalised so the P columns sum to 1; the elementwise mean.

    Args:
      P_hist: (S, K, N) tensor; E_hist: (S, N, G) tensor, or None when the
        E history was not kept (ChainEnsemble store_E=False): the result
        then has no 'E' key and no E intervals (map_estimate.py:100-158);
      A_hist: (S, N).
      final: keep only the included signatures (keep_sigs) if True.
      want_ci: compute the elementwise credible intervals.
    Returns a dict with P, [E], A, A_full, keep_sigs, idx_mask, A_counts
    and, with want_ci, credible_intervals {P: {lower, upper}, [E: ...]};
    the arrays are numpy.
    """
    mode_row, mask, top = a_mode(np.asarray(A_hist))
    if final:
        keep_sigs = np.nonzero(mode_row == 1)[0]
        if keep_sigs.size == 0:
            keep_sigs = np.arange(mode_row.shape[0])
    else:
        keep_sigs = np.arange(mode_row.shape[0])
    host = lambda t: t.cpu().numpy()  # noqa: E731

    mask_d = torch.as_tensor(mask, device=P_hist.device)
    P_map, E_map, P_rn, E_rn = _masked_renorm_mean(P_hist, E_hist, mask_d)
    out = {
        "P": host(P_map)[:, keep_sigs],
        "A": mode_row[keep_sigs],
        "A_full": mode_row,
        "keep_sigs": keep_sigs,
        "idx_mask": mask,
        "A_counts": top,
    }
    if E_map is not None:
        out["E"] = host(E_map)[keep_sigs, :]
    if want_ci:
        lo = float((1.0 - credible_interval) / 2.0)
        P_lo, P_hi = (host(t) for t in _masked_quantiles(P_rn, mask, lo))
        out["credible_intervals"] = {
            "P": {"lower": P_lo[:, keep_sigs], "upper": P_hi[:, keep_sigs]}}
        if E_rn is not None:
            E_lo, E_hi = (host(t) for t in _masked_quantiles(E_rn, mask, lo))
            out["credible_intervals"]["E"] = {
                "lower": E_lo[keep_sigs, :], "upper": E_hi[keep_sigs, :]}
    return out


def map_quality_metrics(data: torch.Tensor, map_est: dict, G: int,
                        K: int, mesh=None) -> dict:
    """RMSE/KL/n_params/rank of a MAP estimate (compute_metrics_ with the
    final A recoded to ones, utils.R:419-423): Mhat = P @ E. On a mesh
    ``data`` is this rank's columns of G (the MAP's E is whole): the
    squared residuals and the KL terms are summed over them and
    all-reduced over the g group."""
    P = torch.as_tensor(map_est["P"], device=data.device)
    E = torch.as_tensor(map_est["E"], device=data.device)
    rank = float(np.sum(np.asarray(map_est["A_full"])))
    out = {"n_params": rank * (G + K), "rank": rank}
    if mesh is not None and mesh.n_g > 1:
        from ..parallel.mesh import G_AXIS, g_all_reduce, local

        Mh = m.mhat(P, torch.ones(P.shape[1], device=data.device),
                    local(E, (None, G_AXIS), mesh, G))
        d = Mh - data
        sums = g_all_reduce(torch.stack([
            torch.sum(d * d), m.padded_kl(Mh, data)]), mesh)
        return out | {"RMSE": float(torch.sqrt(sums[0] / float(K * G))),
                      "KL": float(sums[1])}
    Mh = m.mhat(P, torch.ones(P.shape[1], device=data.device), E)
    return {"RMSE": float(m.rmse(data, Mh)),
            "KL": float(m.padded_kl(Mh, data))} | out
