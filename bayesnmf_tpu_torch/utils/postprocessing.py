"""Posterior-ensemble reference assignment, votes, and summaries.

The port's copy of the JAX package's utils/postprocessing.py
(postprocessing.R:18-341): every posterior sample in the MAP window is
Hungarian-assigned to the reference; votes are weighted by cosine
similarity; the majority vote fixes the final assignment; per-sample cosines
give credible intervals. It reads numpy arrays from the sampler (MAP,
``_gather_window``), so it runs on the host whatever device sampled.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from .assignment import hungarian_solve_batch, pairwise_cosine
from .cosmic import get_cosmic


def _resolve_reference(reference_P, K, row_names=None):
    if isinstance(reference_P, str):
        if reference_P != "cosmic":
            raise ValueError("reference_P must be a matrix or 'cosmic'")
        reference_P = get_cosmic()
    ref_names = None
    if isinstance(reference_P, pd.DataFrame):
        if row_names is not None and set(row_names) == set(reference_P.index):
            reference_P = reference_P.loc[list(row_names)]
        ref_names = list(reference_P.columns)
        reference_P = reference_P.to_numpy()
    reference_P = np.asarray(reference_P, np.float64)
    if reference_P.shape[0] != K:
        return None, None
    if ref_names is None:
        ref_names = [f"Ref{i+1}" for i in range(reference_P.shape[1])]
    return reference_P, ref_names


def assign_signatures_ensemble(sampler, reference_P="cosmic", idxs=None,
                               credible_interval=0.95):
    """Ensemble signature assignment with cosine-weighted majority voting.

    Returns {'assignments': DataFrame, 'votes': DataFrame} and caches the
    result on ``sampler.reference_comparison``
    (assign_signatures_ensemble_, postprocessing.R:175-341).
    """
    if sampler.MAP is None:
        sampler.get_MAP()
    K = sampler.spec.K
    row_names = getattr(sampler, "row_names", None)
    ref, ref_names = _resolve_reference(reference_P, K, row_names)
    if ref is None:
        raise ValueError(
            f"Reference matrix rows != data rows ({K}); cannot assign")

    # keep_sigs / sig_idx bookkeeping (postprocessing.R:212-220)
    A_full = np.asarray(sampler.MAP["A_full"])
    keep_sigs = np.asarray(sampler.MAP["keep_sigs"])
    if keep_sigs.size == sampler.spec.N and (A_full == 0).any():
        keep_sigs = np.nonzero(A_full == 1)[0]
        sampler.MAP["sig_idx"] = keep_sigs
    else:
        sampler.MAP["sig_idx"] = np.arange(keep_sigs.size)

    # memoization (postprocessing.R:225-247)
    rc = sampler.reference_comparison
    idx_arr = (np.asarray(idxs) if idxs is not None
               else np.asarray(sampler.MAP["idx"]))
    if (rc.get("reference_P") is not None
            and np.array_equal(rc.get("idxs", []), idx_arr)
            and np.array_equal(rc.get("keep_sigs", []), keep_sigs)
            and rc["reference_P"].shape == ref.shape
            and np.allclose(rc["reference_P"], ref)):
        return {"assignments": rc["assignments"], "votes": rc["votes"]}

    # gather posterior P samples over the window; map requested iterations
    # onto the gathered stack explicitly (one sample is recorded per
    # iteration, so the gathered stack ends at end_iter — but never assume
    # the requested idxs are contiguous or fully covered)
    end_iter = int(idx_arr.max())
    n_window = int(idx_arr.max() - idx_arr.min() + 1)
    P_h, _, _ = sampler._gather_window(end_iter, n_window)
    P_h = np.asarray(P_h)  # (S, K, N)
    gathered_iters = np.arange(end_iter - P_h.shape[0] + 1, end_iter + 1)
    sel = np.searchsorted(gathered_iters, idx_arr)
    covered = (sel < P_h.shape[0]) & (gathered_iters[np.clip(
        sel, 0, P_h.shape[0] - 1)] == idx_arr)
    if not covered.all():
        idx_arr = idx_arr[covered]
        sel = sel[covered]
    P_sel = P_h[sel][:, :, keep_sigs]  # (S, K, n)
    S, _, n_est = P_sel.shape
    n_ref = ref.shape[1]

    # batched cosine: normalize columns, one einsum
    Pn = P_sel / np.maximum(
        np.linalg.norm(P_sel, axis=1, keepdims=True), 1e-30)
    Rn = ref / np.maximum(np.linalg.norm(ref, axis=0, keepdims=True), 1e-30)
    sims = np.einsum("skn,kr->snr", Pn, Rn)  # (S, n_est, n_ref)

    # one Hungarian solve per posterior sample
    assign = hungarian_solve_batch(-sims)  # (S, n_est) ref col per est sig

    # cosine-weighted votes (postprocessing.R:269-295)
    votes_rows = []
    for e in range(n_est):
        cols = assign[:, e]
        valid = cols >= 0
        w = sims[np.arange(S), e, np.clip(cols, 0, n_ref - 1)] * valid
        tally = np.zeros(n_ref)
        np.add.at(tally, cols[valid], w[valid])
        total = tally.sum()
        props = tally / total if total > 0 else tally
        for r in np.nonzero(tally > 0)[0]:
            votes_rows.append({
                "sig_est": e + 1, "sig_ref": ref_names[r],
                "prop_votes": props[r]})
    votes = pd.DataFrame(votes_rows).sort_values(
        ["sig_est", "prop_votes"], ascending=[True, False]
    ).reset_index(drop=True)

    # majority vote → final assignment (postprocessing.R:297-306)
    final_ref = []
    for e in range(n_est):
        sub = votes[votes.sig_est == e + 1]
        final_ref.append(sub.iloc[0].sig_ref if len(sub) else None)
    ref_idx = np.array([ref_names.index(r) for r in final_ref])

    # MAP cosines + per-sample cosine CIs (postprocessing.R:308-329)
    P_map = np.asarray(sampler.MAP["P"])[:, sampler.MAP["sig_idx"]]
    map_cos = np.diag(pairwise_cosine(P_map, ref[:, ref_idx]))
    sample_cos = sims[:, np.arange(n_est), ref_idx]  # (S, n_est)
    lo = (1 - credible_interval) / 2
    q = np.quantile(sample_cos, [lo, 1 - lo], axis=0)

    assignments = pd.DataFrame({
        "sig_est": np.arange(1, n_est + 1),
        "sig_ref": final_ref,
        "MAP_cosine": map_cos,
        "lower_cosine": q[0],
        "upper_cosine": q[1],
    })

    sampler.reference_comparison = {
        "reference_P": ref,
        "reference_names": ref_names,
        "idxs": idx_arr,
        "keep_sigs": keep_sigs,
        "assignments": assignments,
        "votes": votes,
        "summary": None,
        "plots": {},
        "label_switching_df": None,
    }
    return {"assignments": assignments, "votes": votes}


def sampler_summary(sampler, reference_P="cosmic"):
    """Per-signature contribution summary (summary.bayesNMF_sampler,
    postprocessing.R:18-91)."""
    ref_available = True
    try:
        if reference_P is not None:
            res = assign_signatures_ensemble(sampler, reference_P)
            assignments = res["assignments"]
        else:
            ref_available = False
    except ValueError:
        ref_available = False

    rc = sampler.reference_comparison
    if ref_available and rc.get("summary") is not None:
        return rc["summary"]

    if sampler.MAP is None:
        sampler.get_MAP()
    E_map = np.asarray(sampler.MAP["E"])
    sig_idx = np.asarray(sampler.MAP["sig_idx"])
    n_est = sig_idx.size
    if not ref_available:
        assignments = pd.DataFrame({
            "sig_est": np.arange(1, n_est + 1),
            "sig_ref": [None] * n_est,
            "MAP_cosine": [np.nan] * n_est,
        })

    rows = []
    for i in range(len(assignments)):
        e = int(assignments.iloc[i].sig_est) - 1
        contrib = E_map[sig_idx[e], :]
        atleast1 = contrib >= 1
        rows.append({
            "G": sampler.spec.G, "N": sampler.spec.N, "K": sampler.spec.K,
            "Signature": e + 1,
            "Med_Contribution": (float(np.median(contrib[atleast1]))
                                 if atleast1.any() else np.nan),
            "Prop_atleast_1": float(np.mean(atleast1)),
            "Reference_Signature": assignments.iloc[i].sig_ref,
            "Cosine_Similarity": float(assignments.iloc[i].get(
                "MAP_cosine", np.nan)),
        })
    out = pd.DataFrame(rows)
    if ref_available:
        sampler.reference_comparison["summary"] = out
    return out


def summarize_samplers(sampler_dict, reference_P="cosmic"):
    """Concatenate summaries of several samplers (summarize_samplers,
    postprocessing.R:114-152)."""
    frames = []
    for name, s in sampler_dict.items():
        if not s.tracker.converged:
            print(f"not done: {name}")
            continue
        df = sampler_summary(s, reference_P).copy()
        df["Name"] = f"{name} ({s.spec.G})"
        frames.append(df)
    return pd.concat(frames, ignore_index=True) if frames else pd.DataFrame()
