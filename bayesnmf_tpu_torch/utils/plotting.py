"""Visualization suite (matplotlib): trace plots, signature plots, heatmaps,
label-switching diagnostics, attribution distributions.

The port's copy of the JAX package's utils/plotting.py (trace_plot.R,
postprocessing_visualizations.R). matplotlib is imported inside each
function that draws, so the module imports where matplotlib is missing. Each function returns the
Figure and optionally saves a PNG into the sampler's output dir, mirroring the
reference's file names (trace_plot.png, summary.png, similarity_heatmap.png,
label_switching.png, signature_dist.png, sig_<k>.png).
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import pandas as pd

from .cosmic import get_cosmic_colors


def _plt():
    """matplotlib.pyplot on the non-interactive Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, sampler, name: str, save: bool):
    if save and sampler.output_dir:
        fig.savefig(os.path.join(sampler.output_dir, name), dpi=120,
                    bbox_inches="tight")
    return fig


# ---------------------------------------------------------------------------
# trace plots — maps C25 (trace_plot.R:15-140)
# ---------------------------------------------------------------------------


def _phase_brackets(sampler, it_max: float):
    """Phase-region brackets (add_annotations + get_idx_annotations,
    trace_plot.R:154-254, :264-289): (xmin, xmax, height, label, color).

    Learning rank: Tempering [1, tempering-done] and MH Samples
    [convergence, iter]; always: Inference [iter - MAP_over, iter]. The
    MH-samples bracket is dropped for non-MH samplers (trace_plot.R:193-197).
    """
    segs = []
    temps = sampler.temp_sched
    conv_iter = sampler.tracker.converged_iter
    if sampler.spec.learning_rank:
        ones = np.nonzero(temps == 1.0)[0]
        done_temp = ones[0] if ones.size else None
        if done_temp is not None and sampler.iter >= done_temp:
            segs.append((1, done_temp, 0.25, "Tempering", "orange"))
    if sampler.spec.MH and conv_iter is not None:
        segs.append((conv_iter, sampler.iter, 0.25, "MH Samples", "#26428b"))
    segs.append((max(sampler.iter - sampler.cc.MAP_over, 1), sampler.iter,
                 0.62, "Inference", "#00b8b8"))
    return [(x0, min(x1, it_max), h, lab, c) for x0, x1, h, lab, c in segs]


def _draw_brackets(ax, segs, it_max: float):
    """Render bracket segments (horizontal bar + end tips + centered label)
    into a thin annotation strip axis."""
    ax.set_xlim(0, it_max * 1.02)
    ax.set_ylim(0, 1.15)
    ax.axis("off")
    for x0, x1, h, lab, color in segs:
        ax.plot([x0, x1], [h, h], color=color, lw=1.2)
        ax.plot([x0, x0], [h - 0.12, h], color=color, lw=1.2)
        ax.plot([x1, x1], [h - 0.12, h], color=color, lw=1.2)
        ax.text(x0 + (x1 - x0) / 2, h + 0.05, lab, color=color,
                fontsize=7, ha="center", va="bottom")


def trace_plot(sampler, MAP_means: bool = False, save: bool = False,
               metrics=None, annotations: bool = True):
    """Faceted metric traces over iterations (sample metrics or MAP metrics).

    Adds rank/n_params/temp facets when learning rank and acceptance-rate
    facets when MH, with convergence / tempering-done vlines and a bracket
    annotation strip marking the Tempering / MH Samples / Inference phase
    regions (trace_plot.R:15-140, add_annotations :154-254,
    get_idx_annotations :264-289).
    """
    plt = _plt()
    if MAP_means:
        if not sampler.MAP_metrics:
            raise ValueError("no MAP metrics yet")
        df = pd.DataFrame(sampler.MAP_metrics)
    else:
        df = sampler.sample_metrics
    base = ["RMSE", "KL", "loglikelihood", "logposterior", "BIC"]
    if metrics is None:
        metrics = list(base)
        if sampler.spec.learning_rank:
            metrics += ["rank", "n_params"]
            metrics += ["mean_temp"] if MAP_means else ["temp"]
        if sampler.spec.MH:
            metrics += ["P_mean_acceptance_rate", "E_mean_acceptance_rate"]
    metrics = [m_ for m_ in metrics if m_ in df.columns]

    ncol = 2
    nrow = -(-len(metrics) // ncol)
    it = df["iter"].to_numpy()
    conv_iter = sampler.tracker.converged_iter
    temps = sampler.temp_sched
    temper_done = None
    if sampler.spec.learning_rank and (temps < 1).any():
        below = np.nonzero(temps < 1)[0]
        temper_done = below.max() + 1 if below.size else None

    fig = plt.figure(figsize=(11, 2.2 * nrow + (0.45 if annotations else 0)))
    import matplotlib.gridspec as gridspec

    if annotations:
        gs = gridspec.GridSpec(nrow + 1, ncol, figure=fig,
                               height_ratios=[0.22] + [1.0] * nrow)
        strip = fig.add_subplot(gs[0, :])
        _draw_brackets(strip, _phase_brackets(sampler, float(it.max())),
                       float(it.max()))
        row0 = 1
    else:
        gs = gridspec.GridSpec(nrow, ncol, figure=fig)
        row0 = 0

    axes = []
    for i in range(len(metrics)):
        ax = fig.add_subplot(gs[row0 + i // ncol, i % ncol])
        axes.append(ax)
    for i, m_ in enumerate(metrics):
        ax = axes[i]
        ax.plot(it, df[m_].to_numpy(), ".", ms=2.5, color="#26428b")
        ax.set_title(m_, fontsize=9)
        ax.tick_params(labelsize=7)
        if conv_iter is not None:
            ax.axvline(conv_iter, color="green", lw=0.8, ls="--")
        if temper_done is not None and temper_done < it.max():
            ax.axvline(temper_done, color="orange", lw=0.8, ls=":")
        if sampler.MAP is not None and len(sampler.MAP.get("idx", [])):
            ax.axvspan(sampler.MAP["idx"].min(), sampler.MAP["idx"].max(),
                       alpha=0.12, color="gray")
    fig.suptitle("MAP metrics" if MAP_means else "Sample metrics", fontsize=11)
    fig.tight_layout()
    name = "trace_plot_MAP.png" if MAP_means else "trace_plot.png"
    return _save(fig, sampler, name, save)


# ---------------------------------------------------------------------------
# signature bar plot — plot_sig (postprocessing_visualizations.R:268-460)
# ---------------------------------------------------------------------------

_MUT_RE = re.compile(r"^([ACGT])\[([ACGT])>([ACGT])\]([ACGT])$")


def _substitution_classes(row_names):
    out = []
    for r in row_names:
        m_ = _MUT_RE.match(str(r))
        out.append(f"{m_.group(2)}>{m_.group(3)}" if m_ else None)
    return out


def plot_sig(sampler, sig: int = 1, reference_P="cosmic", ref="assigned",
             ref_sig=None, save: bool = False, title=None):
    """96-trinucleotide bar chart of one signature: MAP point estimates with
    95% CI errorbars overlaid on reference bars.

    ``ref`` selects the reference column like the reference's plot_sig
    (postprocessing_visualizations.R:294-314): 'assigned' uses the
    posterior-ensemble vote assignment; 'best' Hungarian-matches THIS MAP
    column alone against the whole reference (the best cosine match,
    regardless of what the ensemble vote settled on); any other string is a
    reference column name. ``ref_sig`` is a deprecated alias for a named ref.
    """
    plt = _plt()
    if sampler.MAP is None:
        sampler.get_MAP()
    sig_idx = np.asarray(sampler.MAP["sig_idx"])
    P_map = np.asarray(sampler.MAP["P"])[:, sig_idx[sig - 1]]
    K = P_map.shape[0]
    row_names = getattr(sampler, "row_names", None) or [str(i) for i in range(K)]

    ci = sampler.credible_intervals
    lo = hi = None
    if ci is not None:
        lo = np.asarray(ci["P"]["lower"])[:, sig - 1]
        hi = np.asarray(ci["P"]["upper"])[:, sig - 1]

    if ref_sig is not None:
        ref = ref_sig
    ref_col = None
    ref_name = None
    mode_note = ""
    if reference_P is not None and ref is not None:
        try:
            if ref == "best":
                # best cosine match of this column alone
                # (hungarian_assignment on a single column,
                # postprocessing_visualizations.R:305-309)
                from .assignment import pairwise_cosine
                from .postprocessing import _resolve_reference

                refM, ref_names = _resolve_reference(
                    reference_P, K, getattr(sampler, "row_names", None))
                if refM is None:
                    raise ValueError("reference rows != data rows")
                sim = pairwise_cosine(P_map[:, None], refM)[0]
                ref_name = ref_names[int(np.argmax(sim))]
                ref_col = refM[:, int(np.argmax(sim))]
                mode_note = f"\nBest match in reference is {ref_name}"
            else:
                res = sampler.assign_signatures_ensemble(reference_P)
                a = res["assignments"]
                if ref == "assigned":
                    ref_name = a[a.sig_est == sig].iloc[0].sig_ref
                    mode_note = f"\nAssigned signature is {ref_name}"
                else:
                    ref_name = ref
                rc = sampler.reference_comparison
                j = rc["reference_names"].index(ref_name)
                ref_col = rc["reference_P"][:, j]
            ref_col = ref_col / max(ref_col.sum(), 1e-30) * P_map.sum()
        except (ValueError, IndexError):
            ref_col = None

    classes = _substitution_classes(row_names)
    colors = get_cosmic_colors()
    bar_colors = [colors.get(c, (0.5, 0.5, 0.5)) for c in classes]

    fig, ax = plt.subplots(figsize=(14, 3.2))
    x = np.arange(K)
    if ref_col is not None:
        ax.bar(x, ref_col, color=bar_colors, alpha=0.45,
               label=f"reference {ref_name}")
    ax.errorbar(x, P_map,
                yerr=None if lo is None else np.stack([P_map - lo, hi - P_map]),
                fmt="o", ms=2.5, lw=0.8, color="black", label="MAP (95% CI)")
    ax.set_xticks(x)
    ax.set_xticklabels(row_names, rotation=90, fontsize=4)
    ax.set_title((title or f"Signature {sig}") + mode_note, fontsize=10)
    ax.legend(fontsize=7)
    fig.tight_layout()
    return _save(fig, sampler, f"sig_{sig}.png", save)


# ---------------------------------------------------------------------------
# similarity heatmap (postprocessing_visualizations.R:170-238)
# ---------------------------------------------------------------------------


def plot_similarity_heatmap(sampler, reference_P="cosmic", save: bool = False):
    plt = _plt()
    from .assignment import pairwise_cosine

    res = sampler.assign_signatures_ensemble(reference_P)
    rc = sampler.reference_comparison
    P_map = np.asarray(sampler.MAP["P"])[:, np.asarray(sampler.MAP["sig_idx"])]
    sim = pairwise_cosine(P_map, rc["reference_P"])
    keep = [rc["reference_names"].index(r)
            for r in res["assignments"].sig_ref if r in rc["reference_names"]]
    extra = [j for j in np.argsort(-sim.max(axis=0)) if j not in keep][:10]
    cols = keep + list(extra)
    fig, ax = plt.subplots(figsize=(0.45 * len(cols) + 2, 0.5 * sim.shape[0] + 1.5))
    im = ax.imshow(sim[:, cols], cmap="viridis", vmin=0, vmax=1, aspect="auto")
    ax.set_xticks(range(len(cols)))
    ax.set_xticklabels([rc["reference_names"][j] for j in cols],
                       rotation=90, fontsize=7)
    ax.set_yticks(range(sim.shape[0]))
    ax.set_yticklabels([f"Est{i+1}" for i in range(sim.shape[0])], fontsize=7)
    for i in range(sim.shape[0]):
        for jj, j in enumerate(cols):
            ax.text(jj, i, f"{sim[i, j]:.2f}", ha="center", va="center",
                    fontsize=5.5,
                    color="white" if sim[i, j] < 0.6 else "black")
    fig.colorbar(im, ax=ax, shrink=0.7)
    ax.set_title("cosine similarity to reference", fontsize=10)
    fig.tight_layout()
    return _save(fig, sampler, "similarity_heatmap.png", save)


# ---------------------------------------------------------------------------
# summary dot plot (plot_summary, :499-582)
# ---------------------------------------------------------------------------


def plot_summary(sampler, reference_P="cosmic", save: bool = False):
    plt = _plt()
    df = sampler.summary(reference_P)
    fig, ax = plt.subplots(figsize=(7, 0.5 * len(df) + 1.5))
    contrib = df["Med_Contribution"].to_numpy(float)
    cos = df["Cosine_Similarity"].to_numpy(float)
    y = np.arange(len(df))
    sizes = 40 + 360 * np.nan_to_num(cos, nan=0.3) ** 4
    sc = ax.scatter(df["Prop_atleast_1"], y, s=sizes,
                    c=np.log2(np.maximum(contrib, 1.0)), cmap="plasma")
    labels = [f"{int(s)} → {r}" if r is not None else str(int(s))
              for s, r in zip(df["Signature"], df["Reference_Signature"])]
    ax.set_yticks(y)
    ax.set_yticklabels(labels, fontsize=8)
    ax.set_xlabel("proportion of samples with ≥1 attributed mutation",
                  fontsize=8)
    fig.colorbar(sc, ax=ax, label="log2 median contribution", shrink=0.8)
    ax.set_title("signature summary (size = cosine similarity)", fontsize=10)
    fig.tight_layout()
    return _save(fig, sampler, "summary.png", save)


# ---------------------------------------------------------------------------
# label switching diagnostic (plot_label_switching, :598-787)
# ---------------------------------------------------------------------------


def plot_label_switching(sampler, reference_P="cosmic", save: bool = False,
                         combine_below: float = 0.05, max_iters: int = 2000):
    """Per-iteration per-factor assigned-reference tile diagnostic.

    Requires save_all_samples; assigns every stored posterior P sample to the
    reference and shows the assignment per factor over iterations, with rare
    assignments bucketed into 'Other'."""
    plt = _plt()
    from .assignment import hungarian_solve_batch

    if sampler._archive is None:
        raise ValueError("label switching diagnostic requires "
                         "save_all_samples=True")
    rc_ref, ref_names = None, None
    res = sampler.assign_signatures_ensemble(reference_P)
    rc = sampler.reference_comparison
    rc_ref, ref_names = rc["reference_P"], rc["reference_names"]

    P_all = np.concatenate([c["P"] for c in sampler._archive])  # (S,K,N)
    A_all = np.concatenate([c["A"] for c in sampler._archive])  # (S,N)
    stride = max(len(P_all) // max_iters, 1)
    P_all, A_all = P_all[::stride], A_all[::stride]
    S, K, N = P_all.shape
    Pn = P_all / np.maximum(np.linalg.norm(P_all, axis=1, keepdims=True), 1e-30)
    Rn = rc_ref / np.maximum(np.linalg.norm(rc_ref, axis=0, keepdims=True), 1e-30)
    sims = np.einsum("skn,kr->snr", Pn, Rn)
    assign = hungarian_solve_batch(-sims)  # (S, N)

    # bucket rare assignments as "Other"
    counts = np.bincount(assign[assign >= 0].ravel(), minlength=rc_ref.shape[1])
    common = np.nonzero(counts / max(counts.sum(), 1) >= combine_below / N)[0]
    label_of = {j: i for i, j in enumerate(common)}
    n_labels = len(common) + 1
    img = np.full((N, S), n_labels - 1, int)
    for s in range(S):
        for n in range(N):
            j = assign[s, n]
            if j in label_of:
                img[n, s] = label_of[j]

    fig, ax = plt.subplots(figsize=(10, 0.45 * N + 1.5))
    cmap = plt.get_cmap("tab20", n_labels)
    ax.imshow(img, aspect="auto", cmap=cmap, interpolation="nearest")
    # inclusion markers: dim excluded factors
    for n in range(N):
        excl = np.nonzero(A_all[:, n] == 0)[0]
        if excl.size:
            ax.scatter(excl, np.full(excl.size, n), s=0.4, c="white",
                       marker="|")
    ax.set_yticks(range(N))
    ax.set_yticklabels([f"factor {n+1}" for n in range(N)], fontsize=7)
    ax.set_xlabel(f"iteration (stride {stride})", fontsize=8)
    handles = [plt.Rectangle((0, 0), 1, 1, fc=cmap(i))
               for i in range(n_labels)]
    names = [ref_names[j] for j in common] + ["Other"]
    ax.legend(handles, names, fontsize=6, ncol=4, loc="upper center",
              bbox_to_anchor=(0.5, -0.25))
    ax.set_title("label switching: assigned reference per factor", fontsize=10)
    fig.tight_layout()
    return _save(fig, sampler, "label_switching.png", save)


# ---------------------------------------------------------------------------
# attribution distribution (plot_signature_dist, :802-907)
# ---------------------------------------------------------------------------


def plot_signature_dist(sampler, subjects=None, reference_P="cosmic",
                        save: bool = False,
                        title="Distribution of Signature Allocation"):
    """Per-mutation-type stacked attribution + residual vs observed counts.

    Reference semantics (plot_signature_dist, postprocessing_visualizations
    .R:802-907): for each mutation type k (x axis), stack each included
    signature's attributed counts ``P[k,n] * Σ_{g∈subjects} E[n,g]`` PLUS the
    residual ``Σ_g (M - M̂)[k,g]`` (split into positive and negative residual
    series, :878-886), with the observed row totals overlaid as dots. One
    deliberate deviation: M̂ here is the MAP reconstruction P_MAP @ E_MAP
    (the reference mixes MAP attribution with the *current-iteration* M̂ from
    sampler$get_Mhat(), :836 — incoherent across the two layers).
    """
    plt = _plt()
    if sampler.MAP is None:
        sampler.get_MAP()
    sig_idx = np.asarray(sampler.MAP["sig_idx"])
    P_map = np.asarray(sampler.MAP["P"])[:, sig_idx]   # (K, n)
    E_map = np.asarray(sampler.MAP["E"])[sig_idx]      # (n, G)
    data = sampler.data
    data = (data.cpu().numpy() if hasattr(data, "cpu")
            else np.asarray(data))
    K, G = data.shape
    subjects = np.arange(G) if subjects is None else np.asarray(subjects)
    n_sig = P_map.shape[1]

    # per-signature attributed counts per mutation type: (K, n)
    e_tot = E_map[:, subjects].sum(axis=1)             # (n,)
    counts = P_map * e_tot[None, :]
    # residual vs the MAP reconstruction, split +/- like the reference
    Mhat = P_map @ E_map
    resid = (data[:, subjects] - Mhat[:, subjects]).sum(axis=1)  # (K,)
    observed = data[:, subjects].sum(axis=1)

    try:
        res = sampler.assign_signatures_ensemble(reference_P)
        names = list(res["assignments"].sig_ref)
    except (ValueError, TypeError):
        names = [f"Signature{i+1}" for i in range(n_sig)]

    row_names = (getattr(sampler, "row_names", None)
                 or [str(i) for i in range(K)])
    classes = _substitution_classes(row_names)
    order = (np.lexsort((row_names, [c or "" for c in classes]))
             if any(classes) else np.arange(K))

    fig, ax = plt.subplots(figsize=(14, 3.5))
    x = np.arange(K)
    cmap = plt.get_cmap("tab10")
    bottom = np.zeros(K)
    for i in range(n_sig):
        ax.bar(x, counts[order, i], bottom=bottom, width=0.9,
               color=cmap(i % 10), label=names[i])
        bottom += counts[order, i]
    pos = np.maximum(resid[order], 0.0)
    neg = np.minimum(resid[order], 0.0)
    if (pos > 0).any():
        ax.bar(x, pos, bottom=bottom, width=0.9, color="#bbbbbb",
               label="resid (+)")
    if (neg < 0).any():
        ax.bar(x, neg, width=0.9, color="#666666", label="resid (−)")
    ax.plot(x, observed[order], "k.", ms=3, label="observed")
    ax.set_xticks(x)
    ax.set_xticklabels([row_names[j] for j in order], rotation=90, fontsize=4)
    ax.set_ylabel("Count", fontsize=8)
    ax.legend(fontsize=6, ncol=4)
    ax.set_title(title, fontsize=10)
    fig.tight_layout()
    return _save(fig, sampler, "signature_dist.png", save)


# ---------------------------------------------------------------------------
# orchestrator — plot.bayesNMF_sampler (postprocessing_visualizations.R:12-153)
# ---------------------------------------------------------------------------


def plot_sampler(sampler, reference_P="cosmic", sigs: bool = False,
                 save: bool = True):
    """Generate and save the full result-plot suite; returns {name: Figure}."""
    plt = _plt()
    figs = {}
    figs["summary"] = plot_summary(sampler, reference_P, save=save)
    figs["similarity_heatmap"] = plot_similarity_heatmap(
        sampler, reference_P, save=save)
    if sampler.spec.learning_rank and sampler._archive is not None:
        try:
            figs["label_switching"] = plot_label_switching(
                sampler, reference_P, save=save)
        except ValueError:
            pass
    figs["signature_dist"] = plot_signature_dist(
        sampler, reference_P=reference_P, save=save)
    if sigs:
        for i in range(len(np.asarray(sampler.MAP["sig_idx"]))):
            figs[f"sig_{i+1}"] = plot_sig(sampler, i + 1, reference_P,
                                          save=save)
    if save and sampler.output_dir:
        sampler.save_object()
    plt.close("all")
    return figs
