"""Cosine similarity and Hungarian reference assignment.

Port of the JAX package's utils/assignment.py (helpers.R:218-398). The
Hungarian solve is ``scipy.optimize.linear_sum_assignment``, the JAX
module's own fallback.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
from scipy.optimize import linear_sum_assignment


def hungarian_solve(cost: np.ndarray) -> np.ndarray:
    """Minimum-cost assignment of rows to columns; -1 for unassigned rows."""
    cost = np.asarray(cost, np.float64)
    rows, cols = linear_sum_assignment(cost)
    out = np.full(cost.shape[0], -1, np.int32)
    out[rows] = cols
    return out


def hungarian_solve_batch(costs: np.ndarray) -> np.ndarray:
    """Batch of independent assignments: (B, R, C) -> (B, R) columns."""
    costs = np.asarray(costs, np.float64)
    if costs.shape[0] == 0:
        return np.zeros(costs.shape[:2], np.int32)
    return np.stack([hungarian_solve(c) for c in costs])


def pairwise_cosine(mat1: np.ndarray, mat2: np.ndarray,
                    which: str = "cols") -> np.ndarray:
    """All-pairs cosine similarity between columns (or rows) of two
    matrices (pairwise_sim, helpers.R:218-267)."""
    a = np.asarray(mat1, np.float64)
    b = np.asarray(mat2, np.float64)
    if which == "cols":
        a, b = a.T, b.T
    if a.shape[1] != b.shape[1]:
        raise ValueError(
            f"Different number of overlapping dims: {a.shape[1]} != "
            f"{b.shape[1]}")
    an = a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-30)
    bn = b / np.maximum(np.linalg.norm(b, axis=1, keepdims=True), 1e-30)
    return an @ bn.T


def hungarian_assignment(
    estimated_P,
    reference_P="cosmic",
    which: str = "cols",
    keep_all_est: bool = True,
    keep_all_ref: bool = False,
    return_mat: bool = False,
    check_reference_order: bool = True,
    est_names=None,
    ref_names=None,
):
    """Assign estimated factors to reference factors maximising the total
    cosine (hungarian_assignment, helpers.R:287-398), with the square
    padding by zero-cosine 'None' rows or columns."""
    from .cosmic import get_cosmic

    est_df = None
    if isinstance(estimated_P, pd.DataFrame):
        est_df = estimated_P
        estimated_P = est_df.to_numpy()
    if isinstance(reference_P, str):
        if reference_P != "cosmic":
            raise ValueError("reference_P must be a matrix or 'cosmic'")
        reference_P = get_cosmic()
    ref_df = reference_P if isinstance(reference_P, pd.DataFrame) else None
    if ref_df is not None:
        if check_reference_order and est_df is not None:
            if set(est_df.index) == set(ref_df.index):
                ref_df = ref_df.loc[est_df.index]
        reference_P = ref_df.to_numpy()

    sim = pairwise_cosine(estimated_P, reference_P, which=which)

    if ref_names is None:
        ref_names = (list(ref_df.columns) if ref_df is not None
                     else [f"Ref{i+1}" for i in range(sim.shape[1])])
    if est_names is None:
        est_names = (list(est_df.columns) if est_df is not None
                     else [f"Est{i+1}" for i in range(sim.shape[0])])

    cols = hungarian_solve(-sim)
    rows = [i for i in range(sim.shape[0]) if cols[i] >= 0]
    col_list = [int(cols[i]) for i in rows]
    if keep_all_est:
        rows += [i for i in range(sim.shape[0]) if i not in rows]
    if keep_all_ref:
        col_list += [j for j in range(sim.shape[1]) if j not in col_list]

    re_sim = sim[np.ix_(rows, col_list)] if col_list else sim[rows][:, :0]
    row_names = [est_names[i] for i in rows]
    col_names = [ref_names[j] for j in col_list]
    nr, nc = re_sim.shape
    if nr > nc:
        re_sim = np.concatenate([re_sim, np.zeros((nr, nr - nc))], axis=1)
        col_names += ["None"] * (nr - nc)
    elif nc > nr:
        re_sim = np.concatenate([re_sim, np.zeros((nc - nr, nc))], axis=0)
        row_names += ["None"] * (nc - nr)

    if return_mat:
        return pd.DataFrame(re_sim, index=row_names, columns=col_names)
    return pd.DataFrame({
        "sig_est": row_names,
        "sig_ref": col_names,
        "cos_sim": np.diag(re_sim),
    })
