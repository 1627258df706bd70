"""The yardstick: the card's peaks and the work of one Gibbs step, counted
from the algorithm (Poisson likelihood, truncated-normal prior, exact MH
column updates, with SBFI/BFI rank learning or fixed inclusion masks).

The count belongs to the algorithm and not to a kernel form, so the fused
and the streaming step read the same bound at one shape:

- every input and state tensor is read once and every output written once
  (float32; the data matrix M once a step, shared by the chains);
- per (chain, k, g) entry, each column update's two passes (the
  conditional's sums, then the proposal's sums and likelihood ratio) and
  one rank-1 update of Mhat, which is kept and never charged a rebuild;
  with rank learning each inclusion update's term and its rank-1 update;
  the metrics row's four data terms;
- per entry of P and E, the hyper-update, a column update's epilogue (the
  conditional, the draw, the Hastings ratio and the decision), the metrics
  row's prior term and acceptance product, and the draws the algorithm
  needs, each special function weighted as the port's
  ``utils/measure.py`` weighted it when this benchmark was written (its
  ``STREAM_OPS`` pass counts, ``UPDATE_EPILOGUE_OPS``, ``ROW_PRIOR_OPS``,
  ``fused_bound``'s hyper-sweep and rank-1 terms, ``rng_bound``'s draw).

A component's count (``hyper``, one ``pcol`` column, one ``erow`` row, one
``acol`` column, the ``rdraw``, the ``row``, the ``draws``) is the work of
one update of every chain; ``step`` is their sum, with the step's own bytes.

This is the count of the configurations whose reference is
``poisson_tn_mh`` (``counts/poisson_tn_mh.py``); another model's count is a
file of its own under ``counts/``.
"""

from __future__ import annotations

# NVIDIA H100 SXM at 700 W (data sheet): HBM bandwidth, and float32 outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# per (chain, k, g) entry
PASS1_OPS = 11        # the conditional's sums (measure.STREAM_OPS pcol_stats)
PASS2_OPS = 20        # the proposal's sums and ratio terms (pcol_accept)
RANK1_OPS = 2         # Mhat += (new - old) * other (fused_bound)
INCL_OPS = 12         # an inclusion update's term (acol_delta)
ROW_DATA_OPS = 12     # the metrics row's four data terms (chain_metrics)
# per entry of P and E
HYPER_OPS = 60        # the exact Mu/Sigmasq update (fused_bound)
EPILOGUE_OPS = 150    # a column update's epilogue (UPDATE_EPILOGUE_OPS)
ROW_PRIOR_OPS = 35    # the row's prior term and acceptance product
# draws: the hyper-update's two normals and two uniforms, the
# proposal's two uniforms, the acceptance's one
DRAWS = 7
DRAW_OPS = 25         # one Philox4x32-10 draw (rng_bound)
# per chain
INCL_DECISION_OPS = 30  # an inclusion column's tempered odds and draw


def bound_s(n_ops: float, n_bytes: float) -> float:
    """The least seconds the card could take: the larger of the operations
    over the float32 peak and the bytes over HBM bandwidth."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)


def _f(n):
    return 4.0 * n


def hyper(K, N, G, C):
    kn_ng = K * N + N * G
    # read x, Mu, Sigmasq; write Mu, Sigmasq
    return C * HYPER_OPS * kn_ng, _f(C * 5 * kn_ng)


def pcol(K, N, G, C):
    """One P column of every chain: M and E's row read, the column's four
    planes (value, acceptance, Mu, Sigmasq) and A_n read, two written."""
    ops = (C * K * G * (PASS1_OPS + PASS2_OPS + RANK1_OPS)
           + C * K * EPILOGUE_OPS)
    return ops, _f(K * G + C * (G + 4 * K + 1 + 2 * K))


def erow(K, N, G, C):
    """One E row of every chain: the mirror over G entries."""
    ops = (C * K * G * (PASS1_OPS + PASS2_OPS + RANK1_OPS)
           + C * G * EPILOGUE_OPS)
    return ops, _f(K * G + C * (K + 4 * G + 1 + 2 * G))


def acol(K, N, G, C):
    """One inclusion column of every chain: M, P's column and E's row read,
    A_n read and written."""
    ops = C * K * G * (INCL_OPS + RANK1_OPS) + C * INCL_DECISION_OPS
    return ops, _f(K * G + C * (K + G + 2))


def rdraw(K, N, G, C):
    """The rank draw: the tempered log-likelihood of N + 1 ranks and the
    Gumbel-max, per chain."""
    return C * 10 * (N + 1), _f(C * (N + 2))


def row(K, N, G, C):
    """The metrics row: M and the state read once, 12 numbers written."""
    kn_ng = K * N + N * G
    ops = C * K * G * ROW_DATA_OPS + C * kn_ng * ROW_PRIOR_OPS
    return ops, _f(K * G + C * (4 * kn_ng + N + 12))


def draws(K, N, G, C, learning: bool):
    n = C * (DRAWS * (K * N + N * G) + (2 * N + 1 if learning else 0))
    return n * DRAW_OPS, 0.0


def components(K, N, G, C, learning: bool) -> dict:
    """name -> (operations, bytes, times a step runs it)."""
    out = {"hyper": hyper(K, N, G, C) + (1,),
           "pcol": pcol(K, N, G, C) + (N,),
           "erow": erow(K, N, G, C) + (N,),
           "row": row(K, N, G, C) + (1,),
           "draws": draws(K, N, G, C, learning) + (1,)}
    if learning:
        out["acol"] = acol(K, N, G, C) + (N,)
        out["rdraw"] = rdraw(K, N, G, C) + (1,)
    return out


def step(K, N, G, C, learning: bool):
    """(operations, bytes) of one step of C chains: the components'
    operations; M read once, the state's eight planes and A, R read and
    written once, the metrics row written."""
    ops = sum(o * n for o, _, n in components(K, N, G, C, learning).values())
    kn_ng = K * N + N * G
    n_bytes = _f(K * G + C * (2 * 4 * kn_ng + 2 * (N + 1) + 12))
    return ops, n_bytes


def step_bound_s(K, N, G, C, learning: bool) -> float:
    return bound_s(*step(K, N, G, C, learning))


def sweep_call(K, N, G, C, learning: bool):
    """(operations, bytes) of the fused sweep's call: the hyper-update, the
    2N column updates and with rank learning the R draw and the N inclusion
    updates, without the metrics row and the draws (other launches); M read
    once, the state read and written once."""
    parts = components(K, N, G, C, learning)
    ops = sum(o * n for k, (o, _, n) in parts.items()
              if k not in ("row", "draws"))
    kn_ng = K * N + N * G
    return ops, _f(K * G + C * (2 * 4 * kn_ng + 2 * (N + 1)))


def kernel_bound_s(name: str, K, N, G, C, learning: bool) -> float:
    """The bound of one update of every chain by a component's name, or of
    the fused sweep's call ("sweep")."""
    if name == "sweep":
        return bound_s(*sweep_call(K, N, G, C, learning))
    ops, n_bytes, _ = components(K, N, G, C, learning)[name]
    return bound_s(ops, n_bytes)
