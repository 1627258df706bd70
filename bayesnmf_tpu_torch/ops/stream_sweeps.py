"""Streaming reductions of the large-G MH sweeps: no (chains, K, G) tensor.

Port of bayesnmf_tpu/ops/pallas_stream_sweeps.py. Each function rebuilds
the Mhat tile from ``PA = P * A`` and an E tile and returns only reductions:

- ``pcol_stats`` / ``pcol_accept``: one P column's conditional sums over G
  (``_run`` with col=True);
- ``erow_stats`` / ``erow_accept``: one E row's sums over K (col=False);
- ``acol_delta``: loglik(A_n = 1) - loglik(A_n = 0) for one column;
- ``chain_metrics``: the four data-dependent sums of the metrics row;
- ``stream_metrics_row``: the whole metrics row of every chain from the
  state (chain_metrics' sums, the truncated-normal or exponential prior
  term, the
  acceptance means and the host arithmetic of the JAX package's
  models/gibbs.py::_metrics_row, :293-347) in two launches: a pass over the
  G tiles and a finishing kernel per chain;
- ``stream_pcol_update`` / ``stream_erow_update``: whole column updates of
  the exact-MH sweeps (the sums, the conditional, the draw, the Hastings
  ratio, the decision and the write-back of the JAX package's
  models/updates.py::stream_sweep_P/E, :539-725, with the truncnormal or
  the exponential prior, a runtime argument) in kernels: one launch per
  E row; two passes over the G tiles per P column, each followed by a small
  finishing kernel; the launches of a sweep enqueued by one C call;
- ``stream_acol_update``: whole inclusion-column updates (the delta, the
  SBFI penalty, the tempered sigmoid, the NaN fallback, the Bernoulli draw
  and the write of A[:, n] of models/updates.py::stream_sweep_A, :838-872)
  in kernels: a pass over the G tiles and a finishing kernel per column,
  the launches of a sweep enqueued by one C call.

The signatures and the pre-scaling contract are the JAX package's
(pallas_stream_sweeps.py:357-359): P-column functions take ``pn = A_n*P_n``
and ``prop = A_n*proposal`` with ``en`` raw; E-row functions take
``en = A_n*E_n`` and ``prop = A_n*proposal`` with ``pn`` raw. Every
per-chain operand may carry a leading chain axis C; ``data`` (K, G) is
shared by the chains.

On CUDA tensors the wrappers launch the hand-written kernels of
csrc/stream_sweeps.cu or raise; on CPU tensors they run the plain PyTorch
version below, which evaluates every per-element term in the kernel's order
and sums in float64, tile by tile, as the kernel does.

Tolerance between kernel and plain version on the card: rtol 1e-6 and
atol 1e-6 (``KERNEL_RTOL``/``KERNEL_ATOL``) for the sums: each per-element
term rounds the same way in both, and the float64 sums differ only in their
order, so the float32 results differ by at most an ulp or two. A column
update must take the same decisions as its plain version: for an A column
the same A and NaN counts, with its delta within the sums' tolerance. A P
column's or E row's values are held to rtol 1e-5 and atol 1e-6
(``UPDATE_RTOL``/``UPDATE_ATOL``): an ulp in a sum moves the conditional's
mean by an ulp, and a draw mu + sd*z near 0 keeps the absolute rounding of
mu. Its recorded acceptances (the Hastings ratio) are held to rtol 1e-4
(``RATIO_RTOL``): the kernel's log_ndtr, ndtri, ndtr and sigmoid equal
PyTorch's at all 4,194,304 arguments checked on the card, but a float64 sum
added in another order can still round to the neighbouring float32, and
where the log-likelihood part of the log ratio is ~1e3 one ulp of the sum
is 6e-5 (every checked column update was bit-identical on the card). The
metrics row holds it, n_params, sum A and the temperature exactly and every
other entry to the sums' tolerance.

Limits of the kernels: the envelope (ops.MAX_K rows, ops.MAX_N
components: the register tile is built for N up to 128). The column tiles'
G width is a function of K and N (``col_tile``: 64, then 32 or 16 where a
K x (width + 1) data tile would not fit an SM's shared memory), and the
plain versions sum in tiles of the same width; an E-row block stages P*A
whole, or in chunks of rows where it would not fit (``erow_rows``).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import MAX_N, check_envelope
from . import distributions as dist
from . import math as m

_FLOOR = 1e-6
# a plain-version tile: bounds the (C, K, tile) temporaries on the CPU; a
# multiple of the kernels' G tile
_PLAIN_TILE = 4096
# what a block can opt in to on an H100
_SMEM_MAX_BYTES = 227 * 1024
# threads of a P- or A-column tile block
_COL_THREADS = 384
# G widths of a P-column, A-column or metrics tile, widest first
_COL_TILES = (64, 32, 16)
# rows the register tile takes at once (csrc/stream_sweeps.cu kUnroll)
_UNROLL = 4

KERNEL_RTOL = 1e-6
KERNEL_ATOL = 1e-6
UPDATE_RTOL = 1e-5
UPDATE_ATOL = 1e-6
RATIO_RTOL = 1e-4


# ---------------------------------------------------------------------------
# plain PyTorch version (the CPU path, and what the kernels are checked
# against)
# ---------------------------------------------------------------------------


def _mhat_tile(PA, E_t):
    """Mhat tile (C, K, Gt) = sum_n PA[:, :, n] E_t[:, n, :], n in order, in
    float32: the kernel's loop, not torch.matmul."""
    Mh = PA[:, :, 0:1] * E_t[:, 0:1, :]
    for n in range(1, PA.shape[2]):
        Mh = Mh + PA[:, :, n:n + 1] * E_t[:, n:n + 1, :]
    return Mh


def _tiles(G):
    return [(g0, min(g0 + _PLAIN_TILE, G)) for g0 in range(0, G, _PLAIN_TILE)]


def _col_terms(data, Mh, en, pn, prop):
    """P-column per-element terms (C, K, Gt); pn/prop (C, K, 1), en
    (C, 1, Gt)."""
    if prop is None:
        inv = torch.reciprocal(Mh.clamp_min(_FLOOR))
        resid = data - (Mh - pn * en)
        return (resid * inv) * en, inv * (en * en)
    Mh_no = Mh - pn * en
    lam = Mh.clamp_min(_FLOOR)
    lam_new = (Mh_no + prop * en).clamp_min(_FLOOR)
    d = lam_new - lam
    invr = torch.reciprocal(lam_new)
    resid = data - Mh_no
    return (data * torch.log1p(d / lam) - d, (resid * invr) * en,
            invr * (en * en))


def _row_terms(data, Mh, en, pn, prop):
    """E-row per-element terms (C, K, Gt); pn (C, K, 1), en/prop
    (C, 1, Gt)."""
    if prop is None:
        inv = torch.reciprocal(Mh.clamp_min(_FLOOR))
        resid = data - (Mh - pn * en)
        return (resid * inv) * pn, inv * (pn * pn)
    Mh_no = Mh - pn * en
    lam = Mh.clamp_min(_FLOOR)
    lam_new = (Mh_no + pn * prop).clamp_min(_FLOOR)
    d = lam_new - lam
    invr = torch.reciprocal(lam_new)
    resid = data - Mh_no
    return (data * torch.log1p(d / lam) - d, (resid * invr) * pn,
            invr * (pn * pn))


def _sum64(x, dims):
    return x.sum(dims, dtype=torch.float64)


def run_reference(data, E, PA, en, pn, prop, col: bool):
    """Plain version of ``_run`` on chain-batched operands: returns the
    2 (stats) or 3 (accept) outputs, each (C, K) for a P column or (C, G)
    for an E row."""
    G = E.shape[2]
    pn3 = pn.unsqueeze(-1)
    acc = None
    outs_row = []
    for g0, g1 in _tiles(G):
        Mh = _mhat_tile(PA, E[:, :, g0:g1])
        en3 = en[:, None, g0:g1]
        d_t = data[:, g0:g1]
        if col:
            q = None if prop is None else prop.unsqueeze(-1)
            sums = [_sum64(x, -1) for x in _col_terms(d_t, Mh, en3, pn3, q)]
            acc = sums if acc is None else [a + s for a, s in zip(acc, sums)]
        else:
            q = None if prop is None else prop[:, None, g0:g1]
            outs_row.append([_sum64(x, -2)
                             for x in _row_terms(d_t, Mh, en3, pn3, q)])
    if col:
        return tuple(a.to(torch.float32) for a in acc)
    return tuple(torch.cat(parts, -1).to(torch.float32)
                 for parts in zip(*outs_row))


def acol_delta_reference(data, E, PA, en, pn, an):
    """Plain version of ``acol_delta``: (C,) deltas."""
    acc = torch.zeros(E.shape[0], dtype=torch.float64, device=E.device)
    pn3, an3 = pn.unsqueeze(-1), an.view(-1, 1, 1)
    for g0, g1 in _tiles(E.shape[2]):
        Mh = _mhat_tile(PA, E[:, :, g0:g1])
        contrib = pn3 * en[:, None, g0:g1]
        Mh_off = Mh - an3 * contrib
        lam_off = Mh_off.clamp_min(_FLOOR)
        lam_on = (Mh_off + contrib).clamp_min(_FLOOR)
        d = lam_on - lam_off
        acc = acc + _sum64(data[:, g0:g1] * torch.log1p(d / lam_off) - d,
                           (-2, -1))
    return acc.to(torch.float32)


def acol_update_reference(data, E, P, A, logit_p1, temperature, u, n_nan,
                          penalty, n: int):
    """Plain version of one A-column update (column ``n``), in place on A
    (C, N) and n_nan (C,): the host sequence of the JAX package's
    stream_sweep_A body on chain-batched operands. ``logit_p1`` (C,) the
    prior log-odds, ``temperature`` a number or a one-element tensor,
    ``u`` (C, N), ``penalty`` the SBFI penalty or None (BFI). Returns the
    column's delta (C,) before the penalty."""
    delta = acol_delta_reference(data, E, P * A.unsqueeze(1),
                                 E[:, n, :].contiguous(),
                                 P[:, :, n].contiguous(), A[:, n].contiguous())
    x = delta if penalty is None else delta - penalty
    p = torch.sigmoid(logit_p1 + temperature * x)
    is_nan = torch.isnan(p)
    n_nan += is_nan.to(torch.float32)
    p = torch.where(is_nan, 0.5, p)
    A[:, n] = dist.bernoulli_from_u(u[:, n], p)
    return delta


def _data_terms(data, E, PA, g0, g1):
    """The four data terms of the metrics row over G columns g0..g1-1,
    (C, K, g1 - g0) each: M log lam, lam, max(M, 1e-6) log lam and
    (Mhat - M)^2, lam = max(Mhat, 1e-6)."""
    Mh = _mhat_tile(PA, E[:, :, g0:g1])
    d_t = data[:, g0:g1]
    lam = Mh.clamp_min(_FLOOR)
    L = torch.log(lam)
    d = Mh - d_t
    return d_t * L, lam, d_t.clamp_min(1e-6) * L, d * d


def _tile_sums(x, gt):
    """Float64 sums of x (C, R, W) over R and each gt-wide G tile of W, as
    the kernels' tile blocks sum: (C, ceil(W / gt))."""
    C, R, W = x.shape
    pad = -W % gt
    if pad:
        x = torch.cat([x, x.new_zeros(C, R, pad)], -1)
    return x.view(C, R, -1, gt).sum((1, 3), dtype=torch.float64)


def chain_metrics_reference(data, E, PA):
    """Plain version of ``chain_metrics``: four (C,) sums."""
    gt = _col_tile(*PA.shape[1:])
    parts = [torch.stack([_tile_sums(x, gt) for x in
                          _data_terms(data, E, PA, g0, g1)], 1)
             for g0, g1 in _tiles(E.shape[2])]
    return tuple(torch.cat(parts, -1).sum(-1).to(torch.float32).unbind(1))


def _logprior(x, hp0, hp1, expo):
    """The prior log-density of every entry (ops/math.py): the exponential
    one with hp0 = Lambda, or the truncated normal with hp0, hp1 = Mu,
    Sigmasq."""
    if expo:
        return m.exponential_logpdf(x, hp0)
    return m.truncnorm_logpdf(x, hp0, hp1)


def stream_metrics_row_reference(data, P, E, A, acc_P, acc_E, Mu_p,
                                 Sigmasq_p, Mu_e, Sigmasq_e, lgamma_sum,
                                 mlogm_sum, na_events, it, temperature,
                                 expo: bool = False):
    """Plain version of ``stream_metrics_row``: the (C, 12) metrics rows.
    Every per-element term is the kernels' in their order; the sums run in
    float64 over each G tile of the kernels' width (``col_tile``), then
    over the tiles, and are rounded to float32 once; the row's arithmetic
    rounds each operation as the
    finishing kernel does, dividing by 0-d tensors where a Python number
    would be taken as a reciprocal on the card."""
    C, K, N = P.shape
    G = E.shape[2]
    gt = _col_tile(K, N)
    PA = P * A.unsqueeze(1)
    parts = []
    for g0, g1 in _tiles(G):
        terms = _data_terms(data, E, PA, g0, g1) + (
            _logprior(E[:, :, g0:g1], Mu_e[:, :, g0:g1],
                      None if expo else Sigmasq_e[:, :, g0:g1], expo),
            acc_E[:, :, g0:g1] * A.unsqueeze(-1))
        parts.append(torch.stack([_tile_sums(x, gt) for x in terms], 1))
    (m_loglam, lam_sum, mp_loglam, sq_err, lp_e,
     acc_e) = torch.cat(parts, -1).sum(-1).to(torch.float32).unbind(1)
    lp_p = _sum64(_logprior(P, Mu_p, Sigmasq_p, expo), (1, 2))
    acc_p = _sum64(acc_P * A.unsqueeze(1), (1, 2))
    lp_p, acc_p = lp_p.to(torch.float32), acc_p.to(torch.float32)
    loglik = (m_loglam - lam_sum) - lgamma_sum
    sum_a = A.sum(-1)
    n_par = sum_a * (G + K)
    if isinstance(temperature, torch.Tensor):
        temp = temperature.reshape(1).expand(C)
    else:
        temp = torch.full_like(sum_a, float(temperature))
    return torch.stack([
        torch.full_like(sum_a, float(it)),
        torch.sqrt(sq_err / m.const(float(K * G), sq_err)),
        mlogm_sum - mp_loglam, loglik, loglik + (lp_p + lp_e), n_par,
        -2.0 * loglik + n_par * _log_g(G), sum_a, temp,
        acc_p / torch.clamp_min(sum_a * K, 1.0),
        acc_e / torch.clamp_min(sum_a * G, 1.0), na_events], -1)


def _log_g(G: int) -> float:
    """log(G) as the row multiplies by it: rounded to float32."""
    return float(np.float32(math.log(G)))


def _mh_accept(log_ratio, u_acc, accept_all, inactive):
    """The acceptance step shared by both sweeps (updates.py:611-628 of the
    JAX package): the prior-draw fallback always accepts, a NaN ratio is
    clamped to 0 and counted, the warmup flag accepts everything. Returns
    (take, ratio_rec, n_nan (C,))."""
    log_ratio = torch.where(inactive, 0.0, log_ratio)
    ratio_raw = torch.exp(log_ratio).clamp_max(1.0)
    nan_mask = torch.isnan(ratio_raw)
    n_nan = nan_mask.to(torch.float32).sum(-1)
    ratio = torch.where(nan_mask, 0.0, ratio_raw)
    acc = accept_all.view(-1, 1)
    take = acc | (u_acc < ratio)
    return take, torch.where(acc, 1.0, ratio), n_nan


_EPS = 1e-30       # floor of an exponential conditional's precision
PRIORS = {"truncnormal": 0, "exponential": 1}


def _conditional(mu1, den, hp0, hp1, expo=False):
    """A column's conditional mean and variance from its sums: the
    exponential prior (hp0 = Lambda) shifts the mean by -Lambda with the
    precision floored at 1e-30, the truncnormal prior (hp0, hp1 = Mu,
    Sigmasq) adds its own precision and mean (updates.py:573-600 and
    :660-690 of the JAX package)."""
    if expo:
        den_s = den.clamp_min(_EPS)
        return (mu1 - hp0) / den_s, 1.0 / den_s
    den2 = den + 1.0 / hp1
    return (mu1 + hp0 / hp1) / den2, 1.0 / den2


def _column_update(sums, old, A_n, other_sq, hp0, hp1, prior_n, u, rec_old,
                   accept_all, expo):
    """One column's update from its two sets of sums: ``sums(prop_scaled)``
    returns the stats (prop None) or the accept sums. ``old``, the prior
    pair (hp1 None for the exponential prior), the prior draw and
    ``rec_old`` are (C, L); ``u`` (C, 3, L); A_n (C, 1); ``other_sq``
    (C, 1) the other factor's sum of squares, whose vanishing makes the
    column inactive. Returns (new, rec, n_nan (C,))."""
    mu1, den_raw = sums(None)
    mu, var = _conditional(mu1, A_n * den_raw, hp0, hp1, expo)
    cond = dist.truncnorm_nonneg_from_u(u[:, 0], u[:, 1], mu, var)
    inactive = other_sq <= 0.0
    proposal = torch.where(inactive, prior_n, cond)
    lp, mu1_r, den_raw_r = sums(A_n * proposal)
    mu_r, var_r = _conditional(mu1_r, A_n * den_raw_r, hp0, hp1, expo)
    lprior = (-hp0 * (proposal - old) if expo
              else m.truncnorm_logpdf_delta(proposal, old, hp0, hp1))
    log_ratio = (lp + lprior + m.truncnorm_logpdf(old, mu_r, var_r)
                 - m.truncnorm_logpdf(proposal, mu, var))
    take, rec, nn = _mh_accept(log_ratio, u[:, 2], accept_all, inactive)
    excluded = A_n == 0
    new = torch.where(excluded, prior_n, torch.where(take, proposal, old))
    return new, torch.where(excluded, rec_old, rec), nn


def pcol_update_reference(data, E, P, A, acc_P, hp0_p, hp1_p, P_prior, U,
                          accept_all, n_nan, n: int, expo: bool = False):
    """Plain version of one P-column update (column ``n``), in place on P,
    acc_P and n_nan: the host sequence of the JAX package's stream_sweep_P
    body on chain-batched operands; the prior pair (Mu_p, Sigmasq_p), or
    with ``expo`` (Lambda_p, None)."""
    A_n = A[:, n:n + 1]
    E_n = E[:, n, :].contiguous()
    P_n = P[:, :, n].clone(memory_format=torch.contiguous_format)
    PA = P * A.unsqueeze(1)
    new, rec, nn = _column_update(
        lambda q: run_reference(data, E, PA, E_n, A_n * P_n, q, True),
        P_n, A_n, (E_n * E_n).sum(-1, keepdim=True), hp0_p[:, :, n],
        None if expo else hp1_p[:, :, n], P_prior[:, :, n], U[:, :, n],
        acc_P[:, :, n], accept_all, expo)
    P[:, :, n] = new
    acc_P[:, :, n] = rec
    n_nan += nn


def erow_update_reference(data, E, P, A, acc_E, hp0_e, hp1_e, E_prior, U,
                          accept_all, n_nan, n: int, expo: bool = False):
    """Plain version of one E-row update (row ``n``), in place on E, acc_E
    and n_nan: the host sequence of the JAX package's stream_sweep_E body."""
    A_n = A[:, n:n + 1]
    P_n = P[:, :, n].contiguous()
    E_n = E[:, n, :].clone(memory_format=torch.contiguous_format)
    PA = P * A.unsqueeze(1)
    new, rec, nn = _column_update(
        lambda q: run_reference(data, E, PA, A_n * E_n, P_n, q, False),
        E_n, A_n, (P_n * P_n).sum(-1, keepdim=True), hp0_e[:, n, :],
        None if expo else hp1_e[:, n, :], E_prior[:, n, :], U[:, :, n],
        acc_E[:, n, :], accept_all, expo)
    E[:, n, :] = new
    acc_E[:, n, :] = rec
    n_nan += nn


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "stream_pcol_launch": [_P] * 8 + [_I] * 4 + [_P],
    "stream_erow_launch": [_P] * 7 + [_I] * 4 + [_P],
    "stream_pcol_update_launch": [_P] * 14 + [_I] * 7 + [_P],
    "stream_erow_update_launch": [_P] * 12 + [_I] * 7 + [_P],
    "stream_special_launch": [_P] * 2 + [_I] * 2 + [_P],
    "stream_acol_launch": [_P] * 8 + [_I] * 4 + [_P],
    "stream_acol_update_launch": [_P] * 9 + [ctypes.c_float, _I, _P]
    + [_I] * 6 + [_P],
    "stream_metrics_launch": [_P] * 5 + [_I] * 4 + [_P],
    "stream_metrics_row_launch": [_P] * 16 + [ctypes.c_float] * 3
    + [_I] * 6 + [_P],
}


def _width(N: int) -> int:
    return (-(-N // 4) * 4 if N <= 24 else 32 if N <= 32 else 64 if N <= 64
            else 128)


def tile_width(N: int) -> int:
    """Width of the register tile a column kernel is built with for N
    components: N rounded up to a multiple of 4 up to 24, then 32, 64 and
    128; ValueError beyond ops.MAX_N."""
    if N > MAX_N:
        raise ValueError(f"stream_sweeps: the column kernels hold a column "
                         f"of N components in registers, N <= {MAX_N}; got "
                         f"N = {N}")
    return _width(N)


def _col_rows(K: int) -> int:
    return min(-(-K // 32) * 32, _COL_THREADS)


def col_smem_bytes(K: int, N: int, gt: int) -> dict:
    """Shared memory of each column tile block at G width gt, in bytes
    (col_smem_floats, acol_smem_floats and metrics_smem_floats in
    csrc/stream_sweeps.cu): the E tile (gt x NP), the groups' partials a row
    as doubles (3, 1 and 4 sums), the data tile with a padded stride
    (K x (gt + 1)) and the per-row and per-column vectors."""
    NP, groups = _width(N), _COL_THREADS // _col_rows(K)
    common = gt * NP + K * (gt + 1)
    return {"pcol": 4 * (common + 2 * groups * K * 3 + gt + 2 * K),
            "acol": 4 * (common + 2 * groups * K + gt + K + NP),
            "metrics": 4 * (common + 2 * groups * K * 4 + NP)}


def _col_tile(K: int, N: int) -> int:
    for gt in _COL_TILES:
        if max(col_smem_bytes(K, N, gt).values()) <= _SMEM_MAX_BYTES:
            return gt
    return _COL_TILES[-1]


def col_tile(K: int, N: int) -> int:
    """G width of the P-column, A-column and metrics tiles (col_tile in
    csrc/stream_sweeps.cu): 64, or 32 or 16 where the widest of the three
    blocks would not fit an SM's shared memory (K = 1536 takes 16);
    ValueError beyond the envelope (ops.MAX_K, ops.MAX_N)."""
    check_envelope("stream_sweeps", K, N)
    return _col_tile(K, N)


def _pad_rows(K: int) -> int:
    return -(-K // _UNROLL) * _UNROLL


def erow_rows(K: int, N: int) -> int:
    """Rows of P*A an E-row block stages in shared memory at once (erow_rows
    in csrc/stream_sweeps.cu): all of them (padded to the register tile's
    4), or where they do not fit, chunks of rows that leave room for two
    blocks an SM (K = 1536 at N > 36); ValueError beyond the envelope."""
    check_envelope("stream_sweeps", K, N)
    NP = tile_width(N)
    if 4 * (_pad_rows(K) * NP + K) <= _SMEM_MAX_BYTES:
        return _pad_rows(K)
    return (_SMEM_MAX_BYTES // 2 // 4 - K) // NP // _UNROLL * _UNROLL


def _col_scratch(C: int, K: int, N: int, G: int, device):
    """The P-column tile kernel's partial sums, (C, K, 3, tiles) doubles
    that the finishing kernel adds in order."""
    return torch.empty(C * _n_tiles(G, col_tile(K, N)) * K * 3,
                       dtype=torch.float64, device=device)


def _acol_scratch(C: int, K: int, N: int, G: int, device):
    """The A-column tile kernel's partials, one double per (chain, tile)."""
    return torch.empty(C * _n_tiles(G, col_tile(K, N)), dtype=torch.float64,
                       device=device)


def _metrics_scratch(C: int, K: int, N: int, G: int, sums: int, device):
    """The metrics tile kernel's partials, ``sums`` doubles per (chain,
    tile)."""
    return torch.empty(C * sums * _n_tiles(G, col_tile(K, N)),
                       dtype=torch.float64, device=device)


def _fn(name):
    from ._build import load_library

    fn = getattr(load_library(), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


def _call(name, *args):
    with torch.cuda.device(args[0].device):
        err = _fn(name)(*[a.data_ptr() if isinstance(a, torch.Tensor)
                          else a for a in args],
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError {err}")


def _n_tiles(G, gt):
    return -(-G // gt)


def _launch_run(data, E, PA, en, pn, prop, col):
    C, K, N = PA.shape
    G = E.shape[2]
    n_out = 2 if prop is None else 3
    dev = PA.device
    if col:
        out = torch.empty(n_out, C, K, dtype=torch.float32, device=dev)
        _call("stream_pcol_launch", data, E, PA, en, pn, prop,
              _col_scratch(C, K, N, G, dev), out, C, K, N, G)
    else:
        erow_rows(K, N)
        out = torch.empty(n_out, C, G, dtype=torch.float32, device=dev)
        _call("stream_erow_launch", data, E, PA, en, pn, prop, out, C, K, N,
              G)
    return tuple(out)


def _launch_update(col, data, E, P, A, acc, hp0, hp1, prior_draw, U,
                   accept_all, n_nan, n0, n1, expo):
    """Enqueue the launches of columns n0..n1-1 with one C call; P (or E),
    the acceptance record and n_nan change in place. The exponential prior
    reads hp0 (Lambda) only."""
    C, K, N = P.shape
    G = E.shape[2]
    PA = P * A.unsqueeze(1)
    flags = accept_all.to(torch.float32)
    nan = torch.zeros(C, dtype=torch.int32, device=P.device)
    if col:
        work = torch.empty(C * 4 * K, dtype=torch.float32, device=P.device)
        _call("stream_pcol_update_launch", data, E, P, PA, A, acc, hp0,
              hp0 if hp1 is None else hp1, prior_draw, U, flags, nan,
              _col_scratch(C, K, N, G, P.device), work, C, K, N, G, n0, n1,
              int(expo))
    else:
        erow_rows(K, N)
        _call("stream_erow_update_launch", data, E, P, PA, A, acc, hp0,
              hp0 if hp1 is None else hp1, prior_draw, U, flags, nan, C, K,
              N, G, n0, n1, int(expo))
    n_nan += nan


def _launch_acol(data, E, PA, en, pn, an):
    C, K, N = PA.shape
    G = E.shape[2]
    out = torch.empty(C, dtype=torch.float32, device=PA.device)
    _call("stream_acol_launch", data, E, PA, en, pn, an,
          _acol_scratch(C, K, N, G, PA.device), out, C, K, N, G)
    return out


def _launch_acol_update(data, E, P, A, logit_p1, temperature, u, n_nan,
                        penalty, n0, n1):
    """Enqueue the launches of A columns n0..n1-1 with one C call; A and
    n_nan change in place. Returns the deltas (C, N)."""
    C, K, N = P.shape
    G = E.shape[2]
    if isinstance(temperature, torch.Tensor):
        temp = temperature.to(device=P.device, dtype=torch.float32).reshape(1)
    else:
        temp = torch.full((1,), float(temperature), dtype=torch.float32,
                          device=P.device)
    delta = torch.empty(C, N, dtype=torch.float32, device=P.device)
    _call("stream_acol_update_launch", data, E, P, A, logit_p1, temp, u,
          n_nan, delta, 0.0 if penalty is None else float(penalty),
          int(penalty is not None),
          _acol_scratch(C, K, N, G, P.device), C, K, N, G, n0, n1)
    return delta


def _launch_metrics(data, E, PA):
    C, K, N = PA.shape
    G = E.shape[2]
    out = torch.empty(4, C, dtype=torch.float32, device=PA.device)
    _call("stream_metrics_launch", data, E, PA,
          _metrics_scratch(C, K, N, G, 4, PA.device), out, C, K, N, G)
    return tuple(out)


def _launch_metrics_row(data, P, E, A, acc_P, acc_E, Mu_p, Sigmasq_p, Mu_e,
                        Sigmasq_e, lgamma_sum, mlogm_sum, na_events, it,
                        temperature, out, expo):
    """Enqueue the metrics tile kernel and the finishing kernel; the rows go
    to ``out`` (C, 12), a row every out.stride(0) floats, or to a new
    tensor. Returns the rows. The exponential prior reads Mu_p and Mu_e
    (its Lambdas) only."""
    C, K, N = P.shape
    G = E.shape[2]
    if out is None:
        out = torch.empty(C, ROW_LEN, dtype=torch.float32, device=P.device)
    if isinstance(temperature, torch.Tensor):
        temp, temp_val = temperature.reshape(1), 0.0
    else:
        temp, temp_val = None, float(temperature)
    _call("stream_metrics_row_launch", data, E, P, A, Mu_e,
          Mu_e if expo else Sigmasq_e, acc_E, Mu_p,
          Mu_p if expo else Sigmasq_p, acc_P, lgamma_sum, mlogm_sum,
          na_events, temp, out, _metrics_scratch(C, K, N, G, 6, P.device),
          float(it), temp_val, _log_g(G), out.stride(0), C, K, N, G,
          int(expo))
    return out


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def _check(fn, name, t, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{fn}: {name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{fn}: {name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def _check_out(fn, out, shape, device):
    """An output that may be a slice: float32 on ``device``, of ``shape``,
    each row contiguous."""
    if not isinstance(out, torch.Tensor) or out.dtype != torch.float32 \
            or out.device != device or tuple(out.shape) != tuple(shape) \
            or out.stride(-1) != 1:
        raise ValueError(f"{fn}: out must be a float32 tensor of shape "
                         f"{tuple(shape)} on {device} with contiguous rows")


def _batch(fn, data, E, PA, vectors):
    """Add the chain axis to unbatched operands, check everything, and say
    which path runs. ``vectors``: (name, tensor, per-chain length or None
    for a per-chain scalar)."""
    batched = PA.dim() == 3
    if not batched:
        E, PA = E.unsqueeze(0), PA.unsqueeze(0)
        vectors = [(n, None if t is None else t.reshape(1, -1) if ln
                    else t.reshape(1), ln) for n, t, ln in vectors]
    C, K, N = PA.shape
    G = E.shape[2]
    dev = PA.device
    _check(fn, "data", data, (K, G), dev)
    _check(fn, "E", E, (C, N, G), dev)
    _check(fn, "PA", PA, (C, K, N), dev)
    for name, t, ln in vectors:
        if t is not None:
            _check(fn, name, t, (C, ln) if ln else (C,), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: no path for device {dev}")
    return batched, E, PA, [t for _, t, _ in vectors]


def _run(data, E, PA, en, pn, prop, col: bool):
    """The four bodies of the JAX package's ``_run``. Returns (C, K)
    outputs for a P column (col=True) and (C, G) outputs for an E row, two
    without ``prop`` (stats) and three with it (lp, mu1_r, den_r)."""
    K, G = data.shape
    batched, E, PA, (en, pn, prop) = _batch(
        "stream_sweeps", data, E, PA,
        [("en", en, G), ("pn", pn, K), ("prop", prop, K if col else G)])
    if PA.device.type == "cpu":
        out = run_reference(data, E, PA, en, pn, prop, col)
    else:
        out = _launch_run(data, E, PA, en, pn, prop, col)
        _run.launches += 1
    return out if batched else tuple(o[0] for o in out)


#: kernel launches since the count was last reset (CPU calls do not count)
_run.launches = 0


def pcol_stats(data, E, PA, en, pn_scaled):
    """(mu1, den_raw) of one P column: sums over G of
    (data - Mhat_no_n)/sig * E_n and E_n^2/sig."""
    return _run(data, E, PA, en, pn_scaled, None, col=True)


def pcol_accept(data, E, PA, en, pn_scaled, prop_scaled):
    """(lp_row, mu1_r, den_raw_r) of one P column at the proposal."""
    return _run(data, E, PA, en, pn_scaled, prop_scaled, col=True)


def erow_stats(data, E, PA, en_scaled, pn):
    """(mu1, den_raw) of one E row: sums over K."""
    return _run(data, E, PA, en_scaled, pn, None, col=False)


def erow_accept(data, E, PA, en_scaled, pn, prop_scaled):
    """(lp_col, mu1_r, den_raw_r) of one E row at the proposal."""
    return _run(data, E, PA, en_scaled, pn, prop_scaled, col=False)


def acol_delta(data, E, PA, en, pn, an):
    """loglik(A_n = 1) - loglik(A_n = 0) for one inclusion column: a (C,)
    tensor (a scalar tensor without the chain axis)."""
    K, G = data.shape
    batched, E, PA, (en, pn, an) = _batch(
        "acol_delta", data, E, PA,
        [("en", en, G), ("pn", pn, K), ("an", an, None)])
    if PA.device.type == "cpu":
        out = acol_delta_reference(data, E, PA, en, pn, an)
    else:
        out = _launch_acol(data, E, PA, en, pn, an)
        acol_delta.launches += 1
    return out if batched else out[0]


acol_delta.launches = 0


def chain_metrics(data, E, PA):
    """(sum M log lam, sum lam, sum Mp log lam, sum (Mhat-M)^2), each (C,)
    (scalars without the chain axis), with lam = max(Mhat, 1e-6)."""
    batched, E, PA, _ = _batch("chain_metrics", data, E, PA, [])
    if PA.device.type == "cpu":
        out = chain_metrics_reference(data, E, PA)
    else:
        out = _launch_metrics(data, E, PA)
        chain_metrics.launches += 1
    return out if batched else tuple(o[0] for o in out)


chain_metrics.launches = 0

#: the metrics row's length, models/gibbs.py::METRIC_NAMES
ROW_LEN = 12


def stream_metrics_row(data, P, E, A, acc_P, acc_E, Mu_p, Sigmasq_p, Mu_e,
                       Sigmasq_e, lgamma_sum, mlogm_sum, na_events, it,
                       temperature, out=None, prior: str = "truncnormal"):
    """The metrics row of every chain, (C, 12) in models/gibbs.py's
    METRIC_NAMES order, from the state itself: P (C, K, N), E (C, N, G),
    A (C, N), the acceptance records acc_P (C, K, N) and acc_E (C, N, G),
    the prior's parameters: for the truncated normal the pairs Mu_p/Sigmasq_p
    (C, K, N) and Mu_e/Sigmasq_e (C, N, G), for ``prior="exponential"``
    Lambda_p and Lambda_e in the places of Mu_p and Mu_e (Sigmasq_p and
    Sigmasq_e None); the chunk constants ``lgamma_sum`` = sum lgamma(M + 1)
    and ``mlogm_sum`` = sum Mp log Mp (0-d tensors), the NaN events
    ``na_events`` (C,), the iteration ``it`` (a number) and the temperature
    (a number or a one-element tensor). The log-posterior adds the prior's
    log-density of every entry of P and E (ops/math.py::logprior_PE). The
    rows go to ``out`` when given, a (C, 12) float32 tensor whose rows may
    be strided (a slice of a chunk buffer), else to a new tensor; returns
    them. On the card: a pass over the (G/64, C) tiles and a finishing
    kernel per chain (counted one launch per call in
    ``stream_metrics_row.launches``)."""
    fn = "stream_metrics_row"
    expo = _prior_code(fn, prior, Sigmasq_p, Sigmasq_e)
    C, K, N = P.shape
    G = E.shape[2]
    dev = P.device
    _check(fn, "data", data, (K, G), dev)
    for name, t, shape in (
            ("E", E, (C, N, G)), ("P", P, (C, K, N)), ("A", A, (C, N)),
            ("acc_P", acc_P, (C, K, N)), ("acc_E", acc_E, (C, N, G)),
            ("Mu_p", Mu_p, (C, K, N)), ("Sigmasq_p", Sigmasq_p, (C, K, N)),
            ("Mu_e", Mu_e, (C, N, G)), ("Sigmasq_e", Sigmasq_e, (C, N, G)),
            ("lgamma_sum", lgamma_sum, ()), ("mlogm_sum", mlogm_sum, ()),
            ("na_events", na_events, (C,))):
        if t is not None:
            _check(fn, name, t, shape, dev)
    if isinstance(temperature, torch.Tensor):
        _check(fn, "temperature", temperature, tuple(temperature.shape), dev)
        if temperature.numel() != 1:
            raise ValueError(f"{fn}: temperature has {temperature.numel()} "
                             "values, expected 1")
    if out is not None:
        _check_out(fn, out, (C, ROW_LEN), dev)
    if dev.type == "cpu":
        row = stream_metrics_row_reference(
            data, P, E, A, acc_P, acc_E, Mu_p, Sigmasq_p, Mu_e, Sigmasq_e,
            lgamma_sum, mlogm_sum, na_events, it, temperature, expo)
        return row if out is None else out.copy_(row)
    if dev.type != "cuda":
        raise ValueError(f"{fn}: no path for device {dev}")
    out = _launch_metrics_row(data, P, E, A, acc_P, acc_E, Mu_p, Sigmasq_p,
                              Mu_e, Sigmasq_e, lgamma_sum, mlogm_sum,
                              na_events, it, temperature, out, expo)
    stream_metrics_row.launches += 1
    return out


stream_metrics_row.launches = 0


def _prior_code(fn, prior, *second):
    """Whether ``prior`` is the exponential one, whose second prior operands
    (``second``) are None; the truncated normal needs them."""
    if prior not in PRIORS:
        raise NotImplementedError(
            f"{fn}: no MH kernel takes the {prior!r} prior (the gamma "
            "prior is Gibbs only, MH=False; config.ModelSpec)")
    expo = prior == "exponential"
    if any((t is None) != expo for t in second):
        raise ValueError(f"{fn}: the {prior} prior takes "
                         + ("Lambda alone" if expo else "Mu and Sigmasq"))
    return expo


def _update(fn, col, data, E, P, A, acc, hp0, hp1, prior_draw, U,
            accept_all, n_nan, n0, n1, prior):
    expo = _prior_code(fn, prior, hp1)
    C, K, N = P.shape
    G = E.shape[2]
    dev = P.device
    side = (C, K, N) if col else (C, N, G)
    _check(fn, "data", data, (K, G), dev)
    for name, t, shape in (
            ("E", E, (C, N, G)), ("P", P, (C, K, N)), ("A", A, (C, N)),
            ("acc", acc, side), ("hp0", hp0, side), ("hp1", hp1, side),
            ("prior_draw", prior_draw, side),
            ("U", U, (C, 3, N, K if col else G)), ("n_nan", n_nan, (C,))):
        if t is not None:
            _check(fn, name, t, shape, dev)
    if accept_all.dtype != torch.bool or tuple(accept_all.shape) != (C,) \
            or accept_all.device != dev:
        raise ValueError(f"{fn}: accept_all must be a (C,) bool tensor on "
                         f"{dev}")
    n1 = N if n1 is None else n1
    if not 0 <= n0 <= n1 <= N:
        raise ValueError(f"{fn}: columns {n0}..{n1} out of 0..{N}")
    if dev.type == "cpu":
        plain = pcol_update_reference if col else erow_update_reference
        for n in range(n0, n1):
            plain(data, E, P, A, acc, hp0, hp1, prior_draw, U, accept_all,
                  n_nan, n, expo)
    elif dev.type == "cuda":
        _launch_update(col, data, E, P, A, acc, hp0, hp1, prior_draw, U,
                       accept_all, n_nan, n0, n1, expo)
        _run.launches += (2 if col else 1) * (n1 - n0)
    else:
        raise ValueError(f"{fn}: no path for device {dev}")


def stream_pcol_update(data, E, P, A, acc_P, Mu_p, Sigmasq_p, P_prior, U,
                       accept_all, n_nan, n0: int = 0, n1=None,
                       prior: str = "truncnormal"):
    """Exact-MH updates of columns n0..n1-1 of P (all N by default), in
    order and in place on P (C, K, N), acc_P (C, K, N) and n_nan (C,), which
    gains the count of NaN ratios clamped to 0. Mu_p, Sigmasq_p: the prior
    pair, or with ``prior="exponential"`` Lambda_p and None (the
    conditional's mean moves by -Lambda, its precision is floored at 1e-30,
    and the prior's part of the ratio is -Lambda (proposal - old)); P_prior:
    the prior draw an inactive or excluded column takes; U (C, 3, N, K): the
    proposal's two uniforms and the acceptance uniform of every column;
    accept_all (C,) bool. On the card: two passes over the G tiles per
    column (counted in ``_run.launches``), each with its finishing kernel,
    all enqueued by one C call; the prior is an argument of the same
    kernels."""
    _update("stream_pcol_update", True, data, E, P, A, acc_P, Mu_p,
            Sigmasq_p, P_prior, U, accept_all, n_nan, n0, n1, prior)


def stream_erow_update(data, E, P, A, acc_E, Mu_e, Sigmasq_e, E_prior, U,
                       accept_all, n_nan, n0: int = 0, n1=None,
                       prior: str = "truncnormal"):
    """The mirror for rows n0..n1-1 of E, in place on E (C, N, G), acc_E
    and n_nan; the prior operands are (C, N, G) (Lambda_e and None for the
    exponential prior) and U (C, 3, N, G). On the card: one launch per row
    (counted in ``_run.launches``)."""
    _update("stream_erow_update", False, data, E, P, A, acc_E, Mu_e,
            Sigmasq_e, E_prior, U, accept_all, n_nan, n0, n1, prior)


def stream_acol_update(data, E, P, A, logit_p1, temperature, u, n_nan,
                       penalty=None, n0: int = 0, n1=None):
    """Tempered Bernoulli updates of inclusion columns n0..n1-1 (all N by
    default), in order and in place on A (C, N) and n_nan (C,), which gains
    the count of NaN inclusion probabilities taken as 1/2: column n's delta
    loglik(A_n = 1) - loglik(A_n = 0) at the current A, less ``penalty``
    (SBFI; None for BFI), gives p = sigmoid(logit_p1 + temperature * delta)
    and A[:, n] = u[:, n] < p. P (C, K, N), E (C, N, G), logit_p1 (C,) the
    prior log-odds, ``temperature`` a number or a one-element tensor,
    u (C, N). Returns the deltas (C, N) before the penalty, of columns
    n0..n1-1 (the other columns' entries are undefined). On the card: a pass
    over the G tiles and a finishing kernel per column (counted one launch
    per column in ``stream_acol_update.launches``), all enqueued by one C
    call."""
    fn = "stream_acol_update"
    C, K, N = P.shape
    G = E.shape[2]
    dev = P.device
    _check(fn, "data", data, (K, G), dev)
    for name, t, shape in (("E", E, (C, N, G)), ("P", P, (C, K, N)),
                           ("A", A, (C, N)), ("logit_p1", logit_p1, (C,)),
                           ("u", u, (C, N)), ("n_nan", n_nan, (C,))):
        _check(fn, name, t, shape, dev)
    n1 = N if n1 is None else n1
    if not 0 <= n0 <= n1 <= N:
        raise ValueError(f"{fn}: columns {n0}..{n1} out of 0..{N}")
    if isinstance(temperature, torch.Tensor) and temperature.numel() != 1:
        raise ValueError(f"{fn}: temperature has {temperature.numel()} "
                         "values, expected 1")
    if dev.type == "cpu":
        delta = torch.empty(C, N, dtype=torch.float32)
        for n in range(n0, n1):
            delta[:, n] = acol_update_reference(
                data, E, P, A, logit_p1, temperature, u, n_nan, penalty, n)
    elif dev.type == "cuda":
        delta = _launch_acol_update(data, E, P, A, logit_p1, temperature, u,
                                    n_nan, penalty, n0, n1)
        stream_acol_update.launches += n1 - n0
    else:
        raise ValueError(f"{fn}: no path for device {dev}")
    return delta


stream_acol_update.launches = 0


def special_functions(x, which: str):
    """The kernels' own ``ndtri``, ``log_ndtr``, ``ndtr`` or ``sigmoid`` on
    a float32 CUDA tensor, for holding them against torch.special.ndtri,
    torch.special.log_ndtr, ops/distributions._ndtr and torch.sigmoid,
    whose bits a column update's draw, ratio and decision depend on."""
    _check("special_functions", "x", x, x.shape, x.device)
    if x.device.type != "cuda":
        raise ValueError("special_functions: the kernels' functions exist "
                         "on the card only")
    out = torch.empty_like(x)
    _call("stream_special_launch", x, out, x.numel(),
          ("ndtri", "log_ndtr", "ndtr", "sigmoid").index(which))
    return out


def reset_launch_counts():
    """Set every stream kernel's launch count to 0."""
    _run.launches = acol_delta.launches = chain_metrics.launches = 0
    stream_acol_update.launches = stream_metrics_row.launches = 0
