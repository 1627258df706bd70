"""One Gibbs iteration core of the Poisson + MH sampler: the exact
Mu/Sigmasq hyper-sweep, the N sequential P-column and N sequential E-row
Metropolis-Hastings updates, and with rank learning the rank draw R and the
N sequential inclusion updates of A.

Port of bayesnmf_tpu/ops/pallas_sweeps.py. ``fused_gibbs_sweeps`` keeps the
JAX signature and return tuple (pallas_sweeps.py:370-446), and so does its
fixed-rank form ``fused_pe_sweeps``. On CUDA tensors it
launches the hand-written kernel csrc/fused_sweeps.cu (one thread-block
cluster per chain, ``cluster_config``) or raises; on CPU tensors it runs
``fused_gibbs_sweeps_reference``,
the same function in plain PyTorch, which consumes the same uniforms in the
same order.

One deliberate departure from the reference: the truncated-normal proposal
scales its uniform by the tail mass Phi(-alpha) computed with erfc
(``distributions._ndtr``, as the eager sweeps and the stream kernels do).
The reference takes it as ``pallas_special.ndtr(-alpha)``, i.e. 1 - (1 -
q), which cancels to 0 from alpha ~ 5.5 and is 2e-3 off at 4; its proposal
then collapses to a constant mu + 13 sd there, leaves the density that the
Hastings ratio assumes, and the fused Poisson-Exponential MH chain fails
its Geweke gate (tests/test_torch_geweke.py; the JAX kernel does too).

Ported in full: the truncnormal or the exponential prior, the exact or the
reference-parity (``exact_mh=False``) Hastings ratio, a fixed rank or the
SBFI/BFI rank branch (``rank_method``), the in-kernel hyper-sweep (the
truncnormal prior's only), and ``accept_all`` either way. The temperature
rides in ``rank_pack[..., 0, 0]`` as data, so a step never passes it from
the host.

Chains: every state and uniform tensor may carry a leading chain axis C
(the JAX package gets it from ``vmap``); ``data`` (K, G) and the
``hyper_hp`` planes are shared by all chains, and ``accept_all`` may be a
bool or a (C,) tensor of per-chain flags.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import check_envelope
from . import special as ps
from .distributions import _ndtr
from .math import const

_FLOOR = 1e-6
_EPS = 1e-30
_TINY = 1.2e-38
_LOG_SQRT2PI = 0.9189385332046727

# the kernel's integer codes of the trace-time options
PRIORS = {"truncnormal": 0, "exponential": 1}
RANK_METHODS = {None: 0, "SBFI": 1, "BFI": 2}


def sbfi_penalty(K: int, G: int) -> float:
    """The SBFI inclusion penalty as the kernel takes it:
    float32((G + K) log(G) / 2) computed in double (pallas_sweeps.py:343).
    (The Mhat-based ``sweep_A`` rounds log(G) to float32 first.)"""
    return float(np.float32((G + K) * math.log(G) / 2.0))


# the kernel's block: threads, warps, and what a block can opt in to on an
# H100
_THREADS = 512
_WARPS = _THREADS // 32
_SMEM_MAX_BYTES = 227 * 1024
# columns of G a block should own before a chain is split further (a warp's
# lanes stride over them), and the blocks the card keeps resident as clusters
# of 16 (7 of them at this kernel's shared memory)
_G_PER_BLOCK = 32
_RESIDENT_BLOCKS = 112


def _fixed_smem_bytes(K: int, N: int, S: int, in_smem: bool = True) -> int:
    """Shared memory of a block beside its slices (fixed_smem_bytes in
    csrc/fused_sweeps.cu): the pushed partials, the E-row partials and the
    block-sum scratch as doubles; P and its prior pair, the per-row and
    per-column vectors, A, the NaN counts and the flags as floats. With
    ``in_smem`` False, P, its prior pair and the pushed partials sit in a
    global scratch instead (``fixed_in_smem``)."""
    doubles = (S * K * 5 if in_smem else 0) + 2 * S + _WARPS + _THREADS * 3
    floats = ((3 * K * N if in_smem else 0) + 4 * K + 3 * _THREADS + N
              + _THREADS + 2 * S)
    return 8 * doubles + 4 * floats


def fixed_in_smem(K: int, N: int, S: int) -> bool:
    """Whether a block of a cluster of S keeps P, its prior pair and the
    pushed per-row partials in shared memory (the partials then reach every
    block through distributed shared memory). Where they do not fit (K = 288
    at N >= 8 on one block, K = 1536 at any N), the kernel keeps them in a
    per-chain global scratch the wrapper sizes (``scratch_floats``): P and
    its prior pair a copy per block, the partials one slot per block that
    the others read after the cluster barrier."""
    return _fixed_smem_bytes(K, N, S) <= _SMEM_MAX_BYTES


def scratch_floats(K: int, N: int, S: int, C: int) -> int:
    """Float32 words of the global scratch of C chains on clusters of S
    when ``fixed_in_smem`` is False: the partials (C, S, K, 5) as doubles,
    then P and its prior pair (C, S, 3, K, N)."""
    return 2 * C * S * K * 5 + C * S * 3 * K * N


def cluster_config(K: int, N: int, G: int, C: int = 1):
    """(blocks per chain, E slice resident, data and Mhat slices resident)
    of the kernel for C chains of a (K, N, G) problem. A chain is one
    thread-block cluster whose blocks split G: the smallest of 1, 2, 4, 8,
    16 blocks that leaves a block at most 32 columns (16 beyond G = 512),
    halved while the C chains' blocks together exceed what the card keeps
    resident, and halved once more where the part of a block beside its
    slices (``_fixed_smem_bytes``) fits only so; where it fits on neither
    size, the first size stays and that part moves to global memory
    (``fixed_in_smem``). With Gq = ceil(G / S), a block's slice of E
    (N * Gq floats) and then its slices of data and Mhat (2 * K * Gq
    floats) stay in shared memory when they fit beside the rest in the
    227 KB a block can have: the latter up to about K * Gq = 17000 at N = 8
    (96 x 2780 fits on 16 blocks, 96 x 4000 does not); what does not fit
    the kernel reads in global memory. Beyond the envelope (ops.MAX_K,
    ops.MAX_N) it raises ValueError."""
    check_envelope("fused_gibbs_sweeps", K, N)
    S = 1
    while S < 16 and -(-G // S) > _G_PER_BLOCK:
        S *= 2
    while S > 1 and C * S > _RESIDENT_BLOCKS:
        S //= 2
    # a cluster of half the size doubles a block's share of G; below that
    # the exchange of the partials through L2 (a few microseconds a column)
    # costs less than the blocks lost
    if S > 1 and not fixed_in_smem(K, N, S) and fixed_in_smem(K, N, S // 2):
        S //= 2
    in_smem = fixed_in_smem(K, N, S)
    Gq = -(-G // S)
    need = _fixed_smem_bytes(K, N, S, in_smem)
    e_resident = need + 4 * N * Gq <= _SMEM_MAX_BYTES
    if e_resident:
        need += 4 * N * Gq
    return S, e_resident, e_resident and need + 8 * K * Gq <= _SMEM_MAX_BYTES


# ---------------------------------------------------------------------------
# plain PyTorch version (the CPU path, and what the kernel is checked against)
# ---------------------------------------------------------------------------


def _ndtri(p):
    """erfinv in the centre, Acklam in the tails (pallas_sweeps.py:43-55)."""
    central = 1.4142135623730951 * torch.erfinv(2.0 * p - 1.0)
    return torch.where((p < 0.02425) | (p > 0.97575), ps.ndtri(p), central)


def _truncnorm_icdf(u, mu, sd):
    """Inverse-CDF TruncNormal[0, inf) draw; beyond alpha = 8 the Exp(1)/alpha
    deep-tail limit reuses the SAME uniform (pallas_sweeps.py:58-70). The
    tail mass is erfc's, not the reference's cancelling ndtr (see the module
    docstring)."""
    alpha = -mu / sd
    tail = _ndtr(-alpha)
    v = (u * tail).clamp_min(_TINY)
    z_icdf = torch.maximum(-_ndtri(v), alpha)
    a_safe = alpha.clamp_min(1.0)
    z_tail = a_safe - torch.log(u.clamp_min(_TINY)) / a_safe
    z = torch.where(alpha > 8.0, z_tail, z_icdf)
    return (mu + sd * z).clamp_min(0.0)


def _tn_logpdf(x, mu, var):
    sd = torch.sqrt(var)
    z = (x - mu) / sd
    return -0.5 * z * z - torch.log(sd) - _LOG_SQRT2PI - ps.log_ndtr(mu / sd)


def _hyper_sweep_side(x, mu_old, sq_old, hhp, hu):
    """Exact Metropolized-conjugate Mu/Sigmasq update for one side, elementwise
    (pallas_sweeps.py:80-124). ``hhp``/``hu`` have the 4 planes on dim -3."""
    m0, s0, a0, b0 = hhp.unbind(-3)
    z_mu = _ndtri(hu[..., 0, :, :])
    lu_mu = torch.log(hu[..., 1, :, :])
    z_sq = _ndtri(hu[..., 2, :, :])
    lu_sq = torch.log(hu[..., 3, :, :])

    den = 1.0 / s0 + 1.0 / sq_old
    prop = (m0 / s0 + x / sq_old) / den + torch.sqrt(1.0 / den) * z_mu
    sd = torch.sqrt(sq_old)
    la = ps.log_ndtr(mu_old / sd) - ps.log_ndtr(prop / sd)
    mu_new = torch.where(lu_mu < la, prop, mu_old)

    a = a0 + 0.5
    b = b0 + 0.5 * (x - mu_new) * (x - mu_new)
    c = 1.0 - 1.0 / (9.0 * a)
    sqa3 = 3.0 * torch.sqrt(a)
    t_new = c + z_sq / sqa3
    g_new = a * t_new * t_new * t_new
    ok = g_new > 1e-30
    g_new_s = g_new.clamp_min(1e-30)
    sq_new = b / g_new_s
    g_old = b / sq_old.clamp_min(1e-30)
    t_old = torch.exp(torch.log((g_old / a).clamp_min(1e-38)) / 3.0)
    z_old = sqa3 * (t_old - c)

    def logw(g, t, zz, sq):
        return ((a - 1.0) * torch.log(g) - g + 0.5 * zz * zz
                + 2.0 * torch.log(t.clamp_min(1e-30))
                - ps.log_ndtr(mu_new / torch.sqrt(sq)))

    la2 = torch.where(
        ok, logw(g_new_s, t_new, z_sq, sq_new) - logw(g_old, t_old, z_old,
                                                       sq_old),
        torch.full_like(g_new, -float("inf")))
    return mu_new, torch.where(lu_sq < la2, sq_new, sq_old)


def _sum(x, dim):
    """Reduction over G or K, accumulated in float64 and rounded back. The
    reference sums in float32; the CUDA kernel sums in double too, so the
    kernel and this version agree to rounding at any G."""
    return x.sum(dim, keepdim=True, dtype=torch.float64).to(torch.float32)


def _prior_draw(expo, u, hp0, hp1):
    """prior_draw_of (pallas_sweeps.py:174-177): Exp(Lambda) by -log(u) /
    Lambda, or the TruncNormal(Mu, Sigmasq) inverse-CDF draw."""
    if expo:
        return -torch.log(u) / hp0
    return _truncnorm_icdf(u, hp0, torch.sqrt(hp1))


def _conditional(expo, mu1, den, hp0, hp1):
    """Mean and variance of a column entry's conditional from its two
    reductions (pallas_sweeps.py:196-203); hp0/hp1 are Lambda/unused for the
    exponential prior, Mu/Sigmasq for the truncnormal one."""
    if expo:
        den_s = den.clamp_min(_EPS)
        return (mu1 - hp0) / den_s, 1.0 / den_s
    den2 = den + 1.0 / hp1
    return (mu1 + hp0 / hp1) / den2, 1.0 / den2


def _mh_column(M, Mh, old, other, hp0, hp1, u_prop, u_acc, u_prior, acc_on,
               dim, expo, exact_mh):
    """Active-column (A_n = 1) MH update (pallas_sweeps.py:179-260).
    ``other`` is E_n (C,1,G) for the P sweep (dim=2) or P_n (C,K,1) for the
    E sweep (dim=1). With the exponential prior an all-zero ``other`` makes
    the column inactive: it takes the prior draw, and with the exact ratio
    always accepts it."""
    sig = Mh.clamp_min(_FLOOR)
    Mno = Mh - old * other
    o2 = other * other
    mu1 = _sum(((M - Mno) / sig) * other, dim)
    den = _sum(o2 / sig, dim)
    mu, var = _conditional(expo, mu1, den, hp0, hp1)
    proposal = _truncnorm_icdf(u_prop, mu, torch.sqrt(var))
    if expo:
        inactive = o2.sum((1, 2), keepdim=True) <= 0.0
        proposal = torch.where(inactive, _prior_draw(True, u_prior, hp0, hp1),
                               proposal)

    Mh_prop = Mh + (proposal - old) * other
    lam_o = Mh.clamp_min(_FLOOR)
    lam_n = Mh_prop.clamp_min(_FLOOR)
    # log1p ratio form: log(lam_n) - log(lam_o) would amplify the rounding of
    # the logs by ~sum(M) and destroy the acceptance ratio
    d_lam = lam_n - lam_o
    lp_core = M * torch.log1p(d_lam / lam_o) - d_lam
    if exact_mh:
        sig_r = Mh_prop.clamp_min(_FLOOR)
        mu1_r = _sum(((M - Mno) / sig_r) * other, dim)
        den_r = _sum(o2 / sig_r, dim)
        mu_r, var_r = _conditional(expo, mu1_r, den_r, hp0, hp1)
        if expo:
            lprior = -hp0 * (proposal - old)
        else:
            lprior = _tn_logpdf(proposal, hp0, hp1) - _tn_logpdf(old, hp0,
                                                                 hp1)
        log_ratio = (_sum(lp_core, dim) + lprior
                     + _tn_logpdf(old, mu_r, var_r)
                     - _tn_logpdf(proposal, mu, var))
        if expo:
            log_ratio = torch.where(inactive, 0.0, log_ratio)
    else:
        # the reference's ratio: normal-model likelihoods stand in for the
        # proposal densities (sample_Pn.R:209-239)
        vs_o = Mh_prop.clamp_min(1.0)
        vs_n = Mh.clamp_min(1.0)
        r_o = M - Mh
        r_n = M - Mh_prop
        log_ratio = _sum(
            lp_core + (-0.5 * r_o * r_o / vs_o - 0.5 * torch.log(vs_o))
            - (-0.5 * r_n * r_n / vs_n - 0.5 * torch.log(vs_n)), dim)
    ratio_raw = torch.exp(log_ratio).clamp_max(1.0)
    nan_mask = torch.isnan(ratio_raw)
    n_nan = nan_mask.flatten(1).sum(1).to(torch.float32)
    ratio = torch.where(nan_mask, 0.0, ratio_raw)
    take = acc_on | (u_acc < ratio)
    rec = torch.where(acc_on, torch.ones_like(ratio), ratio)
    new_val = torch.where(take, proposal, old)
    return new_val, Mh + (new_val - old) * other, rec, n_nan


def _rank_branch(M, P, E, A, Mh, rank_pack, rank_method, nan):
    """The rank draw R by Gumbel-max with the index taken by sum-select, then
    the N sequential tempered inclusion updates of A, each from one
    reduction over K*G and a rank-1 rewrite of Mhat (pallas_sweeps.py:
    316-364). Returns (A, R (C,), Mhat, nan)."""
    C, K, N = P.shape
    G = E.shape[2]
    temp = rank_pack[:, 0, 0:1]                                  # (C, 1)
    fN = const(float(N), P)
    lo = const(0.4, P) / fN
    hi = 1.0 - const(0.4, P) / fN
    sumA = A.sum(-1, keepdim=True)
    r = torch.arange(N + 1, dtype=torch.float32, device=P.device)
    p1_r = torch.minimum(torch.maximum(r / fN, lo), hi)
    scores = (temp * (sumA * torch.log(p1_r)
                      + (fN - sumA) * torch.log(1.0 - p1_r))
              + rank_pack[:, 1, :])
    mx = scores.max(-1, keepdim=True).values
    R = torch.where(scores >= mx, r, 0.0).sum(-1)
    p1 = torch.minimum(torch.maximum(R / fN, lo), hi)
    logit_p1 = torch.log(p1) - torch.log1p(-p1)
    pen = sbfi_penalty(K, G)
    temp = temp.view(C)
    A = A.clone()
    for n in range(N):
        A_n = A[:, n].view(C, 1, 1)
        con = P[:, :, n:n + 1] * E[:, n:n + 1, :]
        off = Mh - A_n * con
        lam_off = off.clamp_min(_FLOOR)
        d = (off + con).clamp_min(_FLOOR) - lam_off
        delta = _sum(M * torch.log1p(d / lam_off) - d, (1, 2)).view(C)
        if rank_method == "SBFI":
            delta = delta - pen
        p = 1.0 / (1.0 + torch.exp(-(logit_p1 + temp * delta)))
        is_nan = torch.isnan(p)
        nan = nan + is_nan.to(torch.float32)
        p = torch.where(is_nan, 0.5, p)
        a_new = (rank_pack[:, 2, n] < p).to(torch.float32)
        Mh = off + a_new.view(C, 1, 1) * con
        A[:, n] = a_new
    return A, R, Mh, nan


def fused_gibbs_sweeps_reference(data, P, E, A, Mhat, acc_P, acc_E,
                                 Upr_P, Upr_E, Up_P, Ua_P, Up_E, Ua_E,
                                 hp0_p, hp1_p, hp0_e, hp1_e, rank_pack,
                                 prior_kind="truncnormal", exact_mh=True,
                                 rank_method=None, hyper_u=None,
                                 hyper_hp=None):
    """Plain PyTorch version of the kernel on chain-batched operands:
    data (K,G), Mhat (C,K,G), P-side (C,K,N), E-side (C,N,G), A (C,N),
    ``rank_pack`` (C,3,N+1) with [temperature, accept_all flag] in row 0,
    uniform planes (C,4,K,N)/(C,4,N,G) and the shared hyperprior planes
    (4,K,N)/(4,N,G).

    Returns (P, E, Mhat, acc_P, acc_E, A, R (C,), nan_count (C,), hp0_p,
    hp1_p, hp0_e, hp1_e). Inputs are not modified.
    """
    N = P.shape[2]
    expo = prior_kind == "exponential"
    P, E, Mh = P.clone(), E.clone(), Mhat.clone()
    acc_P, acc_E = acc_P.clone(), acc_E.clone()
    if hyper_u is not None:
        hp0_p, hp1_p = _hyper_sweep_side(P, hp0_p, hp1_p, hyper_hp[0],
                                         hyper_u[0])
        hp0_e, hp1_e = _hyper_sweep_side(E, hp0_e, hp1_e, hyper_hp[1],
                                         hyper_u[1])
    else:
        hp0_p, hp1_p, hp0_e, hp1_e = (t.clone() for t in
                                      (hp0_p, hp1_p, hp0_e, hp1_e))
    acc_on = (rank_pack[:, 0, 1] > 0.0).view(-1, 1, 1)
    nan = torch.zeros(P.shape[0], dtype=torch.float32, device=P.device)

    # Excluded columns (A_n = 0) take the prior draw; both branches are
    # computed and selected per chain, so the function has no host sync.
    def sweep(X, acc, Upr, Up, Ua, hp0, hp1, other_of, sl, dim):
        nonlocal Mh, nan
        for n in range(N):
            s = sl(n)
            active = (A[:, n] != 0.0).view(-1, 1, 1)
            new, Mh_new, rec, n_nan = _mh_column(
                data, Mh, X[s], other_of(n), hp0[s], hp1[s], Up[s], Ua[s],
                Upr[s], acc_on, dim, expo, exact_mh)
            prior = _prior_draw(expo, Upr[s], hp0[s], hp1[s])
            X[s] = torch.where(active, new, prior)
            acc[s] = torch.where(active, rec, acc[s])
            Mh = torch.where(active, Mh_new, Mh)
            nan = nan + torch.where(active.view(-1), n_nan, 0.0)

    sweep(P, acc_P, Upr_P, Up_P, Ua_P, hp0_p, hp1_p,
          lambda n: E[:, n:n + 1, :],
          lambda n: (slice(None), slice(None), slice(n, n + 1)), dim=2)
    sweep(E, acc_E, Upr_E, Up_E, Ua_E, hp0_e, hp1_e,
          lambda n: P[:, :, n:n + 1],
          lambda n: (slice(None), slice(n, n + 1), slice(None)), dim=1)
    if rank_method is None:
        A, R = A.clone(), rank_pack[:, 0, 0].clone()
    else:
        A, R, Mh, nan = _rank_branch(data, P, E, A, Mh, rank_pack,
                                     rank_method, nan)
    return P, E, Mh, acc_P, acc_E, A, R, nan, hp0_p, hp1_p, hp0_e, hp1_e


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
# 22 input pointers; hyper-sweep, prior, exact, rank codes and the SBFI
# penalty; 12 output pointers; C K N G, the cluster size and what sits in
# shared memory; the global scratch; the stream
_ARGTYPES = ([_P] * 22 + [_I] * 4 + [ctypes.c_float] + [_P] * 12 + [_I] * 6
             + [_P] * 2)


def _launch(data, P, E, A, Mhat, acc_P, acc_E, Upr_P, Upr_E, Up_P, Ua_P,
            Up_E, Ua_E, hp0_p, hp1_p, hp0_e, hp1_e, rank_pack,
            prior_kind, exact_mh, rank_method, hyper_u, hyper_hp):
    from ._build import load_library

    lib = load_library()
    fn = lib.fused_gibbs_sweeps_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    C, K, N = P.shape
    G = E.shape[2]
    cluster, e_resident, resident = cluster_config(K, N, G, C)
    in_smem = fixed_in_smem(K, N, cluster)
    scratch = None if in_smem else torch.empty(
        scratch_floats(K, N, cluster, C), dtype=torch.float32,
        device=P.device)
    outs = [torch.empty_like(t) for t in
            (P, E, Mhat, acc_P, acc_E, A)]
    R = torch.empty(C, dtype=torch.float32, device=P.device)
    nan = torch.empty(C, dtype=torch.float32, device=P.device)
    hps = [torch.empty_like(t) for t in (hp0_p, hp1_p, hp0_e, hp1_e)]
    hyper = hyper_u is not None
    ptr = lambda t: t.data_ptr()  # noqa: E731
    hu_ptrs = ([ptr(t) for t in (*hyper_u, *hyper_hp)] if hyper
               else [None] * 4)
    with torch.cuda.device(P.device):
        err = fn(ptr(data), *map(ptr, (P, E, A, Mhat, acc_P, acc_E)),
                 *map(ptr, (Upr_P, Upr_E, Up_P, Ua_P, Up_E, Ua_E)),
                 *map(ptr, (hp0_p, hp1_p, hp0_e, hp1_e)), ptr(rank_pack),
                 *hu_ptrs, int(hyper), PRIORS[prior_kind], int(exact_mh),
                 RANK_METHODS[rank_method], sbfi_penalty(K, G),
                 *map(ptr, outs), ptr(R), ptr(nan), *map(ptr, hps),
                 C, K, N, G, cluster,
                 int(resident) + 2 * int(e_resident) + 4 * int(not in_smem),
                 ptr(scratch) if scratch is not None else None,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_gibbs_sweeps kernel launch failed: "
                           f"cudaError {err}")
    fused_gibbs_sweeps.launches += 1
    return (*outs, R, nan, *hps)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


def _check(name, t, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"fused_gibbs_sweeps: {name} must be a tensor")
    if t.device != device:
        raise ValueError(f"fused_gibbs_sweeps: {name} is on {t.device}, "
                         f"expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"fused_gibbs_sweeps: {name} must be float32, got "
                        f"{t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_gibbs_sweeps: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"fused_gibbs_sweeps: {name} must be contiguous")


def fused_gibbs_sweeps(data, P, E, A, Mhat, acc_P, acc_E,
                       Upr_P, Upr_E, Up_P, Ua_P, Up_E, Ua_E,
                       hp0_p, hp1_p, hp0_e, hp1_e, rank_pack,
                       prior_kind: str, exact_mh: bool, accept_all,
                       rank_method, hyper_u=None, hyper_hp=None):
    """Run the Gibbs iteration core (hyper-sweep, P sweep, E sweep, and with
    ``rank_method`` 'SBFI'/'BFI' the R draw and the A sweep).

    Arguments mirror bayesnmf_tpu.ops.pallas_sweeps.fused_gibbs_sweeps:
    prior-fallback uniforms (Upr_*), proposal and acceptance uniforms (Up_*,
    Ua_*), the prior pair per side ((Mu, Sigmasq) for the truncnormal prior,
    (Lambda, unused) for the exponential one), ``rank_pack`` (3, N+1): row 0
    [temperature, ...], row 1 the Gumbel noise of the R draw, row 2 the A
    draws' uniforms; the warmup flag ``accept_all``, and the optional
    hyper-sweep planes ``hyper_u``/``hyper_hp`` ((4,K,N), (4,N,G)) of
    uniforms and hyperpriors [m, s, a, b] (truncnormal prior only).

    Returns (P, E, Mhat, acc_P, acc_E, A, R_float, nan_count, hp0_p',
    hp1_p', hp0_e', hp1_e'), each with the leading chain axis when the
    inputs had one. At a fixed rank A comes back as given and R is
    rank_pack[0, 0]. The outputs are new tensors; no input is modified.
    """
    if prior_kind not in PRIORS:
        raise NotImplementedError(
            f"fused_gibbs_sweeps: no MH kernel takes the {prior_kind!r} "
            "prior (the gamma prior is Gibbs only, MH=False; "
            "config.ModelSpec)")
    if rank_method not in RANK_METHODS:
        raise NotImplementedError(
            f"fused_gibbs_sweeps: rank_method={rank_method!r} is not a "
            "kernel option (the Gibbs step runs BIC over a rank list as BFI, "
            "models/gibbs.kernel_rank_method)")
    if (hyper_u is None) != (hyper_hp is None):
        raise ValueError("hyper_u and hyper_hp go together")
    if hyper_u is not None and prior_kind != "truncnormal":
        raise NotImplementedError(
            "fused_gibbs_sweeps: the in-kernel hyper-sweep is the truncnormal "
            "prior's; the exponential prior's Lambda update runs outside the "
            "kernel (models/updates.sample_prior_params)")

    batched = P.dim() == 3
    b = (lambda t: t) if batched else (lambda t: t.unsqueeze(0))
    P, E, A, Mhat, acc_P, acc_E = map(b, (P, E, A, Mhat, acc_P, acc_E))
    Upr_P, Upr_E, Up_P, Ua_P, Up_E, Ua_E = map(
        b, (Upr_P, Upr_E, Up_P, Ua_P, Up_E, Ua_E))
    hp0_p, hp1_p, hp0_e, hp1_e, rank_pack = map(
        b, (hp0_p, hp1_p, hp0_e, hp1_e, rank_pack))
    if hyper_u is not None:
        hyper_u = tuple(map(b, hyper_u))
    C, K, N = P.shape
    G = E.shape[2]
    dev = P.device
    kn, ng = (C, K, N), (C, N, G)
    _check("data", data, (K, G), dev)
    for name, t, shape in (
            ("P", P, kn), ("E", E, ng), ("A", A, (C, N)), ("Mhat", Mhat,
                                                           (C, K, G)),
            ("acc_P", acc_P, kn), ("acc_E", acc_E, ng),
            ("Upr_P", Upr_P, kn), ("Upr_E", Upr_E, ng), ("Up_P", Up_P, kn),
            ("Ua_P", Ua_P, kn), ("Up_E", Up_E, ng), ("Ua_E", Ua_E, ng),
            ("hp0_p", hp0_p, kn), ("hp1_p", hp1_p, kn), ("hp0_e", hp0_e, ng),
            ("hp1_e", hp1_e, ng), ("rank_pack", rank_pack, (C, 3, N + 1))):
        _check(name, t, shape, dev)
    if hyper_u is not None:
        _check("hyper_u[0]", hyper_u[0], (C, 4, K, N), dev)
        _check("hyper_u[1]", hyper_u[1], (C, 4, N, G), dev)
        _check("hyper_hp[0]", hyper_hp[0], (4, K, N), dev)
        _check("hyper_hp[1]", hyper_hp[1], (4, N, G), dev)

    # the warmup flag rides in rank_pack[:, 0, 1], as in the JAX kernel
    rank_pack = rank_pack.clone()
    if isinstance(accept_all, torch.Tensor):
        rank_pack[:, 0, 1] = accept_all.to(device=dev, dtype=torch.float32)
    else:  # fill_, not item assignment, which would wait for the device
        rank_pack[:, 0, 1].fill_(float(accept_all))

    args = (data, P, E, A, Mhat, acc_P, acc_E, Upr_P, Upr_E, Up_P, Ua_P,
            Up_E, Ua_E, hp0_p, hp1_p, hp0_e, hp1_e, rank_pack)
    if dev.type == "cpu":
        res = fused_gibbs_sweeps_reference(
            *args, prior_kind=prior_kind, exact_mh=exact_mh,
            rank_method=rank_method, hyper_u=hyper_u, hyper_hp=hyper_hp)
    elif dev.type == "cuda":
        res = _launch(*args, prior_kind, exact_mh, rank_method, hyper_u,
                      hyper_hp)
    else:
        raise ValueError(f"fused_gibbs_sweeps: no path for device {dev}")
    if not batched:
        res = tuple(t[0] for t in res)
    return res


#: kernel launches since the count was last reset (CPU calls do not count)
fused_gibbs_sweeps.launches = 0


def fused_pe_sweeps(data, P, E, A, Mhat, acc_P, acc_E,
                    Upr_P, Upr_E, Up_P, Ua_P, Up_E, Ua_E,
                    hp0_p, hp1_p, hp0_e, hp1_e,
                    prior_kind: str, exact_mh: bool, accept_all):
    """The fixed-rank form (pallas_sweeps.py:449-462): the P and E MH
    sweeps only, through ``fused_gibbs_sweeps`` with a zero ``rank_pack``,
    ``rank_method=None`` and no hyper-sweep, so the prior pair stays as
    given. Arguments as there, with or without a leading chain axis.
    Returns (P, E, Mhat, acc_P, acc_E). On CPU tensors this is the plain
    version; on CUDA tensors the kernel, or an error."""
    N = P.shape[-1]
    rank_pack = P.new_zeros(P.shape[:-2] + (3, N + 1))
    before = fused_gibbs_sweeps.launches
    out = fused_gibbs_sweeps(
        data, P, E, A, Mhat, acc_P, acc_E, Upr_P, Upr_E, Up_P, Ua_P, Up_E,
        Ua_E, hp0_p, hp1_p, hp0_e, hp1_e, rank_pack, prior_kind=prior_kind,
        exact_mh=exact_mh, accept_all=accept_all, rank_method=None)
    fused_pe_sweeps.launches += fused_gibbs_sweeps.launches - before
    return out[:5]


#: kernel launches through this form since the count was last reset
fused_pe_sweeps.launches = 0
