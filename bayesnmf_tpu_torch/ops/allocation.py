"""Latent-count multinomial allocation of the conjugate Poisson-Gibbs path.

For every cell (k, g) the count M[k, g] is split over the N components,
Z[k, :, g] ~ Multinomial(M[k, g], p ∝ P[k, :] * A * E[:, g]), and only the
two marginal sums are kept: Zsum_g[k, n] = Σ_g Z[k, n, g] (the P draw's
shapes) and Zsum_k[n, g] = Σ_k Z[k, n, g] (the E draw's).

Port of bayesnmf_tpu/ops/pallas_allocation.py::allocate_counts_fused. The
multinomial is a binary tree of conditional binomials over n2 = next_pow2(N)
leaves: bottom-up node weights, then top-down Binomial(count, w_left / w)
splits, each by 40-step inversion when n·p ≤ 10 and by BTRS rejection above
(the mode when every round rejects). Padding leaves and A_n = 0 components
get exactly zero counts; a cell whose weights are all zero allocates zero.

- ``allocate_counts_reference`` is the tree in plain PyTorch over given
  uniform planes (C, 1 + 2 rounds, n2-1, K, G): one inversion plane and a
  (u, v) pair for each BTRS round per node. The JAX kernel draws 17 (8
  rounds) in interpret mode (pallas_allocation.py:282-288);
  ``philox_planes`` builds the 25 (12 rounds) the kernel's Philox mode
  draws for a key and the chains' uids, so that mode too is held against
  the plain version.
- ``allocate_counts`` is the wrapper. Given planes, both devices consume
  them (how the kernel is held against the plain version). Without, the
  draw is the Philox stream of ``key`` (ops/rng.ChainStreams.subkey of
  (seed, iteration, site)) and the chains' ``uids`` (8 + 4 BTRS rounds):
  CPU tensors run the plain version on ``philox_planes``; CUDA tensors
  launch csrc/allocation.cu (one thread per cell, the tree in registers,
  an inversion that stops once its value is settled), which draws the same
  uniforms in-kernel, so a step reads nothing back to the host; or raise.

Counts are integers: both versions sum them exactly (float64 on the CPU,
double partials added in a fixed order on the card), where the JAX kernel
adds float32 tile sums, which round once a row total passes 2^24.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .math import const
from .rng import philox4x32_10, uniform_of

N_PLANES = 17        # 1 inversion plane + (u, v) for each of 8 BTRS rounds
PHILOX_ROUNDS = 12   # BTRS rounds of the kernel's Philox mode (8 + 4)
MAX_N = 64           # the kernel keeps a tree of at most 64 leaves per cell
_INV_STEPS = 40
_TINY = 1.2e-38
_HALF_LOG_2PI = 0.9189385332046727


def n_leaves(N: int) -> int:
    """n2: the tree's leaves, the next power of two >= N."""
    return 1 << max(int(math.ceil(math.log2(max(N, 1)))), 0)


def n_nodes(N: int) -> int:
    """The node axis of the uniform planes (pallas_allocation.py:282)."""
    return max(n_leaves(N) - 1, 1)


def philox_planes(key, uids: torch.Tensor, N: int, K: int, G: int,
                  rounds: int = PHILOX_ROUNDS, g0: int = 0,
                  G_total: int | None = None) -> torch.Tensor:
    """The uniforms the kernel's Philox mode draws under ``key`` (two 32-bit
    ints, ops/rng.ChainStreams.subkey) for the chains ``uids`` ((C,)
    int64), as planes (C, 1 + 2 rounds, n2-1, K, G) for the plain version:
    uniform i of a node's draw is word i % 4 of the Philox block with
    counter (cell k*G_total + g0 + g, node, i // 4, uids[c]), mapped by
    rng.uniform_of. ``g0`` and ``G_total`` place a G shard's columns in the
    whole matrix (defaults: the whole)."""
    dev = uids.device
    i64 = dict(dtype=torch.int64, device=dev)
    C = uids.numel()
    nn = n_nodes(N)
    shape = (C, nn, K, G)
    G_total = G if G_total is None else G_total
    cell = (torch.arange(K, **i64).view(1, 1, K, 1) * G_total + g0
            + torch.arange(G, **i64).view(1, 1, 1, G))
    node = torch.arange(nn, **i64).view(1, nn, 1, 1)
    chain = uids.view(C, 1, 1, 1)
    n_u = 1 + 2 * rounds
    out = torch.empty((C, n_u, nn, K, G), dtype=torch.float32, device=dev)
    for blk in range((n_u + 3) // 4):
        words = philox4x32_10((cell, node, blk, chain), *key)
        for w in range(min(4, n_u - 4 * blk)):
            out[:, 4 * blk + w] = uniform_of(words[w].expand(shape))
    return out


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _lgamma_pos(x):
    """log Gamma(x) for x >= 1: shift into z >= 5 by the recurrence, then
    the 3-term Stirling series (pallas_allocation.py:57-75)."""
    shift = torch.zeros_like(x)
    z = x
    for _ in range(4):
        small = z < 5.0
        shift = shift + torch.where(small, torch.log(z.clamp_min(_TINY)), 0.0)
        z = torch.where(small, z + 1.0, z)
    zi = 1.0 / z
    zi2 = zi * zi
    series = zi * (8.3333333333e-2 - zi2 * (2.7777777778e-3
                                            - zi2 * 7.9365079365e-4))
    return (z - 0.5) * torch.log(z) - z + _HALF_LOG_2PI + series - shift


def _binomial(n, p, planes):
    """Binomial(n, p) elementwise from a list of uniform tensors
    (pallas_allocation.py:78-137): 40-step CDF inversion when n·p' <= 10
    (p' = min(p, 1-p)), BTRS rejection with (len(planes) - 1) / 2 rounds
    above, the mode when every round rejects."""
    flip = p > 0.5
    pp = torch.where(flip, 1.0 - p, p)
    small = n * pp <= 10.0

    p_inv = torch.where(small, pp, 0.01)
    n_inv = torch.where(small, n, 1.0)
    ratio = p_inv / (1.0 - p_inv).clamp_min(1e-12)
    pmf = torch.exp(n_inv * torch.log1p(-p_inv))
    cdf = pmf
    x_inv = torch.zeros_like(n)
    for j in range(_INV_STEPS):
        x_inv = x_inv + (planes[0] > cdf).to(torch.float32)
        pmf = pmf * (n_inv - j) / const(j + 1.0, n) * ratio
        cdf = cdf + pmf
    x_inv = torch.minimum(x_inv, n_inv)

    p_b = torch.where(small, 0.4, pp)
    n_b = torch.where(small, 100.0, n)
    spq = torch.sqrt(n_b * p_b * (1.0 - p_b))
    b = 1.15 + 2.53 * spq
    a = -0.0873 + 0.0248 * b + 0.01 * p_b
    c = n_b * p_b + 0.5
    vr = 0.92 - const(4.2, b) / b
    alpha = (2.83 + const(5.1, b) / b) * spq
    lpq = torch.log(p_b / (1.0 - p_b).clamp_min(1e-12))
    m = torch.floor((n_b + 1.0) * p_b)
    h = _lgamma_pos(m + 1.0) + _lgamma_pos(n_b - m + 1.0)
    k_acc = torch.zeros_like(n)
    done = torch.zeros(n.shape, dtype=torch.bool, device=n.device)
    for r in range((len(planes) - 1) // 2):
        uu = planes[1 + 2 * r] - 0.5
        vv = planes[2 + 2 * r]
        us = 0.5 - uu.abs()
        k = torch.floor((2.0 * a / us.clamp_min(1e-8) + b) * uu + c)
        in_range = (k >= 0.0) & (k <= n_b)
        squeeze = (us >= 0.07) & (vv <= vr)
        v2 = torch.log(vv.clamp_min(_TINY) * alpha
                       / (a / (us * us).clamp_min(1e-12) + b))
        t = (h - _lgamma_pos(k + 1.0) - _lgamma_pos(n_b - k + 1.0)
             + (k - m) * lpq)
        ok = in_range & (squeeze | (v2 <= t))
        k_acc = torch.where(~done & ok, k, k_acc)
        done = done | ok
    k_acc = torch.where(done, k_acc, m)
    y = torch.where(small, x_inv, k_acc)
    return torch.where(flip, n - y, y)


def allocate_counts_reference(M, P, A, E, u):
    """The allocation tree in plain PyTorch on chain-batched operands:
    M (K,G) shared, P (C,K,N), A (C,N), E (C,N,G) and the uniform planes
    u (C, 1 + 2 rounds, n2-1, K, G): 17 planes (8 BTRS rounds) as the
    planes mode takes them, 25 (12) as ``philox_planes`` builds them. Node
    j of the planes is the j-th split the
    top-down pass makes, level by level from the root, left to right,
    skipping the nodes whose right subtree holds only padding leaves
    (pallas_allocation.py:180-211). Returns (Zsum_g (C,K,N), Zsum_k
    (C,N,G)), float32 integer values summed exactly."""
    C, K, N = P.shape
    n2 = n_leaves(N)
    # bottom-up node weights; None marks a subtree of padding leaves
    leaves = [(P[:, :, n:n + 1] * A[:, n].view(C, 1, 1)) * E[:, n:n + 1, :]
              for n in range(N)] + [None] * (n2 - N)
    levels = [leaves]
    while len(levels[-1]) > 1:
        prev = levels[-1]
        levels.append([a if b is None else a + b
                       for a, b in zip(prev[0::2], prev[1::2])])
    counts = [torch.where(levels[-1][0] > 0.0, M, 0.0)]

    node = 0
    for li in range(len(levels) - 2, -1, -1):
        child = levels[li]
        nxt = []
        for pi, cnt in enumerate(counts):
            wl, wr = child[2 * pi], child[2 * pi + 1]
            if cnt is None or wr is None:
                nxt += [cnt, None]
                continue
            q = torch.clamp(wl / (wl + wr).clamp_min(1e-30), 0.0, 1.0)
            degen = (q <= 0.0) | (q >= 1.0) | (cnt <= 0.0)
            q_c = torch.where(degen, 0.5, q)
            n_c = torch.where(degen, 0.0, cnt)
            left = _binomial(n_c, q_c,
                             [u[:, r, node] for r in range(u.shape[1])])
            left = torch.minimum(left, cnt)
            left = torch.where(q >= 1.0, cnt, left)
            left = torch.where((q <= 0.0) | (cnt <= 0.0), 0.0, left)
            nxt += [left, cnt - left]
            node += 1
        counts = nxt

    Z = torch.stack(counts[:N], dim=1)                      # (C, N, K, G)
    f32 = torch.float32
    zg = Z.sum(3, dtype=torch.float64).to(f32).transpose(1, 2).contiguous()
    zk = Z.sum(2, dtype=torch.float64).to(f32)
    return zg, zk


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_U32 = ctypes.c_uint32
# M P A E u uids k0 k1, Zsum_g Zsum_k scratch, C K N G, g0 G_total, stream
_ARGTYPES = [_P] * 6 + [_U32] * 2 + [_P] * 3 + [_I] * 4 + [_I] * 2 + [_P]
TILE_G = 32          # columns g per block (csrc/allocation.cu kTileG)
ROWS = 8             # rows k per block (kRows)


def _launch(M, P, A, E, u, uids, key, g0, G_total):
    from ._build import load_library

    lib = load_library()
    fn = lib.allocate_counts_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    C, K, N = P.shape
    G = E.shape[2]
    f32 = dict(dtype=torch.float32, device=P.device)
    zg = torch.empty(C, K, N, **f32)
    zk = torch.empty(C, N, G, **f32)
    # the partials: Zsum_g per G tile (C, tiles, K, N), then Zsum_k per
    # block of rows (C, kblocks, N, G)
    tiles, kblocks = -(-G // TILE_G), -(-K // ROWS)
    scratch = torch.empty(C * (tiles * K * N + kblocks * N * G),
                          dtype=torch.float64, device=P.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    k0, k1 = key if key is not None else (0, 0)
    with torch.cuda.device(P.device):
        err = fn(ptr(M), ptr(P), ptr(A), ptr(E), ptr(u), ptr(uids), k0, k1,
                 ptr(zg), ptr(zk), ptr(scratch), C, K, N, G, g0, G_total,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"allocate_counts kernel launch failed: "
                           f"cudaError {err}")
    allocate_counts.launches += 1
    return zg, zk


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


def _check(name, t, shape, device, dtype=torch.float32):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"allocate_counts: {name} must be a tensor")
    if t.device != device:
        raise ValueError(f"allocate_counts: {name} is on {t.device}, "
                         f"expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"allocate_counts: {name} must be {dtype}, got "
                        f"{t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"allocate_counts: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"allocate_counts: {name} must be contiguous")


def allocate_counts(M, P, A, E, u=None, key=None, uids=None, g0: int = 0,
                    G_total: int | None = None):
    """Draw the multinomial latent counts of every cell and return their
    marginal sums (Zsum_g (K, N), Zsum_k (N, G)); the same contract as
    bayesnmf_tpu.ops.pallas_allocation.allocate_counts_fused.

    M (K, G) is shared and holds non-negative integer counts (the kernel's
    inversion stops once x reaches the count, which returns the plain
    version's draw for integers only; ``GibbsSampler`` checks the data);
    P (K, N), A (N,) and E (N, G) may carry a leading chain axis C, and the
    results then do too. Randomness: the uniform planes ``u``
    (C, 17, n2-1, K, G) when given; otherwise the Philox stream of ``key``
    (two 32-bit ints) and the chains' ``uids`` ((C,) int64 on the device),
    on the CPU through ``philox_planes``, on CUDA in the kernel.

    On a G shard (parallel/mesh.py) M, E and the planes are a rank's
    columns of the whole: ``g0`` is its first column and ``G_total`` the
    whole G, so the Philox stream counts cells of the whole matrix (the
    defaults leave every unsharded call as it was); ``uids`` name the
    rank's chains. Zsum_g is then this shard's part.
    """
    batched = P.dim() == 3
    b = (lambda t: t) if batched else (lambda t: t.unsqueeze(0))
    P, A, E = b(P), b(A), b(E)
    if u is not None:
        u = b(u)
    C, K, N = P.shape
    G = E.shape[2]
    dev = P.device
    if N > MAX_N:
        raise NotImplementedError(
            f"allocate_counts: at most {MAX_N} components, got N = {N}")
    _check("M", M, (K, G), dev)
    _check("P", P, (C, K, N), dev)
    _check("A", A, (C, N), dev)
    _check("E", E, (C, N, G), dev)
    G_total = G if G_total is None else G_total
    if u is not None:
        _check("u", u, (C, N_PLANES, n_nodes(N), K, G), dev)
    else:
        if key is None or uids is None:
            raise ValueError("allocate_counts: give the uniform planes u, or "
                             "the Philox key and the chains' uids")
        _check("uids", uids, (C,), dev, torch.int64)

    if dev.type == "cpu":
        if u is None:
            u = philox_planes(key, uids, N, K, G, g0=g0, G_total=G_total)
        zg, zk = allocate_counts_reference(M, P, A, E, u)
    elif dev.type == "cuda":
        zg, zk = _launch(M, P, A, E, u, None if u is not None else uids,
                         None if u is not None else key, g0, G_total)
    else:
        raise ValueError(f"allocate_counts: no path for device {dev}")
    if not batched:
        zg, zk = zg[0], zk[0]
    return zg, zk


#: kernel launches since the count was last reset (CPU calls do not count)
allocate_counts.launches = 0
