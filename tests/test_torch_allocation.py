"""The port's latent-count allocation against the JAX Pallas kernel.

The JAX kernel runs in Pallas interpret mode on the CPU, where it draws
its uniforms as one operand, jax.random.uniform(fold_in(key, 0),
(17, n2-1, K, Gp), minval=1.2e-38) with Gp the G axis padded to its tile
(pallas_allocation.py:282-288). The same planes, cut to G, go to the port's
plain version, which is what the wrapper runs on CPU tensors. The counts
are integers, so Zsum_g and Zsum_k must be equal exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesnmf_tpu.ops.pallas_allocation import _pick_tile
from bayesnmf_tpu.ops.pallas_allocation import allocate_counts_fused
from bayesnmf_tpu_torch.ops import allocation as AL
from bayesnmf_tpu_torch.ops.math import const
from bayesnmf_tpu_torch.ops.rng import ChainStreams

torch.set_num_threads(1)


def setup(K, N, G, seed, excluded=(), zero_cells=(), scale=30.0):
    rng = np.random.default_rng(seed)
    f = np.float32
    P = rng.gamma(2.0, 1.0, (K, N)).astype(f)
    E = rng.gamma(2.0, 1.0, (N, G)).astype(f)
    A = np.ones(N, f)
    A[list(excluded)] = 0.0
    M = rng.poisson(scale, (K, G)).astype(f)
    for k, g in zero_cells:
        M[k, g] = 0.0
    return M, P, A, E


def jax_planes(key, K, N, G):
    """The uniform operand allocate_counts_fused draws in interpret mode."""
    n2 = AL.n_leaves(N)
    Gt = _pick_tile(K, G, n2)
    Gp = -(-G // Gt) * Gt
    u = jax.random.uniform(jax.random.fold_in(key, 0),
                           (AL.N_PLANES, AL.n_nodes(N), K, Gp), jnp.float32,
                           minval=1.2e-38)
    return np.asarray(u)[..., :G]


def both(M, P, A, E, seed):
    key = jax.random.PRNGKey(seed)
    zg, zk = allocate_counts_fused(key, jnp.asarray(M), jnp.asarray(P),
                                   jnp.asarray(A), jnp.asarray(E),
                                   interpret=True)
    u = jax_planes(key, M.shape[0], P.shape[1], M.shape[1])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got = AL.allocate_counts(t(M), t(P), t(A), t(E), u=t(u))
    return [g.numpy() for g in got], [np.asarray(zg), np.asarray(zk)]


@pytest.mark.parametrize("shape,excluded,zero_cells", [
    ((16, 5, 40), (3,), ((0, 0),)),
    ((7, 3, 37), (), ()),
    ((12, 8, 20), (0, 6), ((2, 3), (5, 19))),
    ((9, 1, 15), (), ()),
    ((10, 2, 33), (1,), ()),
])
def test_plain_version_equals_jax_kernel(shape, excluded, zero_cells):
    """Exact equality on the same planes, both regimes: the multinomial
    splits of counts ~30 with n·p above and below 10."""
    M, P, A, E = setup(*shape, seed=sum(shape), excluded=excluded,
                       zero_cells=zero_cells)
    got, want = both(M, P, A, E, seed=shape[0])
    for name, g, w in zip(("Zsum_g", "Zsum_k"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_large_counts_take_the_btrs_regime_and_match():
    """Counts ~2000: most splits run BTRS; still exactly JAX's."""
    M, P, A, E = setup(8, 4, 30, seed=3, scale=2000.0)
    got, want = both(M, P, A, E, seed=9)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def philox(seed, it=0):
    """The Philox mode's operands of one chain (uid 0): the key of the
    streams of ``seed`` at iteration ``it`` and the uid."""
    return dict(key=ChainStreams(seed, [0], it).subkey("alloc"),
                uids=torch.zeros(1, dtype=torch.int64))


def test_conservation_exclusion_and_integers():
    M, P, A, E = setup(16, 5, 40, seed=0, excluded=(3,), zero_cells=((0, 0),))
    zg, zk = (x.numpy() for x in AL.allocate_counts(*_t(M, P, A, E),
                                                    **philox(1)))
    np.testing.assert_array_equal(zk.sum(0), M.sum(0))
    np.testing.assert_array_equal(zg.sum(1), M.sum(1))
    assert zg[:, 3].sum() == 0 and zk[3].sum() == 0
    assert zk[:, 0].sum() == M[:, 0].sum()
    np.testing.assert_array_equal(zk, np.round(zk))
    assert (zg >= 0).all() and (zk >= 0).all()


def test_all_zero_weight_cell_allocates_nothing():
    """A cell whose weights are all zero (E[:, g] = 0) gets zero counts,
    whatever M holds there (the total > 0 guard)."""
    M, P, A, E = setup(6, 3, 10, seed=4)
    E[:, 2] = 0.0
    zg, zk = AL.allocate_counts(*_t(M, P, A, E), **philox(2))
    assert float(zk[:, 2].sum()) == 0.0
    np.testing.assert_array_equal(zg.numpy().sum(1),
                                  M.sum(1) - M[:, 2])


def _stopping_inversion(n, pp, u):
    """A float32 mirror of csrc/allocation.cu's inversion: the reference's
    recurrence, with x frozen from the first step that adds nothing, or once
    x reaches n (the kernel leaves its loop there)."""
    ratio = pp / (1.0 - pp).clamp_min(1e-12)
    pmf = torch.exp(n * torch.log1p(-pp))
    cdf = pmf
    x = torch.zeros_like(n)
    live = torch.ones(n.shape, dtype=torch.bool)
    for j in range(AL._INV_STEPS):
        live = live & (u > cdf)
        x = x + live.to(torch.float32)
        live = live & (x < n)
        pmf = pmf * (n - j) / const(j + 1.0, n) * ratio
        cdf = cdf + pmf
    return torch.minimum(x, n)


def test_stopping_inversion_equals_the_40_steps():
    """The kernel's inversion stops early; it returns what the reference's
    40 steps (ops/allocation.py::_binomial) return, on counts 0..60, every
    p' with n p' <= 10 on a grid, both flips, and uniforms near 0, near 1
    and exactly at (and one ulp around) the CDF values: the pmf is never
    negative, so the CDF never falls, and past n it is 0."""
    n = torch.arange(61, dtype=torch.float32).view(-1, 1)
    frac = torch.linspace(0.0, 1.0, 41)[1:].view(1, -1)
    pp = torch.minimum(10.0 / n.clamp_min(1.0), torch.tensor(0.5)) * frac
    n, pp = torch.broadcast_tensors(n, pp)
    n, pp = n.reshape(-1, 1), pp.reshape(-1, 1)
    # the CDF at x = 0..5, by the reference's recurrence
    ratio = pp / (1.0 - pp).clamp_min(1e-12)
    pmf = torch.exp(n * torch.log1p(-pp))
    cdfs = [pmf]
    for j in range(5):
        pmf = pmf * (n - j) / const(j + 1.0, n) * ratio
        cdfs.append(cdfs[-1] + pmf)
    at = torch.cat(cdfs, 1).clamp(1.2e-38, 1.0)
    fixed = torch.tensor([1.2e-38, 1e-30, 1e-7, 1e-3, 0.3, 0.5, 0.7, 0.999,
                          1.0 - 2.0 ** -23, 1.0 - 2.0 ** -24])
    u = torch.cat([fixed.expand(n.shape[0], -1), at,
                   torch.nextafter(at, torch.tensor(0.0)),
                   torch.nextafter(at, torch.tensor(1.0))], 1)
    n, pp = n.expand_as(u), pp.expand_as(u)
    rest = torch.full_like(u, 0.5)   # BTRS planes, unused by inversions
    for p in (pp, 1.0 - pp):
        flip = p > 0.5
        q = torch.where(flip, 1.0 - p, p)
        # 1 - (1 - p') may round above n p' = 10: those cells run BTRS
        small = n * q <= 10.0
        assert float(small.float().mean()) > 0.95
        want = AL._binomial(n, p, [u, rest, rest])
        y = _stopping_inversion(n, q, u)
        got = torch.where(flip, n - y, y)
        assert torch.equal(got[small], want[small])


def _assert_multinomial_mean(M, P, A, E, zks):
    """Each cell of Zsum_k's mean over the draws ``zks`` within 6 of its own
    SD of the multinomial mean."""
    S = len(zks)
    W = P[:, :, None] * A[None, :, None] * E[None, :, :]
    probs = W / np.maximum(W.sum(1, keepdims=True), 1e-30)
    expect = (M[:, None, :] * probs).sum(0)
    sd = np.sqrt(np.maximum(
        (M[:, None, :] * probs * (1 - probs)).sum(0), 1e-9) / S)
    z = np.abs(zks.mean(0) - expect) / sd
    assert z.max() < 6.0, f"a cell's mean is {z.max():.2f} of its SD off"


def test_multinomial_mean():
    """The mean over 200 draws lies within 6 SD of the multinomial mean,
    each cell against its own SD (tests/test_allocation.py:85-120 takes the
    largest SD of all cells)."""
    M, P, A, E = setup(16, 5, 40, seed=0, excluded=(3,))
    zks = np.stack([AL.allocate_counts(*_t(M, P, A, E),
                                       **philox(5, it))[1].numpy()
                    for it in range(200)])
    _assert_multinomial_mean(M, P, A, E, zks)


# Random123's known-answer vectors for Philox4x32-10: (counter, key, output)
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", PHILOX_KAT)
def test_philox_known_answers(ctr, key, want):
    """The plain Philox4x32-10, which the kernel's in-kernel stream is held
    against on the card, gives the published answers."""
    i64 = lambda x: torch.tensor(x, dtype=torch.int64)  # noqa: E731
    got = AL.philox4x32_10([i64(c) for c in ctr], i64(key[0]), i64(key[1]))
    assert [int(x) for x in got] == list(want)


def test_philox_planes_layout():
    """Plane i of node j at cell (k, g) of the chain of uid c is word i % 4
    of the block with counter (k*G + g, j, i // 4, c) under the key's two
    32-bit words, its low 24 bits j mapped to max(j / 2^24, tiny)."""
    C, N, K, G = 2, 5, 3, 4
    key = (0x0F0E0D0C, 0x1234ABCD)
    uids = torch.tensor([7, 2], dtype=torch.int64)
    u = AL.philox_planes(key, uids, N, K, G)
    assert u.shape == (C, 1 + 2 * AL.PHILOX_ROUNDS, AL.n_nodes(N), K, G)
    i64 = lambda x: torch.tensor(x, dtype=torch.int64)  # noqa: E731
    for c, i, j, k, g in [(0, 0, 0, 0, 0), (1, 5, 3, 2, 1), (0, 24, 6, 1, 3),
                          (1, 12, 0, 2, 3)]:
        words = AL.philox4x32_10(
            [i64(k * G + g), i64(j), i64(i // 4), i64(int(uids[c]))],
            i64(key[0]), i64(key[1]))
        want = max((int(words[i % 4]) & 0xFFFFFF) / 2.0 ** 24, 1.1754944e-38)
        assert float(u[c, i, j, k, g]) == np.float32(want)
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0


def test_philox_mode_multinomial_mean():
    """The plain version on the Philox mode's 25 planes (12 BTRS rounds),
    one seed a draw: counts conserved and integer, the excluded component
    0, the mean within 6 SD of the multinomial mean in every cell."""
    M, P, A, E = setup(16, 5, 40, seed=0, excluded=(3,), zero_cells=((0, 0),))
    Mt, Pt, At, Et = _t(M, P[None], A[None], E[None])
    zks = []
    for s in range(200):
        u = AL.philox_planes((s * 7919 + 1, 0),
                             torch.zeros(1, dtype=torch.int64), 5, 16, 40)
        zg, zk = (x[0].numpy() for x in AL.allocate_counts_reference(
            Mt, Pt, At, Et, u))
        np.testing.assert_array_equal(zk.sum(0), M.sum(0))
        np.testing.assert_array_equal(zg.sum(1), M.sum(1))
        assert zg[:, 3].sum() == 0 and zk[3].sum() == 0
        np.testing.assert_array_equal(zk, np.round(zk))
        zks.append(zk)
    _assert_multinomial_mean(M, P, A, E, np.stack(zks))


def test_chain_batch_matches_unbatched_calls():
    """A leading chain axis on P, A, E and the planes: each chain's sums
    equal a one-chain call on its slice; M is shared."""
    C, K, N, G = 3, 10, 6, 25
    rng = np.random.default_rng(8)
    M = rng.poisson(40.0, (K, G)).astype(np.float32)
    P = rng.gamma(2.0, 1.0, (C, K, N)).astype(np.float32)
    E = rng.gamma(2.0, 1.0, (C, N, G)).astype(np.float32)
    A = np.ones((C, N), np.float32)
    A[1, 2] = A[2, 0] = 0.0
    u = np.random.default_rng(9).uniform(
        1e-6, 1.0, (C, AL.N_PLANES, AL.n_nodes(N), K, G)).astype(np.float32)
    zg, zk = AL.allocate_counts(*_t(M, P, A, E), u=torch.from_numpy(u))
    assert zg.shape == (C, K, N) and zk.shape == (C, N, G)
    for c in range(C):
        zg1, zk1 = AL.allocate_counts(*_t(M, P[c], A[c], E[c]),
                                      u=torch.from_numpy(u[c]))
        np.testing.assert_array_equal(zg[c].numpy(), zg1.numpy())
        np.testing.assert_array_equal(zk[c].numpy(), zk1.numpy())
    assert float(zg[1, :, 2].sum()) == 0.0 and float(zk[2, 0].sum()) == 0.0


def test_wrapper_rejects_bad_operands():
    M, P, A, E = _t(*setup(6, 3, 10, seed=1))
    with pytest.raises(TypeError):
        AL.allocate_counts(M.double(), P, A, E, **philox(0))
    with pytest.raises(ValueError):
        AL.allocate_counts(M[:, :-1].contiguous(), P, A, E, **philox(0))
    with pytest.raises(ValueError):
        AL.allocate_counts(M, P, A, E, u=torch.rand(1, 17, 3, 6, 10))
    with pytest.raises(ValueError, match="key"):
        AL.allocate_counts(M, P, A, E)
    with pytest.raises(TypeError):
        AL.allocate_counts(M, P, A, E, key=(0, 0),
                           uids=torch.zeros(1, dtype=torch.int32))


def test_cuda_tensors_never_take_the_plain_path(monkeypatch):
    """For a CUDA tensor the wrapper launches the kernel or raises: the
    plain version is not reached. Checked with a stand-in launcher, since
    this machine has no card."""
    M, P, A, E = _t(*setup(6, 3, 10, seed=2))
    calls = []

    def fake_launch(*a):
        calls.append("kernel")
        raise RuntimeError("stand-in kernel")

    def no_plain(*a, **k):
        raise AssertionError("plain version reached for CUDA tensors")

    monkeypatch.setattr(AL, "_launch", fake_launch)
    monkeypatch.setattr(AL, "allocate_counts_reference", no_plain)
    monkeypatch.setattr(AL, "_check", lambda *a: None)
    fake_cuda = torch.device("cuda", 0)
    monkeypatch.setattr(torch.Tensor, "device", property(
        lambda self: fake_cuda))
    with pytest.raises(RuntimeError, match="stand-in kernel"):
        AL.allocate_counts(M, P, A, E, **philox(0))
    assert calls == ["kernel"]
