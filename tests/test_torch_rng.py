"""The port's per-chain counter-based random streams (ops/rng.py) on the CPU:
the plain Philox4x32-10 against Random123's known answers and an
independent numpy version, the layout of the uniforms and normals, the
allocation's planes, and the invariant that a chain's draws depend on its
seed, uid, iteration, site and element alone: not on the chains beside it,
a compaction, a mesh block, or the rejection rounds of other elements."""

import os

import numpy as np
import pytest
import torch

import bayesnmf_tpu_torch as bt
from bayesnmf_tpu_torch.config import ModelSpec, default_hyperprior_params
from bayesnmf_tpu_torch.models import gibbs
from bayesnmf_tpu_torch.models import updates as U
from bayesnmf_tpu_torch.ops import allocation as AL
from bayesnmf_tpu_torch.ops import distributions as D
from bayesnmf_tpu_torch.ops import rng as R
from bayesnmf_tpu_torch.parallel import mesh as M
from test_torch_mesh import fake_mesh, rejecting_planes, sim

torch.set_num_threads(1)

MASK = 0xFFFFFFFF

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


def np_philox(ctr, key):
    """Philox4x32-10 in numpy uint64 (each 32 x 32 product exact), an
    implementation independent of the port's."""
    x = [np.asarray(c, np.uint64) for c in ctr]
    x = np.broadcast_arrays(*x)
    x = [a.copy() for a in x]
    k0, k1 = np.uint64(key[0]), np.uint64(key[1])
    m0, m1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
    w0, w1 = np.uint64(0x9E3779B9), np.uint64(0xBB67AE85)
    mask, s32 = np.uint64(MASK), np.uint64(32)
    for _ in range(10):
        p0, p1 = x[0] * m0, x[2] * m1
        x = [(p1 >> s32) ^ x[1] ^ k0, p1 & mask, (p0 >> s32) ^ x[3] ^ k1,
             p0 & mask]
        k0, k1 = (k0 + w0) & mask, (k1 + w1) & mask
    return x


def np_uniform(word):
    return np.maximum((word & np.uint64(0xFFFFFF)).astype(np.float32)
                      * np.float32(2.0 ** -24), np.float32(R.TINY))


@pytest.mark.parametrize("ctr,key,want", PHILOX_KAT)
def test_philox_known_answers(ctr, key, want):
    """The plain Philox4x32-10 (the rounds of csrc/philox.cuh) gives the
    published answers on int64 tensors and on Python ints, as does the
    numpy version the tests below hold it against."""
    i64 = lambda x: torch.tensor(x, dtype=torch.int64)  # noqa: E731
    got = R.philox4x32_10([i64(c) for c in ctr], i64(key[0]), i64(key[1]))
    assert [int(x) for x in got] == list(want)
    assert [int(x) for x in R.philox4x32_10(ctr, *key)] == list(want)
    assert [int(x) for x in np_philox(ctr, key)] == list(want)


def test_philox_moved_into_rng():
    """ops/allocation.py takes the rounds from ops/rng.py: one copy."""
    assert AL.philox4x32_10 is R.philox4x32_10
    assert not hasattr(AL, "_mulhilo")


def test_philox_planes_unchanged_for_uids_0_to_C():
    """The allocation's Philox planes for the chains of uids 0..C-1 (the
    layout that an unsharded call with its first chain at c0 = 0 drew):
    plane i of node j at cell (k, g) of chain c is word i % 4 of the block
    (k*G + g, j, i // 4, c) under the key, mapped by uniform_of."""
    C, N, K, G = 3, 6, 4, 5
    key = (0x89ABCDEF, 0x01234567)
    u = AL.philox_planes(key, torch.arange(C), N, K, G).numpy()
    nn, n_u = AL.n_nodes(N), 1 + 2 * AL.PHILOX_ROUNDS
    c, j, k, g = np.meshgrid(np.arange(C), np.arange(nn), np.arange(K),
                             np.arange(G), indexing="ij")
    for i in range(n_u):
        words = np_philox((k * G + g, j, np.full_like(c, i // 4), c), key)
        np.testing.assert_array_equal(u[:, i], np_uniform(words[i % 4]))


def test_uniform_and_normal_layout():
    """Element e of the chain of uid c at (site, round, iteration): the
    uniform is word e % 4 of block (e // 4, site + (round << 8), it, c);
    the normal Box-Muller of block e // 2's words (2 (e % 2), 2 (e % 2) +
    1), in float64, rounded to float32."""
    s = R.ChainStreams(0x1234_0000_0042, [3, 11], it=17)
    n = 37
    u = s.uniform("sweep_E", (2, n), rnd=0).numpy()
    u5 = s.uniform("sweep_E", (2, n), rnd=5).numpy()
    z = s.normal("eager_z", (2, n)).numpy()
    e = np.arange(n)
    for row, uid in enumerate((3, 11)):
        for got, site, rnd in ((u, "sweep_E", 0), (u5, "sweep_E", 5)):
            words = np_philox((e // 4, R.SITES[site] + (rnd << 8), 17, uid),
                              s.key)
            want = np.choose(e % 4, [np_uniform(w) for w in words])
            np.testing.assert_array_equal(got[row], want)
        words = np_philox((e // 2, R.SITES["eager_z"], 17, uid), s.key)
        u1 = np.choose(e % 2, [np_uniform(words[0]), np_uniform(words[2])])
        u2 = np.choose(e % 2, [np_uniform(words[1]), np_uniform(words[3])])
        want = (np.sqrt(-2.0 * np.log(u1.astype(np.float64)))
                * np.cos(2.0 * np.pi * u2.astype(np.float64)))
        np.testing.assert_allclose(z[row], want.astype(np.float32),
                                   rtol=1e-6, atol=1e-7)
    assert not np.array_equal(u, u5)


def test_uniform_range_and_normal_moments():
    s = R.ChainStreams(4, [0, 1])
    u = s.uniform("fused", (2, 100_000))
    assert float(u.min()) >= R.TINY and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.005
    z = s.normal("stream_z", (2, 100_000)).double()
    assert abs(float(z.mean())) < 0.01 and abs(float(z.var()) - 1.0) < 0.02
    # every distinct 24-bit value maps to a distinct float
    j = torch.arange(0, 2 ** 24, 4099, dtype=torch.int64)
    assert torch.unique(R.uniform_of(j)).numel() == j.numel()


def draws(s, C):
    """Every kind of draw of ``C`` chains: plain, chain axis second, G
    axis, flat parts, normal, a rejection round."""
    K, N, G = 5, 3, 11
    return {"plain": s.uniform("fused", (C, 40)),
            "c_dim": s.uniform("prior_P", (2, C, K, N), c_dim=1),
            "g": s.uniform("sweep_E", (C, 3, N, G), g=True),
            "flat": s.flat("slice", (C, 18), [(1, K * N, False),
                                              (N, G, True)]),
            "normal": s.normal("hyper_z", (C, 2, 7)),
            "round": s.uniform("lambda_e", (C, 2, N, G), g=True, rnd=3)}


def chain_of(d, c):
    return {k: (v[:, c] if k == "c_dim" else v[c]) for k, v in d.items()}


def test_a_chains_draws_do_not_depend_on_its_company():
    """The chain of uid 2 draws the same numbers bit for bit alone, among 3
    or 6 chains in any order, after ``select`` and without a chain axis."""
    alone = chain_of(draws(R.ChainStreams(5, [2], it=7), 1), 0)
    three = R.ChainStreams(5, [0, 1, 2], it=7)
    six = R.ChainStreams(5, [4, 2, 0, 1, 3, 5], it=7)
    for got in (chain_of(draws(three, 3), 2), chain_of(draws(six, 6), 1),
                chain_of(draws(six.select([1, 5]), 2), 0),
                chain_of(draws(six.select(torch.tensor([1])), 1), 0)):
        for k, v in alone.items():
            assert torch.equal(got[k], v), k
    one = R.ChainStreams(5, [2], it=7)
    assert torch.equal(one.uniform("fused", (40,), c_dim=None),
                       alone["plain"])
    with pytest.raises(ValueError, match="one chain"):
        three.uniform("fused", (40,), c_dim=None)
    with pytest.raises(ValueError, match="3 chains"):
        six.uniform("fused", (3, 40))


@pytest.mark.parametrize("n_chain,n_g", [(1, 2), (2, 1), (2, 3)])
def test_a_mesh_block_draws_only_its_block(n_chain, n_g, monkeypatch):
    """On every rank of a (chain, g) mesh the block's draws are the
    one-process draws' block bit for bit, and the block computes only its
    own elements."""
    C, G = 4, 11
    whole = R.ChainStreams(8, [7, 6, 5, 4], it=2)
    full = draws(whole, C)
    fills = []
    fill = R.philox_fill

    def spy(uids, key, word1, it, n, index=None, normal=False):
        fills.append(uids.numel() * n)
        return fill(uids, key, word1, it, n, index, normal)

    monkeypatch.setattr(R, "philox_fill", spy)
    for ci in range(n_chain):
        for gi in range(n_g):
            mesh = fake_mesh(n_chain, n_g, ci, gi)
            sg = whole.block(mesh, G)
            c0, c1 = M.chain_block(C, mesh)
            g0, g1 = M.g_block(G, mesh)
            assert sg.G_local == g1 - g0
            fills.clear()
            got = {"plain": sg.uniform("fused", (c1 - c0, 40)),
                   "g": sg.uniform("sweep_E", (c1 - c0, 3, 3, g1 - g0),
                                   g=True),
                   "flat": sg.flat("slice", (c1 - c0, 18),
                                   [(1, 15, False), (3, g1 - g0, True)]),
                   "round": sg.uniform("lambda_e", (c1 - c0, 2, 3, g1 - g0),
                                       g=True, rnd=3)}
            cs = slice(c0, c1)
            flat = full["flat"][cs]
            want = {"plain": full["plain"][cs],
                    "g": full["g"][cs][..., g0:g1],
                    "flat": torch.cat([flat[..., :15], flat[..., 15:].reshape(
                        -1, 18, 3, G)[..., g0:g1].reshape(c1 - c0, 18, -1)],
                        -1),
                    "round": full["round"][cs][..., g0:g1]}
            for k, v in want.items():
                assert torch.equal(got[k], v), (ci, gi, k)
            assert fills == [v.numel() for v in got.values()]


def test_gamma_rounds_elsewhere_do_not_shift_a_chain():
    """A chain's gamma draw is the same bit for bit whether or not another
    chain (or another element) needs the exact rejection loop's rounds, and
    so is every later draw."""
    C, K, N = 2, 5, 3
    rng = torch.Generator().manual_seed(2)
    a = 0.5 + 3.0 * torch.rand((C, K, N), generator=rng)
    b = 0.5 + torch.rand((C, K, N), generator=rng)
    u = torch.rand((C, 9, K, N), generator=rng).clamp_min(1e-6)
    u[1] = rejecting_planes(1, (K, N))[0]
    pair = R.ChainStreams(3, [0, 1], it=4)
    D.gamma.rounds = 0
    both = D.gamma(pair, a, b, u=u, chain_axis=True, site="gamma_P")
    assert D.gamma.rounds > 0
    D.gamma.rounds = 0
    alone = D.gamma(pair.select([0]), a[:1], b[:1], u=u[:1],
                    chain_axis=True, site="gamma_P")
    assert D.gamma.rounds == 0
    assert torch.equal(both[:1], alone)
    # the rejecting chain alone draws what it drew beside the other
    D.gamma.rounds = 0
    assert torch.equal(D.gamma(pair.select([1]), a[1:], b[1:], u=u[1:],
                               chain_axis=True, site="gamma_P"), both[1:])
    assert D.gamma.rounds > 0
    assert torch.equal(pair.uniform("gamma_E", (2, 9, N, 7))[:1],
                       pair.select([0]).uniform("gamma_E", (1, 9, N, 7)))


INIT_SPECS = {
    "truncnormal-mh": dict(),
    "exponential-conjugate": dict(prior="exponential", MH=False),
    "gamma-conjugate": dict(prior="gamma", MH=False),
    "normal-truncnormal": dict(likelihood="normal", MH=False),
}


@pytest.mark.parametrize("fam", sorted(INIT_SPECS))
def test_initial_state_of_a_chain_does_not_depend_on_its_company(fam):
    """init_state of 6 chains, of 3, and of the chain of uid 2 alone (as a
    batch of one, and without a chain axis as GibbsSampler draws it): the
    chain's prior parameters, P, E, R, A, latent-count sums and sigmasq
    equal bit for bit; the first step of the 6 and of the 3 chains at
    once keeps them equal."""
    spec = ModelSpec(K=12, N=3, G=32, rank_method="SBFI",
                     learning_rank=True, **INIT_SPECS[fam])
    data = torch.from_numpy(sim())
    hp = default_hyperprior_params(spec, float(data.mean()))

    def init(uids, chains=True):
        return gibbs.init_state(spec, hp, data, R.ChainStreams(6, uids),
                                chains=len(uids) if chains else None)

    six, three = init(range(6)), init([0, 1, 2])
    one, bare = init([2]), init([2], chains=False)
    for group in ("params", "prior"):
        for k, v in six[group].items():
            for other, c in ((three, 2), (one, 0)):
                assert torch.equal(other[group][k][c], v[2]), (group, k)
            assert torch.equal(bare[group][k], v[2]), (group, k)
    acc = torch.zeros(6, dtype=torch.bool)
    six, _ = gibbs.gibbs_step(spec, data, hp, six, 1.0, acc)
    three, _ = gibbs.gibbs_step(spec, data, hp, three, 1.0, acc[:3])
    for group in ("params", "prior"):
        for k, v in three[group].items():
            assert torch.equal(six[group][k][:3], v), (group, k)


def test_state_round_trip_and_subkey():
    s = R.ChainStreams(2 ** 40 + 9, [3, 1], it=5)
    d = s.state()
    assert isinstance(d["seed"], int) and isinstance(d["iter"], int)
    assert isinstance(d["uids"], np.ndarray)
    r = R.ChainStreams.from_state(d)
    assert torch.equal(r.uniform("A", (2, 9)), s.uniform("A", (2, 9)))
    assert s.at(5) is s and s.at(6).iter == 6 and s.iter == 5
    keys = {s.subkey("alloc"), s.at(6).subkey("alloc"), s.subkey("R"),
            R.ChainStreams(2 ** 40 + 10, [0], it=5).subkey("alloc")}
    assert len(keys) == 4 and s.subkey("alloc") == r.subkey("alloc")


def test_conjugate_cpu_draws_the_kernels_planes():
    """The conjugate step's latent counts on the CPU are the plain version
    on philox_planes of the streams' (seed, iteration, "alloc") key and the
    chains' uids: the uniforms the kernel draws in its Philox mode for the
    same seed (csrc/allocation.cu, checked on the card by chip_smoke.py)."""
    spec = ModelSpec(K=12, N=3, G=32, prior="exponential", MH=False)
    data = torch.from_numpy(sim())
    hp = default_hyperprior_params(spec, float(data.mean()))
    st = gibbs.init_state(spec, hp, data, R.ChainStreams(1, [4, 9]),
                          chains=2)
    gen = gibbs.streams_of(st)
    got = U.sample_Z_sums(spec, data, st["params"], gen)
    p = st["params"]
    want = AL.allocate_counts_reference(
        data, p["P"], p["A"], p["E"],
        AL.philox_planes(gen.subkey("alloc"), gen.uids, spec.N, spec.K,
                         spec.G))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_checks_and_cuda_never_takes_the_plain_path(monkeypatch):
    """The wrapper checks its operands; for a CUDA tensor it launches the
    kernel or raises, never the plain version (a stand-in launcher, since
    this machine has no card)."""
    uids = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="uids"):
        R.philox_fill(uids.to(torch.int32), (0, 0), 0, 0, 4)
    with pytest.raises(ValueError, match="index"):
        R.philox_fill(uids, (0, 0), 0, 0, 4, index=torch.arange(3))
    calls = []

    def fake_launch(*a):
        calls.append("kernel")
        raise RuntimeError("stand-in kernel")

    def no_plain(*a, **k):
        raise AssertionError("plain version reached for CUDA tensors")

    monkeypatch.setattr(R, "_launch", fake_launch)
    monkeypatch.setattr(R, "philox_fill_reference", no_plain)
    fake_cuda = torch.device("cuda", 0)
    monkeypatch.setattr(torch.Tensor, "device", property(
        lambda self: fake_cuda))
    with pytest.raises(RuntimeError, match="stand-in kernel"):
        R.philox_fill(uids, (0, 0), 0, 0, 4)
    assert calls == ["kernel"] and R.philox_fill.launches == 0


def test_no_generator_draw_in_the_port():
    """No torch.rand / randn / randint with a generator, and no
    torch.Generator, in the port: every draw goes through the streams."""
    root = os.path.dirname(os.path.abspath(bt.__file__))
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    text = fh.read()
                assert "generator=" not in text, f
                assert "torch.Generator(" not in text, f


DRAW_SPECS = {
    "fused-truncnormal": dict(fused_sweeps=True),
    "fused-truncnormal-conjugate-hypers": dict(fused_sweeps=True,
                                               exact_truncnorm_hypers=False),
    "fused-exponential": dict(fused_sweeps=True, prior="exponential"),
    "eager-truncnormal": dict(),
    "eager-exponential": dict(prior="exponential"),
    "normal-truncnormal": dict(likelihood="normal", MH=False),
    "normal-exponential": dict(likelihood="normal", prior="exponential",
                               MH=False),
    "conjugate-exponential": dict(prior="exponential", MH=False),
    "conjugate-gamma": dict(prior="gamma", MH=False),
    "stream-truncnormal": dict(stream_sweeps=True),
    "stream-conjugate-hypers": dict(stream_sweeps=True,
                                    exact_truncnorm_hypers=False),
    "stream-exponential": dict(stream_sweeps=True, prior="exponential"),
}


@pytest.mark.parametrize("learning", [False, True])
@pytest.mark.parametrize("path", sorted(DRAW_SPECS))
def test_draw_launches_counts_every_draw(path, learning, monkeypatch):
    """gibbs.draw_launches gives the draw kernel's launches of the initial
    state and of a step on every path, besides one a rejection round: the
    counts chip_smoke.py and bench_torch.py hold the card's runs to."""
    kw = dict(DRAW_SPECS[path])
    if learning:
        kw |= dict(learning_rank=True, rank_method="SBFI")
    spec = ModelSpec(K=12, N=3, G=32, **kw)
    data = torch.from_numpy(sim())
    hp = default_hyperprior_params(spec, float(data.mean()))
    calls, fill = [0], R.philox_fill

    def spy(*a, **k):
        calls[0] += 1
        return fill(*a, **k)

    monkeypatch.setattr(R, "philox_fill", spy)
    D.gamma.rounds = 0
    st = gibbs.init_state(spec, hp, data, R.ChainStreams(2, [0, 1]),
                          chains=2)
    assert calls[0] == gibbs.draw_launches(spec, init=True) + D.gamma.rounds
    acc = torch.zeros(2, dtype=torch.bool)
    for _ in range(3):
        calls[0], D.gamma.rounds = 0, 0
        st, _ = gibbs.gibbs_step(spec, data, hp, st, 1.0, acc)
        assert calls[0] == gibbs.draw_launches(spec) + D.gamma.rounds


@pytest.mark.parametrize("fam", ["gamma", "exact", "conjugate-hypers",
                                 "exponential"])
def test_one_chain_without_its_axis_draws_as_a_batch_of_one(fam):
    """The prior update and the R draw of one chain's unbatched state (as
    GibbsSampler's state is) draw what the same chain draws as a batch of
    one."""
    kw = {"gamma": dict(prior="gamma", MH=False),
          "exact": dict(),
          "conjugate-hypers": dict(exact_truncnorm_hypers=False),
          "exponential": dict(prior="exponential")}[fam]
    spec = ModelSpec(K=12, N=3, G=32, **kw)
    data = torch.from_numpy(sim())
    hp = default_hyperprior_params(spec, float(data.mean()))
    st = gibbs.init_state(spec, hp, data, R.ChainStreams(4, [0]))
    gen = gibbs.streams_of(st)
    one = U.sample_prior_params(spec, hp, st["params"], st["prior"], gen)
    batch = U.sample_prior_params(spec, hp, U.lift(st["params"]),
                                  U.lift(st["prior"]), gen)
    for k, v in one.items():
        assert torch.equal(v, batch[k][0]), k
    A = torch.tensor([1.0, 0.0, 1.0])
    assert torch.equal(U.sample_R(spec, A, 0.5, gen),
                       U.sample_R(spec, A[None], 0.5, gen)[0])
