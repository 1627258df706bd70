"""The port's fused-sweep function against the JAX Pallas kernel.

Both sides get the same numpy inputs and the same uniforms. The JAX kernel
runs in Pallas interpret mode on the CPU, as tests/test_pallas.py runs it;
the port runs its plain PyTorch version, which is what the wrapper takes for
CPU tensors. Tolerance: rtol 1e-4, atol 1e-5 on every output, because the
float32 sums over G and K are taken in another order; the accept/reject
decisions, the inclusion vector A and the rank R must agree exactly.
Covered: the truncnormal and the exponential prior, the exact and the
reference-parity (exact_mh=False) ratio, and the SBFI/BFI rank branch at
several temperatures, one chain and a chain batch.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bayesnmf_tpu.ops.pallas_sweeps import fused_gibbs_sweeps as jax_sweeps
from bayesnmf_tpu_torch.ops import fused_sweeps as FS

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
OUT_NAMES = ("P", "E", "Mhat", "acc_P", "acc_E", "A", "R", "nan", "Mu_p",
             "Sigmasq_p", "Mu_e", "Sigmasq_e")


def make_inputs(K, N, G, seed, A=None, prior="truncnormal", temp=None,
                zero_E_row=None):
    """One call's operands, as the Gibbs step would hand them over. With
    the exponential prior hp0 is Lambda and hp1 ones; ``temp`` fills the
    rank pack as the rank-learning step does (temperature, Gumbel noise,
    the A draws' uniforms padded with a zero); ``zero_E_row`` zeroes one
    row of E (an all-zero ``other`` for that P column)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    Pt = rng.dirichlet(np.ones(K) * 0.5, N).T * 50.0
    Et = rng.gamma(2.0, 2.0, (N, G))
    data = rng.poisson(Pt @ Et).astype(f)
    P = (Pt * rng.uniform(0.5, 1.5, (K, N))).astype(f)
    E = (Et * rng.uniform(0.5, 1.5, (N, G))).astype(f)
    if zero_E_row is not None:
        E[zero_E_row] = 0.0
    A = np.ones(N, f) if A is None else np.asarray(A, f)
    Mh = ((P * A[None, :]) @ E).astype(f)
    u = lambda *s: rng.uniform(1e-6, 1.0, s).astype(f)  # noqa: E731
    mean = float(data.mean())
    hp = [0.0, np.sqrt(mean / N), N + 1.0, np.sqrt(N)]
    rank_pack = np.zeros((3, N + 1), f)
    if temp is not None:
        rank_pack[0, 0] = temp
        rank_pack[1] = -np.log(-np.log(u(N + 1)))
        rank_pack[2, :N] = u(N)
    d = dict(
        data=data, P=P, E=E, A=A, Mhat=Mh,
        acc_P=np.ones((K, N), f), acc_E=np.ones((N, G), f),
        Upr_P=u(K, N), Upr_E=u(N, G), Up_P=u(K, N), Ua_P=u(K, N),
        Up_E=u(N, G), Ua_E=u(N, G),
        hp0_p=rng.normal(0.0, 1.0, (K, N)).astype(f),
        hp1_p=rng.gamma(2.0, 2.0, (K, N)).astype(f),
        hp0_e=rng.normal(0.0, 1.0, (N, G)).astype(f),
        hp1_e=rng.gamma(2.0, 2.0, (N, G)).astype(f),
        rank_pack=rank_pack,
        hyper_u=(u(4, K, N), u(4, N, G)),
        hyper_hp=(np.stack([np.full((K, N), v, f) for v in hp]),
                  np.stack([np.full((N, G), v, f) for v in hp])),
    )
    if prior == "exponential":
        d |= dict(hp0_p=rng.gamma(2.0, 0.5, (K, N)).astype(f),
                  hp1_p=np.ones((K, N), f),
                  hp0_e=rng.gamma(2.0, 0.5, (N, G)).astype(f),
                  hp1_e=np.ones((N, G), f))
    return d


_ARGS = ("data", "P", "E", "A", "Mhat", "acc_P", "acc_E", "Upr_P", "Upr_E",
         "Up_P", "Ua_P", "Up_E", "Ua_E", "hp0_p", "hp1_p", "hp0_e", "hp1_e",
         "rank_pack")


def _kw(prior_kind, exact_mh, rank_method, hyper, conv, d):
    kw = dict(prior_kind=prior_kind, exact_mh=exact_mh,
              rank_method=rank_method)
    if hyper:
        kw |= dict(hyper_u=tuple(map(conv, d["hyper_u"])),
                   hyper_hp=tuple(map(conv, d["hyper_hp"])))
    return kw


def run_jax(d, accept_all, prior_kind="truncnormal", exact_mh=True,
            rank_method=None, hyper=True):
    out = jax_sweeps(*(jnp.asarray(d[k]) for k in _ARGS),
                     accept_all=accept_all,
                     **_kw(prior_kind, exact_mh, rank_method, hyper,
                           jnp.asarray, d))
    return [np.asarray(o) for o in out]


def run_torch(d, accept_all, prior_kind="truncnormal", exact_mh=True,
              rank_method=None, hyper=True):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    out = FS.fused_gibbs_sweeps(
        *(t(d[k]) for k in _ARGS), accept_all=accept_all,
        **_kw(prior_kind, exact_mh, rank_method, hyper, t, d))
    return [o.numpy() for o in out]


def assert_match(got, want, d):
    for name, g, w in zip(OUT_NAMES, got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=name)
    # same accept/reject decision for every entry, the same A and R
    for i, k in ((0, "P"), (1, "E")):
        np.testing.assert_array_equal(got[i] != d[k], want[i] != d[k],
                                      err_msg=f"{k} decisions")
    np.testing.assert_array_equal(got[5], want[5], err_msg="A")
    np.testing.assert_array_equal(got[6], want[6], err_msg="R")


@pytest.mark.parametrize("accept_all", [True, False])
@pytest.mark.parametrize("shape", [(16, 3, 24), (7, 2, 37)])
def test_one_call_matches_jax(shape, accept_all):
    d = make_inputs(*shape, seed=sum(shape))
    got, want = run_torch(d, accept_all), run_jax(d, accept_all)
    assert_match(got, want, d)
    # the sweeps moved the state: not a trivial copy-through
    assert not np.array_equal(got[0], d["P"])


def test_excluded_column_draws_from_prior():
    d = make_inputs(16, 3, 24, seed=5, A=[1.0, 0.0, 1.0])
    got, want = run_torch(d, False), run_jax(d, False)
    assert_match(got, want, d)
    # the excluded column leaves its acceptance record untouched
    np.testing.assert_array_equal(got[3][:, 1], d["acc_P"][:, 1])


def test_chain_batch_matches_unbatched_jax_calls():
    ds = [make_inputs(16, 3, 24, seed=s) for s in (11, 12, 13)]
    flags = [True, False, False]
    batch = {k: np.stack([d[k] for d in ds]) for k in _ARGS}
    batch["hyper_u"] = tuple(np.stack([d["hyper_u"][i] for d in ds])
                             for i in range(2))
    shared = {"data": ds[0]["data"], "hyper_hp": ds[0]["hyper_hp"]}
    got = run_torch(batch | shared, torch.tensor(flags))
    for c, (d, flag) in enumerate(zip(ds, flags)):
        d = d | shared
        assert_match([o[c] for o in got], run_jax(d, flag), d)


def test_hyper_sweep_off_keeps_prior_params():
    d = make_inputs(7, 2, 37, seed=3)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    out = FS.fused_gibbs_sweeps(
        *(t(d[k]) for k in _ARGS), prior_kind="truncnormal", exact_mh=True,
        accept_all=False, rank_method=None)
    want = jax_sweeps(*(jnp.asarray(d[k]) for k in _ARGS),
                      prior_kind="truncnormal", exact_mh=True,
                      accept_all=False, rank_method=None)
    for name, g, w in zip(OUT_NAMES, out, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(out[8].numpy(), d["hp0_p"])


@pytest.mark.parametrize("exact_mh", [True, False])
@pytest.mark.parametrize("accept_all", [True, False])
@pytest.mark.parametrize("shape,zero_row", [((16, 3, 24), 1),
                                            ((7, 2, 37), None)])
def test_exponential_prior_matches_jax(shape, zero_row, accept_all,
                                       exact_mh):
    """The exponential prior (Lambda in hp0, its update outside the kernel),
    with one all-zero E row: that P column is inactive and takes the prior
    draw."""
    d = make_inputs(*shape, seed=sum(shape) + 1, prior="exponential",
                    zero_E_row=zero_row)
    kw = dict(prior_kind="exponential", exact_mh=exact_mh, hyper=False)
    got, want = run_torch(d, accept_all, **kw), run_jax(d, accept_all, **kw)
    assert_match(got, want, d)
    assert not np.array_equal(got[0], d["P"])
    if zero_row is not None and exact_mh and not accept_all:
        # the prior draw is always accepted: -log(u) / Lambda
        want_col = -np.log(d["Upr_P"][:, zero_row]) / d["hp0_p"][:, zero_row]
        np.testing.assert_allclose(got[0][:, zero_row], want_col, rtol=1e-6)
        np.testing.assert_array_equal(got[3][:, zero_row], 1.0)


@pytest.mark.parametrize("accept_all", [True, False])
@pytest.mark.parametrize("shape", [(16, 3, 24), (7, 2, 37)])
def test_reference_parity_ratio_matches_jax(shape, accept_all):
    """exact_mh=False: the reference's normal-model stand-in ratio."""
    d = make_inputs(*shape, seed=sum(shape) + 2)
    got = run_torch(d, accept_all, exact_mh=False)
    want = run_jax(d, accept_all, exact_mh=False)
    assert_match(got, want, d)
    # the ratio differs from the exact one
    exact = run_torch(d, accept_all)
    assert not np.array_equal(got[3], exact[3]) or accept_all


@pytest.mark.parametrize("temp", [0.0, 1e-3, 1.0])
@pytest.mark.parametrize("rank_method", ["SBFI", "BFI"])
def test_rank_branch_matches_jax(rank_method, temp):
    """The R draw and the A sweep after the P and E sweeps, with a mixed
    starting A; A, R and every decision equal."""
    d = make_inputs(12, 5, 30, seed=17, A=[1.0, 0.0, 1.0, 1.0, 0.0],
                    temp=temp)
    kw = dict(rank_method=rank_method)
    got, want = run_torch(d, False, **kw), run_jax(d, False, **kw)
    assert_match(got, want, d)
    assert 0.0 <= got[6] <= 5.0 and got[6] == np.round(got[6])


def test_rank_branch_moves_the_rank():
    """At temperature 0 the inclusion odds are the prior's, so columns
    leave and join: A and R move. Where a column leaves, its Mhat entries
    become differences of terms up to ~60 whose float32 rounding (a few
    ulp of 60, ~1e-5) the two versions take apart; so here Mhat is held to
    P diag(A) E of its own side, and everything else to JAX as above."""
    moved = []
    for seed in range(4):
        d = make_inputs(12, 5, 30, seed=seed, temp=0.0,
                        A=[1.0, 1.0, 0.0, 1.0, 0.0])
        got, want = run_torch(d, False, rank_method="SBFI"), run_jax(
            d, False, rank_method="SBFI")
        assert_match([g if i != 2 else w for i, (g, w) in
                      enumerate(zip(got, want))], want, d)
        for P, E, Mh, A in ((got[0], got[1], got[2], got[5]),
                            (want[0], want[1], want[2], want[5])):
            exact = (P.astype(np.float64) * A) @ E.astype(np.float64)
            scale = np.abs(P).max() * np.abs(E).max()
            np.testing.assert_allclose(Mh, exact, rtol=0,
                                       atol=1e-6 * scale)
        moved.append(not np.array_equal(got[5], d["A"]))
    assert any(moved)


def test_chain_batch_with_rank_learning_matches_jax():
    """Three chains with their own temperature and warmup flag, SBFI rank
    learning, the exponential prior without the hyper-sweep on one side of
    the comparison each: a batch of the port against unbatched JAX calls."""
    ds = [make_inputs(12, 5, 30, seed=s, A=a, temp=t)
          for s, a, t in ((21, [1, 1, 1, 0, 0], 1e-4), (22, [1, 0, 1, 0, 1],
                                                         0.3),
                          (23, [0, 0, 1, 1, 1], 1.0))]
    flags = [True, False, True]
    batch = {k: np.stack([d[k] for d in ds]) for k in _ARGS}
    batch["hyper_u"] = tuple(np.stack([d["hyper_u"][i] for d in ds])
                             for i in range(2))
    shared = {"data": ds[0]["data"], "hyper_hp": ds[0]["hyper_hp"]}
    got = run_torch(batch | shared, torch.tensor(flags), rank_method="SBFI")
    for c, (d, flag) in enumerate(zip(ds, flags)):
        d = d | shared
        assert_match([o[c] for o in got],
                     run_jax(d, flag, rank_method="SBFI"), d)


@pytest.mark.parametrize("kw", [dict(prior_kind="gamma"),
                                dict(rank_method="BIC"),
                                dict(prior_kind="exponential", hyper=True)])
def test_unported_specialisations_raise(kw):
    """The gamma prior and rank_method='BIC' are not kernel options, and the
    in-kernel hyper-sweep is the truncnormal prior's."""
    d = make_inputs(7, 2, 37, seed=1)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    args = dict(prior_kind="truncnormal", exact_mh=True, rank_method=None,
                hyper=False) | kw
    with pytest.raises(NotImplementedError):
        FS.fused_gibbs_sweeps(
            *(t(d[k]) for k in _ARGS), accept_all=False,
            **_kw(args["prior_kind"], args["exact_mh"], args["rank_method"],
                  args["hyper"], t, d))


def test_wrapper_rejects_bad_operands():
    d = make_inputs(7, 2, 37, seed=1)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    args = [t(d[k]) for k in _ARGS]
    kw = dict(prior_kind="truncnormal", exact_mh=True, accept_all=False,
              rank_method=None)
    bad = list(args)
    bad[1] = args[1].double()
    with pytest.raises(TypeError):
        FS.fused_gibbs_sweeps(*bad, **kw)
    bad = list(args)
    bad[2] = args[2].t().contiguous().t()  # a transposed view
    with pytest.raises(ValueError):
        FS.fused_gibbs_sweeps(*bad, **kw)
    bad = list(args)
    bad[4] = args[4][:, :-1].contiguous()
    with pytest.raises(ValueError):
        FS.fused_gibbs_sweeps(*bad, **kw)


def test_cuda_tensors_never_take_the_plain_path(monkeypatch):
    """For a CUDA tensor the wrapper launches the kernel or raises: the plain
    version is not reached. Checked with a stand-in launcher, since this
    machine has no card."""
    d = make_inputs(7, 2, 37, seed=2)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    args = [t(d[k]) for k in _ARGS]
    calls = []

    def fake_launch(*a):
        calls.append("kernel")
        raise RuntimeError("stand-in kernel")

    def no_plain(*a, **k):
        raise AssertionError("plain version reached for CUDA tensors")

    monkeypatch.setattr(FS, "_launch", fake_launch)
    monkeypatch.setattr(FS, "fused_gibbs_sweeps_reference", no_plain)
    monkeypatch.setattr(FS, "_check", lambda *a: None)
    fake_cuda = torch.device("cuda", 0)
    monkeypatch.setattr(torch.Tensor, "device", property(
        lambda self: fake_cuda))
    with pytest.raises(RuntimeError, match="stand-in kernel"):
        FS.fused_gibbs_sweeps(*args, prior_kind="truncnormal", exact_mh=True,
                              accept_all=True, rank_method=None)
    assert calls == ["kernel"]


# (K, N, G, C) -> (blocks per chain, E slice resident, data/Mhat slices
# resident)
CLUSTER_CASES = [
    ((7, 2, 37, 1), (2, True, True)),       # at most 32 columns a block
    ((96, 5, 100, 1), (4, True, True)),
    ((96, 8, 500, 1), (16, True, True)),
    ((96, 8, 1003, 1), (16, True, True)),   # G not divisible by the cluster
    ((96, 8, 2780, 1), (16, True, True)),
    ((96, 8, 4000, 1), (16, True, False)),  # slices past shared memory
    ((96, 20, 10000, 1), (16, True, False)),
    ((96, 20, 100000, 1), (16, False, False)),  # not even the E slice fits
    ((96, 8, 500, 4), (16, True, True)),    # a batch the card keeps resident
    ((96, 8, 500, 8), (8, True, True)),     # larger batches: smaller clusters
    ((96, 8, 500, 64), (1, True, False)),
]


@pytest.mark.parametrize("shape,want", CLUSTER_CASES)
def test_cluster_config_picks_size_and_residency(shape, want):
    """The pure-Python helper that sizes the kernel's cluster and decides
    what stays in shared memory."""
    assert FS.cluster_config(*shape) == want
    K, N, G, C = shape
    S, e_res, res = want
    Gq = -(-G // S)
    need = FS._fixed_smem_bytes(K, N, S)
    if e_res:
        need += 4 * N * Gq
    if res:
        need += 8 * K * Gq
    assert need <= FS._SMEM_MAX_BYTES
    if not res:  # the next thing did not fit
        extra = 8 * K * Gq if e_res else 4 * N * Gq
        assert need + extra > FS._SMEM_MAX_BYTES
    assert S == 16 or Gq <= 32 or C * 2 * S > FS._RESIDENT_BLOCKS
    assert S == 1 or C * S <= FS._RESIDENT_BLOCKS


def test_cluster_config_refuses_what_no_block_can_hold():
    with pytest.raises(ValueError):
        FS.cluster_config(4000, 20, 100)
