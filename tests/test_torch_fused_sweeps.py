"""The port's fused-sweep function against the JAX Pallas kernel.

Both sides get the same numpy inputs and the same uniforms. The JAX kernel
runs in Pallas interpret mode on the CPU, as tests/test_pallas.py runs it;
the port runs its plain PyTorch version, which is what the wrapper takes for
CPU tensors. Tolerance: rtol 1e-4, atol 1e-5 on every output, because the
float32 sums over G and K are taken in another order; the accept/reject
decisions must agree exactly.
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


def make_inputs(K, N, G, seed, A=None):
    """One call's operands, as the Gibbs step would hand them over."""
    rng = np.random.default_rng(seed)
    f = np.float32
    Pt = rng.dirichlet(np.ones(K) * 0.5, N).T * 50.0
    Et = rng.gamma(2.0, 2.0, (N, G))
    data = rng.poisson(Pt @ Et).astype(f)
    P = (Pt * rng.uniform(0.5, 1.5, (K, N))).astype(f)
    E = (Et * rng.uniform(0.5, 1.5, (N, G))).astype(f)
    A = np.ones(N, f) if A is None else np.asarray(A, f)
    Mh = ((P * A[None, :]) @ E).astype(f)
    u = lambda *s: rng.uniform(1e-6, 1.0, s).astype(f)  # noqa: E731
    mean = float(data.mean())
    hp = [0.0, np.sqrt(mean / N), N + 1.0, np.sqrt(N)]
    return dict(
        data=data, P=P, E=E, A=A, Mhat=Mh,
        acc_P=np.ones((K, N), f), acc_E=np.ones((N, G), f),
        Upr_P=u(K, N), Upr_E=u(N, G), Up_P=u(K, N), Ua_P=u(K, N),
        Up_E=u(N, G), Ua_E=u(N, G),
        hp0_p=rng.normal(0.0, 1.0, (K, N)).astype(f),
        hp1_p=rng.gamma(2.0, 2.0, (K, N)).astype(f),
        hp0_e=rng.normal(0.0, 1.0, (N, G)).astype(f),
        hp1_e=rng.gamma(2.0, 2.0, (N, G)).astype(f),
        rank_pack=np.zeros((3, N + 1), f),
        hyper_u=(u(4, K, N), u(4, N, G)),
        hyper_hp=(np.stack([np.full((K, N), v, f) for v in hp]),
                  np.stack([np.full((N, G), v, f) for v in hp])),
    )


_ARGS = ("data", "P", "E", "A", "Mhat", "acc_P", "acc_E", "Upr_P", "Upr_E",
         "Up_P", "Ua_P", "Up_E", "Ua_E", "hp0_p", "hp1_p", "hp0_e", "hp1_e",
         "rank_pack")


def run_jax(d, accept_all):
    out = jax_sweeps(*(jnp.asarray(d[k]) for k in _ARGS),
                     prior_kind="truncnormal", exact_mh=True,
                     accept_all=accept_all, rank_method=None,
                     hyper_u=tuple(map(jnp.asarray, d["hyper_u"])),
                     hyper_hp=tuple(map(jnp.asarray, d["hyper_hp"])))
    return [np.asarray(o) for o in out]


def run_torch(d, accept_all):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    out = FS.fused_gibbs_sweeps(
        *(t(d[k]) for k in _ARGS), prior_kind="truncnormal", exact_mh=True,
        accept_all=accept_all, rank_method=None,
        hyper_u=tuple(map(t, d["hyper_u"])),
        hyper_hp=tuple(map(t, d["hyper_hp"])))
    return [o.numpy() for o in out]


def assert_match(got, want, d):
    for name, g, w in zip(OUT_NAMES, got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=name)
    # same accept/reject decision for every entry
    for i, k in ((0, "P"), (1, "E")):
        np.testing.assert_array_equal(got[i] != d[k], want[i] != d[k],
                                      err_msg=f"{k} decisions")


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


@pytest.mark.parametrize("kw", [dict(prior_kind="exponential"),
                                dict(exact_mh=False),
                                dict(rank_method="SBFI")])
def test_unported_specialisations_raise(kw):
    d = make_inputs(7, 2, 37, seed=1)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    args = dict(prior_kind="truncnormal", exact_mh=True, accept_all=False,
                rank_method=None) | kw
    with pytest.raises(NotImplementedError):
        FS.fused_gibbs_sweeps(*(t(d[k]) for k in _ARGS), **args)


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
