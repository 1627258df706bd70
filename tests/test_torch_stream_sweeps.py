"""The port's streaming path against the JAX package, function by function.

Both sides get the same numpy inputs. The JAX Pallas kernels run in
interpret mode on the CPU, as tests/test_stream_sweeps.py runs them; the
port runs each kernel's plain PyTorch version, which is what its wrapper
takes for CPU tensors. Where a function draws random numbers, the port is
fed the JAX function's own draws, rebuilt from the same key.

Tolerances. The six stream functions: rtol 1e-5 at G = 300 and rtol 1e-4 at
G = 25000 (two ragged G tiles at K = 16), with an absolute floor of rtol
times the largest output, because JAX sums float32 partials tile by tile
while the port sums in float64; the E-row log-likelihood sums over K cancel
to values far below their terms, where only the absolute error means
anything. The sweeps, the hyper-update and the metrics row: rtol 1e-5 and
identical accept decisions; drawn values also get atol 1e-6, because a draw
mu + sd*z near 0 keeps the absolute rounding of mu (~1e-7 at mu ~ 1). The
metrics row's KL is a difference of two sums of size sum(M log M) and is
held to 1e-5 of that instead; so are loglik, logposterior and BIC in the
row's extra cases, whose counts make loglik a few per cent of its sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesnmf_tpu.config import ConvergenceControl as JConvergenceControl
from bayesnmf_tpu.config import ModelSpec as JModelSpec
from bayesnmf_tpu.config import default_hyperprior_params
from bayesnmf_tpu.models import convergence as jconv
from bayesnmf_tpu.models import gibbs as jgibbs
from bayesnmf_tpu.models import updates as JU
from bayesnmf_tpu.ops import math as jm
from bayesnmf_tpu.ops import pallas_stream_sweeps as JS
from bayesnmf_tpu_torch.config import ConvergenceControl, ModelSpec
from bayesnmf_tpu_torch.models import convergence as tconv
from bayesnmf_tpu_torch.models import gibbs as tgibbs
from bayesnmf_tpu_torch.models import updates as TU
from bayesnmf_tpu_torch.ops import math as tm
from bayesnmf_tpu_torch.ops import stream_sweeps as S
from bayesnmf_tpu_torch.ops.rng import ChainStreams
from bayesnmf_tpu_torch.utils.measure import count_ops

torch.set_num_threads(1)

_TINY = np.float32(1.1754944e-38)
_U_MIN = np.float32(1.2e-38)


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, rtol, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


# ---------------------------------------------------------------------------
# the six stream functions
# ---------------------------------------------------------------------------


def stream_inputs(K, N, G, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    Pt = rng.dirichlet(np.ones(K) * 0.5, N).T * 50.0
    Et = rng.gamma(2.0, 2.0, (N, G))
    P = (Pt * rng.uniform(0.5, 1.5, (K, N))).astype(f)
    E = (Et * rng.uniform(0.5, 1.5, (N, G))).astype(f)
    A = np.ones(N, f)
    A[1] = 0.0
    n = 0
    return dict(
        data=rng.poisson(Pt @ Et).astype(f), E=E, PA=(P * A).astype(f),
        en=E[n].copy(), pn=P[:, n].copy(),
        prop_k=(P[:, n] * rng.uniform(0.5, 1.5, K)).astype(f),
        prop_g=(E[n] * rng.uniform(0.5, 1.5, G)).astype(f),
        an=np.float32(1.0))


# name -> (argument names, output count)
STREAM_FUNCS = {
    "pcol_stats": (("data", "E", "PA", "en", "pn"), 2),
    "pcol_accept": (("data", "E", "PA", "en", "pn", "prop_k"), 3),
    "erow_stats": (("data", "E", "PA", "en", "pn"), 2),
    "erow_accept": (("data", "E", "PA", "en", "pn", "prop_g"), 3),
    "acol_delta": (("data", "E", "PA", "en", "pn", "an"), 1),
    "chain_metrics": (("data", "E", "PA"), 4),
}


def call_jax(name, d):
    out = getattr(JS, name)(*(jnp.asarray(d[k])
                              for k in STREAM_FUNCS[name][0]))
    return [np.asarray(o) for o in (out if isinstance(out, tuple)
                                    else (out,))]


def call_port(name, d):
    out = getattr(S, name)(*(t(d[k]) for k in STREAM_FUNCS[name][0]))
    return [o.numpy() for o in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("G,rtol", [(300, 1e-5), (25000, 1e-4)])
@pytest.mark.parametrize("name", list(STREAM_FUNCS))
def test_stream_function_matches_jax(name, G, rtol):
    d = stream_inputs(16, 3, G, seed=G)
    got, want = call_port(name, d), call_jax(name, d)
    assert len(got) == len(want) == STREAM_FUNCS[name][1]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == np.float32
        close(g, w, rtol, atol=rtol * float(np.abs(w).max()),
              msg=f"{name} output {i}")


@pytest.mark.parametrize("name", list(STREAM_FUNCS))
def test_chain_axis_equals_separate_jax_calls(name):
    """C = 3 chains in one port call equal three JAX calls on one dataset."""
    ds = [stream_inputs(16, 3, 300, seed=s) for s in (1, 2, 3)]
    for d in ds[1:]:
        d["data"] = ds[0]["data"]
    args = STREAM_FUNCS[name][0]
    batch = [t(ds[0]["data"])] + [t(np.stack([d[k] for d in ds]))
                                  for k in args[1:]]
    out = getattr(S, name)(*batch)
    out = out if isinstance(out, tuple) else (out,)
    for c, d in enumerate(ds):
        for i, w in enumerate(call_jax(name, d)):
            assert out[i].shape[0] == 3
            close(out[i][c].numpy(), w, 1e-5,
                  atol=1e-5 * float(np.abs(w).max()),
                  msg=f"{name} chain {c} output {i}")


def test_wrappers_check_their_operands():
    d = stream_inputs(7, 2, 37, seed=4)
    a = [t(d[k]) for k in ("data", "E", "PA", "en", "pn")]
    with pytest.raises(TypeError):
        S.pcol_stats(a[0], a[1].double(), *a[2:])
    with pytest.raises(ValueError):
        S.pcol_stats(a[0], a[1], a[2], a[3][:-1].contiguous(), a[4])
    with pytest.raises(ValueError):
        S.pcol_stats(a[0].t().contiguous().t(), *a[1:])
    with pytest.raises(ValueError):  # a non-contiguous chain batch
        E2 = torch.stack([a[1], a[1]], -1).movedim(-1, 0)
        S.chain_metrics(a[0], E2, torch.stack([a[2], a[2]]))


@pytest.mark.parametrize("name", list(STREAM_FUNCS))
def test_cuda_tensors_never_take_the_plain_path(name, monkeypatch):
    """For a CUDA tensor each wrapper launches its kernel or raises: the
    plain version is not reached and a CPU call counts no launch. Checked
    with stand-in launchers, since this machine has no card."""
    d = stream_inputs(7, 2, 37, seed=5)
    args = [t(d[k]) for k in STREAM_FUNCS[name][0]]
    S.reset_launch_counts()
    call_port(name, d)
    assert (S._run.launches, S.acol_delta.launches,
            S.chain_metrics.launches) == (0, 0, 0)

    def fake_launch(*a):
        raise RuntimeError("stand-in kernel")

    def no_plain(*a, **k):
        raise AssertionError("plain version reached for CUDA tensors")

    for launch in ("_launch_run", "_launch_acol", "_launch_metrics"):
        monkeypatch.setattr(S, launch, fake_launch)
    for plain in ("run_reference", "acol_delta_reference",
                  "chain_metrics_reference"):
        monkeypatch.setattr(S, plain, no_plain)
    monkeypatch.setattr(S, "_check", lambda *a: None)
    fake_cuda = torch.device("cuda", 0)
    monkeypatch.setattr(torch.Tensor, "device", property(
        lambda self: fake_cuda))
    with pytest.raises(RuntimeError, match="stand-in kernel"):
        getattr(S, name)(*args)


# ---------------------------------------------------------------------------
# the sweeps, the hyper-update and R, fed the JAX draws
# ---------------------------------------------------------------------------

K, N, G, C = 16, 4, 140, 2


@pytest.fixture(scope="module")
def ens_setup():
    """A JAX two-chain SBFI stream state and the same state in the port's
    layout."""
    from bayesnmf_tpu.parallel import chains as JCH

    rng = np.random.default_rng(4)
    P = rng.dirichlet(np.ones(K) * 0.5, 2).T * 40
    E = rng.gamma(2.0, 2.0, (2, G))
    data = rng.poisson(P @ E).astype(np.float32)
    kw = dict(K=K, N=N, G=G, likelihood="poisson", prior="truncnormal",
              MH=True, learning_rank=True, rank_method="SBFI",
              stream_sweeps=True)
    jspec, tspec = JModelSpec(**kw), ModelSpec(**kw)
    hp = default_hyperprior_params(jspec, float(data.mean()))
    js = JCH.init_chain_states(jspec, hp, jnp.asarray(data),
                               jax.random.PRNGKey(6), C)
    # one chain with an excluded column, one with an all-zero E row
    js["params"]["A"] = js["params"]["A"].at[0, 1].set(0.0)
    js["params"]["A"] = js["params"]["A"].at[1].set(1.0)
    js["params"]["E"] = js["params"]["E"].at[1, 2].set(0.0)
    return jspec, tspec, hp, data, js


def port_tree(tree):
    return {k: t(np.asarray(v)) for k, v in tree.items()}


def p_noise(key, rows, cols):
    """stream_sweep_P/E's draws: the prior draw's two uniform planes, then
    the (3, N, rows-or-cols) sweep uniforms (updates.py:558-561)."""
    k_prior, k_u = jax.random.split(key)
    prior_u = jax.random.uniform(k_prior, (2, rows, cols), jnp.float32,
                                 minval=_TINY, maxval=1.0)
    return prior_u, k_u


def stack_noise(keys, fn):
    parts = [fn(k) for k in keys]
    return {name: t(np.stack([np.asarray(p[name]) for p in parts]))
            for name in parts[0]}


@pytest.mark.parametrize("accept_all", [(True, False), (False, False)])
def test_stream_sweep_P_matches_jax(ens_setup, accept_all):
    jspec, tspec, hp, data, js = ens_setup
    params, prior = js["params"], js["prior"]
    acc = jnp.full((C, K, N), 0.5, jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(7), C)
    flags = jnp.asarray(accept_all)
    want = jax.vmap(lambda p, pr, a, k, f: JU.stream_sweep_P(
        jspec, jnp.asarray(data), p, pr, a, k, f))(params, prior, acc, keys,
                                                   flags)

    def noise(k):
        prior_u, k_u = p_noise(k, K, N)
        return {"prior_u": prior_u,
                "u": jax.random.uniform(k_u, (3, N, K), jnp.float32,
                                        minval=_U_MIN)}

    got = TU.stream_sweep_P(tspec, t(data), port_tree(params),
                            port_tree(prior), t(acc), torch.tensor(
                                accept_all), noise=stack_noise(keys, noise))
    P0 = np.asarray(params["P"])
    Pw, Pg = np.asarray(want[0]), got[0].numpy()
    np.testing.assert_array_equal(Pg != P0, Pw != P0)
    close(Pg, Pw, 1e-5, 1e-6, msg="P")
    close(got[1].numpy(), np.asarray(want[1]), 1e-5, msg="acc_P")
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert not np.array_equal(Pg, P0)


def test_stream_sweep_E_matches_jax(ens_setup):
    jspec, tspec, hp, data, js = ens_setup
    params, prior = js["params"], js["prior"]
    acc = jnp.full((C, N, G), 0.5, jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(9), C)
    flags = jnp.asarray([False, True])
    want = jax.vmap(lambda p, pr, a, k, f: JU.stream_sweep_E(
        jspec, jnp.asarray(data), p, pr, a, k, f))(params, prior, acc, keys,
                                                   flags)

    def noise(k):
        prior_u, k_u = p_noise(k, N, G)
        return {"prior_u": prior_u,
                "u": jax.random.uniform(k_u, (3, N, G), jnp.float32,
                                        minval=_U_MIN)}

    got = TU.stream_sweep_E(tspec, t(data), port_tree(params),
                            port_tree(prior), t(acc),
                            torch.tensor([False, True]),
                            noise=stack_noise(keys, noise))
    E0 = np.asarray(params["E"])
    Ew, Eg = np.asarray(want[0]), got[0].numpy()
    np.testing.assert_array_equal(Eg != E0, Ew != E0)
    close(Eg, Ew, 1e-5, 1e-6, msg="E")
    close(got[1].numpy(), np.asarray(want[1]), 1e-5, msg="acc_E")


@pytest.mark.parametrize("rank_method", ["SBFI", "BFI"])
def test_sample_R_and_stream_sweep_A_match_jax(ens_setup, rank_method):
    jspec, tspec, hp, data, js = ens_setup
    jspec = JModelSpec(**{**jspec.__dict__, "rank_method": rank_method})
    tspec = ModelSpec(**{**tspec.__dict__, "rank_method": rank_method})
    params = js["params"]
    temp = jnp.float32(0.7)
    keys = jax.random.split(jax.random.PRNGKey(21), C)
    k_R = jax.random.split(jax.random.PRNGKey(22), C)
    R_want = jax.vmap(lambda a, k: JU.sample_R(jspec, a, temp, k))(
        params["A"], k_R)
    gumbel = t(np.stack([np.asarray(jax.random.gumbel(k, (N + 1,)))
                         for k in k_R]))
    R_got = TU.sample_R(tspec, t(params["A"]), 0.7, gumbel=gumbel)
    np.testing.assert_array_equal(R_got.numpy(), np.asarray(R_want))

    R = jnp.asarray([1, 3], jnp.int32)
    want = jax.vmap(lambda p, r, k: JU.stream_sweep_A(
        jspec, jnp.asarray(data), p, r, temp, k))(params, R, keys)
    u = t(np.stack([[np.asarray(jax.random.uniform(kn, ()))
                     for kn in jax.random.split(k, N)] for k in keys]))
    got = TU.stream_sweep_A(tspec, t(data), port_tree(params), t(R), 0.7,
                            u=u)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_sample_prior_params_matches_jax(ens_setup):
    jspec, tspec, hp, data, js = ens_setup
    params, prior = js["params"], js["prior"]
    keys = jax.random.split(jax.random.PRNGKey(31), C)
    want = jax.vmap(lambda p, pr, k: JU.sample_prior_params(
        jspec, hp, p, pr, k))(params, prior, keys)
    n2 = TU.n_hyper_noise(tspec)

    def noise(k):
        kz, ku = jax.random.split(k, 2)
        return {"z": jax.random.normal(kz, (n2,), jnp.float32),
                "u": jax.random.uniform(ku, (n2,), jnp.float32,
                                        minval=_U_MIN)}

    got = TU.sample_prior_params(tspec, hp, port_tree(params),
                                 port_tree(prior),
                                 noise=stack_noise(keys, noise))
    for k in ("Mu_p", "Sigmasq_p", "Mu_e", "Sigmasq_e"):
        old = np.asarray(prior[k])
        np.testing.assert_array_equal(got[k].numpy() != old,
                                      np.asarray(want[k]) != old,
                                      err_msg=f"{k} decisions")
        close(got[k].numpy(), np.asarray(want[k]), 1e-5, 1e-6, msg=k)


PRIOR_PAIRS = ("Mu_p", "Sigmasq_p", "Mu_e", "Sigmasq_e")


def hyper_operands(ens_setup, chains=True):
    """sample_prior_params' operands at ens_setup's two-chain state (chain
    0 alone without ``chains``), the noise laid out as draw_stream_noise
    lays it: z a draw of its own, u a slice of a wider draw."""
    jspec, tspec, hp, data, js = ens_setup
    params, prior = port_tree(js["params"]), port_tree(js["prior"])
    n2 = TU.n_hyper_noise(tspec)
    rng = np.random.default_rng(12)
    noise = {"z": t(rng.standard_normal((C, n2)).astype(np.float32)),
             "u": t(rng.uniform(_U_MIN, 1.0, (C, n2 + 41)).astype(
                 np.float32))[:, :n2]}
    if not chains:
        params, prior, noise = TU.drop(params), TU.drop(prior), TU.drop(noise)
    return tspec, hp, params, prior, noise


def hyper_args(params, prior, noise, hp):
    return [params["P"], params["E"], *(prior[k] for k in PRIOR_PAIRS),
            noise["z"], noise["u"], [hp[k] for k in S.HYPERS]]


@pytest.mark.parametrize("chains", [True, False])
def test_hyper_update_never_takes_the_plain_path_on_cuda(ens_setup, chains,
                                                         monkeypatch):
    """For CUDA tensors the exact hyper-update is one launch of the kernel
    (one chain as a batch of one), with the hyperparameters as numbers: the
    PyTorch ops are not reached and nothing is copied to the card; a CPU
    call counts no launch. Checked with a stand-in launcher, whose
    operands then give the CPU call's result."""
    tspec, hp, params, prior, noise = hyper_operands(ens_setup, chains)
    S.reset_launch_counts()
    want = TU.sample_prior_params(tspec, hp, params, prior, noise=noise)
    assert S.hyper_update.launches == 0
    calls = []
    tensor = torch.tensor

    def stand_in(*a):
        calls.append(a)
        return tuple(torch.full(a[2 + i].shape, float(i)) for i in range(4))

    def no_plain(*a, **k):
        raise AssertionError("the PyTorch ops reached for CUDA tensors")

    def no_copy(*a, **k):
        if "device" in k:
            raise AssertionError("a number copied to the card")
        return tensor(*a, **k)

    fake_cuda = torch.device("cuda", 0)
    with monkeypatch.context() as mp:
        mp.setattr(S, "_launch_hyper", stand_in)
        for name in ("_mu_step", "_sq_step", "hyper_update_reference"):
            mp.setattr(S, name, no_plain)
        mp.setattr(torch, "tensor", no_copy)
        mp.setattr(torch.Tensor, "device", property(lambda self: fake_cuda))
        got = TU.sample_prior_params(tspec, hp, params, prior, noise=noise)
    assert S.hyper_update.launches == 1 and len(calls) == 1
    for i, k in enumerate(PRIOR_PAIRS):
        assert (got[k] == float(i)).all()
        assert got[k].shape == prior[k].shape
    assert calls[0][8] == [hp[k] for k in S.HYPERS]
    for k, v in zip(PRIOR_PAIRS, S.hyper_update_reference(*calls[0])):
        assert torch.equal(v if chains else v[0], want[k]), k
    S.reset_launch_counts()
    assert S.hyper_update.launches == 0


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity",
                                  "noise_rows", "noise_length", "device",
                                  "hypers"])
def test_hyper_update_checks_its_operands(ens_setup, case):
    tspec, hp, params, prior, noise = hyper_operands(ens_setup)
    args = hyper_args(params, prior, noise, hp)
    err = ValueError
    if case == "dtype":
        args[3], err = args[3].double(), TypeError
    elif case == "shape":
        args[4] = args[4][:, :, :-1].contiguous()
    elif case == "contiguity":
        args[1] = args[1].transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "noise_rows":
        args[7] = args[7].t().contiguous().t()
    elif case == "noise_length":
        args[6] = args[6][:, :-1]
    elif case == "device":
        args[2] = torch.empty(args[2].shape, device="meta")
    else:
        args[8] = args[8][:-1]
    with pytest.raises(err):
        S.hyper_update(*args)


def test_hyper_update_takes_noise_rows_of_any_stride(ens_setup):
    """Noise rows that are slices of a wider draw give what their
    contiguous copies give, and each chain what it gets alone."""
    tspec, hp, params, prior, noise = hyper_operands(ens_setup)
    args = hyper_args(params, prior, noise, hp)
    assert not args[7].is_contiguous()
    got = S.hyper_update(*args)
    same = S.hyper_update(*args[:6], args[6].clone(), args[7].contiguous(),
                          args[8])
    one = S.hyper_update(*(a[1:] for a in args[:8]), args[8])
    for a, b, c, k in zip(got, same, one, PRIOR_PAIRS):
        assert torch.equal(a, b) and torch.equal(a[1:], c), k
        assert (a != prior[k]).any(), f"{k}: no move accepted"


@pytest.mark.parametrize("exact", [True, False])
def test_truncnormal_prior_update_copies_nothing_to_the_card(ens_setup,
                                                             exact,
                                                             monkeypatch):
    """Neither truncnormal branch makes a number a device tensor with
    torch.tensor (a blocking copy from the host on the card); the exact one
    reads nothing back either."""
    jspec, tspec, hp, data, js = ens_setup
    tspec, hp, params, prior, noise = hyper_operands(ens_setup)
    if not exact:
        tspec = ModelSpec(K=K, N=N, G=G, likelihood="poisson",
                          prior="truncnormal", MH=True,
                          exact_truncnorm_hypers=False)
        rng = np.random.default_rng(13)
        noise = {"mu_p": t(rng.standard_normal((C, K, N)).astype(np.float32)),
                 "mu_e": t(rng.standard_normal((C, N, G)).astype(np.float32)),
                 "sq_p": t(rng.uniform(0.05, 1.0, (C, 9, K, N)).astype(
                     np.float32)),
                 "sq_e": t(rng.uniform(0.05, 1.0, (C, 9, N, G)).astype(
                     np.float32))}
    tensor = torch.tensor

    def no_copy(*a, **k):
        if "device" in k:
            raise AssertionError("a number copied to the card")
        return tensor(*a, **k)

    monkeypatch.setattr(torch, "tensor", no_copy)
    _, reads = count_ops(torch, lambda: TU.sample_prior_params(
        tspec, hp, params, prior, noise=noise))
    if exact:
        assert reads == 0


def test_stream_step_makes_one_hyper_update_call(ens_setup, monkeypatch):
    """stream_step updates Mu and Sigmasq by one call of hyper_update (one
    launch on the card, gibbs.hyper_launches)."""
    jspec, tspec, hp, data, js = ens_setup
    state = {"params": port_tree(js["params"]),
             "prior": port_tree(js["prior"]),
             "acc_P": t(np.asarray(js["acc_P"])),
             "acc_E": t(np.asarray(js["acc_E"])), "iter": 4,
             "gen": ChainStreams(0, np.arange(C))}
    calls = []
    update = S.hyper_update

    def spy(*a, **k):
        calls.append(update(*a, **k))
        return calls[-1]

    monkeypatch.setattr(S, "hyper_update", spy)
    new, _ = tgibbs.stream_step(tspec, t(data), hp, state, 0.5,
                                torch.tensor([False, True]))
    assert len(calls) == 1 == tgibbs.hyper_launches(tspec)
    for k, v in zip(PRIOR_PAIRS, calls[0]):
        assert new["prior"][k] is v


@pytest.mark.parametrize("kw,want", [
    (dict(stream_sweeps=True), 1), (dict(fused_sweeps=False), 1),
    (dict(fused_sweeps=True), 0), (dict(likelihood="normal", MH=False), 1),
    (dict(stream_sweeps=True, exact_truncnorm_hypers=False), 0),
    (dict(stream_sweeps=True, prior="exponential"), 0)])
def test_hyper_launches_by_path(kw, want):
    spec = ModelSpec(**{**dict(K=K, N=N, G=G, likelihood="poisson",
                               prior="truncnormal", MH=True), **kw})
    assert tgibbs.hyper_launches(spec) == want


ROW_ARGS = ("P", "E", "A", "acc_P", "acc_E", "Mu_p", "Sigmasq_p", "Mu_e",
            "Sigmasq_e")


def jax_rows(jspec, data, params, prior, acc_P, acc_E, na, it, temp):
    """The JAX package's metrics rows of a chain batch: _metrics_row with
    ``pois_red`` from chain_metrics on P * A, as its stream step does."""
    consts = jm.metric_constants("poisson", jnp.asarray(data))

    def one(p, pr, aP, aE, n):
        red = JS.chain_metrics(jnp.asarray(data), p["E"],
                               p["P"] * p["A"][None, :])
        return jgibbs._metrics_row(jspec, jnp.asarray(data), p, pr, None,
                                   jnp.int32(it), jnp.float32(temp), aP, aE,
                                   n, consts, red)

    return np.asarray(jax.vmap(one)(params, prior, jnp.asarray(acc_P),
                                    jnp.asarray(acc_E), jnp.asarray(na)))


def port_rows(data, params, prior, acc_P, acc_E, na, it, temp, **kw):
    """The port's rows through stream_metrics_row: raw P and A, no P * A."""
    torch.set_num_threads(1)
    d = {**{k: t(np.asarray(v)) for k, v in params.items()},
         **{k: t(np.asarray(v)) for k, v in prior.items()},
         "acc_P": t(acc_P), "acc_E": t(acc_E)}
    consts = tm.metric_constants("poisson", t(data))
    return S.stream_metrics_row(
        t(data), *(d[k] for k in ROW_ARGS), consts["lgamma_sum"],
        consts["mlogm_sum"], t(na), it, temp, **kw)


def close_rows(got, want, data, diffs=("KL",)):
    """rtol 1e-5 for every entry but those named in ``diffs``: differences
    of sums of size sum(M log M) (KL; loglik and what is built on it), held
    to 1e-5 of that, since JAX sums them tile by tile in float32."""
    cols = [tgibbs.METRIC_NAMES.index(k) for k in diffs]
    Mp = np.maximum(data, 1e-6)
    close(np.delete(got, cols, 1), np.delete(want, cols, 1), 1e-5)
    for k, i in zip(diffs, cols):
        close(got[:, i], want[:, i], 0,
              atol=1e-5 * float(np.sum(Mp * np.log(Mp))), msg=k)


def test_stream_metrics_row_matches_jax(ens_setup):
    jspec, tspec, hp, data, js = ens_setup
    params, prior = js["params"], js["prior"]
    rng = np.random.default_rng(3)
    acc_P = rng.uniform(0, 1, (C, K, N)).astype(np.float32)
    acc_E = rng.uniform(0, 1, (C, N, G)).astype(np.float32)
    na = np.array([0.0, 2.0], np.float32)
    want = jax_rows(jspec, data, params, prior, acc_P, acc_E, na, 12, 0.3)
    got = port_rows(data, params, prior, acc_P, acc_E, na, 12, 0.3).numpy()
    close_rows(got, want, data)


def row_case(case, seed=0):
    """A three-chain state at K = 16, N = 3 for the metrics row. "excluded":
    chain 0 without column 1, chain 2 without any column (sum A = 0, the
    acceptance means' clamp_min(1)); "tails": prior means of E and P at
    mu/sd from -1 to -50 and below -50 (log_ndtr's erfcx branch and its
    continued fraction); "ragged": G = 100, a tile cut short."""
    Kr, Nr, Cr = 16, 3, 3
    Gr = 100 if case == "ragged" else 300
    rng = np.random.default_rng(seed)
    f = np.float32
    Pt = rng.dirichlet(np.ones(Kr) * 0.5, Nr).T * 40.0
    Et = rng.gamma(2.0, 2.0, (Nr, Gr))
    data = rng.poisson(Pt @ Et).astype(f)
    A = np.ones((Cr, Nr), f)
    if case == "excluded":
        A[0, 1] = 0.0
        A[2] = 0.0
    params = {"P": (Pt * rng.uniform(0.5, 1.5, (Cr, Kr, Nr))).astype(f),
              "E": (Et * rng.uniform(0.5, 1.5, (Cr, Nr, Gr))).astype(f),
              "A": A}
    prior = {"Sigmasq_p": rng.gamma(2.0, 0.5, (Cr, Kr, Nr)).astype(f),
             "Sigmasq_e": rng.gamma(2.0, 2.0, (Cr, Nr, Gr)).astype(f)}
    if case == "tails":
        # mu/sd uniform in -120..0 for half the entries, in -1..-50 for the
        # rest
        for side, shape in (("p", (Cr, Kr, Nr)), ("e", (Cr, Nr, Gr))):
            z = np.where(rng.uniform(size=shape) < 0.5,
                         -rng.uniform(0, 120, shape),
                         -rng.uniform(1, 50, shape))
            prior[f"Mu_{side}"] = (z * np.sqrt(prior[f"Sigmasq_{side}"])
                                   ).astype(f)
    else:
        prior["Mu_p"] = rng.normal(0.0, 1.0, (Cr, Kr, Nr)).astype(f)
        prior["Mu_e"] = rng.normal(2.0, 2.0, (Cr, Nr, Gr)).astype(f)
    acc_P = rng.uniform(0, 1, (Cr, Kr, Nr)).astype(f)
    acc_E = rng.uniform(0, 1, (Cr, Nr, Gr)).astype(f)
    na = np.array([0.0, 3.0, 1.0], f)
    kw = dict(K=Kr, N=Nr, G=Gr, likelihood="poisson", prior="truncnormal",
              MH=True, learning_rank=True, rank_method="SBFI",
              stream_sweeps=True)
    return JModelSpec(**kw), data, params, prior, acc_P, acc_E, na


@pytest.mark.parametrize("case", ["excluded", "tails", "ragged"])
def test_stream_metrics_row_cases_match_jax(case):
    """The row against the JAX _metrics_row with pois_red from
    chain_metrics: excluded columns and a chain with none, prior means deep
    in the tail, G not a multiple of the 64-wide tile."""
    torch.set_num_threads(1)
    jspec, data, params, prior, acc_P, acc_E, na = row_case(case)
    want = jax_rows(jspec, data, params, prior, acc_P, acc_E, na, 7, 1.0)
    got = port_rows(data, params, prior, acc_P, acc_E, na, 7, 1.0).numpy()
    # at these counts loglik is ~4% of the sums it is the difference of
    close_rows(got, want, data,
               ("KL", "loglikelihood", "logposterior", "BIC"))
    names = tgibbs.METRIC_NAMES
    assert np.isfinite(got).all()
    if case == "excluded":
        assert got[2, names.index("rank")] == 0.0
        assert got[2, names.index("n_params")] == 0.0
        for k in ("P_mean_acceptance_rate", "E_mean_acceptance_rate"):
            assert got[2, names.index(k)] == 0.0


def test_stream_metrics_row_writes_a_strided_slot():
    """With ``out`` a slice of a chunk buffer the rows land in that slot
    (the returned tensor is the slice) and nothing else moves; a tensor
    temperature gives the same row as the number."""
    torch.set_num_threads(1)
    jspec, data, params, prior, acc_P, acc_E, na = row_case("excluded")
    row = port_rows(data, params, prior, acc_P, acc_E, na, 5, 0.25)
    buf = torch.full((3, 4, tgibbs.N_METRICS), -7.0)
    got = port_rows(data, params, prior, acc_P, acc_E, na, 5,
                    torch.tensor(0.25), out=buf[:, 2])
    assert got.data_ptr() == buf[:, 2].data_ptr()
    assert torch.equal(buf[:, 2], row)
    assert (buf[:, [0, 1, 3]] == -7.0).all()
    assert S.ROW_LEN == tgibbs.N_METRICS


def test_stream_metrics_row_checks_its_operands():
    """Shapes, dtypes and devices of every operand, the temperature's size
    and the output slot."""
    torch.set_num_threads(1)
    jspec, data, params, prior, acc_P, acc_E, na = row_case("ragged")
    base = dict(data=data, params=params, prior=prior, acc_P=acc_P,
                acc_E=acc_E, na=na, it=3, temp=1.0)
    with pytest.raises(ValueError):  # acc_E cut short
        port_rows(**{**base, "acc_E": acc_E[:, :, :-1]})
    with pytest.raises(TypeError):   # a float64 prior operand
        port_rows(**{**base, "prior": {**prior, "Mu_e": prior["Mu_e"]
                                       .astype(np.float64)}})
    with pytest.raises(ValueError):  # A without its chain axis
        port_rows(**{**base, "params": {**params, "A": params["A"][0]}})
    with pytest.raises(ValueError):  # na_events of the wrong length
        port_rows(**{**base, "na": na[:2]})
    with pytest.raises(ValueError):
        port_rows(**{**base, "temp": torch.ones(2)})
    with pytest.raises(ValueError):  # an output slot with strided columns
        port_rows(**base, out=torch.empty(12, 3).t())
    with pytest.raises(ValueError):  # on another device
        port_rows(**base, out=torch.empty(3, 12, device="meta"))


def test_stream_metrics_row_never_takes_the_plain_path_on_cuda(monkeypatch):
    """For CUDA tensors the row enqueues its kernels or raises; the plain
    version is not reached and a CPU call counts no launch. Checked with a
    stand-in launcher."""
    torch.set_num_threads(1)
    jspec, data, params, prior, acc_P, acc_E, na = row_case("excluded")
    S.reset_launch_counts()
    port_rows(data, params, prior, acc_P, acc_E, na, 3, 1.0)
    assert S.stream_metrics_row.launches == 0

    def fake_launch(*a):
        raise RuntimeError("stand-in kernel")

    def no_plain(*a, **k):
        raise AssertionError("plain version reached for CUDA tensors")

    monkeypatch.setattr(S, "_launch_metrics_row", fake_launch)
    monkeypatch.setattr(S, "stream_metrics_row_reference", no_plain)
    monkeypatch.setattr(S, "_check", lambda *a: None)
    fake_cuda = torch.device("cuda", 0)
    monkeypatch.setattr(torch.Tensor, "device", property(
        lambda self: fake_cuda))
    with pytest.raises(RuntimeError, match="stand-in kernel"):
        port_rows(data, params, prior, acc_P, acc_E, na, 3, 1.0)


def test_stream_step_makes_one_metrics_row_call(ens_setup, monkeypatch):
    """stream_step computes the metrics row by one call of
    stream_metrics_row on the state itself (P and A as they are, no P * A)
    and never calls chain_metrics."""
    torch.set_num_threads(1)
    jspec, tspec, hp, data, js = ens_setup
    state = {"params": port_tree(js["params"]),
             "prior": port_tree(js["prior"]),
             "acc_P": t(np.asarray(js["acc_P"])),
             "acc_E": t(np.asarray(js["acc_E"])), "iter": 4,
             "gen": ChainStreams(0, np.arange(js["params"]["P"].shape[0]))}
    calls = []
    row = S.stream_metrics_row

    def spy(*a, **k):
        calls.append(a)
        return row(*a, **k)

    def no_sums(*a, **k):
        raise AssertionError("chain_metrics called on the stream path")

    monkeypatch.setattr(S, "stream_metrics_row", spy)
    monkeypatch.setattr(S, "chain_metrics", no_sums)
    buf = torch.empty(C, 3, tgibbs.N_METRICS)
    new, out = tgibbs.stream_step(tspec, t(data), hp, state, 0.5,
                                  torch.tensor([False, True]),
                                  metrics_out=buf[:, 1])
    assert len(calls) == 1
    P, E, A = calls[0][1:4]
    assert P is new["params"]["P"] and A is new["params"]["A"]
    assert E is new["params"]["E"]
    assert out["metrics"].data_ptr() == buf[:, 1].data_ptr()
    assert (out["metrics"][:, 0] == 5.0).all()
    assert torch.isfinite(buf[:, 1]).all()


def test_stream_step_matches_jax_gibbs_step(ens_setup):
    """Two whole SBFI iterations of one chain: the port's stream_step fed
    the draws of the JAX gibbs_step's keys (gibbs.py:121-132)."""
    jspec, tspec, hp, data, js = ens_setup
    jstate = jax.tree.map(lambda x: x[0], js)
    tstate = {"params": {k: t(np.asarray(v))[None]
                         for k, v in jstate["params"].items()},
              "prior": {k: t(np.asarray(v))[None]
                        for k, v in jstate["prior"].items()},
              "acc_P": t(np.asarray(jstate["acc_P"]))[None],
              "acc_E": t(np.asarray(jstate["acc_E"]))[None],
              "iter": int(jstate["iter"]), "gen": None}
    n2 = TU.n_hyper_noise(tspec)
    for step, (temp, acc_all) in enumerate(((0.25, True), (1.0, False))):
        k_pp, k_P, k_E, _, k_R, k_A = jax.random.split(jstate["key"], 6)
        kz, ku = jax.random.split(k_pp, 2)
        pu_P, ku_P = p_noise(k_P, K, N)
        pu_E, ku_E = p_noise(k_E, N, G)
        noise = {
            "prior": {"z": jax.random.normal(kz, (n2,), jnp.float32),
                      "u": jax.random.uniform(ku, (n2,), jnp.float32,
                                              minval=_U_MIN)},
            "P": {"prior_u": pu_P, "u": jax.random.uniform(
                ku_P, (3, N, K), jnp.float32, minval=_U_MIN)},
            "E": {"prior_u": pu_E, "u": jax.random.uniform(
                ku_E, (3, N, G), jnp.float32, minval=_U_MIN)},
            "R": jax.random.gumbel(k_R, (N + 1,)),
            "A": jnp.stack([jax.random.uniform(k, ())
                            for k in jax.random.split(k_A, N)]),
        }
        noise = jax.tree.map(lambda x: t(np.asarray(x))[None], noise)
        jstate, jout = jgibbs.gibbs_step(jspec, jnp.asarray(data), hp,
                                         jstate, jnp.float32(temp), acc_all)
        tstate, tout = tgibbs.gibbs_step(
            tspec, t(data), hp, tstate, temp, torch.tensor([acc_all]),
            noise=noise)
        for k in ("P", "E", "A"):
            close(tout[k][0].numpy(), np.asarray(jout[k]), 1e-5, 1e-6,
                  msg=f"{k} step {step}")
        assert int(tstate["params"]["R"][0]) == int(jstate["params"]["R"])
        for k in ("Mu_p", "Sigmasq_p", "Mu_e", "Sigmasq_e"):
            close(tstate["prior"][k][0].numpy(),
                  np.asarray(jstate["prior"][k]), 1e-5, 1e-6, msg=k)
        kl = tgibbs.METRIC_NAMES.index("KL")
        close(np.delete(tout["metrics"][0].numpy(), kl),
              np.delete(np.asarray(jout["metrics"]), kl), 1e-5,
              msg=f"metrics step {step}")


def test_truncnorm_logpdf_delta_matches_jax():
    rng = np.random.default_rng(8)
    x1, x0 = rng.gamma(2.0, 1.0, (2, 50)).astype(np.float32)
    mu = rng.normal(0, 1, 50).astype(np.float32)
    sq = rng.gamma(2.0, 1.0, 50).astype(np.float32)
    close(tm.truncnorm_logpdf_delta(t(x1), t(x0), t(mu), t(sq)).numpy(),
          np.asarray(jm.truncnorm_logpdf_delta(x1, x0, mu, sq)), 1e-6)


# ---------------------------------------------------------------------------
# the ensemble's convergence tracker
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vector_convergence_tracker_matches_jax(seed):
    kw = dict(MAP_over=20, MAP_every=10, miniters=30, maxiters=160,
              Ninarow_nochange=2, Ninarow_nobest=3, tol=1e-3)
    n_chains = 6
    a = tconv.VectorConvergenceTracker(ConvergenceControl(**kw), n_chains)
    b = jconv.VectorConvergenceTracker(JConvergenceControl(**kw), n_chains)
    rng = np.random.default_rng(seed)
    level = rng.uniform(100, 200, n_chains)
    for i in range(16):
        level = level * rng.choice([1.0, 0.9995, 0.97], n_chains)
        vals = level + rng.normal(0, 1e-3, n_chains)
        vals[rng.uniform(size=n_chains) < 0.1] = np.nan
        it = 10 * (i + 1)
        temps_one = i >= 2
        np.testing.assert_array_equal(a.update(vals, it, temps_one),
                                      b.update(vals, it, temps_one))
        for k, v in b.to_dict().items():
            np.testing.assert_array_equal(a.to_dict()[k], v, err_msg=k)
        assert [a.why(c) for c in range(n_chains)] == \
            [b.why(c) for c in range(n_chains)]
    assert a.converged.all()
    c = tconv.VectorConvergenceTracker(ConvergenceControl(**kw), n_chains)
    c.restore(a.to_dict())
    for k, v in a.to_dict().items():
        np.testing.assert_array_equal(c.to_dict()[k], v)


# ---------------------------------------------------------------------------
# the column-update entry points: on CPU tensors the plain host sequence
# ---------------------------------------------------------------------------


def update_setup(G_u, seed):
    """A two-chain stream state at K = 16, N = 3 with an excluded column on
    chain 0 and data rows and columns scaled towards 0, which puts part of
    the conditionals deep in the truncated tail (alpha = -mu/sd beyond 5.4
    and beyond 8, where the draw switches its form)."""
    from bayesnmf_tpu.parallel import chains as JCH

    K_u, N_u = 16, 3
    rng = np.random.default_rng(seed)
    P = rng.dirichlet(np.ones(K_u) * 0.5, 2).T * 40
    E = rng.gamma(2.0, 2.0, (2, G_u))
    data = rng.poisson(P @ E).astype(np.float32)
    data *= rng.choice([0.0, 0.3, 1.0], (K_u, 1)).astype(np.float32)
    data *= rng.choice([0.0, 0.3, 1.0], (1, G_u)).astype(np.float32)
    kw = dict(K=K_u, N=N_u, G=G_u, likelihood="poisson",
              prior="truncnormal", MH=True, learning_rank=True,
              rank_method="SBFI", stream_sweeps=True)
    jspec, tspec = JModelSpec(**kw), ModelSpec(**kw)
    hp = default_hyperprior_params(jspec, float(data.mean()))
    js = JCH.init_chain_states(jspec, hp, jnp.asarray(data),
                               jax.random.PRNGKey(seed), C)
    js["params"]["A"] = js["params"]["A"].at[0, 1].set(0.0)
    js["params"]["A"] = js["params"]["A"].at[1].set(1.0)
    return jspec, tspec, data, js


def deep_tail_counts(tspec, data, params, prior, col):
    """Entries of column 0's conditional with 5.4 < alpha <= 8 and with
    alpha > 8."""
    P, E, A = (t(np.asarray(params[k])) for k in "PEA")
    PA = P * A.unsqueeze(1)
    A_n = A[:, 0:1]
    P_n, E_n = P[:, :, 0].contiguous(), E[:, 0, :].contiguous()
    if col:
        mu1, den = S.run_reference(t(data), E, PA, E_n, A_n * P_n, None,
                                   True)
        Mu, Sq = prior["Mu_p"][:, :, 0], prior["Sigmasq_p"][:, :, 0]
    else:
        mu1, den = S.run_reference(t(data), E, PA, A_n * E_n, P_n, None,
                                   False)
        Mu, Sq = prior["Mu_e"][:, 0, :], prior["Sigmasq_e"][:, 0, :]
    mu, var = S._conditional(mu1, A_n * den, t(np.asarray(Mu)),
                             t(np.asarray(Sq)))
    alpha = (-mu / torch.sqrt(var)).numpy()
    return int(((alpha > 5.4) & (alpha <= 8)).sum()), int((alpha > 8).sum())


def acol_operands(tspec, R):
    """stream_sweep_A's prior log-odds for the ranks R and its penalty."""
    p1 = TU.prior_prob_1(t(np.asarray(R)).to(torch.float32), tspec.N)
    logit = torch.log(p1) - torch.log1p(-p1)
    pen = TU.sbfi_penalty(tspec) if tspec.rank_method == "SBFI" else None
    return logit, pen


def a_uniforms(keys, N_u):
    """stream_sweep_A's Bernoulli uniforms: column n's from split(key, N)[n]
    (updates.py:846, :866), (C, N)."""
    return t(np.stack([[np.asarray(jax.random.uniform(kn, ()))
                        for kn in jax.random.split(k, N_u)] for k in keys]))


def check_acol_entry_point(G_u, rtol):
    """stream_acol_update on CPU tensors, column by column, against the JAX
    stream_sweep_A on the same uniforms (SBFI and BFI): each column's delta
    against the JAX acol_delta at the same state, and the final A and NaN
    counts against the JAX sweep's."""
    jspec0, tspec0, data, js = update_setup(G_u, seed=G_u + 2)
    params = js["params"]
    N_u = tspec0.N
    R = np.array([1, 2], np.int32)
    temp = 0.01
    keys = jax.random.split(jax.random.PRNGKey(13), C)
    u = a_uniforms(keys, N_u)
    tp = port_tree(params)
    for method in ("SBFI", "BFI"):
        jspec = JModelSpec(**{**jspec0.__dict__, "rank_method": method})
        tspec = ModelSpec(**{**tspec0.__dict__, "rank_method": method})
        want = jax.vmap(lambda p, r, k: JU.stream_sweep_A(
            jspec, jnp.asarray(data), p, r, jnp.float32(temp), k))(
                params, jnp.asarray(R), keys)
        logit, pen = acol_operands(tspec, R)
        A = tp["A"].clone()
        n_nan = torch.zeros(C)
        for n in range(N_u):
            A_before = A.numpy().copy()
            delta = S.stream_acol_update(t(data), tp["E"], tp["P"], A, logit,
                                         temp, u, n_nan, pen, n, n + 1)
            P, E = np.asarray(params["P"]), np.asarray(params["E"])
            jd = np.asarray(jax.vmap(lambda E_, PA, en, pn, an: JS.acol_delta(
                jnp.asarray(data), E_, PA, en, pn, an))(
                    E, P * A_before[:, None, :], E[:, n], P[:, :, n],
                    A_before[:, n]))
            close(delta[:, n].numpy(), jd, rtol,
                  atol=rtol * float(np.abs(jd).max()),
                  msg=f"{method} delta column {n}")
        np.testing.assert_array_equal(A.numpy(), np.asarray(want[0]),
                                      err_msg=method)
        np.testing.assert_array_equal(n_nan.numpy(), np.asarray(want[1]))
        assert not np.array_equal(A.numpy(), np.asarray(params["A"]))
        # stream_sweep_A of models/updates.py is the same call
        got = TU.stream_sweep_A(tspec, t(data), tp, t(R), temp, u=u)
        assert torch.equal(got[0], A) and torch.equal(got[1], n_nan)


@pytest.mark.parametrize("G_u,rtol", [(300, 1e-5), (25000, 1e-4)])
@pytest.mark.parametrize("side", ["P", "E", "A"])
def test_column_update_entry_points_match_jax(side, G_u, rtol):
    """stream_pcol_update / stream_erow_update / stream_acol_update on CPU
    tensors run the plain host sequence: the JAX stream_sweep_P/E/A fed the
    same draws; for P and E with an excluded column, per-chain warmup flags
    and deep-tail conditionals."""
    if side == "A":
        check_acol_entry_point(G_u, rtol)
        return
    jspec, tspec, data, js = update_setup(G_u, seed=G_u + (side == "E"))
    params, prior = js["params"], js["prior"]
    K_u, N_u = tspec.K, tspec.N
    col = side == "P"
    lo, hi = deep_tail_counts(tspec, data, params, prior, col)
    assert lo + hi > 0, "the case has no deep-tail conditional"
    shape = (C, K_u, N_u) if col else (C, N_u, G_u)
    acc = jnp.full(shape, 0.5, jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(11), C)
    flags = jnp.asarray([True, False])
    jfn = JU.stream_sweep_P if col else JU.stream_sweep_E
    want = jax.vmap(lambda p, pr, a, k, f: jfn(
        jspec, jnp.asarray(data), p, pr, a, k, f))(params, prior, acc, keys,
                                                   flags)
    rows, cols = (K_u, N_u) if col else (N_u, G_u)

    def noise(k):
        prior_u, k_u = p_noise(k, rows, cols)
        return {"prior_u": prior_u,
                "u": jax.random.uniform(k_u, (3, N_u, K_u if col else G_u),
                                        jnp.float32, minval=_U_MIN)}

    nz = stack_noise(keys, noise)
    tp, tpr = port_tree(params), port_tree(prior)
    X = tp[side].clone()
    acc_t = t(np.asarray(acc)).clone()
    n_nan = torch.zeros(C)
    if col:
        prior_draw = TU._prior_draw_P(tspec, tpr, None, nz["prior_u"])
        S.stream_pcol_update(t(data), tp["E"], X, tp["A"], acc_t, tpr["Mu_p"],
                             tpr["Sigmasq_p"], prior_draw, nz["u"],
                             torch.tensor([True, False]), n_nan)
    else:
        prior_draw = TU._prior_draw_E(tspec, tpr, None, nz["prior_u"])
        S.stream_erow_update(t(data), X, tp["P"], tp["A"], acc_t, tpr["Mu_e"],
                             tpr["Sigmasq_e"], prior_draw, nz["u"],
                             torch.tensor([True, False]), n_nan)
    X0, Xw = np.asarray(params[side]), np.asarray(want[0])
    np.testing.assert_array_equal(X.numpy() != X0, Xw != X0)
    close(X.numpy(), Xw, rtol, 1e-6, msg=side)
    # the recorded ratio exp(log_ratio): with data scaled towards 0 the
    # terms of the log ratio reach ~1e2 at G = 300 and ~1e3 at G = 25000,
    # so its float32 rounding alone (JAX sums the parts in float32 tile by
    # tile, the port in float64) is a few times the values' tolerance; a
    # ratio below the smallest normal float32 is 0 in XLA and a denormal
    # in PyTorch
    close(acc_t.numpy(), np.asarray(want[1]), 10 * rtol, 1e-37,
          msg=f"acc_{side}")
    np.testing.assert_array_equal(n_nan.numpy(), np.asarray(want[2]))
    # the excluded column took its prior draw and kept its record
    ex = (0, slice(None), 1) if col else (0, 1, slice(None))
    np.testing.assert_array_equal(X[ex].numpy(), prior_draw[ex].numpy())
    assert (acc_t[ex] == 0.5).all()
    # the sweeps of models/updates.py are the same calls
    sweep = TU.stream_sweep_P if col else TU.stream_sweep_E
    got = sweep(tspec, t(data), tp, tpr, t(np.asarray(acc)),
                torch.tensor([True, False]), noise=nz)
    assert torch.equal(got[0], X) and torch.equal(got[1], acc_t)
    assert torch.equal(got[2], n_nan)


def check_acol_ranges_compose(tspec, data, tp):
    rng = np.random.default_rng(5)
    N_u = tspec.N
    u = t(rng.uniform(1e-6, 1.0, (C, N_u)).astype(np.float32))
    logit = t(rng.normal(0.0, 1.0, C).astype(np.float32))

    def run(ranges):
        A = tp["A"].clone()
        nn = torch.zeros(C)
        deltas = []
        for n0, n1 in ranges:
            d = S.stream_acol_update(t(data), tp["E"], tp["P"], A, logit, 0.05,
                                     u, nn, 3.0, n0, n1)
            deltas.append(d[:, n0:n1])
        return A, nn, torch.cat(deltas, 1)

    S.reset_launch_counts()
    one = run([(0, None)])
    two = run([(0, 1), (1, N_u)])
    assert S.stream_acol_update.launches == 0
    for a, b in zip(one, two):
        assert torch.equal(a, b)
    assert not torch.equal(one[0], tp["A"])
    with pytest.raises(ValueError):
        run([(2, 1)])
    with pytest.raises(ValueError):   # a temperature per chain
        S.stream_acol_update(t(data), tp["E"], tp["P"], tp["A"].clone(),
                             logit, torch.ones(C), u, torch.zeros(C))
    with pytest.raises(TypeError):    # integer NaN counts
        S.stream_acol_update(t(data), tp["E"], tp["P"], tp["A"].clone(),
                             logit, 1.0, u, torch.zeros(C, dtype=torch.int32))


@pytest.mark.parametrize("side", ["P", "E", "A"])
def test_column_update_ranges_compose(side):
    """Columns 0..n and n..N in two calls equal one call, in place; a CPU
    call counts no launch."""
    jspec, tspec, data, js = update_setup(60, seed=3)
    tp, tpr = port_tree(js["params"]), port_tree(js["prior"])
    if side == "A":
        check_acol_ranges_compose(tspec, data, tp)
        return
    col = side == "P"
    K_u, N_u, G_u = tspec.K, tspec.N, tspec.G
    rng = np.random.default_rng(5)
    L = K_u if col else G_u
    U = t(rng.uniform(1e-6, 1.0, (C, 3, N_u, L)).astype(np.float32))
    shape = (C, K_u, N_u) if col else (C, N_u, G_u)
    prior_draw = t(rng.gamma(2.0, 1.0, shape).astype(np.float32))
    flags = torch.tensor([False, True])
    fn = S.stream_pcol_update if col else S.stream_erow_update
    mu, sq = ((tpr["Mu_p"], tpr["Sigmasq_p"]) if col
              else (tpr["Mu_e"], tpr["Sigmasq_e"]))

    def run(ranges):
        st = {"P": tp["P"].clone(), "E": tp["E"].clone()}
        acc = torch.full(shape, 0.5)
        nn = torch.zeros(C)
        for n0, n1 in ranges:
            fn(t(data), st["E"], st["P"], tp["A"], acc, mu, sq, prior_draw,
               U, flags, nn, n0, n1)
        return st[side], acc, nn

    S.reset_launch_counts()
    one = run([(0, None)])
    two = run([(0, 1), (1, N_u)])
    assert S._run.launches == 0
    for a, b in zip(one, two):
        assert torch.equal(a, b)
    assert not torch.equal(one[0], tp[side])
    with pytest.raises(ValueError):
        run([(2, 1)])
    with pytest.raises(ValueError):
        fn(t(data), tp["E"], tp["P"], tp["A"], torch.full(shape, 0.5), mu,
           sq, prior_draw, U, flags.float(), torch.zeros(C))


@pytest.mark.parametrize("side", ["P", "E", "A"])
def test_column_updates_never_take_the_plain_path_on_cuda(side, monkeypatch):
    """For CUDA tensors a column update enqueues its kernels or raises; the
    host sequence is not reached. Checked with a stand-in launcher."""
    jspec, tspec, data, js = update_setup(40, seed=6)
    tp, tpr = port_tree(js["params"]), port_tree(js["prior"])
    if side == "A":
        args = (t(data), tp["E"], tp["P"], tp["A"].clone(), torch.zeros(C),
                0.5, torch.full((C, tspec.N), 0.5), torch.zeros(C))
    else:
        col = side == "P"
        shape = tuple(tp[side].shape)
        L = tspec.K if col else tspec.G
        args = (t(data), tp["E"], tp["P"], tp["A"], torch.full(shape, 0.5),
                tpr[f"Mu_{side.lower()}"], tpr[f"Sigmasq_{side.lower()}"],
                torch.ones(shape), torch.full((C, 3, tspec.N, L), 0.5),
                torch.tensor([False, True]), torch.zeros(C))

    def fake_launch(*a):
        raise RuntimeError("stand-in kernel")

    def no_plain(*a, **k):
        raise AssertionError("plain version reached for CUDA tensors")

    monkeypatch.setattr(S, "_launch_update", fake_launch)
    monkeypatch.setattr(S, "_launch_acol_update", fake_launch)
    monkeypatch.setattr(S, "pcol_update_reference", no_plain)
    monkeypatch.setattr(S, "erow_update_reference", no_plain)
    monkeypatch.setattr(S, "acol_update_reference", no_plain)
    monkeypatch.setattr(S, "_check", lambda *a: None)
    fake_cuda = torch.device("cuda", 0)
    monkeypatch.setattr(torch.Tensor, "device", property(
        lambda self: fake_cuda))
    fn = {"P": S.stream_pcol_update, "E": S.stream_erow_update,
          "A": S.stream_acol_update}[side]
    with pytest.raises(RuntimeError, match="stand-in kernel"):
        fn(*args)


def test_acol_update_nan_delta_takes_one_half():
    """A chain whose P holds an inf has a NaN delta in every column: each
    inclusion is drawn at p = 1/2 and counted, as the JAX stream_sweep_A
    does; the other chain is untouched by it."""
    jspec, tspec, data, js = update_setup(60, seed=3)
    params = dict(js["params"])
    params["P"] = params["P"].at[1, 0, 1].set(jnp.inf)
    N_u = tspec.N
    R = np.array([2, 1], np.int32)
    keys = jax.random.split(jax.random.PRNGKey(17), C)
    want = jax.vmap(lambda p, r, k: JU.stream_sweep_A(
        jspec, jnp.asarray(data), p, r, jnp.float32(1.0), k))(
            params, jnp.asarray(R), keys)
    u = a_uniforms(keys, N_u)
    tp = port_tree(params)
    logit, pen = acol_operands(tspec, R)
    A = tp["A"].clone()
    n_nan = torch.zeros(C)
    delta = S.stream_acol_update(t(data), tp["E"], tp["P"], A, logit, 1.0,
                                 u, n_nan, pen)
    assert torch.isnan(delta[1]).all() and torch.isfinite(delta[0]).all()
    assert n_nan.tolist() == [0.0, float(N_u)]
    assert torch.equal(A[1], (u[1] < 0.5).to(torch.float32))
    np.testing.assert_array_equal(A.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(n_nan.numpy(), np.asarray(want[1]))


def test_column_kernel_limits():
    """The register tile's width by N, shapes the kernels refuse, and their
    scratch sizes."""
    assert [S.tile_width(n) for n in (1, 4, 5, 20, 24, 25, 32, 33, 64, 65,
                                      128)] == \
        [4, 4, 8, 20, 24, 32, 32, 64, 64, 128, 128]
    with pytest.raises(ValueError):
        S.tile_width(129)
    with pytest.raises(ValueError):
        S._col_scratch(2, 5000, 20, 100, torch.device("cpu"))
    with pytest.raises(ValueError):
        S.erow_rows(5000, 20)
    assert S._col_scratch(2, 96, 20, 130, torch.device("cpu")).numel() == \
        2 * 3 * 96 * 3
    with pytest.raises(ValueError):
        S._acol_scratch(2, 5000, 20, 100, torch.device("cpu"))
    # one partial per (chain, tile)
    assert S._acol_scratch(2, 96, 20, 130, torch.device("cpu")).numel() == \
        2 * 3
