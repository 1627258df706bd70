"""The port's eager sweep path and Normal likelihood against the JAX package.

Each function of the eager path (``fused_sweeps=False``, and every Normal
fit) is fed the numpy inputs and the random numbers that its JAX
counterpart draws from its key, and compared with that function: the
Normal log-likelihood and the metrics constants, sigmasq's draw, the A
sweep's Normal branch, the reference's conjugate Mu/Sigmasq update, and the
sequential P and E sweeps in each branch (the Normal conjugate draw with
either prior, Poisson MH with the exact and with the reference Hastings
ratio), with an excluded column, an all-zero row of the other factor and
the warmup flag both ways. Then ten steps of each new path against
``jax.jit(gibbs.gibbs_step)``, as in tests/test_torch_gibbs.py, whose
docstrings give the tolerances: float32 sums taken in another order drift
apart by ~1e-6 relative a step, so values are held to rtol 1e-3 (atol 1e-4
for values near 0), decisions (A, R, accept/reject) to be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesnmf_tpu.config import ModelSpec as JModelSpec
from bayesnmf_tpu.config import default_hyperprior_params
from bayesnmf_tpu.models import gibbs as jgibbs
from bayesnmf_tpu.models import updates as jU
from bayesnmf_tpu.ops import math as jm
from bayesnmf_tpu_torch.config import ModelSpec
from bayesnmf_tpu_torch.models import gibbs as tgibbs
from bayesnmf_tpu_torch.models import updates as tU
from bayesnmf_tpu_torch.models.state import state_from_numpy, state_to_numpy
from bayesnmf_tpu_torch.ops import math as tm
from test_torch_fused_sweeps import jax_erfc_tail

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def erfc_tail():
    """The JAX fused kernel (the fused_conjugate_hypers case) with the
    port's erfc tail mass in its proposal
    (tests/test_torch_fused_sweeps.py::jax_erfc_tail)."""
    with jax_erfc_tail():
        yield

K, N, G = 16, 3, 24
RTOL, ATOL = 1e-3, 1e-4
KL = tgibbs.METRIC_NAMES.index("KL")
_JTINY = jnp.float32(1.1754944e-38)   # distributions._TINY

# compiled once per spec for the whole module
_jit = lambda f: jax.jit(f, static_argnames=("spec",))  # noqa: E731
J_SWEEP = {"P": _jit(jU.sweep_P), "E": _jit(jU.sweep_E)}
J_PRIOR_INIT = _jit(jU.init_prior_params)
J_PRIOR_UPDATE = _jit(jU.sample_prior_params)
J_SIGMASQ = _jit(jU.sample_sigmasq)


def sim_data(seed=0):
    rng = np.random.default_rng(seed)
    Pt = rng.dirichlet(np.ones(K) * 0.5, N).T * 50.0
    Et = rng.gamma(2.0, 2.0, (N, G))
    return rng.poisson(Pt @ Et).astype(np.float32)


def specs(**kw):
    kw = dict(K=K, N=N, G=G) | kw
    return JModelSpec(**kw), ModelSpec(**kw)


def T(x):
    """numpy (or nested dicts of it) -> CPU tensors."""
    if isinstance(x, dict):
        return {k: T(v) for k, v in x.items()}
    return torch.from_numpy(np.array(x))


def close(got, want, msg, rtol=RTOL, atol=ATOL):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


# ---------------------------------------------------------------------------
# the JAX functions' draws, from their keys
# ---------------------------------------------------------------------------


def _uniform(key, shape, minval=1.2e-38):
    return np.array(jax.random.uniform(key, shape, jnp.float32,
                                       minval=jnp.float32(minval)))


def _gamma_planes(key, shape):
    return _uniform(key, (9,) + shape, _JTINY)


def jax_prior_noise(jspec, key):
    """sample_prior_params' draws (updates.py:91-203)."""
    kn, ng = (jspec.K, jspec.N), (jspec.N, jspec.G)
    if jspec.prior == "exponential":
        ks = jax.random.split(key, 4)
        return {"p": _gamma_planes(ks[0], kn), "e": _gamma_planes(ks[1], ng)}
    if jspec.exact_truncnorm_hypers:
        n = 2 * (jspec.K * jspec.N + jspec.N * jspec.G)
        kz, ku = jax.random.split(key, 2)
        return {"z": np.array(jax.random.normal(kz, (n,))),
                "u": _uniform(ku, (n,))}
    ks = jax.random.split(key, 4)
    return {"mu_p": np.array(jax.random.normal(ks[0], kn)),
            "mu_e": np.array(jax.random.normal(ks[1], ng)),
            "sq_p": _gamma_planes(ks[2], kn), "sq_e": _gamma_planes(ks[3], ng)}


def jax_sweep_noise(jspec, side, key):
    """sweep_P's / sweep_E's draws: the prior fallback from the first key of
    split(key), one (3, N, K) or (3, N, G) uniform block from the second
    (updates.py:278-287, :424-430)."""
    k_prior, k_u = jax.random.split(key)
    shape = (jspec.K, jspec.N) if side == "P" else (jspec.N, jspec.G)
    if jspec.prior == "truncnormal":
        prior_u = _uniform(k_prior, (2,) + shape, _JTINY)
    else:  # jax.random.exponential's uniforms
        prior_u = np.array(jax.random.uniform(k_prior, shape))
    L = jspec.K if side == "P" else jspec.G
    return {"prior_u": prior_u, "u": _uniform(k_u, (3, jspec.N, L))}


def jax_step_noise(jspec, key):
    """(the fused step's flat uniforms or None, the noise dict of the other
    draws) as jgibbs.gibbs_step draws them from ``key`` (gibbs.py:118-132)."""
    n_extra = (2 * jspec.learning_rank + jspec.needs_Z
               + jspec.needs_sigmasq)
    ks = jax.random.split(key, 4 + n_extra)
    noise = {}
    if not (jspec.fused_sweeps and jspec.prior == "truncnormal"
            and jspec.exact_truncnorm_hypers):
        noise["prior"] = jax_prior_noise(jspec, ks[0])
    if jspec.fused_sweeps:
        return _uniform(ks[1], (tgibbs.n_uniforms(jspec),)), noise
    noise["P"] = jax_sweep_noise(jspec, "P", ks[1])
    noise["E"] = jax_sweep_noise(jspec, "E", ks[2])
    i = 4
    if jspec.learning_rank:
        noise["R"] = np.array(jax.random.gumbel(ks[4], (jspec.N + 1,)))
        noise["A"] = np.array([jax.random.uniform(k, ()) for k in
                               jax.random.split(ks[5], jspec.N)])
        i = 6
    if jspec.needs_sigmasq:
        noise["sigmasq"] = _gamma_planes(ks[i], (jspec.G,))
    return None, noise


# ---------------------------------------------------------------------------
# the Normal likelihood's math
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mats():
    rng = np.random.default_rng(5)
    data = sim_data(1)
    Mh = (data + rng.normal(0.0, 3.0, data.shape)).astype(np.float32)
    sq_g = rng.gamma(2.0, 5.0, G).astype(np.float32)
    sq_kg = rng.gamma(2.0, 5.0, (K, G)).astype(np.float32)
    return data, Mh, sq_g, sq_kg


@pytest.mark.parametrize("case", ["normal_g", "normal_kg", "dispatch_normal",
                                  "dispatch_poisson"])
def test_loglik_mats_match_jax(mats, case):
    data, Mh, sq_g, sq_kg = mats
    if case == "normal_g":
        got = tm.normal_loglik_mat(T(data), T(Mh), T(sq_g))
        want = jm.normal_loglik_mat(jnp.asarray(data), jnp.asarray(Mh),
                                    jnp.asarray(sq_g))
    elif case == "normal_kg":
        got = tm.normal_loglik_mat(T(data), T(Mh), T(sq_kg))
        want = jm.normal_loglik_mat(jnp.asarray(data), jnp.asarray(Mh),
                                    jnp.asarray(sq_kg))
    else:
        lik = case.split("_")[1]
        sq = sq_g if lik == "normal" else None
        got = tm.loglik_mat(T(data), T(Mh), lik,
                            None if sq is None else T(sq))
        want = jm.loglik_mat(jnp.asarray(data), jnp.asarray(Mh), lik,
                             None if sq is None else jnp.asarray(sq))
    assert got.shape == (K, G)
    # the Poisson terms M log(lam), lam and lgamma(M + 1) reach ~1e3 and
    # cancel: each rounds to ~6e-8 of its size, in another order in XLA
    lam = np.maximum(Mh, 1e-6)
    scale = np.max(np.abs(data * np.log(lam)) + lam + data * np.log(data + 1))
    close(got, want, case, rtol=1e-6, atol=1e-6 * scale)


@pytest.mark.parametrize("likelihood", ["poisson", "normal"])
def test_metric_constants_match_jax(mats, likelihood):
    data = mats[0]
    got = tm.metric_constants(likelihood, T(data))
    want = jm.metric_constants(likelihood, jnp.asarray(data))
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k], k, rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# single updates
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def normal_state():
    """A Normal-TruncNormal JAX init state with column 1 excluded, E row 2
    and P column 2 all zero (the prior-fallback cases)."""
    data = sim_data(2)
    jspec, _ = specs(likelihood="normal", prior="truncnormal", MH=False)
    hp = default_hyperprior_params(jspec, float(data.mean()))
    st = jax.tree.map(np.asarray, jgibbs.init_state(
        jspec, hp, jnp.asarray(data), jax.random.PRNGKey(11)))
    params = dict(st["params"])
    params["A"] = np.array([1.0, 0.0, 1.0], np.float32)
    params["P"] = params["P"].copy()
    params["E"] = params["E"].copy()
    params["P"][:, 2] = 0.0
    params["E"][2] = 0.0
    return data, hp, params, st["prior"]


def test_sample_sigmasq_matches_jax(normal_state):
    data, _, params, prior = normal_state
    jspec, spec = specs(likelihood="normal", prior="truncnormal", MH=False)
    Mh = np.asarray(jm.mhat(jnp.asarray(params["P"]),
                            jnp.asarray(np.ones(N, np.float32)),
                            jnp.asarray(params["E"])))
    key = jax.random.PRNGKey(4)
    want = J_SIGMASQ(jspec, jnp.asarray(data), prior, jnp.asarray(Mh), key)
    got = tU.sample_sigmasq(spec, T(data), T(prior), T(Mh),
                            u=T(_gamma_planes(key, (G,))))
    assert got.shape == (G,)
    close(got, want, "sigmasq", rtol=1e-5, atol=0)


@pytest.mark.parametrize("rank_method", ["SBFI", "BFI"])
def test_sweep_A_normal_matches_jax(normal_state, rank_method):
    data, _, params, _ = normal_state
    jspec, spec = specs(likelihood="normal", prior="truncnormal", MH=False,
                        learning_rank=True, rank_method=rank_method)
    Mh = jm.mhat(jnp.asarray(params["P"]), jnp.asarray(params["A"]),
                 jnp.asarray(params["E"]))
    key = jax.random.PRNGKey(8)
    R = jnp.asarray(2, jnp.int32)
    # a temperature at which the SBFI penalty leaves the odds undecided
    temp = 1e-3 if rank_method == "SBFI" else 0.05
    A, Mh_j, nan_j = jU.sweep_A(jspec, jnp.asarray(data),
                                jax.tree.map(jnp.asarray, params), R, Mh,
                                jnp.float32(temp), key)
    u = np.array([jax.random.uniform(k, ()) for k in
                  jax.random.split(key, N)])
    got_A, got_Mh, got_nan = tU.sweep_A(spec, T(data), T(params),
                                        torch.tensor(2), T(np.asarray(Mh)),
                                        temp, u=T(u))
    np.testing.assert_array_equal(got_A.numpy(), np.asarray(A))
    close(got_Mh, Mh_j, "Mhat")
    assert float(got_nan) == float(nan_j)


@pytest.mark.parametrize("exact", [True, False])
def test_truncnorm_prior_update_matches_jax(normal_state, exact):
    """One chain's Mu/Sigmasq update: the exact Metropolised sweep and the
    reference's conjugate draws (exact_truncnorm_hypers=False)."""
    data, hp, params, prior = normal_state
    jspec, spec = specs(likelihood="normal", prior="truncnormal", MH=False,
                        exact_truncnorm_hypers=exact)
    key = jax.random.PRNGKey(21)
    want = J_PRIOR_UPDATE(jspec, hp, jax.tree.map(jnp.asarray, params),
                          jax.tree.map(jnp.asarray, prior), key)
    got = tU.sample_prior_params(spec, hp, T(params), T(prior),
                                 noise=T(jax_prior_noise(jspec, key)))
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k], k)
    moved = [k for k in ("Mu_p", "Sigmasq_p") if not
             np.array_equal(np.asarray(want[k]), prior[k])]
    assert moved, "the update kept every value"


SWEEP_BRANCHES = {
    "normal_truncnormal": dict(likelihood="normal", prior="truncnormal",
                               MH=False),
    "normal_exponential": dict(likelihood="normal", prior="exponential",
                               MH=False),
    "mh_exact_truncnormal": dict(likelihood="poisson", prior="truncnormal"),
    "mh_exact_exponential": dict(likelihood="poisson", prior="exponential"),
    "mh_reference_truncnormal": dict(likelihood="poisson",
                                     prior="truncnormal", exact_mh=False),
    "mh_reference_exponential": dict(likelihood="poisson",
                                     prior="exponential", exact_mh=False),
}
SWEEP_CASES = [(b, side, aa) for b in sorted(SWEEP_BRANCHES)
               for side in ("P", "E")
               for aa in ((False,) if b.startswith("normal") else
                          (False, True))]


@pytest.mark.parametrize("branch,side,accept_all", SWEEP_CASES)
def test_sweep_matches_jax(normal_state, branch, side, accept_all):
    """One P or E sweep from the same state and draws: column 1 excluded
    (its prior draw), E row 2 and P column 2 all zero (the other side's
    prior fallback); values within rtol 1e-3 / atol 1e-4, the same
    decisions and NaN count."""
    data, _, params, _ = normal_state
    jspec, spec = specs(**SWEEP_BRANCHES[branch])
    hp = default_hyperprior_params(jspec, float(data.mean()))
    prior = jax.tree.map(np.asarray, J_PRIOR_INIT(
        jspec, hp, jax.random.PRNGKey(13)))
    Mh = np.asarray(jm.mhat(jnp.asarray(params["P"]),
                            jnp.asarray(params["A"]),
                            jnp.asarray(params["E"])))
    acc = np.full((K, N) if side == "P" else (N, G), 0.5, np.float32)
    key = jax.random.PRNGKey(17)
    # a traced warmup flag: both values share one compiled sweep
    X, Mh_j, acc_j, nan_j = J_SWEEP[side](
        jspec, jnp.asarray(data), jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, prior), jnp.asarray(Mh),
        jnp.asarray(acc) if jspec.MH else None, key, jnp.asarray(accept_all))
    tfn = {"P": tU.sweep_P, "E": tU.sweep_E}[side]
    got = tfn(spec, T(data), T(params), T(prior), T(Mh),
              T(acc) if spec.MH else None, accept_all,
              noise=T(jax_sweep_noise(jspec, side, key)))
    X_t, Mh_t, acc_t, nan_t = got
    close(X_t, X, side)
    close(Mh_t, Mh_j, "Mhat")
    assert float(nan_t) == float(nan_j)
    old = params[side]
    if spec.MH:
        close(acc_t, acc_j, "acc")
        # the excluded column keeps its record; accepted entries moved
        sel = (lambda a: a[:, 1]) if side == "P" else (lambda a: a[1])
        np.testing.assert_array_equal(sel(acc_t.numpy()), 0.5)
        took_t = X_t.numpy() != old
        np.testing.assert_array_equal(took_t, np.asarray(X) != old)
    else:
        assert acc_t is None
    # every entry of an active column moved (a conditional or prior draw)
    assert (X_t.numpy() != old).any()


# ---------------------------------------------------------------------------
# ten steps of each new path
# ---------------------------------------------------------------------------


STEP_CASES = {
    "normal_truncnormal": dict(likelihood="normal", prior="truncnormal",
                               MH=False),
    "normal_truncnormal_sbfi": dict(likelihood="normal", prior="truncnormal",
                                    MH=False, learning_rank=True,
                                    rank_method="SBFI"),
    "normal_exponential": dict(likelihood="normal", prior="exponential",
                               MH=False),
    "normal_exponential_bfi": dict(likelihood="normal", prior="exponential",
                                   MH=False, learning_rank=True,
                                   rank_method="BFI"),
    "eager_exact": dict(likelihood="poisson", prior="truncnormal"),
    "eager_sbfi": dict(likelihood="poisson", prior="truncnormal",
                       learning_rank=True, rank_method="SBFI"),
    "eager_exponential_reference_ratio": dict(
        likelihood="poisson", prior="exponential", exact_mh=False),
    "fused_conjugate_hypers": dict(likelihood="poisson", prior="truncnormal",
                                   fused_sweeps=True,
                                   exact_truncnorm_hypers=False),
    "eager_conjugate_hypers": dict(likelihood="poisson", prior="truncnormal",
                                   exact_truncnorm_hypers=False),
}
TEMPS = (0.0, 1e-4, 1e-3, 1e-2, 0.1, 0.3, 0.6, 1.0, 1.0, 1.0)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_ten_steps_of_each_new_path_match_jax(case):
    """Ten steps over a rising temperature (warmup then MH on the Poisson
    paths): A and R equal; P, E, sigmasq and the prior parameters within
    rtol 1e-3 / atol 1e-4; the metrics row within rtol 1e-3, KL within
    1e-5 of sum(M log M) (tests/test_torch_gibbs.py). In a step where a
    column leaves, Mhat keeps the float32 residue of Mh - P_n E_n in its
    cells, which both packages round apart and whose log at the 1e-6 floor
    decides the KL, and under the Poisson likelihood RMSE, loglik, logpost
    and BIC too (see that file); there those are held to be finite."""
    data = sim_data(0)
    jspec, spec = specs(**STEP_CASES[case])
    hp = default_hyperprior_params(jspec, float(data.mean()))
    jstate = jgibbs.init_state(jspec, hp, jnp.asarray(data),
                               jax.random.PRNGKey(7))
    jstep = jax.jit(jgibbs.gibbs_step,
                    static_argnames=("spec", "accept_all", "record"))
    tdata = torch.from_numpy(data)
    tstate = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    Mp = np.maximum(data, 1e-6)
    kl_atol = 1e-5 * float(np.sum(Mp * np.log(Mp)))
    mhat_cols = [tgibbs.METRIC_NAMES.index(k) for k in
                 ("RMSE", "KL", "loglikelihood", "logposterior", "BIC")]
    ranks = set()
    for step, temp in enumerate(TEMPS):
        accept_all = jspec.MH and step < 5
        A_before = np.asarray(jstate["params"]["A"])
        u, noise = jax_step_noise(jspec, jstate["key"])
        jstate, jout = jstep(jspec, jnp.asarray(data), hp, jstate,
                             jnp.float32(temp), accept_all)
        tstate, tout = tgibbs.gibbs_step(
            spec, tdata, hp, tstate, temp, accept_all,
            u=None if u is None else T(u), noise=T(noise))
        want = jax.tree.map(np.asarray, jstate)
        got = state_to_numpy(tstate)
        assert sorted(got["params"]) == sorted(want["params"])
        assert sorted(got["prior"]) == sorted(want["prior"])
        for k in ("A", "R"):
            np.testing.assert_array_equal(got["params"][k],
                                          want["params"][k],
                                          err_msg=f"{k} step {step}")
        for k in ("P", "E", "sigmasq"):
            if k in want["params"]:
                close(got["params"][k], want["params"][k], f"{k} step {step}")
        for k, v in want["prior"].items():
            close(got["prior"][k], v, f"{k} step {step}")
        for k in ("acc_P", "acc_E"):
            assert (k in got) == (k in want)
            if k in want:
                close(got[k], want[k], f"{k} step {step}")
        tmr, jmr = tout["metrics"].numpy(), np.asarray(jout["metrics"])
        left = bool(np.any((A_before == 1) & (want["params"]["A"] == 0)))
        if left:
            # the Normal loglik, RMSE and BIC do not take the log of Mhat
            cols = mhat_cols if jspec.likelihood == "poisson" else [KL]
            assert np.isfinite(tmr[cols]).all()
            tmr, jmr = np.delete(tmr, cols), np.delete(jmr, cols)
        else:
            np.testing.assert_allclose(tmr[KL], jmr[KL], rtol=0,
                                       atol=kl_atol, err_msg=f"KL {step}")
            tmr, jmr = np.delete(tmr, KL), np.delete(jmr, KL)
        np.testing.assert_allclose(tmr, jmr, rtol=RTOL,
                                   err_msg=f"metrics step {step}")
        ranks.add(int(got["params"]["R"]))
    if jspec.learning_rank:
        assert len(ranks) > 1, "the rank never moved"
    if jspec.MH:  # MH rejected something after the warmup steps
        assert float(tout["metrics"][9]) < 1.0


def test_eager_noise_layout():
    """draw_eager_noise gives every draw of an eager step, shaped as the
    JAX step draws it, and the step draws nothing else from the generator
    but the gamma draws' rare rejection rounds."""
    for kw in STEP_CASES.values():
        if kw.get("fused_sweeps"):
            continue
        jspec, spec = specs(**kw)
        gen = torch.Generator().manual_seed(0)
        got = tgibbs.draw_eager_noise(spec, gen, "cpu")
        want = jax_step_noise(jspec, jax.random.PRNGKey(0))[1]
        assert shapes(got) == shapes(want), kw


def shapes(d):
    return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in d.items()}


def test_stream_step_with_conjugate_hypers_runs():
    """The streaming step takes the reference's conjugate Mu/Sigmasq
    update too: two chains, two steps, finite metrics."""
    data = torch.from_numpy(sim_data(3))
    spec = ModelSpec(K=K, N=N, G=G, stream_sweeps=True,
                     exact_truncnorm_hypers=False)
    hp = default_hyperprior_params(spec, float(data.mean()))
    gen = torch.Generator().manual_seed(1)
    state = tgibbs.init_state(spec, hp, data, gen, chains=2)
    for _ in range(2):
        state, out = tgibbs.stream_step(spec, data, hp, state, 1.0,
                                        torch.zeros(2, dtype=torch.bool))
    assert out["metrics"].shape == (2, tgibbs.N_METRICS)
    assert torch.isfinite(out["metrics"]).all()
    assert state["prior"]["Sigmasq_p"].shape == (2, K, N)
