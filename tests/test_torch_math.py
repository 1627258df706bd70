"""The port's model math, samplers, MAP estimate and convergence tracker
against the JAX package (and scipy for the samplers' distributions)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

from bayesnmf_tpu.config import ConvergenceControl as JConvergenceControl
from bayesnmf_tpu.models import convergence as jconv
from bayesnmf_tpu.models import map_estimate as jmap
from bayesnmf_tpu.ops import math as jm
from bayesnmf_tpu_torch.config import ConvergenceControl
from bayesnmf_tpu_torch.models import convergence as tconv
from bayesnmf_tpu_torch.models import map_estimate as tmap
from bayesnmf_tpu_torch.ops import distributions as dist
from bayesnmf_tpu_torch.ops import math as tm
from bayesnmf_tpu_torch.ops.rng import ChainStreams

torch.set_num_threads(1)

K, N, G = 12, 3, 20


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(0)
    f = np.float32
    P = rng.gamma(1.0, 1.0, (K, N)).astype(f)
    E = rng.gamma(2.0, 3.0, (N, G)).astype(f)
    A = np.array([1.0, 0.0, 1.0], f)
    M = rng.poisson((P * A) @ E).astype(f)
    prior = {"Mu_p": rng.normal(0, 1, (K, N)).astype(f),
             "Sigmasq_p": rng.gamma(2.0, 1.0, (K, N)).astype(f),
             "Mu_e": rng.normal(0, 1, (N, G)).astype(f),
             "Sigmasq_e": rng.gamma(2.0, 1.0, (N, G)).astype(f)}
    return P, E, A, M, prior


def t(x):
    return torch.from_numpy(np.array(x))


def test_mhat_full_float32_and_matches_jax(arrays):
    P, E, A, _, _ = arrays
    got = tm.mhat(t(P), t(A), t(E)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.mhat(P, A, E)), rtol=1e-6)
    # the reference's Precision.HIGHEST: no TF32 on the card
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_elementwise_math_matches_jax(arrays):
    P, E, A, M, prior = arrays
    Mh = np.asarray(jm.mhat(P, A, E))
    pairs = [
        (tm.poisson_loglik_mat(t(M), t(Mh)), jm.poisson_loglik_mat(M, Mh)),
        (tm.truncnorm_logpdf(t(P), t(prior["Mu_p"]), t(prior["Sigmasq_p"])),
         jm.truncnorm_logpdf(P, prior["Mu_p"], prior["Sigmasq_p"])),
        (tm.rmse(t(M), t(Mh)), jm.rmse(M, Mh)),
        (tm.padded_kl(t(Mh), t(M)), jm.padded_kl(Mh, M)),
        (tm.n_params_of(t(A), K, G), jm.n_params_of(A, K, G)),
        (tm.bic(torch.tensor(-123.5), torch.tensor(64.0), G),
         jm.bic(jnp.float32(-123.5), jnp.float32(64.0), G)),
        (tm.logprior_PE(t(P), t(E), "truncnormal",
                        {k: t(v) for k, v in prior.items()}),
         jm.logprior_PE(P, E, "truncnormal", prior)),
    ]
    lam = {"Lambda_p": prior["Sigmasq_p"], "Lambda_e": prior["Sigmasq_e"]}
    pairs += [
        (tm.exponential_logpdf(t(P), t(lam["Lambda_p"])),
         jm.exponential_logpdf(P, lam["Lambda_p"])),
        (tm.logprior_PE(t(P), t(E), "exponential",
                        {k: t(v) for k, v in lam.items()}),
         jm.logprior_PE(P, E, "exponential", lam)),
    ]
    pairs += list(zip(tm.renormalize(t(P), t(E)), jm.renormalize(P, E)))
    tc = tm.metric_constants("poisson", t(M))
    jc = jm.metric_constants("poisson", jnp.asarray(M))
    pairs += [(tc[k], jc[k]) for k in ("mlogm_sum", "lgamma_sum")]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=1e-5)


def test_unported_families_raise(arrays):
    """The gamma prior's log-prior, the last family ported, equals the JAX
    package's (rtol 1e-5: each entry is a sum of terms ~10x larger than the
    result); the Normal likelihood's metric constants hold the KL entropy
    alone."""
    P, E, _, M, _ = arrays
    rng = np.random.default_rng(4)
    prior = {k: (rng.gamma(4.0, 0.5, x.shape) + 0.1).astype(np.float32)
             for k, x in (("Alpha_p", P), ("Beta_p", P), ("Alpha_e", E),
                          ("Beta_e", E))}
    got = tm.logprior_PE(t(P), t(E), "gamma", {k: t(v)
                                               for k, v in prior.items()})
    want = jm.logprior_PE(P, E, "gamma", prior)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    consts = tm.metric_constants("normal", t(M))
    assert sorted(consts) == ["mlogm_sum"]


@pytest.mark.parametrize("final", [False, True])
def test_compute_map_matches_jax(final):
    rng = np.random.default_rng(1)
    S = 40
    P_h = rng.gamma(1.0, 1.0, (S, K, N)).astype(np.float32)
    E_h = rng.gamma(2.0, 3.0, (S, N, G)).astype(np.float32)
    A_h = np.ones((S, N), np.float32)
    A_h[::3, 1] = 0.0  # two inclusion patterns; the mode keeps column 1
    A_h[::5, 2] = 0.0
    got = tmap.compute_map(t(P_h), t(E_h), A_h, final=final)
    want = jmap.compute_map(P_h, E_h, A_h, final=final)
    for k in ("A", "A_full", "keep_sigs", "idx_mask"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    assert got["A_counts"] == want["A_counts"]
    for k in ("P", "E"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-5)
        for side in ("lower", "upper"):
            np.testing.assert_allclose(
                got["credible_intervals"][k][side],
                np.asarray(want["credible_intervals"][k][side]), rtol=1e-5)
    M = rng.poisson(got["P"] @ got["E"]).astype(np.float32)
    tq = tmap.map_quality_metrics(t(M), got, G, K)
    jq = jmap.map_quality_metrics(jnp.asarray(M), want, G, K)
    for k in tq:
        np.testing.assert_allclose(tq[k], jq[k], rtol=1e-5)


@pytest.mark.parametrize("prior,MH", [("truncnormal", True),
                                      ("exponential", True),
                                      ("exponential", False),
                                      ("gamma", False)])
def test_hyperprior_defaults_match_jax(prior, MH):
    """The port's own copy of the hyperprior defaults (setup.R:123-181)
    gives the JAX package's values, which test_reference_parity.py pins."""
    from bayesnmf_tpu.config import ModelSpec as JModelSpec
    from bayesnmf_tpu.config import default_hyperprior_params as jdefaults
    from bayesnmf_tpu_torch.config import ModelSpec, default_hyperprior_params

    kw = dict(K=96, N=8, G=100, likelihood="poisson", prior=prior, MH=MH)
    assert (default_hyperprior_params(ModelSpec(**kw), 25.0)
            == jdefaults(JModelSpec(**kw), 25.0))


def test_convergence_tracker_matches_jax():
    kw = dict(MAP_over=20, MAP_every=10, miniters=30, maxiters=200,
              Ninarow_nochange=2, Ninarow_nobest=3)
    cc = ConvergenceControl(**kw)
    a = tconv.ConvergenceTracker(cc)
    b = jconv.ConvergenceTracker(JConvergenceControl(**kw))
    metrics = [100.0, 90.0, 85.0, 84.99, 84.995, 84.996, 84.9961, 85.0]
    for i, v in enumerate(metrics):
        it = 10 * (i + 1)
        assert a.update(v, it, True) == b.update(v, it, True)
        assert a.to_dict() == b.to_dict()
    assert a.converged
    c = tconv.ConvergenceTracker(cc)
    c.restore(a.to_dict())
    assert c.to_dict() == a.to_dict()


# ---------------------------------------------------------------------------
# samplers: distribution checks (Philox and threefry never draw alike)
# ---------------------------------------------------------------------------


def _gen(seed):
    """The streams of one chain (uid 0) under ``seed``."""
    return ChainStreams(seed, [0])


@pytest.mark.parametrize("shape_param", [0.4, 2.0, 9.5])
def test_gamma_and_inv_gamma_distributions(shape_param):
    n, rate = 20000, 3.0
    a = torch.full((n,), shape_param)
    x = dist.gamma(_gen(1), a, torch.full((n,), rate),
                   site="gamma_P").numpy()
    assert np.isfinite(x).all() and (x > 0).all()
    assert st.kstest(x, st.gamma(shape_param, scale=1 / rate).cdf).pvalue \
        > 1e-3
    y = dist.inv_gamma(_gen(2), a, torch.full((n,), rate),
                       site="sq_p").numpy()
    assert st.kstest(y, st.invgamma(shape_param, scale=rate).cdf).pvalue \
        > 1e-3


@pytest.mark.parametrize("mu,sigmasq", [(1.5, 0.5), (-2.0, 1.0),
                                        (-30.0, 4.0)])
def test_truncnorm_nonneg_distribution(mu, sigmasq):
    n = 20000
    x = dist.truncnorm_nonneg(_gen(3), torch.full((n,), mu),
                              torch.full((n,), sigmasq), "prior_P").numpy()
    assert (x >= 0).all()
    sd = np.sqrt(sigmasq)
    if -mu / sd > 8.0:
        # deep tail: the draw is mu + sd * (alpha + Exp(1)/alpha), which is
        # sd * Exp(1) / alpha since mu + sd * alpha = 0
        alpha = -mu / sd
        assert abs((x * alpha / sd).mean() - 1.0) < 0.05
    else:
        ref = st.truncnorm(-mu / sd, np.inf, loc=mu, scale=sd)
        assert st.kstest(x, ref.cdf).pvalue > 1e-3


def test_exponential_distribution():
    rate = 2.5
    x = dist.exponential(_gen(5), torch.full((20000,), rate),
                         site="prior_P").numpy()
    assert (x >= 0).all()
    assert st.kstest(x, st.expon(scale=1 / rate).cdf).pvalue > 1e-3


def test_gamma_takes_the_jax_planes():
    """With the JAX draw's uniform planes, the gamma sampler returns the
    JAX values (the exact rejection fallback aside)."""
    import jax

    from bayesnmf_tpu.ops import distributions as jdist

    key = jax.random.PRNGKey(3)
    a = np.linspace(0.3, 40.0, 200).astype(np.float32).reshape(10, 20)
    rate = np.full((10, 20), 1.7, np.float32)
    want = np.asarray(jdist.gamma(key, a, rate))
    u = np.asarray(jax.random.uniform(key, (9, 10, 20), jnp.float32,
                                      minval=jnp.float32(1.1754944e-38)))
    got = dist.gamma(_gen(0), t(a), t(rate), u=t(u), site="gamma_P").numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5)


def test_normal_distribution():
    x = dist.normal(_gen(4), torch.full((20000,), 2.0),
                    torch.full((20000,), 9.0), site="mu_p").numpy()
    assert st.kstest(x, st.norm(2.0, 3.0).cdf).pvalue > 1e-3
