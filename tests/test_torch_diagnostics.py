"""The port's cross-chain diagnostics against the JAX package's.

Each function of bayesnmf_tpu_torch/parallel/diagnostics.py on the seeded
stacks of tests/test_diagnostics.py equals its JAX counterpart (float32 on
both sides, rtol 1e-5) and keeps the JAX tests' ground truths: iid chains
give R-hat ~1 and ESS ~ the draw count, a mean-shifted chain a large R-hat,
an AR(1) chain the ESS (1 - phi) / (1 + phi) of theory; the rank
normalisation is monotone and batched over trailing axes. The ensemble
report equals the JAX report computed from the same metric windows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesnmf_tpu.parallel import diagnostics as JD
from bayesnmf_tpu_torch.parallel import diagnostics as TD

torch.set_num_threads(1)

FUNCS = ("split_rhat", "rank_normalize", "ess", "ess_bulk", "ess_tail",
         "rhat")


def ar1(phi=0.9, C=8, T=4096, seed=3):
    rng = np.random.default_rng(seed)
    x = np.zeros((C, T), np.float64)
    innov = rng.normal(0.0, np.sqrt(1 - phi ** 2), (C, T))
    for t in range(1, T):
        x[:, t] = phi * x[:, t - 1] + innov[:, t]
    return x.astype(np.float32)


def stacks():
    shifted = np.array(jax.random.normal(jax.random.PRNGKey(2), (4, 400)))
    shifted[0] += 5.0
    return {
        "iid": np.array(jax.random.normal(jax.random.PRNGKey(0), (8, 512))),
        "iid_long": np.array(jax.random.normal(jax.random.PRNGKey(1),
                                               (8, 1024))),
        "shifted": shifted,
        "ar1": ar1(),
        "exponential": np.array(jax.random.exponential(
            jax.random.PRNGKey(4), (4, 64, 3))),
        "batched": np.array(jax.random.normal(jax.random.PRNGKey(5),
                                              (4, 256, 2, 3))),
        "ties_odd": np.random.default_rng(6).integers(
            0, 4, (4, 101)).astype(np.float32),
    }


STACKS = stacks()
# the functions each stack's JAX test reads (all of them on the iid and the
# tied stacks)
CASES = {"iid": ("split_rhat", "rhat"), "iid_long": FUNCS,
         "shifted": ("rhat",), "ar1": ("ess",),
         "exponential": ("rank_normalize",),
         "batched": ("rhat", "ess_bulk"), "ties_odd": FUNCS}


@pytest.mark.parametrize("name", sorted(STACKS))
def test_functions_equal_jax(name):
    x = STACKS[name]
    for fn in CASES[name]:
        want = np.asarray(getattr(JD, fn)(jnp.asarray(x)))
        got = getattr(TD, fn)(x)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        assert tuple(got.shape) == want.shape, fn
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6,
                                   err_msg=f"{fn} on {name}")
    # a CPU tensor gives what its numpy array gives
    np.testing.assert_array_equal(TD.rhat(torch.from_numpy(x)).numpy(),
                                  TD.rhat(x).numpy())


def test_ground_truths():
    r = float(TD.rhat(STACKS["iid"]))
    assert 0.99 < r < 1.02 and float(TD.split_rhat(STACKS["iid"])) < 1.02
    total = 8 * 1024
    assert 0.5 * total < float(TD.ess_bulk(STACKS["iid_long"])) < 1.6 * total
    assert 0.3 * total < float(TD.ess_tail(STACKS["iid_long"])) < 1.6 * total
    assert float(TD.rhat(STACKS["shifted"])) > 1.2
    expected = 8 * 4096 * (1 - 0.9) / (1 + 0.9)
    assert 0.5 * expected < float(TD.ess(STACKS["ar1"])) < 2.0 * expected
    x = STACKS["exponential"]
    z = TD.rank_normalize(x).numpy()
    assert z.shape == x.shape
    xf, zf = x.reshape(-1, 3), z.reshape(-1, 3)
    for j in range(3):
        assert (np.argsort(xf[:, j]) == np.argsort(zf[:, j])).all()
    assert abs(float(z.mean())) < 0.05 and 0.8 < float(z.std()) < 1.1
    r = TD.rhat(STACKS["batched"])
    assert r.shape == (2, 3) and (r < 1.1).all()
    assert TD.ess_bulk(STACKS["batched"]).shape == (2, 3)


def test_ensemble_report_equals_jax():
    """A conjugate Poisson-Exponential ensemble at a fixed rank (the JAX
    test's model): the port's report and the JAX function's on the same
    windows; the rank, constant at a fixed rank, is flagged."""
    import bayesnmf_tpu_torch as bt

    rng = np.random.default_rng(0)
    P = rng.dirichlet(np.ones(12) * 0.5, 3).T * 80.0
    E = rng.gamma(2.0, 2.0, (3, 16))
    M = rng.poisson(P @ E).astype(np.float32)
    cc = bt.ConvergenceControl(MAP_over=20, MAP_every=10, miniters=20,
                               maxiters=60, Ninarow_nochange=2,
                               Ninarow_nobest=3)
    ens = bt.ChainEnsemble(M, 3, n_chains=4, prior="exponential", MH=False,
                           convergence_control=cc, seed=0, device="cpu")
    ens.run()
    df = TD.ensemble_diagnostics(ens, n_draws=40)
    want = JD.ensemble_diagnostics(ens, n_draws=40)
    assert list(df["metric"]) == list(want["metric"])
    assert list(df["constant"]) == list(want["constant"])
    for col in ("rhat", "ess_bulk", "ess_tail"):
        np.testing.assert_allclose(df[col], want[col], rtol=1e-5, err_msg=col)
    row = df[df["metric"] == "rank"].iloc[0]
    assert row["constant"] and row["rhat"] == 1.0
    assert np.isfinite(df["rhat"]).all() and (df["ess_bulk"] > 0).all()
    # the method defaults the window to MAP_over
    df2 = ens.diagnostics()
    assert list(df2["metric"]) == list(df["metric"])
    np.testing.assert_allclose(
        df2["rhat"], JD.ensemble_diagnostics(ens, n_draws=20)["rhat"],
        rtol=1e-5)


def test_chains_stuck_at_different_ranks_are_flagged():
    """Each chain's rank constant, the chains' ranks unequal: not
    ``constant`` (the JAX report calls it so and gives R-hat 1), and a large
    R-hat; a rank shared by every chain is constant."""
    import types

    from bayesnmf_tpu_torch.models.gibbs import METRIC_NAMES, N_METRICS

    rng = np.random.default_rng(1)
    rows = rng.normal(size=(3, 40, N_METRICS)).astype(np.float32)
    col = METRIC_NAMES.index("rank")
    rows[:, :, col] = np.array([3.0, 5.0, 8.0])[:, None]
    ens = types.SimpleNamespace(metrics_stack=lambda n: rows[:, -n:])
    df = TD.ensemble_diagnostics(ens, metrics=("rank", "RMSE"), n_draws=40)
    rank = df[df["metric"] == "rank"].iloc[0]
    assert not rank["constant"] and rank["rhat"] > 2.0
    assert bool(JD.ensemble_diagnostics(ens, metrics=("rank",),
                                        n_draws=40)["constant"][0])
    rows[:, :, col] = 4.0
    df = TD.ensemble_diagnostics(ens, metrics=("rank",), n_draws=40)
    assert bool(df["constant"][0]) and df["rhat"][0] == 1.0
