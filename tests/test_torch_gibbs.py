"""The port's Gibbs step against the JAX package's, step by step.

Both start from one JAX ``init_state``, carried over with
``state_from_numpy``. Each step the port is fed the flat uniform tensor
that the JAX step draws from its key (gibbs.py:122-123, 178-180), so the two
chains see the same numbers. Tolerance rtol 1e-3 over 10 steps: float32
sums taken in another order drift a little from step to step. The KL column
is the difference of two float32 sums of size S = sum(M log M) over K*G
terms (gibbs.py:319); each rounds to ~sqrt(K*G) * 6e-8 * S, so KL is held
to an absolute 1e-5 * S instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesnmf_tpu.config import ModelSpec as JModelSpec
from bayesnmf_tpu.config import default_hyperprior_params
from bayesnmf_tpu.models import gibbs as jgibbs
from bayesnmf_tpu_torch.config import ModelSpec
from bayesnmf_tpu_torch.models import gibbs as tgibbs
from bayesnmf_tpu_torch.models.state import state_from_numpy, state_to_numpy

torch.set_num_threads(1)

K, N, G = 16, 3, 24
RTOL = 1e-3
KL = tgibbs.METRIC_NAMES.index("KL")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    Pt = rng.dirichlet(np.ones(K) * 0.5, N).T * 50.0
    Et = rng.gamma(2.0, 2.0, (N, G))
    data = rng.poisson(Pt @ Et).astype(np.float32)
    kw = dict(K=K, N=N, G=G, likelihood="poisson", prior="truncnormal",
              MH=True, fused_sweeps=True)
    jspec, spec = JModelSpec(**kw), ModelSpec(**kw)
    hp = default_hyperprior_params(jspec, float(data.mean()))
    state = jgibbs.init_state(jspec, hp, jnp.asarray(data),
                              jax.random.PRNGKey(3))
    return (jspec, spec), hp, data, state


def jax_uniforms(spec, key):
    """The flat uniforms the JAX fused step draws from ``key``."""
    k_P = jax.random.split(key, 4)[1]
    return np.array(jax.random.uniform(
        k_P, (tgibbs.n_uniforms(spec),), jnp.float32,
        minval=jnp.float32(1.2e-38)))


def to_np(state):
    return jax.tree.map(np.asarray, state)


def test_ten_steps_match_jax(setup):
    (jspec, spec), hp, data, jstate = setup
    jstep = jax.jit(jgibbs.gibbs_step,
                    static_argnames=("spec", "accept_all", "record"))
    tdata = torch.from_numpy(data)
    tstate = state_from_numpy(to_np(jstate), "cpu")
    Mp = np.maximum(data, 1e-6)
    kl_atol = 1e-5 * float(np.sum(Mp * np.log(Mp)))
    for step in range(10):
        accept_all = step < 5  # warmup steps, then true MH
        u = torch.from_numpy(jax_uniforms(spec, jstate["key"]))
        jstate, jout = jstep(jspec, jnp.asarray(data), hp, jstate,
                             jnp.float32(1.0), accept_all)
        tstate, tout = tgibbs.gibbs_step(spec, tdata, hp, tstate, 1.0,
                                         accept_all, u=u)
        want, got = to_np(jstate), state_to_numpy(tstate)
        for k in ("P", "E"):
            np.testing.assert_allclose(got["params"][k], want["params"][k],
                                       rtol=RTOL, err_msg=f"{k} step {step}")
        for k in ("Mu_p", "Sigmasq_p", "Mu_e", "Sigmasq_e"):
            np.testing.assert_allclose(got["prior"][k], want["prior"][k],
                                       rtol=RTOL, atol=1e-6,
                                       err_msg=f"{k} step {step}")
        tm, jm = tout["metrics"].numpy(), np.asarray(jout["metrics"])
        np.testing.assert_allclose(np.delete(tm, KL), np.delete(jm, KL),
                                   rtol=RTOL, err_msg=f"metrics step {step}")
        np.testing.assert_allclose(tm[KL], jm[KL], rtol=0, atol=kl_atol,
                                   err_msg=f"KL step {step}")
        assert int(got["iter"]) == int(want["iter"])
    # the chain moved, and MH rejected something after the warmup steps
    assert float(tout["metrics"][9]) < 1.0


def test_temp_schedule_equals_jax():
    for length, n_temp, seed in ((400, 374, 0), (800, 748, 1),
                                 (200, 100, 2), (1000, 200, 3)):
        np.testing.assert_array_equal(
            tgibbs.temp_schedule(length, n_temp,
                                 np.random.default_rng(seed)),
            jgibbs.temp_schedule(length, n_temp,
                                 np.random.default_rng(seed)))


def test_state_round_trip(setup):
    _, _, _, jstate = setup
    s = to_np(jstate)
    back = state_to_numpy(state_from_numpy(s, "cpu"))
    for group in ("params", "prior"):
        for k, v in back[group].items():
            np.testing.assert_array_equal(v, s[group][k])
            assert v.dtype == s[group][k].dtype
    for k in ("acc_P", "acc_E", "iter"):
        np.testing.assert_array_equal(back[k], s[k])


def test_snapshot_metrics_match_jax(setup):
    (jspec, spec), hp, data, jstate = setup
    want = jgibbs.snapshot_sample(jspec, jnp.asarray(data), jstate,
                                  jnp.float32(1.0))
    got = tgibbs.snapshot_sample(spec, torch.from_numpy(data),
                                 state_from_numpy(to_np(jstate), "cpu"), 1.0)
    np.testing.assert_allclose(got["metrics"].numpy(),
                               np.asarray(want["metrics"]), rtol=1e-5)


def test_chunk_runner_records_every_step(setup):
    (_, spec), hp, data, jstate = setup
    state = state_from_numpy(to_np(jstate), "cpu", seed=4)
    state, out = tgibbs.run_chunk(spec, torch.from_numpy(data), hp, state,
                                  np.ones(6, np.float32), accept_all=False)
    assert out["metrics"].shape == (6, tgibbs.N_METRICS)
    assert out["P"].shape == (6, K, N) and out["E"].shape == (6, N, G)
    np.testing.assert_array_equal(out["metrics"][:, 0].numpy(),
                                  np.arange(2, 8, dtype=np.float32))
    assert torch.isfinite(out["metrics"]).all()
    np.testing.assert_array_equal(out["P"][-1].numpy(),
                                  state["params"]["P"].numpy())
    assert state["iter"] == 7


@pytest.mark.parametrize("kw", [dict(prior="exponential"),
                                dict(learning_rank=True),
                                dict(exact_mh=False),
                                dict(exact_truncnorm_hypers=False),
                                dict(fused_sweeps=False)])
def test_unported_specs_raise(kw):
    spec = ModelSpec(**(dict(K=K, N=N, G=G, likelihood="poisson",
                             prior="truncnormal", MH=True,
                             fused_sweeps=True) | kw))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tgibbs.check_spec(spec)
