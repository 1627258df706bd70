"""The port's Gibbs step against the JAX package's, step by step.

Both start from one JAX ``init_state``, carried over with
``state_from_numpy``. Each step the port is fed the random numbers that the
JAX step draws from its keys: the flat uniform tensor of the fused step
(gibbs.py:122-123, 178-207), and on the other paths each draw's uniform
planes (the gamma draws', the Gumbel noise, the A draws', the allocation
kernel's interpret-mode planes), so the two chains see the same numbers. Tolerance rtol 1e-3 over 10 steps: float32
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
from bayesnmf_tpu.ops.pallas_allocation import _pick_tile
from bayesnmf_tpu_torch.config import ModelSpec
from bayesnmf_tpu_torch.models import gibbs as tgibbs
from bayesnmf_tpu_torch.models.state import state_from_numpy, state_to_numpy
from bayesnmf_tpu_torch.ops import allocation as AL
from test_torch_fused_sweeps import jax_erfc_tail

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def erfc_tail():
    """The JAX fused kernel with the port's erfc tail mass in its proposal
    (tests/test_torch_fused_sweeps.py::jax_erfc_tail)."""
    with jax_erfc_tail():
        yield

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


# the JAX step's draws, from its key (gibbs.py:118-132)
_JTINY = jnp.float32(1.1754944e-38)   # distributions._TINY


def _gamma_planes(key, shape):
    return np.array(jax.random.uniform(key, (9,) + shape, jnp.float32,
                                       minval=_JTINY))


def jax_slice_noise(key, shape):
    """The noise the JAX slice sampler draws from ``key``
    (distributions.py:225-253): the Exp(1) level, the bracket's uniform and
    the 16 shrink uniforms."""
    k_h, k_l, _, k_u = jax.random.split(key, 4)
    return {"e": np.array(jax.random.exponential(k_h, shape, jnp.float32)),
            "u_l": np.array(jax.random.uniform(k_l, shape, jnp.float32)),
            "u_s": np.stack([np.array(jax.random.uniform(k, shape,
                                                         jnp.float32))
                             for k in jax.random.split(k_u, 16)])}


def side_by_side(p, e):
    """Two sides' slice noise as the port's one pass takes it: each flattened
    and concatenated, P's targets first (the 16 shrink planes along the
    targets' axis)."""
    return {"e": np.concatenate([p["e"].ravel(), e["e"].ravel()]),
            "u_l": np.concatenate([p["u_l"].ravel(), e["u_l"].ravel()]),
            "u_s": np.concatenate([p["u_s"].reshape(16, -1),
                                   e["u_s"].reshape(16, -1)], 1)}


def jax_step_noise(jspec, key):
    """(flat uniforms of the fused step or None, noise dict of the other
    draws) as the JAX gibbs_step draws them from ``key``."""
    K, N, G = jspec.K, jspec.N, jspec.G
    n_extra = 2 * jspec.learning_rank + jspec.needs_Z
    ks = jax.random.split(key, 4 + n_extra)
    k_pp, k_P, k_E = ks[0], ks[1], ks[2]
    noise = {}
    if jspec.prior == "exponential":
        kp = jax.random.split(k_pp, 4)
        noise["prior"] = {"p": _gamma_planes(kp[0], (K, N)),
                          "e": _gamma_planes(kp[1], (N, G))}
    elif jspec.prior == "gamma":  # updates.py:204-235
        kp = jax.random.split(k_pp, 4)
        noise["prior"] = {
            "p": _gamma_planes(kp[0], (K, N)),
            "e": _gamma_planes(kp[2], (N, G)),
            "slice": side_by_side(jax_slice_noise(kp[1], (K, N)),
                                  jax_slice_noise(kp[3], (N, G)))}
    if jspec.MH:
        u = np.array(jax.random.uniform(
            k_P, (tgibbs.n_uniforms(jspec),), jnp.float32,
            minval=jnp.float32(1.2e-38)))
        return u, noise
    noise["P"] = _gamma_planes(k_P, (K, N))
    noise["E"] = _gamma_planes(k_E, (N, G))
    i = 4
    if jspec.learning_rank:
        noise["R"] = np.array(jax.random.gumbel(ks[4], (N + 1,)))
        noise["A"] = np.array([jax.random.uniform(k, ())
                               for k in jax.random.split(ks[5], N)])
        i = 6
    n2 = AL.n_leaves(N)
    Gp = -(-G // _pick_tile(K, G, n2)) * _pick_tile(K, G, n2)
    noise["Z"] = np.array(jax.random.uniform(
        jax.random.fold_in(ks[i], 0), (AL.N_PLANES, AL.n_nodes(N), K, Gp),
        jnp.float32, minval=1.2e-38))[..., :G]
    return None, noise


def _to_torch(x):
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    return torch.from_numpy(np.ascontiguousarray(x))


STEP_CASES = {
    "sbfi": dict(prior="truncnormal", MH=True, fused_sweeps=True,
                 learning_rank=True, rank_method="SBFI"),
    "bfi_exponential": dict(prior="exponential", MH=True, fused_sweeps=True,
                            learning_rank=True, rank_method="BFI"),
    "exponential_reference_ratio": dict(prior="exponential", MH=True,
                                        fused_sweeps=True, exact_mh=False),
    "conjugate": dict(prior="exponential", MH=False, fused_allocation=True),
    "conjugate_sbfi": dict(prior="exponential", MH=False,
                           fused_allocation=True, learning_rank=True,
                           rank_method="SBFI"),
    "conjugate_gamma": dict(prior="gamma", MH=False, fused_allocation=True),
    "conjugate_gamma_sbfi": dict(prior="gamma", MH=False,
                                 fused_allocation=True, learning_rank=True,
                                 rank_method="SBFI"),
    # Alpha ~ Gamma(0.5, 1) starts below 1, where the P and E draws take
    # the gamma draw's a < 1 boost
    "conjugate_gamma_small_alpha": dict(
        prior="gamma", MH=False, fused_allocation=True,
        hp={"c_p": 0.5, "d_p": 1.0, "c_e": 0.5, "d_e": 1.0}),
}
TEMPS = (0.0, 1e-4, 1e-3, 1e-2, 0.1, 0.3, 0.6, 1.0, 1.0, 1.0)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_ten_steps_of_each_path_match_jax(case):
    """Rank learning (SBFI, BFI) in the fused kernel, the exponential prior
    with the exact and the reference ratio, and conjugate Poisson-Gibbs with
    the allocation kernel under the exponential and the gamma prior (the
    latter also with Alpha below 1), at a fixed rank and learning it: ten
    steps over a
    rising temperature, warmup then MH. A and R must be equal; P, E and
    the prior parameters within rtol 1e-3 (P and E, whose values are
    0.05-50, with an absolute 1e-4: a TruncNormal draw near 0 is mu + sd z
    with mu < 0, whose cancellation turns the ~1e-6 relative difference of
    the float32 conditional sums into a larger relative one of a value
    ~1e-3), the metrics as above, the latent
    counts' sums within one count (a count that lands on the other side of
    a split when P and E differ in their last digits). In a step where a
    column leaves (A_n 1 -> 0) the kernel's Mhat keeps that column's cells
    as the float32 residue of Mh - P_n E_n, which both packages round
    apart and whose log at the 1e-6 floor decides the Mhat metrics (RMSE,
    KL, loglik, logpost, BIC); there those five are held to be finite, the
    rest of the row as above."""
    rng = np.random.default_rng(0)
    Pt = rng.dirichlet(np.ones(K) * 0.5, N).T * 50.0
    Et = rng.gamma(2.0, 2.0, (N, G))
    data = rng.poisson(Pt @ Et).astype(np.float32)
    kw = dict(K=K, N=N, G=G, likelihood="poisson") | STEP_CASES[case]
    hp_over = kw.pop("hp", {})
    jspec, spec = JModelSpec(**kw), ModelSpec(**kw)
    hp = default_hyperprior_params(jspec, float(data.mean())) | hp_over
    jstate = jgibbs.init_state(jspec, hp, jnp.asarray(data),
                               jax.random.PRNGKey(7))
    if hp_over:
        assert float(np.min(jstate["prior"]["Alpha_p"])) < 1.0
    jstep = jax.jit(jgibbs.gibbs_step,
                    static_argnames=("spec", "accept_all", "record"))
    tdata = torch.from_numpy(data)
    tstate = state_from_numpy(to_np(jstate), "cpu")
    Mp = np.maximum(data, 1e-6)
    kl_atol = 1e-5 * float(np.sum(Mp * np.log(Mp)))
    ranks = set()
    mhat_cols = [tgibbs.METRIC_NAMES.index(k) for k in
                 ("RMSE", "KL", "loglikelihood", "logposterior", "BIC")]
    for step, temp in enumerate(TEMPS):
        accept_all = jspec.MH and step < 5
        A_before = np.asarray(jstate["params"]["A"])
        u, noise = jax_step_noise(jspec, jstate["key"])
        jstate, jout = jstep(jspec, jnp.asarray(data), hp, jstate,
                             jnp.float32(temp), accept_all)
        tstate, tout = tgibbs.gibbs_step(
            spec, tdata, hp, tstate, temp, accept_all,
            u=None if u is None else torch.from_numpy(u),
            noise=_to_torch(noise))
        want, got = to_np(jstate), state_to_numpy(tstate)
        assert sorted(got["params"]) == sorted(want["params"])
        assert sorted(got["prior"]) == sorted(want["prior"])
        for k in ("A", "R"):
            np.testing.assert_array_equal(got["params"][k],
                                          want["params"][k],
                                          err_msg=f"{k} step {step}")
        for k in ("P", "E"):
            np.testing.assert_allclose(got["params"][k], want["params"][k],
                                       rtol=RTOL, atol=1e-4,
                                       err_msg=f"{k} step {step}")
        for k in ("Zsum_g", "Zsum_k"):
            if k in want["params"]:
                np.testing.assert_allclose(got["params"][k],
                                           want["params"][k], rtol=0,
                                           atol=1.0,
                                           err_msg=f"{k} step {step}")
        for k, v in want["prior"].items():
            np.testing.assert_allclose(got["prior"][k], v, rtol=RTOL,
                                       atol=1e-6, err_msg=f"{k} step {step}")
        tm, jm = tout["metrics"].numpy(), np.asarray(jout["metrics"])
        left = bool(np.any((A_before == 1) & (want["params"]["A"] == 0)))
        if left and jspec.MH:
            assert np.isfinite(tm[mhat_cols]).all()
            tm, jm = np.delete(tm, mhat_cols), np.delete(jm, mhat_cols)
        else:
            np.testing.assert_allclose(tm[KL], jm[KL], rtol=0, atol=kl_atol,
                                       err_msg=f"KL step {step}")
            tm, jm = np.delete(tm, KL), np.delete(jm, KL)
        np.testing.assert_allclose(tm, jm, rtol=RTOL,
                                   err_msg=f"metrics step {step}")
        ranks.add(int(got["params"]["R"]))
    if jspec.learning_rank:
        assert len(ranks) > 1, "the rank never moved"


def test_record_full_adds_the_reference_names(setup):
    """With record='full' a step's sample_out and the chunk's buffers add
    the prior parameters, and with MH the acceptance records
    (gibbs.py:280-289); the basic record holds P, E, A and the metrics."""
    (_, spec), hp, data, jstate = setup
    state = state_from_numpy(to_np(jstate), "cpu", seed=4)
    tdata = torch.from_numpy(data)
    _, basic = tgibbs.gibbs_step(spec, tdata, hp, state, 1.0, False)
    assert sorted(basic) == ["A", "E", "P", "metrics"]
    new, full = tgibbs.gibbs_step(spec, tdata, hp, state, 1.0, False,
                                  record="full")
    assert sorted(full) == ["A", "E", "P", "acc_E", "acc_P", "metrics",
                            "prior"]
    for k, v in new["prior"].items():
        assert torch.equal(full["prior"][k], v)
    _, out = tgibbs.run_chunk(spec, tdata, hp, state, np.ones(3, np.float32),
                              accept_all=False, record="full")
    assert out["prior"]["Mu_e"].shape == (3, N, G)
    assert out["acc_P"].shape == (3, K, N)
    snap = tgibbs.snapshot_sample(spec, tdata, state, 1.0, "full")
    assert torch.equal(snap["acc_E"], state["acc_E"])
