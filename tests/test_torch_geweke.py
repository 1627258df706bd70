"""Geweke joint-distribution tests of the port's eager sweeps, Normal
likelihood and gamma prior (the design of tests/test_geweke.py, whose
docstring explains it): the successive-conditional chain, one Gibbs step
of the port then a fresh draw of the data from the likelihood, keeps the
joint of (params, data), so the chains' mean statistics of (P, E) must
match exact prior draws within 6 standard errors. Per-step parity with the JAX package
(tests/test_torch_eager.py) cannot show this: one flipped decision parts
two chains for good.

Marked slow, as the JAX tests are; each case runs ~30-60 s on one CPU core
(the gamma prior's ~3 min).
"""

import numpy as np
import pytest
import torch

from bayesnmf_tpu_torch.config import ModelSpec
from bayesnmf_tpu_torch.models import gibbs
from bayesnmf_tpu_torch.models import updates as U
from bayesnmf_tpu_torch.ops import math as m

torch.set_num_threads(1)

K, N, G = 3, 2, 4
C = 64     # chains
T = 250    # transitions per chain


def fixed_hp(spec):
    """Constant hyperpriors (tests/test_geweke.py::fixed_hp)."""
    if spec.prior == "truncnormal":
        hp = {"m_p": 1.0, "s_p": 0.5, "a_p": 4.0, "b_p": 3.0,
              "m_e": 1.0, "s_e": 0.5, "a_e": 4.0, "b_e": 3.0}
    elif spec.prior == "exponential":
        hp = {"a_p": 5.0, "b_p": 5.0, "a_e": 5.0, "b_e": 5.0}
    else:
        hp = {"a_p": 6.0, "b_p": 3.0, "c_p": 6.0, "d_p": 3.0,
              "a_e": 6.0, "b_e": 3.0, "c_e": 6.0, "d_e": 3.0}
    if spec.likelihood == "normal":
        hp |= {"alpha": 4.0, "beta": 3.0}
    return hp


def redraw_data(spec, gen, params):
    """The data given params: Poisson(max(Mhat, 1e-6)) or
    Normal(Mhat, sigmasq per column)."""
    Mh = m.mhat(params["P"], params["A"], params["E"])
    if spec.likelihood == "poisson":
        return torch.poisson(Mh.clamp_min(1e-6), generator=gen)
    return Mh + torch.randn(Mh.shape, generator=gen) * torch.sqrt(
        params["sigmasq"])


def stats_of(P, E):
    """mean P, mean P^2, mean E, mean E^2, mean P * mean E over the last
    two axes (per chain when there is a leading one)."""
    mp, me = P.mean((-2, -1)), E.mean((-2, -1))
    return torch.stack([mp, (P * P).mean((-2, -1)), me,
                        (E * E).mean((-2, -1)), mp * me], -1)


def run_successive(spec, hp, seed=0):
    """Per-chain means of the statistics over T successive-conditional
    transitions, the first fifth dropped: (C, 5)."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(C):
        state = gibbs.init_state(spec, hp, torch.zeros(K, G), gen)
        data = redraw_data(spec, gen, state["params"])
        stats = []
        for _ in range(T):
            state, _ = gibbs.gibbs_step(spec, data, hp, state, 1.0, False)
            data = redraw_data(spec, gen, state["params"])
            stats.append(stats_of(state["params"]["P"],
                                  state["params"]["E"]))
        out.append(torch.stack(stats[T // 5:]).mean(0))
    return torch.stack(out).numpy()


def run_marginal(spec, hp, n=4096, seed=1):
    """Exact prior draws of the statistics: (n, 5)."""
    gen = torch.Generator().manual_seed(seed)
    prior = U.init_prior_params(spec, hp, gen, "cpu", chains=n)
    P = U._prior_draw_P(spec, prior, gen)
    E = U._prior_draw_E(spec, prior, gen)
    return stats_of(P, E).numpy()


FAMILIES = [
    dict(likelihood="normal", prior="truncnormal", MH=False),
    dict(likelihood="normal", prior="exponential", MH=False),
    dict(likelihood="poisson", prior="truncnormal", MH=True),
]


@pytest.mark.slow
@pytest.mark.parametrize("kw", FAMILIES,
                         ids=lambda kw: f"{kw['likelihood']}-{kw['prior']}")
def test_geweke_joint_eager(kw):
    """The eager step (Poisson MH with fused_sweeps=False) leaves the joint
    invariant: |z| < 6 for every statistic, as tests/test_geweke.py:158-170
    holds the JAX XLA path."""
    spec = ModelSpec(K=K, N=N, G=G, **kw)
    assert not spec.fused_sweeps
    hp = fixed_hp(spec)
    succ, marg = run_successive(spec, hp), run_marginal(spec, hp)
    se = np.sqrt(succ.var(0, ddof=1) / len(succ)
                 + marg.var(0, ddof=1) / len(marg))
    z = (succ.mean(0) - marg.mean(0)) / se
    assert np.all(np.abs(z) < 6.0), (
        f"Geweke mismatch for {kw}: z={z}, succ={succ.mean(0)}, "
        f"marg={marg.mean(0)}")


def redraw_counts(gen, params):
    """The data layer of the Z-augmented conjugate path, for C chains at
    once (tests/test_geweke.py::redraw_data): Z ~ Poisson(P_kn A_n E_ng),
    M = sum_n Z, and the latent counts' sums from the same Z."""
    lam = (params["P"] * params["A"].unsqueeze(-2)).unsqueeze(-1) \
        * params["E"].unsqueeze(-3)                       # (C, K, N, G)
    Z = torch.poisson(lam.clamp_min(1e-12), generator=gen)
    return Z.sum(-2), Z.sum(-1), Z.sum(-3)


@pytest.mark.slow
def test_geweke_joint_conjugate_gamma():
    """The conjugate Poisson-Gamma step (Beta, Alpha by the slice sampler,
    P and E given the latent counts, the allocation kernel's plain version)
    leaves the joint invariant (tests/test_geweke.py:138): C chains run as
    one chain-batched state, |z| < 6 for every statistic."""
    spec = ModelSpec(K=K, N=N, G=G, likelihood="poisson", prior="gamma",
                     MH=False)
    hp = fixed_hp(spec)
    gen = torch.Generator().manual_seed(0)
    state = gibbs.init_state(spec, hp, torch.zeros(K, G), gen, chains=C)
    params = state["params"]
    data, params["Zsum_g"], params["Zsum_k"] = redraw_counts(gen, params)
    stats = []
    for _ in range(T):
        # each chain's data differ, so the chains step one at a time on a
        # batch of one
        out = []
        for c in range(C):
            st = {"params": {k: v[c] for k, v in state["params"].items()},
                  "prior": {k: v[c] for k, v in state["prior"].items()},
                  "gen": gen, "iter": state["iter"]}
            out.append(gibbs.gibbs_step(spec, data[c], hp, st, 1.0,
                                        False)[0])
        state = {"params": {k: torch.stack([o["params"][k] for o in out])
                            for k in out[0]["params"]},
                 "prior": {k: torch.stack([o["prior"][k] for o in out])
                           for k in out[0]["prior"]},
                 "gen": gen, "iter": out[0]["iter"]}
        params = state["params"]
        data, params["Zsum_g"], params["Zsum_k"] = redraw_counts(gen, params)
        stats.append(stats_of(params["P"], params["E"]))
    succ = torch.stack(stats[T // 5:]).mean(0).numpy()
    marg = run_marginal(spec, hp)
    se = np.sqrt(succ.var(0, ddof=1) / len(succ)
                 + marg.var(0, ddof=1) / len(marg))
    z = (succ.mean(0) - marg.mean(0)) / se
    assert np.all(np.abs(z) < 6.0), (
        f"Geweke mismatch for the gamma prior: z={z}, succ={succ.mean(0)}, "
        f"marg={marg.mean(0)}")
