"""Geweke joint-distribution tests of the port (the design of
tests/test_geweke.py, whose docstring explains it): the
successive-conditional chain, one Gibbs step of the port then a fresh draw
of the data from the likelihood, keeps the joint of (params, data), so the
chains' mean statistics of (P, E), and with rank learning of A and R, must
match exact prior draws within 6 standard errors. Per-step parity with the
JAX package (tests/test_torch_eager.py, tests/test_torch_fused_sweeps.py)
cannot show this: one flipped decision parts two chains for good.

Every gate of the JAX file has its counterpart here, on each path of the
port that runs it: the eager sweeps, the fused kernel, the streaming
kernels, the conjugate steps through the allocation, and the fixed-rank
``fused_pe_sweeps``. On the CPU they run the kernels' plain versions. The
harness takes a ``device``: chip_smoke.py imports this file and runs the
gates on the card, where the same steps launch the kernels.

Marked slow, as the JAX tests are; a gate takes ~0.3-5 min on one CPU core
(the conjugate gamma prior's the longest).
"""

import numpy as np
import pytest
import torch

from bayesnmf_tpu_torch.config import ModelSpec
from bayesnmf_tpu_torch.models import gibbs
from bayesnmf_tpu_torch.ops import fused_sweeps as FS
from bayesnmf_tpu_torch.ops import math as m
from bayesnmf_tpu_torch.ops.rng import ChainStreams

torch.set_num_threads(1)

K, N, G = 3, 2, 4
C = 64     # chains
T = 250    # transitions per chain
N_MARGINAL = 4096
Z_BOUND = 6.0

# the gates: name -> ModelSpec keywords at (K, N, G); "fused_pe_sweeps"
# steps through ops/fused_sweeps.fused_pe_sweeps instead of gibbs_step
GATES = {
    "normal-truncnormal": dict(likelihood="normal", prior="truncnormal",
                               MH=False),
    "normal-exponential": dict(likelihood="normal", prior="exponential",
                               MH=False),
    "poisson-truncnormal": dict(prior="truncnormal", MH=True),
    "conjugate-gamma": dict(prior="gamma", MH=False),
    "conjugate-exponential": dict(prior="exponential", MH=False),
    "exponential-mh": dict(prior="exponential", MH=True),
    "exponential-mh-fused": dict(prior="exponential", MH=True,
                                 fused_sweeps=True),
    "bfi": dict(prior="exponential", MH=True, learning_rank=True,
                rank_method="BFI"),
    "bfi-fused": dict(prior="exponential", MH=True, learning_rank=True,
                      rank_method="BFI", fused_sweeps=True),
    "sbfi": dict(prior="exponential", MH=True, learning_rank=True,
                 rank_method="SBFI"),
    "sbfi-fused": dict(prior="exponential", MH=True, learning_rank=True,
                       rank_method="SBFI", fused_sweeps=True),
    "fused-truncnormal": dict(prior="truncnormal", MH=True,
                              fused_sweeps=True),
    "stream": dict(prior="truncnormal", MH=True, stream_sweeps=True),
    "reference-ratio": dict(prior="truncnormal", MH=True, exact_mh=False),
    "reference-ratio-fused": dict(prior="truncnormal", MH=True,
                                  exact_mh=False, fused_sweeps=True),
    "reference-hypers": dict(prior="truncnormal", MH=True,
                             exact_truncnorm_hypers=False),
    "reference-hypers-fused": dict(prior="truncnormal", MH=True,
                                   exact_truncnorm_hypers=False,
                                   fused_sweeps=True),
    "fused_pe_sweeps": dict(prior="truncnormal", MH=True,
                            fused_sweeps=True),
}
# the reference kernels' gates fail with these signs of z[0], mean(P)
# (tests/test_geweke.py:211-242): the reference ratio biases P/E down, the
# reference conjugate hypers up
FAILING = {"reference-ratio": -1, "reference-ratio-fused": -1,
           "reference-hypers": +1, "reference-hypers-fused": +1}


def gate_spec(name, K=K, N=N, G=G):
    kw = dict(GATES[name])
    return ModelSpec(K=K, N=N, G=G, likelihood=kw.pop("likelihood",
                                                      "poisson"), **kw)


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
    """The data layer given one chain's params, a batch of one
    (tests/test_geweke.py::redraw_data): Poisson(max(Mhat, 1e-6)) or
    Normal(Mhat, sigmasq per column); on the conjugate path the latent
    counts Z ~ Poisson(P_kn A_n E_ng), M = sum_n Z, and the latent counts'
    sums taken from the same Z. Returns (data (K, G), params)."""
    P, A, E = params["P"], params["A"], params["E"]
    if spec.needs_Z:
        lam = (P * A.unsqueeze(-2)).unsqueeze(-1) * E.unsqueeze(-3)
        Z = torch.poisson(lam.clamp_min(1e-12), generator=gen)
        params = dict(params, Zsum_g=Z.sum(-1), Zsum_k=Z.sum(-3))
        return Z.sum(-2)[0], params
    Mh = m.mhat(P, A, E)[0]
    if spec.likelihood == "poisson":
        return torch.poisson(Mh.clamp_min(1e-6), generator=gen), params
    noise = torch.randn(Mh.shape, generator=gen, device=Mh.device)
    return Mh + noise * torch.sqrt(params["sigmasq"][0]), params


def stats_of(params, learning=False):
    """Per chain: mean P, mean P^2, mean E, mean E^2, mean P * mean E, and
    with rank learning mean A and R (tests/test_geweke.py::stats_of)."""
    P, E = params["P"], params["E"]
    mp, me = P.mean((-2, -1)), E.mean((-2, -1))
    s = [mp, (P * P).mean((-2, -1)), me, (E * E).mean((-2, -1)), mp * me]
    if learning:
        s += [params["A"].mean(-1), params["R"].to(torch.float32)]
    return torch.stack(s, -1)


def pe_sweeps_step(spec, data, hp, state, temperature, accept_all):
    """One step of ``fused_pe_sweeps`` with the prior parameters held at
    their initial draw: the P and E MH sweeps alone, on a fresh Mhat and
    fresh uniforms. The chain keeps p(P, E, data | Mu, Sigmasq), so its
    means over chains whose prior parameters were drawn from the
    hyperpriors match the full model's marginal. The uniforms are one draw
    of the chain's streams at site "fused"."""
    params, prior = dict(state["params"]), state["prior"]
    gen = gibbs.streams_of(state)
    kn, ng = (spec.K, spec.N), (spec.N, spec.G)
    shapes = [kn, ng, kn, kn, ng, ng]
    sizes = [int(np.prod(x)) for x in shapes]
    planes = gen.uniform("fused", (1, sum(sizes))).split(sizes, 1)
    Upr_P, Upr_E, Up_P, Ua_P, Up_E, Ua_E = (
        x.reshape((1,) + sh) for x, sh in zip(planes, shapes))
    Mh = m.mhat(params["P"], params["A"], params["E"])
    params["P"], params["E"], _, acc_P, acc_E = FS.fused_pe_sweeps(
        data, params["P"], params["E"], params["A"], Mh, state["acc_P"],
        state["acc_E"], Upr_P, Upr_E, Up_P, Ua_P, Up_E, Ua_E,
        prior["Mu_p"], prior["Sigmasq_p"], prior["Mu_e"], prior["Sigmasq_e"],
        prior_kind="truncnormal", exact_mh=True, accept_all=accept_all)
    it = state["iter"] + 1
    return dict(state, params=params, acc_P=acc_P, acc_E=acc_E, iter=it,
                gen=gen.at(it)), None


def run_successive(name, spec=None, device="cpu", n_chains=C, n_steps=T,
                   seed=0, chains=None):
    """Per-chain means of the statistics over ``n_steps``
    successive-conditional transitions, the first fifth dropped: (chains,
    n_stats). Each chain starts from an exact joint draw and steps as a
    batch of one, since each has its own data and no step takes data on a
    chain axis; chain c draws from the stream of uid c under ``seed``, and
    its data from a generator seeded from (seed, c), so ``chains`` (default
    range(n_chains)) may split one gate's chains over several callers."""
    spec = gate_spec(name) if spec is None else spec
    hp = fixed_hp(spec)
    step = pe_sweeps_step if name == "fused_pe_sweeps" else gibbs.gibbs_step
    accept = torch.zeros(1, dtype=torch.bool, device=device)
    zeros = torch.zeros(spec.K, spec.G, device=device)
    out = []
    for c in (range(n_chains) if chains is None else chains):
        gen = torch.Generator(device=device).manual_seed(seed * 1000003 + c)
        state = gibbs.init_state(spec, hp, zeros,
                                 ChainStreams(seed, [c], device=device),
                                 chains=1)
        data, state["params"] = redraw_data(spec, gen, state["params"])
        stats = []
        for _ in range(n_steps):
            state, _ = step(spec, data, hp, state, 1.0, accept)
            data, state["params"] = redraw_data(spec, gen, state["params"])
            stats.append(stats_of(state["params"], spec.learning_rank)[0])
        out.append(torch.stack(stats[n_steps // 5:]).mean(0))
    return torch.stack(out).cpu().numpy()


def run_marginal(spec, n=N_MARGINAL, seed=1, device="cpu"):
    """Exact prior draws of the statistics (init_state of n chains):
    (n, n_stats)."""
    st = gibbs.init_state(spec, fixed_hp(spec),
                          torch.zeros(spec.K, spec.G, device=device),
                          ChainStreams(seed, np.arange(n), device=device),
                          chains=n)
    return stats_of(st["params"], spec.learning_rank).cpu().numpy()


def geweke_z(succ, marg):
    """The z-score of each statistic: chain means against prior draws."""
    se = np.sqrt(succ.var(0, ddof=1) / len(succ)
                 + marg.var(0, ddof=1) / len(marg))
    return (succ.mean(0) - marg.mean(0)) / se


def gate_z(name, device="cpu"):
    spec = gate_spec(name)
    succ = run_successive(name, spec, device=device)
    return geweke_z(succ, run_marginal(spec, device=device)), succ


def assert_gate(name, z, succ):
    assert np.all(np.abs(z) < Z_BOUND), (
        f"Geweke mismatch for {name}: z={z}, succ={succ.mean(0)}")


@pytest.mark.slow
@pytest.mark.parametrize("name", ["normal-truncnormal", "normal-exponential",
                                  "poisson-truncnormal"])
def test_geweke_joint_eager(name):
    """The eager step (the Normal likelihood; Poisson MH with
    fused_sweeps=False) leaves the joint invariant: |z| < 6 for every
    statistic, as tests/test_geweke.py:158-170 holds the JAX XLA path."""
    assert not gate_spec(name).fused_sweeps
    assert_gate(name, *gate_z(name))


@pytest.mark.slow
def test_geweke_joint_conjugate_gamma():
    """The conjugate Poisson-Gamma step (Beta, Alpha by the slice sampler,
    P and E given the latent counts, the allocation kernel's plain version)
    leaves the joint invariant (tests/test_geweke.py:138)."""
    assert_gate("conjugate-gamma", *gate_z("conjugate-gamma"))


@pytest.mark.slow
@pytest.mark.parametrize("name", ["conjugate-exponential", "exponential-mh",
                                  "exponential-mh-fused"])
def test_geweke_joint(name):
    """The rest of tests/test_geweke.py::FAMILIES (:136-143):
    Poisson-Exponential conjugate Gibbs (Lambda, P and E given the latent
    counts, the allocation's plain version, the counts redrawn with the
    data), and Poisson-Exponential MH on the eager sweeps and through the
    fused kernel."""
    assert_gate(name, *gate_z(name))


@pytest.mark.slow
@pytest.mark.parametrize("name", ["bfi", "bfi-fused"])
def test_geweke_joint_rank_learning_bfi(name):
    """The rank-learning transitions (the R draw and the A sweep) leave the
    joint invariant under BFI, whose A update is the exact Bernoulli
    conditional, on the eager sweeps and in the fused kernel (Gumbel-max R
    and the A draws in-kernel) (tests/test_geweke.py:172-192)."""
    assert_gate(name, *gate_z(name))


@pytest.mark.slow
@pytest.mark.parametrize("fused", [False, True])
def test_sbfi_penalty_biases_rank_down(fused):
    """SBFI's BIC penalty pushes the stationary mean of A below BFI's
    (tests/test_geweke.py:195-208), on both paths."""
    sfx = "-fused" if fused else ""
    means = {rm: run_successive(rm + sfx).mean(0)[5] for rm in ("bfi",
                                                                "sbfi")}
    assert means["sbfi"] < means["bfi"], means


@pytest.mark.slow
@pytest.mark.parametrize("name", list(FAILING))
def test_reference_kernels_fail_geweke(name):
    """With one reference kernel in place of the exact one, the chain
    drifts off the joint by many standard errors, with the JAX package's
    sign on mean(P) (tests/test_geweke.py:211-242): the reference MH ratio
    (normal-model likelihoods for the proposal densities) biases P/E down,
    the reference conjugate Mu/Sigmasq updates (the truncation normaliser
    dropped) up; on the eager sweeps and on the fused path."""
    z, succ = gate_z(name)
    assert np.abs(z).max() > Z_BOUND, (
        f"expected the reference kernel ({name}) to fail the joint test; "
        f"z={z}")
    assert np.sign(z[0]) == FAILING[name], (name, z)


@pytest.mark.slow
def test_geweke_joint_fused_truncnormal_inkernel_hypers():
    """The fully fused truncnormal iteration, the Mu/Sigmasq hyper-sweep
    inside the kernel beside the P/E sweeps (tests/test_geweke.py:246)."""
    assert_gate("fused-truncnormal", *gate_z("fused-truncnormal"))


@pytest.mark.slow
def test_geweke_joint_stream_sweeps():
    """The streaming path (stream_step: the column updates, the A sweep and
    the metrics row of ops/stream_sweeps.py) leaves the joint invariant on
    its own (tests/test_geweke.py:291)."""
    assert_gate("stream", *gate_z("stream"))


@pytest.mark.slow
def test_geweke_joint_fused_pe_sweeps():
    """The fixed-rank form ``fused_pe_sweeps`` (the MH sweeps at fixed
    prior parameters) leaves p(P, E, data | Mu, Sigmasq) invariant."""
    assert_gate("fused_pe_sweeps", *gate_z("fused_pe_sweeps"))
