"""The port's steps on a chain axis against the JAX package, chain by chain.

Each path's batched step (the fused kernel's plain version, the eager
Poisson MH sweeps, Normal-TruncNormal, Normal-Exponential and conjugate
Poisson-Gibbs with the exponential and the gamma prior), at a fixed rank
and with SBFI, runs C = 3 chains at once
fed each chain's JAX draws (the draws the JAX step takes from that chain's
key), and each chain is held to the JAX ``gibbs_step`` of that chain for
ten steps over a rising temperature, with the warmup flag mixed across the
chains: decisions (A, R, accept/reject) equal, values within rtol 1e-3 /
atol 1e-4 and the metrics row as in tests/test_torch_eager.py (KL to
1e-5 of sum(M log M), or to the KL of the port's own state where the
states' allowed differences move it by more, see check_kl; in a step where
a column leaves, the Mhat metrics only finite), the latent counts' sums
within one count. Each step starts from the JAX chains' states: on the
conjugate path a count that lands on the other side of a binomial split
(P and E differ in their last digits) sends a chain's later draws
elsewhere for good, as one flipped decision would on the MH paths. Then
the chain axis itself: a step of C = 3 chains equals three C = 1 steps of
the port on the same numbers, on every path (rtol 1e-6).
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
from bayesnmf_tpu_torch.models import updates as tU
from bayesnmf_tpu_torch.models.state import state_from_numpy, state_to_numpy
from bayesnmf_tpu_torch.ops.rng import ChainStreams
from bayesnmf_tpu_torch.ops import allocation as AL
from test_torch_eager import jax_step_noise as eager_noise
from test_torch_fused_sweeps import jax_erfc_tail
from test_torch_gibbs import jax_step_noise as conjugate_noise

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def erfc_tail():
    """The JAX fused kernel with the port's erfc tail mass in its proposal
    (tests/test_torch_fused_sweeps.py::jax_erfc_tail)."""
    with jax_erfc_tail():
        yield

K, N, G, C = 16, 3, 24, 3
RTOL, ATOL = 1e-3, 1e-4
KL = tgibbs.METRIC_NAMES.index("KL")
MHAT_COLS = [tgibbs.METRIC_NAMES.index(k) for k in
             ("RMSE", "KL", "loglikelihood", "logposterior", "BIC")]
TEMPS = (0.0, 1e-4, 1e-3, 1e-2, 0.1, 0.3, 0.6, 1.0, 1.0, 1.0)
# the warmup flags of the first five steps: chain 2 is past its warmup
WARMUP = (True, True, False)

PATHS = {
    "fused": dict(likelihood="poisson", prior="truncnormal",
                  fused_sweeps=True),
    "eager_mh": dict(likelihood="poisson", prior="truncnormal"),
    "normal_truncnormal": dict(likelihood="normal", prior="truncnormal",
                               MH=False),
    "normal_exponential": dict(likelihood="normal", prior="exponential",
                               MH=False),
    "conjugate": dict(likelihood="poisson", prior="exponential", MH=False,
                      fused_allocation=True),
    "conjugate_gamma": dict(likelihood="poisson", prior="gamma", MH=False,
                            fused_allocation=True),
}
RANKS = {"fixed": {}, "sbfi": dict(learning_rank=True, rank_method="SBFI")}


def sim_data(seed=0):
    rng = np.random.default_rng(seed)
    Pt = rng.dirichlet(np.ones(K) * 0.5, N).T * 50.0
    Et = rng.gamma(2.0, 2.0, (N, G))
    return rng.poisson(Pt @ Et).astype(np.float32)


def T(x):
    if isinstance(x, dict):
        return {k: T(v) for k, v in x.items()}
    return torch.from_numpy(np.ascontiguousarray(x))


def stack(trees):
    """Per-chain numpy trees -> one tree with a leading chain axis."""
    if isinstance(trees[0], dict):
        return {k: stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack([np.asarray(t) for t in trees])


def chain_draws(jspec, key):
    """(flat uniforms or None, noise) the JAX step of one chain draws."""
    if jspec.needs_Z:
        return conjugate_noise(jspec, key)
    return eager_noise(jspec, key)


def batch_state(jstates):
    """The port's C-chain state from the chains' JAX states."""
    d = stack([jax.tree.map(np.asarray, s) for s in jstates])
    d["iter"] = np.asarray(jstates[0]["iter"])
    return state_from_numpy(d, "cpu")


def close(got, want, msg):
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=msg)


def kl_terms(data, params):
    """The padded KL of a state in float64, and its Mhat."""
    Mh = (params["P"].astype(np.float64) * params["A"]) @ params["E"]
    Mp = np.maximum(data, 1e-6).astype(np.float64)
    return float(np.sum(Mp * (np.log(Mp) - np.log(np.maximum(Mh, 1e-6))))), Mh


def check_kl(c, got, want, trow, jrow, data, kl_atol, step):
    """KL within 1e-5 of sum(M log M) of the JAX chain's. Where the two
    states' Mhat differ by more than that weighs in the log (the Normal
    likelihood leaves cells with counts at Mhat ~1e-5, whose value rests on
    truncated-normal draws near 0, held to atol 1e-4), the port's KL is
    held to its own state's instead (rtol 1e-5)."""
    mine = {k: got["params"][k][c] for k in "PAE"}
    kl_t, Mh_t = kl_terms(data, mine)
    _, Mh_j = kl_terms(data, want["params"])
    Mp = np.maximum(data, 1e-6)
    spread = float(np.sum(Mp * np.abs(Mh_t - Mh_j)
                          / np.maximum(np.minimum(Mh_t, Mh_j), 1e-6)))
    if spread <= kl_atol:
        np.testing.assert_allclose(trow[KL], jrow[KL], rtol=0, atol=kl_atol,
                                   err_msg=f"KL chain {c} step {step}")
    else:
        np.testing.assert_allclose(trow[KL], kl_t, rtol=1e-5,
                                   err_msg=f"KL chain {c} step {step}")


def check_chain(c, got, want, trow, jrow, A_before, jspec, data, kl_atol,
                step):
    """One chain of the port's batched state and row against its JAX
    step's."""
    for k in ("A", "R"):
        np.testing.assert_array_equal(got["params"][k][c], want["params"][k],
                                      err_msg=f"{k} chain {c} step {step}")
    for k, v in want["params"].items():
        if k not in ("A", "R", "Zsum_g", "Zsum_k"):
            close(got["params"][k][c], v, f"{k} chain {c} step {step}")
    for k in ("Zsum_g", "Zsum_k"):  # a count on the other side of a split
        if k in want["params"]:
            np.testing.assert_allclose(got["params"][k][c],
                                       want["params"][k], rtol=0, atol=1.0)
    for k, v in want["prior"].items():
        close(got["prior"][k][c], v, f"{k} chain {c} step {step}")
    for k in ("acc_P", "acc_E"):
        assert (k in got) == (k in want)
        if k in want:
            close(got[k][c], want[k], f"{k} chain {c} step {step}")
    left = bool(np.any((A_before == 1) & (want["params"]["A"] == 0)))
    if left:
        cols = MHAT_COLS if jspec.likelihood == "poisson" else [KL]
        assert np.isfinite(trow[cols]).all()
        trow, jrow = np.delete(trow, cols), np.delete(jrow, cols)
    else:
        check_kl(c, got, want, trow, jrow, data, kl_atol, step)
        trow, jrow = np.delete(trow, KL), np.delete(jrow, KL)
    np.testing.assert_allclose(trow, jrow, rtol=RTOL,
                               err_msg=f"metrics chain {c} step {step}")


@pytest.mark.parametrize("rank", sorted(RANKS))
@pytest.mark.parametrize("path", sorted(PATHS))
def test_batched_step_matches_jax_chain_by_chain(path, rank):
    data = sim_data()
    kw = dict(K=K, N=N, G=G) | PATHS[path] | RANKS[rank]
    jspec, spec = JModelSpec(**kw), ModelSpec(**kw)
    hp = default_hyperprior_params(jspec, float(data.mean()))
    jdata = jnp.asarray(data)
    jstates = [jgibbs.init_state(jspec, hp, jdata, jax.random.PRNGKey(7 + c))
               for c in range(C)]
    jstep = jax.jit(jgibbs.gibbs_step,
                    static_argnames=("spec", "accept_all", "record"))
    tdata = torch.from_numpy(data)
    Mp = np.maximum(data, 1e-6)
    kl_atol = 1e-5 * float(np.sum(Mp * np.log(Mp)))
    ranks = set()
    for step, temp in enumerate(TEMPS):
        flags = [jspec.MH and step < 5 and WARMUP[c] for c in range(C)]
        draws = [chain_draws(jspec, s["key"]) for s in jstates]
        u = None if draws[0][0] is None else T(stack([d[0] for d in draws]))
        noise = T(stack([d[1] for d in draws]))
        A_before = [np.asarray(s["params"]["A"]) for s in jstates]
        tstate = batch_state(jstates)
        outs = []
        for c in range(C):
            jstates[c], jout = jstep(jspec, jdata, hp, jstates[c],
                                     jnp.float32(temp), flags[c])
            outs.append(np.asarray(jout["metrics"]))
        tstate, tout = tgibbs.gibbs_step(spec, tdata, hp, tstate, temp,
                                         torch.tensor(flags), u=u,
                                         noise=noise)
        got = state_to_numpy(tstate)
        rows = tout["metrics"].numpy()
        assert rows.shape == (C, tgibbs.N_METRICS)
        for c in range(C):
            want = jax.tree.map(np.asarray, jstates[c])
            check_chain(c, got, want, rows[c], outs[c], A_before[c], jspec,
                        data, kl_atol, step)
        ranks |= set(got["params"]["R"].tolist())
    if jspec.learning_rank:
        assert len(ranks) > 1, "the rank never moved"
    if jspec.MH:  # MH rejected something after the warmup steps
        assert (rows[:, 9] < 1.0).any()


# ---------------------------------------------------------------------------
# the chain axis: C chains at once equal C one-chain calls
# ---------------------------------------------------------------------------

AXIS_CASES = PATHS | {
    "fused_exponential_bfi": dict(likelihood="poisson", prior="exponential",
                                  fused_sweeps=True, learning_rank=True,
                                  rank_method="BFI"),
    "stream_truncnormal": dict(likelihood="poisson", prior="truncnormal",
                               stream_sweeps=True, learning_rank=True),
    "stream_exponential": dict(likelihood="poisson", prior="exponential",
                               stream_sweeps=True),
}


def pick_tree(tree, pick):
    """``pick`` applied to every tensor of a (nested) dict."""
    if isinstance(tree, dict):
        return {k: pick_tree(v, pick) for k, v in tree.items()}
    return pick(tree) if isinstance(tree, torch.Tensor) else tree


def port_noise(spec, gen, streams=None):
    """(u, noise) for C chains, chain-major: the stream and eager steps'
    from the chains' ``streams`` (ops/rng.ChainStreams), the rest from the
    torch generator ``gen``."""
    if spec.stream_sweeps:
        return None, tgibbs.draw_stream_noise(spec, C, streams, "cpu")
    if spec.fused_sweeps:
        u = torch.rand((C, tgibbs.n_uniforms(spec)), generator=gen)
        noise = {}
        if spec.prior == "exponential":
            noise["prior"] = {"p": torch.rand((C, 9, K, N), generator=gen),
                              "e": torch.rand((C, 9, N, G), generator=gen)}
        return u.clamp_min(1e-30), noise
    if not spec.needs_Z:
        return None, tgibbs.draw_eager_noise(spec, streams, "cpu", C)
    r = lambda *s: torch.rand((C,) + s, generator=gen).clamp_min(1e-30)  # noqa
    noise = {"prior": {"p": r(9, K, N), "e": r(9, N, G)},
             "P": r(9, K, N), "E": r(9, N, G),
             "Z": r(AL.N_PLANES, AL.n_nodes(N), K, G)}
    if spec.prior == "gamma":
        n_t = tU.n_slice_targets(spec)
        noise["prior"]["slice"] = {"e": -torch.log(r(n_t)), "u_l": r(n_t),
                                   "u_s": r(16, n_t)}
    if spec.learning_rank:
        noise |= {"R": -torch.log(-torch.log(r(N + 1))), "A": r(N)}
    return None, noise


@pytest.mark.parametrize("path", sorted(AXIS_CASES))
def test_chain_axis_equals_one_chain_calls(path):
    """Three chains in one call against three one-chain calls of the same
    step on the same state and draws (the stream step takes a batch of one
    for a chain): every output within rtol 1e-6, decisions equal; the
    streams are not drawn from but by the gamma draws' rare rejection
    rounds, which each one-chain call draws from its chain's own stream."""
    data = torch.from_numpy(sim_data(1))
    spec = ModelSpec(**(dict(K=K, N=N, G=G) | AXIS_CASES[path]))
    hp = default_hyperprior_params(spec, float(data.mean()))
    gen = torch.Generator().manual_seed(3)
    state = tgibbs.init_state(spec, hp, data, ChainStreams(3, np.arange(C)),
                              chains=C)
    flags = torch.tensor([True, False, False])
    for step in range(2):
        u, noise = port_noise(spec, gen, tgibbs.streams_of(state))
        one = []
        for c in range(C):
            pick = (lambda x: x[c:c + 1]) if spec.stream_sweeps else (
                lambda x: x[c])
            st = pick_tree(state, pick)
            st["gen"] = state["gen"].select([c])
            one.append(tgibbs.gibbs_step(
                spec, data, hp, st, 0.5, flags[c:c + 1] if spec.stream_sweeps
                else bool(flags[c]), u=None if u is None else u[c],
                noise=pick_tree(noise, pick)))
        state, out = tgibbs.gibbs_step(spec, data, hp, state, 0.5, flags,
                                       u=u, noise=noise)
        for c, (st, o) in enumerate(one):
            sel = (lambda x: x[0]) if spec.stream_sweeps else (lambda x: x)
            for group in ("params", "prior"):
                for k, v in st[group].items():
                    np.testing.assert_allclose(
                        state[group][k][c].numpy(), sel(v).numpy(),
                        rtol=1e-6, atol=1e-7, err_msg=f"{k} chain {c}")
            for k in ("acc_P", "acc_E"):
                if k in st:
                    np.testing.assert_allclose(state[k][c].numpy(),
                                               sel(st[k]).numpy(), rtol=1e-6)
            np.testing.assert_allclose(out["metrics"][c].numpy(),
                                       sel(o["metrics"]).numpy(), rtol=1e-6)
            np.testing.assert_array_equal(state["params"]["A"][c].numpy(),
                                          sel(st["params"]["A"]).numpy())


def test_lift_and_drop_are_views():
    x = torch.arange(6.0).view(2, 3)
    tree = {"a": x, "b": (x, None), "n": 3}
    up = tU.lift(tree)
    assert up["a"].shape == (1, 2, 3) and up["b"][0].shape == (1, 2, 3)
    assert up["b"][1] is None and up["n"] == 3
    assert up["a"].data_ptr() == x.data_ptr()
    down = tU.drop({"a": up["a"], "t": (up["a"], 1)})
    assert torch.equal(down["a"], x) and torch.equal(down["t"][0], x)
