"""The Gibbs engine: state construction, one step, the chunk runner, and the
tempering schedule.

Port of bayesnmf_tpu/models/gibbs.py for the six model families of the
Poisson and Normal likelihoods, on four paths,
each for one chain or for C chains at once (every state tensor with a
leading chain axis; the JAX package vmaps one chain's step, and one chain
here is a batch of one):

- fused (Poisson MH, the default there): each step draws one uniform
  tensor (a row per chain), recomputes Mhat with one batched matmul, runs
  the fused sweep (ops/fused_sweeps.py, one thread-block cluster per chain;
  with rank learning it also draws R and sweeps A) and computes the
  metrics rows; the exponential prior's Lambda update and the reference's
  conjugate Mu/Sigmasq update (``exact_truncnorm_hypers=False``) run
  before the kernel (gibbs.py:139-227);
- eager (the Normal likelihood, and Poisson MH with
  ``fused_sweeps=False``): the prior update, a fresh Mhat, the sequential
  P and E sweeps issued column by column as tensor ops over all chains
  (models/updates.sweep_P/sweep_E), with rank learning the R draw and the
  Mhat-based A sweep, and with the Normal likelihood sigmasq from the
  final Mhat (gibbs.py:241-269); no kernel runs but the exact
  truncnormal hyper-update's one launch (ops/stream_sweeps.hyper_update);
- conjugate (MH=False, the exponential or the gamma prior): the prior
  update (Lambda; or Beta, then Alpha by one slice transition), then all
  of P and all of E by conjugate gamma draws, the R draw and the
  Mhat-based A sweep when rank learning, and the latent counts' sums
  through the allocation kernel (ops/allocation.py, one grid over the
  chains; gibbs.py:159-162, 248-267);
- streaming (large G, either prior): each step runs the prior update (the
  exact truncnormal one a launch of ops/stream_sweeps.hyper_update), the
  streamed P, E and A sweeps (models/updates.py) and the metrics row (one
  kernel pair); no (C, K, G) tensor exists (gibbs.py:228-264).

Each step's random numbers come from the chains' counter-based streams
(``state['gen']``, an ops/rng.ChainStreams at the state's iteration): every
draw is chain-major, chain c's its own row in the one-chain layout of the
JAX step's keys, and a function of the seed, the chain's uid, the
iteration, the draw site and the element alone, so a chain draws the same
numbers whichever chains share its batch. ``jax.lax.scan``
becomes a Python loop that writes each step into buffers allocated once a
chunk on the device (P, E, A and the metrics rows; with ``record='full'``
also the prior parameters, sigmasq and the acceptance records, as the
reference's record_sample keeps them, bayesNMF_sampler.R:651-672); the
chunk's temperatures go to the device once, and no step
waits for the device except where a gamma draw's exact rejection loop
checks that it is done (ops/distributions.gamma), once a draw for all
chains.

On a mesh (parallel/mesh.py) the eager and conjugate steps run on this
rank's chains and columns of G: ``state['gen']`` is the rank's block of the
streams, which draws only its elements of each one-process draw, the
sweeps' sums over G are all-reduced over the g group (models/updates.py),
and each step's metrics rows take one stacked all-reduce. The fused and streaming kernels do not
partition over G and refuse a mesh, as the JAX package's do.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ModelSpec
from ..ops import distributions as dist
from ..ops import math as m
from ..ops import stream_sweeps as S
from ..ops.fused_sweeps import fused_gibbs_sweeps
from ..parallel import mesh as Mesh
from ..utils import tracing
from . import updates as U

# metrics-row layout (order matches the reference's sample_metrics columns,
# bayesNMF_sampler.R:190-207); NA_events counts MH ratios clamped NaN -> 0
# and A-sweep posteriors clamped NaN -> 1/2
METRIC_NAMES = (
    "iter", "RMSE", "KL", "loglikelihood", "logposterior", "n_params", "BIC",
    "rank", "temp", "P_mean_acceptance_rate", "E_mean_acceptance_rate",
    "NA_events",
)
N_METRICS = len(METRIC_NAMES)

_TINY = 1.2e-38


#: the JAX package's refusals of its per-chip kernels on a mesh
#: (sampler.py:176-180, ensemble.py:448-457)
FUSED_MESH_ERROR = ("fused_sweeps is a single-chip VMEM-resident kernel; use "
                    "the XLA sweep path with mesh sharding")
STREAM_MESH_ERROR = ("stream_sweeps kernels do not partition over a "
                     "G-sharded mesh; use the XLA sweep path for "
                     "mesh-sharded ensembles")


def kernel_rank_method(spec: ModelSpec):
    """The rank branch the fused kernel runs: None at a fixed rank, "SBFI"
    with the inclusion penalty, "BFI" without it (BFI, and BIC over a rank
    list; the JAX step runs the last without the SBFI penalty,
    updates.py:819, :859)."""
    if not spec.learning_rank:
        return None
    return "SBFI" if spec.rank_method == "SBFI" else "BFI"


# ---------------------------------------------------------------------------
# state construction
# ---------------------------------------------------------------------------


def init_state(spec: ModelSpec, hp: dict, data: torch.Tensor, gen,
               init_params=None, init_prior_params=None,
               chains=None) -> dict:
    """Initial state on ``data``'s device: prior parameters from the
    hyperpriors, P and E from the priors, with rank learning
    R ~ Uniform{0..N}, A_n ~ Bern(p1(R)), on the conjugate path the
    latent counts' sums, and with the Normal likelihood sigmasq from its
    conditional; iteration 1 (gibbs.py:41-92). ``gen``: the chains' streams
    (ops/rng.ChainStreams; one uid without ``chains``), which draw these
    at iteration 0; the state carries them at iteration 1. With ``chains``
    = C every tensor has a leading chain axis of C independent draws.
    ``init_params`` / ``init_prior_params`` entries override the draws (the
    same value for every chain); ``init_prior_params`` "alpha" and "beta"
    set the sigmasq prior, broadcast to length G."""
    dev = data.device
    f32 = dict(dtype=torch.float32, device=dev)
    lead = () if chains is None else (chains,)

    def override(v, dtype):
        t = torch.as_tensor(np.asarray(v, dtype), device=dev)
        return t if chains is None else t.expand(lead + t.shape).clone()

    state_gen = gen.at(1)
    gen = gen.at(0)
    prior = U.init_prior_params(spec, hp, gen, dev, chains)
    for name, v in (init_prior_params or {}).items():
        if name in ("alpha", "beta"):
            name = "Alpha_sig" if name == "alpha" else "Beta_sig"
            v = np.broadcast_to(np.asarray(v, np.float32), (spec.G,))
        prior[name] = override(v, np.float32)
    params = {"P": U._prior_draw_P(spec, prior, gen),
              "E": U._prior_draw_E(spec, prior, gen)}
    if spec.learning_rank:
        c_dim = None if chains is None else 0
        # R ~ Uniform{0..N} as floor(u (N + 1)), u in [tiny, 1)
        u = gen.uniform("R", lead + (1,), c_dim)[..., 0]
        params["R"] = torch.floor(u * (spec.N + 1)).clamp_max_(spec.N).to(
            torch.int32)
        p1 = U.prior_prob_1(params["R"].to(torch.float32), spec.N)
        u = gen.uniform("A", lead + (spec.N,), c_dim)
        params["A"] = (u < p1.unsqueeze(-1)).to(torch.float32)
    else:
        params["R"] = torch.full(lead, spec.N, dtype=torch.int32, device=dev)
        params["A"] = torch.ones(lead + (spec.N,), **f32)
    for name, v in (init_params or {}).items():
        params[name] = override(v, np.int32 if name == "R" else np.float32)
    if spec.needs_Z:
        params["Zsum_g"], params["Zsum_k"] = U.sample_Z_sums(spec, data,
                                                             params, gen)
    if spec.needs_sigmasq and "sigmasq" not in params:
        params["sigmasq"] = U.sample_sigmasq(
            spec, data, prior, m.mhat(params["P"], params["A"], params["E"]),
            gen)
    state = {"params": params, "prior": prior, "gen": state_gen, "iter": 1}
    if spec.MH:
        state["acc_P"] = torch.ones(lead + (spec.K, spec.N), **f32)
        state["acc_E"] = torch.ones(lead + (spec.N, spec.G), **f32)
    return state


def hyper_in_kernel(spec: ModelSpec) -> bool:
    """Whether the fused kernel runs the prior update: the exact truncnormal
    hyper-sweep does (gibbs.py:139-144); the exponential prior's Lambda
    update and the reference's conjugate update run before the kernel."""
    return spec.prior == "truncnormal" and spec.exact_truncnorm_hypers


def step_constants(spec: ModelSpec, hp: dict, device, chains: int = 1) -> dict:
    """Per-fit constant operands of the fused sweep for ``chains`` chains:
    for the in-kernel hyper-sweep the hyperprior planes [m, s, a, b] of
    each side (shared by the chains), for the exponential prior the unused
    second prior planes (ones), and the (3, N+1) rank pack of a fixed rank
    (zeros). The reference rebuilds them every step; here a chunk builds
    them once."""
    K, N, G = spec.K, spec.N, spec.G
    C = chains
    f32 = dict(dtype=torch.float32, device=device)
    consts = {"rank_pack": torch.zeros(C, 3, N + 1, **f32)}
    if hyper_in_kernel(spec):
        planes = lambda side, shape: torch.stack([  # noqa: E731
            torch.full(shape, float(hp[f"{k}_{side}"]), **f32)
            for k in ("m", "s", "a", "b")])
        consts["hyper_hp"] = (planes("p", (K, N)), planes("e", (N, G)))
    if spec.prior == "exponential":
        consts["ones"] = (torch.ones(C, K, N, **f32),
                          torch.ones(C, N, G, **f32))
    return consts


def n_uniforms(spec: ModelSpec) -> int:
    """Length of one fused step's flat uniform tensor (gibbs.py:175-180):
    three planes per side for the sweeps (prior fallback, proposal,
    acceptance), with rank learning 2(N+1) for the R draw's Gumbel noise and
    the A draws, and for the in-kernel hyper-sweep four planes per side."""
    n = spec.K * spec.N + spec.N * spec.G
    return (3 * n + (2 * (spec.N + 1) if spec.learning_rank else 0)
            + (4 * n if hyper_in_kernel(spec) else 0))


def _temp_tensor(temperature, device) -> torch.Tensor:
    """The temperature as a 0-d float32 tensor on ``device``; a tensor on
    the device already is used as it is (no host copy)."""
    if isinstance(temperature, torch.Tensor):
        return temperature.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(temperature), dtype=torch.float32,
                      device=device)


# ---------------------------------------------------------------------------
# one Gibbs iteration
# ---------------------------------------------------------------------------


def streams_of(state: dict):
    """The state's streams at its iteration (None where the state carries
    none: a caller that feeds every draw as noise)."""
    return _advance(state.get("gen"), state["iter"])


def _advance(gen, it: int):
    """``gen`` at iteration ``it`` (None stays None)."""
    return None if gen is None else gen.at(it)


def draw_launches(spec: ModelSpec, init: bool = False) -> int:
    """Launches of the draw kernel (ops/rng.philox_fill) a step of ``spec``'s
    path makes when it draws its own noise (``init``: the initial state's),
    besides one a round of a gamma draw's exact rejection loop
    (ops/distributions.gamma.rounds)."""
    truncnormal = spec.prior == "truncnormal"
    if init:
        # the prior parameters (two a side), P and E, R and A, sigmasq
        return (2 if spec.prior == "exponential" else 4) + 2 \
            + 2 * spec.learning_rank + spec.needs_sigmasq
    if spec.stream_sweeps:
        exact = truncnormal and spec.exact_truncnorm_hypers
        return 1 + exact + 4 * (truncnormal and not exact)
    if spec.likelihood == "poisson" and not spec.MH:
        # the prior update (Lambda, or Beta and the slice pass), P, E, R, A
        return (2 if spec.prior == "exponential" else 3) + 2 \
            + 2 * spec.learning_rank
    if not spec.fused_sweeps:
        return 1 + truncnormal
    if hyper_in_kernel(spec):
        return 1
    return 1 + (2 if spec.prior == "exponential" else 4)


def hyper_launches(spec: ModelSpec) -> int:
    """Launches of the exact hyper-update kernel
    (ops/stream_sweeps.hyper_update) a step of ``spec``'s path makes: one
    on the stream and eager paths of the truncnormal prior with
    ``exact_truncnorm_hypers``; none where the fused kernel runs the
    hyper-sweep, nor for the other priors or the conjugate update."""
    return int(spec.prior == "truncnormal" and spec.exact_truncnorm_hypers
               and not spec.fused_sweeps)


def _one_chain(step, spec, data, hp, state, temperature, accept_all,
               metric_consts, noise, **kw):
    """Run ``step`` on one chain's state (no chain axis) as a batch of one:
    the state, the noise and the uniforms gain a leading axis of 1 (views),
    and the results lose it. ``consts`` (step_constants) are a batch's
    already."""
    if kw.get("u") is not None:
        kw["u"] = U.lift(kw["u"])
    new_state, out = step(spec, data, hp, U.lift(state), temperature,
                          accept_all, metric_consts, noise=U.lift(noise),
                          **kw)
    return U.drop(new_state), U.drop(out)


def _sample_out(spec: ModelSpec, state: dict, metrics, record: str) -> dict:
    """A step's record of ``state``: P, E, A and the metrics row; with
    ``record='full'`` also the prior parameters (a dict under "prior"),
    sigmasq with the Normal likelihood and the acceptance records acc_P,
    acc_E with MH (gibbs.py:280-289)."""
    params = state["params"]
    out = {"P": params["P"], "E": params["E"], "A": params["A"],
           "metrics": metrics}
    if record == "full":
        out["prior"] = state["prior"]
        if spec.needs_sigmasq:
            out["sigmasq"] = params["sigmasq"]
        if spec.MH:
            out["acc_P"], out["acc_E"] = state["acc_P"], state["acc_E"]
    return out


def gibbs_step(spec: ModelSpec, data, hp: dict, state: dict, temperature,
               accept_all, metric_consts=None, u=None, consts=None,
               noise=None, metrics_out=None, record: str = "basic"):
    """One full Gibbs sweep; returns (new_state, sample_out).

    Every step takes one chain's state or C chains' with a leading chain
    axis on every tensor (the JAX package vmaps one chain's step; a batch of
    one runs the same code). On the streaming path this is ``stream_step``,
    on the conjugate path ``conjugate_step`` and on the eager path
    ``eager_step`` (``noise`` goes there). On the fused path the order is
    (gibbs.py:100-290): the exponential prior's Lambda update or the
    conjugate Mu/Sigmasq update (``noise`` {"prior": ...}), a fresh
    Mhat = P diag(A) E (one batched product), then inside the fused sweep
    the exact truncnormal hyper-sweep, the P sweep, the E sweep and with
    rank learning the R draw and the A sweep. ``u`` is the flat uniform
    tensor of length ``n_uniforms(spec)`` per chain ((C, n) with a chain
    axis, each chain's row laid out as at gibbs.py:175-207); when None it
    is drawn from ``state['gen']`` at site "fused". ``temperature`` is a
    float or a 0-d tensor on the device; ``accept_all`` a bool or a (C,)
    bool tensor.
    ``sample_out`` holds P, E, A and the metrics row, which goes to
    ``metrics_out`` ((C, N_METRICS), a slice of a chunk buffer) when given;
    ``record='full'`` adds what ``_sample_out`` lists.
    ``metric_consts`` and ``consts`` (step_constants of C chains, of 1 for
    one chain) are computed when not given.
    """
    if spec.stream_sweeps:
        return stream_step(spec, data, hp, state, temperature, accept_all,
                           metric_consts, noise, metrics_out, record)
    if spec.likelihood == "poisson" and not spec.MH:
        return conjugate_step(spec, data, hp, state, temperature,
                              metric_consts, noise, metrics_out, record)
    if not spec.fused_sweeps:
        return eager_step(spec, data, hp, state, temperature, accept_all,
                          metric_consts, noise, metrics_out, record)
    if Mesh.mesh_of(state["gen"]) is not None:
        raise ValueError(FUSED_MESH_ERROR)
    if state["params"]["P"].dim() == 2:
        return _one_chain(gibbs_step, spec, data, hp, state, temperature,
                          accept_all, metric_consts, noise, u=u,
                          consts=consts, record=record)
    K, N, G = spec.K, spec.N, spec.G
    dev = data.device
    gen = streams_of(state)
    params = dict(state["params"])
    prior = dict(state["prior"])
    C = params["P"].shape[0]
    if consts is None:
        consts = step_constants(spec, hp, dev, C)
    in_kernel = hyper_in_kernel(spec)
    if not in_kernel:
        with tracing.span("step.prior_update"):
            prior = U.sample_prior_params(spec, hp, params, prior, gen,
                                          noise=(noise or {}).get("prior"))

    # fresh Mhat every iteration, so the sweeps' rank-1 updates cannot
    # accumulate float32 drift over thousands of iterations
    with tracing.span("step.mhat"):
        Mh = m.mhat(params["P"], params["A"], params["E"])

    n_p, n_e = K * N, N * G
    with tracing.span("step.draws"):
        if u is None:
            u = gen.uniform("fused", (C, n_uniforms(spec))).clamp_min_(_TINY)

        def cut(off, shape):
            # a view for one chain; the kernel takes each plane contiguous,
            # so C > 1 chains' planes are gathered out of their rows
            n = int(np.prod(shape))
            return u[:, off:off + n].reshape((C,) + shape).contiguous()

        Upr_P, Up_P, Ua_P = (cut(i * n_p, (K, N)) for i in range(3))
        Upr_E, Up_E, Ua_E = (cut(3 * n_p + i * n_e, (N, G))
                             for i in range(3))
        off = 3 * (n_p + n_e)
        rank_pack = consts["rank_pack"]
        if spec.learning_rank:
            gumbel = -torch.log(-torch.log(u[:, off:off + N + 1]))
            zero = torch.zeros(C, 1, dtype=torch.float32, device=dev)
            u_A = torch.cat([u[:, off + N + 1:off + 2 * N + 1], zero], 1)
            row0 = torch.cat([_temp_tensor(temperature, dev).view(1, 1)
                              .expand(C, 1), zero.expand(C, N)], 1)
            rank_pack = torch.stack([row0, gumbel, u_A], 1)
            off += 2 * (N + 1)
        hyper_u = hyper_hp = None
        if in_kernel:
            hyper_u = (cut(off, (4, K, N)), cut(off + 4 * n_p, (4, N, G)))
            hyper_hp = consts["hyper_hp"]
    if spec.prior == "exponential":
        hp_arrays = (prior["Lambda_p"], consts["ones"][0], prior["Lambda_e"],
                     consts["ones"][1])
    else:
        hp_arrays = (prior["Mu_p"], prior["Sigmasq_p"], prior["Mu_e"],
                     prior["Sigmasq_e"])

    with tracing.span("step.fused_sweep"):
        (params["P"], params["E"], Mh, acc_P, acc_E, A_new, R_new,
         na_events, hp0_p, hp1_p, hp0_e, hp1_e) = fused_gibbs_sweeps(
            data, params["P"], params["E"], params["A"], Mh,
            state["acc_P"], state["acc_E"], Upr_P, Upr_E, Up_P, Ua_P, Up_E,
            Ua_E, *hp_arrays, rank_pack, prior_kind=spec.prior,
            exact_mh=spec.exact_mh, accept_all=accept_all,
            rank_method=kernel_rank_method(spec), hyper_u=hyper_u,
            hyper_hp=hyper_hp)
    if in_kernel:
        prior["Mu_p"], prior["Sigmasq_p"] = hp0_p, hp1_p
        prior["Mu_e"], prior["Sigmasq_e"] = hp0_e, hp1_e
    if spec.learning_rank:
        params["A"] = A_new
        params["R"] = R_new.to(torch.int32)

    new_iter = state["iter"] + 1
    new_state = {"params": params, "prior": prior,
                 "gen": _advance(gen, new_iter), "iter": new_iter,
                 "acc_P": acc_P, "acc_E": acc_E}
    with tracing.span("step.metrics_row"):
        metrics = _metrics_row(spec, data, params, prior, Mh, new_iter,
                               temperature, acc_P, acc_E, na_events,
                               metric_consts, metrics_out)
    return new_state, _sample_out(spec, new_state, metrics, record)


def draw_eager_noise(spec: ModelSpec, gen, device, chains=None) -> dict:
    """All random numbers of one eager step: one uniform draw (site
    eager_u) and one normal draw (eager_z) from the streams ``gen``, cut
    into views laid out as the JAX step draws them from its keys
    (gibbs.py:121-132, updates.py:91-203, :266-531, :776-886): the
    prior update's ({"p", "e"}: gamma planes for the exponential prior;
    {"z", "u"} for the exact truncnormal hyper-sweep; {"mu_p", "mu_e",
    "sq_p", "sq_e"} for the conjugate one), each sweep's {"prior_u", "u"},
    with rank learning the R draw's Gumbel noise and the A draws' uniforms,
    and with the Normal likelihood sigmasq's gamma planes. With ``chains``
    = C each draw is chain-major, (C, total), and every view has a leading
    chain axis: chain c's noise is row c, in the one-chain layout. On a
    mesh (``gen`` a rank's block) each view is this rank's block of the
    one-process layout's (all chains, all of G): its chains, and of the
    parts with a G axis its columns."""
    K, N = spec.K, spec.N
    G = gen.G_local or spec.G
    kn, ng = (K, N), (N, G)
    tn = (2,) if spec.prior == "truncnormal" else ()
    uni = {("P", "prior_u"): tn + kn, ("P", "u"): (3, N, K),
           ("E", "prior_u"): tn + ng, ("E", "u"): (3, N, G)}
    nrm = {}
    if spec.prior == "exponential":
        uni |= {("prior", "p"): (9,) + kn, ("prior", "e"): (9,) + ng}
    elif spec.exact_truncnorm_hypers:
        uni[("prior", "u")] = nrm[("prior", "z")] = (2 * (K * N + N * G),)
    else:
        uni |= {("prior", "sq_p"): (9,) + kn, ("prior", "sq_e"): (9,) + ng}
        nrm |= {("prior", "mu_p"): kn, ("prior", "mu_e"): ng}
    if spec.learning_rank:
        uni |= {("R",): (N + 1,), ("A",): (N,)}
    if spec.needs_sigmasq:
        uni[("sigmasq",)] = (9, G)
    C = 1 if chains is None else chains

    def segments(path, shape):
        # the part's layout in the flat draw: (rows, cols, cols are G)
        if path == ("prior", "u") or path == ("prior", "z"):
            return [(1, K * N, False), (N, G, True)] * 2
        if path[0] in ("E", "sigmasq") or path[-1] in ("e", "sq_e", "mu_e"):
            return [(int(np.prod(shape[:-1])), G, True)]
        return [(1, int(np.prod(shape)), False)]

    noise = {}
    for shapes, normal in ((uni, False), (nrm, True)):
        if not shapes:
            continue
        sizes = [int(np.prod(s)) for s in shapes.values()]
        parts = [seg for path, shape in shapes.items()
                 for seg in segments(path, shape)]
        flat = gen.flat("eager_z" if normal else "eager_u", (C,), parts,
                        normal)
        if not normal:
            flat.clamp_min_(_TINY)
        for (path, shape), part in zip(shapes.items(),
                                       torch.split(flat, sizes, 1)):
            d = noise
            for k in path[:-1]:
                d = d.setdefault(k, {})
            d[path[-1]] = part.view((C,) + shape)
    if spec.learning_rank:
        noise["R"] = dist.gumbel_from_u(noise["R"])
    return noise if chains is not None else U.drop(noise)


def eager_step(spec: ModelSpec, data, hp: dict, state: dict, temperature,
               accept_all, metric_consts=None, noise=None, metrics_out=None,
               record: str = "basic"):
    """One Gibbs iteration on the eager path (gibbs.py:100-290): the prior
    update, a fresh Mhat, the P sweep and the E sweep (Normal conjugate
    draws, or Poisson MH with ``accept_all`` during warmup), with rank
    learning the R draw and the A sweep, with the Normal likelihood sigmasq
    from the final Mhat, then the metrics row; for one chain or C chains at
    once (see gibbs_step). ``noise`` (draw_eager_noise's layout) is drawn
    from ``state['gen']`` when None; a part it lacks comes from the
    streams too. Nothing waits for the device except the gamma draws'
    rejection loops (ops/distributions.gamma), one wait a draw for all C."""
    if state["params"]["P"].dim() == 2:
        return _one_chain(eager_step, spec, data, hp, state, temperature,
                          accept_all, metric_consts, noise, record=record)
    gen = streams_of(state)
    params = dict(state["params"])
    C = params["P"].shape[0]
    if noise is None:
        noise = draw_eager_noise(spec, gen, data.device, C)
    prior = U.sample_prior_params(spec, hp, params, state["prior"], gen,
                                  noise=noise.get("prior"))
    Mh = m.mhat(params["P"], params["A"], params["E"])
    params["P"], Mh, acc_P, nan_P = U.sweep_P(
        spec, data, params, prior, Mh, state.get("acc_P"), accept_all, gen,
        noise.get("P"))
    params["E"], Mh, acc_E, nan_E = U.sweep_E(
        spec, data, params, prior, Mh, state.get("acc_E"), accept_all, gen,
        noise.get("E"))
    mesh = Mesh.mesh_of(gen)
    # on a mesh the E side's count is of this rank's columns: the metrics
    # row adds the g group's
    na_events, na_local = ((nan_P + nan_E, None) if mesh is None
                           else (nan_P, nan_E))
    if spec.learning_rank:
        params["R"] = U.sample_R(spec, params["A"], temperature, gen,
                                 gumbel=noise.get("R"))
        params["A"], Mh, nan_A = U.sweep_A(
            spec, data, params, params["R"], Mh, temperature, gen,
            u=noise.get("A"))
        na_events = na_events + nan_A
    if spec.needs_sigmasq:
        params["sigmasq"] = U.sample_sigmasq(spec, data, prior, Mh, gen,
                                             u=noise.get("sigmasq"))
    new_iter = state["iter"] + 1
    new_state = {"params": params, "prior": prior,
                 "gen": _advance(gen, new_iter), "iter": new_iter}
    if spec.MH:
        new_state |= {"acc_P": acc_P, "acc_E": acc_E}
    metrics = _metrics_row(spec, data, params, prior, Mh, new_iter,
                           temperature, acc_P, acc_E, na_events,
                           metric_consts, metrics_out, mesh, na_local)
    return new_state, _sample_out(spec, new_state, metrics, record)


def conjugate_step(spec: ModelSpec, data, hp: dict, state: dict, temperature,
                   metric_consts=None, noise=None, metrics_out=None,
                   record: str = "basic"):
    """One conjugate Poisson-Gibbs iteration (MH=False; gibbs.py:100-290):
    the prior update (the exponential prior's Lambda, or the gamma prior's
    Beta and Alpha), then P and E given the latent counts, with rank
    learning the R draw and the Mhat-based A sweep, then the new latent
    counts' sums through the allocation kernel (its grid has the chain
    axis); for one chain or C chains at once. ``noise`` may hold each
    draw's random numbers as the JAX step draws them from its keys:
    {"prior", "P", "E", "R", "A", "Z"} (the prior update's, in the layout
    ``updates.sample_prior_params`` takes; the gamma planes of P and E, the
    Gumbel noise, the A uniforms, the allocation planes), chain-major with
    a chain axis; what it lacks comes from ``state['gen']``."""
    if state["params"]["P"].dim() == 2:
        return _one_chain(
            lambda sp, d, h, st, t, _a, mc, noise: conjugate_step(
                sp, d, h, st, t, mc, noise, record=record),
            spec, data, hp, state, temperature, None, metric_consts, noise)
    gen = streams_of(state)
    noise = noise or {}
    params = dict(state["params"])
    prior = U.sample_prior_params(spec, hp, params, state["prior"], gen,
                                  noise=noise.get("prior"))
    params["P"] = U.sample_P_poisson_gibbs(spec, prior, params, gen,
                                           u=noise.get("P"))
    params["E"] = U.sample_E_poisson_gibbs(spec, prior, params, params["P"],
                                           gen, u=noise.get("E"))
    Mh = m.mhat(params["P"], params["A"], params["E"])
    na_events = 0.0  # no MH ratios on this path
    if spec.learning_rank:
        params["R"] = U.sample_R(spec, params["A"], temperature, gen,
                                 gumbel=noise.get("R"))
        params["A"], Mh, na_events = U.sweep_A(
            spec, data, params, params["R"], Mh, temperature, gen,
            u=noise.get("A"))
    params["Zsum_g"], params["Zsum_k"] = U.sample_Z_sums(
        spec, data, params, gen, u=noise.get("Z"))
    new_iter = state["iter"] + 1
    new_state = {"params": params, "prior": prior,
                 "gen": _advance(gen, new_iter), "iter": new_iter}
    metrics = _metrics_row(spec, data, params, prior, Mh, new_iter,
                           temperature, None, None, na_events, metric_consts,
                           metrics_out, Mesh.mesh_of(gen))
    return new_state, _sample_out(spec, new_state, metrics, record)


def _fill(col, v):
    """col[:] = v without a host wait: a device tensor is copied on the
    device, a host number is passed to a fill kernel (``col[:] = x`` would
    copy it from host memory and wait for the device)."""
    if isinstance(v, torch.Tensor):
        col.copy_(v.expand_as(col))
    else:
        col.fill_(float(v))


def _metrics_row(spec, data, params, prior, Mh, it, temperature, acc_P,
                 acc_E, na_events=0.0, consts=None, out=None, mesh=None,
                 na_local=None):
    """Per-iteration metrics (compute_metrics_, utils.R:412-455) from Mhat
    (gibbs.py:293-347) for C chains at once, every sum taken per chain:
    the Poisson or Normal loglik (the latter with the state's sigmasq), the
    padded KL; the acceptance rates are 1 without MH. ``it`` is a host
    number, ``temperature`` a host number or a device tensor, ``na_events``
    a number or a (C,) tensor; everything else stays on the device. The
    (C, N_METRICS) rows go to ``out`` when given. On a mesh the data, Mhat
    and E are this rank's columns of G and ``na_local`` a count over them:
    with a split G every sum over G is a partial, and all of them go out
    stacked in one all-reduce over the g group."""
    if consts is None:
        consts = m.metric_constants(spec.likelihood, data, mesh)
    s2 = (-2, -1)
    # one log(max(Mhat, floor)) pass feeds both the loglik and the padded
    # KL (the floors coincide: MHAT_FLOOR == the KL pad, 1e-6)
    lam = Mh.clamp_min(m.MHAT_FLOOR)
    L = torch.log(lam)
    if spec.likelihood == "poisson":
        ll_sum = torch.sum(data * L, s2) - torch.sum(lam, s2)
    else:
        ll_sum = torch.sum(m.normal_loglik_mat(
            data, Mh, params["sigmasq"].unsqueeze(-2)), s2)
    kl_sum = torch.sum(data.clamp_min(1e-6) * L, s2)
    lp, le = m.logprior_parts(params["P"], params["E"], spec.prior, prior)
    A = params["A"]
    C = A.shape[0]
    d = Mh - data
    acc_e = torch.sum(acc_E * A.unsqueeze(-1), s2) if spec.MH else None
    if mesh is not None and mesh.n_g > 1:
        zero = torch.zeros(C, dtype=torch.float32, device=data.device)
        ll_sum, kl_sum, le, ssq, acc_e, na_g = Mesh.g_all_reduce(
            torch.stack([ll_sum, kl_sum, le, torch.sum(d * d, s2),
                         zero if acc_e is None else acc_e,
                         zero if na_local is None else na_local], -1),
            mesh).unbind(-1)
        rmse = torch.sqrt(ssq / float(spec.K * spec.G))
        na_events = na_events + na_g
    else:
        rmse = torch.sqrt(torch.mean(d * d, s2))
        if na_local is not None:
            na_events = na_events + na_local
    loglik = (ll_sum - consts["lgamma_sum"] if spec.likelihood == "poisson"
              else ll_sum)
    kl = consts["mlogm_sum"] - kl_sum
    logpost = loglik + (lp + le)
    n_par = m.n_params_of(A, spec.K, spec.G)
    sum_a = torch.sum(A, -1)
    row = (torch.empty(C, N_METRICS, dtype=torch.float32, device=data.device)
           if out is None else out)
    _fill(row[:, 0], it)
    row[:, 1:8] = torch.stack([rmse, kl, loglik, logpost, n_par,
                               m.bic(loglik, n_par, spec.G), sum_a], -1)
    _fill(row[:, 8], temperature)
    if spec.MH:
        row[:, 9:11] = torch.stack([
            torch.sum(acc_P * A.unsqueeze(-2), s2)
            / (sum_a * spec.K).clamp_min(1),
            acc_e / (sum_a * spec.G).clamp_min(1)], -1)
    else:
        row[:, 9:11].fill_(1.0)
    _fill(row[:, 11], na_events)
    return row


def snapshot_sample(spec: ModelSpec, data, state: dict, temperature,
                    record: str = "basic") -> dict:
    """Sample record of the current state without advancing the chain (the
    initial sample, bayesNMF_sampler.R:240-257; gibbs.py:362-375), for one
    chain or C."""
    params = state["params"]
    if params["P"].dim() == 2:
        return U.drop(snapshot_sample(spec, data, U.lift(state),
                                      temperature, record))
    Mh = m.mhat(params["P"], params["A"], params["E"])
    metrics = _metrics_row(spec, data, params, state["prior"], Mh,
                           state["iter"], temperature, state.get("acc_P"),
                           state.get("acc_E"),
                           mesh=Mesh.mesh_of(state["gen"]))
    return _sample_out(spec, state, metrics, record)


# ---------------------------------------------------------------------------
# the streaming step (chain ensembles)
# ---------------------------------------------------------------------------


def draw_stream_noise(spec: ModelSpec, chains: int, gen, device) -> dict:
    """All random numbers of one streaming step for ``chains`` chains: one
    chain-major uniform draw (site stream_u) and, for the exact hyper-sweep,
    one normal draw (stream_z) from the streams ``gen``, cut into views laid
    out as the JAX step draws them from its keys (gibbs.py:121-132): the
    exponential prior's gamma planes or the exact hyper-sweep's noise, each
    sweep's prior-draw uniforms and column uniforms, and with rank learning
    the Gumbel noise and the A uniforms."""
    K, N, G = spec.K, spec.N, spec.G
    expo = spec.prior == "exponential"
    # the reference's conjugate hyper-update draws its own
    nh = (U.n_hyper_noise(spec) if spec.exact_truncnorm_hypers and not expo
          else 0)
    tn = () if expo else (2,)
    shapes = {"prior": (nh,), "P_prior": tn + (K, N), "P": (3, N, K),
              "E_prior": tn + (N, G), "E": (3, N, G)}
    if expo:
        shapes |= {"Lambda_p": (9, K, N), "Lambda_e": (9, N, G)}
    if spec.learning_rank:
        shapes |= {"R": (N + 1,), "A": (N,)}
    sizes = {k: int(np.prod(s)) for k, s in shapes.items()}
    u = gen.uniform("stream_u", (chains, sum(sizes.values()))).clamp_min_(
        _TINY)
    views, off = {}, 0
    for k, s in shapes.items():
        views[k] = u[:, off:off + sizes[k]].view((chains,) + s)
        off += sizes[k]
    noise = {
        "P": {"prior_u": views["P_prior"], "u": views["P"]},
        "E": {"prior_u": views["E_prior"], "u": views["E"]},
    }
    if expo:
        noise["prior"] = {"p": views["Lambda_p"], "e": views["Lambda_e"]}
    elif spec.exact_truncnorm_hypers:
        noise["prior"] = {"z": gen.normal("stream_z", (chains, nh)),
                          "u": views["prior"]}
    if spec.learning_rank:
        noise["R"] = -torch.log(-torch.log(views["R"]))
        noise["A"] = views["A"]
    return noise


def stream_step(spec: ModelSpec, data, hp: dict, state: dict, temperature,
                accept_all, metric_consts=None, noise=None, metrics_out=None,
                record: str = "basic"):
    """One Gibbs iteration of every chain on the streaming path
    (gibbs.py:228-264): the prior update (Mu/Sigmasq, or the exponential
    prior's Lambda on the (C, K, N) and (C, N, G) planes), the P and E
    sweeps, and with rank learning the R draw and the A sweep, then the
    metrics row from the state by one call of
    ops/stream_sweeps.stream_metrics_row (no Mhat, no P*A and no host
    arithmetic on the state). State tensors carry the chain axis C;
    ``accept_all`` is a (C,) bool tensor; ``noise``
    (draw_stream_noise's layout) is drawn from ``state['gen']`` when None;
    ``metrics_out``, a (C, N_METRICS) slice of a chunk buffer, takes the
    rows when given. Returns (new_state, sample_out) with sample_out P
    (C, K, N), E (C, N, G), A (C, N), metrics (C, N_METRICS), and with
    ``record='full'`` the prior parameters and acc_P (C, K, N), acc_E
    (C, N, G).
    """
    if Mesh.mesh_of(state["gen"]) is not None:
        raise ValueError(STREAM_MESH_ERROR)
    gen = streams_of(state)
    params = dict(state["params"])
    C = params["P"].shape[0]
    if noise is None:
        with tracing.span("step.draws"):
            noise = draw_stream_noise(spec, C, gen, data.device)
    if metric_consts is None:
        metric_consts = m.metric_constants(spec.likelihood, data)
    with tracing.span("step.prior_update"):
        prior = U.sample_prior_params(spec, hp, params, state["prior"], gen,
                                      noise=noise.get("prior"))
    with tracing.span("step.sweep_P"):
        params["P"], acc_P, nan_P = U.stream_sweep_P(
            spec, data, params, prior, state["acc_P"], accept_all,
            noise=noise["P"])
    with tracing.span("step.sweep_E"):
        params["E"], acc_E, nan_E = U.stream_sweep_E(
            spec, data, params, prior, state["acc_E"], accept_all,
            noise=noise["E"])
    na_events = nan_P + nan_E
    if spec.learning_rank:
        with tracing.span("step.rank"):
            params["R"] = U.sample_R(spec, params["A"], temperature,
                                     gumbel=noise["R"])
            params["A"], nan_A = U.stream_sweep_A(
                spec, data, params, params["R"], temperature, u=noise["A"])
            na_events = na_events + nan_A
    new_iter = state["iter"] + 1
    new_state = {"params": params, "prior": prior,
                 "gen": _advance(gen, new_iter), "iter": new_iter,
                 "acc_P": acc_P, "acc_E": acc_E}
    with tracing.span("step.metrics_row"):
        hp_p, hp_e = (U._stream_prior(spec, prior, side) for side in "pe")
        metrics = S.stream_metrics_row(
            data, params["P"], params["E"], params["A"], acc_P, acc_E,
            *hp_p, *hp_e, metric_consts["lgamma_sum"],
            metric_consts["mlogm_sum"], na_events, new_iter, temperature,
            out=metrics_out, prior=spec.prior)
    return new_state, _sample_out(spec, new_state, metrics, record)


# ---------------------------------------------------------------------------
# chunk runner
# ---------------------------------------------------------------------------


def record_buffers(sample: dict, steps: int, axis: int) -> dict:
    """Empty device buffers for ``steps`` records shaped like ``sample`` (a
    step's sample_out, nested dicts of tensors), the step axis inserted at
    ``axis`` (0 for one chain, 1 after the chain axis)."""
    if isinstance(sample, dict):
        return {k: record_buffers(v, steps, axis) for k, v in sample.items()}
    shape = sample.shape[:axis] + (steps,) + sample.shape[axis:]
    return torch.empty(shape, dtype=sample.dtype, device=sample.device)


def write_record(bufs: dict, sample: dict, i: int, axis: int):
    """Copy every tensor of ``sample`` into slot ``i`` of its buffer."""
    for k, buf in bufs.items():
        if isinstance(buf, dict):
            write_record(buf, sample[k], i, axis)
        else:
            buf.select(axis, i).copy_(sample[k])


def run_chunk(spec: ModelSpec, data, hp: dict, state: dict, temps,
              accept_all: bool, record: str = "basic"):
    """Run ``len(temps)`` Gibbs iterations (the reference's lax.scan).

    Returns (state, samples): ``samples['metrics']`` is (steps, N_METRICS)
    and ``samples['P'/'E'/'A']`` stack the per-iteration draws, with
    ``record='full'`` also the prior parameters (a dict under "prior"),
    sigmasq and acc_P/acc_E (gibbs.py:280-289), all in buffers allocated
    once a chunk on the device. On a mesh the state and the records are
    this rank's block (parallel/mesh.sample_out_layout).
    """
    steps = len(temps)
    dev = data.device
    metric_consts = m.metric_constants(spec.likelihood, data,
                                       Mesh.mesh_of(state["gen"]))
    consts = step_constants(spec, hp, dev) if spec.fused_sweeps else None
    # the chunk's temperatures go to the device once; each step indexes them
    temps = torch.as_tensor(np.asarray(temps, np.float32), device=dev)
    out = None
    for i in range(steps):
        state, sample = gibbs_step(spec, data, hp, state, temps[i],
                                   accept_all, metric_consts, consts=consts,
                                   record=record)
        if out is None:
            out = record_buffers(sample, steps, 0)
        write_record(out, sample, i, 0)
    return state, out


# ---------------------------------------------------------------------------
# tempering schedule (get_temp_sched_, utils.R:307-332)
# ---------------------------------------------------------------------------


def temp_schedule(length: int, n_temp: int,
                  rng: np.random.Generator | None = None):
    """Log-spaced temperature ladder 0 -> 1 over ~n_temp iterations, padded
    with 1s, including the 374-level ladder constant and the sorted random
    subsample when the ladder exceeds ``n_temp`` (gibbs.py:410-432)."""
    if rng is None:
        rng = np.random.default_rng(0)
    nX = max(int(round(n_temp / 374)), 1)
    sched = [0.0] * nX
    for x in range(9, 4, -1):
        sched += [10.0 ** (-x)] * nX
    sched += [1e-4] * int(round(8 * nX))
    for y in range(4, 0, -1):
        for x in np.arange(0.0, 8.95, 0.1):
            sched += [(1.0 + x) * 10.0 ** (-y)] * nX
    sched = np.asarray(sched, np.float64)
    if len(sched) > n_temp:
        sched = np.sort(rng.choice(sched, size=n_temp, replace=False))
    pad = max(length - len(sched), 0)
    out = np.concatenate([sched, np.ones(pad)])[:length]
    return out.astype(np.float32)
