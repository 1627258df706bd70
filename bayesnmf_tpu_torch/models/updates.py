"""Gibbs conditional updates of the port.

Port of bayesnmf_tpu/models/updates.py:

- initial draws: ``init_prior_params`` (:62-88, with the Normal
  likelihood's fixed sigmasq prior), ``_prior_draw_P/E`` (:244-258);
- ``sample_prior_params`` (:91-235): the exact TruncNormal hyper-update,
  which on the streaming and eager paths is the one-launch kernel of
  ops/stream_sweeps.hyper_update (the fused kernel carries its own copy),
  the reference's conjugate update (``exact_truncnorm_hypers=False``), the
  exponential prior's Lambda ~ Gamma(a + 1, b + x), and the gamma prior's
  Beta ~ Gamma(a + Alpha, b + x) then Alpha by one slice transition of
  both sides at once;
- the eager sequential sweeps ``sweep_P``/``sweep_E`` (:266-531): the
  Normal likelihood's conjugate column draws and Poisson MH
  with the exact or the reference Hastings ratio, issued column by column
  as tensor ops (no kernel: the JAX package runs them in XLA), and
  ``sample_sigmasq`` (:880-886);
- the conjugate Poisson-Gibbs draws ``sample_P_poisson_gibbs`` /
  ``sample_E_poisson_gibbs`` (:733-762) and ``sample_Z_sums`` (:894-905),
  whose allocation is the kernel of ops/allocation.py;
- rank learning: ``prior_prob_1`` and ``sample_R`` (:770-783), the
  Mhat-based ``sweep_A`` (:786-835) of the conjugate and eager paths, for
  either likelihood, and ``stream_sweep_A`` (:838-872);
- the streaming sweeps ``stream_sweep_P``/``stream_sweep_E`` (:539-725)
  with either prior, whose column updates are the kernels of
  ops/stream_sweeps.py.

Every function takes C chains at once, each per-chain tensor with a
leading chain axis (the streaming ones only so); those the single-chain
sampler calls take one chain's tensors too, as a batch of one (``lift``,
``drop``). ``accept_all`` is a bool or a (C,) bool tensor, and every
branch on device data is a ``torch.where``, so no call waits for the
device but the gamma draws' rejection check. Each function takes its
random numbers as optional ``noise`` operands laid out as the JAX function
draws them from its key (the tests feed it the JAX draws); when ``noise``
is None they come from ``gen``, the chains' random streams
(ops/rng.ChainStreams), each draw at its own site.

On a mesh (parallel/mesh.py) ``gen`` is a rank's block of the streams: the
tensors with a G axis are this rank's columns, every draw gives each of
its elements the value of the one-process draw, and each sum over G (the
P sweep's, the A sweep's deltas, the P draw's rate, Zsum_g) is a local sum
all-reduced over the g group, so that the P side comes out alike on every
rank of the group.
"""

from __future__ import annotations

import torch

from ..config import ModelSpec
from ..ops import distributions as dist
from ..ops import math as m
from ..ops import stream_sweeps as S
from ..ops.allocation import allocate_counts
from ..parallel import mesh as Mesh

_U_MIN = 1.2e-38   # minval of the JAX package's sweep uniforms
_EPS = 1e-30       # floor of an exponential conditional's precision


def _full(hp, name, shape, device):
    """Hyperprior entry broadcast to ``shape`` as float32."""
    return torch.full(shape, float(hp[name]), dtype=torch.float32,
                      device=device)


def _rand(gen, site, shape, g=False, c_dim=0):
    """Uniforms of ``shape`` at ``site`` (dim ``c_dim`` the chains, None
    for one chain without the axis; with ``g`` the last dim G), in
    [1.2e-38, 1)."""
    return gen.uniform(site, shape, c_dim, g).clamp_min_(_U_MIN)


def _flat(gen, site, lead, parts, chained, normal=False):
    """``gen.flat`` of ``lead + (T,)``: with ``chained`` lead[0] is the
    chain axis, else the draw is one chain's (as a batch of one)."""
    if chained:
        return gen.flat(site, lead, parts, normal)
    return gen.flat(site, (1,) + tuple(lead), parts, normal)[0]


def lift(x):
    """One chain's operands as a batch of one: every tensor of ``x`` (a
    tensor, or tuples and nested dicts of them) gains a leading chain axis
    of 1 (a view); anything else is returned as it is."""
    if isinstance(x, tuple):
        return tuple(lift(v) for v in x)
    if isinstance(x, dict):
        return {k: lift(v) for k, v in x.items()}
    return x.unsqueeze(0) if isinstance(x, torch.Tensor) else x


def drop(x):
    """The inverse of ``lift`` on results: chain 0 of every tensor of ``x``
    (a tensor, or tuples and nested dicts of them)."""
    if isinstance(x, tuple):
        return tuple(drop(v) for v in x)
    if isinstance(x, dict):
        return {k: drop(v) for k, v in x.items()}
    return x[0] if isinstance(x, torch.Tensor) else x


# ---------------------------------------------------------------------------
# initial draws
# ---------------------------------------------------------------------------


def init_prior_params(spec: ModelSpec, hp: dict, gen, device,
                      chains=None) -> dict:
    """Draw the prior parameters of P and E from their hyperpriors
    (init_prior_params_, sample_priors.R:15-141): Mu/Sigmasq for the
    truncnormal prior, Lambda ~ Gamma(a, b) for the exponential one,
    Beta ~ Gamma(a, b) and Alpha ~ Gamma(c, d) for the gamma one; with
    the Normal likelihood also the fixed InvGamma(alpha, beta) prior of
    sigmasq, length G, default 3/3 (bayesNMF_sampler.R:222-230), never
    resampled; with ``chains`` = C, one draw per chain on a leading axis."""
    lead = () if chains is None else (chains,)
    kn, ng = lead + (spec.K, spec.N), lead + (spec.N, spec.G)
    kw = dict(chain_axis=chains is not None)
    if spec.prior == "gamma":
        prior = {}
        for side, shape in (("p", kn), ("e", ng)):
            for name, (a, b) in (("Beta", "ab"), ("Alpha", "cd")):
                prior[f"{name}_{side}"] = dist.gamma(
                    gen, _full(hp, f"{a}_{side}", shape, device),
                    _full(hp, f"{b}_{side}", shape, device),
                    site=f"{name.lower()}_{side}", g=side == "e", **kw)
    elif spec.prior == "exponential":
        prior = {
            "Lambda_p": dist.gamma(gen, _full(hp, "a_p", kn, device),
                                   _full(hp, "b_p", kn, device),
                                   site="lambda_p", **kw),
            "Lambda_e": dist.gamma(gen, _full(hp, "a_e", ng, device),
                                   _full(hp, "b_e", ng, device),
                                   site="lambda_e", g=True, **kw),
        }
    else:
        prior = {
            "Mu_p": dist.normal(gen, _full(hp, "m_p", kn, device),
                                _full(hp, "s_p", kn, device),
                                site="mu_p", **kw),
            "Sigmasq_p": dist.inv_gamma(gen, _full(hp, "a_p", kn, device),
                                        _full(hp, "b_p", kn, device),
                                        site="sq_p", **kw),
            "Mu_e": dist.normal(gen, _full(hp, "m_e", ng, device),
                                _full(hp, "s_e", ng, device),
                                site="mu_e", g=True, **kw),
            "Sigmasq_e": dist.inv_gamma(gen, _full(hp, "a_e", ng, device),
                                        _full(hp, "b_e", ng, device),
                                        site="sq_e", g=True, **kw),
        }
    if spec.likelihood == "normal":
        for name, key in (("Alpha_sig", "alpha"), ("Beta_sig", "beta")):
            prior[name] = torch.full(lead + (spec.G,),
                                     float(hp.get(key, 3.0)),
                                     dtype=torch.float32, device=device)
    return prior


def _prior_draw(spec: ModelSpec, prior: dict, gen, u, side: str):
    """A full P (``side`` "p") or E ("e") from the prior; drawn at site
    prior_P / prior_E when ``u`` is None."""
    site = "prior_" + side.upper()
    first = {"gamma": "Alpha_", "exponential": "Lambda_"}.get(spec.prior,
                                                              "Mu_")
    kw = dict(chain_axis=prior[first + side].dim() == 3, g=side == "e")
    if spec.prior == "gamma":
        return dist.gamma(gen, prior[f"Alpha_{side}"], prior[f"Beta_{side}"],
                          u=u, site=site, **kw)
    if spec.prior == "exponential":
        return dist.exponential(gen, prior[f"Lambda_{side}"], u=u, site=site,
                                **kw)
    mu, sq = prior[f"Mu_{side}"], prior[f"Sigmasq_{side}"]
    if u is None:
        return dist.truncnorm_nonneg(gen, mu, sq, site, **kw)
    return dist.truncnorm_nonneg_from_u(u.select(-3, 0), u.select(-3, 1),
                                        mu, sq)


def _prior_draw_P(spec: ModelSpec, prior: dict, gen, u=None):
    """A full P from the prior (sample_Pn.R:12-29); ``u``: for the
    truncnormal prior the two uniform planes on dim -3 (the JAX draw's
    (2, K, N), with the chain axis first), for the exponential prior the
    one plane of jax.random.exponential's uniforms, for the gamma prior the
    gamma draw's planes (9, K, N), or (C, 9, K, N); drawn from ``gen`` at
    site prior_P when None."""
    return _prior_draw(spec, prior, gen, u, "p")


def _prior_draw_E(spec: ModelSpec, prior: dict, gen, u=None):
    """_prior_draw_P's mirror for E (site prior_E)."""
    return _prior_draw(spec, prior, gen, u, "e")


# ---------------------------------------------------------------------------
# the exact TruncNormal hyper-update (truncnormal + exact_truncnorm_hypers)
# ---------------------------------------------------------------------------


def n_hyper_noise(spec: ModelSpec) -> int:
    """Length of one chain's normal (and uniform) draw for the hyper-update:
    two per element of (K, N) and of (N, G)."""
    return 2 * (spec.K * spec.N + spec.N * spec.G)


def _sample_lambda(spec: ModelSpec, hp: dict, params: dict, prior: dict,
                   gen, noise) -> dict:
    """Lambda | x ~ Gamma(a + 1, b + x) for both sides (sample_priors.R:
    284-308, updates.py:196-203). ``noise``: {"p": ..., "e": ...}, the
    gamma draws' uniform planes (9,) + shape as the JAX function draws them
    from split(key, 4)[0] and [1], with a leading chain axis (C, 9) + shape
    when P and E carry one."""
    P, E = params["P"], params["E"]
    noise = noise or {}
    new = dict(prior)
    for side, x in (("p", P), ("e", E)):
        new[f"Lambda_{side}"] = dist.gamma(
            gen, torch.full_like(x, float(hp[f"a_{side}"])) + 1.0,
            torch.full_like(x, float(hp[f"b_{side}"])) + x,
            u=noise.get(side), chain_axis=x.dim() == 3, g=side == "e",
            site=f"lambda_{side}")
    return new


def n_slice_targets(spec: ModelSpec) -> int:
    """Targets of the gamma prior's slice pass, per chain: Alpha_p's K*N
    then Alpha_e's N*G."""
    return spec.K * spec.N + spec.N * spec.G


def _sample_gamma_prior(spec: ModelSpec, hp: dict, params: dict,
                        prior: dict, gen, noise) -> dict:
    """The gamma prior's update (sample_priors.R:323-397; updates.py:
    204-235): Beta | Alpha, x ~ Gamma(a + Alpha, b + x) for both sides,
    then Alpha | Beta, x by one slice transition on
    gamma_shape_cond_logpdf. The two Alpha sides are independent given the
    Betas, so one slice pass runs over both, flattened and concatenated
    per chain (Alpha_p's K*N targets, then Alpha_e's N*G): each op of the
    slice sampler is one launch for both sides, and the result is the JAX
    package's, which updates Beta_p, Alpha_p, Beta_e, Alpha_e in turn.
    ``noise``: {"p", "e"}: the Beta draws' gamma planes (9,) + shape as
    the JAX function draws them from split(key, 4)[0] and [2]; "slice":
    {"e", "u_l"} (n_slice_targets,) and {"u_s"} (16, n_slice_targets),
    each side's part its slice of the last axis, as the JAX slice sampler
    draws them from split(key, 4)[1] and [3]; with a leading chain axis on
    P and E, every operand has one ((C, 9) + shape, (C, T), (C, 16, T))."""
    P, E = params["P"], params["E"]
    noise = noise or {}
    lead = P.shape[:-2]
    chained = P.dim() == 3
    new = dict(prior)
    for side, x in (("p", P), ("e", E)):
        new[f"Beta_{side}"] = dist.gamma(
            gen, torch.full_like(x, float(hp[f"a_{side}"]))
            + prior[f"Alpha_{side}"],
            torch.full_like(x, float(hp[f"b_{side}"])) + x,
            u=noise.get(side), chain_axis=chained, g=side == "e",
            site=f"beta_{side}")

    def flat_pair(p, e):
        return torch.cat([p.reshape(lead + (-1,)), e.reshape(lead + (-1,))],
                         -1)

    n_p = spec.K * spec.N
    n_t = n_p + E.shape[-2] * E.shape[-1]   # this rank's E block on a mesh
    dev = P.device

    def hyper(name):  # the hyperprior constant of both sides, (T,)
        return torch.cat([
            torch.full((n_p,), float(hp[f"{name}_p"]), device=dev),
            torch.full((n_t - n_p,), float(hp[f"{name}_e"]), device=dev)])

    sl = noise.get("slice")
    if sl is None:
        u = _flat(gen, "slice", lead + (18,),
                  [(1, n_p, False), (spec.N, E.shape[-1], True)], chained)
        sl = {"e": -torch.log1p(-u.select(-2, 0)), "u_l": u.select(-2, 1),
              "u_s": u.narrow(-2, 2, 16)}
    alpha = dist.slice_sample_logconcave(
        flat_pair(prior["Alpha_p"], prior["Alpha_e"]), dist._gamma_shape_cond,
        (hyper("c") - 1.0, hyper("d"),
         torch.log(flat_pair(new["Beta_p"], new["Beta_e"]).clamp_min(_EPS)),
         torch.log(flat_pair(P, E).clamp_min(_EPS))),
        sl["e"], sl["u_l"], sl["u_s"], chain_axis=chained)
    new["Alpha_p"] = alpha[..., :n_p].unflatten(-1, P.shape[-2:])
    new["Alpha_e"] = alpha[..., n_p:].unflatten(-1, E.shape[-2:])
    return new


def _sample_truncnorm_conjugate(hp: dict, params: dict, prior: dict, gen,
                                noise) -> dict:
    """The reference's Mu/Sigmasq update, plain conjugates that drop the
    truncation normaliser (sample_priors.R:214-270, with sd = sqrt(var) and
    the B_e rate corrected; updates.py:182-195). ``noise``: {"mu_p",
    "mu_e"}: the standard normals, shaped as P and E; {"sq_p", "sq_e"}: the
    inverse-gamma draws' uniform planes (9,) + shape, as the JAX function
    draws them from split(key, 4); with a chain axis on P and E, every
    operand has one ((C, 9) + shape for the planes)."""
    noise = noise or {}
    new = dict(prior)
    dev = params["P"].device

    def h(name):  # float32 operands, as the JAX package broadcasts them
        return torch.full((), float(hp[name]), dtype=torch.float32,
                          device=dev)

    for side, x in (("p", params["P"]), ("e", params["E"])):
        sq = prior[f"Sigmasq_{side}"]
        s0 = h(f"s_{side}")
        num = h(f"m_{side}") / s0 + x / sq
        den = 1.0 / s0 + 1.0 / sq
        mu = dist.normal(gen, num / den, 1.0 / den,
                         z=noise.get(f"mu_{side}"),
                         chain_axis=x.dim() == 3, g=side == "e",
                         site=f"mu_{side}")
        d = x - mu
        new[f"Mu_{side}"] = mu
        new[f"Sigmasq_{side}"] = dist.inv_gamma(
            gen, h(f"a_{side}") + 0.5, h(f"b_{side}") + 0.5 * d * d,
            u=noise.get(f"sq_{side}"), chain_axis=x.dim() == 3,
            g=side == "e", site=f"sq_{side}")
    return new


def _exact_hypers(spec: ModelSpec, hp: dict, params: dict, prior: dict,
                  gen, noise) -> dict:
    """The exact sweep over Mu/Sigmasq of P and E of C chains (P (C, K, N),
    E (C, N, G)) by ops/stream_sweeps.hyper_update: one kernel launch on
    the card, its plain PyTorch version on the CPU. The noise is drawn at
    sites hyper_z and hyper_u when None."""
    P, E = params["P"], params["E"]
    if noise is None:
        N, G = spec.N, E.shape[-1]   # G: this rank's block on a mesh
        parts = [(1, spec.K * N, False), (N, G, True)] * 2
        noise = {"z": _flat(gen, "hyper_z", P.shape[:1], parts, True, True),
                 "u": _flat(gen, "hyper_u", P.shape[:1], parts,
                            True).clamp_min_(_U_MIN)}
    names = ("Mu_p", "Sigmasq_p", "Mu_e", "Sigmasq_e")
    new = dict(prior)
    new.update(zip(names, S.hyper_update(
        P, E, *(prior[k] for k in names), noise["z"], noise["u"],
        [hp[k] for k in S.HYPERS])))
    return new


def sample_prior_params(spec: ModelSpec, hp: dict, params: dict, prior: dict,
                        gen=None, noise=None) -> dict:
    """One Gibbs sweep over the prior parameters (updates.py:91-203).

    Exponential prior: Lambda ~ Gamma(a + 1, b + x) (``_sample_lambda``).
    Truncnormal prior with ``exact_truncnorm_hypers``: the exact sweep over
    Mu/Sigmasq of P and E (``_exact_hypers``), for one chain or
    chain-batched (P (C, K, N), E (C, N, G) and the prior dict alike);
    ``noise``: {"z": normals, "u": uniforms}, each (n_hyper_noise(spec),)
    per chain, in the JAX layout [Mu_p, Mu_e, Sigmasq_p, Sigmasq_e]
    (updates.py:119-173). Without it: the reference's conjugate update
    (``_sample_truncnorm_conjugate``). Gamma prior: ``_sample_gamma_prior``.
    No branch copies a number to the card or waits for it, except the gamma
    draws' rejection loops (ops/distributions.gamma).
    """
    if spec.prior == "exponential":
        return _sample_lambda(spec, hp, params, prior, gen, noise)
    if spec.prior == "gamma":
        return _sample_gamma_prior(spec, hp, params, prior, gen, noise)
    if not spec.exact_truncnorm_hypers:
        return _sample_truncnorm_conjugate(hp, params, prior, gen, noise)
    if params["P"].dim() == 2:  # one chain: a batch of one
        return drop(_exact_hypers(spec, hp, lift(params), lift(prior), gen,
                                  lift(noise)))
    return _exact_hypers(spec, hp, params, prior, gen, noise)


# ---------------------------------------------------------------------------
# the eager sequential sweeps (Normal likelihood, Poisson MH unfused)
# ---------------------------------------------------------------------------


def _conditional(spec: ModelSpec, mu1, den, lam, mu0, inv_sq):
    """Mean and variance of a column's full conditional (or MH proposal)
    from its sums (get_mu_sigmasq_Pn_normal, sample_Pn.R:132-187): the
    exponential prior shifts the mean by -Lambda with the precision floored
    at 1e-30, the truncnormal prior adds its own precision and mean."""
    if spec.prior == "exponential":
        den_s = den.clamp_min(_EPS)
        return (mu1 - lam) / den_s, 1.0 / den_s
    den2 = den + inv_sq
    return (mu1 + mu0) / den2, 1.0 / den2


def _sweep(spec: ModelSpec, side: str, data, params: dict, prior: dict,
           Mhat, acc, accept_all, gen, noise):
    """sweep_P (``side`` "P", the N columns of P, each a K-vector whose
    sums run over G) or sweep_E (side "E", the rows of E, G-vectors summed
    over K) of C chains at once; see sweep_P."""
    if params["P"].dim() == 2:  # one chain: a batch of one
        return drop(_sweep(spec, side, data, lift(params), lift(prior),
                           lift(Mhat), lift(acc), accept_all, gen,
                           lift(noise)))
    N = spec.N
    A = params["A"]                                      # (C, N)
    C = A.shape[0]
    mh = spec.likelihood == "poisson" and spec.MH
    # on a mesh the P side's sums run over G: each is all-reduced over the
    # g group (the E side's run over K, on this rank's own columns)
    mesh = Mesh.mesh_of(gen) if side == "P" else None

    def red_sums(*xs):
        """Each of ``xs`` summed over ``red``; on a mesh's P side the
        partial sums go out stacked in one all-reduce."""
        sums = [torch.sum(x, red) for x in xs]
        if mesh is None or mesh.n_g == 1:
            return sums
        return Mesh.g_all_reduce(torch.stack(torch.broadcast_tensors(
            *sums)), mesh).unbind()

    # the other factor is fixed through the sweep: its n-th vector in the
    # shape that broadcasts against (C, K, G), its squares and the all-zero
    # test; ``red`` the axis of (C, K, G) a column's sums run over
    if side == "P":
        X, o_all, xdim, red, sfx = params["P"].clone(), params["E"], 2, -1, "p"
        outer = lambda x, o: x.unsqueeze(-1) * o.unsqueeze(-2)  # noqa: E731
        bc = lambda v: v.unsqueeze(-2)                          # noqa: E731
    else:
        X, xdim, red, sfx = params["E"].clone(), 1, -2, "e"
        o_all = params["P"].transpose(-1, -2)            # (C, N, K)
        outer = lambda x, o: o.unsqueeze(-1) * x.unsqueeze(-2)  # noqa: E731
        bc = lambda v: v.unsqueeze(-1)                          # noqa: E731
    o_sq = o_all * o_all
    inactive = red_sums(o_sq)[0] <= 0.0 if side == "P" else (
        o_sq.sum(-1) <= 0.0)                             # (C, N)
    L = X.shape[3 - xdim]
    if noise is None:
        tn = spec.prior == "truncnormal"
        g = side == "E"
        noise = {"prior_u": (gen.uniform("prior_" + side, (C, 2)
                                         + X.shape[1:], 0, g) if tn
                             else None),
                 "u": _rand(gen, "sweep_" + side, (C, 3, N, L), g=g)}
    draw = _prior_draw_P if side == "P" else _prior_draw_E
    X_prior = draw(spec, prior, gen, noise["prior_u"])
    U = noise["u"]
    # the prior's terms of every column at once (elementwise, so each equals
    # the column's own)
    if spec.prior == "exponential":
        lam_all = prior[f"Lambda_{sfx}"]
        mu_all = sq_all = mu0_all = inv_sq_all = None
    else:
        lam_all = None
        mu_all, sq_all = prior[f"Mu_{sfx}"], prior[f"Sigmasq_{sfx}"]
        mu0_all, inv_sq_all = mu_all / sq_all, 1.0 / sq_all
    if mh:
        acc = acc.clone()
    else:
        inv_sig = 1.0 / params["sigmasq"].unsqueeze(-2)  # (C, 1, G)
    flags = (accept_all.view(C, 1) if isinstance(accept_all, torch.Tensor)
             else None)
    n_nan = torch.zeros(C, dtype=torch.float32, device=X.device)
    for n in range(N):
        A2 = A[:, n:n + 1]                               # (C, 1)
        A3 = A2.unsqueeze(-1)                            # (C, 1, 1)
        x_n, o_n = X.select(xdim, n), o_all[:, n]
        x_prior, u = X_prior.select(xdim, n), U[:, :, n]
        lam, mu0, inv_sq = (None if t is None else t.select(xdim, n)
                            for t in (lam_all, mu0_all, inv_sq_all))
        inactive_n = inactive[:, n:n + 1]
        o_b, o2_b = bc(o_n), bc(o_sq[:, n])
        if mh:  # the proposal's variance is max(Mhat, floor)
            lam_old = Mhat.clamp_min(m.MHAT_FLOOR)
            inv_sig = 1.0 / lam_old
        resid = data - (Mhat - A3 * outer(x_n, o_n))
        mu1, den = red_sums(resid * inv_sig * o_b, inv_sig * o2_b)
        den = A2 * den
        mu, var = _conditional(spec, mu1, den, lam, mu0, inv_sq)
        cond = dist.truncnorm_nonneg_from_u(u[:, 0], u[:, 1], mu, var)
        # prior fallback: an all-zero vector of the other factor
        # (sample_Pn.R:12-13, 56)
        proposal = torch.where(inactive_n, x_prior, cond)
        if mh:
            Mhat_prop = Mhat + A3 * outer(proposal - x_n, o_n)
            lam_new = Mhat_prop.clamp_min(m.MHAT_FLOOR)
            d_lam = lam_new - lam_old
            lp_core = data * torch.log1p(d_lam / lam_old) - d_lam
            if spec.exact_mh:
                # the reverse move's conditional shares Mhat_no_n; only its
                # proposal variance max(Mhat_prop, floor) differs
                inv_sig_r = 1.0 / lam_new
                lp_sum, mu1_r, den_r = red_sums(
                    lp_core, resid * inv_sig_r * o_b, inv_sig_r * o2_b)
                den_r = A2 * den_r
                mu_r, var_r = _conditional(spec, mu1_r, den_r, lam, mu0,
                                           inv_sq)
                if spec.prior == "exponential":
                    lprior = -lam * (proposal - x_n)
                else:
                    lprior = m.truncnorm_logpdf_delta(
                        proposal, x_n, mu_all.select(xdim, n),
                        sq_all.select(xdim, n))
                log_ratio = (lp_sum + lprior
                             + m.truncnorm_logpdf(x_n, mu_r, var_r)
                             - m.truncnorm_logpdf(proposal, mu, var))
                # the prior-draw fallback: target and proposal coincide
                log_ratio = torch.where(inactive_n, 0.0, log_ratio)
            else:
                # the reference's ratio: normal-model likelihoods with
                # variances pmax(Mhat_prop, 1) / pmax(Mhat, 1) stand in
                # for the proposal densities (sample_Pn.R:209-239)
                vs_old = Mhat_prop.clamp_min(1.0)
                vs_new = Mhat.clamp_min(1.0)
                r_old = data - Mhat
                r_new = data - Mhat_prop
                log_ratio = red_sums(
                    lp_core
                    + (-0.5 * r_old * r_old / vs_old - 0.5 * torch.log(vs_old))
                    - (-0.5 * r_new * r_new / vs_new
                       - 0.5 * torch.log(vs_new)))[0]
            ratio = torch.exp(log_ratio).clamp_max(1.0)
            nan = torch.isnan(ratio)
            n_nan = n_nan + nan.sum(-1, dtype=torch.float32)
            ratio = torch.where(nan, 0.0, ratio)
            if flags is not None:
                x_mh = torch.where(flags | (u[:, 2] < ratio), proposal, x_n)
                rec = torch.where(flags, 1.0, ratio)
            elif accept_all:
                x_mh, rec = proposal, torch.ones_like(ratio)
            else:
                x_mh, rec = torch.where(u[:, 2] < ratio, proposal, x_n), ratio
            acc_n = acc.select(xdim, n)
            acc_n.copy_(torch.where(A2 == 0, acc_n, rec))
        else:
            x_mh = proposal
        new = torch.where(A2 == 0, x_prior, x_mh)
        Mhat = Mhat + A3 * outer(new - x_n, o_n)
        x_n.copy_(new)
    return X, Mhat, (acc if mh else None), n_nan


def sweep_P(spec: ModelSpec, data, params: dict, prior: dict, Mhat, acc_P,
            accept_all, gen=None, noise=None):
    """Sample the N columns of P in turn from their full conditionals, as
    host-issued tensor ops (sample_Pn / sample_Pn_normal /
    MH_Pn_poisson, sample_Pn.R:11-248; updates.py:266-412), with Mhat
    carried by rank-1 updates. The Normal likelihood draws each column from
    its truncated-normal conditional with variance sigmasq; Poisson MH
    proposes from the conditional with variance max(Mhat, 1e-6) and accepts
    row by row by the exact Hastings ratio (``spec.exact_mh``) or the
    reference's; ``accept_all`` (warmup) takes every proposal. A column
    with A_n = 0 or an all-zero E row draws from the prior; a NaN ratio
    is clamped to 0 and counted. Nothing reads the device.

    One chain (P (K, N), Mhat (K, G), ...) or C chains at once, every
    per-chain operand with a leading chain axis (P (C, K, N), A (C, N),
    Mhat (C, K, G), sigmasq (C, G), the noise's parts); ``accept_all`` a
    bool or a (C,) bool tensor. ``noise``: {"prior_u": the prior draw's
    uniforms ((2, K, N) for the truncnormal prior, (K, N) for the
    exponential one), "u": (3, N, K)}, laid out as the JAX function draws
    them from split(key) (the tests feed it those draws), each chain's its
    own slice of a chain-major batch; else drawn from ``gen``. Returns (P,
    Mhat, acc_P, n_nan (C,)): acc_P None without MH; the inputs are not
    modified."""
    return _sweep(spec, "P", data, params, prior, Mhat, acc_P, accept_all,
                  gen, noise)


def sweep_E(spec: ModelSpec, data, params: dict, prior: dict, Mhat, acc_E,
            accept_all, gen=None, noise=None):
    """sweep_P's mirror over the N rows of E (sample_En.R;
    updates.py:420-531): the sums run over K and the prior fallback is an
    all-zero P column. ``noise``: {"prior_u": (2, N, G) or (N, G),
    "u": (3, N, G)}. Returns (E, Mhat, acc_E, n_nan)."""
    return _sweep(spec, "E", data, params, prior, Mhat, acc_E, accept_all,
                  gen, noise)


# ---------------------------------------------------------------------------
# rank learning
# ---------------------------------------------------------------------------


def prior_prob_1(R, N, clip_val=0.4):
    """clip(R/N, 0.4/N, 1-0.4/N) (compute_prior_prob_1,
    sample_params.R:178-187)."""
    return torch.clamp(R / N, clip_val / N, 1.0 - clip_val / N)


def sample_R(spec: ModelSpec, A, temperature, gen=None, gumbel=None):
    """The expected rank 0..N from its tempered discrete posterior
    (sample_R, sample_params.R:217-241), by Gumbel-max. A (C, N); ``gumbel``
    (C, N+1). Returns (C,) int32."""
    N = spec.N
    sumA = A.sum(-1, keepdim=True)
    r = torch.arange(N + 1, dtype=torch.float32, device=A.device)
    p1 = prior_prob_1(r, N)
    loglik = sumA * torch.log(p1) + (N - sumA) * torch.log(1.0 - p1)
    if gumbel is None:
        gumbel = dist.gumbel_from_u(_rand(
            gen, "R", loglik.shape, c_dim=0 if A.dim() == 2 else None))
    return dist.categorical_from_gumbel(gumbel, temperature * loglik)


def sbfi_penalty(spec: ModelSpec) -> float:
    """The BIC-penalty delta (G+K) log(G) / 2 of one inclusion, in float32
    with log(G) rounded to float32 first (sample_params.R:118-126,
    updates.py:801). The fused kernel takes the form computed in double
    (ops/fused_sweeps.sbfi_penalty)."""
    return float(torch.tensor(float(spec.G + spec.K))
                 * torch.log(torch.tensor(float(spec.G))) / 2.0)


def sweep_A(spec: ModelSpec, data, params: dict, R, Mhat, temperature,
            gen=None, u=None):
    """Sequential tempered Bernoulli updates of the inclusion vector A from
    Mhat (sample_An, sample_params.R:101-166; updates.py:786-835): column
    n's loglik(A_n=1) - loglik(A_n=0) is one reduction over K*G (Poisson,
    or Normal with the state's sigmasq), SBFI subtracts the BIC-penalty
    delta, BFI and BIC (a rank list under rank_method='BIC', updates.py:819)
    do not, and Mhat is rewritten by a rank-1 term. One chain (A (N,), R a
    scalar, Mhat (K, G)) or C chains with a leading chain axis. ``u``: (N,)
    or (C, N) uniforms, column n's Bernoulli draw in u[..., n] (the JAX
    draw from split(key, N)[n]). Returns (A, Mhat, n_nan), n_nan counting
    posteriors clamped NaN -> 1/2.
    """
    if params["P"].dim() == 2:  # one chain: a batch of one
        return drop(sweep_A(spec, data, lift(params), lift(R), lift(Mhat),
                            temperature, gen, lift(u)))
    P, E = params["P"], params["E"]
    A = params["A"].clone()
    C, N = A.shape
    if u is None:
        u = _rand(gen, "A", (C, N))
    p1 = prior_prob_1(R.to(torch.float32), N)
    logit_p1 = torch.log(p1) - torch.log1p(-p1)
    pen = sbfi_penalty(spec)
    mesh = Mesh.mesh_of(gen)
    n_nan = torch.zeros(C, dtype=torch.float32, device=P.device)
    if spec.likelihood == "normal":
        two_sig = 2.0 * params["sigmasq"].unsqueeze(-2)
    for n in range(N):
        contrib = P[:, :, n:n + 1] * E[:, n:n + 1, :]
        Mhat_off = Mhat - A[:, n].view(C, 1, 1) * contrib
        if spec.likelihood == "poisson":
            lam_on = (Mhat_off + contrib).clamp_min(m.MHAT_FLOOR)
            lam_off = Mhat_off.clamp_min(m.MHAT_FLOOR)
            d_lam = lam_on - lam_off
            delta = torch.sum(data * torch.log1p(d_lam / lam_off) - d_lam,
                              (-2, -1))
        else:
            r_on = data - (Mhat_off + contrib)
            r_off = data - Mhat_off
            delta = torch.sum((r_off * r_off - r_on * r_on) / two_sig,
                              (-2, -1))
        # on a mesh a sum over this rank's columns: add the g group's
        delta = Mesh.g_all_reduce(delta, mesh)
        if spec.rank_method == "SBFI":
            delta = delta - pen
        p = torch.sigmoid(logit_p1 + temperature * delta)
        is_nan = torch.isnan(p)
        n_nan = n_nan + is_nan.to(torch.float32)
        p = torch.where(is_nan, 0.5, p)
        a_new = dist.bernoulli_from_u(u[:, n], p)
        Mhat = Mhat_off + a_new.view(C, 1, 1) * contrib
        A[:, n] = a_new
    return A, Mhat, n_nan


def stream_sweep_A(spec: ModelSpec, data, params: dict, R, temperature,
                   gen=None, u=None):
    """Sequential tempered Bernoulli updates of the inclusion vector A
    (sample_An, sample_params.R:101-166), the whole sweep one call of
    ops/stream_sweeps.stream_acol_update, whose kernels take each column's
    loglik delta, the SBFI penalty (BFI and BIC: none), the tempered
    sigmoid, the
    NaN fallback and the draw in turn. ``u``: (C, N) uniforms, column n's
    Bernoulli draw in u[:, n]. Returns (A, n_nan), n_nan (C,) counting
    posteriors clamped NaN -> 1/2.
    """
    P, E = params["P"], params["E"]
    A = params["A"].clone()
    C, K, N = P.shape
    if u is None:
        u = _rand(gen, "A", (C, N))
    p1 = prior_prob_1(R.to(torch.float32), N)
    logit_p1 = torch.log(p1) - torch.log1p(-p1)
    pen = sbfi_penalty(spec) if spec.rank_method == "SBFI" else None
    n_nan = torch.zeros(C, dtype=torch.float32, device=P.device)
    S.stream_acol_update(data, E, P, A, logit_p1, temperature,
                         u.contiguous(), n_nan, pen)
    return A, n_nan


# ---------------------------------------------------------------------------
# sigmasq (Normal likelihood)
# ---------------------------------------------------------------------------


def sample_sigmasq(spec: ModelSpec, data, prior: dict, Mhat, gen=None,
                   u=None):
    """sigmasq_g ~ InvGamma(Alpha + K/2, Beta + sum_k resid^2 / 2)
    (sample_params.R:275-286; updates.py:880-886), for one chain or, with
    a leading chain axis on Mhat and the prior, for C; ``u``: the gamma
    draw's uniform planes (9, G), or (C, 9, G)."""
    resid = data - Mhat
    rss = torch.sum(resid * resid, -2)
    return dist.inv_gamma(gen, prior["Alpha_sig"] + spec.K / 2.0,
                          prior["Beta_sig"] + 0.5 * rss, u=u,
                          chain_axis=Mhat.dim() == 3, g=True, site="sigmasq")


# ---------------------------------------------------------------------------
# conjugate Poisson-Gibbs: P and E given the latent counts, and the counts
# ---------------------------------------------------------------------------


def _conjugate_prior(spec: ModelSpec, prior: dict, side: str):
    """The prior's (shape, rate) of one side's conjugate gamma draw: (1,
    Lambda) for the exponential prior, (Alpha, Beta) for the gamma one."""
    if spec.prior == "gamma":
        return prior[f"Alpha_{side}"], prior[f"Beta_{side}"]
    return 1.0, prior[f"Lambda_{side}"]


def sample_P_poisson_gibbs(spec: ModelSpec, prior: dict, params: dict,
                           gen=None, u=None):
    """All of P in one conjugate draw given the latent-count sums
    (sample_Pn_poisson, sample_Pn.R:98-120; updates.py:733-749):
    P ~ Gamma(1 + Zsum_g, Lambda_p + A * rowsum(E)) under the exponential
    prior, Gamma(Alpha_p + Zsum_g, Beta_p + A * rowsum(E)) under the gamma
    prior. An excluded column has Zsum 0 and draws from the prior. Every
    operand may carry a leading chain axis C. ``u``: the gamma draw's
    uniform planes (9, K, N), or (C, 9, K, N)."""
    A, E = params["A"], params["E"]
    rate_add = (A * Mesh.gsum(E, -1, Mesh.mesh_of(gen))).unsqueeze(-2)
    shape, rate = _conjugate_prior(spec, prior, "p")
    return dist.gamma(gen, shape + params["Zsum_g"], rate + rate_add, u=u,
                      chain_axis=E.dim() == 3, site="gamma_P")


def sample_E_poisson_gibbs(spec: ModelSpec, prior: dict, params: dict, P_new,
                           gen=None, u=None):
    """The mirror for E with the freshly drawn P (sample_En.R:97-119;
    updates.py:752-762): E ~ Gamma(1 + Zsum_k, Lambda_e + A * colsum(P)),
    or Gamma(Alpha_e + Zsum_k, Beta_e + A * colsum(P))."""
    rate_add = (params["A"] * P_new.sum(-2)).unsqueeze(-1)    # (N, 1)
    shape, rate = _conjugate_prior(spec, prior, "e")
    return dist.gamma(gen, shape + params["Zsum_k"], rate + rate_add, u=u,
                      chain_axis=P_new.dim() == 3, g=True, site="gamma_E")


def sample_Z_sums(spec: ModelSpec, data, params: dict, gen=None, u=None):
    """The latent counts' marginal sums (Zsum_g (K, N), Zsum_k (N, G)) of
    Z[k, :, g] ~ Multinomial(M[k, g], p ∝ P[k, :] A E[:, g])
    (sample_params.R:253-265; updates.py:894-905), through
    ops/allocation.allocate_counts, for one chain or C (the kernel's grid
    has the chain axis); ``u``: its uniform planes, else the Philox stream
    of the streams' ``subkey("alloc")`` and the chains' uids. On a mesh the
    kernel runs on this rank's columns and chains, counting them in the
    whole matrix, and Zsum_g adds the g group's parts."""
    mesh = Mesh.mesh_of(gen)
    kw = {} if u is not None else dict(key=gen.subkey("alloc"),
                                       uids=gen.uids)
    if mesh is None:
        return allocate_counts(data, params["P"], params["A"], params["E"],
                               u=u, **kw)
    zg, zk = allocate_counts(data, params["P"], params["A"], params["E"],
                             u=u, g0=gen.g0, G_total=gen.G, **kw)
    return Mesh.g_all_reduce(zg, mesh), zk


# ---------------------------------------------------------------------------
# streaming P and E sweeps
# ---------------------------------------------------------------------------


def _stream_prior(spec: ModelSpec, prior: dict, side: str):
    """The prior operands of a streamed sweep: (Mu, Sigmasq), or the
    exponential prior's (Lambda, None)."""
    if spec.prior == "exponential":
        return prior[f"Lambda_{side}"], None
    return prior[f"Mu_{side}"], prior[f"Sigmasq_{side}"]


def _stream_noise(spec: ModelSpec, gen, shape, L: int, side: str) -> dict:
    """A streamed sweep's draws when none are given: the prior draw's
    uniforms ((C, 2) + shape[1:] for the truncnormal prior, ``shape`` for
    the exponential one) and (C, 3, N, L) for the column updates of
    ``side`` ("P" or "E")."""
    C = shape[0]
    g = side == "E"
    if spec.prior == "exponential":
        prior_u = gen.uniform("prior_" + side, shape, 0, g)
    else:
        prior_u = gen.uniform("prior_" + side, (C, 2) + tuple(shape[1:]), 0,
                              g)
    return {"prior_u": prior_u,
            "u": _rand(gen, "sweep_" + side, (C, 3, spec.N, L), g=g)}


def stream_sweep_P(spec: ModelSpec, data, params: dict, prior: dict, acc_P,
                   accept_all, gen=None, noise=None):
    """Sequential exact-MH updates of the N columns of P with streamed
    reductions (updates.py:539-636), each column one call of
    ops/stream_sweeps.stream_pcol_update's kernel, with the truncnormal or
    the exponential prior (Lambda in the place of the prior pair); on the
    card nothing runs between the column launches. ``noise``: {"prior_u":
    (C, 2, K, N), or (C, K, N) for the exponential prior, "u":
    (C, 3, N, K)}, the JAX draws of _prior_draw_P and of the sweep's
    uniforms. Returns (P, acc_P, n_nan (C,)); the inputs are not modified.
    """
    P = params["P"].clone()
    acc_P = acc_P.clone()
    C, K, N = P.shape
    if noise is None:
        noise = _stream_noise(spec, gen, P.shape, K, "P")
    P_prior = _prior_draw_P(spec, prior, gen, noise["prior_u"])
    n_nan = torch.zeros(C, dtype=torch.float32, device=P.device)
    S.stream_pcol_update(data, params["E"], P, params["A"], acc_P,
                         *_stream_prior(spec, prior, "p"), P_prior,
                         noise["u"].contiguous(), accept_all, n_nan,
                         prior=spec.prior)
    return P, acc_P, n_nan


def stream_sweep_E(spec: ModelSpec, data, params: dict, prior: dict, acc_E,
                   accept_all, gen=None, noise=None):
    """Streaming mirror of stream_sweep_P over the rows of E
    (updates.py:639-725). ``noise``: {"prior_u": (C, 2, N, G), or (C, N, G)
    for the exponential prior, "u": (C, 3, N, G)}. Returns (E, acc_E,
    n_nan (C,))."""
    E = params["E"].clone()
    acc_E = acc_E.clone()
    C, N, G = E.shape
    if noise is None:
        noise = _stream_noise(spec, gen, E.shape, G, "E")
    E_prior = _prior_draw_E(spec, prior, gen, noise["prior_u"])
    n_nan = torch.zeros(C, dtype=torch.float32, device=E.device)
    S.stream_erow_update(data, E, params["P"], params["A"], acc_E,
                         *_stream_prior(spec, prior, "e"), E_prior,
                         noise["u"].contiguous(), accept_all, n_nan,
                         prior=spec.prior)
    return E, acc_E, n_nan
