"""Samplers of the Gibbs conditionals.

Port of a subset of bayesnmf_tpu/ops/distributions.py. A sampler either
draws from the chains' random streams (``gen``, an ops/rng.ChainStreams)
at a named draw site, or (the ``*_from_u`` / ``*_from_gumbel`` forms, and
the ``u`` / ``z`` operands) takes its noise as operands, so a test can
feed it the JAX package's draws. Philox and threefry never give the same
numbers, so the keyed forms match the reference in distribution, not draw
by draw.
"""

from __future__ import annotations

import torch

_TINY = 1.1754944e-38  # smallest normal float32


def _uniform(gen, site: str, shape, chain_axis: bool = False,
             g: bool = False, rnd: int = 0):
    """Uniforms in [_TINY, 1) of ``shape`` from the streams ``gen`` at
    ``site``: with ``chain_axis`` the leading dim is the chain axis, else
    the streams hold one chain; ``g``: the last dim is G."""
    return gen.uniform(site, shape, 0 if chain_axis else None, g, rnd)


def _ndtr(x):
    """Standard normal CDF in the form of jax.scipy.special.ndtr: erfc in
    both tails. (torch.special.ndtr computes 1 + erf, which rounds to 0 in
    float32 below about -5.4, where the truncated-normal draws need it.)"""
    z = x * 0.7071067811865476
    a = z.abs()
    y = torch.where(a < 0.7071067811865476, 1.0 + torch.erf(z),
                    torch.where(z > 0, 2.0 - torch.erfc(a), torch.erfc(a)))
    return 0.5 * y


def _std_normal_lower_tail_from_u(u1, u2, alpha):
    """Z ~ N(0,1) | Z >= alpha from two uniforms (distributions.py:24-46):
    the tail-form inverse CDF z = -ndtri(u1 * ndtr(-alpha)) up to alpha = 8,
    and beyond it the deep-tail limit alpha + Exp(1)/alpha from the second
    uniform."""
    tail = _ndtr(-alpha)
    v = (u1 * tail).clamp_min(_TINY)
    z_icdf = torch.maximum(-torch.special.ndtri(v), alpha)
    a_safe = alpha.clamp_min(1.0)
    z_tail = a_safe - torch.log(u2.clamp_min(_TINY)) / a_safe
    return torch.where(alpha > 8.0, z_tail, z_icdf)


def truncnorm_nonneg_from_u(u1, u2, mu, sigmasq):
    """Normal(mu, sigmasq) truncated to [0, inf), from two uniforms."""
    sd = torch.sqrt(sigmasq)
    z = _std_normal_lower_tail_from_u(u1, u2, -mu / sd)
    return (mu + sd * z).clamp_min(0.0)


def truncnorm_nonneg(gen, mu, sigmasq, site: str, chain_axis: bool = False,
                     g: bool = False):
    """Elementwise TruncNormal[0, inf) draws (replaces truncnorm::rtruncnorm)
    from two uniform planes at ``site``: (2,) + shape, or with
    ``chain_axis`` (C, 2) + shape[1:]."""
    mu, sigmasq = torch.broadcast_tensors(mu, sigmasq)
    shape = tuple(mu.shape)
    if chain_axis:
        u = _uniform(gen, site, (shape[0], 2) + shape[1:], True, g)
        u0, u1 = u[:, 0], u[:, 1]
    else:
        u0, u1 = _uniform(gen, site, (2,) + shape, False, g)
    return truncnorm_nonneg_from_u(u0, u1, mu, sigmasq)


def normal(gen, mu, sigmasq, z=None, chain_axis: bool = False,
           g: bool = False, site: str | None = None):
    """Normal(mu, sigmasq) draws (sigmasq is the variance); ``z``: the
    standard normals, else drawn from ``gen`` at ``site`` (``chain_axis``:
    the operands' leading axis is the chain axis, ``g``: their last G)."""
    mu, sigmasq = torch.broadcast_tensors(mu, sigmasq)
    if z is None:
        z = gen.normal(site, mu.shape, 0 if chain_axis else None, g)
    return mu + torch.sqrt(sigmasq) * z


def gamma(gen, shape_param, rate, unroll: int = 4, u=None,
          chain_axis: bool = False, g: bool = False, site: str | None = None):
    """Exact Gamma(shape, rate) draws (mean = shape/rate), by Marsaglia-Tsang
    (distributions.py:83-157): ``unroll`` rounds of candidates from one
    uniform draw, then an exact rejection loop for the elements still
    undecided. a < 1 is boosted: Gamma(a) = Gamma(a+1) * U^(1/a).

    ``u``: the pre-drawn uniforms, (2 * unroll + 1,) + shape, as the JAX
    function draws them from its key; with ``chain_axis`` the operands carry
    a leading chain axis C and ``u`` is chain-major, (C, 2 * unroll + 1) +
    shape[1:], each chain's planes its own slice (a draw from ``gen`` takes
    that layout too), from ``gen`` at ``site`` when not given. The exact
    rejection loop, which runs for about 1e-5 of the elements, draws its
    round r at (``site``, r), so the rounds one chain or element needs
    never shift another draw. That loop reads the device to know when it
    is done: one host wait per call, whatever C is. On a mesh (``g``: the
    operands' last axis is G) a rank draws its own elements' rounds and
    stops when they are done."""
    a, rate = torch.broadcast_tensors(shape_param, rate)
    shape, dev = tuple(a.shape), a.device
    boost = a < 1.0
    a_eff = torch.where(boost, a + 1.0, a)
    d = a_eff - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)

    def candidate(u_z, u_a):
        x = torch.special.ndtri(u_z)
        one_cx = 1.0 + c * x
        v = one_cx * one_cx * one_cx
        ok = (v > 0.0) & (
            torch.log(u_a)
            < 0.5 * x * x + d - d * v + d * torch.log(v.clamp_min(_TINY)))
        return d * v, ok

    n_u = 2 * unroll + 1
    if u is None:
        u = _uniform(gen, site, (shape[0], n_u) + shape[1:] if chain_axis
                     else (n_u,) + shape, chain_axis, g)
    u_all = u.movedim(1, 0) if chain_axis else u
    x = torch.full(shape, float("nan"), device=dev)
    done = torch.zeros(shape, dtype=torch.bool, device=dev)
    for r in range(unroll):
        xv, ok = candidate(u_all[2 * r], u_all[2 * r + 1])
        x = torch.where(~done & ok, xv, x)
        done = done | ok
    # a non-finite or non-positive shape never accepts: leave it NaN instead
    # of looping forever
    done = done | ~torch.isfinite(d) | (a <= 0.0)
    rnd = 0
    while not bool(done.all()):
        rnd += 1
        gamma.rounds += 1
        uv = _uniform(gen, site, (shape[0], 2) + shape[1:] if chain_axis
                      else (2,) + shape, chain_axis, g, rnd)
        uv = uv.movedim(1, 0) if chain_axis else uv
        xv, ok = candidate(uv[0], uv[1])
        x = torch.where(~done & ok, xv, x)
        done = done | ok

    x = x * torch.where(
        boost, torch.exp(torch.log(u_all[-1]) / a.clamp_min(1e-12)),
        torch.ones_like(x))
    return x / rate


#: rounds of the exact rejection loop run since the count was last reset
gamma.rounds = 0


def inv_gamma(gen, shape_param, rate, u=None, chain_axis: bool = False,
              g: bool = False, site: str | None = None):
    """InvGamma(shape, rate) draws via 1/Gamma (replaces invgamma::rinvgamma);
    ``u``, ``chain_axis``, ``g`` and ``site``: as ``gamma`` takes them."""
    return 1.0 / gamma(gen, shape_param, rate, u=u, chain_axis=chain_axis,
                       g=g, site=site).clamp_min(1e-30)


def exponential(gen, rate, u=None, site: str | None = None,
                chain_axis: bool = False, g: bool = False):
    """Exponential(rate) draws (replaces stats::rexp): -log1p(-u) / rate,
    the form of jax.random.exponential; ``u`` uniforms in [0, 1), else
    drawn from ``gen`` at ``site``."""
    if u is None:
        u = _uniform(gen, site, rate.shape, chain_axis, g)
    return -torch.log1p(-u) / rate


def _gamma_shape_cond(x, cm1, d, log_beta, log_param):
    """gamma_shape_cond_logpdf with c - 1 given (``cm1``), so a caller that
    evaluates it many times on the same operands computes it once."""
    return (cm1 * torch.log(x) - d * x + x * log_beta
            + (x - 1.0) * log_param - torch.lgamma(x))


def gamma_shape_cond_logpdf(x, c, d, log_beta, log_param):
    """Unnormalised log-density of the gamma prior's shape conditional
    (logpdf_prop of sample_Alpha_Pkn, sample_priors.R:357-363;
    distributions.py:290-304): (c-1) log x - d x + x log(beta)
    + (x-1) log(p) - lgamma(x), p the current P (or E) entry, beta its
    rate."""
    return _gamma_shape_cond(x, c - 1.0, d, log_beta, log_param)


def slice_sample_logconcave(x0, logpdf_fn, params: tuple, e, u_l, u_s,
                            lower: float = 1e-3, upper: float = 1e4,
                            width: float = 1.0, chain_axis: bool = False):
    """One elementwise slice-sampling transition of independent 1-D
    densities ``logpdf_fn(x, *params)`` on (lower, upper), with stepping
    out and shrinkage (distributions.py:189-263; replaces armspp::arms,
    sample_priors.R:356-397).

    The noise comes as operands, laid out as the JAX function draws it from
    split(key, 4): ``e`` the Exp(1) draw of the slice level and ``u_l`` the
    bracket's uniform, each shaped as x0, and ``u_s`` the shrink steps'
    uniforms, (n_shrink,) + x0.shape; with ``chain_axis`` x0 carries a
    leading chain axis C and ``u_s`` is chain-major, (C, n_shrink) +
    x0.shape[1:]. The 8 stepping-out and len(u_s) shrink rounds are a
    fixed sequence of tensor ops that never read the device; a lane that
    accepts no proposal keeps x0 (the identity transition)."""
    def logf(x):
        return logpdf_fn(x.clamp(lower, upper), *params)

    log_y = logf(x0) - e
    L = (x0 - width * u_l).clamp_min(lower)
    R = (L + width).clamp_max(upper)
    w = width
    for _ in range(8):  # stepping out, the bracket doubling each round
        grow_L = logf(L) > log_y
        grow_R = logf(R) > log_y
        L = torch.where(grow_L, (L - w).clamp_min(lower), L)
        R = torch.where(grow_R, (R + w).clamp_max(upper), R)
        w = w * 2.0
    u_s = u_s.movedim(1, 0) if chain_axis else u_s
    x = x0
    accepted = torch.zeros_like(x0, dtype=torch.bool)
    for u in u_s:  # shrinkage towards x0
        prop = L + u * (R - L)
        ok = logf(prop) > log_y
        x = torch.where(ok & ~accepted, prop, x)
        accepted = accepted | ok
        shrink = ~accepted
        below = prop < x0
        L = torch.where(shrink & below, prop, L)
        R = torch.where(shrink & ~below, prop, R)
    return torch.where(accepted, x.clamp(lower, upper), x0)


def bernoulli_from_u(u, p):
    """Bernoulli(p) as float 0/1 from a uniform: ``u < p``, the form of
    jax.random.bernoulli (its uniform comes from the same key)."""
    return (u < p).to(torch.float32)


def gumbel_from_u(u):
    """Standard Gumbel noise from uniforms in (0, 1): -log(-log(u)), the
    form of jax.random.gumbel."""
    return -torch.log(-torch.log(u))


def categorical_from_gumbel(gumbel, logits):
    """Categorical draw over the last axis by the Gumbel-max trick, the form
    of jax.random.categorical: argmax(logits + gumbel). Returns int32."""
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)
