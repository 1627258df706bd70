"""The streaming path with the exponential prior against the JAX package.

The plain versions of ``stream_pcol_update``, ``stream_erow_update`` and
``stream_metrics_row`` with ``prior="exponential"`` (what their wrappers
run on CPU tensors) against the JAX ``stream_sweep_P``/``stream_sweep_E``
(updates.py:573-600, :660-690: the conditional (mu1 - Lambda) / max(den,
1e-30), the prior's part -Lambda (proposal - old) of the ratio, the prior
draw of an excluded or inactive column) and ``_metrics_row`` (the
exponential log-prior of every entry of P and E), at G = 300 with an
excluded column, fed the same draws; then whole stream steps against
``gibbs_step``. Tolerances are those of the TruncNormal cases in
tests/test_torch_stream_sweeps.py: values rtol 1e-5 / atol 1e-6 and the
same decisions, recorded ratios rtol 1e-4, the metrics row rtol 1e-5 with
KL to 1e-5 of sum(M log M).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesnmf_tpu.config import ModelSpec as JModelSpec
from bayesnmf_tpu.config import default_hyperprior_params
from bayesnmf_tpu.models import gibbs as jgibbs
from bayesnmf_tpu.models import updates as JU
from bayesnmf_tpu.ops import math as jm
from bayesnmf_tpu.ops import pallas_stream_sweeps as JS
from bayesnmf_tpu.parallel import chains as JCH
from bayesnmf_tpu_torch.config import ModelSpec
from bayesnmf_tpu_torch.models import gibbs as tgibbs
from bayesnmf_tpu_torch.models import updates as TU
from bayesnmf_tpu_torch.ops import math as tm
from bayesnmf_tpu_torch.ops import stream_sweeps as S
from bayesnmf_tpu_torch.ops.rng import ChainStreams
from test_torch_eager import jax_prior_noise

torch.set_num_threads(1)

K, N, G, C = 16, 3, 300, 2
RTOL, ATOL = 1e-5, 1e-6
_U_MIN = np.float32(1.2e-38)
KL = tgibbs.METRIC_NAMES.index("KL")


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, rtol, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def setup():
    """A JAX two-chain Poisson-Exponential stream state at G = 300: chain
    0 without column 1, chain 1 with an all-zero E row 2 (an inactive P
    column, whose proposal is the prior draw)."""
    rng = np.random.default_rng(12)
    P = rng.dirichlet(np.ones(K) * 0.5, N).T * 40
    E = rng.gamma(2.0, 2.0, (N, G))
    data = rng.poisson(P @ E).astype(np.float32)
    kw = dict(K=K, N=N, G=G, likelihood="poisson", prior="exponential",
              MH=True, stream_sweeps=True)
    jspec, tspec = JModelSpec(**kw), ModelSpec(**kw)
    hp = default_hyperprior_params(jspec, float(data.mean()))
    js = JCH.init_chain_states(jspec, hp, jnp.asarray(data),
                               jax.random.PRNGKey(5), C)
    js["params"]["A"] = js["params"]["A"].at[0, 1].set(0.0)
    js["params"]["E"] = js["params"]["E"].at[1, 2].set(0.0)
    return jspec, tspec, hp, data, js


def tree(d):
    return {k: t(np.asarray(v)) for k, v in d.items()}


def sweep_noise(key, rows, cols, L):
    """stream_sweep_P/E's draws with the exponential prior: the uniforms of
    jax.random.exponential for the prior draw, then (3, N, L)."""
    k_prior, k_u = jax.random.split(key)
    return {"prior_u": np.asarray(jax.random.uniform(k_prior, (rows, cols))),
            "u": np.asarray(jax.random.uniform(k_u, (3, N, L), jnp.float32,
                                               minval=_U_MIN))}


@pytest.mark.parametrize("side", ["P", "E"])
def test_exponential_column_updates_match_jax(setup, side):
    jspec, tspec, hp, data, js = setup
    col = side == "P"
    shape = (C, K, N) if col else (C, N, G)
    acc = jnp.full(shape, 0.5, jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(21 + col), C)
    flags = jnp.asarray([False, True])
    jfn = JU.stream_sweep_P if col else JU.stream_sweep_E
    want = jax.vmap(lambda p, pr, a, k, f: jfn(
        jspec, jnp.asarray(data), p, pr, a, k, f))(
            js["params"], js["prior"], acc, keys, flags)
    rows, cols = (K, N) if col else (N, G)
    nz = [sweep_noise(k, rows, cols, K if col else G) for k in keys]
    nz = {k: t(np.stack([n[k] for n in nz])) for k in nz[0]}
    tp, tpr = tree(js["params"]), tree(js["prior"])
    X = tp[side].clone()
    acc_t = t(np.asarray(acc)).clone()
    n_nan = torch.zeros(C)
    draw = TU._prior_draw_P if col else TU._prior_draw_E
    prior_draw = draw(tspec, tpr, None, nz["prior_u"])
    fn = S.stream_pcol_update if col else S.stream_erow_update
    lam = tpr["Lambda_p" if col else "Lambda_e"]
    fn(t(data), tp["E"] if col else X, X if col else tp["P"], tp["A"],
       acc_t, lam, None, prior_draw, nz["u"], torch.tensor([False, True]),
       n_nan, prior="exponential")
    X0, Xw = np.asarray(js["params"][side]), np.asarray(want[0])
    np.testing.assert_array_equal(X.numpy() != X0, Xw != X0)
    close(X.numpy(), Xw, RTOL, ATOL, msg=side)
    # the recorded ratio exp(log_ratio): its relative difference is the
    # log ratio's absolute one, which JAX's float32 sums of ~1e2-1e3 over
    # G round to ~1e-4 (tests/test_torch_stream_sweeps.py); a ratio's
    # absolute difference below the uniforms' grid 2^-23 cannot move a
    # decision by more than one grid point (the decisions are held equal
    # above)
    close(acc_t.numpy(), np.asarray(want[1]), 10 * RTOL, 2.0 ** -23 / 10,
          msg=f"acc_{side}")
    np.testing.assert_array_equal(n_nan.numpy(), np.asarray(want[2]))
    # the excluded column took its prior draw and kept its record
    ex = (0, slice(None), 1) if col else (0, 1, slice(None))
    np.testing.assert_array_equal(X[ex].numpy(), prior_draw[ex].numpy())
    assert (acc_t[ex] == 0.5).all()
    if col:  # chain 1's P column 2 faces an all-zero E row: a prior draw
        np.testing.assert_array_equal(X[1, :, 2].numpy(),
                                      prior_draw[1, :, 2].numpy())
    # the streamed sweep of models/updates.py is the same call
    sweep = TU.stream_sweep_P if col else TU.stream_sweep_E
    got = sweep(tspec, t(data), tp, tpr, t(np.asarray(acc)),
                torch.tensor([False, True]), noise=nz)
    assert torch.equal(got[0], X) and torch.equal(got[1], acc_t)


def test_exponential_prior_needs_lambda_alone(setup):
    _, _, _, data, js = setup
    tp, tpr = tree(js["params"]), tree(js["prior"])
    args = (t(data), tp["E"], tp["P"].clone(), tp["A"],
            torch.full((C, K, N), 0.5), tpr["Lambda_p"])
    rest = (torch.ones(C, K, N), torch.full((C, 3, N, K), 0.5),
            torch.tensor([False, False]), torch.zeros(C))
    with pytest.raises(ValueError, match="Lambda alone"):
        S.stream_pcol_update(*args, tpr["Lambda_p"], *rest,
                             prior="exponential")
    with pytest.raises(ValueError, match="Mu and Sigmasq"):
        S.stream_pcol_update(*args, None, *rest)
    with pytest.raises(NotImplementedError, match="Gibbs only"):
        S.stream_pcol_update(*args, None, *rest, prior="gamma")


@pytest.mark.parametrize("excluded", [False, True])
def test_exponential_metrics_row_matches_jax(setup, excluded):
    """The rows of _metrics_row with pois_red from chain_metrics on P * A
    and the exponential log-prior; ``excluded`` also drops every column of
    chain 1 (sum A = 0)."""
    jspec, _, _, data, js = setup
    params = dict(js["params"])
    if excluded:
        params["A"] = params["A"].at[1].set(0.0)
    rng = np.random.default_rng(7)
    acc_P = rng.uniform(0, 1, (C, K, N)).astype(np.float32)
    acc_E = rng.uniform(0, 1, (C, N, G)).astype(np.float32)
    na = np.array([1.0, 0.0], np.float32)
    consts = jm.metric_constants("poisson", jnp.asarray(data))

    def one(p, pr, aP, aE, n):
        red = JS.chain_metrics(jnp.asarray(data), p["E"],
                               p["P"] * p["A"][None, :])
        return jgibbs._metrics_row(jspec, jnp.asarray(data), p, pr, None,
                                   jnp.int32(9), jnp.float32(0.7), aP, aE, n,
                                   consts, red)

    want = np.asarray(jax.vmap(one)(params, js["prior"], jnp.asarray(acc_P),
                                    jnp.asarray(acc_E), jnp.asarray(na)))
    tp, tpr = tree(params), tree(js["prior"])
    tc = tm.metric_constants("poisson", t(data))
    got = S.stream_metrics_row(
        t(data), tp["P"], tp["E"], tp["A"], t(acc_P), t(acc_E),
        tpr["Lambda_p"], None, tpr["Lambda_e"], None, tc["lgamma_sum"],
        tc["mlogm_sum"], t(na), 9, 0.7, prior="exponential").numpy()
    Mp = np.maximum(data, 1e-6)
    close(np.delete(got, KL, 1), np.delete(want, KL, 1), RTOL)
    close(got[:, KL], want[:, KL], 0,
          atol=1e-5 * float(np.sum(Mp * np.log(Mp))))
    # the log-prior is the exponential one: logposterior - loglik
    lp = [float(tm.logprior_PE(tp["P"][c], tp["E"][c], "exponential",
                               {k: v[c] for k, v in tpr.items()}))
          for c in range(C)]
    close(got[:, 4] - got[:, 3], lp, 1e-4)


def test_exponential_stream_steps_match_jax(setup):
    """Two whole iterations of one chain, warmup then MH: the port's
    stream_step fed the draws of the JAX gibbs_step's keys, the Lambda
    update's gamma planes among them; the same decisions, values within the
    steps' tolerance of tests/test_torch_chains.py (rtol 1e-3 / atol 1e-4):
    Lambda is a gamma draw rounded apart in its last digits, and the
    exponential conditional's mean (mu1 - Lambda) / den cancels them into a
    larger relative difference of the draws."""
    jspec, tspec, hp, data, js = setup
    jstate = jax.tree.map(lambda x: x[0], js)
    tstate = {"params": {k: t(np.asarray(v))[None]
                         for k, v in jstate["params"].items()},
              "prior": {k: t(np.asarray(v))[None]
                        for k, v in jstate["prior"].items()},
              "acc_P": t(np.asarray(jstate["acc_P"]))[None],
              "acc_E": t(np.asarray(jstate["acc_E"]))[None],
              "iter": int(jstate["iter"]), "gen": None}
    for step, acc_all in enumerate((True, False)):
        k_pp, k_P, k_E, _ = jax.random.split(jstate["key"], 4)
        noise = {"prior": jax_prior_noise(jspec, k_pp),
                 "P": sweep_noise(k_P, K, N, K),
                 "E": sweep_noise(k_E, N, G, G)}
        noise = {k: {n: t(v)[None] for n, v in d.items()}
                 for k, d in noise.items()}
        before = ({k: tstate["params"][k][0].numpy() for k in ("P", "E")},
                  {k: np.asarray(jstate["params"][k]) for k in ("P", "E")})
        jstate, jout = jgibbs.gibbs_step(jspec, jnp.asarray(data), hp,
                                         jstate, jnp.float32(1.0), acc_all)
        tstate, tout = tgibbs.gibbs_step(
            tspec, t(data), hp, tstate, 1.0, torch.tensor([acc_all]),
            noise=noise)
        for k in ("P", "E"):  # the same entries accepted
            np.testing.assert_array_equal(
                tout[k][0].numpy() != before[0][k],
                np.asarray(jout[k]) != before[1][k], err_msg=k)
        for k in ("P", "E", "A"):
            close(tout[k][0].numpy(), np.asarray(jout[k]), 1e-3, 1e-4,
                  msg=f"{k} step {step}")
        for k in ("Lambda_p", "Lambda_e"):
            close(tstate["prior"][k][0].numpy(),
                  np.asarray(jstate["prior"][k]), RTOL, ATOL, msg=k)
        close(np.delete(tout["metrics"][0].numpy(), KL),
              np.delete(np.asarray(jout["metrics"]), KL), 1e-3,
              msg=f"metrics step {step}")

    assert float(tout["metrics"][0, 9]) < 1.0  # MH rejected something


def test_stream_noise_layout_with_the_exponential_prior(setup):
    """draw_stream_noise gives the exponential prior's shapes: the Lambda
    update's gamma planes and one plane of prior-draw uniforms a side, each
    chain's its own row of one draw."""
    _, tspec, _, _, _ = setup
    noise = tgibbs.draw_stream_noise(tspec, C, ChainStreams(0, np.arange(C)),
                                     "cpu")
    assert noise["prior"]["p"].shape == (C, 9, K, N)
    assert noise["prior"]["e"].shape == (C, 9, N, G)
    assert noise["P"]["prior_u"].shape == (C, K, N)
    assert noise["E"]["prior_u"].shape == (C, N, G)
    one = noise["P"]["u"].untyped_storage().data_ptr()
    assert all(v.untyped_storage().data_ptr() == one
               for d in noise.values() for v in d.values())
