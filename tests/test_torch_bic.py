"""Fixed inclusion masks, fit(rank_method='BIC') and the ensemble's results.

- ``A_masks``: on every path a chain keeps its mask and its rank through a
  run, and its excluded columns draw from the prior: one step from the
  same state and draws gives the same excluded columns whatever the data.
- ``fit(data, ranks, rank_method='BIC')``: the JAX return layout on the
  parallel route (one masked ensemble) and on the serial one, which a
  keyword that ChainEnsemble lacks selects with the JAX warning
  (tests/test_ensemble_surface.py:126-147), as ``parallel_bic=False`` does.
- ``assign_signatures``, ``summary`` and ``pooled_assignment`` against a
  given reference, equal to the JAX methods run on the same chains; a
  Normal, a conjugate and a masked ensemble resume bit-exactly.
"""

import numpy as np
import pytest
import torch

import bayesnmf_tpu_torch as bt
from bayesnmf_tpu_torch.config import default_hyperprior_params
from bayesnmf_tpu_torch.models import gibbs as tgibbs
from bayesnmf_tpu_torch.models.sampler import GibbsSampler, fit
from bayesnmf_tpu_torch.parallel.ensemble import ChainEnsemble
from test_torch_chains import port_noise

torch.set_num_threads(1)

K, N, G = 16, 3, 24
MASKS = np.array([[1, 0, 0], [1, 1, 0], [0, 1, 1]], np.float32)
PATHS = {
    "fused": dict(),
    "fused_exponential": dict(prior="exponential"),
    "eager_mh": dict(fused_sweeps=False),
    "stream_truncnormal": dict(stream_sweeps=True),
    "stream_exponential": dict(prior="exponential", stream_sweeps=True),
    "conjugate": dict(prior="exponential", MH=False),
    "normal_truncnormal": dict(likelihood="normal"),
    "normal_exponential": dict(likelihood="normal", prior="exponential"),
}
CC = bt.ConvergenceControl(MAP_over=40, MAP_every=20, miniters=40,
                           maxiters=120, Ninarow_nochange=2, Ninarow_nobest=3)


def sim(seed=0, scale=30.0):
    rng = np.random.default_rng(seed)
    P = rng.dirichlet(np.ones(K) * 0.5, N).T * scale
    E = rng.gamma(2.0, 2.0, (N, G))
    return rng.poisson(P @ E).astype(np.float32), P / P.sum(0)


# ---------------------------------------------------------------------------
# A_masks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", sorted(PATHS))
def test_masks_fix_each_chains_rank(path):
    M, _ = sim()
    ens = ChainEnsemble(M, N, n_chains=3, A_masks=MASKS, seed=1,
                        convergence_control=CC, device="cpu", **PATHS[path])
    assert ens.spec.learning_rank is False
    ens._run_chunk(6)
    chunk = ens._window[-1]
    np.testing.assert_array_equal(chunk["A"].numpy(),
                                  np.repeat(MASKS[:, None], 6, 1))
    np.testing.assert_array_equal(ens.states["params"]["R"].numpy(),
                                  MASKS.sum(1))
    rows = ens._metrics_all()
    np.testing.assert_array_equal(rows[:, :, 7], np.repeat(
        MASKS.sum(1)[:, None], 6, 1))
    assert np.isfinite(rows).all()
    with pytest.raises(ValueError, match="shape"):
        ChainEnsemble(M, N, n_chains=2, A_masks=MASKS, device="cpu",
                      **PATHS[path])


@pytest.mark.parametrize("path", sorted(PATHS))
def test_excluded_columns_draw_from_the_prior(path):
    """One step of three masked chains from the same state and draws on two
    data matrices: an excluded column of P and row of E (a prior draw, with
    the prior's parameters updated from P and E alone) come out the same,
    the included ones differ. On the conjugate path P and E are drawn from
    the latent counts of the step before, and the step's new counts give
    the excluded components none, whatever the data."""
    M1, _ = sim(0)
    M2, _ = sim(5, scale=60.0)
    ens = ChainEnsemble(M1, N, n_chains=3, A_masks=MASKS, seed=2,
                        device="cpu", **PATHS[path])
    spec, hp = ens.spec, ens.hp
    state = ens.states
    if spec.needs_Z:  # the latent counts of excluded components are 0
        for k, dim in (("Zsum_g", 1), ("Zsum_k", 2)):
            z = state["params"][k].clone()
            z.mul_(torch.as_tensor(MASKS).unsqueeze(dim))
            state["params"][k] = z
    gen = torch.Generator().manual_seed(9)
    u, noise = port_noise(spec, gen, tgibbs.streams_of(state))
    outs = []
    for M in (M1, M2):
        st = dict(state)
        st["params"] = dict(state["params"])
        new, out = tgibbs.gibbs_step(
            spec, torch.from_numpy(M), hp, st, 1.0,
            torch.zeros(3, dtype=torch.bool), u=u, noise=noise)
        outs.append(out | new["params"])
    ex = MASKS == 0
    for c, n in zip(*np.nonzero(ex)):
        assert torch.equal(outs[0]["P"][c, :, n], outs[1]["P"][c, :, n])
        assert torch.equal(outs[0]["E"][c, n], outs[1]["E"][c, n])
        if spec.needs_Z:
            assert (outs[0]["Zsum_g"][c, :, n] == 0).all()
            assert (outs[1]["Zsum_k"][c, n] == 0).all()
    key = ("Zsum_k", lambda x, c, n: x[c, n]) if spec.needs_Z else (
        "P", lambda x, c, n: x[c, :, n])
    for c, n in zip(*np.nonzero(~ex)):
        assert not torch.equal(key[1](outs[0][key[0]], c, n),
                               key[1](outs[1][key[0]], c, n))


def test_masks_with_a_rank_list_raise():
    M, _ = sim()
    with pytest.raises(ValueError, match="learned rank"):
        ChainEnsemble(M, [1, 2, 3], n_chains=3, A_masks=MASKS, device="cpu")


# ---------------------------------------------------------------------------
# fit(rank_method="BIC")
# ---------------------------------------------------------------------------


def test_fit_parallel_bic_returns_the_jax_layout():
    M, _ = sim()
    out = fit(M, [2, 3], rank_method="BIC", convergence_control=CC,
              output_dir=None, post_warmup=40, seed=0,
              hyperprior_params={"s_p": 2.0},
              init_params={"P": np.full((K, N), 1.0, np.float32)},
              device="cpu")
    assert set(out) == {"results", "best_rank", "sampler", "ensemble"}
    res = out["results"]
    assert {r["rank"] for r in res} == {2, 3}
    assert all(set(r) == {"rank", "chain", "dir", "BIC", "time"}
               for r in res)
    assert [r["BIC"] for r in res] == sorted(r["BIC"] for r in res)
    assert out["best_rank"] == res[0]["rank"]
    s = out["sampler"]
    assert s.credible_intervals is not None and "P" in s.credible_intervals
    assert s.chain == res[0]["chain"]
    ens = out["ensemble"]
    np.testing.assert_array_equal(ens.A_masks, [[1, 1, 0], [1, 1, 1]])
    assert ens.hp["s_p"] == 2.0


def test_fit_bic_routes_unsupported_kwargs_to_the_serial_loop(tmp_path):
    M, _ = sim()
    cc = bt.ConvergenceControl(MAP_over=10, MAP_every=10, miniters=10,
                               maxiters=30)
    with pytest.warns(UserWarning, match="exact_mh.*serial per-rank"):
        out = fit(M, [2, 3], rank_method="BIC", convergence_control=cc,
                  output_dir=None, post_warmup=10, seed=0, exact_mh=True,
                  device="cpu")
    assert isinstance(out["sampler"], GibbsSampler)
    assert set(out) == {"results", "best_rank", "sampler"}
    # parallel_bic=False runs the same loop: a directory per rank and the
    # winner saved at the parent
    od = str(tmp_path / "bic")
    out = fit(M, [2, 3], rank_method="BIC", convergence_control=cc,
              output_dir=od, post_warmup=10, seed=0, parallel_bic=False,
              MH=False, prior="exponential", device="cpu")
    assert {r["rank"] for r in out["results"]} == {2, 3}
    assert {r["dir"] for r in out["results"]} == {
        f"{od}/rank_2", f"{od}/rank_3"}
    assert (tmp_path / "bic" / "sampler.ckpt").exists()
    assert out["best_rank"] == out["results"][0]["rank"]
    assert out["sampler"].spec.N == out["best_rank"]


def test_gibbs_sampler_learns_a_rank_list_by_bic():
    """A rank list with rank_method='BIC' runs the inclusion sweep without
    the SBFI penalty, as the JAX sampler does."""
    M, _ = sim()
    cc = bt.ConvergenceControl(MAP_over=10, MAP_every=10, miniters=10,
                               maxiters=30)
    s = GibbsSampler(M, [1, 2, 3], rank_method="BIC", convergence_control=cc,
                     post_warmup=10, fused_sweeps=False, device="cpu")
    assert s.spec.learning_rank and s.spec.rank_method == "BIC"
    assert tgibbs.kernel_rank_method(s.spec) == "BFI"
    s.run_gibbs_sampler()
    assert np.isfinite(s.sample_metrics.to_numpy()).all()


# ---------------------------------------------------------------------------
# results and resume
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def finished():
    M, P_true = sim(3)
    cc = bt.ConvergenceControl(MAP_over=30, MAP_every=15, miniters=30,
                               maxiters=90, Ninarow_nochange=2,
                               Ninarow_nobest=3)
    ens = ChainEnsemble(M, N, n_chains=2, convergence_control=cc,
                        post_warmup=30, seed=4, fused_sweeps=False,
                        device="cpu")
    return ens.run(), P_true


def test_results_against_a_reference(finished):
    """The port's assign_signatures, summary and pooled_assignment against
    the JAX methods run on the same chains (the JAX class's functions on
    this ensemble object, with the JAX package's postprocessing)."""
    from bayesnmf_tpu.parallel.ensemble import ChainEnsemble as JCE

    ens, P_true = finished
    ref = P_true.astype(np.float64)
    got = ens.assign_signatures(ref)
    want = JCE.assign_signatures(ens, ref)
    assert sorted(got) == [0, 1]
    for c in got:
        a, b = got[c]["assignments"], want[c]["assignments"]
        assert list(a["sig_ref"]) == list(b["sig_ref"])
        np.testing.assert_allclose(a["MAP_cosine"], b["MAP_cosine"],
                                   rtol=1e-6)
        assert a["MAP_cosine"].min() > 0.9
    pooled = ens.pooled_assignment(ref)
    jpooled = JCE.pooled_assignment(ens, ref)
    assert list(pooled.columns) == ["sig_ref", "n_chains", "mean_cosine",
                                    "prop_chains"]
    assert list(pooled["sig_ref"]) == list(jpooled["sig_ref"])
    np.testing.assert_allclose(pooled["prop_chains"], jpooled["prop_chains"])
    summ = ens.summary(ref)
    assert list(summ.columns[:2]) == ["Chain", "G"]
    assert set(summ["Chain"]) == {0, 1} and len(summ) == 2 * N
    assert (summ["Cosine_Similarity"] > 0.9).all()


def resume_case(kind, tmp_path):
    M, _ = sim(4)
    cc = bt.ConvergenceControl(MAP_over=20, MAP_every=10, miniters=40,
                               maxiters=40, Ninarow_nochange=99,
                               Ninarow_nobest=99)
    kw = dict(n_chains=3, convergence_control=cc, post_warmup=10, seed=2,
              device="cpu")
    rank = [1, 2, 3]
    if kind == "normal":
        kw |= dict(likelihood="normal", hyperprior_params={"alpha": 2.0})
    elif kind == "conjugate":
        kw |= dict(prior="exponential", MH=False)
    else:
        rank = N
        kw |= dict(A_masks=MASKS)
    return M, rank, kw


@pytest.mark.parametrize("kind", ["normal", "conjugate", "masked"])
def test_resume_bit_exact(kind, tmp_path):
    M, rank, kw = resume_case(kind, tmp_path)
    e1 = ChainEnsemble(M, rank, **kw).run()
    e2 = ChainEnsemble(M, rank, output_dir=str(tmp_path / "run"), **kw)
    e2._run_chunk(19)
    e3 = ChainEnsemble.load(e2.save_object())
    assert e3.spec == e1.spec and e3.iter == 20
    if kind == "masked":
        np.testing.assert_array_equal(e3.A_masks, MASKS)
    e3.run()
    assert e3.iter == e1.iter
    for group in ("params", "prior"):
        assert sorted(e3.states[group]) == sorted(e1.states[group])
        for k, v in e1.states[group].items():
            np.testing.assert_array_equal(e3.states[group][k].numpy(),
                                          v.numpy(), err_msg=k)
    np.testing.assert_array_equal(e3._metrics_all(), e1._metrics_all())
    for c in range(3):
        np.testing.assert_array_equal(e3.MAP_per_chain[c]["P"],
                                      e1.MAP_per_chain[c]["P"])
    if kind == "normal":
        assert e1.hp["alpha"] == 2.0 and e1.hp["beta"] == 3.0
        assert "sigmasq" in e3.states["params"]
    if kind == "conjugate":
        assert e1.post_warmup == 0 and "acc_P" not in e1.states


def test_ensemble_hyperprior_defaults_match_the_sampler():
    M, _ = sim()
    ens = ChainEnsemble(M, 2, n_chains=2, likelihood="normal",
                        init_prior_params={"beta": 5.0}, device="cpu")
    want = default_hyperprior_params(ens.spec, float(M.mean()))
    assert ens.hp == want | {"alpha": 3.0, "beta": 5.0}
