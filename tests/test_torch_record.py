"""The port's recording surface on the CPU: ``record_history='full'`` and
``samples``/``posterior_summary`` on the single sampler against the JAX
sampler's keys and shapes (tests/test_observability.py:69-101), the
ensemble's full history and archive (tests/test_ensemble_surface.py:31-60,
:220-260), the chain view's model math live and after compaction,
``fit(rank_method='BIC')`` with the recording options as one ensemble, resume
with the archive, and the package's lazy exports."""

import warnings

import numpy as np
import pytest
import torch

import bayesnmf_tpu as jbn
import bayesnmf_tpu_torch as bt
from bayesnmf_tpu.utils.rds import load_example_data as jax_example_data
from bayesnmf_tpu_torch.models.sampler import GibbsSampler
from bayesnmf_tpu_torch.ops import math as m
from bayesnmf_tpu_torch.parallel.ensemble import (
    ChainEnsemble,
    _ChainView,
    _select,
)
from bayesnmf_tpu_torch.utils import plotting

torch.set_num_threads(1)


def small_data(seed=0, K=8, N=2, G=12):
    rng = np.random.default_rng(seed)
    P = rng.dirichlet(np.ones(K), N).T * 30.0
    return rng.poisson(P @ rng.gamma(2.0, 2.0, (N, G))).astype(np.float32)


SAMPLER_CASES = {
    "normal_exponential": dict(likelihood="normal", prior="exponential"),
    "poisson_exponential_mh": dict(likelihood="poisson", prior="exponential",
                                   MH=True),
    "poisson_truncnormal_eager": dict(fused_sweeps=False),
    "poisson_gamma": dict(prior="gamma"),
}


@pytest.mark.parametrize("case", sorted(SAMPLER_CASES))
def test_sampler_full_history_matches_the_jax_keys(case):
    """The same config through both samplers with record_history='full':
    ``samples`` has the same keys and shapes (the prior parameters under
    their names, sigmasq with the Normal likelihood, acc_P/acc_E with MH),
    every value finite and every acceptance entry in [0, 1]."""
    data = small_data()
    kw = dict(convergence_control=bt.ConvergenceControl(
        MAP_over=10, MAP_every=5, miniters=5, maxiters=15),
        record_history="full", post_warmup=5, seed=2) | SAMPLER_CASES[case]
    jkw = {k: v for k, v in kw.items() if k != "convergence_control"}
    js = jbn.GibbsSampler(data, 2, convergence_control=jbn.ConvergenceControl(
        MAP_over=10, MAP_every=5, miniters=5, maxiters=15), **jkw)
    js.run_gibbs_sampler()
    s = GibbsSampler(data, 2, device="cpu", **kw)
    s.run_gibbs_sampler()
    want, got = js.samples, s.samples
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert np.shape(got[k]) == np.shape(v), k
        if k != "start_iter":
            assert np.isfinite(got[k]).all(), k
    for k in ("acc_P", "acc_E"):
        if k in got:
            assert np.all((got[k] >= 0) & (got[k] <= 1))
    assert got["start_iter"] == 1 and got["P"].shape[0] == s.iter


def test_posterior_summary_and_its_key_error():
    """posterior_summary over the recorded history (the JAX test's
    sigmasq case, tests/test_observability.py:69-88), and the KeyError the
    JAX sampler raises for a name a basic record lacks."""
    data = small_data()
    cc = bt.ConvergenceControl(MAP_over=30, MAP_every=7, miniters=10,
                               maxiters=40)
    s = GibbsSampler(data, 2, likelihood="normal", prior="exponential",
                     convergence_control=cc, record_history="full",
                     post_warmup=0, seed=1, device="cpu")
    s.run_gibbs_sampler()
    h = s.samples
    assert h["sigmasq"].shape == (40, 12) and h["Lambda_p"].shape == (40, 8, 2)
    summ = s.posterior_summary("sigmasq", q=(0.1, 0.9))
    assert summ["mean"].shape == (12,) and summ["n_samples"] == 40
    np.testing.assert_allclose(summ["mean"], h["sigmasq"].mean(0))
    assert sorted(summ["quantiles"]) == [0.1, 0.9]
    assert np.all(summ["quantiles"][0.1] <= summ["quantiles"][0.9])
    basic = dict(convergence_control=cc, post_warmup=0, seed=1)
    s2 = GibbsSampler(data, 2, likelihood="normal", prior="exponential",
                      device="cpu", **basic)
    s2.run_gibbs_sampler()
    js = jbn.GibbsSampler(data, 2, likelihood="normal", prior="exponential",
                          **basic | {"convergence_control":
                                     jbn.ConvergenceControl(**vars(cc))})
    js.run_gibbs_sampler()
    with pytest.raises(KeyError) as got:
        s2.posterior_summary("sigmasq")
    with pytest.raises(KeyError) as want:
        js.posterior_summary("sigmasq")
    assert str(got.value) == str(want.value)


CC = bt.ConvergenceControl(MAP_over=40, MAP_every=20, miniters=40,
                           maxiters=120, Ninarow_nochange=2, Ninarow_nobest=3)


def sim(seed=0, K=16, N=3, G=24):
    rng = np.random.default_rng(seed)
    P = rng.dirichlet(np.ones(K) * 0.5, N).T * 40
    return rng.poisson(P @ rng.gamma(2.0, 2.0, (N, G))).astype(np.float32)


ENSEMBLE_CASES = {
    "fused": (dict(fused_sweeps=True, hyperprior_params={"s_p": 2.5}),
              ("Mu_p", "Sigmasq_p", "Mu_e", "Sigmasq_e", "acc_P", "acc_E")),
    "stream": (dict(stream_sweeps=True, rank=[1, 2, 3]),
               ("Mu_p", "Sigmasq_p", "Mu_e", "Sigmasq_e", "acc_P", "acc_E")),
    "gamma": (dict(prior="gamma"), ("Alpha_p", "Beta_p", "Alpha_e", "Beta_e")),
    "normal": (dict(likelihood="normal", prior="exponential"),
               ("Lambda_p", "Lambda_e", "sigmasq")),
}


@pytest.mark.parametrize("case", sorted(ENSEMBLE_CASES))
def test_ensemble_full_history(case):
    """record_history='full' on an ensemble's path: each chain's samples
    carry the prior parameters and, per path, the acceptance records or
    sigmasq, per draw (tests/test_ensemble_surface.py:45-54), and
    posterior_summary reads them; acceptance entries lie in [0, 1]."""
    kw, names = ENSEMBLE_CASES[case]
    kw = dict(rank=3) | kw
    e = ChainEnsemble(sim(), n_chains=3, convergence_control=CC,
                      post_warmup=40, seed=0, record_history="full",
                      device="cpu", **kw)
    e.run()
    for c in range(3):
        s = e.chain(c).samples
        S = s["P"].shape[0]
        assert S > 0
        for k in ("P", "E", "A") + names:
            assert k in s and s[k].shape[0] == S, k
        want = e.states["prior"][names[0]].shape[1:]
        assert s[names[0]].shape == (S,) + want
        for k in ("acc_P", "acc_E"):
            if k in s:
                assert np.all((s[k] >= 0) & (s[k] <= 1))
    summ = e.chain(0).posterior_summary(names[-1])
    assert summ["mean"].shape == s[names[-1]].shape[1:]


@pytest.fixture(scope="module")
def ens_arch():
    cc = bt.ConvergenceControl(MAP_over=20, MAP_every=10, miniters=30,
                               maxiters=60, Ninarow_nochange=2,
                               Ninarow_nobest=3)
    e = ChainEnsemble(sim(3), 3, n_chains=3, convergence_control=cc,
                      post_warmup=20, seed=1, save_all_samples=True,
                      record_history="full", device="cpu")
    return e.run()


def test_archive_label_switching_and_far_past_window(ens_arch):
    """save_all_samples on an ensemble: the label-switching plot over a
    chain's whole history, the plot suite on the chain's view, and a
    get_MAP window older than the retained chunks
    (tests/test_ensemble_surface.py:233-260); without an archive the first
    and the last raise."""
    import matplotlib.pyplot as plt

    e = ens_arch
    v = e.chain(0)
    arch = v._archive
    assert arch and arch[0]["start_iter"] == 2
    assert sum(ch["P"].shape[0] for ch in arch) == e.iter - 1
    assert "Mu_e" in arch[0]["prior"] and "acc_E" in arch[0]
    ref = np.random.default_rng(0).random((e.spec.K, 5)) + 0.1
    fig = plotting.plot_label_switching(v, reference_P=ref)
    assert fig is not None
    plt.close(fig)
    # the whole plot suite on the view (the label-switching plot only
    # with rank learning)
    figs = plotting.plot_sampler(v, reference_P=ref, save=False)
    assert {"summary", "similarity_heatmap", "signature_dist"} <= set(figs)
    res = v.get_MAP(end_iter=12, n_samples=8)
    assert res["idx"].max() <= 12 and len(res["idx"]) <= 8
    # the window came from the archive: iterations 5..12 of chain 0
    P_h, _, A_h = v._gather_window(12, 8)
    want = np.concatenate([ch["P"] for ch in arch])[3:11]
    np.testing.assert_array_equal(P_h, want)
    e2 = ChainEnsemble(sim(3), 3, n_chains=3, convergence_control=e.cc,
                       post_warmup=20, seed=1, device="cpu")
    e2.run()
    with pytest.raises(ValueError):
        plotting.plot_label_switching(e2.chain(0), reference_P=ref)
    with pytest.raises(ValueError):
        e2.chain(0).get_MAP(end_iter=12, n_samples=8)


def check_math(view, state):
    """The view's model math against ops/math on a chain's state."""
    P, A, E = (torch.as_tensor(state["params"][k]) for k in "PAE")
    Mh = m.mhat(P, A, E)
    np.testing.assert_array_equal(view.get_Mhat().numpy(), Mh.numpy())
    ll = m.loglik_mat(view.data, Mh, "poisson")
    np.testing.assert_array_equal(view.get_loglik(return_matrix=True).numpy(),
                                  ll.numpy())
    prior = {k: torch.as_tensor(v) for k, v in state["prior"].items()}
    lp = ll.sum() + m.logprior_PE(P, E, view.spec.prior, prior)
    np.testing.assert_allclose(view.get_logpost().numpy(), lp.numpy(),
                               rtol=1e-6)
    assert np.isfinite(view.get_logpost().numpy())


@pytest.mark.parametrize("prior", ["truncnormal", "gamma"])
def test_view_model_math_live_and_after_compaction(prior):
    """get_Mhat/get_loglik/get_logpost of a chain's view equal ops/math on
    that chain's state: its device state while resident, and after it was
    finalised and compacted away, the last draw of its final window (the
    prior parameters there only under record_history='full'; a basic
    record raises for them)."""
    kw = dict(MH=False) if prior == "gamma" else {}
    cc = bt.ConvergenceControl(MAP_over=10, MAP_every=10, miniters=20,
                               maxiters=40, Ninarow_nochange=99,
                               Ninarow_nobest=99)
    for record in ("full", "basic"):
        e = ChainEnsemble(sim(2), 3, n_chains=3, convergence_control=cc,
                          post_warmup=10, seed=3, prior=prior,
                          record_history=record, device="cpu", **kw)
        e._run_chunk(9)
        view = _ChainView(e, 1)  # chain() would finalise every chain
        assert view._live_slot() == 1
        live = {g: {k: x[1].numpy() for k, x in e.states[g].items()}
                for g in ("params", "prior")}
        check_math(view, live)
        # chain 1 finishes: finalised, then compacted off the device
        e.tracker.converged[1] = True
        e._end_iter[1] = e.iter
        e._finalize_chain(1)
        e._maybe_compact()
        assert view._live_slot() is None and list(e._slots) == [0, 2]
        if record == "basic":
            with pytest.raises(ValueError, match="record_history='full'"):
                view.get_logpost()
            continue
        check_math(view, live)
        assert sorted(view._current("prior")) == sorted(live["prior"])
        e.run()
        check_math(view, live)  # the view keeps reading the final window


def test_fit_bic_with_recording_runs_as_one_ensemble(tmp_path):
    """fit(rank_method='BIC') takes save_all_samples and record_history into
    its one ensemble (no fallback to the serial loop), and the winner has
    the single sampler's surface."""
    M = sim(4)
    cc = bt.ConvergenceControl(MAP_over=20, MAP_every=10, miniters=20,
                               maxiters=40)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = bt.fit(M, [2, 3], rank_method="BIC", convergence_control=cc,
                     output_dir=str(tmp_path / "bic"), post_warmup=20,
                     seed=0, save_all_samples=True, record_history="full",
                     device="cpu")
    ens, s = out["ensemble"], out["sampler"]
    assert ens._archive and ens.record == "full"
    h = s.samples
    assert {"P", "E", "A", "Mu_p", "acc_E"} <= set(h)
    assert np.isfinite(float(s.get_logpost()))
    assert s.get_Mhat().shape == M.shape
    assert s.get_loglik(return_matrix=True).shape == M.shape
    assert np.isfinite(float(s.get_loglik()))
    summ = s.summary(np.random.default_rng(0).random((16, 4)) + 0.1)
    assert len(summ) == out["best_rank"]
    path = s.save_object(str(tmp_path / "winner.ckpt"))
    again = ChainEnsemble.load(path)
    assert again.record == "full" and len(again._archive) == len(ens._archive)


def test_ensemble_resume_with_the_archive_bit_exact(tmp_path):
    """An interrupted recorded ensemble resumed from its checkpoint ends
    where the uninterrupted one does, its archive and recorded windows
    included."""
    M = sim(5)
    cc = bt.ConvergenceControl(MAP_over=20, MAP_every=10, miniters=40,
                               maxiters=40, Ninarow_nochange=99,
                               Ninarow_nobest=99)
    kw = dict(n_chains=3, convergence_control=cc, post_warmup=10, seed=2,
              stream_sweeps=True, save_all_samples=True,
              record_history="full", device="cpu")
    e1 = ChainEnsemble(M, [1, 2, 3], **kw).run()
    e2 = ChainEnsemble(M, [1, 2, 3], output_dir=str(tmp_path / "run"), **kw)
    e2._run_chunk(9)  # iterations 2..10, the first chunk of e1's run
    e3 = ChainEnsemble.load(e2.save_object())
    e3.run()
    assert e3.iter == e1.iter and len(e3._archive) == len(e1._archive)
    for a, b in zip(e3._archive, e1._archive):
        for k in ("P", "E", "A", "acc_P", "acc_E"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for k, v in b["prior"].items():
            np.testing.assert_array_equal(a["prior"][k], v, err_msg=k)
        np.testing.assert_array_equal(a["chain_ids"], b["chain_ids"])
    for c in range(3):
        for k, v in e1.chain(c).samples.items():
            np.testing.assert_array_equal(e3.chain(c).samples[k], v)


def test_sampler_resume_with_the_archive_bit_exact(tmp_path):
    """The same for the single sampler with record_history='full'."""
    M = sim(6)
    cc = bt.ConvergenceControl(MAP_over=20, MAP_every=10, miniters=20,
                               maxiters=40, Ninarow_nochange=2,
                               Ninarow_nobest=3)
    kw = dict(convergence_control=cc, post_warmup=20, seed=4,
              record_history="full", device="cpu")
    s1 = GibbsSampler(M, 3, **kw)
    s1.run_gibbs_sampler()
    s2 = GibbsSampler(M, 3, output_dir=str(tmp_path / "run"), **kw)
    s2._run_chunk(9, accept_all=True)
    s3 = GibbsSampler.load(s2.save_object())
    s3.run_gibbs_sampler()
    assert s3.record == "full" and s3.iter == s1.iter
    for k, v in s1.samples.items():
        np.testing.assert_array_equal(s3.samples[k], v, err_msg=k)


def test_lazy_exports_and_example_data():
    """The JAX package's top-level names (bayesnmf_tpu/__init__.py:22-51)
    and the port's own reader of the example data, equal to the JAX
    reader's arrays."""
    assert bt.bayesNMF is bt.fit
    assert bt.new_convergence_control(maxiters=300) == bt.ConvergenceControl(
        maxiters=300)
    assert bt.get_cosmic().shape == (96, 79)
    assert set(bt.get_cosmic_colors()) == set(jbn.get_cosmic_colors())
    assert callable(bt.download_cosmic)
    a = np.random.default_rng(0).random((5, 3))
    np.testing.assert_allclose(bt.pairwise_sim(a, a), jbn.pairwise_sim(a, a))
    assert callable(bt.hungarian_assignment)
    assert callable(bt.summarize_samplers)
    assert bt.__version__ == jbn.__version__
    with pytest.raises(AttributeError):
        bt.not_a_name  # noqa: B018
    from bayesnmf_tpu_torch.utils.rds import load_example_data

    got, want = load_example_data(), jax_example_data()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


def test_select_keeps_every_state_tensor():
    """Compaction's index-select reaches the gamma prior's parameters."""
    st = {"params": {"P": torch.arange(6.0).view(3, 2)},
          "prior": {"Alpha_p": torch.arange(3.0)}, "iter": 4}
    out = _select(st, torch.tensor([0, 2]))
    assert out["prior"]["Alpha_p"].tolist() == [0.0, 2.0] and out["iter"] == 4
