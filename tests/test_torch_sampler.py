"""The port's sampler end to end on the CPU: recovery on the reference's
example data (fixed rank with MH, rank learning by SBFI, the exponential
prior with MH, conjugate Poisson-Gibbs, the Normal likelihood, the eager
sweeps), checkpoint resume, the model-math methods against the JAX
sampler's, the jax-free import, and the guards around what the single
sampler refuses (the fused kernel on a mesh, and ``stream_sweeps``, which
neither the JAX sampler nor the port's takes: the streaming kernels run in
ensembles)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bayesnmf_tpu_torch as bt
from bayesnmf_tpu.utils.assignment import hungarian_solve, pairwise_cosine
from bayesnmf_tpu.utils.rds import load_example_data
from bayesnmf_tpu_torch.models.sampler import GibbsSampler

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def matched_cosines(P_est, P_true):
    sim = pairwise_cosine(P_est, P_true)
    cols = hungarian_solve(-sim)
    return np.array([sim[i, c] for i, c in enumerate(cols) if c >= 0])


def sim_data(seed=0, K=16, N=3, G=24, scale=100.0):
    rng = np.random.default_rng(seed)
    P = rng.dirichlet(np.ones(K) * 0.5, N).T * scale
    E = rng.gamma(2.0, 2.0, (N, G))
    return rng.poisson(P @ E).astype(np.float32)


def test_slice_recovers_example_signatures():
    """The bar of tests/test_reference_parity.py::test_fixed_rank_recovery_mh,
    through the port's fit on the CPU path."""
    d = load_example_data()
    M = np.asarray(d["M"], np.float32)
    P_true = np.asarray(d["P"], np.float32)
    cc = bt.ConvergenceControl(MAP_over=100, MAP_every=50, miniters=100,
                               maxiters=600, Ninarow_nochange=3,
                               Ninarow_nobest=5)
    s = bt.fit(M, 4, convergence_control=cc, post_warmup=100, seed=0,
               device="cpu", output_dir=None)
    cos = matched_cosines(s.MAP["P"], P_true)
    assert cos.min() > 0.9, cos
    assert cos.mean() > 0.95, cos
    df = s.sample_metrics
    assert df.shape[0] == s.iter
    assert np.isfinite(df.to_numpy()).all()
    # the JAX package's postprocessing reads the port's numpy results
    res = s.assign_signatures_ensemble("cosmic")
    assert len(res["assignments"]) == 4


@pytest.fixture(scope="module")
def example():
    d = load_example_data()
    return np.asarray(d["M"], np.float32), np.asarray(d["P"], np.float32)


def test_sbfi_learns_the_example_rank(example):
    """tests/test_reference_parity.py::test_rank_learning_recovers_4 through
    the port's fit: ranks 1..7 by SBFI learn 4, matched cosine min > 0.9."""
    M, P_true = example
    cc = bt.ConvergenceControl(MAP_over=100, MAP_every=50, miniters=100,
                               maxiters=1500, Ninarow_nochange=3,
                               Ninarow_nobest=6)
    s = bt.fit(M, range(1, 8), rank_method="SBFI", convergence_control=cc,
               prop_temp=0.3, post_warmup=200, seed=0, device="cpu",
               output_dir=None)
    assert s.rank == list(range(0, 8)) and s.spec.N == 7
    assert int(np.asarray(s.MAP["A_full"]).sum()) == 4
    cos = matched_cosines(s.MAP["P"], P_true)
    assert cos.min() > 0.9, cos
    ranks = s.sample_metrics["rank"].to_numpy()
    assert len(np.unique(ranks)) > 1  # the rank moved while tempering
    assert np.isfinite(s.sample_metrics.to_numpy()).all()


@pytest.mark.parametrize("MH,seed", [(True, 1), (False, 1)])
def test_exponential_prior_recovers_example_signatures(example, MH, seed):
    """The bar of test_reference_parity.py::test_fixed_rank_recovery_gibbs
    (min > 0.85) for the exponential prior, with MH through the fused
    kernel and conjugate (MH=False) through the allocation kernel."""
    M, P_true = example
    cc = bt.ConvergenceControl(MAP_over=100, MAP_every=50, miniters=100,
                               maxiters=500, Ninarow_nochange=3,
                               Ninarow_nobest=5)
    s = bt.fit(M, 4, prior="exponential", MH=MH, convergence_control=cc,
               post_warmup=100, seed=seed, device="cpu", output_dir=None)
    cos = matched_cosines(s.MAP["P"], P_true)
    assert cos.min() > 0.85, cos
    df = s.sample_metrics
    assert np.isfinite(df.to_numpy()).all()
    if not MH:  # no post-warmup MH phase, acceptance recorded as 1
        assert s.iter <= cc.maxiters
        assert (df["P_mean_acceptance_rate"] == 1.0).all()
        Zg = s.state["params"]["Zsum_g"].numpy()
        np.testing.assert_array_equal(Zg.sum(1), M.sum(1))


EXAMPLE_CC = dict(MAP_over=100, MAP_every=50, miniters=100, maxiters=600,
                  Ninarow_nochange=3, Ninarow_nobest=5)


@pytest.mark.parametrize("kw,seed", [
    (dict(likelihood="normal", prior="truncnormal"), 1),
    (dict(likelihood="normal", prior="exponential"), 1),
    (dict(likelihood="poisson", prior="truncnormal", fused_sweeps=False), 0),
])
def test_eager_paths_recover_example_signatures(example, kw, seed):
    """The Normal likelihood with either prior and Poisson-TruncNormal MH on
    the eager sweeps (fused_sweeps=False), at rank 4 with the convergence
    control of test_slice_recovers_example_signatures: matched cosine
    min > 0.9, and for the Poisson fit mean > 0.95 as there. With the
    Normal likelihood a few chains in a hundred, in either package, settle
    within 600 iterations in a poorer mode of this posterior (the JAX
    step's chains do so as often from the port's initial states as from
    its own); seed 0 of the port's generator is one, so the Normal fits
    run seed 1."""
    M, P_true = example
    cc = bt.ConvergenceControl(**EXAMPLE_CC)
    s = bt.fit(M, 4, convergence_control=cc, post_warmup=100, seed=seed,
               device="cpu", output_dir=None, **kw)
    assert not s.spec.fused_sweeps
    cos = matched_cosines(s.MAP["P"], P_true)
    assert cos.min() > 0.9, cos
    if kw["likelihood"] == "poisson":
        assert cos.mean() > 0.95, cos
    else:
        assert s.state["params"]["sigmasq"].shape == (M.shape[1],)
        assert (s.state["params"]["sigmasq"] > 0).all()
    assert np.isfinite(s.sample_metrics.to_numpy()).all()


def test_normal_sbfi_learns_a_rank_near_the_example_rank(example):
    """Ranks 1..7 by SBFI with the Normal likelihood: a learned rank in
    3..5 (the JAX package learns 4 or 5 here, and 2-4 with the exponential
    prior) and finite metrics."""
    M, P_true = example
    cc = bt.ConvergenceControl(**(EXAMPLE_CC | dict(maxiters=1000)))
    s = bt.fit(M, range(1, 8), likelihood="normal", convergence_control=cc,
               prop_temp=0.3, seed=0, device="cpu", output_dir=None)
    rank = int(np.asarray(s.MAP["A_full"]).sum())
    assert 3 <= rank <= 5, rank
    assert matched_cosines(s.MAP["P"], P_true).min() > 0.9
    assert len(np.unique(s.sample_metrics["rank"].to_numpy())) > 1
    assert np.isfinite(s.sample_metrics.to_numpy()).all()


@pytest.mark.parametrize("likelihood", ["normal", "poisson"])
def test_model_math_methods_match_jax(likelihood):
    """get_Mhat, get_loglik (sum and matrix) and get_logpost on the same
    state and data as the JAX sampler's methods, and with parameters
    given."""
    import jax
    import jax.numpy as jnp
    from bayesnmf_tpu.models.sampler import GibbsSampler as JSampler

    M = sim_data(seed=5)
    kw = dict(likelihood=likelihood, seed=2, verbosity=0)
    s = GibbsSampler(M, 3, fused_sweeps=False, device="cpu", **kw)
    s._run_chunk(4, accept_all=s.spec.MH)
    js = JSampler(M, 3, **kw)
    st = {g: {k: np.asarray(v) for k, v in s.state[g].items()}
          for g in ("params", "prior")}
    js.state = jax.tree.map(jnp.asarray, st)
    rtol = 1e-5
    np.testing.assert_allclose(s.get_Mhat().numpy(),
                               np.asarray(js.get_Mhat()), rtol=rtol)
    np.testing.assert_allclose(float(s.get_loglik()),
                               float(js.get_loglik()), rtol=rtol)
    np.testing.assert_allclose(s.get_loglik(return_matrix=True).numpy(),
                               np.asarray(js.get_loglik(return_matrix=True)),
                               rtol=rtol, atol=1e-4)
    np.testing.assert_allclose(float(s.get_logpost()),
                               float(js.get_logpost()), rtol=rtol)
    given = dict(P=st["params"]["P"] * 1.1, A=np.array([1, 0, 1], np.float32),
                 E=st["params"]["E"])
    if likelihood == "normal":
        given["sigmasq"] = st["params"]["sigmasq"] * 2.0
    np.testing.assert_allclose(float(s.get_loglik(**given)),
                               float(js.get_loglik(**given)), rtol=rtol)
    np.testing.assert_allclose(float(s.get_logpost(**given)),
                               float(js.get_logpost(**given)), rtol=rtol)


@pytest.mark.parametrize("change,MH,ok", [
    (0.5, False, False), (-1.0, False, False), (0.5, True, True),
    (0.0, False, True)])
def test_conjugate_path_takes_integer_counts(change, MH, ok):
    """The conjugate path refuses data that are not non-negative integer
    counts (the allocation kernel's stopping inversion matches the
    reference only on integers); the MH path takes any data."""
    M = sim_data(seed=3)
    if change < 0:
        M[0, 0] = change
    else:
        M = M + np.float32(change)
    make = lambda: GibbsSampler(M, 3, prior="exponential", MH=MH,  # noqa
                                seed=0, device="cpu", output_dir=None,
                                verbosity=0)
    if ok:
        make()
    else:
        with pytest.raises(ValueError, match="integer counts"):
            make()


def small_cc():
    return bt.ConvergenceControl(MAP_over=20, MAP_every=10, miniters=20,
                                 maxiters=40, Ninarow_nochange=2,
                                 Ninarow_nobest=3)


@pytest.mark.parametrize("value", [False, None, True])
def test_fused_allocation_is_taken_and_selects_nothing(value):
    """GibbsSampler takes the JAX sampler's ``fused_allocation``
    (sampler.py:99, :134-144): None resolves to False as off a TPU, the
    value is validated into the spec, and the conjugate fit is the fit
    without the argument (the port has one allocation)."""
    M = sim_data(seed=3)
    kw = dict(prior="exponential", MH=False, seed=2, device="cpu",
              output_dir=None, verbosity=0, convergence_control=small_cc())
    a = GibbsSampler(M, 2, fused_allocation=value, **kw)
    assert a.spec.fused_allocation is bool(value)
    a.run_gibbs_sampler()
    b = GibbsSampler(M, 2, **kw).run_gibbs_sampler()
    np.testing.assert_array_equal(a.sample_metrics.to_numpy(),
                                  b.sample_metrics.to_numpy())
    for k, v in b.state["params"].items():
        np.testing.assert_array_equal(a.state["params"][k].numpy(),
                                      v.numpy(), err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(prior="exponential", MH=True),
    dict(prior="truncnormal", MH=True),
    dict(likelihood="normal", prior="truncnormal"),
])
def test_fused_allocation_outside_conjugate_gibbs_raises_as_jax(kw):
    """fused_allocation=True with MH or the Normal likelihood raises the
    JAX sampler's ModelError, with its message."""
    from bayesnmf_tpu.config import ModelError as JModelError
    from bayesnmf_tpu.models.sampler import GibbsSampler as JGibbsSampler

    from bayesnmf_tpu_torch.config import ModelError

    M = sim_data(seed=3)
    with pytest.raises(JModelError) as want:
        JGibbsSampler(M, 2, fused_allocation=True, output_dir=None,
                      verbosity=0, **kw)
    with pytest.raises(ModelError) as got:
        GibbsSampler(M, 2, fused_allocation=True, device="cpu",
                     output_dir=None, verbosity=0, **kw)
    assert str(got.value) == str(want.value)
    assert "fused_allocation" in str(got.value)


def test_fit_forwards_fused_allocation():
    """``fit`` hands fused_allocation to the sampler, as the JAX fit does
    through its keywords; under rank_method='BIC' the ensemble does not
    take it, so the search runs rank by rank with the JAX package's
    warning (tests/test_ensemble_surface.py:142)."""
    from bayesnmf_tpu_torch.config import ModelError

    M = sim_data(seed=3)
    kw = dict(prior="exponential", device="cpu", output_dir=None,
              verbosity=0, convergence_control=small_cc())
    s = bt.fit(M, 2, MH=False, fused_allocation=True, **kw)
    assert s.spec.fused_allocation is True and s.iter > 1
    with pytest.raises(ModelError, match="fused_allocation"):
        bt.fit(M, 2, MH=True, fused_allocation=True, **kw)
    with pytest.warns(UserWarning, match="fused_allocation.*serial per-rank"):
        res = bt.fit(M, [1, 2], rank_method="BIC", MH=False,
                     fused_allocation=False, **kw)
    assert res["best_rank"] in (1, 2)
    assert res["sampler"].spec.fused_allocation is False


@pytest.mark.parametrize("kw", [
    dict(rank=range(1, 4), rank_method="BFI"),
    dict(rank=3, prior="exponential", MH=False),
    dict(rank=[1, 3], prior="exponential", MH=False, rank_method="SBFI"),
    dict(rank=3, likelihood="normal"),
    dict(rank=[1, 3], likelihood="normal", prior="exponential",
         rank_method="BFI"),
    dict(rank=3, fused_sweeps=False),
    dict(rank=3, prior="exponential", fused_sweeps=False, exact_mh=False),
])
def test_new_paths_resume_bit_exact(tmp_path, kw):
    """An interrupted run resumed from its checkpoint ends where the
    uninterrupted one does: rank learning in the fused kernel, the
    conjugate path at a fixed and a learned rank (the generator state, the
    latent counts' sums and Lambda are carried), the Normal likelihood
    (sigmasq and its prior carried) and the eager Poisson sweeps."""
    M = sim_data(seed=11)
    cc = bt.ConvergenceControl(MAP_over=20, MAP_every=10, miniters=20,
                               maxiters=60, Ninarow_nochange=2,
                               Ninarow_nobest=3)
    base = dict(convergence_control=cc, post_warmup=20, seed=4,
                device="cpu") | kw
    s1 = GibbsSampler(M, **base)
    s1.run_gibbs_sampler()
    s2 = GibbsSampler(M, output_dir=str(tmp_path / "run"), **base)
    s2._run_chunk(9, accept_all=s2.spec.MH)
    s3 = GibbsSampler.load(s2.save_object())
    s3.run_gibbs_sampler()
    assert s3.iter == s1.iter
    for group in ("params", "prior"):
        assert sorted(s3.state[group]) == sorted(s1.state[group])
        for k, v in s1.state[group].items():
            np.testing.assert_array_equal(s3.state[group][k].numpy(),
                                          v.numpy(), err_msg=k)
    np.testing.assert_array_equal(s3.sample_metrics.to_numpy(),
                                  s1.sample_metrics.to_numpy())


def test_checkpoint_resume_bit_exact(tmp_path):
    M = sim_data(seed=7)
    cc = bt.ConvergenceControl(MAP_over=20, MAP_every=10, miniters=20,
                               maxiters=60, Ninarow_nochange=2,
                               Ninarow_nobest=3)
    kw = dict(convergence_control=cc, post_warmup=20, seed=9, device="cpu")
    s1 = GibbsSampler(M, 3, **kw)
    s1.run_gibbs_sampler()
    # interrupted run: iterations 2..10, checkpoint, resume
    s2 = GibbsSampler(M, 3, output_dir=str(tmp_path / "run"), **kw)
    s2._run_chunk(9, accept_all=True)
    path = s2.save_object()
    s3 = GibbsSampler.load(path)
    assert s3.iter == s2.iter == 10
    s3.run_gibbs_sampler()
    assert s3.tracker.converged and s3.iter == s1.iter
    for k in ("P", "E"):
        np.testing.assert_array_equal(s3.state["params"][k].numpy(),
                                      s1.state["params"][k].numpy())
    np.testing.assert_array_equal(s3.sample_metrics.to_numpy(),
                                  s1.sample_metrics.to_numpy())
    log = (tmp_path / "run" / "log.txt").read_text()
    assert "Starting Gibbs sampler" in log and "Sampler done" in log


def test_imports_without_jax():
    """The port imports neither jax nor anything of the JAX package: both
    are blocked in sys.modules, and every module of the port imports,
    the mesh layer too (its multi-process workers check the same in
    tests/test_torch_multiproc.py)."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['bayesnmf_tpu'] = None\n"
        "import bayesnmf_tpu_torch as bt\n"
        "from bayesnmf_tpu_torch import config\n"
        "from bayesnmf_tpu_torch.models import sampler, gibbs, state, "
        "map_estimate, convergence, updates\n"
        "from bayesnmf_tpu_torch.ops import fused_sweeps, stream_sweeps, "
        "allocation, special, math, distributions, _build\n"
        "from bayesnmf_tpu_torch.parallel import chains, ensemble, mesh, "
        "multihost\n"
        "assert multihost.initialize() is False\n"
        "assert mesh.make_mesh(device='cpu').size == 1\n"
        "from bayesnmf_tpu_torch.utils import checkpoint, logging, "
        "assignment, cosmic, postprocessing, plotting\n"
        "assert bt.fit is sampler.fit\n"
        "assert bt.ChainEnsemble is ensemble.ChainEnsemble\n"
        "assert cosmic.get_cosmic().shape == (96, 79)\n"
        "assert sys.modules['jax'] is None\n"
        "assert sys.modules['bayesnmf_tpu'] is None\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_source_of_the_port_imports_jax():
    """No file of the port, and not chip_smoke.py, names jax or the JAX
    package in an import."""
    import re

    pat = re.compile(r"^\s*(import jax|from jax|import bayesnmf_tpu\b(?!_)"
                     r"|from bayesnmf_tpu(\.| ))", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "bayesnmf_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = [f for f in files if pat.search(open(f).read())]
    assert not offenders, offenders


def test_cuda_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        GibbsSampler(sim_data(), 3)  # device="cuda" is the default


@pytest.mark.parametrize("kw", [
    dict(mesh="a one-process mesh", fused_sweeps=True),
    dict(stream_sweeps=True),
])
def test_outside_the_slice_raises(kw):
    """What the single sampler refuses: the fused kernel on a mesh, as the
    JAX package refuses it (ValueError), and a ``stream_sweeps`` argument,
    which the JAX sampler does not take either (TypeError): the streaming
    kernels run in ensembles only."""
    from bayesnmf_tpu_torch.parallel.mesh import make_mesh

    args = dict(rank=3, device="cpu") | kw
    if "mesh" in kw:
        args["mesh"] = make_mesh(device="cpu")
        with pytest.raises(ValueError, match="fused_sweeps"):
            GibbsSampler(sim_data(), **args)
        return
    with pytest.raises(TypeError, match="stream_sweeps"):
        GibbsSampler(sim_data(), **args)
