"""The port's sampler end to end on the CPU: recovery on the reference's
example data, checkpoint resume, the jax-free import, and the guards around
what is not ported yet."""

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
    are blocked in sys.modules, and every module of the port imports."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['bayesnmf_tpu'] = None\n"
        "import bayesnmf_tpu_torch as bt\n"
        "from bayesnmf_tpu_torch import config\n"
        "from bayesnmf_tpu_torch.models import sampler, gibbs, state, "
        "map_estimate, convergence, updates\n"
        "from bayesnmf_tpu_torch.ops import fused_sweeps, stream_sweeps, "
        "special, math, distributions, _build\n"
        "from bayesnmf_tpu_torch.parallel import chains, ensemble\n"
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
    dict(rank=[1, 2, 3]),
    dict(mesh=object()),
    dict(prior="exponential"),
    dict(likelihood="normal"),
    dict(exact_mh=False),
    dict(exact_truncnorm_hypers=False),
    dict(stream_sweeps=True),
    dict(fused_sweeps=False),
    dict(record_history="full"),
])
def test_outside_the_slice_raises(kw):
    args = dict(rank=3, device="cpu") | kw
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GibbsSampler(sim_data(), **args)
