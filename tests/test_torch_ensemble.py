"""The port's ChainEnsemble on the CPU: SBFI recovery on the reference's
example data, live-chain compaction and throughput, bit-exact resume, the
chain views, and the guards around what is not ported yet."""

import numpy as np
import pytest
import torch

import bayesnmf_tpu_torch as bt
from bayesnmf_tpu.utils.rds import load_example_data
from bayesnmf_tpu_torch.parallel.ensemble import (
    ChainEnsemble,
    _auto_stream_sweeps,
)
from bayesnmf_tpu_torch.utils.assignment import hungarian_solve, pairwise_cosine

torch.set_num_threads(1)


def matched_cosines(P_est, P_true):
    sim = pairwise_cosine(P_est, P_true)
    cols = hungarian_solve(-sim)
    return np.array([sim[i, c] for i, c in enumerate(cols) if c >= 0])


def sim_data(seed=8, K=16, N=3, G=24):
    rng = np.random.default_rng(seed)
    P = rng.dirichlet(np.ones(K) * 0.5, N).T * 40
    E = rng.gamma(2.0, 2.0, (N, G))
    return rng.poisson(P @ E).astype(np.float32)


def test_sbfi_ensemble_recovers_example_rank():
    """The bar of tests/test_reference_parity.py::test_rank_learning_recovers_4
    (learned rank 4, matched cosine min > 0.9) for each of two chains."""
    d = load_example_data()
    M = np.asarray(d["M"], np.float32)
    P_true = np.asarray(d["P"], np.float32)
    cc = bt.ConvergenceControl(MAP_over=100, MAP_every=50, miniters=100,
                               maxiters=1500, Ninarow_nochange=3,
                               Ninarow_nobest=6)
    ens = ChainEnsemble(M, range(1, 8), n_chains=2, rank_method="SBFI",
                        convergence_control=cc, prop_temp=0.3,
                        post_warmup=200, seed=0, stream_sweeps=True,
                        device="cpu")
    ens.run()
    assert list(ens.learned_ranks) == [4, 4], ens.learned_ranks
    for c in range(2):
        cos = matched_cosines(ens.chain(c).MAP["P"], P_true)
        assert cos.min() > 0.9, (c, cos)
    # the chain views feed the postprocessing
    res = ens.chain(0).assign_signatures_ensemble("cosmic")
    assert len(res["assignments"]) == 4
    table = ens.bic_table()
    assert set(table["chain"]) == {0, 1} and (table["rank"] == 4).all()


def test_short_sbfi_run_compacts_and_counts_live_chains():
    M = sim_data()
    cc = bt.ConvergenceControl(MAP_over=10, MAP_every=10, miniters=20,
                               maxiters=40, Ninarow_nochange=99,
                               Ninarow_nobest=99)
    ens = ChainEnsemble(M, range(1, 5), n_chains=3, convergence_control=cc,
                        post_warmup=10, seed=3, stream_sweeps=True,
                        device="cpu")
    ens._run_chunk(9)
    assert ens.iter == 10 and ens._chain_iters == 27
    # chain 1 has finished its run: it is finalised and leaves the device
    ens.tracker.converged[1] = True
    ens._end_iter[1] = ens.iter
    ens._finalize_chain(1)
    ens._maybe_compact()
    assert list(ens._slots) == [0, 2]
    assert ens.states["params"]["P"].shape[0] == 2
    assert ens.states["prior"]["Mu_e"].shape[0] == 2
    ens.run()
    rows = ens._metrics_all()
    # chain 1 has no rows after it left; the others are finite throughout
    assert np.isnan(rows[1, 9:, 0]).all()
    live = rows[~np.isnan(rows[..., 0])]
    assert np.isfinite(live).all()
    assert rows.shape[1] == ens.iter - 1
    # the rank trace moves under SBFI
    assert len(np.unique(rows[0, :, 7])) > 1
    # throughput counts 3 chains for the first 9 iterations and the 2
    # resident ones after, each up to its own end
    ens.time["total"] = 1.0 / 60.0
    assert ens._chain_iters == 27 + 2 * (ens.iter - 10)
    assert ens.throughput() == pytest.approx(ens._chain_iters)
    assert all(m is not None for m in ens.MAP_per_chain)
    assert (ens.learned_ranks >= 0).all()
    view = ens.chain(1)
    assert view.MAP is ens.MAP_per_chain[1]
    assert view.sample_metrics.shape[0] == 9
    again = view.get_MAP(end_iter=10, n_samples=5)
    assert again["P"].shape[0] == 16


def _compaction_sim(K=16, N=3, G=24, seed=0, scale=30.0):
    """tests/test_ensemble_surface.py::_sim."""
    rng = np.random.default_rng(seed)
    P = rng.dirichlet(np.ones(K) * 0.5, N).T * scale
    E = rng.gamma(2.0, 2.0, (N, G))
    return rng.poisson(P @ E).astype(np.float32)


def _recorded_run(monkeypatch, **kw):
    """A run with every draw recorded per chain: {(counter word 1,
    iteration, uid): that chain's row} of the streams' draws, and the
    allocation's Philox planes under {("alloc", key, uid): planes}."""
    from bayesnmf_tpu_torch.ops import allocation as AL
    from bayesnmf_tpu_torch.ops import rng as R

    rec = {}
    fill, planes = R.philox_fill, AL.philox_planes

    def spy_fill(uids, key, word1, it, n, index=None, normal=False):
        out = fill(uids, key, word1, it, n, index, normal)
        for c, uid in enumerate(uids.tolist()):
            rec[(word1 + (normal << 30), it, uid)] = out[c].clone()
        return out

    def spy_planes(key, uids, *a, **k):
        out = planes(key, uids, *a, **k)
        for c, uid in enumerate(uids.tolist()):
            rec[("alloc", key, uid)] = out[c].clone()
        return out

    monkeypatch.setattr(R, "philox_fill", spy_fill)
    monkeypatch.setattr(AL, "philox_planes", spy_planes)
    ens = ChainEnsemble(_compaction_sim(), 3, n_chains=6, **kw).run()
    monkeypatch.undo()
    return ens, rec


COMPACTION_PATHS = {
    "fused": dict(prior="truncnormal", MH=True, fused_sweeps=True),
    "conjugate": dict(prior="exponential", MH=False),
    "stream": dict(prior="truncnormal", MH=True, stream_sweeps=True),
}


@pytest.mark.parametrize("path", sorted(COMPACTION_PATHS))
def test_compaction_preserves_per_chain_inference(path, monkeypatch):
    """The port's counterpart of tests/test_ensemble_surface.py::
    test_compaction_preserves_per_chain_inference, on the fused (its plain
    version here), conjugate and streaming paths: with compact on and off
    the same convergence iterations and MAP windows, per-column cosines of
    the MAP P above 0.98, and every draw of every resident chain at every
    iteration equal bit for bit (the draws of the compacted run are a
    subset of the other's: a finished chain stops drawing)."""
    cc = bt.ConvergenceControl(MAP_over=40, MAP_every=20, miniters=60,
                               maxiters=400, Ninarow_nochange=2,
                               Ninarow_nobest=4, tol=1e-5)
    kw = dict(likelihood="poisson", convergence_control=cc, post_warmup=40,
              seed=3, output_dir=None, verbosity=0, device="cpu",
              **COMPACTION_PATHS[path])
    e1, r1 = _recorded_run(monkeypatch, compact=True, **kw)
    e2, r2 = _recorded_run(monkeypatch, compact=False, **kw)
    assert e1._slots.size < 6, "staggering never compacted; weaken CC"
    np.testing.assert_array_equal(e1._end_iter, e2._end_iter)
    np.testing.assert_array_equal(e1.tracker.converged_iter,
                                  e2.tracker.converged_iter)
    for c in range(6):
        m1, m2 = e1.MAP_per_chain[c], e2.MAP_per_chain[c]
        np.testing.assert_array_equal(m1["idx"], m2["idx"])
        P1 = np.asarray(m1["P"])
        P2 = np.asarray(m2["P"])
        assert P1.shape == P2.shape
        for j in range(P1.shape[1]):
            cos = (P1[:, j] @ P2[:, j]) / (
                np.linalg.norm(P1[:, j]) * np.linalg.norm(P2[:, j]) + 1e-12)
            assert cos > 0.98, (c, j, cos)
    assert set(r1) <= set(r2) and len(r1) < len(r2)
    for k, v in r1.items():
        assert torch.equal(v, r2[k]), k


def test_checkpoint_resume_bit_exact(tmp_path):
    M = sim_data(seed=2)
    cc = bt.ConvergenceControl(MAP_over=20, MAP_every=10, miniters=40,
                               maxiters=40, Ninarow_nochange=99,
                               Ninarow_nobest=99)
    kw = dict(n_chains=3, convergence_control=cc, post_warmup=10, seed=2,
              stream_sweeps=True, device="cpu")
    e1 = ChainEnsemble(M, range(1, 4), **kw)
    e1.run()
    e2 = ChainEnsemble(M, range(1, 4), output_dir=str(tmp_path / "run"),
                       **kw)
    e2._run_chunk(19)
    path = e2.save_object()
    e3 = ChainEnsemble.load(path)
    assert e3.spec.stream_sweeps and e3.iter == 20
    e3.run()
    assert e3.iter == e1.iter
    for group in ("params", "prior"):
        for k, v in e1.states[group].items():
            np.testing.assert_array_equal(e3.states[group][k].numpy(),
                                          v.numpy(), err_msg=k)
    np.testing.assert_array_equal(e3._metrics_all(), e1._metrics_all())
    for c in range(3):
        np.testing.assert_array_equal(e3.MAP_per_chain[c]["P"],
                                      e1.MAP_per_chain[c]["P"])
    log = (tmp_path / "run" / "log.txt").read_text()
    assert "Ensemble done" in log


def test_auto_stream_policy():
    on = dict(likelihood="poisson", prior="truncnormal", MH=True, mesh=None,
              fused_sweeps=False, G=2000, device=torch.device("cuda"))
    assert _auto_stream_sweeps(**on)
    assert not _auto_stream_sweeps(**{**on, "G": 1999})
    assert not _auto_stream_sweeps(**{**on, "device": torch.device("cpu")})
    assert not _auto_stream_sweeps(**{**on, "fused_sweeps": True})
    assert not _auto_stream_sweeps(**{**on, "MH": False})


def test_cuda_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        ChainEnsemble(sim_data(), 3, stream_sweeps=True)


@pytest.mark.parametrize("kw", [
    dict(mesh="a one-process mesh"),
])
def test_outside_the_slice_raises(kw):
    """The streaming kernels on a mesh are refused with the JAX package's
    ValueError: they do not partition over G."""
    from bayesnmf_tpu_torch.parallel.mesh import make_mesh

    args = dict(rank=3, n_chains=2, stream_sweeps=True, device="cpu") | kw
    args["mesh"] = make_mesh(device="cpu")
    with pytest.raises(ValueError, match="stream_sweeps"):
        ChainEnsemble(sim_data(), **args)
