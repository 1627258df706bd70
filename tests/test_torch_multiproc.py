"""Mesh runs of the port across processes (gloo on the CPU) against the
one-process port with the same seed.

A mesh is a layout, not a different sampler: every rank draws at the
one-process shape and keeps its block (parallel/mesh.ShardGen), so a run on
an n_chain x n_g mesh gives the one-process chain(s): A, R and every MH
decision equal, P, E, the prior parameters and sigmasq within rtol 1e-5 /
atol 1e-6, the latent counts' sums exactly equal, the metrics rows within
rtol 1e-5 (the loglik, log-posterior, BIC and KL, sums of K x G terms
that cancel, to 1e-5 of sum(M log M), as tests/test_torch_chains.py holds
the KL), and P bit-identical on the ranks of a g group. The recorded
acceptance probabilities and their means in the metrics rows (exp of a
log ratio summed over G, whose order the split changes) are held to
rtol 1e-4.

Each mesh shape is spawned once (a module fixture per shape): this file run
as a script is the worker (``--worker``), one process per rank, over gloo
at 127.0.0.1 on a free port, one thread each, under a hard wall-clock
limit; every case's results go to one npz per rank, and each case is its
own test here. The workers import no JAX (checked); only the parent's
comparison with the JAX package's mesh fit does.
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, N, G = 12, 3, 32
SEED = 5
STEPS = 5
TEMPS = np.asarray([0.1, 0.3, 0.6, 1.0, 1.0], np.float32)
RTOL, ATOL = 1e-5, 1e-6
ACC_RTOL = 1e-4
WORKER_TIMEOUT = 240

# the (a) cases: one chain on a 1x2 mesh, five steps each
PATHS = {
    "eager_mh": dict(prior="truncnormal", MH=True, fused_sweeps=False),
    "eager_mh_reference": dict(prior="truncnormal", MH=True,
                               fused_sweeps=False, exact_mh=False),
    "exponential_mh": dict(prior="exponential", MH=True, fused_sweeps=False),
    "exponential_conjugate": dict(prior="exponential", MH=False),
    "gamma_conjugate": dict(prior="gamma", MH=False),
    "normal_truncnormal": dict(likelihood="normal", prior="truncnormal"),
    "normal_exponential": dict(likelihood="normal", prior="exponential"),
    "sbfi": dict(prior="truncnormal", MH=True, fused_sweeps=False,
                 rank=[1, 2, 3]),
    "ragged_G": dict(prior="exponential", MH=False, G=33),
    "hypers_conjugate": dict(prior="truncnormal", MH=True,
                             fused_sweeps=False,
                             exact_truncnorm_hypers=False),
}
ENSEMBLE = dict(prior="exponential", MH=False)


def sim(G=G, seed=0):
    rng = np.random.default_rng(seed)
    P = rng.gamma(2.0, 1.0, (K, N))
    E = rng.gamma(2.0, 3.0, (N, G))
    return rng.poisson(P @ E).astype(np.float32)


def sampler_kw(case):
    kw = dict(PATHS[case])
    kw.pop("G", None)
    return kw, kw.pop("rank", N)


def cc():
    import bayesnmf_tpu_torch as bt

    return bt.ConvergenceControl(MAP_over=20, MAP_every=10, miniters=20,
                                 maxiters=40, Ninarow_nochange=2,
                                 Ninarow_nobest=3)


def ens_cc():
    import bayesnmf_tpu_torch as bt

    return bt.ConvergenceControl(MAP_over=10, MAP_every=5, miniters=5,
                                 maxiters=60, Ninarow_nochange=99,
                                 Ninarow_nobest=99)


# ---------------------------------------------------------------------------
# the worker (this file as a script): every case of one mesh shape
# ---------------------------------------------------------------------------


def _steps(s, temps=TEMPS):
    """Five steps of a sampler from its state: the local records (full
    record) and the state, each rank's own block."""
    from bayesnmf_tpu_torch.models import gibbs

    state, rec = gibbs.run_chunk(s.spec, s.data, s.hyperprior_params,
                                 s.state, temps, False, "full")
    return state, rec


def _flat(prefix, tree, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(f"{prefix}{k}/", v, out)
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = v.detach().cpu().numpy()


def path_case(mesh, case, out):
    import bayesnmf_tpu_torch as bt
    from bayesnmf_tpu_torch.parallel import mesh as M

    kw, rank = sampler_kw(case)
    data = sim(PATHS[case].get("G", G))
    s = bt.GibbsSampler(data, rank, seed=SEED, device="cpu", mesh=mesh,
                        record_history="full", **kw)
    state, rec = _steps(s)
    Gd = data.shape[1]
    full = M.gather({k: v for k, v in rec.items() if k != "metrics"},
                    M.sample_out_layout(s.spec, chains=False, record="full"),
                    mesh, Gd)
    st = M.gather({k: state[k] for k in ("params", "prior")},
                  M.state_layout(s.spec, chains=False), mesh, Gd)
    _flat(f"{case}/rec/", full, out)
    _flat(f"{case}/state/", st, out)
    out[f"{case}/metrics"] = rec["metrics"].numpy()
    out[f"{case}/local_P"] = rec["P"].numpy()


def fit_case(mesh, tmp, out):
    """(c): a whole fit on the mesh, and (d): checkpoints between the mesh
    and one process."""
    import torch.distributed as dist

    import bayesnmf_tpu_torch as bt

    data = sim()
    kw = dict(prior="truncnormal", MH=True, fused_sweeps=False)
    s = bt.GibbsSampler(data, N, convergence_control=cc(), post_warmup=20,
                        mesh=mesh, seed=6, device="cpu",
                        output_dir=os.path.join(tmp, "fit"), overwrite=True,
                        **kw)
    s.run_gibbs_sampler()
    out["fit/metrics"] = s.sample_metrics.to_numpy()
    out["fit/MAP_P"] = s.MAP["P"]
    out["fit/MAP_E"] = s.MAP["E"]
    out["fit/loglik"] = np.float64(s.get_loglik())
    out["fit/logpost"] = np.float64(s.get_logpost())
    out["fit/Mhat"] = s.get_Mhat().numpy()
    out["fit/files"] = np.asarray(sorted(os.listdir(s.output_dir)))

    # (d) save on the mesh; the parent loads it in one process
    kw = dict(prior="exponential", MH=False)
    s = bt.GibbsSampler(data, N, seed=SEED, device="cpu", mesh=mesh, **kw)
    s._run_chunk(STEPS, False)
    s.save_object(os.path.join(tmp, "mesh.ckpt"))
    # the reverse: a one-process checkpoint continued on the mesh
    if mesh.is_root:
        one = bt.GibbsSampler(data, N, seed=SEED, device="cpu", **kw)
        one._run_chunk(STEPS, False)
        one.save_object(os.path.join(tmp, "one.ckpt"))
    dist.barrier()
    s = bt.GibbsSampler.load(os.path.join(tmp, "one.ckpt"), mesh=mesh,
                             device="cpu")
    s._run_chunk(STEPS, False)
    out["resume/metrics"] = s.sample_metrics.to_numpy()
    out["resume/P"] = s._window[-1]["P"].numpy()
    out["resume/E"] = s._window[-1]["E"].numpy()


def ensemble_case(mesh, tmp, out):
    """(b): one chunk, a forced compaction (chains 1 and 2 finish), one more
    chunk, on every rank alike."""
    import bayesnmf_tpu_torch as bt

    e = bt.ChainEnsemble(sim(), N, n_chains=4, convergence_control=ens_cc(),
                         seed=SEED, device="cpu", mesh=mesh, **ENSEMBLE)
    drive_ensemble(e)
    out["ens/metrics"] = e._metrics_all()
    out["ens/slots"] = e._slots
    out["ens/E"] = e._window[-1]["E"].numpy()
    out["ens/MAP_P1"] = e.MAP_per_chain[1]["P"]
    out["ens/local_P"] = e.states["params"]["P"].numpy()
    st = e.whole_states()
    _flat("ens/state/", {k: st[k] for k in ("params", "prior")}, out)
    # checkpoints: saved on the mesh (the parent loads it in one process),
    # and a one-process checkpoint continued on the mesh
    e.save_object(os.path.join(tmp, "ens_mesh.ckpt"))
    if mesh.is_root:
        one = bt.ChainEnsemble(sim(), N, n_chains=4,
                               convergence_control=ens_cc(), seed=SEED,
                               device="cpu", **ENSEMBLE)
        drive_ensemble(one)
        one.save_object(os.path.join(tmp, "ens_one.ckpt"))
    torch.distributed.barrier()
    r = bt.ChainEnsemble.load(os.path.join(tmp, "ens_one.ckpt"), mesh=mesh,
                              device="cpu")
    r._run_chunk(5)
    out["ens/resumed_metrics"] = r._metrics_all()


def drive_ensemble(e):
    e._run_chunk(5)
    for c in (1, 2):
        e.tracker.converged[c] = True
        e._end_iter[c] = e.iter
        e._finalize_chain(c)
    e._maybe_compact()
    e._run_chunk(5)


def bic_case(mesh, out):
    """(e): fit over a rank list by BIC on the mesh (one masked ensemble)."""
    import bayesnmf_tpu_torch as bt

    res = bt.fit(sim(), [1, 2, 3, 4], rank_method="BIC", mesh=mesh,
                 convergence_control=cc(), output_dir=None, device="cpu",
                 seed=SEED, **ENSEMBLE)
    out["bic/best_rank"] = np.int64(res["best_rank"])
    out["bic/BIC"] = np.asarray([r["BIC"] for r in res["results"]])
    out["bic/ranks"] = np.asarray([r["rank"] for r in res["results"]])


def global_mesh_case(out):
    """(f): a global mesh of the processes, one chunk of chain-split
    chains, and a cross-process gather of every chain's metrics."""
    from bayesnmf_tpu_torch.config import ModelSpec
    from bayesnmf_tpu_torch.config import default_hyperprior_params
    from bayesnmf_tpu_torch.parallel import chains as CH
    from bayesnmf_tpu_torch.parallel import mesh as M
    from bayesnmf_tpu_torch.parallel import multihost as MH

    out["global/n_hosts"] = np.int64(MH.n_hosts())
    mesh = MH.global_mesh(n_chain=2, n_g=1, device="cpu")
    data = sim()
    spec = ModelSpec(K=K, N=N, G=G, likelihood="poisson",
                     prior="truncnormal", MH=True)
    hp = default_hyperprior_params(spec, float(data.mean()))
    init, run = CH.make_sharded_chain_runner(spec, mesh, 4)
    states = init(hp, data, 0)
    states, samples = run(MH.shard_data(data, mesh), hp, states,
                          np.ones(3, np.float32), np.zeros(4, bool))
    met = M.gather(samples["metrics"], (M.CHAIN_AXIS, None, None), mesh, G)
    out["global/metrics"] = met.numpy()
    out["global/local_chains"] = np.int64(samples["metrics"].shape[0])


def gamma_operands(side, C=2):
    """One-process operands of a gamma draw of C chains (P side (C, K, N),
    E side (C, N, G)) and its chain-major uniform planes, whose four
    unrolled rounds reject in the last quarter of the entries (on the E
    side the columns of the second rank's block): those go to the exact
    rejection loop, the others are done after the unrolled rounds."""
    shape = (C, K, N) if side == "P" else (C, N, G)
    rng = np.random.default_rng(17)
    a = torch.from_numpy(rng.uniform(0.5, 3.5, shape).astype(np.float32))
    b = torch.from_numpy(rng.uniform(0.5, 1.5, shape).astype(np.float32))
    u = torch.from_numpy(rng.uniform(1e-6, 1.0, (C, 9) + shape[1:])
                         .astype(np.float32))
    last = shape[-1] - max(1, shape[-1] // 4)
    u[:, 0:8:2, ..., last:] = 1.2e-38
    return a, b, u


def gamma_case(mesh, out):
    """(e): gamma draws that take the rejection loop through the mesh's
    generator: this rank's block, or the error the draw raised, and the
    loop's rounds."""
    from bayesnmf_tpu_torch.ops import distributions as D
    from bayesnmf_tpu_torch.parallel import mesh as M

    g0, g1 = M.g_block(G, mesh)
    for side in ("P", "E"):
        a, b, u = gamma_operands(side)
        if side == "E":
            a, b, u = (x[..., g0:g1].contiguous() for x in (a, b, u))
        sg = M.ShardGen(torch.Generator().manual_seed(SEED), mesh, 2, G)
        D.gamma.rounds = 0
        try:
            x = D.gamma(sg, a, b, u=u, chain_axis=True, g=side == "E")
            out[f"gamma/{side}"] = x.numpy()
        except RuntimeError as e:
            out[f"gamma/{side}/error"] = np.str_(repr(e))
        out[f"gamma/{side}/rounds"] = np.int64(D.gamma.rounds)


def refuses_odd_chains(mesh) -> bool:
    """An ensemble whose chain count does not split over the chain axis
    raises ValueError."""
    import bayesnmf_tpu_torch as bt

    try:
        bt.ChainEnsemble(sim(), N, n_chains=3, device="cpu", mesh=mesh,
                         **ENSEMBLE)
    except ValueError as e:
        return "multiple of the chain axis" in str(e)
    return False


def worker(rank, world, port, n_chain, n_g, tmp):
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    from bayesnmf_tpu_torch.parallel import mesh as M
    from bayesnmf_tpu_torch.parallel import multihost as MH

    MH.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo")
    out = {}
    if (n_chain, n_g) == (1, 2):
        mesh = M.make_mesh(1, 2, device="cpu")
        for case in PATHS:
            path_case(mesh, case, out)
        fit_case(mesh, tmp, out)
        gamma_case(mesh, out)
    else:
        mesh = M.make_mesh(n_chain, n_g, device="cpu")
        ensemble_case(mesh, tmp, out)
        if (n_chain, n_g) == (2, 1):
            bic_case(mesh, out)
            global_mesh_case(out)
            out["refused/n_chains"] = np.bool_(refuses_odd_chains(mesh))
    out["imports_jax"] = np.bool_("jax" in sys.modules
                                  or "bayesnmf_tpu" in sys.modules)
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)


# ---------------------------------------------------------------------------
# the parent: spawn once per mesh shape
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def spawn(n_chain, n_g, tmp):
    """Run the worker on n_chain x n_g processes; every rank's npz. A rank
    that fails or outlives WORKER_TIMEOUT fails the fixture, with every
    rank's output."""
    world = n_chain * n_g
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(r),
         str(world), str(port), str(n_chain), str(n_g), str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO) for r in range(world)]
    logs, failed = [], False
    for r, p in enumerate(procs):
        try:
            log, _ = p.communicate(timeout=WORKER_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            log, _ = p.communicate()
            log += f"\n(rank {r} killed after {WORKER_TIMEOUT} s)"
        failed |= p.returncode != 0
        logs.append(f"--- rank {r} (rc {p.returncode}) ---\n{log}")
    if failed:
        pytest.fail("mesh worker failed:\n" + "\n".join(logs))
    return [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
            for r in range(world)]


@pytest.fixture(scope="module")
def mesh_1x2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_1x2")
    return spawn(1, 2, tmp), tmp


@pytest.fixture(scope="module")
def mesh_2x1(tmp_path_factory):
    return spawn(2, 1, tmp_path_factory.mktemp("mesh_2x1"))


@pytest.fixture(scope="module")
def mesh_2x2_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_2x2")
    return spawn(2, 2, tmp), tmp


@pytest.fixture(scope="module")
def mesh_2x2(mesh_2x2_run):
    return mesh_2x2_run[0]


def one_process_path(case):
    import bayesnmf_tpu_torch as bt

    kw, rank = sampler_kw(case)
    s = bt.GibbsSampler(sim(PATHS[case].get("G", G)), rank, seed=SEED,
                        device="cpu", record_history="full", **kw)
    state, rec = _steps(s)
    out = {}
    _flat("rec/", {k: v for k, v in rec.items() if k != "metrics"}, out)
    _flat("state/", {k: state[k] for k in ("params", "prior")}, out)
    out["metrics"] = rec["metrics"].numpy()
    return out


def check_metrics(got, want, data=None):
    """Metrics rows (..., 12) within the stated tolerances: the sums that
    cancel to 1e-5 of sum(M log M) (the BIC twice that), the acceptance
    rates to rtol 1e-4, the rest (iteration, RMSE, n_params, rank,
    temperature, NaN count) to rtol 1e-5."""
    from bayesnmf_tpu_torch.models.gibbs import METRIC_NAMES

    M = np.maximum(sim() if data is None else data, 1e-6)
    scale = float(np.sum(M * np.log(M)))
    for j, name in enumerate(METRIC_NAMES):
        g, w = got[..., j], want[..., j]
        if name in ("KL", "loglikelihood", "logposterior", "BIC"):
            tol = dict(rtol=0.0, atol=RTOL * scale * (2 if name == "BIC"
                                                      else 1))
        elif name.endswith("acceptance_rate"):
            tol = dict(rtol=ACC_RTOL, atol=ATOL)
        else:
            tol = dict(rtol=RTOL)
        np.testing.assert_allclose(g, w, err_msg=name, **tol)


def decisions(x):
    """Which entries moved in each step (an MH rejection keeps the value;
    a Gibbs draw always moves)."""
    return x[1:] != x[:-1]


@pytest.mark.parametrize("case", list(PATHS))
def test_g_sharded_chain_equals_one_process(mesh_1x2, case):
    """(a) One chain on a 1x2 mesh (G split), five steps, against the
    one-process port with the same seed."""
    ranks, _ = mesh_1x2
    got = {k[len(case) + 1:]: v for k, v in ranks[0].items()
           if k.startswith(case + "/")}
    ref = one_process_path(case)
    # the P side is computed alike on both ranks of the g group
    np.testing.assert_array_equal(ranks[0][f"{case}/local_P"],
                                  ranks[1][f"{case}/local_P"])
    for k, v in ref.items():
        g = got[k]
        assert g.shape == v.shape, k
        if k.endswith(("/A", "/R")):
            np.testing.assert_array_equal(g, v, err_msg=k)
        elif k.endswith(("Zsum_g", "Zsum_k")):
            np.testing.assert_array_equal(g, v, err_msg=k)
        elif k == "metrics":
            check_metrics(g, v, sim(PATHS[case].get("G", G)))
        elif "/acc_" in k:
            # an acceptance probability is exp of a sum over G: the order
            # of that sum moves it by its relative rounding, ~1e-5
            np.testing.assert_allclose(g, v, rtol=ACC_RTOL, atol=ATOL,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(g, v, rtol=RTOL, atol=ATOL, err_msg=k)
    if PATHS[case].get("MH"):
        for k in ("rec/P", "rec/E"):
            np.testing.assert_array_equal(decisions(got[k]),
                                          decisions(ref[k]), err_msg=k)
    assert not ranks[0]["imports_jax"] and not ranks[1]["imports_jax"]


@pytest.mark.parametrize("side", ["P", "E"])
def test_gamma_rejection_loop_on_a_g_split_mesh(mesh_1x2, side):
    """(e) A gamma draw whose unrolled rounds reject in part of the entries
    (on the E side only in the second rank's columns) runs the exact
    rejection loop through the mesh's generator on both ranks, as many
    rounds on each, and each rank's block equals the one-process draw's
    block."""
    from bayesnmf_tpu_torch.ops import distributions as D

    ranks, _ = mesh_1x2
    for r in ranks:
        assert f"gamma/{side}/error" not in r, str(r[f"gamma/{side}/error"])
    a, b, u = gamma_operands(side)
    D.gamma.rounds = 0
    want = D.gamma(torch.Generator().manual_seed(SEED), a, b, u=u,
                   chain_axis=True).numpy()
    assert D.gamma.rounds > 0 and np.isfinite(want).all()
    cols = [(0, G // 2), (G // 2, G)]
    for r, (g0, g1) in zip(ranks, cols):
        block = want[..., g0:g1] if side == "E" else want
        np.testing.assert_array_equal(r[f"gamma/{side}"], block)
        assert int(r[f"gamma/{side}/rounds"]) == D.gamma.rounds


def test_g_sharded_fit_against_the_jax_mesh_fit(mesh_1x2):
    """(c) A whole GibbsSampler(mesh=...) fit (the JAX package's
    test_single_chain_g_sharded_sampler): MAP finite, the model math whole
    and alike on every rank, only the root writes, and the final loglik
    within 5% of the JAX package's fit on a 1x2 mesh of the same data."""
    ranks, _ = mesh_1x2
    r0, r1 = ranks
    for k in ("fit/metrics", "fit/MAP_P", "fit/MAP_E", "fit/loglik",
              "fit/logpost", "fit/Mhat"):
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    assert np.isfinite(r0["fit/MAP_P"]).all()
    assert np.isfinite(r0["fit/MAP_E"]).all()
    assert r0["fit/MAP_E"].shape[1] == G and r0["fit/Mhat"].shape == (K, G)
    assert np.isfinite(r0["fit/metrics"][1:, 3]).all()
    assert {"log.txt", "sampler.ckpt"} <= set(r0["fit/files"].tolist())

    import jax

    from bayesnmf_tpu.config import ConvergenceControl
    from bayesnmf_tpu.models.sampler import GibbsSampler
    from bayesnmf_tpu.parallel import mesh as JM

    jc = ConvergenceControl(MAP_over=20, MAP_every=10, miniters=20,
                            maxiters=40, Ninarow_nochange=2, Ninarow_nobest=3)
    js = GibbsSampler(sim(), N, likelihood="poisson", prior="truncnormal",
                      MH=True, post_warmup=20, convergence_control=jc,
                      mesh=JM.make_mesh(1, 2, devices=jax.devices()[:2]),
                      seed=6)
    js.run_gibbs_sampler()
    ll_jax = js.sample_metrics["loglikelihood"].to_numpy()[-1]
    ll = r0["fit/metrics"][-1, 3]
    assert abs(ll - ll_jax) / max(abs(ll_jax), 1.0) < 0.05, (ll, ll_jax)


@pytest.mark.parametrize("direction", ["mesh_to_one", "one_to_mesh"])
def test_checkpoint_moves_between_mesh_and_one_process(mesh_1x2, direction):
    """(d) A checkpoint written on the 1x2 mesh loads in one process, and a
    one-process checkpoint loads on the mesh; either continues five steps
    as the uninterrupted one-process run."""
    import bayesnmf_tpu_torch as bt

    ranks, tmp = mesh_1x2
    ref = bt.GibbsSampler(sim(), N, seed=SEED, device="cpu",
                          prior="exponential", MH=False)
    ref._run_chunk(STEPS, False)
    ref._run_chunk(STEPS, False)
    want = ref.sample_metrics.to_numpy()
    if direction == "mesh_to_one":
        with open(os.path.join(tmp, "mesh.ckpt"), "rb") as fh:
            assert "mesh" not in pickle.load(fh)
        s = bt.GibbsSampler.load(os.path.join(tmp, "mesh.ckpt"))
        s._run_chunk(STEPS, False)
        got = s.sample_metrics.to_numpy()
        P, E = s._window[-1]["P"].numpy(), s._window[-1]["E"].numpy()
    else:
        got = ranks[0]["resume/metrics"]
        P, E = ranks[0]["resume/P"], ranks[0]["resume/E"]
        np.testing.assert_array_equal(got, ranks[1]["resume/metrics"])
    check_metrics(got, want)
    np.testing.assert_allclose(P, ref._window[-1]["P"].numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(E, ref._window[-1]["E"].numpy(), rtol=RTOL,
                               atol=ATOL)


def one_process_ensemble():
    import bayesnmf_tpu_torch as bt

    e = bt.ChainEnsemble(sim(), N, n_chains=4, convergence_control=ens_cc(),
                         seed=SEED, device="cpu", **ENSEMBLE)
    drive_ensemble(e)
    return e


@pytest.mark.parametrize("shape", ["2x1", "2x2"])
def test_ensemble_on_a_mesh_equals_one_process(mesh_2x1, mesh_2x2, shape):
    """(b) A 4-chain conjugate ensemble, chain-split (2x1) and chain- and
    G-split (2x2): a chunk, a compaction to the two live chains (they move
    between ranks), another chunk; every rank holds every chain's rows,
    alike, equal to the one-process ensemble's."""
    ranks = mesh_2x1 if shape == "2x1" else mesh_2x2
    e = one_process_ensemble()
    for r in ranks:
        np.testing.assert_array_equal(r["ens/slots"], e._slots)
        np.testing.assert_array_equal(r["ens/metrics"], ranks[0]["ens/metrics"])
        assert not r["imports_jax"]
    got = ranks[0]
    np.testing.assert_array_equal(np.isnan(got["ens/metrics"]),
                                  np.isnan(e._metrics_all()))
    check_metrics(got["ens/metrics"], e._metrics_all())
    np.testing.assert_allclose(got["ens/E"], e._window[-1]["E"].numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["ens/MAP_P1"], e.MAP_per_chain[1]["P"],
                               rtol=RTOL, atol=ATOL)
    for k in ("Zsum_g", "Zsum_k", "A", "R"):
        np.testing.assert_array_equal(got[f"ens/state/params/{k}"],
                                      e.states["params"][k].numpy())
    np.testing.assert_allclose(got["ens/state/params/P"],
                               e.states["params"]["P"].numpy(), rtol=RTOL,
                               atol=ATOL)
    # P alike on the ranks of each g group (ranks are row-major)
    n_g = 1 if shape == "2x1" else 2
    for r in range(len(ranks)):
        np.testing.assert_array_equal(ranks[r]["ens/local_P"],
                                      ranks[r - r % n_g]["ens/local_P"])


@pytest.mark.parametrize("direction", ["mesh_to_one", "one_to_mesh"])
def test_ensemble_checkpoint_moves_between_mesh_and_one_process(
        mesh_2x2_run, direction):
    """An ensemble checkpoint written on the 2x2 mesh continues in one
    process, and a one-process one continues on the mesh, as the
    one-process ensemble does (five more steps)."""
    import bayesnmf_tpu_torch as bt

    ranks, tmp = mesh_2x2_run
    want = one_process_ensemble()
    want._run_chunk(5)
    if direction == "mesh_to_one":
        r = bt.ChainEnsemble.load(os.path.join(tmp, "ens_mesh.ckpt"))
        r._run_chunk(5)
        got = r._metrics_all()
    else:
        got = ranks[0]["ens/resumed_metrics"]
        for other in ranks[1:]:
            np.testing.assert_array_equal(other["ens/resumed_metrics"], got)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want._metrics_all()))
    check_metrics(got, want._metrics_all())


def test_bic_fit_on_a_chain_mesh_picks_the_one_process_rank(mesh_2x1):
    """(e) fit(M, [1, 2, 3, 4], rank_method='BIC', mesh=2x1) runs the
    masked ensemble on the mesh and picks the one-process rank."""
    import bayesnmf_tpu_torch as bt

    r0, r1 = mesh_2x1
    res = bt.fit(sim(), [1, 2, 3, 4], rank_method="BIC",
                 convergence_control=cc(), output_dir=None, device="cpu",
                 seed=SEED, **ENSEMBLE)
    assert int(r0["bic/best_rank"]) == res["best_rank"]
    assert int(r1["bic/best_rank"]) == res["best_rank"]
    assert sorted(r0["bic/ranks"].tolist()) == [1, 2, 3, 4]


def test_odd_chain_count_is_refused_on_a_chain_mesh(mesh_2x1):
    """n_chains % n_chain != 0 raises ValueError on every rank."""
    assert all(bool(r["refused/n_chains"]) for r in mesh_2x1)


def test_global_mesh_chunk_and_gather(mesh_2x1):
    """(f) The counterpart of tests/_multihost_worker.py: a global mesh of
    two processes (one host: make_mesh), one chunk of four chains split
    two a process, and every chain's metrics gathered across processes."""
    for r in mesh_2x1:
        assert int(r["global/n_hosts"]) == 1
        assert int(r["global/local_chains"]) == 2
        met = r["global/metrics"]
        assert met.shape == (4, 3, 12)
        assert np.isfinite(met[:, -1, 3]).all()
    np.testing.assert_array_equal(mesh_2x1[0]["global/metrics"],
                                  mesh_2x1[1]["global/metrics"])


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    a = sys.argv[2:]
    worker(int(a[0]), int(a[1]), int(a[2]), int(a[3]), int(a[4]), a[5])
