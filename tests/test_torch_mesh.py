"""The port's mesh layer in one process: the layout tables against the JAX
package's shardings, the blocks, a rank's block of the streams, the
bootstrap off a cluster, the refusals, the allocation on a G shard, a
world-1 mesh and a resume on another device type. The runs across processes are in
tests/test_torch_multiproc.py."""

import pickle
import types

import jax
import numpy as np
import pytest
import torch

import bayesnmf_tpu_torch as bt
from bayesnmf_tpu.config import ModelSpec as JModelSpec
from bayesnmf_tpu.parallel import mesh as JM
from bayesnmf_tpu_torch.config import ModelSpec
from bayesnmf_tpu_torch.ops import allocation as AL
from bayesnmf_tpu_torch.ops import distributions as D
from bayesnmf_tpu_torch.ops.rng import ChainStreams
from bayesnmf_tpu_torch.parallel import mesh as M
from bayesnmf_tpu_torch.parallel import multihost as MH
from bayesnmf_tpu_torch.utils import checkpoint as CK

torch.set_num_threads(1)

FAMILIES = [
    dict(likelihood="poisson", prior="truncnormal", MH=True),
    dict(likelihood="poisson", prior="exponential", MH=True),
    dict(likelihood="poisson", prior="exponential", MH=False),
    dict(likelihood="poisson", prior="gamma", MH=False),
    dict(likelihood="normal", prior="truncnormal", MH=False),
    dict(likelihood="normal", prior="exponential", MH=False),
]
FAMILY_IDS = [f"{f['likelihood']}-{f['prior']}-{'MH' if f['MH'] else 'Gibbs'}"
              for f in FAMILIES]


def sim(K=12, N=3, G=32, seed=0):
    rng = np.random.default_rng(seed)
    return rng.poisson(rng.gamma(2.0, 1.0, (K, N))
                       @ rng.gamma(2.0, 3.0, (N, G))).astype(np.float32)


def specs(fam):
    return (ModelSpec(K=12, N=3, G=32, **fam),
            JModelSpec(K=12, N=3, G=32, **fam))


def jax_table(tree):
    """The partition spec of every leaf of a JAX sharding pytree, as
    tuples, without the threefry key and the iteration."""
    if isinstance(tree, dict):
        return {k: jax_table(v) for k, v in tree.items()
                if k not in ("key", "iter")}
    return tuple(tree.spec)


@pytest.fixture(scope="module")
def jmesh():
    return JM.make_mesh(n_chain=2, n_g=4)


@pytest.mark.parametrize("chains", [True, False])
@pytest.mark.parametrize("fam", FAMILIES, ids=FAMILY_IDS)
def test_state_layout_equals_the_jax_shardings(jmesh, fam, chains):
    spec, jspec = specs(fam)
    assert M.state_layout(spec, chains) == jax_table(
        JM.state_shardings(jspec, jmesh, chains=chains))


@pytest.mark.parametrize("store_E", [True, False])
@pytest.mark.parametrize("record", ["metrics", "basic", "full"])
@pytest.mark.parametrize("fam", FAMILIES, ids=FAMILY_IDS)
def test_sample_out_layout_equals_the_jax_shardings(jmesh, fam, record,
                                                    store_E):
    spec, jspec = specs(fam)
    for chains in (True, False):
        assert M.sample_out_layout(spec, chains, record, store_E) == \
            jax_table(JM.sample_out_shardings(jspec, jmesh, chains=chains,
                                              record=record,
                                              store_E=store_E))


def fake_mesh(n_chain, n_g, ci=0, gi=0):
    """A mesh position without process groups (for what needs no
    collective: blocks and draws)."""
    return types.SimpleNamespace(n_chain=n_chain, n_g=n_g, ci=ci, gi=gi,
                                 size=n_chain * n_g)


@pytest.mark.parametrize("G", [32, 33, 7])
@pytest.mark.parametrize("n_g", [1, 2, 3, 4])
def test_g_block_covers_G(G, n_g):
    blocks = [M.g_block(G, fake_mesh(1, n_g, gi=i)) for i in range(n_g)]
    cols = np.concatenate([np.arange(*b) for b in blocks])
    np.testing.assert_array_equal(cols, np.arange(G))
    sizes = [b - a for a, b in blocks]
    assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes)[::-1]


def test_local_and_blocks_of_a_state():
    spec, _ = specs(FAMILIES[0])
    x = torch.arange(4 * 3 * 33, dtype=torch.float32).view(4, 3, 33)
    parts = [M.local(x, (M.CHAIN_AXIS, None, M.G_AXIS),
                     fake_mesh(2, 2, ci, gi), 33)
             for ci in range(2) for gi in range(2)]
    assert [p.shape for p in parts] == [(2, 3, 17), (2, 3, 16)] * 2
    np.testing.assert_array_equal(parts[3].numpy(), x[2:, :, 17:].numpy())
    with pytest.raises(ValueError, match="multiple of the chain axis"):
        M.chain_block(3, fake_mesh(2, 1))


@pytest.mark.parametrize("gi", [0, 1, 2])
def test_shard_generator_keeps_the_block_of_the_one_process_draw(gi):
    """A rank's block of the streams (ChainStreams.block) draws only its
    chains and columns, each element the one-process draw's: plain and flat
    draws, uniform and normal, equal the one-process draw's slice, and the
    block draws no more elements than it keeps."""
    C, N, K, G = 4, 3, 5, 11
    mesh = fake_mesh(2, 3, ci=1, gi=gi)
    g0, g1 = M.g_block(G, mesh)
    whole = ChainStreams(7, np.arange(10, 10 + C), it=3)
    sg = whole.block(mesh, G)
    assert sg.uids.tolist() == [12, 13] and (sg.c0, sg.c1) == (2, 4)
    full = whole.uniform("sweep_E", (C, 9, N, G), g=True)
    got = sg.uniform("sweep_E", (2, 9, N, g1 - g0), g=True)
    assert got.shape == (2, 9, N, g1 - g0)
    np.testing.assert_array_equal(got, full[2:, :, :, g0:g1])
    full = whole.normal("mu_p", (2, C, N, K), c_dim=1)
    np.testing.assert_array_equal(sg.normal("mu_p", (2, 2, N, K), c_dim=1),
                                  full[:, 2:])
    full = whole.flat("slice", (C, 18), [(1, K * N, False), (N, G, True)])
    got = sg.flat("slice", (2, 18), [(1, K * N, False), (N, g1 - g0, True)])
    want = torch.cat([full[2:, :, :K * N], full[2:, :, K * N:].reshape(
        2, 18, N, G)[..., g0:g1].reshape(2, 18, -1)], -1)
    np.testing.assert_array_equal(got, want)
    assert got.numel() == 2 * 18 * (K * N + N * (g1 - g0))
    # the block writes the whole streams' record
    assert sg.state()["uids"].tolist() == whole.state()["uids"].tolist()


def rejecting_planes(C, shape, seed=3):
    """Pre-drawn gamma uniforms, chain-major (C, 9) + shape, whose four
    unrolled rounds all reject: the candidates' normal quantiles at the
    smallest uniform put 1 + c x below 0, so every element goes to the
    exact rejection loop."""
    u = torch.rand((C, 9) + tuple(shape),
                   generator=torch.Generator().manual_seed(seed))
    u[:, 0:8:2] = D._TINY
    return u


@pytest.mark.parametrize("side", ["P", "E", "sigmasq"])
def test_gamma_rejection_loop_on_a_mesh_equals_one_process(side):
    """A gamma draw whose unrolled rounds all reject runs its rejection loop
    on each rank's block alone (the done flag is a local test, no
    collective) and returns the one-process draw's block: the loop's round
    r draws each element's own (site, r) uniforms, so the rounds a rank
    needs do not depend on the others'. E side and sigmasq: blocks of G
    (inv_gamma over G); P side: blocks of the chains."""
    C, K, N, G = 4, 5, 3, 7
    shape = {"P": (C, K, N), "E": (C, N, G), "sigmasq": (C, G)}[side]
    g = side != "P"
    rng = torch.Generator().manual_seed(11)
    a = 0.5 + 3.0 * torch.rand(shape, generator=rng)
    b = 0.5 + torch.rand(shape, generator=rng)
    u = rejecting_planes(C, shape[1:])
    draw = D.inv_gamma if side == "sigmasq" else D.gamma
    whole = ChainStreams(5, np.arange(C), it=2)
    D.gamma.rounds = 0
    want = draw(whole, a, b, u=u, chain_axis=True, g=g, site="lambda_e")
    assert D.gamma.rounds > 0
    assert torch.isfinite(want).all() and (want > 0).all()
    meshes = ([fake_mesh(1, 2, gi=i) for i in range(2)] if g
              else [fake_mesh(2, 1, ci=i) for i in range(2)])
    for mesh in meshes:
        sg = whole.block(mesh, G)
        cs = slice(sg.c0, sg.c1)
        gs = slice(sg.g0, sg.g1) if g else slice(None)
        got = draw(sg, a[cs][..., gs], b[cs][..., gs],
                   u=u[cs][..., gs].contiguous(), chain_axis=True, g=g,
                   site="lambda_e")
        np.testing.assert_array_equal(got.numpy(), want[cs][..., gs].numpy())


def test_initialize_binds_the_card_of_local_device_ids(monkeypatch):
    """``local_device_ids``: None changes nothing; an id outside the host's
    cards raises before any process group exists (on the CPU every id
    does); a valid id binds this process's card, which the mesh then
    uses in place of LOCAL_RANK % cards."""
    monkeypatch.setattr(M, "_bound_card", None)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert MH.initialize(local_device_ids=None) is False
    assert M._bound_card is None
    assert M.make_mesh(device="cpu").device == torch.device("cpu")
    for ids in ([0], 0, [-1], []):
        with pytest.raises(ValueError, match="local_device_ids"):
            MH.initialize("127.0.0.1:1", 1, 0, local_device_ids=ids)
    assert not torch.distributed.is_initialized()
    assert M._bound_card is None
    # a host of two cards: id 2 is out of range, id 1 binds
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    bound = []
    monkeypatch.setattr(torch.cuda, "set_device", bound.append)
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert M.local_card(0) == 0
    with pytest.raises(ValueError, match="local_device_ids"):
        MH.initialize("127.0.0.1:1", 1, 0, local_device_ids=[1, 2])
    from test_torch_multiproc import free_port

    port = free_port()
    try:
        assert MH.initialize(f"127.0.0.1:{port}", 1, 0, backend="gloo",
                             local_device_ids=[1, 0])
        assert bound == [1] and M._bound_card == 1
        assert M.local_card(0) == 1
        assert M._device_of(0, "cuda") == torch.device("cuda", 1)
    finally:
        torch.distributed.destroy_process_group()


def test_initialize_is_a_no_op_off_cluster(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert MH.initialize() is False
    assert not torch.distributed.is_initialized()
    assert MH.n_hosts() == 1


def test_global_mesh_off_cluster():
    assert bt.mesh is M and bt.multihost is MH   # the package's exports
    mesh = MH.global_mesh(1, 1, device="cpu")
    assert (mesh.n_chain, mesh.n_g, mesh.rank) == (1, 1, 0)
    assert mesh.device == torch.device("cpu") and mesh.is_root
    with pytest.raises(ValueError, match="mesh 3x2 != 1 global devices"):
        MH.global_mesh(3, 2, device="cpu")
    with pytest.raises(ValueError, match="mesh 2x1 != 1 devices"):
        M.make_mesh(2, 1, device="cpu")
    block = MH.shard_data(sim(G=33), mesh)
    np.testing.assert_array_equal(block.numpy(), sim(G=33))


def test_a_mesh_on_cuda_needs_a_card(monkeypatch):
    """A rank without a card raises; it does not move to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no card"):
        M.make_mesh(1, 1)


def test_mesh_refuses_the_per_chip_kernels():
    """The JAX package's refusals (test_fused_sweeps_rejects_mesh; its
    ensemble's fused and stream refusals) and the device check."""
    mesh = M.make_mesh(1, 1, device="cpu")
    M_ = sim()
    with pytest.raises(ValueError, match="fused_sweeps"):
        bt.GibbsSampler(M_, 3, mesh=mesh, fused_sweeps=True, device="cpu")
    with pytest.raises(ValueError, match="fused_sweeps"):
        bt.ChainEnsemble(M_, 3, n_chains=2, mesh=mesh, fused_sweeps=True,
                         device="cpu")
    with pytest.raises(ValueError, match="stream_sweeps"):
        bt.ChainEnsemble(M_, 3, n_chains=2, mesh=mesh, stream_sweeps=True,
                         device="cpu")
    with pytest.raises(ValueError, match="mesh's ranks are on cpu"):
        bt.GibbsSampler(M_, 3, mesh=mesh)
    # the auto policy takes the eager sweeps on a mesh
    s = bt.GibbsSampler(M_, 3, mesh=mesh, device="cpu")
    assert not s.spec.fused_sweeps


@pytest.mark.parametrize("prior", ["truncnormal", "exponential"])
def test_world_one_mesh_is_bit_identical(prior):
    """A 1x1 mesh runs the one-process chain bit for bit (no collective;
    the shared generator draws the one-process shapes)."""
    cc = bt.ConvergenceControl(MAP_over=10, MAP_every=5, miniters=10,
                               maxiters=20)
    kw = dict(prior=prior, MH=prior == "truncnormal", fused_sweeps=False,
              convergence_control=cc, post_warmup=10, seed=4, device="cpu")
    a = bt.GibbsSampler(sim(), [1, 2, 3], mesh=M.make_mesh(device="cpu"),
                        **kw).run_gibbs_sampler()
    b = bt.GibbsSampler(sim(), [1, 2, 3], **kw).run_gibbs_sampler()
    np.testing.assert_array_equal(a.sample_metrics.to_numpy(),
                                  b.sample_metrics.to_numpy())
    np.testing.assert_array_equal(a.MAP["P"], b.MAP["P"])


@pytest.mark.parametrize("G0, C0", [(0, 0), (5, 1), (13, 2)])
def test_allocation_on_a_shard_equals_the_slice(G0, C0):
    """The plain version with g0/G_total/c0: a shard's philox_planes equal
    the slice of the whole's; in planes mode the wrapper on a shard's slice
    of the planes gives the whole's Zsum_k columns, and its Zsum_g and the
    other columns' add to the whole's exactly."""
    K, N, G, C = 6, 5, 21, 4
    Gl, Cl = 8, 2
    rng = np.random.default_rng(3)
    Mx = torch.as_tensor(rng.poisson(30.0, (K, G)).astype(np.float32))
    P = torch.as_tensor(rng.gamma(1.0, 1.0, (C, K, N)).astype(np.float32))
    A = torch.ones(C, N)
    E = torch.as_tensor(rng.gamma(1.0, 1.0, (C, N, G)).astype(np.float32))
    key = (12345, 0)
    uids = torch.arange(C, dtype=torch.int64)
    cs, gs = slice(C0, C0 + Cl), slice(G0, G0 + Gl)
    np.testing.assert_array_equal(
        AL.philox_planes(key, uids[cs], N, K, Gl, g0=G0, G_total=G),
        AL.philox_planes(key, uids, N, K, G)[cs, ..., gs])
    u = torch.rand((C, AL.N_PLANES, AL.n_nodes(N), K, G),
                   generator=torch.Generator().manual_seed(1)).clamp_min(
                       1.2e-38)
    zg, zk = AL.allocate_counts(Mx, P, A, E, u=u)
    rest = [c for c in range(G) if not G0 <= c < G0 + Gl]

    def shard(cols):
        return AL.allocate_counts(
            Mx[:, cols].contiguous(), P[cs].contiguous(),
            A[cs].contiguous(), E[cs][..., cols].contiguous(),
            u=u[cs][..., cols].contiguous(), g0=G0, G_total=G)

    pg, pk = shard(gs)
    np.testing.assert_array_equal(pk, zk[cs, :, gs])
    np.testing.assert_array_equal(pg + shard(rest)[0], zg[cs])


def test_allocation_philox_shard_through_the_plain_version():
    """In Philox mode a shard's planes (philox_planes with its offsets)
    through the plain version give the whole's Zsum_k columns."""
    K, N, G, C = 6, 3, 20, 2
    rng = np.random.default_rng(4)
    Mx = torch.as_tensor(rng.poisson(20.0, (K, G)).astype(np.float32))
    P = torch.as_tensor(rng.gamma(1.0, 1.0, (C, K, N)).astype(np.float32))
    A = torch.ones(C, N)
    E = torch.as_tensor(rng.gamma(1.0, 1.0, (C, N, G)).astype(np.float32))
    key = (99, 0)
    uids = torch.tensor([4, 9], dtype=torch.int64)
    zg, zk = AL.allocate_counts_reference(
        Mx, P, A, E, AL.philox_planes(key, uids, N, K, G))
    parts = []
    for g0, g1 in ((0, 10), (10, 20)):
        u = AL.philox_planes(key, uids[1:], N, K, g1 - g0, g0=g0, G_total=G)
        pg, pk = AL.allocate_counts_reference(
            Mx[:, g0:g1], P[1:], A[1:], E[1:, :, g0:g1], u)
        np.testing.assert_array_equal(pk[0], zk[1, :, g0:g1])
        parts.append(pg[0])
    np.testing.assert_array_equal(parts[0] + parts[1], zg[1])


def rewrite_device(path, device):
    with open(path, "rb") as fh:
        p = pickle.load(fh)
    p["device"] = device
    with open(path, "wb") as fh:
        pickle.dump(p, fh)
    return p


def test_load_onto_another_device_type_restarts_the_generator(tmp_path):
    """A checkpoint whose recorded device is a card loads with
    device='cpu': the state, records and tracker carry over exactly, and
    the chain's stream continues: the resumed chain draws what the saved
    one draws next, bit for bit. A checkpoint written before the streams
    (a generator's state) loads through the restart path: the streams
    restart seeded from (seed, iteration), and the log says so."""
    cc = bt.ConvergenceControl(MAP_over=10, MAP_every=5, miniters=10,
                               maxiters=20)
    s = bt.GibbsSampler(sim(), 3, prior="exponential", MH=False, seed=3,
                        convergence_control=cc, device="cpu",
                        output_dir=str(tmp_path / "run"))
    s._run_chunk(5, False)
    path = s.save_object()
    p = rewrite_device(path, "cuda:0")
    assert (p["streams"]["seed"], p["streams"]["iter"]) == (3, s.iter)
    assert p["streams"]["uids"].tolist() == [0]
    r = bt.GibbsSampler.load(path, device="cpu")
    for k, v in s.state["params"].items():
        np.testing.assert_array_equal(r.state["params"][k].numpy(),
                                      v.numpy())
    np.testing.assert_array_equal(r.sample_metrics.to_numpy(),
                                  s.sample_metrics.to_numpy())
    assert r.state["gen"].state()["iter"] == s.iter == r.state["iter"]
    for x in (s, r):
        x._run_chunk(5, False)
    for k, v in s.state["params"].items():
        np.testing.assert_array_equal(r.state["params"][k].numpy(),
                                      v.numpy())
    np.testing.assert_array_equal(r.sample_metrics.to_numpy(),
                                  s.sample_metrics.to_numpy())
    # a checkpoint written before the streams restarts them
    del p["streams"]
    p["gen_state"] = torch.Generator().get_state().numpy()
    with open(path, "wb") as fh:
        pickle.dump(p, fh)
    r = bt.GibbsSampler.load(path, device="cpu")
    it = p["iter"]
    assert r.state["gen"].state()["seed"] == CK.restart_seed(3, it)
    assert r.state["gen"].iter == it
    assert "streams restart" in (tmp_path / "run" / "log.txt").read_text()
    r._run_chunk(5, False)
    assert np.isfinite(r.sample_metrics.to_numpy()[:, 3]).all()


def test_ensemble_load_onto_another_device_type(tmp_path):
    """An ensemble checkpoint recorded on a card resumes with device='cpu'
    and continues every chain's stream: the resumed run equals the saved
    run continued, bit for bit."""
    kw = dict(prior="exponential", MH=False, seed=2, device="cpu",
              convergence_control=bt.ConvergenceControl(
                  MAP_over=10, MAP_every=5, miniters=10, maxiters=20))
    e = bt.ChainEnsemble(sim(), 3, n_chains=2, **kw)
    e._run_chunk(5)
    path = e.save_object(str(tmp_path / "ens.ckpt"))
    rewrite_device(path, "cuda")
    r = bt.ChainEnsemble.load(path, device="cpu")
    for k, v in e.states["params"].items():
        np.testing.assert_array_equal(r.states["params"][k].numpy(),
                                      v.numpy())
    assert r.states["gen"].state()["uids"].tolist() == [0, 1]
    assert r.states["gen"].iter == e.iter
    for x in (e, r):
        x.run()
    assert r.MAP_per_chain[0] is not None
    for c in range(2):
        np.testing.assert_array_equal(r.MAP_per_chain[c]["P"],
                                      e.MAP_per_chain[c]["P"])


def test_jax_mesh_partition_specs_are_tuples(jmesh):
    """What the comparison above relies on: a JAX PartitionSpec reads as
    the tuple of its axis names."""
    sh = JM.data_sharding(jmesh)
    assert tuple(sh.spec) == (None, "g")
    assert len(jax.devices()) >= 8
