"""The port's mesh layer in one process: the layout tables against the JAX
package's shardings, the blocks, the shared generator, the bootstrap off
a cluster, the refusals, the allocation on a G shard, a world-1 mesh and a
resume on another device type. The runs across processes are in
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
    """ShardGen draws at the one-process shape and keeps this rank's block:
    plain and flat draws, uniform and normal, equal the one-process draw's
    slice, and the generators stay in step."""
    C, N, K, G = 4, 3, 5, 11
    mesh = fake_mesh(2, 3, ci=1, gi=gi)
    g0, g1 = M.g_block(G, mesh)
    ref = torch.Generator().manual_seed(7)
    sg = M.ShardGen(torch.Generator().manual_seed(7), mesh, C, G)
    full = torch.rand((C, 9, N, G), generator=ref)
    np.testing.assert_array_equal(sg.draw((2, 9, N, g1 - g0), 0, True),
                                  full[2:, :, :, g0:g1])
    full = torch.randn((2, C, N, K), generator=ref)
    np.testing.assert_array_equal(sg.draw((2, 2, N, K), 1, False, True),
                                  full[:, 2:])
    full = torch.rand((C, 18, K * N + N * G), generator=ref)
    got = sg.draw_flat((2, 18), [(1, K * N, False), (N, g1 - g0, True)])
    want = torch.cat([full[2:, :, :K * N], full[2:, :, K * N:].reshape(
        2, 18, N, G)[..., g0:g1].reshape(2, 18, -1)], -1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sg.get_state(), ref.get_state())


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
    seed = torch.tensor([12345], dtype=torch.int64)
    cs, gs = slice(C0, C0 + Cl), slice(G0, G0 + Gl)
    np.testing.assert_array_equal(
        AL.philox_planes(seed, Cl, N, K, Gl, g0=G0, G_total=G, c0=C0),
        AL.philox_planes(seed, C, N, K, G)[cs, ..., gs])
    u = AL.draw_planes(torch.Generator().manual_seed(1), C, N, K, G, "cpu")
    zg, zk = AL.allocate_counts(Mx, P, A, E, u=u)
    rest = [c for c in range(G) if not G0 <= c < G0 + Gl]

    def shard(cols):
        return AL.allocate_counts(
            Mx[:, cols].contiguous(), P[cs].contiguous(),
            A[cs].contiguous(), E[cs][..., cols].contiguous(),
            u=u[cs][..., cols].contiguous(), g0=G0, G_total=G, c0=C0)

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
    seed = torch.tensor([99], dtype=torch.int64)
    zg, zk = AL.allocate_counts_reference(
        Mx, P, A, E, AL.philox_planes(seed, C, N, K, G))
    parts = []
    for g0, g1 in ((0, 10), (10, 20)):
        u = AL.philox_planes(seed, 1, N, K, g1 - g0, g0=g0, G_total=G, c0=1)
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
    device='cpu': the state, records and tracker carry over exactly; the
    generator restarts seeded from (seed, iteration), and the log says so."""
    cc = bt.ConvergenceControl(MAP_over=10, MAP_every=5, miniters=10,
                               maxiters=20)
    s = bt.GibbsSampler(sim(), 3, prior="exponential", MH=False, seed=3,
                        convergence_control=cc, device="cpu",
                        output_dir=str(tmp_path / "run"))
    s._run_chunk(5, False)
    path = s.save_object()
    rewrite_device(path, "cuda:0")
    r = bt.GibbsSampler.load(path, device="cpu")
    for k, v in s.state["params"].items():
        np.testing.assert_array_equal(r.state["params"][k].numpy(),
                                      v.numpy())
    np.testing.assert_array_equal(r.sample_metrics.to_numpy(),
                                  s.sample_metrics.to_numpy())
    want = torch.Generator().manual_seed(CK.restart_seed(3, s.iter))
    np.testing.assert_array_equal(r.state["gen"].get_state(),
                                  want.get_state())
    assert "generator restarts" in (tmp_path / "run" / "log.txt").read_text()
    r._run_chunk(5, False)
    assert np.isfinite(r.sample_metrics.to_numpy()[:, 3]).all()
    # the same device type keeps the stream: a bit-exact resume
    rewrite_device(path, "cpu")
    r = bt.GibbsSampler.load(path)
    np.testing.assert_array_equal(r.state["gen"].get_state(),
                                  s.state["gen"].get_state())


def test_ensemble_load_onto_another_device_type(tmp_path):
    e = bt.ChainEnsemble(sim(), 3, n_chains=2, prior="exponential", MH=False,
                         seed=2, device="cpu",
                         convergence_control=bt.ConvergenceControl(
                             MAP_over=10, MAP_every=5, miniters=10,
                             maxiters=20))
    e._run_chunk(5)
    path = e.save_object(str(tmp_path / "ens.ckpt"))
    rewrite_device(path, "cuda")
    r = bt.ChainEnsemble.load(path, device="cpu")
    for k, v in e.states["params"].items():
        np.testing.assert_array_equal(r.states["params"][k].numpy(),
                                      v.numpy())
    want = torch.Generator().manual_seed(CK.restart_seed(2, e.iter))
    np.testing.assert_array_equal(r.states["gen"].get_state(),
                                  want.get_state())
    r.run()
    assert r.MAP_per_chain[0] is not None


def test_jax_mesh_partition_specs_are_tuples(jmesh):
    """What the comparison above relies on: a JAX PartitionSpec reads as
    the tuple of its axis names."""
    sh = JM.data_sharding(jmesh)
    assert tuple(sh.spec) == (None, "g")
    assert len(jax.devices()) >= 8
