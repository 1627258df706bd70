"""The kernels' launch rules over the catalogue envelope, and the plain
versions against the JAX package at the catalogue's widths.

The envelope (bayesnmf_tpu_torch/ops/__init__.py): K up to 1536 rows
(DBS-78, ID-83, SBS-96/192/288/384/1536) and N up to 128 components, at
any G and chain count. On the card every wrapper launches its kernel there
and raises ValueError beyond it; the launch rules that decide how are pure
Python, so the CPU checks them:

(a) at every (K, N, G, C) of a grid over the envelope each rule returns a
    configuration whose shared memory, recomputed here from the kernels'
    layouts, fits the 227 KB a block can have (and for the P and A
    columns' row form, its grid and the blocks an SM it is built for), and
    at N = 129 or K = 1537 each raises ValueError;
(b) at the shapes the benchmark cells and the card's earlier phases run,
    each rule returns the configuration it returned before the envelope
    widened (cluster, residency, G tile, register tile, tree);
(c) the plain versions (what the wrappers run on CPU tensors and what the
    kernels are held to on the card) equal the JAX functions on the same
    numpy inputs at the new widths, at the tolerances of
    tests/test_torch_fused_sweeps.py (but the acceptance records, ACC_RTOL),
    test_torch_stream_sweeps.py and test_torch_allocation.py (the JAX
    allocation kernel's body run eagerly; through interpret mode in a slow
    test);
(d) a conjugate fit at rank 70 (a tree of 128 leaves) runs on the CPU.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesnmf_tpu.ops import pallas_allocation as JPA
from bayesnmf_tpu.ops.pallas_allocation import allocate_counts_fused
import bayesnmf_tpu_torch as bt
from bayesnmf_tpu_torch import ops
from bayesnmf_tpu_torch.ops import allocation as AL
from bayesnmf_tpu_torch.ops import fused_sweeps as FS
from bayesnmf_tpu_torch.ops import stream_sweeps as S
from test_torch_allocation import jax_planes, setup
from test_torch_fused_sweeps import (OUT_NAMES, assert_match, jax_erfc_tail,
                                     make_inputs, run_jax, run_torch)
from test_torch_stream_sweeps import (STREAM_FUNCS, call_jax, call_port,
                                      close, stream_inputs)

torch.set_num_threads(1)

SMEM = 227 * 1024
KS = (78, 83, 96, 192, 288, 384, 1536)
NS = (1, 8, 20, 40, 64, 65, 80, 128)
GS = (37, 500, 2780, 10000)
CS = (1, 8, 64)
RULES = ("fused", "stream", "allocation")


# ---------------------------------------------------------------------------
# (a) the launch rules cover the envelope
# ---------------------------------------------------------------------------


def fused_smem(K, N, G, S_, e_res, res):
    """Shared memory of a cluster-form block of csrc/fused_sweeps.cu (512
    threads, 16 warps): as doubles the A column's partials (2 S), the block
    sums (16), the E row's partials (512 x 3) and a P column's pushed
    partials (S K 2 + S K 3); as floats a column's four K vectors, an E
    row's three 512 vectors, A, the NaN counts (512 + S), the flags (S), P
    with its prior pair (3 K N), the E slice (N Gq) and the data and Mhat
    slices (2 K Gq)."""
    Gq = -(-G // S_)
    doubles = 2 * S_ + 16 + 512 * 3 + 5 * S_ * K
    floats = (4 * K + 3 * 512 + N + 512 + 2 * S_ + 3 * K * N
              + (N * Gq if e_res else 0) + (2 * K * Gq if res else 0))
    return 8 * doubles + 4 * floats


def grid_smem(K, N, Gq, res):
    """Shared memory of a grid-form block (512 threads): as doubles the
    block sums (16) and the E row's partials (512 x 3); as floats a
    column's three K vectors, an E row's three 512 vectors, the NaN counts
    (512) and A, then the slices: E (N Gq, bit 1), data (bit 0) and Mhat
    (bit 2), K rows of an odd stride Gq | 1 each."""
    floats = (3 * K + 4 * 512 + N + (N * Gq if res & 2 else 0)
              + K * (Gq | 1) * ((res & 1) + (res >> 2 & 1)))
    return 8 * (16 + 512 * 3) + 4 * floats


def width(N):
    return -(-N // 4) * 4 if N <= 24 else 32 if N <= 32 else 64 if N <= 64 \
        else 128


def stream_smem(K, N, gt):
    """Shared memory of the three column tile blocks of
    csrc/stream_sweeps.cu (384 threads, a group of rows per roundup32(K)
    threads) at G width gt: the E tile (gt x NP), the groups' partials as
    doubles (3, 1 and 4 sums a row), the data tile (K x (gt + 1)), and the
    vectors (en and pn and the proposal; en, pn and A; A)."""
    NP = width(N)
    groups = 384 // min(-(-K // 32) * 32, 384)
    tile = gt * NP + K * (gt + 1)
    return (4 * (tile + 2 * groups * K * 3 + gt + 2 * K),
            4 * (tile + 2 * groups * K + gt + K + NP),
            4 * (tile + 2 * groups * K * 4 + NP))


def check_fused(K, N, G, C):
    if not FS.grid_form(K, N, G, C):
        # the cluster form: one cluster of at most 16 blocks a chain, the
        # chains' clusters within the 112 blocks the card keeps resident,
        # P, its prior pair and the partials in every block's shared memory
        S_, e_res, res = FS.cluster_config(K, N, G, C)
        assert S_ in (1, 2, 4, 8, 16)
        assert S_ == 1 or C * S_ <= 112
        assert e_res or not res
        assert FS.fixed_in_smem(K, N, S_)
        assert fused_smem(K, N, G, S_, e_res, res) <= SMEM
        return
    # the grid form, above 96 rows only: a launch's chains' blocks all
    # resident at once, one block a multiprocessor of an H100's 132; S
    # blocks a chain, every one with columns, at least 8 each where G
    # allows
    assert K > 96
    S_, group, res = FS.grid_config(K, N, G, C)

    def size(chains):
        S0 = max(1, min(-(-G // 8), 132 // chains))
        Gq = -(-G // S0)
        return -(-G // Gq), Gq

    S1, Gq = size(group)
    assert S_ == S1 and S_ * group <= 132 and 1 <= group <= min(C, 132)
    # as many chains a launch as keep the E and Mhat slices resident; all
    # of them where even one chain's do not fit
    if grid_smem(K, N, Gq, 6) <= SMEM:
        assert group == min(C, 132) or grid_smem(
            K, N, size(group + 1)[1], 6) > SMEM
    else:
        assert group == min(C, 132) and grid_smem(K, N, size(1)[1], 6) > SMEM
    assert grid_smem(K, N, Gq, res) <= SMEM
    # the slices in order, E, Mhat, data, each kept where it fits
    for bit in (2, 4, 1):
        assert res & bit or grid_smem(K, N, Gq, res | bit) > SMEM
    # the partials of a P column's two passes and an A column, the owners'
    # three K vectors, the flags and NaN counts, a barrier counter
    assert FS.grid_scratch_bytes(K, S_, C) == C * (
        8 * (5 * K * S_ + 2 * S_) + 4 * (3 * K + 2 * S_) + 4)


def check_stream(K, N, G, C):
    gt = S.col_tile(K, N)
    assert gt in (64, 32, 16)
    assert max(stream_smem(K, N, gt)) <= SMEM
    if gt < 64:  # the widest that fits
        assert max(stream_smem(K, N, 2 * gt)) > SMEM
    assert S.tile_width(N) == width(N) >= N
    rows = S.erow_rows(K, N)
    assert rows % 4 == 0 and rows >= 4
    if S.erow_split(K):
        # the split form from 192 rows on: a cluster of 1, 2 or 4 blocks of
        # at most 384 rows, their 8 warps' rings of 3 chunks of 8 rows, the
        # partials (3 doubles a thread of 256, 3 x 32 a block of the
        # cluster), the block's rows of the P column, each warp's Mhat
        # values (32 a row), the 32 g's proposals and the flags
        kc = S.erow_split_blocks(K)
        assert K >= 192 and rows == 3 * 64 and kc in (1, 2, 4)
        assert -(-K // kc) <= 384 and (kc == 1 or -(-K // (kc // 2)) > 384)
        Kb = -(-K // kc)
        smem = (8 * (3 * 256 + kc * 96)
                + 4 * (rows * width(N) + Kb + 8 * -(-Kb // 8) * 32 + 32
                       + kc))
    else:
        # the whole form: all rows of P*A (padded to 4) and the P column
        assert K < 192 and rows == -(-K // 4) * 4
        smem = 4 * (rows * width(N) + K)
    assert S.erow_smem_bytes(K, N) == smem <= SMEM
    check_rows_form(K, N, C)


def check_rows_form(K, N, C):
    """The P and A columns' row form from 192 rows on: 32 rows a block (a
    lane a row), a cluster of 1, 2, 4 or 8 blocks along G, the fewest that
    give at least twice an H100's 132 SMs in blocks (else 8); a ring of 3
    slots of G tiles 64 wide (32 for the 64- and 128-wide register tiles),
    each the E tile, the data tile of the block's rows with a padded
    stride and the column's E row; the warps' sums (3 doubles a thread of
    256, 1 for the A column), and for the P column the cluster's sums of
    both passes (5 x 32 doubles a block), the 32 proposals and the flags.
    Three blocks an SM fit up to a 32-wide register tile, one above."""
    if not S.col_rows_form(K):
        assert K < 192
        return
    kc, blocks = S.rows_parts(K, C), -(-K // 32)
    assert K >= 192 and kc in (1, 2, 4, 8)
    assert S.rows_grid(K, C) == (blocks * kc, C)
    assert C * blocks * kc >= 264 or kc == 8
    assert kc == 1 or C * blocks * (kc // 2) < 264
    NP = width(N)
    gt = 64 if NP <= 32 else 32
    assert S.rows_tile(N) == gt
    ring = 3 * (gt * NP + 32 * (gt + 1) + gt)
    want = {"pcol": 8 * (3 * 256 + kc * 5 * 32) + 4 * (ring + 32 + kc),
            "acol": 8 * 256 + 4 * ring}
    assert S.rows_smem_bytes(K, N, C) == want
    assert max(want.values()) <= SMEM
    # an SM's 228 KB, of which each block leaves 1 KB to the system
    per_sm = 228 * 1024 // (max(want.values()) + 1024)
    assert per_sm >= (3 if NP <= 32 else 1)


def check_allocation(K, N, G, C):
    n2 = AL.kernel_leaves(K, N)
    assert n2 >= N and n2 & (n2 - 1) == 0 and n2 <= 128
    # a block's counts of up to 8 leaves a pass, for its 8 x 32 cells
    assert 4 * 8 * min(n2, 8) * 32 <= SMEM
    # the tree of a cell: 2 n2 floats, in registers up to 16 leaves, in
    # local memory above
    assert 8 * n2 <= 1024


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("K", KS)
def test_launch_rules_cover_the_envelope(K, rule):
    check = {"fused": check_fused, "stream": check_stream,
             "allocation": check_allocation}[rule]
    for N in NS:
        for G in GS:
            for C in CS:
                check(K, N, G, C)


# (K, N, G, C) -> the fused kernel's grid form (blocks a chain, chains a
# launch, resident slices) or None for the cluster form: the catalogue
# shapes of the card's checks, either side of the forms' line
GRID_CASES = {(192, 20, 2780, 1): None, (192, 40, 2780, 1): (127, 1, 7),
              (288, 20, 1000, 1): (125, 1, 7), (1536, 8, 500, 1): (63, 1, 7),
              (1536, 20, 2780, 1): (127, 1, 6),
              (1536, 20, 2780, 8): (127, 1, 6),
              (1536, 20, 1000, 20): (33, 4, 6),
              (1536, 128, 10000, 64): (2, 64, 0)}


@pytest.mark.parametrize("shape", list(GRID_CASES))
def test_fused_form_by_shape(shape):
    """Where a cluster's block cannot hold P, its prior pair and the
    partials, the grid form takes the shape: as many blocks a chain as the
    card holds for the chains of a launch (127 of 22 columns for the
    SBS-1536 fit), a launch taking as many chains as keep the Mhat slice
    resident beside the E slice (one at 1536 x 2780, four at 1536 x 1000),
    all of them where none does."""
    want = GRID_CASES[shape]
    assert FS.grid_form(*shape) == (want is not None)
    if want is not None:
        assert FS.grid_config(*shape) == want
    # on a card of fewer multiprocessors the chains' blocks still fit it
    S_, group, _ = FS.grid_config(*shape, sms=20)
    assert S_ * group <= 20 and group <= shape[3]


@pytest.mark.parametrize("rule", RULES)
def test_launch_rules_refuse_beyond_the_envelope(rule):
    calls = {"fused": lambda K, N: FS.cluster_config(K, N, 2780, 8),
             "stream": lambda K, N: (S.col_tile(K, N), S.erow_rows(K, N)),
             "allocation": AL.kernel_leaves}[rule]
    for K, N in ((96, ops.MAX_N + 1), (ops.MAX_K + 1, 8)):
        with pytest.raises(ValueError, match=f"N <= {ops.MAX_N}"):
            calls(K, N)
    if rule == "stream":
        with pytest.raises(ValueError):
            S.tile_width(ops.MAX_N + 1)


# ---------------------------------------------------------------------------
# (b) the cells' and earlier phases' shapes keep their configuration
# ---------------------------------------------------------------------------

# (K, N, G, C) -> cluster_config before the envelope widened
KEPT = {(96, 8, 500, 1): (16, True, True), (96, 8, 500, 8): (8, True, True),
        (96, 8, 2780, 1): (16, True, True),
        (96, 8, 2780, 8): (8, True, False),
        (96, 20, 1000, 1): (16, True, True),
        (96, 20, 1000, 8): (8, True, True),
        (96, 20, 10000, 1): (16, True, False),
        (96, 20, 10000, 8): (8, True, False)}


@pytest.mark.parametrize("shape", list(KEPT))
def test_shapes_that_ran_keep_their_configuration(shape):
    K, N, G, C = shape
    assert FS.cluster_config(K, N, G, C) == KEPT[shape]
    assert FS.fixed_in_smem(K, N, KEPT[shape][0])
    assert S.col_tile(K, N) == 64
    assert not S.col_rows_form(K)           # the G-tile P and A columns
    assert S.tile_width(N) == (8 if N == 8 else 20)
    assert S.erow_rows(K, N) == 96          # all of P*A staged at once
    assert AL.kernel_leaves(K, N) == (8 if N == 8 else 32)


# ---------------------------------------------------------------------------
# (c) the plain versions against the JAX package at the new widths
# ---------------------------------------------------------------------------


# the acceptance records' rtol: an ulp of a proposal near 0 (one of ~1e-2
# whose Mu and Sigmasq come out of the hyper-sweep an ulp apart in XLA and
# PyTorch) moves exp(log ratio) by up to 1.4e-4 at (288, 20, 40), one record
# in 5760; every other output is held to test_torch_fused_sweeps' 1e-4
ACC_RTOL = 2e-4


@pytest.mark.parametrize("shape", [(288, 20, 40), (1536, 8, 24)])
def test_fused_plain_version_matches_jax_at_catalogue_rows(shape):
    """SBS-288 and SBS-1536 rows (the kernel: a halved cluster with P in
    shared memory, and P and the partials in global memory)."""
    d = make_inputs(*shape, seed=sum(shape))
    with jax_erfc_tail():
        want = run_jax(d, False)
    got = run_torch(d, False)
    for i in (3, 4):
        np.testing.assert_allclose(got[i], want[i], rtol=ACC_RTOL,
                                   atol=1e-5, err_msg=OUT_NAMES[i])
        got[i] = want[i]
    assert_match(got, want, d)
    assert not np.array_equal(got[0], d["P"])


@pytest.mark.parametrize("shape", [(1536, 8, 200), (96, 80, 200),
                                   (384, 20, 200)])
@pytest.mark.parametrize("name", list(STREAM_FUNCS))
def test_stream_plain_versions_match_jax_at_catalogue_widths(name, shape):
    """K = 1536 (16-wide G tiles, an E-row block in chunks of rows at large
    N), N = 80 (the 128-wide register tile) and K = 384 (past the row
    form's threshold of the P and A columns, at the ensemble's rank 20),
    at the G = 300 case's tolerance of tests/test_torch_stream_sweeps.py."""
    d = stream_inputs(*shape, seed=sum(shape))
    got, want = call_port(name, d), call_jax(name, d)
    rtol = 1e-5
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == np.float32
        close(g, w, rtol, atol=rtol * float(np.abs(w).max()),
              msg=f"{name} output {i}")


class _Ref:
    """A Pallas ref over a numpy array, for running a kernel body eagerly."""

    def __init__(self, a):
        self.a = np.array(a)
        self.shape, self.dtype = self.a.shape, self.a.dtype

    def __getitem__(self, i):
        return jnp.asarray(self.a[i])

    def __setitem__(self, i, v):
        self.a[i] = np.asarray(v)


def jax_kernel_body(M, P, A, E, u):
    """The JAX kernel's own body (pallas_allocation._alloc_kernel: its
    bottom-up weights, the heap order of its splits, its _binomial_tile) run
    eagerly on one G tile of the planes ``u`` (17, n2 - 1, K, G): the
    function ``allocate_counts_fused(..., interpret=True)`` evaluates, at a
    few seconds where interpret mode traces a 128-leaf tree for ~2-3
    minutes (``test_allocation_equals_jax_kernel_at_80_components``)."""
    K, N = P.shape
    G = E.shape[1]
    refs = [_Ref(x) for x in (u, M, P, A.reshape(N, 1), E)]
    zg, zk = _Ref(np.zeros((K, N), np.float32)), _Ref(
        np.zeros((N, G), np.float32))
    saved = JPA.pl
    JPA.pl = types.SimpleNamespace(
        program_id=lambda axis: 0,
        when=lambda cond: (lambda fn: fn() if cond else None))
    try:
        JPA._alloc_kernel(N, AL.n_leaves(N), False, *refs, zg, zk)
    finally:
        JPA.pl = saved
    return zg.a, zk.a


def test_allocation_plain_version_equals_jax_kernel_body_at_80_components():
    """A tree of 128 leaves (79 splits a cell, the padding subtrees skipped
    in the JAX kernel's heap order) on the JAX kernel's own planes: Zsum_g
    and Zsum_k equal to its body's."""
    K, N, G = 16, 80, 24
    M, P, A, E = setup(K, N, G, seed=7, excluded=(5, 70))
    u = jax_planes(jax.random.PRNGKey(3), K, N, G)
    want = jax_kernel_body(M, P, A, E, u)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got = AL.allocate_counts(t(M), t(P), t(A), t(E), u=t(u))
    assert AL.kernel_leaves(K, N) == 128
    for name, g, w in zip(("Zsum_g", "Zsum_k"), got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    np.testing.assert_array_equal(got[1].numpy().sum(0), M.sum(0))
    assert got[1].numpy()[[5, 70]].sum() == 0.0


@pytest.mark.slow
def test_allocation_equals_jax_kernel_at_80_components():
    """The same case through ``allocate_counts_fused(..., interpret=True)``
    itself (~2-3 minutes of tracing on one core)."""
    K, N, G = 16, 80, 24
    M, P, A, E = setup(K, N, G, seed=7, excluded=(5, 70))
    key = jax.random.PRNGKey(3)
    zg, zk = allocate_counts_fused(key, jnp.asarray(M), jnp.asarray(P),
                                   jnp.asarray(A), jnp.asarray(E),
                                   interpret=True)
    u = jax_planes(key, K, N, G)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got = AL.allocate_counts(t(M), t(P), t(A), t(E), u=t(u))
    for name, g, w in zip(("Zsum_g", "Zsum_k"), got, (zg, zk)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


# ---------------------------------------------------------------------------
# (d) the slice on the CPU
# ---------------------------------------------------------------------------


def test_conjugate_fit_at_rank_70_runs(tmp_path):
    """A conjugate Poisson-Exponential fit at rank 70, which the allocation
    refused above 64 components: its metrics are finite and its P is a
    signature matrix."""
    rng = np.random.default_rng(0)
    M = rng.poisson(20.0, (16, 24)).astype(np.float32)
    cc = bt.ConvergenceControl(MAP_over=4, MAP_every=4, miniters=4,
                               maxiters=8, Ninarow_nochange=2,
                               Ninarow_nobest=2)
    s = bt.fit(M, 70, prior="exponential", MH=False, device="cpu",
               convergence_control=cc, output_dir=str(tmp_path), seed=0,
               verbosity=0)
    rows = np.concatenate(s._metric_rows)
    assert rows.shape[0] == s.iter and np.isfinite(rows).all()
    P = np.asarray(s.MAP["P"])
    assert P.shape == (16, 70) and np.isfinite(P).all() and (P >= 0).all()
