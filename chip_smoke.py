#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--phases 3b,15]

Phases, in order; any failure raises and the script exits non-zero. With
``--phases`` (a comma-separated subset of 3, 3b, 3c, 3d, 4, ..., 15)
the card, the build and the chosen phases run, the kernels line holding
the entries whose phases ran (phase 14 runs phase 11's 1x2 workers for
their draws when 11 is not chosen); without it every phase runs:

1. the card (nvidia-smi name and power limit), torch's CUDA and nvcc;
2. build the kernels from bayesnmf_tpu_torch/csrc (one nvcc per source,
   all started together);
3. the fused-sweep kernel (one thread-block cluster per chain) against its
   plain PyTorch version on the card, on the same inputs and uniforms
   (truncnormal prior, fixed rank), at (K,N,G) = (96,8,500), (96,8,2780),
   (7,2,37), a 4-chain batch at (96,8,500), (96,8,1003) (G not divisible by
   the cluster) and (96,8,4000) (slices too large for shared memory), each
   with accept_all True and False, and two options the main path does not
   take (an excluded column A_n = 0; no hyper-sweep): every output within
   rtol 1e-4 / atol 1e-5, the same accept/reject decisions, and
   bit-identical outputs on two launches; the cluster size and where the
   slices sit are printed per case;
3b. each streaming kernel (the four bodies of ``_run``, ``acol_delta``,
   ``chain_metrics``) against its plain PyTorch version at (K,N,G,C) =
   (96,20,10000,8), (96,20,25000,2), (7,3,37,2) and (16,3,300,2) with an
   excluded column: max abs and rel diff per output within the tolerance
   stated in ops/stream_sweeps.py, bit-identical on two launches, and each
   timed at (96,20,10000,8), on the device (torch.profiler) and per call
   through its wrapper (CUDA events), beside its plain version; the
   metrics row ``stream_metrics_row`` (two launches) against its plain
   version at those shapes, with excluded columns and a chain with none,
   and with prior means deep in log_ndtr's tail: it, n_params, sum A and
   the temperature equal, every other entry within the sums' tolerance,
   two launches bit-identical, timed at (96,20,10000,8) beside PR 5's
   composition of the row (P * A, ``chain_metrics``, the host
   arithmetic); the kernels' ndtri, log_ndtr, ndtr and sigmoid against the
   PyTorch calls on 4M arguments each, all four equal; the column updates ``stream_pcol_update`` and
   ``stream_erow_update`` against the host sequence, column by column from
   the same state, at those shapes, with an excluded column, inactive
   columns, warmup flags mixed across chains and conditionals deep in the
   truncated tail: values and recorded acceptances within the tolerances
   of ops/stream_sweeps.py, NaN counts equal, no decision different, two
   launches bit-identical, one call for a sweep equal to its columns one by
   one; and the A-column update ``stream_acol_update`` against the host
   sequence likewise, at the same shapes with a mixed starting A, SBFI and
   BFI, and a chain whose deltas are all NaN: the same A, NaN counts equal,
   each delta within the sums' tolerance, two launches bit-identical, one
   call for a sweep equal to its columns one by one; each column update
   timed per column at (96,20,10000,8); the exact hyper-update
   ``hyper_update`` (one launch) against its PyTorch ops at
   (96,20,10000,8), (1536,20,2780,8) and one chain at (96,8,500), with Mu
   deep in log_ndtr's tail, Sigmasq at the 1e-30 floor and g_new <= 1e-30:
   every entry bit for bit, timed by CUDA events beside its bound;
4. the fixed-rank slice: ``bayesnmf_tpu_torch.fit`` on a 96x500 rank-8
   synthetic catalogue on the card, checking that the state stayed on the
   card, the metrics are finite, the kernel ran once per iteration, the MAP
   signatures match the true ones (Hungarian-matched cosine >= 0.95), and
   the final checkpoint resumes bit-exactly;
3c. the fused kernel's branches of the third slice against its plain
   version: SBFI and BFI rank learning at (96,20,1000) at temperatures 1e-4
   and 1, a 4-chain batch at (7,3,37) with rank learning and mixed warmup
   flags, the exponential prior at (96,5,100) and (96,8,500) with an
   all-zero E row, exact_mh=False at (96,8,500): every output within
   rtol 1e-4 / atol 1e-5, A, R and every decision equal, two launches
   bit-identical; timed at (96,20,1000) with and without the rank branch;
3d. the allocation kernel against its plain version at (96,5,100),
   (96,20,10000), (96,8,2780), (7,3,37), (16,5,40) with A_3 = 0 and a zero
   M cell, and 4 chains at (96,8,500), in both modes: with uniform planes,
   and in Philox mode against the plain version on the planes
   ``philox_planes`` builds for the same key; Zsum_g and Zsum_k equal, two
   launches bit-identical; in Philox mode also 200 draws that conserve the
   counts, give an excluded component 0 and integers, and whose mean lies
   within 6 SD of the multinomial mean in every cell, and seeds that repeat
   and differ; timed at (96,5,100), (96,20,10000) and (96,8,2780), on the
   device (torch.profiler) and per call through the wrapper; and at
   (96,20,10000) what warps whose lanes take both regimes of a split cost
   (equal weights, counts alike or alternating along a warp);
4. the fixed-rank slice: ``bayesnmf_tpu_torch.fit`` on a 96x500 rank-8
   synthetic catalogue on the card, checking that the state stayed on the
   card, the metrics are finite, the kernel ran once per iteration, the MAP
   signatures match the true ones (Hungarian-matched cosine >= 0.95), and
   the final checkpoint resumes bit-exactly;
5. the ensemble slice: ``ChainEnsemble`` with SBFI over ranks 1..20, 8
   chains, on a 96x10000 rank-8 synthetic catalogue, through the streaming
   kernels: every metrics row finite, each stream kernel launched its
   launches per iteration times the iterations run (3N for the P and E
   sweeps' kernels, N A columns through ``stream_acol_update``, one
   metrics-row call, one ``hyper_update`` launch and no ``chain_metrics``
   launch), the final checkpoint
   resumes bit-exactly for 20 iterations; it prints the iterations, the
   chain-it/s of the run and of the chunk loop alone, each chain's learned
   rank and matched cosine, and the loop's device busy share and device
   events per iteration (torch.profiler);
6. rank learning: ``fit`` on a 96x1000 rank-8 catalogue over ranks 1..20
   by SBFI: metrics finite, the fused kernel launched once per iteration
   and no other kernel, the rank moved while tempering, the best-matched
   MAP columns cosine >= 0.9, bit-exact resume; learned rank, fit and loop
   it/s;
7. BASELINE config 1 (96x100, rank 5, Poisson-Exponential) with MH and
   conjugate (MH=False): matched cosine >= 0.9, bit-exact resume, the
   allocation kernel launched iterations + 1 times; then the conjugate
   chunk loop at 96x2780, rank 8 (config 4's shape): it/s, device busy
   share and the host waits of the gamma draws (torch.profiler);
8. the eager sweeps (no kernel) and the Normal likelihood: (a) one step of
   each new path (Normal-TruncNormal and Normal-Exponential at a fixed
   rank and learning it, Poisson MH on the eager sweeps with the exact and
   the reference ratio and SBFI, exact_truncnorm_hypers=False on the fused
   and the eager path) at 96x500, rank 8, on the card against the CPU on
   the same draws: A, R and the MH decisions equal, the rest within
   rtol 1e-3 / atol 1e-4; (b) fits at 96x500, rank 8 (config 2's shape,
   phase 4's recipe): Normal-TruncNormal, Normal-Exponential and
   Poisson-TruncNormal with fused_sweeps=False, MAP matched cosine >= 0.9,
   no kernel launched, fit and loop it/s, and the fused path's loop on the
   same data beside them (its kernel launched once per iteration); (c)
   Normal-TruncNormal SBFI over ranks 1..20 at 96x1000 (config 3's shape),
   maxiters 500: learned rank and cosines; (d) the Normal fit's final
   checkpoint resumes bit-exactly; (e) torch.profiler over 10 iterations
   of the Normal and the eager Poisson loops: busy share, device events
   and host waits per iteration;
9. the ensemble slice: (a) the fused kernel at (96,8,500) with 8 and 64
   chains and at (96,20,1000) with 20 chains masked to ranks 1..20, the
   warmup flag alternating over the chains, against its plain version as
   in phase 3, with ``cluster_config``, the kernel's time and its bound;
   (b) the exponential prior in the stream kernels (the P-column and E-row
   updates at (96,20,10000,8), with an excluded and inactive columns and
   deep in the truncated tail; the metrics row at (96,20,10000,8) and with
   a chain without columns) against their plain versions at the
   truncnormal cases' limits, timed; (c) the allocation on a conjugate
   ensemble's step at (96,8,2780) with 8 chains, both modes equal to the
   plain version; (d) whole runs: ``fit(rank_method="BIC")`` over ranks
   1..20 at 96x1000 (one fused launch per iteration, best rank and BIC
   table), the Poisson-Exponential SBFI ensemble at 96x10k with 8 chains
   through the stream kernels (3N + N + 1 launches per iteration), a
   conjugate ensemble at 96x2780 with 8 chains (one allocation launch per
   iteration, plus one), a Normal-TruncNormal ensemble at 96x500 (no
   kernel), each with chain-it/s over run() and in the chunk loop, busy
   share, device events per iteration, diagnostics() and the best chain's
   matched cosine >= 0.9; Poisson MH at 96x500 with 8 and 64 chains on the
   fused kernel and on the eager sweeps; (e) the masked ensemble's final
   checkpoint resumes bit-exactly;
10. the Poisson-Gamma family and the recording surface: (a) the allocation
   kernel on Poisson-Gamma states (30 steps on the card) at (96,8,2780)
   with 1 and 8 chains, both modes, against its plain version (equal, two
   launches bit-identical), timed, with its bound; (b) one Poisson-Gamma
   step at 96x500, rank 8, at a fixed rank and with SBFI, on the card
   against the CPU on the same draws: A, R and the slice decisions equal,
   Alpha and Beta within rtol 1e-4, P and E within rtol 1e-3 / atol 1e-4;
   (c) fits: the reference's example data at rank 4 (matched cosine
   > 0.9), 96x2780 rank 8 (cosine >= 0.9, the allocation launched
   iterations + 1 times, fit and loop it/s, busy share, device events and
   host waits per iteration), SBFI over ranks 1..20 at 96x1000 (the
   learned rank), an 8-chain ensemble at 96x2780 (chain-it/s,
   diagnostics()), ``fit(rank_method="BIC", save_all_samples=True)`` over
   ranks 1..20 at 96x1000 (best rank, the winner's finite get_logpost());
   (d) record_history='full' with save_all_samples on the 96x10k SBFI
   stream ensemble of 8 chains for 200 iterations beside 'basic' (launches
   per iteration unchanged, acceptance entries in [0, 1], peak device
   memory, chain-it/s), and on config 2's fused fit beside phase 4's
   it/s, whose final checkpoint resumes bit-exactly with its archive;
11. distributed runs (``mesh``): (a) the allocation kernel on each G shard
   (96,8,1390) of the 96x2780 matrix: in planes mode equal to its plain
   version on that slice of the whole planes, in Philox mode the shards'
   Zsum_k side by side equal to the one-process kernel's bit for bit and
   their Zsum_g adding to its Zsum_g exactly, and equal to the plain
   version on ``philox_planes`` with the shard's offset; timed, with its
   bound; (b) a world-1 NCCL mesh (``global_mesh(1, 1)``): a conjugate
   Poisson-Exponential fit at 96x2780, rank 8, 50 iterations, bit-identical
   to the run without a mesh; (c) two processes on the one card over gloo
   (``python3 chip_smoke.py --mesh-worker ...``, each under a hard time
   limit, a failure of either failing the script): 1x2 G-split conjugate
   Poisson-Exponential and Poisson-Gamma at 96x2780, rank 8, 20 steps, and
   a 1x2 eager Poisson-TruncNormal MH at 96x500, rank 8, 10 steps, against
   the one-process card run of the same seed (loglik and log-posterior
   within rtol 1e-4 every step; P bit-identical on the two ranks; the
   differing latent counts and MH decisions printed: a count or decision
   whose draw falls within the float rounding of the split moves a
   chain's later draws); a 2x1 chain-split conjugate ensemble of 8 chains
   at 96x2780, one chunk of 10, bit-identical to the one-process ensemble;
   (d) a checkpoint saved on the 1x2 mesh loads in one process and
   continues as the mesh did, and a card checkpoint loads with
   device="cpu" (the state and the streams equal); (e) the
   conjugate loop's it/s at 96x2780 in one process and on the 1x2 mesh of
   the one card, with the all-reduces per iteration: the cost of gloo's
   host copies on one card, not a scaling figure;
12. the Geweke gates of tests/test_torch_geweke.py with the kernels on the
   card (``run_geweke``);
13. the benchmark (bench_torch.py, ``run_bench``) at short windows: the
   three cells and configs 1..5 (config 5's full 256 x 96x100k shape for 2
   iterations), each result through JSON and back, ``correct`` true (its
   launch counts and no plain version among its checks), every metric
   measured;
14. the chains' counter-based streams (``run_rng``): (a) the draw kernel
   (csrc/rng.cu) against its plain version on the card and on the CPU at
   the north-star ensemble's stream-step draws (8 chains at 96x10k, SBFI
   over ranks 1..20) and at a mesh rank's G block (an index map):
   uniforms bit for bit, normals within NORMAL_ATOL, each timed beside its
   bound, its plain version and torch.rand / torch.randn of the shape;
   (b) tests/test_torch_ensemble.py's compaction test on the card for the
   fused and stream ensembles (the same end iterations and MAP windows,
   MAP columns' cosines > 0.98, every chain draw equal); (c) a conjugate
   sampler saved on the card resumes on the CPU with its streams (the next
   draws equal; the allocation's Philox planes drawn on the CPU equal the
   card's, the card kernel equal to its plain version on them); (d) phase
   11's 1x2 mesh: each rank's draws the one-process
   draw's block, each rank computing only its block's elements;
15. catalogue shapes (``run_catalogue``): (a) each kernel against its plain
   version at shapes of the envelope (K <= 1536, N <= 128) that raised
   before: the fused kernel in its cluster form at (192,20,2780) and in
   its grid form (a chain over up to one block per SM, ``grid_config``)
   at (192,40,2780), (288,20,1000) (also with the exponential prior and an
   inactive column), (1536,8,500) and (1536,20,2780) with the rank branch,
   one chain and 8 chains of their own A, as in phase 3; the allocation at
   n2 = 128, Philox mode at (96,80,2780) and (1536,80,2780) (the plain
   version on G chunks of 1024) and planes mode at (96,80,300), equal; the
   stream kernels (the sums-only bodies, the metrics row, the P, E and A
   column updates) at (1536,20,2780,8) (16-wide G tiles), (96,80,10000,2)
   (the 128-wide register tile), (192,20,2780,8) and (1536,64,300,2) (the
   E row's split form at its first K and at a 64-wide register tile), as
   in phase 3b; each timed beside its bound and its plain version, and the
   E-row sweep timed in both forms either side of their line (CUDA
   events); the P and A columns' row form (K >= 192) also at
   (384,20,2780,8) with an inactive column, (1530,8,1001,4) (a cluster of
   two blocks, a K no block's 32 rows and a G no tile width divides, an
   excluded column; and with the exponential prior) and (192,80,300,2)
   (the 128-wide register tile), as in phase 3b; (b) on a 1536x2780 rank-8 catalogue (phase 4's recipe, E ~
   Gamma(2, 8000)): ``fit`` over ranks 1..20 with default flags (the fused
   kernel, SBFI; 600 iterations) and an 8-chain ``ChainEnsemble`` over
   ranks 1..20 (the stream kernels by the auto policy; 300 iterations;
   every P and A column of every step in the row form, every E row in the
   split form), each with every launch count exact, no plain version
   called, metrics finite and a matched min cosine of MAP P >= 0.9; a
   conjugate rank-80
   ``fit`` at 96x2780 and two conjugate steps at (1536, 80, 2780) (the
   allocation launched once a step, + 1 at the fit's start).

Every phase that drives a path also counts the draw kernel's launches
exactly: the path's draws a step (models/gibbs.draw_launches) times the
iterations, the initial state's draws where the window holds them, and one
a rejection round of the gamma draws.

The launch counts are set to 0 just before each phase drives its path and
read just after, so launches made to compare a kernel with its plain version
do not count. The last lines are the card, a JSON line of the kernels'
results, and ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the package beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from bayesnmf_tpu_torch.ops.rng import ChainStreams
from bayesnmf_tpu_torch.utils.measure import (
    acol_update_bound, alloc_bound, card_line, count_ops, device_ms,
    draw_launches, fused_bound, hyper_bound, kernel_ms, launch_counters,
    loop_rates, matched_cosines, metrics_row_bound, n_leaves, pe_bound,
    plain_calls, profile_loop, profile_run, reset_counts, rng_bound,
    stream_bound, synthetic, time_ms, update_bound)

RTOL, ATOL = 1e-4, 1e-5
# (K, N, G, chains, A, hyper-sweep)
KERNEL_CASES = [(96, 8, 500, 1, None, True), (96, 8, 2780, 1, None, True),
                (7, 2, 37, 1, None, True), (96, 8, 500, 4, None, True),
                (16, 3, 24, 1, (1.0, 0.0, 1.0), True),
                (7, 2, 37, 1, None, False),
                # G not divisible by the cluster; slices too large for
                # shared memory
                (96, 8, 1003, 1, None, True), (96, 8, 4000, 1, None, True)]
TIMED_SHAPES = [(96, 8, 500, 1), (96, 8, 2780, 1), (96, 8, 4000, 1)]
_ARGS = ("data", "P", "E", "A", "Mhat", "acc_P", "acc_E", "Upr_P", "Upr_E",
         "Up_P", "Ua_P", "Up_E", "Ua_E", "hp0_p", "hp1_p", "hp0_e", "hp1_e",
         "rank_pack")


class SmokeFailure(RuntimeError):
    pass


def check_draws(label, launches, gibbs, spec, steps, init=True):
    """The draw kernel's launches (csrc/rng.cu) over a window started by
    ``reset_counts``: exactly ``spec``'s path's draws a step times
    ``steps`` (with ``init`` the initial state's draws too) and one a
    rejection round of its gamma draws. Returns the count."""
    want = draw_launches(gibbs, spec, steps, init)
    check(launches["rng"] == want, f"{label}: draw kernel launches "
          f"{launches['rng']} != {want} ({gibbs.draw_launches(spec)} x "
          f"{steps} iterations" + (" + the initial draws" if init else "")
          + " + the rejection rounds)")
    return want


def ported(launches) -> int:
    """The launches of the ported TPU kernels (every counter but the
    chains' draw kernel)."""
    return sum(v for k, v in launches.items() if k != "rng")


def uniform_planes(torch, AL, C, N, K, G, seed):
    """Uniform planes (C, 17, n2-1, K, G) in [1.2e-38, 1) on the card, for
    the allocation's planes mode."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return torch.rand((C, AL.N_PLANES, AL.n_nodes(N), K, G), generator=gen,
                      device="cuda").clamp_min_(1.2e-38)


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# phase 3: kernel against plain version
# ---------------------------------------------------------------------------


def sweep_inputs(K, N, G, C, seed, A=None):
    """One call's operands, as the Gibbs step hands them over, made with
    numpy from ``seed``; C > 1 stacks C independent chains on the first
    chain's data."""
    rng = np.random.default_rng(seed)
    f = np.float32

    def one():
        Pt = rng.dirichlet(np.ones(K) * 0.5, N).T * 50.0
        Et = rng.gamma(2.0, 2.0, (N, G))
        data = rng.poisson(Pt @ Et).astype(f)
        P = (Pt * rng.uniform(0.5, 1.5, (K, N))).astype(f)
        E = (Et * rng.uniform(0.5, 1.5, (N, G))).astype(f)
        u = lambda *s: rng.uniform(1e-6, 1.0, s).astype(f)  # noqa: E731
        a = np.ones(N, f) if A is None else np.asarray(A, f)
        return dict(
            data=data, P=P, E=E, A=a, Mhat=((P * a) @ E).astype(f),
            acc_P=np.ones((K, N), f), acc_E=np.ones((N, G), f),
            Upr_P=u(K, N), Upr_E=u(N, G), Up_P=u(K, N), Ua_P=u(K, N),
            Up_E=u(N, G), Ua_E=u(N, G),
            hp0_p=rng.normal(0.0, 1.0, (K, N)).astype(f),
            hp1_p=rng.gamma(2.0, 2.0, (K, N)).astype(f),
            hp0_e=rng.normal(0.0, 1.0, (N, G)).astype(f),
            hp1_e=rng.gamma(2.0, 2.0, (N, G)).astype(f),
            rank_pack=np.zeros((3, N + 1), f),
            Hu_p=u(4, K, N), Hu_e=u(4, N, G))

    chains = [one() for _ in range(C)]
    d = {k: (chains[0][k] if C == 1 or k == "data"
             else np.stack([c[k] for c in chains])) for k in chains[0]}
    mean = float(d["data"].mean())
    hp = [0.0, np.sqrt(mean / N), N + 1.0, np.sqrt(N)]
    d["Hhp_p"] = np.stack([np.full((K, N), v, f) for v in hp])
    d["Hhp_e"] = np.stack([np.full((N, G), v, f) for v in hp])
    return d


def plain_sweeps(FS, t, C, accept_all, hyper=True, **kw):
    """The fused sweep's plain version on the card tensors ``t`` of
    sweep_inputs, with the warmup flag in the rank pack as the wrapper puts
    it; outputs in the wrapper's order, without the chain axis at C = 1."""
    bt = (lambda x: x) if C > 1 else (lambda x: x.unsqueeze(0))
    rp = bt(t["rank_pack"]).clone()
    rp[:, 0, 1] = (accept_all.float() if hasattr(accept_all, "float")
                   else float(accept_all))
    extra = {}
    if hyper:
        extra = dict(hyper_u=(bt(t["Hu_p"]), bt(t["Hu_e"])),
                     hyper_hp=(t["Hhp_p"], t["Hhp_e"]))
    out = FS.fused_gibbs_sweeps_reference(
        t["data"], *(bt(t[k]) for k in _ARGS[1:17]), rp, **kw, **extra)
    return out if C > 1 else tuple(x[0] for x in out)


_OUT_NAMES = ("P", "E", "Mhat", "acc_P", "acc_E", "A", "R", "nan", "hp0_p",
              "hp1_p", "hp0_e", "hp1_e")


def check_sweep_case(torch, FS, t, C, case, accept_all, hyper=True, **kw):
    """One fused-sweep case on the card: two kernel launches bit-identical,
    every output within RTOL/ATOL of the plain version, A, R and every
    accept decision equal. Returns (max abs diff, kernel fn, plain fn)."""
    args = [t[k] for k in _ARGS]
    hk = {}
    if hyper:
        hk = dict(hyper_u=(t["Hu_p"], t["Hu_e"]),
                  hyper_hp=(t["Hhp_p"], t["Hhp_e"]))
    kw = dict(prior_kind="truncnormal", exact_mh=True, rank_method=None) | kw

    def kernel():
        return FS.fused_gibbs_sweeps(*args, accept_all=accept_all, **kw,
                                     **hk)

    def plain():
        return plain_sweeps(FS, t, C, accept_all, hyper, **kw)

    k1, k2 = kernel(), kernel()
    p = plain()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(k1, k2)),
          f"two launches differ at {case}")
    errs = {}
    for name, a, b in zip(_OUT_NAMES, k1, p):
        errs[name] = float((a - b).abs().max()) if a.numel() else 0.0
        check(torch.allclose(a, b, rtol=RTOL, atol=ATOL),
              f"{name} differs at {case} accept_all={accept_all}: max abs "
              f"{errs[name]}")
    for i, name in ((0, "P"), (1, "E")):
        check(torch.equal(k1[i] != args[i + 1], p[i] != args[i + 1]),
              f"{name} accept decisions differ at {case}")
    check(torch.equal(k1[5], p[5]) and torch.equal(k1[6], p[6]),
          f"A or R differ at {case}")
    worst = max(errs.values())
    K, N = t["P"].shape[-2:]
    print(f"kernel vs plain {case} accept_all={accept_all}: "
          f"{fused_form(torch, FS, K, N, t['E'].shape[-1], C)}; max abs diff "
          f"{worst:.3e} ({', '.join(f'{k} {v:.1e}' for k, v in errs.items())}"
          "); A, R and decisions equal; two launches bit-identical",
          flush=True)
    return worst, kernel, plain


def fused_form(torch, FS, K, N, G, C):
    """The fused kernel's form at a shape, as printed beside its checks."""
    if FS.grid_form(K, N, G, C):
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        S_, group, res = FS.grid_config(K, N, G, C, sms)
        where = [name for bit, name in ((2, "E"), (4, "Mhat"), (1, "data"))
                 if res & bit]
        return (f"grid form of {S_} blocks a chain, {group} chains a "
                f"launch, {', '.join(where) or 'no'} slices in shared "
                "memory")
    cluster, e_res, res = FS.cluster_config(K, N, G, C)
    where = ("data, Mhat and E slices in shared memory" if res else
             "E slice in shared memory, data and Mhat in global memory"
             if e_res else "slices in global memory")
    return f"cluster of {cluster}, {where}"


def to_card(torch, d):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to("cuda")
            for k, v in d.items()}


def compare_kernel(torch, FS):
    """Phase 3. Returns (max_abs_err, {shape: (kernel ms on the device, ms
    per call through the wrapper, plain_ms)})."""
    max_err = 0.0
    times = {}
    for (K, N, G, C, A, hyper) in KERNEL_CASES:
        t = to_card(torch, sweep_inputs(K, N, G, C, seed=K + N + G + C, A=A))
        case = f"(K,N,G,C)={(K, N, G, C)}" + (f" A={A}" if A else "") + (
            "" if hyper else " no hyper-sweep")
        for accept_all in (True, False):
            worst, kernel, plain = check_sweep_case(torch, FS, t, C, case,
                                                    accept_all, hyper)
            max_err = max(max_err, worst)
            if (K, N, G, C) in TIMED_SHAPES and hyper and not accept_all:
                times[(K, N, G)] = (*kernel_ms(torch, kernel, 50),
                                    time_ms(torch, plain, 5))
    return max_err, times


# (K, N, G, chains): phase 3, the fixed-rank form fused_pe_sweeps
PE_CASES = [(96, 8, 500, 1), (7, 3, 37, 4)]


def compare_pe_sweeps(torch, FS, card):
    """Phase 3: ``fused_pe_sweeps`` (the kernel at a fixed rank: a zero rank
    pack, no rank branch, no hyper-sweep) against its plain version on the
    card, with accept_all True and False: the five outputs within
    RTOL/ATOL, every decision equal, two launches bit-identical; timed at
    (96,8,500). Returns its kernel row's numbers."""
    err, row = 0.0, {}
    for (K, N, G, C) in PE_CASES:
        t = to_card(torch, sweep_inputs(K, N, G, C, seed=K + N + G + C + 1))
        args = [t[k] for k in _ARGS[:17]]
        b = (lambda x: x) if C > 1 else (lambda x: x.unsqueeze(0))
        for accept_all in (True, False):
            def kernel():
                return FS.fused_pe_sweeps(*args, prior_kind="truncnormal",
                                          exact_mh=True,
                                          accept_all=accept_all)

            def plain():
                rp = torch.zeros((C, 3, N + 1), device="cuda")
                rp[:, 0, 1] = float(accept_all)
                out = FS.fused_gibbs_sweeps_reference(
                    t["data"], *map(b, args[1:]), rp,
                    prior_kind="truncnormal", exact_mh=True)[:5]
                return out if C > 1 else tuple(x[0] for x in out)

            k1, k2 = kernel(), kernel()
            p = plain()
            torch.cuda.synchronize()
            case = f"fused_pe_sweeps (K,N,G,C)={(K, N, G, C)} " \
                f"accept_all={accept_all}"
            check(len(k1) == 5 and all(torch.equal(x, y)
                                       for x, y in zip(k1, k2)),
                  f"{case}: two launches differ")
            for name, x, y in zip(_OUT_NAMES, k1, p):
                err = max(err, float((x - y).abs().max()))
                check(torch.allclose(x, y, rtol=RTOL, atol=ATOL),
                      f"{case}: {name} differs from the plain version")
            for i, name in ((0, "P"), (1, "E")):
                check(torch.equal(k1[i] != args[i + 1], p[i] != args[i + 1]),
                      f"{case}: {name} accept decisions differ")
            print(f"kernel vs plain {case}: max abs diff {err:.3e}, "
                  "decisions equal, two launches bit-identical", flush=True)
        if (K, N, G, C) == PE_CASES[0] and not accept_all:
            ms, wrapped = kernel_ms(torch, kernel, 50)
            plain_ms = time_ms(torch, plain, 5)
            b_ms, b_by = pe_bound(K, N, G)
            row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                   "bound_by": b_by}
            print(f"time per call of fused_pe_sweeps at (K,N,G)={(K, N, G)}: "
                  f"kernel {ms:.4f} ms on the device ({wrapped:.4f} ms per "
                  f"call through the wrapper), plain PyTorch {plain_ms:.4f} "
                  f"ms, bound {b_ms:.5f} ms ({b_by}), on {card}", flush=True)
    return dict(row, max_abs_err=err)


# (K, N, G, chains, options, temperatures): phase 3c, kernel 1's branches
# ported in this slice
BRANCH_CASES = [
    (96, 20, 1000, 1, dict(rank_method="SBFI"), (1e-4, 1.0)),
    (96, 20, 1000, 1, dict(rank_method="BFI"), (1e-4, 1.0)),
    (7, 3, 37, 4, dict(rank_method="SBFI"), (1e-4, 1.0)),
    (96, 5, 100, 1, dict(prior_kind="exponential"), (None,)),
    (96, 8, 500, 1, dict(prior_kind="exponential"), (None,)),
    (96, 8, 500, 1, dict(exact_mh=False), (None,)),
]
RANK_TIMED = (96, 20, 1000)


def branch_inputs(K, N, G, C, seed, kw, temp):
    """sweep_inputs with a mixed starting A and the rank pack of a
    rank-learning step; for the exponential prior Lambda in hp0, ones in
    hp1 and one all-zero E row (an inactive P column)."""
    rng = np.random.default_rng(seed + 1000)
    A = (rng.uniform(size=N) < 0.6).astype(np.float32) if "rank_method" in kw \
        else None
    d = sweep_inputs(K, N, G, C, seed, A=A)
    lead = (C,) if C > 1 else ()
    if temp is not None:
        rp = np.zeros(lead + (3, N + 1), np.float32)
        rp[..., 0, 0] = temp
        rp[..., 1, :] = -np.log(-np.log(rng.uniform(1e-6, 1.0,
                                                    lead + (N + 1,))))
        rp[..., 2, :N] = rng.uniform(1e-6, 1.0, lead + (N,))
        d["rank_pack"] = rp.astype(np.float32)
    if kw.get("prior_kind") == "exponential":
        d["hp0_p"] = rng.gamma(2.0, 0.5, d["hp0_p"].shape).astype(np.float32)
        d["hp0_e"] = rng.gamma(2.0, 0.5, d["hp0_e"].shape).astype(np.float32)
        d["hp1_p"] = np.ones_like(d["hp1_p"])
        d["hp1_e"] = np.ones_like(d["hp1_e"])
        d["E"][..., 1, :] = 0.0
        d["Mhat"] = np.einsum("...kn,...n,...ng->...kg", d["P"], d["A"],
                              d["E"]).astype(np.float32)
    return d


def compare_branches(torch, FS, card):
    """Phase 3c. Returns (max_abs_err, {label: (kernel ms on the device, ms
    per call through the wrapper, plain_ms)}) with the times at RANK_TIMED
    with and without the rank branch."""
    max_err = 0.0
    times = {}
    for (K, N, G, C, kw, temps) in BRANCH_CASES:
        for temp in temps:
            d = branch_inputs(K, N, G, C, K + N + G + C, kw, temp)
            t = to_card(torch, d)
            hyper = kw.get("prior_kind") != "exponential"
            case = (f"(K,N,G,C)={(K, N, G, C)} "
                    + " ".join(f"{k}={v}" for k, v in kw.items())
                    + ("" if temp is None else f" temp={temp}"))
            flags = (torch.tensor([True, False, True, False], device="cuda")
                     if C > 1 else None)
            for accept_all in ((flags,) if C > 1 else (True, False)):
                worst, kernel, plain = check_sweep_case(
                    torch, FS, t, C, case, accept_all, hyper, **kw)
                max_err = max(max_err, worst)
            if (K, N, G) == RANK_TIMED and kw.get("rank_method") == "SBFI" \
                    and temp == 1.0:
                times["rank"] = (*kernel_ms(torch, kernel, 20),
                                 time_ms(torch, plain, 3))
                fixed = dict(kw, rank_method=None)
                _, kernel0, plain0 = check_sweep_case(
                    torch, FS, t, C, case + " (fixed rank)", False, hyper,
                    **fixed)
                times["fixed"] = (*kernel_ms(torch, kernel0, 20),
                                  time_ms(torch, plain0, 3))
    for label, (k_ms, w_ms, p_ms) in times.items():
        b_ms, b_by = fused_bound(*RANK_TIMED, rank=label == "rank")
        print(f"time per call at (K,N,G)={RANK_TIMED} "
              f"{'with' if label == 'rank' else 'without'} the rank branch: "
              f"kernel {k_ms:.4f} ms on the device ({w_ms:.4f} ms per call "
              f"through the wrapper), plain PyTorch {p_ms:.4f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}), on {card}", flush=True)
    return max_err, times


# ---------------------------------------------------------------------------
# phase 4: the slice
# ---------------------------------------------------------------------------


def run_slice(torch, bt, FS, gibbs, card):
    rng = np.random.default_rng(0)
    K, N, G = 96, 8, 500
    P_true = rng.dirichlet(np.ones(K) * 0.3, N).T
    E_true = rng.gamma(2.0, 500.0, (N, G))
    M = rng.poisson(P_true @ E_true).astype(np.float32)
    cc = bt.ConvergenceControl(MAP_over=500, MAP_every=100, miniters=500,
                               maxiters=2000, Ninarow_nochange=3,
                               Ninarow_nobest=5)
    from bayesnmf_tpu_torch.ops import allocation as AL
    from bayesnmf_tpu_torch.ops import stream_sweeps as S

    with tempfile.TemporaryDirectory() as tmp:
        reset_counts(FS, S, AL)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = bt.fit(M, N, device="cuda", output_dir=os.path.join(tmp, "fit"),
                   convergence_control=cc, post_warmup=500, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counters(FS, S, AL)
        launches = counts["fused"]
        steps = s.iter - 1  # iteration 1 is the initial draw
        draws = check_draws("slice", counts, gibbs, s.spec, steps)
        check(ported(counts) == launches, "slice: another kernel ran")
        # the final checkpoint resumes bit-exactly (streams included)
        resumed = bt.GibbsSampler.load(
            os.path.join(s.output_dir, "sampler.ckpt"))
        ends = [gibbs.run_chunk(x.spec, x.data, x.hyperprior_params,
                                x.state, np.ones(20, np.float32), False)[0]
                for x in (s, resumed)]
        check(all(torch.equal(ends[0]["params"][k], ends[1]["params"][k])
                  for k in "PE"), "a resumed checkpoint drew other samples")
        print("slice: resumed from the final checkpoint, 20 more iterations "
              "equal the original chain's bit for bit", flush=True)

    tensors = [s.data, s.state["acc_P"], s.state["acc_E"],
               *s.state["params"].values(), *s.state["prior"].values()]
    check(all(x.is_cuda for x in tensors), "a state tensor left the card")
    rows = np.concatenate(s._metric_rows)
    check(rows.shape[0] == s.iter and np.isfinite(rows).all(),
          "metrics are not finite")
    check(launches == steps,
          f"kernel launches {launches} != iterations run {steps}")
    cos = matched_cosines(np.asarray(s.MAP["P"]), P_true)
    check(cos.min() >= 0.95, f"MAP cosine to the true P too low: {cos}")
    print(f"slice: fit(96x500, rank 8) ran {steps} iterations, converged "
          f"at {s.tracker.converged_iter} ({s.tracker.why}); kernel "
          f"launches {launches}, draw kernel {draws}; MAP matched cosine "
          f"min {cos.min():.4f} "
          f"mean {cos.mean():.4f}", flush=True)
    print(f"slice: {steps / wall:.1f} it/s for the whole fit ({wall:.2f} s, "
          "MAP checks and checkpoints included) on " + card,
          flush=True)

    # the hot loop alone, from the fit's final state
    temps = np.ones(500, np.float32)
    state = s.state
    gibbs.run_chunk(s.spec, s.data, s.hyperprior_params, state, temps[:20],
                    False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gibbs.run_chunk(s.spec, s.data, s.hyperprior_params, state, temps, False)
    torch.cuda.synchronize()
    hot = len(temps) / (time.perf_counter() - t0)
    print(f"slice: {hot:.1f} it/s in the Gibbs chunk loop alone "
          f"(500 iterations) on " + card, flush=True)
    return steps / wall


# ---------------------------------------------------------------------------
# phase 3b: the streaming kernels against their plain versions
# ---------------------------------------------------------------------------

STREAM_CASES = [(96, 20, 10000, 8, None), (96, 20, 25000, 2, None),
                (7, 3, 37, 2, None), (16, 3, 300, 2, (1.0, 0.0, 1.0))]
STREAM_TIMED = (96, 20, 10000, 8)


def stream_inputs(K, N, G, C, seed, A=None):
    """Operands of one column's calls as the sweeps hand them over: data
    shared, per-chain E, P*A and column 0's vectors (pre-scaled by A_0),
    made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    f = np.float32
    Pt = rng.dirichlet(np.ones(K) * 0.5, N).T * 50.0
    Et = rng.gamma(2.0, 2.0, (N, G))
    data = rng.poisson(Pt @ Et).astype(f)
    P = (Pt * rng.uniform(0.5, 1.5, (C, K, N))).astype(f)
    E = (Et * rng.uniform(0.5, 1.5, (C, N, G))).astype(f)
    a = np.ones(N, f) if A is None else np.asarray(A, f)
    n = 1 if A is not None else 0     # the excluded column when there is one
    an = np.full(C, a[n], f)
    return dict(
        data=data, E=E, PA=(P * a).astype(f),
        en=E[:, n].copy(), pn=P[:, :, n] * an[:, None],
        en_s=E[:, n] * an[:, None], pn_raw=P[:, :, n].copy(),
        prop_k=(P[:, :, n] * rng.uniform(0.5, 1.5, (C, K)) * an[:, None]
                ).astype(f),
        prop_g=(E[:, n] * rng.uniform(0.5, 1.5, (C, G)) * an[:, None]
                ).astype(f),
        an=an)


# name -> (function, argument names); the pre-scaling contract of
# ops/stream_sweeps.py: P-column calls take A_n*P_n, E-row calls A_n*E_n
STREAM_CALLS = {
    "pcol_stats": ("pcol_stats", ("data", "E", "PA", "en", "pn")),
    "pcol_accept": ("pcol_accept", ("data", "E", "PA", "en", "pn",
                                    "prop_k")),
    "erow_stats": ("erow_stats", ("data", "E", "PA", "en_s", "pn_raw")),
    "erow_accept": ("erow_accept", ("data", "E", "PA", "en_s", "pn_raw",
                                    "prop_g")),
    "acol_delta": ("acol_delta", ("data", "E", "PA", "en", "pn_raw", "an")),
    "chain_metrics": ("chain_metrics", ("data", "E", "PA")),
}


def stream_plain(S, name, args):
    if name in ("pcol_stats", "pcol_accept", "erow_stats", "erow_accept"):
        col = name.startswith("pcol")
        prop = args[5] if len(args) > 5 else None
        return S.run_reference(*args[:5], prop, col)
    if name == "acol_delta":
        return (S.acol_delta_reference(*args),)
    return S.chain_metrics_reference(*args)


def compare_stream_kernels(torch, S, card, cases=None, timed=STREAM_TIMED):
    """Phase 3b (phase 15 at its own ``cases``, timed at ``timed``).
    Returns {name: dict(max_abs_err, ms, plain_ms, bound_ms, bound_by)} at
    the timed shape."""
    dev = torch.device("cuda")
    res = {}
    for (K, N, G, C, A) in (STREAM_CASES if cases is None else cases):
        d = stream_inputs(K, N, G, C, seed=K + N + G + C, A=A)
        tt = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
              for k, v in d.items()}
        case = f"(K,N,G,C)={(K, N, G, C)}" + (f" A={A}" if A else "")
        for name, (fn, argn) in STREAM_CALLS.items():
            args = [tt[k] for k in argn]

            def kernel(fn=fn, args=args):
                out = getattr(S, fn)(*args)
                return out if isinstance(out, tuple) else (out,)

            k1, k2 = kernel(), kernel()
            p = stream_plain(S, name, args)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(k1, k2)),
                  f"{name}: two launches differ at {case}")
            worst_abs = 0.0
            parts = []
            for i, (a, b) in enumerate(zip(k1, p)):
                check(a.shape == b.shape, f"{name} output {i} shape "
                      f"{tuple(a.shape)} != {tuple(b.shape)} at {case}")
                diff = (a - b).abs()
                ab = float(diff.max())
                rel = float((diff / b.abs().clamp_min(1e-30)).max())
                worst_abs = max(worst_abs, ab)
                parts.append(f"out{i} abs {ab:.2e} rel {rel:.2e}")
                check(torch.allclose(a, b, rtol=S.KERNEL_RTOL,
                                     atol=S.KERNEL_ATOL),
                      f"{name} output {i} differs at {case}: max abs {ab} "
                      f"rel {rel}")
                check(bool(torch.isfinite(a).all()),
                      f"{name} output {i} not finite at {case}")
            print(f"stream kernel vs plain {name} {case}: "
                  + "; ".join(parts) + "; two launches bit-identical",
                  flush=True)
            r = res.setdefault(name, {"max_abs_err": 0.0})
            r["max_abs_err"] = max(r["max_abs_err"], worst_abs)
            if (K, N, G, C) == timed:
                r["ms"], wrapped = kernel_ms(torch, kernel, 50)
                r["plain_ms"] = time_ms(
                    torch, lambda name=name, args=args: stream_plain(
                        S, name, args), 3)
                r["bound_ms"], r["bound_by"] = stream_bound(name, K, N, G, C)
                print(f"time per call {name} at (K,N,G,C)={timed}: "
                      f"kernel {r['ms']:.4f} ms on the device "
                      f"({wrapped:.4f} ms per call through the wrapper), "
                      f"plain PyTorch "
                      f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                      f"({r['bound_by']}), on {card}", flush=True)
    return res


# (K, N, G, chains, A, option): phase 3b, the metrics row. "excluded"
# leaves chain 0 without column 1 and the last chain without any column
# (sum A = 0: the acceptance means' clamp_min(1)) and passes the
# temperature as a device tensor; "tails" puts the prior means at mu/sd in
# -1..-50 and below -50 (log_ndtr's erfcx fit and its continued fraction).
ROW_CASES = [(K, N, G, C, A, None) for (K, N, G, C, A) in STREAM_CASES] + [
    (16, 3, 300, 3, None, "excluded"), (96, 8, 2000, 2, None, "tails")]
# the row's entries that are counts or copies, held exactly: it, n_params,
# the rank sum A, the temperature
ROW_EXACT = (0, 5, 7, 8)


def row_inputs(torch, S, K, N, G, C, seed, A=None, option=None):
    """The metrics row's operands on the card, made with numpy from
    ``seed``: a state as the stream step hands it over."""
    from bayesnmf_tpu_torch.ops import math as m

    rng = np.random.default_rng(seed)
    f = np.float32
    Pt = rng.dirichlet(np.ones(K) * 0.5, N).T * 50.0
    Et = rng.gamma(2.0, 2.0, (N, G))
    a = np.ones((C, N), f) if A is None else np.tile(np.asarray(A, f),
                                                     (C, 1))
    if option == "excluded":
        a[0, 1] = 0.0
        a[-1] = 0.0
    d = {"data": rng.poisson(Pt @ Et).astype(f),
         "P": (Pt * rng.uniform(0.5, 1.5, (C, K, N))).astype(f),
         "E": (Et * rng.uniform(0.5, 1.5, (C, N, G))).astype(f), "A": a,
         "acc_P": rng.uniform(0, 1, (C, K, N)).astype(f),
         "acc_E": rng.uniform(0, 1, (C, N, G)).astype(f),
         "Sigmasq_p": rng.gamma(2.0, 0.5, (C, K, N)).astype(f),
         "Sigmasq_e": rng.gamma(2.0, 2.0, (C, N, G)).astype(f),
         "na": rng.integers(0, 4, C).astype(f)}
    for side, shape in (("p", (C, K, N)), ("e", (C, N, G))):
        if option == "tails":
            z = np.where(rng.uniform(size=shape) < 0.5,
                         -rng.uniform(0, 120, shape),
                         -rng.uniform(1, 50, shape))
            d[f"Mu_{side}"] = (z * np.sqrt(d[f"Sigmasq_{side}"])).astype(f)
        else:
            d[f"Mu_{side}"] = rng.normal(0.5, 1.0, shape).astype(f)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to("cuda")
         for k, v in d.items()}
    t.update(m.metric_constants("poisson", t["data"]))
    t["it"] = 41
    t["temp"] = (torch.tensor(0.5, device="cuda") if option == "excluded"
                 else 0.03125)
    return t


ROW_ARGS = ("data", "P", "E", "A", "acc_P", "acc_E", "Mu_p", "Sigmasq_p",
            "Mu_e", "Sigmasq_e", "lgamma_sum", "mlogm_sum", "na", "it",
            "temp")


def pr5_row(torch, S, t):
    """The metrics row as PR 5 composed it: P * A on the host, the
    sums-only chain_metrics, and the host arithmetic of PR 5's
    models/gibbs.py::stream_metrics_row, in plain tensor ops (its float32
    sums and multiplications by reciprocals included)."""
    from bayesnmf_tpu_torch.ops import math as m

    P, E, A = t["P"], t["E"], t["A"]
    K, G = t["data"].shape
    m_loglam, lam_sum, mp_loglam, sq_err = S.chain_metrics(
        t["data"], E, P * A.unsqueeze(1))
    loglik = m_loglam - lam_sum - t["lgamma_sum"]
    prior = {k: t[k] for k in ("Mu_p", "Sigmasq_p", "Mu_e", "Sigmasq_e")}
    logpost = loglik + m.logprior_PE(P, E, "truncnormal", prior)
    sum_a = A.sum(-1)
    n_par = m.n_params_of(A, K, G)
    acc_p = ((t["acc_P"] * A.unsqueeze(1)).sum((1, 2))
             / (sum_a * K).clamp_min(1.0))
    acc_e = ((t["acc_E"] * A.unsqueeze(2)).sum((1, 2))
             / (sum_a * G).clamp_min(1.0))
    full = lambda v: torch.full_like(sum_a, float(v))  # noqa: E731
    return torch.stack([
        full(t["it"]), torch.sqrt(sq_err / (K * G)),
        t["mlogm_sum"] - mp_loglam, loglik, logpost, n_par,
        m.bic(loglik, n_par, G), sum_a, full(t["temp"]), acc_p, acc_e,
        t["na"]], dim=-1)


def compare_metrics_rows(torch, S, card, prior="truncnormal", cases=None,
                         timed=STREAM_TIMED):
    """Phase 3b, the metrics row: the row kernels against their plain
    version at every ROW_CASES case; it, n_params, sum A and the
    temperature exact, every other entry within the sums' tolerance, two
    launches bit-identical; timed at (96,20,10000,8) beside PR 5's
    composition. With ``prior="exponential"`` (phase 9) the same kernels
    with the Lambdas (the Sigmasq planes of row_inputs) in the places of
    Mu and no PR 5 composition. Returns dict(max_abs_err, ms, plain_ms,
    bound_ms, bound_by, pr5_ms)."""
    res = {"max_abs_err": 0.0}
    expo = prior == "exponential"
    for (K, N, G, C, A, opt) in (ROW_CASES if cases is None else cases):
        t = row_inputs(torch, S, K, N, G, C, seed=K + N + G + C, A=A,
                       option=opt)
        if expo:
            t["Mu_p"], t["Mu_e"] = t["Sigmasq_p"], t["Sigmasq_e"]
            t["Sigmasq_p"] = t["Sigmasq_e"] = None
        args = [t[k] for k in ROW_ARGS]
        case = (f"(K,N,G,C)={(K, N, G, C)}" + (f" A={A}" if A else "")
                + (f" {opt}" if opt else "") + (f" {prior}" if expo else ""))

        def kernel(args=args):
            return S.stream_metrics_row(*args, prior=prior)

        k1, k2 = kernel(), kernel()
        p = S.stream_metrics_row_reference(*args, expo)
        torch.cuda.synchronize()
        check(torch.equal(k1, k2), f"metrics row: two launches differ at "
              f"{case}")
        check(bool(torch.isfinite(k1).all()),
              f"metrics row not finite at {case}")
        exact = list(ROW_EXACT)
        check(torch.equal(k1[:, exact], p[:, exact]),
              f"metrics row: it, n_params, sum A or the temperature differ "
              f"at {case}: {k1[:, exact].tolist()} {p[:, exact].tolist()}")
        diff = (k1 - p).abs()
        ab = float(diff.max())
        rel = float((diff / p.abs().clamp_min(1e-30)).max())
        check(torch.allclose(k1, p, rtol=S.KERNEL_RTOL, atol=S.KERNEL_ATOL),
              f"metrics row differs at {case}: max abs {ab} rel {rel}")
        res["max_abs_err"] = max(res["max_abs_err"], ab)
        print(f"metrics row vs plain {case}: max abs {ab:.2e} rel "
              f"{rel:.2e}; it, n_params, sum A, temperature equal; two "
              "launches bit-identical", flush=True)
        if (K, N, G, C) == timed and A is None and opt is None:
            res["ms"], wrapped = kernel_ms(torch, kernel, 50)
            res["plain_ms"] = time_ms(
                torch, lambda: S.stream_metrics_row_reference(*args, expo),
                3)
            res["bound_ms"], res["bound_by"] = metrics_row_bound(K, N, G, C,
                                                                 expo)
            pr5 = ""
            if not expo and timed == STREAM_TIMED:
                res["pr5_ms"], pr5_wrapped = kernel_ms(
                    torch, lambda: pr5_row(torch, S, t), 50)
                pr5 = (f", PR 5's composition (P * A, chain_metrics, the "
                       f"host row) {res['pr5_ms']:.4f} ms on the device "
                       f"({pr5_wrapped:.4f} ms per call)")
            print(f"time per call metrics row ({prior}) at (K,N,G,C)="
                  f"{timed}: kernels {res['ms']:.4f} ms on the device "
                  f"({wrapped:.4f} ms per call through the wrapper){pr5}, "
                  f"plain PyTorch {res['plain_ms']:.4f} ms, bound "
                  f"{res['bound_ms']:.4f} ms ({res['bound_by']}), on {card}",
                  flush=True)
    return res


# (K, N, G, chains, A, options): phase 3b, the column updates. "inactive"
# zeroes one E row and one P column of the last chain (a prior-draw
# proposal that always accepts); "tails" scales rows and columns of the
# data towards 0 so that the conditionals sit deep in the truncated tail.
UPDATE_CASES = [(96, 20, 10000, 8, None, ()), (96, 20, 25000, 2, None, ()),
                (7, 3, 37, 2, None, ()),
                (16, 3, 300, 2, (1.0, 0.0, 1.0), ("inactive",)),
                (96, 8, 2000, 2, None, ("tails",))]


def update_inputs(K, N, G, C, seed, A=None, opts=()):
    """A sweep's operands as stream_sweep_P/E hand them over, made with
    numpy from ``seed``: the state, the prior pairs, the prior draws, the
    uniforms and mixed warmup flags."""
    rng = np.random.default_rng(seed)
    f = np.float32
    Pt = rng.dirichlet(np.ones(K) * 0.5, N).T * 50.0
    Et = rng.gamma(2.0, 2.0, (N, G))
    data = rng.poisson(Pt @ Et).astype(f)
    if "tails" in opts:
        data *= rng.choice([0.0, 0.3, 0.6, 1.0], (K, 1)).astype(f)
        data *= rng.choice([0.0, 0.3, 0.6, 1.0], (1, G)).astype(f)
    P = (Pt * rng.uniform(0.5, 1.5, (C, K, N))).astype(f)
    E = (Et * rng.uniform(0.5, 1.5, (C, N, G))).astype(f)
    if "inactive" in opts:
        E[-1, N - 1] = 0.0
        P[-1, :, 0] = 0.0
    a = np.ones(N, f) if A is None else np.asarray(A, f)
    u = lambda *sh: rng.uniform(1e-6, 1.0, sh).astype(f)  # noqa: E731
    d = dict(
        data=data, P=P, E=E, A=np.tile(a, (C, 1)),
        acc_P=np.full((C, K, N), 0.5, f), acc_E=np.full((C, N, G), 0.5, f),
        Mu_p=rng.normal(0.0, 1.0, (C, K, N)).astype(f),
        Sq_p=rng.gamma(2.0, 2.0, (C, K, N)).astype(f),
        Mu_e=rng.normal(0.0, 1.0, (C, N, G)).astype(f),
        Sq_e=rng.gamma(2.0, 2.0, (C, N, G)).astype(f),
        P_prior=rng.gamma(2.0, 1.0, (C, K, N)).astype(f),
        E_prior=rng.gamma(2.0, 1.0, (C, N, G)).astype(f),
        U_p=u(C, 3, N, K), U_e=u(C, 3, N, G),
        accept_all=(np.arange(C) % 2 == 1))
    # the exponential prior's Lambdas (phase 9)
    d["Lam_p"] = rng.gamma(2.0, 0.5, (C, K, N)).astype(f)
    d["Lam_e"] = rng.gamma(2.0, 0.5, (C, N, G)).astype(f)
    return d


def tail_counts(torch, S, t, col, n, expo=False):
    """How many entries of column n's conditional have their truncation
    point alpha = -mu / sd in (5.4, 8] and beyond 8."""
    A_n = t["A"][:, n:n + 1]
    PA = t["P"] * t["A"].unsqueeze(1)
    P_n, E_n = t["P"][:, :, n].contiguous(), t["E"][:, n, :].contiguous()
    if col:
        mu1, den = S.run_reference(t["data"], t["E"], PA, E_n, A_n * P_n,
                                   None, True)
        Mu, Sq = ((t["Lam_p"][:, :, n], None) if expo
                  else (t["Mu_p"][:, :, n], t["Sq_p"][:, :, n]))
    else:
        mu1, den = S.run_reference(t["data"], t["E"], PA, A_n * E_n, P_n,
                                   None, False)
        Mu, Sq = ((t["Lam_e"][:, n, :], None) if expo
                  else (t["Mu_e"][:, n, :], t["Sq_e"][:, n, :]))
    mu, var = S._conditional(mu1, A_n * den, Mu, Sq, expo)
    alpha = -mu / torch.sqrt(var)
    return (int(((alpha > 5.4) & (alpha <= 8.0)).sum()),
            int((alpha > 8.0).sum()))


def compare_stream_updates(torch, S, card, prior="truncnormal",
                           cases=None, timed=STREAM_TIMED):
    """Phase 3b, the column updates: ``stream_pcol_update`` and
    ``stream_erow_update`` against the host sequence on the card, column by
    column from the same state; with ``prior="exponential"`` (phase 9) the
    same kernels with the Lambdas in the place of the prior pair. Returns
    {name: dict(max_abs_err, ms, plain_ms, bound_ms, bound_by)} at the timed
    shape."""
    res = {}
    expo = prior == "exponential"
    for (K, N, G, C, A, opts) in (UPDATE_CASES if cases is None else cases):
        t = to_card(torch, update_inputs(K, N, G, C, K + N + G + C, A, opts))
        if expo:
            t["Sq_p"] = t["Sq_e"] = None
            t["Mu_p"], t["Mu_e"] = t["Lam_p"], t["Lam_e"]
        case = f"(K,N,G,C)={(K, N, G, C)}" + (f" A={A}" if A else "") + (
            " " + " ".join(opts) if opts else "") + (f" {prior}" if expo
                                                    else "")
        sides = {
            "pcol_update": (True, S.stream_pcol_update,
                            S.pcol_update_reference, "P", "acc_P", "Mu_p",
                            "Sq_p", "P_prior", "U_p"),
            "erow_update": (False, S.stream_erow_update,
                            S.erow_update_reference, "E", "acc_E", "Mu_e",
                            "Sq_e", "E_prior", "U_e")}
        for name, (col, kernel, plain, xk, acck, muk, sqk, prk, uk) in \
                sides.items():
            state = {"P": t["P"].clone(), "E": t["E"].clone()}
            acc0 = t[acck].clone()

            def operands(st, acc, nan):
                return (t["data"], st["E"], st["P"], t["A"], acc, t[muk],
                        t[sqk], t[prk], t[uk], t["accept_all"], nan)

            def fresh():
                return ({"P": state["P"].clone(), "E": state["E"].clone()},
                        acc.clone(),
                        torch.zeros(C, dtype=torch.float32, device="cuda"))

            acc = acc0
            worst, flips, n_equal = 0.0, 0, 0
            tails = [0, 0]
            nan_k = nan_p = 0.0
            for n in range(N):
                if "tails" in opts:
                    tc = tail_counts(torch, S, {**t, **state}, col, n, expo)
                    tails = [tails[0] + tc[0], tails[1] + tc[1]]
                sk, ak, nk = fresh()
                kernel(*operands(sk, ak, nk), n, n + 1, prior=prior)
                s2, a2, n2 = fresh()
                kernel(*operands(s2, a2, n2), n, n + 1, prior=prior)
                sp, ap, npn = fresh()
                plain(*operands(sp, ap, npn), n, expo)
                torch.cuda.synchronize()
                check(torch.equal(sk[xk], s2[xk]) and torch.equal(ak, a2)
                      and torch.equal(nk, n2),
                      f"{name}: two launches differ at {case} column {n}")
                check(bool(torch.isfinite(sk[xk]).all()),
                      f"{name}: not finite at {case} column {n}")
                flips += int(((sk[xk] != state[xk])
                              != (sp[xk] != state[xk])).sum())
                for what, a_, b_, rtol in (
                        ("values", sk[xk], sp[xk], S.UPDATE_RTOL),
                        ("recorded acceptance", ak, ap, S.RATIO_RTOL)):
                    worst = max(worst, float((a_ - b_).abs().max()))
                    check(torch.allclose(a_, b_, rtol=rtol,
                                         atol=S.UPDATE_ATOL),
                          f"{name} {what} differ at {case} column {n}: max "
                          f"abs {float((a_ - b_).abs().max())}")
                check(torch.equal(nk, npn),
                      f"{name}: NaN counts differ at {case} column {n}")
                n_equal += int(torch.equal(sk[xk], sp[xk])
                               and torch.equal(ak, ap))
                nan_k += float(nk.sum())
                nan_p += float(npn.sum())
                state, acc = sk, ak
            check(flips == 0, f"{name}: {flips} decisions differ at {case}")
            # the whole sweep in one call gives the chained columns' bits
            state0 = {"P": t["P"].clone(), "E": t["E"].clone()}
            acc_all = acc0.clone()
            nan_all = torch.zeros(C, dtype=torch.float32, device="cuda")
            kernel(*operands(state0, acc_all, nan_all), prior=prior)
            torch.cuda.synchronize()
            check(torch.equal(state0[xk], state[xk])
                  and torch.equal(acc_all, acc),
                  f"{name}: one call for the sweep differs from its columns "
                  f"one by one at {case}")
            print(f"stream {name} vs host sequence {case}: {N} columns, max "
                  f"abs diff {worst:.3e}, 0 decisions differ, "
                  f"{n_equal}/{N} columns bit-identical, NaN counts equal "
                  f"({nan_k:.0f}); two launches bit-identical; one call for "
                  "the sweep equals the columns one by one"
                  + (f"; conditionals with 5.4 < alpha <= 8: {tails[0]}, "
                     f"alpha > 8: {tails[1]}" if "tails" in opts else ""),
                  flush=True)
            if "tails" in opts:
                check(tails[0] > 0 and tails[1] > 0,
                      f"{name}: the deep-tail case has no deep tail: {tails}")
            r = res.setdefault(name, {"max_abs_err": 0.0})
            r["max_abs_err"] = max(r["max_abs_err"], worst)
            if (K, N, G, C) == timed:
                def sweep():
                    st, ac, nn = fresh()
                    kernel(*operands(st, ac, nn), prior=prior)

                def clones():
                    fresh()

                def plain_col():
                    st, ac, nn = fresh()
                    plain(*operands(st, ac, nn), 0, expo)

                r["ms"] = (time_ms(torch, sweep, 20)
                           - time_ms(torch, clones, 20)) / N
                r["plain_ms"] = time_ms(torch, plain_col, 3)
                r["bound_ms"], r["bound_by"] = update_bound(col, K, N, G, C)
                print(f"time per column {name} ({prior}) at (K,N,G,C)="
                      f"{timed}: "
                      f"kernel {r['ms']:.4f} ms (a sweep of {N} launches "
                      f"over {N}), host sequence {r['plain_ms']:.4f} ms, "
                      f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), on "
                      f"{card}", flush=True)
    return res


# (K, N, G, chains, A, options): phase 3b, the A-column update: the column
# updates' cases, and "nan": one chain's P holds an inf, so that every delta
# of that chain is NaN and its draws take the 1/2 fallback
ACOL_CASES = UPDATE_CASES + [(16, 3, 300, 2, None, ("nan",))]


def acol_inputs(K, N, G, C, seed, A=None, opts=()):
    """update_inputs with a mixed starting A (the case's A where it names
    one), the expected ranks R and the draws' uniforms."""
    d = update_inputs(K, N, G, C, seed, A, opts)
    rng = np.random.default_rng(seed + 1)
    if A is None:
        d["A"] = (rng.uniform(size=(C, N)) < 0.6).astype(np.float32)
    if "nan" in opts:
        d["P"][-1, 0, 1] = np.inf
    d["R"] = rng.integers(0, N + 1, C).astype(np.int32)
    d["U_a"] = rng.uniform(1e-6, 1.0, (C, N)).astype(np.float32)
    return d


def compare_acol_updates(torch, S, U, card, cases=None, timed=STREAM_TIMED):
    """Phase 3b, the A-column update: ``stream_acol_update`` against the
    host sequence on the card, column by column from the same state, SBFI
    at a temperature of 1e-4 (a number) and BFI at 1 (a device tensor), as
    the sweeps pass it. Returns dict(max_abs_err, ms, events_ms, plain_ms,
    bound_ms, bound_by) at the timed shape."""
    from types import SimpleNamespace

    res = {"max_abs_err": 0.0}
    for (K, N, G, C, A, opts) in (ACOL_CASES if cases is None else cases):
        t = to_card(torch, acol_inputs(K, N, G, C, K + N + G + C, A, opts))
        p1 = U.prior_prob_1(t["R"].to(torch.float32), N)
        logit = torch.log(p1) - torch.log1p(-p1)
        pen = U.sbfi_penalty(SimpleNamespace(K=K, G=G))
        for method, temp, penalty in (
                ("SBFI", 1e-4, pen),
                ("BFI", torch.ones((), device="cuda"), None)):
            case = (f"(K,N,G,C)={(K, N, G, C)}" + (f" A={A}" if A else "")
                    + (" " + " ".join(opts) if opts else "") + f" {method}")

            def update(A_, nan_, n0=0, n1=None):
                return S.stream_acol_update(t["data"], t["E"], t["P"], A_,
                                            logit, temp, t["U_a"], nan_,
                                            penalty, n0, n1)

            def zeros():
                return torch.zeros(C, dtype=torch.float32, device="cuda")

            A_cur, nan_cur = t["A"].clone(), zeros()
            deltas = []
            worst, flips, n_equal, n_nan_delta = 0.0, 0, 0, 0
            for n in range(N):
                Ak, nk = A_cur.clone(), zeros()
                dk = update(Ak, nk, n, n + 1)[:, n]
                A2, n2 = A_cur.clone(), zeros()
                d2 = update(A2, n2, n, n + 1)[:, n]
                Ap, npl = A_cur.clone(), zeros()
                dp = S.acol_update_reference(t["data"], t["E"], t["P"], Ap,
                                             logit, temp, t["U_a"], npl,
                                             penalty, n)
                torch.cuda.synchronize()
                check(torch.equal(Ak, A2) and torch.equal(nk, n2)
                      and torch.equal(dk.nan_to_num(), d2.nan_to_num())
                      and torch.equal(dk.isnan(), d2.isnan()),
                      f"acol_update: two launches differ at {case} column "
                      f"{n}")
                flips += int((Ak != Ap).sum())
                check(torch.equal(nk, npl),
                      f"acol_update: NaN counts differ at {case} column {n}")
                check(torch.allclose(dk, dp, rtol=S.KERNEL_RTOL,
                                     atol=S.KERNEL_ATOL, equal_nan=True),
                      f"acol_update: delta differs at {case} column {n}: "
                      f"{dk.tolist()} against {dp.tolist()}")
                fin = dp.isfinite()
                if bool(fin.any()):
                    worst = max(worst, float((dk - dp)[fin].abs().max()))
                n_nan_delta += int(dp.isnan().sum())
                n_equal += int(torch.equal(dk.nan_to_num(), dp.nan_to_num()))
                deltas.append(dk)
                A_cur, nan_cur = Ak, nan_cur + nk
            check(flips == 0,
                  f"acol_update: {flips} decisions differ at {case}")
            if "nan" in opts:
                check(n_nan_delta > 0 and float(nan_cur.sum()) > 0,
                      f"acol_update: the NaN case has no NaN at {case}")
            # the whole sweep in one call gives the chained columns' bits
            A_all, nan_all = t["A"].clone(), zeros()
            d_all = update(A_all, nan_all)
            torch.cuda.synchronize()
            d_cols = torch.stack(deltas, 1)
            check(torch.equal(A_all, A_cur) and torch.equal(nan_all, nan_cur)
                  and torch.equal(d_all.nan_to_num(), d_cols.nan_to_num()),
                  f"acol_update: one call for the sweep differs from its "
                  f"columns one by one at {case}")
            print(f"stream acol_update vs host sequence {case}: {N} columns, "
                  f"0 decisions differ ({int((A_cur != t['A']).sum())} "
                  f"inclusions changed), NaN counts equal "
                  f"({float(nan_cur.sum()):.0f}), delta max abs diff "
                  f"{worst:.3e}, {n_equal}/{N} deltas bit-identical; two "
                  "launches bit-identical; one call for the sweep equals "
                  "the columns one by one", flush=True)
            res["max_abs_err"] = max(res["max_abs_err"], worst)
            if (K, N, G, C) == timed and method == "SBFI":
                def sweep():
                    update(t["A"].clone(), zeros())

                def clones():
                    t["A"].clone(), zeros()

                def plain_col():
                    S.acol_update_reference(t["data"], t["E"], t["P"],
                                            t["A"].clone(), logit, temp,
                                            t["U_a"], zeros(), penalty, 0)

                res["events_ms"] = (time_ms(torch, sweep, 20)
                                    - time_ms(torch, clones, 20)) / N
                dev = [device_ms(torch, f, 10) for f in (sweep, clones)]
                # CUDA events where the profiler read nothing
                res["ms"] = (res["events_ms"] if None in dev
                             else (dev[0] - dev[1]) / N)
                res["plain_ms"] = time_ms(torch, plain_col, 3)
                res["bound_ms"], res["bound_by"] = acol_update_bound(K, N, G,
                                                                     C)
                print(f"time per column acol_update at (K,N,G,C)="
                      f"{timed}: kernels {res['ms']:.4f} ms on the "
                      f"device, {res['events_ms']:.4f} ms by CUDA events (a "
                      f"sweep of {N} columns enqueued by one call, over {N}),"
                      f" host sequence {res['plain_ms']:.4f} ms, bound "
                      f"{res['bound_ms']:.4f} ms ({res['bound_by']}), on "
                      f"{card}", flush=True)
    return res


def compare_special(torch, S):
    """The kernels' ndtri, log_ndtr, ndtr and sigmoid against the PyTorch
    calls of the host sequences and the metrics row, on 4M arguments each
    that cover every branch. Returns (arguments at which ndtri, ndtr or
    sigmoid differ, which a proposal's or an inclusion's bits depend on;
    arguments at which log_ndtr differs, which the Hastings ratio and the
    row's prior term depend on)."""
    from bayesnmf_tpu_torch.ops import distributions as dist

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    n = 1 << 21
    u = torch.rand(n, generator=gen, device="cuda")
    tiny = torch.exp(-torch.rand(n, generator=gen, device="cuda") * 87.0)
    x = torch.cat([torch.randn(n, generator=gen, device="cuda") * 4.0,
                   -torch.rand(n, generator=gen, device="cuda") * 120.0])
    # the sigmoid's log-odds: both signs out past where it saturates, and
    # the non-finite ones
    lo = torch.cat([torch.randn(n, generator=gen, device="cuda") * 8.0,
                    (torch.rand(n, generator=gen, device="cuda") * 2.0 - 1.0)
                    * 120.0])
    lo[:3] = torch.tensor([float("nan"), float("inf"), -float("inf")])
    bad_by = {}
    for which, arg, ref in (("ndtri", torch.cat([u, tiny]),
                             torch.special.ndtri),
                            ("log_ndtr", x, torch.special.log_ndtr),
                            ("ndtr", x, dist._ndtr),
                            ("sigmoid", lo, torch.sigmoid)):
        got, want = S.special_functions(arg.contiguous(), which), ref(arg)
        torch.cuda.synchronize()
        bad = int(((got != want) & ~(got.isnan() & want.isnan())).sum())
        ulps = (got.view(torch.int32) - want.view(torch.int32)).abs()
        print(f"special function {which}: {bad} of {arg.numel()} arguments "
              f"differ from the PyTorch call (max {int(ulps.max())} ulp)",
              flush=True)
        bad_by[which] = bad
    return (max(bad_by["ndtri"], bad_by["ndtr"], bad_by["sigmoid"]),
            bad_by["log_ndtr"])


# (K, N, G, chains): phase 3b, the exact hyper-update at the two stream
# cells' shapes and one chain at a fit's
HYPER_CASES = [(96, 20, 10000, 8), (1536, 20, 2780, 8), (96, 8, 500, 1)]
# the entries of chain 0 on each side whose g_new hyper_inputs drives
# below 1e-30
HYPER_REJECTED = slice(6, 8)


def hyper_inputs(torch, S, K, N, G, C, seed):
    """The hyper-update's operands on the card: P and E at a fit's scale,
    prior pairs about the hyperpriors of a catalogue of mean 50
    (config.default_hyperprior_params), normals and uniforms in
    draw_stream_noise's layout (u a slice of a wider draw), and in chain
    0's first 10 entries of each side the update's edges: Mu deep in
    log_ndtr's tail (Mu / sd from -4 to -40), Sigmasq at and below the
    1e-30 floor, normals that drive g_new below 1e-30 (HYPER_REJECTED: the
    Sigmasq move is rejected there) and uniforms at 1.2e-38. Returns the
    wrapper's arguments."""
    from types import SimpleNamespace

    from bayesnmf_tpu_torch.config import default_hyperprior_params

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    f = dict(generator=gen, device="cuda")
    hp = default_hyperprior_params(SimpleNamespace(prior="truncnormal", N=N),
                                   50.0)
    P = torch.rand(C, K, N, **f) * (2.0 / K)
    E = torch.rand(C, N, G, **f) * 200.0
    pairs = []
    for side, shape in (("p", (C, K, N)), ("e", (C, N, G))):
        mu = torch.randn(shape, **f) * hp[f"s_{side}"] + hp[f"m_{side}"]
        sq = hp[f"b_{side}"] / (hp[f"a_{side}"]
                                * (0.25 + torch.rand(shape, **f)))
        pairs += [mu, sq]
    n_p, n_e = K * N, N * G
    n_t = n_p + n_e
    z = torch.randn(C, 2 * n_t, **f)
    u = torch.rand(C, 2 * n_t + 41, **f).clamp_min_(1.2e-38)[:, :2 * n_t]
    for (mu, sq), off in (((pairs[0], pairs[1]), 0),
                          ((pairs[2], pairs[3]), n_p)):
        mu_f, sq_f = mu.view(C, -1), sq.view(C, -1)
        mu_f[0, 0:4] = (torch.tensor([-4.0, -10.0, -25.0, -40.0],
                                     device="cuda") * sq_f[0, 0:4].sqrt())
        sq_f[0, 4:6] = torch.tensor([1e-30, 1e-33], device="cuda")
        z[0, n_t + off:][HYPER_REJECTED] = torch.tensor([-40.0, -1e3],
                                                        device="cuda")
        u[0, off + 8] = u[0, n_t + off + 9] = 1.2e-38
    return [P, E, *pairs, z, u, [hp[k] for k in S.HYPERS]]


def events_ms(torch, fn, reps):
    """ms per call of ``fn`` by CUDA events around ``reps`` calls enqueued
    behind a 100 ms spin of the card, so that the events time the card's
    work and not the host's pace of launching."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_hyper_update(torch, S, card):
    """Phase 3b, the exact hyper-update: ``hyper_update`` (one launch)
    against its plain version (the PyTorch ops of
    ``hyper_update_reference``) on the same CUDA tensors at HYPER_CASES,
    with the edges of ``hyper_inputs``: Mu and Sigmasq equal bit for bit
    (any entry that differs is printed with its count), two launches
    bit-identical, the edges' Sigmasq moves rejected; each case timed by
    CUDA events and on the device beside its bound (``hyper_bound``, and
    the benchmark's ``workcount.hyper``) and the plain version. Returns
    dict(max_abs_err, ms, events_ms, plain_ms, bound_ms, bound_by) at the
    first case."""
    from benchmark import workcount

    names = ("Mu_p", "Sigmasq_p", "Mu_e", "Sigmasq_e")
    res = {}
    for i, (K, N, G, C) in enumerate(HYPER_CASES):
        case = f"(K,N,G,C)={(K, N, G, C)}"
        args = hyper_inputs(torch, S, K, N, G, C, 7 + i)
        before = S.hyper_update.launches
        got = S.hyper_update(*args)
        again = S.hyper_update(*args)
        want = S.hyper_update_reference(*args)
        torch.cuda.synchronize()
        check(S.hyper_update.launches == before + 2,
              f"hyper_update: {S.hyper_update.launches - before} launches "
              f"for two calls at {case}")
        bad_total, moved = 0, []
        for name, k, k2, p, old in zip(names, got, again, want, args[2:6]):
            check(torch.equal(k.view(torch.int32), k2.view(torch.int32)),
                  f"hyper_update: two launches differ in {name} at {case}")
            bad = (k.view(torch.int32) != p.view(torch.int32)).flatten()
            n_bad = int(bad.sum())
            if n_bad:
                idx = bad.nonzero()[:5, 0].tolist()
                kf, pf = k.flatten(), p.flatten()
                print(f"hyper_update {name} at {case}: {n_bad} entries "
                      f"differ from the PyTorch ops, first at "
                      + ", ".join(f"{j}: {kf[j].item()!r} against "
                                  f"{pf[j].item()!r}" for j in idx),
                      flush=True)
            bad_total += n_bad
            moved.append(int((k != old).sum()))
        for sq_new, sq_old in ((got[1], args[3]), (got[3], args[5])):
            check(torch.equal(sq_new[0].flatten()[HYPER_REJECTED],
                              sq_old[0].flatten()[HYPER_REJECTED]),
                  f"hyper_update: a Sigmasq move with g_new <= 1e-30 "
                  f"accepted at {case}")
        check(bad_total == 0, f"hyper_update: {bad_total} entries differ "
              f"from the PyTorch ops at {case}")

        def kernel():
            S.hyper_update(*args)

        def plain():
            S.hyper_update_reference(*args)

        ev = events_ms(torch, kernel, 200)
        dev = device_ms(torch, kernel, 20)
        plain_ms = time_ms(torch, plain, 10)
        b_ms, b_by = hyper_bound(K, N, G, C)
        wc_ms = workcount.bound_s(*workcount.hyper(K, N, G, C)) * 1e3
        print(f"hyper_update vs the PyTorch ops {case}: 0 of "
              f"{2 * C * (K * N + N * G)} entries differ (moves accepted: "
              + ", ".join(f"{n} {m}" for n, m in zip(names, moved))
              + f"; edges: Mu/sd to -40, Sigmasq 1e-30 and 1e-33, g_new "
              f"<= 1e-30 rejected, u at 1.2e-38); two launches "
              f"bit-identical; kernel {ev:.4f} ms by CUDA events, "
              + (f"{dev:.4f}" if dev is not None else "not measured")
              + f" ms on the device, plain {plain_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), workcount.hyper {wc_ms:.4f} ms, on "
              f"{card}", flush=True)
        if i == 0:
            res = {"max_abs_err": 0.0, "ms": ev if dev is None else dev,
                   "events_ms": ev, "plain_ms": plain_ms, "bound_ms": b_ms,
                   "bound_by": b_by}
    return res


# ---------------------------------------------------------------------------
# phase 3d: the allocation kernel against its plain version
# ---------------------------------------------------------------------------

# (K, N, G, C, excluded components, zero M cells)
ALLOC_CASES = [(96, 5, 100, 1, (), ()), (96, 20, 10000, 1, (), ()),
               (96, 8, 2780, 1, (), ()), (7, 3, 37, 1, (), ()),
               (16, 5, 40, 1, (3,), ((0, 0),)), (96, 8, 500, 4, (2,), ())]
ALLOC_TIMED = [(96, 5, 100), (96, 20, 10000), (96, 8, 2780)]


def alloc_inputs(K, N, G, C, seed, excluded=(), zero_cells=(), planes=True):
    """Operands of one allocation as the conjugate step hands them over:
    M (K, G) shared, per-chain P, A, E, and with ``planes`` the uniform
    planes."""
    rng = np.random.default_rng(seed)
    f = np.float32
    lead = (C,) if C > 1 else ()
    P = rng.dirichlet(np.ones(K) * 0.5, lead + (N,)).astype(f)
    P = np.swapaxes(P, -1, -2) * 50.0
    E = rng.gamma(2.0, 2.0, lead + (N, G)).astype(f)
    A = np.ones(lead + (N,), f)
    A[..., list(excluded)] = 0.0
    Mh = np.einsum("...kn,...n,...ng->...kg", P, A, E)
    M = rng.poisson(Mh if C == 1 else Mh[0]).astype(f)
    for k, g in zero_cells:
        M[k, g] = 0.0
    d = dict(M=M, P=P.astype(f), A=A, E=E)
    if planes:
        n2 = n_leaves(N)
        d["u"] = rng.uniform(1e-7, 1.0, lead + (17, max(n2 - 1, 1), K, G)
                             ).astype(f)
    return d


DIVERGENCE_SHAPE = (96, 20, 10000)


def alloc_divergence(torch, AL, card, warp_splits):
    """What a warp whose lanes take both regimes of a split costs. Every
    weight equal (q = 1/2 at a full node), half the cells a count of 6
    (every split by inversion) and half 4000 (every split by BTRS), Philox
    mode: in one layout a warp's 32 cells (a row of a 32-column tile) share
    their count, in the other the counts alternate along the lanes, so every
    warp-split takes both regimes; the same cells and work, arranged
    differently. Prints the device ms of each layout and of each count
    alone, and scales the cost of a mixed warp-split to the
    ``warp_splits`` = (warp-splits, mixed ones) of the timed data."""
    K, N, G = DIVERGENCE_SHAPE
    f32 = dict(dtype=torch.float32, device="cuda")
    P, A, E = (torch.ones(K, N, **f32), torch.ones(N, **f32),
               torch.ones(N, G, **f32))
    key = (K * G + N, 0)
    uids = torch.zeros(1, dtype=torch.int64, device="cuda")
    small, large = 6.0, 4000.0
    row = torch.arange(K, device="cuda").view(K, 1) % 2 == 0
    col = torch.arange(G, device="cuda").view(1, G) % 2 == 0
    layouts = {f"every count {small:g}": torch.full((K, G), small, **f32),
               f"every count {large:g}": torch.full((K, G), large, **f32),
               "counts alike along a warp": torch.where(
                   row, small, large).expand(K, G).contiguous(),
               "counts alternating along a warp": torch.where(
                   col, small, large).expand(K, G).contiguous()}
    ms = {}
    for label, M in layouts.items():
        ms[label] = device_ms(
            torch, lambda M=M: AL.allocate_counts(M, P, A, E, key=key,
                                                  uids=uids), 20)
    alike, mixed = ms["counts alike along a warp"], ms[
        "counts alternating along a warp"]
    n_warp_splits = K * -(-G // 32) * (N - 1)
    per_split = (mixed - alike) / n_warp_splits
    print(f"allocation divergence at (K,N,G)={DIVERGENCE_SHAPE} (Philox, "
          "equal weights): " + "; ".join(
              f"{k} {v:.4f} ms" for k, v in ms.items())
          + f"; a warp-split taking both regimes costs {per_split * 1e6:.4f}"
          f" ns more ({n_warp_splits} in the alternating layout); the timed "
          f"data's {warp_splits[1]} of {warp_splits[0]} mixed warp-splits "
          f"so cost ~{per_split * warp_splits[1]:.4f} ms, the most a split "
          f"of the regimes could save; on {card}", flush=True)


def count_splits(AL, torch, plain):
    """Run the plain version once with its binomial wrapped, counting the
    work this run's draws need: (inversion splits, their steps, BTRS
    splits), then (warp-splits, those whose lanes take both regimes), a
    warp-split being one node of the 32 cells of a kernel warp (a row k of
    a 32-column tile) with a draw in at least one lane. The CDF only rises
    and the pmf is 0 past n, so an inversion that drew x is settled after
    min(x + 1, n + 1, 40) steps."""
    counts = [0, 0, 0, 0, 0]
    binomial = AL._binomial

    def by_warp(mask):
        mask = torch.nn.functional.pad(mask, (0, -mask.shape[-1] % 32))
        return mask.view(*mask.shape[:-1], -1, 32).any(-1)

    def counted(n, p, planes):
        y = binomial(n, p, planes)
        live = n > 0
        small = n * torch.minimum(p, 1.0 - p) <= 10.0
        x = torch.where(p > 0.5, n - y, y)
        steps = torch.minimum(x + 1.0, n + 1.0).clamp(max=40.0)
        inv = live & small
        counts[0] += int(inv.sum())
        counts[1] += int(torch.where(inv, steps, 0.0).sum(
            dtype=torch.float64))
        counts[2] += int((live & ~small).sum())
        counts[3] += int(by_warp(live).sum())
        counts[4] += int((by_warp(inv) & by_warp(live & ~small)).sum())
        return y

    AL._binomial = counted
    try:
        plain()
    finally:
        AL._binomial = binomial
    return counts


def compare_allocation(torch, AL, card):
    """Phase 3d. Returns dict(max_abs_err, ms, plain_ms, bound_ms,
    bound_by) of the Philox mode at (96, 5, 100), printing every case."""
    res = {"max_abs_err": 0.0}
    for (K, N, G, C, excl, zeros) in ALLOC_CASES:
        t = to_card(torch, alloc_inputs(K, N, G, C, K + N + G + C, excl,
                                        zeros))
        case = f"(K,N,G,C)={(K, N, G, C)}" + (
            f" excluded={excl}" if excl else "") + (
            f" zero cells={zeros}" if zeros else "")
        args = (t["M"], t["P"], t["A"], t["E"])
        key = (K * G + N + C, 0)
        uids = torch.arange(C, dtype=torch.int64, device="cuda")
        b = (lambda x: x) if C > 1 else (lambda x: x.unsqueeze(0))
        unb = (lambda out: out) if C > 1 else (
            lambda out: tuple(x[0] for x in out))
        modes = {
            "planes": (lambda: AL.allocate_counts(*args, u=t["u"]),
                       lambda: unb(AL.allocate_counts_reference(
                           args[0], *map(b, args[1:]), b(t["u"])))),
            "Philox": (lambda: AL.allocate_counts(*args, key=key, uids=uids),
                       lambda: unb(AL.allocate_counts_reference(
                           args[0], *map(b, args[1:]),
                           AL.philox_planes(key, uids, N, K, G))))}
        for mode, (kernel, plain) in modes.items():
            k1, k2 = kernel(), kernel()
            p = plain()
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(k1, k2)),
                  f"allocation ({mode}): two launches differ at {case}")
            errs = []
            for name, x, y in zip(("Zsum_g", "Zsum_k"), k1, p):
                errs.append(float((x - y).abs().max()))
                check(torch.equal(x, y), f"allocation ({mode}) {name} "
                      f"differs from the plain version at {case}: max abs "
                      f"{errs[-1]}")
            res["max_abs_err"] = max(res["max_abs_err"], *errs)
            zk = k1[1]
            check(torch.equal(zk.sum(-2),
                              t["M"].sum(0).expand_as(zk.sum(-2))),
                  f"allocation ({mode}) does not conserve the counts at "
                  f"{case}")
            print(f"allocation kernel vs plain ({mode}) {case}: Zsum_g and "
                  f"Zsum_k equal (max abs {max(errs)}); two launches "
                  "bit-identical", flush=True)

        if (K, N, G) in ALLOC_TIMED:
            (k_prng, p_prng), (k_planes, p_planes) = (modes["Philox"],
                                                      modes["planes"])
            ms_prng, w_prng = kernel_ms(torch, k_prng, 20)
            ms_planes, w_planes = kernel_ms(torch, k_planes, 20)
            p_ms = time_ms(torch, p_prng, 2)
            s_prng = count_splits(AL, torch, p_prng)
            s_planes = count_splits(AL, torch, p_planes)
            b_ms, b_by = alloc_bound(K, N, G, C, s_prng, False)
            bp_ms, bp_by = alloc_bound(K, N, G, C, s_planes, True)
            print(f"time per call allocate_counts at (K,N,G)={(K, N, G)}: "
                  f"kernels {ms_prng:.4f} ms on the device (Philox; "
                  f"{w_prng:.4f} ms per call through the wrapper), "
                  f"{ms_planes:.4f} ms (planes; {w_planes:.4f} ms), plain "
                  f"PyTorch {p_ms:.4f} ms (Philox planes); "
                  f"bound {b_ms:.6f} ms ({b_by}) for {s_prng[0]} inversion "
                  f"splits of {s_prng[1]} steps and {s_prng[2]} BTRS "
                  f"splits, both regimes in {s_prng[4]} of {s_prng[3]} "
                  f"warp-splits; planes mode bound {bp_ms:.6f} ms ({bp_by}) for "
                  f"{s_planes[0]} inversions of {s_planes[1]} steps and "
                  f"{s_planes[2]} BTRS; on {card}", flush=True)
            if (K, N, G) == ALLOC_TIMED[0]:
                res |= dict(ms=ms_prng, plain_ms=p_ms, bound_ms=b_ms,
                            bound_by=b_by)
            if (K, N, G) == DIVERGENCE_SHAPE:
                alloc_divergence(torch, AL, card, s_prng[3:])

    # Philox mode: conservation, exclusion, integers, the multinomial mean,
    # seeds
    d = alloc_inputs(16, 5, 40, 1, 0, (3,), ((0, 0),))
    d["M"] = np.random.default_rng(1).poisson(30.0, (16, 40)).astype(
        np.float32)
    d["M"][0, 0] = 0.0
    t = to_card(torch, d)
    args = (t["M"], t["P"], t["A"], t["E"])
    uids = torch.zeros(1, dtype=torch.int64, device="cuda")
    S = 200
    zks = []
    for it in range(S):
        zg, zk = AL.allocate_counts(*args, uids=uids, key=ChainStreams(
            0, [0], it).subkey("alloc"))
        check(torch.equal(zk.sum(0), t["M"].sum(0))
              and torch.equal(zg.sum(1), t["M"].sum(1)),
              "allocation (Philox) does not conserve the counts")
        check(float(zg[:, 3].abs().sum()) == 0.0
              and float(zk[3].abs().sum()) == 0.0,
              "allocation (Philox) gave counts to an excluded component")
        check(torch.equal(zk, zk.round()) and torch.equal(zg, zg.round()),
              "allocation (Philox) counts are not integers")
        zks.append(zk.cpu().numpy())
    zks = np.stack(zks)
    M, P, A, E = d["M"], d["P"], d["A"], d["E"]
    W = P[:, :, None] * A[None, :, None] * E[None, :, :]
    probs = W / np.maximum(W.sum(1, keepdims=True), 1e-30)
    expect = (M[:, None, :] * probs).sum(0)
    sd = np.sqrt(np.maximum((M[:, None, :] * probs * (1 - probs)).sum(0),
                            1e-9) / S)
    dev_sd = float((np.abs(zks.mean(0) - expect) / sd).max())
    check(dev_sd < 6.0, f"allocation (Philox) mean {dev_sd:.2f} of a cell's "
          "SD off the multinomial mean")
    a1, a2, b1 = (AL.allocate_counts(*args, key=(k, 0), uids=uids)[1]
                  for k in (12345, 12345, 12346))
    check(torch.equal(a1, a2), "allocation (Philox): one seed, other bits")
    check(not torch.equal(a1, b1), "allocation (Philox): two seeds, one draw")
    print(f"allocation kernel (Philox) at (16,5,40) with A_3 = 0 and a zero "
          f"cell: {S} draws conserve the counts, give the excluded component "
          f"0 and integers; mean within {dev_sd:.2f} of each cell's SD of the "
          "multinomial mean; one key gives the same bits, another key other "
          "bits",
          flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 5: the ensemble slice
# ---------------------------------------------------------------------------

ENS_K, ENS_G, ENS_TRUE_RANK, ENS_MAX_RANK, ENS_CHAINS = 96, 10000, 8, 20, 8
ENS_CC = dict(MAP_over=200, MAP_every=100, miniters=500, maxiters=800,
              Ninarow_nochange=3, Ninarow_nobest=5)
ENS_POST_WARMUP = 200


def run_ensemble(torch, bt, S, card):
    from bayesnmf_tpu_torch.models import gibbs
    from bayesnmf_tpu_torch.ops import allocation as AL
    from bayesnmf_tpu_torch.ops import fused_sweeps as FS
    from bayesnmf_tpu_torch.parallel import chains as CH

    rng = np.random.default_rng(0)
    P_true = rng.dirichlet(np.ones(ENS_K) * 0.3, ENS_TRUE_RANK).T
    E_true = rng.gamma(2.0, 500.0, (ENS_TRUE_RANK, ENS_G))
    M = rng.poisson(P_true @ E_true).astype(np.float32)
    cc = bt.ConvergenceControl(**ENS_CC)
    N = ENS_MAX_RANK
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts(FS, S, AL)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ens = bt.ChainEnsemble(
            M, range(1, N + 1), n_chains=ENS_CHAINS, rank_method="SBFI",
            convergence_control=cc, post_warmup=ENS_POST_WARMUP, seed=0,
            stream_sweeps=True, store_E=False, periodic_save=False,
            output_dir=os.path.join(tmp, "ens"), device="cuda")
        ens.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"_run": S._run.launches,
                    "stream_acol_update": S.stream_acol_update.launches,
                    "acol_delta": S.acol_delta.launches,
                    "stream_metrics_row": S.stream_metrics_row.launches,
                    "hyper_update": S.hyper_update.launches,
                    "chain_metrics": S.chain_metrics.launches}
        steps = ens.iter - 1  # iteration 1 is the initial draw
        counts = launch_counters(FS, S, AL)
        launches["rng"] = check_draws("ensemble", counts, gibbs, ens.spec,
                                      steps)
        check(counts["fused"] == counts["allocation"] == 0,
              "ensemble: another kernel ran")
        # a P column is two passes over the G tiles, an E row one launch;
        # an A column one update; the metrics row and the hyper-update one
        # call each (the sums-only acol_delta and chain_metrics are off the
        # path)
        per_iter = {"_run": 3 * N, "stream_acol_update": N, "acol_delta": 0,
                    "stream_metrics_row": 1, "hyper_update": 1,
                    "chain_metrics": 0}
        for k, n in per_iter.items():
            check(launches[k] == n * steps,
                  f"{k} launches {launches[k]} != {n} x {steps} iterations")
        print(f"ensemble: {steps} iterations; launches "
              + ", ".join(f"{k} {v} (= {per_iter[k]} x {steps})"
                          for k, v in launches.items() if k in per_iter)
              + f", draw kernel {launches['rng']} ("
              f"{gibbs.draw_launches(ens.spec)} x {steps} + the initial "
              "draws + the rejection rounds)", flush=True)

        # the final checkpoint resumes bit-exactly (streams
        # included): 20 more iterations from the loaded copy and from the
        # run's own state
        resumed = bt.ChainEnsemble.load(
            os.path.join(ens.output_dir, "ensemble.ckpt"))
        temps = np.ones(20, np.float32)
        ends = []
        for x in (ens, resumed):
            acc = torch.zeros(x.states["params"]["P"].shape[0],
                              dtype=torch.bool, device="cuda")
            ends.append(CH.run_chunk_chains(x.spec, x.data, x.hp, x.states,
                                            temps, acc, store_E=False)[0])
        check(all(torch.equal(ends[0][g][k], ends[1][g][k])
                  for g in ("params", "prior") for k in ends[0][g]),
              "a resumed ensemble checkpoint drew other samples")
        print("ensemble: resumed from the final checkpoint, 20 more "
              "iterations equal the original chains' bit for bit",
              flush=True)

    rows = ens._metrics_all()
    rows = rows[~np.isnan(rows[..., 0])]
    check(rows.shape[0] > 0 and np.isfinite(rows).all(),
          "ensemble metrics are not finite")
    print(f"ensemble: {ens.throughput():.1f} chain-it/s over the run "
          f"({wall:.2f} s, {steps} iterations, MAP checks included) on "
          + card, flush=True)
    for c in range(ENS_CHAINS):
        cos = matched_cosines(np.asarray(ens.chain(c).MAP["P"]), P_true)
        print(f"ensemble: chain {c} learned rank {ens.learned_ranks[c]}, "
              f"converged at {ens.tracker.converged_iter[c]} "
              f"({ens.tracker.why(c)}), matched cosine min {cos.min():.4f} "
              f"mean {cos.mean():.4f}", flush=True)

    # the chunk loop alone: 8 fresh chains, 3 x 20 iterations after 5 of
    # warm-up
    states = CH.init_chain_states(
        ens.spec, ens.hp, ens.data,
        ChainStreams(1, np.arange(ENS_CHAINS), device="cuda"), ENS_CHAINS)
    acc = torch.zeros(ENS_CHAINS, dtype=torch.bool, device="cuda")
    states, _ = CH.run_chunk_chains(ens.spec, ens.data, ens.hp, states,
                                    np.ones(5, np.float32), acc,
                                    store_E=False)
    n_loop = 20
    for rep in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states, _ = CH.run_chunk_chains(ens.spec, ens.data, ens.hp, states,
                                        np.ones(n_loop, np.float32), acc,
                                        store_E=False)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        print(f"ensemble: chunk loop alone (rep {rep}) "
              f"{n_loop / loop_s:.2f} it/s, "
              f"{ENS_CHAINS * n_loop / loop_s:.1f} chain-it/s at C = "
              f"{ENS_CHAINS} on {card}", flush=True)

    # device busy share of the loop: device time of every kernel over the
    # wall time of a profiled window
    from torch.profiler import ProfilerActivity, profile

    n_prof = 10
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        states, _ = CH.run_chunk_chains(ens.spec, ens.data, ens.hp, states,
                                        np.ones(n_prof, np.float32), acc,
                                        store_E=False)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
                 for e in prof.key_averages())
    n_kernels = sum(e.count for e in prof.key_averages()
                    if getattr(e, "device_type", None) is not None
                    and "CUDA" in str(e.device_type))
    stream_us = {
        k: sum(getattr(e, "self_device_time_total", 0.0)
               for e in prof.key_averages() if k in e.key)
        for k in ("pcol_tile_kernel", "pcol_finish_kernel", "erow_kernel",
                  "acol_tile_kernel", "acol_finish_kernel",
                  "metrics_tile_kernel", "metrics_finish_kernel")}
    if dev_us > 0:
        print(f"ensemble: profiled {n_prof} iterations: device busy "
              f"{dev_us / 1e3:.1f} ms of {prof_s * 1e3:.1f} ms wall "
              f"(share {dev_us / 1e6 / prof_s:.3f}); stream kernels "
              + ", ".join(f"{k} {v / 1e3:.2f} ms" for k, v in
                          stream_us.items())
              + f"; {n_kernels} device events ({n_kernels / n_prof:.1f} per "
              f"iteration); on {card}", flush=True)
    else:
        print("ensemble: torch.profiler recorded no device time; busy "
              "share not measured", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phases 6 and 7: rank learning, the exponential prior, conjugate Gibbs
# ---------------------------------------------------------------------------


def resume_check(torch, bt, gibbs, s, label):
    """The final checkpoint resumes bit-exactly for 20 iterations."""
    resumed = bt.GibbsSampler.load(os.path.join(s.output_dir,
                                                "sampler.ckpt"))
    ends = [gibbs.run_chunk(x.spec, x.data, x.hyperprior_params, x.state,
                            np.ones(20, np.float32), False)[0]
            for x in (s, resumed)]
    check(all(torch.equal(ends[0][g][k], ends[1][g][k])
              for g in ("params", "prior") for k in ends[0][g]),
          f"{label}: a resumed checkpoint drew other samples")
    print(f"{label}: resumed from the final checkpoint, 20 more iterations "
          "equal the original chain's bit for bit", flush=True)


RANK_K, RANK_G, RANK_TRUE, RANK_MAX = 96, 1000, 8, 20
RANK_CC = dict(MAP_over=500, MAP_every=100, miniters=1000, maxiters=2000,
               Ninarow_nochange=3, Ninarow_nobest=5)


def run_rank_learning(torch, bt, FS, S, AL, gibbs, card):
    """Phase 6: SBFI over ranks 1..20 on a 96x1000 rank-8 catalogue."""
    M, P_true = synthetic(RANK_K, RANK_G, RANK_TRUE)
    cc = bt.ConvergenceControl(**RANK_CC)
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts(FS, S, AL)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = bt.fit(M, range(1, RANK_MAX + 1), rank_method="SBFI",
                   device="cuda", output_dir=os.path.join(tmp, "sbfi"),
                   convergence_control=cc, prop_temp=0.3, post_warmup=300,
                   seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counters(FS, S, AL)
        launches = counts["fused"]
        others = ported(counts) - launches
        steps = s.iter - 1
        draws = check_draws("rank learning", counts, gibbs, s.spec, steps)
        resume_check(torch, bt, gibbs, s, "rank learning")
    rows = np.concatenate(s._metric_rows)
    check(rows.shape[0] == s.iter and np.isfinite(rows).all(),
          "rank learning: metrics are not finite")
    check(launches == steps, f"rank learning: fused kernel launches "
          f"{launches} != iterations run {steps}")
    check(others == 0, f"rank learning: {others} other kernel launches")
    rank_col = rows[:, gibbs.METRIC_NAMES.index("rank")]
    tempering = s.temp_sched[1:s.iter + 1] < 1.0
    check(len(np.unique(rank_col[tempering])) > 1,
          "rank learning: the rank never moved while tempering")
    learned = int(np.asarray(s.MAP["A_full"]).sum())
    cos = matched_cosines(np.asarray(s.MAP["P"]), P_true)
    check(cos.min() >= 0.9, f"rank learning: matched cosine too low: {cos}")
    (loop,), _, _ = loop_rates(torch, gibbs, s, 300)
    print(f"rank learning: fit(96x1000, ranks 1..20, SBFI) ran {steps} "
          f"iterations, converged at {s.tracker.converged_iter} "
          f"({s.tracker.why}); learned rank {learned} (true "
          f"{RANK_TRUE}); rank during tempering {int(rank_col[0])}.."
          f"{int(rank_col[tempering][-1])} over "
          f"{len(np.unique(rank_col[tempering]))} values; fused kernel "
          f"launches {launches} (= iterations), draw kernel {draws}, other "
          f"kernels {others}; "
          f"the {len(cos)} best-matched MAP columns cosine min "
          f"{cos.min():.4f} mean {cos.mean():.4f}", flush=True)
    print(f"rank learning: {steps / wall:.1f} it/s for the whole fit "
          f"({wall:.2f} s), {loop:.1f} it/s in the chunk loop alone (300 "
          f"iterations) on {card}", flush=True)
    return launches


CONFIG1_CC = dict(MAP_over=300, MAP_every=100, miniters=300, maxiters=1500,
                  Ninarow_nochange=3, Ninarow_nobest=5)


def run_exponential(torch, bt, FS, S, AL, gibbs, card):
    """Phase 7: BASELINE config 1 (96x100, rank 5, Poisson-Exponential) with
    MH (the fused kernel) and conjugate (the allocation kernel), then the
    conjugate chunk loop at config 4's shape. Returns the allocation
    launches of the conjugate fit."""
    M, P_true = synthetic(96, 100, 5, seed=1)
    cc = bt.ConvergenceControl(**CONFIG1_CC)
    alloc_launches = None
    for MH in (True, False):
        label = f"exponential {'MH' if MH else 'conjugate'}"
        with tempfile.TemporaryDirectory() as tmp:
            reset_counts(FS, S, AL)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s = bt.fit(M, 5, prior="exponential", MH=MH, device="cuda",
                       output_dir=os.path.join(tmp, "fit"),
                       convergence_control=cc, post_warmup=300, seed=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counters(FS, S, AL)
            fused, alloc = counts["fused"], counts["allocation"]
            steps = s.iter - 1
            draws = check_draws(label, counts, gibbs, s.spec, steps)
            check(ported(counts) == fused + alloc,
                  f"{label}: another kernel ran")
            resume_check(torch, bt, gibbs, s, label)
        rows = np.concatenate(s._metric_rows)
        check(rows.shape[0] == s.iter and np.isfinite(rows).all(),
              f"{label}: metrics are not finite")
        if MH:
            check(fused == steps and alloc == 0, f"{label}: launches fused "
                  f"{fused}, allocation {alloc} for {steps} iterations")
        else:
            check(alloc == steps + 1 and fused == 0, f"{label}: launches "
                  f"allocation {alloc}, fused {fused} for {steps} iterations "
                  "(+1 at init)")
            alloc_launches = alloc
        cos = matched_cosines(np.asarray(s.MAP["P"]), P_true)
        check(cos.min() >= 0.9, f"{label}: matched cosine too low: {cos}")
        (loop,), _, _ = loop_rates(torch, gibbs, s, 300)
        print(f"{label}: fit(96x100, rank 5) ran {steps} iterations "
              f"({s.tracker.why}); launches fused {fused}, allocation "
              f"{alloc}, draw kernel {draws}; MAP matched cosine min "
              f"{cos.min():.4f} mean "
              f"{cos.mean():.4f}; {steps / wall:.1f} it/s for the whole fit "
              f"({wall:.2f} s), {loop:.1f} it/s in the chunk loop alone on "
              f"{card}", flush=True)

    # config 4's shape: the conjugate chunk loop at 96x2780, rank 8
    M4, _ = synthetic(96, 2780, 8, seed=2)
    s = bt.GibbsSampler(M4, 8, prior="exponential", MH=False, device="cuda",
                        convergence_control=bt.ConvergenceControl(
                            maxiters=600, miniters=0), seed=0)
    n_loop, n_prof = 200, 20
    (rate,), state, _ = loop_rates(torch, gibbs, s, n_loop)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gibbs.run_chunk(s.spec, s.data, s.hyperprior_params, state,
                        np.ones(n_prof, np.float32), False)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    ka = prof.key_averages()
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0)) for e in ka)
    alloc_us = sum(getattr(e, "self_device_time_total", 0.0) for e in ka
                   if "alloc_kernel" in e.key or "reduce_zg" in e.key)
    waits = [e for e in ka if e.key == "aten::_local_scalar_dense"]
    n_waits = sum(e.count for e in waits)
    wait_us = sum(e.cpu_time_total for e in waits)
    print(f"conjugate loop at 96x2780, rank 8: {rate:.1f} it/s ({n_loop} "
          f"iterations) on {card}", flush=True)
    if dev_us > 0:
        print(f"conjugate loop: profiled {n_prof} iterations: device busy "
              f"{dev_us / 1e3:.2f} ms of {prof_s * 1e3:.1f} ms wall (share "
              f"{dev_us / 1e6 / prof_s:.3f}); allocation kernel "
              f"{alloc_us / 1e3:.2f} ms; {n_waits} host waits "
              f"(aten::_local_scalar_dense, {n_waits / n_prof:.1f} per "
              f"iteration, {wait_us / 1e3:.2f} ms of host time) on {card}",
              flush=True)
    else:
        print("conjugate loop: torch.profiler recorded no device time; busy "
              "share not measured", flush=True)
    return alloc_launches


# ---------------------------------------------------------------------------
# phase 8: the eager sweeps and the Normal likelihood
# ---------------------------------------------------------------------------

# the new paths of phase 8 (a): models/gibbs.eager_step, and the fused step
# with the reference's conjugate Mu/Sigmasq update before the kernel
EAGER_CASES = {
    "normal_truncnormal": dict(likelihood="normal", prior="truncnormal",
                               MH=False),
    "normal_truncnormal_sbfi": dict(likelihood="normal", prior="truncnormal",
                                    MH=False, learning_rank=True,
                                    rank_method="SBFI"),
    "normal_exponential": dict(likelihood="normal", prior="exponential",
                               MH=False),
    "normal_exponential_bfi": dict(likelihood="normal", prior="exponential",
                                   MH=False, learning_rank=True,
                                   rank_method="BFI"),
    "eager_exact": dict(likelihood="poisson", prior="truncnormal"),
    "eager_sbfi": dict(likelihood="poisson", prior="truncnormal",
                       learning_rank=True, rank_method="SBFI"),
    "eager_exponential_reference_ratio": dict(
        likelihood="poisson", prior="exponential", exact_mh=False),
    "fused_conjugate_hypers": dict(likelihood="poisson", prior="truncnormal",
                                   fused_sweeps=True,
                                   exact_truncnorm_hypers=False),
    "eager_conjugate_hypers": dict(likelihood="poisson", prior="truncnormal",
                                   exact_truncnorm_hypers=False),
}
EAGER_K, EAGER_G, EAGER_RANK = 96, 500, 8
EAGER_RTOL, EAGER_ATOL = 1e-3, 1e-4
EAGER_WARMUP = 30
EAGER_CC = dict(MAP_over=200, MAP_every=100, miniters=200, maxiters=400,
                Ninarow_nochange=3, Ninarow_nobest=5)
# the eager fits' depth, cut to keep the script within its time: each fit
# at 96x500 recovers P to a matched cosine of 0.98 or more within it
EAGER_POST_WARMUP, EAGER_LOOP = 100, 100
EAGER_SBFI_G, EAGER_SBFI_CC = 1000, dict(MAP_over=100, MAP_every=100,
                                         miniters=100, maxiters=200,
                                         Ninarow_nochange=3,
                                         Ninarow_nobest=5)


def eager_step_case(torch, bt, gibbs, M, case, kw):
    """Phase 8 (a): one step of ``case`` from one state (after
    EAGER_WARMUP steps on the CPU) on the card and on the CPU with the same
    random numbers: A, R and every MH decision
    equal, every other value within rtol 1e-3 / atol 1e-4 (the KL within
    1e-5 of the size of its two sums). Returns the largest |card - CPU|
    over P and E."""
    from bayesnmf_tpu_torch.models import state as ST

    spec = bt.ModelSpec(K=EAGER_K, N=EAGER_RANK, G=EAGER_G, **kw)
    hp = dict(bt.default_hyperprior_params(spec, float(M.mean())))
    data = {d: torch.as_tensor(M, device=d) for d in ("cpu", "cuda")}
    state = gibbs.init_state(spec, hp, data["cpu"], ChainStreams(3, [0]))
    # from a state after a short warmup on the CPU, as a fit compares its
    # MH decisions: from the initial draw the Hastings ratios sum terms of
    # ~1e4 whose float32 rounding (~1e-3) can put a ratio on the other side
    # of its uniform on one device, which is no fault of either
    state, _ = gibbs.run_chunk(spec, data["cpu"], hp, state,
                               np.ones(EAGER_WARMUP, np.float32), spec.MH)
    if spec.MH:  # a record that the MH step must overwrite
        state["acc_P"].fill_(0.5)
        state["acc_E"].fill_(0.5)
    u = None
    gen = gibbs.streams_of(state)
    if spec.fused_sweeps:
        u = gen.uniform("fused", (gibbs.n_uniforms(spec),), None)
        noise = {"prior": gibbs.draw_eager_noise(spec, gen, "cpu")["prior"]}
    else:
        noise = gibbs.draw_eager_noise(spec, gen, "cpu")
    on = lambda x, d: ({k: on(v, d) for k, v in x.items()}  # noqa: E731
                       if isinstance(x, dict) else x.to(d))
    temp = 1e-3 if spec.learning_rank else 1.0
    out = {}
    for d in ("cpu", "cuda"):
        st = ST.state_from_numpy(ST.state_to_numpy(state), d)
        new, sample = gibbs.gibbs_step(
            spec, data[d], hp, st, temp, False,
            u=None if u is None else u.to(d), noise=on(noise, d))
        out[d] = (ST.state_to_numpy(new), sample["metrics"].cpu().numpy())
    (got, gm), (want, wm) = out["cuda"], out["cpu"]
    for k in ("A", "R"):
        check(np.array_equal(got["params"][k], want["params"][k]),
              f"eager step {case}: {k} differs on the card")
    old = ST.state_to_numpy(state)["params"]
    err = 0.0
    for k in ("P", "E"):
        check(np.array_equal(got["params"][k] != old[k],
                             want["params"][k] != old[k]),
              f"eager step {case}: a decision on {k} differs on the card")
        err = max(err, float(np.max(np.abs(got["params"][k]
                                           - want["params"][k]))))
    pairs = [(f"params.{k}", got["params"][k], want["params"][k])
             for k in ("P", "E", "sigmasq") if k in want["params"]]
    pairs += [(f"prior.{k}", got["prior"][k], v)
              for k, v in want["prior"].items()]
    pairs += [(k, got[k], want[k]) for k in ("acc_P", "acc_E") if k in want]
    kl = gibbs.METRIC_NAMES.index("KL")
    pairs.append(("metrics", np.delete(gm, kl), np.delete(wm, kl)))
    for name, a, b in pairs:
        check(np.allclose(a, b, rtol=EAGER_RTOL, atol=EAGER_ATOL),
              f"eager step {case}: {name} differs on the card by "
              f"{float(np.max(np.abs(a - b)))}")
    # KL = sum(Mp log Mp) - sum(Mp log max(Mhat, 1e-6)): each float32 sum
    # of K*G terms, added in another order on the card, rounds to ~1e-5 of
    # its size, and the second is ~|KL| where excluded columns leave Mhat
    # at the floor
    Mp = np.maximum(M, 1e-6)
    kl_atol = 1e-5 * (float(np.sum(Mp * np.log(Mp))) + abs(float(wm[kl])))
    check(abs(gm[kl] - wm[kl]) <= kl_atol,
          f"eager step {case}: KL {gm[kl]} on the card, {wm[kl]} on the CPU")
    return err


def run_eager(torch, bt, FS, S, AL, gibbs, card):
    """Phase 8: the eager sweeps and the Normal likelihood on the card."""
    M, P_true = synthetic(EAGER_K, EAGER_G, EAGER_RANK, seed=3)

    # (a) one step of each new path, card against CPU
    t0 = time.perf_counter()
    errs = {case: eager_step_case(torch, bt, gibbs, M, case, kw)
            for case, kw in EAGER_CASES.items()}
    print(f"eager (a): one step of each of {len(errs)} paths at "
          f"({EAGER_K},{EAGER_RANK},{EAGER_G}) on the card equals the CPU "
          f"step on the same draws (A, R, decisions equal; the rest within "
          f"rtol {EAGER_RTOL} / atol {EAGER_ATOL}); max |P, E diff| "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)

    # (b) full-width fits; (d) bit-exact resume of the Normal fit
    fits = {}
    for label, kw in (("normal_truncnormal", dict(likelihood="normal")),
                      ("normal_exponential", dict(likelihood="normal",
                                                  prior="exponential")),
                      ("poisson_eager", dict(fused_sweeps=False))):
        with tempfile.TemporaryDirectory() as tmp:
            reset_counts(FS, S, AL)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s = bt.fit(M, EAGER_RANK, device="cuda",
                       output_dir=os.path.join(tmp, "fit"),
                       convergence_control=bt.ConvergenceControl(**EAGER_CC),
                       post_warmup=EAGER_POST_WARMUP, seed=0, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counters(FS, S, AL)
            # the exact truncnormal hyper-update is one launch a step
            hyper = counts["hyper_update"]
            launches = ported(counts) - hyper
            steps = s.iter - 1
            draws = check_draws(f"eager (b) {label}", counts, gibbs, s.spec,
                                steps)
            if label == "normal_truncnormal":
                resume_check(torch, bt, gibbs, s, f"eager (d) {label}")
        check(launches == 0, f"eager (b) {label}: {launches} kernel "
              "launches on the eager path")
        check(hyper == gibbs.hyper_launches(s.spec) * steps,
              f"eager (b) {label}: hyper-update launches {hyper} != "
              f"{gibbs.hyper_launches(s.spec)} x {steps} iterations")
        rows = np.concatenate(s._metric_rows)
        check(rows.shape[0] == s.iter and np.isfinite(rows).all(),
              f"eager (b) {label}: metrics are not finite")
        cos = matched_cosines(np.asarray(s.MAP["P"]), P_true)
        check(cos.min() >= 0.9, f"eager (b) {label}: matched cosine too "
              f"low: {cos}")
        (loop,), state, _ = loop_rates(torch, gibbs, s, EAGER_LOOP)
        check(FS.fused_gibbs_sweeps.launches == 0,
              f"eager (b) {label}: the loop launched the fused kernel")
        fits[label] = (s, state)
        print(f"eager (b) {label}: fit({EAGER_K}x{EAGER_G}, rank "
              f"{EAGER_RANK}) ran {steps} "
              f"iterations ({s.tracker.why}); kernel launches 0 but the "
              f"hyper-update's {hyper} and the draw kernel's {draws}; MAP "
              f"matched cosine min {cos.min():.4f} mean {cos.mean():.4f}; "
              f"{steps / wall:.1f} it/s for the whole fit ({wall:.2f} s), "
              f"{loop:.1f} it/s in the chunk loop alone ({EAGER_LOOP} "
              f"iterations) on {card}", flush=True)
    # the fused path's loop on the same data in the same call
    reset_counts(FS, S, AL)
    fused = bt.GibbsSampler(M, EAGER_RANK, device="cuda", seed=0,
                            verbosity=0)
    check(fused.spec.fused_sweeps, "a default Poisson-MH fit is not fused")
    (loop,), _, _ = loop_rates(torch, gibbs, fused, 500)
    check(FS.fused_gibbs_sweeps.launches == 520,
          f"fused loop: {FS.fused_gibbs_sweeps.launches} launches for 520 "
          "iterations")
    check_draws("fused loop", launch_counters(FS, S, AL), gibbs, fused.spec,
                520)
    print(f"eager (b): the fused path's chunk loop on the same data "
          f"{loop:.1f} it/s (500 iterations, {FS.fused_gibbs_sweeps.launches}"
          f" fused launches in 520) on {card}", flush=True)

    # (c) Normal-TruncNormal SBFI over ranks 1..20 at 96x1000
    M3, P3 = synthetic(96, EAGER_SBFI_G, EAGER_RANK, seed=4)
    reset_counts(FS, S, AL)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = bt.fit(M3, range(1, RANK_MAX + 1), likelihood="normal",
               device="cuda", output_dir=None, prop_temp=0.3, seed=0,
               convergence_control=bt.ConvergenceControl(**EAGER_SBFI_CC))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counters(FS, S, AL)
    hyper = counts["hyper_update"]
    launches = ported(counts) - hyper
    check(launches == 0, f"eager (c): {launches} kernel launches")
    check(hyper == s.iter - 1, f"eager (c): hyper-update launches {hyper} "
          f"!= {s.iter - 1} iterations")
    check_draws("eager (c)", counts, gibbs, s.spec, s.iter - 1)
    rows = np.concatenate(s._metric_rows)
    check(np.isfinite(rows).all(), "eager (c): metrics are not finite")
    learned = int(np.asarray(s.MAP["A_full"]).sum())
    cos = matched_cosines(np.asarray(s.MAP["P"]), P3)
    print(f"eager (c): fit(96x{EAGER_SBFI_G}, ranks 1..{RANK_MAX}, SBFI, "
          f"Normal-TruncNormal) "
          f"ran {s.iter - 1} iterations ({s.tracker.why}); learned rank "
          f"{learned} (true {EAGER_RANK}); the {len(cos)} best-matched MAP "
          f"columns cosine min {cos.min():.4f} mean {cos.mean():.4f}; "
          f"{(s.iter - 1) / wall:.1f} it/s for the whole fit ({wall:.2f} s) "
          f"on {card}", flush=True)

    # (e) where the Normal and the eager Poisson loops spend their time
    for label in ("normal_truncnormal", "poisson_eager"):
        s, state = fits[label]
        n_prof = 10
        dev_us, wall, events, n_waits, wait_us = profile_loop(
            torch, gibbs, s, state, n_prof)
        if dev_us > 0:
            print(f"eager (e) {label}: profiled {n_prof} iterations: device "
                  f"busy {dev_us / 1e3:.2f} ms of {wall * 1e3:.1f} ms wall "
                  f"(share {dev_us / 1e6 / wall:.3f}); {events} device "
                  f"events ({events / n_prof:.1f} per iteration); {n_waits} "
                  f"host waits ({n_waits / n_prof:.1f} per iteration, "
                  f"{wait_us / 1e3:.2f} ms of host time) on {card}",
                  flush=True)
        else:
            print(f"eager (e) {label}: torch.profiler recorded no device "
                  "time; busy share not measured", flush=True)


# ---------------------------------------------------------------------------
# phase 9: the ensemble slice
# ---------------------------------------------------------------------------

# (K, N, G, chains, per-chain masks of ranks 1..C): phase 9 (a), the fused
# kernel on a chain axis beyond the four chains phase 3 checks
ENS_KERNEL_CASES = [(96, 8, 500, 8, False), (96, 8, 500, 64, False),
                    (96, 20, 1000, 20, True)]
# phase 9 (b): the exponential prior in the stream kernels, at the timed
# shape, with an excluded column (and inactive columns), and deep in the
# truncated tail; the metrics row at the timed shape and with excluded
# columns and a chain with none
EXP_UPDATE_CASES = [(96, 20, 10000, 8, None, ()),
                    (16, 3, 300, 2, (1.0, 0.0, 1.0), ("inactive",)),
                    (96, 8, 2000, 2, None, ("tails",))]
EXP_ROW_CASES = [(96, 20, 10000, 8, None, None),
                 (16, 3, 300, 3, None, "excluded")]
# phase 9 (c): the allocation on the conjugate step of an ensemble
ENS_ALLOC = (96, 8, 2780, 8)
# phase 9 (d): whole runs
BIC_G, BIC_CC, BIC_POST = 1000, dict(MAP_over=300, MAP_every=100,
                                     miniters=600, maxiters=1200,
                                     Ninarow_nochange=3,
                                     Ninarow_nobest=5), 300
EXP_ENS_CC, EXP_ENS_POST = dict(MAP_over=200, MAP_every=100, miniters=400,
                                maxiters=800, Ninarow_nochange=3,
                                Ninarow_nobest=5), 200
CONJ_ENS_CC = dict(MAP_over=300, MAP_every=100, miniters=300, maxiters=500,
                   Ninarow_nochange=3, Ninarow_nobest=5)
NORMAL_ENS_CC = dict(MAP_over=200, MAP_every=100, miniters=200,
                     maxiters=400, Ninarow_nochange=3, Ninarow_nobest=5)
LOOP_CHAINS = (8, 64)


def rank_masks(C, N):
    """(C, N) inclusion masks of ranks 1..C: chain c keeps its first c + 1
    columns."""
    return (np.arange(N)[None, :] <= np.arange(C)[:, None]).astype(
        np.float32)


def compare_ensemble_kernel(torch, FS, card):
    """Phase 9 (a): the fused kernel at ENS_KERNEL_CASES against its plain
    version (rtol 1e-4 / atol 1e-5, A, R and every decision equal, two
    launches bit-identical), the warmup flag alternating over the chains;
    prints cluster_config and the kernel's time beside its bound. Returns
    {(K, N, G, C): dict(max_abs_err, ms, plain_ms, bound_ms, bound_by)}."""
    res = {}
    for (K, N, G, C, masks) in ENS_KERNEL_CASES:
        d = sweep_inputs(K, N, G, C, seed=K + N + G + C)
        if masks:
            d["A"] = rank_masks(C, N)
            d["Mhat"] = np.einsum("ckn,cn,cng->ckg", d["P"], d["A"],
                                  d["E"]).astype(np.float32)
        t = to_card(torch, d)
        flags = torch.arange(C, device="cuda") % 2 == 0
        case = (f"ensemble (K,N,G,C)={(K, N, G, C)}"
                + (" masks of ranks 1..C" if masks else ""))
        worst, kernel, plain = check_sweep_case(torch, FS, t, C, case, flags)
        k_ms, w_ms = kernel_ms(torch, kernel, 20)
        p_ms = time_ms(torch, plain, 2)
        b_ms, b_by = fused_bound(K, N, G, C)
        res[(K, N, G, C)] = dict(max_abs_err=worst, ms=k_ms, plain_ms=p_ms,
                                 bound_ms=b_ms, bound_by=b_by)
        cfg = FS.cluster_config(K, N, G, C)
        print(f"ensemble kernel {case}: cluster_config {cfg}; kernel "
              f"{k_ms:.4f} ms on the device ({w_ms:.4f}"
              f" ms per call through the wrapper, {k_ms / C:.4f} ms a "
              f"chain), plain PyTorch {p_ms:.4f} ms, bound {b_ms:.5f} ms "
              f"({b_by}), on {card}", flush=True)
    return res


def compare_ensemble_allocation(torch, bt, AL, card, shape=ENS_ALLOC,
                                prior="exponential", steps=5,
                                label="ensemble allocation"):
    """Phase 9 (c): the allocation on the operands of a conjugate ensemble
    step at ``shape`` (P, A, E of C chains after ``steps`` steps of the
    ``prior``'s conjugate path on the card, the shared M): equal to its
    plain version in both modes, two launches bit-identical, the counts
    conserved (phase 10 (a) runs it on Poisson-Gamma states). Returns
    dict(max_abs_err, ms, plain_ms, bound_ms, bound_by)."""
    K, N, G, C = shape
    M, _ = synthetic(K, G, N, seed=2)
    ens = bt.ChainEnsemble(M, N, n_chains=C, prior=prior, MH=False,
                           device="cuda", seed=0, verbosity=0)
    ens._run_chunk(steps)
    st = ens.states["params"]
    args = (ens.data, st["P"], st["A"], st["E"])
    u = uniform_planes(torch, AL, C, N, K, G, 5)
    # the Philox mode keyed as the ensemble's next step keys it
    from bayesnmf_tpu_torch.models.gibbs import streams_of

    gen = streams_of(ens.states)
    key, uids = gen.subkey("alloc"), gen.uids
    modes = {
        "planes": (lambda: AL.allocate_counts(*args, u=u),
                   lambda: AL.allocate_counts_reference(*args, u)),
        "Philox": (lambda: AL.allocate_counts(*args, key=key, uids=uids),
                   lambda: AL.allocate_counts_reference(
                       *args, AL.philox_planes(key, uids, N, K, G)))}
    res = {"max_abs_err": 0.0}
    for mode, (kernel, plain) in modes.items():
        k1, k2 = kernel(), kernel()
        p = plain()
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(k1, k2)),
              f"{label} ({mode}): two launches differ")
        for name, x, y in zip(("Zsum_g", "Zsum_k"), k1, p):
            err = float((x - y).abs().max())
            res["max_abs_err"] = max(res["max_abs_err"], err)
            check(torch.equal(x, y), f"{label} ({mode}) {name} "
                  f"differs from the plain version: max abs {err}")
        check(torch.equal(k1[1].sum(-2), ens.data.sum(0).expand(C, G)),
              f"{label} ({mode}) does not conserve the counts")
    ms, wrapped = kernel_ms(torch, modes["Philox"][0], 20)
    res["ms"] = ms
    res["plain_ms"] = time_ms(torch, modes["Philox"][1], 2)
    splits = count_splits(AL, torch, modes["Philox"][1])
    res["bound_ms"], res["bound_by"] = alloc_bound(K, N, G, C, splits, False)
    print(f"{label} at (K,N,G,C)={shape} on a {prior} conjugate state "
          f"after {steps} steps: Zsum_g and Zsum_k equal to the plain "
          f"version in both "
          f"modes, two launches bit-identical, counts conserved; "
          f"{ms:.4f} ms on the device (Philox; {wrapped:.4f} ms per call "
          f"through the wrapper), plain PyTorch {res['plain_ms']:.4f} ms, "
          f"bound {res['bound_ms']:.6f} ms ({res['bound_by']}) for "
          f"{splits[0]} inversion splits of {splits[1]} steps and "
          f"{splits[2]} BTRS splits, on {card}", flush=True)
    return res


def profile_chains(torch, CH, ens, states, acc, n):
    """torch.profiler over ``n`` iterations of the ensemble's chunk loop
    from ``states``: (device busy us, wall s, device events)."""
    return profile_run(torch, lambda: CH.run_chunk_chains(
        ens.spec, ens.data, ens.hp, states, np.ones(n, np.float32), acc,
        store_E=False))[:3]


def fresh_chains(torch, CH, ens, C, seed=1):
    """C new chains of the ensemble's model (its masks on them)."""
    states = CH.init_chain_states(
        ens.spec, ens.hp, ens.data,
        ChainStreams(seed, np.arange(C), device="cuda"), C)
    if ens.A_masks is not None:
        masks = torch.as_tensor(ens.A_masks[:C], device="cuda")
        states["params"]["A"] = masks
        states["params"]["R"] = masks.sum(1).to(torch.int32)
    return states


def chunk_loop(torch, CH, ens, C, n, label, card, profile=True):
    """The chunk loop alone on C fresh chains (5 iterations of warm-up,
    then ``n`` timed), and a profiled window of 10: returns chain-it/s and
    prints the busy share and device events per iteration."""
    states = fresh_chains(torch, CH, ens, C)
    acc = torch.zeros(C, dtype=torch.bool, device="cuda")
    states, _ = CH.run_chunk_chains(ens.spec, ens.data, ens.hp, states,
                                    np.ones(5, np.float32), acc,
                                    store_E=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    states, _ = CH.run_chunk_chains(ens.spec, ens.data, ens.hp, states,
                                    np.ones(n, np.float32), acc,
                                    store_E=False)
    torch.cuda.synchronize()
    rate = C * n / (time.perf_counter() - t0)
    line = (f"{label}: chunk loop alone {rate:.1f} chain-it/s "
            f"({rate / C:.2f} it/s, C = {C}, {n} iterations)")
    if profile:
        n_prof = 10
        dev_us, wall, events = profile_chains(torch, CH, ens, states, acc,
                                              n_prof)
        line += (f"; profiled {n_prof} iterations: device busy "
                 f"{dev_us / 1e3:.2f} ms of {wall * 1e3:.1f} ms wall (share "
                 f"{dev_us / 1e6 / wall:.3f}), {events / n_prof:.1f} device "
                 "events per iteration" if dev_us > 0 else
                 "; torch.profiler recorded no device time, busy share not "
                 "measured")
    print(f"{line} on {card}", flush=True)
    return rate


def report_run(torch, CH, ens, label, wall, launches, per_iter, P_true,
               card, best=None):
    """The checks and lines every phase 9 run prints: finite metrics, each
    kernel's launches per iteration (the draw kernel's: the path's draws a
    step, the initial draws and the rejection rounds), chain-it/s over
    run(), diagnostics(), the best chain's (least BIC, or ``best``) matched
    cosine >= 0.9."""
    from bayesnmf_tpu_torch.models import gibbs

    steps = ens.iter - 1
    per_iter = dict(per_iter)
    per_iter["rng"] = (gibbs.draw_launches(ens.spec),
                       draw_launches(gibbs, ens.spec, 0, init=True))
    if gibbs.hyper_launches(ens.spec):
        per_iter["hyper_update"] = (gibbs.hyper_launches(ens.spec), 0)
    rows = ens._metrics_all()
    rows = rows[~np.isnan(rows[..., 0])]
    check(rows.shape[0] > 0 and np.isfinite(rows).all(),
          f"{label}: metrics are not finite")
    for k, v in launches.items():
        n, extra = per_iter.get(k, (0, 0))
        check(v == n * steps + extra, f"{label}: {k} launches {v} != "
              f"{n} x {steps} iterations + {extra}")
    table = ens.bic_table()
    c = int(table.iloc[0]["chain"]) if best is None else best
    cos = matched_cosines(np.asarray(ens.chain(c).MAP["P"]), P_true)
    check(cos.min() >= 0.9, f"{label}: chain {c}'s matched cosine too low: "
          f"{cos}")
    diag = ens.diagnostics()
    counted = ", ".join(f"{k} {v} (= {per_iter[k][0]} x {steps}"
                        + (f" + {per_iter[k][1]}" if per_iter[k][1] else "")
                        + ")" for k, v in launches.items() if k in per_iter)
    print(f"{label}: {steps} iterations, {ens.throughput():.1f} chain-it/s "
          f"over run() ({wall:.2f} s, MAP checks included); launches "
          + (counted + ", other kernels 0" if counted else "none")
          + f"; learned ranks {ens.learned_ranks.tolist()}; "
          f"best chain {c} (rank {int(table.iloc[0]['rank'])}) matched "
          f"cosine min {cos.min():.4f} mean {cos.mean():.4f}; on {card}",
          flush=True)
    print(f"{label}: diagnostics() " + "; ".join(
        f"{r.metric} rhat {r.rhat:.4f} ess_bulk {r.ess_bulk:.1f} ess_tail "
        f"{r.ess_tail:.1f}" + (" (constant)" if r.constant else "")
        for r in diag.itertuples()), flush=True)
    return table


def run_ensembles(torch, bt, FS, S, AL, card):
    """Phase 9 (d), (e): whole ensemble runs on every path, and the masked
    ensemble's bit-exact resume. Returns the launches of each run."""
    from bayesnmf_tpu_torch.parallel import chains as CH

    out = {}
    # fit(rank_method="BIC") over ranks 1..20: one masked ensemble of 20
    # chains through the fused kernel
    M, P_true = synthetic(RANK_K, BIC_G, RANK_TRUE)
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts(FS, S, AL)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = bt.fit(M, range(1, RANK_MAX + 1), rank_method="BIC",
                     device="cuda", output_dir=os.path.join(tmp, "bic"),
                     convergence_control=bt.ConvergenceControl(**BIC_CC),
                     post_warmup=BIC_POST, seed=0, periodic_save=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counters(FS, S, AL)
        ens = res["ensemble"]
        check(ens.spec.fused_sweeps and ens.A_masks is not None,
              "BIC: the parallel route did not run the masked fused path")
        report_run(torch, CH, ens, "ensemble BIC", wall, launches,
                   {"fused": (1, 0)}, P_true, card, best=res["sampler"].chain)
        print("ensemble BIC: best_rank " + str(res["best_rank"])
              + " (true " + str(RANK_TRUE) + "); BIC table " + "; ".join(
                  f"rank {r['rank']} {r['BIC']:.1f}" for r in res["results"]),
              flush=True)
        out["bic"] = launches
        # (e) the masked ensemble's final checkpoint resumes bit-exactly
        resumed = bt.ChainEnsemble.load(os.path.join(ens.output_dir,
                                                     "ensemble.ckpt"))
        check(np.array_equal(resumed.A_masks, ens.A_masks),
              "BIC: the checkpoint lost the masks")
        ends = []
        for x in (ens, resumed):
            acc = torch.zeros(x.states["params"]["P"].shape[0],
                              dtype=torch.bool, device="cuda")
            ends.append(CH.run_chunk_chains(x.spec, x.data, x.hp, x.states,
                                            np.ones(20, np.float32), acc,
                                            store_E=False)[0])
        check(all(torch.equal(ends[0][g][k], ends[1][g][k])
                  for g in ("params", "prior") for k in ends[0][g]),
              "a resumed masked ensemble drew other samples")
        print("ensemble BIC: resumed from the final checkpoint, 20 more "
              "iterations equal the original chains' bit for bit", flush=True)
    chunk_loop(torch, CH, ens, RANK_MAX, 30, "ensemble BIC", card)

    # Poisson-Exponential SBFI at the north-star shape through the stream
    # kernels
    M, P_true = synthetic(ENS_K, ENS_G, ENS_TRUE_RANK)
    N = ENS_MAX_RANK
    reset_counts(FS, S, AL)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ens = bt.ChainEnsemble(
        M, range(1, N + 1), n_chains=ENS_CHAINS, prior="exponential",
        convergence_control=bt.ConvergenceControl(**EXP_ENS_CC),
        post_warmup=EXP_ENS_POST, seed=0, store_E=False, periodic_save=False,
        device="cuda")
    check(ens.spec.stream_sweeps, "the 96x10k ensemble is not streamed")
    ens.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counters(FS, S, AL)
    report_run(torch, CH, ens, "ensemble exponential stream", wall, launches,
               {"_run": (3 * N, 0), "stream_acol_update": (N, 0),
                "stream_metrics_row": (1, 0)}, P_true, card)
    out["exponential"] = launches
    chunk_loop(torch, CH, ens, ENS_CHAINS, 20, "ensemble exponential stream",
               card)

    # conjugate Poisson-Exponential at config 4's shape
    M, P_true = synthetic(96, 2780, 8, seed=2)
    reset_counts(FS, S, AL)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ens = bt.ChainEnsemble(
        M, 8, n_chains=8, prior="exponential", MH=False,
        convergence_control=bt.ConvergenceControl(**CONJ_ENS_CC), seed=0,
        periodic_save=False, device="cuda")
    ens.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counters(FS, S, AL)
    report_run(torch, CH, ens, "ensemble conjugate", wall, launches,
               {"allocation": (1, 1)}, P_true, card)
    out["conjugate"] = launches
    chunk_loop(torch, CH, ens, 8, 50, "ensemble conjugate", card)

    # Normal-TruncNormal at config 2's shape: no kernel
    M, P_true = synthetic(96, 500, 8, seed=3)
    reset_counts(FS, S, AL)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ens = bt.ChainEnsemble(
        M, 8, n_chains=8, likelihood="normal",
        convergence_control=bt.ConvergenceControl(**NORMAL_ENS_CC), seed=0,
        periodic_save=False, device="cuda")
    ens.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    report_run(torch, CH, ens, "ensemble Normal", wall,
               launch_counters(FS, S, AL), {}, P_true, card)
    chunk_loop(torch, CH, ens, 8, 20, "ensemble Normal", card)

    # Poisson MH at config 2's shape: the fused kernel against the
    # chain-batched eager sweeps, the number behind fused_sweeps=None
    M, _ = synthetic(96, 500, 8, seed=3)
    for C in LOOP_CHAINS:
        for fused in (True, False):
            ens = bt.ChainEnsemble(M, 8, n_chains=C, fused_sweeps=fused,
                                   seed=0, device="cuda", verbosity=0)
            reset_counts(FS, S, AL)
            chunk_loop(torch, CH, ens, C, 30 if fused else 10,
                       f"ensemble Poisson MH 96x500 fused_sweeps={fused}",
                       card, profile=C == LOOP_CHAINS[0])
            n_fused = FS.fused_gibbs_sweeps.launches
            want = 5 + (30 if fused else 10) + (
                10 if C == LOOP_CHAINS[0] else 0)
            check(n_fused == (want if fused else 0),
                  f"Poisson MH fused_sweeps={fused}: {n_fused} fused "
                  "launches")
            from bayesnmf_tpu_torch.models import gibbs

            check_draws(f"Poisson MH fused_sweeps={fused}",
                        launch_counters(FS, S, AL), gibbs, ens.spec, want)
    return out


# ---------------------------------------------------------------------------
# phase 10: the Poisson-Gamma family and the recording surface
# ---------------------------------------------------------------------------

# (a) the allocation on Poisson-Gamma states of 1 and 8 chains
GAMMA_ALLOC = (96, 8, 2780)
GAMMA_ALLOC_CHAINS = (1, 8)
GAMMA_WARMUP = 30
# (b) one step on the card against the CPU
GAMMA_K, GAMMA_G, GAMMA_RANK = 96, 500, 8
GAMMA_HYPER_RTOL = 1e-4
# (c) fits
GAMMA_EXAMPLE_CC = dict(MAP_over=200, MAP_every=100, miniters=400,
                        maxiters=600)
GAMMA_FIT_G = 2780
GAMMA_FIT_CC = dict(MAP_over=200, MAP_every=100, miniters=200, maxiters=300,
                    Ninarow_nochange=3, Ninarow_nobest=5)
GAMMA_SBFI_G = 1000
GAMMA_SBFI_CC = dict(MAP_over=100, MAP_every=100, miniters=100,
                     maxiters=200, Ninarow_nochange=3, Ninarow_nobest=5)
GAMMA_ENS_CHAINS = 8
GAMMA_ENS_CC = dict(MAP_over=200, MAP_every=100, miniters=200, maxiters=300,
                    Ninarow_nochange=3, Ninarow_nobest=5)
GAMMA_BIC_CC = dict(MAP_over=100, MAP_every=100, miniters=200, maxiters=300,
                    Ninarow_nochange=3, Ninarow_nobest=5)
# (d) recording: the stream ensemble at the north-star shape, 200
# iterations (100 of warmup, 100 of MH)
REC_CC = dict(MAP_over=100, MAP_every=100, miniters=0, maxiters=100)
REC_POST = 100


def gamma_step_case(torch, bt, gibbs, AL, M, kw):
    """Phase 10 (b): one Poisson-Gamma step (the Beta draws, one slice pass
    over both Alphas, P and E given the latent counts, with SBFI the R draw
    and the A sweep, then the allocation) on the card and on the CPU from
    one state (after GAMMA_WARMUP steps on the card) with the same random
    numbers: A, R and the slice decisions (which Alpha lanes moved)
    equal, Alpha and Beta within rtol 1e-4, P and E within rtol 1e-3 /
    atol 1e-4. Returns the largest |card - CPU| over P and E."""
    from bayesnmf_tpu_torch.models import state as ST

    spec = bt.ModelSpec(K=GAMMA_K, N=GAMMA_RANK, G=GAMMA_G,
                        likelihood="poisson", prior="gamma", MH=False, **kw)
    K, N, G = spec.K, spec.N, spec.G
    hp = dict(bt.default_hyperprior_params(spec, float(M.mean())))
    data = {d: torch.as_tensor(M, device=d) for d in ("cpu", "cuda")}
    state = gibbs.init_state(spec, hp, data["cuda"],
                             ChainStreams(3, [0], device="cuda"))
    state, _ = gibbs.run_chunk(spec, data["cuda"], hp, state,
                               np.ones(GAMMA_WARMUP, np.float32), False)
    cg = torch.Generator().manual_seed(4)
    r = lambda *s: torch.rand(s, generator=cg).clamp_min_(1.2e-38)  # noqa
    n_t = K * N + N * G
    noise = {"prior": {"p": r(9, K, N), "e": r(9, N, G),
                       "slice": {"e": -torch.log(r(n_t)), "u_l": r(n_t),
                                 "u_s": r(16, n_t)}},
             "P": r(9, K, N), "E": r(9, N, G),
             "Z": r(AL.N_PLANES, AL.n_nodes(N), K, G)}
    if spec.learning_rank:
        noise |= {"R": -torch.log(-torch.log(r(N + 1))), "A": r(N)}
    on = lambda x, d: ({k: on(v, d) for k, v in x.items()}  # noqa: E731
                       if isinstance(x, dict) else x.to(d))
    temp = 1e-3 if spec.learning_rank else 1.0
    out = {}
    for d in ("cpu", "cuda"):
        st = ST.state_from_numpy(ST.state_to_numpy(state), d)
        new, _ = gibbs.gibbs_step(spec, data[d], hp, st, temp, False,
                                  noise=on(noise, d))
        out[d] = ST.state_to_numpy(new)
    got, want = out["cuda"], out["cpu"]
    old = ST.state_to_numpy(state)
    label = f"gamma step {'SBFI' if spec.learning_rank else 'fixed rank'}"
    for k in ("A", "R"):
        check(np.array_equal(got["params"][k], want["params"][k]),
              f"{label}: {k} differs on the card")
    for k in ("Alpha_p", "Alpha_e"):
        moved = got["prior"][k] != old["prior"][k]
        check(np.array_equal(moved, want["prior"][k] != old["prior"][k]),
              f"{label}: a slice decision on {k} differs on the card")
    for k in ("Alpha_p", "Alpha_e", "Beta_p", "Beta_e"):
        check(np.allclose(got["prior"][k], want["prior"][k],
                          rtol=GAMMA_HYPER_RTOL, atol=0),
              f"{label}: {k} differs on the card by "
              f"{float(np.max(np.abs(got['prior'][k] - want['prior'][k])))}")
    err = 0.0
    for k in ("P", "E"):
        a, b = got["params"][k], want["params"][k]
        check(np.allclose(a, b, rtol=EAGER_RTOL, atol=EAGER_ATOL),
              f"{label}: {k} differs on the card by "
              f"{float(np.max(np.abs(a - b)))}")
        err = max(err, float(np.max(np.abs(a - b))))
    moved = sum(int((got["prior"][k] != old["prior"][k]).sum())
                for k in ("Alpha_p", "Alpha_e"))
    below = int((got["prior"]["Alpha_e"] < 1.0).sum())
    print(f"{label} at ({K},{N},{G}): on the card equal to the CPU step on "
          f"the same draws (A, R and the slice decisions of {n_t} lanes "
          f"equal, {moved} moved; Alpha, Beta within rtol "
          f"{GAMMA_HYPER_RTOL}; P, E within rtol {EAGER_RTOL} / atol "
          f"{EAGER_ATOL}, max |diff| {err:.3g}); {below} Alpha_e entries "
          "below 1", flush=True)
    return err


def run_gamma(torch, bt, FS, S, AL, gibbs, card):
    """Phase 10 (a)-(c): the allocation on Poisson-Gamma states, one step
    on the card against the CPU, and the Poisson-Gamma fits. Returns
    (the 8-chain allocation's comparison, the 8-chain ensemble's
    allocation launches)."""
    from bayesnmf_tpu_torch.parallel import chains as CH
    from bayesnmf_tpu_torch.utils.rds import load_example_data

    # (a) the allocation kernel on Poisson-Gamma states
    alloc = {C: compare_ensemble_allocation(
        torch, bt, AL, card, GAMMA_ALLOC + (C,), "gamma", GAMMA_WARMUP,
        "gamma allocation") for C in GAMMA_ALLOC_CHAINS}

    # (b) one step on the card against the CPU, fixed rank and SBFI
    M, _ = synthetic(GAMMA_K, GAMMA_G, GAMMA_RANK, seed=3)
    for kw in ({}, dict(learning_rank=True, rank_method="SBFI")):
        gamma_step_case(torch, bt, gibbs, AL, M, kw)

    # (c) fits: the reference's example data at rank 4
    d = load_example_data()
    Mx, Px = np.asarray(d["M"], np.float32), np.asarray(d["P"], np.float32)
    reset_counts(FS, S, AL)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = bt.fit(Mx, 4, prior="gamma", device="cuda", output_dir=None,
               convergence_control=bt.ConvergenceControl(**GAMMA_EXAMPLE_CC),
               seed=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cos = matched_cosines(np.asarray(s.MAP["P"]), Px)
    check(cos.min() > 0.9, f"gamma example data: matched cosine {cos}")
    counts = launch_counters(FS, S, AL)
    check(counts["allocation"] == s.iter
          and ported(counts) == counts["allocation"],
          f"gamma example data: allocation launches "
          f"{AL.allocate_counts.launches} for {s.iter - 1} iterations + 1")
    check_draws("gamma example data", counts, gibbs, s.spec, s.iter - 1)
    print(f"gamma example data: fit(96x64, rank 4, seed 1) ran "
          f"{s.iter - 1} iterations ({s.tracker.why}); matched cosine min "
          f"{cos.min():.4f} mean {cos.mean():.4f}; {(s.iter - 1) / wall:.1f}"
          f" it/s for the whole fit on {card}", flush=True)

    # Poisson-Gamma at config 4's shape, as phase 7's conjugate run
    M, P_true = synthetic(96, GAMMA_FIT_G, 8, seed=2)
    reset_counts(FS, S, AL)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = bt.fit(M, 8, prior="gamma", device="cuda", output_dir=None,
               convergence_control=bt.ConvergenceControl(**GAMMA_FIT_CC),
               seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = s.iter - 1
    counts = launch_counters(FS, S, AL)
    alloc_n = counts["allocation"]
    check(alloc_n == steps + 1 and ported(counts) == alloc_n,
          f"gamma fit: allocation launches {alloc_n} for {steps} "
          "iterations + 1, or another kernel ran")
    draws = check_draws("gamma fit", counts, gibbs, s.spec, steps)
    rows = np.concatenate(s._metric_rows)
    check(np.isfinite(rows).all(), "gamma fit: metrics are not finite")
    cos = matched_cosines(np.asarray(s.MAP["P"]), P_true)
    check(cos.min() >= 0.9, f"gamma fit: matched cosine too low: {cos}")
    (loop,), state, _ = loop_rates(torch, gibbs, s, 100)
    n_prof = 20
    dev_us, pwall, events, n_waits, wait_us = profile_loop(
        torch, gibbs, s, state, n_prof)
    # the ops one step issues, and those of its prior update
    consts = gibbs.m.metric_constants("poisson", s.data)
    hp = s.hyperprior_params
    step_ops, step_reads = count_ops(torch, lambda: gibbs.gibbs_step(
        s.spec, s.data, hp, state, 1.0, False, consts))
    prior_ops, _ = count_ops(torch, lambda: gibbs.U.sample_prior_params(
        s.spec, hp, state["params"], state["prior"],
        gibbs.streams_of(state)))
    print(f"gamma fit(96x{GAMMA_FIT_G}, rank 8) ran {steps} iterations "
          f"({s.tracker.why}); allocation launches {alloc_n} (= iterations "
          f"+ 1), draw kernel {draws}, no other kernel; matched cosine min "
          f"{cos.min():.4f} mean "
          f"{cos.mean():.4f}; {steps / wall:.1f} it/s for the whole fit "
          f"({wall:.2f} s), {loop:.1f} it/s in the chunk loop alone (100 "
          f"iterations) on {card}", flush=True)
    print(f"gamma loop: profiled {n_prof} iterations: " + (
        f"device busy {dev_us / 1e3:.2f} ms of {pwall * 1e3:.1f} ms wall "
        f"(share {dev_us / 1e6 / pwall:.3f}), " if dev_us > 0 else
        "torch.profiler recorded no device time (busy share not "
        "measured), ") + f"{events / n_prof:.1f} device events and "
        f"{n_waits / n_prof:.1f} host waits per iteration "
        f"({wait_us / 1e3:.2f} ms of host time); one step issues "
        f"{step_ops} tensor ops ({step_reads} host reads), its prior "
        f"update {prior_ops} (dispatch count) on {card}", flush=True)

    # SBFI over ranks 1..20 at config 3's shape
    M, _ = synthetic(96, GAMMA_SBFI_G, 8, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = bt.fit(M, range(1, RANK_MAX + 1), prior="gamma", device="cuda",
               output_dir=None, prop_temp=0.3, seed=0,
               convergence_control=bt.ConvergenceControl(**GAMMA_SBFI_CC))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(np.isfinite(np.concatenate(s._metric_rows)).all(),
          "gamma SBFI: metrics are not finite")
    print(f"gamma SBFI: fit(96x{GAMMA_SBFI_G}, ranks 1..{RANK_MAX}) ran "
          f"{s.iter - 1} iterations ({s.tracker.why}); learned rank "
          f"{int(np.asarray(s.MAP['A_full']).sum())} (true 8); "
          f"{(s.iter - 1) / wall:.1f} it/s for the whole fit on {card}",
          flush=True)

    # an 8-chain Poisson-Gamma ensemble at config 4's shape
    M, P_true = synthetic(96, GAMMA_FIT_G, 8, seed=2)
    reset_counts(FS, S, AL)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ens = bt.ChainEnsemble(
        M, 8, n_chains=GAMMA_ENS_CHAINS, prior="gamma", MH=False,
        convergence_control=bt.ConvergenceControl(**GAMMA_ENS_CC), seed=0,
        periodic_save=False, device="cuda")
    ens.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counters(FS, S, AL)
    report_run(torch, CH, ens, "ensemble gamma", wall, launches,
               {"allocation": (1, 1)}, P_true, card)
    ens_alloc_launches = launches["allocation"]
    chunk_loop(torch, CH, ens, GAMMA_ENS_CHAINS, 20, "ensemble gamma", card)

    # fit(rank_method="BIC") with save_all_samples: one masked ensemble
    M, _ = synthetic(96, GAMMA_SBFI_G, 8, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = bt.fit(M, range(1, RANK_MAX + 1), rank_method="BIC",
                 prior="gamma", device="cuda", output_dir=None, seed=0,
                 save_all_samples=True,
                 convergence_control=bt.ConvergenceControl(**GAMMA_BIC_CC))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    win = res["sampler"]
    check(res["ensemble"]._archive is not None,
          "gamma BIC: save_all_samples did not reach the ensemble")
    lp = float(win.get_logpost())
    check(np.isfinite(lp), f"gamma BIC: the winner's get_logpost() is {lp}")
    check(win.samples["P"].shape[0] > 0, "gamma BIC: the winner's samples")
    print(f"gamma BIC: fit(96x{GAMMA_SBFI_G}, ranks 1..{RANK_MAX}, BIC, "
          f"save_all_samples=True) ran {res['ensemble'].iter - 1} "
          f"iterations as one ensemble in {wall:.2f} s; best_rank "
          f"{res['best_rank']} (true 8); the winner's get_logpost() {lp:.1f}"
          f" on {card}", flush=True)
    return alloc[GAMMA_ALLOC_CHAINS[-1]], ens_alloc_launches


def recorded_stream_run(torch, bt, FS, S, AL, M, record):
    """One 96x10k SBFI stream ensemble run with ``record`` and
    save_all_samples: (ensemble, seconds, launches, peak device bytes)."""
    reset_counts(FS, S, AL)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ens = bt.ChainEnsemble(
        M, range(1, ENS_MAX_RANK + 1), n_chains=ENS_CHAINS,
        convergence_control=bt.ConvergenceControl(**REC_CC),
        post_warmup=REC_POST, seed=0, stream_sweeps=True,
        save_all_samples=True, record_history=record, periodic_save=False,
        device="cuda", verbosity=0)
    ens.run()
    torch.cuda.synchronize()
    from bayesnmf_tpu_torch.models import gibbs

    launches = launch_counters(FS, S, AL)
    launches["rng_want"] = draw_launches(gibbs, ens.spec, ens.iter - 1,
                                         init=True)
    return (ens, time.perf_counter() - t0, launches,
            torch.cuda.max_memory_allocated())


def run_recording(torch, bt, FS, S, AL, gibbs, card, slice_rate):
    """Phase 10 (d): record_history='full' on the 96x10k SBFI stream
    ensemble beside 'basic' (launches per iteration unchanged, acceptance
    entries in [0, 1], peak device memory, chain-it/s), and on config 2's
    fused fit beside phase 4's rate; that fit's final checkpoint resumes
    bit-exactly, archive included."""
    M, _ = synthetic(ENS_K, ENS_G, ENS_TRUE_RANK)
    N = ENS_MAX_RANK
    runs = {r: recorded_stream_run(torch, bt, FS, S, AL, M, r)
            for r in ("basic", "full")}
    for rec, (ens, wall, launches, peak) in runs.items():
        steps = ens.iter - 1
        for k, n in (("_run", 3 * N), ("stream_acol_update", N),
                     ("stream_metrics_row", 1)):
            check(launches[k] == n * steps, f"recording {rec}: {k} "
                  f"launches {launches[k]} != {n} x {steps} iterations")
        check(launches["fused"] == launches["allocation"] == 0,
              f"recording {rec}: another kernel ran")
        check(launches["rng"] == launches["rng_want"],
              f"recording {rec}: draw kernel launches {launches['rng']} != "
              f"{launches['rng_want']}")
        if rec == "full":
            for ch in ens._archive:
                for k in ("acc_P", "acc_E"):
                    check(np.all((ch[k] >= 0) & (ch[k] <= 1)),
                          f"recording: an {k} entry outside [0, 1]")
            h = ens.chain(0).samples
            check({"Mu_p", "Sigmasq_e", "acc_P", "acc_E"} <= set(h),
                  "recording: a chain's samples lack the full record")
        print(f"recording {rec}: {ENS_K}x{ENS_G} SBFI stream ensemble, "
              f"{ENS_CHAINS} chains, save_all_samples=True: {steps} "
              f"iterations in {wall:.2f} s, {ens.throughput():.1f} "
              f"chain-it/s over run(); launches _run {launches['_run']}, "
              f"stream_acol_update {launches['stream_acol_update']}, "
              f"stream_metrics_row {launches['stream_metrics_row']} (= 3N, "
              f"N, 1 per iteration); peak device memory "
              f"{peak / 2 ** 30:.2f} GiB; archive {len(ens._archive)} chunks "
              f"on the host on {card}", flush=True)
    del runs

    # config 2's fused fit with the full record, beside phase 4's rate
    rng = np.random.default_rng(0)
    P_true = rng.dirichlet(np.ones(96) * 0.3, 8).T
    M = rng.poisson(P_true @ rng.gamma(2.0, 500.0, (8, 500))).astype(
        np.float32)
    cc = bt.ConvergenceControl(MAP_over=500, MAP_every=100, miniters=500,
                               maxiters=2000, Ninarow_nochange=3,
                               Ninarow_nobest=5)
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts(FS, S, AL)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = bt.fit(M, 8, device="cuda", output_dir=os.path.join(tmp, "fit"),
                   convergence_control=cc, post_warmup=500, seed=0,
                   record_history="full")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = s.iter - 1
        check(FS.fused_gibbs_sweeps.launches == steps,
              "recorded fused fit: launches")
        check_draws("recorded fused fit", launch_counters(FS, S, AL), gibbs,
                    s.spec, steps)
        h = s.samples
        check(h["acc_P"].shape == (s.iter, 96, 8) and
              np.all((h["acc_E"] >= 0) & (h["acc_E"] <= 1)),
              "recorded fused fit: the acceptance records")
        resumed = bt.GibbsSampler.load(os.path.join(s.output_dir,
                                                    "sampler.ckpt"))
        check(len(resumed._archive) == len(s._archive) and all(
            np.array_equal(a[k], b[k]) for a, b in zip(resumed._archive,
                                                       s._archive)
            for k in ("P", "E", "A", "acc_P", "acc_E")) and all(
            np.array_equal(a["prior"][k], b["prior"][k])
            for a, b in zip(resumed._archive, s._archive)
            for k in b["prior"]), "recorded fused fit: the resumed archive")
        resume_check(torch, bt, gibbs, s, "recorded fused fit")
    print(f"recorded fused fit(96x500, rank 8, record_history='full') ran "
          f"{steps} iterations: {steps / wall:.1f} it/s for the whole fit "
          f"({wall:.2f} s) against phase 4's "
          + (f"{slice_rate:.1f} (basic) in this call"
             if slice_rate is not None else "(not run in this call)")
          + f"; archive {len(s._archive)} chunks, resumed with it "
          f"on {card}", flush=True)


# ---------------------------------------------------------------------------
# phase 11: distributed runs
# ---------------------------------------------------------------------------

MESH_K, MESH_N, MESH_G = 96, 8, 2780     # config 4's shape
MESH_EAGER_G, MESH_STEPS, MESH_EAGER_STEPS = 500, 20, 10
MESH_CHAINS, MESH_CHUNK = 8, 10
MESH_WORKER_TIMEOUT = 240
MESH_SEEDS = {"exponential": 11, "gamma": 12, "eager": 13, "ensemble": 14,
              "resume": 15, "reject": 16, "draws": 17}
# the conjugate Poisson-Exponential loop that runs through the gamma draws'
# rejection loop on the 1x2 mesh
MESH_LOOP_STEPS = 50


def mesh_data(G, seed=0):
    return synthetic(MESH_K, G, MESH_N, seed)[0]


def mesh_sampler(bt, case, mesh=None, device="cuda"):
    """The sampler of a phase 11 case, on ``mesh`` or in one process."""
    if case == "eager":
        return bt.GibbsSampler(mesh_data(MESH_EAGER_G), MESH_N, MH=True,
                               prior="truncnormal", fused_sweeps=False,
                               seed=MESH_SEEDS[case], mesh=mesh,
                               device=device)
    G = MESH_EAGER_G if case == "resume" else MESH_G
    prior = "gamma" if case == "gamma" else "exponential"
    return bt.GibbsSampler(mesh_data(G), MESH_N, MH=False, prior=prior,
                           seed=MESH_SEEDS[case], mesh=mesh, device=device)


def mesh_ensemble(bt, mesh=None):
    return bt.ChainEnsemble(mesh_data(MESH_G), MESH_N, n_chains=MESH_CHAINS,
                            MH=False, prior="exponential",
                            seed=MESH_SEEDS["ensemble"], mesh=mesh,
                            device="cuda")


def reject_operands(torch, side, device="cuda"):
    """A gamma draw of 2 chains on one side of config 4's shape (P (2, 96,
    8), E (2, 8, 2780)) and its pre-drawn uniforms, chain-major, whose four
    unrolled rounds reject in the last quarter of the last axis (on the E
    side columns of the second rank's block of a 1x2 mesh): those entries
    go to the exact rejection loop."""
    C = 2
    shape = (C, MESH_K, MESH_N) if side == "P" else (C, MESH_N, MESH_G)
    rng = np.random.default_rng(MESH_SEEDS["reject"])
    f = np.float32
    a = rng.uniform(0.5, 3.5, shape).astype(f)
    b = rng.uniform(0.5, 1.5, shape).astype(f)
    u = rng.uniform(1e-6, 1.0, (C, 9) + shape[1:]).astype(f)
    u[:, 0:8:2, ..., shape[-1] - max(1, shape[-1] // 4):] = 1.2e-38
    return tuple(torch.from_numpy(x).to(device) for x in (a, b, u))


def reject_streams(mesh=None):
    """The streams of ``reject_operands``' two chains (a rank's block of
    them on ``mesh``)."""
    whole = ChainStreams(MESH_SEEDS["reject"], np.arange(2), device="cuda")
    return whole if mesh is None else whole.block(mesh, MESH_G)


def reject_draw(torch, D, gen, side, g0=0, g1=None):
    """The gamma draw of ``reject_operands`` from the streams ``gen`` (a
    rank's block of them, with its columns [g0, g1) of the E side): the
    draw and the rejection rounds it ran."""
    a, b, u = reject_operands(torch, side)
    if side == "E" and g1 is not None:
        a, b, u = (x[..., g0:g1].contiguous() for x in (a, b, u))
    D.gamma.rounds = 0
    x = D.gamma(gen, a, b, u=u, chain_axis=True, g=side == "E",
                site="gamma_" + side)
    return x, D.gamma.rounds


def fake_mesh(n_chain, n_g, ci=0, gi=0):
    """A rank's place in a mesh without its processes: what the blocks of
    the streams need."""
    import types

    return types.SimpleNamespace(n_chain=n_chain, n_g=n_g, ci=ci, gi=gi,
                                 size=n_chain * n_g)


def mesh_draws(torch, gen, C, G):
    """Phase 14 (d): a uniform draw with a G axis, a normal one without and
    a flat draw of parts, at config 4's K and N, from ``gen`` (``C`` chains
    and ``G`` columns: a rank's block, or the whole)."""
    K, N = MESH_K, MESH_N
    return {"g": gen.uniform("sweep_E", (C, 3, N, G), g=True),
            "normal": gen.normal("hyper_z", (C, 2, K, N)),
            "flat": gen.flat("slice", (C, 18), [(1, K * N, False),
                                                (N, G, True)])}


def mesh_steps(torch, gibbs, s, n):
    """``n`` steps from the sampler's state, past warmup: (records,
    seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.state, rec = gibbs.run_chunk(s.spec, s.data, s.hyperprior_params,
                                   s.state, np.ones(n, np.float32), False)
    torch.cuda.synchronize()
    return rec, time.perf_counter() - t0


def mesh_worker(args) -> int:
    """One rank of phase 11 (c)-(e): ``--mesh-worker rank world port
    n_chain n_g out_dir``. Writes its results to out_dir/rank<r>.npz."""
    import torch
    import torch.distributed as dist

    rank, world, port, n_chain, n_g = (int(a) for a in args[:5])
    out_dir = args[5]
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import bayesnmf_tpu_torch as bt
    from bayesnmf_tpu_torch.models import gibbs
    from bayesnmf_tpu_torch.ops import _build
    from bayesnmf_tpu_torch.ops import allocation as AL
    from bayesnmf_tpu_torch.ops import distributions as D
    from bayesnmf_tpu_torch.ops import rng as R
    from bayesnmf_tpu_torch.parallel import mesh as M
    from bayesnmf_tpu_torch.parallel import multihost as MH

    _build.load_library()   # built by the parent: loaded, not rebuilt
    MH.initialize(f"127.0.0.1:{port}", world, rank)
    check(dist.get_backend() == "gloo",
          "two ranks on one card must run over gloo")
    mesh = M.make_mesh(n_chain, n_g, device="cuda")
    n_reduce = [0]
    all_reduce = dist.all_reduce

    def counted(*a, **k):
        n_reduce[0] += 1
        return all_reduce(*a, **k)

    dist.all_reduce = counted
    out = {}
    if (n_chain, n_g) == (1, 2):
        for case in ("exponential", "gamma", "eager"):
            n = MESH_EAGER_STEPS if case == "eager" else MESH_STEPS
            if case != "eager":
                mesh_steps(torch, gibbs, mesh_sampler(bt, case, mesh), 2)
            # the timed run: n steps in one chunk
            s = mesh_sampler(bt, case, mesh)
            AL.allocate_counts.launches = 0
            R.philox_fill.launches = 0
            D.gamma.rounds = 0
            n_reduce[0] = 0
            rec, secs = mesh_steps(torch, gibbs, s, n)
            out[f"{case}/launches"] = AL.allocate_counts.launches
            out[f"{case}/draws"] = R.philox_fill.launches
            out[f"{case}/draws_want"] = draw_launches(gibbs, s.spec, n)
            out[f"{case}/all_reduces"] = n_reduce[0]
            out[f"{case}/seconds"] = secs
            out[f"{case}/metrics"] = rec["metrics"].cpu().numpy()
            out[f"{case}/P_local"] = rec["P"].cpu().numpy()
            # the same run step by step: each step's whole state and the
            # streams before it (alike on every rank)
            s = mesh_sampler(bt, case, mesh)
            for i in range(n + 1):
                save_whole_state(out, f"{case}/step{i}/", s.state, mesh,
                                 s.spec, chains=False)
                if i < n:
                    s.state, _ = gibbs.run_chunk(
                        s.spec, s.data, s.hyperprior_params, s.state,
                        np.ones(1, np.float32), False)
        # gamma draws that take the rejection loop through the mesh's
        # streams, this rank's block; then the conjugate loop long enough
        # to take it on its own
        g0, g1 = M.g_block(MESH_G, mesh)
        for side in ("P", "E"):
            x, rounds = reject_draw(torch, D, reject_streams(mesh), side, g0,
                                    g1)
            out[f"reject/{side}"] = x.cpu().numpy()
            out[f"reject/{side}/rounds"] = rounds
        s = mesh_sampler(bt, "exponential", mesh)
        AL.allocate_counts.launches = 0
        R.philox_fill.launches = 0
        D.gamma.rounds = 0
        rec, secs = mesh_steps(torch, gibbs, s, MESH_LOOP_STEPS)
        out["loop/rounds"] = D.gamma.rounds
        out["loop/draws"] = R.philox_fill.launches
        out["loop/draws_want"] = draw_launches(gibbs, s.spec,
                                               MESH_LOOP_STEPS)
        out["loop/launches"] = AL.allocate_counts.launches
        # phase 14 (d): this rank's block of three draws, and the elements
        # its draws computed
        blk = ChainStreams(MESH_SEEDS["draws"], np.arange(MESH_CHAINS), 5,
                           device="cuda").block(mesh, MESH_G)
        fill, elements = R.philox_fill, [0]

        @functools.wraps(fill)
        def counted_fill(uids, key, word1, it, n, index=None, normal=False):
            elements[0] += uids.numel() * n
            return fill(uids, key, word1, it, n, index, normal)

        R.philox_fill = counted_fill
        try:
            draws = mesh_draws(torch, blk, MESH_CHAINS, g1 - g0)
        finally:
            R.philox_fill = fill
        for k, v in draws.items():
            out[f"draws/{k}"] = v.cpu().numpy()
        out["draws/elements"] = elements[0]
        out["loop/seconds"] = secs
        out["loop/metrics"] = rec["metrics"].cpu().numpy()
        # (d) save on the mesh, then continue as the parent will
        s = mesh_sampler(bt, "resume", mesh)
        s._run_chunk(10, False)
        s.save_object(os.path.join(out_dir, "mesh.ckpt"))
        s._run_chunk(5, False)
        out["resume/metrics"] = s.sample_metrics.to_numpy()
    else:
        from bayesnmf_tpu_torch.parallel import chains as CH

        e = mesh_ensemble(bt, mesh)
        AL.allocate_counts.launches = 0
        e._run_chunk(MESH_CHUNK)
        out["ensemble/launches"] = AL.allocate_counts.launches
        out["ensemble/metrics"] = e._metrics_all()
        # the same chunk step by step, each step's whole states saved
        e = mesh_ensemble(bt, mesh)
        for i in range(MESH_CHUNK + 1):
            save_whole_state(out, f"ensemble/step{i}/", e.states, mesh,
                             e.spec, chains=True)
            if i < MESH_CHUNK:
                e.states, _ = CH.run_chunk_chains(
                    e.spec, e.data, e.hp, e.states, np.ones(1, np.float32),
                    e._accept_all_vec())
    out["imports_jax"] = ("jax" in sys.modules
                          or "bayesnmf_tpu" in sys.modules)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def save_whole_state(out, prefix, state, mesh, spec, chains):
    """A mesh state gathered whole into ``out`` under ``prefix`` (params/,
    prior/, acc_P, acc_E), with its streams' record (seed, uids) and
    iteration (alike on every rank)."""
    from bayesnmf_tpu_torch.parallel import mesh as M

    layout = M.state_layout(spec, chains=chains)
    whole = M.gather({k: state[k] for k in layout}, layout, mesh, spec.G)
    for grp, v in whole.items():
        if isinstance(v, dict):
            for k, x in v.items():
                out[f"{prefix}{grp}/{k}"] = x.cpu().numpy()
        else:
            out[prefix + grp] = v.cpu().numpy()
    rec = state["gen"].state()
    out[prefix + "seed"] = rec["seed"]
    out[prefix + "uids"] = rec["uids"]
    out[prefix + "iter"] = state["iter"]


def spawn_mesh(n_chain, n_g, out_dir):
    """Run phase 11's worker on n_chain x n_g processes; every rank's npz.
    A rank that fails or outlives MESH_WORKER_TIMEOUT fails the script,
    with every rank's output printed."""
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    world = n_chain * n_g
    here = os.path.abspath(__file__)
    procs = [subprocess.Popen(
        [sys.executable, here, "--mesh-worker", str(r), str(world),
         str(port), str(n_chain), str(n_g), out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=os.path.dirname(here)) for r in range(world)]
    logs, failed = [], False
    for r, p in enumerate(procs):
        try:
            log, _ = p.communicate(timeout=MESH_WORKER_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            log, _ = p.communicate()
            log += f"\n(killed after {MESH_WORKER_TIMEOUT} s)"
        failed |= p.returncode != 0
        logs.append(f"--- mesh rank {r} (rc {p.returncode}) ---\n{log}")
    if failed:
        print("\n".join(logs), flush=True)
    check(not failed, f"a {n_chain}x{n_g} mesh worker failed")
    ranks = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
             for r in range(world)]
    check(not any(bool(r["imports_jax"]) for r in ranks),
          "a mesh worker imported jax or the JAX package")
    return ranks


def compare_shard_allocation(torch, AL, card):
    """Phase 11 (a): the allocation kernel on the two G shards of the
    96x2780 matrix. Returns the kernel row's numbers."""
    K, N, G, C = MESH_K, MESH_N, MESH_G, 1
    t = to_card(torch, alloc_inputs(K, N, G, C, 1101))
    # a batch of one chain, as the conjugate step hands it over
    M, P, A, E = t["M"], t["P"][None], t["A"][None], t["E"][None]
    halves = ((0, G // 2), (G // 2, G))

    def shard(g0, g1):
        return (M[:, g0:g1].contiguous(), P, A, E[..., g0:g1].contiguous())

    u = uniform_planes(torch, AL, C, N, K, G, 5)
    err = 0.0
    for g0, g1 in halves:
        args = shard(g0, g1)
        uu = u[..., g0:g1].contiguous()
        got = AL.allocate_counts(*args, u=uu, g0=g0, G_total=G)
        want = AL.allocate_counts_reference(*args, uu)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"allocation shard [{g0}, {g1}) differs from its plain "
              "version on the slice of the planes")
    key = ChainStreams(20261017, [0], 3).subkey("alloc")
    uids = torch.zeros(1, dtype=torch.int64, device="cuda")
    zg, zk = AL.allocate_counts(M, P, A, E, key=key, uids=uids)
    parts = []
    for g0, g1 in halves:
        args = shard(g0, g1)
        pg, pk = AL.allocate_counts(*args, key=key, uids=uids, g0=g0,
                                    G_total=G)
        plain = AL.allocate_counts_reference(*args, AL.philox_planes(
            key, uids, N, K, g1 - g0, g0=g0, G_total=G))
        err = max(err, max(float((a - b).abs().max())
                           for a, b in zip((pg, pk), plain)))
        check(err == 0.0, f"allocation shard [{g0}, {g1}) in Philox mode "
              "differs from its plain version")
        parts.append((pg, pk))
    check(torch.equal(torch.cat([p[1] for p in parts], -1), zk),
          "the shards' Zsum_k side by side differ from the whole kernel's")
    check(torch.equal(parts[0][0] + parts[1][0], zg),
          "the shards' Zsum_g do not add to the whole kernel's")
    args = shard(0, G // 2)

    def kernel():
        return AL.allocate_counts(*args, key=key, uids=uids, g0=0,
                                  G_total=G)

    planes = AL.philox_planes(key, uids, N, K, G // 2, g0=0, G_total=G)

    def plain():
        return AL.allocate_counts_reference(*args, planes)

    ms, wrapped = kernel_ms(torch, kernel, 50)
    plain_ms = time_ms(torch, plain, 3)
    splits = count_splits(AL, torch, plain)
    b_ms, b_by = alloc_bound(K, N, G // 2, C, splits, planes=False)
    print(f"phase 11 allocation on a G shard (K,N,G)=({K},{N},{G // 2}) of "
          f"{G}: planes and Philox modes equal to the plain version, the two "
          "shards equal to the whole kernel (Zsum_k side by side, Zsum_g "
          f"added); kernel {ms:.4f} ms on the device ({wrapped:.4f} ms per "
          f"call through the wrapper), plain {plain_ms:.4f} ms, bound "
          f"{b_ms:.6f} ms ({b_by}), on {card}", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def world_one_mesh(torch, bt, card):
    """Phase 11 (b): a conjugate fit on a world-1 NCCL mesh, bit-identical
    to the fit without a mesh."""
    import socket

    import torch.distributed as dist
    from bayesnmf_tpu_torch.ops import distributions as D
    from bayesnmf_tpu_torch.parallel import multihost as MH

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    MH.initialize(f"127.0.0.1:{port}", 1, 0)
    try:
        check(dist.get_backend() == "nccl", "a world-1 mesh on the card "
              "should pick NCCL")
        cc = bt.ConvergenceControl(MAP_over=25, MAP_every=25, miniters=50,
                                   maxiters=50)
        kw = dict(MH=False, prior="exponential", seed=21, device="cuda",
                  convergence_control=cc)
        data = mesh_data(MESH_G)
        t0 = time.perf_counter()
        b = bt.GibbsSampler(data, MESH_N, **kw).run_gibbs_sampler()
        t1 = time.perf_counter()
        a = bt.GibbsSampler(data, MESH_N, mesh=MH.global_mesh(1, 1),
                            **kw).run_gibbs_sampler()
        t2 = time.perf_counter()
        # a gamma draw through the mesh's block of the streams that takes
        # the rejection loop, against the one-process draw
        rounds = {}
        for side in ("P", "E"):
            got, rounds[side] = reject_draw(
                torch, D, reject_streams(MH.global_mesh(1, 1)), side)
            want, one = reject_draw(torch, D, reject_streams(), side)
            check(rounds[side] > 0 and rounds[side] == one,
                  f"world-1 mesh: the {side} draw ran {rounds[side]} "
                  f"rejection rounds, one process {one}")
            check(torch.equal(got, want) and bool(torch.isfinite(got).all()),
                  f"world-1 mesh: the {side} draw through the rejection loop "
                  "differs from the one-process draw")
    finally:
        dist.destroy_process_group()
    check(np.array_equal(a.sample_metrics.to_numpy(),
                         b.sample_metrics.to_numpy()),
          "the world-1 mesh fit's metrics differ from the fit without one")
    check(all(torch.equal(a.state["params"][k], b.state["params"][k])
              for k in b.state["params"]),
          "the world-1 mesh fit's state differs from the fit without one")
    print(f"phase 11 world-1 NCCL mesh: conjugate Poisson-Exponential fit "
          f"at {MESH_K}x{MESH_G}, rank {MESH_N}, {a.iter} iterations, "
          f"bit-identical to the fit without a mesh ({t2 - t1:.2f} s "
          f"against {t1 - t0:.2f} s, which ran first); gamma draws whose "
          f"unrolled rounds reject in a quarter of the entries: P (2,"
          f"{MESH_K},{MESH_N}) {rounds['P']} and E (2,{MESH_N},{MESH_G}) "
          f"{rounds['E']} rejection rounds through the mesh's streams, "
          f"equal to the one-process draws, on {card}", flush=True)


def mesh_state(torch, saved, case, i):
    """Step ``i``'s whole state of a mesh worker's run, on the card, with
    its streams."""
    from bayesnmf_tpu_torch.models.state import state_from_numpy

    pre = f"{case}/step{i}/"
    d = {"params": {}, "prior": {}, "iter": saved[pre + "iter"]}
    for key, v in saved.items():
        parts = key[len(pre):].split("/")
        if not key.startswith(pre):
            continue
        if len(parts) == 2:
            d[parts[0]][parts[1]] = v
        elif parts[0] in ("acc_P", "acc_E"):
            d[parts[0]] = v
    st = state_from_numpy(d, "cuda")
    st["gen"] = ChainStreams(int(saved[pre + "seed"]), saved[pre + "uids"],
                             int(d["iter"]), device="cuda")
    return st


def sum_rel(a, b, data):
    """Max |a - b| of loglik or log-posterior values over the scale of the
    sums they cancel: max(|b|, sum(M log M)), M floored at 1e-6 (as
    tests/test_torch_multiproc.py and tests/test_torch_chains.py hold the
    KL and the loglik)."""
    M = np.maximum(np.asarray(data, np.float64), 1e-6)
    scale = float(np.sum(M * np.log(M)))
    return float(np.max(np.abs(np.asarray(a, np.float64) - b)
                        / np.maximum(np.abs(b), scale)))


def rel(a, b):
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def run_mesh(torch, bt, AL, gibbs, card):
    """Phase 11. Returns (the shard allocation's kernel row numbers, the
    allocation's launches on the 1x2 Poisson-Exponential run)."""
    shard = compare_shard_allocation(torch, AL, card)
    world_one_mesh(torch, bt, card)
    out_dir = tempfile.mkdtemp(prefix="bayesnmf_mesh_")
    t0 = time.perf_counter()
    g_ranks = spawn_mesh(1, 2, out_dir)
    c_ranks = spawn_mesh(2, 1, out_dir)
    print(f"phase 11 workers: 1x2 and 2x1 meshes on the one card over gloo, "
          f"{time.perf_counter() - t0:.1f} s with start-up", flush=True)
    r0 = g_ranks[0]
    ll, lp = gibbs.METRIC_NAMES.index("loglikelihood"), \
        gibbs.METRIC_NAMES.index("logposterior")
    rates = {}
    for case in ("exponential", "gamma", "eager"):
        n = MESH_EAGER_STEPS if case == "eager" else MESH_STEPS
        for r in g_ranks:
            check(np.array_equal(r[f"{case}/P_local"], r0[f"{case}/P_local"]),
                  f"{case}: P differs between the ranks of the g group")
        # free running: the one-process run of the same seed
        s = mesh_sampler(bt, case)
        if case != "eager":
            mesh_steps(torch, gibbs, mesh_sampler(bt, case), 2)
        rec, secs = mesh_steps(torch, gibbs, s, n)
        met = rec["metrics"].cpu().numpy()
        got = r0[f"{case}/metrics"]
        free = max(rel(got[:, ll], met[:, ll]), rel(got[:, lp], met[:, lp]))
        check(free <= 1e-3, f"{case}: the free-running 1x2 chain's loglik "
              f"moved {free:.2e} from the one-process chain's")
        # resynced: each one-process step from the mesh's state and
        # streams before it, against the mesh's next state
        worst, moved_n, moved_tot, diff_n, diff_tot = 0.0, 0, 0, 0, 0
        first_diff = None
        for i in range(n):
            st = mesh_state(torch, r0, case, i)
            nxt, one = gibbs.run_chunk(s.spec, s.data, s.hyperprior_params,
                                       st, np.ones(1, np.float32), False)
            m1 = one["metrics"][0].cpu().numpy()
            worst = max(worst, sum_rel(got[i, [ll, lp]], m1[[ll, lp]],
                                       s.data.cpu().numpy()))
            want = {k: v.cpu().numpy() for k, v in nxt["params"].items()}
            if case == "eager":
                for k in ("P", "E"):
                    before = r0[f"{case}/step{i}/params/{k}"]
                    after = r0[f"{case}/step{i + 1}/params/{k}"]
                    moved_n += int(np.sum((after != before)
                                          != (want[k] != before)))
                    moved_tot += before.size
            else:
                d = sum(int(np.sum(r0[f"{case}/step{i + 1}/params/{k}"]
                                   != want[k])) for k in ("Zsum_g", "Zsum_k"))
                diff_n += d
                diff_tot += want["Zsum_g"].size + want["Zsum_k"].size
                if d and first_diff is None:
                    first_diff = i + 1
        check(worst <= 1e-5, f"{case}: a one-process step from the mesh's "
              f"state moved the loglik/logpost {worst:.2e} of the sums' "
              "scale from the mesh's")
        line = (f"phase 11 1x2 {case} ({n} steps): resynced steps (each "
                "one-process step from the mesh's state and streams) "
                f"loglik/logpost max diff {worst:.2e} of the sums' scale "
                "(max(|value|, sum M log M))")
        if case == "eager":
            check(moved_n <= 1e-3 * moved_tot, f"{case}: {moved_n} of "
                  f"{moved_tot} MH decisions differ")
            line += f", MH decisions differing {moved_n} of {moved_tot}"
        else:
            check(diff_n <= 1e-3 * diff_tot, f"{case}: {diff_n} of "
                  f"{diff_tot} latent-count sums differ")
            line += (f", latent-count sums differing {diff_n} of {diff_tot}"
                     f" (first at step {first_diff})")
            check(int(r0[f"{case}/launches"]) == n,
                  f"{case}: the allocation kernel ran "
                  f"{int(r0[f'{case}/launches'])} times on rank 0, not {n}")
        for gi, r in enumerate(g_ranks):
            check(int(r[f"{case}/draws"]) == int(r[f"{case}/draws_want"]),
                  f"{case}: rank {gi} launched the draw kernel "
                  f"{int(r[f'{case}/draws'])} times, not "
                  f"{int(r[f'{case}/draws_want'])}")
            rates[case] = (n / secs, n / float(r0[f"{case}/seconds"]),
                           int(r0[f"{case}/all_reduces"]) / n)
        E_free = rel(r0[f"{case}/step{n}/params/E"],
                     s.state["params"]["E"].cpu().numpy())
        print(line + f"; free running against the one-process chain: "
              f"loglik/logpost max rel diff {free:.2e}, E {E_free:.2e} after "
              f"{n} steps; on {card}", flush=True)

    # the gamma draws through the rejection loop: each rank's block the
    # one-process draw's, each rank running the rounds its own block needs
    # (the done flag is a local test: no rank waits for another's rounds)
    from bayesnmf_tpu_torch.ops import distributions as D
    from bayesnmf_tpu_torch.parallel import mesh as M

    rounds = {}
    for side in ("P", "E"):
        want, one = reject_draw(torch, D, reject_streams(), side)
        want = want.cpu().numpy()
        rounds[side] = [one]
        for gi, r in enumerate(g_ranks):
            g0, g1 = M.split(MESH_G, 2, gi)
            block = want[..., g0:g1] if side == "E" else want
            check(np.array_equal(r[f"reject/{side}"], block),
                  f"1x2 rank {gi}: the {side} gamma draw through the "
                  "rejection loop differs from the one-process draw's block")
            _, own = reject_draw(torch, D, reject_streams(
                fake_mesh(1, 2, gi=gi)), side, g0, g1)
            check(int(r[f"reject/{side}/rounds"]) == own,
                  f"1x2 rank {gi}: {int(r[f'reject/{side}/rounds'])} "
                  f"rejection rounds in the {side} draw, its block alone "
                  f"{own}")
            rounds[side].append(own)
        check(max(rounds[side]) > 0, f"the {side} draw never rejected")
    loop = [int(r["loop/rounds"]) for r in g_ranks]
    for gi, r in enumerate(g_ranks):
        check(int(r["loop/draws"]) == int(r["loop/draws_want"]),
              f"1x2 conjugate loop: rank {gi} launched the draw kernel "
              f"{int(r['loop/draws'])} times, not {int(r['loop/draws_want'])}")
    check(all(np.isfinite(r["loop/metrics"]).all() for r in g_ranks),
          "1x2 conjugate loop: metrics not finite")
    check(all(int(r["loop/launches"]) == MESH_LOOP_STEPS for r in g_ranks),
          "1x2 conjugate loop: the allocation did not run once a step")
    print(f"phase 11 1x2 gamma rejection loop: draws whose unrolled rounds "
          f"reject in a quarter of the entries (E: the second rank's "
          f"columns), rounds (one process, rank 0, rank 1) P {rounds['P']} "
          f"and E {rounds['E']}, each rank's block equal to the one-process "
          "draw's; the "
          f"conjugate Poisson-Exponential loop at {MESH_K}x{MESH_G}, "
          f"{MESH_LOOP_STEPS} steps: {loop[0]} and {loop[1]} rejection "
          f"rounds on ranks 0 and 1, "
          f"{MESH_LOOP_STEPS / float(g_ranks[0]['loop/seconds']):.1f} it/s, "
          f"metrics finite, on {card}", flush=True)

    # 2x1: the chains split, G whole
    from bayesnmf_tpu_torch.parallel import chains as CH

    c0 = c_ranks[0]
    e = mesh_ensemble(bt)
    e._run_chunk(MESH_CHUNK)
    got, want = c0["ensemble/metrics"], e._metrics_all()
    for r in c_ranks:
        check(np.array_equal(r["ensemble/metrics"], got),
              "the 2x1 ensemble's ranks hold different metrics rows")
        check(int(r["ensemble/launches"]) == MESH_CHUNK,
              "a 2x1 ensemble's rank did not launch the allocation once a "
              "step")
    free = max(rel(got[..., ll], want[..., ll]),
               rel(got[..., lp], want[..., lp]))
    check(free <= 1e-3, f"the free-running 2x1 ensemble's loglik moved "
          f"{free:.2e} from the one-process ensemble's")
    worst, diff_n, diff_tot = 0.0, 0, 0
    for i in range(MESH_CHUNK):
        st = mesh_state(torch, c0, "ensemble", i)
        acc = torch.zeros(MESH_CHAINS, dtype=torch.bool, device="cuda")
        nxt, one = CH.run_chunk_chains(e.spec, e.data, e.hp, st,
                                       np.ones(1, np.float32), acc)
        m1 = one["metrics"][:, 0].cpu().numpy()
        worst = max(worst, sum_rel(got[:, i][:, [ll, lp]], m1[:, [ll, lp]],
                                   e._data_np))
        for k in ("Zsum_g", "Zsum_k"):
            w = nxt["params"][k].cpu().numpy()
            diff_n += int(np.sum(
                c0[f"ensemble/step{i + 1}/params/{k}"] != w))
            diff_tot += w.size
    check(worst <= 1e-5, f"a one-process ensemble step from the 2x1 mesh's "
          f"state moved the loglik/logpost {worst:.2e} of the sums' scale")
    check(diff_n <= 1e-3 * diff_tot, f"2x1: {diff_n} of {diff_tot} "
          "latent-count sums differ")
    print(f"phase 11 2x1 conjugate ensemble, {MESH_CHAINS} chains at "
          f"{MESH_K}x{MESH_G}, {MESH_CHUNK} steps: resynced steps loglik/"
          f"logpost max diff {worst:.2e} of the sums' scale, latent-count "
          f"sums differing "
          f"{diff_n} of {diff_tot}; free running max rel diff {free:.2e} "
          f"(4 chains a rank: the card's batched products and sums round "
          f"as for 4 chains, not 8), on {card}", flush=True)

    # (d) the mesh checkpoint in one process, and on the CPU
    path = os.path.join(out_dir, "mesh.ckpt")
    one = bt.GibbsSampler.load(path)
    one._run_chunk(5, False)
    got = r0["resume/metrics"]
    d = rel(got[-5:, ll], one.sample_metrics.to_numpy()[-5:, ll])
    # free running for 5 steps: a count flipped by the sum order parts the
    # two continuations (see the resynced steps above), so the bound is the
    # free-running one
    check(d <= 1e-3, f"the mesh checkpoint continued in one process moved "
          f"{d:.2e} from the mesh's own continuation")
    card_s = bt.GibbsSampler.load(path)
    cpu_s = bt.GibbsSampler.load(path, device="cpu")
    check(all(np.array_equal(cpu_s.state["params"][k].numpy(),
                             v.cpu().numpy())
              for k, v in card_s.state["params"].items()),
          "the card checkpoint's state changed on the CPU")
    check(repr(cpu_s.state["gen"].state()) == repr(
        card_s.state["gen"].state()), "the card checkpoint's streams "
          "changed on the CPU")
    cpu_s._run_chunk(2, False)
    check(np.isfinite(cpu_s.sample_metrics.to_numpy()[:, ll]).all(),
          "the card checkpoint did not continue on the CPU")
    print(f"phase 11 checkpoints: saved on the 1x2 mesh, continued in one "
          f"process (loglik max rel diff {d:.2e} from the mesh's own "
          "continuation); loaded with device='cpu', state and streams "
          f"equal, 2 steps finite, on {card}", flush=True)

    for case, (one_rate, mesh_rate, n_ar) in rates.items():
        print(f"phase 11 loop at {MESH_K}x{MESH_G} conjugate {case}: one "
              f"process {one_rate:.1f} it/s, 1x2 mesh of two processes on "
              f"the one card over gloo {mesh_rate:.1f} it/s, {n_ar:.1f} "
              "all-reduces per iteration (the cost of gloo's host copies "
              f"on one card, not scaling), on {card}", flush=True)
    return (shard, int(sum(int(r["exponential/launches"]) for r in g_ranks)),
            g_ranks)


# ---------------------------------------------------------------------------
# phase 12: Geweke gates on the card
# ---------------------------------------------------------------------------

# the gates of tests/test_torch_geweke.py that run a kernel, with the
# kernels on the card: name -> the launch counters that count one launch
# per step of each chain (the allocation also one per chain's initial
# state; the stream sweeps 3N column launches a step)
GEWEKE_GATES = {
    "fused-truncnormal": ("fused",),
    "bfi-fused": ("fused",),
    "exponential-mh-fused": ("fused",),
    "fused_pe_sweeps": ("fused", "fused_pe"),
    "stream": ("_run", "stream_metrics_row"),
    "conjugate-exponential": ("allocation",),
    "conjugate-gamma": ("allocation",),
    "reference-ratio-fused": ("fused",),
    "reference-hypers-fused": ("fused",),
}
# the production-scale gate (tests/test_geweke.py:261-288): the fused step
# at config 2's shape, fewer chains and steps, |z| < 8
GEWEKE_PROD = dict(gate="fused-truncnormal", shape=(96, 8, 500), chains=16,
                   steps=100, marginal=1024, bound=8.0)
GEWEKE_CHUNK = 8        # chains a worker task runs
GEWEKE_WORKERS = 8
GEWEKE_TIMEOUT = 600
# host-paced gates that run fewer chains than the CPU tests' C = 64 and
# fewer steps than their T = 250, at the same bound, to hold the phase to
# ~2 min: the conjugate steps' gamma draws and slice sampler, the stream
# step's 3N column launches and the rank branch take 10-29 ms a chain-step
# (NVIDIA H100 80GB HBM3, 700 W). The reference kernels' gates keep the
# CPU tests' depth: their |z| must exceed the bound (7.3 for the hypers'
# at that depth).
GEWEKE_CHAINS = {"conjugate-gamma": 16, "conjugate-exponential": 16,
                 "stream": 16, "bfi-fused": 32, "exponential-mh-fused": 32}
GEWEKE_STEPS = {gate: 150 for gate in GEWEKE_GATES
                if not gate.startswith("reference")}
# host cost of a chain-step relative to the fused truncnormal one (chip
# run, 64 chains x 250 steps of each), for spreading the tasks
GEWEKE_COST = {"conjugate-gamma": 14.0, "conjugate-exponential": 7.0,
               "stream": 8.0, "exponential-mh-fused": 4.5, "bfi-fused": 3.5,
               "reference-hypers-fused": 9.5, "fused_pe_sweeps": 0.5}


def geweke_tasks():
    """(gate, first chain, end chain, steps, production) tasks of at most
    GEWEKE_CHUNK chains."""
    import test_torch_geweke as TG

    tasks = []
    for gate in GEWEKE_GATES:
        n = GEWEKE_CHAINS.get(gate, TG.C)
        for c0 in range(0, n, GEWEKE_CHUNK):
            tasks.append((gate, c0, min(c0 + GEWEKE_CHUNK, n),
                          GEWEKE_STEPS.get(gate, TG.T), False))
    for c0 in range(0, GEWEKE_PROD["chains"], GEWEKE_CHUNK):
        tasks.append((GEWEKE_PROD["gate"], c0, min(
            c0 + GEWEKE_CHUNK, GEWEKE_PROD["chains"]), GEWEKE_PROD["steps"],
            True))
    return tasks


def geweke_spec(TG, gate, production):
    return (TG.gate_spec(gate, *GEWEKE_PROD["shape"]) if production
            else TG.gate_spec(gate))


def geweke_worker(args) -> int:
    """One worker of phase 12: ``--geweke-worker out_dir device i0,i1,...``
    runs those tasks of ``geweke_tasks()`` and writes each task's chain
    means, launch counts, plain-version calls and seconds to
    out_dir/geweke<first task>.json."""
    import torch

    out_dir, device = args[0], args[1]
    ids = [int(i) for i in args[2].split(",")]
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [here, os.path.join(here, "tests")]
    import test_torch_geweke as TG
    from bayesnmf_tpu_torch.ops import _build
    from bayesnmf_tpu_torch.ops import allocation as AL
    from bayesnmf_tpu_torch.ops import distributions as D
    from bayesnmf_tpu_torch.ops import fused_sweeps as FS
    from bayesnmf_tpu_torch.ops import stream_sweeps as S

    if device == "cuda":
        _build.load_library()   # built by the parent: loaded, not rebuilt
    tasks = geweke_tasks()
    res = []
    with plain_calls(FS, S, AL) as calls:
        for i in ids:
            gate, c0, c1, steps, prod = tasks[i]
            reset_counts(FS, S, AL)
            for k in calls:
                calls[k] = 0
            t0 = time.perf_counter()
            means = TG.run_successive(gate, geweke_spec(TG, gate, prod),
                                      device=device, n_steps=steps,
                                      chains=range(c0, c1))
            if device == "cuda":
                torch.cuda.synchronize()
            res.append({"task": i, "means": means.tolist(),
                        "launches": launch_counters(FS, S, AL),
                        "rounds": D.gamma.rounds,
                        "plain": dict(calls),
                        "seconds": time.perf_counter() - t0})
    res.append({"imports_jax": "jax" in sys.modules
                or "bayesnmf_tpu" in sys.modules})
    with open(os.path.join(out_dir, f"geweke{ids[0]}.json"), "w") as f:
        json.dump(res, f)
    return 0


def spread(tasks, n):
    """The task ids split over n workers, longest first onto the least
    loaded."""
    cost = [(c1 - c0) * steps * GEWEKE_COST.get(gate, 1.0)
            * (2.0 if prod else 1.0)
            for gate, c0, c1, steps, prod in tasks]
    load, parts = [0.0] * n, [[] for _ in range(n)]
    for i in sorted(range(len(tasks)), key=lambda i: -cost[i]):
        w = load.index(min(load))
        parts[w].append(i)
        load[w] += cost[i]
    return [p for p in parts if p]


def run_geweke(torch, card, device="cuda"):
    """Phase 12: the Geweke gates of tests/test_torch_geweke.py with the
    kernels on the card, C = 64 chains x T = 250 steps each (GEWEKE_CHAINS
    and GEWEKE_STEPS for the host-paced ones) against 4096 prior draws,
    |z| < 6 (the reference kernels' gates max |z| > 6 with the
    JAX signs), and the production-scale fused gate at (96,8,500), 16
    chains x 100 steps against 1024 draws, |z| < 8. The chains run as
    tasks of GEWEKE_CHUNK over GEWEKE_WORKERS processes (each step is
    paced by the host), every task's kernels counted: each gate launched
    its kernels once a step of each chain (the stream columns 3N times),
    the draw kernel its path's draws a step and at each chain's initial
    state and once a rejection round, and never reached a plain version. Every gate's z vector and time is
    printed; any failure fails the phase after all are printed. Returns
    {gate: launches}."""
    import test_torch_geweke as TG
    from bayesnmf_tpu_torch.models import gibbs

    tasks = geweke_tasks()
    out_dir = tempfile.mkdtemp(prefix="bayesnmf_geweke_")
    here = os.path.abspath(__file__)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, here, "--geweke-worker", out_dir, device,
         ",".join(map(str, part))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=os.path.dirname(here))
        for part in spread(tasks, GEWEKE_WORKERS)]
    # the prior draws meanwhile, in this process
    margs = {}
    for gate in GEWEKE_GATES:
        margs[gate] = TG.run_marginal(TG.gate_spec(gate), device=device)
    prod_spec = geweke_spec(TG, GEWEKE_PROD["gate"], True)
    margs["production"] = TG.run_marginal(prod_spec,
                                          n=GEWEKE_PROD["marginal"],
                                          device=device)
    logs, failed = [], False
    for w, p in enumerate(procs):
        try:
            log, _ = p.communicate(timeout=GEWEKE_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            log, _ = p.communicate()
            log += f"\n(killed after {GEWEKE_TIMEOUT} s)"
        failed |= p.returncode != 0
        logs.append(f"--- Geweke worker {w} (rc {p.returncode}) ---\n{log}")
    if failed:
        print("\n".join(logs), flush=True)
    check(not failed, "a Geweke worker failed")
    wall = time.perf_counter() - t0
    done = {}
    for name in os.listdir(out_dir):
        with open(os.path.join(out_dir, name)) as f:
            res = json.load(f)
        check(not res[-1]["imports_jax"],
              "a Geweke worker imported jax or the JAX package")
        for r in res[:-1]:
            done[r["task"]] = r
    check(sorted(done) == list(range(len(tasks))), "Geweke tasks missing")
    errors, launches = [], {}
    K, N = TG.K, TG.N
    for label in list(GEWEKE_GATES) + ["production"]:
        prod = label == "production"
        gate = GEWEKE_PROD["gate"] if prod else label
        ids = [i for i, t in enumerate(tasks) if t[0] == gate and t[4] == prod]
        ids.sort(key=lambda i: tasks[i][1])
        succ = np.concatenate([np.asarray(done[i]["means"]) for i in ids])
        steps = tasks[ids[0]][3]
        z = TG.geweke_z(succ, margs[label])
        secs = sum(done[i]["seconds"] for i in ids)
        count = {k: sum(done[i]["launches"][k] for i in ids)
                 for k in done[ids[0]]["launches"]}
        plain = {k: sum(done[i]["plain"][k] for i in ids)
                 for k in done[ids[0]]["plain"]}
        n_chain = len(succ)
        want = {k: n_chain * steps for k in
                GEWEKE_GATES[gate]}
        if "allocation" in want:
            want["allocation"] += n_chain
        if "_run" in want:
            want["_run"] *= 3 * N
        spec = geweke_spec(TG, gate, prod)
        if gibbs.hyper_launches(spec):
            want["hyper_update"] = (n_chain * steps
                                    * gibbs.hyper_launches(spec))
        want["rng"] = (n_chain * (steps * gibbs.draw_launches(spec)
                                  + gibbs.draw_launches(spec, init=True))
                       + sum(done[i]["rounds"] for i in ids))
        others = {k: v for k, v in count.items() if k not in want and v}
        launched = {k: count[k] for k in want}
        launches[label] = launched
        bound = GEWEKE_PROD["bound"] if prod else TG.Z_BOUND
        if gate in TG.FAILING and not prod:
            ok = (np.abs(z).max() > bound
                  and np.sign(z[0]) == TG.FAILING[gate])
            verdict = (f"max |z| {np.abs(z).max():.2f}, z[0] of sign "
                       f"{int(np.sign(z[0])):+d}: "
                       + (f"fails the gate (> {bound:g}, the JAX sign) as "
                          "the reference kernel should" if ok else
                          f"expected max |z| > {bound:g} with sign "
                          f"{TG.FAILING[gate]:+d}: FAILED"))
        else:
            ok = bool(np.all(np.abs(z) < bound))
            verdict = (f"max |z| {np.abs(z).max():.2f} "
                       + (f"< {bound:g}" if ok else f">= {bound:g}: FAILED"))
        shape = GEWEKE_PROD["shape"] if prod else (TG.K, TG.N, TG.G)
        print(f"phase 12 Geweke {label}"
              + (f" ({gate})" if prod else "")
              + f" at (K,N,G)={shape}: {n_chain} chains x {steps} steps "
              f"against {len(margs[label])} prior draws: z = "
              f"{np.array2string(z, precision=2, separator=', ')}; "
              f"{verdict}; launches {launched}; {secs:.1f} s of worker "
              f"time, on {card}", flush=True)
        if not ok:
            errors.append(f"{label}: z = {z}")
        if device == "cuda":
            if launched != want:
                errors.append(f"{label}: launches {launched}, expected "
                              f"{want}")
            if others:
                errors.append(f"{label}: other kernels launched {others}")
        if any(plain.values()):
            errors.append(f"{label}: plain versions called "
                          f"{ {k: v for k, v in plain.items() if v} }")
    print(f"phase 12 Geweke workers: {len(tasks)} tasks on "
          f"{len(procs)} processes, {wall:.1f} s with start-up, on {card}",
          flush=True)
    check(not errors, "phase 12: " + "; ".join(errors))
    return launches


# ---------------------------------------------------------------------------
# phase 13: the benchmark at short windows
# ---------------------------------------------------------------------------

BENCH_CELLS = {
    "bl2_fit_96x500_k8": dict(maxiters=300, post_warmup=100, MAP_over=100,
                              MAP_every=100, fits=1, warmups=1,
                              loop_iters=100,
                              loop_reps=1, prof_iters=10, kernel_reps=50,
                              layer_reps=2, trace=True),
    "cj_fit_96x2780_k8_expo": dict(maxiters=300, MAP_over=100, MAP_every=50,
                                   fits=1, warmups=1,
                                   loop_iters=50, loop_reps=1,
                                   loop_warmup=10, prof_iters=5,
                                   kernel_reps=20, layer_reps=2, trace=True),
    "ns_ens_8x96x10k_sbfi": dict(maxiters=200, post_warmup=100, MAP_over=100,
                                 MAP_every=100, runs=1, warmups=1,
                                 loop_iters=5,
                                 loop_reps=1, prof_iters=3, kernel_reps=5,
                                 trace=True),
}
BENCH_CONFIGS = {
    1: dict(iters=200, reps=1, baseline_iters=1),
    2: dict(iters=200, reps=1, baseline_iters=1),
    3: dict(iters=100, reps=1, baseline_iters=1),
    4: dict(maxiters=400, miniters=200, post_warmup=200),
    5: dict(iters=5, full_iters=2),
}


def run_bench(card):
    """Phase 13: bench_torch.py's cells and configs on the card at short
    windows; each result must survive JSON, be ``correct`` (finite metrics,
    the launch counts of its path, no plain version, recovery where the
    truth is known) and measure every metric."""
    import bench_torch as BT

    for name, (fn, units) in BT.CELLS.items():
        res = json.loads(json.dumps(fn("cuda", seed=0, **BENCH_CELLS[name])))
        check(res["correct"], f"bench cell {name}: checks {res['checks']}")
        missing = [k for k in units if res["metrics"].get(k) is None]
        check(not missing, f"bench cell {name}: not measured {missing}")
        check(len(res["breakdown"]["top_device_ops"]) > 0,
              f"bench cell {name}: the trace holds no device operation")
        print(f"bench cell {name}: "
              + ", ".join(f"{k} {res['metrics'][k]['value']:.4g} {u}"
                          for k, (u, _) in units.items())
              + f"; iterations {res['iterations']}; on {card}", flush=True)
        print(f"bench cell {name}: idle gaps "
              + json.dumps(res["breakdown"]["idle_gaps"]), flush=True)
    for n, fn in BT.CONFIGS.items():
        row = json.loads(json.dumps(fn("cuda", **BENCH_CONFIGS[n])))
        check(row["correct"], f"bench config {n}: {row}")
        print(f"bench config {n}: " + json.dumps(row), flush=True)


# ---------------------------------------------------------------------------
# phase 14: the chains' counter-based streams
# ---------------------------------------------------------------------------

# the normals' bound: Box-Muller in double on both sides, rounded to float;
# the card's and the CPU's log and cos may differ by an ulp of a double,
# which moves a float at most one ulp (2.4e-7 at |z| < 4, 4.8e-7 below 8)
NORMAL_ATOL = 1e-6
RNG_CHAINS, RNG_SEED = ENS_CHAINS, 41
# the compaction test of tests/test_torch_ensemble.py, on the card
COMPACT_CC = dict(MAP_over=40, MAP_every=20, miniters=60, maxiters=400,
                  Ninarow_nochange=2, Ninarow_nobest=4, tol=1e-5)
COMPACT_PATHS = {"fused": dict(fused_sweeps=True),
                 "stream": dict(stream_sweeps=True)}


def captured_fills(torch, R, fn):
    """The arguments of every launch of the draw kernel ``fn()`` makes."""
    calls, fill = [], R.philox_fill

    # the spy carries the wrapper's launch count, which the launcher reaches
    # through the module's name while it is replaced
    @functools.wraps(fill)
    def spy(uids, key, word1, it, n, index=None, normal=False):
        calls.append((uids, key, word1, it, n, index, normal))
        return fill(uids, key, word1, it, n, index, normal)

    R.philox_fill = spy
    try:
        fn()
    finally:
        R.philox_fill = fill
    return calls


def compare_draws(torch, R, calls, label, card):
    """Each captured draw on the card against its plain version on the
    card and on the CPU: uniforms bit for bit, normals within NORMAL_ATOL.
    Returns {label of the call: (n, C, normal, max abs err)}."""
    out = {}
    for uids, key, word1, it, n, index, normal in calls:
        k = R.philox_fill(uids, key, word1, it, n, index, normal)
        plain = R.philox_fill_reference(uids, key, word1, it, n, index,
                                        normal)
        cpu = R.philox_fill_reference(
            uids.cpu(), key, word1, it, n,
            None if index is None else index.cpu(), normal)
        k2 = R.philox_fill(uids, key, word1, it, n, index, normal)
        torch.cuda.synchronize()
        check(torch.equal(k, k2), f"{label}: two draws differ")
        err = max(float((k - plain).abs().max()),
                  float((k.cpu() - cpu).abs().max()))
        if normal:
            check(err <= NORMAL_ATOL, f"{label}: normals differ from the "
                  f"plain version by {err}")
        else:
            check(torch.equal(k, plain) and torch.equal(k.cpu(), cpu),
                  f"{label}: uniforms differ from the plain version "
                  f"(max abs {err})")
        name = f"{label} site {word1 & 255} {'normal' if normal else 'uniform'}"
        out[name] = (n, uids.numel(), normal, err, index)
    return out


def compaction_on_the_card(torch, bt, R, path, card):
    """Phase 14 (b): tests/test_torch_ensemble.py's compaction test on the
    card: compact on and off, the same end and convergence iterations and
    MAP windows, per-column cosines of the MAP P > 0.98, every draw of
    every chain equal bit for bit."""
    rng = np.random.default_rng(0)
    P = rng.dirichlet(np.ones(16) * 0.5, 3).T * 30.0
    M = rng.poisson(P @ rng.gamma(2.0, 2.0, (3, 24))).astype(np.float32)
    runs = []
    for compact in (True, False):
        rec, fill = {}, R.philox_fill

        @functools.wraps(fill)
        def spy(uids, key, word1, it, n, index=None, normal=False):
            out = fill(uids, key, word1, it, n, index, normal)
            for c, uid in enumerate(uids.tolist()):
                rec[(word1, normal, it, uid)] = out[c].clone()
            return out

        R.philox_fill = spy
        try:
            e = bt.ChainEnsemble(
                M, 3, n_chains=6, compact=compact, likelihood="poisson",
                prior="truncnormal", MH=True, post_warmup=40, seed=3,
                convergence_control=bt.ConvergenceControl(**COMPACT_CC),
                output_dir=None, verbosity=0, device="cuda",
                **COMPACT_PATHS[path]).run()
        finally:
            R.philox_fill = fill
        runs.append((e, rec))
    (e1, r1), (e2, r2) = runs
    label = f"phase 14 compaction ({path})"
    check(e1._slots.size < 6, f"{label}: the ensemble never compacted")
    check(np.array_equal(e1._end_iter, e2._end_iter)
          and np.array_equal(e1.tracker.converged_iter,
                             e2.tracker.converged_iter),
          f"{label}: end iterations {e1._end_iter} and {e2._end_iter}")
    worst, same = 1.0, True
    for c in range(6):
        m1, m2 = e1.MAP_per_chain[c], e2.MAP_per_chain[c]
        check(np.array_equal(m1["idx"], m2["idx"]),
              f"{label}: chain {c}'s MAP window differs")
        P1, P2 = np.asarray(m1["P"]), np.asarray(m2["P"])
        check(P1.shape == P2.shape, f"{label}: chain {c}'s MAP rank differs")
        same &= bool(np.array_equal(P1, P2))
        for j in range(P1.shape[1]):
            cos = (P1[:, j] @ P2[:, j]) / (np.linalg.norm(P1[:, j])
                                           * np.linalg.norm(P2[:, j]) + 1e-12)
            worst = min(worst, float(cos))
    check(worst > 0.98, f"{label}: a MAP column's cosine {worst}")
    check(set(r1) <= set(r2) and len(r1) < len(r2),
          f"{label}: the compacted run drew what the other did not")
    bad = sum(not torch.equal(v, r2[k]) for k, v in r1.items())
    check(bad == 0, f"{label}: {bad} of {len(r1)} chain draws differ")
    print(f"{label}: 6 chains at 16x24, compacted to {e1._slots.size}; end "
          f"iterations {e1._end_iter.tolist()} in both runs, MAP windows "
          f"equal, MAP P columns' cosine min {worst:.6f} (bit-identical: "
          f"{same}); {len(r1)} chain draws of the compacted run equal the "
          f"other's bit for bit; on {card}", flush=True)


def run_rng(torch, bt, gibbs, card, mesh_ranks):
    """Phase 14: the chains' streams. (a) The draw kernel (csrc/rng.cu)
    against its plain version on the card and on the CPU at the draws of
    the north-star ensemble's stream step (8 chains at 96x10k, SBFI over
    ranks 1..20) and at a mesh rank's G block (an index map): uniforms
    bit for bit, normals within NORMAL_ATOL; each timed beside its bound,
    its plain version and torch.rand / torch.randn of the same shape.
    (b) The compaction test on the card for the fused and stream
    ensembles. (c) A checkpoint saved on the card resumes on the CPU with
    the same streams: the next draws equal bit for bit, and the conjugate
    step's allocation planes drawn on the CPU equal the card's. (d) The 1x2 mesh of phase 11: each rank's draws are
    the one-process draw's block and computed only its block's elements.
    Returns the kernels line's numbers."""
    from bayesnmf_tpu_torch.models import updates as U
    from bayesnmf_tpu_torch.ops import allocation as AL
    from bayesnmf_tpu_torch.ops import rng as R
    from bayesnmf_tpu_torch.parallel import mesh as M

    t14 = time.perf_counter()
    # (a) the stream step's draws and a mesh block's
    spec = bt.ModelSpec(K=ENS_K, N=ENS_MAX_RANK, G=ENS_G, stream_sweeps=True,
                        learning_rank=True, rank_method="SBFI")
    gen = ChainStreams(RNG_SEED, np.arange(RNG_CHAINS), 7, device="cuda")
    step = captured_fills(torch, R, lambda: gibbs.draw_stream_noise(
        spec, RNG_CHAINS, gen, "cuda"))
    check(len(step) == gibbs.draw_launches(spec),
          f"the stream step made {len(step)} draws, not "
          f"{gibbs.draw_launches(spec)}")
    blk = gen.block(fake_mesh(1, 2, gi=1), ENS_G)
    block = captured_fills(torch, R, lambda: blk.uniform(
        "sweep_E", (RNG_CHAINS, 3, ENS_MAX_RANK, blk.G_local), g=True))
    res = compare_draws(torch, R, step, "stream step", card)
    res |= compare_draws(torch, R, block, "G block [5000, 10000)", card)
    rows = {}
    for (name, (n, C, normal, err, index)), call in zip(res.items(),
                                                          step + block):
        kern, wrapped = kernel_ms(torch, lambda c=call: R.philox_fill(*c), 50)
        plain = time_ms(torch, lambda c=call: R.philox_fill_reference(*c), 5)
        lib_fn = torch.randn if normal else torch.rand
        lib = time_ms(torch, lambda: lib_fn((C, n), device="cuda"), 50)
        b_ms, b_by = rng_bound(C * n, 0 if index is None else n)
        rows[name] = dict(n=C * n, err=err, ms=kern, plain_ms=plain,
                          library_ms=lib, bound_ms=b_ms, bound_by=b_by)
        print(f"phase 14 draw kernel {name}: ({C}, {n}) float32, "
              f"{'an index map, ' if index is not None else ''}max abs "
              f"{err:.3g} against the plain version (card and CPU); kernel "
              f"{kern:.4f} ms on the device ({wrapped:.4f} ms per call "
              f"through the wrapper), plain PyTorch {plain:.4f} ms, "
              f"torch.{lib_fn.__name__} of the shape {lib:.4f} ms (another "
              f"function, for scale), bound {b_ms:.6f} ms ({b_by}); on "
              f"{card}", flush=True)
    # (b) compaction on the card
    for path in COMPACT_PATHS:
        compaction_on_the_card(torch, bt, R, path, card)
    # (c) a card checkpoint resumed on the CPU
    Mx, _ = synthetic(96, 500, 8, seed=5)
    with tempfile.TemporaryDirectory() as tmp:
        s = bt.GibbsSampler(Mx, 8, prior="exponential", MH=False, seed=9,
                            device="cuda", output_dir=os.path.join(tmp, "r"),
                            verbosity=0)
        s._run_chunk(10, False)
        path = s.save_object()
        r = bt.GibbsSampler.load(path, device="cpu")
    check(repr(r.state["gen"].state()) == repr(s.state["gen"].state()),
          "phase 14 (c): the streams changed on the CPU")
    a, b = (gibbs.streams_of(x.state) for x in (s, r))
    nxt = [(x.uniform("gamma_P", (9, 96, 8), None),
            x.uniform("gamma_E", (9, 8, 500), None, g=True),
            x.normal("mu_e", (8, 500), None)) for x in (a, b)]
    check(all(torch.equal(p.cpu(), q) for p, q in zip(nxt[0][:2],
                                                      nxt[1][:2]))
          and float((nxt[0][2].cpu() - nxt[1][2]).abs().max())
          <= NORMAL_ATOL, "phase 14 (c): the CPU's next draws differ from "
          "the card's")
    # the conjugate step's allocation: the CPU draws the planes the card
    # kernel draws in-kernel (the same uniforms), so the kernel equals its
    # plain version fed the CPU's planes; the plain version run on the CPU
    # may still split a count otherwise where a log or exp rounds another
    # way on the two devices
    K, N, G = s.spec.K, s.spec.N, s.spec.G
    planes = AL.philox_planes(b.subkey("alloc"), b.uids, N, K, G)
    check(torch.equal(planes, AL.philox_planes(
        a.subkey("alloc"), a.uids, N, K, G).cpu()),
          "phase 14 (c): the allocation's planes differ on the CPU")
    p = s.state["params"]
    zc = U.sample_Z_sums(s.spec, s.data, p, a)
    zr = AL.allocate_counts_reference(s.data, p["P"][None], p["A"][None],
                                      p["E"][None], planes.to("cuda"))
    check(all(torch.equal(x, y[0]) for x, y in zip(zc, zr)),
          "phase 14 (c): the allocation kernel differs from its plain "
          "version on the CPU's planes")
    zp = U.sample_Z_sums(r.spec, r.data,
                         {k: v.cpu() for k, v in p.items()}, b)
    n_diff = sum(int((x.cpu() != y).sum()) for x, y in zip(zc, zp))
    n_all = sum(x.numel() for x in zc)
    print(f"phase 14 (c): a conjugate sampler saved on the card at iteration "
          f"{s.iter} resumes on the CPU with its streams: the next uniforms "
          "equal bit for bit, the normals within "
          f"{NORMAL_ATOL:g}; the allocation's Philox planes drawn on the CPU "
          "equal the card's, and the card kernel equals its plain version "
          f"on them; the CPU's own plain run differs in {n_diff} of {n_all} "
          f"latent-count sums (float rounding of a split); on {card}",
          flush=True)
    # (d) the 1x2 mesh's draws
    whole = ChainStreams(MESH_SEEDS["draws"], np.arange(MESH_CHAINS), 5,
                         device="cuda")
    want = {k: v.cpu().numpy() for k, v in mesh_draws(
        torch, whole, MESH_CHAINS, MESH_G).items()}
    K, N = MESH_K, MESH_N
    for gi, rk in enumerate(mesh_ranks):
        g0, g1 = M.split(MESH_G, 2, gi)
        flat = want["flat"]
        blocks = {"g": want["g"][..., g0:g1], "normal": want["normal"],
                  "flat": np.concatenate(
                      [flat[..., :K * N], flat[..., K * N:].reshape(
                          MESH_CHAINS, 18, N, MESH_G)[..., g0:g1].reshape(
                              MESH_CHAINS, 18, -1)], -1)}
        for k, v in blocks.items():
            err = float(np.max(np.abs(rk[f"draws/{k}"] - v)))
            check(err <= (NORMAL_ATOL if k == "normal" else 0.0),
                  f"phase 14 (d): rank {gi}'s {k} draw differs from the "
                  f"one-process block by {err}")
        size = sum(v.size for v in blocks.values())
        check(int(rk["draws/elements"]) == size,
              f"phase 14 (d): rank {gi} drew {int(rk['draws/elements'])} "
              f"elements for a block of {size}")
    print(f"phase 14 (d): the 1x2 mesh's ranks drew their blocks of a G "
          f"draw, a normal draw and a flat draw of parts ({MESH_CHAINS} "
          f"chains at {MESH_K}x{MESH_G}): each equal to the one-process "
          "draw's block, each rank computing only its block's "
          f"{[int(r['draws/elements']) for r in mesh_ranks]} elements; "
          f"phase 14 {time.perf_counter() - t14:.1f} s; on {card}",
          flush=True)
    main_row = rows[next(iter(rows))]   # the stream step's uniform draw
    return main_row | {"max_abs_err": max(r["err"] for r in rows.values())}


# ---------------------------------------------------------------------------
# phase 15: catalogue shapes
# ---------------------------------------------------------------------------

# (K, N, G, chains, options, temperature): the fused kernel at the strand,
# SBS-288 and SBS-1536 shapes: the cluster form at (192,20,2780), the grid
# form beyond it (its first shape (192,40,2780); the exponential prior with
# an inactive P column, whose flag crosses the blocks); the rank branch at
# the SBS-1536 fit's shape, one chain and 8 (each its own A, so the chains
# pass different numbers of barriers)
CAT_FUSED = [(192, 20, 2780, 1, {}, None), (192, 40, 2780, 1, {}, None),
             (288, 20, 1000, 1, {}, None),
             (288, 20, 1000, 1, dict(prior_kind="exponential"), None),
             (1536, 8, 500, 1, {}, None),
             (1536, 20, 2780, 1, dict(rank_method="SBFI"), 1.0),
             (1536, 20, 2780, 8, dict(rank_method="SBFI"), 1.0)]
# the stream kernels: the SBS-1536 ensemble's step (16-wide G tiles) and
# N = 80 (the 128-wide register tile); the E row's split form at its first
# K and at a 64-wide register tile
CAT_STREAM = [(1536, 20, 2780, 8, None), (96, 80, 10000, 2, None),
              (192, 20, 2780, 8, None), (1536, 64, 300, 2, None)]
# the E-row sweep timed in both forms: the whole form's last K of the
# catalogue, the split form's first and the SBS-1536 ensemble's
EROW_FORMS_TIMED = [(96, 20, 2780, 8), (192, 20, 2780, 8),
                    (1536, 20, 2780, 8)]
CAT_STREAM_TIMED = [(1536, 20, 2780, 8), (96, 80, 10000, 2)]
# (K, N, G, chains, A, options): the P and A columns' row form (K >= 192)
# beyond the CAT_STREAM shapes, whose (1536,20,2780,8) takes a cluster of
# one block, the others of 4 or 8: an inactive P column (an all-zero E row)
# whose flag crosses a cluster of 4 blocks; a cluster of 2 at a K and a G
# that no block's rows and no tile width divide, with an excluded column;
# the 128-wide register tile; and (ROWS_EXP) the exponential prior in the
# same kernels
ROWS_CASES = [(384, 20, 2780, 8, None, ("inactive",)),
              (1530, 8, 1001, 4, (1.0, 1.0, 1.0, 0.0, 1.0, 1.0, 1.0, 1.0),
               ()),
              (192, 80, 300, 2, None, ())]
ROWS_EXP = [(1530, 8, 1001, 4, None, ())]
CAT_ALLOC = [(96, 80, 2780), (1536, 80, 2780)]
# the planes mode's check at n2 = 128 (the uniform operand of the main
# path's shapes would take 2.3 GB and 37 GB)
CAT_ALLOC_PLANES = (96, 80, 300)
# the allocation's plain version runs on G chunks (the Philox planes of
# the whole of (1536, 80, 2780) would take 54 GB)
CAT_ALLOC_CHUNK = 1024
CAT_K, CAT_G, CAT_TRUE, CAT_MAX, CAT_CHAINS = 1536, 2780, 8, 20, 8
CAT_SCALE = 8000.0
CAT_FIT_CC = dict(MAP_over=200, MAP_every=100, miniters=400, maxiters=600,
                  Ninarow_nochange=3, Ninarow_nobest=5)
CAT_ENS_CC = dict(MAP_over=100, MAP_every=50, miniters=200, maxiters=300,
                  Ninarow_nochange=3, Ninarow_nobest=5)
CAT_CONJ_CC = dict(MAP_over=100, MAP_every=50, miniters=150, maxiters=200,
                   Ninarow_nochange=3, Ninarow_nobest=5)
CAT_CONJ_RANK = 80


def compare_catalogue_fused(torch, FS, card):
    """Phase 15 (a): the fused kernel at CAT_FUSED against its plain
    version as in phase 3, timed beside its bound. Returns {case: dict(
    max_abs_err, ms, plain_ms, bound_ms, bound_by)}, case (K, N, G, C) and
    the options."""
    res = {}
    for (K, N, G, C, kw, temp) in CAT_FUSED:
        d = (branch_inputs(K, N, G, C, K + N + G + C, kw, temp) if kw
             else sweep_inputs(K, N, G, C, seed=K + N + G + C))
        if C > 1:
            A = (np.random.default_rng(K + N + G).uniform(size=(C, N))
                 < 0.6).astype(np.float32)
            d["A"] = A
            d["Mhat"] = np.einsum("ckn,cn,cng->ckg", d["P"], A,
                                  d["E"]).astype(np.float32)
        t = to_card(torch, d)
        hyper = kw.get("prior_kind") != "exponential"
        key = f"{(K, N, G, C)}" + "".join(f" {v}" for v in kw.values())
        case = f"catalogue (K,N,G,C)={(K, N, G, C)}" + "".join(
            f" {k}={v}" for k, v in kw.items())
        flags = torch.arange(C, device="cuda") % 2 == 0
        worst = 0.0
        for accept_all in ((flags,) if C > 1 else (True, False)):
            w, kernel, plain = check_sweep_case(torch, FS, t, C, case,
                                                accept_all, hyper, **kw)
            worst = max(worst, w)
        k_ms = time_ms(torch, kernel, 10)
        p_ms = time_ms(torch, plain, 2)
        b_ms, b_by = fused_bound(K, N, G, C, rank="rank_method" in kw)
        res[key] = dict(max_abs_err=worst, ms=k_ms, plain_ms=p_ms,
                        bound_ms=b_ms, bound_by=b_by)
        print(f"time per call fused at {case}: "
              f"{fused_form(torch, FS, K, N, G, C)}; kernel {k_ms:.4f} ms "
              f"(CUDA events), plain PyTorch {p_ms:.4f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}), on {card}", flush=True)
    return res


def time_erow_forms(torch, S, card):
    """Phase 15 (a): the E-row sweep at EROW_FORMS_TIMED, a column's time
    (CUDA events over a sweep of N launches, less its operands' clones),
    beside its bound. Returns {(K, N, G, C): dict(form, ms, bound_ms,
    bound_by)}."""
    res = {}
    for (K, N, G, C) in EROW_FORMS_TIMED:
        t = to_card(torch, update_inputs(K, N, G, C, K + N + G + C))
        zero = torch.zeros(C, device="cuda")

        def sweep():
            S.stream_erow_update(t["data"], t["E"].clone(), t["P"], t["A"],
                                 t["acc_E"].clone(), t["Mu_e"], t["Sq_e"],
                                 t["E_prior"], t["U_e"], t["accept_all"],
                                 zero.clone())

        def clones():
            t["E"].clone(), t["acc_E"].clone(), zero.clone()

        ms = (time_ms(torch, sweep, 10) - time_ms(torch, clones, 10)) / N
        b_ms, b_by = update_bound(False, K, N, G, C)
        form = "split" if S.erow_split(K) else "whole"
        res[(K, N, G, C)] = dict(form=form, ms=ms, bound_ms=b_ms,
                                 bound_by=b_by)
        print(f"time per row stream_erow_update at (K,N,G,C)="
              f"{(K, N, G, C)}: the {form} form, {ms:.4f} ms (CUDA events, "
              f"a sweep of {N} rows), bound {b_ms:.4f} ms ({b_by}), on "
              f"{card}", flush=True)
    return res


def catalogue_alloc_plain(torch, AL, M, P, A, E, key, uids, chunk):
    """The allocation's plain version on the Philox planes of the whole,
    drawn and allocated G chunk by G chunk (the planes' counters are the
    whole matrix's cells): Zsum_g added over the chunks (integers, exact),
    Zsum_k side by side."""
    K, G = M.shape
    N = P.shape[-1]
    zgs, zks = [], []
    for g0 in range(0, G, chunk):
        g1 = min(g0 + chunk, G)
        u = AL.philox_planes(key, uids, N, K, g1 - g0, g0=g0, G_total=G)
        zg, zk = AL.allocate_counts_reference(
            M[:, g0:g1].contiguous(), P, A, E[:, :, g0:g1].contiguous(), u)
        zgs.append(zg.double())
        zks.append(zk)
        del u
    return sum(zgs).float(), torch.cat(zks, -1)


def compare_catalogue_alloc(torch, AL, card):
    """Phase 15 (a): the allocation at n2 = 128 against its plain version:
    in the planes mode at CAT_ALLOC_PLANES, and in the Philox mode (the
    main path's) at CAT_ALLOC, where it is timed beside its bound. Returns
    {(K, N, G): dict(max_abs_err, ms, plain_ms, bound_ms, bound_by)}."""
    res = {}
    uids = torch.zeros(1, dtype=torch.int64, device="cuda")
    for (K, N, G) in [CAT_ALLOC_PLANES] + CAT_ALLOC:
        t = to_card(torch, alloc_inputs(K, N, G, 1, K + N + G, (5,), (),
                                        planes=False))
        M = t["M"]
        P, A, E = (x.unsqueeze(0) for x in (t["P"], t["A"], t["E"]))
        key = (K * G + N, 0)
        case = f"catalogue (K,N,G)={(K, N, G)} excluded=(5,)"
        if (K, N, G) == CAT_ALLOC_PLANES:
            u = uniform_planes(torch, AL, 1, N, K, G, K + N + G)
            mode = "planes"
            kernel = lambda: AL.allocate_counts(M, P, A, E, u=u)  # noqa
            plain = lambda: AL.allocate_counts_reference(  # noqa: E731
                M, P, A, E, u)
        else:
            mode = "Philox"
            kernel = lambda: AL.allocate_counts(  # noqa: E731
                M, P, A, E, key=key, uids=uids)
            plain = lambda: catalogue_alloc_plain(  # noqa: E731
                torch, AL, M, P, A, E, key, uids, CAT_ALLOC_CHUNK)
        k1, k2 = kernel(), kernel()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = plain()
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        check(all(torch.equal(x, y) for x, y in zip(k1, k2)),
              f"allocation ({mode}): two launches differ at {case}")
        worst = 0.0
        for name, x, y in zip(("Zsum_g", "Zsum_k"), k1, p):
            err = float((x - y).abs().max())
            worst = max(worst, err)
            check(torch.equal(x, y), f"allocation ({mode}) {name} "
                  f"differs from the plain version at {case}: max abs {err}")
        check(torch.equal(k1[1].sum(-2), M.sum(0).unsqueeze(0)),
              f"allocation ({mode}) does not conserve the counts at {case}")
        check(float(k1[1][:, 5].abs().sum()) == 0.0,
              f"allocation ({mode}) gave counts to an excluded component "
              f"at {case}")
        print(f"allocation kernel vs plain ({mode}) {case}: Zsum_g and "
              f"Zsum_k equal; two launches bit-identical; counts conserved; "
              f"plain {p_ms:.1f} ms", flush=True)
        if mode == "planes":
            continue
        ms, wrapped = kernel_ms(torch, kernel, 5)
        splits = count_splits(AL, torch, plain)
        b_ms, b_by = alloc_bound(K, N, G, 1, splits, False)
        res[(K, N, G)] = dict(max_abs_err=worst, ms=ms, plain_ms=p_ms,
                              bound_ms=b_ms, bound_by=b_by)
        print(f"time per call allocate_counts at {case} (n2 = "
              f"{AL.kernel_leaves(K, N)}): kernels {ms:.4f} ms on the device "
              f"(Philox; {wrapped:.4f} ms per call through the wrapper), "
              f"plain PyTorch {p_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}) "
              f"for {splits[0]} inversion splits of {splits[1]} steps and "
              f"{splits[2]} BTRS splits, on {card}", flush=True)
    return res


def compare_catalogue_stream(torch, S, U, card):
    """Phase 15 (a): the stream kernels at CAT_STREAM against their plain
    versions, as phase 3b holds them (the sums-only bodies, the column
    updates, the A-column update and the metrics row), each timed at
    CAT_STREAM_TIMED. Returns {timed shape: (sums, row, updates, acol)}."""
    cases = [c + (None,) for c in CAT_STREAM]
    ucases = [c + ((),) for c in CAT_STREAM]
    for (K, N, G, C, _) in CAT_STREAM + [c[:5] for c in ROWS_CASES]:
        print(f"stream tiles at catalogue (K,N,G,C)={(K, N, G, C)}: G tile "
              f"{S.col_tile(K, N)} wide, register tile {S.tile_width(N)}, "
              + (f"E row in the split form, a cluster of "
                 f"{S.erow_split_blocks(K)} block(s) holding "
                 f"{S.erow_rows(K, N)} rows of P*A each at once"
                 if S.erow_split(K) else
                 f"E row in the whole form, P*A's {S.erow_rows(K, N)} rows "
                 "staged") + "; P and A columns "
              + (f"in the row form, a grid of {S.rows_grid(K, C)} blocks "
                 f"in clusters of {S.rows_parts(K, C)} along G, "
                 f"{S.rows_tile(N)}-wide ring slots"
                 if S.col_rows_form(K) else "in the G-tile form"),
              flush=True)
    out = {}
    for i, timed in enumerate(CAT_STREAM_TIMED):
        # every case is compared once; each timed shape is timed
        sub = [c for c in cases if c[:4] == timed]
        usub = [c for c in ucases if c[:4] == timed]
        if i == len(CAT_STREAM_TIMED) - 1:
            sub += [c for c in cases if c[:4] not in CAT_STREAM_TIMED]
            usub += [c for c in ucases if c[:4] not in CAT_STREAM_TIMED]
        out[timed] = (
            compare_stream_kernels(torch, S, card, [c[:5] for c in sub],
                                   timed),
            compare_metrics_rows(torch, S, card, cases=sub, timed=timed),
            compare_stream_updates(torch, S, card, cases=usub, timed=timed),
            compare_acol_updates(torch, S, U, card, cases=usub, timed=timed))
    # the row form's own cases, and the calls of both row kernels counted
    rows0 = S._run.row_launches, S.stream_acol_update.row_launches
    compare_stream_kernels(torch, S, card, [c[:5] for c in ROWS_CASES],
                           None)
    compare_stream_updates(torch, S, card, cases=ROWS_CASES, timed=None)
    compare_acol_updates(torch, S, U, card, cases=ROWS_CASES, timed=None)
    compare_stream_updates(torch, S, card, "exponential", ROWS_EXP, None)
    check(S._run.row_launches > rows0[0]
          and S.stream_acol_update.row_launches > rows0[1],
          "the row form's cases did not run the row kernels")
    return out


def run_catalogue(torch, bt, FS, S, AL, U, gibbs, card):
    """Phase 15: catalogue shapes. (a) Each changed kernel against its plain
    version at the new shapes, timed beside its bound. (b) The slice's three
    runs through the entry points on synthetic catalogues (phase 4's recipe
    at 1536 rows, E ~ Gamma(2, 8000)): SBFI ``fit`` over ranks 1..20 at
    1536 x 2780 (the fused kernel, its rank branch, P and the partials in
    global memory), an 8-chain ``ChainEnsemble`` over ranks 1..20 at
    1536 x 2780 (the stream kernels, picked by the auto policy at
    G >= 2000), a conjugate rank-80 ``fit`` at 96 x 2780 and two conjugate
    steps at (1536, 80, 2780) (the allocation at n2 = 128): each kernel's
    launches per iteration exact, no plain version called, metrics finite;
    the SBS-1536 fit's and the ensemble's best chain's matched min cosine
    >= 0.9. Returns (kernel results, launches of each run)."""
    from bayesnmf_tpu_torch.parallel import chains as CH

    t15 = time.perf_counter()
    fused = compare_catalogue_fused(torch, FS, card)
    t_f = time.perf_counter()
    alloc = compare_catalogue_alloc(torch, AL, card)
    t_a = time.perf_counter()
    stream = compare_catalogue_stream(torch, S, U, card)
    erow = time_erow_forms(torch, S, card)
    print(f"phase 15 (a): {time.perf_counter() - t15:.1f} s (fused "
          f"{t_f - t15:.1f} s, allocation {t_a - t_f:.1f} s, stream "
          f"{time.perf_counter() - t_a:.1f} s)", flush=True)

    launches = {}
    M, P_true = synthetic(CAT_K, CAT_G, CAT_TRUE, seed=0, scale=CAT_SCALE)
    with tempfile.TemporaryDirectory() as tmp:
        # the SBS-1536 SBFI fit, default flags: the fused kernel
        reset_counts(FS, S, AL)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with plain_calls(FS, S, AL) as calls:
            s = bt.fit(M, range(1, CAT_MAX + 1), device="cuda",
                       output_dir=os.path.join(tmp, "fit"),
                       convergence_control=bt.ConvergenceControl(
                           **CAT_FIT_CC), post_warmup=200, seed=0)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counters(FS, S, AL)
        steps = s.iter - 1
        draws = check_draws("catalogue fit", counts, gibbs, s.spec, steps)
        check(counts["fused"] == steps, f"catalogue fit: fused kernel "
              f"launches {counts['fused']} != iterations run {steps}")
        check(ported(counts) == counts["fused"],
              "catalogue fit: another kernel ran")
        check(FS.fused_gibbs_sweeps.grid_launches == counts["fused"],
              f"catalogue fit: {FS.fused_gibbs_sweeps.grid_launches} of "
              f"{counts['fused']} fused launches in the grid form")
        check(sum(calls.values()) == 0,
              f"catalogue fit: plain versions ran: {calls}")
        rows = np.concatenate(s._metric_rows)
        check(rows.shape[0] == s.iter and np.isfinite(rows).all(),
              "catalogue fit: metrics are not finite")
        cos = matched_cosines(np.asarray(s.MAP["P"]), P_true)
        check(cos.min() >= 0.9,
              f"catalogue fit: matched cosine too low: {cos}")
        launches["fit"] = counts["fused"]
        print(f"catalogue fit: fit(1536x2780, ranks 1..20, SBFI) ran {steps} "
              f"iterations ({s.tracker.why}); learned rank "
              f"{int(np.asarray(s.MAP['A_full']).sum())} (true {CAT_TRUE}); "
              f"fused kernel launches {counts['fused']} (= iterations, "
              f"{FS.fused_gibbs_sweeps.grid_launches} in the grid form), "
              f"draw kernel {draws}, no other kernel, no plain version; "
              f"matched cosine min {cos.min():.4f} mean {cos.mean():.4f}; "
              f"{steps / wall:.1f} it/s for the whole fit ({wall:.2f} s) on "
              f"{card}", flush=True)
        del s

        # the SBS-1536 ensemble: the stream kernels by the auto policy
        reset_counts(FS, S, AL)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with plain_calls(FS, S, AL) as calls:
            ens = bt.ChainEnsemble(
                M, range(1, CAT_MAX + 1), n_chains=CAT_CHAINS,
                convergence_control=bt.ConvergenceControl(**CAT_ENS_CC),
                post_warmup=100, seed=0, store_E=False,
                periodic_save=False, output_dir=os.path.join(tmp, "ens"),
                device="cuda")
            check(ens.spec.stream_sweeps,
                  "catalogue ensemble: the auto policy did not stream")
            ens.run()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(sum(calls.values()) == 0,
              f"catalogue ensemble: plain versions ran: {calls}")
        counts = launch_counters(FS, S, AL)
        check(counts["fused"] == counts["allocation"] == 0,
              "catalogue ensemble: another kernel ran")
        # a step's 2N P-column passes and N E rows: the rows a third
        check(3 * S._run.split_launches == S._run.launches,
              f"catalogue ensemble: {S._run.split_launches} E rows in the "
              f"split form of {S._run.launches // 3}")
        print(f"catalogue ensemble: {S._run.split_launches} E-row launches, "
              f"all in the split form; {S._run.row_launches} P columns and "
              f"{S.stream_acol_update.row_launches} A columns in the row "
              "form", flush=True)
        N = CAT_MAX
        ens_launches = {"_run": S._run.launches,
                        "stream_acol_update": S.stream_acol_update.launches,
                        "stream_metrics_row": S.stream_metrics_row.launches,
                        "hyper_update": S.hyper_update.launches,
                        "acol_delta": S.acol_delta.launches,
                        "chain_metrics": S.chain_metrics.launches,
                        "rng": counts["rng"],
                        "pcol rows": S._run.row_launches,
                        "acol rows": S.stream_acol_update.row_launches}
        # every P and A column of every step in the row form
        report_run(torch, CH, ens, "catalogue ensemble", wall, ens_launches,
                   {"_run": (3 * N, 0), "stream_acol_update": (N, 0),
                    "stream_metrics_row": (1, 0), "pcol rows": (N, 0),
                    "acol rows": (N, 0)}, P_true, card)
        launches["ensemble"] = ens_launches
        del ens

        # the rank-80 conjugate fit at 96 x 2780: the allocation at n2 = 128
        M96, _ = synthetic(96, CAT_G, CAT_TRUE, seed=1)
        reset_counts(FS, S, AL)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with plain_calls(FS, S, AL) as calls:
            s = bt.fit(M96, CAT_CONJ_RANK, prior="exponential", MH=False,
                       device="cuda", output_dir=os.path.join(tmp, "conj"),
                       convergence_control=bt.ConvergenceControl(
                           **CAT_CONJ_CC), seed=0)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counters(FS, S, AL)
        steps = s.iter - 1
        draws = check_draws("catalogue conjugate fit", counts, gibbs,
                            s.spec, steps)
        check(counts["allocation"] == steps + 1,
              f"catalogue conjugate fit: allocation launches "
              f"{counts['allocation']} != iterations + 1 ({steps + 1})")
        check(ported(counts) == counts["allocation"],
              "catalogue conjugate fit: another kernel ran")
        check(sum(calls.values()) == 0,
              f"catalogue conjugate fit: plain versions ran: {calls}")
        rows = np.concatenate(s._metric_rows)
        check(rows.shape[0] == s.iter and np.isfinite(rows).all(),
              "catalogue conjugate fit: metrics are not finite")
        launches["conjugate"] = counts["allocation"]
        print(f"catalogue conjugate fit: fit(96x2780, rank 80, exponential, "
              f"MH=False) ran {steps} iterations; allocation launches "
              f"{counts['allocation']} (= iterations + 1), draw kernel "
              f"{draws}, no other kernel, no plain version; "
              f"{steps / wall:.1f} it/s ({wall:.2f} s) on {card}", flush=True)

    # two conjugate steps at (1536, 80, 2780)
    s = bt.GibbsSampler(M, CAT_CONJ_RANK, prior="exponential", MH=False,
                        device="cuda", seed=0, verbosity=0)
    reset_counts(FS, S, AL)
    with plain_calls(FS, S, AL) as calls:
        state, _ = gibbs.run_chunk(s.spec, s.data, s.hyperprior_params,
                                   s.state, np.ones(2, np.float32), False)[:2]
        torch.cuda.synchronize()
    counts = launch_counters(FS, S, AL)
    check(counts["allocation"] == 2 and ported(counts) == 2,
          f"catalogue conjugate steps: launches {counts}")
    check_draws("catalogue conjugate steps", counts, gibbs, s.spec, 2,
                init=False)
    check(sum(calls.values()) == 0,
          f"catalogue conjugate steps: plain versions ran: {calls}")
    check(all(bool(torch.isfinite(v).all())
              for v in state["params"].values()),
          "catalogue conjugate steps: the state is not finite")
    launches["conjugate"] += counts["allocation"]
    print(f"catalogue conjugate steps at (1536, 80, 2780): allocation "
          f"launches {counts['allocation']} (= 2 steps), state finite; "
          f"phase 15 {time.perf_counter() - t15:.1f} s on {card}", flush=True)
    return dict(fused=fused, alloc=alloc, stream=stream, erow=erow), launches


def catalogue_kernels(cat, launches):
    """The kernels line's entries of phase 15: one a kernel and new shape,
    its launches those of the phase's run through it."""
    src = "bayesnmf_tpu_torch/csrc/stream_sweeps.cu"
    pss = "bayesnmf_tpu/ops/pallas_stream_sweeps.py"
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    rows = []
    for shape, r in cat["fused"].items():
        rows.append({"name": f"fused_gibbs_sweeps at {shape}",
                     "route": "cuda",
                     "source": "bayesnmf_tpu_torch/csrc/fused_sweeps.cu",
                     "replaces": "bayesnmf_tpu/ops/pallas_sweeps.py:127",
                     "launches": launches["fit"],
                     **{k: r[k] for k in keys}, "library_ms": None})
    for shape, r in cat["alloc"].items():
        rows.append({"name": f"allocate_counts_fused at {shape}",
                     "route": "cuda",
                     "source": "bayesnmf_tpu_torch/csrc/allocation.cu",
                     "replaces": "bayesnmf_tpu/ops/pallas_allocation.py:140",
                     "launches": launches["conjugate"],
                     **{k: r[k] for k in keys}, "library_ms": None})
    ens = launches["ensemble"]
    timed = CAT_STREAM_TIMED[0]
    erow = cat["stream"][timed][2]["erow_update"]
    rows.append({"name": f"stream_erow_update (split form) at {timed}",
                 "route": "cuda", "source": src, "replaces": f"{pss}:370",
                 "launches": ens["_run"] // 3,
                 **{k: erow[k] for k in keys}, "library_ms": None})
    # the P and A columns' row form at the SBS-1536 ensemble's shape, its
    # launches the ensemble's columns (all of them in the row form)
    pcol = cat["stream"][timed][2]["pcol_update"]
    rows.append({"name": f"stream_pcol_update (row form) at {timed}",
                 "route": "cuda", "source": src, "replaces": f"{pss}:344",
                 "launches": ens["pcol rows"],
                 **{k: pcol[k] for k in keys}, "library_ms": None})
    acol = cat["stream"][timed][3]
    rows.append({"name": f"stream_acol_update (row form) at {timed}",
                 "route": "cuda", "source": src, "replaces": f"{pss}:234",
                 "launches": ens["acol rows"],
                 **{k: acol[k] for k in keys}, "library_ms": None})
    for shape, (sums, row, updates, acol) in cat["stream"].items():
        mean = lambda key: float(np.mean(  # noqa: E731
            [u[key] for u in updates.values()]))
        rows.append({
            "name": f"_run at {shape}", "route": "cuda", "source": src,
            "replaces": f"{pss}:330", "launches": ens["_run"],
            "max_abs_err": max([sums[b]["max_abs_err"] for b in (
                "pcol_stats", "pcol_accept", "erow_stats", "erow_accept")]
                + [u["max_abs_err"] for u in updates.values()]),
            "ms": mean("ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_ms"),
            "bound_by": updates["pcol_update"]["bound_by"],
            "library_ms": None})
        rows.append({
            "name": f"acol_delta at {shape}", "route": "cuda",
            "source": src, "replaces": f"{pss}:220",
            "launches": ens["stream_acol_update"],
            "max_abs_err": max(sums["acol_delta"]["max_abs_err"],
                               acol["max_abs_err"]),
            **{k: acol[k] for k in keys[1:]}, "library_ms": None})
        rows.append({
            "name": f"chain_metrics at {shape}", "route": "cuda",
            "source": src, "replaces": f"{pss}:272",
            "launches": ens["stream_metrics_row"],
            "max_abs_err": max(sums["chain_metrics"]["max_abs_err"],
                               row["max_abs_err"]),
            **{k: row[k] for k in keys[1:]}, "library_ms": None})
    return rows


#: the phases after the card and the build, in the order they run
PHASES = ("3", "3b", "3c", "3d", "4", "5", "6", "7", "8", "9", "10", "11",
          "12", "13", "14", "15")


def chosen_phases(argv) -> tuple:
    """``--phases 3b,15`` (a comma-separated subset of PHASES; phases 1 and
    2, the card and the build, always run): the phases to run, in order;
    every phase without the option."""
    if "--phases" not in argv:
        return PHASES
    i = argv.index("--phases")
    names = argv[i + 1].split(",") if i + 1 < len(argv) else []
    names = [n for n in names if n not in ("1", "2")]
    bad = [n for n in names if n not in PHASES]
    if bad or not names and i + 1 >= len(argv):
        raise SystemExit(f"chip_smoke: --phases takes a comma-separated "
                         f"subset of {', '.join(('1', '2') + PHASES)}; got "
                         f"{argv[i + 1:i + 2]}")
    return tuple(p for p in PHASES if p in names)


def main() -> int:
    if sys.argv[1:2] == ["--mesh-worker"]:
        return mesh_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--geweke-worker"]:
        return geweke_worker(sys.argv[2:])
    phases = chosen_phases(sys.argv[1:])
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    # the package sits beside this script, the Geweke harness in its tests
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [here, os.path.join(here, "tests")]
    import bayesnmf_tpu_torch as bt
    from bayesnmf_tpu_torch.models import gibbs
    from bayesnmf_tpu_torch.ops import _build
    from bayesnmf_tpu_torch.ops import allocation as AL
    from bayesnmf_tpu_torch.ops import fused_sweeps as FS
    from bayesnmf_tpu_torch.models import updates as U
    from bayesnmf_tpu_torch.ops import stream_sweeps as S

    t_start = time.perf_counter()
    # phase 1: the card and the toolchain
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True)
    print("nvcc: " + nvcc.stdout.strip().splitlines()[-1], flush=True)
    print(f"phases: 1, 2, {', '.join(phases)}", flush=True)

    # phase 2: build
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s for "
          f"{len(_build.sources())} source(s), one nvcc each, in parallel ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in sorted(
              _build.compile_seconds.items(), key=lambda kv: -kv[1]))
          + ")", flush=True)

    r = {}          # each phase's results, by name
    walls = {}      # each phase's seconds

    def phase(name, fn):
        if name in phases:
            t = time.perf_counter()
            fn()
            walls[name] = time.perf_counter() - t
            print(f"phase {name}: {walls[name]:.1f} s", flush=True)

    def p3():
        # the fused kernel against its plain version, and its fixed-rank
        # form
        r["max_err"], times = compare_kernel(torch, FS)
        r["pe"] = compare_pe_sweeps(torch, FS, card)
        for shape, (k_ms, w_ms, p_ms) in times.items():
            print(f"time per call at (K,N,G)={shape}: kernel {k_ms:.4f} ms "
                  f"on the device ({w_ms:.4f} ms per call through the "
                  f"wrapper), plain PyTorch {p_ms:.4f} ms, bound "
                  f"{fused_bound(*shape)[0]:.4f} ms, on {card}", flush=True)

    def p3b():
        # the streaming kernels against their plain versions
        r["stream"] = compare_stream_kernels(torch, S, card)
        r["row"] = compare_metrics_rows(torch, S, card)
        check(compare_special(torch, S) == (0, 0),
              "the kernels' ndtri, log_ndtr, ndtr or sigmoid differ from the "
              "PyTorch calls")
        r["updates"] = compare_stream_updates(torch, S, card)
        r["acol"] = compare_acol_updates(torch, S, U, card)
        r["hyper"] = compare_hyper_update(torch, S, card)

    def p3c():
        # the fused kernel's rank branch, exponential prior and
        # reference-parity ratio against the plain version
        r["branch_err"], r["branch_times"] = compare_branches(torch, FS, card)

    def p3d():
        r["alloc"] = compare_allocation(torch, AL, card)

    def p4():
        r["slice_rate"] = run_slice(torch, bt, FS, gibbs, card)

    def p5():
        r["ens_launches"] = run_ensemble(torch, bt, S, card)

    def p6():
        r["rank_launches"] = run_rank_learning(torch, bt, FS, S, AL, gibbs,
                                               card)

    def p7():
        r["alloc_launches"] = run_exponential(torch, bt, FS, S, AL, gibbs,
                                              card)

    def p8():
        run_eager(torch, bt, FS, S, AL, gibbs, card)

    def p9():
        r["ens_kernel"] = compare_ensemble_kernel(torch, FS, card)
        r["exp_updates"] = compare_stream_updates(
            torch, S, card, "exponential", EXP_UPDATE_CASES)
        r["exp_row"] = compare_metrics_rows(torch, S, card, "exponential",
                                            EXP_ROW_CASES)
        r["ens_alloc"] = compare_ensemble_allocation(torch, bt, AL, card)
        r["p9_launches"] = run_ensembles(torch, bt, FS, S, AL, card)

    def p10():
        r["gamma_alloc"], r["gamma_launches"] = run_gamma(
            torch, bt, FS, S, AL, gibbs, card)
        run_recording(torch, bt, FS, S, AL, gibbs, card,
                      r.get("slice_rate"))

    def p11():
        (r["mesh_alloc"], r["mesh_launches"],
         r["mesh_ranks"]) = run_mesh(torch, bt, AL, gibbs, card)

    def p12():
        r["geweke"] = run_geweke(torch, card)

    def p13():
        run_bench(card)

    def p14():
        # without phase 11, its 1x2 workers run here for their draws
        ranks = r.get("mesh_ranks") or spawn_mesh(
            1, 2, tempfile.mkdtemp(prefix="bayesnmf_mesh_"))
        r["rng_row"] = run_rng(torch, bt, gibbs, card, ranks)

    def p15():
        r["cat"], r["cat_launches"] = run_catalogue(torch, bt, FS, S, AL, U,
                                                    gibbs, card)

    for name, fn in (("3", p3), ("3b", p3b), ("3c", p3c), ("3d", p3d),
                     ("4", p4), ("5", p5), ("6", p6), ("7", p7), ("8", p8),
                     ("9", p9), ("10", p10), ("11", p11), ("12", p12),
                     ("13", p13), ("14", p14), ("15", p15)):
        phase(name, fn)

    check("jax" not in sys.modules, "the port imported jax")
    check("bayesnmf_tpu" not in sys.modules,
          "the port imported the JAX package")
    kernels = kernel_entries(r)
    print(f"phases' seconds: "
          + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
          + f"; the whole script {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def kernel_entries(r):
    """The kernels line's entries from the phases' results ``r``: each
    entry whose phases ran (all of them in a run of every phase)."""
    kernels = []

    def have(*keys):
        return all(k in r for k in keys)

    src = "bayesnmf_tpu_torch/csrc/stream_sweeps.cu"
    pss = "bayesnmf_tpu/ops/pallas_stream_sweeps.py"
    if have("branch_times", "rank_launches", "max_err", "branch_err"):
        # the fused kernel at the rank-learning path's shape, rank branch on
        k_ms, _, p_ms = r["branch_times"]["rank"]
        b_ms, b_by = fused_bound(*RANK_TIMED, rank=True)
        kernels.append({
            "name": "fused_gibbs_sweeps", "route": "cuda",
            "source": "bayesnmf_tpu_torch/csrc/fused_sweeps.cu",
            "replaces": "bayesnmf_tpu/ops/pallas_sweeps.py:127",
            "launches": r["rank_launches"],
            "max_abs_err": max(r["max_err"], r["branch_err"]),
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None})
    if have("stream", "row", "updates", "acol", "ens_launches"):
        stream, updates, acol, row = (r["stream"], r["updates"], r["acol"],
                                      r["row"])
        ens_launches = r["ens_launches"]
        # _run's kernels reach the main path through the column updates;
        # its entry is the mean of a P-column and an E-row update (the four
        # sums-only bodies are timed in the lines above)
        bodies = ("pcol_stats", "pcol_accept", "erow_stats", "erow_accept")
        mean = lambda key: float(np.mean(  # noqa: E731
            [u[key] for u in updates.values()]))
        kernels.append({
            "name": "_run", "route": "cuda", "source": src,
            "replaces": f"{pss}:330", "launches": ens_launches["_run"],
            "max_abs_err": max([stream[b]["max_abs_err"] for b in bodies]
                               + [u["max_abs_err"]
                                  for u in updates.values()]),
            "ms": mean("ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_ms"),
            "bound_by": updates["pcol_update"]["bound_by"],
            "library_ms": None})
        # the E row's whole form (K < 192) at the north star's shape, alone
        erow = updates["erow_update"]
        kernels.append({
            "name": f"stream_erow_update (whole form) at {STREAM_TIMED}",
            "route": "cuda", "source": src, "replaces": f"{pss}:370",
            "launches": ens_launches["_run"] // 3,
            **{k: erow[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by")},
            "library_ms": None})
        # acol_delta reaches the main path as the A-column update: its entry
        # is a column update's (the sums-only form is timed above)
        kernels.append({
            "name": "acol_delta", "route": "cuda", "source": src,
            "replaces": f"{pss}:220",
            "launches": ens_launches["stream_acol_update"],
            "max_abs_err": max(stream["acol_delta"]["max_abs_err"],
                               acol["max_abs_err"]),
            "ms": acol["ms"], "plain_ms": acol["plain_ms"],
            "bound_ms": acol["bound_ms"], "bound_by": acol["bound_by"],
            "library_ms": None})
        # chain_metrics reaches the main path as the metrics row: its entry
        # is the row's (the sums-only form is timed above)
        kernels.append({
            "name": "chain_metrics", "route": "cuda", "source": src,
            "replaces": f"{pss}:272",
            "launches": ens_launches["stream_metrics_row"],
            "max_abs_err": max(stream["chain_metrics"]["max_abs_err"],
                               row["max_abs_err"]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None})
    if have("hyper", "ens_launches"):
        # no TPU kernel: the JAX package's exact hyper-update runs in XLA
        hyper = r["hyper"]
        kernels.append({
            "name": "hyper_update", "route": "cuda", "source": src,
            "replaces": "none (bayesnmf_tpu/models/updates.py:119-173 in "
                        "XLA)",
            "launches": r["ens_launches"]["hyper_update"],
            **{k: hyper[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by")},
            "library_ms": None})
    if have("alloc", "alloc_launches"):
        alloc = r["alloc"]
        kernels.append({
            "name": "allocate_counts_fused", "route": "cuda",
            "source": "bayesnmf_tpu_torch/csrc/allocation.cu",
            "replaces": "bayesnmf_tpu/ops/pallas_allocation.py:140",
            "launches": r["alloc_launches"],
            "max_abs_err": alloc["max_abs_err"], "ms": alloc["ms"],
            "plain_ms": alloc["plain_ms"], "bound_ms": alloc["bound_ms"],
            "bound_by": alloc["bound_by"], "library_ms": None})
    if have("ens_kernel", "exp_updates", "exp_row", "ens_alloc",
            "p9_launches"):
        ens_kernel, exp_updates = r["ens_kernel"], r["exp_updates"]
        exp_row, ens_alloc = r["exp_row"], r["ens_alloc"]
        p9_launches = r["p9_launches"]
        # phase 9's cases: the fused kernel over 20 masked chains (the BIC
        # ensemble's launches), the exponential prior in the stream kernels
        # (the 96x10k exponential ensemble's), the allocation on a conjugate
        # ensemble's step (that ensemble's launches)
        bic = ens_kernel[ENS_KERNEL_CASES[-1][:4]]
        kernels.append({
            "name": "fused_gibbs_sweeps (ensemble of 20 masked chains)",
            "route": "cuda",
            "source": "bayesnmf_tpu_torch/csrc/fused_sweeps.cu",
            "replaces": "bayesnmf_tpu/ops/pallas_sweeps.py:127",
            "launches": p9_launches["bic"]["fused"],
            "max_abs_err": max(v["max_abs_err"]
                               for v in ens_kernel.values()),
            "ms": bic["ms"], "plain_ms": bic["plain_ms"],
            "bound_ms": bic["bound_ms"], "bound_by": bic["bound_by"],
            "library_ms": None})
        emean = lambda key: float(np.mean(  # noqa: E731
            [u[key] for u in exp_updates.values()]))
        kernels.append({
            "name": "_run (exponential prior)", "route": "cuda",
            "source": src, "replaces": f"{pss}:330",
            "launches": p9_launches["exponential"]["_run"],
            "max_abs_err": max(u["max_abs_err"]
                               for u in exp_updates.values()),
            "ms": emean("ms"), "plain_ms": emean("plain_ms"),
            "bound_ms": emean("bound_ms"),
            "bound_by": exp_updates["pcol_update"]["bound_by"],
            "library_ms": None})
        kernels.append({
            "name": "chain_metrics (exponential prior)", "route": "cuda",
            "source": src, "replaces": f"{pss}:272",
            "launches": p9_launches["exponential"]["stream_metrics_row"],
            "max_abs_err": exp_row["max_abs_err"], "ms": exp_row["ms"],
            "plain_ms": exp_row["plain_ms"],
            "bound_ms": exp_row["bound_ms"],
            "bound_by": exp_row["bound_by"], "library_ms": None})
        kernels.append({
            "name": "allocate_counts_fused (conjugate ensemble of 8 chains)",
            "route": "cuda",
            "source": "bayesnmf_tpu_torch/csrc/allocation.cu",
            "replaces": "bayesnmf_tpu/ops/pallas_allocation.py:140",
            "launches": p9_launches["conjugate"]["allocation"],
            "max_abs_err": ens_alloc["max_abs_err"], "ms": ens_alloc["ms"],
            "plain_ms": ens_alloc["plain_ms"],
            "bound_ms": ens_alloc["bound_ms"],
            "bound_by": ens_alloc["bound_by"], "library_ms": None})
    if have("gamma_alloc", "gamma_launches"):
        # phase 10: the allocation on the Poisson-Gamma states of 8 chains
        # (the 8-chain Poisson-Gamma ensemble's launches)
        gamma_alloc = r["gamma_alloc"]
        kernels.append({
            "name": "allocate_counts_fused (Poisson-Gamma, 8 chains)",
            "route": "cuda",
            "source": "bayesnmf_tpu_torch/csrc/allocation.cu",
            "replaces": "bayesnmf_tpu/ops/pallas_allocation.py:140",
            "launches": r["gamma_launches"],
            "max_abs_err": gamma_alloc["max_abs_err"],
            "ms": gamma_alloc["ms"], "plain_ms": gamma_alloc["plain_ms"],
            "bound_ms": gamma_alloc["bound_ms"],
            "bound_by": gamma_alloc["bound_by"], "library_ms": None})
    if have("mesh_alloc", "mesh_launches"):
        # phase 11: the allocation on each rank's G shard of a 1x2 mesh
        # (the 1x2 Poisson-Exponential run's launches, both ranks)
        mesh_alloc = r["mesh_alloc"]
        kernels.append({
            "name": "allocate_counts_fused (G shard (96,8,1390) of a 1x2 "
                    "mesh)", "route": "cuda",
            "source": "bayesnmf_tpu_torch/csrc/allocation.cu",
            "replaces": "bayesnmf_tpu/ops/pallas_allocation.py:140",
            "launches": r["mesh_launches"],
            "max_abs_err": mesh_alloc["max_abs_err"],
            "ms": mesh_alloc["ms"], "plain_ms": mesh_alloc["plain_ms"],
            "bound_ms": mesh_alloc["bound_ms"],
            "bound_by": mesh_alloc["bound_by"], "library_ms": None})
    if have("pe", "geweke"):
        # the fixed-rank form over kernel 1 (phase 3's case at (96,8,500);
        # its launches are phase 12's fused_pe_sweeps gate's)
        pe = r["pe"]
        kernels.append({
            "name": "fused_pe_sweeps", "route": "cuda",
            "source": "bayesnmf_tpu_torch/csrc/fused_sweeps.cu",
            "replaces": "bayesnmf_tpu/ops/pallas_sweeps.py:449",
            "launches": r["geweke"]["fused_pe_sweeps"]["fused_pe"],
            "max_abs_err": pe["max_abs_err"], "ms": pe["ms"],
            "plain_ms": pe["plain_ms"], "bound_ms": pe["bound_ms"],
            "bound_by": pe["bound_by"], "library_ms": None})
    if have("rng_row", "ens_launches"):
        # the chains' draw kernel at the north-star ensemble's stream step
        # (its launches phase 5's run's)
        rng_row = r["rng_row"]
        kernels.append({
            "name": "rng", "route": "cuda",
            "source": "bayesnmf_tpu_torch/csrc/rng.cu",
            "replaces": "bayesnmf_tpu/parallel/chains.py:19 (per-chain "
                        "threefry keys; XLA's draws, no pallas_call)",
            "launches": r["ens_launches"]["rng"],
            "max_abs_err": rng_row["max_abs_err"], "ms": rng_row["ms"],
            "plain_ms": rng_row["plain_ms"], "bound_ms": rng_row["bound_ms"],
            "bound_by": rng_row["bound_by"],
            "library_ms": rng_row["library_ms"]})
    if have("cat", "cat_launches"):
        kernels += catalogue_kernels(r["cat"], r["cat_launches"])
    return kernels


if __name__ == "__main__":
    sys.exit(main())
