"""Measurement helpers shared by ``chip_smoke.py`` and ``bench_torch.py``:
the card's name and power limit, kernel and loop timing (CUDA events, the
host clock around synchronized work, torch.profiler), the least time the
card could take for each kernel's work (its roofline bound), launch
counters and plain-version call counters, the tensor ops a step issues,
Hungarian-matched cosines, and the synthetic catalogue the card runs use.

Like the scripts that call them, the timing functions take the ``torch``
module as their first argument. Nothing here runs at import.
"""

from __future__ import annotations

import contextlib
import subprocess
import time

import numpy as np


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, reps):
    """Device time of one call of ``fn``: the kernels' own durations in a
    profiled window of ``reps`` calls (torch.profiler), over ``reps``. Where
    a call's kernels are shorter than the host takes to issue them, CUDA
    events around the calls time the host; this times the card. None when
    the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
                 for e in prof.key_averages())
    return dev_us / 1e3 / reps if dev_us > 0 else None


def kernel_ms(torch, fn, reps):
    """(ms on the device, ms per call through the wrapper): the first is
    the kernel's time; it falls back to the second where the profiler
    records nothing."""
    wrapped = time_ms(torch, fn, reps)
    dev = device_ms(torch, fn, min(reps, 20))
    return (wrapped if dev is None else dev), wrapped


def time_ms(torch, fn, reps):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_seconds(torch, fn):
    """(wall seconds, result) of ``fn()`` and the card's work it enqueued;
    without a card the host clock alone."""
    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return time.perf_counter() - t0, out


def loop_rates(torch, gibbs, s, n, reps=1, warmup=20,
               warmup_accept_all=False):
    """Iterations per second of ``reps`` chunks of ``n`` iterations of the
    chunk loop alone (accept_all off, temperature 1) from the sampler's
    state after ``warmup`` iterations (accept_all ``warmup_accept_all``):
    (rates, the state reached, the last chunk's samples)."""
    temps = np.ones(max(n, warmup), np.float32)

    def chunk(state, m, accept_all=False):
        return gibbs.run_chunk(s.spec, s.data, s.hyperprior_params, state,
                               temps[:m], accept_all)

    state, samples = chunk(s.state, warmup, warmup_accept_all)
    rates = []
    for _ in range(reps):
        dt, (state, samples) = host_seconds(torch, lambda: chunk(state, n))
        rates.append(n / dt)
    return rates, state, samples


def matched_cosines(P_est, P_true):
    from scipy.optimize import linear_sum_assignment

    a = P_est / np.linalg.norm(P_est, axis=0, keepdims=True)
    b = P_true / np.linalg.norm(P_true, axis=0, keepdims=True)
    sim = a.T @ b
    rows, cols = linear_sum_assignment(-sim)
    return sim[rows, cols]


# NVIDIA H100 SXM peaks at 700 W (data sheet): HBM bandwidth and float32
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


F32_OPS_PER_S = 67e12


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): each input read once and each output written
    once over the memory rate, against the operations over the float32
    peak."""
    t_mem, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return (max(t_mem, t_ops) * 1e3,
            "bytes" if t_mem >= t_ops else "operations")


def fused_bound(K, N, G, C=1, rank=False):
    """The fused sweep (csrc/fused_sweeps.cu) at one call: bytes of its 22
    inputs and 12 outputs; operations of the hyper-sweep (~60 a parameter)
    and of the 2N column updates, each two passes over K*G entries of about
    8 and 20 operations and a rank-1 update of 2; with the rank branch N
    inclusion updates, each a pass of 8 operations and a rewrite of 4 over
    K*G entries."""
    kn, ng, kg = K * N, N * G, K * G
    n_in = kg + kn + ng + N + C * kg + 2 * kn + 2 * ng + 3 * kn + 3 * ng \
        + 2 * kn + 2 * ng + 3 * (N + 1) + 4 * (kn + ng) + 4 * (kn + ng)
    n_out = 2 * kn + 2 * ng + kg + N + 2 + 2 * kn + 2 * ng
    ops = 60 * (kn + ng) + 2 * N * kg * (8 + 20 + 2)
    if rank:
        ops += N * kg * (8 + 4)
    return bound(4 * C * (n_in + n_out), C * ops)


def pe_bound(K, N, G, C=1):
    """``fused_pe_sweeps`` at one call: bytes of its 17 inputs and 5
    outputs, operations of the 2N column updates (as in fused_bound)."""
    kn, ng, kg = K * N, N * G, K * G
    n_in = kg + kn + ng + N + C * kg + 2 * kn + 2 * ng + 3 * kn + 3 * ng \
        + 2 * kn + 2 * ng
    n_out = 2 * kn + 2 * ng + kg
    return bound(4 * C * (n_in + n_out), C * 2 * N * kg * (8 + 20 + 2))


# operations of one conditional-binomial split (csrc/allocation.cu): the
# inversion's set-up and 7 a step; BTRS's set-up with two Stirling lgammas
# and one round with two more, at ~36 a lgamma
INV_SETUP, INV_STEP, BTRS_OPS = 12, 7, 206


def alloc_bound(K, N, G, C, splits, planes):
    """The allocation (csrc/allocation.cu) at one call: bytes of M, P, A, E
    (and the uniform planes in planes mode) read once and of Zsum_g, Zsum_k
    written once; operations of the splits this run's draws need, counted
    on the plain version by ``count_splits`` (an inversion at the steps its
    drawn value needs, a BTRS split at one round; the Philox mode's own
    uniform generation is not counted)."""
    n_inv, inv_steps, n_btrs = splits[:3]
    n_in = K * G + C * (K * N + N + N * G)
    if planes:
        n_in += C * 17 * (n_leaves(N) - 1) * K * G
    n_out = C * (K * N + N * G)
    return bound(4 * (n_in + n_out),
                 n_inv * INV_SETUP + inv_steps * INV_STEP + n_btrs * BTRS_OPS)


def n_leaves(N):
    return 1 << max(int(np.ceil(np.log2(max(N, 1)))), 0)


# operations per (chain, k, g) element of each stream kernel beyond the
# Mhat rebuild (2N - 1): the formulas in csrc/stream_sweeps.cu, counting a
# division, log, log1p, max or accumulation as one
STREAM_OPS = {"pcol_stats": 11, "pcol_accept": 20, "erow_stats": 11,
              "erow_accept": 20, "acol_delta": 12, "chain_metrics": 12}


def stream_bound(name, K, N, G, C):
    n_in = K * G + C * (N * G + K * N)                    # data, E, PA
    if name != "chain_metrics":
        n_in += C * (G + K)                               # en, pn
    n_out = {"pcol_stats": 2 * K, "pcol_accept": 3 * K,
             "erow_stats": 2 * G, "erow_accept": 3 * G,
             "acol_delta": 1, "chain_metrics": 4}[name] * C
    if name == "pcol_accept":
        n_in += C * K
    elif name == "erow_accept":
        n_in += C * G
    elif name == "acol_delta":
        n_in += C
    ops = C * K * G * (2 * N - 1 + STREAM_OPS[name])
    return bound(4 * (n_in + n_out), ops)


# operations per entry of the metrics row's prior term (sqrt, two
# divisions, log, log_ndtr at ~20, the quadratic) and acceptance product
ROW_PRIOR_OPS = 35


# the exponential prior's term per entry (log, product, difference,
# comparison) and the acceptance product
ROW_EXP_PRIOR_OPS = 6


def metrics_row_bound(K, N, G, C, expo=False):
    """The metrics row (csrc/stream_sweeps.cu: the metrics tile and
    finishing kernels) at one call: data, E, P, A, both sides' prior pairs
    (one Lambda a side for the exponential prior) and acceptance records,
    the NaN events and the two chunk constants read once, the rows written
    once; operations: the Mhat rebuild and the four data terms per
    (c, k, g) (STREAM_OPS["chain_metrics"]), and the prior term and the
    acceptance product per entry of E and P."""
    planes = 3 if expo else 4
    n_in = K * G + C * (planes * (N * G + K * N) + N + 1) + 2
    n_out = 12 * C
    ops = (C * K * G * (2 * N - 1 + STREAM_OPS["chain_metrics"])
           + C * (N * G + K * N) * (ROW_EXP_PRIOR_OPS if expo
                                    else ROW_PRIOR_OPS))
    return bound(4 * (n_in + n_out), ops)


# operations of a column update's epilogue per entry (two conditionals, the
# draw with ndtr and ndtri, three log-densities with log_ndtr, exp), at ~20
# a special function
UPDATE_EPILOGUE_OPS = 150


def update_bound(col, K, N, G, C):
    """One column update (csrc/stream_sweeps.cu): data, E and P*A read once,
    the column's eight per-entry operands read and its two outputs written
    once; operations: one Mhat rebuild and both passes' terms per (c, k, g),
    and the epilogue per entry."""
    entries = C * (K if col else G)
    n_in = K * G + C * (N * G + K * N) + C * (G + K) + 8 * entries
    n_out = 2 * entries
    ops = (C * K * G * (2 * N - 1 + STREAM_OPS["pcol_stats"]
                        + STREAM_OPS["pcol_accept"])
           + entries * UPDATE_EPILOGUE_OPS)
    return bound(4 * (n_in + n_out), ops)


def acol_update_bound(K, N, G, C):
    """One A-column update (csrc/stream_sweeps.cu): data, E, P and A read
    once, the prior log-odds, the uniform and the temperature, A[:, n], the
    delta and the NaN count written once; operations: the Mhat rebuild and
    the term per (c, k, g), and ~30 for the decision per chain."""
    n_in = K * G + C * (N * G + K * N + N) + 2 * C + 1
    n_out = 3 * C
    ops = C * K * G * (2 * N - 1 + STREAM_OPS["acol_delta"]) + 30 * C
    return bound(4 * (n_in + n_out), ops)


# operations of the exact hyper-update per entry of P and E (two
# proposals, three log_ndtr at ~20 a special function, the Wilson-Hilferty
# terms), as fused_bound counts the hyper-sweep
HYPER_OPS = 60


def hyper_bound(K, N, G, C):
    """The exact hyper-update (csrc/stream_sweeps.cu: hyper_kernel) at one
    call: per entry of P and E, x, Mu, Sigmasq, two normals and two
    uniforms read once and Mu and Sigmasq written once (36 bytes), and
    HYPER_OPS operations."""
    entries = C * (K * N + N * G)
    return bound(36 * entries, HYPER_OPS * entries)


def synthetic(K, G, rank, seed=0, scale=500.0):
    """The synthetic recipe of phase 4: P ~ Dirichlet(0.3), E ~ Gamma(2,
    scale), M ~ Poisson. ``scale`` 500 at 96 rows; K / 96 times that keeps
    the counts a cell near the 96-row recipe's (8000 at 1536 rows)."""
    rng = np.random.default_rng(seed)
    P_true = rng.dirichlet(np.ones(K) * 0.3, rank).T
    E_true = rng.gamma(2.0, scale, (rank, G))
    return rng.poisson(P_true @ E_true).astype(np.float32), P_true


def profile_run(torch, fn):
    """torch.profiler over one call of ``fn`` and the card's work it
    enqueued: (device busy us, wall s, device events, host waits
    (aten::_local_scalar_dense), their host us). Without a card the device
    figures are 0."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0)) for e in ka)
    events = sum(e.count for e in ka
                 if getattr(e, "device_type", None) is not None
                 and "CUDA" in str(e.device_type))
    waits = [e for e in ka if e.key == "aten::_local_scalar_dense"]
    return (dev_us, wall, events, sum(e.count for e in waits),
            sum(e.cpu_time_total for e in waits))


def profile_loop(torch, gibbs, s, state, n):
    """torch.profiler over ``n`` iterations of the chunk loop from
    ``state``: (device busy us, wall s, device events, host waits
    (aten::_local_scalar_dense), their host us)."""
    return profile_run(torch, lambda: gibbs.run_chunk(
        s.spec, s.data, s.hyperprior_params, state, np.ones(n, np.float32),
        False))


# aten ops that make a view or an alias and launch nothing
VIEW_OPS = {"view", "_unsafe_view", "select", "slice", "unsqueeze", "squeeze",
            "expand", "permute", "transpose", "t", "reshape", "unflatten",
            "alias", "as_strided", "detach", "narrow", "split",
            "split_with_sizes", "unbind", "lift_fresh"}


def count_ops(torch, fn):
    """The tensor ops ``fn()`` issues, counted at PyTorch's dispatcher
    (views and aliases left out): (ops, host reads)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = reads = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.__name__.split(".")[0]
            if name not in VIEW_OPS:
                Count.n += 1
            Count.reads += name == "_local_scalar_dense"
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n, Count.reads


def reset_counts(FS, S, AL):
    """Every kernel wrapper's launch count to 0, and the gamma draws'
    rejection rounds (each round one launch of the draw kernel)."""
    from ..ops import distributions, rng

    FS.fused_gibbs_sweeps.launches = FS.fused_gibbs_sweeps.grid_launches = 0
    FS.fused_pe_sweeps.launches = 0
    S.reset_launch_counts()
    AL.allocate_counts.launches = 0
    rng.philox_fill.launches = 0
    distributions.gamma.rounds = 0


def launch_counters(FS, S, AL):
    """Every kernel wrapper's launch count, by name ("rng": the chains'
    draw kernel, csrc/rng.cu)."""
    from ..ops import rng

    return {"fused": FS.fused_gibbs_sweeps.launches,
            "fused_pe": FS.fused_pe_sweeps.launches,
            "_run": S._run.launches,
            "stream_acol_update": S.stream_acol_update.launches,
            "stream_metrics_row": S.stream_metrics_row.launches,
            "hyper_update": S.hyper_update.launches,
            "acol_delta": S.acol_delta.launches,
            "chain_metrics": S.chain_metrics.launches,
            "allocation": AL.allocate_counts.launches,
            "rng": rng.philox_fill.launches}


def draw_launches(gibbs, spec, steps: int, init: bool = False) -> int:
    """The draw kernel's launches over ``steps`` iterations of ``spec``'s
    path (with ``init``, the initial state's draws too), and one for each
    rejection round the gamma draws ran since the counts were reset:
    the exact count a window started by ``reset_counts`` must show."""
    from ..ops import distributions

    return (steps * gibbs.draw_launches(spec)
            + (gibbs.draw_launches(spec, init=True) if init else 0)
            + distributions.gamma.rounds)


def rng_bound(n_out: int, n_index: int = 0):
    """The draw kernel (csrc/rng.cu) at one call: the ``n_out`` float32
    draws written once and the int64 index map (``n_index`` entries) read
    once; operations ~25 integer operations an element (the Philox block's
    10 rounds over its four words) against the float32 rate."""
    return bound(4 * n_out + 8 * n_index, 25 * n_out)


@contextlib.contextmanager
def plain_calls(FS, S, AL):
    """Count the calls of every plain version that the kernels stand in for
    while the block runs: yields the counts (a dict the wrappers fill) and
    puts the plain versions back on exit."""
    calls, saved = {}, []
    from ..ops import rng

    for mod, names in ((FS, ("fused_gibbs_sweeps_reference",)),
                       (AL, ("allocate_counts_reference",)),
                       (rng, ("philox_fill_reference",)),
                       (S, ("run_reference", "acol_delta_reference",
                            "acol_update_reference", "chain_metrics_reference",
                            "stream_metrics_row_reference",
                            "pcol_update_reference",
                            "erow_update_reference",
                            "hyper_update_reference"))):
        for name in names:
            calls[name] = 0
            saved.append((mod, name, getattr(mod, name)))

            def wrapped(*a, _f=getattr(mod, name), _n=name, **k):
                calls[_n] += 1
                return _f(*a, **k)

            setattr(mod, name, wrapped)
    try:
        yield calls
    finally:
        for mod, name, f in saved:
            setattr(mod, name, f)
