#!/usr/bin/env python3
"""Benchmarks of the PyTorch/CUDA port on one NVIDIA GPU: the five BASELINE
configs of ``bench.py`` and the port's benchmark cells.

    python3 bench_torch.py                  # configs 2, 1, 3, 4, 5
    python3 bench_torch.py --config N       # one config (1..5)
    python3 bench_torch.py --all            # configs 1..5 in order
    python3 bench_torch.py --chains N [--eager]
    python3 bench_torch.py --bic
    python3 bench_torch.py --compact
    python3 bench_torch.py --cell NAME --seed S [--trace]

Each config prints one JSON line with ``bench.py``'s keys (``metric``,
``value``, ``unit``, ``vs_baseline`` and the config's extras) and adds the
card (``device``: its nvidia-smi name and power limit), the repetitions
(``reps``: every sample, their median and quartiles; ``value`` is all the
repetitions' work over all their time), the iterations each ran, the
kernel build's seconds (set-up, never inside a timed window) and
``correct``: every metrics row finite, each kernel of the
path launched its count per iteration, no plain version ran, and where the
truth is known, the signatures recovered. ``vs_baseline`` divides by
single-core NumPy mirrors of the reference's per-iteration work, copied
from ``bench.py`` with their arithmetic unchanged.

A cell (``CELLS``) prints each of its metrics as a JSON line (name, value,
unit, the samples) and then one summary line with ``correct`` and each
timed run's wall seconds split by layer on the host clock (the chunk loop,
the MAP checks, the checkpoints, the rest); ``--trace`` adds a profiled
window, separate from the timed ones, whose breakdown gives the ten device
operations that took the most time and the five longest device idle gaps,
each with the label of the layer the host was in (the
``torch.profiler.record_function`` spans this script puts around its calls
into the loop, the MAP estimate and the checkpoint).

Timing: CUDA events around many launches after a warm-up for kernels; the
host clock around work that ends in ``torch.cuda.synchronize()`` for loops
and fits; torch.profiler only for the busy share, events per iteration and
the breakdown, each in a run of its own. Fits write their log and
checkpoint to a temporary directory.

Without a card the script exits non-zero before any work. A config that
raises prints an ``error`` row, the remaining configs run, and the script
exits non-zero; so it does when a row is not ``correct``. The functions take
an explicit ``device`` so that the tests can call them on the CPU at tiny
sizes; the command line always runs on the card.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

import bayesnmf_tpu_torch as bt
from bayesnmf_tpu_torch.models import gibbs
from bayesnmf_tpu_torch.models import updates as U
from bayesnmf_tpu_torch.ops import _build
from bayesnmf_tpu_torch.ops import allocation as AL
from bayesnmf_tpu_torch.ops import distributions as D
from bayesnmf_tpu_torch.ops import fused_sweeps as FS
from bayesnmf_tpu_torch.ops import stream_sweeps as S
from bayesnmf_tpu_torch.ops.rng import ChainStreams
from bayesnmf_tpu_torch.parallel import chains as CH
from bayesnmf_tpu_torch.utils import measure as MS
from bayesnmf_tpu_torch.utils.cosmic import get_cosmic

BENCH_ITERS = 3000
BASELINE_ITERS = 20
# a streak limit no run reaches: a fit under such a control stops at maxiters
# and nowhere else, so every run of a cell does the same work
NEVER = 10 ** 9


def _sim_data(seed=0, K=96, N=8, G=500, scale=100.0):
    """bench.py's catalogue (bench.py:49), with the true P and E."""
    rng = np.random.default_rng(seed)
    P = rng.dirichlet(np.ones(K) * 0.5, N).T * scale
    E = rng.gamma(2.0, 2.0, (N, G))
    return rng.poisson(P @ E).astype(np.float32), P, E


# ---------------------------------------------------------------------------
# NumPy baselines (single core, reference algorithm shape), as bench.py has
# them
# ---------------------------------------------------------------------------


def baseline_numpy_mh(data, N, iters=BASELINE_ITERS, seed=1):
    """Single-core NumPy mirror of the reference's MH per-iteration work:
    sequential column sweep with TWO full KxG Mhat recomputations per column
    (sample_Pn.R:136,152) and 4 full loglik matrices per MH acceptance
    (sample_Pn.R:209-239), for both the P and E sweeps."""
    from scipy.special import gammaln

    rng = np.random.default_rng(seed)
    Kd, Gd = data.shape
    M = data.astype(np.float64)
    P = rng.gamma(1.0, 1.0, (Kd, N))
    E = rng.gamma(1.0, 1.0, (N, Gd))
    Mu_p, Sq_p = np.zeros((Kd, N)), np.ones((Kd, N))
    Mu_e, Sq_e = np.zeros((N, Gd)), np.ones((N, Gd))

    def pois_ll(M, lam):
        lam = np.maximum(lam, 1e-6)
        return M * np.log(lam) - lam - gammaln(M + 1)

    def norm_ll(M, mean, var):
        return -0.5 * (M - mean) ** 2 / var - 0.5 * np.log(2 * np.pi * var)

    t0 = time.perf_counter()
    for _ in range(iters):
        for n in range(N):
            Mh = P @ E                           # full matmul (as reference)
            sig = Mh.copy()
            Pc = P.copy(); Pc[:, n] = 0
            Mh_no_n = Pc @ E                     # second full matmul
            resid = (M - Mh_no_n) / np.maximum(sig, 1e-6)
            mu1 = resid @ E[n]
            den = (1 / np.maximum(sig, 1e-6)) @ (E[n] ** 2) + 1 / Sq_p[:, n]
            mu = (mu1 + Mu_p[:, n] / Sq_p[:, n]) / den
            prop = np.maximum(mu + rng.normal(size=Kd) / np.sqrt(den), 0)
            Pp = P.copy(); Pp[:, n] = prop
            Mh_prop = Pp @ E
            lp_old = pois_ll(M, Mh).sum(1)
            lp_new = pois_ll(M, Mh_prop).sum(1)
            ln_old = norm_ll(M, Mh, np.maximum(Mh_prop, 1)).sum(1)
            ln_new = norm_ll(M, Mh_prop, np.maximum(Mh, 1)).sum(1)
            # min(exp(d), 1) == exp(min(d, 0)): clamp so np.exp can't overflow
            ratio = np.exp(np.minimum(lp_new + ln_old - lp_old - ln_new, 0.0))
            acc = rng.random(Kd) < ratio
            P[acc, n] = prop[acc]
        for n in range(N):
            Mh = P @ E
            sig = Mh.copy()
            Ec = E.copy(); Ec[n] = 0
            Mh_no_n = P @ Ec
            resid = (M - Mh_no_n) / np.maximum(sig, 1e-6)
            mu1 = P[:, n] @ resid
            den = (P[:, n] ** 2) @ (1 / np.maximum(sig, 1e-6)) + 1 / Sq_e[n]
            mu = (mu1 + Mu_e[n] / Sq_e[n]) / den
            prop = np.maximum(mu + rng.normal(size=Gd) / np.sqrt(den), 0)
            Ep = E.copy(); Ep[n] = prop
            Mh_prop = P @ Ep
            lp_old = pois_ll(M, Mh).sum(0)
            lp_new = pois_ll(M, Mh_prop).sum(0)
            ln_old = norm_ll(M, Mh, np.maximum(Mh_prop, 1)).sum(0)
            ln_new = norm_ll(M, Mh_prop, np.maximum(Mh, 1)).sum(0)
            ratio = np.exp(np.minimum(lp_new + ln_old - lp_old - ln_new, 0.0))
            acc = rng.random(Gd) < ratio
            E[n, acc] = prop[acc]
    return iters / (time.perf_counter() - t0)


def baseline_numpy_gibbs(data, N, iters=BASELINE_ITERS, seed=1):
    """NumPy mirror of the conjugate Poisson-Gibbs iteration: the K*G
    per-cell rmultinom latent-count loop (sample_Zkg, sample_params.R:253-265)
    followed by per-column Gamma draws for P and E (sample_Pn.R:98-120)."""
    rng = np.random.default_rng(seed)
    Kd, Gd = data.shape
    M = data.astype(np.int64)
    P = rng.gamma(1.0, 1.0, (Kd, N))
    E = rng.gamma(1.0, 1.0, (N, Gd))
    t0 = time.perf_counter()
    for _ in range(iters):
        Zsum_g = np.zeros((Kd, N))
        Zsum_k = np.zeros((N, Gd))
        for k in range(Kd):          # the reference's double loop over cells
            pk = P[k]
            for g in range(Gd):
                w = pk * E[:, g]
                s = w.sum()
                if s <= 0 or M[k, g] == 0:
                    continue
                z = rng.multinomial(M[k, g], w / s)
                Zsum_g[k] += z
                Zsum_k[:, g] += z
        P = rng.gamma(1.0 + Zsum_g, 1.0 / (1.0 + E.sum(axis=1))[None, :])
        E = rng.gamma(1.0 + Zsum_k, 1.0 / (1.0 + P.sum(axis=0))[:, None])
    return iters / (time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def sync(device):
    if on_card(device):
        torch.cuda.synchronize()


def device_info(device) -> dict:
    """The card's nvidia-smi name and power limit in W (None where
    nvidia-smi gives none); on the CPU the name "cpu"."""
    if not on_card(device):
        return {"name": "cpu", "power_limit_w": None}
    name, _, limit = MS.card_line().partition(",")
    try:
        watts = float(limit.strip().split()[0])
    except (ValueError, IndexError):
        watts = None
    return {"name": name.strip(), "power_limit_w": watts}


def summary(samples, work=None) -> dict:
    """Every sample with their median and quartiles, and ``value``: with
    ``work`` (each sample a rate, ``work`` the iterations it ran) all the
    work over all the time, sum(work) / sum(work / rate), so that a slow
    run weighs by its time; else the median."""
    a = np.asarray(samples, float)
    q1, med, q3 = np.percentile(a, [25, 50, 75])
    out = {"n": len(a), "samples": [float(x) for x in a],
           "median": float(med), "q1": float(q1), "q3": float(q3),
           "value": float(med)}
    if work is not None:
        w = np.asarray(work, float)
        out |= {"value": float(w.sum() / (w / a).sum()),
                "work": [float(x) for x in w]}
    return out


@contextlib.contextmanager
def phase_clock(methods):
    """Host seconds spent in each of ``methods`` ([(class, name, label)])
    while the block runs, by label; a call made inside another counts for
    the inner label only. The methods are put back on exit."""
    secs = {label: 0.0 for _, _, label in methods}
    inner = []      # the seconds of the calls made inside each open call
    saved = []
    for cls, name, label in methods:
        f = getattr(cls, name)
        saved.append((cls, name, f, name in vars(cls)))

        @functools.wraps(f)
        def wrapped(*a, _f=f, _label=label, **k):
            inner.append(0.0)
            t0 = time.perf_counter()
            try:
                return _f(*a, **k)
            finally:
                dt = time.perf_counter() - t0
                secs[_label] += dt - inner.pop()
                if inner:
                    inner[-1] += dt

        setattr(cls, name, wrapped)
    try:
        yield secs
    finally:
        for cls, name, f, own in reversed(saved):
            if own:
                setattr(cls, name, f)
            else:
                delattr(cls, name)


def call_ms(fn, reps, device):
    """ms per call of ``fn``: CUDA events around ``reps`` calls after a
    warm-up on the card, the host clock on the CPU."""
    if on_card(device):
        return MS.time_ms(torch, fn, reps)
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


@contextlib.contextmanager
def counted(device):
    """Each kernel wrapper's launches, the gamma draws' rejection rounds and
    the plain versions' calls over the block: yields a dict that gets
    ``launches``, ``rounds``, ``plain`` and ``on_card`` on exit. On the CPU
    the plain versions are the path and nothing is launched."""
    out = {"on_card": on_card(device)}
    MS.reset_counts(FS, S, AL)
    with MS.plain_calls(FS, S, AL) as calls:
        yield out
        sync(device)
    out["launches"] = MS.launch_counters(FS, S, AL)
    out["rounds"] = D.gamma.rounds
    out["plain"] = sum(calls.values())


def launches_ok(cnt, per_iter, steps, spec, init=False) -> bool:
    """Every counter at its launches per iteration times ``steps``, the
    draw kernel's (csrc/rng.cu) at ``spec``'s path's draws a step times
    ``steps`` and one a rejection round (with ``init``: the initial
    state's draws too, and its allocation on the conjugate path), the
    hyper-update's at ``spec``'s path's launches a step, every other
    counter 0, and no plain version called; True on the CPU, where
    nothing is launched."""
    if not cnt["on_card"]:
        return True
    want = {k: per_iter.get(k, 0) * steps for k in cnt["launches"]}
    want["hyper_update"] = steps * gibbs.hyper_launches(spec)
    want["rng"] = (steps * gibbs.draw_launches(spec) + cnt["rounds"]
                   + (gibbs.draw_launches(spec, init=True) if init else 0))
    if init and spec.needs_Z:
        want["allocation"] += 1
    return cnt["launches"] == want and cnt["plain"] == 0


@contextlib.contextmanager
def captured(mod, name):
    """Keep the arguments of each call of ``mod.name`` made in the block;
    the function still runs."""
    calls = []
    f = getattr(mod, name)

    # the wrapper carries the function's attributes (its launch count),
    # which the function reaches through its module name while wrapped
    @functools.wraps(f)
    def wrapped(*a, **k):
        calls.append((a, k))
        return f(*a, **k)

    setattr(mod, name, wrapped)
    try:
        yield calls
    finally:
        setattr(mod, name, f)


def fixed_work(maxiters, MAP_over, MAP_every):
    """A control under which a run stops at maxiters and nowhere else."""
    return bt.ConvergenceControl(MAP_over=MAP_over, MAP_every=MAP_every,
                                 miniters=0, maxiters=maxiters,
                                 Ninarow_nochange=NEVER, Ninarow_nobest=NEVER)


def recovery(P_est, P_true, bar):
    """(whether every estimated signature matches a true one at a cosine of
    at least ``bar``, the least such cosine): Hungarian-matched, so the
    order of the columns does not matter."""
    low = float(MS.matched_cosines(np.asarray(P_est, float),
                                   np.asarray(P_true, float)).min())
    return low >= bar, low


def window_mean_P(samples):
    """A chunk's posterior mean of P (one chain's (steps, K, N) records)."""
    return samples["P"].double().mean(0).cpu().numpy()


def loop_rates(device, s, iters, reps, warmup=200):
    """it/s of ``reps`` chunks of ``iters`` iterations of gibbs.run_chunk
    (accept_all off, temperature 1, as bench.py times them) from the
    sampler's state after ``warmup`` iterations of a fit's warm-up phase
    (accept_all on with MH): (rates, counts over the warm-up and the timed
    chunks, the last chunk's samples)."""
    with counted(device) as cnt:
        rates, _, samples = MS.loop_rates(torch, gibbs, s, iters, reps,
                                          warmup, s.spec.MH)
    return rates, cnt, samples


def finite(x) -> bool:
    a = x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x, float)
    return bool(np.isfinite(a).all())


def ensemble_finite(ens) -> bool:
    """Every metrics row an ensemble's resident chains wrote is finite (a
    chain off the device has NaN rows)."""
    rows = ens._metrics_all()
    rows = rows[~np.isnan(rows[..., 0])]
    return rows.shape[0] > 0 and bool(np.isfinite(rows).all())


def config_row(metric, rates, unit, device, base=None, work=None, **extra):
    """A config's row: bench.py's keys, the card and the repetitions; with
    ``work`` (each rate's iterations) the value is all the work over all
    the time (``summary``)."""
    reps = summary(rates, work)
    row = {"metric": metric, "value": round(reps["value"], 2), "unit": unit,
           "vs_baseline": (round(reps["value"] / base, 2) if base else None)}
    return row | extra | {"reps": reps, "device": device_info(device)}


# ---------------------------------------------------------------------------
# the five BASELINE configs
# ---------------------------------------------------------------------------


def config1(device="cuda", iters=BENCH_ITERS, reps=3, baseline_iters=5,
            K=96, G=100, warmup=200):
    """96x100 Poisson-Exponential Gibbs, fixed K=5: the conjugate step
    through the allocation kernel (csrc/allocation.cu)."""
    data, P_true, _ = _sim_data(seed=0, K=K, N=5, G=G)
    s = bt.GibbsSampler(data, 5, prior="exponential", MH=False,
                        device=device, verbosity=0, seed=0)
    rates, cnt, samples = loop_rates(device, s, iters, reps, warmup)
    ok, low = recovery(window_mean_P(samples), P_true, 0.9)
    base = baseline_numpy_gibbs(data, 5, iters=baseline_iters)
    correct = (ok and finite(samples["metrics"])
               and launches_ok(cnt, {"allocation": 1}, iters * reps + warmup,
                               s.spec))
    return config_row(
        f"gibbs_iters_per_sec_{K}x{G}_K5_poisson_exp_gibbs", rates,
        "iterations/sec/chip", device, base, work=[iters] * reps,
        iters=iters, matched_cosine_min=round(low, 4),
        launches=cnt.get("launches"), correct=bool(correct))


def config2(device="cuda", iters=BENCH_ITERS, reps=3,
            baseline_iters=BASELINE_ITERS, K=96, G=500, warmup=200):
    """96x500 Poisson-TruncNormal+MH fixed K=8 (the headline), default
    flags: the sampler resolves the fused kernel (csrc/fused_sweeps.cu)."""
    data, P_true, _ = _sim_data(seed=0, K=K, N=8, G=G)
    s = bt.GibbsSampler(data, 8, device=device, verbosity=0, seed=0)
    rates, cnt, samples = loop_rates(device, s, iters, reps, warmup)
    ok, low = recovery(window_mean_P(samples), P_true, 0.9)
    base = baseline_numpy_mh(data, 8, iters=baseline_iters)
    correct = (ok and s.spec.fused_sweeps and finite(samples["metrics"])
               and launches_ok(cnt, {"fused": 1}, iters * reps + warmup,
                               s.spec))
    return config_row(
        f"gibbs_iters_per_sec_{K}x{G}_K8_poisson_truncnormal_MH", rates,
        "iterations/sec/chip", device, base, work=[iters] * reps,
        default_flags=True, iters=iters,
        matched_cosine_min=round(low, 4),
        launches=cnt.get("launches"), correct=bool(correct))


def config3(device="cuda", iters=BENCH_ITERS, reps=3, baseline_iters=5,
            K=96, N=20, G=1000, warmup=200):
    """SBFI rank learning K in 1..20 on 96x1000 through the fused kernel's
    rank branch, and the fixed rank 20 at the same size."""
    data, _, _ = _sim_data(seed=0, K=K, N=N, G=G)
    rows = {}
    for rank in (list(range(1, N + 1)), N):
        s = bt.GibbsSampler(data, rank, rank_method="SBFI",
                            device=device, verbosity=0, seed=0)
        rates, cnt, samples = loop_rates(device, s, iters, reps, warmup)
        A = samples["A"].cpu().numpy()
        ok = (s.spec.fused_sweeps and finite(samples["metrics"])
              and launches_ok(cnt, {"fused": 1}, iters * reps + warmup,
                              s.spec)
              and bool(np.isin(A, (0.0, 1.0)).all()))
        rows[isinstance(rank, list)] = (rates, cnt, ok, int(A[-1].sum()))
    rates, cnt, ok, learned = rows[True]
    fixed_rates, fixed_cnt, fixed_ok, _ = rows[False]
    fixed = summary(fixed_rates, [iters] * reps)
    base = baseline_numpy_mh(data, N, iters=baseline_iters)
    row = config_row(
        f"sbfi_iters_per_sec_{K}x{G}_K1to{N}", rates, "iterations/sec/chip",
        device, base, work=[iters] * reps,
        fixed_rank_iters_per_sec=round(fixed["value"], 2), iters=iters,
        rank_at_end=learned, launches=cnt.get("launches"),
        fixed_rank_reps=fixed, correct=bool(ok and fixed_ok))
    row["rank_learning_overhead_x"] = round(
        fixed["value"] / row["reps"]["value"], 3)
    return row


def config4(device="cuda", G=2780, maxiters=1200, miniters=600,
            MAP_over=300, MAP_every=150, post_warmup=300):
    """PCAWG-scale end-to-end: a 96x2780 fit from 6 COSMIC signatures, then
    the COSMIC ensemble assignment. Seconds: a cold fit (the first at this
    shape in the process; the kernel build is set-up, done before), then a
    warm fit and the assignment."""
    import pandas as pd

    cosmic = get_cosmic()
    rng = np.random.default_rng(0)
    sig_idx = rng.choice(cosmic.shape[1], 6, replace=False)
    P_true = cosmic.to_numpy()[:, sig_idx]
    E_true = rng.gamma(1.5, 200.0, (6, G))
    data = rng.poisson(P_true @ E_true).astype(np.float32)
    df = pd.DataFrame(data, index=list(cosmic.index))
    cc = bt.ConvergenceControl(
        MAP_over=MAP_over, MAP_every=MAP_every, miniters=miniters,
        maxiters=maxiters, Ninarow_nochange=3, Ninarow_nobest=5)

    def one_fit(seed):
        with tempfile.TemporaryDirectory() as tmp, \
                counted(device) as cnt:
            def run():
                s = bt.GibbsSampler(
                    df, 6, likelihood="poisson", prior="truncnormal",
                    MH=True, convergence_control=cc, post_warmup=post_warmup,
                    fused_sweeps=True, output_dir=os.path.join(tmp, "fit"),
                    seed=seed, device=device, verbosity=0)
                return s.run_gibbs_sampler()

            secs, s = MS.host_seconds(torch, run)
        return s, secs, cnt

    _, cold_s, _ = one_fit(0)
    s, fit_s, cnt = one_fit(1)
    assign_s, res = MS.host_seconds(
        torch, lambda: s.assign_signatures_ensemble("cosmic"))
    cos = res["assignments"]["MAP_cosine"].to_numpy(float)
    ok, low = recovery(s.MAP["P"], P_true, 0.95)
    correct = (ok and finite(s.sample_metrics.to_numpy(float))
               and launches_ok(cnt, {"fused": 1}, s.iter - 1, s.spec,
                               init=True))
    return config_row(
        f"pcawg_scale_96x{G}_end_to_end", [fit_s + assign_s], "seconds",
        device, cold_fit_seconds=round(cold_s, 2),
        fit_seconds=round(fit_s, 2), assign_seconds=round(assign_s, 2),
        iters=int(s.iter), iters_per_sec=round(s.iter / fit_s, 2),
        mean_MAP_cosine=round(float(np.nanmean(cos)), 4),
        matched_cosine_min=round(low, 4),
        launches=cnt.get("launches"), correct=bool(correct))


def _chain_run(device, data, rank, n_chains, iters, stream, **ens_kw):
    """chain-it/s of ``chains.run_chunk_chains`` over ``iters`` iterations,
    after a warm-up of the same length, on the path ChainEnsemble resolves
    for ``stream_sweeps=stream``: (rate, path, correct, counts)."""
    ens = bt.ChainEnsemble(data, rank, n_chains=n_chains,
                           stream_sweeps=stream, store_E=False,
                           periodic_save=False, device=device, **ens_kw)
    spec = ens.spec
    if spec.stream_sweeps:
        path = "stream"
        per_iter = {"_run": 3 * spec.N, "stream_metrics_row": 1}
        if spec.learning_rank:
            per_iter["stream_acol_update"] = spec.N
    else:
        path = "fused" if spec.fused_sweeps else "eager"
        per_iter = {"fused": 1} if spec.fused_sweeps else {}
    acc = torch.zeros(n_chains, dtype=torch.bool, device=device)
    temps = np.ones(iters, np.float32)

    def chunk(states):
        return CH.run_chunk_chains(spec, ens.data, ens.hp, states, temps,
                                   acc, store_E=False)

    ens.states, _ = chunk(ens.states)
    with counted(device) as cnt:
        dt, (states, samples) = MS.host_seconds(
            torch, lambda: chunk(ens.states))
    ok = finite(samples["metrics"]) and launches_ok(cnt, per_iter, iters,
                                                    spec)
    return n_chains * iters / dt, path, bool(ok), cnt


def _release():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _g(G):
    return f"{G // 1000}k" if G % 1000 == 0 and G >= 10000 else str(G)


def config5(device="cuda", n_chains=64, G_big=25000, iters=50,
            full_chains=256, full_G=100_000, full_iters=10, K=96):
    """Many chains at large G on one card: 64 chains x 96x25000 on the
    streaming kernels and on the path ChainEnsemble resolves without them
    (the fused kernel), then the full BASELINE config 5, 256 chains x
    96x100k with SBFI over ranks 1..8, on the streaming kernels."""
    data, _, _ = _sim_data(seed=0, K=K, N=8, G=G_big, scale=50.0)
    rate, _, ok, cnt = _chain_run(device, data, 8, n_chains, iters,
                                  True)
    _release()
    other, path, other_ok, _ = _chain_run(device, data, 8, n_chains,
                                          iters, False)
    del data
    _release()
    data_f, _, _ = _sim_data(seed=0, K=K, N=8, G=full_G, scale=50.0)
    full, _, full_ok, full_cnt = _chain_run(
        device, data_f, list(range(1, 9)), full_chains, full_iters,
        True, rank_method="SBFI")
    _release()
    return config_row(
        f"chain_iters_per_sec_{n_chains}chains_{K}x{_g(G_big)}_MH", [rate],
        "chain-iterations/sec/chip", device, iters=iters,
        **{f"{path}_path_chain_iters_per_sec": round(other, 2),
           f"stream_vs_{path}_x": round(rate / other, 3),
           f"full_scale_{full_chains}chains_{K}x{_g(full_G)}_SBFI_chain_"
           "iters_per_sec": round(full, 2)},
        full_scale_iters=full_iters, launches=cnt.get("launches"),
        full_scale_launches=full_cnt.get("launches"),
        correct=ok and other_ok and full_ok)


CONFIGS = {1: config1, 2: config2, 3: config3, 4: config4, 5: config5}


def bench_chains(device="cuda", n_chains=8, iters=100, eager=False, K=96,
                 G=500):
    """N-chain throughput at config 2's size: the fused kernel over the
    chains (ChainEnsemble's default there), or with ``eager`` the
    chain-batched eager sweeps (fused_sweeps=False)."""
    data, _, _ = _sim_data(seed=0, K=K, N=8, G=G)
    rate, path, ok, cnt = _chain_run(device, data, 8, n_chains, iters,
                                     None, fused_sweeps=not eager)
    return config_row(
        f"chain_iters_per_sec_{n_chains}chains_{K}x{G}_K8_MH_{path}", [rate],
        "chain-iterations/sec/chip", device, iters=iters,
        launches=cnt.get("launches"), correct=ok)


def bench_bic(device="cuda", ranks=range(1, 9), K=96, G=500, maxiters=800,
              miniters=400, MAP_over=200, MAP_every=100, post_warmup=200):
    """Parallel (one masked ensemble) against serial (one fit per rank)
    min-BIC rank search, wall-clock of a second run of each."""
    data, _, _ = _sim_data(seed=0, K=K, N=4, G=G)
    cc = bt.ConvergenceControl(
        MAP_over=MAP_over, MAP_every=MAP_every, miniters=miniters,
        maxiters=maxiters, Ninarow_nochange=3, Ninarow_nobest=5)

    def run(parallel, seed):
        with tempfile.TemporaryDirectory() as tmp:
            return MS.host_seconds(torch, lambda: bt.fit(
                data, list(ranks), rank_method="BIC",
                convergence_control=cc, output_dir=os.path.join(tmp, "bic"),
                parallel_bic=parallel, seed=seed, post_warmup=post_warmup,
                device=device))

    run(True, 0)
    t_par, out_p = run(True, 1)
    run(False, 0)
    t_ser, out_s = run(False, 1)
    return config_row(
        f"bic_search_{len(list(ranks))}ranks_{K}x{G}_speedup",
        [t_ser / t_par], "x vs serial loop", device,
        parallel_seconds=round(t_par, 2), serial_seconds=round(t_ser, 2),
        best_rank=int(out_p["best_rank"]),
        serial_best_rank=int(out_s["best_rank"]),
        correct=out_p["best_rank"] == out_s["best_rank"])


def bench_compaction(device="cuda", n_chains=32, K=96, G=500, maxiters=3000,
                     miniters=200, MAP_over=100, MAP_every=50,
                     post_warmup=200):
    """Wall-clock of a staggered-convergence ensemble with live-chain
    compaction on and off (bench.py's mode): the ratio of the two runs'
    seconds. Each chain draws from its own stream, which compaction leaves
    as it was, so both runs do the same statistical work: ``correct``
    demands equal chain-iterations inside the chains' own runs
    (``ChainEnsemble.throughput``'s count), the same per-chain end
    iterations, finite metrics and a MAP for every chain."""
    data, _, _ = _sim_data(seed=0, K=K, N=8, G=G)
    # tight tolerance and a noisy no-best gate: the chains converge at
    # different checks
    cc = bt.ConvergenceControl(
        MAP_over=MAP_over, MAP_every=MAP_every, miniters=miniters,
        maxiters=maxiters, Ninarow_nochange=2, Ninarow_nobest=6, tol=5e-5)

    def run(compact):
        with tempfile.TemporaryDirectory() as tmp:
            return MS.host_seconds(torch, lambda: bt.ChainEnsemble(
                data, 8, n_chains=n_chains, convergence_control=cc,
                post_warmup=post_warmup, seed=1,
                output_dir=os.path.join(tmp, "ens"), compact=compact,
                store_E=False, device=device).run())

    run(True)
    t_c, ens_c = run(True)
    run(False)
    t_n, ens_n = run(False)
    work_c, work_n = ens_c._chain_iters, ens_n._chain_iters
    ok = (all(ensemble_finite(e) and all(m is not None
                                         for m in e.MAP_per_chain)
              for e in (ens_c, ens_n))
          and work_c == work_n
          and np.array_equal(ens_c._end_iter, ens_n._end_iter))
    return config_row(
        f"ensemble_compaction_{n_chains}chains_{K}x{G}", [t_n / t_c],
        "x wall-clock speedup, compaction off over on", device,
        compact_seconds=round(t_c, 2), no_compact_seconds=round(t_n, 2),
        compact_chain_iters=int(work_c), no_compact_chain_iters=int(work_n),
        iters=int(ens_c.iter), no_compact_iters=int(ens_n.iter),
        final_resident=int(ens_c._slots.size), correct=bool(ok))


# ---------------------------------------------------------------------------
# the port's benchmark cells
# ---------------------------------------------------------------------------

# device operations in a chrome trace of torch.profiler
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def breakdown(events, labels, top=10, gaps=5) -> dict:
    """From a torch.profiler chrome trace's events: the ``top`` device
    operations by total time, and the ``gaps`` longest idle gaps of the
    device between its first and last operation, each with the ``labels``
    span (record_function) and the innermost host op open at its middle."""
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                  e["name"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
             e["name"], e.get("cat")) for e in events
            if e.get("ph") == "X"
            and e.get("cat") in ("user_annotation", "cpu_op")]
    by_name: dict = {}
    for t0, t1, name in dev:
        us, n = by_name.get(name, (0.0, 0))
        by_name[name] = (us + t1 - t0, n + 1)
    idle, end, busy = [], None, 0.0
    for t0, t1, _ in dev:
        if end is not None and t0 > end:
            idle.append((end, t0))
        busy += max(0.0, t1 - (t0 if end is None else max(t0, end)))
        end = t1 if end is None else max(end, t1)

    def open_at(t, cat, names=None):
        spans = [h for h in host if h[3] == cat and h[0] <= t <= h[1]
                 and (names is None or h[2] in names)]
        return min(spans, key=lambda h: h[1] - h[0])[2] if spans else None

    first = dev[0][0] if dev else 0.0
    return {
        "top_device_ops": [
            {"name": name, "ms": us / 1e3, "count": n}
            for name, (us, n) in sorted(by_name.items(),
                                        key=lambda kv: -kv[1][0])[:top]],
        "idle_gaps": [
            {"ms": (b - a) / 1e3, "at_ms": (a - first) / 1e3,
             "layer": open_at((a + b) / 2, "user_annotation", labels),
             "host_op": open_at((a + b) / 2, "cpu_op")}
            for a, b in sorted(idle, key=lambda g: g[0] - g[1])[:gaps]],
        "device_busy_ms": busy / 1e3,
        "window_ms": ((end - first) / 1e3) if dev else 0.0}


def traced(device, steps) -> dict:
    """A profiled window of ``steps`` [(label, fn)], each call inside a
    record_function span of its label; returns ``breakdown`` of it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if on_card(device):
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for label, fn in steps:
            with record_function(label):
                fn()
        sync(device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return breakdown(events, {label for label, _ in steps})


def busy_metrics(device, fn, n) -> dict:
    """device_busy_share and device_events_per_iter of a profiled window of
    ``fn`` (``n`` iterations); None where the profiler records no device
    time (on the CPU, or a profiler that cannot see the card)."""
    if not on_card(device):
        return {"device_busy_share": None, "device_events_per_iter": None}
    dev_us, wall, events, _, _ = MS.profile_run(torch, fn)
    if dev_us <= 0:
        return {"device_busy_share": None, "device_events_per_iter": None}
    return {"device_busy_share": summary([dev_us / 1e6 / wall]),
            "device_events_per_iter": summary([events / n])}


def layer_ms(fn, device, reps) -> list:
    """Host-clock ms of ``reps`` calls of ``fn``, each ending in a
    synchronize (the MAP estimate and the checkpoint: host work around the
    card's)."""
    return [MS.host_seconds(torch, fn)[0] * 1e3 for _ in range(reps)]


def share(bound_ms, ms):
    return None if not ms else bound_ms / ms


BL2_METRICS = {
    "iterations_per_sec": ("iterations/s", "end_to_end"),
    "loop_iterations_per_sec": ("iterations/s", "layer"),
    "fused_kernel_ms": ("ms", "layer"),
    "fused_bound_ms": ("ms", "layer"),
    "fused_roofline_share": ("fraction", "layer"),
    "map_check_ms": ("ms", "layer"),
    "checkpoint_ms": ("ms", "layer"),
    "device_busy_share": ("fraction", "layer"),
    "device_events_per_iter": ("events/iteration", "layer"),
}


def timed_runs(n, warmups, run):
    """``warmups`` calls of ``run(i)`` that do not count, then ``n`` that
    do: each returns (wall seconds, its host seconds by phase, the rest);
    ``other`` completes the phases, the wall seconds in none of them.
    Returns ([(wall, phases, rest)] of the counted calls, the warm-ups'
    walls)."""
    out, warm = [], []
    for i in range(warmups + n):
        wall, phases, rest = run(i)
        phases = {k: round(v, 4) for k, v in phases.items()}
        phases["other"] = round(wall - sum(phases.values()), 4)
        (out if i >= warmups else warm).append((wall, phases, rest))
    return out, [w for w, _, _ in warm]


# the sampler's layers inside a fit, for the host-clock split of its wall
FIT_PHASES = ((bt.GibbsSampler, "_run_chunk", "loop"),
              (bt.GibbsSampler, "_map_check", "map_check"),
              (bt.GibbsSampler, "save_object", "checkpoint"))


def cell_bl2_fit_96x500_k8(device="cuda", seed=0, G=500, rank=8,
                           maxiters=2500, post_warmup=500, MAP_over=500,
                           MAP_every=100, fits=5, warmups=5, loop_iters=500,
                           loop_reps=3, loop_warmup=200, prof_iters=50,
                           kernel_reps=200, layer_reps=5,
                           trace=False) -> dict:
    """BASELINE config 2's model, fit end to end: ``fit(M, 8)`` with default
    flags (the fused kernel) on a 96x500 catalogue of true rank 8 made from
    ``seed``; ``warmups`` fits with chain seed ``seed``, then ``fits`` timed
    ones with chain seeds seed..seed+fits-1, each stopping at maxiters +
    post_warmup. The end-to-end rate is all the timed fits' iterations over
    all their wall seconds; each fit's rate and its wall split by layer
    (the chunk loop, the MAP checks, the checkpoints, the rest) are kept
    beside it.

    The warm-ups are many because a process's first fits are slow in their
    checkpoints: pickling the archive allocates a copy of each of its
    arrays, and those copies page-fault until glibc's adaptive mmap
    threshold has grown past them, which takes about five fits of this
    size. The cell measures that steady state; the warm-ups' rates, the
    first fit's in a fresh process among them, are kept beside it."""
    M, P_true = MS.synthetic(96, G, rank, seed)
    cc = fixed_work(maxiters, MAP_over, MAP_every)
    checks, last = [], []

    def one_fit(i):
        with tempfile.TemporaryDirectory() as tmp, \
                counted(device) as cnt, phase_clock(FIT_PHASES) as phases:
            wall, s = MS.host_seconds(torch, lambda: bt.fit(
                M, rank, device=device, output_dir=os.path.join(tmp, "fit"),
                convergence_control=cc, post_warmup=post_warmup,
                seed=seed + max(i - warmups, 0)))
        ok, low = recovery(s.MAP["P"], P_true, 0.95)
        checks.append(bool(
            ok and s.spec.fused_sweeps
            and finite(s.sample_metrics.to_numpy(float))
            and launches_ok(cnt, {"fused": 1}, s.iter - 1, s.spec,
                            init=True)))
        last[:] = [s]   # only the newest fit stays alive
        return wall, phases, (int(s.iter), low)

    runs, warm = timed_runs(fits, warmups, one_fit)
    iters = [n for _, _, (n, _) in runs]
    rates = [n / wall for n, (wall, _, _) in zip(iters, runs)]
    cos_min = [low for _, _, (_, low) in runs]
    s = last[0]

    # the layers, on the last fit's sampler
    loop, _, _ = loop_rates(device, s, loop_iters, loop_reps,
                            loop_warmup)
    with captured(gibbs, "fused_gibbs_sweeps") as calls:
        gibbs.gibbs_step(s.spec, s.data, s.hyperprior_params, s.state, 1.0,
                         False)
    a, k = calls[0]
    kern = call_ms(lambda: FS.fused_gibbs_sweeps(*a, **k),
                   kernel_reps, device)
    bound_ms, bound_by = MS.fused_bound(96, rank, G)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "sampler.ckpt")
        map_ms = layer_ms(s.get_MAP, device, layer_reps)
        ckpt_ms = layer_ms(lambda: s.save_object(ckpt), device, layer_reps)
        busy = busy_metrics(device, lambda: gibbs.run_chunk(
            s.spec, s.data, s.hyperprior_params, s.state,
            np.ones(prof_iters, np.float32), False), prof_iters)
        brk = None
        if trace:
            st = [s.state]

            def chunk():
                st[0] = gibbs.run_chunk(
                    s.spec, s.data, s.hyperprior_params, st[0],
                    np.ones(MAP_every, np.float32), False)[0]

            brk = traced(device, [
                (label, fn) for _ in range(3) for label, fn in (
                    ("bench/loop", chunk), ("bench/MAP", s.get_MAP),
                    ("bench/checkpoint", lambda: s.save_object(ckpt)))])

    metrics = {
        "iterations_per_sec": summary(rates, iters),
        "loop_iterations_per_sec": summary(loop, [loop_iters] * loop_reps),
        "fused_kernel_ms": summary([kern]),
        "fused_bound_ms": summary([bound_ms]),
        "fused_roofline_share": summary([share(bound_ms, kern)]),
        "map_check_ms": summary(map_ms),
        "checkpoint_ms": summary(ckpt_ms),
    } | busy
    return {"cell": "bl2_fit_96x500_k8", "seed": seed,
            "metrics": metrics, "iterations": iters,
            "fit_seconds_by_phase": [ph for _, ph, _ in runs],
            "warmup_iterations_per_sec": [iters[0] / w for w in warm],
            "matched_cosine_min": cos_min, "fused_bound_by": bound_by,
            "checks": checks, "correct": all(checks), "breakdown": brk,
            "device": device_info(device)}


CJ_METRICS = {
    "iterations_per_sec": ("iterations/s", "end_to_end"),
    "loop_iterations_per_sec": ("iterations/s", "layer"),
    "allocation_kernel_ms": ("ms", "layer"),
    "map_check_ms": ("ms", "layer"),
    "checkpoint_ms": ("ms", "layer"),
    "device_busy_share": ("fraction", "layer"),
    "device_events_per_iter": ("events/iteration", "layer"),
}


def cell_cj_fit_96x2780_k8_expo(device="cuda", seed=0, G=2780, rank=8,
                                maxiters=800, post_warmup=200, MAP_over=200,
                                MAP_every=100, fits=3, warmups=3,
                                loop_iters=200, loop_reps=3, loop_warmup=50,
                                prof_iters=20, kernel_reps=100, layer_reps=5,
                                trace=False) -> dict:
    """Conjugate Poisson-Exponential Gibbs (BASELINE config 4's shape and
    config 1's model), fit end to end: ``fit(M, 8, prior="exponential",
    MH=False)`` on a 96x2780 catalogue of true rank 8 made from ``seed``
    (the allocation kernel, csrc/allocation.cu, and the chains' draw
    kernel, csrc/rng.cu); ``warmups`` fits with chain seed ``seed``, then
    ``fits`` timed ones with chain seeds seed..seed+fits-1, each stopping
    at maxiters (the conjugate path runs no post-warmup MH phase, so
    ``post_warmup`` adds nothing), with the default periodic checkpoint.
    The end-to-end rate and each fit's wall split by layer as in the bl2
    cell. ``correct``: every fit's matched min cosine of MAP P >= 0.9,
    metrics finite, the allocation launched once an iteration and once at
    init, the draw kernel's count exact, nothing else launched, no plain
    version called."""
    M, P_true = MS.synthetic(96, G, rank, seed)
    cc = fixed_work(maxiters, MAP_over, MAP_every)
    checks, last = [], []

    def one_fit(i):
        with tempfile.TemporaryDirectory() as tmp, \
                counted(device) as cnt, phase_clock(FIT_PHASES) as phases:
            wall, s = MS.host_seconds(torch, lambda: bt.fit(
                M, rank, prior="exponential", MH=False, device=device,
                output_dir=os.path.join(tmp, "fit"), convergence_control=cc,
                post_warmup=post_warmup, seed=seed + max(i - warmups, 0)))
        ok, low = recovery(s.MAP["P"], P_true, 0.9)
        checks.append(bool(
            ok and s.spec.needs_Z and finite(s.sample_metrics.to_numpy(float))
            and launches_ok(cnt, {"allocation": 1}, s.iter - 1, s.spec,
                            init=True)))
        last[:] = [s]   # only the newest fit stays alive
        return wall, phases, (int(s.iter), low)

    runs, warm = timed_runs(fits, warmups, one_fit)
    iters = [n for _, _, (n, _) in runs]
    rates = [n / wall for n, (wall, _, _) in zip(iters, runs)]
    cos_min = [low for _, _, (_, low) in runs]
    s = last[0]

    loop, _, _ = loop_rates(device, s, loop_iters, loop_reps, loop_warmup)
    with captured(U, "allocate_counts") as calls:
        gibbs.gibbs_step(s.spec, s.data, s.hyperprior_params, s.state, 1.0,
                         False)
    a, k = calls[0]
    kern = call_ms(lambda: AL.allocate_counts(*a, **k), kernel_reps, device)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "sampler.ckpt")
        map_ms = layer_ms(s.get_MAP, device, layer_reps)
        ckpt_ms = layer_ms(lambda: s.save_object(ckpt), device, layer_reps)
        busy = busy_metrics(device, lambda: gibbs.run_chunk(
            s.spec, s.data, s.hyperprior_params, s.state,
            np.ones(prof_iters, np.float32), False), prof_iters)
        brk = None
        if trace:
            st = [s.state]

            def chunk():
                st[0] = gibbs.run_chunk(
                    s.spec, s.data, s.hyperprior_params, st[0],
                    np.ones(MAP_every, np.float32), False)[0]

            brk = traced(device, [
                (label, fn) for _ in range(3) for label, fn in (
                    ("bench/loop", chunk), ("bench/MAP", s.get_MAP),
                    ("bench/checkpoint", lambda: s.save_object(ckpt)))])

    metrics = {
        "iterations_per_sec": summary(rates, iters),
        "loop_iterations_per_sec": summary(loop, [loop_iters] * loop_reps),
        "allocation_kernel_ms": summary([kern]),
        "map_check_ms": summary(map_ms),
        "checkpoint_ms": summary(ckpt_ms),
    } | busy
    return {"cell": "cj_fit_96x2780_k8_expo", "seed": seed,
            "metrics": metrics, "iterations": iters,
            "fit_seconds_by_phase": [ph for _, ph, _ in runs],
            "warmup_iterations_per_sec": [iters[0] / w for w in warm],
            "matched_cosine_min": cos_min, "checks": checks,
            "correct": all(checks), "breakdown": brk,
            "device": device_info(device)}


# the ensemble's layers inside a run, for the host-clock split of its wall
ENS_PHASES = ((bt.ChainEnsemble, "_run_chunk", "loop"),
              (bt.ChainEnsemble, "_check_convergence", "map_check"),
              (bt.ChainEnsemble, "_compute_maps", "map_check"),
              (bt.ChainEnsemble, "_finalize_chain", "map_check"),
              (bt.ChainEnsemble, "save_object", "checkpoint"))


NS_METRICS = {
    "chain_iterations_per_sec": ("chain-iterations/s", "end_to_end"),
    "loop_chain_iterations_per_sec": ("chain-iterations/s", "layer"),
    "stream_pcol_ms": ("ms", "layer"),
    "stream_pcol_roofline_share": ("fraction", "layer"),
    "stream_erow_ms": ("ms", "layer"),
    "stream_erow_roofline_share": ("fraction", "layer"),
    "stream_acol_ms": ("ms", "layer"),
    "stream_acol_roofline_share": ("fraction", "layer"),
    "stream_metrics_row_ms": ("ms", "layer"),
    "stream_metrics_row_roofline_share": ("fraction", "layer"),
    "prior_update_ms": ("ms", "layer"),
    "device_busy_share": ("fraction", "layer"),
    "device_events_per_iter": ("events/iteration", "layer"),
}


def cell_ns_ens_8x96x10k_sbfi(device="cuda", seed=0, G=10000, true_rank=8,
                              max_rank=20, chains=8, maxiters=800,
                              post_warmup=200, MAP_over=200, MAP_every=100,
                              runs=3, warmups=3, loop_iters=20,
                              loop_reps=3, prof_iters=10, kernel_reps=100,
                              stream_sweeps=None, trace=False) -> dict:
    """The north-star shape as a chain ensemble: ``ChainEnsemble`` of 8
    chains over ranks 1..20 by SBFI on a 96x10000 catalogue of true rank 8
    made from ``seed`` (the streaming kernels, which the ensemble resolves
    at this G on the card), with the defaults' periodic checkpoint at every
    MAP check into a temporary directory; ``warmups`` runs with seed
    ``seed``, then ``runs`` timed ones with seeds seed..seed+runs-1, every
    chain stopping at maxiters + post_warmup, so that no compaction
    happens. The end-to-end rate is all the timed runs' chain-iterations
    over all their seconds in ``run()`` (``ChainEnsemble.throughput``'s
    counts); each run's rate and its wall split by layer are kept beside
    it. The warm-ups let the checkpoints' allocations settle, as in the fit
    cell."""
    M, P_true = MS.synthetic(96, G, true_rank, seed)
    cc = fixed_work(maxiters, MAP_over, MAP_every)
    N = max_rank
    per_iter = {"_run": 3 * N, "stream_acol_update": N,
                "stream_metrics_row": 1}
    checks, last = [], []

    def one_run(i):
        with tempfile.TemporaryDirectory() as tmp, \
                counted(device) as cnt, phase_clock(ENS_PHASES) as phases:
            wall, ens = MS.host_seconds(torch, lambda: bt.ChainEnsemble(
                M, range(1, N + 1), n_chains=chains, rank_method="SBFI",
                convergence_control=cc, post_warmup=post_warmup,
                seed=seed + max(i - warmups, 0), stream_sweeps=stream_sweeps,
                store_E=False, output_dir=os.path.join(tmp, "ens"),
                device=device).run())
        best = int(ens.bic_table().iloc[0]["chain"])
        ok, low = recovery(ens.chain(best).MAP["P"], P_true, 0.9)
        checks.append(bool(
            ok and ens.spec.stream_sweeps and ensemble_finite(ens)
            and launches_ok(cnt, per_iter, ens.iter - 1, ens.spec,
                            init=True)))
        last[:] = [(ens, best)]
        return wall, phases, (ens._chain_iters, ens.throughput(),
                              int(ens.iter), ens.learned_ranks.tolist(), low)

    timed, _ = timed_runs(runs, warmups, one_run)
    work, rates, iters, ranks, best_cos = (
        list(x) for x in zip(*(rest for _, _, rest in timed)))
    ens, best = last[0]

    # the layers: the chunk loop on fresh chains, then each kernel at the
    # state it reached
    spec, data, hp = ens.spec, ens.data, ens.hp
    states = CH.init_chain_states(
        spec, hp, data, ChainStreams(seed + 1, np.arange(chains),
                                     device=device), chains)
    acc = torch.zeros(chains, dtype=torch.bool, device=device)

    def chunk(n):
        return CH.run_chunk_chains(spec, data, hp, states,
                                   np.ones(n, np.float32), acc,
                                   store_E=False)[0]

    states = chunk(5)
    loop = []
    for _ in range(loop_reps):
        dt, states = MS.host_seconds(torch, lambda: chunk(loop_iters))
        loop.append(chains * loop_iters / dt)
    busy = busy_metrics(device, lambda: chunk(prof_iters), prof_iters)
    names = ("stream_pcol_update", "stream_erow_update",
             "stream_acol_update", "stream_metrics_row")
    with contextlib.ExitStack() as stack:
        calls = {n: stack.enter_context(captured(S, n)) for n in names}
        gibbs.gibbs_step(spec, data, hp, states,
                         torch.ones((), device=data.device), acc)
    K = spec.K
    bounds = {"stream_pcol_update": MS.update_bound(True, K, N, G, chains),
              "stream_erow_update": MS.update_bound(False, K, N, G, chains),
              "stream_acol_update": MS.acol_update_bound(K, N, G, chains),
              "stream_metrics_row": MS.metrics_row_bound(K, N, G, chains)}
    kern = {}
    for n in names:
        a, k = calls[n][0]
        per = 1 if n == "stream_metrics_row" else N  # a sweep is N columns
        kern[n] = call_ms(lambda a=a, k=k, n=n: getattr(S, n)(*a, **k),
                          kernel_reps, device) / per
    gen = gibbs.streams_of(states)
    noise = gibbs.draw_stream_noise(spec, chains, gen, data.device)
    prior_ms = call_ms(lambda: (
        U.sample_prior_params(spec, hp, states["params"], states["prior"],
                              gen, noise=noise.get("prior")),
        U.sample_R(spec, states["params"]["A"], 1.0, gumbel=noise["R"])),
        kernel_reps, device)
    brk = None
    if trace:
        st = [states]

        def loop_chunk():
            st[0] = CH.run_chunk_chains(spec, data, hp, st[0],
                                        np.ones(loop_iters, np.float32), acc,
                                        store_E=False)[0]

        with tempfile.TemporaryDirectory() as tmp:
            ckpt = os.path.join(tmp, "ensemble.ckpt")
            brk = traced(device, [
                (label, fn) for _ in range(2) for label, fn in (
                    ("bench/loop", loop_chunk),
                    ("bench/MAP", ens.chain(best).get_MAP),
                    ("bench/checkpoint", lambda: ens.save_object(ckpt)))])

    short = {"stream_pcol_update": "stream_pcol",
             "stream_erow_update": "stream_erow",
             "stream_acol_update": "stream_acol",
             "stream_metrics_row": "stream_metrics_row"}
    metrics = {"chain_iterations_per_sec": summary(rates, work),
               "loop_chain_iterations_per_sec": summary(
                   loop, [chains * loop_iters] * loop_reps)}
    for n in names:
        metrics[f"{short[n]}_ms"] = summary([kern[n]])
        metrics[f"{short[n]}_roofline_share"] = summary(
            [share(bounds[n][0], kern[n])])
    metrics["prior_update_ms"] = summary([prior_ms])
    metrics |= busy
    return {"cell": "ns_ens_8x96x10k_sbfi", "seed": seed, "metrics": metrics,
            "iterations": iters, "chain_iterations": work,
            "run_seconds_by_phase": [ph for _, ph, _ in timed],
            "learned_ranks": ranks,
            "best_chain_matched_cosine_min": best_cos,
            "bounds_ms": {short[n]: list(b) for n, b in bounds.items()},
            "checks": checks, "correct": all(checks), "breakdown": brk,
            "device": device_info(device)}


# name -> (function, {metric: (unit, end_to_end or layer)})
CELLS = {
    "bl2_fit_96x500_k8": (cell_bl2_fit_96x500_k8, BL2_METRICS),
    "cj_fit_96x2780_k8_expo": (cell_cj_fit_96x2780_k8_expo, CJ_METRICS),
    "ns_ens_8x96x10k_sbfi": (cell_ns_ens_8x96x10k_sbfi, NS_METRICS),
}


def metric_lines(res: dict, units: dict):
    """One JSON object per metric of a cell's result: name, value (all the
    work over all the time for a rate over runs, else the median of the
    samples), unit, the samples' median and quartiles, and the samples."""
    for name, (unit, kind) in units.items():
        m = res["metrics"][name]
        line = {"cell": res["cell"], "seed": res["seed"], "metric": name,
                "kind": kind, "unit": unit, "device": res["device"]}
        if m is None:
            line["value"] = "not measured"
        else:
            line |= {"value": m["value"], "median": m["median"],
                     "q1": m["q1"], "q3": m["q3"],
                     "samples": m["samples"]}
        yield line


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------


def _rows(fns, setup) -> int:
    """Run each function on the card and print its row; a function that
    raises prints an error row and the rest still run. Returns the exit
    code: 1 if any row failed or is not correct."""
    failed = False
    for fn in fns:
        try:
            row = fn("cuda") | setup
        except Exception as e:  # one config failing must not hide the rest
            traceback.print_exc()
            row = {"metric": fn.__name__, "error": f"{type(e).__name__}: {e}"}
        failed |= not row.get("correct", False)
        print(json.dumps(row), flush=True)
        gc.collect()
    return 1 if failed else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--config", type=int, choices=sorted(CONFIGS))
    mode.add_argument("--all", action="store_true")
    mode.add_argument("--chains", type=int, metavar="N")
    mode.add_argument("--bic", action="store_true")
    mode.add_argument("--compact", action="store_true")
    mode.add_argument("--cell", choices=sorted(CELLS))
    ap.add_argument("--eager", action="store_true",
                    help="with --chains: the eager sweeps")
    ap.add_argument("--seed", type=int, default=0, help="with --cell")
    ap.add_argument("--trace", action="store_true",
                    help="with --cell: the breakdown of a profiled window")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_torch: torch.cuda.is_available() is False; the "
              "benchmark measures the card and does not run on the CPU",
              file=sys.stderr)
        return 2
    # set-up: the kernels build (or load) before any timed window
    t0 = time.perf_counter()
    _build.load_library()
    setup = {"build_seconds": round(time.perf_counter() - t0, 2)}

    if args.cell:
        fn, units = CELLS[args.cell]
        res = fn("cuda", seed=args.seed, trace=args.trace)
        for line in metric_lines(res, units):
            print(json.dumps(line), flush=True)
        print(json.dumps({k: v for k, v in res.items() if k != "metrics"}
                         | setup), flush=True)
        return 0 if res["correct"] else 1
    if args.chains:
        return _rows([lambda d: bench_chains(d, args.chains,
                                             eager=args.eager)], setup)
    if args.bic:
        return _rows([bench_bic], setup)
    if args.compact:
        return _rows([bench_compaction], setup)
    if args.config:
        return _rows([CONFIGS[args.config]], setup)
    order = (1, 2, 3, 4, 5) if args.all else (2, 1, 3, 4, 5)
    return _rows([CONFIGS[n] for n in order], setup)


if __name__ == "__main__":
    sys.exit(main())
