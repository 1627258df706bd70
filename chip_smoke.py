#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card (nvidia-smi name and power limit), torch's CUDA and nvcc;
2. build the kernels from bayesnmf_tpu_torch/csrc (one nvcc per source,
   all started together);
3. the fused-sweep kernel against its plain PyTorch version on the card, on
   the same inputs and uniforms, at (K,N,G) = (96,8,500), (96,8,2780),
   (7,2,37) and a 4-chain batch at (96,8,500), each with accept_all True
   and False, and two options the main path does not take (an excluded
   column A_n = 0; no hyper-sweep): every output within rtol 1e-4 /
   atol 1e-5, the same accept/reject decisions, and bit-identical outputs
   on two launches;
3b. each streaming kernel (the four bodies of ``_run``, ``acol_delta``,
   ``chain_metrics``) against its plain PyTorch version at (K,N,G,C) =
   (96,20,10000,8), (96,20,25000,2), (7,3,37,2) and (16,3,300,2) with an
   excluded column: max abs and rel diff per output within the tolerance
   stated in ops/stream_sweeps.py, bit-identical on two launches, and each
   timed with CUDA events at (96,20,10000,8) beside its plain version;
4. the fixed-rank slice: ``bayesnmf_tpu_torch.fit`` on a 96x500 rank-8
   synthetic catalogue on the card, checking that the state stayed on the
   card, the metrics are finite, the kernel ran once per iteration, the MAP
   signatures match the true ones (Hungarian-matched cosine >= 0.95), and
   the final checkpoint resumes bit-exactly;
5. the ensemble slice: ``ChainEnsemble`` with SBFI over ranks 1..20, 8
   chains, on a 96x10000 rank-8 synthetic catalogue, through the streaming
   kernels: every metrics row finite, each stream kernel launched its
   launches per iteration times the iterations run, the final checkpoint
   resumes bit-exactly for 20 iterations; it prints the iterations, the
   chain-it/s of the run and of the chunk loop alone, each chain's learned
   rank and matched cosine, and the loop's device busy share
   (torch.profiler).

The launch counts are set to 0 just before each phase drives its path and
read just after, so launches made to compare a kernel with its plain version
do not count. The last lines are the card, a JSON line of the kernels'
results, and ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the package beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

RTOL, ATOL = 1e-4, 1e-5
# (K, N, G, chains, A, hyper-sweep)
KERNEL_CASES = [(96, 8, 500, 1, None, True), (96, 8, 2780, 1, None, True),
                (7, 2, 37, 1, None, True), (96, 8, 500, 4, None, True),
                (16, 3, 24, 1, (1.0, 0.0, 1.0), True),
                (7, 2, 37, 1, None, False)]
TIMED_SHAPES = [(96, 8, 500, 1), (96, 8, 2780, 1)]
_ARGS = ("data", "P", "E", "A", "Mhat", "acc_P", "acc_E", "Upr_P", "Upr_E",
         "Up_P", "Ua_P", "Up_E", "Ua_E", "hp0_p", "hp1_p", "hp0_e", "hp1_e",
         "rank_pack")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


def compare_kernel(torch, FS):
    """Phase 3. Returns (max_abs_err, {shape: (kernel_ms, plain_ms)})."""
    dev = torch.device("cuda")
    max_err = 0.0
    times = {}
    for (K, N, G, C, A, hyper) in KERNEL_CASES:
        d = sweep_inputs(K, N, G, C, seed=K + N + G + C, A=A)
        t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in d.items()}
        args = [t[k] for k in _ARGS]
        hyper_u, hyper_hp = (t["Hu_p"], t["Hu_e"]), (t["Hhp_p"], t["Hhp_e"])
        bt = (lambda x: x) if C > 1 else (lambda x: x.unsqueeze(0))
        if not hyper:
            hyper_u = hyper_hp = None
        case = f"(K,N,G,C)={(K, N, G, C)}" + (f" A={A}" if A else "") + (
            "" if hyper else " no hyper-sweep")
        for accept_all in (True, False):
            def kernel():
                return FS.fused_gibbs_sweeps(
                    *args, prior_kind="truncnormal", exact_mh=True,
                    accept_all=accept_all, rank_method=None,
                    hyper_u=hyper_u, hyper_hp=hyper_hp)

            flag = torch.full((C,), accept_all, device=dev)

            def plain():
                return FS.fused_gibbs_sweeps_reference(
                    *map(bt, args[:17]), flag,
                    hyper_u and tuple(map(bt, hyper_u)),
                    hyper_hp and tuple(map(bt, hyper_hp)))

            k1, k2 = kernel(), kernel()
            p = plain()
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(k1, k2)),
                  f"two launches differ at {case}")
            # the wrapper's 12 outputs minus A and R, in the plain order
            k_out = [k1[i] for i in (0, 1, 2, 3, 4, 7, 8, 9, 10, 11)]
            names = ("P", "E", "Mhat", "acc_P", "acc_E", "nan", "Mu_p",
                     "Sigmasq_p", "Mu_e", "Sigmasq_e")
            errs = {}
            for name, a, b in zip(names, k_out, p):
                b = b if C > 1 else b[0]
                errs[name] = float((a - b).abs().max())
                check(torch.allclose(a, b, rtol=RTOL, atol=ATOL),
                      f"{name} differs at {case} accept_all={accept_all}: "
                      f"max abs {errs[name]}")
            for i, name in ((0, "P"), (1, "E")):
                ref = p[i] if C > 1 else p[i][0]
                check(torch.equal(k1[i] != args[i + 1], ref != args[i + 1]),
                      f"{name} accept decisions differ at {case}")
            worst = max(errs.values())
            max_err = max(max_err, worst)
            print(f"kernel vs plain {case} accept_all={accept_all}: max "
                  f"abs diff {worst:.3e} "
                  f"({', '.join(f'{k} {v:.1e}' for k, v in errs.items())})"
                  "; two launches bit-identical", flush=True)
            if (K, N, G, C) in TIMED_SHAPES and hyper and not accept_all:
                times[(K, N, G)] = (time_ms(torch, kernel, 50),
                                    time_ms(torch, plain, 5))
    return max_err, times


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


# ---------------------------------------------------------------------------
# phase 4: the slice
# ---------------------------------------------------------------------------


def matched_cosines(P_est, P_true):
    from scipy.optimize import linear_sum_assignment

    a = P_est / np.linalg.norm(P_est, axis=0, keepdims=True)
    b = P_true / np.linalg.norm(P_true, axis=0, keepdims=True)
    sim = a.T @ b
    rows, cols = linear_sum_assignment(-sim)
    return sim[rows, cols]


def run_slice(torch, bt, FS, gibbs, card):
    rng = np.random.default_rng(0)
    K, N, G = 96, 8, 500
    P_true = rng.dirichlet(np.ones(K) * 0.3, N).T
    E_true = rng.gamma(2.0, 500.0, (N, G))
    M = rng.poisson(P_true @ E_true).astype(np.float32)
    cc = bt.ConvergenceControl(MAP_over=500, MAP_every=100, miniters=500,
                               maxiters=2000, Ninarow_nochange=3,
                               Ninarow_nobest=5)
    with tempfile.TemporaryDirectory() as tmp:
        FS.fused_gibbs_sweeps.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = bt.fit(M, N, device="cuda", output_dir=os.path.join(tmp, "fit"),
                   convergence_control=cc, post_warmup=500, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = FS.fused_gibbs_sweeps.launches
        steps = s.iter - 1  # iteration 1 is the initial draw
        # the final checkpoint resumes bit-exactly (generator state included)
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
          f"launches {launches}; MAP matched cosine min {cos.min():.4f} "
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
    return launches


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for a call's work
# ---------------------------------------------------------------------------

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


def fused_bound(K, N, G, C=1):
    """The fused sweep (csrc/fused_sweeps.cu) at one call: bytes of its 22
    inputs and 12 outputs; operations of the hyper-sweep (~60 a parameter)
    and of the 2N column updates, each two passes over K*G entries of about
    8 and 20 operations and a rank-1 update of 2."""
    kn, ng, kg = K * N, N * G, K * G
    n_in = kg + kn + ng + N + C * kg + 2 * kn + 2 * ng + 3 * kn + 3 * ng \
        + 2 * kn + 2 * ng + 3 * (N + 1) + 4 * (kn + ng) + 4 * (kn + ng)
    n_out = 2 * kn + 2 * ng + kg + 1 + 2 * kn + 2 * ng
    ops = 60 * (kn + ng) + 2 * N * kg * (8 + 20 + 2)
    return bound(4 * C * (n_in + n_out), C * ops)


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


def compare_stream_kernels(torch, S, card):
    """Phase 3b. Returns {name: dict(max_abs_err, ms, plain_ms, bound_ms,
    bound_by)} at the timed shape."""
    dev = torch.device("cuda")
    res = {}
    for (K, N, G, C, A) in STREAM_CASES:
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
            if (K, N, G, C) == STREAM_TIMED:
                r["ms"] = time_ms(torch, kernel, 50)
                r["plain_ms"] = time_ms(
                    torch, lambda name=name, args=args: stream_plain(
                        S, name, args), 3)
                r["bound_ms"], r["bound_by"] = stream_bound(name, K, N, G, C)
                print(f"time per call {name} at (K,N,G,C)={STREAM_TIMED}: "
                      f"kernel {r['ms']:.4f} ms, plain PyTorch "
                      f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                      f"({r['bound_by']}), on {card}", flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 5: the ensemble slice
# ---------------------------------------------------------------------------

ENS_K, ENS_G, ENS_TRUE_RANK, ENS_MAX_RANK, ENS_CHAINS = 96, 10000, 8, 20, 8
ENS_CC = dict(MAP_over=200, MAP_every=100, miniters=800, maxiters=1200,
              Ninarow_nochange=3, Ninarow_nobest=5)
ENS_POST_WARMUP = 200


def run_ensemble(torch, bt, S, card):
    from bayesnmf_tpu_torch.parallel import chains as CH

    rng = np.random.default_rng(0)
    P_true = rng.dirichlet(np.ones(ENS_K) * 0.3, ENS_TRUE_RANK).T
    E_true = rng.gamma(2.0, 500.0, (ENS_TRUE_RANK, ENS_G))
    M = rng.poisson(P_true @ E_true).astype(np.float32)
    cc = bt.ConvergenceControl(**ENS_CC)
    N = ENS_MAX_RANK
    with tempfile.TemporaryDirectory() as tmp:
        S.reset_launch_counts()
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
                    "acol_delta": S.acol_delta.launches,
                    "chain_metrics": S.chain_metrics.launches}
        steps = ens.iter - 1  # iteration 1 is the initial draw
        per_iter = {"_run": 4 * N, "acol_delta": N, "chain_metrics": 1}
        for k, n in per_iter.items():
            check(launches[k] == n * steps,
                  f"{k} launches {launches[k]} != {n} x {steps} iterations")
        print(f"ensemble: {steps} iterations; launches "
              + ", ".join(f"{k} {v} (= {per_iter[k]} x {steps})"
                          for k, v in launches.items()), flush=True)

        # the final checkpoint resumes bit-exactly (generator state
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
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    states = CH.init_chain_states(ens.spec, ens.hp, ens.data, gen,
                                  ENS_CHAINS)
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
        for k in ("pcol_kernel", "erow_kernel", "acol_kernel",
                  "metrics_kernel", "reduce_tiles")}
    if dev_us > 0:
        print(f"ensemble: profiled {n_prof} iterations: device busy "
              f"{dev_us / 1e3:.1f} ms of {prof_s * 1e3:.1f} ms wall "
              f"(share {dev_us / 1e6 / prof_s:.3f}); stream kernels "
              + ", ".join(f"{k} {v / 1e3:.2f} ms" for k, v in
                          stream_us.items())
              + f"; {n_kernels} device events; on {card}", flush=True)
    else:
        print("ensemble: torch.profiler recorded no device time; busy "
              "share not measured", flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    # the package sits beside this script
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import bayesnmf_tpu_torch as bt
    from bayesnmf_tpu_torch.models import gibbs
    from bayesnmf_tpu_torch.ops import _build
    from bayesnmf_tpu_torch.ops import fused_sweeps as FS
    from bayesnmf_tpu_torch.ops import stream_sweeps as S

    # phase 1: the card and the toolchain
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True)
    print("nvcc: " + nvcc.stdout.strip().splitlines()[-1], flush=True)

    # phase 2: build
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s for "
          f"{len(_build.sources())} source(s), one nvcc each, in parallel",
          flush=True)

    # phase 3: the fused kernel against its plain version
    max_err, times = compare_kernel(torch, FS)
    for shape, (k_ms, p_ms) in times.items():
        print(f"time per call at (K,N,G)={shape}: kernel {k_ms:.4f} ms, "
              f"plain PyTorch {p_ms:.4f} ms, bound "
              f"{fused_bound(*shape)[0]:.4f} ms, on {card}", flush=True)

    # phase 3b: the streaming kernels against their plain versions
    stream = compare_stream_kernels(torch, S, card)

    # phase 4: the fixed-rank slice
    launches = run_slice(torch, bt, FS, gibbs, card)

    # phase 5: the ensemble slice
    ens_launches = run_ensemble(torch, bt, S, card)

    check("jax" not in sys.modules, "the port imported jax")
    check("bayesnmf_tpu" not in sys.modules,
          "the port imported the JAX package")
    k_ms, p_ms = times[(96, 8, 500)]
    b_ms, b_by = fused_bound(96, 8, 500)
    kernels = [{
        "name": "fused_gibbs_sweeps", "route": "cuda",
        "source": "bayesnmf_tpu_torch/csrc/fused_sweeps.cu",
        "replaces": "bayesnmf_tpu/ops/pallas_sweeps.py:127",
        "launches": launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None}]
    src = "bayesnmf_tpu_torch/csrc/stream_sweeps.cu"
    pss = "bayesnmf_tpu/ops/pallas_stream_sweeps.py"
    # _run serves four bodies; its entry is the mean of their calls
    bodies = ("pcol_stats", "pcol_accept", "erow_stats", "erow_accept")
    mean = lambda key: float(np.mean([stream[b][key] for b in bodies]))  # noqa
    bound_run = [stream_bound(b, *STREAM_TIMED) for b in bodies]
    kernels.append({
        "name": "_run", "route": "cuda", "source": src,
        "replaces": f"{pss}:330", "launches": ens_launches["_run"],
        "max_abs_err": max(stream[b]["max_abs_err"] for b in bodies),
        "ms": mean("ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": float(np.mean([b[0] for b in bound_run])),
        "bound_by": bound_run[0][1], "library_ms": None})
    for name, line in (("acol_delta", 220), ("chain_metrics", 272)):
        r = stream[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": f"{pss}:{line}", "launches": ens_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
