#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card (nvidia-smi name and power limit), torch's CUDA and nvcc;
2. build the kernels from bayesnmf_tpu_torch/csrc;
3. the fused-sweep kernel against its plain PyTorch version on the card, on
   the same inputs and uniforms, at (K,N,G) = (96,8,500), (96,8,2780),
   (7,2,37) and a 4-chain batch at (96,8,500), each with accept_all True
   and False, and two options the main path does not take (an excluded
   column A_n = 0; no hyper-sweep): every output within rtol 1e-4 /
   atol 1e-5, the same accept/reject decisions, and bit-identical outputs
   on two launches;
4. the slice: ``bayesnmf_tpu_torch.fit`` on a 96x500 rank-8 synthetic
   catalogue on the card, checking that the state stayed on the card, the
   metrics are finite, the kernel ran once per iteration, the MAP
   signatures match the true ones (Hungarian-matched cosine >= 0.95), and
   the final checkpoint resumes bit-exactly.

The last lines are the card, a JSON line of the kernels' results, and
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
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
          f"{len(_build.sources())} source(s)", flush=True)

    # phase 3: kernel against plain version
    max_err, times = compare_kernel(torch, FS)
    for shape, (k_ms, p_ms) in times.items():
        print(f"time per call at (K,N,G)={shape}: kernel {k_ms:.4f} ms, "
              f"plain PyTorch {p_ms:.4f} ms, on {card}", flush=True)

    # phase 4: the slice
    launches = run_slice(torch, bt, FS, gibbs, card)

    check("jax" not in sys.modules, "the port imported jax")
    k_ms, p_ms = times[(96, 8, 500)]
    print(card)
    print(json.dumps({"kernels": [{
        "name": "fused_gibbs_sweeps", "route": "cuda",
        "source": "bayesnmf_tpu_torch/csrc/fused_sweeps.cu",
        "replaces": "bayesnmf_tpu/ops/pallas_sweeps.py:127",
        "launches": launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
