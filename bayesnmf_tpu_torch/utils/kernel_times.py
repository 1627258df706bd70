"""Time the kernels of PERF.md section 6 rows 1-5 at the shapes the table
has always used, on one NVIDIA GPU, for the tree whose root is given:

    python3 bayesnmf_tpu_torch/utils/kernel_times.py ROOT LABEL

ROOT is the root of a checkout (its ``bayesnmf_tpu_torch`` is imported and
its kernels built under ROOT/build); LABEL names the tree in the output.
To compare two commits on one card, unpack the other under a gitignored
directory (``git archive``) and run this script on each in turns in one
call (parent, change, change, parent). It prints one line, ``AB`` and a
JSON object: each kernel's device time in ms (torch.profiler; CUDA events
where the profiler reads nothing): the fused kernel at (96,8,500),
(96,8,2780) and (96,20,1000) with and without the rank branch, the
allocation (Philox mode) at (96,5,100), (96,8,2780) and (96,20,10000), and
at (96,20,10000,8) the P-column, E-row and A-column updates a column and
the metrics row; and the large-K forms' shapes: the fused kernel at
(192,40,2780), (288,20,1000), (1536,8,500) and (1536,20,2780) with the
rank branch, one chain and 8, the E-row update a row at
(192,20,2780,8) and (1536,20,2780,8), and the P-column and A-column
updates a column at (192,20,2780,8), (384,20,2780,8) and (1536,20,2780,8),
each also split by kernel (the profiler's device time a column of each
kernel a sweep launches, by name: the G-tile form's tile and finishing
kernels apart). The operands are made with numpy from a fixed seed and
use only the wrappers' signatures, which are the same in every commit
since the allocation took the chains' stream keys (``key``, ``uids``).
"""

import json
import os
import re
import sys
import time


def main(root: str, label: str) -> dict:
    root = os.path.abspath(root)
    sys.path[:0] = [root]
    import numpy as np
    import torch
    from bayesnmf_tpu_torch.ops import _build
    from bayesnmf_tpu_torch.ops import allocation as AL
    from bayesnmf_tpu_torch.ops import fused_sweeps as FS
    from bayesnmf_tpu_torch.ops import stream_sweeps as S
    from bayesnmf_tpu_torch.utils.measure import device_ms, time_ms

    if not _build.__file__.startswith(root):
        raise RuntimeError(f"imported {_build.__file__}, not {root}'s")
    t0 = time.time()
    _build.load_library()
    out = {"tree": label, "build_s": round(time.time() - t0, 1)}
    dev, f32 = "cuda", np.float32
    rng = np.random.default_rng(0)

    def T(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def ms(fn, reps=20):
        d = device_ms(torch, fn, reps)
        return round(d if d is not None else time_ms(torch, fn, reps), 5)

    def u(*s):
        return rng.uniform(1e-6, 1.0, s).astype(f32)

    def fused_case(K, N, G, rank, C=1):
        Pt = rng.dirichlet(np.ones(K) * 0.5, N).T * 50.0
        Et = rng.gamma(2.0, 2.0, (N, G))
        data = rng.poisson(Pt @ Et).astype(f32)
        P = (Pt * rng.uniform(0.5, 1.5, (K, N))).astype(f32)
        E = (Et * rng.uniform(0.5, 1.5, (N, G))).astype(f32)
        A = ((rng.uniform(size=N) < 0.6).astype(f32) if rank
             else np.ones(N, f32))
        rp = np.zeros((3, N + 1), f32)
        if rank:
            rp[0, 0] = 1.0
            rp[1] = -np.log(-np.log(u(N + 1)))
            rp[2, :N] = u(N)
        mean = float(data.mean())
        hp = [0.0, np.sqrt(mean / N), N + 1.0, np.sqrt(N)]
        args = [T(x) for x in (
            data, P, E, A, ((P * A) @ E).astype(f32), np.ones((K, N), f32),
            np.ones((N, G), f32), u(K, N), u(N, G), u(K, N), u(K, N),
            u(N, G), u(N, G), rng.normal(0, 1, (K, N)).astype(f32),
            rng.gamma(2, 2, (K, N)).astype(f32),
            rng.normal(0, 1, (N, G)).astype(f32),
            rng.gamma(2, 2, (N, G)).astype(f32), rp)]
        hu = (T(u(4, K, N)), T(u(4, N, G)))
        hh = (T(np.stack([np.full((K, N), v, f32) for v in hp])),
              T(np.stack([np.full((N, G), v, f32) for v in hp])))
        if C > 1:  # C copies of the chain (the data stays shared)
            args[1:] = [x.expand(C, *x.shape).contiguous() for x in args[1:]]
            hu = tuple(x.expand(C, *x.shape).contiguous() for x in hu)
        return lambda: FS.fused_gibbs_sweeps(
            *args, prior_kind="truncnormal", exact_mh=True, accept_all=False,
            rank_method="SBFI" if rank else None, hyper_u=hu, hyper_hp=hh)

    for (K, N, G, rank) in ((96, 8, 500, False), (96, 8, 2780, False),
                            (96, 20, 1000, True), (96, 20, 1000, False)):
        out[f"fused {(K, N, G)}" + (" rank" if rank else "")] = ms(
            fused_case(K, N, G, rank))

    def erow_time(K, N, G, C):
        """An E-row update's time a row: a sweep's N launches over N, less
        the clones each call makes."""
        Pt = rng.dirichlet(np.ones(K) * 0.5, N).T * 50.0
        Et = rng.gamma(2.0, 2.0, (N, G))
        data = T(rng.poisson(Pt @ Et).astype(f32))
        P = T((Pt * rng.uniform(0.5, 1.5, (C, K, N))).astype(f32))
        E = T((Et * rng.uniform(0.5, 1.5, (C, N, G))).astype(f32))
        A = T(np.ones((C, N), f32))
        acc = T(np.full((C, N, G), 0.5, f32))
        mu = T(rng.normal(0, 1, (C, N, G)).astype(f32))
        sq = T(rng.gamma(2, 2, (C, N, G)).astype(f32))
        pr = T(rng.gamma(2, 1, (C, N, G)).astype(f32))
        U = T(rng.uniform(1e-6, 1, (C, 3, N, G)).astype(f32))
        flags = torch.arange(C, device=dev) % 2 == 1
        zero = torch.zeros(C, device=dev)

        def sweep():
            S.stream_erow_update(data, E.clone(), P, A, acc.clone(), mu, sq,
                                 pr, U, flags, zero.clone())

        return round((ms(sweep, 10) - ms(lambda: (E.clone(), acc.clone(),
                                                   zero.clone()), 10)) / N,
                     5)

    def by_kernel(fn, per, reps=10):
        """Each stream kernel's device ms over ``per`` (a sweep's columns)
        a call of ``fn``, by kernel name (torch.profiler); the operands'
        copies are left out."""
        from torch.profiler import ProfilerActivity, profile

        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        res = {}
        for e in prof.key_averages():
            name = re.search(r"(\w+_kernel)\b", e.key)
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            if name and us > 0 and "elementwise" not in name.group(1):
                key = name.group(1)
                res[key] = round(res.get(key, 0.0) + us / 1e3 / reps / per,
                                 5)
        return res

    def column_times(K, N, G, C):
        """A P-column and an A-column update's ms a column: a sweep's N
        columns less the clones each call makes (CUDA events or the
        profiler, as ``ms``), and split by kernel."""
        Pt = rng.dirichlet(np.ones(K) * 0.5, N).T * 50.0
        Et = rng.gamma(2.0, 2.0, (N, G))
        data = T(rng.poisson(Pt @ Et).astype(f32))
        P = T((Pt * rng.uniform(0.5, 1.5, (C, K, N))).astype(f32))
        E = T((Et * rng.uniform(0.5, 1.5, (C, N, G))).astype(f32))
        A = T(np.ones((C, N), f32))
        acc = T(np.full((C, K, N), 0.5, f32))
        mu = T(rng.normal(0, 1, (C, K, N)).astype(f32))
        sq = T(rng.gamma(2, 2, (C, K, N)).astype(f32))
        pr = T(rng.gamma(2, 1, (C, K, N)).astype(f32))
        U = T(rng.uniform(1e-6, 1, (C, 3, N, K)).astype(f32))
        flags = torch.arange(C, device=dev) % 2 == 1
        zero = torch.zeros(C, device=dev)
        Aa = T((rng.uniform(size=(C, N)) < 0.6).astype(f32))
        logit = torch.zeros(C, device=dev)
        ua = T(rng.uniform(1e-6, 1, (C, N)).astype(f32))

        def pcol():
            S.stream_pcol_update(data, E, P.clone(), A, acc.clone(), mu, sq,
                                 pr, U, flags, zero.clone())

        def acol():
            S.stream_acol_update(data, E, P, Aa.clone(), logit, 1e-4, ua,
                                 zero.clone(), 100.0)

        shape = (K, N, G, C)
        out[f"pcol_update per column {shape}"] = round(
            (ms(pcol, 10) - ms(lambda: (P.clone(), acc.clone(),
                                        zero.clone()), 10)) / N, 5)
        out[f"pcol kernels per column {shape}"] = by_kernel(pcol, N)
        out[f"acol_update per column {shape}"] = round(
            (ms(acol, 10) - ms(lambda: (Aa.clone(), zero.clone()), 10)) / N,
            5)
        out[f"acol kernels per column {shape}"] = by_kernel(acol, N)

    uids = torch.zeros(1, dtype=torch.int64, device=dev)
    for (K, N, G) in ((96, 5, 100), (96, 8, 2780), (96, 20, 10000)):
        P = T(rng.gamma(2.0, 1.0, (K, N)).astype(f32))
        E = T(rng.gamma(2.0, 2.0, (N, G)).astype(f32))
        A = T(np.ones(N, f32))
        M = T(rng.poisson(30.0, (K, G)).astype(f32))
        out[f"allocation {(K, N, G)}"] = ms(
            lambda: AL.allocate_counts(M, P, A, E, key=(7, 0), uids=uids))

    K, N, G, C = 96, 20, 10000, 8
    Pt = rng.dirichlet(np.ones(K) * 0.5, N).T * 50.0
    Et = rng.gamma(2.0, 2.0, (N, G))
    data = T(rng.poisson(Pt @ Et).astype(f32))
    P = T((Pt * rng.uniform(0.5, 1.5, (C, K, N))).astype(f32))
    E = T((Et * rng.uniform(0.5, 1.5, (C, N, G))).astype(f32))
    A = T(np.ones((C, N), f32))
    acc_P = T(np.full((C, K, N), 0.5, f32))
    acc_E = T(np.full((C, N, G), 0.5, f32))
    Mu_p = T(rng.normal(0, 1, (C, K, N)).astype(f32))
    Sq_p = T(rng.gamma(2, 2, (C, K, N)).astype(f32))
    Mu_e = T(rng.normal(0, 1, (C, N, G)).astype(f32))
    Sq_e = T(rng.gamma(2, 2, (C, N, G)).astype(f32))
    Pp = T(rng.gamma(2, 1, (C, K, N)).astype(f32))
    Ep = T(rng.gamma(2, 1, (C, N, G)).astype(f32))
    Up = T(rng.uniform(1e-6, 1, (C, 3, N, K)).astype(f32))
    Ue = T(rng.uniform(1e-6, 1, (C, 3, N, G)).astype(f32))
    flags = torch.arange(C, device=dev) % 2 == 1
    nan = torch.zeros(C, device=dev)

    # a sweep's launches over N, less the clones each call makes
    def pcol():
        S.stream_pcol_update(data, E, P.clone(), A, acc_P.clone(), Mu_p,
                             Sq_p, Pp, Up, flags, nan.clone())

    def erow():
        S.stream_erow_update(data, E.clone(), P, A, acc_E.clone(), Mu_e,
                             Sq_e, Ep, Ue, flags, nan.clone())

    out["pcol_update per column"] = round(
        (ms(pcol, 10) - ms(lambda: (P.clone(), acc_P.clone(), nan.clone()),
                           10)) / N, 5)
    out["erow_update per column"] = round(
        (ms(erow, 10) - ms(lambda: (E.clone(), acc_E.clone(), nan.clone()),
                           10)) / N, 5)
    Aa = T((rng.uniform(size=(C, N)) < 0.6).astype(f32))
    logit = torch.zeros(C, device=dev)
    ua = T(rng.uniform(1e-6, 1, (C, N)).astype(f32))

    def acol():
        S.stream_acol_update(data, E, P, Aa.clone(), logit, 1e-4, ua,
                             nan.clone(), 100.0)

    out["acol_update per column"] = round(
        (ms(acol, 10) - ms(lambda: (Aa.clone(), nan.clone()), 10)) / N, 5)
    lg = torch.tensor(1.0, device=dev)
    ml = torch.tensor(2.0, device=dev)
    na = torch.zeros(C, device=dev)
    out["metrics row"] = ms(lambda: S.stream_metrics_row(
        data, P, E, A, acc_P, acc_E, Mu_p, Sq_p, Mu_e, Sq_e, lg, ml, na, 5,
        1.0))
    # the large-K forms' shapes, after every draw of the shapes above
    for (K, N, G, rank, C) in ((192, 40, 2780, False, 1),
                               (288, 20, 1000, False, 1),
                               (1536, 8, 500, False, 1),
                               (1536, 20, 2780, True, 1),
                               (1536, 20, 2780, True, 8)):
        out[f"fused {(K, N, G, C)}" + (" rank" if rank else "")] = ms(
            fused_case(K, N, G, rank, C), 10)
    for (K, N, G, C) in ((192, 20, 2780, 8), (1536, 20, 2780, 8)):
        out[f"erow_update per column {(K, N, G, C)}"] = erow_time(K, N, G, C)
    for (K, N, G, C) in ((192, 20, 2780, 8), (384, 20, 2780, 8),
                         (1536, 20, 2780, 8)):
        column_times(K, N, G, C)
    print("AB " + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    # run as a script: its own directory (utils/, whose logging.py would
    # shadow the standard library's) comes off the path
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path
                   if os.path.abspath(p or os.curdir) != here]
    main(sys.argv[1], sys.argv[2])
