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
the metrics row. The operands are made with numpy from a fixed seed and
use only the wrappers' signatures, which are the same in every commit
since the allocation took the chains' stream keys (``key``, ``uids``).
"""

import json
import os
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

    def fused_case(K, N, G, rank):
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
        return lambda: FS.fused_gibbs_sweeps(
            *args, prior_kind="truncnormal", exact_mh=True, accept_all=False,
            rank_method="SBFI" if rank else None, hyper_u=hu, hyper_hp=hh)

    for (K, N, G, rank) in ((96, 8, 500, False), (96, 8, 2780, False),
                            (96, 20, 1000, True), (96, 20, 1000, False)):
        out[f"fused {(K, N, G)}" + (" rank" if rank else "")] = ms(
            fused_case(K, N, G, rank))

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
    print("AB " + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    # run as a script: its own directory (utils/, whose logging.py would
    # shadow the standard library's) comes off the path
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path
                   if os.path.abspath(p or os.curdir) != here]
    main(sys.argv[1], sys.argv[2])
