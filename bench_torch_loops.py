#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's three chunk loops on one NVIDIA GPU, for one
tree or for two trees in turns.

    python3 bench_torch_loops.py                 # this tree
    python3 bench_torch_loops.py --ab OTHER_DIR  # OTHER, this, this, OTHER

The loops are the hot loops of ``chip_smoke.py``'s paths, from fresh chains
made from a seed (``P ~ Dirichlet(0.3)``, ``E ~ Gamma(2, 500)``,
``M ~ Poisson``), after a warm-up, three repetitions each:

- ``fused_500``: ``gibbs.run_chunk`` at 96x500, rank 8 (the fused kernel);
- ``fused_1000_sbfi``: the same at 96x1000 over ranks 1..20 by SBFI, all 20
  columns in at the start;
- ``ensemble_10k``: ``chains.run_chunk_chains`` at 96x10000, ranks 1..20 by
  SBFI, 8 chains (the streaming kernels).

Each tree runs in a process of its own and builds its own kernels. With
``--ab`` the two trees run in turns on the same card, so that a difference
between them is not a difference between two cards or two hosts. Prints one
JSON object per run: the tree, the card's name and power limit, and the
iterations per second of every repetition. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


def synthetic(K, G, rank, seed=0):
    rng = np.random.default_rng(seed)
    P = rng.dirichlet(np.ones(K) * 0.3, rank).T
    E = rng.gamma(2.0, 500.0, (rank, G))
    return rng.poisson(P @ E).astype(np.float32)


def timed(torch, fn, n, reps=3):
    rates = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(n)
        torch.cuda.synchronize()
        rates.append(n / (time.perf_counter() - t0))
    return rates


def run_tree(root: str) -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_torch_loops: no CUDA device")
    sys.path.insert(0, os.path.abspath(root))
    import bayesnmf_tpu_torch as bt
    from bayesnmf_tpu_torch.models import gibbs
    from bayesnmf_tpu_torch.parallel import chains as CH

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {"tree": os.path.abspath(root), "card": card}
    cc = bt.ConvergenceControl(maxiters=1000, miniters=0)

    for name, G, rank, n in (("fused_500", 500, 8, 500),
                             ("fused_1000_sbfi", 1000, range(1, 21), 300)):
        s = bt.GibbsSampler(synthetic(96, G, 8), rank, device="cuda",
                            convergence_control=cc, seed=0)
        state = [s.state]

        def loop(k, s=s, state=state):
            state[0] = gibbs.run_chunk(s.spec, s.data, s.hyperprior_params,
                                       state[0], np.ones(k, np.float32),
                                       False)[0]

        loop(20)
        out[name] = timed(torch, loop, n)

    ens = bt.ChainEnsemble(synthetic(96, 10000, 8), range(1, 21), n_chains=8,
                           rank_method="SBFI", convergence_control=cc,
                           seed=0, stream_sweeps=True, store_E=False,
                           periodic_save=False, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    states = [CH.init_chain_states(ens.spec, ens.hp, ens.data, gen, 8)]
    acc = torch.zeros(8, dtype=torch.bool, device="cuda")

    def ens_loop(k):
        states[0] = CH.run_chunk_chains(ens.spec, ens.data, ens.hp, states[0],
                                        np.ones(k, np.float32), acc,
                                        store_E=False)[0]

    ens_loop(5)
    out["ensemble_10k"] = timed(torch, ens_loop, 20)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)), help="the tree whose package to time")
    ap.add_argument("--ab", metavar="OTHER_DIR",
                    help="another tree: run OTHER, this, this, OTHER")
    args = ap.parse_args()
    if not args.ab:
        print(json.dumps(run_tree(args.root)), flush=True)
        return 0
    for root in (args.ab, args.root, args.root, args.ab):
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--root", root]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
