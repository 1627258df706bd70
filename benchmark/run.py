"""Run one cell of BENCHMARK.json once on this machine's card:

    python3 benchmark/run.py --workload NAME --seed S --seconds T --trace 0|1

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number compared with its limit);
the last lines of standard error repeat the checks. Exits 2 without a card
(or with fewer cards than the cell asks for), 3 when JAX or the JAX package
was loaded, 4 when the reference times a call that the program does not
have, each without a result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    cell = harness.load_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"no result: the cell needs {cell['chips']} CUDA card(s), "
              f"this machine has {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    try:
        res, lines = harness.run(ROOT, args.workload, args.seed,
                                 args.seconds, bool(args.trace), "cuda",
                                 T_START, cell)
    except harness.MissingCall as e:
        print(f"no result: {e}", file=sys.stderr)
        return 4
    bad = harness.foreign_modules()
    if bad:
        print(f"no result: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
