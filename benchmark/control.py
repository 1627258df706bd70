"""The control of a cell's check, and the readings its limit is set from:

    python3 benchmark/control.py --workload NAME --seeds 1,2,3 [--seconds T]

For each seed one short run of the cell (at least one whole fit at the
cell's own size, its steps replayed as every run replays them) gives two
readings of ``mismatch_share``: the program's against the float32
reference, and the control's, the reference itself put in the program's
place with its state and its draws held in bfloat16, the precision below
the configuration's float32 (what storing the state in bfloat16 would do).
One JSON line a seed. The benchmark's runs do not run this.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def readings(name: str, seed: int, seconds: float, device="cuda",
             cell=None) -> dict:
    import torch

    from benchmark import check, harness

    keep = {}
    res, _ = harness.run(ROOT, name, seed, seconds, False, device, cell=cell,
                         keep=keep)
    ctl = check.mismatch(*keep["args"], rounding=torch.bfloat16,
                         use_reference_output=True)
    return {"workload": name, "seed": seed, "correct": res["correct"],
            "program": keep["got"]["mismatch_share"],
            "program_by_tensor": keep["got"]["by_tensor"],
            "control": ctl["mismatch_share"],
            "control_by_tensor": ctl["by_tensor"],
            "steps": keep["got"]["steps"], "starts": keep["got"]["starts"],
            "metrics": res["metrics"], "device": res["device"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    for s in args.seeds.split(","):
        print(json.dumps(readings(args.workload, int(s), args.seconds)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
