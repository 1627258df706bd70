"""Run one cell of BENCHMARK.json as ``run.py`` does, with the program's
spans (``bayesnmf_tpu_torch.utils.tracing``) on in the window:

    python3 benchmark/spans.py --workload NAME --seed S --seconds T \\
        --trace 0|1 [--spans 0|1]

The last line of standard output is ``run.py``'s result line with one key
more, ``program``: the readings of ``attribution.py`` (with ``--trace 1``
``step_idle_share`` and ``prior_update_idle_share`` of the profiled
stretch; ``step_host_ms`` of the window's steps outside it), the spans a
step made, each span's count, total and self seconds, and the stretch's
idle seconds by innermost span. With ``--trace 1`` the breakdown's idle
gaps name the program's spans. ``--spans 0`` runs the same with the spans
off, to price them. ``harness.py`` is used as it is: this script hands it
a subclass of its ``Hooks`` and keeps the trace's events as they are read.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import attribution as A  # noqa: E402
from benchmark import harness  # noqa: E402
from benchmark import profiling as PR  # noqa: E402


def run(root: str, name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start=None, cell=None, spans: bool = True):
    """harness.run with the program's spans on from the window's opening
    to its close; returns (result dict with ``program``, the check's
    lines)."""
    from bayesnmf_tpu_torch.utils import tracing

    got = {"spans": [], "events": [], "stretch_ns": None}

    class SpanHooks(harness.Hooks):
        def install(self):
            super().install()
            if spans:
                tracing.enable()

        def uninstall(self):
            tracing.disable()
            got["spans"] = tracing.take()
            super().uninstall()

        def _start_profile(self):
            super()._start_profile()
            got["t0_ns"] = time.perf_counter_ns()

        def _stop_profile(self):
            super()._stop_profile()
            got["stretch_ns"] = (got["t0_ns"], time.perf_counter_ns())

    read_trace = PR.read_trace

    def keep_events(prof):
        got["events"] = read_trace(prof)
        return got["events"]

    hooks = harness.Hooks
    harness.Hooks, PR.read_trace = SpanHooks, keep_events
    try:
        res, lines = harness.run(root, name, seed, seconds, trace, device,
                                 t_start, cell)
    finally:
        harness.Hooks, PR.read_trace = hooks, read_trace
    res["program"] = readings(got["spans"], got["events"],
                              res["device"].get("window_s", 0.0),
                              got["stretch_ns"])
    return res, lines


def readings(spans: list, events: list, window_s: float,
             stretch_ns) -> dict:
    """attribution.py's readings of one run's spans and stretch."""
    from bayesnmf_tpu_torch.utils import tracing

    summ = tracing.summary(spans)
    n_steps = summ.get(A.STEP, {}).get("count", 0)
    per_step = sum(d["count"] for k, d in summ.items()
                   if k.startswith(("step.", "chains.")))
    idle = A.idle_by_span(events) if events else {}
    return {
        "step_idle_share": A.step_idle_share(events, window_s),
        "prior_update_idle_share": A.prior_update_idle_share(events,
                                                             window_s),
        "step_host_ms": A.step_host_ms(spans, stretch_ns),
        "spans_per_step": per_step / n_steps if n_steps else None,
        "summary": summ,
        "idle_by_span": sorted(([str(k), v] for k, v in idle.items()),
                               key=lambda kv: -kv[1]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    import torch

    cell = harness.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"no result: the cell needs {cell['chips']} CUDA card(s)",
              file=sys.stderr)
        return 2
    res, lines = run(ROOT, args.workload, args.seed, args.seconds,
                     bool(args.trace), "cuda", T_START, cell,
                     bool(args.spans))
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
