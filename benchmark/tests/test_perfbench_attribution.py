"""The device's idle time put down to the program's spans
(benchmark/attribution.py) on hand-made chrome-trace events, and the
harness's traced runs of the small cells: the program's spans kept on the
Run, the readings there on the CPU, the shares None without device
operations."""

import pytest

from benchmark import attribution as A
from benchmark import harness
from benchmark import profiling as PR
from small import ROOT, run_small


def _host(name, t0, t1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": t0,
            "dur": t1 - t0}


def _kernel(t0, t1):
    return {"ph": "X", "cat": "kernel", "name": "k", "ts": t0,
            "dur": t1 - t0}


# a stretch of 120 us: the benchmark's own span around a chunk of two
# steps, the first with a prior update, the second with a P sweep, then
# the chunk's read to the host
EVENTS = [
    _host("ensemble/loop", 0, 110),
    _host("ensemble.chunk", 1, 99),
    _host("chains.step", 2, 50),
    _host("step.prior_update", 10, 30),
    _host("chains.record", 50, 52),
    _host("ensemble.to_host", 60, 70),
    _host("chains.step", 72, 98),
    _host("step.sweep_P", 75, 80),
    {"ph": "X", "cat": "cpu_op", "name": "aten::sqrt", "ts": 12, "dur": 6},
    _kernel(2, 10), _kernel(20, 22), _kernel(30, 50), _kernel(55, 60),
    _kernel(70, 72), _kernel(100, 105),
]
WINDOW_S = 120e-6


def test_idle_is_put_down_to_the_innermost_program_span():
    idle = A.idle_by_span(EVENTS)
    us = {k: round(v * 1e6, 6) for k, v in idle.items()}
    assert us == {"step.prior_update": 18.0, "chains.record": 2.0,
                  "ensemble.chunk": 3.0 + 1.0, "ensemble.to_host": 10.0,
                  "chains.step": 3.0 + 18.0, "step.sweep_P": 5.0,
                  None: 1.0}
    assert sum(idle.values()) == pytest.approx(
        sum(b - a for a, b in A.idle_intervals(EVENTS)) / 1e6)


def test_shares_take_the_gaps_inside_steps_only():
    step = A.step_idle_share(EVENTS, WINDOW_S)
    prior = A.prior_update_idle_share(EVENTS, WINDOW_S)
    assert step == pytest.approx(100 * (18 + 21 + 5) / 120)
    assert prior == pytest.approx(100 * 18 / 120)
    # gaps outside any step (the record, the read, the chunk) go to neither
    outside = [e for e in EVENTS if e["name"] not in ("chains.step",)
               and not e["name"].startswith("step.")]
    assert A.step_idle_share(outside, WINDOW_S) == 0.0
    assert A.prior_update_idle_share(outside, WINDOW_S) is None


def test_step_share_within_the_device_idle_share():
    read = harness.load_reader(ROOT, "device_idle_share")
    stretch = PR.summarize(EVENTS) | {"window_s": WINDOW_S}
    device = read(harness.Run(stretch=stretch))
    step = A.step_idle_share(EVENTS, WINDOW_S)
    assert A.prior_update_idle_share(EVENTS, WINDOW_S) <= step <= device
    # the breakdown's gaps name the program's spans, not the benchmark's
    names = [g[0] for g in stretch["idle_gaps"]]
    assert names[:2] == ["chains.step|none", "step.prior_update|aten::sqrt"]
    assert not any(n.startswith("ensemble/") for n in names)


def test_step_host_ms_leaves_out_the_stretch():
    from bayesnmf_tpu_torch.utils.tracing import Span

    spans = [Span("chains.step", -1, t, t + d) for t, d in
             ((0, 2_000_000), (3_000_000, 4_000_000),
              (8_000_000, 6_000_000), (20_000_000, 9_000_000))]
    assert A.step_host_ms(spans) == 5.0
    assert A.step_host_ms(spans, (7_000_000, 15_000_000)) == 4.0
    assert A.step_host_ms([]) is None


@pytest.mark.parametrize("kind", ["stream", "fused"])
def test_spans_run_on_the_small_cells(kind):
    from bayesnmf_tpu_torch.utils import tracing

    keep = {}
    res, _ = run_small(kind, trace=True, keep=keep)
    assert res["correct"]
    run = keep["run"]
    assert A.step_host_ms(run.program_spans, run.stretch_ns) > 0
    assert res["metrics"]["step_host_ms"]["value"] == \
        A.step_host_ms(run.program_spans, run.stretch_ns)
    summ = tracing.summary(run.program_spans)
    per_step = sum(d["count"] for k, d in summ.items()
                   if k.startswith(("step.", "chains.")))
    assert per_step / summ[A.STEP]["count"] == (8 if kind == "stream" else 6)
    # no device operation on the CPU: the idle shares read nothing
    assert A.step_idle_share(run.events, run.stretch["window_s"]) is None
    assert A.prior_update_idle_share(run.events,
                                     run.stretch["window_s"]) is None
    for name in ("step_idle_share", "prior_update_idle_share",
                 "device_idle_share"):
        assert name not in res["metrics"]
    off = {}
    run_small(kind, keep=off)
    assert tracing.summary(off["run"].program_spans) == {}
    assert A.step_host_ms(off["run"].program_spans) is None
