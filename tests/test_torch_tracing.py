"""The port's spans (bayesnmf_tpu_torch/utils/tracing.py) on the CPU: off
they record nothing and cost one shared object; on they leave every draw
as it was, nest chunk > step > the step's parts on the stream and fused
paths, count what the ensemble counts, and reach the profiler's trace
only while a profiler records."""

import inspect
import json
import tracemalloc

import numpy as np
import pytest
import torch

import bayesnmf_tpu_torch as bt
from bayesnmf_tpu_torch.utils import tracing

torch.set_num_threads(1)

PATHS = {"stream": dict(stream_sweeps=True), "fused": dict()}
STEP_PARTS = {
    "stream": {"step.draws", "step.prior_update", "step.sweep_P",
               "step.sweep_E", "step.rank", "step.metrics_row"},
    "fused": {"step.mhat", "step.draws", "step.fused_sweep",
              "step.metrics_row"},
}


@pytest.fixture(autouse=True)
def _tracing_left_off():
    yield
    tracing.disable()
    tracing.take()


def _data(seed=3, K=12, G=40):
    rng = np.random.default_rng(seed)
    return rng.poisson(20.0, (K, G)).astype(np.float32)


def _ensemble(path, **kw):
    cc = bt.ConvergenceControl(MAP_over=4, MAP_every=2, miniters=0,
                               maxiters=6, Ninarow_nochange=10 ** 9,
                               Ninarow_nobest=10 ** 9)
    return bt.ChainEnsemble(_data(), range(1, 4), n_chains=2,
                            convergence_control=cc, post_warmup=4, seed=5,
                            device="cpu", **(PATHS[path] | kw))


def _traced_run(path, on):
    if on:
        tracing.enable()
    ens = _ensemble(path)
    ens.run()
    tracing.disable()
    return ens, tracing.take()


@pytest.fixture(scope="module")
def runs():
    """Each path's ensemble run with tracing off, then on."""
    out = {}
    for path in PATHS:
        off = _traced_run(path, False)
        out[path] = {"off": off, "on": _traced_run(path, True)}
    return out


@pytest.mark.parametrize("path", list(PATHS))
def test_off_records_nothing(runs, path):
    ens, spans = runs[path]["off"]
    assert ens.spec.stream_sweeps == (path == "stream")
    assert ens.spec.fused_sweeps == (path == "fused")
    assert spans == []


@pytest.mark.parametrize("path", list(PATHS))
def test_on_leaves_the_draws_as_they_were(runs, path):
    (off, _), (on, spans) = runs[path]["off"], runs[path]["on"]
    assert spans
    a, b = off.whole_states()["params"], on.whole_states()["params"]
    for k in ("P", "E", "A", "R"):
        assert torch.equal(a[k], b[k]), k
    np.testing.assert_array_equal(off._metrics_all(), on._metrics_all())


@pytest.mark.parametrize("path", list(PATHS))
def test_spans_nest_chunk_step_part(runs, path):
    _, spans = runs[path]["on"]
    names = [s.name for s in spans]
    for s in spans:
        if s.name.startswith("step."):
            assert names[s.parent] == "chains.step", s
        if s.name in ("chains.step", "chains.record", "ensemble.to_host"):
            assert names[s.parent] == "ensemble.chunk", s
        if s.name == "ensemble.chunk":
            assert names[s.parent] == "ensemble.run", s
        assert s.t0_ns <= s.t1_ns
    assert {n for n in names if n.startswith("step.")} == STEP_PARTS[path]
    # at most eight spans a step, the step's own and its record's included
    n_steps = names.count("chains.step")
    per_step = sum(n.startswith(("step.", "chains.")) for n in names)
    assert per_step <= 8 * n_steps


@pytest.mark.parametrize("path", list(PATHS))
def test_spans_count_what_the_ensemble_counts(runs, path):
    ens, spans = runs[path]["on"]
    names = [s.name for s in spans]
    steps = [s for s in spans if s.name == "chains.step"]
    # the ensemble's iteration counts the initial state as iteration 1
    assert len(steps) == ens.iter - 1
    # no chain ends early here, so every step runs every chain
    assert len(steps) * ens.n_chains == ens._chain_iters
    chunks = [i for i, n in enumerate(names) if n == "ensemble.chunk"]
    per_chunk = [sum(s.parent == i for s in steps) for i in chunks]
    # the first chunk runs from iteration 1 to the first MAP check at 2
    assert per_chunk == [1, 2, 2, 2, 2]
    reads = [s.parent for s in spans if s.name == "ensemble.to_host"]
    assert reads == chunks
    assert names.count("ensemble.finalize") == ens.n_chains
    assert names.count("ensemble.map_check") == len(chunks)


@pytest.mark.parametrize("path", list(PATHS))
def test_summary_self_within_total(runs, path):
    _, spans = runs[path]["on"]
    summ = tracing.summary(spans)
    assert summ["chains.step"]["count"] == sum(
        s.name == "chains.step" for s in spans)
    for name, d in summ.items():
        assert 0.0 <= d["self_s"] <= d["total_s"], name
    # a step's self time is what its parts leave over
    assert summ["chains.step"]["self_s"] < summ["chains.step"]["total_s"]


def test_off_is_one_shared_object_and_allocates_nothing():
    assert tracing.span("a") is tracing.span("b")
    with tracing.span("a") as sp:
        assert sp is tracing.span("c")

    def spans(n):
        for _ in range(n):
            with tracing.span("chains.step"):
                pass

    spans(10)
    tracemalloc.start()
    try:
        base = tracemalloc.get_traced_memory()[0]
        spans(1000)
        grown = tracemalloc.get_traced_memory()[0] - base
    finally:
        tracemalloc.stop()
    assert grown == 0
    assert tracing.take() == []


def test_take_clears_and_nests_by_order():
    tracing.enable()
    with tracing.span("outer"):
        with tracing.span("inner"):
            pass
        with tracing.span("inner"):
            pass
    tracing.disable()
    with tracing.span("after"):
        pass
    spans = tracing.take()
    assert [(s.name, s.parent) for s in spans] == [
        ("outer", -1), ("inner", 0), ("inner", 0)]
    assert tracing.take() == []
    summ = tracing.summary(spans)
    assert summ["inner"]["count"] == 2
    inner = sum(s.t1_ns - s.t0_ns for s in spans[1:]) / 1e9
    assert summ["outer"]["self_s"] == pytest.approx(
        summ["outer"]["total_s"] - inner)


def test_traced_puts_each_call_in_a_span():
    @tracing.traced("layer.part")
    def part(x, *, y=1):
        """doc"""
        with tracing.span("layer.inner"):
            return x + y

    assert part.__name__ == "part" and part.__doc__ == "doc"
    assert list(inspect.signature(part).parameters) == ["x", "y"]
    assert part(1, y=2) == 3
    assert tracing.take() == []
    tracing.enable()
    assert part(1) == 2
    tracing.disable()
    assert [(s.name, s.parent) for s in tracing.take()] == [
        ("layer.part", -1), ("layer.inner", 0)]


def test_take_while_a_span_is_open():
    tracing.enable()
    with tracing.span("outer"):
        first = tracing.take()
        assert first == [None]
        with tracing.span("inner"):
            pass
    tracing.disable()
    assert [s.name for s in first] == ["outer"]
    (inner,) = tracing.take()
    assert inner.name == "inner" and inner.parent == -1


def test_profiler_sees_spans_only_while_recording(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    tracing.enable()
    with tracing.span("fit.unprofiled"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("ensemble.chunk"):
            with tracing.span("step.prior_update"):
                torch.ones(4).sqrt()
    tracing.disable()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    named = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"ensemble.chunk", "step.prior_update"} <= named
    assert "fit.unprofiled" not in named
    assert [s.name for s in tracing.take()] == [
        "fit.unprofiled", "ensemble.chunk", "step.prior_update"]


def test_fit_and_checkpoint_spans(tmp_path):
    cc = bt.ConvergenceControl(MAP_over=4, MAP_every=2, miniters=0,
                               maxiters=4, Ninarow_nochange=10 ** 9,
                               Ninarow_nobest=10 ** 9)
    tracing.enable()
    out = bt.fit(_data(), [1, 2], rank_method="BIC", convergence_control=cc,
                 post_warmup=2, output_dir=str(tmp_path / "fit"),
                 periodic_save=False, device="cpu", seed=1)
    tracing.disable()
    spans = tracing.take()
    names = [s.name for s in spans]
    root = spans[0]
    assert root.name == "fit" and root.parent == -1
    parent = {n: names[s.parent] for n, s in zip(names, spans)
              if s.parent >= 0}
    assert parent["fit.bic_table"] == "fit"
    assert parent["ensemble.construct"] == "fit"
    assert parent["ensemble.run"] == "fit"
    assert parent["ensemble.checkpoint"] == "ensemble.run"
    assert parent["checkpoint.write"] == "ensemble.checkpoint"
    assert (tmp_path / "fit" / "ensemble.ckpt").stat().st_size > 0
    # the BIC ensemble ran, so ``traced`` kept ChainEnsemble's signature
    assert out["ensemble"].n_chains == 2
