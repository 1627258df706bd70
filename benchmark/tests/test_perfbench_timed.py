"""What a traced run times and keeps: the calls the reference's ``TIMED``
declares for the run's path (poisson_tn_mh's giving the stream and fused
cells' timing names, a reference of this file's own timing the conjugate
path's allocation and prior update, an undeclared call stopping the run),
the program's spans recorded in traced runs only, the check's copies kept
out of the profiled stretch, and the three readers of the spans."""

import json
import os
import shutil

import pytest

from benchmark import check as CK
from benchmark import harness
from small import ROOT, run_small

STREAM = {"stream_pcol_update", "stream_erow_update", "stream_acol_update",
          "prior_update"}

# the timed calls of the conjugate path, as a Poisson-Gamma reference would
# declare them, over poisson_tn_mh's step declarations (which do not
# replay that path)
CONJUGATE = '''
TIMED = {"conjugate": {
    "allocation": ("models.updates:allocate_counts",),
    "prior_update": ("models.updates:sample_prior_params",)}}
'''
GAMMA = {"prior": "gamma", "MH": False}


def _tree(tmp_path, name, extra):
    """A copy of the benchmark with the reference ``name``: poisson_tn_mh's
    source followed by ``extra``."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    ref = tmp_path / "benchmark" / "reference"
    (ref / f"{name}.py").write_text(
        (ref / "poisson_tn_mh.py").read_text() + extra)
    return str(tmp_path)


@pytest.mark.parametrize("kind,names", [("stream", STREAM),
                                        ("fused", {"fused_gibbs_sweeps"}),
                                        ("bic", {"fused_gibbs_sweeps"})])
def test_declared_calls_give_the_parents_timing_names(kind, names):
    keep = {}
    res, lines = run_small(kind, trace=True, keep=keep)
    assert res["correct"], lines
    assert set(keep["run"].kernel_ms) == names
    assert all(v > 0 for v in keep["run"].kernel_ms.values())


def test_every_cell_reference_times_its_path():
    b = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for w in b["workloads"]:
        cell = harness.load_cell(ROOT, w["name"])
        ref = CK.load_reference(ROOT, cell["config"]["reference"])
        assert harness.timed_calls(ref, cell["traffic"]["path"])


def test_a_reference_of_its_own_times_the_conjugate_path(tmp_path):
    root = _tree(tmp_path, "conjugate_timed", CONJUGATE)
    keep = {}
    res, lines = run_small("fit", trace=True, keep=keep, model=GAMMA,
                           root=root, reference="conjugate_timed")
    assert keep["run"].path == "conjugate"
    assert set(keep["run"].kernel_ms) == {"allocation", "prior_update"}
    # the path is timed, and still not replayed: not correct
    assert not res["correct"]
    assert lines[0].startswith("path conjugate: not declared by the "
                               "reference conjugate_timed")


@pytest.mark.parametrize("call", ["models.gibbs:no_such_call",
                                  "ops.no_such_module:fused_gibbs_sweeps",
                                  "models.gibbs"])
def test_a_declared_call_that_does_not_exist_stops_the_run(tmp_path, call):
    extra = f'\nTIMED = {{"fused": {{"gone": ("{call}",)}}}}\n'
    root = _tree(tmp_path, "missing_call", extra)
    for trace in (False, True):
        with pytest.raises(harness.MissingCall, match=call):
            run_small("fit", trace=trace, root=root, reference="missing_call")


def test_untraced_runs_leave_tracing_off(monkeypatch):
    from bayesnmf_tpu_torch.utils import tracing

    calls = []
    enable = tracing.enable
    monkeypatch.setattr(tracing, "enable",
                        lambda: (calls.append(1), enable())[1])
    keep = {}
    run_small("stream", keep=keep)
    assert not calls and not tracing._on
    assert list(keep["run"].program_spans) == []
    assert keep["run"].events is None and keep["run"].stretch_ns is None
    run_small("stream", trace=True, keep=keep)
    assert calls == [1] and not tracing._on
    run = keep["run"]
    assert any(s.name == "chains.step" for s in run.program_spans)
    t0, t1 = run.stretch_ns
    assert t0 < t1 and run.events


@pytest.mark.parametrize("kind", ["stream", "fit"])
def test_captures_leave_the_stretch(kind, monkeypatch):
    # every step of the stretch (the plan's chunk 1: iterations 2 and 3) is
    # sampled for the check; each capture lands after the stretch
    sample = {1, 2, 3}
    monkeypatch.setattr(harness.CK, "sample_steps",
                        lambda *a: set(sample))
    for trace, want in ((False, [1, 2, 3]), (True, [1, 4])):
        keep = {}
        res, lines = run_small(kind, trace=trace, keep=keep)
        assert res["correct"], lines
        assert [c["in"]["it"] for c in keep["args"][3]] == want


def test_readers_read_where_their_inputs_exist():
    from bayesnmf_tpu_torch.utils.tracing import Span
    from test_perfbench_attribution import EVENTS, WINDOW_S

    def read(name, run):
        return harness.load_reader(ROOT, name)(run)

    # the step open across the stretch (5 to 6 ms) is left out
    run = harness.Run(events=EVENTS, stretch={"window_s": WINDOW_S},
                      stretch_ns=(5_000_000, 6_000_000),
                      program_spans=[
                          Span("chains.step", -1, 0, 4_000_000),
                          Span("chains.step", -1, 4_500_000, 5_500_000),
                          Span("chains.step", -1, 7_000_000, 9_000_000)])
    assert read("step_idle_share", run) == pytest.approx(100 * 44 / 120)
    assert read("prior_update_idle_share", run) == pytest.approx(
        100 * 18 / 120)
    assert read("step_host_ms", run) == 3.0
    # no trace, no step span, no chain step: nothing to read
    for name in ("step_idle_share", "prior_update_idle_share",
                 "step_host_ms"):
        assert read(name, harness.Run()) is None
    outside = [e for e in EVENTS if e["name"] != "chains.step"
               and not e["name"].startswith("step.")]
    bare = harness.Run(events=outside, stretch={"window_s": WINDOW_S},
                       program_spans=[Span("fit", -1, 0, 9)])
    for name in ("step_idle_share", "prior_update_idle_share",
                 "step_host_ms"):
        assert read(name, bare) is None


@pytest.mark.parametrize("kind,present", [
    ("stream", {"step_host_ms"}), ("bic", {"step_host_ms"}),
    ("fit", set())])
def test_readers_on_the_small_cells(kind, present):
    # the CPU runs no device operation, so the idle shares read nothing;
    # one chain's run_chunk spans no chains.step
    res, lines = run_small(kind, trace=True)
    assert res["correct"], lines
    got = {"step_idle_share", "prior_update_idle_share",
           "step_host_ms"} & set(res["metrics"])
    assert got == present
    for name in present:
        assert res["metrics"][name]["value"] > 0
