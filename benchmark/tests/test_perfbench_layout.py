"""The harness is driven by data: a configuration, a traffic mix, a cell's
limits and a metric's reader are files found by their names, so adding one
edits no other file; and the result line has its fixed keys."""

import json
import os
import shutil

import pytest

from benchmark import harness
from small import ROOT, run_small

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture()
def tree(tmp_path):
    """A copy of BENCHMARK.json and the benchmark's files."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_new_files_are_found_by_name(tree):
    b = json.loads((tree / "BENCHMARK.json").read_text())
    here = tree / "benchmark"
    cfg = json.loads((here / "configs" / "sbs96_poisson_tn_mh.json")
                     .read_text())
    cfg["name"] = "sbs96_other"
    (here / "configs" / "sbs96_other.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "traffic" / "ens8_g10k_sbfi.json").read_text())
    mix["G"] = 5000
    (here / "traffic" / "ens8_g5k_sbfi.json").write_text(json.dumps(mix))
    (here / "workloads" / "sbs96_other_g5k.json").write_text(json.dumps(
        {"limits": {"mismatch_share": 1e-3}, "replays_per_fit": 2,
         "trace": {"fit": 0, "chunk": 2}}))
    (here / "metrics" / "fits_per_window.py").write_text(
        "def read(run):\n    return len(run.fits)\n")
    b["configs"].append({"name": "sbs96_other", "source": "x",
                         "file": "benchmark/configs/sbs96_other.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "sbs96_other_g5k", "config": "sbs96_other",
                           "traffic": "ens8_g5k_sbfi", "chips": 1,
                           "why": "x"})
    b["per_layer"].append({"name": "fits_per_window", "unit": "fits",
                           "better": "higher", "source": "host_clock",
                           "layer": "ensemble",
                           "moves": "chain_iterations_per_sec",
                           "workloads": ["sbs96_other_g5k"]})
    (tree / "BENCHMARK.json").write_text(json.dumps(b))
    cell = harness.load_cell(str(tree), "sbs96_other_g5k")
    assert cell["config"]["name"] == "sbs96_other"
    assert cell["traffic"]["G"] == 5000
    assert [m["name"] for m in cell["per_layer"]] == ["fits_per_window"]
    read = harness.load_reader(str(tree), "fits_per_window")
    assert read(harness.Run(fits=[1, 2, 3])) == 3
    # the cells already there read the same
    old = harness.load_cell(str(tree), "sbs96_ens8_g10k")
    assert old == harness.load_cell(ROOT, "sbs96_ens8_g10k")


def test_every_declared_file_exists():
    b = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for w in b["workloads"]:
        cell = harness.load_cell(ROOT, w["name"])
        assert cell["traffic"]["path"] in ("stream", "fused")
        for m in cell["end_to_end"] + cell["per_layer"]:
            assert callable(harness.load_reader(ROOT, m["name"]))
        assert cell["end_to_end"] and cell["per_layer"]
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    res, lines = run_small("stream", trace=trace)
    want = RESULT_KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(res) == want
    assert list(res["checks"]) == ["mismatch_share"]
    assert set(res["checks"]["mismatch_share"]) == {"value", "limit"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert lines[-1].startswith("check mismatch_share ")
    json.dumps(res)
