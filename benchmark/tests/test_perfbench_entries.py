"""The configuration's model reaches the program, through each entry: the
``fit`` entry (one GibbsSampler) checked as the ensembles are; a model the
reference does not replay, or a key the program does not take up, making
the run not correct; the reference's declarations deciding what is
replayed; and a model without a work count reading no bound."""

import json
import os
import shutil

import pytest
import torch

from benchmark import check as CK
from benchmark import harness
from bayesnmf_tpu_torch.config import ModelSpec
from small import ROOT, run_small, small_cell


@pytest.mark.parametrize("kind", ["fit", "fit_sbfi"])
def test_fit_entry_is_correct(kind):
    keep = {}
    res, lines = run_small(kind, keep=keep)
    assert res["correct"], lines
    assert res["checks"]["mismatch_share"]["value"] == 0.0
    got = keep["got"]
    assert got["starts"] == res["attempted"] >= 1
    assert got["steps"] >= res["attempted"]
    spec = keep["spec"]
    assert spec.learning_rank == (kind == "fit_sbfi") and spec.fused_sweeps
    # one chain: a step is one chain-iteration, 6 - 1 + 4 steps a fit
    assert keep["run"].steps == [1] * 9 * res["attempted"]


def test_fit_entry_traced():
    keep = {}
    res, lines = run_small("fit", trace=True, keep=keep)
    assert res["correct"], lines
    assert res["metrics"]["outside_loop_share"]["value"] > 0
    # the stretch opened at the plan's chunk of the sampler's loop and
    # counted its steps: device_events_per_iter's divisor (the CPU runs no
    # device operation, so the reading itself is the card's)
    run = keep["run"]
    assert run.stretch["steps"] > 0 and res["device"]["window_s"] > 0
    # chunks of 1, 2, 2 warm-up and 2, 2 post-warm-up steps
    assert len(run.spans["loop"]) == 5 and len(run.spans["construct"]) == 1
    read = harness.load_reader(ROOT, "device_events_per_iter")
    with_ops = harness.Run(stretch=dict(run.stretch, n_device_ops=90))
    assert read(with_ops) == 90 / run.stretch["steps"]


@pytest.mark.parametrize("model,path", [
    ({"prior": "gamma", "MH": False}, "conjugate"),
    ({"likelihood": "normal", "MH": False}, "eager")])
def test_model_reaches_the_program(model, path):
    keep = {}
    res, lines = run_small("fit", trace=True, keep=keep, model=model)
    spec = keep["spec"]
    assert (spec.likelihood, spec.prior, spec.MH) == (
        model.get("likelihood", "poisson"), model.get("prior", "truncnormal"),
        False)
    assert not res["correct"]
    assert lines[0].startswith(f"path {path}: not declared by the reference")
    # nothing replayed by another path's step, and no TN-MH bound read
    assert keep["got"]["steps"] == keep["got"]["starts"] == 0
    assert res["checks"]["mismatch_share"]["value"] == 1.0
    assert "step_mfu" not in res["metrics"]
    assert "outside_loop_share" in res["metrics"]


@pytest.mark.parametrize("kind,model,line", [
    ("fused", {"exact_truncnorm_hypers": False},
     "model exact_truncnorm_hypers: configuration False, program True"),
    ("fit", {"tempering": "off"},
     "model tempering: configuration 'off', program '(not taken up)'")])
def test_model_key_not_taken_up_is_reported(kind, model, line):
    res, lines = run_small(kind, model=model)
    assert not res["correct"]
    assert line in lines
    # the program ran the reference's model all the same
    assert res["checks"]["mismatch_share"]["value"] == 0.0


def test_model_keys_go_where_they_are_taken():
    import bayesnmf_tpu_torch as bt

    model = json.load(open(os.path.join(
        ROOT, "benchmark", "configs", "sbs96_poisson_tn_mh.json")))["model"]
    ens = harness.model_kw(model, bt.ChainEnsemble)
    one = harness.model_kw(model, bt.GibbsSampler)
    assert ens == {"likelihood": "poisson", "prior": "truncnormal",
                   "MH": True}
    assert one == ens | {"exact_truncnorm_hypers": True}


def test_path_is_named_from_the_spec():
    def spec(**kw):
        return ModelSpec(K=12, N=3, G=40, **kw)

    assert harness.path_of(spec(stream_sweeps=True)) == "stream"
    assert harness.path_of(spec(fused_sweeps=True)) == "fused"
    assert harness.path_of(spec(prior="gamma", MH=False)) == "conjugate"
    assert harness.path_of(spec(prior="exponential", MH=False)) == \
        "conjugate"
    assert harness.path_of(spec()) == "eager"
    assert harness.path_of(spec(likelihood="normal", MH=False)) == "eager"


def test_undeclared_path_is_never_replayed():
    ref = CK.load_reference(ROOT, "poisson_tn_mh")
    assert set(ref.STEPS) == {"stream", "fused"}
    assert set(ref.START) <= set(ref.STATE)
    cap = {"in": {}, "out": {}}
    with pytest.raises(KeyError):
        CK.replay(ref, None, None, cap, "eager", 3, True, True)
    got = CK.mismatch(ref, torch.zeros(12, 40), None, [cap], [{}],
                      "conjugate", 3, True, True)
    assert got["mismatch_share"] == 1.0 and got["steps"] == 0


def test_every_cell_path_is_declared_by_its_reference():
    b = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for w in b["workloads"]:
        cell = harness.load_cell(ROOT, w["name"])
        ref = CK.load_reference(ROOT, cell["config"]["reference"])
        assert cell["traffic"]["path"] in ref.STEPS
        assert cell["traffic"]["entry"] in harness.ENTRIES
        assert harness.load_count(ROOT, cell["config"]["reference"])


def test_no_count_leaves_out_the_bounds(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    ref = tmp_path / "benchmark" / "reference"
    shutil.copy(ref / "poisson_tn_mh.py", ref / "uncounted.py")
    assert harness.load_count(str(tmp_path), "uncounted") is None
    keep = {}
    res, lines = run_small("fit", trace=True, keep=keep,
                           model=None, root=str(tmp_path),
                           reference="uncounted")
    assert res["correct"], lines
    assert keep["run"].step_bound_s(1) is None
    assert "outside_loop_share" in res["metrics"]
    assert "step_mfu" not in res["metrics"]
    assert "fused_sweep_roofline" not in res["metrics"]


@pytest.mark.card
def test_fit_entry_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    cell = small_cell("fit")
    res, lines = harness.run(ROOT, cell["name"], 4242424242, 0.0, True,
                             "cuda", cell=cell)
    assert res["correct"], lines
    assert res["metrics"]["device_events_per_iter"]["value"] > 0
    assert "outside_loop_share" in res["metrics"]
    assert res["device"]["platform"] == "gpu"
