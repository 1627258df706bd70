"""What decides ``correct``: the program's steps against the plain
reference, the control in bfloat16 failing the cell's limit, and a run
whose step is broken underneath (its state unchanged, half its chains left
out, one chain's answer altered) coming out not correct."""

import pytest
import torch

from benchmark import control
from small import run_small, small_cell

KINDS = ["stream", "bic", "fused"]


@pytest.mark.parametrize("kind", KINDS)
def test_sound_run_is_correct(kind):
    res, _ = run_small(kind)
    assert res["correct"], res["checks"]
    assert res["checks"]["mismatch_share"]["value"] == 0.0


@pytest.mark.parametrize("kind", KINDS)
def test_control_fails_the_limit(kind):
    cell = small_cell(kind)
    got = control.readings(cell["name"], 5, 0.0, "cpu", cell)
    limit = cell["workload"]["limits"]["mismatch_share"]
    assert got["program"] <= limit < got["control"]


def _broken(fault):
    from bayesnmf_tpu_torch.models import gibbs

    orig = gibbs.gibbs_step

    def step(spec, data, hp, state, *a, **k):
        new, sample = orig(spec, data, hp, state, *a, **k)
        bad = dict(new)
        bad["params"] = dict(new["params"])
        bad["prior"] = dict(new["prior"])
        C = new["params"]["P"].shape[0]
        if fault == "unchanged":
            bad["params"] = dict(state["params"])
            bad["prior"] = dict(state["prior"])
            bad["acc_P"], bad["acc_E"] = state["acc_P"], state["acc_E"]
        elif fault == "half":
            keep = torch.arange(C) < C - C // 2
            for group in ("params", "prior"):
                for name, v in new[group].items():
                    old = state[group][name]
                    m = keep.view((C,) + (1,) * (v.dim() - 1)).to(v.device)
                    bad[group][name] = torch.where(m, v, old)
        elif fault == "altered":
            P = new["params"]["P"].clone()
            P[0] *= 1.01
            bad["params"]["P"] = P
        return bad, sample
    return gibbs, orig, step


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("kind", KINDS)
def test_broken_step_is_not_correct(kind, fault, monkeypatch):
    gibbs, _, step = _broken(fault)
    monkeypatch.setattr(gibbs, "gibbs_step", step)
    res, _ = run_small(kind)
    assert not res["correct"]
    assert res["checks"]["mismatch_share"]["value"] > \
        res["checks"]["mismatch_share"]["limit"]
