"""The window's rate is all the work over all the time: whole fits back to
back, the window closing at the end of the first fit that ends after the
given seconds, and a stall inside one fit lowering the rate."""

import time

import pytest

from benchmark import harness
from small import ROOT, run_small


def test_rate_is_all_work_over_all_time():
    read = harness.load_reader(ROOT, "chain_iterations_per_sec")
    run = harness.Run(chain_iters=3000 + 1000, window_s=8.0)
    assert read(run) == 500.0


def test_window_runs_whole_fits_past_its_seconds():
    res, _ = run_small("stream", seconds=0.0)
    assert res["attempted"] == 1
    res, _ = run_small("stream", seconds=1.5)
    # every fit of 2 chains runs 10 steps; the window ends after a whole fit
    assert res["attempted"] >= 2
    rate = res["metrics"]["chain_iterations_per_sec"]["value"]
    assert rate > 0


def test_a_stall_inside_one_fit_lowers_the_rate(monkeypatch):
    base, _ = run_small("bic", seed=7, seconds=0.0)
    import bayesnmf_tpu_torch

    ens_cls = bayesnmf_tpu_torch.ChainEnsemble
    orig = ens_cls._check_convergence
    stalled = []

    def stall(self):
        # once, in the window's first fit (not in the set-up's warm fit)
        if not stalled and self.seed == harness._fit_seed(7, 1):
            stalled.append(1)
            time.sleep(2.0)
        return orig(self)

    monkeypatch.setattr(ens_cls, "_check_convergence", stall)
    slow, _ = run_small("bic", seed=7, seconds=0.0)
    assert stalled
    b = base["metrics"]["chain_iterations_per_sec"]["value"]
    s = slow["metrics"]["chain_iterations_per_sec"]["value"]
    assert s < b
    assert base["attempted"] == slow["attempted"] == 1


@pytest.mark.parametrize("kind", ["stream", "bic", "fused"])
def test_setup_is_reported_apart(kind):
    res, _ = run_small(kind)
    assert res["metrics"]["setup_s"]["value"] > 0
