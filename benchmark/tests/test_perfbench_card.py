"""On the card: one short run of each cell's entry through benchmark/run.py
(the library built once, into the checkout), ``correct`` and every
end-to-end metric in its line. Skips without a CUDA card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from small import ROOT


@pytest.mark.card
@pytest.mark.parametrize("cell", ["sbs96_bic20_g1000", "sbs96_ens8_g10k"])
def test_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          cell, "--seed", "4242424242", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], out.stderr[-2000:]
    assert {"chain_iterations_per_sec", "setup_s"} <= set(res["metrics"])
    assert res["device"]["platform"] == "gpu"
    assert os.path.isdir(os.path.join(ROOT, "build", "bayesnmf_tpu_torch"))
