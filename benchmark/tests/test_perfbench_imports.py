"""Nothing the benchmark runs loads JAX or the JAX package: the harness,
every configuration, traffic mix, cell, reference and metric reader, and a
small run, in a fresh interpreter, compared by whole top-level names
(``bayesnmf_tpu_torch`` is the port's own)."""

import os
import subprocess
import sys

from small import ROOT

CODE = r"""
import glob, json, os, sys
sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.join(os.getcwd(), "benchmark", "tests"))
import torch
torch.set_num_threads(1)
from benchmark import harness, check, control
b = json.load(open("BENCHMARK.json"))
for w in b["workloads"]:
    cell = harness.load_cell(".", w["name"])
    check.load_reference(".", cell["config"]["reference"])
    for m in cell["end_to_end"] + cell["per_layer"]:
        harness.load_reader(".", m["name"])
for p in glob.glob("benchmark/metrics/*.py"):
    harness.load_reader(".", os.path.basename(p)[:-3])
from small import run_small
res, _ = run_small("stream")
assert res["correct"]
top = sorted({m.split(".")[0] for m in sys.modules})
print(json.dumps(top))
"""


def test_no_jax_in_the_benchmark():
    out = subprocess.run([sys.executable, "-c", CODE], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    import json

    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "bayesnmf_tpu"}
    assert "bayesnmf_tpu_torch" in top


def test_run_refuses_without_the_program(tmp_path):
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from benchmark import harness\n"
            "harness.run('.', 'sbs96_ens8_g10k', 1, 1.0, False, 'cpu')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "bayesnmf_tpu_torch" in out.stderr
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "sbs96_ens8_g10k", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
