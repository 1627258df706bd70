"""bench_torch.py, the port's benchmark, on the CPU: it imports nothing of
jax, the JAX package or bench.py, refuses to run without a card, keeps
bench.py's catalogue bit for bit, and its configs and cells return every
metric at tiny sizes through the same functions the card runs; the bounds
moved into bayesnmf_tpu_torch/utils/measure.py give PERF.md's numbers."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench_torch as B  # noqa: E402
from bayesnmf_tpu_torch.utils import measure as MS  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def blocked_imports():
    """One interpreter with jax and the JAX package blocked: bench_torch
    imports and runs its catalogue, then bench.py imports (it imports jax
    inside its functions only) and gives its catalogue at three seeds."""
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['bayesnmf_tpu'] = None\n"
        "import bench_torch\n"
        "from bayesnmf_tpu_torch.utils import measure\n"
        "first = sorted(m for m in sys.modules if m == 'bench')\n"
        "import bench\n"
        "same = [bool((bench._sim_data(seed=s, K=96, N=n, G=g) ==\n"
        "              bench_torch._sim_data(seed=s, K=96, N=n, G=g)[0]).all()\n"
        "             and bench._sim_data(seed=s, K=96, N=n, G=g).dtype ==\n"
        "             bench_torch._sim_data(seed=s, K=96, N=n, G=g)[0].dtype)\n"
        "        for s, n, g in ((0, 8, 500), (1, 5, 100), (7, 20, 1000))]\n"
        "print(json.dumps({'bench_before': first, 'same': same,\n"
        "                  'jax': sys.modules['jax'] is None,\n"
        "                  'pkg': sys.modules['bayesnmf_tpu'] is None}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_imports_without_jax_or_bench(blocked_imports):
    assert blocked_imports["bench_before"] == []
    assert blocked_imports["jax"] and blocked_imports["pkg"]


def test_sim_data_is_bench_py_s_bit_for_bit(blocked_imports):
    assert blocked_imports["same"] == [True, True, True]


def test_no_card_exits_nonzero_without_a_row(monkeypatch, capsys):
    """Without a card the command line exits non-zero before any work (no
    build, no row), whatever the mode."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(B._build, "load_library", lambda: pytest.fail(
        "the kernels were built without a card"))
    for argv in ([], ["--config", "2"], ["--cell", "bl2_fit_96x500_k8"]):
        assert B.main(argv) != 0
        out = capsys.readouterr()
        assert out.out == "" and "is_available" in out.err


@pytest.mark.parametrize("fn, args, want", [
    # PERF.md §6: bounds in ms, to the digits printed there
    (MS.fused_bound, (96, 8, 500), 0.00035),
    (MS.pe_bound, (96, 8, 500), 0.00034),
    (MS.fused_bound, (96, 8, 2780), 0.0019),
    (lambda *a: MS.update_bound(True, *a), (96, 20, 10000, 8), 0.0080),
    (lambda *a: MS.update_bound(False, *a), (96, 20, 10000, 8), 0.0082),
    (MS.acol_update_bound, (96, 20, 10000, 8), 0.0058),
    (MS.metrics_row_bound, (96, 20, 10000, 8), 0.0089),
    (lambda *a: MS.stream_bound("pcol_stats", *a), (96, 20, 10000, 8),
     0.0057),
    (lambda *a: MS.stream_bound("erow_accept", *a), (96, 20, 10000, 8),
     0.0068),
    (lambda *a: MS.stream_bound("chain_metrics", *a), (96, 20, 10000, 8),
     0.0058),
])
def test_moved_bounds_give_perf_md_s(fn, args, want):
    ms, by = fn(*args)
    digits = -int(np.floor(np.log10(want))) + 1
    assert round(ms, digits) == pytest.approx(want)
    assert by in ("bytes", "operations")


def test_recovery_fails_on_a_permuted_and_perturbed_P():
    rng = np.random.default_rng(0)
    P = rng.dirichlet(np.ones(96) * 0.3, 8).T
    perm = rng.permutation(8)
    assert B.recovery(P[:, perm], P, 0.95) == (True, pytest.approx(1.0))
    noisy = P[:, perm] * rng.lognormal(0.0, 1.5, P.shape)
    ok, low = B.recovery(noisy, P, 0.95)
    assert not ok and low < 0.95


def test_breakdown_of_a_trace():
    """Device operations by total time, and the longest idle gaps of the
    device, each labelled with the span the host was in."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench/loop",
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "bench/MAP",
         "ts": 100, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 120,
         "dur": 30},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 40, "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 45, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy", "ts": 180,
         "dur": 10},
    ]
    b = B.breakdown(ev, {"bench/loop", "bench/MAP"}, top=2, gaps=2)
    assert [o["name"] for o in b["top_device_ops"]] == ["k1", "Memcpy"]
    assert b["top_device_ops"][0]["ms"] == pytest.approx(0.040)
    gaps = b["idle_gaps"]
    assert [g["ms"] for g in gaps] == pytest.approx([0.115, 0.010])
    assert gaps[0]["layer"] == "bench/MAP"
    assert gaps[0]["host_op"] == "aten::copy_"
    assert gaps[1]["layer"] == "bench/loop" and gaps[1]["host_op"] is None
    assert b["device_busy_ms"] == pytest.approx(0.055)
    assert b["window_ms"] == pytest.approx(0.180)


def test_an_error_row_is_never_a_value(capsys):
    """A config that raises prints an error row, the next one still runs,
    and the exit code is non-zero; so it is for a row that is not
    correct."""
    def boom(device):
        raise MemoryError("out of memory")

    def good(device):
        return {"metric": "m", "value": 1.0, "correct": True}

    def wrong(device):
        return {"metric": "w", "value": 1.0, "correct": False}

    assert B._rows([boom, good], {"build_seconds": 0.0}) == 1
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert rows[0] == {"metric": "boom", "error": "MemoryError: out of memory"}
    assert rows[1]["value"] == 1.0 and rows[1]["build_seconds"] == 0.0
    assert B._rows([good], {}) == 0
    assert B._rows([wrong], {}) == 1


TINY = {
    B.config1: dict(iters=10, reps=2, baseline_iters=1, K=16, G=40,
                    warmup=10),
    B.config2: dict(iters=10, reps=2, baseline_iters=1, K=16, G=40,
                    warmup=10),
    B.config3: dict(iters=10, reps=1, baseline_iters=1, K=16, N=4, G=40,
                    warmup=10),
}


@pytest.mark.parametrize("fn", list(TINY), ids=lambda f: f.__name__)
def test_config_rows_on_the_cpu(fn):
    row = fn("cpu", **TINY[fn])
    assert {"metric", "value", "unit", "vs_baseline", "reps", "device",
            "correct", "iters"} <= set(row)
    assert np.isfinite(row["value"]) and row["value"] > 0
    assert np.isfinite(row["vs_baseline"]) and row["vs_baseline"] > 0
    assert row["reps"]["n"] == TINY[fn]["reps"]
    assert row["value"] == round(row["reps"]["value"], 2)
    assert row["device"] == {"name": "cpu", "power_limit_w": None}
    assert isinstance(row["correct"], bool)
    json.dumps(row)


@pytest.fixture
def no_plots(monkeypatch):
    """The fits' trace plots at every MAP check are host work the card's
    machine skips (it has no matplotlib); skipped here for time."""
    from bayesnmf_tpu_torch.utils import plotting

    monkeypatch.setattr(plotting, "trace_plot", lambda *a, **k: None)


CELL_TINY = {
    "bl2_fit_96x500_k8": dict(G=30, rank=3, maxiters=20, post_warmup=10,
                              MAP_over=10, MAP_every=10, fits=1, warmups=1,
                              loop_iters=5, loop_reps=2, loop_warmup=5,
                              prof_iters=2, kernel_reps=2, layer_reps=2),
    "cj_fit_96x2780_k8_expo": dict(G=100, rank=3, maxiters=60,
                                   post_warmup=10, MAP_over=10, MAP_every=10,
                                   fits=1, warmups=1, loop_iters=5,
                                   loop_reps=2, loop_warmup=5, prof_iters=2,
                                   kernel_reps=2, layer_reps=2),
    "ns_ens_8x96x10k_sbfi": dict(G=300, true_rank=3, max_rank=4, chains=2,
                                 maxiters=30, post_warmup=10, MAP_over=10,
                                 MAP_every=10, runs=1, warmups=1,
                                 loop_iters=2, loop_reps=2, prof_iters=2,
                                 kernel_reps=2,
                                 stream_sweeps=True),
}


@pytest.mark.parametrize("name", sorted(B.CELLS))
def test_cells_on_the_cpu(name, no_plots):
    """Each cell returns every metric it declares, finite, the device
    metrics "not measured" off the card, and passes its checks."""
    fn, units = B.CELLS[name]
    res = fn("cpu", seed=3, **CELL_TINY[name])
    assert set(res["metrics"]) == set(units)
    device_only = {"device_busy_share", "device_events_per_iter"}
    for k, m in res["metrics"].items():
        if k in device_only:
            assert m is None
            continue
        assert m["n"] >= 1 and np.isfinite(m["samples"]).all(), k
    kinds = [kind for _, kind in units.values()]
    assert kinds.count("end_to_end") == 1
    lines = list(B.metric_lines(res, units))
    assert [ln["metric"] for ln in lines] == list(units)
    assert all(ln["value"] == "not measured" for ln in lines
               if ln["metric"] in device_only)
    assert res["correct"] and len(res["checks"]) >= 2
    assert res["breakdown"] is None     # no --trace here
    # the end-to-end rate is all the timed runs' work over all their time
    (e2e,) = [k for k, (_, kind) in units.items() if kind == "end_to_end"]
    m = res["metrics"][e2e]
    assert m["value"] == pytest.approx(
        sum(m["work"]) / sum(w / r for w, r in zip(m["work"], m["samples"])))
    phases = res.get("fit_seconds_by_phase") or res["run_seconds_by_phase"]
    assert len(phases) == m["n"]
    for ph in phases:
        assert set(ph) == {"loop", "map_check", "checkpoint", "other"}
        assert ph["loop"] > 0 and ph["map_check"] > 0 and ph["checkpoint"] > 0
    json.dumps(res)


def test_summary_weighs_each_run_by_its_time():
    """Two runs of 100 iterations at 100 and 50 it/s ran 200 iterations in
    3 s, whatever the median says."""
    m = B.summary([100.0, 50.0], [100, 100])
    assert m["value"] == pytest.approx(200 / 3)
    assert m["median"] == pytest.approx(75.0)
    assert B.summary([1.0, 2.0, 9.0])["value"] == 2.0


def test_phase_clock_counts_each_call_once_and_restores(monkeypatch):
    """A call made inside another counts for the inner label only; the
    methods are the originals again after the block, an inherited one
    removed from the subclass."""
    now = [0.0]
    monkeypatch.setattr(B.time, "perf_counter", lambda: now[0])

    class Base:
        def inner(self):
            now[0] += 2.0

    class Sub(Base):
        def outer(self):
            now[0] += 1.0
            self.inner()

    outer = Sub.outer
    with B.phase_clock([(Sub, "outer", "a"), (Sub, "inner", "b")]) as secs:
        Sub().outer()
        Sub().inner()
    assert secs == {"a": 1.0, "b": 4.0}
    assert Sub.outer is outer and "inner" not in vars(Sub)


def test_compaction_mode_compares_equal_work_on_the_cpu():
    """--compact (bench.py's mode): both runs do the same chain-iterations,
    each chain ending at the same iteration, and the value is the
    wall-clock ratio."""
    row = B.bench_compaction("cpu", n_chains=3, K=16, G=16, maxiters=100,
                             miniters=20, MAP_over=10, MAP_every=10,
                             post_warmup=10)
    assert row["correct"]
    assert row["compact_chain_iters"] == row["no_compact_chain_iters"]
    assert row["reps"]["value"] == pytest.approx(
        row["no_compact_seconds"] / row["compact_seconds"], rel=0.02)
    json.dumps(row)
