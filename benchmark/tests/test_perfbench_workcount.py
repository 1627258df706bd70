"""The yardstick's work count: one bound for a step at one shape, whichever
path runs it, and the per-update counts adding up to the step's."""

import pytest

from benchmark import harness
from benchmark import workcount as W
from small import ROOT

SHAPES = [(96, 20, 10000, 8, True), (1536, 20, 2780, 8, True),
          (96, 20, 1000, 20, False), (1536, 20, 1000, 8, True)]


def _run(path, shape):
    K, N, G, C, learning = shape
    return harness.Run(K=K, N=N, G=G, C=C, learning=learning, path=path,
                       steps=[C] * 10, window_s=1.0,
                       count=harness.load_count(ROOT, "poisson_tn_mh"))


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_and_stream_steps_read_one_bound(shape):
    read = harness.load_reader(ROOT, "step_mfu")
    assert read(_run("fused", shape)) == read(_run("stream", shape))
    assert _run("fused", shape).step_bound_s(shape[3]) == \
        W.step_bound_s(*shape)


@pytest.mark.parametrize("shape", SHAPES)
def test_updates_add_up_to_the_step(shape):
    K, N, G, C, learning = shape
    parts = W.components(K, N, G, C, learning)
    ops, _ = W.step(K, N, G, C, learning)
    assert sum(o * n for o, _, n in parts.values()) == ops
    sweep_ops, _ = W.sweep_call(K, N, G, C, learning)
    assert sweep_ops + parts["row"][0] + parts["draws"][0] == ops
    assert set(parts) == ({"hyper", "pcol", "erow", "row", "draws"}
                          | ({"acol", "rdraw"} if learning else set()))


def test_counts_are_the_algorithms():
    # one P column of one chain at 96x10k: two passes and a rank-1 update
    # of 11 + 20 + 2 operations an entry, and the 150-operation epilogue a
    # row; the data matrix read once
    ops, n_bytes, times = W.components(96, 20, 10000, 1, True)["pcol"]
    assert ops == 96 * 10000 * 33 + 96 * 150 and times == 20
    assert n_bytes >= 4 * 96 * 10000
    # operations bound every cell's step on the H100
    for shape in SHAPES:
        ops, n_bytes = W.step(*shape)
        assert ops / W.F32_OPS_PER_S > n_bytes / W.HBM_BYTES_PER_S
