"""The streaming inclusion column
(``stream_acol_update``): its bound (benchmark/workcount.py's ``acol``,
one update of every chain) over its CUDA-event time per column, in %,
of the call captured in the window (all N columns, repeated)."""


def read(run):
    ms = run.kernel_ms.get("stream_acol_update")
    if not ms:
        return None
    return 100.0 * run.bound_s("acol") * 1e3 / (ms / run.N)
