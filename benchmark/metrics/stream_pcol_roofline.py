"""The streaming P column (``stream_pcol_update``,
csrc/stream_sweeps.cu): its bound (benchmark/workcount.py's ``pcol``,
one update of every chain) over its CUDA-event time per column, in %,
of the call captured in the window (all N columns, repeated)."""


def read(run):
    ms = run.kernel_ms.get("stream_pcol_update")
    if not ms:
        return None
    return 100.0 * run.bound_s("pcol") * 1e3 / (ms / run.N)
