"""The streaming E row (``stream_erow_update``): its bound
(benchmark/workcount.py's ``erow``, one update of every chain) over its
CUDA-event time per row, in %, of the call captured in the window (all N
rows, repeated)."""


def read(run):
    ms = run.kernel_ms.get("stream_erow_update")
    if not ms:
        return None
    return 100.0 * run.bound_s("erow") * 1e3 / (ms / run.N)
