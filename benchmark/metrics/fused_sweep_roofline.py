"""The fused sweep (``ops/fused_sweeps.py`` -> csrc/fused_sweeps.cu, the
cluster and the grid forms): the bound of its call (benchmark/workcount.py
``sweep``: the hyper-update, the 2N column updates and with rank learning
the inclusion updates of every chain) over the CUDA-event time of the call
captured in the window, repeated, in %."""


def read(run):
    ms = run.kernel_ms.get("fused_gibbs_sweeps")
    if not ms:
        return None
    return 100.0 * run.bound_s("sweep") * 1e3 / ms
