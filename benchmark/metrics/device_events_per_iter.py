"""Device operations (kernels, copies, sets) a step, in the profiled
stretch of the window."""


def read(run):
    st = run.stretch
    if not st or not st["steps"] or not st["n_device_ops"]:
        return None
    return st["n_device_ops"] / st["steps"]
