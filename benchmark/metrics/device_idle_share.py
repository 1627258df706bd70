"""The share (%) of the profiled stretch's wall in which no operation ran
on the device: 1 - (the union of its operations' intervals) / the
stretch's host-clock length."""


def read(run):
    st = run.stretch
    if not st or st["window_s"] <= 0 or not st["n_device_ops"]:
        return None
    return 100.0 * (1.0 - st["busy_s"] / st["window_s"])
