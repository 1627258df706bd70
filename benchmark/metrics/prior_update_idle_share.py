"""The share (%) of the profiled stretch's wall in which the device idled
while the program's ``step.prior_update`` span was innermost on the host
(benchmark/attribution.py ``prior_update_idle_share``); nothing where no
step of the stretch spans its prior update, or no device operation ran."""

from benchmark import attribution as A


def read(run):
    if not run.events or not run.stretch:
        return None
    return A.prior_update_idle_share(run.events, run.stretch["window_s"])
