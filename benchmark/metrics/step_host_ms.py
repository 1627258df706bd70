"""The median host-clock milliseconds of the program's ``chains.step``
spans over the window, those that overlap the profiled stretch left out
(benchmark/attribution.py ``step_host_ms``); nothing where the program
spanned no chain step (a single chain's ``run_chunk`` has none)."""

from benchmark import attribution as A


def read(run):
    return A.step_host_ms(run.program_spans, run.stretch_ns)
