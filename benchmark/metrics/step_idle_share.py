"""The share (%) of the profiled stretch's wall in which the device idled
while a step of the program was open on the host: ``chains.step`` or a
``step.*`` span innermost (benchmark/attribution.py ``step_idle_share``,
over the program's spans in the stretch's trace); nothing where the
stretch holds no step span or no device operation."""

from benchmark import attribution as A


def read(run):
    if not run.events or not run.stretch:
        return None
    if not any(e.get("cat") == "user_annotation" and A.in_step(e.get("name"))
               for e in run.events):
        return None
    return A.step_idle_share(run.events, run.stretch["window_s"])
