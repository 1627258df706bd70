"""The step's share (%) of the card's peak: the least time of every step
the window ran (benchmark/workcount.py: the larger of its bytes over HBM
bandwidth and its float32 operations over the peak, counted from the
algorithm at the cell's shape and the step's chains), over the window's
wall seconds."""


def read(run):
    if not run.steps or run.window_s <= 0:
        return None
    bound = {C: run.step_bound_s(C) for C in set(run.steps)}
    return 100.0 * sum(bound[C] for C in run.steps) / run.window_s
