"""The share (%) of the window's wall outside the ensemble's chunk loop
(``ChainEnsemble._run_chunk``): construction, MAP and convergence checks,
checkpoints, finalisation and whatever a fit does around them; from the
benchmark's host-clock spans."""


def read(run):
    loop = run.spans.get("loop") or []
    if not loop or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - sum(loop) / run.window_s)
