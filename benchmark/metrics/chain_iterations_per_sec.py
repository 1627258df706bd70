"""Chain-iterations per second: every chain-iteration the window's fits
ran, over the window's wall seconds (host clock, from the first fit's start
to the last one's end)."""


def read(run):
    return run.chain_iters / run.window_s if run.window_s > 0 else None
