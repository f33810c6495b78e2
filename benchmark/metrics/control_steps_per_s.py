"""Control steps completed in the window over the window's seconds, all
steps of all trials (host clock)."""

from benchmark.stats import rate


def read(run):
    return rate(run.window.steps, run.window.seconds)
