"""AIS iterations per control step over the window: the policy step's own
counter, `info["ais_its"]`, summed and divided by the steps."""


def read(run):
    w = run.window
    return sum(w.ais_its) / w.steps if w.steps else None
