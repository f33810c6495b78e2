"""The share of the traced window in which no device operation runs, the
window from the first traced control step's start to the last one's end."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
