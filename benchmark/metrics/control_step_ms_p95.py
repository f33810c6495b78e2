"""The 95th percentile of the window's control-step times: each from handing
the state to `pol.step` to the action and reward on the host (host clock)."""

from benchmark.stats import percentile


def read(run):
    return percentile(run.window.step_ms, 95.0) if run.window.step_ms else None
