"""Device ms per traced control step of everything launched inside the
rollout span (the env's `fused_rollout_costs_tak`)."""


def read(run):
    t = run.trace
    if t is None or not t.steps:
        return None
    return sum(d for _n, _s, d, _l in t.ops_in("bench.rollout")) / 1e3 / t.steps
