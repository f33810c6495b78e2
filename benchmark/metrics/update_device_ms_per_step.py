"""Device ms per traced control step of the operations launched inside the
policy step's span and outside the rollout span: the sampling, the CE
update, the weights and the plan."""


def read(run):
    t = run.trace
    if t is None or not t.steps:
        return None
    return sum(d for _n, _s, d, _l in t.ops_in("bench.policy_step", "bench.rollout")) / 1e3 / t.steps
