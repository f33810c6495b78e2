"""Device operations (kernels, copies, sets) launched inside the control-step
span, per traced control step."""


def read(run):
    t = run.trace
    if t is None or not t.steps:
        return None
    return len(t.ops_in("bench.control_step")) / t.steps
