"""Device ms per traced control step of the operations launched inside the
program's `mpopis.env_step` spans outside `mpopis.policy_step`: the plant's
step and its reward (`step_reward`; on the contact tasks the step entry of
their kernel), not the steps of a plain rollout inside the policy."""

from benchmark import program_spans as ps


def read(run):
    t = run.trace
    if not ps.has_spans(t):
        return None
    return ps.device_ms(ps.ops_in(t, "mpopis.env_step", "mpopis.policy_step")) / t.steps
