"""Device-idle ms per traced control step inside the program's
`mpopis.policy_step` spans: the gaps between the device's merged busy
intervals, inside the traced window, that overlap the policy step."""

from benchmark import program_spans as ps


def read(run):
    t = run.trace
    if not ps.has_spans(t):
        return None
    return ps.overlap_us(ps.idle_intervals(t), ps.pairs(t, "mpopis.policy_step")) / 1e3 / t.steps
