"""Host ms per traced control step inside the program's `mpopis.rollout`
spans and outside their `mpopis.rollout.launch` spans: what issuing the
rollouts costs the host (the clamp, the layout, the wrapper's checks and
look-ups, the allocation, the gather and the gamma term), the kernel's
launch call itself left out."""

from benchmark import program_spans as ps


def read(run):
    t = run.trace
    if not ps.has_spans(t):
        return None
    rollout = ps.pairs(t, "mpopis.rollout")
    whole = sum(b - a for a, b in rollout)
    return (whole - ps.overlap_us(rollout, ps.pairs(t, "mpopis.rollout.launch"))) / 1e3 / t.steps
