"""Host ms per traced control step inside the program's `mpopis.sync.*`
spans: the time the host waited for the device at its deliberate reads."""

from benchmark import program_spans as ps


def read(run):
    t = run.trace
    if not ps.has_spans(t):
        return None
    syncs = ps.pairs(t, lambda name: name.startswith(ps.SYNC))
    return sum(b - a for a, b in syncs) / 1e3 / t.steps
