"""The program's deliberate host syncs per traced control step: its
`mpopis.sync.*` spans (each a host read of a device value, named for what it
reads; the CE stop flag once an AIS iteration) inside the traced steps."""

from benchmark import program_spans as ps


def read(run):
    t = run.trace
    if not ps.has_spans(t):
        return None
    return len(ps.pairs(t, lambda name: name.startswith(ps.SYNC))) / t.steps
