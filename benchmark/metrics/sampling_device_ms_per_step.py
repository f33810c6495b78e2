"""Device ms per traced control step of the operations launched inside the
program's `mpopis.sample` spans: each AIS iteration's normals and the
candidates' noise `chol @ z` (`policies/driver.py`)."""

from benchmark import program_spans as ps


def read(run):
    t = run.trace
    if not ps.has_spans(t):
        return None
    return ps.device_ms(ps.ops_in(t, "mpopis.sample")) / t.steps
