"""Device ms per traced control step of the operations launched inside the
program's `mpopis.update` spans: the AIS strategy's refit each iteration
(for CE the sort, the elite mask, the covariance and its Cholesky)."""

from benchmark import program_spans as ps


def read(run):
    t = run.trace
    if not ps.has_spans(t):
        return None
    return ps.device_ms(ps.ops_in(t, "mpopis.update")) / t.steps
