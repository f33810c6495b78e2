"""The program's own spans in a traced run: the `mpopis.*` ranges that the
port opens at its layer boundaries (`mpopis_tpu_torch.utils.span`), read
from the host events of `trace.Trace`.

They are the profiler's `user_annotation` events, as the benchmark's
`bench.*` spans are, so they share the device trace's clock: a device
operation belongs to a program span whose host interval holds the runtime
call that launched it (`Trace.ops_in`'s rule), and an idle gap of the
device is set against a span's interval directly. Only spans that start
inside a traced control step (`bench.control_step`) count. A program that
opens none (an earlier commit) gives no program spans, and the metrics that
read them are silent.
"""

from __future__ import annotations

from benchmark.trace import Intervals

PREFIX = "mpopis."
SYNC = "mpopis.sync."


def has_spans(trace) -> bool:
    """Whether the traced window holds any program span."""
    return trace is not None and trace.steps > 0 and any(
        name.startswith(PREFIX) for name, _s, _d in trace.host)


def pairs(trace, match) -> list:
    """Sorted (start_us, end_us) of the program spans whose name `match`
    accepts (a name, or a callable on the name), inside a control step."""
    accept = match if callable(match) else match.__eq__
    control = trace.spans["bench.control_step"]
    return sorted((s, s + d) for name, s, d in trace.host
                  if name.startswith(PREFIX) and accept(name) and control.holds(s))


def intervals(trace, match) -> Intervals:
    return Intervals(pairs(trace, match))


def ops_in(trace, name: str, outside: str | None = None) -> list:
    """The device operations launched inside the program span `name` (and
    not inside the program span `outside`)."""
    inside = intervals(trace, name)
    skip = intervals(trace, outside) if outside else None
    return [op for op in trace.device_ops if op[3] is not None and inside.holds(op[3])
            and not (skip is not None and skip.holds(op[3]))]


def device_ms(ops) -> float:
    return sum(d for _n, _s, d, _l in ops) / 1e3


def overlap_us(a: list, b: list) -> float:
    """The time two sorted lists of disjoint intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_intervals(trace) -> list:
    """The gaps between the device's merged busy intervals, inside the
    traced window (`Trace.busy_intervals`' complement)."""
    w0, w1 = trace.window
    edges = [w0] + [x for iv in trace.busy_intervals() for x in iv] + [w1]
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
