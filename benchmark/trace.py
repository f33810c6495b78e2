"""The traced run's device trace: the benchmark's own spans and the device
operations, read from torch.profiler's chrome trace.

Spans (`record_function` ranges, opened by the benchmark around its calls
into the program): `bench.control_step` around each control step,
`bench.policy_step` around `pol.step`, `bench.rollout` around the env's
`fused_rollout_costs_tak`. A device operation (kernel, copy or set) belongs
to the innermost span whose host interval holds the runtime call that
launched it, matched by the trace's correlation id.
"""

from __future__ import annotations

import bisect
import gzip
import json
import os
import tempfile
from collections import defaultdict
from pathlib import Path

SPANS = ("bench.control_step", "bench.policy_step", "bench.rollout")
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver", "user_annotation"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}


class Intervals:
    """Sorted, disjoint host intervals of one span name."""

    def __init__(self, pairs):
        pairs = sorted(pairs)
        self.starts = [a for a, _ in pairs]
        self.ends = [b for _, b in pairs]

    def __len__(self):
        return len(self.starts)

    def holds(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.ends[i]


class Trace:
    """What the per-layer metrics read from one traced window."""

    def __init__(self, events: list):
        spans = defaultdict(list)
        launches = {}
        self.device_ops = []  # (name, start_us, dur_us, launch_ts_us or None)
        self.host = []  # (name, start_us, dur_us) of host events, for the idle gaps
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            if cat == "user_annotation" and ev.get("name") in SPANS:
                spans[ev["name"]].append((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])))
            if cat in LAUNCH_CATS and "correlation" in ev.get("args", {}):
                launches[ev["args"]["correlation"]] = float(ev["ts"])
            if cat in HOST_CATS:
                self.host.append((ev["name"], float(ev["ts"]), float(ev["dur"])))
        for ev in events:
            if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS:
                corr = ev.get("args", {}).get("correlation")
                self.device_ops.append((ev["name"], float(ev["ts"]), float(ev["dur"]),
                                        launches.get(corr)))
        self.spans = {name: Intervals(spans[name]) for name in SPANS}
        control = self.spans["bench.control_step"]
        self.steps = len(control)
        self.window = (control.starts[0], control.ends[-1]) if self.steps else (0.0, 0.0)
        self.unmatched = sum(1 for op in self.device_ops if op[3] is None)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def ops_in(self, span: str, outside: str | None = None):
        """The device operations launched inside `span` (and not inside
        `outside`)."""
        inside, skip = self.spans[span], self.spans[outside] if outside else None
        return [op for op in self.device_ops if op[3] is not None and inside.holds(op[3])
                and not (skip is not None and skip.holds(op[3]))]

    def busy_intervals(self):
        """The merged intervals in which some device operation ran, clipped
        to the traced window."""
        w0, w1 = self.window
        ivs = sorted((max(s, w0), min(s + d, w1)) for _, s, d, _ in self.device_ops
                     if s + d > w0 and s < w1)
        merged = []
        for a, b in ivs:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps summed by what the host was doing (the shortest host event that
        spans the gap's middle)."""
        by_op = defaultdict(float)
        for name, _s, d, _l in self.device_ops:
            by_op[name] += d / 1e6
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        longest = max((h[2] for h in host), default=0.0)
        gaps = defaultdict(float)
        busy = self.busy_intervals()
        edges = [self.window[0]] + [x for iv in busy for x in iv] + [self.window[1]]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            lo = bisect.bisect_left(starts, mid - longest)
            hi = bisect.bisect_right(starts, mid)
            holding = [h for h in host[lo:hi] if h[1] <= mid <= h[1] + h[2]]
            label = min(holding, key=lambda h: h[2])[0] if holding else "host outside any op"
            gaps[label] += (b - a) / 1e6
        order = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        gap_order = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in order],
                "idle_gaps": [[k, v] for k, v in gap_order]}


def read_profile(prof, keep: Path | None = None, keep_steps: int = 3) -> Trace:
    """Export the profiler's chrome trace into TMPDIR, read it and delete
    it; where `keep` is given, write there (gzip) the events of the first
    `keep_steps` traced control steps, a few MB at most."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    trace = Trace(events)
    if keep is not None and trace.steps:
        control = trace.spans["bench.control_step"]
        t0, t1 = control.starts[0], control.ends[min(keep_steps, trace.steps) - 1]
        small = [ev for ev in events if ev.get("ph") != "X"
                 or t0 <= float(ev.get("ts", 0.0)) <= t1]
        keep.parent.mkdir(parents=True, exist_ok=True)
        with gzip.open(keep, "wt") as f:
            json.dump({"traceEvents": small}, f)
    return trace
