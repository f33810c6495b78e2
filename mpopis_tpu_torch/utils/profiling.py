"""Phase timers and a profiler trace.

Counterpart of `mpopis_tpu/utils/profiling.py`: per-phase host wall-clock
timers, a `torch.profiler` trace (CPU and, where there is a card, CUDA
activity) written as a chrome trace, and the steady-state seconds a call of
a function takes.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class PhaseTimer:
    """Accumulates wall-clock per named phase.

    CUDA launches are asynchronous, so the caller synchronises on the
    phase's device results INSIDE the with-block for the timing to mean
    anything:

        timer = PhaseTimer()
        with timer.phase("rollout"):
            costs = rollout(...)
            torch.cuda.synchronize()
        print(timer.report())
    """

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        total = sum(self.totals.values())
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"{name:<24s} {t * 1e3:9.2f} ms total | {t / max(n, 1) * 1e3:8.3f} ms/call"
                f" | {n:5d} calls | {100 * t / max(total, 1e-12):5.1f}%"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str = "mpopis_trace"):
    """Profile the block with torch.profiler (CPU activity, and CUDA activity
    where a card is present) and write `<log_dir>/trace.json`, a chrome
    trace (chrome://tracing, Perfetto). Yields the directory."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync(out) -> None:
    """Wait for the card where the output (a tensor, or a tuple, list or
    dict holding tensors) lies on a CUDA device."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, (tuple, list)):
        for o in out:
            _sync(o)
    elif isinstance(out, dict):
        for o in out.values():
            _sync(o)


def timed(fn, *args, iters: int = 10, warmup: int = 2):
    """Steady-state seconds a call of `fn(*args)` takes, on the host clock,
    synchronising with the card before each clock read where the output lies
    on a CUDA device."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) / iters
