"""The arithmetic of the end-to-end metrics."""

from __future__ import annotations

import math


def rate(count: int, seconds: float) -> float:
    """Work completed over the seconds it took."""
    if seconds <= 0.0:
        raise ValueError(f"a window of {seconds} s")
    return count / seconds


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100), interpolated linearly between the two
    nearest ranks, as numpy's default."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
