"""Trial statistics: order-statistic CI for the median and the reference's
AVE/STD/MED/L95/U95/MIN/MAX summary rows.

A copy of `mpopis_tpu/harness/stats.py`, which has no jax in it but cannot
be imported without jax (its package's `__init__` imports the JAX models).
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np

_STD_NORMAL = NormalDist()


def quantile_ci(x, p: float = 0.05, q: float = 0.5):
    """Nonparametric CI for the q-quantile via z-based rank bounds.

    Returns (lower, point, upper) with the reference's 1-based rank
    arithmetic.
    """
    x = np.asarray(x, dtype=float)
    n = len(x)
    zm = _STD_NORMAL.inv_cdf(p / 2.0)
    zp = _STD_NORMAL.inv_cdf(1.0 - p / 2.0)
    spread = math.sqrt(n * q * (1.0 - q))
    j = max(int(math.ceil(n * q + zm * spread)), 1)
    k = min(int(math.ceil(n * q + zp * spread)), n)
    xs = np.sort(x)
    return xs[j - 1], float(np.quantile(x, q)), xs[k - 1]


def std(x) -> float:
    """Sample standard deviation (n-1), matching Julia's std."""
    x = np.asarray(x, dtype=float)
    if len(x) < 2:
        return float("nan")
    return float(np.std(x, ddof=1))


SUMMARY_ROWS = ("AVE", "STD", "MED", "L95", "U95", "MIN", "MAX")


def summary_value(row: str, x) -> float:
    x = np.asarray(x, dtype=float)
    if row == "AVE":
        return float(np.mean(x))
    if row == "STD":
        return std(x)
    if row == "MED":
        return quantile_ci(x)[1]
    if row == "L95":
        return quantile_ci(x)[0]
    if row == "U95":
        return quantile_ci(x)[2]
    if row == "MIN":
        return float(np.min(x))
    if row == "MAX":
        return float(np.max(x))
    raise ValueError(row)
