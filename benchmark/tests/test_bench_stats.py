"""The end-to-end arithmetic: the rate and the 95th percentile over
synthetic step times with one stall."""

import numpy as np
import pytest

from benchmark.stats import percentile, rate


def test_rate_counts_every_step_over_the_whole_window():
    assert rate(1650, 30.25) == pytest.approx(54.545454545)
    with pytest.raises(ValueError):
        rate(3, 0.0)


def test_p95_over_steps_with_one_stall():
    steps = [18.0] * 190 + [19.0] * 9 + [400.0]  # one 400 ms stall in 200 steps
    p95 = percentile(steps, 95.0)
    assert p95 == pytest.approx(float(np.percentile(steps, 95.0)))
    assert 18.0 <= p95 <= 19.0  # one stall in 200 is beyond the 95th percentile
    many = [18.0] * 180 + [400.0] * 20  # a stall in every tenth step
    assert percentile(many, 95.0) == 400.0
    # the rate still pays for the stall
    assert rate(len(steps), sum(steps) / 1e3) < rate(200, 200 * 18.0 / 1e3)


@pytest.mark.parametrize("q", [0.0, 5.0, 50.0, 95.0, 100.0])
def test_percentile_matches_numpy(q):
    xs = np.random.default_rng(1).gamma(2.0, 3.0, size=137)
    assert percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))
