"""The end-to-end arithmetic on synthetic timings: a rate is all the work
over all the window, a tail is the tail of every request (a stall and a
failure included)."""

import math
import statistics

import numpy as np
import pytest

from perfbench import core


def test_percentile_matches_numpy():
    rng = np.random.default_rng(0)
    v = rng.exponential(10.0, 1001).tolist()
    for q in (50, 90, 95, 99):
        assert core.percentile(v, q) == pytest.approx(np.percentile(v, q))


def test_p95_sees_a_stall():
    # 1,000 requests at 10 ms, a stall holds 60 of them for 500 ms more
    lat = [10.0] * 940 + [510.0] * 60
    assert core.latency_p95(lat, 0) == pytest.approx(510.0)
    # the same stall on 40: under the tail
    lat = [10.0] * 960 + [510.0] * 40
    assert core.latency_p95(lat, 0) == pytest.approx(10.0)


def test_a_failed_request_misses_every_limit():
    lat = [10.0] * 94
    assert core.latency_p95(lat, 0) == pytest.approx(10.0)
    assert core.latency_p95(lat, 4) == pytest.approx(10.0)
    assert math.isinf(core.latency_p95(lat, 6))  # 6 of 100 failed


def test_rate_is_work_over_the_whole_window():
    # 100 steps of 0.1 s and one stall of 5 s: the rate carries the stall
    steps = [0.1] * 100 + [5.0]
    assert core.rate(100, sum(steps)) == pytest.approx(100 / 15.0)
    # a median of chunk rates would not
    chunks = [10 / sum(steps[i:i + 10]) for i in range(0, 100, 10)]
    assert statistics.median(chunks) == pytest.approx(10.0)
    with pytest.raises(ValueError):
        core.rate(1, 0.0)


def test_spread_is_quartiles_over_median():
    v = [100, 101, 102, 103, 104, 105]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert core.spread(v) == pytest.approx((q3 - q1) / q2)
