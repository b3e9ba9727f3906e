"""The percentile is taken over every frame at once."""

import numpy as np
import pytest

from bmk import stats


def test_percentile_over_all_frames():
    rng = np.random.default_rng(0)
    xs = rng.lognormal(5, 0.5, 997).tolist()
    for q in (50, 95):
        assert stats.percentile(xs, q) == pytest.approx(
            np.percentile(xs, q), rel=1e-12)


def test_not_a_median_of_chunks():
    # ten chunks of 20 frames: five with two slow frames, five with none;
    # the chunks' p95s are 1000 or 10 (median 505), all frames' p95 is 59.5
    xs = ([10.0] * 18 + [1000.0] * 2 + [10.0] * 20) * 5
    chunks = [stats.percentile(xs[i:i + 20], 95) for i in range(0, 200, 20)]
    assert np.median(chunks) == pytest.approx(505.0)
    assert stats.percentile(xs, 95) == pytest.approx(59.5)


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == (4.5 - 1.5) / 3.0
