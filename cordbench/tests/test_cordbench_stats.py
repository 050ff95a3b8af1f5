"""Window arithmetic on hand-worked cases."""

import pytest

from cordbench import stats


def test_percentile_interpolates_between_ranks():
    xs = [5.0, 1.0, 4.0, 2.0, 3.0]
    assert stats.percentile(xs, 50) == 3.0
    assert stats.percentile(xs, 95) == pytest.approx(4.8)
    assert stats.percentile(xs, 0) == 1.0 and stats.percentile(xs, 100) == 5
    assert stats.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_rate_is_over_the_whole_window():
    # 3 waves of 100 tokens, returning at 2, 5 and 9 s: 300 tokens / 9 s
    assert stats.rate(300, 9.0) == pytest.approx(33.333333)


def test_ttft_counts_the_queue_from_the_wave_submit():
    assert stats.ttft_ms(10.0, 10.25) == pytest.approx(250.0)


def test_tpot_from_token_stamps():
    assert stats.tpot_ms([1.0, 1.05, 1.10, 1.40]) == pytest.approx(400 / 3)
    assert stats.tpot_ms([2.0]) is None
