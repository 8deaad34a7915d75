"""qps and p95_batch_ms over a timeline with a stall: taken over every batch
and all the time, not as medians of chunks (CPU)."""

import statistics

import pytest

from benchport import timeline


def _timeline(stall_at=None, stall_s=0.0, n=400, period=0.05, depth=3):
    """Closed loop, `depth` batches in flight: batch i is pulled when batch
    i - depth completes and completes one period after batch i - 1 (or
    after a stall)."""
    pulled, done = [], []
    t = 0.0
    for i in range(n):
        pulled.append(done[i - depth] if i >= depth else 0.0)
        t += period + (stall_s if i == stall_at else 0.0)
        done.append(t)
    return pulled, done


def test_qps_is_all_work_over_all_time():
    pulled, done = _timeline()
    assert timeline.qps(0.0, done, [4096] * len(done)) == pytest.approx(4096 / 0.05)


def test_a_stall_shows_where_a_median_of_windows_hides_it():
    pulled, done = _timeline(stall_at=200, stall_s=4.0)
    q = timeline.qps(0.0, done, [4096] * len(done))
    assert q == pytest.approx(400 * 4096 / (400 * 0.05 + 4.0))
    # The median of 1-s windows of completions reads as if nothing stalled.
    windows = [sum(1 for t in done if w <= t < w + 1.0) * 4096 for w in range(int(done[-1]))]
    assert statistics.median(windows) == pytest.approx(4096 / 0.05)
    assert q < 0.85 * statistics.median(windows)


def test_p95_counts_every_batch():
    pulled, done = _timeline()
    assert timeline.p95_ms(pulled, done) == pytest.approx(150.0)
    # A 2-s stall at batch 30 of 40 delays the 3 batches in flight (7.5%).
    assert timeline.p95_ms(*_timeline(stall_at=30, stall_s=2.0, n=40)) > 2000.0


def test_percentile_is_nearest_rank():
    assert timeline.percentile([5, 1, 4, 2, 3], 95) == 5
    assert timeline.percentile(list(range(1, 101)), 95) == 95
    assert timeline.percentile([7], 95) == 7
