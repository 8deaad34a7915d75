"""End-to-end readings of a window's timeline (host clock, seconds).

Both are taken over every batch of the window and all of its time, never as
medians of chunks of it, so that a stall anywhere shows.
"""

from __future__ import annotations

import math
from typing import Sequence


def qps(t0: float, done: Sequence[float], sizes: Sequence[int]) -> float:
    """Queries completed over the seconds from the window's start to the
    last completion."""
    if not done:
        return 0.0
    return float(sum(sizes)) / (max(done) - t0)


def percentile(values: Sequence[float], p: float) -> float:
    """The nearest-rank p-th percentile: the smallest value that at least p%
    of the values do not exceed."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(p / 100.0 * len(ordered)) - 1)]


def p95_ms(pulled: Sequence[float], done: Sequence[float]) -> float:
    """95th percentile of batch latency (pulled by the stream -> yielded), ms."""
    return 1e3 * percentile([b - a for a, b in zip(pulled, done)], 95.0)
