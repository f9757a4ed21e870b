"""The benchmark's arithmetic: the window's statistics over all frames,
the spread of repeated runs, and the union of device intervals."""
from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100) of all values:
    the smallest value with at least q% of the values at or below it."""
    vals = sorted(values)
    if not vals:
        raise ValueError("percentile of no values")
    k = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[k - 1]


def window_ms(seconds: float, frames: int) -> float:
    """Milliseconds a frame over the whole window."""
    if frames <= 0:
        raise ValueError("a window with no frames")
    return seconds * 1e3 / frames


def spread(values) -> float:
    """(third quartile - first quartile) / median, the quartiles as
    statistics.quantiles(values, n=4) gives them."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def interval_union(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        total += max(0.0, b - max(a, end))
        end = max(end, b)
    return total


def gaps(intervals, lo: float, hi: float):
    """The idle (start, end) gaps of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in sorted(intervals):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]
