"""The window's arithmetic: rates over all the work and all the time,
percentiles over all steps, and the union of device intervals."""
from __future__ import annotations

import math

__all__ = ["rate", "percentile", "union_length", "gaps"]


def rate(units: float, seconds: float) -> float:
    """Work over the window's whole wall time."""
    if seconds <= 0:
        raise ValueError("a window of no time")
    return units / seconds


def percentile(values: list, q: float) -> float:
    """The ``q``-th percentile (0-100) of all ``values``, linear between
    order statistics (numpy's default)."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_length(intervals: list) -> float:
    """Length of the union of ``(start, end)`` intervals: overlapping
    intervals count once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: list, start: float, end: float) -> list:
    """``(start, end)`` of each stretch of [start, end] that no interval
    covers."""
    out, cur = [], start
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, end)))
        cur = max(cur, e)
        if cur >= end:
            break
    if cur < end:
        out.append((cur, end))
    return [(a, b) for a, b in out if b > a]

