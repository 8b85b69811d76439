"""The window's arithmetic, kept apart so that tests can hold it on
hand-made numbers."""

from __future__ import annotations

import statistics


def rate_mbps(bytes_per_search: int, searches: int, window_s: float) -> float:
    """Corpus bytes of every completed search over the whole window's wall
    time (first start to last end), in 10^6 bytes a second."""
    return bytes_per_search * searches / window_s / 1e6


def p95_ms(latencies_s) -> float:
    """The 95th percentile of every search's latency, in ms
    (``statistics.quantiles``, inclusive method)."""
    lat = sorted(latencies_s)
    if len(lat) == 1:
        return lat[0] * 1e3
    return statistics.quantiles(lat, n=100, method="inclusive")[94] * 1e3


def union_s(intervals, lo: float, hi: float) -> float:
    """Length of the union of [start, end) ``intervals`` clipped to [lo, hi)."""
    total, cur_lo, cur_hi = 0.0, None, None
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if cur_hi is None or a > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = a, b
        else:
            cur_hi = max(cur_hi, b)
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return total


def gaps(intervals, lo: float, hi: float):
    """The [start, end) stretches of [lo, hi) that no interval covers."""
    out, at = [], lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out
