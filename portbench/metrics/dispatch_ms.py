"""``dispatch_ms``: the lane's device stage (``many.many_pipeline`` or the
DP slices' hit lists and steps), ``last_stats["dispatch_ms"]`` under
``FAC_TIME=1`` (host clock to a synchronise), the median over the traced
searches."""

import statistics


def read(trace):
    vals = [s["dispatch_ms"] for s in trace.stats if "dispatch_ms" in s]
    return statistics.median(vals) if vals else None
