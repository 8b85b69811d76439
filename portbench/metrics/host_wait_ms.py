"""``host_wait_ms``: host time a search spends blocked in the port's own
device-to-host reads, the sum of its ``host_wait`` spans of ``utils/trace``
(``last_stats["host_wait_us"]`` under ``FAC_TIME=1``; the tracing's own
``timing_sync`` is not one of them), in ms, the median over the traced
searches; None where no search reported it."""

import statistics


def read(trace):
    vals = [s["host_wait_us"] / 1e3 for s in trace.stats if "host_wait_us" in s]
    return statistics.median(vals) if vals else None
