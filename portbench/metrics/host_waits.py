"""``host_waits``: the port's blocking device-to-host reads a search
(``last_stats["host_waits"]``, which ``utils/trace`` counts on every search:
the hit counts, the step's totals, the rows' copies), the median over the
traced searches; None where no search reported it."""

import statistics


def read(trace):
    vals = [s["host_waits"] for s in trace.stats if "host_waits" in s]
    return statistics.median(vals) if vals else None
