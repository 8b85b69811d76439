"""``prepare_ms``: host time from a search's entry (``DeviceEngine.search_raw``)
to its first launch, the span ``prepare`` of ``utils/trace``
(``last_stats["prepare_us"]`` under ``FAC_TIME=1``), in ms, the median over
the traced searches; None where no search reported it."""

import statistics


def read(trace):
    vals = [s["prepare_us"] / 1e3 for s in trace.stats if "prepare_us" in s]
    return statistics.median(vals) if vals else None
