"""``decode_ms``: rows to matches on the host (``ops.emit.decode_matches``),
``last_stats["decode_ms"]`` under ``FAC_TIME=1``, the median over the
traced searches (rounded to 0.1 ms where the port records it)."""

import statistics


def read(trace):
    vals = [s["decode_ms"] for s in trace.stats if "decode_ms" in s]
    return statistics.median(vals) if vals else None
