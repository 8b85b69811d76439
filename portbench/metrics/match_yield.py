"""``match_yield``: useful outcomes of the hit list and the step: the
matches over the candidates the step verified (``last_stats``), summed over
the traced searches."""


def read(trace):
    cand = sum(s.get("candidates", 0) for s in trace.stats)
    if not cand:
        return None
    return 100.0 * sum(s.get("matches", 0) for s in trace.stats) / cand
