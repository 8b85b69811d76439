"""``launches_per_search``: the port's launch counters
(``ops.packed_bitap.LAUNCHES``, every kernel family) summed over the traced
searches, over their count."""


def read(trace):
    if not trace.searches:
        return None
    return sum(trace.launches.values()) / trace.searches
