"""``device_idle``: the share of the traced window in which no kernel,
copy or memset ran on the card (1 minus the union of their intervals)."""


def read(trace):
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
