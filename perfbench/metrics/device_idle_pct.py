"""The share of the traced window in which no kernel, fill or copy ran on
the card, from the profiler's timeline."""


def read(reading):
    t = reading.trace
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
