"""The host's time in the port's entry a request: the harness's own span
from the call into the port to its return, before the read-back, summed
over every request of the untraced window (profiler off) and divided by
their count."""


def read(reading):
    w = reading.window
    return w.dispatch_s * 1e3 / w.requests if w.requests else None
