"""Device operations a request: every kernel, fill and copy the card ran
in the traced window (the port's kernels, PyTorch's fills of the fresh
state, the read-back of the CRCs and error flags), over the requests of
that window."""


def read(reading):
    if reading.trace is None or not reading.traced.requests or not reading.trace.device:
        return None
    return len(reading.trace.device) / reading.traced.requests
