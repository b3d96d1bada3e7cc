"""Kernel A's share of its roofline: the least time its bytes need at the
card's peak bandwidth (roofline.py; each request's inputs as handed to the
port, read once, and its final state, written once, counted from shapes)
over the device time of the kernels named `replay_kernel` in the traced
window."""
from perfbench.roofline import roofline_pct

KERNEL = r"\breplay_kernel\b"


def read(reading):
    if reading.trace is None:
        return None
    return roofline_pct(reading.traced.bytes, reading.trace.kernel_seconds(KERNEL))
