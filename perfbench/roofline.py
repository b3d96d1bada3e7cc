"""The yardstick's peaks and byte counts.

A kernel's roofline share is the least time the card could take for the
work, over the time the kernel took: here bytes over the card's peak
bandwidth, since the replay's kernels do integer work on data they read
once. Bytes are counted from shapes, whatever implements the kernel:
each input byte read once and each output byte written once.
"""
from __future__ import annotations

#: NVIDIA H100 SXM5 80 GB: HBM3 bandwidth, bytes/s (NVIDIA's data sheet)
PEAK_BYTES_PER_S = 3.35e12


def state_bytes_per_workflow(layout) -> int:
    """Bytes of one workflow's final replay state at `layout` (kernel A's
    output), from the reference state's shapes."""
    from .reference.state import init_state, leaves

    s = init_state(1, layout, "meta")
    return sum(t.numel() * t.element_size() for _, t in leaves(s))


def request_bytes(input_bytes: int, workflows: int, layout) -> int:
    """Kernel A's bytes for one request: its inputs as handed to the port
    (wire32: 80 B a real event; wirec: the slab, bases and counts as
    packed), read once, and the final state of `workflows`, written once."""
    return input_bytes + workflows * state_bytes_per_workflow(layout)


def roofline_pct(bytes_moved: float, seconds: float):
    """100 x (bytes / peak bandwidth) / seconds; None without device time."""
    if seconds <= 0 or bytes_moved <= 0:
        return None
    return 100.0 * (bytes_moved / PEAK_BYTES_PER_S) / seconds
