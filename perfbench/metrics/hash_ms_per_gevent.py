"""Kernels B and C (`payload_kernel`, `crc32_kernel`): their device time in
the traced window, in ms, per 1e9 events replayed in that window."""

KERNELS = r"\b(payload_kernel|crc32_kernel)\b"


def read(reading):
    if reading.trace is None or not reading.traced.events:
        return None
    seconds = reading.trace.kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    return seconds * 1e3 / (reading.traced.events / 1e9)
