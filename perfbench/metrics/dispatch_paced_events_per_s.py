"""The rate of the untraced window where the host's dispatch paces it:
the real events of every request read back in the window, over the
window's length, as `verify_events_per_s` counts them. Listed per layer
for the cells in which the host's speed, which swings between runs on a
shared host, sets the rate; no bound holds it there."""


def read(reading):
    w = reading.window
    return w.events / w.seconds if w.seconds else None
