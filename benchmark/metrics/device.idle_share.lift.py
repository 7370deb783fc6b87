"""device.idle_share.lift: the share of serving time in the traced slice
with nothing running on the device; serving time is the union of the
cell's entry spans (the pool's submit and step, and the lift's rides
between ticks), so time spent waiting for the next request does not
count."""

from harness.trace import idle_share


def read(t):
    return idle_share(t)
