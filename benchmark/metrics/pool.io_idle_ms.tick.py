"""pool.io_idle_ms.tick: device-idle ms inside the program's pool.pack
(the host buffer and its copy to the device) and pool.readback (the
outputs' one read) spans, per pool.step of the traced slice."""

from harness.program import stage_idle_ms


def read(t):
    return stage_idle_ms(t, ("pool.pack", "pool.readback"), "pool.step")
