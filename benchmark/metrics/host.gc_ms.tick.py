"""host.gc_ms.tick: device-idle ms inside Python's garbage-collection
pauses (the program's host.gc spans) within its pool.step spans, per
tick of the traced slice; 0 where no collection fell in a tick."""

from harness.program import stage_idle_ms


def read(t):
    return stage_idle_ms(t, ("host.gc",), "pool.step")
