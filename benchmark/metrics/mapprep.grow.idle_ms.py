"""mapprep.grow.idle_ms: device-idle ms inside the program's
mapprep.grow spans (region growth, one launch and one host read a
growth call; the refiner's regrowths included) within its
online.set_map spans, per map switch of the traced slice."""

from harness.program import stage_idle_ms


def read(t):
    return stage_idle_ms(t, ("mapprep.grow",), "online.set_map")
