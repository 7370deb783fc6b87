"""mapprep.validate.idle_ms: device-idle ms inside the program's
mapprep.validate spans (the rectangle fit, the refiner and the NFA
test) within its online.set_map spans, less the regrowths inside them
(mapprep.grow, read by mapprep.grow.idle_ms), per map switch of the
traced slice."""

from harness.program import stage_idle_ms


def read(t):
    return stage_idle_ms(t, ("mapprep.validate",), "online.set_map",
                         minus=("mapprep.grow",))
