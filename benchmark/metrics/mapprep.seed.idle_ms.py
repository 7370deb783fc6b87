"""mapprep.seed.idle_ms: device-idle ms inside the program's
mapprep.seed spans (the seed walk's argmax and its host read, one a
seed) within its online.set_map spans, per map switch of the traced
slice."""

from harness.program import stage_idle_ms


def read(t):
    return stage_idle_ms(t, ("mapprep.seed",), "online.set_map")
