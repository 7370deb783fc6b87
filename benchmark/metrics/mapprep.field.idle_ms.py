"""mapprep.field.idle_ms: device-idle ms inside the program's
mapprep.field spans (the distance field's waves, one host read each)
within its online.set_map spans, per map switch of the traced slice."""

from harness.program import stage_idle_ms


def read(t):
    return stage_idle_ms(t, ("mapprep.field",), "online.set_map")
