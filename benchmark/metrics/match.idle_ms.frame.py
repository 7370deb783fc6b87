"""match.idle_ms.frame: device-idle ms inside the program's step.match
spans (candidates, scoring, fusion, the gate and the UKF) within its
batch.run span, per batch.frame of the traced replay call."""

from harness.program import stage_idle_ms


def read(t):
    return stage_idle_ms(t, ("step.match",), "batch.frame", "batch.run")
