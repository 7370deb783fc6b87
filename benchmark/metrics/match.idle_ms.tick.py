"""match.idle_ms.tick: device-idle ms inside the program's step.match
spans (candidates, scoring, fusion, the gate and the UKF, ~1300
launches a tick) within its pool.step spans, per tick of the traced
slice."""

from harness.program import stage_idle_ms


def read(t):
    return stage_idle_ms(t, ("step.match",), "pool.step")
