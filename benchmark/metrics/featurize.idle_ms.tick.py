"""featurize.idle_ms.tick: device-idle ms inside the program's
step.featurize spans (the RDP rounds, each a host read) within its
pool.step spans, per tick of the traced slice."""

from harness.program import stage_idle_ms


def read(t):
    return stage_idle_ms(t, ("step.featurize",), "pool.step")
