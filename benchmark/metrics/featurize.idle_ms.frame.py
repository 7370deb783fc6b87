"""featurize.idle_ms.frame: device-idle ms inside the program's
step.featurize spans (the RDP rounds, each a host read) within its
batch.run span, per batch.frame of the traced replay call."""

from harness.program import stage_idle_ms


def read(t):
    return stage_idle_ms(t, ("step.featurize",), "batch.frame", "batch.run")
