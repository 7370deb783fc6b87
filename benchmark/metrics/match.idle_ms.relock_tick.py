"""match.idle_ms.relock_tick: device-idle ms inside the program's
step.match spans within the pool.step spans that carry a relock lane
(their count relock_lanes above 0), per such tick of the traced slice."""

from harness.program import idle_ns, intersect, intervals, program_spans
from harness.trace import union


def read(t):
    spans = program_spans(t)
    ticks = [(s.start_ns, s.end_ns) for s in spans if s.name == "pool.step"
             and s.counts.get("relock_lanes", 0) > 0]
    if not ticks:
        return None
    inside = intersect(intervals(spans, ("step.match",)), union(ticks))
    return idle_ns(t, inside) / 1e6 / len(ticks)
