"""calcscore.device_ms.relock_tick: the device time of the CalcScore
kernels (score_partials*) that start inside a pool.step span carrying a
relock lane (its count relock_lanes above 0), per such tick of the
traced slice.  A tick ends with the read of its outputs, so its kernels
run inside its span."""

from harness.program import program_spans


def read(t):
    ticks = [(s.start_ns, s.end_ns) for s in program_spans(t)
             if s.name == "pool.step" and s.counts.get("relock_lanes", 0) > 0]
    if not ticks:
        return None
    ns = [b - a for name, kind, a, b in t.events
          if kind == "kernel" and "score_partials" in name
          and any(lo <= a < hi for lo, hi in ticks)]
    if not ns:
        return None
    return sum(ns) / 1e6 / len(ticks)
