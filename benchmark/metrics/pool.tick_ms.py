"""pool.tick_ms: the window's time inside SessionPool.step over the
ticks (the benchmark's spans)."""


def read(t):
    ticks = [(b - a) for n, a, b in t.spans if n == "pool.step"]
    return sum(ticks) / len(ticks) / 1e6 if ticks else None
