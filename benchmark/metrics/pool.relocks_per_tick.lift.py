"""pool.relocks_per_tick.lift: the relock lanes the program stepped in
the window (its counter pool.relock_lanes) over the ticks that carried
one (pool.relock_ticks), both read around the window."""


def read(t):
    ticks = t.counters.get("pool.relock_ticks")
    if not ticks:
        return None
    return t.counters["pool.relock_lanes"] / ticks
