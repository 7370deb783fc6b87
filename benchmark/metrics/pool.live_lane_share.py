"""pool.live_lane_share: the slots that carried a scan over the slots
stepped (a tick steps every slot of the pool)."""


def read(t):
    stepped = t.counters.get("slots_stepped", 0)
    return t.counters["scans_carried"] / stepped if stepped else None
