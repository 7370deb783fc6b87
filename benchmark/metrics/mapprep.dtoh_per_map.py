"""mapprep.dtoh_per_map: device-to-host copies in the traced switch
(set_map and the first scan) over the switches traced (one)."""


def read(t):
    maps = t.slice_counts.get("switches", 0)
    if not maps or not t.events:
        return None
    return sum(1 for e in t.events if e[1] == "dtoh") / maps
