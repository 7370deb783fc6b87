"""mapprep.device_ops_per_map: device kernels, copies and memsets in the
traced switch over the switches traced (one)."""


def read(t):
    maps = t.slice_counts.get("switches", 0)
    if not maps or not t.events:
        return None
    return len(t.events) / maps
