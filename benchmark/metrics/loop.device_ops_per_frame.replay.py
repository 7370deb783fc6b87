"""loop.device_ops_per_frame.replay: device kernels, copies and memsets
of the traced run_batch call over its batched frames."""


def read(t):
    frames = t.slice_counts.get("frames", 0)
    if not frames or not t.events:
        return None
    return len(t.events) / frames
