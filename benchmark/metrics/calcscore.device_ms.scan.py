"""calcscore.device_ms.scan: the device time of the CalcScore kernels
(score_partials*) in the traced slice over the scans answered in it."""


def read(t):
    scans = t.slice_counts.get("scans", 0)
    ns = [b - a for name, kind, a, b in t.events
          if kind == "kernel" and "score_partials" in name]
    if not scans or not ns:
        return None
    return sum(ns) / 1e6 / scans
