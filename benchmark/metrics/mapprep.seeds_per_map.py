"""mapprep.seeds_per_map: the seed walk's seeds (the MapPrepStats
count on the program's mapprep.lsd span), per online.set_map span of
the traced slice."""

from harness.program import span_count


def read(t):
    return span_count(t, "mapprep.lsd", "seeds", "online.set_map")
