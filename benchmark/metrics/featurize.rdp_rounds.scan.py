"""featurize.rdp_rounds.scan: the RDP split rounds (each a host read)
over the featurize calls of the window, one a tick for a pool (the
port's counter _rdp_rounds.rounds)."""


def read(t):
    calls = t.counters.get("featurize_calls", 0)
    return t.counters["rdp_rounds"] / calls if calls else None
