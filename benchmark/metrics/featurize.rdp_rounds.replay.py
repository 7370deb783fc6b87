"""featurize.rdp_rounds.replay: the RDP split rounds (each a host read)
over the batched frames of the window's replay calls (the port's
counter _rdp_rounds.rounds)."""


def read(t):
    frames = t.counters.get("featurize_calls", 0)
    return t.counters["rdp_rounds"] / frames if frames else None
