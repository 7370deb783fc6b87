"""pool.open_ms.lift: the host ms of a floor change inside the program's
pool.open_session and pool.close_session spans (the rider's session
closed on one floor's map and opened on the other's, between two
ticks), over the pool.open_session spans of the traced slice."""

from harness.program import program_spans


def read(t):
    spans = program_spans(t)
    opens = sum(1 for s in spans if s.name == "pool.open_session")
    if not opens:
        return None
    ns = sum(s.end_ns - s.start_ns for s in spans
             if s.name in ("pool.open_session", "pool.close_session"))
    return ns / 1e6 / opens
