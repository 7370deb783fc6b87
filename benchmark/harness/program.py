"""The program's own stage spans in a traced slice, and the device-idle
time inside them.

The program (lsdtpu_torch.runtime.trace) records its stage spans on the
host clock (``time.perf_counter_ns``, the clock the device trace is
aligned to) while a torch.profiler profile is active in the process,
which the traced slice is.  A reader takes them from the program in the
same process, clipped to the slice, and measures what of them the
device spent idle against the slice's busy intervals.  A program
without the tracer has no spans: every reader then returns None.  In a
cell over several cards the other ranks hand theirs to rank 0 with
their cards (``card_program_spans``)."""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

from harness.trace import clip, overlap, union


def program_spans(t) -> list:
    """The program's span records overlapping the traced slice (name,
    start_ns, end_ns, parent, request, counts, id), or [] where there is
    no slice or the program keeps no spans."""
    if t.slice is None:
        return []
    try:
        from lsdtpu_torch.runtime import trace as ptrace
        records = ptrace.spans()
    except (ImportError, AttributeError):
        return []
    lo, hi = t.slice
    return [s for s in records if s.end_ns > lo and s.start_ns < hi]


class ProgramSpan(NamedTuple):
    """A program span record handed over by another rank (the fields of
    lsdtpu_torch.runtime.trace.SpanRecord)."""
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    request: object
    counts: dict
    id: int


def recorded():
    """The program's span records and counters in this process ([] and
    {} where the program keeps none)."""
    try:
        from lsdtpu_torch.runtime import trace as ptrace
        return ptrace.spans(), ptrace.counters()
    except (ImportError, AttributeError):
        return [], {}


def card_program_spans(t, rank: int) -> list:
    """``program_spans`` of the card of ``rank``: rank 0's read in this
    process, another rank's from its card."""
    if rank == 0:
        return program_spans(t)
    if t.slice is None:
        return []
    lo, hi = t.slice
    return [s for s in t.cards[rank].program_spans
            if s.end_ns > lo and s.start_ns < hi]


def intervals(spans, names: Sequence[str]) -> List[tuple]:
    """The merged intervals of the spans named ``names``."""
    return union((s.start_ns, s.end_ns) for s in spans if s.name in names)


def intersect(a, b) -> List[tuple]:
    """The intersection of two merged interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle_ns(t, ivs, busy=None) -> int:
    """Device-idle time inside merged intervals, clipped to the slice."""
    ivs = clip(ivs, *t.slice)
    busy = t.busy() if busy is None else busy
    return sum(b - a for a, b in ivs) - overlap(ivs, busy)


def stage_idle_ms(t, stages: Sequence[str], per: str,
                  within: Optional[str] = None,
                  minus: Sequence[str] = ()) -> Optional[float]:
    """Device-idle ms inside the spans named ``stages`` that lie inside
    the ``within`` spans (default ``per``), less what of it lies inside
    spans named ``minus`` (stages nested in these, each read by its own
    metric), over the number of ``per`` spans in the slice; None
    without them."""
    spans = program_spans(t)
    n = sum(1 for s in spans if s.name == per)
    if not n:
        return None
    busy = t.busy()
    inside = intersect(intervals(spans, stages),
                       intervals(spans, (within or per,)))
    idle = idle_ns(t, inside, busy)
    if minus:
        idle -= idle_ns(t, intersect(inside, intervals(spans, minus)), busy)
    return idle / 1e6 / n


def span_count(t, name: str, key: str, per: str) -> Optional[float]:
    """The sum of count ``key`` over the slice's spans named ``name``,
    over the number of ``per`` spans in it; None without them."""
    spans = program_spans(t)
    n = sum(1 for s in spans if s.name == per)
    if not n:
        return None
    return sum(s.counts.get(key, 0) for s in spans if s.name == name) / n
