"""Spans and counters kept by the benchmark, and the device trace of a
bounded slice of the window.

Spans are the benchmark's own: the host clock (``time.perf_counter_ns``)
around each call into a layer of the program, kept in memory in every
run (a list append a call).  The device trace is ``torch.profiler`` with
CUDA activity only, over one slice of a traced run's window: host-op
tracing slows the host and its processing, so the profiler records the
card's kernels and copies, and the benchmark's spans name what the host
was doing.  Both are put on one clock by a marker: a one-element
kernel the program never launches (``i1e``), launched right after the
host clock is read with the device idle, so its device start is that
reading plus one launch latency (a few us).
The raw kineto events are read; no Chrome trace is written.

In a cell over several cards each rank traces its own card and puts its
events on the host clock by its own marker: ``time.perf_counter_ns`` is
CLOCK_MONOTONIC, one clock for every process of a host.  Rank 0 gathers
every card (``Card``) after the window; ``TraceView.events`` stays rank
0's, so a reader written for one card reads what it read before, and
``cards`` hold them all.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

# the clock marker: a kernel the program never launches
MARKER = "i1e"
NAME_CHARS = 160                     # a kernel's name, cut for the line
Span = Tuple[str, int, int]          # (name, start_ns, end_ns), host clock
Event = Tuple[str, str, int, int]    # (name, kind, start_ns, end_ns)


class Spans:
    """The benchmark's spans and counters of one run."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter_ns()))


def event_kind(name: str) -> str:
    """A device event's kind from its name: a copy's direction, a memset,
    or a kernel."""
    if name.startswith("Memcpy DtoH"):
        return "dtoh"
    if name.startswith("Memcpy HtoD"):
        return "htod"
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


class DeviceTrace:
    """torch.profiler over one slice, its device events on the host
    clock.  ``start`` and ``stop`` are called between calls into the
    program, with the device idle."""

    def __init__(self):
        self.events: List[Event] = []
        self.slice: Optional[Tuple[int, int]] = None
        self._prof = None
        self._t_host = None

    def warm(self) -> None:
        """Profile the marker alone once: the first profile of a process
        loads and sets up the tracing library for seconds, which is
        set-up; and the marker's reading gives the clock offset that a
        later slice uses where its own marker is missing."""
        self.start()
        self.stop()
        self.events, self.slice = [], None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._marker = torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        t_enter = time.perf_counter_ns()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._t_host = time.perf_counter_ns()
        torch.special.i1e(self._marker)        # the clock marker
        torch.cuda.synchronize()
        self._t0 = time.perf_counter_ns()
        self.start_s = (self._t0 - t_enter) / 1e9

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
        self._prof.__exit__(None, None, None)
        raw = []
        results = getattr(self._prof.profiler, "kineto_results", None)
        if results is not None:
            for e in results.events():
                if e.device_type() == torch.autograd.DeviceType.CUDA:
                    raw.append((e.name(), e.start_ns(), e.duration_ns()))
        else:                                   # older profilers
            for e in self._prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    raw.append((e.name, int(e.time_range.start * 1000),
                                int(e.time_range.elapsed_us() * 1000)))
        self._prof = None
        self.n_raw = len(raw)
        self.offset, self.events, self.slice = align(
            raw, self._t_host, self._t0, t1, getattr(self, "offset", None))
        self.stop_s = (time.perf_counter_ns() - t1) / 1e9


def align(raw, t_host: int, t0: int, t1: int, offset=None):
    """Device events (name, device start ns, duration ns) on the host
    clock: the last clock marker's device start is placed at ``t_host``
    (or, with no marker among the events, the earlier ``offset`` is
    used).  Returns the offset, the events of the slice [t0, t1] (a
    profile after the first in a process can hold earlier activity) and
    the slice."""
    marks = [s for n, s, _d in raw if MARKER in n]
    if marks:
        offset = max(marks) - t_host
    elif offset is None:
        raise RuntimeError(f"device trace: no clock marker ({MARKER}) "
                           f"among {len(raw)} device events")
    ev = []
    for n, s, d in raw:
        a, b = s - offset, s - offset + d
        if MARKER not in n and b > t0 and a < t1:
            ev.append((n, event_kind(n), a, b))
    ev.sort(key=lambda e: e[2])
    return offset, ev, (t0, t1)


def union(intervals) -> List[Tuple[int, int]]:
    """Merged, sorted intervals."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def overlap(a, b) -> int:
    """Total length of the intersection of two merged interval lists."""
    i = j = tot = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            tot += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def clip(intervals, lo: int, hi: int):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


@dataclasses.dataclass
class Card:
    """One card of a run as its rank hands it to rank 0: its peak memory,
    its traced slice and that slice's device events on the host clock,
    the benchmark's spans and counters, the program's span records and
    counters, and the forbidden modules loaded in its process."""
    rank: int
    memory_peak_bytes: int
    events: List[Event] = dataclasses.field(default_factory=list)
    slice: Optional[Tuple[int, int]] = None
    spans: List[Span] = dataclasses.field(default_factory=list)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    program_spans: list = dataclasses.field(default_factory=list)
    program_counters: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    forbidden: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class TraceView:
    """What a per-layer metric reader reads: the window's spans and
    counters, and the traced slice's device events and counts, all of
    rank 0; and every card of the run (``cards``, indexed by rank, rank
    0's first)."""
    spans: List[Span]
    counters: Dict[str, float]
    events: List[Event]
    slice: Optional[Tuple[int, int]]
    slice_counts: Dict[str, float]
    serving: Tuple[str, ...]        # the entry spans of this cell
    cards: List[Card] = dataclasses.field(default_factory=list)

    @property
    def events_by_card(self) -> List[List[Event]]:
        return [c.events for c in self.cards]

    def slice_spans(self, names=None):
        if self.slice is None:
            return []
        lo, hi = self.slice
        return [(n, a, b) for n, a, b in self.spans
                if (names is None or n in names) and b > lo and a < hi]

    def busy(self):
        """Merged device-busy intervals of the slice."""
        if self.slice is None:
            return []
        return clip(union((a, b) for _n, _k, a, b in self.events),
                    *self.slice)

    def serving_time(self):
        if self.slice is None:
            return []
        return clip(union((a, b) for _n, a, b in
                          self.slice_spans(self.serving)), *self.slice)


def idle_share(t: TraceView) -> Optional[float]:
    """The share of serving time (the union of the cell's entry spans in
    the slice) in which nothing ran on the device."""
    serve = t.serving_time()
    total = sum(b - a for a, b in serve)
    if total <= 0 or not t.events:
        return None
    return 1.0 - overlap(serve, t.busy()) / total


def breakdown(t: TraceView, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps of the slice, each named by the benchmark span open at its
    middle (``outside`` where none was)."""
    per: Dict[str, float] = {}
    for name, _k, a, b in t.events:
        name = name[:NAME_CHARS]
        per[name] = per.get(name, 0.0) + (b - a) / 1e9
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:top]
    busy = t.busy()
    gaps = []
    if t.slice is not None:
        edges = [t.slice[0]] + [x for iv in busy for x in iv] + [t.slice[1]]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps.append((a, b))
    gaps.sort(key=lambda g: g[0] - g[1])
    spans = sorted(t.slice_spans(), key=lambda s: s[2] - s[1])
    named = []
    for a, b in gaps[:top]:
        mid = (a + b) // 2
        name = next((n for n, s, e in spans if s <= mid < e), "outside")
        named.append([f"{name} +{(a - t.slice[0]) / 1e9:.3f}s",
                      (b - a) / 1e9])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


def card_busy(t: TraceView, card: Card):
    """Merged device-busy intervals of one card, clipped to rank 0's
    slice."""
    if t.slice is None:
        return []
    return clip(union((a, b) for _n, _k, a, b in card.events), *t.slice)


def card_busy_s(t: TraceView) -> List[float]:
    """Each card's busy seconds in the slice (one card: rank 0's)."""
    cards = t.cards or [Card(0, 0, t.events)]
    return [sum(b - a for a, b in card_busy(t, c)) / 1e9 for c in cards]


def device_busy_s(t: TraceView) -> float:
    """The mean over the cards of each card's busy seconds in the slice:
    over ``window_s`` a share of at most 1."""
    busy = card_busy_s(t)
    return sum(busy) / len(busy)


def card_idle_shares(t: TraceView):
    """Each card's share of its rank's serving time (the union of the
    cell's entry spans on that rank, in rank 0's slice) in which nothing
    ran on that card, and their mean; a card with no serving time or no
    events reads None, and then so does the mean."""
    shares = []
    for c in t.cards:
        serve = clip(union((a, b) for n, a, b in c.spans
                           if n in t.serving), *t.slice) \
            if t.slice is not None else []
        total = sum(b - a for a, b in serve)
        shares.append(1.0 - overlap(serve, card_busy(t, c)) / total
                      if total > 0 and c.events else None)
    mean = None if not shares or None in shares else \
        sum(shares) / len(shares)
    return shares, mean
