"""The benchmark's readers of the program's stage spans
(benchmark/metrics/*.py on benchmark/harness/program.py): each on a
canned device trace and canned program spans, its idle time against a
hand count, and nothing where the slice holds no program span."""

import sys
from pathlib import Path

import pytest

from lsdtpu_torch.runtime import trace as ttrace
from lsdtpu_torch.runtime.trace import SpanRecord

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

from harness import program  # noqa: E402
from harness import spec  # noqa: E402
from harness import trace as htr  # noqa: E402

MS = 1_000_000

FLEET = ("featurize.idle_ms.tick", "match.idle_ms.tick",
         "pool.io_idle_ms.tick", "host.gc_ms.tick")
REPLAY = ("featurize.idle_ms.frame", "match.idle_ms.frame")
SWITCH = ("mapprep.field.idle_ms", "mapprep.seed.idle_ms",
          "mapprep.grow.idle_ms", "mapprep.validate.idle_ms",
          "mapprep.seeds_per_map")

# a 100 ms slice, the device busy 10-20 and 50-70 ms
EVENTS = [("k1", "kernel", 10 * MS, 20 * MS),
          ("Memcpy DtoH (Device -> Pinned)", "dtoh", 50 * MS, 51 * MS),
          ("k2", "kernel", 51 * MS, 70 * MS)]


def spans(*rows):
    """SpanRecords from (name, start ms, end ms[, counts]) rows."""
    out = []
    for i, r in enumerate(rows):
        counts = r[3] if len(r) > 3 else {}
        out.append(SpanRecord(r[0], int(r[1] * MS), int(r[2] * MS), None,
                              None, counts, i))
    return out


# two ticks (5-35, 45-75 ms) and one past the slice
FLEET_SPANS = spans(
    ("pool.step", 5, 35), ("pool.pack", 5, 6), ("step.featurize", 6, 15),
    ("step.match", 15, 30), ("pool.readback", 30, 34), ("host.gc", 31, 33),
    ("pool.step", 45, 75), ("pool.pack", 45, 46), ("step.featurize", 46, 52),
    ("step.match", 52, 72), ("pool.readback", 72, 74),
    ("host.gc", 80, 85),                    # outside a tick: not counted
    ("pool.step", 120, 130), ("step.match", 121, 129))
# one call of three frames
REPLAY_SPANS = spans(
    ("batch.run", 2, 92), ("batch.upload", 2, 3), ("batch.frame", 3, 30),
    ("step.featurize", 3, 12), ("step.match", 12, 30),
    ("batch.frame", 30, 60), ("step.featurize", 30, 40),
    ("step.match", 40, 60), ("batch.frame", 60, 90),
    ("step.featurize", 60, 65), ("step.match", 65, 90))
# one switch: a regrowth (30-32) nests in a validation (30-44)
SWITCH_SPANS = spans(
    ("online.set_map", 0, 80), ("mapprep.field", 0, 8),
    ("mapprep.lsd", 8, 80, {"seeds": 3, "syncs": 40}),
    ("mapprep.seed", 8, 9), ("mapprep.grow", 9, 15),
    ("mapprep.seed", 25, 26), ("mapprep.grow", 26, 30),
    ("mapprep.validate", 30, 44), ("mapprep.grow", 30, 32),
    ("mapprep.seed", 45, 46), ("online.push", 80, 95))

# the hand counts: idle inside each stage (busy 10-20, 50-70), over the
# ticks (2), the frames (3) and the switches (1)
WANT = {
    # featurize 6-10 + 46-50; match 20-30 + 70-72; io 1 + 4 + 1 + 2;
    # gc 31-33 (80-85 lies outside every tick)
    "featurize.idle_ms.tick": 8 / 2, "match.idle_ms.tick": 12 / 2,
    "pool.io_idle_ms.tick": 8 / 2, "host.gc_ms.tick": 2 / 2,
    # featurize 3-10 + 30-40 + 0; match 20-30 + 40-50 + 70-90
    "featurize.idle_ms.frame": 17 / 3, "match.idle_ms.frame": 40 / 3,
    # field 0-8; seeds 1 + 1 + 1; growth 9-10, 26-30, 30-32; validation
    # 30-44 less its regrowth 30-32
    "mapprep.field.idle_ms": 8.0, "mapprep.seed.idle_ms": 3.0,
    "mapprep.grow.idle_ms": 7.0, "mapprep.validate.idle_ms": 12.0,
    "mapprep.seeds_per_map": 3.0}


def view(sl=(0, 100 * MS)):
    return htr.TraceView(spans=[], counters={}, events=EVENTS, slice=sl,
                         slice_counts={}, serving=())


def read(name, t):
    return spec.load_module(BENCH / "metrics" / f"{name}.py",
                            "m_" + name.replace(".", "_")).read(t)


@pytest.mark.parametrize("names, canned", [(FLEET, FLEET_SPANS),
                                           (REPLAY, REPLAY_SPANS),
                                           (SWITCH, SWITCH_SPANS)],
                         ids=["fleet", "replay", "mapswitch"])
def test_reader_against_hand_count(monkeypatch, names, canned):
    monkeypatch.setattr(ttrace, "spans", lambda: list(canned))
    for name in names:
        assert read(name, view()) == pytest.approx(WANT[name]), name


@pytest.mark.parametrize("name", FLEET + REPLAY + SWITCH)
def test_reader_returns_nothing_without_program_spans(monkeypatch, name):
    canned = FLEET_SPANS + REPLAY_SPANS + SWITCH_SPANS
    monkeypatch.setattr(ttrace, "spans", lambda: list(canned))
    # a slice past every span, no slice at all
    assert read(name, view((200 * MS, 300 * MS))) is None
    assert read(name, view(None)) is None
    # a program without the tracer (an older checkout)
    monkeypatch.delattr(ttrace, "spans")
    assert read(name, view()) is None


def test_readers_are_in_the_benchmark():
    import json
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    per = {m["name"]: m for m in bench["per_layer"]}
    cells = {FLEET: "fleet.f3key-data1", REPLAY: "replay.hall-0523",
             SWITCH: "mapswitch.f3key-data1"}
    for names, cell in cells.items():
        for name in names:
            assert per[name]["workloads"] == [cell]
            assert (BENCH / "metrics" / f"{name}.py").is_file()


def test_program_spans_clip_to_the_slice(monkeypatch):
    monkeypatch.setattr(ttrace, "spans", lambda: list(FLEET_SPANS))
    got = program.program_spans(view())
    assert [s.name for s in got][-1] == "host.gc"
    assert all(s.start_ns < 100 * MS for s in got)
    assert program.intersect([(0, 10), (20, 30)], [(5, 25)]) == \
        [(5, 10), (20, 25)]
    assert program.idle_ns(view(), [(0, 30 * MS)]) == 20 * MS
