"""Each per-layer metric reader on a canned trace, and the trace's
reductions (clock alignment, idle share, breakdown)."""

import pytest

from conftest import BENCH
from harness import spec
from harness import trace as tr

MS = 1_000_000


def view(**kw):
    base = dict(spans=[], counters={}, events=[], slice=None,
                slice_counts={}, serving=("step",))
    base.update(kw)
    return tr.TraceView(**base)


def read(name, t):
    return spec.load_module(BENCH / "metrics" / f"{name}.py",
                            "m_" + name.replace(".", "_")).read(t)


# a 100 ms slice: two 30 ms steps; the device busy 10-20 and 50-70 ms
EVENTS = [("score_partials_batched_kernel", "kernel", 10 * MS, 14 * MS),
          ("vectorized_elementwise_kernel", "kernel", 14 * MS, 20 * MS),
          ("Memcpy DtoH (Device -> Pinned)", "dtoh", 50 * MS, 51 * MS),
          ("score_partials_kernel", "kernel", 51 * MS, 70 * MS)]
SPANS = [("step", 5 * MS, 35 * MS), ("wait", 35 * MS, 45 * MS),
         ("step", 45 * MS, 75 * MS)]


@pytest.fixture
def canned():
    return view(spans=SPANS, events=EVENTS, slice=(0, 100 * MS),
                slice_counts={"scans": 4, "switches": 2, "frames": 2},
                counters={"rdp_rounds": 30, "featurize_calls": 6,
                          "scans_carried": 12, "slots_stepped": 48})


def test_span_and_counter_readers(canned):
    t = view(spans=[("pool.step", 0, 20 * MS), ("pool.submit", 20 * MS,
                                                   21 * MS),
                    ("pool.step", 30 * MS, 70 * MS)],
             counters=canned.counters)
    assert read("pool.tick_ms", t) == pytest.approx(30.0)
    assert read("pool.live_lane_share", t) == pytest.approx(0.25)
    assert read("featurize.rdp_rounds.scan", t) == pytest.approx(5.0)
    assert read("featurize.rdp_rounds.replay", t) == pytest.approx(5.0)


def test_trace_readers(canned):
    assert read("calcscore.device_ms.scan", canned) == pytest.approx(
        23.0 / 4)
    assert read("mapprep.dtoh_per_map", canned) == pytest.approx(0.5)
    assert read("mapprep.device_ops_per_map", canned) == pytest.approx(2.0)
    assert read("loop.device_ops_per_frame.replay", canned) == \
        pytest.approx(2.0)
    # serving time 5-35 and 45-75 ms (60 ms); busy inside it 10-20 and
    # 50-70 (30 ms): the wait between steps does not count
    for m in ("scan", "map", "replay"):
        assert read(f"device.idle_share.{m}", canned) == pytest.approx(0.5)


def test_readers_return_nothing_without_data():
    empty = view()
    for p in sorted((BENCH / "metrics").glob("*.py")):
        name = p.stem
        if name in ("pool.live_lane_share", "featurize.rdp_rounds.scan",
                    "featurize.rdp_rounds.replay"):
            assert read(name, view(counters={"featurize_calls": 0,
                                             "slots_stepped": 0})) is None
        else:
            assert read(name, empty) is None, name


def test_breakdown_names_gaps_by_the_open_span(canned):
    b = tr.breakdown(canned)
    ops = dict(b["device_ops"])
    assert ops["score_partials_kernel"] == pytest.approx(0.019)
    assert b["device_ops"][0][0] == "score_partials_kernel"
    gaps = b["idle_gaps"]
    # idle 0-10, 20-50, 70-100 ms; 20-50 has its middle in the wait
    assert [g[1] for g in gaps] == pytest.approx([0.03, 0.03, 0.01])
    assert gaps[0][0].startswith("wait") or gaps[1][0].startswith("wait")
    assert any(g[0].startswith("outside") for g in gaps)
    assert tr.device_busy_s(canned) == pytest.approx(0.03)


def test_alignment_places_the_marker_at_the_host_reading():
    raw = [("void at::native::vectorized_elementwise_kernel<i1e>", 5_000,
            10), ("Memcpy DtoH (Device -> Pinned)", 9_000, 100),
           ("score_partials_kernel", 7_000, 50),
           ("arange_kernel", 1_000, 10)]        # before the slice
    off, ev, sl = tr.align(raw, 1_000, 1_010, 20_000)
    assert (off, sl) == (4_000, (1_010, 20_000))
    assert ev == [("score_partials_kernel", "kernel", 3_000, 3_050),
                  ("Memcpy DtoH (Device -> Pinned)", "dtoh", 5_000, 5_100)]
    # no marker: an earlier offset places the events
    off, ev, _ = tr.align(raw[1:], 0, 0, 20_000, offset=4_000)
    assert off == 4_000 and [e[2] for e in ev] == [3_000, 5_000]
    with pytest.raises(RuntimeError):
        tr.align([("Memcpy HtoD", 1, 1)], 0, 0, 1)


def test_interval_helpers():
    assert tr.union([(5, 7), (1, 3), (2, 4)]) == [(1, 4), (5, 7)]
    assert tr.overlap([(0, 10)], [(2, 3), (5, 20)]) == 6
    assert tr.clip([(0, 10), (20, 30)], 5, 25) == [(5, 10), (20, 25)]
