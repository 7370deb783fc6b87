"""The lift cell (traffic/lift.py) at a tiny size on the CPU: its cars
and schedule; a sound run correct; the control (the reference in
bfloat16 in the program's place), the program with its field in
bfloat16 and two planted faults not correct; its per-layer readers on
canned spans.

The tiny building: two rooms of the generator's default size (200 x 260
and 180 x 240 cells at 0.05 m), 16 robots, a car every 0.5 s.  Its
relocks gate 88-92 hypotheses, so the pool's candidate buffer is cut to
64 here (the relock buffer to 512), as 2,048 lies below most relocks of
the real floors: a relock truncated to the tracking buffer is the fault
the cell exists to see."""

import collections
import json

import numpy as np
import pytest

import run as runner
import test_bench_spec
from conftest import BENCH, ROOT, TINY_CONFIG
from harness import spec
from harness import trace as tr

NAME = "lift.f3f4key-building"
SEED = 2**31 + 5
SECONDS = 1.0
TINY_FLOORS = [{"floor": 3, "cols": 260, "rows": 200, "scene_seed": 3,
                "interior_walls": 3},
               {"floor": 4, "cols": 240, "rows": 180, "scene_seed": 4,
                "interior_walls": 3}]
# the numbers that decide a lift run's ``correct``: the spec test holds
# every cell's traffic file to a limit for each
COMPARED = {"pose_gap_max_px", "score_gap_median", "score_gap_p90",
            "decision_flip_share", "truth_gap_px",
            "first_pose_gap_median_px", "relock_overflow_share"}
test_bench_spec.COMPARED.setdefault("lift", COMPARED)
MS = 1_000_000


def lift_cell(**over):
    """The lift cell on the tiny building: its traffic file's keys and
    limits, the tiny sizes above, BENCHMARK.json's metrics of the cell."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    wl = spec.load_json(BENCH / "workloads" / f"{NAME}.json")
    wl.update(robots=16, walks=2, walk_radius_m=1.0, rest_s=1.0,
              engine={"shapes.max_candidates": 64,
                      "shapes.relock_candidates": 512}, **over)
    config = {k: v for k, v in TINY_CONFIG.items()
              if k not in ("cols", "rows", "scene_seed", "interior_walls")}
    config.update(name="tiny-building", floors=TINY_FLOORS)
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or NAME in m["workloads"]]
    entry = {"name": NAME, "config": wl["config"], "traffic": "lift",
             "chips": 1}
    return spec.Cell(NAME, entry, config, wl, e2e, [])


def correct(cell, mode="program"):
    res, _lines, checks = runner.execute(cell, SEED, SECONDS, 0, mode, "cpu")
    return res, {c["name"]: c["value"] for c in checks}, \
        {c["name"] for c in checks if not c["ok"]}


def test_the_cell_is_in_the_benchmark_with_its_limits():
    cell = spec.find_cell(NAME)
    assert cell.kind == "lift" and cell.entry["chips"] == 1
    assert COMPARED <= set(cell.workload["limits"])
    assert {m["name"] for m in cell.end_to_end} == {"map_to_pose_ms",
                                                    "setup_s"}
    assert len(cell.per_layer) == 5
    assert [f["cols"] for f in cell.config["floors"]] == [1440, 1404]


def test_cars_riders_and_the_schedule():
    cell = lift_cell()
    run = cell.traffic_module().Run(cell, SEED, "cpu", "control")
    run.seconds = 3.0
    run.setup()
    n, period = len(run.sid), run.period
    where = [stays[0].floor for stays in run.stays]
    assert sorted(collections.Counter(where).values()) == [n // 2, n // 2]
    rode = {}
    for k, car in enumerate(run.cars):
        assert car.at == pytest.approx(run.cars[0].at + 0.5 * k)
        assert car.floor == (run.cars[0].floor + k) % 2
        assert len(car.riders) == 4
        for i, stay in zip(car.riders, car.stays):
            assert where[i] != car.floor and stay.floor == car.floor
            assert car.at - rode.get(i, -9.0) >= 1.0
            where[i], rode[i] = car.floor, car.at
    ev = sorted(run.schedule(3.0))
    for i in range(n):
        dues = [(d, k) for d, o, j, k in ev if o == 1 and j == i]
        cuts = [c.at for c in run.cars if i in c.riders]
        assert [k for _d, k in dues] == sorted(k for _d, k in dues)
        for k, first in enumerate([run.phase[i]] + cuts):
            mine = [d for d, kk in dues if kk == k]
            end = (cuts + [3.0])[k]
            assert np.allclose(mine, first + period * np.arange(len(mine)))
            assert all(first <= d < end for d in mine)
    # a car comes before the scans due at its arrival
    assert all(o == 0 for d, o, _j, _k in ev
               if any(d == c.at for c in run.cars) and o == 0)
    again = cell.traffic_module().Run(cell, SEED, "cpu", "control")
    again.seconds = 3.0
    again.setup()
    assert [(c.at, c.riders) for c in again.cars] == \
        [(c.at, c.riders) for c in run.cars]


def test_sound_lift_is_correct():
    res, vals, bad = correct(lift_cell())
    assert res["correct"] and not bad, vals
    assert res["failed"] == 0
    assert vals["relock_overflow_share"] == 0.0
    assert vals["first_pose_gap_median_px"] < 1e-3
    assert set(res["metrics"]) == {"map_to_pose_ms", "setup_s"}


def test_lift_control_is_not_correct():
    res, vals, _bad = correct(lift_cell(), "control")
    assert not res["correct"], vals


def test_lift_with_bf16_field_is_not_correct():
    res, vals, _bad = correct(lift_cell(), "cache-bf16")
    assert not res["correct"], vals


def test_a_rider_relocked_on_its_old_floor_is_caught(monkeypatch):
    """Every session reopened with the map it first opened with."""
    from lsdtpu_torch.runtime import serving
    real = serving.SessionPool.open_session
    first = {}

    def stale(self, sid, *art):
        return real(self, sid, *first.setdefault(sid, art))

    monkeypatch.setattr(serving.SessionPool, "open_session", stale)
    res, vals, bad = correct(lift_cell())
    assert not res["correct"], vals
    assert "first_pose_gap_median_px" in bad, vals


def test_a_relock_truncated_to_the_tracking_buffer_is_caught(monkeypatch):
    """The pool's tick never told it relocks: a relock keeps the first
    shapes.max_candidates hypotheses, as a pool without a relock buffer
    does."""
    from lsdtpu_torch.runtime import serving
    real = serving._pool_step

    def capped(states, inputs, ctxs, active, cfg, coarse=None,
               relock=False):
        return real(states, inputs, ctxs, active, cfg, coarse, False)

    monkeypatch.setattr(serving, "_pool_step", capped)
    res, vals, bad = correct(lift_cell())
    assert not res["correct"], vals
    assert "relock_overflow_share" in bad, vals


# -- a relock's ties ----------------------------------------------------------
def test_a_relock_reports_every_tied_minimum():
    """Two copies of one map line 7 px apart along a field that does not
    change along them: the scan scores the same on either, the first is
    the relock's pose, and both are its ties."""
    from reference import floors as rfl
    field = np.minimum(np.abs(np.arange(80.0) - 40.0) * 0.025, 1.0)
    field = np.repeat(field[:, None], 300, 1)
    line = lambda x1, y1, x2, y2: [0, 0, 0, 0, x1, y1, x2, y2,
                                   float(np.hypot(x2 - x1, y2 - y1)), 0]
    scan = np.asarray([line(10.0, 20.0, 60.0, 20.0)])
    maps = np.asarray([line(100.0, 40.0, 150.0, 40.0),
                       line(107.0, 40.0, 157.0, 40.0)])
    pts = np.stack([np.arange(10.0, 61.0), np.full(51, 20.0)], 1)
    pts[::3, 1] += 1.0            # off the wall: a score above 0
    got = rfl.relock(scan, maps, pts, (35.0, 10.0), field)
    assert 0 < got.score < 3
    first, second = [110.0 + 15.0, 40.0 - 10.0], [117.0 + 15.0, 30.0]
    assert np.allclose(got.pose[:2], first)
    assert any(np.allclose(t[:2], second) for t in got.ties)
    assert np.allclose(got.ties[0], got.pose)
    assert np.allclose(rfl.nearest_tie(got.ties, [131.8, 30.1, 0.0])[:2],
                       second)
    # a third line one pixel off the wall: no tie, and not among them
    far = rfl.relock(scan, np.concatenate([maps, [line(200.0, 41.0, 250.0,
                                                       41.0)]]), pts,
                     (35.0, 10.0), field)
    assert not any(np.allclose(t[:2], [215.0, 31.0]) for t in far.ties)


def _tiny_stay(frames=12):
    """A stay's steps on the tiny building's first floor and the
    reference's own answers to them, with its lines and field."""
    from harness import kind
    from reference import follow
    from reference import lsd as rlsd
    from traffic import scene
    config = dict(TINY_CONFIG, **TINY_FLOORS[0])
    b = scene.building(config, config["scene_seed"])
    walk = scene.walks(b, 11, 1, config["frames"], config["range_m"], 0.15,
                       1.0, "cpu")[0]
    steps = kind.reference_steps(kind.Robot("", walk, 0, 1, 0.0),
                                 range(frames))
    lines = rlsd.line_segment_detector(b.grid.copy()).lines_info
    field = rlsd.create_map_cache(b.grid.copy(), b.resol)
    geom = (b.resol, b.ori_x, b.ori_y)
    fol = follow.Follower(lines, field, *geom)
    answers = [fol.step(st["ranges"], st["angles"], st["odom_prev"],
                        st["odom_cur"]) for st in steps]
    return steps, answers, lines, field, geom


def test_stream_gaps_hold_a_relock_to_its_nearest_tie(monkeypatch):
    """The lift's stream follower: the reference's own answers read no
    gap, as in judge.stream_gaps; a relock answered 4 px off reads 4 px
    unless that pose ties with the reference's, and then reads none."""
    from reference import floors as rfl
    from reference import judge as rj
    steps, answers, lines, field, geom = _tiny_stay()
    assert np.isfinite(answers[0]["score"])
    own = rfl.stream_gaps(steps, answers, lines, field, geom)
    assert own == rj.stream_gaps(steps, answers, lines, field, geom)
    assert max(own["pose"]) < 1e-9
    moved = [dict(a) for a in answers]
    moved[0]["pose"] = answers[0]["pose"] + np.asarray([4.0, 0.0, 0.0])
    assert rfl.stream_gaps(steps, moved, lines, field, geom)["pose"][0] == \
        pytest.approx(4.0)
    real = rfl.relock_scan

    def tied(*a):
        r = real(*a)
        return r._replace(ties=np.stack([r.pose, moved[0]["pose"]]))

    monkeypatch.setattr(rfl, "relock_scan", tied)
    got = rfl.stream_gaps(steps, moved, lines, field, geom)
    assert got["pose"][0] == 0.0
    assert rj.stream_gaps(steps, moved, lines, field, geom)["pose"][0] == \
        pytest.approx(4.0)


# -- the per-layer readers ----------------------------------------------------
class Rec(collections.namedtuple(
        "Rec", "name start_ns end_ns parent request counts id")):
    pass


def read(name, t):
    return spec.load_module(BENCH / "metrics" / f"{name}.py",
                            "m_" + name.replace(".", "_")).read(t)


def test_lift_readers():
    # a 100 ms slice: a relock tick 0-40 ms (match 10-30), a plain tick
    # 50-80 ms (match 55-75); a ride 40-45 ms; device busy 10-20, 22-24
    # and 60-70 ms
    recs = [Rec("pool.step", 0, 40 * MS, None, 1, {"relock_lanes": 4}, 0),
            Rec("step.match", 10 * MS, 30 * MS, 0, 1, {}, 1),
            Rec("pool.close_session", 40 * MS, 41 * MS, None, None, {}, 2),
            Rec("pool.open_session", 41 * MS, 44 * MS, None, None, {}, 3),
            Rec("pool.close_session", 44 * MS, 44 * MS + MS // 2, None,
                None, {}, 4),
            Rec("pool.open_session", 44 * MS + MS // 2, 45 * MS, None, None,
                {}, 5),
            Rec("pool.step", 50 * MS, 80 * MS, None, 2, {"relock_lanes": 0},
                6),
            Rec("step.match", 55 * MS, 75 * MS, 6, 2, {}, 7)]
    events = [("score_partials_batched_kernel", "kernel", 10 * MS, 20 * MS),
              ("elementwise_kernel", "kernel", 22 * MS, 24 * MS),
              ("score_partials_batched_kernel", "kernel", 60 * MS, 70 * MS)]
    t = tr.TraceView(
        spans=[("pool.step", 0, 40 * MS), ("lift.ride", 40 * MS, 45 * MS),
               ("pool.step", 50 * MS, 80 * MS)],
        counters={"pool.relock_ticks": 3, "pool.relock_lanes": 13},
        events=events, slice=(0, 100 * MS), slice_counts={"scans": 4},
        serving=("pool.submit", "pool.step", "lift.ride"))
    # the open and close spans: 5 ms over two changes
    assert _read_with(recs, "pool.open_ms.lift", t) == pytest.approx(2.5)
    assert read("pool.relocks_per_tick.lift", t) == pytest.approx(13 / 3)
    # match 10-30 ms of the relock tick, busy 10-20 and 22-24: idle 8 ms
    assert _read_with(recs, "match.idle_ms.relock_tick", t) == \
        pytest.approx(8.0)
    # the relock tick's CalcScore: 10 ms; the plain tick's is not counted
    assert _read_with(recs, "calcscore.device_ms.relock_tick", t) == \
        pytest.approx(10.0)
    # serving 0-45 and 50-80 ms (75 ms), busy 22 ms of it
    assert read("device.idle_share.lift", t) == pytest.approx(1 - 22 / 75)


def _read_with(recs, name, t):
    """A program-span reader on ``recs`` in place of the process's own."""
    mod = spec.load_module(BENCH / "metrics" / f"{name}.py",
                           "m_" + name.replace(".", "_"))
    mod.program_spans = lambda _t: recs
    return mod.read(t)


def test_lift_readers_read_nothing_from_a_program_without_them():
    """The parent's program keeps no relock span count, no swap span and
    no relock counter: every new reader returns None."""
    recs = [Rec("pool.step", 0, 40 * MS, None, 1,
                {"slots_stepped": 3, "scans_carried": 2}, 0),
            Rec("step.match", 10 * MS, 30 * MS, 0, 1, {}, 1)]
    t = tr.TraceView(spans=[("pool.step", 0, 40 * MS)], counters={},
                     events=[("score_partials_kernel", "kernel", 10 * MS,
                              20 * MS)], slice=(0, 100 * MS),
                     slice_counts={}, serving=("pool.step",))
    for m in ("match.idle_ms.relock_tick", "calcscore.device_ms.relock_tick",
              "pool.open_ms.lift"):
        assert _read_with(recs, m, t) is None, m
    assert read("pool.relocks_per_tick.lift", t) is None
