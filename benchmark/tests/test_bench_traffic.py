"""The traffic kinds' schedules and streams at a tiny size, on the CPU."""

import math

import numpy as np
import pytest

from harness import kind
from reference import judge as rj
from traffic import scene


def test_scene_copy_is_the_smoke_tests_scene_bit_for_bit():
    from lsdtpu_torch.io import synth
    kw = dict(F=279, H=979, W=1440, resol=0.025, rmax=13.0, n_walls=46,
              clear_m=2.5, wall_scale=2.5)
    want = synth.synth_dataset(1, **kw)
    got = scene.synth_dataset(1, **kw)
    assert np.array_equal(got.grid, want.dataset.map_value)
    assert np.array_equal(got.walls, want.walls)
    assert np.array_equal(got.odom, want.dataset.odom)
    assert np.array_equal(got.true_pos, want.true_pos)
    assert all(np.array_equal(a, b)
               for a, b in zip(got.frames, want.dataset.frames))
    assert np.array_equal(scene.wall_lines(got.walls),
                          synth.wall_lines(want.walls), equal_nan=True)


@pytest.mark.parametrize("seed", [0, 5])
def test_device_march_is_the_copys_raycast(seed):
    g, walls = scene.synth_map(seed, 200, 260, 3, 20.0, 1.0)
    b = scene.Building(g, walls, scene.RESOL, scene.ORI_X, scene.ORI_Y)
    rng = np.random.default_rng(seed)
    pos = np.asarray(b.centre) + rng.uniform(-1, 1, (5, 2))
    got = scene.cast_scans(b, pos, 10.0, "cpu", chunk=2)
    for f, (x, y) in enumerate(pos):
        r, a = scene.raycast(g, x, y, rmax=10.0)
        hit = np.rint(a / scene.SCAN_INC).astype(int)
        assert np.array_equal(got[f, hit], r)
        assert np.isinf(np.delete(got[f], hit)).all()


def test_cycle_is_forwards_then_backwards():
    F = 5
    fwd = [scene.cycle_index(F, 0, t) for t in range(10)]
    assert fwd == [0, 1, 2, 3, 4, 3, 2, 1, 0, 1]
    back = [scene.cycle_index(F, 2, t, -1) for t in range(6)]
    assert back == [2, 1, 0, 1, 2, 3]
    # consecutive frames are neighbours: no robot jumps
    for start in range(8):
        for d in (1, -1):
            seq = [scene.cycle_index(F, start, t, d) for t in range(20)]
            assert all(abs(a - b) == 1 for a, b in zip(seq, seq[1:]))


def test_walks_stay_in_the_clear_disc_and_scans_are_ros_shaped():
    g, walls = scene.synth_map(2, 200, 260, 3, 30.0, 1.0)
    b = scene.Building(g, walls, 0.05, -2.0, -1.5)
    ws = scene.walks(b, 2**31 + 11, 2, 40, 10.0, 0.15, 1.0)
    again = scene.walks(b, 2**31 + 11, 2, 40, 10.0, 0.15, 1.0)
    for w, w2 in zip(ws, again):
        assert np.array_equal(w.scans, w2.scans, equal_nan=True)
        d = np.hypot(*(w.pos - w.pos[0]).T)
        assert d.max() <= 1.0 + 1e-12
        assert np.abs(np.diff(w.pos, axis=0)).max() <= 0.15
        assert w.scans.dtype == np.float32 and w.scans.shape == (40, 360)
        assert np.isfinite(w.scans).sum(1).min() > 100
    assert not np.array_equal(ws[0].pos, ws[1].pos)


def test_fleet_schedule_due_times_and_phases(tiny):
    run = tiny("fleet").traffic_module().Run(tiny("fleet"), 7, "cpu",
                                             "control")
    run.setup()
    ev = sorted(run.schedule(1.0))
    assert [d for d, _ in ev] == sorted(d for d, _ in ev)
    for i, r in enumerate(run.robots):
        dues = [d for d, j in ev if j == i]
        assert 0.0 <= r.phase < run.period
        assert np.allclose(dues, r.phase + run.period * np.arange(len(dues)))
        assert len(dues) == math.ceil((1.0 - r.phase) / run.period)


def test_an_unanswered_scan_counts_as_missing_every_limit():
    lat = [10.0] * 18 + [math.inf] * 2
    assert kind.percentile(lat, 50) == 10.0
    assert math.isinf(kind.percentile(lat, 95))
    assert kind.percentile([1.0, 2.0, 3.0], 50) == 2.0
    assert kind.percentile([1.0, 2.0], 95) == pytest.approx(1.95)


def test_fleet_counts_a_dropped_answer_as_failed(tiny, monkeypatch):
    from lsdtpu_torch.runtime import serving
    real = serving.SessionPool.step

    def drop_r0(self):
        out = real(self)
        out.pop("r0", None)
        return out

    cell = tiny("fleet")
    run = cell.traffic_module().Run(cell, 3, "cpu")
    run.setup()
    monkeypatch.setattr(serving.SessionPool, "step", drop_r0)
    run.window(0.5)
    n_r0 = sum(1 for d, i in run.schedule(0.5) if i == 0)
    assert run.failed() == n_r0 > 0
    assert math.isinf(max(run.lat))


def test_truth_is_the_walk_in_map_pixels(tiny):
    """Every robot's tracked answers lie within a pixel or two of its
    walk, in the frame the program answers in."""
    cell = tiny("fleet")
    run = cell.traffic_module().Run(cell, 9, "cpu")
    run.setup()
    run.window(0.6)
    for r in run.robots:
        ts = run.taken[r.sid][:len(run.poses[r.sid])]
        gap = rj.truth_gaps(run.poses[r.sid],
                            run.truth_px(r.walk, [r.frame(t) for t in ts]))
        assert gap < 2.0, (r.sid, gap)


def test_truth_gaps_skips_lost_answers_only():
    truth = np.array([[10.0, 10.0], [11.0, 10.0], [12.0, 10.0],
                      [13.0, 10.0]])
    poses = np.array([[10.5, 10.0, 0.0], [-1.0, -1.0, 0.0],
                      [np.nan, np.nan, np.nan], [13.0, 12.0, 0.0]])
    assert rj.truth_gaps(poses, truth) == pytest.approx(1.25)
    assert rj.truth_gaps(poses[1:3], truth[1:3]) == math.inf


def test_replay_lanes_follow_their_walks(tiny):
    cell = tiny("replay")
    run = cell.traffic_module().Run(cell, 4, "cpu", "control")
    run.setup()
    w, idx = run.lanes(0)
    fr = run.frames((w, idx))
    F = cell.config["frames"]
    assert fr["ranges"].shape == (cell.workload["lanes"], F, 360)
    for b in range(len(w)):
        assert all(abs(x - y) == 1 for x, y in zip(idx[b], idx[b][1:]))
        wk = run.walks[w[b]]
        assert np.array_equal(fr["odom_cur"][b],
                              wk.odom[idx[b]].astype(np.float32))
        assert np.array_equal(fr["odom_prev"][b, 1:], fr["odom_cur"][b, :-1])
    assert not np.array_equal(run.lanes(0)[1], run.lanes(1)[1])


def test_a_perfect_pose_on_one_side_is_a_decision_not_a_gap(monkeypatch):
    """A NaN pose (a perfect candidate's) against a finite one counts as a
    decision flip and stays out of the pose gap; NaN against NaN is no
    gap."""
    refs = iter([{"pose": np.array([5.0, 5.0, 0.0]), "score": 0.1,
                  "n_candidates": 3},
                 {"pose": np.array([np.nan, np.nan, np.nan]), "score": 0.0,
                  "n_candidates": 3},
                 {"pose": np.array([np.nan, np.nan, np.nan]), "score": 0.0,
                  "n_candidates": 3}])

    class Stub:
        def __init__(self, *a, **k):
            pass

        def step(self, *a):
            return next(refs)

    monkeypatch.setattr(rj, "Follower", Stub)
    answers = [{"pose": np.array([np.nan, np.nan, np.nan]), "score": 0.0,
                "n_candidates": 3},
               {"pose": np.array([5.5, 5.0, 0.0]), "score": 0.1,
                "n_candidates": 3},
               {"pose": np.array([np.nan, np.nan, np.nan]), "score": 0.0,
                "n_candidates": 3}]
    steps = [{"ranges": None, "angles": None, "odom_prev": None,
              "odom_cur": None}] * 3
    g = rj.stream_gaps(steps, answers, None, None, (0.025, 0.0, 0.0))
    assert g["flips"] == 2 and g["pose"] == [0.0] and g["scans"] == 3
