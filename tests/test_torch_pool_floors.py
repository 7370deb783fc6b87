"""A serving pool whose robots change floor between ticks
(lsdtpu_torch.runtime.serving.SessionPool) against the floor reference
(lsdtpu_torch.oracle.floors), on the CPU in float64.

Two floors of different sizes (the synthetic scenes of 200 x 260 and
180 x 240 cells) share one 8-slot pool; riders close their session on
one floor and open one on the other at fixed ticks, and their next scan
relocks there.  The pool's ``shapes.max_candidates`` is cut to 64, below
every relock's gated count on these floors (76-136) and above every
tracking scan's (at most 52): a relock lane is answered from every gated
hypothesis (``shapes.relock_candidates``), unflagged, and every other
lane's answers are those of a pool whose robots never ride, bit for bit.
Answers equal the reference's: decisions exactly, positions within
1e-9 px (the pool's batched UKF adds in another order).  The tests
marked ``cuda`` run the same riders on the card, skipping where there
is none: in float64 against the reference (positions within 1e-6 px,
the card tier of tests/test_torch_cuda.py), and in float32 the lanes
that do not ride against the pool without riders, bit for bit."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from lsdtpu_torch.config import DEFAULT
from lsdtpu_torch.oracle import fa as ofa
from lsdtpu_torch.oracle import floors
from lsdtpu_torch.oracle import rdp as ordp
from lsdtpu_torch.oracle.lsd import c_round
from lsdtpu_torch.runtime import trace
from lsdtpu_torch.runtime.serving import SessionPool

from torch_parity import lane_scenes

K = 64
CFG = dataclasses.replace(DEFAULT, shapes=dataclasses.replace(
    DEFAULT.shapes, max_candidates=K))
CANVAS = (200, 260)
FLOORS = {"A": 0, "B": 1}          # floor -> scene of lane_scenes()
# robot -> (floor, first frame); rides: robot -> [(tick, floor, frame)]
ROBOTS = {"r0": ("A", 0), "r1": ("A", 3), "r2": ("B", 1), "r3": ("B", 4),
          "r4": ("B", 6), "r5": ("A", 7)}
RIDES = {"r1": [(3, "B", 2), (7, "A", 5)], "r4": [(5, "A", 1)]}
TICKS = 10


def _frame(first, t, F=10):
    """Step t of a stay replaying F frames forwards, then backwards."""
    period = 2 * F - 2
    k = (first + t) % period
    return k if k < F else period - k


def _scan(floor, first, t):
    ds = lane_scenes()[0][FLOORS[floor]]
    f = _frame(first, t)
    return ds.frames[f][:, 0], ds.frames[f][:, 1], ds.odom[f + 1]


def _map(floor):
    dss, arts = lane_scenes()
    p = dss[FLOORS[floor]].param
    return (*arts[FLOORS[floor]], p.resol, p.ori_x, p.ori_y)


def _geom():
    p = lane_scenes()[0][0].param
    return p.resol, p.ori_x, p.ori_y


@functools.lru_cache(maxsize=None)
def _serve(riders=True, cfg=CFG, device="cpu", dtype=np.float64):
    """Every robot's answers, the scans it sent and the floor table."""
    pool = SessionPool(8, CANVAS, cfg, dtype=dtype, device=device)
    table = floors.FloorTable()
    stay = {}
    for sid, (fl, first) in ROBOTS.items():
        pool.open_session(sid, *_map(fl))
        table.board(sid, fl)
        stay[sid] = [fl, first, 0]
    answers = {sid: [] for sid in ROBOTS}
    scans = {sid: [] for sid in ROBOTS}
    for tick in range(TICKS):
        for sid, rides in RIDES.items() if riders else ():
            for at, fl, first in rides:
                if at == tick:
                    pool.close_session(sid)
                    pool.open_session(sid, *_map(fl))
                    table.board(sid, fl, len(scans[sid]))
                    stay[sid] = [fl, first, 0]
        for sid in ROBOTS:
            fl, first, t = stay[sid]
            stay[sid][2] += 1
            scan = _scan(fl, first, t)
            pool.submit_scan(sid, *scan)
            scans[sid].append(scan)
        res = pool.step()
        for sid in ROBOTS:
            answers[sid].append(res[sid])
    return answers, scans, table


@functools.lru_cache(maxsize=None)
def _reference():
    answers, scans, table = _serve()
    maps = {fl: lane_scenes()[1][i] for fl, i in FLOORS.items()}
    return {sid: floors.follow(table, sid, scans[sid], maps, *_geom())
            for sid in ROBOTS}


def _relock_steps(table, sid, n):
    return [lo for _fl, lo, _hi in table.segments(sid, n)]


def _assert_reference(answers, px, rtol):
    ref = _reference()
    for sid in ROBOTS:
        got, want = answers[sid], ref[sid]
        assert len(got) == len(want) == TICKS
        for k, (g, w) in enumerate(zip(got, want)):
            assert int(g["n_candidates"]) == w["n_candidates"], (sid, k)
            assert np.isfinite(g["score"]) == np.isfinite(w["score"])
            np.testing.assert_allclose(g["pose"], w["pose"], rtol=0,
                                       atol=px, err_msg=f"{sid} {k}")
            if np.isfinite(w["score"]):
                np.testing.assert_allclose(g["score"], w["score"],
                                           rtol=rtol, atol=0)
            assert not g["candidate_overflow"], (sid, k)


def test_every_answer_is_the_floor_reference():
    _assert_reference(_serve()[0], 1e-9, 1e-9)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")


@pytest.mark.cuda
def test_every_answer_on_the_card_is_the_floor_reference():
    _need_card()
    _assert_reference(_serve(device="cuda")[0], 1e-6, 1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lanes_that_do_not_ride_on_the_card_are_bitwise(dtype):
    _need_card()
    _assert_non_riders_bitwise(_serve(True, device="cuda", dtype=dtype)[0],
                               _serve(False, device="cuda", dtype=dtype)[0])


def test_relocks_past_max_candidates_are_unflagged_and_uncapped():
    """Every stay's first scan relocks over more than K gated hypotheses;
    the pool answers each from all of them, where a pool whose relock
    buffer is K flags it and keeps the first K."""
    answers, _scans, table = _serve()
    ref = _reference()
    capped = _serve(cfg=dataclasses.replace(CFG, shapes=dataclasses.replace(
        CFG.shapes, relock_candidates=K)))[0]
    n = 0
    for sid in ROBOTS:
        for k in _relock_steps(table, sid, TICKS):
            assert ref[sid][k]["n_gated"] > K
            assert not answers[sid][k]["candidate_overflow"]
            np.testing.assert_allclose(answers[sid][k]["pose"],
                                       ref[sid][k]["pose"], rtol=0,
                                       atol=1e-9)
            assert capped[sid][k]["candidate_overflow"]
            n += 1
    assert n == len(ROBOTS) + sum(len(r) for r in RIDES.values())


def test_lanes_that_do_not_ride_are_the_pool_without_riders_bit_for_bit():
    _assert_non_riders_bitwise(_serve(True)[0], _serve(False)[0])


def _assert_non_riders_bitwise(with_riders, without):
    for sid in sorted(set(ROBOTS) - set(RIDES)):
        for g, w in zip(with_riders[sid], without[sid]):
            assert set(g) == set(w)
            for key in g:
                np.testing.assert_array_equal(g[key], w[key],
                                              err_msg=f"{sid} {key}")


def _relock_of(floor, scan):
    """The reference's relock of one scan on ``floor``."""
    lines, field, resol, ox, oy = _map(floor)
    fs = ordp.feature_scan(np.asarray(scan[0], np.float64),
                           np.asarray(scan[1], np.float64), resol, ox, oy)
    lidar = [float(c_round(np.float64(v))) for v in fs.lidar_pos[:2]]
    return floors.relock(fs.lines_info, lines, fs.scan_im_point, lidar,
                         field)


def _pool_with(sids):
    pool = SessionPool(4, CANVAS, CFG, dtype=np.float64, device="cpu")
    for sid, fl in sids.items():
        pool.open_session(sid, *_map(fl))
    return pool


def test_a_relock_after_a_lost_scan_takes_the_relock_buffer():
    pool = _pool_with({"a": "A", "b": "B"})
    for t in range(2):
        pool.submit_scan("a", *_scan("A", 0, t))
        pool.submit_scan("b", *_scan("B", 0, t))
        pool.step()
    # an empty scan: no line, no candidate, the answer lost
    pool.submit_scan("a", np.zeros(0), np.zeros(0), _scan("A", 0, 2)[2])
    pool.submit_scan("b", *_scan("B", 0, 2))
    lost = pool.step()["a"]
    assert not np.isfinite(lost["score"])
    np.testing.assert_array_equal(lost["pose"], [-1.0, -1.0, 0.0])
    scan = _scan("A", 0, 3)
    pool.submit_scan("a", *scan)
    pool.submit_scan("b", *_scan("B", 0, 3))
    with trace.recording():
        trace.clear()
        got = pool.step()["a"]
        steps = [s for s in trace.spans() if s.name == "pool.step"]
    assert steps[-1].counts["relock_lanes"] == 1
    want = _relock_of("A", scan)
    assert want.n_gated > K
    assert int(got["n_candidates"]) == want.n_accepted
    assert not got["candidate_overflow"]
    np.testing.assert_allclose(got["pose"], want.pose, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["score"], want.score, rtol=1e-9)


def _reads():
    """The device reads counted so far, but the RDP fixpoint's rounds,
    which follow the scans' shapes (scan/featurize.py) and are the same
    whether a lane relocks or not."""
    return {k: v for k, v in trace.counters().items()
            if k.startswith("host_reads.") and
            k != "host_reads.featurize.rdp"}


def _delta(before):
    after = _reads()
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


def test_a_swap_and_a_relock_tick_add_no_device_read():
    pool = _pool_with({"a": "A", "b": "B"})
    for sid, fl in (("a", "A"), ("b", "B")):
        pool.submit_scan(sid, *_scan(fl, 0, 0))
    pool.step()
    for sid, fl in (("a", "A"), ("b", "B")):
        pool.submit_scan(sid, *_scan(fl, 0, 1))
    before = _reads()
    pool.step()                               # tracking only
    plain = _delta(before)
    before = _reads()
    pool.close_session("a")
    pool.open_session("a", *_map("B"))        # a slot swap on a live pool
    assert _delta(before) == {}
    pool.submit_scan("a", *_scan("B", 4, 0))
    pool.submit_scan("b", *_scan("B", 0, 2))
    before = _reads()
    pool.step()                               # one relock lane
    assert _delta(before) == plain == {"host_reads.pool.readback": 1}


def test_swap_spans_and_relock_counters_are_recorded():
    pool = _pool_with({"a": "A", "b": "B"})
    names = ("pool.relock_ticks", "pool.relock_lanes", "pool.relock_overflow")
    c0 = trace.counters()
    with trace.recording():
        trace.clear()
        for sid, fl in (("a", "A"), ("b", "B")):
            pool.submit_scan(sid, *_scan(fl, 0, 0))
        pool.step()                           # two relock lanes
        pool.close_session("b")
        pool.open_session("b", *_map("A"))
        for sid in ("a", "b"):
            pool.submit_scan(sid, *_scan("A", 1, 0))
        pool.step()                           # one relock lane
        for sid in ("a", "b"):
            pool.submit_scan(sid, *_scan("A", 1, 1))
        pool.step()                           # none
        spans = trace.spans()
    c1 = trace.counters()
    assert [s.name for s in spans].count("pool.open_session") == 1
    assert [s.name for s in spans].count("pool.close_session") == 1
    ticks = [s.counts["relock_lanes"] for s in spans if s.name == "pool.step"]
    assert ticks == [2, 1, 0]
    assert [c1.get(n, 0) - c0.get(n, 0) for n in names] == [2, 3, 0]


def test_relock_overflow_is_counted():
    """A relock past the relock buffer itself is flagged and counted."""
    cfg = dataclasses.replace(CFG, shapes=dataclasses.replace(
        CFG.shapes, relock_candidates=K + 1))
    pool = SessionPool(2, CANVAS, cfg, dtype=np.float64, device="cpu")
    pool.open_session("a", *_map("A"))
    pool.submit_scan("a", *_scan("A", 0, 0))
    c0 = trace.counters().get("pool.relock_overflow", 0)
    out = pool.step()["a"]
    assert out["candidate_overflow"]
    assert trace.counters()["pool.relock_overflow"] - c0 == 1


def test_floor_relock_is_the_oracles_first_frame():
    """floors.relock picks what the oracle's matcher picks on a first
    frame, which enumerates every hypothesis with no cap."""
    dss, arts = lane_scenes()
    for i, floor in enumerate(FLOORS):
        ds = dss[i]
        for f in (0, 4, 9):
            scan = (ds.frames[f][:, 0], ds.frames[f][:, 1])
            got = _relock_of(floor, scan)
            fs = ordp.feature_scan(scan[0], scan[1], ds.param.resol,
                                   ds.param.ori_x, ds.param.ori_y)
            lidar = [float(c_round(np.float64(v))) for v in fs.lidar_pos[:2]]
            res = ofa.feature_association(
                fs.lines_info, arts[i][0], fs.scan_im_point, lidar,
                floors.SENTINEL, ofa.KALMAN_RESET_X, ofa.KALMAN_RESET_P,
                (0.0, 0.0, 0.0), arts[i][1])
            assert got.n_accepted == res.n_candidates
            np.testing.assert_allclose(got.pose, res.kalman_x[:3], rtol=0,
                                       atol=1e-9)
            np.testing.assert_allclose(got.score, res.score, rtol=1e-12)


def test_floor_table_stays():
    table = floors.FloorTable()
    table.board("r", "A")
    table.board("r", "B", 4)
    table.board("r", "A", 9)
    assert table.segments("r", 12) == [("A", 0, 4), ("B", 4, 9),
                                       ("A", 9, 12)]
    assert table.segments("r", 6) == [("A", 0, 4), ("B", 4, 6)]
    assert [table.floor_at("r", s) for s in (0, 3, 4, 8, 9, 20)] == \
        ["A", "A", "B", "B", "A", "A"]
    with pytest.raises(ValueError):
        table.board("r", "B", 9)
    with pytest.raises(KeyError):
        floors.FloorTable().floor_at("x", 0)
