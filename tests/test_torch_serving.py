"""The multi-robot serving pool: lsdtpu_torch.runtime.serving.SessionPool
against per-robot port OnlineLocalizer sessions and against the JAX
package's SessionPool on the same submissions, on synthetic scenes of
two map sizes (CPU) - the counterparts of tests/test_serving.py, whose
cases need the bundled dataset.

Tiers (f64): against OnlineLocalizer identical decisions and poses
within 1e-9 px (tests/test_serving.py:49; not bitwise: the pool's
batched UKF matmuls, tests/test_torch_batch_lanes.py); against the JAX
pool identical decisions and poses within 1e-6 px
(tests/test_torch_loop.py's tier), scores within rel 1e-7 (that pool's
field is rounded to float32).  An idle slot's state is untouched bit for bit."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from lsdtpu.runtime.serving import SessionPool as JaxPool
from lsdtpu_torch.config import DEFAULT
from lsdtpu_torch.runtime.online import OnlineLocalizer
from lsdtpu_torch.runtime.serving import SessionPool, make_pool_mesh

import torch_ranks
from torch_parity import LANES, lane_scenes

NF = 6
CANVAS = (200, 260)
# robot -> (scene of LANES, first frame): two maps, two start offsets
ROBOTS = {"a": (0, 0), "b": (1, 2)}


def _args(i):
    dss, arts = lane_scenes()
    p = dss[i].param
    return (arts[i][0], arts[i][1], p.resol, p.ori_x, p.ori_y)


def _scan(i, f):
    """(ranges, angles, odom) of frame f of scene i."""
    ds = lane_scenes()[0][i]
    return ds.frames[f][:, 0], ds.frames[f][:, 1], ds.odom[f + 1]


def _solo(i, frames, cfg=DEFAULT):
    loc = OnlineLocalizer(cfg, dtype=np.float64, device="cpu")
    loc.set_map_artifacts(*_args(i))
    return [loc.push_scan(*_scan(i, f)) for f in frames]


@functools.lru_cache(maxsize=None)
def _fleet(kind):
    """Per-tick results of both robots through a pool of capacity 3 (one
    slot never opened): kind "port" or "jax"."""
    if kind == "port":
        pool = SessionPool(3, CANVAS, dtype=np.float64, device="cpu")
    else:
        pool = JaxPool(3, CANVAS, dtype=np.float64)
    for sid, (i, _f0) in ROBOTS.items():
        pool.open_session(sid, *_args(i))
    ticks = []
    for t in range(NF):
        for sid, (i, f0) in ROBOTS.items():
            pool.submit_scan(sid, *_scan(i, f0 + t))
        ticks.append(pool.step())
    return {sid: {k: np.stack([np.asarray(r[sid][k]) for r in ticks])
                  for k in ticks[0][sid]} for sid in ROBOTS}


def _assert_same_decisions(got, want):
    np.testing.assert_array_equal(got["n_candidates"], want["n_candidates"])
    np.testing.assert_array_equal(np.isfinite(got["score"]),
                                  np.isfinite(want["score"]))


def test_pool_matches_online_sessions():
    got = _fleet("port")
    for sid, (i, f0) in ROBOTS.items():
        solo = _solo(i, range(f0, f0 + NF))
        want = {k: np.stack([o[k] for o in solo]) for k in solo[0]}
        _assert_same_decisions(got[sid], want)
        np.testing.assert_allclose(got[sid]["pose"], want["pose"], rtol=0,
                                   atol=1e-9)
        assert np.isfinite(got[sid]["score"]).all()


def test_pool_matches_jax_pool():
    got, want = _fleet("port"), _fleet("jax")
    for sid in ROBOTS:
        _assert_same_decisions(got[sid], want[sid])
        np.testing.assert_allclose(got[sid]["pose"], want[sid]["pose"],
                                   rtol=0, atol=1e-6)
        # the reference package's pool builds each slot's canvas in
        # float32 before the cast to the working type (its serving.py:157),
        # so its f64 scores carry the field rounded to float32; the
        # port's f64 pool keeps the f64 field, as make_map_context does
        fin = np.isfinite(want[sid]["score"])
        np.testing.assert_allclose(got[sid]["score"][fin],
                                   want[sid]["score"][fin], rtol=1e-7,
                                   atol=0)


def _slot_state(pool, slot):
    return {f.name: getattr(pool._states, f.name)[slot].clone()
            for f in dataclasses.fields(pool._states)}


def test_pool_join_leave_reused_slot_and_idle():
    pool = SessionPool(2, CANVAS, dtype=np.float64, device="cpu")
    pool.open_session("a", *_args(0))
    pool.open_session("b", *_args(1))
    with pytest.raises(RuntimeError, match="full"):
        pool.open_session("c", *_args(0))
    # b moves on one frame, then idles while a leaves and c takes a's slot
    pool.submit_scan("b", *_scan(1, 0))
    pool.submit_scan("a", *_scan(0, 0))
    pool.step()
    pool.close_session("a")
    with pytest.raises(ValueError, match="already open"):
        pool.open_session("b", *_args(1))
    pool.open_session("c", *_args(0))
    assert pool.n_active == 2 and pool._sessions["c"] == 0
    b_before = _slot_state(pool, pool._sessions["b"])
    # a fresh session in a reused slot starts from the reset state
    pool.submit_scan("c", *_scan(0, 3))
    res = pool.step()
    assert set(res) == {"c"}                    # idle "b" has no result
    want = _solo(0, [3])[0]
    np.testing.assert_allclose(res["c"]["pose"], want["pose"], rtol=0,
                               atol=1e-9)
    assert res["c"]["n_candidates"] == want["n_candidates"]
    b_after = _slot_state(pool, pool._sessions["b"])
    for k in b_before:                          # idle slot untouched
        torch.testing.assert_close(b_after[k], b_before[k], rtol=0, atol=0)
    assert pool.step() == {}                    # nothing submitted


def test_pool_overwrite_keeps_dropped_scans_motion():
    """A robot publishing faster than the pool ticks overwrites its
    pending scan; the filter still sees the odometry delta from the last
    PROCESSED scan (the single-session reference pushes only the frames
    the pool processes)."""
    want = _solo(0, range(0, NF, 2))
    pool = SessionPool(2, CANVAS, dtype=np.float64, device="cpu")
    pool.open_session("a", *_args(0))
    got = []
    for f in range(0, NF, 2):
        if f > 0:                 # an odd frame, overwritten before step
            pool.submit_scan("a", *_scan(0, f - 1))
        pool.submit_scan("a", *_scan(0, f))
        got.append(pool.step()["a"]["pose"])
    np.testing.assert_allclose(np.stack(got),
                               np.stack([o["pose"] for o in want]), rtol=0,
                               atol=1e-9)


def test_pool_caps_raise():
    pool = SessionPool(2, CANVAS, device="cpu")
    pool.open_session("a", *_args(0))
    with pytest.raises(ValueError, match="points_per_scan"):
        pool.submit_scan("a", np.ones(1081), np.zeros(1081))
    lines, cache, *geo = _args(0)
    with pytest.raises(ValueError, match="max_map_lines"):
        pool.open_session("b", np.zeros((300, 10)), cache, *geo)
    with pytest.raises(ValueError, match="exceeds canvas"):
        pool.open_session("b", lines, np.zeros((201, 10)), *geo)


def test_pool_honours_cache_dtype():
    cfg = dataclasses.replace(DEFAULT, match=dataclasses.replace(
        DEFAULT.match, cache_dtype="u16"))
    pool = SessionPool(2, CANVAS, cfg=cfg, device="cpu")
    assert pool._ctxs.cache.dtype == torch.uint16
    assert pool._coarse.dtype == torch.uint16
    pool.open_session("a", *_args(1))
    # the slot's canvas: its 180x240 map's codes, the top code (the cap)
    # outside it
    codes = pool._ctxs.cache.view(torch.int16)[0]
    assert (codes[180:] == -1).all() and (codes[:, 240:] == -1).all()
    assert (codes[:180, :240] != -1).any()
    pool.submit_scan("a", *_scan(1, 0))
    assert np.isfinite(pool.step()["a"]["score"])


def test_pool_mesh_and_device():
    """A pool over a one-rank mesh (this process) is the pool without one;
    the meshed pool over two ranks is test_meshed_pool_matches_pool."""
    pools = [SessionPool(2, CANVAS, dtype=np.float64, device="cpu",
                         mesh=mesh)
             for mesh in (None, make_pool_mesh(device="cpu"))]
    for pool in pools:
        pool.open_session("a", *_args(0))
        pool.submit_scan("a", *_scan(0, 0))
    got, want = (p.step()["a"] for p in pools[::-1])
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            SessionPool(2, CANVAS)
    assert tuple(LANES[0][1:3]) == CANVAS     # the larger of the two maps


def test_meshed_pool_matches_pool(tmp_path):
    """SessionPool(mesh=...) over two spawned gloo ranks (capacity 3
    padded to 4 slots, two a rank; the third robot on rank 1) against the
    same calls on a pool in this process: every rank returns every
    robot's outputs, poses within 1e-9 px and identical decisions."""
    robots = dict(ROBOTS, c=(0, 1))
    sessions = {sid: _args(i) for sid, (i, _f) in robots.items()}
    ticks = [{sid: _scan(i, f0 + t) for sid, (i, f0) in robots.items()}
             for t in range(4)]
    group = torch_ranks.Group(tmp_path, 2, [("pool", dict(
        capacity=3, canvas=CANVAS, sessions=sessions, ticks=ticks))])
    pool = SessionPool(3, CANVAS, dtype=np.float64, device="cpu")
    for sid, args in sessions.items():
        pool.open_session(sid, *args)
    want = []
    for tick in ticks:
        for sid, scan in tick.items():
            pool.submit_scan(sid, *scan)
        want.append(pool.step())
    for (got,) in group.results():
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w) == sorted(robots)
            for sid in w:
                _assert_same_decisions(g[sid], w[sid])
                np.testing.assert_allclose(g[sid]["pose"], w[sid]["pose"],
                                           rtol=0, atol=1e-9)
