"""The streaming entry point: lsdtpu_torch.runtime.online.OnlineLocalizer
against lsdtpu.runtime.online.OnlineLocalizer and against the port's own
run_sequence, on test_fuzz_parity's synthetic scenes (CPU).

Tiers: tracking mode f64 against the JAX localizer on the same
artifacts - identical decisions (n_candidates, overflow, tracked and
NaN pattern), poses within 1e-6 px (the rollout tier of
tests/test_torch_loop.py); against the port's run_sequence on the same
frames - bitwise.  Legacy mode f64 against the JAX legacy localizer and
the numpy oracle - poses within 1e-9 px, scores within 1e-12 relative.
set_map from a grid is held at the wave tier's structural thresholds
(the JAX package's wave lines differ from the port's: ROADMAP Queue 3,
"the ulp flip")."""

import dataclasses

import numpy as np
import pytest
import torch

from lsdtpu.config import DEFAULT as JDEFAULT
from lsdtpu.eval import ate as jate
from lsdtpu.oracle import legacy_fa as olegacy
from lsdtpu.oracle import lsd as olsd
from lsdtpu.oracle import rdp as ordp
from lsdtpu.runtime import online as jonline
from lsdtpu_torch.config import DEFAULT
from lsdtpu_torch.eval import ate as tate
from lsdtpu_torch.runtime import loop as tloop
from lsdtpu_torch.runtime import online as tonline

from torch_parity import (INC, assert_structural, grid_payload, localizers,
                          np_, ros_scan, scene)


def _push_all(loc, ds, laser=False):
    outs = []
    for f, fr in enumerate(ds.frames):
        if laser:
            outs.append(loc.push_laser_scan(ros_scan(fr), 0.0, INC,
                                            ds.odom[f + 1]))
        else:
            outs.append(loc.push_scan(fr[:, 0], fr[:, 1], ds.odom[f + 1]))
    return {k: np.stack([o[k] for o in outs]) for k in outs[0]}


@pytest.mark.parametrize("seed", [0, 101])
def test_tracking_matches_jax(seed):
    ds, _ = scene(seed)
    j, t = localizers(seed)
    want = _push_all(j, ds)
    got = _push_all(t, ds)
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
    for k in ("n_candidates", "candidate_overflow", "n_scan_lines",
              "coasting", "relock_deferred"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    fin = np.isfinite(want["score"])
    np.testing.assert_array_equal(np.isfinite(got["score"]), fin)
    np.testing.assert_allclose(got["score"][fin], want["score"][fin],
                               rtol=0, atol=1e-9)
    for k, tol in (("pose", 1e-6), ("pose_world", 1e-6 * ds.param.resol)):
        nan = np.isnan(want[k]).any(1)
        np.testing.assert_array_equal(np.isnan(got[k]).any(1), nan)
        np.testing.assert_allclose(got[k][~nan], want[k][~nan], rtol=0,
                                   atol=tol, err_msg=k)
    if seed == 101:          # the perfect-score NaN chain is exercised
        assert np.isnan(want["pose"]).any()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("laser", [False, True])
def test_tracking_equals_run_sequence_bitwise(dtype, laser):
    """Streaming = rollout: each push gives what run_sequence gives on
    the same frames (the ROS-shaped path's compacted ones), bit for
    bit; the first frame's odometry is its own anchor."""
    ds, _ = scene(1)
    _, t = localizers(1, dtype=dtype)
    got = _push_all(t, ds, laser=laser)
    fr = tloop.stack_frames(ds, dtype=dtype)
    if laser:
        for f, frame in enumerate(ds.frames):
            r, a = tonline.laser_scan_to_polar(ros_scan(frame), 0.0, INC)
            fr["ranges"][f, :len(r)] = r
            fr["angles"][f, :len(a)] = a
        assert np.array_equal(fr["n"], [len(x) for x in ds.frames])
    fr["odom_prev"][0] = fr["odom_cur"][0]
    want = tloop.run_sequence(fr, t.ctx, t.cfg, device="cpu")
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np_(v), err_msg=k)
    xy = got["pose"][:, :2] * np.asarray(t._world[0]) + \
        np.asarray(t._world[1:])
    np.testing.assert_array_equal(got["pose_world"][:, :2], xy)


def test_legacy_matches_jax_and_oracle():
    ds, _ = scene(0)
    p = ds.param
    j, t = localizers(0, mode="legacy")
    want = _push_all(j, ds)
    got = _push_all(t, ds)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["n_candidates"], want["n_candidates"])
    np.testing.assert_array_equal(got["candidate_overflow"],
                                  want["candidate_overflow"])
    np.testing.assert_allclose(got["score"], want["score"], rtol=1e-12)
    for k in ("pose", "pose_world"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9,
                                   err_msg=k)
    cache = olsd.create_map_cache(ds.map_value, p.resol, 2.0)
    for f in (0, 6):
        r, a = (ds.frames[f][:, i].astype(np.float64) for i in (0, 1))
        fs = ordp.feature_scan(r, a, p.resol, p.ori_x, p.ori_y)
        pose_o, _ = olegacy.feature_association_legacy(
            fs.lines_info, scene(0)[1].lines_info,
            np.array(fs.lidar_pos, np.float64), cache, r, a, p.resol)
        np.testing.assert_allclose(got["pose"][f], pose_o, rtol=0, atol=1e-9)


def test_legacy_overflow_flag_matches_jax():
    ds, _ = scene(1)
    kw = dict(max_candidates=4)
    cfgs = (dataclasses.replace(JDEFAULT, shapes=dataclasses.replace(
        JDEFAULT.shapes, **kw)),
        dataclasses.replace(DEFAULT, shapes=dataclasses.replace(
            DEFAULT.shapes, **kw)))
    j, t = localizers(1, mode="legacy", cfgs=cfgs)
    fr = ds.frames[0]
    want = j.push_scan(fr[:, 0], fr[:, 1])
    got = t.push_scan(fr[:, 0], fr[:, 1])
    assert bool(got["candidate_overflow"]) and bool(
        want["candidate_overflow"])
    np.testing.assert_allclose(got["pose"], want["pose"], rtol=0, atol=1e-9)


def test_guards():
    ds, art = scene(0)
    p = ds.param
    with pytest.raises(ValueError, match="mode"):
        tonline.OnlineLocalizer(mode="fast", device="cpu")
    loc = tonline.OnlineLocalizer(dtype=np.float64, device="cpu")
    assert not loc.is_map_ready
    with pytest.raises(RuntimeError, match="isMapReady"):
        loc.push_scan(np.ones(4), np.zeros(4))
    loc.set_map_artifacts(art.lines_info, art.map_cache, p.resol, p.ori_x,
                          p.ori_y)
    assert loc.is_map_ready
    with pytest.raises(ValueError, match="points_per_scan"):
        loc.push_scan(np.ones(361), np.zeros(361))
    u16 = dataclasses.replace(DEFAULT, match=dataclasses.replace(
        DEFAULT.match, cache_dtype="u16"))
    leg = tonline.OnlineLocalizer(u16, mode="legacy", device="cpu")
    with pytest.raises(ValueError, match="cache_dtype"):
        leg.set_map_artifacts(art.lines_info, art.map_cache, p.resol,
                              p.ori_x, p.ori_y)
    # a tracking session takes the compressed field
    trk = tonline.OnlineLocalizer(u16, device="cpu")
    trk.set_map_artifacts(art.lines_info, art.map_cache, p.resol, p.ori_x,
                          p.ori_y)
    assert trk.ctx.cache.dtype == torch.uint16


def test_ros_conversions_equal_jax():
    rng = np.random.default_rng(5)
    data = rng.choice(np.array([-1, 0, 100, 42, 7], np.int8), 12 * 7)
    got = tonline.occupancy_grid_to_map_value(data, 12, 7)
    want = jonline.occupancy_grid_to_map_value(data, 12, 7)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tonline.occupancy_grid_to_map_value(np.array([-1, 0, 100, 42],
                                                     np.int8), 2, 2),
        [[0, 255], [1, 1]])
    ranges = rng.uniform(0.1, 9.0, 50)
    ranges[[3, 17, 18, 49]] = np.inf
    got = tonline.laser_scan_to_polar(ranges, -1.2, 0.05)
    want = jonline.laser_scan_to_polar(ranges, -1.2, 0.05)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (46,)


@pytest.mark.parametrize("mode,z", [("tracking", 1.0), ("legacy", 2.0)])
def test_set_map_occupancy_grid(mode, z):
    """Map prep from the grid on the localizer's device (f32 wave): the
    oracle's lines at the structural tier, its field (cap z) within the
    f32 rounding with the same at-cap cells; then the localizer runs."""
    ds, art = scene(2)
    p = ds.param
    H, W = ds.map_value.shape
    loc = tonline.OnlineLocalizer(mode=mode, dtype=np.float64, device="cpu")
    n = loc.set_map_occupancy_grid(grid_payload(ds.map_value), W, H,
                                   p.resol, p.ori_x, p.ori_y)
    assert int(loc.ctx.lines_mask.sum()) == n
    assert_structural(np_(loc.ctx.lines[:n]), art.lines_info)
    want = olsd.create_map_cache(ds.map_value, p.resol, z)
    got = np_(loc.ctx.cache)
    np.testing.assert_array_equal(got == z, want == z)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)
    out = loc.push_scan(ds.frames[0][:, 0], ds.frames[0][:, 1],
                        ds.odom[1])
    assert np.isfinite(out["score"]) and np.isfinite(out["pose"]).all()


def test_ate_equals_jax():
    """pose_world's conversion and the keyframe ATE (keyframes past the
    trajectory skipped, none left -> NaN) equal the JAX package's."""
    rng = np.random.default_rng(9)
    poses = rng.uniform(0, 400, (30, 3))
    truth = rng.uniform(-5, 5, (6, 2))
    rec = np.array([1, 4, 9, 17, 30, 31])
    args = (0.05, -2.0, -1.5)
    np.testing.assert_array_equal(tate.pixel_to_world(poses, *args),
                                  jate.pixel_to_world(poses, *args))
    for got, want in ((tate.keyframe_ate(poses, truth, rec, *args),
                       jate.keyframe_ate(poses, truth, rec, *args)),
                      (tate.keyframe_ate(poses, truth[:1], rec[5:], *args),
                       jate.keyframe_ate(poses, truth[:1], rec[5:], *args))):
        assert got.n == want.n
        np.testing.assert_array_equal(got.errors, want.errors)
        np.testing.assert_array_equal(
            [got.rmse, got.mean, got.median, got.max],
            [want.rmse, want.mean, want.median, want.max])
    assert got.n == 0 and np.isnan(got.rmse)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert tonline.OnlineLocalizer().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        tonline.OnlineLocalizer()
    with pytest.raises(RuntimeError, match="cuda"):
        tonline.OnlineLocalizer(mode="legacy")
