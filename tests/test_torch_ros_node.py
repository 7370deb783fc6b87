"""The ROS adapter: lsdtpu_torch.runtime.ros_node.LsdRosAdapter against
lsdtpu.runtime.ros_node.LsdRosAdapter over fake (duck-typed) messages on
test_fuzz_parity's synthetic scenes (CPU; no ROS install needed;
reference wiring LSD/main_on_linux.cpp:33-134).

Tiers: the guards and drops identical; with both adapters on the same
artifacts, legacy poses within 1e-9 px (f64) and tracking poses within
1e-6 px (the rollout tier); /map from a grid at the wave tier's
structural thresholds."""

import math
from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch

from lsdtpu.oracle import lsd as olsd
from lsdtpu.runtime import ros_node as jros
from lsdtpu_torch.runtime import ros_node as tros

from torch_parity import (INC, assert_structural, grid_payload, np_,
                          ros_scan, scene)


def _grid_msgs(ds):
    """(/map_metadata, /map) messages of a dataset map."""
    h, w = ds.map_value.shape
    p = ds.param
    meta = NS(width=w, height=h, resolution=p.resol,
              origin=NS(position=NS(x=p.ori_x, y=p.ori_y)))
    return meta, NS(data=grid_payload(ds.map_value))


def _scan_msg(frame, holes=()):
    """A synthetic frame as a LaserScan on the uniform 360-ray grid,
    INF where the ray hit nothing and at the indices ``holes``."""
    r = ros_scan(frame)
    r[list(holes)] = np.inf
    return NS(ranges=r, angle_min=0.0, angle_increment=INC)


def _odom_msg(x, y, yaw):
    return NS(pose=NS(pose=NS(
        position=NS(x=x, y=y),
        orientation=NS(x=0.0, y=0.0, z=math.sin(yaw / 2),
                       w=math.cos(yaw / 2)))))


def _adapters(mode, seed=0):
    """(JAX, port) adapters in f64 on the same artifacts (the oracle's
    lines; the z = 2 m field in legacy mode)."""
    ds, art = scene(seed)
    p = ds.param
    cache = art.map_cache if mode == "tracking" else \
        olsd.create_map_cache(ds.map_value, p.resol, 2.0)
    j = jros.LsdRosAdapter(mode=mode, use_tpu_mapprep=False,
                           dtype=np.float64)
    t = tros.LsdRosAdapter(mode=mode, dtype=np.float64, device="cpu")
    for ad in (j, t):
        ad.loc.set_map_artifacts(art.lines_info, cache, p.resol, p.ori_x,
                                 p.ori_y)
    return j, t


def test_map_guard_order_and_scan_drop():
    """Scans before the map are dropped (isMapReady guard); /map before
    /map_metadata is dropped (oriMapCol <= 0 guard); the map then builds
    on the adapter's device with the ROS node's z = 2 m cap."""
    ds, art = scene(1)
    meta, grid = _grid_msgs(ds)
    ad = tros.LsdRosAdapter(dtype=np.float64, device="cpu")
    assert ad.mode == "legacy"
    assert ad.on_scan(_scan_msg(ds.frames[0])) is None
    assert ad.on_map(grid) is None
    assert not ad.loc.is_map_ready
    ad.on_map_metadata(meta)
    n = ad.on_map(grid)
    assert n == ad.n_map_lines and n > 5 and ad.loc.is_map_ready
    assert_structural(np_(ad.loc.ctx.lines[:n]), art.lines_info)
    assert float(ad.loc.ctx.cache.max()) == 2.0
    out = ad.on_scan(_scan_msg(ds.frames[0]))
    assert np.isfinite(out["score"]) and out["pose_world"].shape == (3,)


def test_legacy_adapter_matches_jax_adapter():
    """Scans through both adapters (angles reconstructed incrementally,
    INF readings dropped, main_on_linux.cpp:54-64) on the same
    artifacts; and through the port's own legacy localizer on the
    compacted scan."""
    ds, _ = scene(0)
    j, t = _adapters("legacy")
    for f in (0, 3, 8):
        msg = _scan_msg(ds.frames[f], holes=range(0, 360, 17))
        got, want = t.on_scan(msg), j.on_scan(msg)
        assert int(got["n_candidates"]) == int(want["n_candidates"])
        for k in ("pose", "pose_world"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9,
                                       err_msg=k)
        np.testing.assert_allclose(got["score"], want["score"], rtol=1e-12)
        keep = np.isfinite(msg.ranges)
        angles = np.arange(360) * INC
        direct = t.loc.push_scan(msg.ranges[keep], angles[keep])
        for k in got:
            np.testing.assert_array_equal(got[k], direct[k], err_msg=k)


def test_all_inf_scan_dropped():
    j, t = _adapters("legacy")
    msg = NS(ranges=np.full(360, np.inf), angle_min=0.0,
             angle_increment=math.tau / 360)
    assert t.on_scan(msg) is None and j.on_scan(msg) is None


def test_tracking_mode_consumes_odometry():
    """mode='tracking': /odom quaternions feed the UKF's odometry deltas,
    the same yaw and the same poses as the JAX adapter's."""
    ds, _ = scene(0)
    j, t = _adapters("tracking")
    for f in range(4):
        od = ds.odom[f + 1]
        for ad in (j, t):
            ad.on_odom(_odom_msg(od[0], od[1], 0.1 * f))
        np.testing.assert_array_equal(t._odom, j._odom)
        np.testing.assert_allclose(t._odom[2], 0.1 * f, rtol=0, atol=1e-15)
        msg = _scan_msg(ds.frames[f])
        got, want = t.on_scan(msg), j.on_scan(msg)
        assert int(got["n_candidates"]) == int(want["n_candidates"])
        np.testing.assert_allclose(got["pose"], want["pose"], rtol=0,
                                   atol=1e-6)
    assert np.isfinite(got["score"])


def test_main_without_rclpy_exits_cleanly(capsys):
    """No ROS install: the entry point reports and exits 2."""
    assert tros.main([]) == 2
    err = capsys.readouterr().err
    assert "rclpy" in err and "lsdtpu-torch-ros-node" in err


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert tros.LsdRosAdapter().loc.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        tros.LsdRosAdapter()
