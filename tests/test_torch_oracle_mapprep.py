"""The numpy oracle's map prep where the port's entry points take it, on
the CPU: prepare_map_cached(backend="oracle") returns the oracle's
arrays cast to the asked dtype; OnlineLocalizer(mapprep="oracle") in
tracking and legacy modes equals the JAX package's
OnlineLocalizer(use_tpu_mapprep=False) over f64 pushes (poses within
1e-9 px, scores within 1e-12 relative: the legacy tier of
tests/test_torch_online.py); LsdRosAdapter passes the switch through."""

import os
from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch

from lsdtpu.oracle import driver as odrv
from lsdtpu.runtime import online as jonline
from lsdtpu.runtime import ros_node as jros
from lsdtpu_torch.runtime import online as tonline
from lsdtpu_torch.runtime import ros_node as tros
from lsdtpu_torch.runtime.artifacts import prepare_map_cached

from torch_parity import grid_payload, np_, ros_scan, scene, INC

PUSHES = 4


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_prepare_map_cached_oracle(tmp_path, dtype):
    """Cold and warm (the cache file) the oracle's arrays in ``dtype``,
    under a key of its own beside the port's wave artifacts."""
    ds, art = scene(2)
    args = (ds.map_value, ds.param.resol)
    for _ in range(2):      # cold, then from the cache
        lines, cache = prepare_map_cached(*args, cache_dir=str(tmp_path),
                                          dtype=dtype, device="cpu",
                                          backend="oracle")
        assert lines.dtype == cache.dtype == dtype
        assert torch.equal(lines, torch.from_numpy(art.lines_info).to(dtype))
        assert torch.equal(cache, torch.from_numpy(art.map_cache).to(dtype))
    # growth does not apply to the oracle: the same file
    prepare_map_cached(*args, cache_dir=str(tmp_path), dtype=dtype,
                       device="cpu", backend="oracle", growth="fifo")
    assert len(os.listdir(tmp_path)) == 1
    with pytest.raises(ValueError, match="backend"):
        prepare_map_cached(*args, cache_dir=str(tmp_path), device="cpu",
                           backend="tpu")


@pytest.mark.parametrize("mode,z", [("tracking", 1.0), ("legacy", 2.0)])
def test_online_oracle_mapprep_matches_jax(mode, z):
    ds, _ = scene(0)
    p = ds.param
    j = jonline.OnlineLocalizer(mode=mode, dtype=np.float64,
                                use_tpu_mapprep=False)
    t = tonline.OnlineLocalizer(mode=mode, dtype=np.float64, device="cpu",
                                mapprep="oracle")
    n = t.set_map(ds.map_value, p.resol, p.ori_x, p.ori_y)
    assert n == j.set_map(ds.map_value, p.resol, p.ori_x, p.ori_y) > 5
    want = odrv.prepare_map(ds.map_value, p.resol, z_occ_max_dis=z)
    assert np.array_equal(np_(t.ctx.lines[:n]), want.lines_info)
    assert np.array_equal(np_(t.ctx.cache), want.map_cache)
    for f in range(PUSHES):
        fr = ds.frames[f]
        got = t.push_scan(fr[:, 0], fr[:, 1], ds.odom[f + 1])
        exp = j.push_scan(fr[:, 0], fr[:, 1], ds.odom[f + 1])
        assert set(got) == set(exp)
        assert int(got["n_candidates"]) == int(exp["n_candidates"]) > 0
        for k in ("pose", "pose_world"):
            np.testing.assert_allclose(got[k], exp[k], rtol=0, atol=1e-9,
                                       err_msg=k)
        np.testing.assert_allclose(got["score"], exp["score"], rtol=1e-12)


def test_online_mapprep_rejects_unknown():
    with pytest.raises(ValueError, match="mapprep"):
        tonline.OnlineLocalizer(device="cpu", mapprep="tpu")


def test_ros_adapter_passes_mapprep():
    """/map through both adapters with the oracle's map prep: the same
    lines and z = 2 m field, then the same legacy poses."""
    ds, _ = scene(1)
    p = ds.param
    h, w = ds.map_value.shape
    meta = NS(width=w, height=h, resolution=p.resol,
              origin=NS(position=NS(x=p.ori_x, y=p.ori_y)))
    grid = NS(data=grid_payload(ds.map_value))
    j = jros.LsdRosAdapter(use_tpu_mapprep=False, dtype=np.float64)
    t = tros.LsdRosAdapter(dtype=np.float64, device="cpu", mapprep="oracle")
    assert t.loc.mapprep == "oracle"
    assert tros.LsdRosAdapter(device="cpu").loc.mapprep == "torch"
    for ad in (j, t):
        ad.on_map_metadata(meta)
    n = t.on_map(grid)
    assert n == j.on_map(grid) > 5
    assert np.array_equal(np_(t.loc.ctx.lines[:n]),
                          np.asarray(j.loc.ctx.lines)[:n])
    assert np.array_equal(np_(t.loc.ctx.cache), np.asarray(j.loc.ctx.cache))
    assert float(t.loc.ctx.cache.max()) == 2.0
    for f in (0, 4):
        msg = NS(ranges=ros_scan(ds.frames[f]), angle_min=0.0,
                 angle_increment=INC)
        got, exp = t.on_scan(msg), j.on_scan(msg)
        np.testing.assert_allclose(got["pose"], exp["pose"], rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(got["score"], exp["score"], rtol=1e-12)
