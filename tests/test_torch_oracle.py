"""The port's copy of the numpy oracle (lsdtpu_torch.oracle) against
lsdtpu.oracle, bit for bit (np.array_equal and ==), on synth_map seeds
0-2 at test size (200x260, 10 frames): the distance field, the LSD
lines and lineIm, the scan featurization, the matcher + UKF step, the
legacy matcher and the whole offline driver."""

import dataclasses
import functools

import numpy as np
import pytest

from lsdtpu.oracle import driver as jdrv
from lsdtpu.oracle import fa as jfa
from lsdtpu.oracle import legacy_fa as jlegacy
from lsdtpu.oracle import lsd as jlsd
from lsdtpu.oracle import rdp as jrdp
from lsdtpu_torch.io import synth
from lsdtpu_torch.oracle import driver as tdrv
from lsdtpu_torch.oracle import fa as tfa
from lsdtpu_torch.oracle import legacy_fa as tlegacy
from lsdtpu_torch.oracle import lsd as tlsd
from lsdtpu_torch.oracle import rdp as trdp

SEEDS = [0, 1, 2]
FRAMES = 10


@functools.lru_cache(maxsize=None)
def _scene(seed):
    """(Dataset, the reference oracle's MapArtifacts) of one seed."""
    ds = synth.synth_dataset(seed, F=FRAMES).dataset
    return ds, jdrv.prepare_map(ds.map_value, ds.param.resol)


def _features(seed, f, mod):
    ds, _ = _scene(seed)
    p = ds.param
    fr = ds.frames[f]
    return mod.feature_scan(fr[:, 0], fr[:, 1], p.resol, p.ori_x, p.ori_y)


def _same_dataclass(a, b):
    for k in dataclasses.fields(a):
        x, y = getattr(a, k.name), getattr(b, k.name)
        assert type(x) is type(y), k.name
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y,
                                                         equal_nan=True), \
                k.name
        else:
            assert x == y or (x != x and y != y), k.name


@pytest.mark.parametrize("seed", SEEDS)
def test_create_map_cache(seed):
    ds, _ = _scene(seed)
    for z in (1.0, 2.0):
        got = tlsd.create_map_cache(ds.map_value.copy(), ds.param.resol, z)
        want = jlsd.create_map_cache(ds.map_value.copy(), ds.param.resol, z)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_line_segment_detector(seed):
    ds, _ = _scene(seed)
    got = tlsd.line_segment_detector(ds.map_value.copy())
    want = jlsd.line_segment_detector(ds.map_value.copy())
    assert len(want.lines_info) > 0
    _same_dataclass(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_feature_scan(seed):
    for f in range(0, FRAMES, 3):
        got, want = _features(seed, f, trdp), _features(seed, f, jrdp)
        assert len(want.lines_info) > 0
        _same_dataclass(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_feature_association(seed):
    """A relock frame (reset state: the best candidate) and then the next
    frame through fusion and the UKF, from the same state on both."""
    ds, art = _scene(seed)
    res = {}
    for name, fa, rdp in (("port", tfa, trdp), ("ref", jfa, jrdp)):
        x, P = fa.KALMAN_RESET_X.copy(), fa.KALMAN_RESET_P.copy()
        last, steps = (-1.0, -1.0, 0.0), []
        for f, scan_pose in ((0, (0.0, 0.0, 0.0)), (1, (1.5, -0.5, 0.25))):
            fs = _features(seed, f, rdp)
            lidar = (float(np.floor(fs.lidar_pos[0] + 0.5)),
                     float(np.floor(fs.lidar_pos[1] + 0.5)))
            r = fa.feature_association(fs.lines_info, art.lines_info,
                                       fs.scan_im_point, lidar, last, x, P,
                                       scan_pose, art.map_cache)
            x, P, last = r.kalman_x, r.kalman_P, tuple(r.kalman_x[:3])
            steps.append(r)
        res[name] = steps
    for got, want in zip(res["port"], res["ref"]):
        assert want.n_candidates > 0
        _same_dataclass(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_feature_association_legacy(seed):
    ds, art = _scene(seed)
    p = ds.param
    cache2 = jlsd.create_map_cache(ds.map_value.copy(), p.resol, 2.0)
    fr = ds.frames[0]
    out = {}
    for name, legacy, rdp in (("port", tlegacy, trdp), ("ref", jlegacy,
                                                         jrdp)):
        fs = _features(seed, 0, rdp)
        out[name] = legacy.feature_association_legacy(
            fs.lines_info, art.lines_info, np.asarray(fs.lidar_pos, float),
            cache2, fr[:, 0], fr[:, 1], p.resol)
    (pose, cands), (wpose, wcands) = out["port"], out["ref"]
    assert wpose is not None and len(wcands) > 0
    assert np.array_equal(pose, wpose)
    assert len(cands) == len(wcands)
    for a, b in zip(cands, wcands):
        _same_dataclass(a, b)


@pytest.mark.parametrize("seed", SEEDS)
def test_run_sequence(seed):
    ds, art = _scene(seed)
    got = tdrv.run_sequence(ds, tdrv.MapArtifacts(
        map_cache=art.map_cache, lines_info=art.lines_info,
        line_im=art.line_im))
    want = jdrv.run_sequence(ds, art)
    assert got.poses.shape == want.poses.shape == (FRAMES, 3)
    assert np.array_equal(got.poses, want.poses, equal_nan=True)
    assert len(got.records) == len(want.records)
    for a, b in zip(got.records, want.records):
        _same_dataclass(a, b)
    # and with its own map prep (the driver's prepare_map)
    own = tdrv.run_sequence(ds, max_frames=4)
    assert np.array_equal(own.poses, want.poses[:4], equal_nan=True)


@pytest.mark.parametrize("tiny", [0.0, 1e-170, 1e-300])
def test_fuse_candidates_underflowing_square(tiny):
    """A positive score whose square underflows to 0.0 weighs +inf, as
    the C++ reference's 1 / (score * score) does (myFA.cpp:161): the
    fused pose is NaN and the fused score 0.0, as for a score of 0.0."""
    cands = [tfa.Candidate(1.0, 2.0, 0.5, tiny),
             tfa.Candidate(3.0, 4.0, 0.1, 0.5)]
    got = tfa.fuse_candidates(cands)
    assert np.isnan([got.x, got.y, got.ang]).all()
    assert got.score == 0.0
    # a subnormal square that is not zero: 1 / 1e-320 overflows to +inf,
    # the same result
    sub = tfa.fuse_candidates([tfa.Candidate(1.0, 2.0, 0.5, 1e-160),
                               tfa.Candidate(3.0, 4.0, 0.1, 0.5)])
    assert np.isnan([sub.x, sub.y, sub.ang]).all() and sub.score == 0.0
