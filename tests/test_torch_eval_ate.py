"""Trajectory metrics: lsdtpu_torch.eval.ate against lsdtpu.eval.ate on
the same seeded trajectories (keyframe indexing, interpolation, the
rigid SE(2)-aligned ATE), within 1e-12."""

import numpy as np
import pytest

from lsdtpu.eval import ate as jate
from lsdtpu_torch.eval import ate as tate

TOL = 1e-12


def _rot(deg):
    r = np.deg2rad(deg)
    return np.array([[np.cos(r), -np.sin(r)], [np.sin(r), np.cos(r)]])


def _assert_same(got, want):
    assert got.n == want.n
    for k in ("rmse", "mean", "median", "max"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=0, atol=TOL, err_msg=k)
    np.testing.assert_allclose(got.errors, want.errors, rtol=0, atol=TOL)


def _trajectory(seed, F=60, noise=0.2, offset=(0.0, 0.0)):
    """(poses_px, gt, recorded, resol, ox, oy): a noisy estimate of a
    curved ground truth, shifted by a constant offset."""
    resol, ox, oy = 0.05, -2.0, -3.0
    rng = np.random.default_rng(seed)
    gt = np.stack([np.linspace(0, 6, F), np.sin(np.linspace(0, 3, F))], 1)
    est = gt + np.asarray(offset) + rng.normal(scale=noise, size=(F, 2))
    poses = np.zeros((F, 3))
    poses[:, 0] = (est[:, 0] - ox) / resol
    poses[:, 1] = (est[:, 1] - oy) / resol
    return poses, gt, np.arange(1, F + 1), resol, ox, oy


def test_umeyama_recovers_rigid_transform():
    rng = np.random.default_rng(3)
    src = rng.normal(size=(40, 2)) * 5
    R_true = _rot(37.0)
    t_true = np.array([1.25, -0.75])
    dst = src @ R_true.T + t_true
    R, t = tate.umeyama_se2(src, dst)
    np.testing.assert_allclose(R, R_true, atol=1e-10)
    np.testing.assert_allclose(t, t_true, atol=1e-10)
    assert np.isclose(np.linalg.det(R), 1.0)
    jR, jt = jate.umeyama_se2(src, dst)
    np.testing.assert_allclose(R, jR, rtol=0, atol=TOL)
    np.testing.assert_allclose(t, jt, rtol=0, atol=TOL)


@pytest.mark.parametrize("fn", ["keyframe_ate", "interpolated_ate",
                                "aligned_keyframe_ate"])
@pytest.mark.parametrize("seed,offset", [(0, (0.0, 0.0)), (1, (0.85, 1.93))])
def test_metrics_match_jax(fn, seed, offset):
    args = _trajectory(seed, offset=offset)
    _assert_same(getattr(tate, fn)(*args), getattr(jate, fn)(*args))


def test_aligned_ate_removes_constant_offset():
    args = _trajectory(0, F=50, noise=0.0, offset=(0.85, 1.93))
    raw = tate.keyframe_ate(*args)
    al = tate.aligned_keyframe_ate(*args)
    np.testing.assert_allclose(raw.rmse, np.hypot(0.85, 1.93), atol=1e-9)
    assert al.rmse < 1e-9


def test_aligned_ate_keeps_shape_error():
    args = _trajectory(0, noise=0.2)
    al = tate.aligned_keyframe_ate(*args)
    assert 0.05 < al.rmse < 0.4


def test_keyframe_subset_and_edges_match_jax():
    """Sparse, out-of-range and unsorted keyframe lists, and a lost pose:
    both packages skip and fall back the same way."""
    poses, gt, _, resol, ox, oy = _trajectory(2, F=30)
    poses[4] = np.nan
    for rec in (np.array([3, 5, 10, 20, 31, 0]), np.array([10, 4, 20]),
                np.array([40, 50]), np.array([5, 9])):
        g = gt[:len(rec)]
        for fn in ("keyframe_ate", "interpolated_ate",
                   "aligned_keyframe_ate"):
            got = getattr(tate, fn)(poses, g, rec, resol, ox, oy)
            want = getattr(jate, fn)(poses, g, rec, resol, ox, oy)
            assert got.n == want.n, (fn, rec)
            np.testing.assert_array_equal(np.isnan(got.errors),
                                          np.isnan(want.errors))
            np.testing.assert_allclose(got.errors, want.errors, rtol=0,
                                       atol=TOL)


def test_aligned_ate_skips_nonfinite_poses():
    F = 10
    gt = np.stack([np.arange(F, dtype=float), np.zeros(F)], 1)
    poses = np.zeros((F, 3))
    poses[:, 0] = gt[:, 0] / 0.05
    poses[2] = np.nan
    rec = np.arange(1, F + 1)
    al = tate.aligned_keyframe_ate(poses, gt, rec, 0.05, 0.0, 0.0)
    assert np.isfinite(al.rmse) and al.n == F - 1
    _assert_same(al, jate.aligned_keyframe_ate(poses, gt, rec, 0.05, 0.0,
                                               0.0))
