"""Trajectory evaluation: ATE vs the recorded ground-truth keyframes
(the port's own copy of lsdtpu/eval/ate.py; numpy only).

The reference ships a `samplePos` helper that linearly interpolates the
ground-truth keyframes over odometry frame indices (reference:
ROS/lsd/src/FeatureAssociation.cpp:301-366) but never calls it; it also
always sweeps x (or y) from low to high regardless of travel direction,
which reverses the interpolated trajectory on backward strokes.  Here:

  * keyframe ATE: exact, no interpolation - the pose error at the frames
    listed in recored_Odom.txt (1-based indices);
  * interpolated ATE: direction-correct linear interpolation between
    keyframes (the sane version of samplePos);
  * aligned keyframe ATE: keyframe ATE after a rigid SE(2) alignment
    (umeyama_se2, the TUM convention).

Estimated poses are in map pixel coordinates, ground truth in meters;
the conversion follows the legacy matcher: world = px * mapResol +
mapOri (FeatureAssociation.cpp:126-127).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ATEResult:
    rmse: float
    mean: float
    median: float
    max: float
    n: int
    errors: np.ndarray


def pixel_to_world(poses_px: np.ndarray, resol: float, ori_x: float,
                   ori_y: float) -> np.ndarray:
    """(F, >=2) pixel poses -> (F, 2) world meters."""
    out = np.asarray(poses_px, dtype=np.float64)[:, :2].copy()
    out[:, 0] = out[:, 0] * resol + ori_x
    out[:, 1] = out[:, 1] * resol + ori_y
    return out


def keyframe_ate(poses_px: np.ndarray, real_pos: np.ndarray,
                 recorded_odom: np.ndarray, resol: float, ori_x: float,
                 ori_y: float) -> ATEResult:
    """ATE at ground-truth keyframes.

    poses_px: (F, >=2) estimated pixel poses for frames 1..F;
    recorded_odom: 1-based frame indices of the keyframes.
    Keyframes beyond the estimated range are skipped.
    """
    world = pixel_to_world(poses_px, resol, ori_x, ori_y)
    idx = np.asarray(recorded_odom, dtype=np.int64) - 1
    keep = (idx >= 0) & (idx < world.shape[0])
    idx = idx[keep]
    gt = np.asarray(real_pos, dtype=np.float64)[keep]
    err = np.linalg.norm(world[idx] - gt, axis=1)
    return _summarize(err)


def interpolated_ate(poses_px: np.ndarray, real_pos: np.ndarray,
                     recorded_odom: np.ndarray, resol: float, ori_x: float,
                     ori_y: float) -> ATEResult:
    """ATE against per-frame linearly interpolated ground truth over
    the keyframe span."""
    world = pixel_to_world(poses_px, resol, ori_x, ori_y)
    rec = np.asarray(recorded_odom, dtype=np.int64) - 1
    gt = np.asarray(real_pos, dtype=np.float64)
    # the in-range guard of keyframe_ate (a recorded index <= 0 would
    # otherwise wrap to the trajectory's end); np.interp needs rec sorted
    keep = (rec >= 0) & (rec < world.shape[0])
    rec = rec[keep]
    gt = gt[keep]
    if rec.size == 0 or np.any(np.diff(rec) < 0):
        return _summarize(np.empty((0,)))
    frames = np.arange(rec[0], rec[-1] + 1)
    gx = np.interp(frames, rec, gt[:, 0])
    gy = np.interp(frames, rec, gt[:, 1])
    err = np.linalg.norm(world[frames] - np.stack([gx, gy], 1), axis=1)
    return _summarize(err)


def umeyama_se2(src: np.ndarray, dst: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray]:
    """Least-squares rigid SE(2) alignment (rotation R, translation t)
    minimizing ||R src + t - dst||^2 (Umeyama/Horn, no scale): the
    TUM-style ATE alignment step."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    cov = (dst - mu_d).T @ (src - mu_s) / src.shape[0]
    U, _S, Vt = np.linalg.svd(cov)
    # sign(0) is 0, which would make R a rank-1 projection on an exactly
    # singular covariance (a stuck trajectory); take +1 there
    d = 1.0 if np.linalg.det(U @ Vt) >= 0 else -1.0
    R = U @ np.diag([1.0, d]) @ Vt
    t = mu_d - R @ mu_s
    return R, t


def aligned_keyframe_ate(poses_px: np.ndarray, real_pos: np.ndarray,
                         recorded_odom: np.ndarray, resol: float,
                         ori_x: float, ori_y: float) -> ATEResult:
    """Keyframe ATE after rigid SE(2) alignment of the estimated
    trajectory onto the ground truth (TUM ATE convention).

    The raw keyframe ATE conflates tracking error with any constant
    map <-> ground-truth frame offset; the aligned metric isolates the
    trajectory's shape error.  Needs >= 2 finite keyframe poses, else
    returns the raw metric."""
    world = pixel_to_world(poses_px, resol, ori_x, ori_y)
    idx = np.asarray(recorded_odom, dtype=np.int64) - 1
    keep = (idx >= 0) & (idx < world.shape[0])
    idx = idx[keep]
    gt = np.asarray(real_pos, dtype=np.float64)[keep]
    est = world[idx]
    fin = np.isfinite(est).all(axis=1)
    if fin.sum() < 2:
        return _summarize(np.linalg.norm(est - gt, axis=1))
    R, t = umeyama_se2(est[fin], gt[fin])
    err = np.linalg.norm(est[fin] @ R.T + t - gt[fin], axis=1)
    return _summarize(err)


def _summarize(err: np.ndarray) -> ATEResult:
    if err.size == 0:
        return ATEResult(float("nan"), float("nan"), float("nan"),
                         float("nan"), 0, err)
    return ATEResult(
        rmse=float(np.sqrt(np.mean(err ** 2))),
        mean=float(err.mean()), median=float(np.median(err)),
        max=float(err.max()), n=int(err.size), errors=err)
