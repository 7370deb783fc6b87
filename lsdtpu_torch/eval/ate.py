"""Trajectory evaluation: ATE vs the recorded ground-truth keyframes
(the port's own copy of the part of lsdtpu/eval/ate.py the port uses;
numpy only).

Keyframe ATE is exact, with no interpolation: the pose error at the
frames listed in recored_Odom.txt (1-based indices).  (The reference's
`samplePos` interpolation helper, ROS/lsd/src/FeatureAssociation.cpp:
301-366, is never called there.)  Estimated poses are in map pixel
coordinates, ground truth in meters; the conversion follows the legacy
matcher: world = px * mapResol + mapOri (FeatureAssociation.cpp:126-127).
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


def _summarize(err: np.ndarray) -> ATEResult:
    if err.size == 0:
        return ATEResult(float("nan"), float("nan"), float("nan"),
                         float("nan"), 0, err)
    return ATEResult(
        rmse=float(np.sqrt(np.mean(err ** 2))),
        mean=float(err.mean()), median=float(np.median(err)),
        max=float(err.max()), n=int(err.size), errors=err)
