"""Numpy oracle for the offline localization driver.

Mirrors the reference Windows driver loop (reference:
LSD/main_on_windows.cpp:16-241) including its quirks:

  * odometry rotation bug: ScanPose.y = tempY*sind(theta) + tempY*cosd(theta)
    (no x*sind term, main_on_windows.cpp:151) - kept under faithful=True;
  * theta is the running mean of all angRotate entries; angRotate gets
    kalman_ang - atand(odomAng) each frame, with the is_offset 360-degree
    fix triggered on frame 1 (main_on_windows.cpp:165-172);
  * trans2FA rounds the lidar pose to ints (main_on_windows.cpp:229-230);
  * Odom gets a duplicated final row and Odom[0].x = 0 (handled by the
    loader).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from lsdtpu_torch.io.loaders import Dataset
from lsdtpu_torch.oracle import fa as ofa
from lsdtpu_torch.oracle import lsd as olsd
from lsdtpu_torch.oracle import rdp as ordp
from lsdtpu_torch.oracle.lsd import cosd, sind, _atand


@dataclasses.dataclass
class FrameRecord:
    pose: np.ndarray          # kalman_x[:3]
    score: float
    n_candidates: int
    theta: float


@dataclasses.dataclass
class RunResult:
    poses: np.ndarray         # (F, 3) estimated trajectory (pixel coords)
    records: List[FrameRecord]
    map_lines: np.ndarray
    map_cache: np.ndarray


@dataclasses.dataclass
class MapArtifacts:
    map_cache: np.ndarray
    lines_info: np.ndarray
    line_im: np.ndarray


def prepare_map(map_value: np.ndarray, resol: float,
                z_occ_max_dis: float = 1.0) -> MapArtifacts:
    """Per-map offline preprocessing: mapCache + LSD.

    Order matters: createMapCache reads pre-remap values (occupied == 1)
    and myLineSegmentDetector then remaps the grid in place
    (main_on_windows.cpp:67-70).
    """
    grid = map_value.copy()
    cache = olsd.create_map_cache(grid, resol, z_occ_max_dis)
    lsd = olsd.line_segment_detector(grid)
    return MapArtifacts(map_cache=cache, lines_info=lsd.lines_info,
                        line_im=lsd.line_im)


def run_sequence(ds: Dataset, map_art: Optional[MapArtifacts] = None,
                 z_occ_max_dis: float = 1.0, faithful: bool = True,
                 max_frames: Optional[int] = None,
                 verbose: bool = False) -> RunResult:
    """Full localization loop over one recorded sequence."""
    if map_art is None:
        map_art = prepare_map(ds.map_value, ds.param.resol, z_occ_max_dis)

    last_pose = (-1.0, -1.0, 0.0)
    kalman_x = ofa.KALMAN_RESET_X.copy()
    kalman_P = ofa.KALMAN_RESET_P.copy()
    ang_rotate: List[float] = []
    is_offset = False
    records: List[FrameRecord] = []
    poses: List[np.ndarray] = []

    n_frames = len(ds.frames)
    # reference loop breaks once cnt_frame >= Odom.size()-1; with the
    # loader's duplicated last row that allows exactly len(odom)-1 frames.
    n_frames = min(n_frames, ds.odom.shape[0] - 1)
    if max_frames is not None:
        n_frames = min(n_frames, max_frames)

    for f in range(n_frames):
        cnt_frame = f + 1
        frame = ds.frames[f]
        fs = ordp.feature_scan(frame[:, 0], frame[:, 1], ds.param.resol,
                               ds.param.ori_x, ds.param.ori_y)

        theta = 0.0
        if abs(kalman_x[0] + 1) < 0.0001:
            scan_pose = (0.0, 0.0, 0.0)
        else:
            theta = sum(ang_rotate) / len(ang_rotate)
            tx = (ds.odom[cnt_frame, 0] - ds.odom[cnt_frame - 1, 0]) / \
                ds.param.resol
            ty = (ds.odom[cnt_frame, 1] - ds.odom[cnt_frame - 1, 1]) / \
                ds.param.resol
            tang = _atand(ds.odom[cnt_frame, 2] - ds.odom[cnt_frame - 1, 2])
            sp_x = tx * cosd(theta) - ty * sind(theta)
            if faithful:
                # reference bug: y-term uses ty twice
                sp_y = ty * sind(theta) + ty * cosd(theta)
            else:
                sp_y = tx * sind(theta) + ty * cosd(theta)
            scan_pose = (sp_x, sp_y, tang)

        lidar_pose = (float(olsd.c_round(np.float64(fs.lidar_pos[0]))),
                      float(olsd.c_round(np.float64(fs.lidar_pos[1]))))
        res = ofa.feature_association(
            fs.lines_info, map_art.lines_info, fs.scan_im_point,
            lidar_pose, last_pose, kalman_x, kalman_P, scan_pose,
            map_art.map_cache, z_occ_max_dis)
        kalman_x, kalman_P = res.kalman_x, res.kalman_P
        last_pose = (kalman_x[0], kalman_x[1], kalman_x[2])

        ang_diff = kalman_x[2] - _atand(ds.odom[cnt_frame, 2])
        if abs(ang_diff) > 90 and cnt_frame == 1:
            is_offset = True
        if is_offset and ang_diff < 0:
            ang_diff += 360
        ang_rotate.append(ang_diff)

        poses.append(kalman_x[:3].copy())
        records.append(FrameRecord(pose=kalman_x[:3].copy(),
                                   score=res.score,
                                   n_candidates=res.n_candidates,
                                   theta=theta))
        if verbose:
            print(f"frame {cnt_frame}: x={kalman_x[0]:.2f} "
                  f"y={kalman_x[1]:.2f} ang={kalman_x[2]:.2f} "
                  f"score={res.score:.3f} nc={res.n_candidates}")
    return RunResult(poses=np.array(poses), records=records,
                     map_lines=map_art.lines_info,
                     map_cache=map_art.map_cache)
