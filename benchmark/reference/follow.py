"""The per-scan reference of a localization stream, in float64 numpy.

A tracking session's state is a chain: each scan's candidates are gated
by the last pose, and its scan pose turns on the running mean of the
heading offsets.  Run from scratch in float64 beside a float32 program,
that chain parts from the program's within a few scans, because a
transformed scan pixel that sits on a rounding edge lands in another
field cell (about 0.1 px of pose a scan, and up to 7% of the score).
So the reference follows the program: for each scan it takes the pose
the program answered for the scan before (the gate's last pose, and the
heading offsets of every scan before it), and works out everything else
itself from the benchmark's own inputs: the scan's features, the
candidates and their scores on the reference's own distance field, the
fusion, and the filter, whose state (x, P) is the reference's own chain.
The first scan of a session uses nothing of the program's.

Semantics are those of the reference matcher (fa.py, rdp.py, the
driver loop of main_on_windows.cpp) under the engine's default
configuration (faithful odometry, z_occ_max_dis 1 m).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from reference import fa
from reference import rdp
from reference.lsd import _atand, c_round, cosd, sind

SENTINEL = (-1.0, -1.0, 0.0)


class Follower:
    """One session's reference.  ``step`` takes one answered scan (the
    inputs the benchmark handed the program, and the pose the program
    answered for it) and returns the reference's answer for that scan."""

    def __init__(self, lines: np.ndarray, field: np.ndarray, resol: float,
                 ori_x: float, ori_y: float, z_occ_max_dis: float = 1.0,
                 faithful: bool = True):
        self.lines = np.asarray(lines, np.float64)
        self.field = np.asarray(field, np.float64)
        self.resol, self.ori_x, self.ori_y = resol, ori_x, ori_y
        self.z = z_occ_max_dis
        self.faithful = faithful
        self.x = fa.KALMAN_RESET_X.copy()
        self.P = fa.KALMAN_RESET_P.copy()
        self.prev_pose = SENTINEL      # the program's last answered pose
        self.ang_sum = 0.0
        self.ang_cnt = 0
        self.is_offset = False

    def _scan_pose(self, odom_prev, odom_cur):
        if abs(self.prev_pose[0] + 1) < 1e-4:
            return (0.0, 0.0, 0.0)
        theta = self.ang_sum / max(self.ang_cnt, 1)
        tx = (odom_cur[0] - odom_prev[0]) / self.resol
        ty = (odom_cur[1] - odom_prev[1]) / self.resol
        tang = _atand(odom_cur[2] - odom_prev[2])
        sp_x = tx * cosd(theta) - ty * sind(theta)
        if self.faithful:
            sp_y = ty * sind(theta) + ty * cosd(theta)  # the reference's bug
        else:
            sp_y = tx * sind(theta) + ty * cosd(theta)
        return (sp_x, sp_y, tang)

    def step(self, ranges, angles, odom_prev, odom_cur,
             program_pose: Optional[np.ndarray] = None) -> dict:
        """ranges, angles: the scan's valid points; odom_prev, odom_cur:
        the odometry readings the program was given for it.
        program_pose: the program's answer for this scan, which the next
        step follows (None: follow this step's own answer)."""
        r = np.asarray(ranges, np.float64)
        a = np.asarray(angles, np.float64)
        fs = rdp.feature_scan(r, a, self.resol, self.ori_x, self.ori_y)
        lidar = (float(c_round(np.float64(fs.lidar_pos[0]))),
                 float(c_round(np.float64(fs.lidar_pos[1]))))
        self.scan_pts, self.lidar = fs.scan_im_point, lidar
        last = tuple(float(v) for v in self.prev_pose)
        scan_pose = self._scan_pose(np.asarray(odom_prev, np.float64),
                                    np.asarray(odom_cur, np.float64))
        cands = fa.scan_to_map_candidates(
            fs.lines_info, self.lines, fs.scan_im_point, lidar, last,
            self.field, self.z)
        if not cands:
            self.x = fa.KALMAN_RESET_X.copy()
            self.P = fa.KALMAN_RESET_P.copy()
            score = math.inf
        elif abs(last[0] + 1) < 1e-4:
            best = min(cands, key=lambda c: c.score)
            self.x = self.x.copy()
            self.x[:3] = (best.x, best.y, best.ang)
            score = best.score
        else:
            est = fa.fuse_candidates(cands)
            self.x, self.P = fa.ukf(self.x, self.P, scan_pose,
                                    (est.x, est.y, est.ang))
            score = est.score
        out = {"pose": self.x[:3].copy(), "score": float(score),
               "n_candidates": len(cands)}
        followed = out["pose"] if program_pose is None else \
            np.asarray(program_pose, np.float64)
        # the heading bookkeeping of the driver loop, on the followed pose
        self.ang_cnt += 1
        ang_diff = followed[2] - _atand(float(odom_cur[2]))
        if abs(ang_diff) > 90 and self.ang_cnt == 1:
            self.is_offset = True
        if self.is_offset and ang_diff < 0:
            ang_diff += 360
        self.ang_sum += ang_diff
        self.prev_pose = tuple(followed)
        return out

    def score_pose(self, pose) -> float:
        """The last stepped scan's score on this reference's field with
        the lidar at ``pose`` (x, y in map pixels, heading in degrees):
        a candidate's transform, taken about the lidar's pixel."""
        p = np.asarray(pose, np.float64)
        if not np.isfinite(p[:3]).all():
            return math.inf
        px = self.scan_pts[:, 0].astype(np.float64) - self.lidar[0]
        py = self.scan_pts[:, 1].astype(np.float64) - self.lidar[1]
        ca, sa = cosd(p[2]), sind(p[2])
        return fa.calc_score(self.field, px * ca - py * sa + p[0],
                             px * sa + py * ca + p[1], self.z)
