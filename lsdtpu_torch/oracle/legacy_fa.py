"""Numpy oracle for the legacy (ROS V2.2) FeatureAssociation.

Reference: ROS/lsd/src/FeatureAssociation.cpp.  Differences from the
current-generation matcher (oracle/fa.py):

  * absolute length gate |mapLen - scanLen| <= 0.3 m / resol
    (FeatureAssociation.cpp:64-73) instead of the +-35% ratio gate;
  * no minimum scan-line length, no HMM distance gate, no UKF;
  * candidate pose = floor((LidarPos - scan_base) R + map_base) with the
    heading set to the MAP line direction (RotateScanIm,
    FeatureAssociation.cpp:254-299);
  * the score reprojects the RAW polar ranges at the candidate pose
    (not the extracted line pixels): gx = floor(r cos(a + th)/resol) +
    pose_x - 1, in-bounds test 1 < g < size, cache cap hit (== cap,
    z=2 m in the ROS node) adds 7x penalty weight, validity gate 0.75
    (ScanToMapMatchScore, FeatureAssociation.cpp:202-252);
  * global first-minimum pose wins (FeatureAssociation.cpp:119-124).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

from lsdtpu_torch.oracle.fa import normalized_line_direction


@dataclasses.dataclass
class LegacyCandidate:
    x: float
    y: float
    ang_deg: float
    score: float
    scan_i: int
    map_i: int
    hyp: int


def scan_to_map_match_score(map_cache: np.ndarray, pose, ranges, angles,
                            resol: float, z_occ_max_dis: float = 2.0
                            ) -> float:
    rows, cols = map_cache.shape
    x, y, ang_deg = pose
    if x > cols or x < 1 or y > rows or y < 1:
        return math.inf
    th = ang_deg * math.pi / 180.0
    gx = np.floor(ranges * np.cos(angles + th) / resol) + x - 1
    gy = np.floor(ranges * np.sin(angles + th) / resol) + y - 1
    inb = (gx > 1) & (gx < cols) & (gy > 1) & (gy < rows)
    n = len(ranges)
    scanlen = int(inb.sum())
    if scanlen < n * 0.75:
        return math.inf
    vals = map_cache[gy[inb].astype(int), gx[inb].astype(int)]
    at_cap = vals == z_occ_max_dis
    max_count = int(at_cap.sum())
    dist = float(vals[~at_cap].sum())
    dist_count = scanlen - max_count
    return (dist + 7 * max_count) / (dist_count + max_count) + \
        10.0 * (n - scanlen) / n


def feature_association_legacy(scan_lines: np.ndarray,
                               map_lines: np.ndarray,
                               lidar_pos: np.ndarray,
                               map_cache: np.ndarray,
                               ranges: np.ndarray, angles: np.ndarray,
                               resol: float,
                               z_occ_max_dis: float = 2.0,
                               len_diff_m: float = 0.3
                               ) -> Tuple[Optional[np.ndarray],
                                          List[LegacyCandidate]]:
    """Returns (first-min pose [x, y, ang_rad] or None, all candidates)."""
    len_diff = len_diff_m / resol
    cands: List[LegacyCandidate] = []
    for i, sl in enumerate(scan_lines):
        tgt = sl[8]
        for j, ml in enumerate(map_lines):
            if not (tgt - len_diff <= ml[8] <= tgt + len_diff):
                continue
            for h in range(4):
                if h < 2:
                    mb = (ml[4], ml[5], ml[6], ml[7])
                else:
                    mb = (ml[6], ml[7], ml[4], ml[5])
                if h % 2 == 0:
                    sb = (sl[4], sl[5], sl[6], sl[7])
                else:
                    sb = (sl[6], sl[7], sl[4], sl[5])
                m_ang = normalized_line_direction(*mb)
                s_ang = normalized_line_direction(*sb)
                ad = m_ang - s_ang
                c = math.cos(ad / 180.0 * math.pi)
                s = math.sin(ad / 180.0 * math.pi)
                px = math.floor((lidar_pos[0] - sb[0]) * c -
                                (lidar_pos[1] - sb[1]) * s + mb[0])
                py = math.floor((lidar_pos[0] - sb[0]) * s +
                                (lidar_pos[1] - sb[1]) * c + mb[1])
                ang = s_ang + ad
                sc = scan_to_map_match_score(
                    map_cache, (px, py, ang), ranges, angles, resol,
                    z_occ_max_dis)
                cands.append(LegacyCandidate(px, py, ang, sc, i, j, h))
    if not cands:
        return None, cands
    best = 0
    for k in range(len(cands)):
        if cands[k].score < cands[best].score:
            best = k
    b = cands[best]
    return np.array([b.x, b.y, b.ang_deg / 180.0 * math.pi]), cands
