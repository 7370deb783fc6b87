"""Numpy oracle for the scan pipeline: gap clustering + RDP + featurization.

Exact-semantics re-implementation of the reference per-frame scan
processing (reference: LSD/myRDP.cpp), including quirks:

  * RegionSegmentation's wrap-around handling overwrites cell 0's start
    when the last point connects to the first (myRDP.cpp:326-329), giving
    a wrapped cell with startPointNum > endPointNum;
  * FeatureScan writes split indices starting at axis[1] and overwrites
    axis[0] with the cell start afterwards (myRDP.cpp:47-69);
  * the (0,0) pixel is an out-of-bounds sentinel in the rasterizer; any
    pixel with x==0 or y==0 is dropped from lineIm and scanImPoint;
  * scanPose is always (0,0,0) in the current driver.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

from reference.lsd import _line_info_from_endpoints

PI = math.pi


def threshold_delta_dist(val: float) -> float:
    """Range-dependent gap threshold lookup (myRDP.cpp:347-368)."""
    if val <= 0.3:
        return 0.02
    if val <= 0.5:
        return 0.05
    if val <= 0.8:
        return 0.11
    if val <= 1:
        return 0.17
    if val <= 2:
        return 0.6
    if val <= 3:
        return 0.7
    if val <= 4:
        return 0.85
    if val <= 5:
        return 0.9
    if val <= 6:
        return 1.0
    return 1.1


def region_segmentation(ranges: np.ndarray, angles: np.ndarray,
                        least_point: int = 3) -> List[Tuple[int, int]]:
    """Cluster the scan into contiguous cells (myRDP.cpp:274-345).

    Returns list of (startPointNum, endPointNum); a wrapped cell has
    start > end.
    """
    n = len(ranges)
    xs = ranges * np.cos(angles)
    ys = ranges * np.sin(angles)
    cells: List[List[int]] = []
    start = 0
    wrapped_start: Optional[int] = None
    for i in range(n):
        j = 0 if i == n - 1 else i + 1
        delta = math.hypot(xs[i] - xs[j], ys[i] - ys[j])
        thre = threshold_delta_dist(ranges[i])
        if delta > thre:
            if abs(i - start) >= least_point:
                cells.append([start, i])
            start = i + 1
        if delta <= thre and i == n - 1:
            wrapped_start = start
    if wrapped_start is not None and cells:
        # overwrite cell 0's start with the trailing run's start (quirk)
        cells[0][0] = wrapped_start
    return [(c[0], c[1]) for c in cells]


def split_merge(ranges: np.ndarray, angles: np.ndarray,
                cells: List[Tuple[int, int]], thre_line: float = 0.08
                ) -> np.ndarray:
    """RDP split-point marking (myRDP.cpp:187-272).

    Returns a boolean split mask over points.  Uses world coordinates
    (scanPose = 0).  Recursion is replicated with an explicit stack in
    the same (left, right) order; marking order does not matter since
    splits are a set.
    """
    n = len(ranges)
    xs = ranges * np.cos(angles)
    ys = ranges * np.sin(angles)
    split = np.zeros(n, dtype=bool)

    def recurse(start: int, end: int) -> None:
        if end > start:
            axis = np.arange(start, end + 1)
        else:
            axis = np.arange(start, n + end + 1)
            axis = np.where(axis >= n, axis - n, axis)
        ln = len(axis)
        if ln <= 2:
            return
        ax, ay = xs[start], ys[start]
        bx, by = xs[end], ys[end]
        with np.errstate(divide='ignore', invalid='ignore'):
            k = np.float64(by - ay) / np.float64(bx - ax)
        d = by - k * bx
        interior = axis[1:ln - 1]
        with np.errstate(invalid='ignore'):
            dist = np.abs(k * xs[interior] - ys[interior] + d) / \
                math.sqrt(k * k + 1)
        # reference tracks the running max with strict > (NaNs never win);
        # first-maximum argmax over NaN-suppressed distances matches.
        dist = np.where(np.isnan(dist), -np.inf, dist)
        im = int(np.argmax(dist)) if len(dist) else 0
        dist_max = float(dist[im]) if len(dist) else 0.0
        i_max = int(interior[im]) if len(dist) else 0
        if not np.isfinite(dist_max):
            dist_max = 0.0
        r = ranges[i_max]
        thre = r * thre_line if r > 9 else thre_line
        if dist_max > thre:
            recurse(start, i_max)
            recurse(i_max, end)
            split[i_max] = True

    for s, e in cells:
        recurse(s, e)
    return split


@dataclasses.dataclass
class FeatureScanResult:
    line_im: np.ndarray          # scan-local image
    lines_info: np.ndarray       # (N, 10)
    lidar_pos: Tuple[float, float]   # scan-local pixel coords (floor'd)
    scan_im_point: np.ndarray    # (P, 2) int pixel coords of line pixels


def feature_scan(ranges: np.ndarray, angles: np.ndarray, map_resol: float,
                 map_ori_x: float, map_ori_y: float, least_point: int = 3,
                 thre_line: float = 0.08, least_dist: float = 0.5
                 ) -> FeatureScanResult:
    """Per-frame scan featurization (myRDP.cpp:9-185)."""
    n = len(ranges)
    cells = region_segmentation(ranges, angles, least_point)
    split = split_merge(ranges, angles, cells, thre_line)

    gx = np.floor((ranges * np.cos(angles) - map_ori_x) / map_resol)
    gy = np.floor((ranges * np.sin(angles) - map_ori_y) / map_resol)
    min_x, max_x = float(gx.min()), float(gx.max())
    min_y, max_y = float(gy.min()), float(gy.max())
    x_lim = int(math.ceil(max_x - min_x))
    y_lim = int(math.ceil(max_y - min_y))
    lidar_x = math.floor((0.0 - map_ori_x) / map_resol - min_x)
    lidar_y = math.floor((0.0 - map_ori_y) / map_resol - min_y)

    line_im = np.zeros((y_lim, x_lim), dtype=np.uint8)
    line_dist_thre = least_dist / map_resol
    infos: List[np.ndarray] = []
    collect: List[np.ndarray] = []

    for start, end in cells:
        # walk the cell, collecting split indices then bracketing with
        # start/end (axis[0] overwritten with start, myRDP.cpp:47-69)
        if end > start:
            covered = range(start, end + 1)
        else:
            covered = [(start + j) % n
                       for j in range(n + end - start + 1)]
        axis = [start]
        for idx in covered:
            if split[idx]:
                axis.append(idx)
        axis.append(end)
        for j in range(len(axis) - 1):
            ax, ay = gx[axis[j]], gy[axis[j]]
            bx, by = gx[axis[j + 1]], gy[axis[j + 1]]
            line_dist = math.sqrt((ax - bx) ** 2 + (ay - by) ** 2)
            if line_dist >= line_dist_thre:
                infos.append(_line_info_from_endpoints(
                    ax - min_x, ay - min_y, bx - min_x, by - min_y,
                    x_lim, y_lim, line_im, collect))
    lines = (np.stack(infos, axis=0) if infos
             else np.zeros((0, 10), dtype=np.float64))
    pts = (np.concatenate(collect, axis=0) if collect
           else np.zeros((0, 2), dtype=np.int64))
    return FeatureScanResult(line_im=line_im, lines_info=lines,
                             lidar_pos=(lidar_x, lidar_y),
                             scan_im_point=pts)
