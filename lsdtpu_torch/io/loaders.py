"""Host-side text loaders for the bundled datasets (the port's own copy
of lsdtpu/io/loaders.py).

File formats (reference: LSD/main_on_windows.cpp:27-64,97-124):
  mapParam.txt    -> col row resol origX origY (whitespace separated)
  mapValue.txt    -> row-major uint8 grid {0=unknown, 1=occupied, 255=free}
  Lidar.txt       -> `range angle` pairs, up to 360 per frame; `inf` rows dropped
  Odom.txt        -> `x y ang` per frame
  realPos.txt     -> `x<TAB>y` ground-truth keyframes
  recored_Odom.txt-> keyframe frame indices (1-based)

The native C++ parser (io/native) reads the big grids and the float
tables; where it cannot be built, numpy parses them with the same
results.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

from lsdtpu_torch.io import native


@dataclasses.dataclass(frozen=True)
class MapParam:
    """Map metadata (reference struct: LSD/baseFunc.h:25-31)."""

    col: int
    row: int
    resol: float
    ori_x: float
    ori_y: float


@dataclasses.dataclass
class Dataset:
    """One sequence: map + scans + odometry (+ optional ground truth)."""

    param: MapParam
    map_value: np.ndarray
    odom: np.ndarray
    frames: List[np.ndarray]
    real_pos: Optional[np.ndarray] = None
    recorded_odom: Optional[np.ndarray] = None
    name: str = ""


def load_map_param(path: str) -> MapParam:
    with open(path) as f:
        vals = f.read().split()
    return MapParam(int(vals[0]), int(vals[1]), float(vals[2]),
                    float(vals[3]), float(vals[4]))


def load_map_value(path: str, param: MapParam) -> np.ndarray:
    """Load the occupancy grid as (row, col) uint8."""
    arr = native.load_grid_native(path, param.row, param.col)
    if arr is not None:
        return arr
    flat = np.loadtxt(path, dtype=np.int64).ravel()
    n = param.row * param.col
    if flat.size < n:
        raise ValueError(f"{path}: expected {n} values, got {flat.size}")
    return flat[:n].astype(np.uint8).reshape(param.row, param.col)


def _load_floats(path: str, cols: int) -> np.ndarray:
    """(N, cols) float64: the native parser, else numpy."""
    flat = native.load_doubles_native(path)
    if flat is not None and flat.size % cols == 0:
        return flat.reshape(-1, cols)
    return np.loadtxt(path, dtype=np.float64, ndmin=2)


def load_odom(path: str, duplicate_last: bool = True) -> np.ndarray:
    """Odometry rows (N, 3) float64.  The reference reads with
    `while(!feof)`, which appends a duplicate final row, and overrides
    `Odom[0].x = 0` (LSD/main_on_windows.cpp:51-61)."""
    rows = _load_floats(path, 3)
    if duplicate_last and rows.shape[0] > 0:
        rows = np.concatenate([rows, rows[-1:]], axis=0)
    if rows.shape[0] > 0:
        rows = rows.copy()
        rows[0, 0] = 0.0
    return rows


def load_lidar_frames(path: str, points_per_loop: int = 360
                      ) -> List[np.ndarray]:
    """Split Lidar.txt into frames of (n_i, 2) [range, angle], inf dropped
    (LSD/main_on_windows.cpp:110-124: each frame consumes exactly
    ``points_per_loop`` rows)."""
    raw = _load_floats(path, 2)
    frames = []
    for f in range(raw.shape[0] // points_per_loop):
        chunk = raw[f * points_per_loop:(f + 1) * points_per_loop]
        frames.append(chunk[np.isfinite(chunk[:, 0])])
    return frames


def load_real_pos(path: str) -> np.ndarray:
    """Ground-truth keyframes (N, 2) in meters."""
    return _load_floats(path, 2)


def load_recorded_odom(path: str) -> np.ndarray:
    """Keyframe frame indices (1-based), (N,) int64."""
    return np.loadtxt(path, dtype=np.int64).ravel()


def load_lines_info(path: str) -> np.ndarray:
    """A linesInfo dump: rows of [k b dx dy x1 y1 x2 y2 len orient] in
    structLinesInfo field order (reference: LSD/baseFunc.h:33-44)."""
    return _load_floats(path, 10)


def load_dataset(root: str, map_suffix: str = "",
                 points_per_loop: int = 360) -> Dataset:
    """Load a dataset directory (e.g. data_20190513/data_f3key/data1);
    ``map_suffix`` selects alternate maps in data/ (e.g. "_map1")."""
    param = load_map_param(os.path.join(root, f"mapParam{map_suffix}.txt"))
    map_value = load_map_value(
        os.path.join(root, f"mapValue{map_suffix}.txt"), param)
    odom = load_odom(os.path.join(root, "Odom.txt"))
    frames = load_lidar_frames(os.path.join(root, "Lidar.txt"),
                               points_per_loop)
    real_pos = recorded = None
    rp = os.path.join(root, "realPos.txt")
    ro = os.path.join(root, "recored_Odom.txt")
    if os.path.exists(rp):
        real_pos = load_real_pos(rp)
    if os.path.exists(ro):
        recorded = load_recorded_odom(ro)
    return Dataset(param, map_value, odom, frames, real_pos, recorded,
                   name=os.path.basename(os.path.normpath(root)) + map_suffix)
