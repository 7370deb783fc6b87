"""Visualization: PNG dumps of the reference's display windows (the
port's own copy of lsdtpu/viz.py).

The reference's primary validation surface is visual: OpenCV imshow of
the occupancy map with the extracted LSD lines, the per-frame RDP scan
image, and the estimated trajectory drawn as dots on the map
(LSD/main_on_windows.cpp:175-178; LSD/main_on_linux.cpp:69-84).  This
module reproduces those views as saved images, host-side numpy over the
engine's outputs (pass tensors as ``t.cpu().numpy()``):

  * map_lines.png    map + LSD lineIm overlay       (imshow "mapValue")
  * map_cache.png    distance-field prior heatmap   (debugging aid)
  * trajectory.png   map + pose dots + GT keyframes (imshow trajectory)
  * scan_NNNN.png    per-frame scan pixel cloud     (imshow "scanIm")

PNG encoding is the only PIL dependency; the lineIm overlay comes from
the port's rasterizer (render.py) on the CPU; everything else is numpy.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from lsdtpu_torch.render import render_line_image

# BGR-free fixed palette (RGB)
LINE_RED = (220, 50, 50)
POSE_GREEN = (40, 160, 70)
LOST_ORANGE = (235, 140, 30)
GT_BLUE = (50, 90, 220)
REFINED_PURPLE = (150, 60, 200)
LIDAR_YELLOW = (240, 200, 40)


def save_png(arr: np.ndarray, path: str) -> str:
    """Write a (H, W) or (H, W, 3) uint8 array as PNG."""
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(arr)).save(path)
    return path


def map_to_gray(map_value: np.ndarray) -> np.ndarray:
    """Occupancy map -> display grayscale.

    Input values follow the dataset convention before the LSD in-place
    remap (main_on_windows.cpp:43-45): 0=unknown, 1=occupied, 255=free.
    Display: occupied black, free white, unknown mid-gray.
    """
    m = np.asarray(map_value)
    out = np.full(m.shape, 160, np.uint8)     # unknown
    out[m == 255] = 255                       # free
    out[m == 1] = 0                           # occupied
    return out


def cache_to_gray(map_cache: np.ndarray,
                  z_occ_max_dis: float = 1.0) -> np.ndarray:
    """Distance field (meters, capped) -> grayscale heatmap
    (near-wall dark, far bright)."""
    c = np.asarray(map_cache, np.float64)
    hi = max(float(z_occ_max_dis), 1e-9)
    return np.clip(c / hi * 255.0, 0, 255).astype(np.uint8)


def compose_rgb(gray: np.ndarray, line_im: Optional[np.ndarray] = None,
                line_color: Sequence[int] = LINE_RED) -> np.ndarray:
    """Grayscale canvas -> RGB, with lineIm pixels painted line_color."""
    rgb = np.repeat(np.asarray(gray, np.uint8)[:, :, None], 3, axis=2)
    if line_im is not None:
        on = np.asarray(line_im) != 0
        rgb[on] = np.asarray(line_color, np.uint8)
    return rgb


def _disk_offsets(radius: int) -> np.ndarray:
    r = int(radius)
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    keep = dy * dy + dx * dx <= r * r
    return np.stack([dy[keep], dx[keep]], axis=1)


def draw_dots(rgb: np.ndarray, xy: np.ndarray, color: Sequence[int],
              radius: int = 1) -> np.ndarray:
    """Paint filled dots at (x, y) pixel coords (x = column, y = row —
    the engine's pose convention, see eval/ate.py). In-place; returns rgb.
    Non-finite and out-of-canvas points are skipped."""
    H, W = rgb.shape[:2]
    pts = np.asarray(xy, np.float64).reshape(-1, 2)
    pts = pts[np.isfinite(pts).all(axis=1)]
    if pts.size == 0:
        return rgb
    off = _disk_offsets(radius)
    yy = (np.round(pts[:, 1]).astype(np.int64)[:, None] + off[None, :, 0])
    xx = (np.round(pts[:, 0]).astype(np.int64)[:, None] + off[None, :, 1])
    ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
    rgb[yy[ok], xx[ok]] = np.asarray(color, np.uint8)
    return rgb


def draw_crosses(rgb: np.ndarray, xy: np.ndarray, color: Sequence[int],
                 arm: int = 3) -> np.ndarray:
    """Paint + crosses at (x, y) pixel coords. In-place; returns rgb."""
    H, W = rgb.shape[:2]
    a = int(arm)
    off = np.concatenate([
        np.stack([np.arange(-a, a + 1), np.zeros(2 * a + 1, np.int64)], 1),
        np.stack([np.zeros(2 * a + 1, np.int64), np.arange(-a, a + 1)], 1)])
    pts = np.asarray(xy, np.float64).reshape(-1, 2)
    pts = pts[np.isfinite(pts).all(axis=1)]
    if pts.size == 0:
        return rgb
    yy = (np.round(pts[:, 1]).astype(np.int64)[:, None] + off[None, :, 0])
    xx = (np.round(pts[:, 0]).astype(np.int64)[:, None] + off[None, :, 1])
    ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
    rgb[yy[ok], xx[ok]] = np.asarray(color, np.uint8)
    return rgb


def world_to_px(xy_m: np.ndarray, resol: float, ori_x: float,
                ori_y: float) -> np.ndarray:
    """(N, 2) world meters -> pixel coords (inverse of
    eval/ate.pixel_to_world)."""
    out = np.asarray(xy_m, np.float64)[:, :2].copy()
    out[:, 0] = (out[:, 0] - ori_x) / resol
    out[:, 1] = (out[:, 1] - ori_y) / resol
    return out


def trajectory_image(map_value: np.ndarray, poses_px: np.ndarray,
                     scores: Optional[np.ndarray] = None,
                     line_im: Optional[np.ndarray] = None,
                     real_pos_px: Optional[np.ndarray] = None,
                     refined_px: Optional[np.ndarray] = None) -> np.ndarray:
    """The reference's trajectory window: map (+ LSD lines) with the
    estimated pose per frame as a dot (main_on_windows.cpp:175-178).
    Tracked frames green, tracking-lost frames orange; ground-truth
    keyframes blue crosses; optional refined trajectory purple."""
    rgb = compose_rgb(map_to_gray(map_value), line_im)
    poses = np.asarray(poses_px, np.float64)[:, :2]
    if scores is not None:
        lost = ~np.isfinite(np.asarray(scores, np.float64))
        draw_dots(rgb, poses[lost], LOST_ORANGE, radius=2)
        draw_dots(rgb, poses[~lost], POSE_GREEN, radius=1)
    else:
        draw_dots(rgb, poses, POSE_GREEN, radius=1)
    if refined_px is not None:
        draw_dots(rgb, np.asarray(refined_px)[:, :2], REFINED_PURPLE,
                  radius=1)
    if real_pos_px is not None:
        draw_crosses(rgb, real_pos_px, GT_BLUE, arm=3)
    return rgb


def scan_image(pixels: np.ndarray, pixels_mask: np.ndarray,
               lidar_pos: np.ndarray,
               canvas: Optional[tuple] = None) -> np.ndarray:
    """The reference's per-frame scan window (structFeatureScan.lineIm,
    myRDP.cpp:96-161, shown by the main programs): the RDP segment pixel
    cloud in scan-local coords, white on black, lidar position yellow.

    pixels: (P, 2) int (x, y); pixels_mask: (P,) bool.
    """
    px = np.asarray(pixels, np.int64)[np.asarray(pixels_mask, bool)]
    lp = np.asarray(lidar_pos, np.float64).reshape(-1)[:2]
    if canvas is None:
        hi_x = int(max(px[:, 0].max() if px.size else 0, lp[0], 1)) + 4
        hi_y = int(max(px[:, 1].max() if px.size else 0, lp[1], 1)) + 4
        canvas = (hi_y, hi_x)
    H, W = canvas
    rgb = np.zeros((H, W, 3), np.uint8)
    ok = (px[:, 0] >= 0) & (px[:, 0] < W) & (px[:, 1] >= 0) & (px[:, 1] < H)
    rgb[px[ok, 1], px[ok, 0]] = 255
    draw_dots(rgb, lp[None, :], LIDAR_YELLOW, radius=2)
    return rgb


def dump_run(out_dir: str, map_value: np.ndarray, map_lines: np.ndarray,
             map_cache: np.ndarray, outs: dict, resol: float, ori_x: float,
             ori_y: float, real_pos: Optional[np.ndarray] = None,
             scan_features: Sequence = (),
             z_occ_max_dis: float = 1.0,
             refined_px: Optional[np.ndarray] = None) -> list:
    """Write the full set of run images; returns the paths written.

    map_lines: (M, 10) structLinesInfo rows (from map prep);
    outs: run_sequence's outputs as numpy arrays (pose, score, ...);
    scan_features: optional [(frame_index, ScanFeatures-like of numpy
    arrays)] to dump per-frame scan windows.
    """
    os.makedirs(out_dir, exist_ok=True)
    H, W = np.asarray(map_value).shape
    lines = torch.from_numpy(np.asarray(map_lines, np.float64))
    line_im = render_line_image(
        lines, torch.ones(lines.shape[0], dtype=torch.bool), rows=H, cols=W,
        max_steps=int(max(H, W) + 2)).numpy()

    paths = []
    paths.append(save_png(compose_rgb(map_to_gray(map_value), line_im),
                          os.path.join(out_dir, "map_lines.png")))
    paths.append(save_png(cache_to_gray(map_cache, z_occ_max_dis),
                          os.path.join(out_dir, "map_cache.png")))

    gt_px = None
    if real_pos is not None:
        gt_px = world_to_px(np.asarray(real_pos), resol, ori_x, ori_y)
    paths.append(save_png(
        trajectory_image(map_value, np.asarray(outs["pose"]),
                         np.asarray(outs["score"]), line_im=line_im,
                         real_pos_px=gt_px, refined_px=refined_px),
        os.path.join(out_dir, "trajectory.png")))

    for f, fs in scan_features:
        paths.append(save_png(
            scan_image(np.asarray(fs.pixels), np.asarray(fs.pixels_mask),
                       np.asarray(fs.lidar_pos)),
            os.path.join(out_dir, f"scan_{f:04d}.png")))
    return paths
