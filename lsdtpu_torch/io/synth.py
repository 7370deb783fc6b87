"""Synthetic scenes: random walled maps, raycast lidar scans along a
random walk, noisy odometry (numpy only).

With default arguments ``synth_map`` / ``raycast`` / ``synth_dataset``
reproduce the synthetic-scene generators of the reference package's
fuzz tests bit for bit (a 200x260 room at 0.05 m/px with 2-4 interior
walls, 10 frames of 360-ray scans to 10 m).  The size, resolution,
range, number of interior walls and number of frames are parameters,
so the same generator builds a scene at a real dataset's extent (e.g.
979x1440 cells at 0.025 m/px with 13 m scans, the size of the bundled
data1 sequence) where no dataset is mounted.  Interior wall lengths
and margins scale with the map (``wall_scale``), and a clearance
around the start keeps the first scans from sitting against a wall.

``synth_dataset`` also returns the true poses and the wall segments it
drew; ``wall_lines`` turns the segments into linesInfo rows, a map
line set for the rollout when no line detector runs.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from lsdtpu_torch.io.loaders import Dataset, MapParam

RESOL = 0.05
ORI_X = -2.0
ORI_Y = -1.5


@dataclasses.dataclass
class Scene:
    """A synthetic sequence with its ground truth."""

    dataset: Dataset
    true_pos: np.ndarray    # (F, 2) lidar positions, meters
    walls: np.ndarray       # (n, 4) wall segments [x1 y1 x2 y2], map px


def synth_map(seed, H=200, W=260, n_walls=None, clear_px=0.0,
              wall_scale=None, pillars=0):
    """Random room: a free-space rectangle with boundary walls plus
    interior wall segments (2-4 drawn from the seed when ``n_walls`` is
    None), surrounded by unknown cells - the dataset value convention
    {0 unknown, 1 occupied, 255 free}.  An interior wall that would pass
    within ``clear_px`` of the map centre (where the trajectory starts)
    is drawn from the seed but left out.  Interior wall lengths and
    margins scale by ``wall_scale`` (default: the map's shorter side over
    200 px, at least 1).  ``pillars`` round pillars (filled discs of
    radius 3-6 px times the scale, outside ``clear_px`` of the centre)
    are drawn from a stream of their own, so the walls stay those of
    the same seed without them.  Returns (grid, walls)."""
    rng = np.random.default_rng(seed)
    s = max(1.0, min(H, W) / 200.0) if wall_scale is None else wall_scale

    def sc(v):
        return int(round(v * s))

    g = np.zeros((H, W), np.uint8)
    y0, x0 = 8, 8
    y1, x1 = H - 8, W - 8
    g[y0:y1, x0:x1] = 255
    g[y0, x0:x1] = 1
    g[y1 - 1, x0:x1] = 1
    g[y0:y1, x0] = 1
    g[y0:y1, x1 - 1] = 1
    walls = [(x0, y0, x1 - 1, y0), (x0, y1 - 1, x1 - 1, y1 - 1),
             (x0, y0, x0, y1 - 1), (x1 - 1, y0, x1 - 1, y1 - 1)]
    n = int(rng.integers(2, 5)) if n_walls is None else int(n_walls)
    cy, cx = H / 2, W / 2
    for _ in range(n):
        if rng.random() < 0.5:
            yy = int(rng.integers(y0 + sc(20), y1 - sc(20)))
            xa = int(rng.integers(x0 + sc(5), x1 - sc(60)))
            L = int(rng.integers(sc(40), sc(90)))
            wall = (xa, yy, min(xa + L, W) - 1, yy)
        else:
            xx = int(rng.integers(x0 + sc(20), x1 - sc(20)))
            ya = int(rng.integers(y0 + sc(5), y1 - sc(60)))
            L = int(rng.integers(sc(40), sc(80)))
            wall = (xx, ya, xx, min(ya + L, H) - 1)
        # distance from the centre to the axis-aligned segment
        dx = max(wall[0] - cx, 0.0, cx - wall[2])
        dy = max(wall[1] - cy, 0.0, cy - wall[3])
        if clear_px and dx * dx + dy * dy < clear_px * clear_px:
            continue
        g[wall[1]:wall[3] + 1, wall[0]:wall[2] + 1] = 1
        walls.append(wall)
    prng = np.random.default_rng([seed, 1])
    yy, xx = np.mgrid[0:H, 0:W]
    placed = 0
    while placed < pillars:
        r = prng.uniform(3.0, 6.0) * s
        py = prng.uniform(y0 + r + 2, y1 - r - 2)
        px = prng.uniform(x0 + r + 2, x1 - r - 2)
        if (py - cy) ** 2 + (px - cx) ** 2 < (clear_px + r) ** 2:
            continue
        g[(yy - py) ** 2 + (xx - px) ** 2 <= r * r] = 1
        placed += 1
    return g, np.asarray(walls, np.float64)


def raycast(g, wx, wy, n=360, rmax=10.0, resol=RESOL, ori_x=ORI_X,
            ori_y=ORI_Y):
    """Dense ray marching against the occupancy grid; returns the
    (range, angle) pairs that hit a wall - a synthetic lidar frame."""
    H, W = g.shape
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    steps = np.arange(0.05, rmax, 0.01)
    X = wx + np.cos(ang)[:, None] * steps[None, :]
    Y = wy + np.sin(ang)[:, None] * steps[None, :]
    ix = np.clip(((X - ori_x) / resol + 0.5).astype(int), 0, W - 1)
    iy = np.clip(((Y - ori_y) / resol + 0.5).astype(int), 0, H - 1)
    occ = g[iy, ix] == 1
    hit = occ.any(axis=1)
    r = steps[np.argmax(occ, axis=1)]
    return r[hit], ang[hit]


def synth_dataset(seed, F=10, H=200, W=260, resol=RESOL, ori_x=ORI_X,
                  ori_y=ORI_Y, rmax=10.0, n_walls=None,
                  clear_m=0.0, wall_scale=None, pillars=0) -> Scene:
    """Random-walk trajectory from the map centre + raycast scans +
    noisy odometry; no interior wall or pillar comes within ``clear_m``
    meters of the start."""
    rng = np.random.default_rng(1000 + seed)
    g, walls = synth_map(seed, H, W, n_walls, clear_m / resol, wall_scale,
                         pillars)
    pos = np.zeros((F, 2))
    pos[0] = (ori_x + W / 2 * resol, ori_y + H / 2 * resol)
    for f in range(1, F):
        pos[f] = pos[f - 1] + rng.uniform(-0.15, 0.15, 2)
    frames = []
    for f in range(F):
        r, a = raycast(g, pos[f, 0], pos[f, 1], rmax=rmax, resol=resol,
                       ori_x=ori_x, ori_y=ori_y)
        r = r + rng.normal(0, 0.003, len(r))
        frames.append(np.stack([r, a], axis=1))
    odom = np.zeros((F + 1, 3))
    odom[1:F + 1, :2] = pos - pos[0]
    odom = odom + rng.normal(0, 0.002, odom.shape)
    ds = Dataset(param=MapParam(W, H, resol, ori_x, ori_y), map_value=g,
                 odom=odom, frames=frames, name=f"synth{seed}")
    return Scene(dataset=ds, true_pos=pos, walls=walls)


def wall_lines(walls: np.ndarray) -> np.ndarray:
    """(n, 10) float64 linesInfo rows for wall segments (the formula of
    geometry.lines_info_from_endpoints, in numpy)."""
    x1, y1, x2, y2 = (walls[:, i].astype(np.float64) for i in range(4))
    with np.errstate(divide="ignore", invalid="ignore"):
        k = (y2 - y1) / (x2 - x1)
        ang = np.arctan(k) * 180.0 / np.pi
        neg = ang < 0
        ang = np.where(neg, ang + 180.0, ang)
        b = (y1 + y2) / 2.0 - k * (x1 + x2) / 2.0
    length = np.sqrt((y2 - y1) ** 2 + (x2 - x1) ** 2)
    return np.stack([k, b, np.cos(ang / 180.0 * np.pi),
                     np.sin(ang / 180.0 * np.pi), x1, y1, x2, y2, length,
                     np.where(neg, -1.0, 1.0)], axis=-1)


def true_pose_px(scene: Scene) -> np.ndarray:
    """(F, 2) true lidar positions in map pixel coordinates (the
    rollout's pose frame: world = px * resol + ori)."""
    p = scene.dataset.param
    return np.stack([(scene.true_pos[:, 0] - p.ori_x) / p.resol,
                     (scene.true_pos[:, 1] - p.ori_y) / p.resol], axis=1)
