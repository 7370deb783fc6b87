"""Scenes and sensor streams from a seed, in numpy (and torch for the
ray marching of many frames at once).

``synth_map``, ``raycast``, ``synth_dataset`` and ``wall_lines`` are a
frozen copy of the port's scene generator (lsdtpu_torch/io/synth.py):
with the settings of the data1 stand-in (979x1440 cells at 0.025 m, 46
interior walls drawn from the seed, wall_scale 2.5, 2.5 m clearance, 13 m
range) ``synth_dataset`` gives the smoke test's scene bit for bit.

The benchmark's streams come from ``walks`` and ``cast_scans``: random
walks that stay inside the clear disc around the map centre (so no
robot walks through a wall), and their 360-ray scans marched on the
device by the copy's arithmetic (the same float64 products and sums,
truncated the same way), returned as ROS LaserScan ranges: float32,
INF where a ray hit nothing.
"""

from __future__ import annotations

import dataclasses

import numpy as np

RESOL = 0.05
ORI_X = -2.0
ORI_Y = -1.5
SCAN_INC = 2.0 * np.pi / 360   # the raycaster's ray step (360 rays)


@dataclasses.dataclass
class Scene:
    grid: np.ndarray        # (H, W) uint8 {0 unknown, 1 occupied, 255 free}
    resol: float
    ori_x: float
    ori_y: float
    odom: np.ndarray        # (F + 1, 3)
    frames: list            # F arrays of (n, 2) [range, angle]
    true_pos: np.ndarray    # (F, 2) meters
    walls: np.ndarray       # (n, 4) [x1 y1 x2 y2] px


def synth_map(seed, H=200, W=260, n_walls=None, clear_px=0.0,
              wall_scale=None, pillars=0):
    """Random room: boundary walls plus interior wall segments, unknown
    cells around it.  Returns (grid, walls)."""
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
    if pillars:
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
    (range, angle) pairs that hit a wall."""
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
                  ori_y=ORI_Y, rmax=10.0, n_walls=None, clear_m=0.0,
                  wall_scale=None, pillars=0) -> Scene:
    """Random-walk trajectory from the map centre + raycast scans +
    noisy odometry."""
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
    return Scene(grid=g, resol=resol, ori_x=ori_x, ori_y=ori_y, odom=odom,
                 frames=frames, true_pos=pos, walls=walls)


def wall_lines(walls: np.ndarray) -> np.ndarray:
    """(n, 10) float64 linesInfo rows for wall segments."""
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


# -- the benchmark's streams ------------------------------------------------

@dataclasses.dataclass
class Building:
    """A deployment's map: the grid, its wall segments and geometry."""
    grid: np.ndarray
    walls: np.ndarray
    resol: float
    ori_x: float
    ori_y: float

    @property
    def centre(self):
        H, W = self.grid.shape
        return (self.ori_x + W / 2 * self.resol,
                self.ori_y + H / 2 * self.resol)


def building(config: dict, seed: int) -> Building:
    """The configuration's map drawn from ``seed``."""
    H, W = config["rows"], config["cols"]
    g, walls = synth_map(seed, H, W, config["interior_walls"],
                         config["clear_m"] / config["resol"],
                         config["wall_scale"])
    return Building(g, walls, config["resol"], config["ori_x"],
                    config["ori_y"])


@dataclasses.dataclass
class Walk:
    pos: np.ndarray     # (F, 2) meters
    odom: np.ndarray    # (F, 3) the cumulative odometry read at each frame
    scans: np.ndarray   # (F, 360) float32 ROS ranges, INF where no hit


def walk_positions(rng, start, F, step_m, radius_m):
    """A random walk of F positions from ``start``: uniform steps of up to
    ``step_m`` on each axis, a step that would leave the disc of
    ``radius_m`` around the start drawn again."""
    pos = np.zeros((F, 2))
    pos[0] = start
    for f in range(1, F):
        while True:
            p = pos[f - 1] + rng.uniform(-step_m, step_m, 2)
            if np.hypot(*(p - pos[0])) <= radius_m:
                break
        pos[f] = p
    return pos


def walks(b: Building, seed: int, n_walks: int, F: int, rmax: float,
          step_m: float, radius_m: float, device="cpu") -> list:
    """``n_walks`` walks of F frames on building ``b`` from ``seed``, with
    noisy odometry (2 mm) and noisy ranges (3 mm), as the copy's
    synth_dataset draws them."""
    out = []
    for w in range(n_walks):
        rng = np.random.default_rng([seed, 7, w])
        pos = walk_positions(rng, b.centre, F, step_m, radius_m)
        odom = np.zeros((F, 3))
        odom[:, :2] = pos - pos[0]
        odom = odom + rng.normal(0, 0.002, odom.shape)
        r = cast_scans(b, pos, rmax, device)
        hit = np.isfinite(r)
        r[hit] = r[hit] + rng.normal(0, 0.003, int(hit.sum()))
        out.append(Walk(pos, odom, r.astype(np.float32)))
    return out


def cast_scans(b: Building, pos: np.ndarray, rmax: float, device="cpu",
               chunk: int = 32) -> np.ndarray:
    """(F, 360) float64 ranges of ``raycast`` at each position (INF where
    a ray hit nothing), marched on ``device`` in chunks of frames."""
    import torch
    dev = torch.device(device)
    H, W = b.grid.shape
    n = 360
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    steps = np.arange(0.05, rmax, 0.01)
    g = torch.as_tensor(b.grid == 1, device=dev)
    cos = torch.as_tensor(np.cos(ang)[:, None], device=dev)
    sin = torch.as_tensor(np.sin(ang)[:, None], device=dev)
    st = torch.as_tensor(steps[None, :], device=dev)
    dx, dy = cos * st, sin * st          # the copy's products, (n, S)
    out = np.empty((len(pos), n))
    for c0 in range(0, len(pos), chunk):
        p = torch.as_tensor(pos[c0:c0 + chunk], device=dev)
        X = p[:, 0, None, None] + dx
        Y = p[:, 1, None, None] + dy
        ix = ((X - b.ori_x) / b.resol + 0.5).to(torch.int64).clamp(0, W - 1)
        iy = ((Y - b.ori_y) / b.resol + 0.5).to(torch.int64).clamp(0, H - 1)
        occ = g[iy, ix]
        hit = occ.any(-1)
        first = occ.to(torch.uint8).argmax(-1)
        r = torch.where(hit, st[0][first], torch.inf)
        out[c0:c0 + chunk] = r.cpu().numpy()
    return out


def ros_to_polar(ranges, angle_min=0.0, inc=SCAN_INC):
    """A ROS LaserScan's valid points (INF dropped), angles rebuilt as
    angle_min + i * inc in float64: what the reference reads."""
    r = np.asarray(ranges, np.float64)
    a = angle_min + np.arange(r.shape[0], dtype=np.float64) * inc
    keep = np.isfinite(r)
    return r[keep], a[keep]


def cycle_index(F: int, start: int, t: int, direction: int = 1) -> int:
    """Frame index at step t of a walk of F frames replayed forwards and
    then backwards (0 .. F-1, F-2 .. 1, 0 ..., period 2F - 2), starting
    at position ``start`` of that cycle and moving in ``direction``."""
    period = 2 * F - 2
    k = (start + direction * t) % period
    return k if k < F else period - k
