"""Numpy oracle for the map pipeline: mapCache + Line Segment Detector.

This module re-implements, in plain numpy/Python, the exact numeric
semantics of the reference map pipeline (reference: LSD/myLSD.cpp), in
double precision, including the behavioral quirks catalogued in
SURVEY.md section 2.1:

  * input occupancy grid is remapped 1<->255 in place, skipping row 0 and
    column 0 (myLSD.cpp:135-142);
  * the mapCache BFS assigns each newly claimed cell the distance of its
    *parent* to the wavefront source, not its own (myLSD.cpp:47-58), and
    the cap test uses the parent distance too;
  * region growth is FIFO with the running circular-mean angle updated
    after every accepted pixel (myLSD.cpp:520-560), repeated until a full
    pass accepts nothing;
  * seeds with region size below regThre leave usedMap untouched
    (myLSD.cpp:228-230); NFA-rejected regions mark usedMap=2 and value-2
    pixels may be re-grown later since only value 1 bans growth
    (myLSD.cpp:242-250, 534);
  * the (0,0) pixel acts as an out-of-bounds sentinel in the rasterizer
    and is never drawn (myLSD.cpp:325-355).

Deliberate deviations from the reference (documented, UB in C++):
  * RegionRadiusReducer's removal loop reads one element past the live
    region (`i <= num`, myLSD.cpp:779); the phantom slot is (0,0) on
    this platform (fresh sbrk heap / NULLed swap slot) and its "drop"
    kills the real last point - REPLICATED deterministically (see
    region_radius_reducer);
  * the lineIm marking loop can overrun the sampled array when the
    floor/ceil spans disagree with the range comparison (myLSD.cpp:325);
    we mark exactly the sampled points;
  * seed order among equal quantized gradient bins follows a *stable*
    descending sort (row-major tie order); the reference uses unstable
    qsort so tie order is implementation-defined.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import List, Optional, Tuple

import numpy as np

PI = math.pi


# ---------------------------------------------------------------------------
# mapCache (reference: createMapCache, LSD/myLSD.cpp:11-127)
# ---------------------------------------------------------------------------

def create_map_cache(map_gray: np.ndarray, res: float,
                     z_occ_max_dis: float = 1.0) -> np.ndarray:
    """Approximate BFS distance field used as the matching prior.

    map_gray: (row, col) uint8 occupancy, occupied == 1 (pre-remap values).
    Returns (row, col) float64 distances in meters, capped at z_occ_max_dis.
    """
    cell_radius = int(math.floor(z_occ_max_dis / res))
    height, width = map_gray.shape
    cache = np.full((height, width), z_occ_max_dis, dtype=np.float64)
    flag = np.zeros((height, width), dtype=np.uint8)

    occ_i, occ_j = np.nonzero(map_gray == 1)
    cache[occ_i, occ_j] = 0.0
    flag[occ_i, occ_j] = 1
    # queue entries: (src_i, src_j, cur_i, cur_j), FIFO, row-major seeds.
    q = deque(zip(occ_i.tolist(), occ_j.tolist(),
                  occ_i.tolist(), occ_j.tolist()))

    while q:
        src_i, src_j, cur_i, cur_j = q.popleft()
        # parent distance: reference computes this once per neighbor but it
        # only depends on (cur, src) so hoist it.
        di = abs(cur_i - src_i)
        dj = abs(cur_j - src_j)
        dist = math.sqrt(di * di + dj * dj)
        within = dist <= cell_radius
        # neighbor order matters: up, left, down, right (myLSD.cpp:46-122)
        for ni, nj in ((cur_i - 1, cur_j), (cur_i, cur_j - 1),
                       (cur_i + 1, cur_j), (cur_i, cur_j + 1)):
            if 0 <= ni < height and 0 <= nj < width and flag[ni, nj] == 0:
                if within:
                    cache[ni, nj] = dist * res   # parent's distance (quirk)
                    flag[ni, nj] = 1
                    q.append((src_i, src_j, ni, nj))
    return cache


# ---------------------------------------------------------------------------
# Gaussian downsampler (reference: GaussianSampler, LSD/myLSD.cpp:378-484)
# ---------------------------------------------------------------------------

def gaussian_kernels(sca: float, sig: float) -> Tuple[np.ndarray, int]:
    """The three phase-shifted normalized kernels (V1.1 x%3 optimization).

    Returns (kernels[3, hSize], h).
    """
    prec = 3
    if sca < 1:
        sig = sig / sca
    h = int(math.ceil(sig * math.sqrt(2 * prec * math.log(10))))
    h_size = 1 + 2 * h
    k = np.arange(h_size, dtype=np.float64)
    # math.exp == glibc exp (what the compiled reference calls); np.exp
    # is numpy's SIMD implementation and differs at the last ulp on
    # some inputs, which poisons every Gaussian output downstream
    # (measured: 4/51 taps differ - parity_trace.py)
    _exp = np.vectorize(math.exp, otypes=[np.float64])
    ker = np.stack([
        _exp(-0.5 * ((k - h) / sig) ** 2),
        _exp(-0.5 * ((k - h - 1.0 / 3) / sig) ** 2),
        _exp(-0.5 * ((k - h + 1.0 / 3) / sig) ** 2),
    ])
    # normalize by the SEQUENTIAL tap sum (kerSum += kerVal[k], one
    # rounded add per tap, myLSD.cpp:404-411) - np.sum's 8-accumulator
    # pairwise loop rounds differently at the last ulp, and that ulp
    # propagates through the convolution into the gradient bins and
    # flips seed order vs the compiled reference (parity_trace.py)
    for r in range(3):
        s = 0.0
        for v in ker[r].tolist():
            s += v
        ker[r] /= s
    return ker, h


def _reflect_indices(centers: np.ndarray, h: int, lim: int) -> np.ndarray:
    """Symmetric boundary reflection over a doubled domain (myLSD.cpp:434-444)."""
    idx = centers[:, None] + (np.arange(2 * h + 1)[None, :] - h)
    dou = 2 * lim
    idx = np.mod(idx, dou)
    idx = np.where(idx >= lim, dou - idx - 1, idx)
    return idx


def gaussian_sampler(image: np.ndarray, sca: float, sig: float) -> np.ndarray:
    """Separable Gaussian blur + subsample; image is (row, col) uint8."""
    y_lim, x_lim = image.shape
    new_x = int(math.floor(x_lim * sca))
    new_y = int(math.floor(y_lim * sca))
    ker, h = gaussian_kernels(sca, sig)

    xs = np.arange(new_x)
    xc = np.floor(xs / sca + 0.5).astype(np.int64)
    jx = _reflect_indices(xc, h, x_lim)             # (new_x, hSize)
    kx = ker[xs % 3]                                # (new_x, hSize)
    img = image.astype(np.float64)
    # aux[y, x] = sum_i img[y, jx[x, i]] * kx[x, i], accumulated IN TAP
    # ORDER (newVal += image[j] * kerVal[i], myLSD.cpp:434-445): each
    # add is one rounded double op exactly like the reference; einsum's
    # dot-product reduction rounds differently at the last ulp (see
    # gaussian_kernels note)
    aux = np.zeros((y_lim, new_x), dtype=np.float64)
    for i in range(2 * h + 1):
        aux += img[:, jx[:, i]] * kx[None, :, i]

    ys = np.arange(new_y)
    yc = np.floor(ys / sca + 0.5).astype(np.int64)
    jy = _reflect_indices(yc, h, y_lim)             # (new_y, hSize)
    ky = ker[ys % 3]
    new_image = np.zeros((new_y, new_x), dtype=np.float64)
    for i in range(2 * h + 1):
        new_image += aux[jy[:, i], :] * ky[:, i, None]
    return new_image


# ---------------------------------------------------------------------------
# Gradient / level-line field (reference: LSD/myLSD.cpp:145-174)
# ---------------------------------------------------------------------------

def gradient_field(gauss: np.ndarray, deg_thre: float
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """2x2 finite-difference gradient; returns (magMap, degMap, usedMap, maxGrad).

    usedMap is 1 where the gradient is below gradThre (pre-banned).
    Row 0 and column 0 are never written (stay 0).
    """
    rows, cols = gauss.shape
    mag = np.zeros((rows, cols), dtype=np.float64)
    deg = np.zeros((rows, cols), dtype=np.float64)
    used = np.zeros((rows, cols), dtype=np.uint8)
    grad_thre = 2.0 / math.sin(deg_thre)

    a = gauss[1:, 1:]
    b = gauss[1:, :-1]
    c = gauss[:-1, 1:]
    d = gauss[:-1, :-1]
    gx = (b + d - a - c) / 2.0
    gy = (c + d - a - b) / 2.0
    m = np.sqrt(gx * gx + gy * gy)     # np.sqrt is IEEE-exact
    # glibc atan2 exactly (np.arctan2 differs at the last ulp on ~7%
    # of inputs - the degMap feeds growth accepts and angle sums)
    v = np.frompyfunc(math.atan2, 2, 1)(gx, -gy).astype(np.float64)
    v = np.where(np.abs(v - PI) < 1e-6, 0.0, v)
    mag[1:, 1:] = m
    deg[1:, 1:] = v
    used[1:, 1:] = (m < grad_thre).astype(np.uint8)
    max_grad = float(m.max()) if m.size else 0.0
    return mag, deg, used, max_grad


def seed_order(mag: np.ndarray, pse_bin: int, max_grad: float
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Quantize gradients to pse_bin bins and sort seeds descending.

    Returns (ys, xs) of nonzero-bin pixels, stable-sorted by bin value
    descending (reference uses unstable qsort: tie order differs).
    """
    zoom = 1.0 * pse_bin / max_grad
    q = np.floor(mag * zoom).astype(np.int64)
    q = np.minimum(q, pse_bin)
    ys, xs = np.nonzero(q)
    vals = q[ys, xs]
    order = np.argsort(-vals, kind='stable')
    return ys[order], xs[order]


# ---------------------------------------------------------------------------
# Region growing (reference: RegionGrower, LSD/myLSD.cpp:491-590)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Region:
    x: int                  # seed x
    y: int                  # seed y
    deg: float              # running circular-mean angle (radians)
    xs: np.ndarray          # region pixel x coords, FIFO order
    ys: np.ndarray          # region pixel y coords


def region_grower(x: int, y: int, ban_map: np.ndarray, reg_deg: float,
                  deg_map: np.ndarray, deg_thre: float
                  ) -> Tuple[np.ndarray, Region]:
    """FIFO region growth with per-pixel running angle update.

    Returns (cur_map uint8, Region).  Only ban_map == 1 blocks growth
    (value 2 = NFA-rejected pixels may be re-absorbed, myLSD.cpp:534).
    """
    y_lim, x_lim = ban_map.shape
    cur = np.zeros((y_lim, x_lim), dtype=np.uint8)
    cur[y, x] = 1
    sin_deg = math.sin(reg_deg)
    cos_deg = math.cos(reg_deg)
    pts_x = [x]
    pts_y = [y]
    grow = 1
    ex = 0
    while ex != grow:
        ex = grow
        i = 0
        while i < grow:   # list keeps extending within the pass (FIFO)
            rx = pts_x[i]
            ry = pts_y[i]
            for m in range(ry - 1, ry + 2):
                for n in range(rx - 1, rx + 2):
                    if 0 <= m < y_lim and 0 <= n < x_lim:
                        if cur[m, n] != 1 and ban_map[m, n] != 1:
                            cur_deg = deg_map[m, n]
                            deg_dif = abs(reg_deg - cur_deg)
                            if deg_dif > PI * 3 / 2.0:
                                deg_dif = abs(deg_dif - 2.0 * PI)
                            if deg_dif < deg_thre:
                                cos_deg += math.cos(cur_deg)
                                sin_deg += math.sin(cur_deg)
                                reg_deg = math.atan2(sin_deg, cos_deg)
                                cur[m, n] = 1
                                grow += 1
                                pts_x.append(n)
                                pts_y.append(m)
            i += 1
    reg = Region(x=x, y=y, deg=reg_deg,
                 xs=np.asarray(pts_x, dtype=np.int64),
                 ys=np.asarray(pts_y, dtype=np.int64))
    return cur, reg


# ---------------------------------------------------------------------------
# Rectangle fitting (reference: LSD/myLSD.cpp:592-734)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Rect:
    x1: float
    y1: float
    x2: float
    y2: float
    wid: float
    c_x: float
    c_y: float
    deg: float
    dx: float
    dy: float
    p: float
    prec: float


def _seq_sum(a: np.ndarray) -> float:
    """Strict left-to-right accumulation - one rounded add per element,
    exactly like the reference's `s += v` loops.  np.sum uses pairwise/
    unrolled partial accumulators whose last-ulp rounding differs, and
    that ulp propagates into seed bins and rectangle endpoints
    (scripts/refbench/parity_trace.py).  np.add.accumulate is
    sequential by definition (it must produce every prefix)."""
    a = np.asarray(a, dtype=np.float64)
    return float(np.add.accumulate(a)[-1]) if a.size else 0.0


def center_getter(xs: np.ndarray, ys: np.ndarray, wei_map: np.ndarray
                  ) -> Tuple[float, float]:
    w = wei_map[ys, xs]
    ws = _seq_sum(w)
    return _seq_sum(w * xs) / ws, _seq_sum(w * ys) / ws


def orientation_getter(reg: Region, cen_x: float, cen_y: float,
                       wei_map: np.ndarray, deg_thre: float) -> float:
    w = wei_map[reg.ys, reg.xs]
    ws = _seq_sum(w)
    dx = reg.xs - cen_x
    dy = reg.ys - cen_y
    # term grouping mirrors the reference exactly: Ixx += w*pow(dy,2)
    # = w*(dy*dy); Ixy -= (w*dx)*dy (myLSD.cpp:638-642); negating after
    # the sum is exact (symmetric rounding)
    ixx = _seq_sum(w * (dy * dy)) / ws
    iyy = _seq_sum(w * (dx * dx)) / ws
    ixy = -_seq_sum((w * dx) * dy) / ws
    lamb = (ixx + iyy - math.sqrt((ixx - iyy) ** 2 + 4 * ixy * ixy)) / 2.0
    if abs(ixx) > abs(iyy):
        inertia = math.atan2(lamb - ixx, ixy)
    else:
        inertia = math.atan2(ixy, lamb - iyy)
    reg_dif = inertia - reg.deg
    while reg_dif <= -PI:
        reg_dif += 2 * PI
    while reg_dif > PI:
        reg_dif -= 2 * PI
    if reg_dif < 0:
        reg_dif = -reg_dif
    if reg_dif > deg_thre:
        inertia += PI
    return inertia


def rectangle_converter(reg: Region, mag_map: np.ndarray, ali_pro: float,
                        deg_thre: float) -> Rect:
    cen_x, cen_y = center_getter(reg.xs, reg.ys, mag_map)
    inertia = orientation_getter(reg, cen_x, cen_y, mag_map, deg_thre)
    dx = math.cos(inertia)
    dy = math.sin(inertia)
    lx = (reg.xs - cen_x) * dx + (reg.ys - cen_y) * dy
    wx = -(reg.xs - cen_x) * dy + (reg.ys - cen_y) * dx
    len_min = min(0.0, float(lx.min()))
    len_max = max(0.0, float(lx.max()))
    wid_min = min(0.0, float(wx.min()))
    wid_max = max(0.0, float(wx.max()))
    rec = Rect(
        x1=cen_x + len_min * dx, y1=cen_y + len_min * dy,
        x2=cen_x + len_max * dx, y2=cen_y + len_max * dy,
        wid=wid_max - wid_min, c_x=cen_x, c_y=cen_y,
        deg=inertia, dx=dx, dy=dy, p=ali_pro, prec=deg_thre)
    if rec.wid < 1:
        rec.wid = 1.0
    return rec


def _density(reg: Region, rec: Rect) -> float:
    return len(reg.xs) / (math.sqrt((rec.x1 - rec.x2) ** 2 +
                                    (rec.y1 - rec.y2) ** 2) * rec.wid)


def region_radius_reducer(reg: Region, rec: Rect, den_thre: float,
                          cur_map: np.ndarray, mag_map: np.ndarray
                          ) -> Tuple[bool, np.ndarray, Region, Rect]:
    """Shrink the region radius x0.75 until density passes (myLSD.cpp:736-802),
    including the `i <= num` phantom-slot behavior (see inline note)."""
    den = _density(reg, rec)
    if den > den_thre:
        return True, cur_map, reg, rec
    ori_x, ori_y = reg.x, reg.y
    # sqrt(pow(dx,2)+pow(dy,2)) exactly (myLSD.cpp:752-753); math.hypot
    # rounds differently
    rad1 = math.sqrt((ori_x - rec.x1) ** 2 + (ori_y - rec.y1) ** 2)
    rad2 = math.sqrt((ori_x - rec.x2) ** 2 + (ori_y - rec.y2) ** 2)
    rad = rad1 if rad1 > rad2 else rad2
    xs, ys = list(reg.xs.tolist()), list(reg.ys.tolist())
    while den < den_thre:
        rad *= 0.75
        # swap-with-last removal IN ORDER (myLSD.cpp:780-787): the point
        # order fed to RectangleConverter is this exact permutation (its
        # weighted sums accumulate sequentially, so order matters).
        i = 0
        while i < len(xs):
            dsq = (ori_x - xs[i]) ** 2 + (ori_y - ys[i]) ** 2
            if math.sqrt(dsq) > rad:
                cur_map[ys[i], xs[i]] = 0
                xs[i] = xs[-1]
                ys[i] = ys[-1]
                xs.pop()
                ys.pop()
            else:
                i += 1
        # the reference's loop runs `i <= num` (myLSD.cpp:779): the final
        # iteration reads ONE SLOT PAST the live array.  That slot holds
        # (0, 0) both on fresh heap (sbrk-zeroed) and after any in-pass
        # swap removal (the vacated slot is NULLed, myLSD.cpp:784-785) -
        # verified against the compiled binary (parity_trace.py seed
        # 352).  (0,0) is essentially always farther than rad, so the
        # phantom "drop" kills the REAL last point: it vanishes from the
        # region while its curMap pixel stays set (only curMap[0][0] is
        # cleared), exactly as below.
        if math.sqrt(ori_x ** 2 + ori_y ** 2) > rad and xs:
            cur_map[0, 0] = 0
            xs.pop()
            ys.pop()
        if len(xs) < 2:
            return False, cur_map, reg, rec
        reg = Region(x=reg.x, y=reg.y, deg=reg.deg,
                     xs=np.asarray(xs, dtype=np.int64),
                     ys=np.asarray(ys, dtype=np.int64))
        rec = rectangle_converter(reg, mag_map, rec.p, rec.prec)
        den = _density(reg, rec)
    return True, cur_map, reg, rec


def refiner(reg: Region, rec: Rect, den_thre: float, deg_map: np.ndarray,
            ban_map: np.ndarray, cur_map: np.ndarray, mag_map: np.ndarray
            ) -> Tuple[bool, np.ndarray, Region, Rect]:
    """Re-estimate the angle tolerance and regrow (myLSD.cpp:804-880)."""
    den = _density(reg, rec)
    if den >= den_thre:
        return True, cur_map, reg, rec
    ori_x, ori_y = reg.x, reg.y
    cen_deg = deg_map[ori_y, ori_x]
    # sqrt of exact integer squares == hypot here, but keep the C++ form
    ddx = (ori_x - reg.xs).astype(np.float64)
    ddy = (ori_y - reg.ys).astype(np.float64)
    near = np.sqrt(ddx * ddx + ddy * ddy) < rec.wid
    cur_degs = deg_map[reg.ys[near], reg.xs[near]]
    deg_dif = cur_degs - cen_deg
    # wrap to (-pi, pi] by REPEATED +-2pi exactly like the reference's
    # while loops (myLSD.cpp:845-850): each correction is one rounded
    # add, and np.mod rounds differently at the last ulp
    while True:
        low = deg_dif <= -PI
        if not low.any():
            break
        deg_dif = np.where(low, deg_dif + 2 * PI, deg_dif)
    while True:
        high = deg_dif > PI
        if not high.any():
            break
        deg_dif = np.where(high, deg_dif - 2 * PI, deg_dif)
    dif_sum = _seq_sum(deg_dif)
    squ_sum = _seq_sum(deg_dif * deg_dif)
    pt_num = int(near.sum())
    mean_dif = dif_sum / pt_num if pt_num else float('nan')
    deg_thre = 2.0 * math.sqrt(
        (squ_sum - 2 * mean_dif * dif_sum) / pt_num + mean_dif * mean_dif
    ) if pt_num else float('nan')
    cur_map2, reg2 = region_grower(ori_x, ori_y, ban_map, cen_deg,
                                   deg_map, deg_thre)
    if len(reg2.xs) < 2:
        return False, cur_map2, reg2, rec
    rec2 = rectangle_converter(reg2, mag_map, rec.p, rec.prec)
    den = _density(reg2, rec2)
    if den < den_thre:
        return region_radius_reducer(reg2, rec2, den_thre, cur_map2, mag_map)
    return True, cur_map2, reg2, rec2


# ---------------------------------------------------------------------------
# NFA validation (reference: LSD/myLSD.cpp:882-1158)
# ---------------------------------------------------------------------------

def log_gamma(x: int) -> float:
    """Windschitl approx above 15, Lanczos below (myLSD.cpp:882-924)."""
    if x > 15:
        return (0.918938533204673 + (x - 0.5) * math.log(x) - x +
                0.5 * x * math.log(x * math.sinh(1.0 / x) +
                                   1.0 / (810 * x ** 6)))
    q = (75122.6331530, 80916.6278952, 36308.2951477, 8687.24529705,
         1168.92649479, 83.8676043424, 2.50662827511)
    a = (x + 0.5) * math.log(x + 5.5) - (x + 5.5)
    b = 0.0
    for i in range(7):
        a -= math.log(x + i)
        b += q[i] * x ** i
    return a + math.log(b)


def _c_log10(v: float) -> float:
    """C's log10: -inf at 0.  A long, well aligned rectangle's binomial
    term underflows to 0.0 (exp of a log below -745); the reference then
    takes log10(0) = -inf, an infinite NFA score, where math.log10
    raises."""
    return -math.inf if v == 0.0 else math.log10(v)


def rectangle_nfa(rec: Rect, deg_map: np.ndarray, log_nt: float) -> float:
    """-log10 NFA of the rectangle via the binomial tail (myLSD.cpp:926-1059).

    Note: the reference's global fold of degMap into [0, pi) here is a
    no-op because atan2 output never exceeds pi (pi itself is snapped to 0
    in gradient_field), so we skip it.
    """
    y_lim, x_lim = deg_map.shape
    ver_x = [rec.x1 - rec.dy * rec.wid / 2.0,
             rec.x2 - rec.dy * rec.wid / 2.0,
             rec.x2 + rec.dy * rec.wid / 2.0,
             rec.x1 + rec.dy * rec.wid / 2.0]
    ver_y = [rec.y1 + rec.dx * rec.wid / 2.0,
             rec.y2 + rec.dx * rec.wid / 2.0,
             rec.y2 - rec.dx * rec.wid / 2.0,
             rec.y1 - rec.dx * rec.wid / 2.0]
    if rec.x1 < rec.x2 and rec.y1 <= rec.y2:
        off = 0
    elif rec.x1 >= rec.x2 and rec.y1 < rec.y2:
        off = 1
    elif rec.x1 > rec.x2 and rec.y1 >= rec.y2:
        off = 2
    else:
        off = 3
    vx = [ver_x[(off + i) % 4] for i in range(4)]
    vy = [ver_y[(off + i) % 4] for i in range(4)]

    x_start = math.ceil(vx[0])
    x_len = abs(int(math.ceil(vx[0]) - math.floor(vx[2]))) + 1
    with np.errstate(divide='ignore', invalid='ignore'):
        ks = [
            float(np.float64(vy[1] - vy[0]) / np.float64(vx[1] - vx[0])),
            float(np.float64(vy[2] - vy[1]) / np.float64(vx[2] - vx[1])),
            float(np.float64(vy[2] - vy[3]) / np.float64(vx[2] - vx[3])),
            float(np.float64(vy[3] - vy[0]) / np.float64(vx[3] - vx[0])),
        ]
    INT_MIN = -(2 ** 31)

    def _c_ceil(v: float) -> int:
        # x86-64 cvttsd2si: any non-finite / out-of-range double -> INT_MIN
        if not math.isfinite(v) or not (INT_MIN <= v < 2 ** 31):
            return INT_MIN
        return int(math.ceil(v))

    def _c_floor(v: float) -> int:
        if not math.isfinite(v) or not (INT_MIN <= v < 2 ** 31):
            return INT_MIN
        return int(math.floor(v))

    all_pix = 0
    ali_pix = 0
    for i in range(x_len):
        xr = int(i + x_start)
        if xr < vx[3]:
            y_low = _c_ceil(vy[0] + (xr - vx[0]) * ks[3])
        else:
            y_low = _c_ceil(vy[3] + (xr - vx[3]) * ks[2])
        if xr < vx[1]:
            y_high = _c_floor(vy[0] + (xr - vx[0]) * ks[0])
        else:
            y_high = _c_floor(vy[1] + (xr - vx[1]) * ks[1])
        if 0 <= xr < x_lim and y_high >= y_low:
            # only in-bounds rows contribute; clip the loop (equivalent)
            j0 = max(y_low, 0)
            j1 = min(y_high, y_lim - 1)
            if j1 >= j0:
                col = deg_map[j0:j1 + 1, xr]
                all_pix += j1 - j0 + 1
                deg_dif = np.abs(rec.deg - col)
                deg_dif = np.where(deg_dif > PI * 3 / 2.0,
                                   np.abs(deg_dif - 2 * PI), deg_dif)
                ali_pix += int((deg_dif < rec.prec).sum())
    if all_pix == 0 or ali_pix == 0:
        return -log_nt
    if all_pix == ali_pix:
        return -log_nt - all_pix * math.log10(rec.p)
    pro_term = rec.p / (1.0 - rec.p)
    log1_coef = (log_gamma(all_pix + 1) - log_gamma(ali_pix + 1) -
                 log_gamma(all_pix - ali_pix + 1))
    log1_term = (log1_coef + ali_pix * math.log(rec.p) +
                 (all_pix - ali_pix) * math.log(1 - rec.p))
    term = math.exp(log1_term)
    eps = 2.2204e-16
    if abs(term) < 100 * eps:
        if ali_pix > all_pix * rec.p:
            return -_c_log10(term) - log_nt
        return -log_nt
    bin_tail = term
    tole = 0.1
    for i in range(ali_pix + 1, all_pix + 1):
        bin_term = (all_pix - i + 1) / (i * 1.0)
        mult_term = bin_term * pro_term
        term *= mult_term
        bin_tail += term
        if bin_term < 1:
            err = term * ((1 - mult_term ** (all_pix - i + 1)) /
                          (1.0 - mult_term) - 1)
            if err < tole * abs(-_c_log10(bin_tail) - log_nt) * bin_tail:
                break
    return -_c_log10(bin_tail) - log_nt


def rectangle_improver(rec: Rect, deg_map: np.ndarray, log_nt: float
                       ) -> Tuple[float, Rect]:
    """Greedy NFA improvement: 5x p/2, 5x wid-0.5, 5x each side shift,
    5x p/2 (myLSD.cpp:1061-1158)."""
    delt = 0.5
    delt2 = delt / 2.0
    log_nfa = rectangle_nfa(rec, deg_map, log_nt)
    if log_nfa > 0:
        return log_nfa, rec
    best = rec

    new = dataclasses.replace(best)
    for _ in range(5):
        new.p /= 2.0
        new.prec = new.p * PI
        nfa = rectangle_nfa(new, deg_map, log_nt)
        if nfa > log_nfa:
            log_nfa = nfa
            best = dataclasses.replace(new)
    if log_nfa > 0:
        return log_nfa, best

    new = dataclasses.replace(best)
    for _ in range(5):
        if new.wid - delt >= 0.5:
            new.wid -= delt
            nfa = rectangle_nfa(new, deg_map, log_nt)
            if nfa > log_nfa:
                log_nfa = nfa
                best = dataclasses.replace(new)
    if log_nfa > 0:
        return log_nfa, best

    new = dataclasses.replace(best)
    for _ in range(5):
        if new.wid - delt >= 0.5:
            new.x1 -= new.dy * delt2
            new.y1 += new.dx * delt2
            new.x2 -= new.dy * delt2
            new.y2 += new.dx * delt2
            new.wid -= delt
            nfa = rectangle_nfa(new, deg_map, log_nt)
            if nfa > log_nfa:
                log_nfa = nfa
                best = dataclasses.replace(new)
    if log_nfa > 0:
        return log_nfa, best

    new = dataclasses.replace(best)
    for _ in range(5):
        if new.wid - delt >= 0.5:
            new.x1 += new.dy * delt2
            new.y1 -= new.dx * delt2
            new.x2 += new.dy * delt2
            new.y2 -= new.dx * delt2
            new.wid -= delt
            nfa = rectangle_nfa(new, deg_map, log_nt)
            if nfa > log_nfa:
                log_nfa = nfa
                best = dataclasses.replace(new)
    if log_nfa > 0:
        return log_nfa, best

    new = dataclasses.replace(best)
    for _ in range(5):
        new.p /= 2.0
        new.prec = new.p * PI
        nfa = rectangle_nfa(new, deg_map, log_nt)
        if nfa > log_nfa:
            log_nfa = nfa
            best = dataclasses.replace(new)
    return log_nfa, best


# ---------------------------------------------------------------------------
# LSD driver (reference: myLineSegmentDetector, LSD/myLSD.cpp:129-376)
# ---------------------------------------------------------------------------

def _atand(x: float) -> float:
    return math.atan(x) * 180.0 / PI


def sind(x: float) -> float:
    """Degree sine with the reference's exact op order (baseFunc.cpp:6-8)."""
    return math.sin(x / 180.0 * PI)


def cosd(x: float) -> float:
    return math.cos(x / 180.0 * PI)


def c_round(v: np.ndarray) -> np.ndarray:
    """C `round()`: half away from zero (np.round is half-to-even)."""
    v = np.asarray(v, dtype=np.float64)
    return np.where(v >= 0, np.floor(v + 0.5),
                    np.ceil(v - 0.5)).astype(np.int64)


def _line_info_from_endpoints(x1: float, y1: float, x2: float, y2: float,
                              col_lim: int, row_lim: int,
                              line_im: Optional[np.ndarray] = None,
                              collect: Optional[list] = None) -> np.ndarray:
    """Shared linesInfo + rasterization semantics (myLSD.cpp:280-368,
    myRDP.cpp:86-176).  Marks line_im in place and appends marked pixels
    to `collect` if given.  Returns the 10-field info row."""
    with np.errstate(divide='ignore', invalid='ignore'):
        k = float(np.float64(y2 - y1) / np.float64(x2 - x1))  # C: +-inf ok
    ang = _atand(k)
    orient = 1
    if ang < 0:
        ang += 180
        orient = -1
    if x1 > x2:
        x_low, x_high = math.floor(x2), math.ceil(x1)
    else:
        x_low, x_high = math.floor(x1), math.ceil(x2)
    if y1 > y2:
        y_low, y_high = math.floor(y2), math.ceil(y1)
    else:
        y_low, y_high = math.floor(y1), math.ceil(y2)
    x_rang, y_rang = abs(x2 - x1), abs(y2 - y1)
    xx_len = int(x_high - x_low + 1)
    yy_len = int(y_high - y_low + 1)
    if x_rang > y_rang:
        xx = np.arange(xx_len, dtype=np.int64) + int(x_low)
        yy = c_round((xx - x1) * k + y1)
    else:
        yy = np.arange(yy_len, dtype=np.int64) + int(y_low)
        with np.errstate(invalid='ignore'):
            xx = c_round((yy - y1) / k + x1)
    oob = (xx < 0) | (xx >= col_lim) | (yy < 0) | (yy >= row_lim)
    xx = np.where(oob, 0, xx)
    yy = np.where(oob, 0, yy)
    mark = (xx != 0) & (yy != 0)   # (0,0) sentinel skip; also drops x==0/y==0
    if line_im is not None:
        # NOTE: reference marks `max(xx_len, yy_len)` entries which can
        # overrun the sampled array (UB); we mark the sampled points only.
        line_im[yy[mark], xx[mark]] = 255
    if collect is not None:
        collect.append(np.stack([xx[mark], yy[mark]], axis=1))
    # vertical lines carry k=+-inf (the reference's raw (y2-y1)/(x2-x1)
    # slope, myLSD.cpp:358-368); inf*0 in the intercept is then the
    # reference's own NaN - keep the value, silence the warning
    with np.errstate(invalid='ignore'):
        b = (y1 + y2) / 2.0 - k * (x1 + x2) / 2.0
    return np.array([k, b,
                     cosd(ang), sind(ang),
                     x1, y1, x2, y2,
                     math.sqrt((y2 - y1) ** 2 + (x2 - x1) ** 2), orient],
                    dtype=np.float64)


@dataclasses.dataclass
class LSDResult:
    line_im: np.ndarray       # (oriMapRow, oriMapCol) uint8
    lines_info: np.ndarray    # (N, 10): k b dx dy x1 y1 x2 y2 len orient


def line_segment_detector(map_gray: np.ndarray, sca: float = 0.3,
                          sig: float = 0.6, ang_thre: float = 22.5,
                          den_thre: float = 0.7, pse_bin: int = 1024
                          ) -> LSDResult:
    """Full LSD forward pass.  NOTE: mutates map_gray in place
    (1<->255 remap skipping row/col 0, myLSD.cpp:135-142), exactly like
    the reference."""
    ori_row, ori_col = map_gray.shape
    new_col = int(math.floor(ori_col * sca))
    new_row = int(math.floor(ori_row * sca))

    sub = map_gray[1:, 1:]
    one = sub == 1
    two55 = sub == 255
    sub[one] = 255
    sub[two55] = 0

    gauss = gaussian_sampler(map_gray, sca, sig)
    deg_thre = ang_thre / 180.0 * PI
    mag_map, deg_map, used_map, max_grad = gradient_field(gauss, deg_thre)
    seed_ys, seed_xs = seed_order(mag_map, pse_bin, max_grad)

    log_nt = 5 * (math.log10(new_row) + math.log10(new_col)) / 2.0
    reg_thre = -log_nt / math.log10(ang_thre / 180.0)
    ali_pro = ang_thre / 180.0

    line_im = np.zeros((ori_row, ori_col), dtype=np.uint8)
    infos: List[np.ndarray] = []
    for y_idx, x_idx in zip(seed_ys.tolist(), seed_xs.tolist()):
        if used_map[y_idx, x_idx] != 0:
            continue
        cur_map, reg = region_grower(x_idx, y_idx, used_map,
                                     deg_map[y_idx, x_idx], deg_map,
                                     deg_thre)
        if len(reg.xs) < reg_thre:
            continue
        rec = rectangle_converter(reg, mag_map, ali_pro, deg_thre)
        ok, cur_map, reg, rec = refiner(reg, rec, den_thre, deg_map,
                                        used_map, cur_map, mag_map)
        if not ok:
            continue
        log_nfa, rec = rectangle_improver(rec, deg_map, log_nt)
        if log_nfa <= 0:
            used_map[cur_map == 1] = 2
            continue
        if sca != 1:
            rec = dataclasses.replace(
                rec,
                x1=(rec.x1 - 1.0) / sca + 1, y1=(rec.y1 - 1.0) / sca + 1,
                x2=(rec.x2 - 1.0) / sca + 1, y2=(rec.y2 - 1.0) / sca + 1,
                wid=(rec.wid - 1.0) / sca + 1)
        used_map[cur_map == 1] = 1
        infos.append(_line_info_from_endpoints(
            rec.x1, rec.y1, rec.x2, rec.y2, ori_col, ori_row, line_im))
    lines = (np.stack(infos, axis=0) if infos
             else np.zeros((0, 10), dtype=np.float64))
    return LSDResult(line_im=line_im, lines_info=lines)
