"""Rectangle fitting over region masks: centroid, inertia orientation,
endpoint projection, density refinement (counterpart of
lsdtpu/mapprep/rect.py, wave growth only).

Reference: CenterGetter/OrientationGetter/RectangleConverter/Refiner/
RegionRadiusReducer, LSD/myLSD.cpp:592-880.  A region is a bool mask
over the downsampled field and every moment is a masked full-field
reduction on the device; the fitted rectangle comes to the host once,
as a dict of numpy scalars of the working dtype (mapprep/nfa.py), and
the density tests and radius bookkeeping run there.  Each host
decision the reference package takes in a ``cond`` or ``while_loop``
is one device -> host read here.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lsdtpu_torch import geometry as geo
from lsdtpu_torch.mapprep.stats import MapPrepStats

PI = math.pi

_REC_KEYS = ("x1", "y1", "x2", "y2", "wid", "c_x", "c_y", "deg", "dx", "dy")


def _coords(mag):
    """(yf (H, 1), xf (1, W)) pixel coordinates in the field's dtype."""
    H, W = mag.shape
    return (torch.arange(H, device=mag.device).to(mag.dtype)[:, None],
            torch.arange(W, device=mag.device).to(mag.dtype)[None, :])


def _wrap_pi(d):
    """Wrap into (-pi, pi] (reference while-loop semantics,
    myLSD.cpp:646-655); floored modulo, as jnp.mod."""
    w = torch.remainder(d + PI, 2 * PI)
    w = torch.where(w == 0.0, 2 * PI, w)
    return w - PI


def rectangle_converter(cur, seed_deg, mag, ali_pro: float, deg_thre: float,
                        stats: MapPrepStats) -> dict:
    """cur: (H, W) bool region mask; seed_deg: () running region angle
    (a tensor on the field's device).  Returns the rectangle as a dict
    of numpy scalars (reference: RectangleConverter, myLSD.cpp:669-734)."""
    yf, xf = _coords(mag)
    w = torch.where(cur, mag, 0.0)
    ws = w.sum()
    cen_x = (w * xf).sum() / ws
    cen_y = (w * yf).sum() / ws
    dxp = xf - cen_x
    dyp = yf - cen_y
    ixx = (w * dyp * dyp).sum() / ws
    iyy = (w * dxp * dxp).sum() / ws
    ixy = -(w * dxp * dyp).sum() / ws
    dif = ixx - iyy
    lamb = (ixx + iyy - geo.sqrt(dif * dif + 4 * ixy * ixy)) / 2.0
    inertia = torch.where(torch.abs(ixx) > torch.abs(iyy),
                          torch.atan2(lamb - ixx, ixy),
                          torch.atan2(ixy, lamb - iyy))
    reg_dif = torch.abs(_wrap_pi(inertia - seed_deg))
    inertia = torch.where(reg_dif > deg_thre, inertia + PI, inertia)
    dxu = torch.cos(inertia)
    dyu = torch.sin(inertia)
    lx = dxp * dxu + dyp * dyu
    wx = -dxp * dyu + dyp * dxu
    len_min = torch.clamp(torch.where(cur, lx, torch.inf).min(), max=0.0)
    len_max = torch.clamp(torch.where(cur, lx, -torch.inf).max(), min=0.0)
    wid_min = torch.clamp(torch.where(cur, wx, torch.inf).min(), max=0.0)
    wid_max = torch.clamp(torch.where(cur, wx, -torch.inf).max(), min=0.0)
    wid = torch.clamp(wid_max - wid_min, min=1.0)
    vals = stats.to_host(torch.stack([
        cen_x + len_min * dxu, cen_y + len_min * dyu,
        cen_x + len_max * dxu, cen_y + len_max * dyu,
        wid, cen_x, cen_y, inertia, dxu, dyu]))
    rec = dict(zip(_REC_KEYS, vals))
    t = vals.dtype.type
    rec["p"] = t(ali_pro)
    rec["prec"] = t(deg_thre)
    return rec


def density(n: int, rec) -> np.generic:
    """Region pixels over rectangle area, on the host; n is the region's
    pixel count."""
    t = type(rec["x1"])
    dx = rec["x1"] - rec["x2"]
    dy = rec["y1"] - rec["y2"]
    length = np.sqrt(dx * dx + dy * dy)
    with np.errstate(all="ignore"):
        return t(n) / (length * rec["wid"])


def _seed_distance(seed_x: int, seed_y: int, mag):
    """(H, W) Euclidean distance of every pixel from the seed."""
    yf, xf = _coords(mag)
    dx = xf - float(seed_x)
    dy = yf - float(seed_y)
    return geo.sqrt(dx * dx + dy * dy)


def radius_reducer(seed_x: int, seed_y: int, seed_deg, cur, n: int, rec,
                   mag, den_thre: float, deg_thre: float,
                   stats: MapPrepStats):
    """Shrink the radius x0.75, dropping far pixels, until dense enough
    (reference: RegionRadiusReducer, myLSD.cpp:736-802).  n is cur's
    pixel count.  Returns (ok, cur, rec)."""
    t = type(rec["x1"])
    d_seed = _seed_distance(seed_x, seed_y, mag)
    sx, sy = t(seed_x), t(seed_y)

    def dist(x, y):
        dx, dy = sx - x, sy - y
        return np.sqrt(dx * dx + dy * dy)

    rad = np.maximum(dist(rec["x1"], rec["y1"]), dist(rec["x2"], rec["y2"]))
    den = density(n, rec)
    alive = n >= 2
    while alive and den < t(den_thre):
        rad = rad * t(0.75)
        cur = cur & (d_seed <= float(rad))
        n = int(stats.to_host(cur.sum()))
        alive = n >= 2
        if alive:
            rec = rectangle_converter(cur, seed_deg, mag, rec["p"], deg_thre,
                                      stats)
            den = density(n, rec)
    return alive, cur, rec


def refiner(seed_x: int, seed_y: int, cur, n: int, rec, mag, deg_map,
            den_thre: float, deg_thre: float, grow_fn, stats: MapPrepStats):
    """Re-estimate the angle tolerance from pixels near the seed and
    regrow (reference: Refiner, myLSD.cpp:804-880).  grow_fn(cen_deg,
    new_thre) -> (cur, reg_deg, n) regrows from the seed.  n is cur's
    pixel count.  Returns (ok, cur, rec)."""
    t = type(rec["x1"])
    if density(n, rec) >= t(den_thre):
        return True, cur, rec
    H, W = mag.shape
    d_seed = _seed_distance(seed_x, seed_y, mag)
    cen_deg = deg_map[min(max(seed_y, 0), H - 1), min(max(seed_x, 0), W - 1)]
    near = cur & (d_seed < float(rec["wid"]))
    difm = torch.where(near, _wrap_pi(deg_map - cen_deg), 0.0)
    dif_sum = difm.sum()
    squ_sum = (difm * difm).sum()
    n_near = near.sum().to(mag.dtype)
    mean = dif_sum / n_near
    var = (squ_sum - 2 * mean * dif_sum) / n_near + mean * mean
    new_thre = 2.0 * geo.sqrt(var)
    cur2, reg_deg2, n2 = grow_fn(cen_deg, new_thre)
    if n2 < 2:
        return False, cur2, rec
    rec2 = rectangle_converter(cur2, reg_deg2, mag, rec["p"], deg_thre, stats)
    if density(n2, rec2) >= t(den_thre):
        return True, cur2, rec2
    return radius_reducer(seed_x, seed_y, reg_deg2, cur2, n2, rec2, mag,
                          den_thre, deg_thre, stats)
