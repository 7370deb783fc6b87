"""Rectangle fitting over region masks: centroid, inertia orientation,
endpoint projection, density refinement (counterpart of
lsdtpu/mapprep/rect.py).

Reference: CenterGetter/OrientationGetter/RectangleConverter/Refiner/
RegionRadiusReducer, LSD/myLSD.cpp:592-880.  A region is a bool mask
over the downsampled field; its moments, projections and extents are
masked full-field passes on the device.  The sums add in one fixed
pairwise order (``geometry.tree_sum``), so the card and the CPU fit the
same rectangle bit for bit: torch's own sum adds in a device-specific order,
and an ulp of a rectangle edge lying on a pixel centre moves an NFA
count.  For the same reason the 2x2 eigen-solve between the moments
and the projections (its atan2, cos and sin) runs on the host, on the
moments' scalars (the card's atan2 is not the CPU's to the ulp).  The
rectangle is a dict of numpy scalars of the working dtype
(mapprep/nfa.py), and the density tests and radius bookkeeping run on
the host too.  Each host decision the reference package takes in a
``cond`` or ``while_loop`` is one device -> host read here; a fit takes
two.  With FIFO growth the refiner's radius reducer walks the
acceptance-ordered queue instead (radius_reducer_fifo, one kernel
launch and one read per shrink pass).

Row-block sharding (mapprep/lsd_sharded.py; the reference package's
row0/axis parameters): the mask and the fields are this rank's rows
[row0, row0 + H) of the field, pixel coordinates are global
(``_coords``), and every full-field sum, minimum and maximum reduces over
the block, then over ``axis`` (a runtime/collectives.Axis: a psum, pmin
or pmax), so every rank fits the same rectangle.  The block sums add in
the fixed order, the psum in rank order: the result is the unsharded
fit's up to the reduction order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lsdtpu_torch import geometry as geo
from lsdtpu_torch.mapprep.stats import MapPrepStats
from lsdtpu_torch.ops import grow as ogrow
from lsdtpu_torch.runtime.collectives import Axis

PI = math.pi

_REC_KEYS = ("x1", "y1", "x2", "y2", "wid", "c_x", "c_y", "deg", "dx", "dy")


def _coords(mag, row0: int = 0):
    """(yf (H, 1), xf (1, W)) pixel coordinates in the field's dtype
    (global rows of a block starting at row0)."""
    H, W = mag.shape
    return (torch.arange(row0, row0 + H,
                         device=mag.device).to(mag.dtype)[:, None],
            torch.arange(W, device=mag.device).to(mag.dtype)[None, :])


def _rsum(rows, axis: Axis):
    """tree_sum of each row of ``rows``, psummed over ``axis``."""
    return axis.psum(geo.tree_sum(rows))


def field_at(field, iy: int, ix: int, row0: int = 0,
             axis: Axis = Axis.none()):
    """field[iy, ix] at the global row iy: the owning rank reads its block,
    the others add 0, and a psum gives every rank the value."""
    ly = iy - row0
    mine = 0 <= ly < field.shape[0]
    v = field[ly, ix] if mine else torch.zeros((), dtype=field.dtype,
                                               device=field.device)
    return axis.psum(v)


def _wrap_pi(d):
    """Wrap into (-pi, pi] (reference while-loop semantics,
    myLSD.cpp:646-655); floored modulo, as jnp.mod.  A tensor, or a
    numpy scalar (in its own dtype)."""
    if torch.is_tensor(d):
        w = torch.remainder(d + PI, 2 * PI)
        return torch.where(w == 0.0, 2 * PI, w) - PI
    t = type(d)
    w = np.mod(d + t(PI), t(2 * PI))
    return (t(2 * PI) if w == 0.0 else w) - t(PI)


def rectangle_converter(cur, seed_deg, mag, ali_pro: float, deg_thre: float,
                        stats: MapPrepStats, row0: int = 0,
                        axis: Axis = Axis.none()) -> dict:
    """cur: (H, W) bool region mask; seed_deg: () running region angle
    (a tensor on the field's device).  Returns the rectangle as a dict
    of numpy scalars (reference: RectangleConverter, myLSD.cpp:669-734).
    Two device -> host reads: the moments, then the extents.  row0/axis:
    a row block of a sharded field (module docstring)."""
    yf, xf = _coords(mag, row0)
    w = torch.where(cur, mag, 0.0)
    ws, swx, swy = _rsum(torch.stack([w, w * xf, w * yf]), axis)
    cen_x = swx / ws
    cen_y = swy / ws
    dxp = xf - cen_x
    dyp = yf - cen_y
    wdx, wdy = w * dxp, w * dyp
    mom = _rsum(torch.stack([wdy * dyp, wdx * dxp, wdx * dyp]), axis) / ws
    cen_x, cen_y, ixx, iyy, ixy, sdeg = stats.to_host("rect", torch.cat([
        torch.stack([cen_x, cen_y]), mom, seed_deg.reshape(1).to(mag.dtype)]))
    t = type(ixx)
    ixy = -ixy
    with np.errstate(all="ignore"):
        dif = ixx - iyy
        lamb = (ixx + iyy - np.sqrt(dif * dif + t(4) * ixy * ixy)) / t(2)
    inertia = np.arctan2(lamb - ixx, ixy) if abs(ixx) > abs(iyy) \
        else np.arctan2(ixy, lamb - iyy)
    if abs(_wrap_pi(inertia - sdeg)) > t(deg_thre):
        inertia = inertia + t(PI)
    dxu = np.cos(inertia)
    dyu = np.sin(inertia)
    lx = dxp * float(dxu) + dyp * float(dyu)
    wx = -dxp * float(dyu) + dyp * float(dxu)
    # the four extents as minima over the region (the maxima as minima of
    # the negated coordinates, exactly): one reduction, and one pmin
    # over a sharded field
    ext = torch.where(cur, torch.stack([lx, -lx, wx, -wx]),
                      torch.inf).amin((1, 2))
    e = stats.to_host("rect", axis.pmin(ext))
    len_min, len_max, wid_min, wid_max = e[0], -e[1], e[2], -e[3]
    len_min, len_max = min(len_min, t(0)), max(len_max, t(0))
    wid_min, wid_max = min(wid_min, t(0)), max(wid_max, t(0))
    vals = (cen_x + len_min * dxu, cen_y + len_min * dyu,
            cen_x + len_max * dxu, cen_y + len_max * dyu,
            max(wid_max - wid_min, t(1)), cen_x, cen_y, inertia, dxu, dyu)
    rec = {k: t(v) for k, v in zip(_REC_KEYS, vals)}
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


def _seed_distance(seed_x: int, seed_y: int, mag, row0: int = 0):
    """(H, W) Euclidean distance of every pixel from the seed."""
    yf, xf = _coords(mag, row0)
    dx = xf - float(seed_x)
    dy = yf - float(seed_y)
    return geo.sqrt(dx * dx + dy * dy)


def radius_reducer(seed_x: int, seed_y: int, seed_deg, cur, n: int, rec,
                   mag, den_thre: float, deg_thre: float,
                   stats: MapPrepStats, row0: int = 0,
                   axis: Axis = Axis.none()):
    """Shrink the radius x0.75, dropping far pixels, until dense enough
    (reference: RegionRadiusReducer, myLSD.cpp:736-802).  n is cur's
    pixel count.  Returns (ok, cur, rec)."""
    t = type(rec["x1"])
    d_seed = _seed_distance(seed_x, seed_y, mag, row0)
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
        k = cur.sum()
        n = int(stats.to_host("rect", axis.psum(k)))
        alive = n >= 2
        if alive:
            rec = rectangle_converter(cur, seed_deg, mag, rec["p"], deg_thre,
                                      stats, row0, axis)
            den = density(n, rec)
    return alive, cur, rec


def radius_reducer_fifo(seed_x: int, seed_y: int, seed_deg, growth, n: int,
                        cur, rec, mag, den_thre: float, deg_thre: float,
                        stats: MapPrepStats):
    """Exact-order radius shrink for FIFO growth (reference:
    RegionRadiusReducer, myLSD.cpp:736-802, with its phantom-slot read;
    ops/grow.py:radius_reducer_fifo runs one pass).  growth: the
    ops.grow.Growth whose queue holds cur's n pixels in acceptance
    order.  The rectangle is fitted on the live list only (the ``fit``
    mask) while ``cur`` keeps the phantom-lost pixels, as the
    reference's curMap does; the density divides the list length.
    Returns (ok, cur, rec)."""
    t = type(rec["x1"])
    sx, sy = t(seed_x), t(seed_y)

    def dist(x, y):
        dx, dy = sx - x, sy - y
        return np.sqrt(dx * dx + dy * dy)

    rad = np.maximum(dist(rec["x1"], rec["y1"]), dist(rec["x2"], rec["y2"]))
    den = density(n, rec)
    alive = n >= 2
    cur = cur.clone()
    fit = cur.clone()
    n_dev = growth.counts[:1].clone()
    while alive and den < t(den_thre):
        rad = rad * t(0.75)
        ogrow.radius_reducer_fifo(seed_x, seed_y, rad, growth.qy, growth.qx,
                                  n_dev, cur, fit)
        stats.reducer_passes += 1
        n = int(stats.to_host("rect", n_dev)[0])
        alive = n >= 2
        if alive:
            rec = rectangle_converter(fit, seed_deg, mag, rec["p"], deg_thre,
                                      stats)
            den = density(n, rec)
    return alive, cur, rec


def refiner(seed_x: int, seed_y: int, cur, n: int, rec, mag, deg_map,
            den_thre: float, deg_thre: float, grow_fn, stats: MapPrepStats,
            row0: int = 0, axis: Axis = Axis.none()):
    """Re-estimate the angle tolerance from pixels near the seed and
    regrow (reference: Refiner, myLSD.cpp:804-880).  grow_fn(cen_deg,
    new_thre) -> (cur, reg_deg, n, growth) regrows from the seed; growth
    is the ops.grow.Growth of FIFO growth (a sparse regrown region then
    goes through radius_reducer_fifo on its queue), None for wave.  n is
    cur's pixel count.  Returns (ok, cur, rec).  row0/axis: a row block
    of a sharded field (module docstring)."""
    t = type(rec["x1"])
    if density(n, rec) >= t(den_thre):
        return True, cur, rec
    d_seed = _seed_distance(seed_x, seed_y, mag, row0)
    # the seed lies in the field: the reference's clamp never binds
    cen_deg = field_at(deg_map, seed_y, seed_x, row0, axis)
    near = cur & (d_seed < float(rec["wid"]))
    difm = torch.where(near, _wrap_pi(deg_map - cen_deg), 0.0)
    dif_sum, squ_sum, n_near = _rsum(torch.stack([
        difm, difm * difm, near.to(mag.dtype)]), axis)
    mean = dif_sum / n_near
    var = (squ_sum - 2 * mean * dif_sum) / n_near + mean * mean
    new_thre = 2.0 * geo.sqrt(var)
    cur2, reg_deg2, n2, growth = grow_fn(cen_deg, new_thre)
    if n2 < 2:
        return False, cur2, rec
    rec2 = rectangle_converter(cur2, reg_deg2, mag, rec["p"], deg_thre, stats,
                               row0, axis)
    if density(n2, rec2) >= t(den_thre):
        return True, cur2, rec2
    if growth is not None:
        return radius_reducer_fifo(seed_x, seed_y, reg_deg2, growth, n2, cur2,
                                   rec2, mag, den_thre, deg_thre, stats)
    return radius_reducer(seed_x, seed_y, reg_deg2, cur2, n2, rec2, mag,
                          den_thre, deg_thre, stats, row0, axis)
