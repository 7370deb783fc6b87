"""Line Segment Detector: the sequential seed walk as a host loop over
device passes (counterpart of lsdtpu/mapprep/lsd.py).

Reference: myLineSegmentDetector, LSD/myLSD.cpp:129-376.  As in the
reference package:

* the next seed is the live pixel of the highest quantised gradient
  bin, the row-major first among ties (a two-stage argmax over the
  live mask, one device -> host read per seed);
* ``growth="wave"``: a region grows in waves; each wave accepts every
  8-neighbour that passes the angle test, then the running circular mean
  is recomputed over the accepted set, until a wave accepts nothing (the
  grow_wave kernel, ops/grow.py: one launch and one read per growth
  call);
* ``growth="fifo"``: the reference's exact acceptance order, a queue
  whose running mean updates after every accepted pixel (the grow_fifo
  kernel, ops/grow.py: one launch and one read per growth call); the
  refiner's radius reducer then walks that queue (rect.py);
* rectangles are masked full-field moments summed in one fixed order
  (rect.py), and the NFA counts go through the rect_counts kernel
  (nfa.py).

The in-place 1<->255 input remap (myLSD.cpp:135-142) is functional:
callers get the remapped map back beside the lines.

``_seed_walk`` is also the body of the row-block-sharded walk
(mapprep/lsd_sharded.py): with ``row0``, ``axis`` (a
runtime/collectives.Axis) and ``n_rows`` each rank holds rows
[row0, row0 + H) of the field and runs the same host loop, every
full-field pass reducing over its block and then over the axis: the seed
is a pmax of the bin, then a pmin of the global row, then of the column;
growth runs the plain wave loop, one read a wave: a wave's dilation takes
the neighbours' boundary rows (the +-1 halo) and its circular-mean sums
are psummed; the rectangle fit reduces
over the axis (rect.py) and the NFA counts are psummed (nfa.py).  Every
rank then holds the same scalars and emits the same lines.  FIFO growth
keeps one global queue and is not sharded.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from lsdtpu_torch import geometry as geo
from lsdtpu_torch import resolve_device
from lsdtpu_torch.mapprep import nfa as mnfa
from lsdtpu_torch.mapprep import rect as mrect
from lsdtpu_torch.mapprep.gaussian import gaussian_sampler
from lsdtpu_torch.mapprep.gradient import gradient_field
from lsdtpu_torch.mapprep.stats import MapPrepStats
from lsdtpu_torch.ops import grow as ogrow
from lsdtpu_torch.runtime import trace
from lsdtpu_torch.runtime.collectives import Axis

PI = math.pi
GROWTH = ("wave", "fifo")


def _dilate8(mask, axis: Axis):
    """8-neighbour dilation of a row block of a 0/1 mask (exact): the
    previous rank's last row and the next rank's first row join it first
    (zeros past either end), so a wave crosses block boundaries as it
    crosses any row."""
    m = mask.to(torch.float32)
    up, dn = axis.halo(m[0], m[-1])
    m = torch.cat([up[None], m, dn[None]])
    return (F.max_pool2d(m[None, None], 3, 1, 1)[0, 0] > 0.0)[1:-1]


def _grow(seed_y: int, seed_x: int, seed_deg, deg_thre, free, deg_map,
          sin_map, cos_map, stats: MapPrepStats, row0: int = 0,
          axis: Axis = Axis.none(), queue=None):
    """Wave-synchronous region growth (reference: RegionGrower,
    myLSD.cpp:491-590).  free: the pixels growth may enter (used != 1;
    NFA-rejected value-2 pixels regrow, myLSD.cpp:534); sin_map/cos_map:
    sin/cos of deg_map.  Returns (cur mask, reg_deg (), pixel count,
    None): the shape of _grow_fifo's return, with no queue.

    At one rank: one grow_wave call and one read of its counts (queue:
    the per-map buffers of ops.grow.fifo_queue).  row0/axis: a row block
    of a sharded field, grown by the plain version's loop with the halo
    dilation, the wave's sums psummed and a read a wave, so every rank
    carries the same running angle and the fixpoint is global."""
    if axis.size == 1:
        g = ogrow.grow_wave(seed_y, seed_x, seed_deg, deg_thre, free,
                            deg_map, sin_map, cos_map, queue)
        n, waves, _tests = (int(v) for v in stats.to_host("grow", g.counts))
        stats.wave_calls += 1
        stats.waves += waves
        return g.cur, g.reg_deg, n, None
    g = ogrow.grow_wave_reference(
        seed_y - row0, seed_x, seed_deg, deg_thre, free, deg_map, sin_map,
        cos_map, dilate=lambda m: _dilate8(m, axis), psum=axis.psum,
        read=lambda t: stats.to_host("grow", t))
    n, waves, _tests = g.counts.tolist()
    stats.waves += waves
    return g.cur, g.reg_deg, n, None


def _grow_fifo(seed_y: int, seed_x: int, deg_thre, ban, deg_map, sin_map,
               cos_map, queue, stats: MapPrepStats):
    """Exact-order FIFO region growth (reference: RegionGrower,
    myLSD.cpp:491-590) from the seed pixel's angle: one grow_fifo launch
    and one read of its counts.  Returns (cur mask, reg_deg (), pixel
    count, ops.grow.Growth)."""
    g = ogrow.grow_fifo(seed_y, seed_x, deg_thre, ban, deg_map, sin_map,
                        cos_map, queue)
    n, pops, passes = (int(v) for v in stats.to_host("grow", g.counts))
    stats.fifo_calls += 1
    stats.pops += pops
    stats.passes += passes
    return g.cur, g.reg_deg, n, g


def line_segment_detector(map_gray, sca: float = 0.3, sig: float = 0.6,
                          ang_thre: float = 22.5, den_thre: float = 0.7,
                          pse_bin: int = 1024, max_lines: int = 256,
                          growth: str = "wave", dtype=torch.float32,
                          device="cuda",
                          stats: Optional[MapPrepStats] = None):
    """map_gray: (row, col) occupancy {0, 1, 255} (numpy or tensor).
    Returns (lines (max_lines, 10), mask (max_lines,), n_lines,
    remapped_map), tensors on ``device``; n_lines is the raw count,
    which exceeds max_lines when lines were dropped.

    linesInfo rows are in structLinesInfo order (geometry.py) with
    endpoints rescaled to the full-resolution map frame
    (myLSD.cpp:252-258).  dtype is the working float type (float32, as
    the reference package without x64, or float64); growth: "wave" or
    "fifo" (the reference's exact acceptance order); ``stats``, when
    given, receives the run's counters."""
    dev = resolve_device(device)
    stats = MapPrepStats() if stats is None else stats
    with trace.span("mapprep.gradient"):
        g = torch.as_tensor(map_gray, device=dev)
        # in-place 1<->255 remap skipping row/col 0 (myLSD.cpp:135-142)
        remapped = g.clone()
        sub = g[1:, 1:]
        remapped[1:, 1:] = torch.where(
            sub == 1, 255, torch.where(sub == 255, 0, sub)).to(g.dtype)
        gauss = gaussian_sampler(remapped.to(dtype), sca, sig)
        new_row, new_col = gauss.shape
        deg_thre = ang_thre / 180.0 * PI
        mag, deg_map, prebanned, max_grad = gradient_field(gauss, deg_thre)
    log_nt = 5 * (math.log10(new_row) + math.log10(new_col)) / 2.0
    ends, n = _seed_walk(mag, deg_map, prebanned, max_grad, log_nt, sca,
                         ang_thre, den_thre, pse_bin, max_lines, stats,
                         growth=growth)
    infos, mask = lines_info(ends, n, max_lines, dtype, dev)
    return infos, mask, n, remapped


def lines_info(ends, n: int, max_lines: int, dtype, dev):
    """(linesInfo (max_lines, 10), mask (max_lines,)) on ``dev`` from the
    seed walk's endpoint rows."""
    lines = torch.zeros((max_lines, 4), dtype=dtype, device=dev)
    if ends:
        lines[:len(ends)] = torch.from_numpy(np.stack(ends)).to(dev)
    mask = torch.arange(max_lines, device=dev) < n
    infos = geo.lines_info_from_endpoints(lines[:, 0], lines[:, 1],
                                          lines[:, 2], lines[:, 3])
    return torch.where(mask[:, None], infos, 0.0), mask


def _seed_walk(mag, deg_map, prebanned, max_grad, log_nt: float, sca: float,
               ang_thre: float, den_thre: float, pse_bin: int,
               max_lines: int, stats: MapPrepStats, growth: str = "wave",
               row0: int = 0, axis: Axis = Axis.none(),
               n_rows: Optional[int] = None):
    """The sequential seeded region extraction loop (myLSD.cpp:219-272)
    with wave or FIFO region growth.  Returns (endpoint rows (at most
    max_lines) of numpy scalars in the working dtype, raw line count).

    row0/axis/n_rows (mapprep/lsd_sharded.py): mag, deg_map and prebanned
    are this rank's rows [row0, row0 + H) of a field whose true height is
    n_rows (the rows past it are padding, prebanned); module docstring."""
    if growth not in GROWTH:
        raise ValueError(f"growth={growth!r}: expected one of {GROWTH}")
    fifo = growth == "fifo"
    if fifo and axis.size > 1:
        raise ValueError("growth='fifo' is inherently sequential (a global "
                         "FIFO queue, myLSD.cpp:491-590) and unsupported "
                         "under row-block sharding; use growth='wave'")
    block = dict(row0=row0, axis=axis)
    H, W = mag.shape
    reg_thre = -log_nt / math.log10(ang_thre / 180.0)
    ali_pro = ang_thre / 180.0
    deg_thre = ang_thre / 180.0 * PI

    # stable-descending seed priority (quantised bin, row-major ties)
    zoom = pse_bin / max_grad
    q = torch.clamp(torch.floor(mag * zoom), max=float(pse_bin))
    # the max-gradient pixel sits exactly on the top bin boundary
    # (mag*zoom == pse_bin in exact math); rounding can push it to
    # pse_bin-1 and reorder the whole seed walk - pin it
    q = torch.where(mag == max_grad, float(pse_bin), q)
    used = torch.where(prebanned, 1, 0).to(torch.int8)
    # q of the live seeds (q >= 1, not visited, used == 0), else -1
    qlive = torch.where((q >= 1.0) & ~prebanned, q, -1.0)
    sin_map = torch.sin(deg_map)
    cos_map = torch.cos(deg_map)
    # the FIFO queue, or the wave kernel's spill space at one rank
    queue = ogrow.fifo_queue(H, W, mag.device) \
        if fifo or axis.size == 1 else None
    ends, n_lines = [], 0

    while True:
        with trace.span("mapprep.seed"):
            # two-stage argmax: the highest live bin, then the row-major
            # first pixel in it
            if axis.size == 1:
                # at one rank _seed_sharded's extra operations (its
                # row/column pmins) would add launches a seed for nothing
                qmax = qlive.max()
                flat = torch.argmax(
                    (qlive == qmax).to(torch.uint8).reshape(-1))
                top, flat = stats.to_host(
                    "seed", torch.stack([qmax.double(), flat.double()]))
                sy, sx = divmod(int(flat), W)
            else:
                top, sy, sx = _seed_sharded(qlive, row0, axis, stats)
            if top < 1.0:
                return ends, n_lines
            stats.seeds += 1
            if 0 <= sy - row0 < H:
                qlive[sy - row0, sx] = -1.0
        if fifo:
            ban = used == 1

            # the regrowth's centre angle is deg_map at the seed, whose
            # sin/cos the kernel reads from the tables
            def grow_fn(cen_deg, new_thre):
                with trace.span("mapprep.grow"):
                    return _grow_fifo(sy, sx, new_thre, ban, deg_map,
                                      sin_map, cos_map, queue, stats)
        else:
            free = used != 1

            def grow_fn(cen_deg, new_thre):
                with trace.span("mapprep.grow"):
                    return _grow(sy, sx, cen_deg, new_thre, free, deg_map,
                                 sin_map, cos_map, stats, queue=queue,
                                 **block)
        cur, reg_deg, size, _growth = grow_fn(
            mrect.field_at(deg_map, sy, sx, **block), deg_thre)
        if size < reg_thre:
            continue
        # the rectangle, the refinement (its regrowths are mapprep.grow
        # spans inside this one) and the NFA test
        with trace.span("mapprep.validate"):
            rec = mrect.rectangle_converter(cur, reg_deg, mag, ali_pro,
                                            deg_thre, stats, **block)
            ok, cur2, rec2 = mrect.refiner(sx, sy, cur, size, rec, mag,
                                           deg_map, den_thre, deg_thre,
                                           grow_fn, stats, **block)
            if not ok:
                continue
            log_nfa, rec3 = mnfa.rectangle_improver(
                rec2, deg_map, log_nt, stats, n_rows=n_rows, **block)
            accept = bool(log_nfa > 0.0)
            # accepted -> used=1; rejected -> used=2 (regrowable)
            used = torch.where(cur2, 1 if accept else 2,
                               used).to(torch.int8)
            qlive = torch.where(cur2, -1.0, qlive)
        if not accept:
            continue
        if n_lines < max_lines:
            # rescale to the full map frame (myLSD.cpp:252-258)
            t = type(rec3["x1"])
            xy = [rec3[k] for k in ("x1", "y1", "x2", "y2")]
            if sca != 1:
                one, s = t(1.0), t(sca)
                xy = [(v - one) / s + one for v in xy]
            ends.append(np.array(xy, dtype=t))
        # the count keeps growing past the cap so callers can detect
        # overflow (n_lines > max_lines)
        n_lines += 1


def _seed_sharded(qlive, row0: int, axis: Axis, stats: MapPrepStats):
    """The next seed of a row-block-sharded walk: (top bin, global row,
    column).  The bin is a pmax; among the ranks holding it, the lowest
    global row and then its lowest column (pmins), which is the unsharded
    row-major first, since row-major order restricted to a block is the
    global order."""
    qmax = axis.pmax(qlive.max())
    cand = (qlive == qmax).reshape(-1)
    W = qlive.shape[1]
    big = torch.iinfo(torch.int64).max
    flat = torch.argmax(cand.to(torch.uint8))
    has = cand.any()
    gy = torch.where(has, row0 + flat // W, big)
    gx = torch.where(has, flat % W, big)
    sy = axis.pmin(gy)
    sx = axis.pmin(torch.where(gy == sy, gx, big))
    top, sy, sx = stats.to_host("seed", torch.stack(
        [qmax.double(), sy.double(), sx.double()]))
    return top, int(sy), int(sx)
