"""mapCache: the BFS-approximate distance-to-wall prior, as
wave-synchronous source propagation with exact FIFO-rank ownership, in
plain PyTorch on the device (counterpart of lsdtpu/mapprep/distance.py).

The reference (createMapCache, LSD/myLSD.cpp:11-127) runs a FIFO BFS
from all occupied cells: a claimed cell stores the Euclidean distance
from its *parent* to the parent's wavefront source (the parent-distance
quirk, myLSD.cpp:47-58), propagation stops when the parent's distance
exceeds z_occ_max_dis, unclaimed cells keep the cap, and contested
cells go to whichever parent dequeued first.

One masked 4-neighbour propagation per BFS wave, each claimed cell
carrying its source coordinates and its dense queue rank: the initial
ranks are the row-major order of the occupied cells (the reference's
seeding order, myLSD.cpp:25-42), a contested cell goes to the
minimum-rank eligible parent, and the new wave's ranks are the dense
sort order of (parent_rank, direction) - the order the reference
enqueues them (neighbour scan order up, left, down, right).  Values
match the reference bit for bit: sqrt of an integer sum of squares
times res.  One host sync per wave (the fixpoint test, the tracer's
``host_reads.mapprep.field``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from lsdtpu_torch import geometry as geo
from lsdtpu_torch import resolve_device
from lsdtpu_torch.runtime import trace

# parent offsets in the reference's neighbour scan order: the parent of
# a cell claimed by an "up" move sits below it, and so on
_PARENT_OFFSETS = ((1, 0), (0, 1), (-1, 0), (0, -1))


def _shift(a, dy: int, dx: int, fill):
    """out[i, j] = a[i + dy, j + dx] (fill at the borders)."""
    out = torch.full_like(a, fill)
    H, W = a.shape
    ys, yd = (slice(1, H), slice(0, H - 1)) if dy == 1 else \
        (slice(0, H - 1), slice(1, H)) if dy == -1 else \
        (slice(0, H), slice(0, H))
    xs, xd = (slice(1, W), slice(0, W - 1)) if dx == 1 else \
        (slice(0, W - 1), slice(1, W)) if dx == -1 else \
        (slice(0, W), slice(0, W))
    out[yd, xd] = a[ys, xs]
    return out


def create_map_cache(map_gray, res: float, z_occ_max_dis: float = 1.0,
                     dtype=torch.float64, device="cuda") -> torch.Tensor:
    """map_gray: (H, W) occupancy (numpy or tensor) with occupied == 1
    (pre-remap values).  Returns the (H, W) distance field in meters,
    capped, as a ``dtype`` tensor on ``device``."""
    dev = resolve_device(device)
    g = torch.as_tensor(np.asarray(map_gray), device=dev)
    cell_radius = math.floor(z_occ_max_dis / res)
    H, W = g.shape
    BIG = H * W
    KEY_BIG = 4 * H * W + 4

    occ = g == 1
    yy = torch.arange(H, device=dev)[:, None].expand(H, W)
    xx = torch.arange(W, device=dev)[None, :].expand(H, W)
    rank = torch.where(occ, torch.cumsum(occ.reshape(-1), 0).reshape(H, W)
                       - 1, BIG)
    claimed = occ
    srcy = torch.where(occ, yy, 0)
    srcx = torch.where(occ, xx, 0)
    cache = torch.full((H, W), z_occ_max_dis, dtype=dtype,
                       device=dev).masked_fill(occ, 0.0)
    ar = torch.arange(H * W, device=dev)

    while True:
        dy_ = (yy - srcy).to(dtype)
        dx_ = (xx - srcx).to(dtype)
        d = geo.sqrt(dy_ * dy_ + dx_ * dx_)
        eligible = claimed & (d <= cell_radius)
        # per-direction claim keys: (parent_rank, dir) lexicographic
        key = torch.full((H, W), KEY_BIG, dtype=torch.int64, device=dev)
        n_srcy, n_srcx, n_cache = srcy, srcx, cache
        for di, (dy, dx) in enumerate(_PARENT_OFFSETS):
            par_ok = _shift(eligible, dy, dx, False)
            k = _shift(rank, dy, dx, BIG) * 4 + di
            k = torch.where(par_ok & ~claimed, k, KEY_BIG)
            better = k < key
            key = torch.where(better, k, key)
            n_srcy = torch.where(better, _shift(srcy, dy, dx, 0), n_srcy)
            n_srcx = torch.where(better, _shift(srcx, dy, dx, 0), n_srcx)
            n_cache = torch.where(better, _shift(d, dy, dx, torch.inf) * res,
                                  n_cache)
        new = key < KEY_BIG
        if not bool(trace.host_read("mapprep.field", new.any())):
            return cache
        # dense re-rank of this wave by enqueue order (keys of new cells
        # are unique, so the sort order is unambiguous)
        order = torch.argsort(key.reshape(-1))
        pos = torch.empty_like(ar)
        pos[order] = ar
        rank = torch.where(new, pos.reshape(H, W), rank)
        claimed = claimed | new
        srcy, srcx, cache = n_srcy, n_srcx, n_cache
