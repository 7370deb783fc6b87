"""Map-line extraction for maps larger than one card: the LSD's passes
sharded over row blocks of the ranks (counterpart of
lsdtpu/mapprep/lsd_sharded.py).

``line_segment_detector_sharded`` runs the same sequential seed walk as
the single-card detector (mapprep/lsd._seed_walk, one shared body), but
every full-field pass inside it reduces over the rank's row block and
then with one collective (lsd.py's module docstring): the seed is a pmax
of the bin and pmins of the global row and column; a growth wave takes
the +-1 halo rows and psums its sums; the rectangle fit psums its moments
and pmins its extents; the NFA counts of each rank's block come from the
rect_counts kernel with ``row0``/``n_rows`` and are psummed, the
binomial tail running on every rank alike.  Every rank holds the same
scalars and emits the same lines.  The lines are the single-card wave
tier's up to reduction order (block sums psummed against whole-field
sums); FIFO growth keeps one global queue and is refused.

``prologue_sharded`` shards the dense prologue (the 1<->255 remap, the
Gaussian downsample, the gradient field) too: each rank takes
halo-extended row slabs of the remapped map, prepared on the host, runs
the x-pass on its rows, the y-pass over the slab's halo (which covers
every tap window, plus one gauss row for the gradient's shifted
differences) and the gradient, and one all_gather assembles the field.
Every cell comes from the same sequential tap sums and elementwise
operations as in the unsharded prologue (gaussian.py, gradient.py), and
the one cross-slab reduction (max_grad) is a max, so the sharded
prologue is the unsharded one bit for bit.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from lsdtpu_torch import resolve_device
from lsdtpu_torch.mapprep.gaussian import (_reflect_indices, kernel_bank,
                                           tap_sum_cols, tap_sum_rows)
from lsdtpu_torch.mapprep.gradient import gradient_core
from lsdtpu_torch.mapprep.lsd import _seed_walk, lines_info
from lsdtpu_torch.mapprep.stats import MapPrepStats
from lsdtpu_torch.runtime.collectives import Axis, rank_slice
from lsdtpu_torch.runtime.distributed import MP_AXIS


def make_mesh_lsd(n_devices: Optional[int] = None, device="cuda"):
    """1-D (mp,) mesh over the ranks: the field's row-block axis."""
    from lsdtpu_torch.runtime.shard import make_mesh_1d
    return make_mesh_1d(n_devices, device, name=MP_AXIS)


def _remap(grid: np.ndarray) -> np.ndarray:
    """The in-place 1<->255 remap skipping row/col 0 (myLSD.cpp:135-142),
    on a copy."""
    out = grid.copy()
    sub = grid[1:, 1:]
    out[1:, 1:] = np.where(sub == 1, np.asarray(255, grid.dtype),
                           np.where(sub == 255, np.asarray(0, grid.dtype),
                                    sub))
    return out


def prologue_sharded(map_gray, sca: float, sig: float, deg_thre: float,
                     mesh=None, blocks_per_device: int = 1,
                     dtype=torch.float32, device="cuda"):
    """Row-slab-sharded LSD prologue, bit for bit the unsharded remap +
    gaussian_sampler + gradient_field chain in ``dtype``.

    map_gray: (H, W) occupancy, the same on every rank.  Returns
    (remapped (H, W) numpy, mag, deg, banned, max_grad, (new_row,
    new_col)) with the fields as tensors on ``device`` (gradient_field's
    outputs), the same on every rank.  Reference: LSD/myLSD.cpp:135-174,
    :378-484."""
    dev = resolve_device(device)
    if mesh is None:
        mesh = make_mesh_lsd(device=dev)
    axis = Axis.of(mesh, MP_AXIS)
    grid = np.asarray(torch.as_tensor(map_gray).cpu())
    remapped = _remap(grid)
    y_lim, x_lim = grid.shape
    ker, h = kernel_bank(sca, sig)
    new_x = int(math.floor(x_lim * sca))
    new_y = int(math.floor(y_lim * sca))

    def table(n, lim):
        c = np.floor(np.arange(n) / sca + 0.5).astype(np.int64)
        return _reflect_indices(c, h, lim), ker[np.arange(n) % 3]

    jx, kx = table(new_x, x_lim)
    jy, ky = table(new_y, y_lim)
    S = axis.size * blocks_per_device
    Lo = -(-new_y // S)
    mags, degs = [], []
    for d in range(S)[rank_slice(S, axis)]:
        # gauss rows [lo - 1, lo + Lo): local gradient row i pairs gauss
        # rows (i, i + 1), global row lo + i.  Slab 0's leading row clips
        # to a copy of row 0 (global row 0 is zeroed below) and rows past
        # the field clip to copies (cut off)
        rg = np.clip(np.arange(d * Lo - 1, d * Lo + Lo), 0, new_y - 1)
        lo_i, hi_i = int(jy[rg].min()), int(jy[rg].max())
        img = torch.from_numpy(remapped[lo_i:hi_i + 1]).to(dev, dtype)
        aux = tap_sum_cols(img, torch.from_numpy(jx).to(dev),
                           torch.from_numpy(kx).to(dev, dtype))
        g = tap_sum_rows(aux, torch.from_numpy(jy[rg] - lo_i).to(dev),
                         torch.from_numpy(ky[rg]).to(dev, dtype))
        m, v = gradient_core(g)
        mag = torch.zeros((Lo, new_x), dtype=dtype, device=dev)
        deg = torch.zeros_like(mag)
        mag[:, 1:] = m
        deg[:, 1:] = v
        mags.append(mag)
        degs.append(deg)
    both = axis.all_gather(torch.stack([torch.cat(mags), torch.cat(degs)]))
    mag, deg = both.transpose(0, 1).reshape(2, S * Lo, new_x)[:, :new_y]
    # global row 0 is never written by the reference prologue
    mag[0] = 0.0
    deg[0] = 0.0
    banned = torch.zeros((new_y, new_x), dtype=torch.bool, device=dev)
    banned[1:, 1:] = mag[1:, 1:] < 2.0 / math.sin(deg_thre)
    return remapped, mag, deg, banned, mag.max(), (new_y, new_x)


def line_segment_detector_sharded(map_gray, sca: float = 0.3,
                                  sig: float = 0.6, ang_thre: float = 22.5,
                                  den_thre: float = 0.7, pse_bin: int = 1024,
                                  max_lines: int = 256, growth: str = "wave",
                                  dtype=torch.float32, device="cuda",
                                  mesh=None,
                                  stats: Optional[MapPrepStats] = None):
    """Row-block-sharded LSD (the wave tier).  Same returns as
    line_segment_detector: (lines (max_lines, 10), mask, n_lines,
    remapped map), the same on every rank.  growth "fifo" raises (one
    global queue)."""
    if growth != "wave":
        raise ValueError(f"growth={growth!r}: the row-block-sharded walk "
                         "takes growth='wave' only (FIFO growth keeps one "
                         "global queue, myLSD.cpp:491-590)")
    dev = resolve_device(device)
    if mesh is None:
        mesh = make_mesh_lsd(device=dev)
    axis = Axis.of(mesh, MP_AXIS)
    stats = MapPrepStats() if stats is None else stats
    deg_thre = ang_thre / 180.0 * math.pi
    remapped, mag, deg_map, prebanned, max_grad, _shape = prologue_sharded(
        map_gray, sca, sig, deg_thre, mesh, dtype=dtype, device=dev)
    remapped = torch.from_numpy(remapped).to(dev)
    H, W = mag.shape
    log_nt = 5 * (math.log10(H) + math.log10(W)) / 2.0
    # pad the rows to the mesh: the padding rows are prebanned (never seed,
    # never grow) and past n_rows for the NFA counts
    L = -(-H // axis.size)
    pad = axis.size * L - H
    mine = rank_slice(axis.size * L, axis)

    def block(t, fill):
        if pad:
            t = torch.cat([t, torch.full((pad, W), fill, dtype=t.dtype,
                                         device=dev)])
        return t[mine].contiguous()

    ends, n = _seed_walk(block(mag, 0), block(deg_map, 0),
                         block(prebanned, True), max_grad, log_nt, sca,
                         ang_thre, den_thre, pse_bin, max_lines, stats,
                         growth="wave", row0=mine.start, axis=axis,
                         n_rows=H)
    infos, mask = lines_info(ends, n, max_lines, dtype, dev)
    return infos, mask, n, remapped
