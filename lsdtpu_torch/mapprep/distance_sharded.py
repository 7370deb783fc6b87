"""The distance field built block by block over the ranks (counterpart
of lsdtpu/mapprep/distance_sharded.py).

For maps too large to prepare on one card the mapCache prior
(mapprep/distance.py) is built in row blocks with exact equality to the
whole-map build.  Propagation stops once the parent's distance to its
source exceeds cell_radius = floor(z_occ_max_dis / res)
(myLSD.cpp:47-58), so every wavefront that can touch a cell starts within
cell_radius + 2 cells of it: a row block extended by that halo holds
every source and every contested parent that can reach its interior.
FIFO ownership localizes too: the initial ranks are the row-major order
of the occupied cells (myLSD.cpp:25-42), row-major order restricted to a
slab is the global order, and each wave's re-rank keeps that (the
reference package's module docstring has the argument).  So the
unmodified create_map_cache on each halo-extended slab, interiors kept,
is the whole field bit for bit.

The host builds the slabs; each rank builds its ``blocks_per_device``
slabs one after the other (the build takes no lane axis) and one
all_gather gives every rank the whole field.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from lsdtpu_torch import resolve_device
from lsdtpu_torch.mapprep.distance import create_map_cache
from lsdtpu_torch.runtime.collectives import Axis, rank_slice
from lsdtpu_torch.runtime.distributed import DP_AXIS


def make_mesh_prep(n_devices: Optional[int] = None, device="cuda"):
    """1-D mesh over the ranks: the map's row-block axis."""
    from lsdtpu_torch.runtime.shard import make_mesh_1d
    return make_mesh_1d(n_devices, device)


def create_map_cache_sharded(map_gray, res: float, z_occ_max_dis: float = 1.0,
                             mesh=None, blocks_per_device: int = 1,
                             dtype=torch.float64,
                             device="cuda") -> torch.Tensor:
    """Block-parallel distance field, bit-identical to
    create_map_cache(map_gray, res, z_occ_max_dis, dtype).

    map_gray: (H, W) occupancy (occupied == 1, pre-remap values), the
    same on every rank; mesh: a 1-D mesh (make_mesh_prep), None for the
    ranks of the default group.  Returns the (H, W) field on ``device``,
    the same on every rank."""
    dev = resolve_device(device)
    if mesh is None:
        mesh = make_mesh_prep(device=dev)
    axis = Axis.of(mesh, DP_AXIS)
    S = axis.size * blocks_per_device
    grid = np.asarray(map_gray)
    H, W = grid.shape
    halo = math.floor(z_occ_max_dis / res) + 2
    L = -(-H // S)
    # outside the map there are no occupied cells, so zero padding (free
    # space) leaves the interiors untouched
    padded = np.zeros((S * L + 2 * halo, W), grid.dtype)
    padded[halo:halo + H] = grid
    mine = range(S)[rank_slice(S, axis)]
    inner = [create_map_cache(padded[s * L:s * L + L + 2 * halo], res,
                              z_occ_max_dis, dtype=dtype,
                              device=dev)[halo:halo + L] for s in mine]
    return axis.all_gather(torch.cat(inner)).reshape(S * L, W)[:H]
