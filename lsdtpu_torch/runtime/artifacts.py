"""Map artifact caching keyed by content hash (counterpart of
lsdtpu/runtime/artifacts.py).

The reference recomputes mapCache + LSD on every run.  Here the
artifacts are stored on disk as numpy arrays keyed by (map bytes,
resolution, cap, working dtype, growth, version) under this package's
own tag and directory, so a port-built artifact never serves, or
overwrites, one the reference package built, and FIFO and wave
artifacts never serve each other; a hit loads to the requested device.

backend "tpu-sharded" (the reference's name, kept so that scripts
written for it work) builds the artifacts over the ranks of the default
process group: the distance field block by block
(mapprep/distance_sharded.py, bit for bit the single-card field) and the
lines by the row-block-sharded wave seed walk (mapprep/lsd_sharded.py),
under a key of its own.  backend "oracle" runs the port's copy of the
numpy oracle (oracle/driver.prepare_map, f64 on the host, the reference
semantics) and casts its arrays to the requested dtype and device, also
under a key of its own; growth does not apply to it.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional, Tuple

import numpy as np
import torch

from lsdtpu_torch import resolve_device
from lsdtpu_torch.mapprep.pipeline import prepare_map

DEFAULT_CACHE_DIR = os.path.join(os.path.expanduser("~"), ".cache",
                                 "lsdtpu_torch")

# bump when the map-prep semantics change: the key hashes only inputs
CACHE_VERSION = 2
BACKENDS = ("torch", "tpu-sharded", "oracle")
SHARDED_MAX_LINES = 1024   # the reference's sharded prep's line cap


def _key(map_value: np.ndarray, resol: float, z: float, dtype,
         growth: str = "wave", backend: str = "torch") -> str:
    h = hashlib.sha256()
    h.update(map_value.tobytes())
    # the sharded build is wave-tier only and the oracle has one growth
    # order: neither keys growth
    tag = "torch" if backend == "torch" else f"torch|{backend}"
    growth = growth if backend == "torch" else "wave"
    h.update(f"{map_value.shape}|{resol}|{z}|{tag}|{dtype}|{growth}"
             f"|v{CACHE_VERSION}".encode())
    return h.hexdigest()[:20]


def _prepare_map_sharded(map_value, resol, z_occ_max_dis, dtype, dev):
    """The artifacts over the ranks of the default group: the distance
    field block by block, the lines by the sharded wave seed walk."""
    from lsdtpu_torch.mapprep.distance_sharded import create_map_cache_sharded
    from lsdtpu_torch.mapprep.lsd_sharded import line_segment_detector_sharded
    from lsdtpu_torch.mapprep.pipeline import MapArtifacts
    cache = create_map_cache_sharded(map_value, float(resol),
                                     float(z_occ_max_dis), dtype=dtype,
                                     device=dev)
    lines, _mask, n, _rm = line_segment_detector_sharded(
        map_value, max_lines=SHARDED_MAX_LINES, dtype=dtype, device=dev)
    if n > SHARDED_MAX_LINES:
        raise ValueError(f"map produced {n} lines > max_lines="
                         f"{SHARDED_MAX_LINES}; raise the cap")
    return MapArtifacts(lines_info=lines[:n], map_cache=cache)


def _prepare_map_oracle(map_value, resol, z_occ_max_dis, dtype, dev):
    """The numpy oracle's artifacts (f64 on the host) as tensors of
    ``dtype`` on ``dev``."""
    from lsdtpu_torch.mapprep.pipeline import MapArtifacts
    from lsdtpu_torch.oracle import driver as odrv
    art = odrv.prepare_map(map_value, float(resol),
                           z_occ_max_dis=float(z_occ_max_dis))
    return MapArtifacts(
        lines_info=torch.from_numpy(art.lines_info).to(dev, dtype),
        map_cache=torch.from_numpy(art.map_cache).to(dev, dtype))


def prepare_map_cached(map_value: np.ndarray, resol: float,
                       z_occ_max_dis: float = 1.0,
                       cache_dir: Optional[str] = None,
                       dtype=torch.float32, device="cuda",
                       growth: str = "wave", backend: str = "torch"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (lines_info, map_cache) on ``device``, computing them at
    most once per map, growth order and backend: "torch"
    (mapprep.pipeline.prepare_map), "tpu-sharded" (over the ranks of
    the default process group, wave tier) or "oracle" (the numpy oracle
    in f64, growth ignored; module docstring).  cache_dir None is
    ~/.cache/lsdtpu_torch."""
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: expected one of {BACKENDS}")
    dev = resolve_device(device)
    map_value = np.asarray(map_value)
    cache_dir = DEFAULT_CACHE_DIR if cache_dir is None else cache_dir
    key = _key(map_value, resol, z_occ_max_dis, dtype, growth, backend)
    path = os.path.join(cache_dir, f"map_{key}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return (torch.from_numpy(z["lines"]).to(dev),
                    torch.from_numpy(z["cache"]).to(dev))
    if backend == "tpu-sharded":
        art = _prepare_map_sharded(map_value, resol, z_occ_max_dis, dtype,
                                   dev)
    elif backend == "oracle":
        art = _prepare_map_oracle(map_value, resol, z_occ_max_dis, dtype, dev)
    else:
        art = prepare_map(map_value, resol, z_occ_max_dis=z_occ_max_dis,
                          growth=growth, dtype=dtype, device=dev)
    os.makedirs(cache_dir, exist_ok=True)
    np.savez_compressed(path, lines=art.lines_info.cpu().numpy(),
                        cache=art.map_cache.cpu().numpy())
    return art.lines_info, art.map_cache
