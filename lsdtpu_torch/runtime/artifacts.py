"""Map artifact caching keyed by content hash (counterpart of
lsdtpu/runtime/artifacts.py).

The reference recomputes mapCache + LSD on every run.  Here the
artifacts are stored on disk as numpy arrays keyed by (map bytes,
resolution, cap, working dtype, growth, version) under this package's
own tag and directory, so a port-built artifact never serves, or
overwrites, one the reference package built, and FIFO and wave
artifacts never serve each other; a hit loads to the requested device.
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
BACKEND = "torch"


def _key(map_value: np.ndarray, resol: float, z: float, dtype,
         growth: str = "wave") -> str:
    h = hashlib.sha256()
    h.update(map_value.tobytes())
    h.update(f"{map_value.shape}|{resol}|{z}|{BACKEND}|{dtype}|{growth}"
             f"|v{CACHE_VERSION}".encode())
    return h.hexdigest()[:20]


def prepare_map_cached(map_value: np.ndarray, resol: float,
                       z_occ_max_dis: float = 1.0,
                       cache_dir: Optional[str] = None,
                       dtype=torch.float32, device="cuda",
                       growth: str = "wave"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (lines_info, map_cache) on ``device``, computing them at
    most once per map and growth order (mapprep.pipeline.prepare_map).
    cache_dir None is ~/.cache/lsdtpu_torch."""
    dev = resolve_device(device)
    map_value = np.asarray(map_value)
    cache_dir = DEFAULT_CACHE_DIR if cache_dir is None else cache_dir
    path = os.path.join(
        cache_dir,
        f"map_{_key(map_value, resol, z_occ_max_dis, dtype, growth)}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return (torch.from_numpy(z["lines"]).to(dev),
                    torch.from_numpy(z["cache"]).to(dev))
    art = prepare_map(map_value, resol, z_occ_max_dis=z_occ_max_dis,
                      growth=growth, dtype=dtype, device=dev)
    os.makedirs(cache_dir, exist_ok=True)
    np.savez_compressed(path, lines=art.lines_info.cpu().numpy(),
                        cache=art.map_cache.cpu().numpy())
    return art.lines_info, art.map_cache
