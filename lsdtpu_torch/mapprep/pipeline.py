"""Map preprocessing entry point: occupancy grid -> (lines, mapCache)
on the device (counterpart of lsdtpu/mapprep/pipeline.py).

The per-map offline stage the reference runs at startup
(main_on_windows.cpp:67-70: createMapCache + LSD).  The artifacts are
tensors on the requested device, ready for
runtime/loop.make_map_context.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from lsdtpu_torch import resolve_device
from lsdtpu_torch.mapprep.distance import create_map_cache
from lsdtpu_torch.mapprep.lsd import line_segment_detector
from lsdtpu_torch.mapprep.stats import MapPrepStats
from lsdtpu_torch.runtime import trace


@dataclasses.dataclass
class MapArtifacts:
    lines_info: torch.Tensor   # (n, 10) valid rows only
    map_cache: torch.Tensor    # (H, W) meters


def prepare_map(map_value, resol: float, z_occ_max_dis: float = 1.0,
                sca: float = 0.3, sig: float = 0.6, ang_thre: float = 22.5,
                den_thre: float = 0.7, pse_bin: int = 1024,
                max_lines: int = 256, growth: str = "wave",
                dtype=torch.float32, device="cuda",
                stats: Optional[MapPrepStats] = None) -> MapArtifacts:
    """Map artifacts of an occupancy grid ({0 unknown, 1 occupied, 255
    free}), computed in ``dtype`` on ``device``.  growth: "wave" or
    "fifo" (the reference's exact acceptance order; the reference
    package's configuration default, lsd.growth).  Raises when the map
    gives more than ``max_lines`` lines.

    mapCache sees the PRE-remap occupancy values (occupied == 1): the
    reference's main program calls createMapCache before
    myLineSegmentDetector mutates the map (main_on_windows.cpp:67-70).
    The line detector's counters go to ``stats`` when given, and to the
    tracer's ``mapprep.lsd`` span."""
    dev = resolve_device(device)
    stats = MapPrepStats() if stats is None else stats
    with trace.span("mapprep.field"):
        cache = create_map_cache(map_value, float(resol),
                                 float(z_occ_max_dis), dtype=dtype,
                                 device=dev)
    with trace.span("mapprep.lsd") as sp:
        lines, mask, n, _remapped = line_segment_detector(
            map_value, sca=sca, sig=sig, ang_thre=ang_thre,
            den_thre=den_thre, pse_bin=pse_bin, max_lines=max_lines,
            growth=growth, dtype=dtype, device=dev, stats=stats)
        sp.set(**dataclasses.asdict(stats))
    if n > max_lines:
        raise ValueError(f"map produced {n} lines > max_lines={max_lines}; "
                         "raise the cap")
    return MapArtifacts(lines_info=lines[:n], map_cache=cache)
